#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, cv2;
2. build every kernel (K1 normalize, K2 flash attention, K3 add+RMSNorm,
   K4 qk-norm+rope) from ``oar_ocr_tpu_torch/csrc/`` with nvcc for
   sm_90a, one nvcc per source, all started together; each instance's
   registers, shared memory and spills from ptxas (no K2 or K3 instance
   may spill; each float32 K2 instance must fit on an SM the CTAs its
   design declares: two at D = 64, 72 and 80, one at D = 128); the
   tensor-core instructions (``HGMMA``, ``HMMA``) of each K2 kernel from
   ``cuobjdump -sass`` (the bfloat16 instances must have ``HGMMA``, the
   float32 ones neither);
3. K1 against its plain PyTorch version on the card, at the OCR path's
   shapes (float32 max abs error ≤ 1e-6, bfloat16 ≤ 1 ulp), with
   CUDA-event times of both (median of 30 runs); the same after phase 15
   on the document chain's own model inputs, each one K1 got on the
   chain's main path (doc orientation (16, 224, 224, 3), UVDoc
   (1, 712, 488, 3), text-line orientation (n, 80, 160, 3) for each det
   batch's pool of n lines);
4. the OCR main path: ``OAROCRBuilder("general")`` in float32 with the
   trained ``assets/bench_det.safetensors`` detector and seeded random
   recognizer weights (CTC blank logit +4.0, as the JAX bench), three
   ``predict`` calls on 16 synthetic 1280×960 pages; every call must
   return results with ≥ 10 regions per page on average and must launch
   K1;
5. the same port on the CPU against the card: the OCR path's own output
   on its first 8-page det batch, and an unbiased recognizer on 2 pages;
   same region count, quad IoU ≥ 0.95, identical texts, confidence
   Δ ≤ 2e-2;
6. steady-state OCR pages/s over the 16-page batch in float32 and
   bfloat16; bfloat16's boxes against float32's: same region count,
   mean quad IoU ≥ 0.95 (text agreement printed, not gated); then
   phase 4's recognizer fitted to drawn text lines
   (``assets/fitted_rec.safetensors``, made on the card by
   ``tools/fit_text_recognizer.py``) on a drawn text page: the card's
   texts against the port's CPU texts in float32 and in bfloat16 (all
   20 equal), and, printed, its bfloat16 texts against float32's there
   and on the 16 pages with the top-2 margin at each split (the split is
   the fitted model's in bfloat16: the JAX package reads the same,
   ``tests/test_torch_rec_options.py``);
7. K2 and K3 against their plain versions on the card at the VL and
   HunyuanOCR paths' shapes, K2 also through the towers' (B, T, H, D)
   views and at a tile edge (K2: float32 ≤ 2e-5 abs; bfloat16 ≤ 1.6e-2
   abs and ≤ 2^-6·max|ref| against the float32 plain version on the same
   inputs; a valid_len-0 row exactly 0;
   K3: float32 ≤ 1e-5 relative, bfloat16 sum bit-equal and normed
   ≤ 1 ulp), with CUDA-event medians (plain, kernel, kernel, plain);
8. the VL main path: ``PaddleOCRVL`` at the full ``PaddleOCRVLConfig()``
   width and depth with seeded random weights, in bfloat16 and float32,
   request 1 ``generate([1280×960 page, its 448×448 crop], "ocr",
   max_new_tokens=128)`` and request 2 ``generate([page], "spotting",
   max_new_tokens=64)``, decoding through the captured CUDA graph of each
   (batch, KV capacity) key (``vl/decode_graph.py``); result counts,
   prompt lengths, finite logits, the launch counts the design predicts
   (K2 = 27 per vision encode, K3 = 36 × (1 + max_new) per generate,
   counted through the replays), again for the bfloat16 requests once
   their graphs exist (every step a replay), and the JAX dtype policy:
   vision tower and projector in the Runtime's dtype, the decoder and
   LM head float32;
9. the VL path on the card against the CPU, full width, the 448×448
   crop with 16 new tokens, in float32 and in bfloat16 (in bfloat16 both
   decoders take the CPU's image embeddings), the card decoding by
   replays of the key's graph: vision embeddings relative error ≤ 1e-4
   (float32) or ``VL_BF16_VISION_REL`` (bfloat16), prefill logits and
   each decode step's logits max abs error ≤ 1e-3·max|logit|, greedy ids
   identical up to a step where the CPU's top-2 logit margin is < 1e-4;
   and the graph against the eager step (``graph=False``) on the card:
   identical ids, step logits ≤ 1e-5·max|logit|;
10. VL times of request 1 in bfloat16 and float32: host preprocessing
    ms, vision ms per batch, prefill ms, decode ms/token as
    (t(128) − t(32)) / 96 at one pinned KV capacity through the graph
    and through the eager step (their 128 ids identical), tokens/s; each
    decode graph's capture ms, pool memory and launches per replay (K3 =
    36);
11. K4 (qk-norm + rotary, one launch for q and k of every batch row)
    against its plain version on the card at the HunyuanOCR decoder's
    shapes: 16 q and 4 k heads of 128 from the (B, T, H, 128)
    projections, k written into a KV-cache slot, B = 1 at T = 1249 and
    T = 1, B = 2 at T = 1, and as the decode graph runs it, k into a
    layer's whole (B, 4, 2048, 128) cache at a device slot, B = 1 and 2
    (float32 ≤ 1e-5 relative; bfloat16 ≤ 1 ulp of the plain version,
    plus 1e-6·max|ref| absolute where the rotary's difference cancels to
    near 0; the whole cache held), and one launch per call;
12. the HunyuanOCR main path: ``HunyuanOCRModel`` at the full
    ``HunyuanOCRConfig()`` width and depth with seeded random weights, in
    bfloat16 and float32, ``generate([page], "OCR:", max_new_tokens=64)``
    (4800 vision tokens, prompt 1249, KV capacity 2048) through the
    key's decode graph; one text per image, the launch counts the design
    predicts (K2 = 27 per image, K3 = 48 × (1 + 64), K4 = 24 × (1 + 64),
    counted through the replays), again for bfloat16 once its graph
    exists, and the JAX dtype policy (patch embedding and tower layers
    in the Runtime's dtype, the perceive projector, decoder and tied head
    float32);
13. HunyuanOCR on the card against the CPU, full width, the 448×448 crop
    with 16 new tokens, the card decoding by replays of the key's graph:
    float32 with vision relative error ≤ 1e-4, prefill and step logits
    max abs error ≤ 1e-3·max|logit| and identical greedy ids; bfloat16
    with both decoders fed the CPU's image embeddings, vision relative
    error ≤ ``HY_BF16_VISION_REL``, the same logits gates and ids
    identical up to a step where the CPU's top-2 margin is < 1e-4; the
    graph against the eager step as in phase 9;
14. HunyuanOCR times in bfloat16 and float32: host preprocessing ms
    (resize + patchify; position-row interpolation), vision ms (upload +
    tower), prefill ms, decode ms/token as (t(64) − t(16)) / 48 at KV
    capacity 2048 through the graph and through the eager step (their
    64 ids identical), generate ms; each decode graph's capture ms, pool
    memory and launches per replay (K3 = 48, K4 = 24);
15. the document chain at full width: ``OAROCRBuilder("general")`` with
    ``.with_word_boxes()`` and the stages of ``.with_doc_orientation()``,
    ``.with_doc_rectification()`` and ``.with_textline_orientation()``
    (PP-LCNet x1.0 doc orientation, UVDoc num_filter 32, PP-LCNet x0.25
    text-line orientation) on seeded weights with calibrated BatchNorm
    statistics, UVDoc tempered (``utils/calibrate``), passed to
    ``OAROCR``; on the 16 bench pages, a quarter of them rotated
    90/180/270°, in float32 and bfloat16; K1 launches by caller (each
    model input goes through K1); against the CPU in float32 on pages
    0-7: orientation probabilities within 1e-4 (classes compared where
    the top-2 gap is ≥ 1e-3, ties counted), rectified pages max|Δ| ≤ 1
    on ≤ 0.1% of pixels, on the card's rectified pages boxes IoU ≥ 0.99
    with identical texts, line angles and word-box counts (end to end
    printed), text-line probabilities within 1e-4; the untempered UVDoc's
    grid within 1e-4 on pages 0-3 (their rectified pages printed);
    bfloat16 against
    float32 on the card: probabilities and the tempered UVDoc grid within
    2e-2 (the untempered grid printed); per-stage ms (``utils/tracing``)
    and pages/s with and without the chain;
16. ``OAROCRBuilder("seal")`` (POLY boxes, device polygon scores) and a
    ``ScoreMode.SLOW`` pipeline on the 16 bench pages: regions, vertices,
    K1 launches, per-stage ms (``det.poly_scores``); against the CPU on
    2 pages: the same boxes within 1e-3 px, identical texts, box scores
    within 1e-5;
17. layout at full width: ``LayoutDetector("pp-doclayout_plus-l")``
    (RT-DETR-L, 800×800, 20 classes, 300 queries, six decoder layers)
    and ``LayoutDetector("pp-doclayout-m")`` (PicoDet-L, 640×640, through
    the device NMS) on seeded weights with calibrated BatchNorm
    statistics, on the 16 bench pages in chunks of 4, float32 then
    bfloat16: boxes per page, labels, ``layout.device[…]`` and
    ``layout.nms`` ms per chunk, K1 launches by caller (one ``layout``
    launch per chunk); then K1 at each model's own input against its
    plain version (float32 ≤ 1e-6, bfloat16 ≤ 1 ulp) with its bound;
18. each layout model on the card against the CPU, float32, 2 pages:
    RT-DETR logits ≤ 1e-3·max|logit| and boxes ≤ 1e-4 on the queries
    both sides select (a query one side alone selects is printed with
    its encoder-logit margin); PicoDet's raw scores and boxes printed;
    the valid detections (after NMS for PicoDet) the
    same by anchor and label, scores ≤ 1e-4, corners ≤ 1e-4 of the input
    side (normalized, or 0.064 px); a detection on one side only must
    lie at a selection boundary (printed);
19. each layout model in bfloat16 against float32 on the card (16
    pages): the same count per page, and each block (backbone, neck,
    selection heads, decoder layers, heads) in bfloat16 within
    2^-4·max|ref| of float32 on float32's own inputs to it; printed: the
    end-to-end share of detections bfloat16 keeps, their IoU, phase 6's
    nearest-centre reading;
20. ``OARStructure`` at full width: ``OARStructureBuilder()
    .with_tables(False).with_formulas(False)`` (default layout, overall
    OCR and seals) on the trained detector, phase 4's seeded recognizer
    and phase 17's RT-DETR-L weights, STRUCTURE_ITERS ``predict`` calls
    on the 16 pages in float32 and on the first CUT_PAGES in bfloat16:
    elements and markdown on
    every page, K1 launched by the layout and by the OCR; pages/s (their
    median) and stage ms, and without the overall OCR on the first
    CUT_PAGES pages; against the CPU in float32 on CPU_PAGES pages: the
    same elements, labels, order indices, texts and markdown;
21. every kernel case's device time (:func:`device_ms`: the median of
    20 calls, each after an L2 flush, queued behind a spin kernel, CUDA
    events; no case's below its bound), last (it runs after phase 26),
    and the launch floor (a one-element ``zero_()`` timed the same way)
    beside K3's and K4's;
22. the table models' weights at published width and depth on 16 pages
    of two drawn tables each (one ruled, one not, 4-12 rows × 3-8
    columns): SLANet (PP-LCNetV3 ×1.0, hidden 256, 500 steps), SLANet_plus
    (PP-LCNet ×1.0, CSP-PAN 96, hidden 256, 501 steps), SLANeXt wired
    (512) and wireless (488) (ViT-B: 768 wide, 12 layers, 12 heads,
    window 14, global blocks 2/5/8/11, hidden 512), the PP-LCNet ×1.0
    table classifier and the RT-DETR-L wired cell detector, seeded with
    calibrated BatchNorm statistics (RT-DETR tempered); each decoder's
    ``<tr>`` and ``<td></td>`` logits raised from its own unbiased decode
    on the card (TOKEN_SHARES), and SLANet's EOS for phases 25-26;
23. each structure model on the card against the CPU in float32: the
    memory ≤ 1e-4 relative, step logits with the CPU's ids fed back
    ≤ 1e-3·max|logit|, free-running ids identical (or first differing at
    a near-tie); the decode graph against the eager loop on the card
    (the same steps, logits and corners bit-equal, at the batch and at
    one row more, a first-seen batch) with ms per step of both, capture
    ms and host syncs; then K1 at each table model's own
    input against its plain version (float32 ≤ 1e-6, bfloat16 ≤ 1 ulp)
    with its bound;
24. SLANet under a bfloat16 Runtime: backbone bfloat16, decoder float32,
    each backbone block within 2^-4·max|ref| of float32 on float32's
    inputs;
25. ``TableAnalyzer.analyze_tables`` on the drawn tables with their text
    blocks as OCR: the card against the CPU (the same routes, tokens and
    HTML, cell boxes within 0.05 px), both routes run; tables/s, stage
    ms, K1 launches per analyze call, the decode graphs held (by batch)
    and their capture ms; then K1 at the analyzer's own inputs (SLANet,
    the table classifier, the cell detector) against its plain version;
26. ``OARStructure`` with tables on (formulas off; the seal OCR on, on
    phase 6's fitted recognizer) on the 16 table pages in float32 and
    their first CUT_PAGES in bfloat16: at least 4 table elements
    analyzed, pages/s,
    ``structure.tables`` and ``structure.table_ocr_split`` ms; the card
    against the CPU on TABLE_CPU_PAGES pages with tables: the same elements and
    texts (seal texts included), tables as in phase 25, the same
    markdown; then K1 at the float32 predict's own table and layout
    inputs against its plain version;
27. K1 at the formula models' own inputs (recorded in phases 28-30:
    the recognizers' canvases, and the structure predict's
    (N, 192, 672, 3) canvas of its N formula crops and its layout input)
    against its plain version (float32 ≤ 1e-6, bfloat16 ≤ 1 ulp), with
    bounds and device times (phase 21);
28. the default formula recognizer at full width (192×672, dim 384,
    vocab 8000, 64 steps) on 16 drawn crops: one K1 launch a call; the
    card against the CPU in float32 (memory and forced step logits
    ≤ 1e-5 relative, the 64 free-running ids identical); its one 64-step
    decode graph against the eager loop, bit for bit; ms/step graph and
    eager, capture ms, host syncs; bfloat16 encoder blocks within
    2^-4·max|ref| on float32's inputs;
29. PP-FormulaNet-S, -L and UniMERNet at published width on 2 crops
    each: the card against the CPU (encoder and forced logits ≤ 1e-4
    relative, free-running ids identical; the CPU decodes 32 new
    tokens), ms per token of the host loop and encode ms;
30. ``OARStructure`` with formulas on (the default recognizer; seals and
    tables off) on the 16 bench pages in float32 and bfloat16: at least
    FORMULA_MIN_BOXES formulas recognized in float32, pages/s,
    ``structure.formulas`` ms; one float32 predict on a prefix of the
    pages whose formula count the decoder has no graph for yet (its
    warm-up and capture in the call), against the same predict again;
    the card against the CPU on two pages with formulas: the same
    elements, texts, LaTeX and markdown;
31. the server OCR at full width: ``OAROCR(DBDetector(backbone="hgnet"),
    CTCRecognizer(backbone="hgnet"), cfg)`` (PP-HGNetV2-B4 det and rec,
    31.3 M and 36.1 M parameters) on calibrated seeded weights, on the 16
    pages in float32 and bfloat16: SERVER_ITERS timed predicts each
    (pages/s, regions, K1 launches per predict by caller); the card against the
    CPU in float32 on CPU_PAGES pages: the det map within 1e-4 of its max, the
    same regions at IoU ≥ 0.95 and identical texts; then K1 at the
    float32 predict's own det and rec inputs against its plain version;
32. a ``ServingEngine`` over phase 6's mobile ``OAROCR`` (float32):
    ``predict_dispatch`` makes no synchronizing call
    (``torch.cuda.set_sync_debug_mode``); 16 single-page requests from
    4 threads (max_batch_size 8, max_wait_ms 5): requests/s, p50/p95
    latency, mean batch size, the device busy share; every served result
    equals a direct predict of the engine's batch (boxes within 1e-4,
    texts), and its boxes a single-page predict's;
33. each of the 11 task predictors (``predictors/predictors.py``) on the
    card, on the weights the earlier phases hold: equal to the wrapper
    it calls on the same upload, K1 launched; detection, recognition and
    the three classifiers against the CPU; the formula predictor at the
    task config's 256 steps, its decode graph against the eager loop bit
    for bit;
34. the CLI's ``ocr`` and ``recognize`` in-process (``cli.main``) on two
    PNGs each in a temporary directory: the JSON lines equal the API's
    results.
35. upstream weights, PDF input and visualization: phase 6's detector
    and fitted recognizer as official-name tensors in two ONNX files
    (the script's own encoder) → ``tools/port_fetch_and_verify.py
    --upstream-file`` under a temporary ``$OAR_TPU_HOME`` (extract and
    convert host ms) → ``OAROCRBuilder().with_det_source(
    "pp-ocrv5_mobile_det").with_rec_source(<artifact path>)`` on the
    card: the state_dicts bit-equal to phase 6's, and on the 16 bench
    pages and the drawn text page the same boxes, texts and confidences
    as phase 6's pipeline (K1 launches counted); the drawn text page as
    a scanned PDF (FlateDecode) through ``utils/pdf.render_pdf``: the
    PNG's pixels, its 20 lines read as the PNG's; a vector page the
    script writes rendered and read (render ms, regions);
    ``draw_ocr_canvas`` and ``draw_structure`` write non-empty images.
36. speculative decoding and the VL families: K2 at D = 64 (the family
    towers' head size; built with the other instances in phase 2) at a
    family tower's token count on the page, (1, 16, T, 64) and the
    towers' chunked-qkv view (2, 16, T, 64) with two valid lengths, in
    float32 and bfloat16 (``gate_k2``), K3 at the verify blocks' and the
    family decoders' widths and K4 at HunyuanOCR's 8-token verify block
    (int slot, and the 0-d device slot a round's graph gives it); the
    phase's main path, counts zeroed before and read after: a
    ``HunyuanOCRSpeculative`` request (``HunyuanOCRConfig()``,
    ``DFlashConfig(hidden=1024, vocab_size=120818)``, float32, the
    448×448 crop, 64 tokens), its rounds through their CUDA graphs
    (``vl/decode_graph.SpecRounds``), and a GLM-OCR family request; the
    speculative ids against the same target's greedy ids (``ids_gate``),
    a forced accept (the greedy's next 7 ids written into the static
    drafts and the captured verify half replayed alone: all 7 accepted,
    the greedy's 8 emitted, both caches at prompt + 8; the next round
    follows the greedy), rounds, mean accepted, K3/K4 per round (48, 24)
    through the replays, the round graphs against the eager rounds bit
    for bit (:func:`round_report`: ids, accept counts, every round's
    verify logits), ms per token through the graphs and eagerly against
    the greedy decode graph, each round graph's capture ms, pool and
    launches; the first verify block's logits card against CPU on a
    224×224 crop (≤ 1e-3 · max|logit|) and the ids; GLM-OCR (greedy, MTP
    speculative, a forced accept through the replayed verify half, its
    MTP rounds' :func:`round_report`), OvisOCR2 (delta layers,
    ``parse``) and the HunyuanOCR family (DFlash, as GLM-OCR's MTP) at
    published width and depth (the speculative ids against the card's
    greedy ids), card against CPU by ``ids_gate`` at published width and
    depth FAM_CPU_DEPTH, greedy ms per token
    on the page; MinerU
    (``parse_two_step``), MinerU-Diffusion (its trial and commit graphs
    against the eager passes bit for bit: ids and every trial's logits),
    HPD (parent at the 0-d slot, and children from ``keep_indices`` +
    ``with_lengths`` at two fork depths at per-row slots, each graph
    against its eager steps bit for bit) and MonkeyOCRv2
    (``parse_end2end``) at published width and depth 2, card against
    CPU; PaddleOCR-VL's table task (OTSL → HTML), card against
    CPU. The head_dim-128 families run rope sections that cover
    head_dim / 2 (``WIDE_SECTIONS``): their published sections fail in
    both packages.
37. the exact VLM stacks, the HPD fork scheduler and DocParser: K2 in
    float32 at the exact towers' shapes (MinerU on the page,
    (1, 16, 6256, 80), and on a 448×448 crop, (1, 16, 1024, 80); D = 80
    with two valid lengths, (2, 16, 1024, 80), a masked case no path
    runs; GLM-OCR (1, 12, 6256, 128), HPD's InternViT tiles
    (5, 16, 1025, 64) and 1, 3 and 4 tiles) and K4 with a (4,) per-row
    slot vector (HPD's verify block), at SDAR's decode slot, with the
    (32,) slot vector of HPD's round graph and at SDAR's block graphs'
    0-d slot over 8 rows, against their plain versions (≤ 2e-5;
    ≤ 1e-6·max); the phase's main path, counts zeroed before and read
    after:
    ``cli.main(["vlm", "mineru-2.5", page.png, "--max-new-tokens",
    "64"])`` at published width and depth (K2 32 and K3 2 × 28 × 65
    launches, as the design predicts), HPD's ``parse_with_forks`` greedy
    and P-MTP at published width and depth through the slot pools' round
    graphs (the fork id set to a token the parent emits; parents and
    children identical) and
    ``DocParser.parse_to_markdown`` over RT-DETR-L (phase 17's weights)
    and a ``VLMBackend`` on PaddleOCR-VL on 2 bench pages (K1 by caller
    ``layout``); MinerU-2.5's vision ms, prefill ms, eager ms/token and
    busy share; HPD's rounds, greedy and P-MTP, through the round graphs
    against the eager rounds bit for bit, ms per round and per token
    both ways, each pool's captures, launches a replay and MiB, the
    device's busy share and the row buffer's MiB, and the scheduler's
    memory at the page's KV capacity 2048 (:func:`hpd_round_report`); MinerU-Diffusion with SDAR's decoder at
    published width and depth, its tower at the decoder's width and
    depth EXACT_DEPTH: card ids against the CPU's, the trial and commit
    graphs against the eager passes bit for bit, ms per token both ways
    and the device's busy share (:func:`sdar_runs`); the five other exact stacks at published width,
    depth EXACT_DEPTH, card against CPU on the 448×448 crop (fused
    embeddings ≤ 1e-4·max, ids by ``ids_gate``); OvisOCR2's
    n-gram speculative and GLM-OCR's MTP ids equal to their greedy ids
    at full depth, each path's rounds through their graphs against the
    eager rounds bit for bit, with ms per token both ways
    (:func:`round_report`); DocParser's markdown card against CPU; the
    card's
    MinerU through ``export_vl_format``, its VL map and the artifact's
    flax keys back to the same ids; GLM-OCR's vision tower alone at
    published width and depth on the page (its host ms, and one K2
    launch a block, 24).
38. the mesh layer (``parallel/``), card against card: ``OAROCR.predict``
    on the 16 pages with the trained det and the fitted recognizer,
    float32, over a data-parallel mesh of every visible card (two
    shards on the one card where there is one) against the predict on
    one card (``compare_results``: same regions, quad IoU ≥ 0.95,
    identical texts), pages/s both ways, K1 launches per card and the
    layout; K1 at the shards' own det and rec inputs on every card of
    the mesh against its plain version; GLM-OCR at published width and
    depth on the 224×224 crop, 32 tokens, ``n_model`` = 2 (over two
    cards where there are two, else two shards on one) against
    ``n_model`` = 1: the prefill's logits ≤ 1e-3 · max|logit| and the
    ids by ``ids_gate``, K2 and K3 at the path's shapes on every model
    card against their plain versions, its main path (``generate``, counts zeroed
    before and read after) with K2 and K3 launches per card, whether
    the decode replayed a graph, ms/token both ways and, a card, the
    shards' weight MiB and the generate's peak MiB over what the card
    held before it. Callable alone (:func:`mesh_phase`) after
    ``build_all`` (``tools/port_mesh_phase.py``).

The kernels' JSON record holds each kernel's first case and, for K2,
also the bfloat16 HunyuanOCR case through the tower's view
(``bf16_hunyuan``), the first D = 64 case (``d64``), MinerU's D = 80
cases on the page (``d80``) and the crop (``d80_crop``), GLM-OCR's tower
case (``glm_d128``) and GLM-OCR's tower alone (``glm_tower``); for K4 the
verify block's device-slot case (``verify_device_slot``), the per-row
case (``per_row``), SDAR's decode slot (``sdar_device_slot``), HPD's
round graph (``hpd_round_per_row``) and SDAR's block graphs
(``sdar_block_device_slot``).
Phase 21 also prints each K2 case's device time over SDPA's device
time, with the phase (7, 36 or 37) its case comes from.

Every kernel case reports its CUDA-event time (median of 30 calls,
wrapper included), its host time per call (the wrapper's own cost,
30 calls enqueued without a sync), its device time (phase 21), its bound (the larger of
the bytes it must move over 3.35 TB/s and its operations over the card's
peak rate for the input type: 67 TFLOP/s float32, 989 TFLOP/s bfloat16)
and, for K2, the CUDA-event and device times of
``F.scaled_dot_product_attention`` with the same boolean mask (a
yardstick; the port never calls it).

The last two lines are the kernels' JSON record and the result JSON
``{"ok": true, "device": {...}}``. Without a CUDA card, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
N_PAGES, PAGE_H, PAGE_W, REGIONS_PER_PAGE = 16, 1280, 960, 20
REGION_DIMS = [(700, 28), (420, 26), (180, 24), (760, 34), (260, 22)]
TIMED_ITERS = 5
# timed OARStructure predicts a configuration (phases 20, 26, 30): each
# takes 1.5-12 s, most of it the seal OCR
STRUCTURE_ITERS = 2
# the pages of phase 20's bfloat16 predicts and predicts without the
# overall OCR, and of phase 26's bfloat16 predicts (cut from 16 to keep
# the script's time)
CUT_PAGES = 8
# the pages of the card-vs-CPU checks of phases 20, 30 and 31, both sides
# run on them, and of phase 26's (cut from 2 to keep the script's time)
CPU_PAGES, TABLE_CPU_PAGES = 2, 1
VL_REQUESTS = (("ocr", 2, 128), ("spotting", 1, 64))   # task, images, max_new
VL_PROMPTS = {"ocr": [1254, 280], "spotting": [2057]}   # tokens per image
HY_MAX_NEW, HY_PROMPT, HY_VISION_TOKENS = 64, 1249, 4800
# the card's published peaks (H100 SXM, dense): bytes/s, FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# K2 bfloat16's gate relative to max|ref|: 2-4 bfloat16 ulps of the
# largest output (the readings it was set from are in PERF.md §6)
K2_BF16_REL = 2.0 ** -6
# the bfloat16 card-vs-CPU gates on the towers' output (phases 9, 13),
# relative to max|ref|: at least 3x the largest of two chip readings,
# capped at 2^-4 (the readings are in PERF.md §6)
VL_BF16_VISION_REL = 2.0 ** -4
HY_BF16_VISION_REL = 2.0 ** -4


def Runtime1(*args, **kwargs):
    """A ``Runtime`` without a mesh, whatever the card count: every phase
    but 38 measures the one-device path, on any machine."""
    from oar_ocr_tpu_torch.config.runtime import RuntimeConfig
    from oar_ocr_tpu_torch.runtime.runtime import Runtime

    return Runtime(*args, cfg=RuntimeConfig(use_mesh=False), **kwargs)


def make_pages(seed: int = 0):
    """The JAX bench's flat pages: 20 dark text blocks on white."""
    rng = np.random.default_rng(seed)
    pages = []
    for _ in range(N_PAGES):
        img = np.full((PAGE_H, PAGE_W, 3), 255, np.uint8)
        for r in range(REGIONS_PER_PAGE):
            w, h = REGION_DIMS[r % len(REGION_DIMS)]
            y = 40 + r * 60
            img[y : y + h, 60 : 60 + w] = rng.integers(0, 80)
        pages.append(img)
    return pages


def cuda_ms(fn, iters: int = 30) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after warmup."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# clock cycles of ``torch.cuda._sleep`` per millisecond: the H100's
# highest SM clock, 1980 MHz, rounded up, so a spin lasts at least as long
# as asked
SPIN_CYCLES_PER_MS = 2_000_000
# bytes written before each timed call so that it finds none of its
# inputs in the 50 MB L2 (as ``triton.testing.do_bench`` does)
L2_FLUSH_BYTES = 256 << 20


def device_ms(fn, symbol: str = "", iters: int = 20,
              bound_ms: float = 0.0) -> float:
    """Device milliseconds of one call of ``fn``: the median over
    ``iters`` calls, each between its own CUDA events after a 256 MB
    write that empties the L2, all queued behind a one-thread spin kernel
    (``torch.cuda._sleep``) that holds the card until the host has queued
    them, so no host gap falls inside a call. The CUDA-event time of a
    lone call that finishes in microseconds is its wrapper's host time;
    this is the card's own, read from memory as the bound assumes (calls
    back to back on the same inputs read them from the L2, and K3's
    (2508, 1024) then beat its bytes bound). ``torch.profiler`` traces
    gave no such number on an H100: some lost part of a kernel's events.
    A spin that ended before the last call was queued is lengthened
    fourfold and the calls timed again, up to five times; then, or when
    the time is below ``bound_ms`` (the least time the card could take),
    it raises. ``symbol`` names the kernel in the messages."""
    import torch

    what = symbol or "the call"
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]

    def queue():
        for start, end in events:
            flush.zero_()
            start.record()
            fn()
            end.record()

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    queue()
    spin_ms = 2 * (time.perf_counter() - t0) * 1e3 + 1.0
    torch.cuda.synchronize()
    for _ in range(5):
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        gate = torch.cuda.Event()
        gate.record()
        queue()
        # the gate not yet reached: the spin held the card past the last
        # call
        queued = not gate.query()
        torch.cuda.synchronize()
        if queued:
            ms = statistics.median(start.elapsed_time(end)
                                   for start, end in events)
            if ms < bound_ms:
                raise AssertionError(f"{what}: device {ms!r} ms per call, "
                                     f"below its bound {bound_ms!r} ms")
            return ms
        spin_ms *= 4
    raise AssertionError(f"{what}: the host queued {iters} calls slower "
                         f"than the card spun, five times (last spin "
                         f"{spin_ms / 4!r} ms)")


def enqueue_ms(fn, iters: int = 30) -> float:
    """Host milliseconds per call of ``fn()`` over ``iters`` calls enqueued
    with no sync between them: the wrapper's own cost, which a path hides
    only while the card's queue stays ahead of it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def host_ms(fn, iters: int = 3) -> float:
    """Median host milliseconds of ``fn()`` ending in a device sync."""
    import torch

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ulps_bf16(got, ref) -> int:
    import torch

    return int((got.view(torch.int16).int()
                - ref.view(torch.int16).int()).abs().max())


def gate_k1(got, ref):
    """K1: float32 ≤ 1e-6 abs, bfloat16 ≤ 1 ulp."""
    import torch

    err = float((got.float() - ref.float()).abs().max())
    if got.dtype == torch.bfloat16:
        ulps = ulps_bf16(got, ref)
        return err, ulps <= 1, f"max {ulps} bf16 ulp"
    return err, err <= 1e-6, "gate 1e-6"


def gate_k2(got, ref):
    """K2 against the float32 plain version on the same inputs: float32
    ≤ 2e-5 abs; bfloat16 ≤ 1.6e-2 abs and ≤ 2^-6·max|ref|. The second
    scales with the output (σ ≈ sqrt(e/T) for N(0,1) inputs), so at the
    long vision lengths it is a few bfloat16 ulps of the largest value,
    where a stale or dropped key block would pass the first."""
    import torch

    err = float((got.float() - ref).abs().max())
    if got.dtype == torch.float32:
        return err, err <= 2e-5, "gate 2e-5"
    peak = float(ref.abs().max())
    tol = min(1.6e-2, K2_BF16_REL * peak)
    return err, err <= tol, (f"gate {tol!r} = min(1.6e-2, 2^-6·max|ref|), "
                             f"max|ref| {peak!r}, err/max|ref| "
                             f"{err / peak if peak else 0.0!r}")


def gate_k3(got, ref):
    """K3 (normed, sum): float32 ≤ 1e-5 relative; bfloat16 sum bit-equal,
    normed ≤ 1 ulp."""
    import torch

    (n, s), (rn, rs) = got, ref
    err = float((n.float() - rn.float()).abs().max())
    if n.dtype == torch.bfloat16:
        ulps = ulps_bf16(n, rn)
        ok = ulps <= 1 and torch.equal(s, rs)
        return err, ok, f"normed max {ulps} bf16 ulp, sum bit-equal {ok}"
    rel = err / float(rn.abs().max())
    ok = rel <= 1e-5 and float((s - rs).abs().max()) <= 1e-6
    return err, ok, f"relative {rel!r}, gate 1e-5"


def bound(nbytes: float, flops: float, dtype) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes over the memory rate and its operations over the peak rate of
    its input type."""
    import torch

    peak = PEAK_FLOPS["bfloat16" if dtype == torch.bfloat16 else "float32"]
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_tensor_cores(library) -> None:
    """Phase 2: count the tensor-core instructions of each K2 kernel in
    ``cuobjdump -sass``; every bfloat16 instance (``flash_wgmma_kernel``)
    must have ``HGMMA``, and every float32 instance (``flash_fma_kernel``)
    neither ``HGMMA`` nor ``HMMA``: its products are float32 FMAs."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump")
    if tool is None and CUDA_HOME:
        found = pathlib.Path(CUDA_HOME) / "bin" / "cuobjdump"
        tool = str(found) if found.exists() else None
    if tool is None:
        raise AssertionError("cuobjdump is missing, so K2's tensor-core "
                             "instructions cannot be counted")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            func = line.split("Function : ")[1].strip()
            counts[func] = {"HGMMA": 0, "HMMA": 0}
        elif func is not None:
            for op in counts[func]:
                counts[func][op] += f" {op}." in line
    for func, n in counts.items():
        print(f"  K2 SASS {demangle(func)}: {n['HGMMA']} HGMMA, "
              f"{n['HMMA']} HMMA")
    wgmma = [n for f, n in counts.items() if "flash_wgmma_kernel" in f]
    fma = [n for f, n in counts.items() if "flash_fma_kernel" in f]
    if not wgmma or any(n["HGMMA"] == 0 for n in wgmma):
        raise AssertionError("a bfloat16 K2 instance has no HGMMA "
                             "instruction: it does not run on the tensor "
                             "cores")
    if not fma or any(n["HGMMA"] or n["HMMA"] for n in fma):
        raise AssertionError("a float32 K2 instance uses the tensor cores: "
                             "its products must stay float32 FMAs")


def demangle(name: str) -> str:
    """A kernel's C++ name and template arguments (``c++filt``), or the
    mangled name without it."""
    import shutil

    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return name
    full = subprocess.run([tool, name], capture_output=True, text=True,
                          timeout=60).stdout.strip() or name
    full = full.replace("(anonymous namespace)::", "")
    return full.removeprefix("void ").split("(")[0]


def ptxas_report(log: pathlib.Path) -> dict:
    """Each kernel's registers, static shared memory and spill bytes from
    the ``-Xptxas -v`` report nvcc wrote beside the library."""
    import re

    funcs, func = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            func = m.group(1)
            funcs.setdefault(func, {"registers": None, "smem": 0,
                                    "spill": None})
            continue
        if func is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            funcs[func]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            funcs[func]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            funcs[func]["smem"] = int(s.group(1)) if s else 0
    return funcs


def check_kernels_built(kernels, built) -> None:
    """Phase 2: registers, shared memory and spills of every kernel
    instance; K2 and K3 must not spill, and every float32 K2 instance, by
    name, must fit on an SM the CTAs its design declares (its
    ``__launch_bounds__``) and declare the tiling the launch rule computes
    with (``ops/flash_attention.check_instances``; its dynamic shared
    memory, occupancy and declared CTAs from ``oar_flash_fma_info``)."""
    from oar_ocr_tpu_torch.ops.flash_attention import (check_instances,
                                                       fma_instances)

    for k, b in zip(kernels, built):
        for func, r in ptxas_report(b.log).items():
            print(f"    {k.name} {demangle(func)}: {r['registers']} "
                  f"registers, {r['smem']} bytes static shared memory, "
                  f"{r['spill']} bytes spilled")
            if k.name in ("flash_attention", "add_rmsnorm") \
                    and r["spill"] != 0:
                raise AssertionError(f"{k.name}: {func} spills registers "
                                     f"({r['spill']} bytes) or ptxas "
                                     "reported no spill count")
        if k.name != "flash_attention":
            continue
        instances = fma_instances(b.lib)
        for f in instances:
            print(f"    flash_fma_kernel {f['name']}: D = {f['d']}, "
                  f"{f['bq']} rows x {f['bk']} keys, {f['threads']} "
                  f"threads, {f['smem_bytes']} bytes dynamic shared memory, "
                  f"{f['split']} CTA(s) a tile, {f['ctas_per_sm']} CTAs per "
                  f"SM, {f['declared_ctas']} declared (rc {f['rc']})")
        check_instances(instances)


def run_cases(cases, card: str) -> dict:
    """Each case: (name, kernel, plain, reference, gate, work).
    ``reference()`` is what the kernel's output is held against; ``plain``
    is the plain version at the kernel's own dtype, which is timed;
    ``work`` is the case's :func:`bound` plus ``library``, one PyTorch
    call computing the same function (timed as a yardstick) or None. The
    record's numbers are the first case's; ``cases`` holds every case's."""
    import torch

    f32_errs, records = [], []
    for name, kernel, plain, reference, gate, work in cases:
        got, ref = kernel(), reference()
        torch.cuda.synchronize()
        err, ok, detail = gate(got, ref)
        print(f"  {name}: max_abs_err {err!r} ({detail})")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({detail})")
        if "f32" in name:
            f32_errs.append(err)
        del got, ref
        # plain, kernel, kernel, plain; each keeps the lower of its medians
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel),
                          cuda_ms(plain))
        lib = work.get("library")
        rec = {"name": name, "max_abs_err": err,
               "ms": min(k1, k2), "host_ms": enqueue_ms(kernel),
               "plain_ms": min(p1, p2),
               "library_ms": None if lib is None else cuda_ms(lib),
               "bound_ms": work["bound_ms"], "bound_by": work["bound_by"]}
        records.append(rec)
        print(f"  {name}: kernel {rec['ms']!r} ms (host "
              f"{rec['host_ms']!r} ms per call), plain "
              f"{rec['plain_ms']!r} ms, library {rec['library_ms']!r} ms, "
              f"bound {rec['bound_ms']!r} ms ({rec['bound_by']})  [{card}]")
    return {**records[0], "max_abs_err": max(f32_errs), "cases": records}


def k1_work(src, out) -> dict:
    """K1's bound: read the input once, write the output once; one FMA
    per element."""
    import torch

    return bound(src.numel() * (src.element_size()
                                + torch.tensor([], dtype=out).element_size()),
                 2.0 * src.numel(), torch.float32)


def k1_cases():
    """Phase 3: K1 at the OCR path's shapes."""
    import torch

    from oar_ocr_tpu_torch.models.detection.detector import (
        DET_ALPHA, DET_BETA, DET_MEAN, DET_STD)
    from oar_ocr_tpu_torch.ops.det_device import _interp_weights, resample
    from oar_ocr_tpu_torch.ops.normalize import (normalize_images,
                                                 normalize_masked,
                                                 normalize_ref)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pages = torch.randint(0, 256, (8, PAGE_H, PAGE_W, 3), generator=gen,
                          dtype=torch.uint8, device=dev)
    # the det tile of those pages: 1280×960 → 960×704 (det_target_size)
    src_h = torch.full((8,), PAGE_H, dtype=torch.int32, device=dev)
    src_w = torch.full((8,), PAGE_W, dtype=torch.int32, device=dev)
    dst_h = torch.full((8,), 960, dtype=torch.int32, device=dev)
    dst_w = torch.full((8,), 704, dtype=torch.int32, device=dev)
    det_tile = resample(pages, _interp_weights(960, PAGE_H, src_h, dst_h),
                        _interp_weights(704, PAGE_W, src_w, dst_w))
    rec_tiles = torch.rand((64, 48, 320, 3), generator=gen,
                           device=dev) * 255.0
    rec_w = torch.randint(16, 321, (64,), generator=gen, dtype=torch.int32,
                          device=dev)
    rec_h = torch.full((64,), 48, dtype=torch.int32, device=dev)
    rec_a, rec_b = (2.0 / 255.0,) * 3, (-1.0,) * 3

    cases = []
    for out in (torch.float32, torch.bfloat16):
        tag = "f32" if out == torch.float32 else "bf16"
        plain = (lambda out=out: normalize_ref(pages, DET_ALPHA, DET_BETA,
                                               out_dtype=out))
        cases.append((
            f"u8 {tuple(pages.shape)} -> {tag}",
            lambda out=out: normalize_images(pages, mean=DET_MEAN,
                                             std=DET_STD, out_dtype=out),
            plain, plain, gate_k1, k1_work(pages, out)))
        plain = (lambda out=out: normalize_ref(
            det_tile, DET_ALPHA, DET_BETA, valid_h=dst_h, valid_w=dst_w,
            pad=0.0, out_dtype=out))
        cases.append((
            f"det masked {tuple(det_tile.shape)} pad 0 -> {tag}",
            lambda out=out: normalize_masked(det_tile, DET_ALPHA, DET_BETA,
                                             valid_h=dst_h, valid_w=dst_w,
                                             pad=0.0, out_dtype=out),
            plain, plain, gate_k1, k1_work(det_tile, out)))
        plain = (lambda out=out: normalize_ref(
            rec_tiles, rec_a, rec_b, valid_h=rec_h, valid_w=rec_w,
            pad=rec_b, swap_rb=True, out_dtype=out))
        cases.append((
            f"rec masked {tuple(rec_tiles.shape)} swap_rb pad beta -> {tag}",
            lambda out=out: normalize_masked(rec_tiles, rec_a, rec_b,
                                             valid_h=rec_h, valid_w=rec_w,
                                             pad=rec_b, swap_rb=True,
                                             out_dtype=out),
            plain, plain, gate_k1, k1_work(rec_tiles, out)))
    return cases


def k2_work(q, vlen, causal) -> dict:
    """K2's bound on these inputs: q, the valid K/V rows and the output
    moved once; 4·D operations per (query, attended key) pair, counting
    only the keys valid_len and the causal mask leave."""
    b, h, t, d = q.shape
    keys = [t] * b if vlen is None else vlen
    pairs = sum(sum(min(i + 1, n) for i in range(t)) if causal else t * n
                for n in keys)
    nbytes = q.element_size() * h * d * (2 * b * t + 2 * sum(keys))
    return bound(nbytes, 4.0 * h * d * pairs, q.dtype)


def sdpa_library(q, k, v, vl, causal):
    """``F.scaled_dot_product_attention`` with K2's boolean mask, or None
    where it is not the same function (a row with every key masked gives
    NaN there, 0 in K2)."""
    import torch
    import torch.nn.functional as F

    if vl is None:
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
    if bool((vl == 0).any()):
        return None
    t = k.shape[2]
    mask = (torch.arange(t, device=q.device)[None, :]
            < vl[:, None])[:, None, None, :]
    if causal:
        mask = mask & torch.ones((t, t), dtype=torch.bool,
                                 device=q.device).tril()
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def k2_cases():
    """Phase 7, K2: the vision attention at the VL requests' shapes
    (request 1: 4920 and 1024 tokens; request 2: 8112) and HunyuanOCR's
    (4800 tokens), contiguous and as the towers pass them, (B, T, H, D)
    projections viewed as (B, H, T, D); a tile edge (333 tokens: a
    ragged last query tile and key block, valid_len mid-block); the causal
    case at the decoder's head size; and a row with valid_len 0."""
    import torch

    from oar_ocr_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for shape, vlen, causal, dtype, tower in [
            ((2, 16, 4920, 72), [4920, 1024], False, torch.float32, False),
            ((2, 16, 4920, 72), [4920, 1024], False, torch.bfloat16, False),
            ((2, 16, 4920, 72), [4920, 1024], False, torch.bfloat16, True),
            ((1, 16, 8112, 72), [8112], False, torch.bfloat16, False),
            ((1, 16, HY_VISION_TOKENS, 72), None, False, torch.float32,
             False),
            ((1, 16, HY_VISION_TOKENS, 72), None, False, torch.float32,
             True),
            ((1, 16, HY_VISION_TOKENS, 72), None, False, torch.bfloat16,
             False),
            ((1, 16, HY_VISION_TOKENS, 72), None, False, torch.bfloat16,
             True),
            ((2, 16, 333, 72), [333, 65], False, torch.bfloat16, True),
            ((1, 16, 1024, 128), None, True, torch.float32, False),
            ((1, 16, 1024, 128), None, True, torch.bfloat16, False),
            ((2, 16, 1024, 72), [1024, 0], False, torch.float32, False)]:
        b, h, t, d = shape
        q, k, v = ((torch.randn((b, t, h, d), generator=gen, device="cuda")
                    .to(dtype).transpose(1, 2)) if tower else
                   torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        vl = (None if vlen is None else
              torch.tensor(vlen, dtype=torch.int32, device="cuda"))
        tag = "f32" if dtype == torch.float32 else "bf16"
        name = (f"K2 {shape} valid_len {vlen}"
                f"{' causal' if causal else ''} {tag}"
                f"{' tower view' if tower else ''}")

        def kernel(q=q, k=k, v=v, vl=vl, causal=causal):
            return flash_attention(q, k, v, valid_len=vl, causal=causal)

        def plain(q=q, k=k, v=v, vl=vl, causal=causal):
            return flash_attention_ref(q, k, v, valid_len=vl, causal=causal)

        def reference(q=q, k=k, v=v, vl=vl, causal=causal):
            return flash_attention_ref(q.float(), k.float(), v.float(),
                                       valid_len=vl, causal=causal)

        def gate(got, ref, vlen=vlen):
            err, ok, detail = gate_k2(got, ref)
            if vlen is not None and 0 in vlen:
                zero = bool((got[vlen.index(0)] == 0).all())
                ok, detail = ok and zero, f"{detail}, valid_len-0 row all 0: {zero}"
            return err, ok, detail

        work = k2_work(q, vlen, causal)
        work["library"] = sdpa_library(q, k, v, vl, causal)
        cases.append((name, kernel, plain, reference, gate, work))
    return cases


def k3_cases():
    """Phase 7, K3: prefill rows of VL request 1 (2 × 1254) and of the
    HunyuanOCR request (1249), and decode rows (2 and 1)."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import (add_rmsnorm_ref,
                                                       fused_add_rmsnorm)

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for rows in (2508, 2, HY_PROMPT, 1):
        for dtype in (torch.float32, torch.bfloat16):
            x, r = (torch.randn((rows, 1024), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            scale = (torch.rand((1024,), generator=gen, device="cuda")
                     + 0.5).to(dtype)
            tag = "f32" if dtype == torch.float32 else "bf16"

            def kernel(x=x, r=r, scale=scale):
                return fused_add_rmsnorm(x, r, scale, eps=1e-5)

            def plain(x=x, r=r, scale=scale):
                return add_rmsnorm_ref(x, r, scale, eps=1e-5)

            # x, r read, both outputs written; add, square-sum, two muls
            work = bound(x.element_size() * (4 * x.numel() + 1024),
                         5.0 * x.numel(), dtype)
            cases.append((f"K3 ({rows}, 1024) {tag}", kernel, plain, plain,
                          gate_k3, work))
    return cases


def gate_k4(got, ref):
    """K4 on (q, k slot) pairs: float32 ≤ 1e-5 relative; bfloat16 ≤ 1 ulp
    of the plain version plus 1e-6·max|ref| absolute (where n1·cos −
    n2·sin cancels to near 0, float32 noise is many ulps of the tiny
    result)."""
    import torch

    diff = torch.cat([(g.float() - r.float()).abs().flatten()
                      for g, r in zip(got, ref)])
    ref = torch.cat([r.float().flatten() for r in ref])
    err, top = float(diff.max()), float(ref.abs().max())
    if got[0].dtype == torch.float32:
        rel = err / top
        return err, rel <= 1e-5, f"relative {rel!r}, gate 1e-5"
    a = ref.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    over = diff > ulp
    big = a >= 1e-3 * top
    ulps_big = float((diff[big] / ulp[big]).max())
    ok = bool((diff <= ulp + 1e-6 * top).all())
    return err, ok, (f"{int(over.sum())} of {diff.numel()} elements over "
                     f"1 bf16 ulp, max {ulps_big!r} ulp where |ref| >= "
                     f"1e-3·max, gate 1 ulp + 1e-6·max|ref|")


def k4_cases():
    """Phase 11, K4 in its one-launch form: a HunyuanOCR decoder layer's
    16 q and 4 k heads of every batch row, from the (B, T, H, 128)
    projections, k written into a (B, 4, 2048, 128) KV-cache slot; B = 1
    at prefill (1249 tokens) and decode, B = 2 at decode."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import (fused_qk_norm_rope_qk,
                                                       qk_norm_rope_qk_ref)

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for b, t in ((1, HY_PROMPT), (1, 1), (2, 1)):
        ang = torch.rand((b, t, 64), generator=gen, device="cuda") * 2048.0
        cos, sin = ang.cos(), ang.sin()
        pos = 0 if t > 1 else HY_PROMPT          # prefill, or a decode step
        for dtype in (torch.float32, torch.bfloat16):
            q, k = (torch.randn((b, t, h, 128), generator=gen,
                                device="cuda").to(dtype) for h in (16, 4))
            qs, ks = ((torch.rand((128,), generator=gen, device="cuda")
                       + 0.5).to(dtype) for _ in range(2))
            # the kernel and the plain version each write their own cache
            slots = [torch.zeros((b, 4, 2048, 128), dtype=dtype,
                                 device="cuda")[:, :, pos:pos + t]
                     for _ in range(2)]
            tag = "f32" if dtype == torch.float32 else "bf16"

            def kernel(q=q, k=k, qs=qs, ks=ks, cos=cos, sin=sin,
                       slot=slots[0]):
                return (fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin,
                                              k_out=slot, eps=1e-5), slot)

            def plain(q=q, k=k, qs=qs, ks=ks, cos=cos, sin=sin,
                      slot=slots[1]):
                return (qk_norm_rope_qk_ref(q, k, qs, ks, cos, sin,
                                            k_out=slot, eps=1e-5), slot)

            # q, k read and written once, the (B, T, 64) tables and both
            # scales read; square-sum, two muls and the rotary's 1.5 ops
            # per element
            n = q.numel() + k.numel()
            work = bound(2 * n * q.element_size() + 2 * b * t * 64 * 4
                         + 2 * 128 * q.element_size(), 6.0 * n, dtype)
            cases.append((f"K4 q+k B={b} T={t} (16+4 heads, 128) {tag}",
                          kernel, plain, plain, gate_k4, work))
    # the decode graph's form: k into the layer's whole cache at a device
    # slot the kernel reads; the gate holds the whole cache, so a write
    # at any other slot fails it
    for b in (1, 2):
        ang = torch.rand((b, 1, 64), generator=gen, device="cuda") * 2048.0
        cos, sin = ang.cos(), ang.sin()
        slot = torch.tensor(HY_PROMPT, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, k = (torch.randn((b, 1, h, 128), generator=gen,
                                device="cuda").to(dtype) for h in (16, 4))
            qs, ks = ((torch.rand((128,), generator=gen, device="cuda")
                       + 0.5).to(dtype) for _ in range(2))
            caches = [torch.zeros((b, 4, 2048, 128), dtype=dtype,
                                  device="cuda") for _ in range(2)]
            tag = "f32" if dtype == torch.float32 else "bf16"

            def kernel(q=q, k=k, qs=qs, ks=ks, cos=cos, sin=sin,
                       cache=caches[0], slot=slot):
                return (fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin,
                                              k_out=cache, slot=slot,
                                              eps=1e-5), cache)

            def plain(q=q, k=k, qs=qs, ks=ks, cos=cos, sin=sin,
                      cache=caches[1], slot=slot):
                return (qk_norm_rope_qk_ref(q, k, qs, ks, cos, sin,
                                            k_out=cache, slot=slot,
                                            eps=1e-5), cache)

            n = q.numel() + k.numel()
            work = bound(2 * n * q.element_size() + 2 * b * 64 * 4
                         + 2 * 128 * q.element_size() + 8, 6.0 * n, dtype)
            cases.append((f"K4 q+k B={b} T=1 device slot {HY_PROMPT} into "
                          f"(B, 4, 2048, 128) (16+4 heads, 128) {tag}",
                          kernel, plain, plain, gate_k4, work))
    return cases


# the recognizer fitted to drawn text lines (phases 6 and 26; made by
# tools/fit_text_recognizer.py), and the characters the lines draw
FITTED_REC = REPO / "assets" / "fitted_rec.safetensors"
FIT_REC_CHARS = ("0123456789abcdefghijklmnopqrstuvwxyz"
                 "ABCDEFGHIJKLMNOPQRSTUVWXYZ")
# phase 6's drawn text page: its seed (held out from the fit) and lines
TEXT_PAGE_SEED, TEXT_PAGE_LINES = 23, 20


def draw_line(rng):
    """One seeded text line drawn with ``cv2.putText`` on a white strip
    48 px high (the recognizer's input height): (uint8 (48, w, 3), the
    string)."""
    import cv2

    text = "".join(rng.choice(list(FIT_REC_CHARS), int(rng.integers(3, 13))))
    scale = float(rng.uniform(0.7, 1.1))
    thick = int(rng.integers(1, 3))
    font = int(rng.choice([cv2.FONT_HERSHEY_SIMPLEX,
                           cv2.FONT_HERSHEY_DUPLEX]))
    (w, h), _base = cv2.getTextSize(text, font, scale, thick)
    while w + 12 > 320:
        scale *= 0.9
        (w, h), _base = cv2.getTextSize(text, font, scale, thick)
    img = np.full((48, w + 12, 3), 255, np.uint8)
    cv2.putText(img, text, (6, 24 + h // 2), font, scale,
                (int(rng.integers(0, 90)),) * 3, thick)
    return img, text


def text_lines(n: int, seed: int):
    """``n`` lines of :func:`draw_line` as uint8 (n, 48, 320, 3) tiles
    (each line at the left, its width in ``widths``), and the strings."""
    rng = np.random.default_rng(seed)
    tiles = np.zeros((n, 48, 320, 3), np.uint8)
    widths, texts = np.zeros((n,), np.int64), []
    for i in range(n):
        img, text = draw_line(rng)
        tiles[i, :, :img.shape[1]] = img
        widths[i] = img.shape[1]
        texts.append(text)
    return tiles, widths, texts


def text_page(seed: int = TEXT_PAGE_SEED):
    """A white 1280×960 page with TEXT_PAGE_LINES held-out lines of
    :func:`draw_line` pasted 60 px apart: (page, their xyxy boxes, the
    strings)."""
    rng = np.random.default_rng(seed)
    page = np.full((PAGE_H, PAGE_W, 3), 255, np.uint8)
    boxes, texts = [], []
    for r in range(TEXT_PAGE_LINES):
        img, text = draw_line(rng)
        y, x = 40 + r * 60, 60 + int(rng.integers(0, 200))
        page[y:y + 48, x:x + img.shape[1]] = img
        boxes.append((x, y, x + img.shape[1], y + 48))
        texts.append(text)
    return page, boxes, texts


def rec_probs(recognizer, pages_u8, plan):
    """The (T, vocab) float32 probabilities the recognizer's model gives
    one crop plan, through its own dispatch (warp, K1, model)."""
    seen = []

    def finish(tiles, model=None, orig=recognizer._finish):
        seen.append((model or recognizer.model)(tiles).float())
        return orig(tiles, model)

    recognizer._finish = finish
    try:
        recognizer.recognize_chunk(pages_u8, [plan])
    finally:
        del recognizer._finish
    return seen[0][0].cpu()


def split_margin(rec32, rec16, pages_u8, plan) -> tuple:
    """Where a float32 and a bfloat16 recognizer read one crop apart:
    (the crop's texts equal on both, the least float32 top-2 probability
    margin over the columns whose argmax differs, or over all columns
    when none does)."""
    p32, p16 = rec_probs(rec32, pages_u8, plan), rec_probs(rec16, pages_u8,
                                                             plan)
    top = p32.topk(2, -1).values
    margin = top[:, 0] - top[:, 1]
    differ = p32.argmax(-1) != p16.argmax(-1)
    t32 = rec32.recognize_chunk(pages_u8, [plan])[0][0]
    t16 = rec16.recognize_chunk(pages_u8, [plan])[0][0]
    return t32 == t16, float((margin[differ] if differ.any()
                              else margin).min())


def text_agreement(card: str, det_state, fitted, pages) -> None:
    """Phase 6, texts: the fitted recognizer in float32 and in bfloat16,
    each through its own dispatch (warp, K1, model, CTC), on the drawn
    text page's lines (:func:`text_page`, held out from the fit), gated
    card against the port's CPU in each dtype (the same 20 texts); and,
    printed, bfloat16 against float32 there and end to end on the 16
    bench pages (whose blocks hold no glyph, and whose bfloat16 boxes
    move, IoU down to ~0.8): the texts equal, the drawn lines read
    right, and at each split (up to 3 a page set) the two recognizers on
    the float32 crop, with the float32 top-2 margin where their columns
    differ. bfloat16 against float32 is not gated: the fitted model
    reads one line apart in bfloat16 ('hrKqw' / 'hrKgw'), and so does the
    JAX package's recognizer under ``compute_dtype="bfloat16"`` on the
    same weights and page (``tests/test_torch_rec_options.py``): the
    split is the model's, not the port's (ROADMAP queue 3)."""
    from oar_ocr_tpu_torch.models.recognition.recognizer import CropPlan
    from oar_ocr_tpu_torch.utils.parity import compare_results

    pipes = {d: build_pipeline(Runtime1(d, device="cuda"), det_state, fitted)
             for d in ("float32", "bfloat16")}
    rec32, rec16 = pipes["float32"].recognizer, pipes["bfloat16"].recognizer

    def split(up, page_i, box, t16, t32):
        eq, margin = split_margin(rec32, rec16, up, CropPlan.from_quad(
            page_i, np.asarray(box, np.float32)))
        return (f"page {page_i} {t16!r}/{t32!r}: on the float32 crop the "
                f"recognizers agree {eq}, top-2 margin {margin!r}")

    page, boxes, truth = text_page()
    up = pipes["float32"].runtime.put_pages([page], (PAGE_H, PAGE_W))
    quads = [[[x0, y0], [x1, y0], [x1, y1], [x0, y1]]
             for x0, y0, x1, y1 in boxes]
    plans = [CropPlan.from_quad(0, np.array(q, np.float32)) for q in quads]
    read = {d: [t for t, _c, _k in p.recognizer.recognize_chunk(up, plans)]
            for d, p in pipes.items()}
    for d in ("float32", "bfloat16"):
        rt = Runtime1(d, device="cpu")
        cpu = build_pipeline(rt, det_state, fitted).recognizer
        want = [t for t, _c, _k in cpu.recognize_chunk(
            rt.put_pages([page], (PAGE_H, PAGE_W)), plans)]
        same = sum(a == b for a, b in zip(read[d], want))
        print(f"fitted recognizer on the drawn text page, {d}, card vs "
              f"cpu (gate: all equal): {same} of {len(plans)} texts equal")
        if same != len(plans):
            raise AssertionError(f"fitted recognizer ({d}): the card's "
                                 f"texts differ from the CPU's")
    notes = [split(up, 0, q, a, b) for q, a, b in zip(
        quads, read["bfloat16"], read["float32"]) if a != b][:3]
    same = sum(a == b for a, b in zip(read["bfloat16"], read["float32"]))
    right = sum(a == b for a, b in zip(read["float32"], truth))
    print(f"fitted recognizer on the drawn text page ({len(plans)} held-out "
          f"lines, not gated): bfloat16 texts equal float32's on {same} of "
          f"{len(plans)}; float32 reads {right} of {len(plans)} exactly, "
          f"e.g. {list(zip(read['float32'][:3], truth[:3]))}; splits "
          f"{notes}  [{card}]")

    fit32 = pipes["float32"].predict(pages)
    fit16 = pipes["bfloat16"].predict(pages)
    agree = compare_results(fit16, fit32)
    n_text = sum(len(r.regions) for r in fit32)
    notes = []
    up = pipes["float32"].runtime.put_pages(pages, (PAGE_H, PAGE_W))
    for page_i, (r16, r32) in enumerate(zip(fit16, fit32)):
        centers = np.array([np.asarray(x.box, np.float32).mean(0)
                            for x in r32.regions])
        for region in r16.regions:
            c = np.asarray(region.box, np.float32).mean(0)
            match = r32.regions[int(np.argmin(np.linalg.norm(
                centers - c, axis=1)))]
            if region.text != match.text and len(notes) < 3:
                notes.append(split(up, page_i, match.box, region.text,
                                   match.text))
    print(f"fitted recognizer end to end, bfloat16 vs float32 on the 16 "
          f"bench pages (not gated): texts "
          f"{n_text - agree['text_mismatches']} of {n_text} equal, "
          f"{sum(1 for r in fit32 for x in r.regions if x.text)} non-empty "
          f"in float32; splits {notes}  [{card}]")


def fitted_recognizer(rec_state) -> dict:
    """Phase 4's recognizer fitted to drawn text lines, as
    ``tools/fit_text_recognizer.py`` made it on the card and committed it
    (``FITTED_REC``): a fixed state, so that phases 6 and 26 read the same
    weights on every run. Its keys, shapes and dtypes must be
    ``rec_state``'s."""
    from safetensors.torch import load_file

    state = load_file(str(FITTED_REC))
    want = {k: (tuple(v.shape), v.dtype) for k, v in rec_state.items()}
    if {k: (tuple(v.shape), v.dtype) for k, v in state.items()} != want:
        raise AssertionError(f"{FITTED_REC.name}: not phase 4's "
                             f"recognizer")
    return state


def build_pipeline(runtime, det_state, rec_state, batch=(8, 64)):
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder

    return (OAROCRBuilder("general").with_runtime(runtime)
            .with_det_params(det_state).with_rec_params(rec_state)
            .with_batch_sizes(image=batch[0], region=batch[1]).build())


def timed_pps(pipe, pages, card: str, label: str):
    times = []
    for _ in range(TIMED_ITERS):
        t0 = time.perf_counter()
        res = pipe.predict(pages)
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    print(f"throughput {label}: {len(pages) / p50!r} pages/s "
          f"(p50 {p50 * 1e3!r} ms per {len(pages)}-page predict, "
          f"iters_ms {[round(t * 1e3, 1) for t in times]}) [{card}]")
    return res, len(pages) / p50


def ocr_phases(card: str, kernels) -> tuple:
    """Phases 4-6; returns K1's launches on the OCR main path and the
    recognizer fitted to drawn lines (:func:`fitted_recognizer`)."""
    import torch

    from oar_ocr_tpu_torch.models.layers import init_state_dict
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
    from oar_ocr_tpu_torch.ops.ctc import default_charset
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.runtime.weights import load_jax_checkpoint
    from oar_ocr_tpu_torch.utils.parity import compare_results

    det_state = load_jax_checkpoint(
        str(REPO / "assets" / "bench_det.safetensors"))
    vocab = 2 + len(default_charset())
    rec_state = init_state_dict(SVTRRecognizer(vocab, 0.95),
                                torch.Generator().manual_seed(0))
    rec_state["head.ctc_head.fc.bias"][0] += 4.0   # blank wins most steps
    pages = make_pages(0)
    gpu_f32 = Runtime1("float32", device="cuda")
    pipe = build_pipeline(gpu_f32, det_state, rec_state)

    for k in kernels:
        k.launches = 0
    per_call, results = [], None
    for call in range(3):
        before = K1.launches
        t0 = time.perf_counter()
        results = pipe.predict(pages)
        dt = time.perf_counter() - t0
        n_regions = sum(len(r.regions) for r in results)
        per_call.append(K1.launches - before)
        print(f"predict {call}: {len(results)} results, {n_regions} regions "
              f"({n_regions / N_PAGES!r}/page), {dt * 1e3!r} ms, "
              f"normalize launches {per_call[-1]}")
        if len(results) != N_PAGES or n_regions / N_PAGES < 10:
            raise AssertionError(f"predict {call}: too few regions "
                                 f"({n_regions} on {len(results)} pages)")
        if per_call[-1] == 0:
            raise AssertionError(f"predict {call} launched no normalize "
                                 "kernel")
        if not all(np.isfinite(r.confidence) and np.isfinite(
                np.asarray(r.box, np.float32)).all()
                for res in results for r in res.regions):
            raise AssertionError("non-finite box or confidence")
    main_launches = K1.launches
    texts = [r.text for res in results for r in res.regions]
    print(f"texts: {sum(1 for t in texts if t)} of {len(texts)} non-empty, "
          f"e.g. {texts[:4]}")

    # --- 5. the card against the CPU, same port. The main path's own
    # output on its first det batch (pages 0-7) is held against the CPU
    # on those pages at the same batch sizes, so the crops pool into the
    # same recognition chunks and buckets. The blank-biased recognizer
    # emits mostly empty texts (so does the JAX bench's), so a second
    # check on 2 pages runs the unbiased weights, whose texts are not
    # empty and make the text gate bite. ---
    rec_unbiased = init_state_dict(SVTRRecognizer(vocab, 0.95),
                                   torch.Generator().manual_seed(0))
    cpu_f32 = Runtime1("float32", device="cpu")
    unbiased_gpu = build_pipeline(gpu_f32, det_state, rec_unbiased,
                                  batch=(2, 64)).predict(pages[:2])
    checks = [
        ("main path, blank-biased rec", results[:8],
         build_pipeline(cpu_f32, det_state, rec_state), pages[:8]),
        ("unbiased rec", unbiased_gpu,
         build_pipeline(cpu_f32, det_state, rec_unbiased, batch=(2, 64)),
         pages[:2])]
    for label, gpu_res, cpu_pipe, sub in checks:
        report = compare_results(gpu_res, cpu_pipe.predict(sub))
        n_text = sum(1 for r in gpu_res for x in r.regions if x.text)
        print(f"gpu vs cpu ({len(sub)} pages, float32, {label}, {n_text} "
              f"non-empty texts): {json.dumps(report)}")
        if not report["ok"]:
            raise AssertionError(f"card output disagrees with the CPU "
                                 f"output ({label})")

    # --- 6. throughput ---
    f32_res, f32_pps = timed_pps(pipe, pages, card, "float32")
    bf16_pipe = build_pipeline(Runtime1("bfloat16", device="cuda"),
                               det_state, rec_state)
    bf16_pipe.predict(pages)                       # warm-up call
    bf16_res, bf16_pps = timed_pps(bf16_pipe, pages, card, "bfloat16")
    agree = compare_results(bf16_res, f32_res)
    n_text = sum(len(r.regions) for r in f32_res)
    n_full = sum(1 for r in f32_res for x in r.regions if x.text)
    print(f"bfloat16 vs float32 (16 pages; gate: same region count, mean "
          f"quad IoU >= 0.95): regions {agree['regions']} vs "
          f"{agree['ref_regions']}, mean IoU {agree['mean_iou']!r}, min IoU "
          f"{agree['min_iou']!r}; texts (not gated) "
          f"{n_text - agree['text_mismatches']} of {n_text} equal, "
          f"{n_full} of them non-empty in float32")
    if not (agree["counts_equal"] and agree["mean_iou"] >= 0.95):
        raise AssertionError("OCR bfloat16 boxes disagree with float32")
    print(f"card: {card}; OCR pages/s float32 {f32_pps!r}, bfloat16 "
          f"{bf16_pps!r}")

    # --- 6, texts: the recognizer fitted to drawn lines, bfloat16 against
    # float32 (printed: the gate stays open, ROADMAP queue 3) ---
    fitted = fitted_recognizer(rec_state)
    text_agreement(card, det_state, fitted, pages)
    return main_launches, fitted


# the document chain's pages (phase 15): page index → the CCW rotation
# it arrives with, a quarter of the 16
CHAIN_ROTATIONS = {1: 90, 5: 180, 9: 270, 13: 90}
# a class is compared card against CPU only where its top-2 probability
# gap is at least this (10x the 1e-4 probability gate)
TIE_GAP = 1e-3
CHAIN_STAGES = ("preprocess.orientation", "doc_ori.device",
                "preprocess.rectify", "uvdoc.device", "line_ori.device")


class K1Inputs:
    """While active, keeps the first K1 input of each (caller, shape)
    that the warps (``ops/warp``) and the det resize
    (``ops/det_device.separable_resize_normalize``) hand to
    ``normalize_masked`` for the models named by ``callers`` (default:
    the chain's three): the inputs K1 gets on the main path, for the K1
    cases of :func:`chain_k1_cases`. It only looks; the launch is the
    caller's own and counts as before."""

    CALLERS = ("doc_ori", "uvdoc", "line_ori")

    def __init__(self, callers=CALLERS):
        self.callers = callers
        self.seen = {}

    def __enter__(self):
        from oar_ocr_tpu_torch.ops import det_device, warp

        self.mods = (warp, det_device)
        self.launch = warp.normalize_masked

        def record(x, alpha, beta, **kw):
            key = (kw.get("caller"), tuple(x.shape))
            if key[0] in self.callers and key not in self.seen:
                self.seen[key] = (x, alpha, beta, kw)
            return self.launch(x, alpha, beta, **kw)

        for mod in self.mods:
            mod.normalize_masked = record
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.normalize_masked = self.launch


def chain_k1_cases(seen):
    """K1 at a main path's own inputs (:class:`K1Inputs`),
    each into bfloat16 and float32, held against ``normalize_ref``."""
    import torch

    from oar_ocr_tpu_torch.ops.normalize import normalize_masked, normalize_ref

    cases = []
    for (caller, shape), (x, alpha, beta, kw) in seen.items():
        args = {k: kw[k] for k in ("valid_h", "valid_w", "pad", "swap_rb")}
        for out in (torch.bfloat16, torch.float32):
            tag = "f32" if out == torch.float32 else "bf16"
            plain = (lambda out=out, x=x, a=alpha, b=beta, args=args:
                     normalize_ref(x, a, b, out_dtype=out, **args))
            cases.append((
                f"{caller} {shape} -> {tag}",
                lambda out=out, x=x, a=alpha, b=beta, args=args:
                normalize_masked(x, a, b, out_dtype=out, **args),
                plain, plain, gate_k1, k1_work(x, out)))
    return cases


def chain_pages():
    pages = make_pages(0)
    for i, deg in CHAIN_ROTATIONS.items():
        pages[i] = np.ascontiguousarray(np.rot90(pages[i], deg // 90))
    return pages


def chain_weights(pages):
    """Seeded weights of the chain's three models at full width, made on
    the CPU so the card and the CPU run the same numbers: N(0, 1/fan_in)
    with every BatchNorm's statistics calibrated on the chain's own pages
    (``utils/calibrate.calibrated_state_dict``; uncalibrated, a random
    PP-LCNet's probabilities tie exactly). UVDoc is also returned
    tempered (``utils/calibrate.tempered_uvdoc``) as ``uvdoc``, which the
    chain runs; ``uvdoc_raw`` is the untempered net."""
    import torch

    from oar_ocr_tpu_torch.models.classification.pp_lcnet import (
        ClassifierPreprocess, DirectResizePreprocess)
    from oar_ocr_tpu_torch.models.classification.pp_lcnet_exact import \
        PPLCNetV1Cls
    from oar_ocr_tpu_torch.models.rectification.uvdoc_exact import \
        UVDocNetExact
    from oar_ocr_tpu_torch.ops.warp import (NormSpec, resize_matrix,
                                            sample_transform)
    from oar_ocr_tpu_torch.runtime.runtime import stack_padded
    from oar_ocr_tpu_torch.utils.calibrate import (calibrated_state_dict,
                                                   tempered_uvdoc)

    side = max(max(p.shape[:2]) for p in pages)
    batch = torch.from_numpy(stack_padded(pages, (side, side)))

    def tiles(matrix, h, w, norm, n):
        mats = torch.from_numpy(np.stack([matrix(*p.shape[:2])
                                          for p in pages[:n]]))
        vh = torch.full((n,), h, dtype=torch.int32)
        vw = torch.full((n,), w, dtype=torch.int32)
        return sample_transform(batch, mats, torch.arange(n), vw, vh,
                                out_h=h, out_w=w, norm=norm)

    imagenet = NormSpec.imagenet_rgb()
    doc = calibrated_state_dict(
        PPLCNetV1Cls(4, 1.0), torch.Generator().manual_seed(3),
        tiles(ClassifierPreprocess().matrix, 224, 224, imagenet,
              len(pages)))
    line = calibrated_state_dict(
        PPLCNetV1Cls(2, 0.25), torch.Generator().manual_seed(2),
        tiles(DirectResizePreprocess().matrix, 80, 160, imagenet,
              len(pages)))
    uvdoc = calibrated_state_dict(
        UVDocNetExact(32), torch.Generator().manual_seed(3),
        tiles(lambda h, w: resize_matrix(h, w, 712, 488), 712, 488,
              NormSpec(alpha=(1 / 255.0,) * 3, beta=(0.0,) * 3), 2))
    return {"doc": doc, "line": line, "uvdoc": tempered_uvdoc(uvdoc),
            "uvdoc_raw": uvdoc}


def chain_pipeline(runtime, det_state, rec_state, weights, batch=(8, 64)):
    """The chain as a caller with weights builds it: the builder's det,
    rec and word-box options, and the three stages on ``weights`` (the
    builder's own stage options run seeded random weights only)."""
    from oar_ocr_tpu_torch.models.classification.pp_lcnet import (
        doc_orientation_classifier, textline_orientation_classifier)
    from oar_ocr_tpu_torch.models.rectification.uvdoc import UVDocRectifier
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCR, OAROCRBuilder
    from oar_ocr_tpu_torch.pipelines.preprocess import DocumentPreprocessor

    pipe = (OAROCRBuilder("general").with_runtime(runtime)
            .with_det_params(det_state).with_rec_params(rec_state)
            .with_word_boxes()
            .with_batch_sizes(image=batch[0], region=batch[1]).build())
    pre = DocumentPreprocessor(
        orientation=doc_orientation_classifier(weights["doc"], runtime),
        rectifier=UVDocRectifier(weights["uvdoc"], runtime=runtime),
        use_orientation=True, use_rectification=True, runtime=runtime)
    return OAROCR(pipe.detector, pipe.recognizer, pipe.cfg, runtime,
                  preprocessor=pre, line_orienter=(
                      textline_orientation_classifier(weights["line"],
                                                      runtime)))


def gate_probs(what: str, card, cpu, tol: float) -> None:
    """Probabilities within ``tol``; classes equal where the top-2 gap is
    clear (≥ TIE_GAP); prints how many were ties."""
    err = float(np.abs(card - cpu).max())
    top2 = np.sort(cpu, 1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] >= TIE_GAP
    same = card.argmax(1)[clear] == cpu.argmax(1)[clear]
    print(f"  {what}: {len(cpu)} items, probabilities max abs err {err!r} "
          f"(gate {tol!r}), {int((~clear).sum())} ties (top-2 gap < "
          f"{TIE_GAP}) skipped, {int(same.sum())} of {int(clear.sum())} "
          f"classes equal, classes {np.bincount(cpu.argmax(1)).tolist()}")
    if err > tol or not same.all():
        raise AssertionError(f"{what}: card disagrees with the CPU")


def gate_rectified(card_pages, cpu_pages, gate: bool = True) -> None:
    """Rectified uint8 pages: max|Δ| ≤ 1 on at most 0.1% of the pixels;
    only printed when not ``gate``."""
    diff = [np.abs(a.astype(np.int16) - b.astype(np.int16))
            for a, b in zip(card_pages, cpu_pages)]
    worst = max(int(d.max()) for d in diff)
    share = sum(int((d > 0).sum()) for d in diff) / sum(d.size for d in diff)
    print(f"  rectified pages ({len(diff)}): max|diff| {worst}, share of "
          f"pixels that differ {share!r} (gate: max 1 on <= 0.001)")
    if gate and (worst > 1 or share > 1e-3):
        raise AssertionError("rectified pages: card disagrees with the CPU")


class Preprocessed:
    """A document preprocessor that hands back pages it was given, already
    preprocessed (``DocumentPreprocessor.preprocess``'s output)."""

    def __init__(self, pages):
        self.pages = pages

    def preprocess(self, images):
        return [dataclasses.replace(p) for p in self.pages]


def gate_chain_results(card_res, cpu_res, gate: bool = True) -> None:
    """Boxes IoU ≥ 0.99, identical texts, line angles, word-box counts;
    the pages' orientation and rectified flags equal; only printed when
    not ``gate``."""
    from oar_ocr_tpu_torch.utils.parity import compare_results

    report = compare_results(card_res, cpu_res)
    print(f"  chain results vs CPU: {json.dumps(report)}")
    same = report["counts_equal"] and report["text_mismatches"] == 0 and (
        report["min_iou"] is None or report["min_iou"] >= 0.99)
    n_angle = n_words = 0
    for o, r in zip(card_res, cpu_res):
        same &= (o.orientation_angle, o.rectified, o.width, o.height) == \
            (r.orientation_angle, r.rectified, r.width, r.height)
        for a, b in zip(o.regions, r.regions):
            same &= a.orientation_angle == b.orientation_angle
            same &= len(a.word_boxes or []) == len(b.word_boxes or [])
            n_angle += a.orientation_angle == 180
            n_words += len(a.word_boxes or [])
    print(f"  {report['regions']} regions, {n_angle} turned 180, "
          f"{n_words} word boxes; page angles "
          f"{[r.orientation_angle for r in cpu_res]}; all equal {same}")
    if gate and (not same or report["regions"] == 0):
        raise AssertionError("chain results: card disagrees with the CPU "
                             "(or found no region)")


def stage_ms(reset: bool = False) -> dict:
    """Host ms per call of the chain's stages (``utils/tracing``)."""
    from oar_ocr_tpu_torch.utils.tracing import METRICS

    out = {k: (n, tot * 1e3 / n) for k, (n, tot, _) in
           METRICS.summary().items()}
    if reset:
        METRICS.reset()
    return out


def chain_phase(card: str, det_state, rec_state):
    """Phase 15: the document chain (orientation, UVDoc rectification,
    text-line orientation, word boxes) at full width; returns K1's
    launches on it and its K1 inputs (:class:`K1Inputs`)."""
    import torch

    from oar_ocr_tpu_torch.models.rectification.uvdoc import UVDocRectifier
    from oar_ocr_tpu_torch.models.rectification.uvdoc_exact import \
        UVDOC_INPUT_HW
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER
    from oar_ocr_tpu_torch.ops.warp import resize_matrix
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCR
    from oar_ocr_tpu_torch.processors.geometry import order_quad_points
    from oar_ocr_tpu_torch.runtime.runtime import DET_SIDE_BUCKETS
    from oar_ocr_tpu_torch.utils.calibrate import UVDOC_GRID_GAIN

    pages = chain_pages()
    t0 = time.perf_counter()
    weights = chain_weights(pages)
    print(f"chain weights (calibrated on the CPU) in "
          f"{time.perf_counter() - t0!r} s")
    gpu = chain_pipeline(Runtime1("float32", device="cuda"), det_state,
                         rec_state, weights)

    # the main path: counts zeroed just before, read just after
    K1.launches = 0
    LAUNCHES_BY_CALLER.clear()
    with K1Inputs() as k1_inputs:
        t0 = time.perf_counter()
        results = gpu.predict(pages)
        dt = time.perf_counter() - t0
    main = K1.launches
    by_caller = dict(LAUNCHES_BY_CALLER)
    n_regions = sum(len(r.regions) for r in results)
    print(f"chain predict: {len(results)} results, {n_regions} regions, "
          f"{dt * 1e3!r} ms, page angles "
          f"{[r.orientation_angle for r in results]}, K1 launches {main} "
          f"by caller {by_caller}")
    if len(results) != N_PAGES or not all(r.rectified for r in results):
        raise AssertionError("chain predict: a page was not rectified")
    for caller in ("det", "rec", "doc_ori", "uvdoc", "line_ori"):
        if by_caller.get(caller, 0) == 0 and (caller != "rec" or n_regions):
            raise AssertionError(f"chain predict launched no K1 for "
                                 f"{caller}")
    if not all(np.isfinite(np.asarray(x.box, np.float32)).all()
               for r in results for x in r.regions):
        raise AssertionError("chain predict: non-finite box")
    print(f"  K1 inputs by caller on it: "
          f"{sorted(k1_inputs.seen)}")
    if {c for c, _ in k1_inputs.seen} != set(K1Inputs.CALLERS):
        raise AssertionError("chain predict: a model's K1 input was not "
                             "seen")

    print("chain, card vs CPU (float32, pages 0-7, the first det batch):")
    cpu = chain_pipeline(Runtime1("float32", device="cpu"), det_state,
                         rec_state, weights)
    sub = pages[:8]
    shapes = [p.shape[:2] for p in sub]
    bucket = (DET_SIDE_BUCKETS.bucket(max(h for h, _ in shapes)),
              DET_SIDE_BUCKETS.bucket(max(w for _, w in shapes)))
    probs = {}
    for label, pipe in (("card", gpu), ("cpu", cpu)):
        probs[label] = pipe.preprocessor.orientation.probs_pages(
            pipe.runtime.put_pages(sub, bucket), shapes)
    gate_probs("doc orientation", probs["card"], probs["cpu"], 1e-4)
    card_pre = gpu.preprocessor.preprocess(sub)
    cpu_pre = cpu.preprocessor.preprocess(sub)
    gate_rectified([p.image for p in card_pre], [p.image for p in cpu_pre])
    # the rest of the chain on the card's rectified pages: their ±1
    # pixels, gated above, reach the random recognizer's near-ties (the
    # end-to-end reading below shows it), so det, text-line orientation,
    # rec and word boxes are held on the same input
    cpu_res = OAROCR(cpu.detector, cpu.recognizer, cpu.cfg, cpu.runtime,
                     preprocessor=Preprocessed(card_pre),
                     line_orienter=cpu.line_orienter).predict(sub)
    gate_chain_results(results[:8], cpu_res)
    print("  end to end, the CPU's own rectified pages (not gated):")
    gate_chain_results(results[:8], cpu.predict(sub), gate=False)
    rect = [p.image for p in card_pre]
    rshape = (DET_SIDE_BUCKETS.bucket(max(p.shape[0] for p in rect)),
              DET_SIDE_BUCKETS.bucket(max(p.shape[1] for p in rect)))
    quads = [(i, order_quad_points(x.box)) for i, r in enumerate(cpu_res)
             for x in r.regions]
    if quads:
        line = {label: pipe.line_orienter.probs_quads(
            pipe.runtime.put_pages(rect, rshape), quads)
            for label, pipe in (("card", gpu), ("cpu", cpu))}
        gate_probs("text-line orientation", line["card"], line["cpu"], 1e-4)

    print("UVDoc untempered (calibrated, utils/calibrate.tempered_uvdoc "
          "not applied), float32, card vs CPU, pages 0-7:")
    t0 = time.perf_counter()
    raw = {dev: UVDocRectifier(weights["uvdoc_raw"], runtime=Runtime1(
        "float32", device=dev)) for dev in ("cuda", "cpu")}
    raw_grid = {dev: [r.grid(r.runtime.put(p[None]),
                             resize_matrix(*p.shape[:2], *UVDOC_INPUT_HW)[None]
                             ).cpu() for p in sub]
                for dev, r in raw.items()}
    rerr = max(float((a - b).abs().max()) for a, b in
               zip(raw_grid["cuda"], raw_grid["cpu"]))
    print(f"  grid max abs err {rerr!r} (gate 1e-4)")
    if rerr > 1e-4:
        raise AssertionError("untempered UVDoc grid: card disagrees with "
                             "the CPU")
    print("  rectified pages of the untempered net (not gated; the chain "
          "runs the tempered one):")
    gate_rectified([raw["cuda"].rectify(p) for p in sub],
                   [raw["cpu"].rectify(p) for p in sub], gate=False)
    print(f"  untempered UVDoc card vs CPU in "
          f"{time.perf_counter() - t0!r} s")
    del raw

    print("chain, bfloat16 vs float32 on the card:")
    gpu_bf16 = chain_pipeline(Runtime1("bfloat16", device="cuda"), det_state,
                              rec_state, weights)
    bf16_probs = gpu_bf16.preprocessor.orientation.probs_pages(
        gpu_bf16.runtime.put_pages(sub, bucket), shapes)
    gate_probs("doc orientation bf16", bf16_probs, probs["card"], 2e-2)
    mats = resize_matrix(*sub[0].shape[:2], *UVDOC_INPUT_HW)[None]
    grids = [p.preprocessor.rectifier.grid(
        p.runtime.put(sub[0][None]), mats) for p in (gpu_bf16, gpu)]
    gerr = float((grids[0] - grids[1]).abs().max())
    print(f"  UVDoc grid bf16 vs f32: max abs err {gerr!r} (gate 2e-2 on "
          f"the tempered net, {2e-2 / UVDOC_GRID_GAIN!r} on the untempered "
          f"projection), dtypes {grids[0].dtype}, {grids[1].dtype}")
    if gerr > 2e-2:
        raise AssertionError("UVDoc grid: bfloat16 disagrees with float32")
    raw = {dt: UVDocRectifier(weights["uvdoc_raw"], runtime=Runtime1(
        dt, device="cuda")) for dt in ("bfloat16", "float32")}
    grids = [r.grid(r.runtime.put(sub[0][None]), mats) for r in raw.values()]
    print(f"  untempered UVDoc grid bf16 vs f32 (not gated): max abs err "
          f"{float((grids[0] - grids[1]).abs().max())!r}")
    del raw, grids

    print("chain times:")
    for label, pipe in (("float32", gpu), ("bfloat16", gpu_bf16)):
        pipe.predict(pages)                            # warm-up call
        stage_ms(reset=True)
        before = dict(LAUNCHES_BY_CALLER)
        _, pps = timed_pps(pipe, pages, card, f"chain {label}")
        per = {k: (v - before.get(k, 0)) / TIMED_ITERS
               for k, v in LAUNCHES_BY_CALLER.items()}
        stages = stage_ms()
        for k in CHAIN_STAGES:
            n, ms = stages.get(k, (0, 0.0))
            print(f"  {label} {k}: {ms!r} ms per call, "
                  f"{n / TIMED_ITERS!r} calls per predict  [{card}]")
        print(f"  {label} K1 launches per predict by caller: {per}")
        plain = build_pipeline(pipe.runtime, det_state, rec_state)
        plain.predict(pages)
        _, plain_pps = timed_pps(plain, pages, card, f"no chain {label}")
        print(f"  {label}: {pps!r} pages/s with the chain, {plain_pps!r} "
              f"without  [{card}]")
    del gpu, gpu_bf16
    torch.cuda.empty_cache()
    return main, k1_inputs.seen


def seal_phase(card: str, det_state, rec_state) -> dict:
    """Phase 16: ``OAROCRBuilder("seal")`` and a ``ScoreMode.SLOW``
    pipeline on the bench pages; returns K1's launches on them."""
    import torch

    from oar_ocr_tpu_torch.core.types import ScoreMode
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
    from oar_ocr_tpu_torch.utils.parity import compare_results

    pages = make_pages(0)

    def pipeline(device, text_type, **det_cfg):
        return (OAROCRBuilder(text_type)
                .with_runtime(Runtime1("float32", device=device))
                .with_det_params(det_state).with_rec_params(rec_state)
                .with_det_config(**det_cfg)
                .with_batch_sizes(image=8, region=64).build())

    launches = {}
    for label, text_type, det_cfg in (
            ("seal", "seal", {}),
            ("slow", "general", {"score_mode": ScoreMode.SLOW})):
        gpu = pipeline("cuda", text_type, **det_cfg)
        gpu.predict(pages[:2])                         # warm-up call
        stage_ms(reset=True)
        K1.launches = 0
        t0 = time.perf_counter()
        results = gpu.predict(pages)
        dt = time.perf_counter() - t0
        launches[label] = K1.launches
        n = sum(len(r.regions) for r in results)
        verts = [x.box.shape[0] for r in results for x in r.regions]
        stages = stage_ms()
        print(f"{label} predict: {n} regions ({n / N_PAGES!r}/page), "
              f"{dt * 1e3!r} ms per {len(pages)} pages, vertices per box "
              f"{min(verts) if verts else None}-"
              f"{max(verts) if verts else None}, K1 launches "
              f"{launches[label]}  [{card}]")
        for k in ("det.candidates", "det.poly_scores", "det.prob_fetch",
                  "det.postprocess_host", "det.finalize"):
            if k in stages:
                print(f"  {label} {k}: {stages[k][1]!r} ms per call, "
                      f"{stages[k][0]} calls  [{card}]")
        if n == 0 or launches[label] == 0:
            raise AssertionError(f"{label}: no region or no K1 launch")
        got = pipeline("cuda", text_type, **det_cfg).predict(pages[:2])
        want = pipeline("cpu", text_type, **det_cfg).predict(pages[:2])
        err, same = 0.0, True
        for o, r in zip(got, want):
            same &= len(o.regions) == len(r.regions)
            for a, b in zip(o.regions, r.regions):
                same &= a.box.shape == b.box.shape and a.text == b.text
                if a.box.shape == b.box.shape:
                    same &= bool(np.allclose(a.box, b.box, atol=1e-3))
                err = max(err, abs(a.det_score - b.det_score))
        m = sum(len(r.regions) for r in want)
        n_text = sum(1 for r in want for x in r.regions if x.text)
        print(f"  {label} card vs CPU (2 pages, float32): {m} regions, "
              f"{n_text} non-empty texts, same boxes and texts {same}, "
              f"box scores max abs err {err!r} (gate 1e-5)")
        if label == "slow":
            print(f"  {json.dumps(compare_results(got, want))}")
        if not same or err > 1e-5 or m == 0:
            raise AssertionError(f"{label}: card disagrees with the CPU")
        del gpu
        torch.cuda.empty_cache()
    return launches


def vl_requests(vlm, page, crop, label: str):
    """Phase 8: the two VL requests through ``generate``; checks results
    and the launch counts of K2 and K3 per request."""
    from oar_ocr_tpu_torch.ops.flash_attention import KERNEL as K2
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3

    c = vlm.cfg
    images = {"ocr": [page, crop], "spotting": [page]}
    for task, n_img, max_new in VL_REQUESTS:
        k2, k3 = K2.launches, K3.launches
        t0 = time.perf_counter()
        res = vlm.generate(images[task], task, max_new_tokens=max_new)
        dt = time.perf_counter() - t0
        k2, k3 = K2.launches - k2, K3.launches - k3
        print(f"VL {label} {task}: {len(res)} results, prompts "
              f"{[r.num_prompt_tokens for r in res]}, new tokens "
              f"{[len(r.token_ids) for r in res]}, {dt * 1e3!r} ms, "
              f"K2 launches {k2}, K3 launches {k3}")
        if len(res) != n_img or [r.num_prompt_tokens for r in res] \
                != VL_PROMPTS[task]:
            raise AssertionError(f"VL {label} {task}: wrong results/prompts")
        if any(len(r.token_ids) > max_new for r in res):
            raise AssertionError(f"VL {label} {task}: too many tokens")
        want = (c.v_layers, c.layers * 2 * (1 + max_new))
        if (k2, k3) != want:
            raise AssertionError(f"VL {label} {task}: launches (K2, K3) "
                                 f"{(k2, k3)}, design predicts {want}")


def vl_logits(vlm, images, task, max_new, feed=None, graph=True):
    """Vision embeddings, prefill logits, ids and each decode step's
    logits of one batch, through the generate path's own stages; the
    decoder takes ``feed`` as the image embeddings when it is given, and
    decodes eagerly when ``graph`` is False."""
    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    rt = vlm.runtime
    batch = vlm.prepare_vision(images, task)
    img = vlm.encode_vision(batch)
    prompts = vlm.build_prompts(batch, task)
    feed = img if feed is None else feed.to(img.device)
    steps = []
    ids, logits = vlm.prefill_decode(
        vlm.fuse_embeds(prompts, feed), rt.put(prompts.positions),
        rt.put(prompts.valid_lengths), max_new=max_new,
        capacity=decoder_cache_capacity(prompts.ids.shape[1], max_new),
        step_logits=steps, graph=graph)
    return img, logits, ids, steps


def card_vs_cpu(what: str, card, cpu, vision_gate: float,
                exact_ids: bool = False) -> float:
    """The card's (vision, prefill logits, ids, step logits) against the
    CPU's: vision relative error ≤ ``vision_gate``; prefill logits max abs
    error ≤ 1e-3·max|logit|; each decode step's logits, up to the first
    token where the ids differ, ≤ 1e-3 of their max|logit|; greedy ids
    identical, or (unless ``exact_ids``) identical up to a token the
    CPU chose with a top-2 logit margin < 1e-4. Returns the vision
    relative error."""
    import torch

    (g_img, g_logits, g_ids, g_steps), (c_img, c_logits, c_ids, steps) = \
        card, cpu
    g_img, c_img = g_img.float().cpu(), c_img.float()
    rel = float((g_img - c_img).abs().max() / c_img.abs().max())
    lerr = float((g_logits.cpu() - c_logits).abs().max())
    lmax = float(c_logits.abs().max())
    g_ids, c_ids = g_ids.cpu()[0].tolist(), c_ids[0].tolist()
    # decode step i was fed tokens 0..i: compare the steps before the
    # first token where the two sides differ
    same = 0
    while same < len(c_ids) and g_ids[same] == c_ids[same]:
        same += 1
    serr = max((float((g.cpu() - c).abs().max() / c.abs().max())
                for g, c in zip(g_steps[:same], steps[:same])), default=0.0)
    print(f"{what}: vision relative error {rel!r} (gate {vision_gate!r}), "
          f"prefill logits max abs error {lerr!r} vs max|logit| {lmax!r} "
          f"(gate 1e-3 x), decode-step logits max abs error / max|logit| "
          f"{serr!r} over {same} steps (gate 1e-3)")
    if not (rel <= vision_gate and lerr <= 1e-3 * lmax and serr <= 1e-3):
        raise AssertionError(f"{what}: the card disagrees with the CPU")
    if not torch.isfinite(g_logits).all():
        raise AssertionError(f"{what}: non-finite logits on the card")
    if same == len(c_ids):
        print(f"  greedy ids identical over {same} tokens: {g_ids}")
        return rel
    # token i came from the prefill logits (i = 0) or decode step i - 1
    top2 = torch.topk(([c_logits] + steps)[same][0], 2).values
    margin = float(top2[0] - top2[1])
    print(f"  ids diverge at token {same}: card {g_ids[same]}, cpu "
          f"{c_ids[same]}, cpu top-2 margin {margin!r}; comparison stops "
          f"here")
    if exact_ids or margin >= 1e-4:
        raise AssertionError(f"{what}: greedy ids diverge")
    return rel


def graph_vs_eager(what: str, graph, eager) -> None:
    """The replayed decode graph against the eager step on the card, on
    the same inputs: identical ids and prefill logits, each step's logits
    within 1e-5 of max|logit| (the same kernels; cuBLAS may pick other
    algorithms under capture)."""
    import torch

    (_, g_logits, g_ids, g_steps), (_, e_logits, e_ids, e_steps) = \
        graph, eager
    same = torch.equal(g_ids.cpu(), e_ids.cpu())
    err = max(float((g - e).abs().max() / e.abs().max())
              for g, e in zip(g_steps, e_steps))
    print(f"{what}: graph vs eager, ids identical {same} over "
          f"{g_ids.shape[1]} tokens, prefill logits equal "
          f"{torch.equal(g_logits, e_logits)}, decode-step logits max abs "
          f"error / max|logit| {err!r} over {len(g_steps)} steps (gate "
          f"1e-5)")
    if not same or len(g_steps) != len(e_steps) or err > 1e-5:
        raise AssertionError(f"{what}: the decode graph disagrees with the "
                             "eager step")


def device_busy(run, counter, marker: str, setup=lambda: None,
                tries: int = 5):
    """The kernels' device ms in a CUDA profile of ``run(setup())``
    (``setup`` out of it), the profile taken again until it holds every
    launch of ``counter`` (whose kernel's name holds ``marker``) the run
    counted and no more kernel time than its wall → (kernel ms or None,
    the profiled run's wall ms). The profiler slows the host's side, so
    a busy share divides the kernel ms by an unprofiled wall where the
    run does host work between its launches."""
    import torch

    wall = None
    for _ in range(tries):
        arg = setup()
        torch.cuda.synchronize()
        n0 = counter.launches
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            run(arg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
            time.sleep(0.05)
        evs = prof.key_averages()
        traced = sum(ev.count for ev in evs if marker in ev.key)
        busy = sum(ev.self_device_time_total for ev in evs) / 1e3
        if traced == counter.launches - n0 and busy <= wall:
            return busy, wall
        print(f"  (the trace holds {traced} of {counter.launches - n0} "
              f"{marker} launches and {busy!r} ms of kernels in {wall!r} "
              f"ms: taken again)")
    return None, wall


def pool_bytes(pool) -> int:
    """Device memory a CUDA graph pool (``graph.pool()``) holds: the
    caching allocator's segments owned by it."""
    import torch

    pool = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)


def graph_report(model, card: str, label: str, per_step: dict) -> None:
    """Phases 10 and 14: each decode graph the model captured, its
    capture ms and pool memory, and the launches one replay runs, which
    must be the design's per step (``per_step``: kernel → launches)."""
    for (b, cap, dt), st in model.decode_graphs.states.items():
        if st.graph is None:
            continue
        got = {k.name: n for k, n in st.launches.counts.items()}
        want = {k.name: n for k, n in per_step.items()}
        print(f"  decode graph {label} (batch {b}, capacity {cap}, {dt}): "
              f"capture {st.capture_ms!r} ms, pool "
              f"{pool_bytes(st.graph.pool()) / 2 ** 20!r} MiB, launches per replay "
              f"{got}  [{card}]")
        if got != want:
            raise AssertionError(f"decode graph {label} ({b}, {cap}): "
                                 f"launches per replay {got}, the design "
                                 f"{want}")


def check_dtype_policy(model, vision) -> None:
    """Phases 8 and 12: the JAX package's dtype policy on the card: the
    ``vision`` submodules' parameters in the Runtime's compute dtype,
    every other one (decoder, LM head) float32."""
    import torch

    dt = model.runtime.compute_dtype
    bad = [n for n, p in model.net.named_parameters()
           if p.dtype != (dt if n.startswith(vision) else torch.float32)]
    if bad:
        raise AssertionError(f"parameters outside the dtype policy under "
                             f"{dt}: {bad[:4]}")


def vl_gpu_vs_cpu(models, crop) -> dict:
    """Phase 9: full width, the card against the CPU on the crop with 16
    new tokens, in float32 and in bfloat16 (the JAX dtype policy on both
    sides: bfloat16 vision, float32 decoder). In bfloat16 both decoders
    take the CPU's image embeddings, so the logits gate holds the decoder
    and the vision gate the tower. Returns the vision errors."""
    from oar_ocr_tpu_torch.vl import PaddleOCRVL

    state = {k: v.cpu()
             for k, v in models["float32"].net.state_dict().items()}
    rels = {}
    for label, gate in (("float32", 1e-4), ("bfloat16", VL_BF16_VISION_REL)):
        cpu_vlm = PaddleOCRVL(state, cfg=models[label].cfg,
                              runtime=Runtime1(label, device="cpu"))
        cpu = vl_logits(cpu_vlm, [crop], "ocr", 16)
        del cpu_vlm
        feed = None if label == "float32" else cpu[0]
        # the first call captures this key's graph; the gated one replays
        # it at every step
        vl_logits(models[label], [crop], "ocr", 16, feed=feed)
        card = vl_logits(models[label], [crop], "ocr", 16, feed=feed)
        graph_vs_eager(f"VL ({label}, 448x448, 16 tokens)", card,
                       vl_logits(models[label], [crop], "ocr", 16, feed=feed,
                                 graph=False))
        rels[label] = card_vs_cpu(f"VL gpu vs cpu ({label}, 448x448, 16 "
                                  f"tokens, decode graph)", card, cpu, gate)
    return rels


def vl_times(vlm, page, crop, card: str, label: str) -> None:
    """Phase 10: vision, prefill and decode times of request 1, and the
    model's decode graphs."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3

    rt = vlm.runtime
    torch.cuda.reset_peak_memory_stats()
    prepare_ms = host_ms(lambda: vlm.prepare_vision([page, crop], "ocr"))
    batch = vlm.prepare_vision([page, crop], "ocr")
    vision_ms = host_ms(lambda: vlm.encode_vision(batch))
    img = vlm.encode_vision(batch)
    prompts = vlm.build_prompts(batch, "ocr")
    embeds = vlm.fuse_embeds(prompts, img)
    pos, vl = rt.put(prompts.positions), rt.put(prompts.valid_lengths)
    capacity = 2048                       # request 1's bucket, pinned

    def run(max_new, graph=True):
        return vlm.prefill_decode(embeds, pos, vl, max_new=max_new,
                                  capacity=capacity, graph=graph)[0].cpu()

    prefill_ms = host_ms(lambda: run(0))
    t32 = host_ms(lambda: run(32))
    t128 = host_ms(lambda: run(128))
    decode_ms = (t128 - t32) / 96
    e32 = host_ms(lambda: run(32, graph=False))
    e128 = host_ms(lambda: run(128, graph=False))
    same = torch.equal(run(128), run(128, graph=False))
    if not same:
        raise AssertionError(f"VL {label} request 1: the decode graph's 128 "
                             "ids differ from the eager step's")
    b = len(prompts.valid_lengths)
    gen_ms = host_ms(lambda: vlm.generate([page, crop], "ocr",
                                          max_new_tokens=128,
                                          min_capacity=capacity), iters=2)
    out = {"host_prepare_ms": prepare_ms, "vision_ms": vision_ms,
           "prefill_ms": prefill_ms,
           "decode_ms_per_token": decode_ms,
           "decode_tokens_per_s": b * 1e3 / decode_ms,
           "eager_decode_ms_per_token": (e128 - e32) / 96,
           "graph_ids_equal_eager": same,
           "generate_ms": gen_ms,
           "generate_tokens_per_s": b * 128 * 1e3 / gen_ms,
           "t32_ms": t32, "t128_ms": t128, "eager_t32_ms": e32,
           "eager_t128_ms": e128,
           # both models resident; the peak of this phase alone
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"VL times {label} (request 1: batch {b}, vision tokens "
          f"{batch.patches.shape[1]}, prompt {prompts.ids.shape[1]}, KV "
          f"capacity {capacity}): {json.dumps(out)} [{card}]")
    graph_report(vlm, card, f"VL {label}", {K3: 2 * vlm.cfg.layers})


def vl_phases(card: str, kernels) -> dict:
    """Phases 7-10; returns the K2/K3 records and their main-path
    launches."""
    import torch

    from oar_ocr_tpu_torch.ops.flash_attention import KERNEL as K2
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.vl import PaddleOCRVL

    print("K2/K3 vs plain version:")
    cases = {"K2": k2_cases(), "K3": k3_cases()}
    k2, k3 = run_cases(cases["K2"], card), run_cases(cases["K3"], card)
    torch.cuda.empty_cache()

    page = make_pages(0)[0]
    crop = np.ascontiguousarray(page[:448, :448])
    models = {}
    for label in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        models[label] = PaddleOCRVL(runtime=Runtime1(label, device="cuda"),
                                    seed=0)
        n = sum(p.numel() for p in models[label].net.parameters())
        print(f"VL model {label}: {n} parameters, built in "
              f"{time.perf_counter() - t0!r} s")
    # the main path: the bfloat16 model's two requests; the counts are
    # zeroed just before and read just after
    for k in kernels:
        k.launches = 0
    vl_requests(models["bfloat16"], page, crop, "bfloat16")
    main = {"K2": K2.launches, "K3": K3.launches}
    # the same requests again: every decode step a replay of the graphs
    # the first run captured, with the same launch counts
    vl_requests(models["bfloat16"], page, crop, "bfloat16, graphs built")
    vl_requests(models["float32"], page, crop, "float32")
    for vlm in models.values():
        check_dtype_policy(vlm, ("visual.", "mlp_AR."))
    vl_gpu_vs_cpu(models, crop)
    for label, vlm in models.items():
        vl_times(vlm, page, crop, card, label)
    return {"K2": k2, "K3": k3, "cases": cases, "launches": main}


def hy_request(model, page, label: str):
    """Phase 12: one HunyuanOCR request through ``generate``; checks the
    result, the request's shapes and the launch counts of K2-K4."""
    from oar_ocr_tpu_torch.ops.flash_attention import KERNEL as K2
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL_QK as K4

    c = model.cfg
    _, gh, gw = model.prepare_image(page)
    ids, _, n_img = model.build_prompt(gh, gw, "OCR:")
    if (gh * gw, len(ids)) != (HY_VISION_TOKENS, HY_PROMPT):
        raise AssertionError(f"HunyuanOCR {label}: {gh * gw} vision tokens, "
                             f"prompt {len(ids)}")
    before = (K2.launches, K3.launches, K4.launches)
    t0 = time.perf_counter()
    out = model.generate([page], "OCR:", max_new_tokens=HY_MAX_NEW)
    dt = time.perf_counter() - t0
    got = tuple(k.launches - b for k, b in zip((K2, K3, K4), before))
    # per forward: K3 at 2 sites a layer, K4 once a layer (q and k)
    want = (c.v_layers, 2 * c.layers * (1 + HY_MAX_NEW),
            c.layers * (1 + HY_MAX_NEW))
    print(f"HunyuanOCR {label}: {len(out)} result, text {out[0][:24]!r}, "
          f"vision tokens {gh * gw}, image tokens {n_img}, prompt "
          f"{len(ids)}, {dt * 1e3!r} ms, launches (K2, K3, K4) {got}")
    if len(out) != 1 or not isinstance(out[0], str):
        raise AssertionError(f"HunyuanOCR {label}: expected one text")
    if got != want:
        raise AssertionError(f"HunyuanOCR {label}: launches (K2, K3, K4) "
                             f"{got}, design predicts {want}")


def hy_logits(model, image, max_new: int, feed=None, graph=True):
    """Vision embeddings, prefill logits, ids and each decode step's
    logits of one image, through the generate path's own stages; the
    decoder takes ``feed`` as the image embeddings when it is given, and
    decodes eagerly when ``graph`` is False."""
    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    patches, gh, gw = model.prepare_image(image)
    img = model.encode_image(patches, model.position_rows(gh, gw), gh, gw)
    ids, pids, _ = model.build_prompt(gh, gw, "OCR:")
    embeds = model.fuse_embeds(ids, img if feed is None
                               else feed.to(img.device))
    steps = []
    out, logits = model.prefill_decode(
        embeds, model.runtime.put(pids)[:, None, :], max_new=max_new,
        capacity=decoder_cache_capacity(len(ids), max_new),
        step_logits=steps, graph=graph)
    return img, logits, out, steps


def hy_gpu_vs_cpu(models, crop) -> dict:
    """Phase 13: full width, the card against the CPU on the crop with 16
    new tokens, in float32 (identical ids) and in bfloat16 (the JAX dtype
    policy on both sides; both decoders take the CPU's image
    embeddings). Returns the vision errors."""
    from oar_ocr_tpu_torch.vl.hunyuan import HunyuanOCRModel

    state = {k: v.cpu()
             for k, v in models["float32"].net.state_dict().items()}
    rels = {}
    for label, gate in (("float32", 1e-4), ("bfloat16", HY_BF16_VISION_REL)):
        cpu_model = HunyuanOCRModel(state, cfg=models[label].cfg,
                                    runtime=Runtime1(label, device="cpu"))
        cpu = hy_logits(cpu_model, crop, 16)
        del cpu_model
        feed = None if label == "float32" else cpu[0]
        # the first call captures this key's graph; the gated one replays
        # it at every step
        hy_logits(models[label], crop, 16, feed=feed)
        card = hy_logits(models[label], crop, 16, feed=feed)
        graph_vs_eager(f"HunyuanOCR ({label}, 448x448, 16 tokens)", card,
                       hy_logits(models[label], crop, 16, feed=feed,
                                 graph=False))
        rels[label] = card_vs_cpu(
            f"HunyuanOCR gpu vs cpu ({label}, 448x448, 16 tokens, decode "
            f"graph)", card, cpu, gate, exact_ids=label == "float32")
    return rels


def hy_times(model, page, card: str, label: str) -> None:
    """Phase 14: host preprocessing (resize + patchify, then the position
    rows' interpolation), vision (upload + tower), prefill and decode
    times of the HunyuanOCR request, and the model's decode graphs."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL_QK as K4

    rt = model.runtime
    torch.cuda.reset_peak_memory_stats()
    patches, gh, gw = model.prepare_image(page)
    prepare_ms = host_ms(lambda: model.prepare_image(page))
    positions_ms = host_ms(lambda: model.position_rows(gh, gw))
    pos = model.position_rows(gh, gw)
    vision_ms = host_ms(lambda: model.encode_image(patches, pos, gh, gw))
    ids, pids, _ = model.build_prompt(gh, gw, "OCR:")
    embeds = model.fuse_embeds(ids, model.encode_image(patches, pos, gh, gw))
    pids = rt.put(pids)[:, None, :]
    capacity = 2048                        # the request's bucket, pinned

    def run(max_new, graph=True):
        return model.prefill_decode(embeds, pids, max_new=max_new,
                                    capacity=capacity, graph=graph)

    _, logits = run(0)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"non-finite HunyuanOCR {label} logits")
    prefill_ms = host_ms(lambda: run(0)[0].cpu())
    t16 = host_ms(lambda: run(16)[0].cpu())
    t64 = host_ms(lambda: run(HY_MAX_NEW)[0].cpu())
    decode_ms = (t64 - t16) / (HY_MAX_NEW - 16)
    e16 = host_ms(lambda: run(16, graph=False)[0].cpu())
    e64 = host_ms(lambda: run(HY_MAX_NEW, graph=False)[0].cpu())
    same = torch.equal(run(HY_MAX_NEW)[0], run(HY_MAX_NEW, graph=False)[0])
    if not same:
        raise AssertionError(f"HunyuanOCR {label}: the decode graph's ids "
                             "differ from the eager step's")
    gen_ms = host_ms(lambda: model.generate([page], "OCR:",
                                            max_new_tokens=HY_MAX_NEW),
                     iters=2)
    out = {"host_prepare_ms": prepare_ms,
           "host_positions_ms": positions_ms, "vision_ms": vision_ms,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "decode_tokens_per_s": 1e3 / decode_ms,
           "eager_decode_ms_per_token": (e64 - e16) / (HY_MAX_NEW - 16),
           "graph_ids_equal_eager": same, "generate_ms": gen_ms,
           "t16_ms": t16, "t64_ms": t64, "eager_t16_ms": e16,
           "eager_t64_ms": e64,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"HunyuanOCR times {label} (vision tokens {gh * gw}, prompt "
          f"{len(ids)}, KV capacity {capacity}): {json.dumps(out)} [{card}]")
    graph_report(model, card, f"HunyuanOCR {label}",
                 {K3: 2 * model.cfg.layers, K4: model.cfg.layers})


def hy_phases(card: str, kernels) -> dict:
    """Phases 11-14; returns the K4 record and the Hunyuan path's
    launches of K2-K4."""
    import torch

    from oar_ocr_tpu_torch.ops.flash_attention import KERNEL as K2
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL_QK as K4
    from oar_ocr_tpu_torch.vl.hunyuan import HunyuanOCRModel

    print("K4 vs plain version:")
    cases = k4_cases()
    for name, kernel, *_ in cases:
        before = K4.launches
        kernel()
        if K4.launches != before + 1:
            raise AssertionError(f"{name}: {K4.launches - before} launches "
                                 "in one call, the design makes 1")
    k4 = run_cases(cases, card)
    torch.cuda.empty_cache()

    page = make_pages(0)[0]
    crop = np.ascontiguousarray(page[:448, :448])
    models = {}
    for label in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        models[label] = HunyuanOCRModel(
            runtime=Runtime1(label, device="cuda"), seed=0)
        n = sum(p.numel() for p in models[label].net.parameters())
        print(f"HunyuanOCR model {label}: {n} parameters, built in "
              f"{time.perf_counter() - t0!r} s")
    # the main path: the bfloat16 model's request; the counts are zeroed
    # just before and read just after
    for k in kernels:
        k.launches = 0
    hy_request(models["bfloat16"], page, "bfloat16")
    main = {"K2": K2.launches, "K3": K3.launches, "K4": K4.launches}
    # again: every decode step a replay of the graph the first captured
    hy_request(models["bfloat16"], page, "bfloat16, graph built")
    hy_request(models["float32"], page, "float32")
    for model in models.values():
        check_dtype_policy(model, ("vit.embeddings.", "vit.layers."))
    hy_gpu_vs_cpu(models, crop)
    for label, model in models.items():
        hy_times(model, page, card, label)
    return {"K4": k4, "cases": cases, "launches": main}


# ------------------------- layout and OARStructure -------------------------

# the layout models at full width (phases 17-20): variant → the model's
# input side
LAYOUT_VARIANTS = (("pp-doclayout_plus-l", 800), ("pp-doclayout-m", 640))
LAYOUT_CHUNK = 4
# OARStructure's layout score threshold in phase 20 (the config's
# ``layout_score_thresh``, 0.5 by default): the random RT-DETR scores
# a hundred boxes a page above 0.5 (rank 100 at ~0.87), and 0.92 keeps
# 13-30, so that the seal crops (~0.5 a page) stay few
STRUCTURE_SCORE_THRESH = 0.92
STRUCTURE_STAGES = ("structure.upload", "layout.device[pp-doclayout_plus-l]",
                    "structure.overall_ocr",
                    "structure.ocr_refine", "structure.seal",
                    "structure.stitch")


def layout_weights(pages):
    """Seeded weights of the two layout models at full width, made on the
    CPU so the card and the CPU run the same numbers: N(0, 1/fan_in) with
    every BatchNorm's statistics calibrated on two bench pages' layout
    tiles (``utils/calibrate.calibrated_state_dict``), RT-DETR's box heads
    tempered (``utils/calibrate.tempered_rtdetr``). Uncalibrated, the deep
    random HGNetV2 and LCNet shrink their maps until the layer norms see
    only their epsilon, and every score ties; untempered, the random
    decoder is chaotic."""
    import torch

    from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
    from oar_ocr_tpu_torch.ops.warp import resize_matrix, sample_transform
    from oar_ocr_tpu_torch.runtime.runtime import stack_padded
    from oar_ocr_tpu_torch.utils.calibrate import (calibrated_state_dict,
                                                   tempered_rtdetr)

    cpu = Runtime1("float32", device="cpu")
    batch = torch.from_numpy(stack_padded(pages[:2], (PAGE_H, PAGE_W)))
    out = {}
    for variant, side in LAYOUT_VARIANTS:
        det = LayoutDetector(variant, runtime=cpu)
        mats = torch.from_numpy(np.stack(
            [resize_matrix(PAGE_H, PAGE_W, side, side)] * 2))
        full = torch.full((2,), side, dtype=torch.int32)
        tiles = sample_transform(batch, mats, torch.arange(2), full, full,
                                 out_h=side, out_w=side, norm=det._norm)
        sd = calibrated_state_dict(det.model,
                                   torch.Generator().manual_seed(5), tiles)
        out[variant] = tempered_rtdetr(sd) if det._is_detr else sd
    return out


def layout_detect_all(det, pages_dev, shapes):
    """``detect`` over the page batch in chunks of LAYOUT_CHUNK, as
    ``OARStructure`` runs it."""
    boxes = []
    for s in range(0, len(shapes), LAYOUT_CHUNK):
        idx = list(range(s, min(s + LAYOUT_CHUNK, len(shapes))))
        boxes.extend(det.detect(pages_dev, [shapes[i] for i in idx],
                                page_indices=idx))
    return boxes


def label_histogram(boxes) -> dict:
    hist: dict = {}
    for page in boxes:
        for b in page:
            hist[b.label] = hist.get(b.label, 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def layout_phase(card: str, weights) -> tuple:
    """Phase 17: both layout models at full width on the 16 bench pages in
    chunks of 4, float32 then bfloat16; boxes per page, labels, stage ms
    and K1 launches by caller. Returns K1's launches on the float32 run
    and the K1 inputs it saw."""
    import torch

    from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER

    pages = make_pages(0)
    shapes = [p.shape[:2] for p in pages]
    launches, k1_inputs = 0, {}
    for dtype in ("float32", "bfloat16"):
        rt = Runtime1(dtype, device="cuda")
        up = rt.put_pages(pages, (PAGE_H, PAGE_W))
        for variant, side in LAYOUT_VARIANTS:
            det = LayoutDetector(variant, dict(weights[variant]), runtime=rt)
            layout_detect_all(det, up, shapes)            # warm-up
            torch.cuda.synchronize()
            stage_ms(reset=True)
            K1.launches = 0
            LAUNCHES_BY_CALLER.clear()
            rec = K1Inputs(("layout",))
            t0 = time.perf_counter()
            with rec:
                boxes = layout_detect_all(det, up, shapes)
            dt = time.perf_counter() - t0
            if dtype == "float32":
                launches += K1.launches
                k1_inputs.update(rec.seen)
            by_caller = dict(LAUNCHES_BY_CALLER)
            stages = stage_ms()
            per_page = [len(b) for b in boxes]
            ranks = np.median([sorted((b.score for b in page),
                                      reverse=True) for page in boxes], 0)
            print(f"layout {variant} {dtype}: {len(boxes)} pages in "
                  f"{dt * 1e3!r} ms ({len(boxes) / dt!r} pages/s), boxes "
                  f"per page {per_page}, labels {label_histogram(boxes)}, "
                  f"K1 launches {K1.launches} by caller {by_caller}; "
                  f"median score at ranks 1/5/10/20/50/100 "
                  f"{[round(float(ranks[r - 1]), 4) for r in (1, 5, 10, 20, 50, 100) if r <= len(ranks)]}  "
                  f"[{card}]")
            for k in (f"layout.device[{variant}]", "layout.nms"):
                if k in stages:
                    print(f"  {k}: {stages[k][1]!r} ms per chunk of "
                          f"{LAYOUT_CHUNK}, {stages[k][0]} chunks  [{card}]")
            if by_caller.get("layout", 0) != len(pages) // LAYOUT_CHUNK:
                raise AssertionError(f"layout {variant}: K1 launched "
                                     f"{by_caller} times, one per chunk "
                                     f"expected")
            if not all(per_page):
                raise AssertionError(f"layout {variant} {dtype}: a page "
                                     f"has no box")
            if not all(np.isfinite(b.box).all() and np.isfinite(b.score)
                       for page in boxes for b in page):
                raise AssertionError(f"layout {variant}: non-finite box")
            del det
        del up
        torch.cuda.empty_cache()
    return launches, k1_inputs


def box_iou(a, b) -> float:
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return float(inter / union) if union > 0 else 0.0


def layout_dets(det, pages_dev, shapes) -> tuple:
    """The model's valid detections on ``shapes``' pages (the upload's
    first pages, in chunks of LAYOUT_CHUNK), keyed by (page, anchor,
    label) → (score, xyxy): for RT-DETR the encoder anchor its query was
    selected from, for PicoDet the anchor its candidate came from; boxes
    normalized (RT-DETR) or in input pixels (PicoDet). The postprocess is
    the detector's own (``rtdetr_postprocess`` top 100; ``topk_candidates``
    400 and ``nms_fixed``). Also returns, per page, the scores at the
    selection boundaries (RT-DETR: the encoder logits of the 300th and
    301st anchor, and the 100th score; PicoDet: the 400th candidate's
    score), the encoder logit of every anchor (RT-DETR), and the raw
    outputs of each chunk on the host (logits or scores, boxes, and for
    RT-DETR each query's anchor)."""
    import torch

    from oar_ocr_tpu_torch.models.detection.rtdetr import rtdetr_postprocess
    from oar_ocr_tpu_torch.ops.nms import nms_fixed, topk_stable
    from oar_ocr_tpu_torch.ops.warp import resize_matrix, sample_transform

    ih, iw = det.variant.input_hw
    put, dev = det.runtime.put, det.runtime.device
    thr = det.score_thresh
    dets, edges, enc, raw = {}, {}, {}, []
    for s in range(0, len(shapes), LAYOUT_CHUNK):
        idx = list(range(s, min(s + LAYOUT_CHUNK, len(shapes))))
        n = len(idx)
        mats = np.stack([resize_matrix(*shapes[i], ih, iw) for i in idx])
        full_w = torch.full((n,), iw, dtype=torch.int32, device=dev)
        full_h = torch.full((n,), ih, dtype=torch.int32, device=dev)
        x = sample_transform(pages_dev, put(mats), put(np.asarray(idx)),
                             full_w, full_h, out_h=ih, out_w=iw,
                             norm=det._norm,
                             out_dtype=det.runtime.compute_dtype)
        seen = {}
        hook = None
        if det._is_detr:
            hook = det.model.transformer.enc_score_head \
                .register_forward_hook(
                    lambda m, i, o: seen.__setitem__("enc", o.float()))
        with torch.no_grad():
            a, b = det.model(x)
        if hook is not None:
            hook.remove()
        if det._is_detr:
            q = det.model.transformer.num_queries
            top_sc = seen["enc"].max(-1).values
            vals, ind = topk_stable(top_sc, q + 1)
            sc, lab, xyxy = rtdetr_postprocess(a, b, num_top=det.MAX_DET)
            # the query row of each of the postprocess's top-k
            qidx = topk_stable(torch.sigmoid(a).reshape(n, -1),
                               det.MAX_DET)[1] // a.shape[-1]
            anchor = torch.gather(ind[:, :q], 1, qidx)
            raw.append((a.cpu(), b.cpu(), ind[:, :q].cpu()))
            for k, p in enumerate(idx):
                edges[p] = (float(vals[k, q - 1]), float(vals[k, q]),
                            float(sc[k, -1]))
                enc[p] = top_sc[k].cpu()
            keep = sc > thr
        else:
            c = a.shape[-1]
            cand_s, fidx = topk_stable(a.reshape(n, -1), det.TOPK)
            cand_a = fidx // c
            cand_l = (fidx % c).to(torch.int32)
            cand_b = torch.gather(b, 1, cand_a[..., None].expand(-1, -1, 4))
            xyxy, sc, lab, keep = nms_fixed(
                cand_b, cand_s, cand_l, iou_thresh=det.nms_iou,
                score_thresh=thr, max_det=det.MAX_DET)
            # each kept box is one candidate, bit for bit
            hit = ((cand_s[:, None, :] == sc[:, :, None])
                   & (cand_l[:, None, :] == lab[:, :, None])
                   & (cand_b[:, None, :, :] == xyxy[:, :, None, :]).all(-1))
            anchor = torch.gather(cand_a, 1, hit.float().argmax(-1))
            raw.append((a.cpu(), b.cpu(), None))
            for k, p in enumerate(idx):
                edges[p] = (float(cand_s[k, -1]),)
        sc, lab, xyxy = sc.cpu(), lab.cpu(), xyxy.cpu()
        keep, anchor = keep.cpu(), anchor.cpu()
        for k, p in enumerate(idx):
            for j in range(sc.shape[1]):
                if keep[k, j]:
                    dets[(p, int(anchor[k, j]), int(lab[k, j]))] = (
                        float(sc[k, j]), xyxy[k, j].numpy())
    return dets, edges, enc, raw


# the blocks whose bfloat16 outputs phase 19 holds to float32 on the same
# inputs, by model
BF16_BLOCKS = {
    "pp-doclayout_plus-l": (
        ["backbone.stem"]
        + [f"backbone.stages.{s}.blocks.{b}" for s, n in
           enumerate((1, 1, 3, 1)) for b in range(n)]
        + ["neck.encoder.0.layers.0"]
        + [f"neck.{m}.{i}" for m in ("lateral_convs", "fpn_blocks",
                                     "downsample_convs", "pan_blocks")
           for i in range(2)]
        + ["transformer.enc_output", "transformer.enc_score_head",
           "transformer.enc_bbox_head"]
        + [f"transformer.decoder.layers.{i}" for i in range(6)]
        + ["transformer.dec_bbox_head.5", "transformer.dec_score_head.5"]),
    "pp-doclayout-m": (
        ["backbone.conv1"]
        + [f"backbone.{s}.{i}" for s, n in (("blocks2", 1), ("blocks3", 2),
                                             ("blocks4", 2), ("blocks5", 6),
                                             ("blocks6", 2))
           for i in range(n)]
        + [f"neck.{m}.{i}" for m in ("top_down_blocks", "downsamples",
                                     "bottom_up_blocks") for i in range(2)]
        + [f"neck.conv_t.convs.{i}" for i in range(3)]
        + ["neck.first_top_conv", "neck.second_top_conv", "head.conv_feat"]
        + [f"head.head_cls{i}" for i in range(4)]),
}


def _tensors(x) -> list:
    """The tensors of a module's output, in order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def bf16_block_errors(model32, model16, x32, x16, names) -> dict:
    """Each named block of the bfloat16 model run on the float32 model's
    own inputs to that block (each cast to the dtype the bfloat16 model
    gives that argument on its own run), against the float32 block's
    output: max|Δ| / max|ref| per block. A block's error is then its own
    bfloat16 rounding, not the rounding of every block before it, which
    a random network amplifies."""
    import torch

    def capture(model, x):
        seen = {}
        mods = dict(model.named_modules())

        def keep(name):
            def hook(module, args, kwargs, out):
                seen.setdefault(name, (args, kwargs, out))
            return hook

        hooks = [mods[n].register_forward_hook(keep(n), with_kwargs=True)
                 for n in names]
        with torch.no_grad():
            model(x)
        for h in hooks:
            h.remove()
        return seen

    s32, s16 = capture(model32, x32), capture(model16, x16)
    mods16 = dict(model16.named_modules())

    def like(v, ref):
        if isinstance(v, torch.Tensor):
            return v.to(ref.dtype) if v.is_floating_point() else v
        if isinstance(v, (list, tuple)):
            return type(v)(like(a, b) for a, b in zip(v, ref))
        return v

    errs = {}
    for n in names:
        a32, kw32, o32 = s32[n]
        a16, kw16, _ = s16[n]
        with torch.no_grad():
            o = mods16[n](*like(a32, a16), **{k: like(v, kw16[k])
                                              for k, v in kw32.items()})
        errs[n] = max(float((g.float() - r.float()).abs().max()
                            / r.float().abs().max())
                      for g, r in zip(_tensors(o), _tensors(o32)))
    return errs


def layout_bf16_vs_f32(card: str, weights) -> None:
    """Phase 19: each model in bfloat16 against float32 on the card, the
    16 bench pages. Gated: the same number of detections per page, and
    every block of BF16_BLOCKS (backbone blocks, neck blocks, the
    encoder's selection heads, each decoder layer, the heads) in bfloat16
    within 2^-4·max|ref| of float32 on the same inputs
    (:func:`bf16_block_errors`, the first chunk of 4 pages). Printed, not
    gated: the end-to-end readings, the share of float32 detections
    bfloat16 keeps (the same anchor and label, :func:`layout_dets`),
    their mean IoU and phase 6's nearest-centre mean IoU. These random
    networks amplify a difference ~100-fold from input to output (float32
    against float64 on the CPU: 1e-7 → 1.7e-5 through PicoDet-L's LCNet),
    so bfloat16's 4e-3 becomes 0.3 of their maps and moves the
    selections of dense, near-tied score fields."""
    import torch

    from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
    from oar_ocr_tpu_torch.ops.warp import resize_matrix, sample_transform

    pages = make_pages(0)
    shapes = [p.shape[:2] for p in pages]
    failed = []
    for variant, side in LAYOUT_VARIANTS:
        got, models, tiles = {}, {}, {}
        for dtype in ("float32", "bfloat16"):
            rt = Runtime1(dtype, device="cuda")
            det = LayoutDetector(variant, dict(weights[variant]), runtime=rt)
            up = rt.put_pages(pages, (PAGE_H, PAGE_W))
            got[dtype] = layout_dets(det, up, shapes)[0]
            n = LAYOUT_CHUNK
            full = torch.full((n,), side, dtype=torch.int32,
                              device=rt.device)
            tiles[dtype] = sample_transform(
                up, rt.put(np.stack([resize_matrix(*shapes[i], side, side)
                                     for i in range(n)])),
                rt.put(np.arange(n)), full, full, out_h=side, out_w=side,
                norm=det._norm, out_dtype=rt.compute_dtype)
            models[dtype] = det.model
            del up
        errs = bf16_block_errors(models["float32"], models["bfloat16"],
                                 tiles["float32"], tiles["bfloat16"],
                                 BF16_BLOCKS[variant])
        del models, tiles
        torch.cuda.empty_cache()
        worst = max(errs, key=errs.get)
        f32, bf16 = got["float32"], got["bfloat16"]
        count = {d: [sum(1 for k in got[d] if k[0] == p)
                     for p in range(len(pages))] for d in got}
        common = sorted(set(f32) & set(bf16))
        ious = [box_iou(f32[k][1], bf16[k][1]) for k in common]
        near = []
        for p in range(len(pages)):
            fb = [v[1] for k, v in f32.items() if k[0] == p]
            if not fb:
                continue
            centers = np.array([(x[:2] + x[2:]) / 2 for x in fb])
            for k, v in bf16.items():
                if k[0] == p:
                    m = fb[int(np.argmin(np.linalg.norm(
                        centers - (v[1][:2] + v[1][2:]) / 2, axis=1)))]
                    near.append(box_iou(v[1], m))
        ok = (count["bfloat16"] == count["float32"]
              and errs[worst] <= 2 ** -4)
        print(f"layout {variant} bfloat16 vs float32 (16 pages): counts "
              f"per page equal {count['bfloat16'] == count['float32']}; "
              f"{len(errs)} blocks on float32's inputs, max rel err "
              f"{errs[worst]!r} at {worst} (gate 2^-4), median "
              f"{float(np.median(list(errs.values())))!r}; end to end (not "
              f"gated): {len(common)} of {len(f32)} float32 detections "
              f"kept, their mean IoU "
              f"{float(np.mean(ious)) if ious else None!r}, nearest-centre "
              f"mean IoU {float(np.mean(near)) if near else None!r}  "
              f"[{card}]")
        print(f"  blocks: { {k: round(v, 4) for k, v in errs.items()} }")
        if not ok:
            failed.append(variant)
    if failed:
        raise AssertionError(f"layout: bfloat16 disagrees with float32: "
                             f"{failed}")


def layout_gpu_vs_cpu(weights) -> None:
    """Phase 18: each layout model on the card against the CPU, float32,
    on 2 bench pages, held by identity (:func:`layout_dets`). RT-DETR:
    the raw logits ≤ 1e-3·max|logit| and boxes ≤ 1e-4 on the queries both
    sides select (matched by their anchor); PicoDet: its raw scores and
    boxes on every anchor printed. Then the detections: the same
    keys, scores ≤ 1e-4, corners ≤ 1e-4 of the input side (RT-DETR's
    normalized, PicoDet's in input pixels: 0.064 px). A detection one side alone has is printed with its
    margins, and must sit at a selection boundary: an RT-DETR anchor one
    side alone selected, or a score within 1e-4 of the threshold, of the
    100th score or of the 400th candidate."""
    from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector

    pages = make_pages(0)[:2]
    shapes = [p.shape[:2] for p in pages]
    failed = []
    for variant, _ in LAYOUT_VARIANTS:
        outs = {}
        for dev in ("cuda", "cpu"):
            det = LayoutDetector(variant, dict(weights[variant]),
                                 runtime=Runtime1("float32", device=dev))
            outs[dev] = layout_dets(det, det.runtime.put_pages(
                pages, (PAGE_H, PAGE_W)), shapes)
        thr = det.score_thresh
        (ga, gb, gi), = outs["cuda"][3]
        (ca, cb, ci), = outs["cpu"][3]
        boundary = set()
        if det._is_detr:
            logit_err = box_err = 0.0
            for p in range(len(pages)):
                g_pos = {int(a): k for k, a in enumerate(gi[p])}
                c_pos = {int(a): k for k, a in enumerate(ci[p])}
                common = sorted(set(g_pos) & set(c_pos))
                gk = [g_pos[a] for a in common]
                ck = [c_pos[a] for a in common]
                logit_err = max(logit_err, float(
                    (ga[p, gk] - ca[p, ck]).abs().max()))
                box_err = max(box_err, float(
                    (gb[p, gk] - cb[p, ck]).abs().max()))
                lo, hi, _ = outs["cpu"][1][p]
                for a in sorted(set(g_pos) ^ set(c_pos)):
                    boundary.add((p, a))
                    print(f"  {variant} page {p}: anchor {a} selected on "
                          f"the {'card' if a in g_pos else 'CPU'} only; its "
                          f"encoder logit {float(outs['cpu'][2][p][a])!r} "
                          f"on the CPU, {float(outs['cuda'][2][p][a])!r} on "
                          f"the card; the CPU's 300th {lo!r}, 301st {hi!r}")
            gates = (logit_err <= 1e-3 * float(ca.abs().max())
                     and box_err <= 1e-4)
            raw_line = (f"logits max abs err {logit_err!r} (gate "
                        f"{1e-3 * float(ca.abs().max())!r} = "
                        f"1e-3·max|logit|), boxes {box_err!r} (gate 1e-4) "
                        f"on the queries both select, {len(boundary)} "
                        f"selected on one side only")
            corner_gate = 1e-4
        else:
            score_err = float((ga - ca).abs().max())
            box_err = float((gb - cb).abs().max())
            gates = True
            raw_line = (f"scores max abs err {score_err!r}, boxes "
                        f"{box_err!r} px on every anchor (not gated)")
            corner_gate = 1e-4 * max(det.variant.input_hw)
        dg, dc = outs["cuda"][0], outs["cpu"][0]
        s_err = c_err = 0.0
        bad = []
        for key in sorted(set(dg) | set(dc)):
            if key in dg and key in dc:
                s_err = max(s_err, abs(dg[key][0] - dc[key][0]))
                c_err = max(c_err, float(np.abs(dg[key][1]
                                                - dc[key][1]).max()))
                continue
            side, d = ("card", dg) if key in dg else ("cpu", dc)
            s = d[key][0]
            edge = outs["cuda" if side == "card" else "cpu"][1][key[0]][-1]
            print(f"  {variant} page {key[0]}: anchor {key[1]} label "
                  f"{key[2]} detected on the {side} only, score {s!r} "
                  f"(threshold {thr}, boundary score {edge!r})")
            if ((key[0], key[1]) not in boundary and abs(s - thr) > 1e-4
                    and abs(s - edge) > 1e-4):
                bad.append(key)
        print(f"layout {variant} card vs CPU (2 pages, float32): "
              f"{raw_line}; detections {len(dc)} on the CPU, {len(dg)} on "
              f"the card; scores max abs err {s_err!r} (gate 1e-4), "
              f"corners {c_err!r} (gate {corner_gate})")
        if not gates or s_err > 1e-4 or c_err > corner_gate or bad:
            failed.append(f"{variant} (unexplained {bad[:4]})")
    if failed:
        raise AssertionError(f"layout: card disagrees with the CPU: "
                             f"{failed}")


def structure_pipeline(runtime, det_state, rec_state, layout_state, *,
                       overall_ocr: bool = True, tables=None,
                       seals: bool = True, formulas=None,
                       thresh: float = STRUCTURE_SCORE_THRESH):
    """``OARStructureBuilder().with_tables(False).with_formulas(False)``
    (default layout, overall OCR and seals) as a caller with weights runs
    it: the builder's configuration with the layout score threshold
    ``thresh``, and its stages on the given weights (the builder's own
    stages run seeded random weights only). With ``tables`` (a
    ``TableAnalyzer``), tables are on, as ``OARStructureBuilder()
    .with_formulas(False)`` builds them; ``seals=False`` is
    ``.with_seals(False)``; with ``formulas`` (a formula recognizer),
    formulas are on."""
    from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
    from oar_ocr_tpu_torch.pipelines.structure import (OARStructure,
                                                       OARStructureBuilder)

    base = (OARStructureBuilder().with_runtime(runtime).with_tables(False)
            .with_formulas(False).with_overall_ocr(overall_ocr).build())
    cfg = dataclasses.replace(base.cfg, layout_score_thresh=thresh,
                              use_tables=tables is not None,
                              use_formulas=formulas is not None,
                              use_seals=seals)
    layout = LayoutDetector(cfg.layout_variant, dict(layout_state),
                            score_thresh=cfg.layout_score_thresh,
                            runtime=runtime)
    ocr = (build_pipeline(runtime, det_state, rec_state)
           if base.ocr is not None else None)
    seal = (OAROCRBuilder("seal").with_runtime(runtime)
            .with_det_params(det_state).with_rec_params(rec_state).build()
            if seals else None)
    return OARStructure(layout=layout, ocr=ocr, seal_ocr=seal, cfg=cfg,
                        tables=tables, formulas=formulas, runtime=runtime)


def structure_phase(card: str, det_state, rec_state, weights) -> int:
    """Phase 20: ``OARStructure`` at full width, STRUCTURE_ITERS predicts
    on the 16 bench pages in float32, then on the first CUT_PAGES in
    bfloat16: elements on
    every page, markdown on every page, K1 launched by the layout and by
    the OCR; pages/s (median of 2) and stage ms, and without the overall
    OCR on the first CUT_PAGES pages; the card against the CPU in float32
    on CPU_PAGES pages. Returns K1's launches on the float32 main path."""
    import torch

    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER

    pages = make_pages(0)
    layout_state = weights["pp-doclayout_plus-l"]
    main = 0
    for dtype in ("float32", "bfloat16"):
        rt = Runtime1(dtype, device="cuda")
        pipe = structure_pipeline(rt, det_state, rec_state, layout_state)
        pipe.predict(pages[:4])                        # warm-up call
        stage_ms(reset=True)
        K1.launches = 0
        LAUNCHES_BY_CALLER.clear()
        times = []
        use = pages if dtype == "float32" else pages[:CUT_PAGES]
        for call in range(STRUCTURE_ITERS):
            t0 = time.perf_counter()
            results = pipe.predict(use)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if dtype == "float32":
            main = K1.launches
        by_caller = {k: v / STRUCTURE_ITERS
                     for k, v in LAUNCHES_BY_CALLER.items()}
        stages = stage_ms()
        n_el = [len(r.elements) for r in results]
        md = [len(r.to_markdown()) for r in results]
        n_text = sum(1 for r in results for e in r.elements if e.text)
        labels: dict = {}
        for r in results:
            for e in r.elements:
                labels[e.label] = labels.get(e.label, 0) + 1
        pps = len(use) / statistics.median(times)
        print(f"structure {dtype}: {pps!r} pages/s (median of "
              f"{STRUCTURE_ITERS}, {[round(t * 1e3, 1) for t in times]} "
              f"ms per {len(use)} pages), "
              f"elements per page {n_el}, {n_text} with text, markdown "
              f"chars per page {md}, labels {labels}, K1 launches per "
              f"predict by caller {by_caller}  [{card}]")
        for k in STRUCTURE_STAGES + ("structure.ocr_refine.multi",
                                     "structure.ocr_refine.fallback"):
            n, ms = stages.get(k, (0, 0.0))
            print(f"  {dtype} {k}: {ms!r} ms per call, "
                  f"{n / STRUCTURE_ITERS!r} calls "
                  f"per predict  [{card}]")
        if not all(n_el) or not all(md):
            raise AssertionError(f"structure {dtype}: a page without "
                                 f"elements or markdown")
        for caller in ("layout", "det", "rec"):
            if by_caller.get(caller, 0) == 0:
                raise AssertionError(f"structure {dtype}: no K1 launch for "
                                     f"{caller}")
        no_ocr = structure_pipeline(rt, det_state, rec_state, layout_state,
                                    overall_ocr=False)
        no_ocr.predict(pages[:4])
        stage_ms(reset=True)
        few = pages[:CUT_PAGES]
        t_no = [host_ms(lambda: no_ocr.predict(few), 1)
                for _ in range(STRUCTURE_ITERS)]
        stages = stage_ms()
        print(f"structure {dtype} without the overall OCR: "
              f"{len(few) / (statistics.median(t_no) / 1e3)!r} pages/s "
              f"(median of {STRUCTURE_ITERS}, "
              f"{[round(t, 1) for t in t_no]} ms per {len(few)} pages), "
              f"stages "
              f"{ {k: round(v[1], 3) for k, v in stages.items() if k in STRUCTURE_STAGES} } "
              f"ms per call  [{card}]")
        del pipe, no_ocr
        torch.cuda.empty_cache()

    print(f"structure, card vs CPU (float32, pages 0-{CPU_PAGES - 1}):")
    t0 = time.perf_counter()
    got = structure_pipeline(Runtime1("float32", device="cuda"), det_state,
                             rec_state, layout_state).predict(
                                 pages[:CPU_PAGES])
    want = structure_pipeline(Runtime1("float32", device="cpu"), det_state,
                              rec_state, layout_state).predict(
                                  pages[:CPU_PAGES])
    same, n, err = True, 0, 0.0
    for g, w in zip(got, want):
        same &= len(g.elements) == len(w.elements)
        for a, b in zip(g.elements, w.elements):
            same &= (a.label, a.order_index, a.text) == (b.label,
                                                         b.order_index,
                                                         b.text)
            err = max(err, float(np.abs(np.asarray(a.box, np.float32)
                                        - np.asarray(b.box, np.float32))
                                 .max()))
            n += 1
        same &= g.to_markdown() == w.to_markdown()
    print(f"  {n} elements, the same elements, labels, order indices, texts "
          f"and markdown {same}; corners max abs err {err!r} px; "
          f"{time.perf_counter() - t0!r} s")
    if not same or n == 0:
        raise AssertionError("structure: card disagrees with the CPU")
    return main


# ------------------------- tables (phases 22-26) -------------------------

# the drawn tables' pages (phases 22-26)
TABLE_SEED = 7
CELL_VARIANT = "rt-detr-l_wired_table_cell_det"
# the structure models at published width and depth: name → input side
TABLE_MODELS = (("slanet", 488), ("slanet_plus", 488),
                ("slanext_wired", 512), ("slanext_wireless", 488))
# the decoders' generator biases (phase 22, :func:`bias_decoders`):
# ``<tr>`` and ``<td></td>`` are raised by the quantile, at this share,
# of their gap below the step's maximum on the unbiased decode, so that
# the random decoders emit rows of cells
TOKEN_SHARES = (("<tr>", 0.15), ("<td></td>", 0.5))
# a free-running id may differ card against CPU only where both sides'
# top-2 logit margin is below this share of max|logit| (a near-tie)
TIE_MARGIN = 1e-4
# the fit of SLANet's head to the drawn grids (:func:`fit_table_decoder`)
# on pages 0-3's tables
FIT_LR, FIT_STEPS, FIT_MARGIN, FIT_PAGES = 3e-3, 400, 0.5, 4
TABLE_STAGES = ("table.classify", "table.cells", "slanet.device")
STRUCTURE_TABLE_STAGES = ("structure.tables", "structure.table_ocr_split")


def table_pages(seed: int = TABLE_SEED):
    """The 16 pages of phases 22-26 (PAGE_H×PAGE_W): two text lines, then
    two tables drawn with cv2, the first ruled (wired), the second not,
    of 4-12 rows × 3-8 columns, a dark text block in each cell. Returns
    (pages, tables): tables[p] holds ((x0, y0, x1, y1), ruled, blocks)
    with blocks the cells' (xyxy, text)."""
    import cv2

    rng = np.random.default_rng(seed)
    pages, tables = [], []
    for _ in range(N_PAGES):
        img = np.full((PAGE_H, PAGE_W, 3), 255, np.uint8)
        for k in range(2):
            img[30 + 40 * k:54 + 40 * k,
                60:60 + int(rng.integers(300, 800))] = rng.integers(0, 80)
        page, y = [], 130
        for ruled in (True, False):
            rows, cols = int(rng.integers(4, 13)), int(rng.integers(3, 9))
            cw = int(rng.integers(80, min(110, 840 // cols) + 1))
            ch = int(rng.integers(30, 44))
            x0 = int(rng.integers(40, PAGE_W - cols * cw - 40 + 1))
            blocks = []
            for r in range(rows):
                for c in range(cols):
                    cx, cy = x0 + c * cw, y + r * ch
                    b = (cx + 8, cy + 10,
                         cx + 8 + int(rng.integers(20, cw - 16)),
                         cy + ch - 10)
                    img[b[1]:b[3], b[0]:b[2]] = rng.integers(0, 80)
                    blocks.append((b, f"r{r}c{c}"))
            if ruled:
                for r in range(rows + 1):
                    cv2.line(img, (x0, y + r * ch), (x0 + cols * cw,
                                                     y + r * ch),
                             (0, 0, 0), 2)
                for c in range(cols + 1):
                    cv2.line(img, (x0 + c * cw, y), (x0 + c * cw,
                                                     y + rows * ch),
                             (0, 0, 0), 2)
            page.append(((float(x0), float(y), float(x0 + cols * cw),
                          float(y + rows * ch)), ruled, blocks))
            y += rows * ch + int(rng.integers(40, 80))
        pages.append(img)
        tables.append(page)
    return pages, tables


def table_regions(tables, page_ids):
    """(page index, integer box) of the tables on ``page_ids``."""
    return [(p, tuple(int(v) for v in t[0])) for p in page_ids
            for t in tables[p]]


def table_region_inputs(tables, page_ids):
    """``TableRegionInput`` of the tables on ``page_ids``, each with its
    page's text blocks as the OCR (the analyzer's inline matching)."""
    from oar_ocr_tpu_torch.pipelines.table_analyzer import TableRegionInput

    out = []
    for p in page_ids:
        boxes, texts = [], []
        for _box, _ruled, blocks in tables[p]:
            for (x0, y0, x1, y1), text in blocks:
                boxes.append(np.array([[x0, y0], [x1, y0], [x1, y1],
                                       [x0, y1]], np.float32))
                texts.append(text)
        out += [TableRegionInput(p, t[0], boxes, texts) for t in tables[p]]
    return out


def table_model(name: str, state, runtime):
    """The wrapper of one structure model of TABLE_MODELS on ``state``."""
    from oar_ocr_tpu_torch.models.recognition.slanet import SLANetModel
    from oar_ocr_tpu_torch.models.recognition.slanet_exact import \
        SLANetExactModel
    from oar_ocr_tpu_torch.models.recognition.slanext_exact import \
        SLANeXtExactModel

    state = dict(state) if state is not None else None
    if name == "slanet":
        return SLANetModel(state, runtime=runtime)
    if name == "slanet_plus":
        return SLANetExactModel(state, runtime=runtime)
    return SLANeXtExactModel(state, runtime=runtime,
                             input_size=dict(TABLE_MODELS)[name])


def model_inputs(model, pages_u8, regions):
    """A table wrapper's K1 output for ``regions`` (NHWC)."""
    x = model.inputs(pages_u8, regions, [0] * len(regions))
    return x[0] if isinstance(x, tuple) else x


def generator_key(name: str) -> str:
    return ("SLAHead_0.cell.out_struct.bias" if name == "slanet"
            else "head.structure_generator.1.bias")


def table_weights(pages, tables):
    """Seeded weights of the table models at full width, made on the CPU
    so the card and the CPU run the same numbers: N(0, 1/fan_in) with
    every BatchNorm's statistics calibrated on the crops of pages 0-1
    (``utils/calibrate.calibrated_state_dict``): SLANet's PP-LCNetV3 and
    projection on its 488×488 warps, SLANet_plus's PP-LCNet and CSP-PAN
    on its keep-ratio canvases, the table classifier on its 224×224
    crops, the RT-DETR-L cell detector on its 640×640 crops, tempered as
    the layout model is (``tempered_rtdetr``). SLANeXt has no BatchNorm
    (seeded only). The classifier's seed is the first from 30 whose
    classes on pages 0-3's tables include both kinds, so that phase 24
    runs both routes."""
    import torch

    from oar_ocr_tpu_torch.models.classification.pp_lcnet import (
        ImageClassifier, table_classifier)
    from oar_ocr_tpu_torch.models.classification.pp_lcnet_exact import \
        PPLCNetV1Cls
    from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
    from oar_ocr_tpu_torch.models.layers import init_state_dict
    from oar_ocr_tpu_torch.models.recognition.slanet import (SLANet,
                                                             crop_matrix)
    from oar_ocr_tpu_torch.models.recognition.slanet_exact import \
        SLANetExact
    from oar_ocr_tpu_torch.models.recognition.slanext_exact import \
        SLANeXtExact
    from oar_ocr_tpu_torch.ops.warp import NormSpec, sample_transform
    from oar_ocr_tpu_torch.runtime.runtime import stack_padded
    from oar_ocr_tpu_torch.utils.calibrate import (calibrated_state_dict,
                                                   tempered_rtdetr)

    cpu = Runtime1("float32", device="cpu")
    batch = torch.from_numpy(stack_padded(pages[:4], (PAGE_H, PAGE_W)))
    regions = table_regions(tables, (0, 1))
    out = {}
    x = model_inputs(table_model("slanet", None, cpu), batch, regions)
    out["slanet"] = calibrated_state_dict(
        SLANet(), torch.Generator().manual_seed(21), x.permute(0, 3, 1, 2))
    x = model_inputs(table_model("slanet_plus", None, cpu), batch, regions)
    out["slanet_plus"] = calibrated_state_dict(
        SLANetExact(), torch.Generator().manual_seed(22),
        x.permute(0, 3, 1, 2))
    out["slanext_wired"] = init_state_dict(SLANeXtExact(),
                                           torch.Generator().manual_seed(23))
    out["slanext_wireless"] = init_state_dict(
        SLANeXtExact(), torch.Generator().manual_seed(24))
    quads = [(p, np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]],
                           [b[0], b[3]]], np.float32))
             for p, b in table_regions(tables, range(4))]
    mats, idx = ImageClassifier(num_classes=2,
                                runtime=cpu).quad_inputs(quads)
    full = torch.full((len(quads),), 224, dtype=torch.int32)
    tiles = sample_transform(batch, torch.from_numpy(mats),
                             torch.from_numpy(idx), full, full, out_h=224,
                             out_w=224, norm=NormSpec.imagenet_rgb())
    for seed in range(30, 60):
        sd = calibrated_state_dict(PPLCNetV1Cls(2, 1.0),
                                   torch.Generator().manual_seed(seed),
                                   tiles)
        kinds = {c for c, _s in table_classifier(sd, cpu).classify_quads(
            batch, quads)}
        if kinds == {0, 1}:
            break
    print(f"  table classifier seed {seed}: classes {sorted(kinds)} on "
          f"pages 0-3's {len(quads)} tables")
    out["cls"] = sd
    det = LayoutDetector(CELL_VARIANT, runtime=cpu)
    mats = np.stack([crop_matrix(b, 0, 640, 640, b[3] - b[1], b[2] - b[0])
                     for _p, b in regions[:2]])
    full = torch.full((2,), 640, dtype=torch.int32)
    tiles = sample_transform(batch, torch.from_numpy(mats),
                             torch.tensor([p for p, _b in regions[:2]]),
                             full, full, out_h=640, out_w=640,
                             norm=det._norm)
    out["cell"] = tempered_rtdetr(calibrated_state_dict(
        det.model, torch.Generator().manual_seed(25), tiles))
    return out


def bias_decoders(card: str, weights, pages, tables,
                  device: str = "cuda") -> None:
    """Phase 22: the decoders' generator biases, from their own decodes
    of pages 0-3's tables (float32): ``<tr>`` and ``<td></td>`` raised by
    TOKEN_SHARES (phase 23 holds these models, which decode to the trip
    limit, card against CPU)."""
    import torch

    from oar_ocr_tpu_torch.models.recognition.slanet import \
        TABLE_STRUCTURE_VOCAB

    rt = Runtime1("float32", device=device)
    up = rt.put_pages(pages[:4], (PAGE_H, PAGE_W))
    regions = table_regions(tables, range(4))

    def gaps(name, state):
        model = table_model(name, state, rt)
        logits, _locs = model.decode_inputs(model_inputs(model, up, regions))
        steps = model.graphs.last["steps"]
        return (logits.amax(-1, keepdim=True) - logits)[:, :steps].cpu(), \
            steps

    for name, _side in TABLE_MODELS:
        gap, steps = gaps(name, weights[name])
        key = generator_key(name)
        weights[name] = dict(weights[name])
        bias = weights[name][key].clone()
        added = {}
        for tok, share in TOKEN_SHARES:
            tid = TABLE_STRUCTURE_VOCAB.index(tok)
            added[tok] = float(torch.quantile(gap[..., tid].flatten(), share))
            bias[tid] += added[tok]
        weights[name][key] = bias
        print(f"  {name}: unbiased decode {steps} steps; generator biases "
              f"added { {k: round(v, 4) for k, v in added.items()} }  "
              f"[{card}]")
    del up
    if device == "cuda":
        torch.cuda.empty_cache()


def table_script(rows: int, cols: int):
    """The structure tokens of a rows × cols grid and each cell token's
    eight corners, normalized to the table (None for a row token)."""
    toks, locs = [], []
    for r in range(rows):
        toks.append("<tr>")
        locs.append(None)
        for c in range(cols):
            x0, x1, y0, y1 = c / cols, (c + 1) / cols, r / rows, (r + 1) / rows
            toks.append("<td></td>")
            locs.append((x0, y0, x1, y0, x1, y1, x0, y1))
        toks.append("</tr>")
        locs.append(None)
    return toks, locs


def fit_table_decoder(card: str, weights, pages, tables,
                      device: str = "cuda") -> None:
    """Phase 22, last step: ``weights["slanet_table"]``, SLANet's weights
    for phases 25-26. A random decoder emits no table (it repeats one
    token, and its cells coincide), so SLANet's head, from its seeded
    weights, is fitted to the grids of the tables on pages 0-3
    (:func:`table_script`: the tokens by cross-entropy, the cells'
    corners by L1, the script's tokens fed back) with Adam at FIT_LR until its free-running decode of
    every table gives the script, with every step's top-2 margin above
    FIT_MARGIN, checked every 25 steps, at most FIT_STEPS; the backbone
    keeps its calibrated weights. A table's decode then stops at its
    own EOS, and its cells are distinct, as a trained model's are. On
    the card the training step (the teacher-forced unroll, its backward
    and Adam's update) is one CUDA graph after 3 eager steps, replayed
    each step: the unroll's thousands of small launches bound an eager
    step's host time."""
    import torch

    from oar_ocr_tpu_torch.models.recognition.slanet import (
        EOS_ID, SOS_ID, TABLE_STRUCTURE_VOCAB)

    t0 = time.perf_counter()
    rt = Runtime1("float32", device=device)
    up = rt.put_pages(pages[:FIT_PAGES], (PAGE_H, PAGE_W))
    regions = table_regions(tables, range(FIT_PAGES))
    model = table_model("slanet", weights["slanet"], rt)
    with torch.no_grad():
        memory = model.model.features(
            model_inputs(model, up, regions).permute(0, 3, 1, 2))
    del up
    scripts = []
    for p in range(FIT_PAGES):
        for _box, _ruled, blocks in tables[p]:
            rows = len({text.split("c")[0] for _b, text in blocks})
            cols = len(blocks) // rows
            scripts.append(table_script(rows, cols))
    n, length = len(scripts), max(len(t) for t, _l in scripts) + 1
    target = torch.full((n, length), EOS_ID, dtype=torch.int64)
    corners = torch.zeros((n, length, 8))
    has_loc = torch.zeros((n, length), dtype=torch.bool)
    live = torch.zeros((n, length), dtype=torch.bool)
    for i, (toks, locs) in enumerate(scripts):
        target[i, :len(toks)] = torch.tensor(
            [TABLE_STRUCTURE_VOCAB.index(t) for t in toks])
        live[i, :len(toks) + 1] = True
        for t, loc in enumerate(locs):
            if loc is not None:
                corners[i, t] = torch.tensor(loc)
                has_loc[i, t] = True
    target, corners, has_loc, live = (v.to(memory.device) for v in (
        target, corners, has_loc, live))
    fed = torch.cat([torch.full((n, 1), SOS_ID, dtype=torch.int64,
                                device=memory.device), target[:, :-1]], 1)
    head = model.model.head.requires_grad_(True)
    graphed = device == "cuda"
    opt = torch.optim.Adam(head.parameters(), lr=FIT_LR, capturable=graphed)

    def train_step():
        with torch.enable_grad():
            ctx = head.prepare(memory)
            h = torch.zeros((n, head.hidden), device=memory.device)
            ce = l1 = 0.0
            for t in range(length):
                h, logits, loc = head.step(h, fed[:, t], ctx)
                ce = ce + (torch.nn.functional.cross_entropy(
                    logits, target[:, t], reduction="none")
                    * live[:, t]).sum()
                l1 = l1 + ((loc - corners[:, t]).abs().sum(-1)
                           * has_loc[:, t]).sum()
            loss = (ce + l1) / live.sum()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        return loss.detach()

    def check():
        logits, _locs, _steps = head.decode(memory)
        logits = logits[:, :length]
        ids = logits.argmax(-1)
        top = logits.topk(2, -1).values
        margin = float((top[..., 0] - top[..., 1])[live].min())
        return bool((ids[live] == target[live]).all()), margin

    fitted, margin, graph = False, float("-inf"), None
    for it in range(1, FIT_STEPS + 1):
        if graph is not None:
            graph.replay()
        elif graphed and it == 4:
            # 3 eager steps on a side stream came first (PyTorch's recipe)
            graph = torch.cuda.CUDAGraph()
            opt.zero_grad(set_to_none=True)
            with torch.cuda.graph(graph):
                loss = train_step()
            graph.replay()
        elif graphed:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                loss = train_step()
            torch.cuda.current_stream().wait_stream(side)
        else:
            loss = train_step()
        if it % 25 == 0:
            ok, margin = check()
            if ok and margin > FIT_MARGIN:
                fitted = True
                break
    print(f"  slanet_table: head fitted to {n} tables' grids ({length - 1} "
          f"tokens at most) in {it} Adam steps ({'a CUDA graph' if graphed else 'eager'}),"
          f" {time.perf_counter() - t0!r}"
          f" s; free-running decode equals the scripts {fitted}, least "
          f"top-2 margin {margin!r}, loss {float(loss.detach())!r}  [{card}]")
    if not fitted:
        raise AssertionError("tables: SLANet's head did not fit the grids")
    state = dict(weights["slanet"])
    for k, v in model.model.state_dict().items():
        if k.startswith("SLAHead_0."):
            state[k] = v.detach().cpu().clone()
    weights["slanet_table"] = state
    del model, memory, opt, graph
    if device == "cuda":
        torch.cuda.empty_cache()


def forced_logits(head, memory, cpu_logits, steps: int):
    """The card decoder's (B, steps, vocab) logits with the CPU's tokens
    fed back: step t gets the token the CPU fed it (SOS, then
    ``where(done, EOS, argmax)`` of the CPU's step t − 1)."""
    import torch

    from oar_ocr_tpu_torch.models.recognition.sla_decode import (EOS_ID,
                                                                 SOS_ID)

    b = memory.shape[0]
    ctx = head.prepare(memory)
    h = torch.zeros((b, head.hidden), device=memory.device)
    tok = torch.full((b,), SOS_ID, dtype=torch.int64, device=memory.device)
    done = torch.zeros((b,), dtype=torch.bool, device=memory.device)
    cpu_ids = cpu_logits.argmax(-1).to(memory.device)
    out = []
    with torch.no_grad():
        for t in range(steps):
            h, logits, _loc = head.step(h, tok, ctx)
            out.append(logits)
            nxt = cpu_ids[:, t]
            tok = torch.where(done, EOS_ID, nxt)
            done = done | (nxt == EOS_ID)
    return torch.stack(out, 1)


def top2_margin(logits) -> float:
    top = logits.float().topk(2).values
    return float(top[0] - top[1])


def free_running(what: str, card_logits, cpu_logits) -> str:
    """Free-running ids card against CPU: identical, or first differing
    at a step where both sides' top-2 margins are below
    TIE_MARGIN·max|logit| (else AssertionError)."""
    g = card_logits.argmax(-1).cpu()
    c = cpu_logits.argmax(-1)
    diff = (g != c).nonzero()
    if len(diff) == 0:
        return "identical"
    t = int(diff[:, 1].min())
    row = int(diff[diff[:, 1] == t][0, 0])
    scale = float(cpu_logits.abs().max())
    mg = top2_margin(card_logits[row, t].cpu())
    mc = top2_margin(cpu_logits[row, t])
    note = (f"first differ at row {row} step {t}: top-2 margins card {mg!r}"
            f", CPU {mc!r} (gate {TIE_MARGIN}·{scale!r})")
    if not (mg < TIE_MARGIN * scale and mc < TIE_MARGIN * scale):
        raise AssertionError(f"{what}: free-running ids {note}")
    return note


def card_block_errors(cpu_model, card_model, x_cpu) -> dict:
    """Each block of a table model's backbone (every module at most three
    levels deep outside the head) on the card, run on the CPU model's own
    inputs to it, against the CPU block's output: max|Δ| / max|ref| per
    block. A block's error is then its own float32 rounding on the card,
    not the rounding of every block before it, which a random network
    amplifies."""
    import torch

    names = [n for n, m in cpu_model.named_modules()
             if n and n.count(".") <= 3 and not n.startswith(("head",
                                                              "SLAHead"))
             and not isinstance(m, torch.nn.ModuleList)]
    seen, mods = {}, dict(cpu_model.named_modules())

    def keep(name):
        def hook(module, args, kwargs, out):
            seen.setdefault(name, (args, kwargs, out))
        return hook

    hooks = [mods[n].register_forward_hook(keep(n), with_kwargs=True)
             for n in names]
    with torch.no_grad():
        cpu_model.features(x_cpu)
    for h in hooks:
        h.remove()

    def to_card(v):
        if isinstance(v, torch.Tensor):
            return v.to("cuda")
        if isinstance(v, (list, tuple)):
            return type(v)(to_card(a) for a in v)
        return v

    card_mods = dict(card_model.named_modules())
    errs = {}
    for n, (args, kwargs, out) in seen.items():
        with torch.no_grad():
            got = card_mods[n](*to_card(args), **to_card(kwargs))
        errs[n] = max(float((g.cpu() - r).abs().max() / r.abs().max())
                      for g, r in zip(_tensors(got), _tensors(out)))
    return errs


def table_models_phase(card: str, weights, pages, tables) -> dict:
    """Phase 23: each structure model at full width on the card against
    the CPU in float32, on pages 0-1's tables (SLANeXt: the first two):
    the K1 input; the backbone (:func:`card_block_errors`: each block on
    the CPU's inputs ≤ 1e-4 relative) and its memory on the CPU's input,
    end to end, against a float64 run of the same model on the CPU: the
    card's distance ≤ max(1e-4, 1.5× the CPU float32's own distance),
    since a random network amplifies float32 rounding by its own factor
    (SLANet_plus: the CPU's float32 memory is 2.8e-4 from float64 on
    the H100's host, PERF.md §6); the step logits with the CPU's ids fed back
    (≤ 1e-3 of max|logit|), the free-running ids (identical, or first
    differing at a near-tie on both sides); then the decode graph against
    the eager loop on the card (the same steps, logits and corners
    bit-equal over the whole buffers, at the batch and at one row more,
    a first-seen batch, whose first decode is timed with its warm-up
    chunk and capture) with ms per step of both, steps run, capture ms
    and host syncs per decode. Returns the K1 inputs the
    models' own ``recognize`` calls gave K1."""
    import torch

    from oar_ocr_tpu_torch.models.recognition.sla_decode import CHUNK
    from oar_ocr_tpu_torch.runtime.runtime import stack_padded

    rt = Runtime1("float32", device="cuda")
    cpu = Runtime1("float32", device="cpu")
    up = rt.put_pages(pages[:2], (PAGE_H, PAGE_W))
    host = torch.from_numpy(stack_padded(pages[:2], (PAGE_H, PAGE_W)))
    k1_inputs, failed = {}, []
    for name, side in TABLE_MODELS:
        regions = table_regions(tables, (0, 1))
        if name.startswith("slanext"):
            regions = regions[:2]
        card_m = table_model(name, weights[name], rt)
        cpu_m = table_model(name, weights[name], cpu)
        rec = K1Inputs(("table",))
        with rec:
            x_card = model_inputs(card_m, up, regions)
            card_m.recognize(up, regions)
        k1_inputs.update(rec.seen)
        x_cpu = model_inputs(cpu_m, host, regions)
        in_err = float((x_card.cpu() - x_cpu).abs().max())
        x_nchw = x_cpu.permute(0, 3, 1, 2)
        with torch.no_grad():
            mem_cpu = cpu_m.model.features(x_nchw)
            mem_card = card_m.model.features(x_nchw.to("cuda"))
            mem_64 = cpu_m.model.double().features(x_nchw.double())
            cpu_m.model.float()
        blocks = card_block_errors(cpu_m.model, card_m.model, x_nchw)
        worst = max(blocks, key=blocks.get)

        def dist(a, ref):
            return float((a.double().cpu() - ref).abs().max()
                         / ref.abs().max())
        mem_rel = dist(mem_card, mem_cpu.double())
        card_64, cpu_64 = dist(mem_card, mem_64), dist(mem_cpu, mem_64)
        mem_gate = max(1e-4, 1.5 * cpu_64)
        lc, _oc, steps_c = cpu_m.model.head.decode(mem_cpu)
        forced = forced_logits(card_m.model.head, mem_cpu.to("cuda"), lc,
                               steps_c).cpu()
        scale = float(lc[:, :steps_c].abs().max())
        f_rel = float((forced - lc[:, :steps_c]).abs().max()) / scale
        lg, og, steps_g = card_m.graphs.decode(mem_card)
        replays, syncs = (card_m.graphs.last["replays"],
                          card_m.graphs.last["syncs"])
        note = free_running(name, lg, lc)
        le, oe, steps_e = card_m.model.head.decode(mem_card)
        same = (steps_e == steps_g and torch.equal(le, lg)
                and torch.equal(oe, og))
        # one row more: a first-seen batch, its warm-up chunk and capture
        # in its first decode
        mem_new = torch.cat([mem_card, mem_card[:1]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ln, on, steps_n = card_m.graphs.decode(mem_new)
        t_first = (time.perf_counter() - t0) * 1e3
        t_again = host_ms(lambda: card_m.graphs.decode(mem_new), 3)
        lne, one, steps_ne = card_m.model.head.decode(mem_new)
        same_new = (steps_n == steps_ne and torch.equal(ln, lne)
                    and torch.equal(on, one))
        t_graph = host_ms(lambda: card_m.graphs.decode(mem_card), 5)
        t_eager = host_ms(lambda: card_m.model.head.decode(mem_card), 3)
        st = next(iter(card_m.graphs.states.values()))
        ok = (blocks[worst] <= 1e-4 and card_64 <= mem_gate
              and f_rel <= 1e-3 and same and same_new)
        print(f"table {name} ({side}, batch {len(regions)}), card vs CPU "
              f"float32: K1 input max abs err {in_err!r}; {len(blocks)} "
              f"backbone blocks on the CPU's inputs, max rel err "
              f"{blocks[worst]!r} at {worst} (gate 1e-4); memory "
              f"{tuple(mem_cpu.shape)} card vs CPU rel err {mem_rel!r}, "
              f"against float64 card {card_64!r} and CPU {cpu_64!r} "
              f"(gate {mem_gate!r}); "
              f"step logits with the CPU's ids fed back rel err "
              f"{f_rel!r} of max|logit| {scale!r} over {steps_c} steps "
              f"(gate 1e-3); free-running ids {note}  [{card}]")
        print(f"  {name} graph vs eager on the card: steps {steps_g} / "
              f"{steps_e}, logits and corners bit-equal {same}; at "
              f"{len(mem_new)} rows, a first-seen batch: steps {steps_n} / "
              f"{steps_ne}, bit-equal {same_new}, its first decode "
              f"{t_first!r} ms (warm-up chunk and capture included), "
              f"then {t_again!r} ms; "
              f"{t_graph / max(steps_g, 1)!r} ms/step through the graph "
              f"({t_graph!r} ms per decode, {replays} replays of "
              f"{CHUNK} steps, {syncs} host syncs) "
              f"against {t_eager / max(steps_e, 1)!r} ms/step eager "
              f"({t_eager!r} ms, {steps_e + 1} syncs); capture "
              f"{st.capture_ms!r} ms  [{card}]")
        if not ok:
            failed.append(name)
        del card_m, cpu_m, x_card, x_cpu, mem_card, mem_cpu
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"tables: card disagrees with the CPU or the "
                             f"graph with the eager loop: {failed}")
    return k1_inputs


def table_bf16_phase(card: str, weights, pages, tables) -> None:
    """Phase 24: SLANet under a bfloat16 Runtime: the backbone and the
    projection bfloat16, the decoder float32 (the JAX dtype policy), each
    backbone block in bfloat16 within 2^-4·max|ref| of float32 on
    float32's own inputs to it (:func:`bf16_block_errors`); the share of
    free-running ids bfloat16 keeps, printed."""
    import torch


    regions = table_regions(tables, (0, 1))
    models, xs, logits = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        rt = Runtime1(dtype, device="cuda")
        up = rt.put_pages(pages[:2], (PAGE_H, PAGE_W))
        models[dtype] = table_model("slanet", weights["slanet"], rt)
        xs[dtype] = model_inputs(models[dtype], up, regions)
        logits[dtype] = models[dtype].decode_inputs(xs[dtype])[0]
    net = models["bfloat16"].model
    policy = ({p.dtype for p in net.PPLCNetV3_0.parameters()}
              | {p.dtype for p in net.ConvBNAct_0.parameters()},
              {p.dtype for p in net.head.parameters()})
    if policy != ({torch.bfloat16}, {torch.float32}):
        raise AssertionError(f"SLANet bfloat16 dtype policy {policy}")
    names = (["PPLCNetV3_0.ConvBNAct_0"]
             + [f"PPLCNetV3_0.DepthSepConv_{i}"
                for i in range(net.PPLCNetV3_0.n_blocks)] + ["ConvBNAct_0"])
    errs = bf16_block_errors(models["float32"].model, net,
                             xs["float32"].permute(0, 3, 1, 2),
                             xs["bfloat16"].permute(0, 3, 1, 2), names)
    worst = max(errs, key=errs.get)
    kept = float((logits["float32"].argmax(-1)
                  == logits["bfloat16"].argmax(-1)).float().mean())
    print(f"table slanet bfloat16 vs float32: backbone and projection "
          f"bfloat16, decoder float32; {len(errs)} blocks on float32's "
          f"inputs, max rel err {errs[worst]!r} at {worst} (gate 2^-4), "
          f"median {float(np.median(list(errs.values())))!r}; free-running "
          f"ids equal at {kept!r} of the (row, step) slots (not gated)  "
          f"[{card}]")
    if errs[worst] > 2 ** -4:
        raise AssertionError("tables: SLANet bfloat16 block beyond 2^-4")
    del models, xs, logits
    torch.cuda.empty_cache()


def table_analyzer(weights, runtime):
    """``TableAnalyzer`` with its defaults (SLANet, the RT-DETR-L wired
    cell detector at score 0.3, no orientation) on the phase's weights,
    SLANet's ``slanet_table`` ones (:func:`fit_table_decoder`)."""
    from oar_ocr_tpu_torch.models.classification.pp_lcnet import \
        table_classifier
    from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
    from oar_ocr_tpu_torch.pipelines.table_analyzer import TableAnalyzer

    return TableAnalyzer(
        classifier=table_classifier(dict(weights["cls"]), runtime),
        structure=table_model("slanet", weights["slanet_table"], runtime),
        cell_detector=LayoutDetector(CELL_VARIANT, dict(weights["cell"]),
                                     score_thresh=0.3, runtime=runtime),
        runtime=runtime)


def coincident_cells(result, tol: float = 0.05) -> int:
    """How many of a table result's cells lie within ``tol`` px of an
    earlier cell (every corner): printed where a table differs, since
    which of two coincident cells an OCR box is matched into is decided
    by float32 rounding."""
    boxes = np.asarray(result.cell_boxes, np.float32).reshape(-1, 4)
    if len(boxes) < 2:
        return 0
    d = np.abs(boxes[:, None] - boxes[None]).max(-1)
    return int((np.tril(d <= tol, -1)).any(1).sum())


def table_equal(what: str, got, want):
    """(equal, max cell box error) of an analyzed table, card against CPU:
    the same structure tokens, route and HTML, and cell boxes within
    0.05 px."""
    gb = np.asarray(got.cell_boxes, np.float32).reshape(-1, 4)
    wb = np.asarray(want.cell_boxes, np.float32).reshape(-1, 4)
    err = (float(np.abs(gb - wb).max()) if gb.shape == wb.shape
           and len(wb) else 0.0)
    same = {k: getattr(got, k) == getattr(want, k)
            for k in ("structure_tokens", "is_wired", "is_e2e", "html")}
    same["cells"] = gb.shape == wb.shape and err <= 0.05
    if not all(same.values()):
        print(f"  {what} differs: {same}; cells {len(gb)} / {len(wb)}, max "
              f"abs err {err!r} px, {coincident_cells(want)} of the CPU's "
              f"cells coincident within 0.05 px")
    return all(same.values()), err


def row_matched(result) -> bool:
    """Whether the analyzer's wired route matched rows for ``result``:
    detected cells, structure tokens with a row start, cells to match."""
    from oar_ocr_tpu_torch.processors.table import find_row_start_index

    return (not result.is_e2e and bool(result.cells)
            and bool(find_row_start_index(result.structure_tokens)))


def analyzer_phase(card: str, weights, pages, tables) -> tuple:
    """Phase 25: ``TableAnalyzer.analyze_tables`` on the drawn tables'
    boxes with their text blocks as OCR. The card against the CPU in
    float32 on pages 0-3's tables (:func:`table_equal`): the same routes,
    tokens and HTML, and cell boxes within 0.05 px; the wired route with
    decoded cells
    (reconciled with the detected ones, rows matched) and the wireless
    route (the decode's cells) each at least once (reconciliation and
    row matching may run in different tables). Then all 32 tables on
    the card: tables/s (median of 3), stage ms, K1 launches per analyze
    call by caller, the decode graphs held. Returns K1's launches of
    one analyze call and K1's inputs in its warm-up call
    (:class:`K1Inputs`: SLANet, the classifier, the cell detector)."""
    import torch

    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER
    from oar_ocr_tpu_torch.runtime.runtime import stack_padded

    rt = Runtime1("float32", device="cuda")
    cpu = Runtime1("float32", device="cpu")
    inputs = table_region_inputs(tables, range(4))
    got = table_analyzer(weights, rt).analyze_tables(
        rt.put_pages(pages[:4], (PAGE_H, PAGE_W)), inputs)
    want = table_analyzer(weights, cpu).analyze_tables(
        torch.from_numpy(stack_padded(pages[:4], (PAGE_H, PAGE_W))), inputs)
    decoded = [len(st.tokens) for st in table_analyzer(
        weights, cpu).structure.recognize(
            torch.from_numpy(stack_padded(pages[:4], (PAGE_H, PAGE_W))),
            [(t.page_index, tuple(int(v) for v in t.box)) for t in inputs])]
    same, err = len(got) == len(want), 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        ok = table_equal(f"table {i}", g, w)
        same &= ok[0]
        err = max(err, ok[1])
    reconciled = [i for i, r in enumerate(want)
                  if not r.is_e2e and decoded[i]]
    rows = [i for i, r in enumerate(want) if row_matched(r)]
    wireless = [i for i, r in enumerate(want) if r.is_e2e]
    print(f"table analyzer, card vs CPU (float32, {len(inputs)} tables of "
          f"pages 0-3): the same routes, tokens and HTML, {same}; cell "
          f"boxes max abs err {err!r} px (gate 0.05); wired with decoded "
          f"cells "
          f"reconciled with the detected ones {reconciled}, wired with "
          f"rows matched {rows}, wireless {wireless}; "
          f"decoded tokens per table {decoded}, tokens "
          f"{[len(r.structure_tokens) for r in want]}, cells "
          f"{[len(r.cells) for r in want]}  [{card}]")
    if not same or not reconciled or not rows or not wireless:
        raise AssertionError("tables: the analyzer's card run disagrees "
                             "with the CPU, or a route did not run")
    inputs = table_region_inputs(tables, range(N_PAGES))
    analyzer = table_analyzer(weights, rt)
    up = rt.put_pages(pages, (PAGE_H, PAGE_W))
    with K1Inputs(("table", "table_cls", "layout")) as k1_inputs:
        analyzer.analyze_tables(up, inputs)             # warm-up
    stage_ms(reset=True)
    K1.launches = 0
    LAUNCHES_BY_CALLER.clear()
    times = []
    for call in range(3):
        t0 = time.perf_counter()
        res = analyzer.analyze_tables(up, inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if call == 0:
            launches, by_caller = K1.launches, dict(LAUNCHES_BY_CALLER)
    stages = stage_ms()
    print(f"table analyzer on the card (float32): {len(inputs)} tables in "
          f"{[round(t * 1e3, 1) for t in times]} ms, "
          f"{len(inputs) / statistics.median(times)!r} tables/s (median "
          f"of 3); K1 launches per analyze call {launches} by caller "
          f"{by_caller}; routes: {sum(r.is_wired for r in res)} wired, "
          f"{sum(not r.is_wired for r in res)} wireless  [{card}]")
    for k in TABLE_STAGES:
        n, ms = stages.get(k, (0, 0.0))
        print(f"  {k}: {ms!r} ms per call, {n / 3!r} calls per analyze  "
              f"[{card}]")
    graphs_held(analyzer.structure, card)
    if {c for c, _ in k1_inputs.seen} != {"table", "table_cls", "layout"}:
        raise AssertionError(f"tables: K1 inputs seen {list(k1_inputs.seen)}")
    if by_caller.get("table", 0) == 0:
        raise AssertionError("tables: SLANet's input did not go through K1")
    return launches, k1_inputs.seen


def graphs_held(model, card: str) -> None:
    """Prints a table model's decode graphs: each one's batch and capture
    ms."""
    print("  decode graphs held: " + ", ".join(
        f"batch {key[0]} capture {st.capture_ms!r} ms"
        for key, st in model.graphs.states.items()) + f"  [{card}]")


def structure_table_phase(card: str, det_state, rec_state, layout_state,
                          weights, pages) -> tuple:
    """Phase 26: ``OARStructure`` with tables on (formulas off; seals on,
    the OCR on ``rec_state``, main passes the recognizer
    fitted to drawn lines: the random recognizer's seal texts met
    near-ties that float32 rounding decides, PERF.md §6) at full width on
    the 16 table pages, STRUCTURE_ITERS predicts in float32, then on the
    first CUT_PAGES in bfloat16 (SLANet's backbone bfloat16, its decoder
    float32): the
    layout's table elements through the analyzer (at least 4), pages/s
    (median of 2), stage ms; the card against the CPU in float32 on the
    first TABLE_CPU_PAGES pages with a table: the same elements and texts,
    each table held as :func:`table_equal` holds it, and the same markdown.
    Each dtype's warm-up predict runs its pages, so that the timed
    predicts find their decode graph's bucket captured. The layout
    threshold is STRUCTURE_SCORE_THRESH, or lower where fewer than 4
    table boxes would pass it. Returns K1's launches of one float32
    predict and K1's inputs in its warm-up predict (:class:`K1Inputs`:
    the layout, the table classifier, SLANet, the cell detector)."""
    import torch

    from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER

    rt = Runtime1("float32", device="cuda")
    det = LayoutDetector("pp-doclayout_plus-l", dict(layout_state),
                         runtime=rt)
    boxes = layout_detect_all(det, rt.put_pages(pages, (PAGE_H, PAGE_W)),
                              [p.shape[:2] for p in pages])
    scores = sorted((b.score for page in boxes for b in page
                     if b.label == "table"), reverse=True)
    thresh = STRUCTURE_SCORE_THRESH
    if len(scores) >= 4 and scores[3] <= thresh:
        thresh = float(scores[3]) - 1e-4
    print(f"structure with tables: layout threshold {thresh!r} (table "
          f"scores above 0.5: {len(scores)}, rank 4 "
          f"{scores[3] if len(scores) > 3 else None!r})")
    del det
    main, first = 0, None
    for dtype in ("float32", "bfloat16"):
        rt = Runtime1(dtype, device="cuda")
        pipe = structure_pipeline(rt, det_state, rec_state, layout_state,
                                  tables=table_analyzer(weights, rt),
                                  thresh=thresh)
        # bfloat16 on the first CUT_PAGES pages: its seal OCR, which phase
        # 20 times, is most of its predict
        use = pages if dtype == "float32" else pages[:CUT_PAGES]
        with K1Inputs(("table", "table_cls", "layout")) as rec:
            pipe.predict(use)                          # warm-up call
        if dtype == "float32":
            k1_inputs = rec.seen
        stage_ms(reset=True)
        K1.launches = 0
        LAUNCHES_BY_CALLER.clear()
        times = []
        for call in range(STRUCTURE_ITERS):
            t0 = time.perf_counter()
            results = pipe.predict(use)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if call == 0 and dtype == "float32":
                main = K1.launches
        by_caller = {k: v / STRUCTURE_ITERS
                     for k, v in LAUNCHES_BY_CALLER.items()}
        stages = stage_ms()
        per_page = [sum(e.table is not None for e in r.elements)
                    for r in results]
        n_tables = sum(per_page)
        pps = len(use) / statistics.median(times)
        print(f"structure with tables {dtype}: {pps!r} pages/s (median of "
              f"{STRUCTURE_ITERS}, {[round(t * 1e3, 1) for t in times]} "
              f"ms per {len(use)} pages), "
              f"{n_tables} table elements analyzed (per page {per_page}), "
              f"K1 launches per predict by caller {by_caller}  [{card}]")
        for k in STRUCTURE_TABLE_STAGES + STRUCTURE_STAGES:
            n, ms = stages.get(k, (0, 0.0))
            print(f"  {dtype} {k}: {ms!r} ms per call, "
                  f"{n / STRUCTURE_ITERS!r} calls per "
                  f"predict  [{card}]")
        graphs_held(pipe.tables.structure, card)
        if n_tables < 4:
            raise AssertionError(f"structure {dtype}: {n_tables} tables "
                                 f"reached the analyzer, 4 needed")
        if by_caller.get("table", 0) == 0:
            raise AssertionError(f"structure {dtype}: no K1 launch for the "
                                 f"table models")
        if first is None:
            first = [i for i, n in enumerate(per_page) if n][
                :TABLE_CPU_PAGES]
        del pipe
        torch.cuda.empty_cache()

    print(f"structure with tables, card vs CPU (float32, pages {first}):")
    sel = [pages[i] for i in first]
    got = structure_pipeline(Runtime1("float32", device="cuda"), det_state,
                             rec_state, layout_state, thresh=thresh,
                             tables=table_analyzer(
                                 weights, Runtime1("float32", device="cuda"))
                             ).predict(sel)
    cpu = Runtime1("float32", device="cpu")
    want = structure_pipeline(cpu, det_state, rec_state, layout_state,
                              thresh=thresh,
                              tables=table_analyzer(weights, cpu)
                              ).predict(sel)
    same, n, n_tab, err = True, 0, 0, 0.0
    for p, (g, w) in enumerate(zip(got, want)):
        if len(g.elements) != len(w.elements):
            print(f"  page {p}: {len(g.elements)} / {len(w.elements)} "
                  f"elements")
            same = False
        for a, b in zip(g.elements, w.elements):
            fields = {"label": a.label == b.label,
                      "order": a.order_index == b.order_index,
                      "text": a.text == b.text,
                      "table": (a.table is None) == (b.table is None)}
            if not all(fields.values()):
                print(f"  page {p} element {n} ({a.label} / {b.label}) "
                      f"differs: {fields}; texts {a.text!r} / {b.text!r}")
                same = False
            elif a.table is not None:
                n_tab += 1
                ok, e = table_equal(f"page {p} table {n}", a.table, b.table)
                same &= ok
                err = max(err, e)
            n += 1
        if g.to_markdown() != w.to_markdown():
            print(f"  page {p}: markdown differs")
            same = False
    print(f"  {n} elements, {n_tab} tables: the same elements, texts, "
          f"table tokens, routes and HTML, and markdown {same}; table cell "
          f"boxes max abs err {err!r} px (gate 0.05)")
    if not same or n_tab == 0:
        raise AssertionError("structure with tables: card disagrees with "
                             "the CPU")
    if {c for c, _ in k1_inputs} != {"table", "table_cls", "layout"}:
        raise AssertionError(f"structure with tables: K1 inputs seen "
                             f"{list(k1_inputs)}")
    return main, k1_inputs


# ------------------------ formulas (phases 27-30) ------------------------

# drawn formula crops (phases 27-30): LaTeX-like strings with cv2.putText
FORMULA_TEXTS = ("x^2+y^2=z^2", "a_1+b_2=c_3", "E=mc^2", "f(x)=ax+b",
                 "sum_i x_i", "n!/(k!(n-k)!)", "e^(i pi)+1=0", "y=sqrt(x)")
FORMULA_CROPS, FORMULA_SEED = 16, 11
# the exact models at published width (phase 29): 2 crops each; the CPU
# side decodes EXACT_CPU_TOKENS new tokens, the card's timed run 96
EXACT_CROPS, EXACT_CPU_TOKENS = 2, 32
# card against CPU, float32 (phases 28-29): the default's memory and
# teacher-forced step logits relative to max|ref|; the exact models'
# encoder sequence and teacher-forced logits (ViT-B / Swin / HGNetV2
# depth at full width, as the table models' memory gate: ≤ 1e-4)
FORMULA_REL, EXACT_REL = 1e-5, 1e-4
# phase 30: the least number of formula elements the float32 structure
# predict must recognize on the 16 pages (phase 17's calibrated
# RT-DETR-L, its formula class unraised, labels 5 above
# STRUCTURE_SCORE_THRESH)
FORMULA_MIN_BOXES = 4
STRUCTURE_FORMULA_STAGES = ("structure.formulas", "formula.device")


def formula_crops(n: int = FORMULA_CROPS, seed: int = FORMULA_SEED):
    """``n`` white crops, each a drawn formula string in a seeded size,
    stroke, shade and margin."""
    import cv2

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        text = FORMULA_TEXTS[i % len(FORMULA_TEXTS)]
        scale = float(rng.uniform(0.8, 1.6))
        thick = int(rng.integers(1, 3))
        (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                       scale, thick)
        pad = int(rng.integers(6, 30))
        img = np.full((h + base + 2 * pad, w + 2 * pad, 3), 255, np.uint8)
        cv2.putText(img, text, (pad, pad + h), cv2.FONT_HERSHEY_SIMPLEX,
                    scale, (int(rng.integers(0, 80)),) * 3, thick)
        out.append(img)
    return out


class FormulaK1Inputs:
    """While active, keeps the first K1 input of each (caller, shape) that
    the formula recognizers hand to ``normalize_images`` (their u8
    canvases), for :func:`formula_k1_cases`; the launch is the
    recognizer's own and counts as before."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        from oar_ocr_tpu_torch.models.recognition import (
            formula, pp_formulanet_exact, unimernet)

        self.mods = (formula, pp_formulanet_exact, unimernet)
        self.launch = formula.normalize_images

        def record(x, **kw):
            key = (kw.get("caller"), tuple(x.shape))
            if key not in self.seen:
                self.seen[key] = (x, kw)
            return self.launch(x, **kw)

        for m in self.mods:
            m.normalize_images = record
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.normalize_images = self.launch


def formula_k1_cases(seen):
    """Phase 27: K1 at the formula inputs, held against ``normalize_ref``:
    the default's canvas into float32 and bfloat16, the exact models'
    into float32 (they run float32 in either Runtime)."""
    import torch

    from oar_ocr_tpu_torch.ops.normalize import (coefficients,
                                                 normalize_images,
                                                 normalize_ref)

    cases = []
    for (caller, shape), (x, kw) in seen.items():
        alpha, beta = coefficients(kw["mean"], kw["std"])
        outs = ((torch.bfloat16, torch.float32) if caller == "formula"
                else (torch.float32,))
        for out in outs:
            tag = "f32" if out == torch.float32 else "bf16"
            plain = (lambda out=out, x=x, a=alpha, b=beta:
                     normalize_ref(x, a, b, out_dtype=out))
            cases.append((
                f"{caller} u8 {shape} -> {tag}",
                lambda out=out, x=x, kw=kw: normalize_images(
                    x, mean=kw["mean"], std=kw["std"], out_dtype=out,
                    caller=kw["caller"]),
                plain, plain, gate_k1, k1_work(x, out)))
    return cases


def formula_weights() -> dict:
    """The default recognizer's seeded weights at full width (made on the
    CPU, so the card and the CPU run the same numbers)."""
    from oar_ocr_tpu_torch.models.recognition.formula import \
        FormulaRecognizer

    rec = FormulaRecognizer(None, runtime=Runtime1("float32", device="cpu"))
    return {k: v.clone() for k, v in rec.model.state_dict().items()}


def ids_gate(what: str, card_ids, cpu_ids, cpu_logits) -> str:
    """Free-running ids card against CPU: identical, or first differing at
    a step where the CPU's top-2 logit margin is below
    TIE_MARGIN·max|logit| (else AssertionError)."""
    g, c = np.asarray(card_ids), np.asarray(cpu_ids)
    diff = np.argwhere(g != c)
    if len(diff) == 0:
        return "identical"
    row, t = (int(v) for v in diff[np.lexsort((diff[:, 0],
                                               diff[:, 1]))][0])
    scale = float(cpu_logits.abs().max())
    mc = top2_margin(cpu_logits[row, t])
    note = (f"first differ at row {row} step {t}: the CPU's top-2 margin "
            f"{mc!r} (gate {TIE_MARGIN}·{scale!r})")
    if not mc < TIE_MARGIN * scale:
        raise AssertionError(f"{what}: free-running ids {note}")
    return note


def formula_phase(card: str, state) -> tuple:
    """Phase 28: the default recognizer at full width (192×672, dim 384,
    2 decoder layers, 8 heads, vocab 8000, 64 steps) on 16 drawn formula
    crops. Main path: ``recognize`` in float32 (its decode graph captured
    by a warm-up call; K1 counted on one call). Card against CPU, float32:
    the memory ≤ FORMULA_REL relative, step logits with the CPU's ids
    fed back ≤ FORMULA_REL·max|logit|, all 64 free-running ids identical
    (or first differing at a near-tie); the graph against the eager loop
    on the card, ids and probs bit-equal; ms per step through the graph
    and eager, capture ms, host syncs per decode, distinct ids. bfloat16:
    each encoder block within 2^-4·max|ref| of float32 on float32's
    inputs, the decoder float32. Returns K1's main-path launches and the
    K1 inputs seen."""
    import torch

    from oar_ocr_tpu_torch.models.recognition.formula import \
        FormulaRecognizer
    from oar_ocr_tpu_torch.models.recognition.formula_decode import \
        decode_eager
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER

    crops = formula_crops()
    rec = FormulaRecognizer(state, runtime=Runtime1("float32",
                                                   device="cuda"))
    cpu = FormulaRecognizer(state, runtime=Runtime1("float32", device="cpu"))
    rec.recognize(crops)                     # warm-up: captures the graph
    K1.launches = 0
    LAUNCHES_BY_CALLER.clear()
    with FormulaK1Inputs() as seen:
        t0 = time.perf_counter()
        results = rec.recognize(crops)
        wall = (time.perf_counter() - t0) * 1e3
    launches = K1.launches
    print(f"formula (default, float32, {len(crops)} crops): {wall!r} ms per "
          f"recognize, K1 launches {launches} by caller "
          f"{dict(LAUNCHES_BY_CALLER)}, e.g. {results[0].latex[:60]!r} "
          f"score {results[0].score!r}  [{card}]")
    if launches != 1 or LAUNCHES_BY_CALLER["formula"] != 1:
        raise AssertionError("formula: one K1 launch per recognize expected")
    if not all(r.latex for r in results) or not all(
            np.isfinite(r.score) and 0 < r.score <= 1 for r in results):
        raise AssertionError("formula: an empty LaTeX or a bad score")

    with torch.no_grad():
        x_g, x_c = rec.inputs(crops), cpu.inputs(crops)
        mem_g = rec.model.encode(x_g.permute(0, 3, 1, 2))
        mem_c = cpu.model.encode(x_c.permute(0, 3, 1, 2))
        mem_err = float((mem_g.cpu() - mem_c).abs().max()
                        / mem_c.abs().max())
        mk, mv = rec.model.prefill(mem_g)
        ids_c, probs_c, logits_c = decode_eager(
            cpu.model.decoder, *cpu.model.prefill(mem_c), return_logits=True)
        _, _, forced = decode_eager(rec.model.decoder, mk, mv,
                                    feed=ids_c.to(mk.device), return_logits=True)
        logit_err = float((forced.cpu() - logits_c).abs().max()
                          / logits_c.abs().max())
        g_ids, g_probs = (t.clone() for t in rec.graphs.decode(mk, mv))
        e_ids, e_probs = decode_eager(rec.model.decoder, mk, mv)
    note = ids_gate("formula", g_ids.cpu(), ids_c, logits_c)
    bit_equal = torch.equal(g_ids, e_ids) and torch.equal(g_probs, e_probs)
    print(f"  card vs CPU: memory rel err {mem_err!r} (gate {FORMULA_REL}), "
          f"forced step logits {logit_err!r}·max|logit| (gate "
          f"{FORMULA_REL}), 64 free-running ids {note}; graph = eager bit "
          f"for bit {bit_equal}; distinct ids {len(torch.unique(g_ids))}, "
          f"probs in [{float(g_probs.min())!r}, {float(g_probs.max())!r}]")
    if mem_err > FORMULA_REL or logit_err > FORMULA_REL:
        raise AssertionError("formula: card disagrees with the CPU")
    if not bit_equal:
        raise AssertionError("formula: the decode graph differs from the "
                             "eager loop")

    steps = rec.model.decoder.max_len
    capture = getattr(rec.graphs.states.get(tuple(mk.shape)), "capture_ms",
                      None)
    graph_ms = cuda_ms(lambda: rec.graphs.decode(mk, mv), 10) / steps
    eager_ms = cuda_ms(lambda: decode_eager(rec.model.decoder, mk, mv),
                       3) / steps
    enc_ms = cuda_ms(lambda: rec.model.prefill(rec.model.encode(
        x_g.permute(0, 3, 1, 2))), 10)
    rec.recognize(crops)
    syncs = rec.graphs.last["syncs"]
    rec_ms = host_ms(lambda: rec.recognize(crops), 5)
    print(f"  decode: graph {graph_ms!r} ms/step, eager {eager_ms!r} "
          f"ms/step ({steps} steps, batch {len(crops)}), capture "
          f"{capture!r} ms, host syncs per decode {syncs}; encoder + "
          f"cross K/V {enc_ms!r} ms; recognize {rec_ms!r} ms "
          f"({len(crops) / rec_ms * 1e3!r} crops/s)  [{card}]")

    rec16 = FormulaRecognizer(state, runtime=Runtime1("bfloat16",
                                                     device="cuda"))
    if (rec16.model.FormulaEncoder_0.LayerNorm_0.weight.dtype
            != torch.bfloat16 or rec16.model.decoder.lm_head.weight.dtype
            != torch.float32 or rec16.model.mem_k0.weight.dtype
            != torch.float32):
        raise AssertionError("formula bf16: the dtype policy is not JAX's")
    names = [f"ConvBNAct_{i}" for i in range(5)] + ["TransformerBlock_0",
                                                    "LayerNorm_0"]
    with torch.no_grad():
        errs = bf16_block_errors(rec.model.FormulaEncoder_0,
                                 rec16.model.FormulaEncoder_0,
                                 x_g.permute(0, 3, 1, 2),
                                 rec16.inputs(crops).permute(0, 3, 1, 2),
                                 names)
    res16 = rec16.recognize(crops)
    same = sum(a.latex == b.latex for a, b in zip(res16, results))
    print(f"  bfloat16: encoder blocks (gate 2^-4) "
          f"{ {k: round(v, 6) for k, v in errs.items()} }; end to end "
          f"(not gated) {same} of {len(crops)} LaTeX equal to float32's  "
          f"[{card}]")
    if max(errs.values()) > 2.0 ** -4:
        raise AssertionError("formula bf16: an encoder block is off")
    del rec, cpu, rec16
    torch.cuda.empty_cache()
    return launches, seen.seen


def parse_ids(text: str) -> list:
    """A recognizer string without a vocab (``⟨id⟩ ⟨id⟩ …``) → ids."""
    return [int(t[1:-1]) for t in text.split()]


def exact_models():
    """(name, recognizer class, config, crops) of phase 29 at published
    width: PP-FormulaNet-S (384², HGNetV2-B4 calibrated on the crops,
    MBart 384 / 16 heads / ffn 1536, vocab 50000), -L (768², Vary ViT-B +
    net_3 + projector, MBart 1024) and UniMERNet (192×672, Swin 128 of
    (2, 2, 14, 2), MBart 1024 × 8)."""
    from oar_ocr_tpu_torch.models.recognition.pp_formulanet_exact import (
        PPFormulaNetConfig, PPFormulaNetRecognizer)
    from oar_ocr_tpu_torch.models.recognition.unimernet import (
        UniMERNetConfig, UniMERNetRecognizer)

    crops = formula_crops(EXACT_CROPS, FORMULA_SEED + 1)
    return (("pp-formulanet-s", PPFormulaNetRecognizer,
             PPFormulaNetConfig(), crops),
            ("pp-formulanet-l", PPFormulaNetRecognizer,
             PPFormulaNetConfig().large(), crops),
            ("unimernet", UniMERNetRecognizer, UniMERNetConfig(), crops))


class LoggedForward:
    """A decode forward that keeps each forward's argmax ids (phase 29)."""

    def __init__(self, forward):
        self.forward, self.out = forward, []

    def begin(self, cross):
        self.forward.begin(cross)

    def __call__(self, query, rows):
        ids = self.forward(query, rows)
        self.out.append(np.asarray(ids).copy())
        return ids


def exact_crosses(rec, crops) -> list:
    """Each crop's cross-attention K/V on the recognizer's device."""
    import torch

    with torch.no_grad():
        x = rec.inputs(crops)
        return [rec.model.mbart.cross_kv(rec.model.encode(x[i:i + 1]))
                for i in range(len(crops))]


def exact_graph_vs_eager(name: str, rec, crosses, card: str) -> None:
    """Phase 29: the recognizer's loop through its graphs against the
    same loop on the eager forward, on the card from the same cross K/V,
    at EXACT_CPU_TOKENS: the ids and each forward's argmax bit-equal
    (else AssertionError); then the keys held with their capture ms, the
    graphs' pool and the host reads a forward (1)."""
    import torch

    from oar_ocr_tpu_torch.models.recognition.exact_decode import \
        EagerForward

    graphs = rec.graphs
    forwards = 0
    with torch.no_grad():
        for i, cross in enumerate(crosses):
            g = LoggedForward(graphs)
            e = LoggedForward(EagerForward(rec.model.mbart))
            ids_g = rec.decode_ids(g, cross, EXACT_CPU_TOKENS)
            ids_e = rec.decode_ids(e, cross, EXACT_CPU_TOKENS)
            same = ids_g == ids_e and len(g.out) == len(e.out) and all(
                np.array_equal(a, b) for a, b in zip(g.out, e.out))
            if not same:
                raise AssertionError(f"{name} crop {i}: graph ids {ids_g} "
                                     f"!= eager ids {ids_e}")
            forwards += len(g.out)
    keys = {k: g.capture_ms for k, g in sorted(graphs.graphs.items())}
    print(f"  {name} graphs = eager bit for bit ({len(crosses)} crops, "
          f"{forwards} forwards, {EXACT_CPU_TOKENS} new tokens at most: "
          f"ids and every forward's argmax); keys (bucket, rows, memory "
          f"length) held {len(keys)} with capture ms {keys}; pool "
          f"{pool_bytes(graphs.pool)!r} bytes; host reads per forward "
          f"{graphs.reads / graphs.forwards!r} ({graphs.reads} / "
          f"{graphs.forwards}), eager past the last bucket "
          f"{graphs.eager}  [{card}]")
    if len(keys) > 6 or graphs.reads != graphs.forwards or graphs.eager:
        raise AssertionError(f"{name}: {len(keys)} keys, {graphs.reads} "
                             f"reads for {graphs.forwards} forwards")


def exact_ms_per_token(name: str, rec, crosses, card: str) -> None:
    """Phase 29: the host loop at 96 new tokens (the default) from each
    crop's K/V, through the graphs (after one untimed run that captures
    the keys 96 tokens reach) and on the eager forward: ms per token of
    each, and the same ids; then each key's replay alone, CUDA events
    around it (the device's share of a forward)."""
    import torch

    from oar_ocr_tpu_torch.models.recognition.exact_decode import \
        EagerForward

    rows = {}
    with torch.no_grad():
        for cross in crosses:
            rec.decode_ids(rec.graphs, cross, 96)
        for label, forward in (("graph", rec.graphs),
                               ("eager", EagerForward(rec.model.mbart))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = [rec.decode_ids(forward, cross, 96) for cross in crosses]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rows[label] = (ids, ms, sum(len(t) - 1 for t in ids))
    if rows["graph"][0] != rows["eager"][0]:
        raise AssertionError(f"{name}: graph ids at 96 new tokens differ "
                             f"from eager")
    (_, g_ms, toks), (_, e_ms, _) = rows["graph"], rows["eager"]
    replay = {k[0]: cuda_ms(g.replay, iters=20)
              for k, g in sorted(rec.graphs.graphs.items())}
    print(f"  {name} host loop at 96 new tokens ({toks} emitted, "
          f"{len(crosses)} crops, the same ids): graph "
          f"{g_ms / max(toks, 1)!r} ms/token, eager "
          f"{e_ms / max(toks, 1)!r} ms/token, eager / graph "
          f"{e_ms / g_ms!r}; one replay by bucket (CUDA events, median of "
          f"20) {replay} ms  [{card}]")


def formulanet_phase(card: str) -> tuple:
    """Phase 29: PP-FormulaNet-S, -L and UniMERNet at published width on
    2 drawn crops each, float32 (as in either Runtime). Card against CPU:
    the encoder sequence ≤ EXACT_REL relative, the decoder's logits on
    the CPU's ids (one teacher-forced forward) ≤ EXACT_REL·max|logit|,
    the free-running ids identical (or first differing at a near-tie);
    the CPU decodes EXACT_CPU_TOKENS new tokens, the card the same for
    the comparison and 96 (the default) for its times. On the card the
    recognizer's decode forwards replay its graphs: they are held to the
    eager forward bit for bit (:func:`exact_graph_vs_eager`), and timed
    against it (:func:`exact_ms_per_token`); one K1 launch a recognize
    call. Returns K1's inputs seen and PP-FormulaNet-S's weights (phase
    30)."""
    import torch

    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER
    from oar_ocr_tpu_torch.utils.calibrate import calibrated_state_dict

    gpu, cpu_rt = Runtime1("float32", device="cuda"), Runtime1(
        "float32", device="cpu")
    seen, s_state = {}, None
    for name, cls, cfg, crops in exact_models():
        t0 = time.perf_counter()
        cpu = cls(None, cfg=cfg, runtime=cpu_rt)
        if name == "pp-formulanet-s":
            # identity BatchNorm statistics shrink a random HGNetV2's map
            x = cpu.inputs(crops).permute(0, 3, 1, 2)
            bb = calibrated_state_dict(cpu.model.backbone,
                                       torch.Generator().manual_seed(3), x)
            cpu.model.backbone.load_state_dict(bb)
        state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
        card_rec = cls(state, cfg=cfg, runtime=gpu)
        made = time.perf_counter() - t0
        LAUNCHES_BY_CALLER.clear()
        with FormulaK1Inputs() as rec_k1:
            card_rec.recognize(crops, max_new_tokens=EXACT_CPU_TOKENS)
        seen.update(rec_k1.seen)
        k1_calls = dict(LAUNCHES_BY_CALLER)
        if list(k1_calls.values()) != [1]:
            raise AssertionError(f"{name}: K1 launches of one recognize "
                                 f"call {k1_calls}, 1 expected")
        got = card_rec.recognize(crops, max_new_tokens=EXACT_CPU_TOKENS)
        t1 = time.perf_counter()
        want = cpu.recognize(crops, max_new_tokens=EXACT_CPU_TOKENS)
        cpu_s = time.perf_counter() - t1
        mbart_c, mbart_g = cpu.model.mbart, card_rec.model.mbart
        enc_err = logit_err = 0.0
        notes = []
        with torch.no_grad():
            xc, xg = cpu.inputs(crops), card_rec.inputs(crops)
            for i, text in enumerate(want):
                ec = cpu.model.encode(xc[i:i + 1])
                eg = card_rec.model.encode(xg[i:i + 1])
                enc_err = max(enc_err, float((eg.cpu() - ec).abs().max()
                                             / ec.abs().max()))
                seq = torch.tensor([[cfg.sos_id] + parse_ids(text)])
                lc = mbart_c(seq, ec)
                lg = mbart_g(seq.to(eg.device), eg).cpu()
                logit_err = max(logit_err, float((lg - lc).abs().max()
                                                 / lc.abs().max()))
                ids_c, ids_g = parse_ids(text), parse_ids(got[i])
                if ids_c != ids_g:
                    n = min(len(ids_c), len(ids_g))
                    t = next((j for j in range(n) if ids_c[j] != ids_g[j]),
                             n)
                    notes.append(f"crop {i} first differs at token {t}, "
                                 f"the CPU's forced top-2 margin there "
                                 f"{top2_margin(lc[0, t])!r} of max|logit| "
                                 f"{float(lc.abs().max())!r}")
        print(f"{name} (float32, {len(crops)} crops, weights in "
              f"{made!r} s): encoder rel err {enc_err!r}, teacher-forced "
              f"logits {logit_err!r}·max|logit| (gates {EXACT_REL}); "
              f"free-running ids ({EXACT_CPU_TOKENS} new tokens at most, "
              f"{[len(parse_ids(t)) for t in want]} emitted) "
              f"{notes or 'identical'}; CPU recognize {cpu_s!r} s; K1 by "
              f"caller in one recognize call {k1_calls}  [{card}]")
        if enc_err > EXACT_REL or logit_err > EXACT_REL or notes:
            raise AssertionError(f"{name}: card disagrees with the CPU")
        crosses = exact_crosses(card_rec, crops)
        exact_graph_vs_eager(name, card_rec, crosses, card)
        exact_ms_per_token(name, card_rec, crosses, card)
        del crosses
        stage_ms(reset=True)
        t0 = time.perf_counter()
        full = card_rec.recognize(crops)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        stages = stage_ms()
        enc = stages.get("formula.encode", stages.get("unimernet.encode",
                                                      (0, 0.0)))
        toks = sum(len(parse_ids(t)) for t in full)
        print(f"  {name} times: recognize {wall!r} ms for {toks} tokens "
              f"({len(crops)} crops, 96 new at most, through the graphs): "
              f"{(wall - enc[0] * enc[1]) / max(toks, 1)!r} ms per token "
              f"of the host loop, encode {enc[1]!r} ms per crop  [{card}]")
        if name == "pp-formulanet-s":
            s_state = state
        del cpu, card_rec, state
        torch.cuda.empty_cache()
    return seen, s_state


def first_seen_formulas(pipe, pages, per_page, card: str) -> None:
    """Phase 30: the cost of a formula count the decoder holds no graph
    for. One float32 predict on the shortest prefix of the pages whose
    formula count has no graph yet (its first decode warms the loop up
    eagerly and captures the graph inside the call), then the same
    predict again (a replay): wall ms and ``structure.formulas`` ms of
    both, the capture ms and the graphs held after."""
    import torch

    graphs = pipe.formulas.graphs
    held = {k[1] for k in graphs.states}
    k = next((k for k in range(1, len(pages) + 1)
              if sum(per_page[:k]) and sum(per_page[:k]) not in held), None)
    if k is None:
        print(f"  first-seen formula count: every prefix's count has a "
              f"graph already ({sorted(held)})  [{card}]")
        return
    sub, n = pages[:k], sum(per_page[:k])
    rows = []
    for label in ("first seen", "again"):
        stage_ms(reset=True)
        t0 = time.perf_counter()
        pipe.predict(sub)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rows.append((label, wall,
                     stage_ms().get("structure.formulas", (0, 0.0))[1]))
    capture = next(st.capture_ms for key, st in graphs.states.items()
                   if key[1] == n)
    print(f"  first-seen formula count (float32, pages 0-{k - 1}, {n} "
          f"formulas, no graph held for {n}): "
          + "; ".join(f"{label}: predict {wall!r} ms, structure.formulas "
                      f"{f_ms!r} ms" for label, wall, f_ms in rows)
          + f"; capture {capture!r} ms; graphs held after, by batch "
          f"{sorted(key[1] for key in graphs.states)} (one per count "
          f"seen, never evicted)  [{card}]")


def exact_structure_predict(card: str, det_state, rec_state, layout_state,
                            s_state, pages) -> None:
    """Phase 30: one float32 ``OARStructure`` predict with PP-FormulaNet-S
    on phase 29's weights as its recognizer, passed as a caller with
    weights passes it (``formulas=PPFormulaNetExactAdapter(state,
    runtime=rt)``), on ``pages``: its decode forwards replay the graphs
    through the entry point. At least one formula element must come back
    with a non-empty LaTeX string. Prints ``structure.formulas`` ms and
    the graph keys held after."""
    import torch

    from oar_ocr_tpu_torch.models.recognition.pp_formulanet_exact import \
        PPFormulaNetExactAdapter

    rt = Runtime1("float32", device="cuda")
    adapter = PPFormulaNetExactAdapter(s_state, runtime=rt)
    pipe = structure_pipeline(rt, det_state, rec_state, layout_state,
                              seals=False, formulas=adapter)
    stage_ms(reset=True)
    t0 = time.perf_counter()
    results = pipe.predict(pages)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    stages = stage_ms()
    latex = [e.formula_latex for r in results for e in r.elements
             if e.formula_latex is not None]
    graphs = adapter.rec.graphs
    f_ms = stages.get("structure.formulas", (0, 0.0))[1]
    print(f"structure with pp-formulanet-exact (float32, {len(pages)} "
          f"pages, the -S recognizer of phase 29): predict {wall!r} ms, "
          f"structure.formulas {f_ms!r} ms, {len(latex)} formulas, "
          f"{sum(bool(t) for t in latex)} with LaTeX (first "
          f"{(latex or [''])[0][:60]!r}); graph keys held after "
          f"{sorted(graphs.graphs)}, {graphs.forwards} forwards, "
          f"{graphs.reads} host reads  [{card}]")
    if not any(latex) or not graphs.graphs or graphs.reads != \
            graphs.forwards:
        raise AssertionError("structure with pp-formulanet-exact: no "
                             "formula recognized through the graphs")
    del pipe, adapter
    torch.cuda.empty_cache()


def structure_formula_phase(card: str, det_state, rec_state, layout_state,
                            fstate, s_state) -> tuple:
    """Phase 30: ``OARStructure`` with formulas on (the default
    recognizer on phase 28's weights; seals off as in phase 26, tables
    off) at full width on the 16 bench pages, the layout's formula class
    unraised, STRUCTURE_ITERS predicts in float32, then bfloat16:
    formula elements with LaTeX (at least FORMULA_MIN_BOXES in float32,
    at least one in bfloat16), pages/s (median of 2), ``structure.formulas``
    ms; the cost of a first-seen formula count
    (:func:`first_seen_formulas`); the card against the CPU in float32 on
    the first CPU_PAGES pages with a formula: identical elements, texts and
    ``formula_latex``, and identical markdown; on those pages, one predict
    with PP-FormulaNet-S (:func:`exact_structure_predict`). Returns K1's
    launches of one float32 predict and K1's inputs in its warm-up
    predict: the formula canvas (:class:`FormulaK1Inputs`) and the
    layout's (:class:`K1Inputs`).
    """
    import torch

    from oar_ocr_tpu_torch.models.recognition.formula import \
        FormulaRecognizer
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER

    pages = make_pages(0)
    main, first = 0, None
    for dtype in ("float32", "bfloat16"):
        rt = Runtime1(dtype, device="cuda")
        pipe = structure_pipeline(rt, det_state, rec_state, layout_state,
                                  seals=False,
                                  formulas=FormulaRecognizer(fstate,
                                                             runtime=rt))
        with FormulaK1Inputs() as frec, K1Inputs(("layout",)) as lrec:
            pipe.predict(pages)                    # warm-up: the graph
        if dtype == "float32":
            formula_inputs, layout_inputs = frec.seen, lrec.seen
        stage_ms(reset=True)
        K1.launches = 0
        LAUNCHES_BY_CALLER.clear()
        times = []
        for call in range(STRUCTURE_ITERS):
            t0 = time.perf_counter()
            results = pipe.predict(pages)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if call == 0 and dtype == "float32":
                main = K1.launches
        by_caller = {k: v / STRUCTURE_ITERS
                     for k, v in LAUNCHES_BY_CALLER.items()}
        stages = stage_ms()
        per_page = [sum(e.formula_latex is not None for e in r.elements)
                    for r in results]
        pps = len(pages) / statistics.median(times)
        print(f"structure with formulas {dtype}: {pps!r} pages/s (median "
              f"of {STRUCTURE_ITERS}, {[round(t * 1e3, 1) for t in times]} "
              f"ms per {len(pages)} "
              f"pages), {sum(per_page)} formulas recognized (per page "
              f"{per_page}), K1 launches per predict by caller "
              f"{by_caller}  [{card}]")
        for k in STRUCTURE_FORMULA_STAGES + STRUCTURE_STAGES:
            n, ms = stages.get(k, (0, 0.0))
            print(f"  {dtype} {k}: {ms!r} ms per call, "
                  f"{n / STRUCTURE_ITERS!r} calls per "
                  f"predict  [{card}]")
        least = FORMULA_MIN_BOXES if dtype == "float32" else 1
        if sum(per_page) < least or by_caller.get("formula", 0) == 0:
            raise AssertionError(f"structure {dtype}: {sum(per_page)} "
                                 f"formulas reached the recognizer, "
                                 f"{least} needed")
        if dtype == "float32":
            first_seen_formulas(pipe, pages, per_page, card)
        if first is None:
            first = [i for i, n in enumerate(per_page) if n][:CPU_PAGES]
        del pipe
        torch.cuda.empty_cache()
    if ({c for c, _ in formula_inputs} != {"formula"}
            or {c for c, _ in layout_inputs} != {"layout"}):
        raise AssertionError(f"structure with formulas: K1 inputs seen "
                             f"{list(formula_inputs) + list(layout_inputs)}")

    print(f"structure with formulas, card vs CPU (float32, pages {first}):")
    t0 = time.perf_counter()
    sel = [pages[i] for i in first]
    out = []
    for dev in ("cuda", "cpu"):
        rt = Runtime1("float32", device=dev)
        out.append(structure_pipeline(
            rt, det_state, rec_state, layout_state, seals=False,
            formulas=FormulaRecognizer(fstate, runtime=rt)).predict(sel))
    same, n, n_f = True, 0, 0
    for p, (g, w) in enumerate(zip(*out)):
        same &= len(g.elements) == len(w.elements)
        for a, b in zip(g.elements, w.elements):
            if (a.label, a.order_index, a.text, a.formula_latex) != (
                    b.label, b.order_index, b.text, b.formula_latex):
                print(f"  page {p} element {n} ({a.label} / {b.label}) "
                      f"differs: texts {a.text!r} / {b.text!r}, LaTeX "
                      f"{a.formula_latex!r} / {b.formula_latex!r}")
                same = False
            n_f += a.formula_latex is not None
            n += 1
        same &= g.to_markdown() == w.to_markdown()
    print(f"  {n} elements, {n_f} formulas: the same elements, texts, "
          f"LaTeX and markdown {same}; {time.perf_counter() - t0!r} s")
    if not same or n_f == 0:
        raise AssertionError("structure with formulas: card disagrees "
                             "with the CPU")
    exact_structure_predict(card, det_state, rec_state, layout_state,
                            s_state, sel)
    return main, formula_inputs, layout_inputs


# ----------------------- the server OCR (phase 31) -----------------------

# the server det's binarize and box thresholds, and its candidates per
# page: its calibrated random map spreads over [0, 1] (median 0.5) in
# pixel-scale noise and its boxes score ~0.5, so the count of boxes over
# 0.5 swings with the calibration (75-140 a page on one CPU, ~870 on
# another, and none at 0.5 / 0.6); the cap on candidates bounds it
SERVER_DET_THRESH, SERVER_BOX_THRESH, SERVER_CANDIDATES = 0.45, 0.5, 64
SERVER_ITERS = 2


def server_weights(pages):
    """Seeded weights of the server det and rec (PP-HGNetV2-B4) at full
    width, made on the CPU so the card and the CPU run the same numbers:
    every BatchNorm calibrated (``utils/calibrate``), the det on page 0's
    own det input (the (1, 960, 960, 3) tile its dispatch feeds the
    model), the rec on eight 48×320 crops of page 0's blocks; the rec's
    CTC blank logit +4.0, as phase 4's."""
    import torch

    from oar_ocr_tpu_torch.models.detection.db import DBNet
    from oar_ocr_tpu_torch.models.detection.detector import DBDetector
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
    from oar_ocr_tpu_torch.ops.ctc import default_charset
    from oar_ocr_tpu_torch.utils.calibrate import calibrated_state_dict

    cpu = Runtime1("float32", device="cpu")
    det = DBDetector(None, backbone="hgnet", runtime=cpu)
    seen = []
    det.model.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    det.dispatch(cpu.put_pages(pages[:1], (PAGE_H, PAGE_W)),
                 [pages[0].shape[:2]])
    det = calibrated_state_dict(DBNet(backbone="hgnet"),
                                torch.Generator().manual_seed(1), seen[0])
    tiles = np.stack([pages[0][y - 8:y + 40, 40:360]
                      for y in range(40, 520, 60)])
    rec = calibrated_state_dict(
        SVTRRecognizer(2 + len(default_charset()), backbone="hgnet"),
        torch.Generator().manual_seed(2),
        torch.from_numpy(tiles).float() * (2.0 / 255.0) - 1.0)
    rec["head.ctc_head.fc.bias"][0] += 4.0
    return det, rec


def server_pipeline(runtime, det_state, rec_state):
    """``OAROCR(DBDetector(backbone="hgnet"), CTCRecognizer(
    backbone="hgnet"), cfg)``, batches 8 / 64."""
    from oar_ocr_tpu_torch.models.detection.detector import DBDetector
    from oar_ocr_tpu_torch.models.recognition.recognizer import \
        CTCRecognizer
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCR, OAROCRConfig
    from oar_ocr_tpu_torch.processors.db_postprocess import \
        DBPostProcessConfig

    return OAROCR(
        DBDetector(det_state, backbone="hgnet", runtime=runtime,
                   post_cfg=DBPostProcessConfig(
                       thresh=SERVER_DET_THRESH,
                       box_thresh=SERVER_BOX_THRESH,
                       max_candidates=SERVER_CANDIDATES)),
        CTCRecognizer(rec_state, backbone="hgnet", runtime=runtime),
        OAROCRConfig(image_batch_size=8, region_batch_size=64))


def server_phase(card: str) -> tuple:
    """Phase 31: the server OCR at full width on the 16 bench pages,
    float32 then bfloat16: a first predict (recording K1's det and rec
    inputs), SERVER_ITERS timed ones (pages/s, K1 launches per predict);
    the card against the CPU in float32 on the first CPU_PAGES pages:
    the det probability map within 1e-4 of the CPU's float64 run, or within twice
    the CPU float32's own distance from it where that is larger (a random
    PP-HGNetV2-B4 amplifies rounding: the CPU's float32 lies 8.4e-5 from
    float64), and the OCR gate of phase 5 (same regions, IoU ≥ 0.95,
    identical texts). Returns K1's launches over the float32 timed
    predicts and the K1 inputs seen."""
    import copy

    import torch

    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER
    from oar_ocr_tpu_torch.utils.parity import compare_results

    t0 = time.perf_counter()
    pages = make_pages(0)
    det_state, rec_state = server_weights(pages)
    print(f"server weights (calibrated on the CPU) in "
          f"{time.perf_counter() - t0!r} s")
    gpu = Runtime1("float32", device="cuda")
    pps, launches = {}, 0
    seen = {}
    for dtype in ("float32", "bfloat16"):
        pipe = server_pipeline(Runtime1(dtype, device="cuda"), det_state,
                               rec_state)
        with K1Inputs(("det", "rec")) as rec_seen:
            t1 = time.perf_counter()
            res = pipe.predict(pages)
            first = time.perf_counter() - t1
        if dtype == "float32":
            seen, pipe32 = rec_seen.seen, pipe
        K1.launches = 0
        LAUNCHES_BY_CALLER.clear()
        times = []
        for _ in range(SERVER_ITERS):
            t1 = time.perf_counter()
            res = pipe.predict(pages)
            times.append(time.perf_counter() - t1)
        if dtype == "float32":
            launches = K1.launches
        n = [len(r.regions) for r in res]
        pps[dtype] = N_PAGES / statistics.median(times)
        print(f"server OCR {dtype}: {pps[dtype]!r} pages/s (median of "
              f"{SERVER_ITERS}, iters_ms "
              f"{[round(t * 1e3, 1) for t in times]}, first call "
              f"{first * 1e3!r} ms), regions per page {n}, K1 launches "
              f"per predict {K1.launches / SERVER_ITERS!r} by caller "
              f"{dict(LAUNCHES_BY_CALLER)}, "
              f"{sum(1 for r in res for x in r.regions if x.text)} "
              f"non-empty texts  [{card}]")
        if min(n) < 10 or not LAUNCHES_BY_CALLER.get("det") or \
                not LAUNCHES_BY_CALLER.get("rec"):
            raise AssertionError(f"server OCR {dtype}: too few regions or "
                                 f"no K1 launch at det / rec")
        if not all(np.isfinite(x.confidence) and np.isfinite(
                np.asarray(x.box, np.float32)).all()
                for r in res for x in r.regions):
            raise AssertionError("server OCR: a non-finite box or score")
        del pipe
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cpu_rt = Runtime1("float32", device="cpu")
    cpu = server_pipeline(cpu_rt, det_state, rec_state)
    sub = pages[:CPU_PAGES]
    shapes = [p.shape[:2] for p in sub]
    inputs = []
    hook = cpu.detector.model.register_forward_pre_hook(
        lambda m, args: inputs.append(args[0]))
    prob_c = cpu.detector.dispatch(
        cpu_rt.put_pages(sub, (PAGE_H, PAGE_W)), shapes)[1]
    hook.remove()
    prob_g = pipe32.detector.dispatch(
        gpu.put_pages(sub, (PAGE_H, PAGE_W)), shapes)[1].cpu()
    with torch.no_grad():
        prob_64 = copy.deepcopy(cpu.detector.model).double()(
            inputs[0].double())
    scale = float(prob_64.abs().max())
    err, cpu_err = (float((p.double() - prob_64).abs().max()) / scale
                    for p in (prob_g, prob_c))
    card_cpu = float((prob_g - prob_c).abs().max()) / scale
    gate = max(1e-4, 2 * cpu_err)
    report = compare_results(pipe32.predict(sub), cpu.predict(sub))
    print(f"server OCR gpu vs cpu ({len(sub)} pages, float32): det prob map card "
          f"vs cpu {card_cpu!r} of max; card vs cpu float64 {err!r} (gate "
          f"{gate!r}: 1e-4, or twice the CPU float32's {cpu_err!r}, as "
          f"PP-HGNetV2-B4 amplifies rounding); {json.dumps(report)}; "
          f"{time.perf_counter() - t0!r} s")
    if err > gate or not report["ok"]:
        raise AssertionError("server OCR: the card disagrees with the CPU")
    print(f"card: {card}; server OCR pages/s float32 {pps['float32']!r}, "
          f"bfloat16 {pps['bfloat16']!r}")
    return launches, seen


# --------------------- the serving engine (phase 32) ---------------------

SERVE_REQUESTS, SERVE_THREADS = 16, 4


class EngineBatches:
    """A pipeline wrapper that records the pages of each batch the engine
    hands it (the engine's own batches, in order)."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.batches = []

    def predict(self, images):
        self.batches.append(list(images))
        return self.pipe.predict(images)

    def predict_dispatch(self, images):
        self.batches.append(list(images))
        return self.pipe.predict_dispatch(images)

    def predict_collect(self, state):
        return self.pipe.predict_collect(state)


def same_result(a, b) -> bool:
    """The same boxes within 1e-4 and the same texts."""
    return len(a.regions) == len(b.regions) and all(
        np.allclose(np.asarray(x.box, np.float32),
                    np.asarray(y.box, np.float32), atol=1e-4)
        and x.text == y.text for x, y in zip(a.regions, b.regions))


def serve(pipe, pages):
    """SERVE_REQUESTS single-page requests from SERVE_THREADS threads
    through a ServingEngine (max_batch_size 8, max_wait_ms 5): (results
    in page order, wall s, stats with p95, the engine's batches)."""
    import threading

    from oar_ocr_tpu_torch.serving.engine import ServingConfig, ServingEngine

    rec = EngineBatches(pipe)
    eng = ServingEngine(rec, ServingConfig(max_batch_size=8, max_wait_ms=5))
    handles = [None] * SERVE_REQUESTS
    per = SERVE_REQUESTS // SERVE_THREADS

    def producer(t):
        for i in range(t * per, (t + 1) * per):
            handles[i] = eng.submit(pages[i])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(SERVE_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results = [h.result(timeout=300) for h in handles]
    wall = time.perf_counter() - t0
    stats = eng.stats()
    stats["p95_ms"] = eng._stats.latency_quantile(0.95)
    eng.close()
    return results, wall, stats, rec.batches


def serving_phase(card: str, det_state, rec_state) -> None:
    """Phase 32: a ServingEngine over phase 6's mobile OAROCR (float32,
    the bench detector, the blank-biased recognizer) on the card. First
    ``predict_dispatch`` of 8 and of 3 pages under
    ``torch.cuda.set_sync_debug_mode("warn")``: no synchronizing call
    (the double buffer overlaps only if dispatch does not wait for the
    device). Then SERVE_REQUESTS single-page requests from SERVE_THREADS
    threads: requests/s, p50/p95 latency, mean batch size, and the
    device busy share (kernel time of a profiled rerun / the unprofiled
    wall). Gates: every served result equals its page's result in a
    direct ``predict`` of the batch the engine formed (same boxes within
    1e-4, same texts); and its boxes equal a direct single-page
    ``predict``'s within 1e-4 (texts printed: the recognizer pools a
    batch's crops, so a chunk's width bucket, and with it SVTR's padded
    attention, can depend on the batch)."""
    import warnings

    import torch


    pages = make_pages(0)
    pipe = build_pipeline(Runtime1("float32", device="cuda"), det_state,
                          rec_state)
    pipe.predict(pages[:8])
    pipe.predict(pages[:3])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            states = [pipe.predict_dispatch(pages[:8]),
                      pipe.predict_dispatch(pages[8:11])]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("a prototype feature") is not a sync
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    for st in states:
        pipe.predict_collect(st)
    print(f"serving: predict_dispatch of 8 and 3 pages made {len(syncs)} "
          f"synchronizing calls {syncs[:2]} (gate: 0)")
    if syncs:
        raise AssertionError("predict_dispatch synchronizes with the card")

    serve(pipe, pages)                               # warm-up
    results, wall, stats, batches = serve(pipe, pages)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        serve(pipe, pages)
        torch.cuda.synchronize()
    dev_s = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.key != "Command Buffer Full") / 1e6
    print(f"serving {SERVE_REQUESTS} requests from {SERVE_THREADS} threads "
          f"(max_batch_size 8, max_wait_ms 5): {SERVE_REQUESTS / wall!r} "
          f"requests/s, wall {wall * 1e3!r} ms, p50 {stats['p50_ms']!r} ms, "
          f"p95 {stats['p95_ms']!r} ms, batches {stats['batches']}, mean "
          f"batch {stats['mean_batch_size']!r} (sizes "
          f"{[len(b) for b in batches]}), device busy share "
          f"{dev_s / wall!r} ({dev_s * 1e3!r} ms of kernels)  [{card}]")
    index = {id(p): i for i, p in enumerate(pages)}
    sent = [index[id(im)] for b in batches for im in b]
    if sorted(sent) != list(range(SERVE_REQUESTS)):
        raise AssertionError(f"serving: the engine's batches hold {sent}")
    batch_direct = {}
    for b in batches:
        for im, res in zip(b, pipe.predict(b)):
            batch_direct[index[id(im)]] = res
    single = [pipe.predict([p])[0] for p in pages[:SERVE_REQUESTS]]
    bad = [i for i, r in enumerate(results)
           if not same_result(r, batch_direct[i])]
    box_bad = [i for i, r in enumerate(results) if not same_result(
        _boxes_only(r), _boxes_only(single[i]))]
    text_same = sum(x.text == y.text for r, s in zip(results, single)
                    for x, y in zip(r.regions, s.regions))
    n = sum(len(r.regions) for r in results)
    print(f"served vs direct: {SERVE_REQUESTS - len(bad)} of "
          f"{SERVE_REQUESTS} equal a direct predict of their batch (gate: "
          f"all); boxes equal a single-page predict on "
          f"{SERVE_REQUESTS - len(box_bad)} (gate: all), texts on "
          f"{text_same} of {n} regions (printed)")
    if bad or box_bad:
        raise AssertionError(f"serving: served results differ from direct "
                             f"predicts (batch {bad}, single {box_bad})")


def _boxes_only(res):
    """A copy of an OAROCRResult without its texts."""
    import copy

    out = copy.copy(res)
    out.regions = [dataclasses.replace(x, text="") for x in res.regions]
    return out


# ------------------------ the predictors (phase 33) ------------------------

def same_boxes(got, want, tol: float = 1e-3) -> bool:
    """[(boxes, scores)] per image: the same counts, vertices within
    ``tol`` px, scores within 1e-5."""
    return all(len(gb) == len(wb) and all(
        np.asarray(a).shape == np.asarray(b).shape
        and np.abs(np.asarray(a) - np.asarray(b)).max() <= tol
        for a, b in zip(gb, wb)) and np.allclose(gs, ws, atol=1e-5)
        for (gb, gs), (wb, ws) in zip(got, want))


def predictors_phase(card: str, det_state, fitted, layout_state=None,
                     table_states=None) -> None:
    """Phase 33: each of the 11 task predictors on the card in float32,
    on the weights the earlier phases hold (the bench detector; the
    fitted recognizer; phase 17's RT-DETR-L; phase 22's SLANet, table
    classifier and cell detector; the chain's classifiers and tempered
    UVDoc, calibrated again on pages 0-3; the formula models seeded).
    Each is held to the wrapper it calls on the same upload (identical
    outputs) and must launch K1; the detectors, the recognizer and the
    three classifiers also to the port's CPU (boxes within 1e-3 px and
    scores within 1e-5; texts identical; probabilities within 1e-4,
    classes where the top-2 gap is ≥ TIE_GAP). The formula predictor
    runs the task config's 256 steps: its decode graph against the
    eager loop, bit for bit."""
    import torch

    from oar_ocr_tpu_torch.models.recognition.formula_decode import \
        decode_eager
    from oar_ocr_tpu_torch.models.recognition.recognizer import CropPlan
    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER
    from oar_ocr_tpu_torch.predictors import predictors as P
    from oar_ocr_tpu_torch.tasks import tasks as T

    gpu, cpu = Runtime1("float32", device="cuda"), Runtime1("float32",
                                                         device="cpu")
    pages = make_pages(0)
    page, boxes, _truth = text_page()
    lines = [page[y0:y1, x0:x1].copy() for x0, y0, x1, y1 in boxes]
    table_states = table_states or {}
    cw = chain_weights(chain_pages()[:4])
    t_all = time.perf_counter()

    def run(name, p, images, wrapper):
        before = sum(LAUNCHES_BY_CALLER.values())
        t0 = time.perf_counter()
        out = p.predict(images)
        ms = (time.perf_counter() - t0) * 1e3
        k1 = sum(LAUNCHES_BY_CALLER.values()) - before
        want = wrapper(*p._upload(images)) if wrapper else None
        print(f"predictor {name}: {len(images)} images, {ms!r} ms, K1 "
              f"launches {k1}  [{card}]")
        if k1 < 1:
            raise AssertionError(f"predictor {name}: no K1 launch")
        return out, want

    def check(name, ok):
        if not ok:
            raise AssertionError(f"predictor {name}: disagrees")

    # detection: wrapper, then the CPU
    for name, cls, cfg in (
            ("text_detection", P.TextDetectionPredictor,
             T.TextDetectionConfig()),
            ("seal_text_detection", P.SealTextDetectionPredictor,
             T.SealTextDetectionConfig())):
        p = cls(cfg, det_state, runtime=gpu)
        out, _ = run(name, p, pages[:2], None)
        check(name, same_boxes(out, p._det.detect_images(pages[:2]), 0.0))
        ref = cls(cfg, det_state, runtime=cpu).predict(pages[:2])
        print(f"  {name}: {[len(b) for b, _ in out]} boxes, card vs cpu "
              f"equal {same_boxes(out, ref)}")
        check(name + " vs cpu", same_boxes(out, ref)
              and sum(len(b) for b, _ in out) >= 10)

    # recognition on the drawn lines, with and without score_thresh
    for thresh in (0.0, 0.97):
        cfg = T.TextRecognitionConfig(score_thresh=thresh)
        p = P.TextRecognitionPredictor(cfg, fitted, runtime=gpu)
        out, (up, shapes) = run(f"text_recognition (score_thresh "
                                f"{thresh})", p, lines,
                                lambda up, shapes: (up, shapes))
        plans = [CropPlan.from_quad(i, np.array(
            [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float32))
            for i, (h, w) in enumerate(shapes)]
        raw = [(t, c) for t, c, _ in p._rec.recognize_chunk(up, plans)]
        if thresh:
            raw = [(t, c) if c >= thresh else ("", c) for t, c in raw]
        ref = P.TextRecognitionPredictor(cfg, fitted,
                                         runtime=cpu).predict(lines)
        same = sum(a[0] == b[0] for a, b in zip(out, ref))
        print(f"  texts {[t for t, _ in out[:4]]}, card vs cpu "
              f"{same} of {len(lines)} equal")
        check("text_recognition", out == raw and same == len(lines)
              and np.allclose([c for _, c in out], [c for _, c in ref],
                              atol=1e-4))

    # the classifiers: probabilities card vs cpu, classes by the wrapper
    for name, cls, state, images in (
            ("document_orientation", P.DocumentOrientationPredictor,
             cw["doc"], pages[:4]),
            ("textline_orientation", P.TextLineOrientationPredictor,
             cw["line"], lines[:8]),
            ("table_classification", P.TableClassificationPredictor,
             table_states.get("cls"), pages[:4])):
        p = cls(T.ClassificationConfig(), state, runtime=gpu)
        out, want = run(name, p, images,
                        lambda up, shapes: p._cls.classify_pages(up, shapes))
        check(name, out == want)
        pc = cls(T.ClassificationConfig(), state, runtime=cpu)
        gate_probs(name, p._cls.probs_pages(*p._upload(images)),
                   pc._cls.probs_pages(*pc._upload(images)), 1e-4)

    p = P.DocumentRectificationPredictor(None, cw["uvdoc"], runtime=gpu)
    out, _ = run("document_rectification", p, pages[:2], None)
    check("document_rectification", all(
        np.array_equal(o, p._rect.rectify(im))
        for o, im in zip(out, pages[:2])))

    for name, p, images in (
            ("layout_detection", P.LayoutDetectionPredictor(
                T.LayoutDetectionConfig(), layout_state, runtime=gpu),
             pages[:4]),
            ("table_cell_detection", P.TableCellDetectionPredictor(
                None, table_states.get("cell"), runtime=gpu), pages[:2])):
        out, want = run(name, p, images,
                        lambda up, shapes: p._det.detect(up, shapes))
        print(f"  {name}: {[len(b) for b in out]} boxes")
        check(name, [[(b.label, b.score, b.box.tolist()) for b in o]
                     for o in out] ==
              [[(b.label, b.score, b.box.tolist()) for b in w]
               for w in want])

    p = P.TableStructureRecognitionPredictor(
        T.TableStructureConfig(), table_states.get("slanet"), runtime=gpu)
    out, want = run("table_structure_recognition", p, pages[:2],
                    lambda up, shapes: p._model.recognize(
                        up, [(i, (0, 0, s[1], s[0]))
                             for i, s in enumerate(shapes)]))
    print(f"  tokens per image {[len(o.tokens) for o in out]}")
    check("table_structure_recognition", all(
        o.tokens == w.tokens and np.array_equal(o.cell_boxes, w.cell_boxes)
        for o, w in zip(out, want)))

    crops = formula_crops(4)
    p = P.FormulaRecognitionPredictor(runtime=gpu)
    out, _ = run("formula_recognition (max_len 256)", p, crops, None)
    rec = p._model
    with torch.no_grad():
        mk, mv = rec.model.prefill(rec.model.encode(
            rec.inputs(crops).permute(0, 3, 1, 2)))
        ids_g, probs_g = (t.clone() for t in rec.graphs.decode(mk, mv))
        ids_e, probs_e = decode_eager(rec.model.decoder, mk, mv)
    torch.cuda.synchronize()
    print(f"  steps {rec.graphs.last['steps']}, ids {tuple(ids_g.shape)}, "
          f"graph = eager ids {bool(torch.equal(ids_g, ids_e))}, probs "
          f"{bool(torch.equal(probs_g, probs_e))}; e.g. "
          f"{out[0].latex[:40]!r}")
    check("formula_recognition", rec.graphs.last["steps"] == 256
          and ids_g.shape[1] == 256 and torch.equal(ids_g, ids_e)
          and torch.equal(probs_g, probs_e)
          and [o.latex for o in out] == [o.latex
                                         for o in rec.recognize(crops)])

    p = P.FormulaRecognitionPredictor(
        T.FormulaRecognitionConfig(model_type="unimernet"), runtime=gpu)
    out, _ = run("formula_recognition (unimernet)", p, crops[:1], None)
    check("formula_recognition (unimernet)",
          out == p._model.recognize(crops[:1]))
    print(f"predictors: 11 of 11 held in {time.perf_counter() - t_all!r} s")


# ---------------------------- the CLI (phase 34) ----------------------------

def cli_phase(card: str) -> None:
    """Phase 34: ``python -m oar_ocr_tpu_torch.cli``'s ``ocr`` and
    ``recognize`` run in-process through ``main([...])`` (default
    device: the card) on two PNGs each written to a temporary directory
    (pages 0-1; two drawn lines), their JSON lines held equal to the
    API's results on the decoded images (the CLI's seeded models, built
    again through the builder / predictor)."""
    import contextlib
    import io
    import tempfile

    import cv2

    from oar_ocr_tpu_torch import cli
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
    from oar_ocr_tpu_torch.predictors.predictors import \
        TextRecognitionPredictor
    from oar_ocr_tpu_torch.runtime.runtime import Runtime
    from oar_ocr_tpu_torch.utils.image import load_image

    page, boxes, _ = text_page()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"ocr": [], "recognize": []}
        for i, img in enumerate(make_pages(0)[:2]):
            paths["ocr"].append(f"{tmp}/page{i}.png")
            cv2.imwrite(paths["ocr"][-1], img[:, :, ::-1])
        for i, (x0, y0, x1, y1) in enumerate(boxes[:2]):
            paths["recognize"].append(f"{tmp}/line{i}.png")
            cv2.imwrite(paths["recognize"][-1], page[y0:y1, x0:x1, ::-1])
        for cmd, api in (
                ("ocr", lambda ims: [r.to_dict() for r in OAROCRBuilder(
                    "general").with_runtime(Runtime()).build().predict(ims)]),
                ("recognize", lambda ims: [
                    {"text": t, "confidence": c}
                    for t, c in TextRecognitionPredictor(
                        runtime=Runtime()).predict(ims)])):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                cli.main([cmd, *paths[cmd]])
            ms = (time.perf_counter() - t0) * 1e3
            got = [json.loads(line) for line in
                   out.getvalue().strip().splitlines()]
            want = api([load_image(p) for p in paths[cmd]])
            for g, w, p in zip(got, want, paths[cmd]):
                w["source_path"] = p
            want = [json.loads(json.dumps(w, ensure_ascii=False))
                    for w in want]
            print(f"cli {cmd}: {len(got)} JSON lines in {ms!r} ms, equal "
                  f"to the API's {got == want}; e.g. "
                  f"{json.dumps(got[0])[:100]}  [{card}]")
            if got != want:
                raise AssertionError(f"cli {cmd}: its JSON differs from "
                                     f"the API's results")


# -------- upstream weights, PDF input, visualization (phase 35) --------

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b7, v = v & 0x7F, v >> 7
        if not v:
            return out + bytes([b7])
        out += bytes([b7 | 0x80])


def _pb_field(number: int, wire: int, payload: bytes) -> bytes:
    key = _varint((number << 3) | wire)
    return key + (_varint(len(payload)) + payload if wire == 2 else payload)


def onnx_bytes(tensors: dict) -> bytes:
    """A minimal ONNX model whose graph holds ``tensors`` (name → float32
    array) as raw-data initializers: ModelProto.ir_version (1) and .graph
    (7) → GraphProto.initializer (5) → TensorProto dims (1), data_type
    (2, FLOAT = 1), name (8), raw_data (9); the protobuf wire format the
    port's ``runtime/onnx_extract.py`` reads."""
    graph = _pb_field(1, 2, _pb_field(4, 2, b"Conv"))      # a node to skip
    for name, arr in tensors.items():
        a = np.ascontiguousarray(arr, "<f4")
        msg = b"".join(_pb_field(1, 0, _varint(d)) for d in a.shape)
        msg += _pb_field(2, 0, _varint(1)) + _pb_field(8, 2, name.encode())
        graph += _pb_field(5, 2, msg + _pb_field(9, 2, a.tobytes()))
    return _pb_field(1, 0, _varint(8)) + _pb_field(7, 2, graph)


def pdf_bytes(media_wh, content: bytes, resources: bytes = b"<< >>",
              extra: dict = None) -> bytes:
    """A one-page classic-layout PDF: catalog 1, pages 2, page 3, content
    stream 4, and ``extra`` objects (number → (dict, stream or None))."""
    objs = {1: (b"<< /Type /Catalog /Pages 2 0 R >>", None),
            2: (b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>", None),
            3: (b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 %d %d] "
                b"/Resources %s /Contents 4 0 R >>"
                % (media_wh[0], media_wh[1], resources), None),
            4: (b"<< /Length %d >>" % len(content), content)}
    objs.update(extra or {})
    buf = bytearray(b"%PDF-1.4\n")
    for num in sorted(objs):
        head, stream = objs[num]
        buf += b"%d 0 obj\n" % num + head
        if stream is not None:
            buf += b"\nstream\n" + stream + b"\nendstream"
        buf += b"\nendobj\n"
    buf += b"trailer << /Size %d /Root 1 0 R >>\n%%%%EOF\n" % (len(objs) + 1)
    return bytes(buf)


def scanned_pdf(page: np.ndarray) -> bytes:
    """``page`` (uint8 RGB) as a one-page scanned PDF: one DeviceRGB
    image XObject, 8 bits, FlateDecode (lossless), drawn over the whole
    MediaBox of the page's pixel size."""
    import zlib

    h, w = page.shape[:2]
    data = zlib.compress(np.ascontiguousarray(page).tobytes())
    image = (b"<< /Type /XObject /Subtype /Image /Width %d /Height %d "
             b"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter "
             b"/FlateDecode /Length %d >>" % (w, h, len(data)))
    return pdf_bytes((w, h), b"q %d 0 0 %d 0 0 cm /Im0 Do Q" % (w, h),
                     b"<< /XObject << /Im0 5 0 R >> >>", {5: (image, data)})


def vector_pdf() -> bytes:
    """A digital-born 960×1280 pt page: eight dark blocks like the bench
    pages' (which the bench detector finds) and three Helvetica lines."""
    ops = [b"0.1 0.1 0.1 rg"]
    for r in range(8):
        w, h = REGION_DIMS[r % len(REGION_DIMS)]
        ops.append(b"60 %d %d %d re f" % (1280 - 60 - r * 120 - h, w, h))
    for r, text in enumerate((b"Upstream weights", b"PDF input",
                              b"Registry OCR")):
        ops.append(b"BT /F1 28 Tf 500 %d Td (%s) Tj ET"
                   % (1100 - r * 300, text))
    font = (b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>", None)
    return pdf_bytes((960, 1280), b"\n".join(ops),
                     b"<< /Font << /F1 5 0 R >> >>", {5: font})


def same_results(what: str, got, want) -> None:
    """Identical OCR results: region counts, boxes, texts, confidences."""
    for i, (g, w) in enumerate(zip(got, want)):
        same = len(g.regions) == len(w.regions) and all(
            np.array_equal(np.asarray(a.box), np.asarray(b.box))
            and a.text == b.text and a.confidence == b.confidence
            for a, b in zip(g.regions, w.regions))
        if not same:
            raise AssertionError(f"{what}: page {i} differs")
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results, {len(want)}")


def registry_pdf_phase(card: str, det_state, fitted, layout_state,
                       kernels, device: str = "cuda") -> tuple:
    """Phase 35: upstream weights through the registry, PDF input and the
    visualization helpers, on the card. Returns K1's launches on the
    registry-built pipeline's predicts, and K1's inputs on the PDF
    pages' predicts (one page a call: det and rec, :class:`K1Inputs`).

    1. phase 6's two models as official-name tensors in two ONNX files
       (the trained bench detector, ``DBNet()``, which is
       ``pp-ocrv5_mobile_det``'s shape, and the fitted recognizer,
       whose dictionary is the port's ``default_charset()``, written to a
       file for the converter) → ``tools/port_fetch_and_verify.py
       --upstream-file`` under a temporary ``$OAR_TPU_HOME``: the
       detector lands in the cache under its name, the recognizer in a
       directory of its own (no registry entry has its dictionary) →
       ``OAROCRBuilder().with_det_source("pp-ocrv5_mobile_det")
       .with_rec_source(<artifact path>)`` on the card: both state_dicts
       bit-equal to phase 6's, and on the 16 bench pages and the drawn
       text page the same boxes, texts and confidences as phase 6's
       pipeline built from the state_dicts;
    2. the drawn text page (``assets/text_page_23.png``) as a one-page
       scanned PDF (FlateDecode RGB) → ``utils/pdf.render_pdf``: the
       page's pixels exactly; its 20 lines read on the card as on the
       PNG, and ``predict`` equal; a vector page the script writes
       (blocks and Helvetica text) rendered at 72 dpi and read;
    3. ``draw_ocr_canvas`` (the registry-built pipeline's result) and
       ``draw_structure`` (an ``OARStructure`` predict) on bench page 0
       write non-empty, annotated PNGs.
    """
    import contextlib
    import io
    import os
    import tempfile

    import cv2
    import torch

    from oar_ocr_tpu_torch.models.detection.db import DBNet
    from oar_ocr_tpu_torch.models.recognition.recognizer import CropPlan
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
    from oar_ocr_tpu_torch.ops.ctc import default_charset
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
    from oar_ocr_tpu_torch.registry import models as registry
    from oar_ocr_tpu_torch.runtime.ppocr_maps import export_ppocr_format
    from oar_ocr_tpu_torch.utils import visualization as vis
    from oar_ocr_tpu_torch.utils.pdf import render_pdf
    sys.path.insert(0, str(REPO / "tools"))
    import port_fetch_and_verify

    gpu = Runtime1("float32", device=device)
    pages = make_pages(0)
    text_png = np.ascontiguousarray(cv2.imread(
        str(REPO / "assets" / "text_page_23.png"))[:, :, ::-1])
    meta = json.loads((REPO / "assets" / "text_page_23.json").read_text())
    plans = [CropPlan.from_quad(0, np.array(
        [[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32))
        for x0, y0, x1, y1 in meta["boxes"]]
    ref = build_pipeline(gpu, det_state, fitted)
    home = tempfile.mkdtemp(prefix="oar_home_")
    saved_home = registry.OAR_TPU_HOME
    registry.OAR_TPU_HOME = home
    try:
        # --- 35.1 weights through the registry ---
        with torch.device("meta"):
            models = {"det": DBNet(),
                      "rec": SVTRRecognizer(2 + len(default_charset()))}
        charset = os.path.join(home, "default_charset.txt")
        with open(charset, "w", encoding="utf-8") as f:
            f.write("\n".join(default_charset()) + "\n")
        artifacts, verdicts = {}, {}
        for kind, state, name, args in (
                ("det", det_state, "pp-ocrv5_mobile_det", []),
                ("rec", fitted, "pp-ocrv5_mobile_rec",
                 ["--charset-file", charset, "--out-dir",
                  os.path.join(home, "fitted_rec")])):
            onnx = os.path.join(home, f"upstream_{kind}.onnx")
            with open(onnx, "wb") as f:
                f.write(onnx_bytes(export_ppocr_format(models[kind], state)))
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = port_fetch_and_verify.main(
                    ["--model", name, "--upstream-file", onnx,
                     "--device", device, *args])
            verdict = json.loads(out.getvalue().strip().splitlines()[-1])
            if rc != 0 or verdict["verdict"] != "OK":
                raise AssertionError(f"port_fetch_and_verify {name}: {rc} "
                                     f"{verdict}")
            verdicts[kind] = verdict
            artifacts[kind] = verdict["converted"]
            print(f"port_fetch_and_verify {name} ({kind}, "
                  f"{os.path.getsize(onnx)} B ONNX): extract "
                  f"{verdict['ms']['extract']!r} ms, convert "
                  f"{verdict['ms']['convert']!r} ms (host), predict "
                  f"{verdict['ms']['predict']!r} ms, "
                  f"{verdict['predict']['regions']} regions  [{card}]")
        if artifacts["det"] != os.path.join(
                home, "models", "pp-ocrv5_mobile_det.safetensors"):
            raise AssertionError(f"det artifact at {artifacts['det']}")
        t0 = time.perf_counter()
        pipe = (OAROCRBuilder("general").with_runtime(gpu)
                .with_det_source("pp-ocrv5_mobile_det")
                .with_rec_source(artifacts["rec"])
                .with_batch_sizes(image=8, region=64).build())
        build_ms = (time.perf_counter() - t0) * 1e3
        for what, got, want in (
                ("det", pipe.detector.model.state_dict(), det_state),
                ("rec", pipe.recognizer.model.state_dict(), fitted)):
            if set(got) != set(want) or not all(torch.equal(
                    got[k].cpu(), want[k].float()) for k in want):
                raise AssertionError(f"registry-built {what} weights are "
                                     f"not phase 6's bit for bit")
        for k in kernels:
            k.launches = 0
        reg = pipe.predict(pages)
        reg_text = pipe.predict([text_png])
        launches = K1.launches
        same_results("registry-built OCR on the bench pages", reg,
                     ref.predict(pages))
        same_results("registry-built OCR on the text page", reg_text,
                     ref.predict([text_png]))
        print(f"registry-built OCR (pp-ocrv5_mobile_det by name, the fitted "
              f"recognizer by path; build {build_ms!r} ms): state_dicts "
              f"bit-equal to phase 6's; {len(pages)} bench pages "
              f"{sum(len(r.regions) for r in reg)} regions and the text page "
              f"{len(reg_text[0].regions)}, boxes, texts and confidences "
              f"identical to phase 6's pipeline; K1 launches {launches}  "
              f"[{card}]")

        # --- 35.2 PDF input ---
        scanned = os.path.join(home, "text_page_23.pdf")
        with open(scanned, "wb") as f:
            f.write(scanned_pdf(text_png))
        t0 = time.perf_counter()
        rendered = render_pdf(scanned)
        render_ms = (time.perf_counter() - t0) * 1e3
        if len(rendered) != 1 or not np.array_equal(rendered[0], text_png):
            raise AssertionError("the scanned PDF's page is not the PNG's "
                                 "pixels")
        up = {k: gpu.put_pages([img], img.shape[:2]) for k, img in
              (("pdf", rendered[0]), ("png", text_png))}
        read = {k: [t for t, _c, _k in ref.recognizer.recognize_chunk(u,
                                                                      plans)]
                for k, u in up.items()}
        right = sum(a == b for a, b in zip(read["pdf"], meta["texts"]))
        if read["pdf"] != read["png"] or len(read["pdf"]) != 20:
            raise AssertionError("the PDF page's 20 lines read otherwise "
                                 "than the PNG's")
        with K1Inputs(("det", "rec")) as k1_seen:
            from_pdf = ref.predict(rendered)
        same_results("OCR of the PDF page", from_pdf,
                     ref.predict([text_png]))
        print(f"scanned PDF ({os.path.getsize(scanned)} B, FlateDecode RGB): "
              f"render_pdf {render_ms!r} ms, pixels equal to the PNG; its "
              f"20 lines read as the PNG's ({right} of 20 as drawn), "
              f"predict equal  [{card}]")
        vector = os.path.join(home, "vector.pdf")
        with open(vector, "wb") as f:
            f.write(vector_pdf())
        t0 = time.perf_counter()
        vpage = render_pdf(vector, dpi=72)
        vector_ms = (time.perf_counter() - t0) * 1e3
        with K1Inputs(("det", "rec")) as vec_seen:
            vres = ref.predict(vpage)
        k1_seen.seen.update(vec_seen.seen)
        n_regions = len(vres[0].regions)
        print(f"vector PDF page {vpage[0].shape}: render_pdf {vector_ms!r} "
              f"ms, {n_regions} regions, texts "
              f"{[r.text for r in vres[0].regions][:4]}  [{card}]")
        if vpage[0].shape != (1280, 960, 3) or n_regions < 8:
            raise AssertionError(f"vector PDF: {vpage[0].shape}, "
                                 f"{n_regions} regions (want >= 8 blocks)")

        # --- 35.3 visualization ---
        structure = structure_pipeline(gpu, det_state, fitted, layout_state,
                                       seals=False).predict(pages[:1])
        images = {
            "ocr_canvas.png": vis.draw_ocr_canvas(
                pages[0], [r.box for r in reg[0].regions],
                [r.text for r in reg[0].regions],
                [r.confidence for r in reg[0].regions]),
            "structure.png": vis.draw_structure(pages[0], structure[0])}
        for name, img in images.items():
            path = os.path.join(home, name)
            vis.save_image(path, img)
            size = os.path.getsize(path)
            changed = img.shape != pages[0].shape or not np.array_equal(
                img, pages[0])
            print(f"  {name}: {img.shape}, {size} B, annotated {changed}")
            if size == 0 or not changed:
                raise AssertionError(f"{name}: nothing drawn")
        print(f"draw_structure: {len(structure[0].elements)} elements  "
              f"[{card}]")
    finally:
        registry.OAR_TPU_HOME = saved_home
        import shutil

        shutil.rmtree(home, ignore_errors=True)
    return launches, k1_seen.seen


# ---------------- speculative decoding and the VL families ----------------

SPEC_NEW = 64          # HunyuanOCRSpeculative's new tokens (phase 36)
FAM_CROP = 224         # the families' card-vs-CPU crop side
FAM_NEW = 8            # their new tokens, card against CPU
FAM_DEPTH = 2          # decoder and tower depth of the four other families
FAM_CPU_DEPTH = 4      # the full-depth three's depth, card against CPU
FAM_SPEC_NEW = 32      # new tokens of the families' round reports
# published widths whose head_dim-128 rope sections cover 32 of 64
# frequency pairs fail in both packages (vl/decoder.check_rope_sections);
# they run with sections that cover head_dim / 2: Qwen2-VL's MRoPE
# sections, and the default XDRoPE sections doubled
WIDE_SECTIONS = {"hunyuanocr": ("xdrope_sections", (48, 8, 8)),
                 "glmocr": ("mrope_sections", (16, 24, 24)),
                 "mineru": ("mrope_sections", (16, 24, 24)),
                 "mineru_diffusion": ("mrope_sections", (16, 24, 24))}


def family_cfg(name: str, depth=None):
    """A family's published config, its rope sections widened where they
    must be, its decoder and tower cut to ``depth`` layers when given
    (and a DFlash draft's taps with them)."""
    from oar_ocr_tpu_torch.vl.families import FAMILY_CONFIGS

    cfg = FAMILY_CONFIGS[name]
    dec, vis = cfg.decoder, cfg.vision
    if name in WIDE_SECTIONS:
        key, sections = WIDE_SECTIONS[name]
        dec = dataclasses.replace(dec, **{key: sections})
    if depth is not None:
        dec = dataclasses.replace(dec, layers=depth)
        vis = dataclasses.replace(vis, layers=depth)
        if cfg.dflash is not None:
            # a DFlash draft's taps past the cut move to the first layers
            taps = cfg.dflash.target_layer_ids
            cfg = dataclasses.replace(cfg, dflash=dataclasses.replace(
                cfg.dflash, target_layer_ids=tuple(range(
                    min(depth, len(taps))))))
    return dataclasses.replace(cfg, decoder=dec, vision=vis)


def family_tokens() -> int:
    """The family towers' patches on the 1280×960 page (GLM-OCR's tiling,
    which phase 36's D = 64 K2 cases take)."""
    from oar_ocr_tpu_torch.vl.families import GLMOCR

    shape_only = GLMOCR.__new__(GLMOCR)
    shape_only.cfg = family_cfg("glmocr")
    return shape_only._prepare_image(make_pages(0)[0])[0].shape[0]


def family_k2_cases():
    """Phase 36's K2 cases at D = 64 on the page (for tools/kernel_ab.py)."""
    return k2_d64_cases(family_tokens())


def k2_d64_cases(t: int):
    """Phase 36, K2 at D = 64 (the family towers' head size) on a family
    tower's token count ``t``: (1, 16, t, 64) and, through the towers'
    chunked qkv view, (2, 16, t, 64) whose valid_len differ."""
    import torch

    from oar_ocr_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(36)
    cases = []
    for b, vlen, tower in ((1, [t], False), (2, [t, t // 3 + 5], True)):
        for dtype in (torch.float32, torch.bfloat16):
            if tower:    # q, k, v chunks of one (B, T, 3·16·64) projection
                qkv = torch.randn((b, t, 3 * 16 * 64), generator=gen,
                                  device="cuda").to(dtype)
                q, k, v = (x.view(b, t, 16, 64).transpose(1, 2)
                           for x in qkv.chunk(3, dim=-1))
            else:
                q, k, v = (torch.randn((b, 16, t, 64), generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(3))
            vl = torch.tensor(vlen, dtype=torch.int32, device="cuda")
            tag = "f32" if dtype == torch.float32 else "bf16"

            def kernel(q=q, k=k, v=v, vl=vl):
                return flash_attention(q, k, v, valid_len=vl)

            def plain(q=q, k=k, v=v, vl=vl):
                return flash_attention_ref(q, k, v, valid_len=vl)

            def reference(q=q, k=k, v=v, vl=vl):
                return flash_attention_ref(q.float(), k.float(), v.float(),
                                           valid_len=vl)

            work = k2_work(q, vlen, False)
            work["library"] = sdpa_library(q, k, v, vl, False)
            cases.append((f"K2 {(b, 16, t, 64)} valid_len {vlen} {tag}"
                          f"{' family tower view' if tower else ''}",
                          kernel, plain, reference, gate_k2, work))
    return cases


def spec_k3_k4_cases():
    """Phase 36, K3 at the verify blocks and the family decoders' widths
    (float32, as those decoders run), and K4 at HunyuanOCR's verify
    block: 8 tokens, k into the KV cache at an int slot, and at the 0-d
    device slot a round's captured verify gives it (q and the whole
    cache ≤ 1e-6·max, ``gate_k4_rows``)."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import (add_rmsnorm_ref,
                                                       fused_add_rmsnorm,
                                                       fused_qk_norm_rope_qk,
                                                       qk_norm_rope_qk_ref)

    gen = torch.Generator(device="cuda").manual_seed(37)
    k3 = []
    for rows, width, eps, what in (
            (8, 1024, 1e-5, "HunyuanOCR verify block"),
            (5, 1536, 1e-6, "GLM-OCR MTP verify block"),
            (8, 2048, 1e-6, "HunyuanOCR family verify block"),
            (1, 1536, 1e-6, "GLM-OCR decode step"),
            (1, 1024, 1e-6, "OvisOCR2 decode step"),
            (1, 896, 1e-6, "MonkeyOCRv2 decode step")):
        x, r = (torch.randn((rows, width), generator=gen, device="cuda")
                for _ in range(2))
        scale = torch.rand((width,), generator=gen, device="cuda") + 0.5

        def kernel(x=x, r=r, scale=scale, eps=eps):
            return fused_add_rmsnorm(x, r, scale, eps=eps)

        def plain(x=x, r=r, scale=scale, eps=eps):
            return add_rmsnorm_ref(x, r, scale, eps=eps)

        work = bound(4 * (4 * x.numel() + width), 5.0 * x.numel(),
                     torch.float32)
        k3.append((f"K3 ({rows}, {width}) f32 {what}", kernel, plain, plain,
                   gate_k3, work))
    b, t, slot = 1, 8, 1300
    ang = torch.rand((b, t, 64), generator=gen, device="cuda") * 2048.0
    cos, sin = ang.cos(), ang.sin()
    q, k = (torch.randn((b, t, h, 128), generator=gen, device="cuda")
            for h in (16, 4))
    qs, ks = (torch.rand((128,), generator=gen, device="cuda") + 0.5
              for _ in range(2))
    caches = [torch.zeros((b, 4, 2048, 128), device="cuda")
              for _ in range(2)]

    def kernel(cache=caches[0]):
        out = cache[:, :, slot:slot + t]
        return (fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin, k_out=out,
                                      eps=1e-5), cache)

    def plain(cache=caches[1]):
        out = cache[:, :, slot:slot + t]
        return (qk_norm_rope_qk_ref(q, k, qs, ks, cos, sin, k_out=out,
                                    eps=1e-5), cache)

    n = q.numel() + k.numel()
    work = bound(2 * n * 4 + 2 * b * t * 64 * 4 + 2 * 128 * 4, 6.0 * n,
                 torch.float32)
    k4 = [(f"K4 q+k B=1 T=8 int slot {slot} into (B, 4, 2048, 128) "
           f"(16+4 heads, 128) f32 verify block", kernel, plain, plain,
           gate_k4, work)]
    # the verify block inside a round's graph: k written from a 0-d
    # device slot into the layer's whole cache
    dev_slot = torch.tensor(slot, device="cuda")
    slot_caches = [torch.zeros((b, 4, 2048, 128), device="cuda")
                   for _ in range(2)]

    def slot_kernel(cache=slot_caches[0]):
        return (fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin, k_out=cache,
                                      slot=dev_slot, eps=1e-5), cache)

    def slot_plain(cache=slot_caches[1]):
        return (qk_norm_rope_qk_ref(q, k, qs, ks, cos, sin, k_out=cache,
                                    slot=dev_slot, eps=1e-5), cache)

    k4.append((f"K4 q+k B=1 T=8 device slot {slot} into (B, 4, 2048, 128) "
               f"(16+4 heads, 128) f32 verify block in a round's graph",
               slot_kernel, slot_plain, slot_plain, gate_k4_rows,
               bound(2 * n * 4 + 2 * b * t * 64 * 4 + 2 * 128 * 4 + 8,
                     6.0 * n, torch.float32)))
    return k3, k4


def greedy_ref(ids, logits_steps):
    """(ids (1, T) numpy, logits (1, T, V) CPU float32) of a greedy run
    whose step logits[i] chose ids[i]."""
    import torch

    return (np.asarray(ids).reshape(1, -1),
            torch.stack([s.float().cpu()[0] for s in logits_steps])[None])


def spec_request(model, image):
    """One HunyuanOCR prompt through the generate path's stages: (fused
    embeddings, XDRoPE positions (4, 1, L)) on the model's device."""
    patches, gh, gw = model.prepare_image(image)
    img = model.encode_image(patches, model.position_rows(gh, gw), gh, gw)
    ids, pids, _ = model.build_prompt(gh, gw, "OCR:")
    return (model.fuse_embeds(ids, img),
            model.runtime.put(pids)[:, None, :])


def spec_greedy(spec, embeds, pos, max_new):
    """The plain greedy decode of the same target (its decode graph):
    ids and the logits that chose each."""
    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    steps = []
    out, logits = spec.prefill_decode(
        embeds, pos, max_new=max_new, step_logits=steps,
        capacity=decoder_cache_capacity(embeds.shape[1], max_new))
    return greedy_ref(out.cpu()[0].tolist(), [logits] + steps[:-1])


def round_report(what: str, start, eos: int, max_new: int, card: str,
                 per_round=None) -> dict:
    """A speculative path's rounds through their CUDA graphs against the
    same halves run eagerly on the card, each request from a fresh
    prefill into the round key's static buffers (``start()`` → (round
    runner, state, page-bucket function)): the ids, the accept counts
    and every round's float32 verify logits equal bit for bit (compared
    as bits); ms per token through the graphs and eagerly ((request −
    prefill) / ids, medians of 3); each captured graph's capture ms and
    launches a replay (the verify graph's must equal ``per_round``,
    kernel → launches, where given), and the MiB of the pool the key's
    graphs share."""
    import torch

    def request(graph, rounds=None, logits=None):
        runner, st, bucket = start()
        ids = runner.decode(st, int(st.tok[0]), max_new, eos, bucket=bucket,
                            graph=graph, rounds=rounds, logits=logits)
        torch.cuda.synchronize()
        return ids, st

    runs = {}
    for graph in (True, False):
        acc, logits = [], []
        ids, st = request(graph, acc, logits)
        runs[graph] = (ids, acc, torch.stack([g.float().cpu()
                                              for g in logits]))
    (g_ids, g_acc, g_l), (e_ids, e_acc, e_l) = runs[True], runs[False]
    same = (g_ids == e_ids and g_acc == e_acc and g_l.shape == e_l.shape
            and torch.equal(g_l.view(torch.int32), e_l.view(torch.int32)))
    print(f"  {what}: round graphs vs eager rounds, {len(g_acc)} rounds, "
          f"{len(g_ids)} ids, the accept counts and every round's verify "
          f"logits bit-equal: {same} (logits finite: "
          f"{bool(torch.isfinite(e_l).all())})")
    if not same:
        raise AssertionError(f"{what}: the round graphs disagree with the "
                             f"eager rounds (ids {g_ids} vs {e_ids}, "
                             f"accepted {g_acc} vs {e_acc})")
    prefill = host_ms(start)
    ms = {mode: (host_ms(lambda: request(graph)) - prefill) / len(g_ids)
          for mode, graph in (("graph", True), ("eager", False))}
    graphs = ([(f"draft {key}", g) for key, g in st.draft_graphs.items()]
              + [("verify", st.verify_graphs[None])])
    captures = {name: {"capture_ms": g.capture_ms,
                       "launches": {k.name: n for k, n in
                                    g.launches.counts.items()}}
                for name, g in graphs}
    out = {"rounds": len(g_acc), "ids": len(g_ids),
           "mean_accepted": float(np.mean(g_acc)), "prefill_ms": prefill,
           "graph_ms_per_token": ms["graph"],
           "eager_ms_per_token": ms["eager"], "graphs": captures,
           "pool_mib": pool_bytes(st.pool) / 2 ** 20}
    print(f"  {what} times: {json.dumps(out)}  [{card}]")
    if per_round is not None:
        want = {k.name: n for k, n in per_round.items()}
        if captures["verify"]["launches"] != want:
            raise AssertionError(f"{what}: the verify graph launches "
                                 f"{captures['verify']['launches']} a "
                                 f"replay, the design {want}")
    return out


def replayed_forced_accept(what: str, runner, st, g_ids, g_logits) -> None:
    """The greedy's next k ids (``greedy_ref``'s pair) written into the
    state's static drafts and its captured verify half replayed alone:
    all k accepted, the k + 1 emitted ids the greedy's (the last by
    ``ids_gate``: the verify's block of rows may round a near-tie the
    other way), the target cache at wpos + k + 1. The state was just
    prefilled, and its key's verify graph captured."""
    import torch

    k, w = st.k, st.at
    verify = st.verify_graphs.get(None)
    if verify is None:
        raise AssertionError(f"{what}: no verify graph to replay")
    with torch.inference_mode():
        st.drafts.copy_(torch.tensor(g_ids[:, 1:1 + k], dtype=torch.int32,
                                     device=st.drafts.device))
    emitted, n_acc = runner.run(st, draft=False)
    print(f"{what} forced accept through the replayed verify half: "
          f"accepted {n_acc} of {k}, emitted {emitted.tolist()}, greedy "
          f"{g_ids[0, 1:2 + k].tolist()}, target cache "
          f"{st.cache.length.tolist()} (wpos {w})")
    if (n_acc != k or st.cache.length.tolist() != [w + k + 1]
            or st.verify_graphs[None] is not verify):
        raise AssertionError(f"{what}: the forced accept through the "
                             f"replayed verify half failed")
    ids_gate(f"{what} forced accept", emitted[None], g_ids[:, 1:2 + k],
             g_logits[:, 1:2 + k])


def spec_phase(card: str, spec, page, crop) -> dict:
    """Phase 36 (2-3): HunyuanOCRSpeculative at published width, float32,
    its rounds through their CUDA graphs: the speculative ids against the
    same target's greedy ids, a forced accept through the replayed verify
    half, the round graphs against the eager rounds bit for bit, times
    and launches per round; then the card against the CPU on a small
    crop."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL_QK as K4
    from oar_ocr_tpu_torch.vl.hunyuan import HunyuanOCRSpeculative

    dcfg = spec.dcfg
    k = dcfg.block_size - 1
    embeds, pos = spec_request(spec, crop)
    t = embeds.shape[1]
    g_ids, g_logits = spec_greedy(spec, embeds, pos, SPEC_NEW)
    # gate (a): the speculative ids follow the greedy's
    before = (K3.launches, K4.launches)
    rounds = []
    ids = spec.decode_speculative(embeds, pos, max_new=SPEC_NEW,
                                  rounds=rounds)
    k3_n, k4_n = K3.launches - before[0], K4.launches - before[1]
    ids = ids + [spec.cfg.eos_id] * (SPEC_NEW - len(ids))
    note = ids_gate("HunyuanOCRSpeculative vs its greedy (f32, 448x448, "
                    f"{SPEC_NEW} tokens)", np.asarray([ids]), g_ids, g_logits)
    # the prefill runs K3 48 and K4 24 times; every round one target pass
    per_round = ((k3_n - 2 * 24) / len(rounds), (k4_n - 24) / len(rounds))
    print(f"HunyuanOCRSpeculative vs greedy: {note}; {len(rounds)} rounds, "
          f"accepted per round {rounds}, mean "
          f"{float(np.mean(rounds))!r}; K3, K4 launches per round "
          f"(through the replays) {per_round}")
    if per_round != (48.0, 24.0):
        raise AssertionError(f"K3, K4 per round {per_round}, the design "
                             "makes one target pass: (48, 24)")

    def start():
        _, cache, _ = spec.start(embeds, pos, max_new=SPEC_NEW)
        return (spec.spec_rounds, spec.spec_rounds.states[
            (1, cache.capacity, torch.float32)], spec.bucket)

    # gate (b): the greedy's next k ids in the static drafts, the verify
    # graph replayed alone: all accepted; the next round (both graphs)
    # follows the greedy
    runner, st, bucket = start()
    replayed_forced_accept("HunyuanOCRSpeculative", runner, st, g_ids,
                           g_logits)
    if st.ctx.length.tolist() != [t + k + 1]:
        raise AssertionError("forced accept: the draft context is not at "
                             "prompt + block")
    nxt, n_acc = runner.run(st, bucket(st))
    print("forced accept, next round: " + ids_gate(
        "the round after the forced accept", nxt[None, :n_acc + 1],
        g_ids[:, 2 + k:3 + k + n_acc], g_logits[:, 2 + k:3 + k + n_acc]))
    # (c): graph rounds = eager rounds; times against the greedy graph
    rep = round_report(f"HunyuanOCRSpeculative (f32, 448x448, {SPEC_NEW} "
                       f"tokens)", start, spec.cfg.eos_id, SPEC_NEW, card,
                       per_round={K3: 48, K4: 24})
    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    cap = decoder_cache_capacity(t, SPEC_NEW)
    g16 = host_ms(lambda: spec.prefill_decode(embeds, pos, max_new=16,
                                              capacity=cap)[0].cpu())
    g64 = host_ms(lambda: spec.prefill_decode(embeds, pos, max_new=SPEC_NEW,
                                              capacity=cap)[0].cpu())
    times = {"rounds": len(rounds), "mean_accepted": float(np.mean(rounds)),
             "speculative_ms_per_token": rep["graph_ms_per_token"],
             "speculative_eager_ms_per_token": rep["eager_ms_per_token"],
             "greedy_graph_ms_per_token": (g64 - g16) / (SPEC_NEW - 16),
             "start_ms": rep["prefill_ms"], "graphs": rep["graphs"],
             "pool_mib": rep["pool_mib"],
             "k3_per_round": per_round[0], "k4_per_round": per_round[1]}
    print(f"HunyuanOCRSpeculative times (prompt {t}, {SPEC_NEW} tokens): "
          f"{json.dumps(times)}  [{card}]")

    # 3. the card against the CPU on a small crop
    small = np.ascontiguousarray(page[:FAM_CROP, :FAM_CROP])
    cpu = HunyuanOCRSpeculative(
        {n: v.cpu() for n, v in spec.net.state_dict().items()},
        cfg=spec.cfg, dflash_cfg=dcfg,
        dflash_state_dict={n: v.cpu()
                           for n, v in spec.draft.state_dict().items()},
        runtime=Runtime1("float32", device="cpu"))
    c_emb, c_pos = spec_request(cpu, small)
    g_emb, g_pos = spec_request(spec, small)

    def g_state():
        _, cache, _ = spec.start(g_emb, g_pos, max_new=FAM_NEW)
        return spec.spec_rounds.states[(1, cache.capacity, torch.float32)]

    # the CPU's first round (its halves eagerly, at the 0-d slot); the
    # card's key captured by one round, then a fresh prefill fed the
    # CPU's bonus token and drafts through the replayed verify half
    c_tok, c_cache, _ = cpu.start(c_emb, c_pos, max_new=FAM_NEW)
    c_st = cpu.spec_rounds.states[(1, c_cache.capacity, torch.float32)]
    c_l = []
    cpu.spec_rounds.run(c_st, cpu.bucket(c_st), logits=c_l)
    g_st = g_state()
    spec.spec_rounds.run(g_st, spec.bucket(g_st))
    verify = g_st.verify_graphs[None]
    g_st = g_state()
    g_l = []
    with torch.inference_mode():
        g_st.tok.copy_(c_tok)
        g_st.drafts.copy_(c_st.drafts)
    spec.spec_rounds.run(g_st, draft=False, logits=g_l)
    if g_st.verify_graphs[None] is not verify:
        raise AssertionError("HunyuanOCRSpeculative gpu vs cpu: the verify "
                             "half was captured again, not replayed")
    err = float((g_l[0].cpu() - c_l[0]).abs().max())
    top = float(c_l[0].abs().max())
    print(f"HunyuanOCRSpeculative gpu vs cpu (f32, {FAM_CROP}x{FAM_CROP}): "
          f"first round's verify logits, the replayed graph at the device "
          f"slot vs the CPU's eager round, max abs error {err!r} vs "
          f"max|logit| {top!r} (gate 1e-3 x)")
    if not err <= 1e-3 * top:
        raise AssertionError("HunyuanOCRSpeculative: the card's verify "
                             "block disagrees with the CPU's")
    c_ref = spec_greedy(cpu, c_emb, c_pos, FAM_NEW)
    g_spec = spec.decode_speculative(g_emb, g_pos, max_new=FAM_NEW)
    g_spec = g_spec + [spec.cfg.eos_id] * (FAM_NEW - len(g_spec))
    print("  ids: " + ids_gate("HunyuanOCRSpeculative gpu vs cpu ids",
                               np.asarray([g_spec]), *c_ref))
    del cpu
    return times


def family_pair(name: str, depth=None, seed: int = 0, cpu_side=True):
    """A family at published width on the card (float32, seeded) and the
    port's CPU model on the same weights (None without ``cpu_side``)."""
    from oar_ocr_tpu_torch.vl.families import FAMILY_CLASSES

    cls = FAMILY_CLASSES[name]
    cfg = family_cfg(name, depth)
    t0 = time.perf_counter()
    card = cls(cfg=cfg, seed=seed, runtime=Runtime1("float32", device="cuda"))
    cpu = cls({n: v.cpu() for n, v in card.module.state_dict().items()},
              cfg=cfg, runtime=Runtime1("float32", device="cpu")) \
        if cpu_side else None
    n = sum(p.numel() for p in card.module.parameters())
    print(f"{name}: {n} parameters (decoder {cfg.decoder.layers} layers of "
          f"{cfg.decoder.hidden}, tower {cfg.vision.layers} of "
          f"{cfg.vision.dim}), card + CPU built in "
          f"{time.perf_counter() - t0!r} s")
    return card, cpu


def family_greedy(fam, image, task, max_new, prompt=None, graph=True):
    """(ids (1, T) numpy, the logits that chose them (1, T, V) CPU); on
    the card through the decode graph unless ``graph`` is False."""
    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    e, p, vl, n = fam._build_inputs([image], task, prompt=prompt)
    steps = []
    ids = fam._generate_impl(e, p, vl, max_new=max_new,
                             capacity=decoder_cache_capacity(n, max_new),
                             step_logits=steps, graph=graph)
    return greedy_ref(ids.cpu()[0].tolist(), steps)


def bit_equal(what: str, graph, eager) -> None:
    """A greedy decode through the CUDA graph against the eager step body
    on the card, on the same inputs: the ids and the float32 logits that
    chose them (``greedy_ref`` pairs) equal bit for bit, compared as
    their bits, so a NaN equals the same NaN; whether the logits are
    finite is printed beside."""
    import torch

    (g_ids, g_logits), (e_ids, e_logits) = graph, eager
    same = (np.array_equal(g_ids, e_ids) and g_logits.shape == e_logits.shape
            and torch.equal(g_logits.view(torch.int32),
                            e_logits.view(torch.int32)))
    print(f"  {what}: graph vs eager, {g_ids.shape[1]} ids and the logits "
          f"that chose them bit-equal: {same} (logits finite: "
          f"{bool(torch.isfinite(e_logits).all())})")
    if not same:
        err = (float((g_logits - e_logits).abs().max())
               if g_logits.shape == e_logits.shape else None)
        raise AssertionError(f"{what}: the decode graph disagrees with the "
                             f"eager step (ids {g_ids.tolist()} vs "
                             f"{e_ids.tolist()}, logits max abs {err!r})")


def family_ms_per_token(fam, image, task) -> dict:
    """Greedy decode ms per token through the graph and eagerly:
    (t(32) − t(8)) / 24 each, at one KV capacity."""
    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    e, p, vl, n = fam._build_inputs([image], task)
    cap = decoder_cache_capacity(n, 32)

    def run(m, graph):
        return fam._generate_impl(e, p, vl, max_new=m, capacity=cap,
                                  graph=graph).cpu()

    return {mode: (host_ms(lambda: run(32, graph))
                   - host_ms(lambda: run(8, graph))) / 24
            for mode, graph in (("graph", True), ("eager", False))}


def families_phase(card: str, page) -> dict:
    """Phase 36 (4-5): the families at published width on the card
    against the port on the CPU (GLM-OCR, OvisOCR2 and the HunyuanOCR
    family at depth FAM_CPU_DEPTH, the other four at FAM_DEPTH); each
    greedy decode through its graph against the eager step, bit for
    bit, GLM-OCR's, OvisOCR2's and HunyuanOCR's at full depth."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3

    crop = np.ascontiguousarray(page[:FAM_CROP, :FAM_CROP])
    out = {}
    # 4. GLM-OCR (greedy and MTP), OvisOCR2 (delta layers, chunked
    # prefill), the HunyuanOCR family (DFlash), full depth on the card;
    # the card against the CPU at depth FAM_CPU_DEPTH
    for name in ("glmocr", "ovisocr2", "hunyuanocr"):
        t0 = time.perf_counter()
        cut, cpu = family_pair(name, depth=FAM_CPU_DEPTH)
        task = cut.cfg.tasks[0]
        ref = family_greedy(cpu, crop, task, FAM_NEW)
        gate = ids_gate(f"{name} greedy (depth {FAM_CPU_DEPTH})",
                        family_greedy(cut, crop, task, FAM_NEW)[0], *ref)
        notes = [f"greedy at depth {FAM_CPU_DEPTH} {gate}"]
        if name == "ovisocr2":
            same = cut.parse([crop], max_new_tokens=FAM_NEW) == \
                cpu.parse([crop], max_new_tokens=FAM_NEW)
            if gate == "identical" and not same:
                raise AssertionError("ovisocr2 parse: card and CPU "
                                     "Markdown differ on identical ids")
            notes.append(f"parse card == CPU: {same}")
        del cut, cpu
        t_cpu = time.perf_counter() - t0
        fam, _ = family_pair(name, cpu_side=False)
        g = family_greedy(fam, crop, task, FAM_NEW)
        bit_equal(f"{name} greedy ({FAM_CROP}x{FAM_CROP})", g,
                  family_greedy(fam, crop, task, FAM_NEW, graph=False))
        if fam.cfg.draft_len > 0:
            e, p, vl, _ = fam._build_inputs([crop], task)
            rounds = []
            decode = fam.decode_dflash if fam.cfg.dflash else fam.decode_mtp
            ids = decode(e, p, vl, max_new=FAM_NEW, rounds=rounds)
            ids = ids + [fam.cfg.decoder.eos_id] * (FAM_NEW - len(ids))
            # greedy-exact: the card's own greedy ids at full depth
            gate = ids_gate(f"{name} speculative", np.asarray([ids]), *g)
            notes.append(f"speculative {gate}, rounds {rounds}")
            forced_accept(fam, e, p, vl, name)
            out[f"{name}_rounds"] = round_report(
                f"{name} {'DFlash' if fam.cfg.dflash else 'MTP'} rounds "
                f"({FAM_CROP}x{FAM_CROP}, {FAM_SPEC_NEW} tokens)",
                lambda: family_start(fam, e, p, vl, FAM_SPEC_NEW),
                fam.cfg.decoder.eos_id, FAM_SPEC_NEW, card,
                per_round={K3: 2 * fam.cfg.decoder.layers})
        ms = family_ms_per_token(fam, page, task)
        out[name] = ms
        print(f"{name} gpu vs cpu ({FAM_CROP}x{FAM_CROP}, {FAM_NEW} tokens): "
              f"{'; '.join(notes)}; greedy decode on the page "
              f"{ms['graph']!r} ms/token through the graph, "
              f"{ms['eager']!r} eager, phase "
              f"{time.perf_counter() - t0!r} s (card against CPU "
              f"{t_cpu!r} s)  [{card}]")
        graph_report(fam, card, name, {K3: 2 * fam.cfg.decoder.layers})
        del fam
        torch.cuda.empty_cache()
    # 5. the other four at published width, depth FAM_DEPTH
    for name in ("mineru", "mineru_diffusion", "hpd_parsing", "monkeyocrv2"):
        t0 = time.perf_counter()
        fam, cpu = family_pair(name, depth=FAM_DEPTH)
        if name == "mineru":
            import cv2

            from oar_ocr_tpu_torch.vl.mineru_layout import (
                LAYOUT_IMAGE_SIZE, LAYOUT_PROMPT)

            square = cv2.resize(crop, (LAYOUT_IMAGE_SIZE,) * 2,
                                interpolation=cv2.INTER_CUBIC)
            ref = family_greedy(cpu, square, "layout", FAM_NEW,
                                prompt=LAYOUT_PROMPT)
            g = family_greedy(fam, square, "layout", FAM_NEW,
                              prompt=LAYOUT_PROMPT)
            bit_equal("mineru layout pass", g, family_greedy(
                fam, square, "layout", FAM_NEW, prompt=LAYOUT_PROMPT,
                graph=False))
            note = ids_gate("mineru layout pass", g[0], *ref)
            got = [b.to_json() for b in fam.parse_two_step(
                crop, max_new_tokens=FAM_NEW)]
            want = [b.to_json() for b in cpu.parse_two_step(
                crop, max_new_tokens=FAM_NEW)]
            same = got == want
            if note == "identical" and not same:
                raise AssertionError("mineru parse_two_step: card and CPU "
                                     "blocks differ on identical ids")
            note += f"; parse_two_step blocks card == CPU: {same} ({len(got)})"
        elif name == "mineru_diffusion":
            e, p, vl, _ = fam._build_inputs([crop], "ocr")
            runs = {}
            for graph in (True, False):
                trials = []
                ids = fam.decode_blocks(e, p, vl, max_new=2 * FAM_NEW,
                                        graph=graph, logits=trials)
                runs[graph] = (np.asarray([ids]), torch.stack(
                    [x.float().cpu()[0] for x in trials])[None])
            bit_equal("mineru_diffusion trial and commit graphs (ids, "
                      "each trial's logits)", runs[True], runs[False])
            got = fam.generate([crop], max_new_tokens=2 * FAM_NEW)
            want = cpu.generate([crop], max_new_tokens=2 * FAM_NEW)
            if got != want:
                raise AssertionError(f"mineru_diffusion: card {got!r} vs "
                                     f"CPU {want!r}")
            note = (f"texts identical ({len(got[0])} chars); "
                    f"{runs[True][1].shape[1]} trials through the graphs")
        elif name == "hpd_parsing":
            note = hpd_forks(fam, cpu, crop)
        else:
            ref = family_greedy(cpu, crop, "end2end", FAM_NEW)
            g = family_greedy(fam, crop, "end2end", FAM_NEW)
            bit_equal("monkeyocrv2 end2end", g, family_greedy(
                fam, crop, "end2end", FAM_NEW, graph=False))
            note = ids_gate("monkeyocrv2 end2end", g[0], *ref)
            res = fam.parse_end2end(crop, max_new_tokens=FAM_NEW)
            note += (f"; parse_end2end {len(res.elements)} elements, page "
                     f"{res.width}x{res.height}")
        print(f"{name} (depth {FAM_DEPTH}) gpu vs cpu: {note}; phase "
              f"{time.perf_counter() - t0!r} s  [{card}]")
        del fam, cpu
        torch.cuda.empty_cache()
    return out


def family_start(fam, e, p, vl, max_new: int):
    """A family's speculative prefill into its round key's static
    buffers → (round runner, state, page-bucket function)."""
    import torch

    if fam.cfg.dflash is None:
        return (fam.spec_rounds, fam.mtp_start(e, p, vl, max_new=max_new),
                lambda st: None)
    _, cache, _ = fam.dflash_start(e, p, vl, max_new=max_new)
    return (fam.spec_rounds, fam.spec_rounds.states[
        (1, cache.capacity, torch.float32)], fam.dflash_bucket)


def forced_accept(fam, e, p, vl, name) -> None:
    """The family's captured verify half, replayed alone on the greedy's
    own next tokens written into the static drafts, accepts them all and
    emits the greedy's tokens."""
    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    t = e.shape[1]
    k = (fam.cfg.dflash.block_size - 1 if fam.cfg.dflash is not None
         else fam.cfg.draft_len)
    steps = []
    g_ids = fam._generate_impl(e, p, vl, max_new=k + 2,
                               capacity=decoder_cache_capacity(t, k + 2),
                               step_logits=steps)
    g_ids, g_logits = greedy_ref(g_ids.cpu()[0].tolist(), steps)
    runner, st, _ = family_start(fam, e, p, vl, FAM_NEW)
    replayed_forced_accept(name, runner, st, g_ids, g_logits)


def hpd_forks(fam, cpu, crop) -> str:
    """HPD's parse_with_forks card against CPU, then its children driven
    from the parent's cache at two fork depths (``keep_indices`` +
    ``with_lengths``, per-row positions and per-row slots): on the card
    the parent's 0-d-slot graph and the children's per-row-slot graph
    against the same steps run eagerly, bit for bit, and the card's ids
    against the CPU's."""
    import torch

    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    res = {}
    for side, m, graph in (("card", fam, True), ("eager", fam, False),
                           ("cpu", cpu, True)):
        e, p, vl, t = m._build_inputs([crop], "parse")
        cache, full, _ = m._new_cache(e, vl, decoder_cache_capacity(
            t, 2 * FAM_NEW + 1))
        with torch.inference_mode():
            logits, _, _ = m.module.lm.prefill(e, p, cache, full)
        cache.advance(t)
        npos = int(p.max()) + 1
        steps = []
        parent, cache = m._decode_from_cache(
            logits.argmax(-1).to(torch.int32), cache, npos, t, FAM_NEW,
            step_logits=steps, graph=graph)
        ends = (2, 5)
        child_cache = cache.keep_indices([0, 0]).with_lengths(
            [t + e_ for e_ in ends])
        dev = e.device
        csteps = []
        children, _ = m._decode_from_cache(
            torch.tensor([int(parent[0, e_]) for e_ in ends],
                         dtype=torch.int32, device=dev), child_cache,
            torch.tensor([npos + e_ for e_ in ends], device=dev),
            torch.tensor([t + e_ for e_ in ends], device=dev), FAM_NEW,
            step_logits=csteps, graph=graph)
        res[side] = (parent, torch.stack(
            [s.float().cpu() for s in [logits] + steps[:-1]], 1),
            children, torch.stack([s.float().cpu() for s in csteps], 1))
    g, ea, c = res["card"], res["eager"], res["cpu"]
    bit_equal("hpd_parsing parent (0-d slot graph)", g[:2], ea[:2])
    bit_equal("hpd_parsing children (per-row slot graph)", g[2:], ea[2:])
    note = "parent " + ids_gate("hpd parent", g[0], c[0], c[1])
    if (g[0] == c[0]).all():
        # children seeded from identical parents: step i chose id i + 1
        note += "; children " + ids_gate(
            "hpd children", g[2][:, 1:], c[2][:, 1:], c[3][:, :-1])
    out = fam.parse_with_forks(crop, max_new_tokens=FAM_NEW)
    return note + (f"; parse_with_forks: {out['stats']['num_children']} "
                   f"children")


def vl_table_phase(card: str, crop) -> None:
    """Phase 36 (6): PaddleOCR-VL's table task (OTSL → HTML) on the VL
    phase's model (float32, seed 0), the card against the CPU."""
    from oar_ocr_tpu_torch.vl import PaddleOCRVL

    vlm = PaddleOCRVL(runtime=Runtime1("float32", device="cuda"), seed=0)
    cpu = PaddleOCRVL({n: v.cpu() for n, v in vlm.net.state_dict().items()},
                      runtime=Runtime1("float32", device="cpu"))
    c_ids = vl_logits(cpu, [crop], "table", FAM_NEW)
    g_ids = vl_logits(vlm, [crop], "table", FAM_NEW)
    note = ids_gate("PaddleOCR-VL table ids", g_ids[2].cpu().numpy(),
                    c_ids[2].numpy(), torch_steps(c_ids))
    got = vlm.generate([crop], "table", max_new_tokens=FAM_NEW)[0].text
    want = cpu.generate([crop], "table", max_new_tokens=FAM_NEW)[0].text
    print(f"PaddleOCR-VL table task gpu vs cpu ({crop.shape[0]}x"
          f"{crop.shape[1]}, {FAM_NEW} tokens): ids {note}; HTML card == "
          f"CPU {got == want}: {got[:60]!r}  [{card}]")
    if note == "identical" and got != want:
        raise AssertionError("PaddleOCR-VL table task: HTML differs on "
                             "identical ids")


def torch_steps(run):
    """The logits that chose each id of a ``vl_logits`` run: the
    prefill's, then each step's but the last (1, T, V)."""
    import torch

    _, logits, _, steps = run
    return torch.stack([s.float().cpu() for s in [logits] + steps[:-1]], 1)


def spec_families_phase(card: str, kernels) -> dict:
    """Phase 36: the kernel checks, the main path's launches (a
    HunyuanOCRSpeculative request and a GLM-OCR family request), then
    the gates of items 2-6. Returns the records and the launches."""
    import torch

    from oar_ocr_tpu_torch.ops.flash_attention import KERNEL as K2
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL_QK as K4
    from oar_ocr_tpu_torch.vl.families import GLMOCR

    t_phase = time.perf_counter()
    page = make_pages(0)[0]
    crop = np.ascontiguousarray(page[:448, :448])
    t_fam = family_tokens()
    print(f"K2 at D = 64 vs plain version (a family tower's {t_fam} "
          f"patches on the page):")
    cases = {"K2": k2_d64_cases(t_fam)}
    cases["K3"], cases["K4"] = spec_k3_k4_cases()
    recs = {key: run_cases(c, card) for key, c in cases.items()}
    torch.cuda.empty_cache()

    # the main path: a speculative request and a family request, counts
    # zeroed just before and read just after
    from oar_ocr_tpu_torch.vl.dflash import DFlashConfig
    from oar_ocr_tpu_torch.vl.hunyuan import HunyuanOCRSpeculative

    t0 = time.perf_counter()
    dcfg = DFlashConfig(hidden=1024, vocab_size=120818)
    spec = HunyuanOCRSpeculative(dflash_cfg=dcfg, seed=0,
                                 runtime=Runtime1("float32", device="cuda"))
    print(f"HunyuanOCRSpeculative float32: target "
          f"{sum(p.numel() for p in spec.net.parameters())} and draft "
          f"{sum(p.numel() for p in spec.draft.parameters())} parameters, "
          f"block {dcfg.block_size}, taps {dcfg.target_layer_ids}, page "
          f"{dcfg.page_size}, built in {time.perf_counter() - t0!r} s")
    glm = GLMOCR(cfg=family_cfg("glmocr"), seed=0,
                 runtime=Runtime1("float32", device="cuda"))
    for k in kernels:
        k.launches = 0
    out = spec.generate_speculative([crop], max_new_tokens=SPEC_NEW)
    fam_out = glm.generate([crop], max_new_tokens=16)
    launches = {"K2": K2.launches, "K3": K3.launches, "K4": K4.launches}
    print(f"phase 36 main path: HunyuanOCRSpeculative text {out[0][:24]!r}, "
          f"GLM-OCR text {fam_out[0][:24]!r}; launches {launches}")
    if min(launches.values()) == 0 or len(out) != 1 or len(fam_out) != 1:
        raise AssertionError(f"phase 36: a kernel of the path did not run "
                             f"({launches}) or a result is missing")
    del glm
    torch.cuda.empty_cache()
    times = spec_phase(card, spec, page, crop)
    del spec
    torch.cuda.empty_cache()
    fam_ms = families_phase(card, page)
    vl_table_phase(card, crop)
    torch.cuda.empty_cache()
    print(f"phase 36 in {time.perf_counter() - t_phase!r} s")
    return {"records": recs, "cases": cases, "launches": launches,
            "times": times, "family_ms_per_token": fam_ms}


# ---- the exact VLMs, the HPD fork scheduler and DocParser (phase 37) ----

EXACT_NEW = 64         # the main path's new tokens
# MinerU-2.5's prompt on the 1280×960 page: [eos], 46 × 34 merged patches
# of its 1288×952 resize, "OCR:"
MINERU_PROMPT = 1 + 46 * 34 + 4
SDAR_SLOT = 300        # the SDAR decode case's device slot
EXACT_CROP = 448       # the card-vs-CPU crop side
EXACT_CPU_NEW = 8      # new tokens, card against CPU
EXACT_DEPTH = 2        # tower and decoder depth of the card-vs-CPU stacks
# MinerU-Diffusion's card-vs-CPU run keeps SDAR's decoder at full depth
# (:func:`sdar_runs`)
EXACT_FAMILIES = ("mineru", "glmocr", "ovisocr2", "hpd_parsing",
                  "monkeyocrv2")
# DocParser's RT-DETR-L score threshold: phase 20's 0.92 keeps 13-30 boxes
# a page, each a PaddleOCR-VL crop the CPU side must also decode
DOCPARSER_THRESH = 0.94
DOCPARSER_TOKENS = 8
# the published MinerU-Diffusion pairs MinerU's tower (out 1536) with
# SDAR's 1024-wide decoder, which fails in both packages
# (exact_models.check_widths); it runs with the tower's output at 1024
DIFFUSION_TOWER_OUT = 1024


class IdsTokenizer:
    """Renders every id as ``⟨id⟩`` (random VL weights emit ids the byte
    tokenizer drops), so DocParser's markdown shows each region's ids."""

    def encode(self, text: str):
        from oar_ocr_tpu_torch.vl.model import ByteTokenizer

        return ByteTokenizer().encode(text)

    def decode(self, ids) -> str:
        return "".join(f"⟨{int(i)}⟩" for i in ids)


def exact_k2_cases():
    """Phase 37, K2 in float32 at the exact towers' shapes, as the towers
    pass them ((B, T, H, D) projections viewed as (B, H, T, D)): MinerU
    on the 1280×960 page (1, 16, 6256, 80) and on a 448×448 crop
    (1, 16, 1024, 80), both unmasked (a MinerU tower call encodes one
    image); D = 80 with valid_len, (2, 16, 1024, 80) with (1024, 700),
    which no path launches but which holds the masked D = 80 kernel to
    its plain version; GLM-OCR (1, 12, 6256, 128), non-causal; HPD's
    InternViT tiles through its fused-qkv view at every image HPD's
    tiling gives: 5 tiles (the page, (5, 16, 1025, 64)), 1 (a 448×448
    crop or a DocParser region), 3 and 4 (the float32 launch rule's
    stream grid at each)."""
    import torch

    from oar_ocr_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(37)
    cases = []
    for shape, vlen, what in (((1, 16, 6256, 80), None, "MinerU page"),
                              ((1, 16, 1024, 80), None, "MinerU crop"),
                              ((2, 16, 1024, 80), [1024, 700],
                               "D = 80 masked, no path"),
                              ((1, 12, 6256, 128), None, "GLM-OCR page"),
                              ((5, 16, 1025, 64), None, "HPD tiles"),
                              ((1, 16, 1025, 64), None, "HPD tiles"),
                              ((3, 16, 1025, 64), None, "HPD tiles"),
                              ((4, 16, 1025, 64), None, "HPD tiles")):
        b, h, t, d = shape
        if what == "HPD tiles":     # q, k, v of one (B, T, 3, H, D) qkv
            qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = (torch.randn((b, t, h, d), generator=gen,
                                   device="cuda").transpose(1, 2)
                       for _ in range(3))
        vl = (None if vlen is None else
              torch.tensor(vlen, dtype=torch.int32, device="cuda"))

        def kernel(q=q, k=k, v=v, vl=vl):
            return flash_attention(q, k, v, valid_len=vl)

        def plain(q=q, k=k, v=v, vl=vl):
            return flash_attention_ref(q, k, v, valid_len=vl)

        work = k2_work(q, vlen, False)
        work["library"] = sdpa_library(q, k, v, vl, False)
        cases.append((f"K2 {shape} valid_len {vlen} f32 {what} tower view",
                      kernel, plain, plain, gate_k2, work))
    return cases


def gate_k4_rows(got, ref):
    """K4 with per-row slots against its plain version: q and the whole
    cache ≤ 1e-6·max|ref| (float32; the kernel's 1/sqrtf and its sum
    order against torch's rsqrt), and bit-equal where nothing was
    written."""
    diff = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    top = max(float(r.abs().max()) for r in ref)
    untouched = bool(((got[1] == 0) == (ref[1] == 0)).all())
    ok = diff <= 1e-6 * top and untouched
    return diff, ok, (f"relative {diff / top!r}, gate 1e-6; the same slots "
                      f"written: {untouched}")


def exact_k4_cases():
    """Phase 37, K4 with per-row slots, as the HPD scheduler's verify
    block runs it: 4 branches of SDAR's 16 q and 8 k heads of 128, a
    block of 7 tokens (P-MTP's 6 drafts + the pending token), each row's
    k written into a (4, 8, 512, 128) layer cache from its own slot, the
    last clamped to C − T."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import (fused_qk_norm_rope_qk,
                                                       qk_norm_rope_qk_ref)

    gen = torch.Generator(device="cuda").manual_seed(38)
    b, t, cap = 4, 7, 512
    slots = torch.tensor([300, 17, 0, 509], device="cuda")
    ang = torch.rand((b, t, 64), generator=gen, device="cuda") * 512.0
    cos, sin = ang.cos(), ang.sin()
    q, k = (torch.randn((b, t, h, 128), generator=gen, device="cuda")
            for h in (16, 8))
    qs, ks = (torch.rand((128,), generator=gen, device="cuda") + 0.5
              for _ in range(2))
    caches = [torch.zeros((b, 8, cap, 128), device="cuda") for _ in range(2)]

    def kernel(cache=caches[0]):
        return (fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin, k_out=cache,
                                      slot=slots, eps=1e-6), cache)

    def plain(cache=caches[1]):
        return (qk_norm_rope_qk_ref(q, k, qs, ks, cos, sin, k_out=cache,
                                    slot=slots, eps=1e-6), cache)

    n = q.numel() + k.numel()
    work = bound(2 * n * 4 + 2 * b * t * 64 * 4 + 2 * 128 * 4 + 8 * b,
                 6.0 * n, torch.float32)
    return [(f"K4 q+k B={b} T={t} per-row slots {slots.tolist()} into "
             f"(B, 8, {cap}, 128) (16+8 heads, 128) f32 HPD verify block",
             kernel, plain, plain, gate_k4_rows, work)]


def graph_k4_cases():
    """Phase 37, K4 as the graphs of this phase's paths replay it: the
    HPD round graph's verify block at per-row slots (the pool of 32 slots
    the fork run grows to, SDAR's 16 q and 8 k heads of 128, a block of
    7: P-MTP's 6 drafts + the pending token, each row's k into a
    (32, 8, 512, 128) layer cache from its slot in a static (32,)
    vector, the last clamped to C − T), and SDAR's trial and commit
    graphs' block of 8 at the 0-d device slot SDAR_SLOT of a
    (1, 8, 512, 128) layer cache."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import (fused_qk_norm_rope_qk,
                                                       qk_norm_rope_qk_ref)

    gen = torch.Generator(device="cuda").manual_seed(41)
    cases = []
    rows = torch.randint(0, 505, (32,), generator=gen, device="cuda")
    rows[-1] = 509
    for b, t, slot, what in (
            (32, 7, rows, "per-row slots (a static (32,) vector) into "
             "(32, 8, 512, 128) (16+8 heads, 128) f32 HPD round graph"),
            (1, 8, torch.tensor(SDAR_SLOT, device="cuda"),
             f"device slot {SDAR_SLOT} into (1, 8, 512, 128) (16+8 heads, "
             f"128) f32 SDAR trial/commit graph")):
        ang = torch.rand((b, t, 64), generator=gen, device="cuda") * 512.0
        cos, sin = ang.cos(), ang.sin()
        q, k = (torch.randn((b, t, h, 128), generator=gen, device="cuda")
                for h in (16, 8))
        qs, ks = (torch.rand((128,), generator=gen, device="cuda") + 0.5
                  for _ in range(2))
        caches = [torch.zeros((b, 8, 512, 128), device="cuda")
                  for _ in range(2)]

        def kernel(q=q, k=k, qs=qs, ks=ks, cos=cos, sin=sin, slot=slot,
                   cache=caches[0]):
            return (fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin,
                                          k_out=cache, slot=slot, eps=1e-6),
                    cache)

        def plain(q=q, k=k, qs=qs, ks=ks, cos=cos, sin=sin, slot=slot,
                  cache=caches[1]):
            return (qk_norm_rope_qk_ref(q, k, qs, ks, cos, sin, k_out=cache,
                                        slot=slot, eps=1e-6), cache)

        # q, k read and written once, the tables, both scales, the slots
        n = q.numel() + k.numel()
        work = bound(2 * n * 4 + 2 * b * t * 64 * 4 + 2 * 128 * 4
                     + 8 * slot.numel(), 6.0 * n, torch.float32)
        cases.append((f"K4 q+k B={b} T={t} {what}", kernel, plain, plain,
                      gate_k4_rows, work))
    return cases


def exact_k3_cases():
    """Phase 37, K3 at MinerU-2.5's decoder rows (width 1536, eps 1e-6,
    float32): its prefill on the page, (MINERU_PROMPT, 1536), and a
    decode step's (1, 1536), 2 × 28 launches a step in the decode
    graph."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import (add_rmsnorm_ref,
                                                       fused_add_rmsnorm)

    gen = torch.Generator(device="cuda").manual_seed(39)
    cases = []
    for rows, what in ((MINERU_PROMPT, "MinerU-2.5 prefill on the page"),
                       (1, "MinerU-2.5 decode step")):
        x, r = (torch.randn((rows, 1536), generator=gen, device="cuda")
                for _ in range(2))
        scale = torch.rand((1536,), generator=gen, device="cuda") + 0.5

        def kernel(x=x, r=r, scale=scale):
            return fused_add_rmsnorm(x, r, scale, eps=1e-6)

        def plain(x=x, r=r, scale=scale):
            return add_rmsnorm_ref(x, r, scale, eps=1e-6)

        # x, r read, both outputs written, the weight read; add,
        # square-sum, two muls
        work = bound(4 * (4 * x.numel() + 1536), 5.0 * x.numel(),
                     torch.float32)
        cases.append((f"K3 ({rows}, 1536) f32 {what}", kernel, plain, plain,
                      gate_k3, work))
    return cases


def sdar_k4_case():
    """Phase 37, K4 as the SDAR decoders' decode graph runs it
    (MonkeyOCRv2, HPD-Parsing's greedy): one row, SDAR's 16 q and 8 k
    heads of 128, k written into a (1, 8, 512, 128) layer cache at the
    device slot the graph advances."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import (fused_qk_norm_rope_qk,
                                                       qk_norm_rope_qk_ref)

    gen = torch.Generator(device="cuda").manual_seed(40)
    slot = torch.tensor(SDAR_SLOT, device="cuda")
    ang = torch.rand((1, 1, 64), generator=gen, device="cuda") * 512.0
    cos, sin = ang.cos(), ang.sin()
    q, k = (torch.randn((1, 1, h, 128), generator=gen, device="cuda")
            for h in (16, 8))
    qs, ks = (torch.rand((128,), generator=gen, device="cuda") + 0.5
              for _ in range(2))
    caches = [torch.zeros((1, 8, 512, 128), device="cuda") for _ in range(2)]

    def kernel(cache=caches[0]):
        return (fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin, k_out=cache,
                                      slot=slot, eps=1e-6), cache)

    def plain(cache=caches[1]):
        return (qk_norm_rope_qk_ref(q, k, qs, ks, cos, sin, k_out=cache,
                                    slot=slot, eps=1e-6), cache)

    # q, k read and written once, the tables, both scales and the slot
    n = q.numel() + k.numel()
    work = bound(2 * n * 4 + 2 * 64 * 4 + 2 * 128 * 4 + 8, 6.0 * n,
                 torch.float32)
    return (f"K4 q+k B=1 T=1 device slot {SDAR_SLOT} into (1, 8, 512, 128) "
            f"(16+8 heads, 128) f32 SDAR decode step", kernel, plain, plain,
            gate_k4, work)


def exact_cut(family: str, depth=None):
    """An exact family's published (spec, vision config), tower and
    decoder cut to ``depth`` layers when given."""
    from oar_ocr_tpu_torch.vl.exact_models import family_spec

    spec, vcfg = family_spec(family)
    if family == "mineru_diffusion":
        vcfg = dataclasses.replace(vcfg, out_hidden=DIFFUSION_TOWER_OUT)
    if depth is not None:
        spec = dataclasses.replace(spec, text_cfg=dataclasses.replace(
            spec.text_cfg, layers=depth))
        key = "layers" if hasattr(vcfg, "layers") else "depth"
        vcfg = dataclasses.replace(vcfg, **{key: depth})
    return spec, vcfg


def exact_pair(family: str, depth=None, seed: int = 0):
    """An exact stack on the card (float32, seeded) and the port's CPU
    model on the same weights."""
    from oar_ocr_tpu_torch.vl.exact_models import (HpdForkExact, ExactVLM,
                                                   SdarDiffusionExact)

    cls = {"mineru_diffusion": SdarDiffusionExact,
           "hpd_parsing": HpdForkExact}.get(family, ExactVLM)
    spec, vcfg = exact_cut(family, depth)
    card = cls(spec, vcfg, seed=seed, runtime=Runtime1("float32"))
    cpu = cls(spec, vcfg, {n: v.cpu() for n, v in
                           card.net.state_dict().items()},
              runtime=Runtime1("float32", device="cpu"))
    return card, cpu


def exact_greedy(model, image, max_new, graph=True):
    """(ids (1, T) numpy, the logits that chose them (1, T, V) CPU) of a
    greedy generate on one image; on the card through the decode graph
    unless ``graph`` is False."""
    import torch

    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    e, p, t = model.prepare_prompt(image, "OCR:")
    steps = []
    ids = model.prefill_decode(
        e, model.runtime.put(p).long(),
        torch.tensor([t], device=e.device), max_new=max_new,
        capacity=decoder_cache_capacity(t, max_new), step_logits=steps,
        graph=graph)
    return greedy_ref(ids.cpu()[0].tolist(), steps)


def exact_times(model, page, card: str) -> dict:
    """Vision ms, prefill ms, decode ms/token through the decode graph
    and eagerly ((t(64) − t(16)) / 48 each, at the request's KV
    capacity), the graph's capture ms, pool MiB and launches per replay,
    its 64 ids and the logits that chose them against the eager step's
    (bit for bit), and the device's busy share over the graph's 64 steps
    alone (kernel time in a ``torch.profiler`` trace over the wall time,
    the prefill run before the trace). A trace is kept only if it holds
    every K3 launch the wrapper counted in it and its kernel time is
    within the wall time: traces on an H100 have lost part of a kernel's
    events. Any other is taken again, up to five times; then the share
    is None (not measured)."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    args, n_img, grid = model.tower_inputs(page)
    vision = host_ms(lambda: model.net.encode_image(*args))
    e, p, t = model.prepare_prompt(page, "OCR:")
    if t != MINERU_PROMPT:
        raise AssertionError(f"MinerU-2.5's prompt on the page: {t} "
                             f"tokens, K3's prefill case has {MINERU_PROMPT}")
    pos = model.runtime.put(p).long()
    cap = decoder_cache_capacity(t, EXACT_NEW)
    vl = torch.tensor([t], device="cuda")

    def prefill():
        cache = model.new_cache(1, cap)
        mask = torch.ones((1, 1, t, t), dtype=torch.bool,
                          device="cuda").tril()
        mask = torch.cat([mask, torch.zeros((1, 1, t, cap - t),
                                            dtype=torch.bool,
                                            device="cuda")], -1)
        with torch.no_grad():
            return model.net.prefill(e, pos, cache, mask,
                                     *model.empty_states(1))

    def decode(m, graph=True):
        return model.prefill_decode(e, pos, vl, max_new=m, capacity=cap,
                                    graph=graph).cpu()

    pre = host_ms(prefill)
    decode(EXACT_NEW)                 # the first request captures the graph
    st = model.decode_graphs.states[(1, cap, torch.float32)]
    t16, t64 = host_ms(lambda: decode(16)), host_ms(lambda: decode(EXACT_NEW))
    per_token = (t64 - t16) / (EXACT_NEW - 16)
    e16 = host_ms(lambda: decode(16, False))
    e64 = host_ms(lambda: decode(EXACT_NEW, False))
    eager_per_token = (e64 - e16) / (EXACT_NEW - 16)
    runs = {}
    for graph in (True, False):
        steps = []
        ids = model.prefill_decode(e, pos, vl, max_new=EXACT_NEW,
                                   capacity=cap, step_logits=steps,
                                   graph=graph)
        runs[graph] = greedy_ref(ids.cpu()[0].tolist(), steps)
    bit_equal(f"MinerU-2.5 (1280x960 page, {EXACT_NEW} tokens)", runs[True],
              runs[False])
    busy, wall = device_busy(
        lambda _: model.decode_graphs.decode(st, EXACT_NEW), K3,
        "add_rmsnorm_kernel",
        setup=lambda: model.prefill_decode(e, pos, vl, max_new=0,
                                           capacity=cap))
    busy_share = None if busy is None else busy / wall
    out = {"image_tokens": n_img, "grid": list(grid), "prompt": t,
           "kv_capacity": cap, "vision_ms": vision, "prefill_ms": pre,
           "generate_64_ms": t64, "graph_ms_per_token": per_token,
           "eager_generate_64_ms": e64, "eager_ms_per_token": eager_per_token,
           "capture_ms": st.capture_ms,
           "graph_pool_mib": pool_bytes(st.graph.pool()) / 2 ** 20,
           "busy_share": busy_share, "profiled_wall_ms": wall}
    print(f"MinerU-2.5 times (1280x960 page, float32): {json.dumps(out)}  "
          f"[{card}]")
    graph_report(model, card, "MinerU-2.5", {K3: 2 * 28})
    return out


def tower_times(model, image, card: str, what: str) -> dict:
    """An exact model's vision tower alone, at its published width and
    depth, on ``image``: host ms of one encode ending in a sync (median of
    3) and the K2 launches one encode counts (one a block: GLM-OCR's
    float32 D = 128, HPD's InternViT D = 64 over every tile at once)."""
    import torch

    from oar_ocr_tpu_torch.ops.flash_attention import KERNEL as K2

    args, n_img, grid = model.tower_inputs(image)
    model.net.encode_image(*args)
    torch.cuda.synchronize()
    n0 = K2.launches
    model.net.encode_image(*args)
    torch.cuda.synchronize()
    launches = K2.launches - n0
    cfg = model.vision_cfg
    depth = getattr(cfg, "depth", None) or cfg.layers
    out = {"patches": grid[0] * grid[1], "image_tokens": n_img,
           "grid": list(grid),
           "vision_ms": host_ms(lambda: model.net.encode_image(*args)),
           "k2_launches": launches, "depth": depth}
    if not any(grid):               # the tiled InternViT: its tiles
        out["tiles"] = int(args[0].shape[0])
    print(f"{what} vision tower (float32, full depth): {json.dumps(out)}  "
          f"[{card}]")
    if launches != depth:
        raise AssertionError(f"{what}: the tower launched K2 {launches} "
                             f"times, one a block predicts {depth}")
    return out


def exact_cli_path(page) -> tuple:
    """``cli.main(["vlm", "mineru-2.5", page.png, "--max-new-tokens",
    "64"])`` (default device: the card) → (its JSON line, ms)."""
    import contextlib
    import io
    import tempfile

    import cv2

    from oar_ocr_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/page.png"
        cv2.imwrite(path, page[:, :, ::-1])
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["vlm", "mineru-2.5", path, "--max-new-tokens",
                      str(EXACT_NEW)])
        ms = (time.perf_counter() - t0) * 1e3
    lines = out.getvalue().strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"cli vlm printed {len(lines)} lines")
    return json.loads(lines[0]), ms


def hpd_fork_runs(model, crop, max_new: int = 16) -> dict:
    """``parse_with_forks`` greedy and P-MTP on ``crop`` with the
    development fork id set to the token the greedy parent emits most
    often (so the parent forks wherever it emits it): both modes' parents
    and children identical, and each child's fork depth."""
    first = model.parse_with_forks(crop, max_new_tokens=max_new)
    toks = first["token_ids"][1:]
    fork = max(set(toks), key=lambda v: (toks.count(v), -toks.index(v)))
    model.DEV_FORK_ID = int(fork)
    for key in ("_sched", "_sched_mtp"):
        if hasattr(model, key):
            delattr(model, key)
    greedy = model.parse_with_forks(crop, max_new_tokens=max_new)
    mtp = model.parse_with_forks(crop, max_new_tokens=max_new, use_mtp=True)
    for key in ("parent", "children", "token_ids"):
        if greedy[key] != mtp[key]:
            raise AssertionError(f"HPD parse_with_forks: P-MTP {key} "
                                 "differ from greedy")
    child = model.scheduler(False).child_token_id
    depths = [i for i, v in enumerate(greedy["token_ids"]) if v == child]
    st = greedy["stats"]
    if st["forked_branches"] < 1:
        raise AssertionError("HPD parse_with_forks: the parent never forked")
    return {"fork_id": int(fork), "children": st["num_children"],
            "child_depths": depths, "greedy_stats": st,
            "mtp_stats": mtp["stats"]}


def hpd_round_report(model, crop, card: str, max_new: int = 16) -> dict:
    """HPD's fork scheduler on ``crop`` (the fork id :func:`hpd_fork_runs`
    chose), greedy and P-MTP, from one prefill: its rounds through the
    slot pools' CUDA graphs against the same round body run eagerly on
    the card, bit for bit (ids, counters, every round's targets and
    accept counts, and its hidden states compared as bits); ms per round
    and per token, graph and eager (the scheduler's whole run, median of
    3, over its rounds and over the tokens its branches emitted); each
    pool's slots, captures (capture ms, launches a replay, which must be
    the design's: 2 K3 a decoder layer and one a draft step, one K4 a
    layer) and pool MiB; the device's busy share over one request
    through the graphs (its kernel ms in a profile, :func:`device_busy`,
    over the graph run's unprofiled median ms) and the MiB of the row
    buffer the pools' caches view; then the memory at a page's
    capacity (:func:`hpd_page_memory`)."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL_QK as K4
    from oar_ocr_tpu_torch.vl.exact_models import _causal_prefill_mask
    from oar_ocr_tpu_torch.vl.hpd_scheduler import HpdSchedulerConfig
    from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

    c = model.spec.text_cfg
    embeds, pids, t = model.prepare_prompt(crop, "Parse:")
    cap = decoder_cache_capacity(t + max_new, max_new)
    cache = model.new_cache(1, cap)
    with torch.no_grad():
        logits, hidden, _, _ = model.net.prefill_hidden_all(
            embeds, model.runtime.put(pids).long(), cache,
            _causal_prefill_mask(1, t, cap, model.device),
            *model.empty_states(1))
    cache.advance(t)
    first = int(logits.argmax(-1)[0])
    out = {}
    for mode, use_mtp in (("greedy", False), ("p_mtp", True)):
        sched = model.scheduler(use_mtp)
        gen = HpdSchedulerConfig(max_new_tokens=max_new, use_mtp=use_mtp)

        def run(graph, log=None):
            res = sched.run(cache, first, hidden[:, -1], gen, graph=graph,
                            round_log=log)
            torch.cuda.synchronize()
            return res

        logs = {True: [], False: []}
        res = {g: run(g, logs[g]) for g in (True, False)}
        g_res, e_res = res[True], res[False]
        same = (g_res.token_ids == e_res.token_ids
                and g_res.children == e_res.children
                and g_res.stats == e_res.stats
                and len(logs[True]) == len(logs[False]))
        for a, b in zip(logs[True], logs[False]):
            same &= (a[0] == b[0] and np.array_equal(a[1], b[1])
                     and np.array_equal(a[2], b[2])
                     and torch.equal(a[3].view(torch.int32),
                                     b[3].view(torch.int32)))
        rounds = g_res.stats.scheduler_rounds
        tokens = len(g_res.parent_tokens) + sum(
            len(row) for row in g_res.children)
        print(f"  HPD {mode} rounds (448x448 crop, {max_new} tokens a "
              f"branch): round graphs vs eager rounds, {rounds} rounds, "
              f"{tokens} tokens, the ids, counters, every round's targets, "
              f"accept counts and hidden states bit-equal: {same}")
        if not same:
            raise AssertionError(f"HPD {mode}: the round graphs disagree "
                                 f"with the eager rounds")
        ms = {m: host_ms(lambda g=g: run(g)) for m, g in (("graph", True),
                                                         ("eager", False))}
        busy, wall = device_busy(lambda _: run(True), K3,
                                 "add_rmsnorm_kernel")
        share = None if busy is None else busy / ms["graph"]
        pools = {}
        for (slots, pcap, _), pool in sched.pools.items():
            graphs = {}
            for k, g in pool.graphs.items():
                n = {kk.name: v for kk, v in g.launches.counts.items()}
                want = {K3.name: 2 * c.layers + k, K4.name: c.layers}
                if n != want:
                    raise AssertionError(f"HPD {mode}: the ({slots}, {k}, "
                                         f"{pcap}) round graph launches {n} "
                                         f"a replay, the design {want}")
                graphs[k] = {"capture_ms": g.capture_ms, "launches": n}
            pools[slots] = {"capacity": pcap, "graphs": graphs,
                            "pool_mib": (pool_bytes(pool.pool) / 2 ** 20
                                         if pool.graphs else 0.0)}
        out[mode] = {
            "rounds": rounds, "tokens": tokens,
            "children": len(g_res.children),
            "accepted": g_res.stats.mtp_accepted_tokens,
            "graph_ms": ms["graph"], "eager_ms": ms["eager"],
            "graph_ms_per_round": ms["graph"] / rounds,
            "eager_ms_per_round": ms["eager"] / rounds,
            "graph_ms_per_token": ms["graph"] / tokens,
            "eager_ms_per_token": ms["eager"] / tokens,
            "kernel_ms": busy, "busy_share": share,
            "profiled_wall_ms": wall,
            "rows_mib": sched.rows.nbytes() / 2 ** 20, "pools": pools}
        print(f"  HPD {mode} times: {json.dumps(out[mode])}  [{card}]")
    out["page_capacity"] = hpd_page_memory(model, cache, first,
                                           hidden[:, -1], max_new, card)
    return out


def hpd_page_memory(model, cache, first, hidden, max_new: int, card: str,
                    capacity: int = 2048) -> dict:
    """The fork scheduler's device memory at a page's KV capacity
    (``capacity``, MinerU-2.5's on the page): ``cache``'s prefix copied
    into a cache of that capacity, one greedy and one P-MTP request
    through the round graphs (their first at this capacity: pools made,
    the row buffer grown, every key captured), the allocator's peak and
    what stays allocated after them, over what was allocated before; the
    row buffer's K/V MiB (the slot pools' caches, shared by both modes)
    and the graph pools' MiB."""
    import torch

    from oar_ocr_tpu_torch.vl.hpd_scheduler import HpdSchedulerConfig

    t = int(cache.length[0])
    big = model.new_cache(1, capacity)
    for buf, src in ((big.k, cache.k), (big.v, cache.v)):
        buf[..., :t, :].copy_(src[..., :t, :])
    big.length.copy_(cache.length)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    slots = {}
    for mode, use_mtp in (("greedy", False), ("p_mtp", True)):
        sched = model.scheduler(use_mtp)
        res = sched.run(big, first, hidden, HpdSchedulerConfig(
            max_new_tokens=max_new, use_mtp=use_mtp))
        slots[mode] = max(s for s, cap, _ in sched.pools if cap == capacity)
        if res.stats.forked_branches < 1:
            raise AssertionError("HPD at the page capacity: no fork")
    torch.cuda.synchronize()
    graph_pools = sum(pool_bytes(p.pool) for use_mtp in (False, True)
                      for (_, cap, _), p in
                      model.scheduler(use_mtp).pools.items()
                      if cap == capacity and p.graphs)
    rows = model.slot_rows.buffers[(capacity, torch.float32)]
    out = {"capacity": capacity, "slots": slots,
           "rows": rows.k.shape[1],
           "rows_mib": (rows.k.nbytes + rows.v.nbytes) / 2 ** 20,
           "graph_pools_mib": graph_pools / 2 ** 20,
           "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2 ** 20,
           "held_mib": (torch.cuda.memory_allocated() - base) / 2 ** 20}
    print(f"  HPD fork scheduler at KV capacity {capacity} (448x448 crop, "
          f"{max_new} tokens a branch, greedy then P-MTP): "
          f"{json.dumps(out)}  [{card}]")
    return out


def sdar_runs(card: str, crop, max_new: int = 64, block: int = 8) -> dict:
    """MinerU-Diffusion on the exact stack, SDAR's decoder at published
    width and depth (28 layers of 1024), its tower's output at
    DIFFUSION_TOWER_OUT and cut to EXACT_DEPTH blocks: block diffusion on
    ``crop`` (``block``-token blocks, 4 unmask steps): the card's ids
    against the CPU's on the same weights (2 blocks); the trial and
    commit graphs against the same passes run eagerly on the card, the
    ids and every trial's logits bit for bit; ms per token graph and
    eager (a request's decode, median of 3, over the blocks' tokens it
    committed); the device's busy share over one request's decode
    through the graphs (its kernel ms in a profile, :func:`device_busy`,
    the prefill out of it, over the unprofiled decode ms); the
    graphs' capture ms, launches a replay (2 K3 and 1 K4 a layer) and
    pool MiB."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL_QK as K4
    from oar_ocr_tpu_torch.vl.exact_models import SdarDiffusionExact

    t0 = time.perf_counter()
    spec, vcfg = exact_cut("mineru_diffusion")
    key = "layers" if hasattr(vcfg, "layers") else "depth"
    vcfg = dataclasses.replace(vcfg, **{key: EXACT_DEPTH})
    model = SdarDiffusionExact(spec, vcfg, seed=0,
                               runtime=Runtime1("float32"))
    cpu = SdarDiffusionExact(spec, vcfg, {n: v.cpu() for n, v in
                                          model.net.state_dict().items()},
                             runtime=Runtime1("float32", device="cpu"))
    gi, ci = [], []
    model.generate([crop], max_new_tokens=2 * block, block_len=block,
                   token_ids=gi)
    cpu.generate([crop], max_new_tokens=2 * block, block_len=block,
                 token_ids=ci)
    print(f"SDAR diffusion (decoder 28 layers of 1024, tower depth "
          f"{EXACT_DEPTH}) gpu vs cpu ({crop.shape[0]}x{crop.shape[1]}, "
          f"{2 * block} tokens): ids identical {gi == ci} ({gi[0]}); "
          f"{time.perf_counter() - t0!r} s  [{card}]")
    if gi != ci:
        raise AssertionError(f"SDAR diffusion: card {gi} vs CPU {ci}")
    del cpu
    embeds, pids, t = model.prepare_prompt(crop, "OCR:")
    pids = model.runtime.put(pids).long()
    n_blocks = -(-max_new // block)

    def start():
        return model.diffusion_start(embeds, pids, max_new_tokens=max_new,
                                     block_len=block,
                                     confidence_threshold=0.9)

    def request(graph, logits=None):
        st = start()
        ids = model.diffusion.decode(st, n_blocks, 4,
                                     model.spec.text_cfg.eos_id,
                                     graph=graph, logits=logits)
        torch.cuda.synchronize()
        return ids, st

    runs = {}
    for graph in (True, False):
        logits = []
        ids, st = request(graph, logits)
        runs[graph] = (ids, torch.stack([g.cpu() for g in logits]),
                       (int(st.wpos) - t) // block)
    (g_ids, g_l, g_blocks), (e_ids, e_l, _) = runs[True], runs[False]
    same = (g_ids == e_ids and g_l.shape == e_l.shape
            and torch.equal(g_l.view(torch.int32), e_l.view(torch.int32)))
    print(f"  SDAR diffusion graphs vs eager passes ({g_blocks} blocks, "
          f"{len(g_l)} trials): ids and every trial's logits bit-equal: "
          f"{same} (logits finite: {bool(torch.isfinite(e_l).all())})")
    if not same:
        raise AssertionError("SDAR diffusion: the trial and commit graphs "
                             "disagree with the eager passes")
    prefill = host_ms(start)
    tokens = g_blocks * block
    ms = {m: (host_ms(lambda g=g: request(g)) - prefill) / tokens
          for m, g in (("graph", True), ("eager", False))}
    busy, wall = device_busy(
        lambda s: model.diffusion.decode(s, n_blocks, 4,
                                         model.spec.text_cfg.eos_id), K3,
        "add_rmsnorm_kernel", setup=start)
    graphs = {}
    c = model.spec.text_cfg
    for name, g in st.graphs.items():
        n = {k.name: v for k, v in g.launches.counts.items()}
        want = {K3.name: 2 * c.layers, K4.name: c.layers}
        if n != want:
            raise AssertionError(f"SDAR {name} graph launches {n} a replay, "
                                 f"the design {want}")
        graphs[name] = {"capture_ms": g.capture_ms, "launches": n}
    out = {"prompt": t, "blocks": g_blocks, "trials": len(g_l),
           "tokens": tokens, "prefill_ms": prefill,
           "graph_ms_per_token": ms["graph"],
           "eager_ms_per_token": ms["eager"], "kernel_ms": busy,
           "busy_share": (None if busy is None
                          else busy / (ms["graph"] * tokens)),
           "profiled_wall_ms": wall, "graphs": graphs,
           "pool_mib": pool_bytes(st.pool) / 2 ** 20}
    print(f"  SDAR diffusion times (f32, {max_new} tokens, block {block}): "
          f"{json.dumps(out)}  [{card}]")
    del model
    torch.cuda.empty_cache()
    return out


def docparser(vlm, layout_state, runtime):
    """DocParser over RT-DETR-L (phase 17's weights) and a VLMBackend."""
    from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
    from oar_ocr_tpu_torch.vl import DocParser
    from oar_ocr_tpu_torch.vl.doc_parser import DocParserConfig, VLMBackend

    layout = LayoutDetector("pp-doclayout_plus-l", dict(layout_state),
                            score_thresh=DOCPARSER_THRESH, runtime=runtime)
    return DocParser(VLMBackend(vlm), layout=layout,
                     config=DocParserConfig(max_tokens=DOCPARSER_TOKENS),
                     runtime=runtime)


def exact_phase(card: str, kernels, layout_state) -> dict:
    """Phase 37: the kernel gates, the main path (``cli vlm mineru-2.5``
    on the page at published width and depth, HPD's P-MTP fork parse,
    ``DocParser.parse_to_markdown``), counts zeroed before and read
    after; then the card against the CPU for every exact family, the
    other entry points, DocParser's markdown and the converter."""
    import torch

    from oar_ocr_tpu_torch.ops.flash_attention import KERNEL as K2
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL_QK as K4
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.ops.normalize import LAUNCHES_BY_CALLER
    from oar_ocr_tpu_torch.vl import PaddleOCRVL
    from oar_ocr_tpu_torch.vl.exact_models import (exact_from_registry,
                                                   hpd_fork_exact)

    t_phase = time.perf_counter()
    pages = make_pages(0)
    page = pages[0]
    crop = np.ascontiguousarray(page[:EXACT_CROP, :EXACT_CROP])
    # 1. kernel gates
    print("K2 f32 at the exact towers' shapes, K3 at MinerU-2.5's rows, "
          "K4 with per-row slots, at SDAR's decode slot, in HPD's round "
          "graph and in SDAR's block graphs, vs plain versions:")
    cases = {"K2": exact_k2_cases(), "K3": exact_k3_cases(),
             "K4": exact_k4_cases() + [sdar_k4_case()] + graph_k4_cases()}
    recs = {key: run_cases(c, card) for key, c in cases.items()}
    torch.cuda.empty_cache()

    # 2. the main path
    rt = Runtime1("float32")
    hpd = hpd_fork_exact(seed=0, runtime=rt)
    vlm = PaddleOCRVL(runtime=rt, seed=0, tokenizer=IdsTokenizer())
    parser = docparser(vlm, layout_state, rt)
    hpd.parse_with_forks(crop, max_new_tokens=4)        # warm the tower
    for k in kernels:
        k.launches = 0
    LAUNCHES_BY_CALLER.clear()
    line, cli_ms = exact_cli_path(page)
    cli_n = {"K2": K2.launches, "K3": K3.launches, "K4": K4.launches}
    forks = hpd_fork_runs(hpd, crop)
    elements = [len(parser.parse(p).elements) for p in pages[:2]]
    md_card = [parser.parse_to_markdown(p) for p in pages[:2]]
    launches = {"K1": K1.launches, "K2": K2.launches, "K3": K3.launches,
                "K4": K4.launches}
    k1_layout = LAUNCHES_BY_CALLER["layout"]
    print(f"phase 37 main path: cli vlm mineru-2.5 {cli_ms!r} ms, text "
          f"{line['text'][:24]!r}, launches {cli_n}; HPD forks {forks}; "
          f"DocParser elements {elements}, markdown chars "
          f"{[len(m) for m in md_card]}, K1 by "
          f"layout {k1_layout}; launches in all {launches}")
    layers = 28
    want = {"K2": 32, "K3": 2 * layers * (1 + EXACT_NEW), "K4": 0}
    if cli_n != want:
        raise AssertionError(f"cli vlm mineru-2.5 launches {cli_n}, the "
                             f"design predicts {want}")
    if min(launches.values()) == 0 or k1_layout == 0 or \
            line["model"] != "mineru-2.5":
        raise AssertionError(f"phase 37: a kernel of the path did not run "
                             f"({launches}, K1 by layout {k1_layout})")
    print(f"  (phase 37 main path done at {time.perf_counter() - t_phase!r}"
          " s)")
    # HPD's InternViT tower alone: the page's 5 tiles, the crop's 1
    hpd_tower = {what: tower_times(hpd, image, card, f"HPD-Parsing ({what})")
                 for what, image in (("1280x960 page", page),
                                     ("448x448 crop", crop))}
    hpd_rounds = hpd_round_report(hpd, crop, card)
    del hpd
    torch.cuda.empty_cache()
    sdar = sdar_runs(card, crop)
    mineru = exact_from_registry("mineru-2.5", runtime=rt)
    times = exact_times(mineru, page, card)
    del mineru
    torch.cuda.empty_cache()

    # 3. the card against the port's CPU, every exact family at published
    # width, depth EXACT_DEPTH, the 448x448 crop, EXACT_CPU_NEW tokens
    mineru_cut = None
    for family in EXACT_FAMILIES:
        t0 = time.perf_counter()
        g, c = exact_pair(family, EXACT_DEPTH)
        ge, _, _ = g.prepare_prompt(crop, "OCR:")
        ce, _, _ = c.prepare_prompt(crop, "OCR:")
        err = float((ge.cpu() - ce).abs().max())
        top = float(ce.abs().max())
        if not err <= 1e-4 * top:
            raise AssertionError(f"{family}: fused embeddings card vs CPU "
                                 f"{err!r} > 1e-4 x {top!r}")
        ref = exact_greedy(c, crop, EXACT_CPU_NEW)
        got = exact_greedy(g, crop, EXACT_CPU_NEW)
        bit_equal(f"{family} greedy (depth {EXACT_DEPTH})", got,
                  exact_greedy(g, crop, EXACT_CPU_NEW, graph=False))
        note = "ids " + ids_gate(f"{family} greedy", got[0], *ref)
        if family == "mineru":
            mineru_cut = (g, got[0])
        n = sum(p.numel() for p in g.net.parameters())
        print(f"{family} (depth {EXACT_DEPTH}, {n} parameters) gpu vs cpu "
              f"({EXACT_CROP}x{EXACT_CROP}, {EXACT_CPU_NEW} tokens): fused "
              f"embeddings max abs error {err!r} vs max {top!r}; {note}; "
              f"{time.perf_counter() - t0!r} s  [{card}]")
        del g, c
        torch.cuda.empty_cache()

    print(f"  (phase 37 card vs CPU done at "
          f"{time.perf_counter() - t_phase!r} s)")
    # 4. the other entry points at published width and depth, on the card
    from oar_ocr_tpu_torch.vl.exact_models import (glm_speculative_exact,
                                                   ovis_exact)

    glm_tower, spec_rounds = None, {}
    for name, build, n_new in (("OvisOCR2 n-gram", ovis_exact, 32),
                               ("GLM-OCR MTP", glm_speculative_exact, 16)):
        m = build(seed=0, runtime=rt)
        if build is glm_speculative_exact:
            glm_tower = tower_times(m, page, card, "GLM-OCR (1280x960 page)")
        gi, si, stats = [], [], {}
        m.generate([crop], max_new_tokens=n_new, token_ids=gi)
        m.generate_speculative([crop], max_new_tokens=n_new, token_ids=si,
                               stats=stats)
        eos = m.spec.text_cfg.eos_id
        greedy = gi[0][:gi[0].index(eos) + 1] if eos in gi[0] else gi[0]
        print(f"{name} (full depth) speculative ids, its rounds through "
              f"their graphs, == greedy ids: {si[0] == greedy} "
              f"({len(greedy)} ids), {stats}")
        if si[0] != greedy:
            raise AssertionError(f"{name}: {si[0]} vs greedy {greedy}")
        embeds, pids, _ = m.prepare_prompt(crop, "OCR:")
        pids = m.runtime.put(pids).long()
        if build is ovis_exact:
            def start(m=m, embeds=embeds, pids=pids, n_new=n_new):
                return (m.spec_rounds, m.ngram_start(
                    embeds, pids, m.tokenizer.encode("OCR:"),
                    max_new_tokens=n_new, draft_k=6, ngram=2),
                    lambda st: None)
        else:
            def start(m=m, embeds=embeds, pids=pids, n_new=n_new):
                return (m.mtp_rounds, m.mtp_start(
                    embeds, pids, max_new_tokens=n_new), lambda st: None)
        spec_rounds[name] = round_report(
            f"{name} rounds (full depth, {EXACT_CROP}x{EXACT_CROP}, {n_new} "
            f"tokens)", start, eos, n_new, card,
            per_round={K3: 2 * m.spec.text_cfg.layers})
        del m, start
        torch.cuda.empty_cache()

    # 5. DocParser's markdown, the card against the CPU
    cpu_rt = Runtime1("float32", device="cpu")
    cvlm = PaddleOCRVL({n: v.cpu() for n, v in vlm.net.state_dict().items()},
                       runtime=cpu_rt, tokenizer=IdsTokenizer())
    t0 = time.perf_counter()
    md_cpu = [docparser(cvlm, layout_state, cpu_rt).parse_to_markdown(p)
              for p in pages[:2]]
    print(f"DocParser markdown card == CPU: {md_card == md_cpu} (CPU "
          f"{time.perf_counter() - t0!r} s); e.g. {md_card[0][:80]!r}")
    if md_card != md_cpu or not all(md_card):
        raise AssertionError("DocParser: the card's markdown differs from "
                             "the CPU's")
    del vlm, cvlm, parser
    torch.cuda.empty_cache()

    # 6. the converter: the card's MinerU (depth EXACT_DEPTH) as HF-name
    # tensors, through its map into the registry's artifact format (flax
    # keys and layouts; the file format is the CPU tests'), and back: the
    # same ids bit for bit
    from oar_ocr_tpu_torch.runtime import ppocr_maps
    from oar_ocr_tpu_torch.runtime.weights import params_from_jax
    from oar_ocr_tpu_torch.vl.exact_models import ExactVLM

    g, g_ids = mineru_cut
    mineru_cut = None
    t0 = time.perf_counter()
    cm = ppocr_maps.build_vl_map(g.net, name="mineru-2.5")
    sd = ppocr_maps.convert_official(
        g.net, cm, ppocr_maps.export_vl_format(g.net))
    back = params_from_jax(ppocr_maps.jax_flat_params(g.net, sd))
    conv = ExactVLM(*exact_cut("mineru", EXACT_DEPTH), back, runtime=rt)
    c_ids = exact_greedy(conv, crop, EXACT_CPU_NEW)[0]
    print(f"converter round trip (export_vl_format → build_vl_map → "
          f"artifact keys → params_from_jax): ids {c_ids[0].tolist()} == phase 37's "
          f"{bool((c_ids == g_ids).all())}, "
          f"{time.perf_counter() - t0!r} s")
    if not (c_ids == g_ids).all():
        raise AssertionError("the converted MinerU's ids differ")
    del g, conv
    torch.cuda.empty_cache()
    print(f"phase 37 in {time.perf_counter() - t_phase!r} s")
    return {"records": recs, "cases": cases, "launches": launches,
            "cli_launches": cli_n, "times": times, "forks": forks,
            "glm_tower": glm_tower, "hpd_tower": hpd_tower,
            "spec_rounds": spec_rounds, "hpd_rounds": hpd_rounds,
            "sdar": sdar}


MESH_NEW = 32          # phase 38's new tokens, n_model 2 against 1


def mesh_k1_cases(seen, devices) -> dict:
    """:func:`chain_k1_cases` at a mesh's recorded K1 inputs, on each
    distinct device of ``devices``: {device: cases}."""
    import torch

    out = {}
    for d in dict.fromkeys(devices):
        moved = {}
        for (caller, shape), (x, alpha, beta, kw) in seen.items():
            kw_d = {k: v.to(d) if isinstance(v, torch.Tensor) else v
                    for k, v in kw.items()}
            moved[(caller, (*shape, str(d)))] = (x.to(d), alpha, beta,
                                                 kw_d)
        out[d] = chain_k1_cases(moved)
    return out


def mesh_k1_checks(k1, k1_c, cases_by_device, card: str) -> None:
    """K1 at the mesh shards' inputs against its plain version on every
    card: the first card's cases join K1's record (phase 21 times them),
    the others run under their card's device, checked and timed there."""
    import torch

    for i, (d, cases) in enumerate(cases_by_device.items()):
        what = f"the mesh shards' own det and rec inputs on {d}"
        if i == 0:
            add_k1(k1, k1_c, cases, card, what)
            continue
        with torch.cuda.device(d):
            print(f"K1 at {what} vs plain version:")
            run_cases(cases, card)


def by_card(kernel) -> dict:
    """A kernel's launches by card index, as a plain dict."""
    return {int(i): n for i, n in sorted(kernel.launches_by_device.items())}


def tp_k3_cases(rows, width: int):
    """K3 float32 at (r, width) for r in ``rows`` (a tensor-parallel
    decoder's prefill and decode rows: each shard's replicated
    residual), on the current card."""
    import torch

    from oar_ocr_tpu_torch.ops.fused_norm_rope import (add_rmsnorm_ref,
                                                       fused_add_rmsnorm)

    gen = torch.Generator(device="cuda").manual_seed(38)
    cases = []
    for r in rows:
        x, res = (torch.randn((r, width), generator=gen, device="cuda")
                  for _ in range(2))
        scale = torch.rand((width,), generator=gen, device="cuda") + 0.5

        def kernel(x=x, res=res, scale=scale):
            return fused_add_rmsnorm(x, res, scale, eps=1e-6)

        def plain(x=x, res=res, scale=scale):
            return add_rmsnorm_ref(x, res, scale, eps=1e-6)

        work = bound(4 * (4 * x.numel() + width), 5.0 * x.numel(),
                     torch.float32)
        cases.append((f"K3 ({r}, {width}) f32 n_model 2 shard", kernel,
                      plain, plain, gate_k3, work))
    return cases


def mesh_phase(card: str, kernels, det_state, fitted) -> dict:
    """Phase 38: the data-parallel OCR predict and the tensor-parallel
    GLM-OCR generate, each against one card. Returns the launches of
    the phase's main paths ("launches", "by_card") and the K1 cases at
    the shards' inputs ("k1_cases")."""
    import torch

    from oar_ocr_tpu_torch.config.runtime import MeshConfig, RuntimeConfig
    from oar_ocr_tpu_torch.ops.flash_attention import KERNEL as K2
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.runtime.runtime import Runtime
    from oar_ocr_tpu_torch.utils.parity import compare_results
    from oar_ocr_tpu_torch.vl.families import GLMOCR

    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]

    def spread(n):
        return cards[:n] if len(cards) >= n else [cards[0]] * n

    # --- the OCR predict over a data-parallel mesh ---
    t0 = time.perf_counter()
    dp_rt = Runtime("float32", device="cuda", devices=spread(
        max(len(cards), 2)), cfg=RuntimeConfig(use_mesh=True))
    pages = make_pages(0)
    single = build_pipeline(Runtime1("float32", device="cuda"),
                            det_state, fitted)
    mesh = build_pipeline(dp_rt, det_state, fitted)
    want = single.predict(pages)
    mesh.predict(pages)                              # warm-up call
    for k in kernels:
        k.reset_counts()
    with K1Inputs(callers=("det", "rec")) as rec:
        got = mesh.predict(pages)
    torch.cuda.synchronize()
    k1 = {"launches": K1.launches, "by_card": by_card(K1)}
    report = compare_results(got, want)
    n_text = sum(1 for r in got for x in r.regions if x.text)
    print(f"phase 38 OCR layout: {dp_rt.layout()}; mesh predict vs one "
          f"card (16 pages, float32, {n_text} non-empty texts): "
          f"{json.dumps(report)}; K1 launches {k1['launches']}, by card "
          f"{k1['by_card']}")
    if not report["ok"]:
        raise AssertionError("phase 38: the mesh predict disagrees with "
                             "the one-card predict")
    if set(k1["by_card"]) != {d.index for d in dp_rt.data_devices}:
        raise AssertionError(f"phase 38: K1 did not launch on every card "
                             f"of the mesh ({k1['by_card']})")
    _, pps_one = timed_pps(single, pages, card, "float32, one card")
    _, pps_mesh = timed_pps(mesh, pages, card,
                            f"float32, mesh {dp_rt.mesh.shape}")
    print(f"phase 38 OCR pages/s: one card {pps_one!r}, mesh {pps_mesh!r} "
          f"({len(dp_rt.data_devices)} shards on "
          f"{len(set(dp_rt.data_devices))} card(s)); "
          f"{time.perf_counter() - t0!r} s  [{card}]")
    k1_cases = mesh_k1_cases(rec.seen, dp_rt.data_devices)
    del single, mesh, want, got
    torch.cuda.empty_cache()

    # --- GLM-OCR at n_model 2 against n_model 1 ---
    t0 = time.perf_counter()
    cfg = family_cfg("glmocr")
    base = GLMOCR(cfg=cfg, seed=0,
                  runtime=Runtime1("float32", device="cuda"))
    tp_rt = Runtime("float32", device="cuda", devices=spread(2),
                    cfg=RuntimeConfig(use_mesh=True,
                                      mesh=MeshConfig(n_model=2)))
    tp = GLMOCR(base.module.state_dict(), cfg=cfg, runtime=tp_rt)
    replays = tp.decode_path.startswith("graph")
    print(f"phase 38 GLM-OCR layout: {tp_rt.layout()}; "
          f"{sum(p.numel() for p in base.module.parameters())} parameters "
          f"(decoder {cfg.decoder.layers} layers of {cfg.decoder.hidden}); "
          f"decode: {tp.decode_path}")
    crop = np.ascontiguousarray(pages[0][:FAM_CROP, :FAM_CROP])
    tp_cards = list(dict.fromkeys(tp_rt.model_devices))
    weights = {str(d): sum(p.numel() * p.element_size()
                           for sh in tp.module.shards
                           for p in sh.parameters() if p.device == d)
               / 2 ** 20 for d in tp_cards}
    held = {d: torch.cuda.memory_allocated(d) for d in tp_cards}
    for d in tp_cards:
        torch.cuda.reset_peak_memory_stats(d)
    for k in kernels:
        k.reset_counts()
    text = tp.generate([crop], "ocr", max_new_tokens=MESH_NEW)
    torch.cuda.synchronize()
    launches = {"K2": K2.launches, "K3": K3.launches}
    cards_of = {"K2": by_card(K2), "K3": by_card(K3)}
    peak = {str(d): (torch.cuda.max_memory_allocated(d) - held[d]) / 2 ** 20
            for d in tp_cards}
    print(f"phase 38 GLM-OCR main path (generate, {MESH_NEW} tokens): "
          f"text {text[0][:24]!r}, launches {launches}, by card "
          f"{cards_of}; MiB by card: the shards' weights {weights}, the "
          f"generate's peak over what the card held before it {peak} "
          f"(held {({str(d): v / 2 ** 20 for d, v in held.items()})}, "
          f"the one-shard model and earlier phases' included)")
    model_cards = {d.index for d in tp_rt.model_devices}
    if any(set(c) != model_cards for c in cards_of.values()):
        raise AssertionError(f"phase 38: K2 or K3 did not launch on every "
                             f"model card ({cards_of})")
    ref = family_greedy(base, crop, "ocr", MESH_NEW)
    g = family_greedy(tp, crop, "ocr", MESH_NEW)
    scale = float(ref[1][0, 0].abs().max())
    err = float((g[1][0, 0] - ref[1][0, 0]).abs().max())
    gate = ids_gate("phase 38 GLM-OCR n_model 2", g[0], *ref)
    print(f"phase 38 GLM-OCR n_model 2 vs 1 ({FAM_CROP}x{FAM_CROP}, "
          f"{MESH_NEW} tokens): prefill logits max abs error {err!r} vs "
          f"max|logit| {scale!r} (gate 1e-3 x); ids {gate}")
    if not err <= 1e-3 * scale:
        raise AssertionError("phase 38: the n_model 2 prefill logits "
                             "disagree with n_model 1")
    bit_equal(f"phase 38 GLM-OCR n_model 2 ({tp.decode_path})", g,
              family_greedy(tp, crop, "ocr", MESH_NEW, graph=False))
    # K2 and K3 at the path's own shapes, on every model card
    tokens = tp._prepare_image(crop)[0].shape[0]
    prompt = tp._build_inputs([crop], "ocr")[3]
    for d in tp_cards:
        with torch.cuda.device(d):
            print(f"K2 and K3 at the n_model 2 path's shapes on {d} vs "
                  f"plain version:")
            run_cases(k2_d64_cases(tokens)[:1]
                      + tp_k3_cases((prompt, 1), cfg.decoder.hidden), card)
    ms = {"n_model 1": family_ms_per_token(base, crop, "ocr"),
          "n_model 2": family_ms_per_token(tp, crop, "ocr")}
    print(f"phase 38 GLM-OCR greedy decode ms/token on the crop (graph | "
          f"eager): n_model 1 {ms['n_model 1']['graph']!r} | "
          f"{ms['n_model 1']['eager']!r}; n_model 2 "
          f"{ms['n_model 2']['graph']!r} | {ms['n_model 2']['eager']!r} "
          f"(the graph column replays a graph: {replays}); "
          f"{time.perf_counter() - t0!r} s  [{card}]")
    del base, tp
    torch.cuda.empty_cache()
    return {"launches": {"K1": k1["launches"], **launches},
            "by_card": {"K1": k1["by_card"], **cards_of},
            "k1_cases": k1_cases}


def add_k1(k1, k1_c, cases, card: str, what: str) -> None:
    """Run K1 ``cases`` against the plain version and add them to K1's
    record."""
    print(f"K1 at {what} vs plain version:")
    rec = run_cases(cases, card)
    k1_c += cases
    k1["cases"] += rec["cases"]
    k1["max_abs_err"] = max(k1["max_abs_err"], rec["max_abs_err"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 2
    if not (REPO / "oar_ocr_tpu_torch").is_dir():
        print("chip_smoke: run it from the repository checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()

    def mark(what: str) -> None:
        print(f"[{time.perf_counter() - t_start:.1f} s] {what}", flush=True)

    mark("phase 1")
    # --- 1. the card ---
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    import cv2

    print(f"cv2 {cv2.__version__} imported")

    mark("phase 2")
    # --- 2. build ---
    from oar_ocr_tpu_torch.ops.cuda_build import build_all
    from oar_ocr_tpu_torch.ops.flash_attention import KERNEL as K2
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL_QK as K4
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1

    kernels = (K1, K2, K3, K4)
    t0 = time.perf_counter()
    built = build_all(kernels)
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0!r} s")
    for k, b in zip(kernels, built):
        print(f"  {k.source} -> {b.path.name} (nvcc {b.build_seconds!r} s)")
    check_kernels_built(kernels, built)
    check_tensor_cores(built[kernels.index(K2)].path)

    mark("phase 3")
    # --- 3. K1 vs plain ---
    print("K1 vs plain version:")
    k1_c = k1_cases()
    k1 = run_cases(k1_c, card)

    from oar_ocr_tpu_torch.models.layers import init_state_dict
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
    from oar_ocr_tpu_torch.ops.ctc import default_charset
    from oar_ocr_tpu_torch.runtime.weights import load_jax_checkpoint

    launches = {}
    mark("phase 4-6")
    # --- 4-6. the OCR path, and the recognizer fitted to drawn lines ---
    launches["ocr"], fitted = ocr_phases(card, kernels)
    torch.cuda.empty_cache()

    mark("phase 7-10")
    # --- 7-10. the VL path ---
    vl = vl_phases(card, kernels)
    torch.cuda.empty_cache()

    mark("phase 11-14")
    # --- 11-14. the HunyuanOCR path ---
    hy = hy_phases(card, kernels)
    torch.cuda.empty_cache()

    mark("phase 15-16")
    # --- 15-16. the document chain; seal and slow scoring. The unbiased
    # recognizer, so texts and word boxes are not empty ---
    det_state = load_jax_checkpoint(
        str(REPO / "assets" / "bench_det.safetensors"))
    rec_state = init_state_dict(SVTRRecognizer(2 + len(default_charset()),
                                               0.95),
                                torch.Generator().manual_seed(0))
    launches["doc_chain"], chain_inputs = chain_phase(card, det_state,
                                                      rec_state)
    add_k1(k1, k1_c, chain_k1_cases(chain_inputs), card,
           "the document chain's own inputs")
    del chain_inputs
    mark("phase 16: seal and slow score")
    seal_launches = seal_phase(card, det_state, rec_state)
    launches["seal"] = seal_launches["seal"]
    launches["slow_score"] = seal_launches["slow"]

    mark("phase 17-20")
    # --- 17-20. layout (RT-DETR-L, PicoDet-L) and OARStructure ---
    t0 = time.perf_counter()
    weights = layout_weights(make_pages(0))
    print(f"layout weights (calibrated on the CPU) in "
          f"{time.perf_counter() - t0!r} s")
    mark("phase 17: layout")
    launches["layout"], layout_inputs = layout_phase(card, weights)
    add_k1(k1, k1_c, chain_k1_cases(layout_inputs), card,
           "the layout models' own inputs")
    del layout_inputs
    mark("phase 18: layout, card vs CPU")
    layout_gpu_vs_cpu(weights)
    mark("phase 19: layout bfloat16")
    layout_bf16_vs_f32(card, weights)
    mark("phase 20: OARStructure")
    launches["structure"] = structure_phase(card, det_state, rec_state,
                                            weights)
    torch.cuda.empty_cache()

    mark("phase 22-26")
    # --- 22-26. tables: SLANet, SLANet_plus, SLANeXt, the analyzer and
    # OARStructure with tables on (its seal OCR on the fitted
    # recognizer) ---
    t0 = time.perf_counter()
    tpages, ttables = table_pages()
    tweights = table_weights(tpages, ttables)
    print(f"table weights (calibrated on the CPU) in "
          f"{time.perf_counter() - t0!r} s")
    bias_decoders(card, tweights, tpages, ttables)
    mark("phase 22: fit the SLANet head")
    fit_table_decoder(card, tweights, tpages, ttables)
    mark("phases 22-23: the table models")
    table_inputs = table_models_phase(card, tweights, tpages, ttables)
    add_k1(k1, k1_c, chain_k1_cases(table_inputs), card,
           "the table models' own inputs")
    del table_inputs
    mark("phase 24: SLANet bfloat16")
    table_bf16_phase(card, tweights, tpages, ttables)
    mark("phase 25: the table analyzer")
    launches["table_analyzer"], analyzer_inputs = analyzer_phase(
        card, tweights, tpages, ttables)
    mark("phase 26: OARStructure with tables")
    launches["structure_tables"], structure_inputs = structure_table_phase(
        card, det_state, fitted, weights["pp-doclayout_plus-l"], tweights,
        tpages)
    for what, seen in (("the table analyzer's", analyzer_inputs),
                       ("the structure predict's", structure_inputs)):
        add_k1(k1, k1_c, chain_k1_cases(seen), card, f"{what} own inputs")
    # the predictors (phase 33) run the table models on these weights
    pred_tables = {k: tweights[k] for k in ("slanet", "cls", "cell")}
    del analyzer_inputs, structure_inputs, tweights
    torch.cuda.empty_cache()

    mark("phase 27-30")
    # --- 27-30. formulas: the default recognizer, PP-FormulaNet-S/-L and
    # UniMERNet, OARStructure with formulas on, K1 at their inputs ---
    fstate = formula_weights()
    launches["formula"], formula_inputs = formula_phase(card, fstate)
    t0 = time.perf_counter()
    exact_inputs, s_state = formulanet_phase(card)
    formula_inputs.update(exact_inputs)
    t1 = time.perf_counter()
    (launches["structure_formulas"], structure_formula_inputs,
     structure_layout_inputs) = structure_formula_phase(
        card, det_state, rec_state, weights["pp-doclayout_plus-l"], fstate,
        s_state)
    print(f"phase 29 in {t1 - t0!r} s, phase 30 in "
          f"{time.perf_counter() - t1!r} s")
    formula_inputs.update(structure_formula_inputs)
    add_k1(k1, k1_c, formula_k1_cases(formula_inputs), card,
           "the formula models' own inputs")
    add_k1(k1, k1_c, chain_k1_cases(structure_layout_inputs), card,
           "the formula structure predict's own layout input")
    del formula_inputs, structure_formula_inputs, structure_layout_inputs
    del fstate, exact_inputs, s_state
    torch.cuda.empty_cache()

    mark("phase 31-34")
    # --- 31-34. the server OCR, the serving engine, the 11 predictors and
    # the CLI ---
    t0 = time.perf_counter()
    launches["server_ocr"], server_inputs = server_phase(card)
    add_k1(k1, k1_c, chain_k1_cases(server_inputs), card,
           "the server OCR's own det and rec inputs")
    del server_inputs
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    biased = dict(rec_state)
    biased["head.ctc_head.fc.bias"] = rec_state[
        "head.ctc_head.fc.bias"].clone()
    biased["head.ctc_head.fc.bias"][0] += 4.0       # phase 4's recognizer
    serving_phase(card, det_state, biased)
    t2 = time.perf_counter()
    predictors_phase(card, det_state, fitted, weights["pp-doclayout_plus-l"],
                     pred_tables)
    t3 = time.perf_counter()
    cli_phase(card)
    t4 = time.perf_counter()
    print(f"phases 31-34 in s: server OCR {t1 - t0!r}, serving "
          f"{t2 - t1!r}, predictors {t3 - t2!r}, CLI {t4 - t3!r}")

    mark("phase 35")
    # --- 35. upstream weights through the registry, PDF input,
    # visualization ---
    launches["registry_ocr"], pdf_inputs = registry_pdf_phase(
        card, det_state, fitted, weights["pp-doclayout_plus-l"], kernels)
    print(f"phase 35 in {time.perf_counter() - t4!r} s")
    add_k1(k1, k1_c, chain_k1_cases(pdf_inputs), card,
           "the PDF pages' own det and rec inputs")
    del pdf_inputs
    layout_plus = weights["pp-doclayout_plus-l"]
    del weights, pred_tables
    torch.cuda.empty_cache()

    mark("phase 36")
    # --- 36. speculative decoding and the VL families ---
    spec = spec_families_phase(card, kernels)
    torch.cuda.empty_cache()

    mark("phase 37")
    # --- 37. the exact VLMs, the HPD fork scheduler and DocParser ---
    exact = exact_phase(card, kernels, layout_plus)
    launches["docparser"] = exact["launches"]["K1"]
    del layout_plus
    torch.cuda.empty_cache()

    mark("phase 38")
    # --- 38. the mesh layer: data-parallel OCR, tensor-parallel GLM-OCR ---
    t0 = time.perf_counter()
    mesh = mesh_phase(card, kernels, det_state, fitted)
    mesh_k1_checks(k1, k1_c, mesh.pop("k1_cases"), card)
    print(f"phase 38 in {time.perf_counter() - t0!r} s")
    torch.cuda.empty_cache()

    mark("phase 21")
    # --- 21. device times, last ---
    print("kernel device times (median of 20 calls, each after an L2 "
          "flush, queued behind a spin; CUDA events):")
    # the launch floor: the device time of the smallest kernel there is,
    # a one-element zero_(), taken the same way
    one = torch.zeros(1, device="cuda")
    floor_ms = device_ms(one.zero_, "")
    print(f"  launch floor, one-element zero_(): device {floor_ms!r} ms  "
          f"[{card}]")
    # K2: flash_fma_kernel (float32) and flash_wgmma_kernel (bfloat16)
    # K2's cases also print device time over SDPA's, with their phase
    for rec, cases, symbol, phase in (
            (k1, k1_c, "normalize_kernel", None),
            (vl["K2"], vl["cases"]["K2"], "flash_", 7),
            (vl["K3"], vl["cases"]["K3"], "add_rmsnorm_kernel", None),
            (hy["K4"], hy["cases"], "qk_norm_rope_kernel", None),
            (spec["records"]["K2"], spec["cases"]["K2"], "flash_", 36),
            (spec["records"]["K3"], spec["cases"]["K3"],
             "add_rmsnorm_kernel", None),
            (spec["records"]["K4"], spec["cases"]["K4"],
             "qk_norm_rope_kernel", None),
            (exact["records"]["K2"], exact["cases"]["K2"], "flash_", 37),
            (exact["records"]["K3"], exact["cases"]["K3"],
             "add_rmsnorm_kernel", None),
            (exact["records"]["K4"], exact["cases"]["K4"],
             "qk_norm_rope_kernel", None)):
        for i, (name, kernel, *_rest, work) in enumerate(cases):
            bound_ms = rec["cases"][i]["bound_ms"]
            ms = device_ms(kernel, symbol, bound_ms=bound_ms)
            rec["cases"][i]["device_ms"] = ms
            if i == 0:
                rec["device_ms"] = ms
            line = f"  {name}: device {ms!r} ms"
            if symbol in ("add_rmsnorm_kernel", "qk_norm_rope_kernel"):
                line += (f" ({ms / floor_ms!r} x the launch floor, "
                         f"{floor_ms!r} ms)")
            if work.get("library") is not None:
                # every kernel the library call runs
                lib_ms = device_ms(work["library"], f"{name}: library",
                                   bound_ms=bound_ms)
                rec["cases"][i]["library_device_ms"] = lib_ms
                line += f", library device {lib_ms!r} ms"
                if phase is not None:
                    rec["cases"][i]["device_over_sdpa"] = ms / lib_ms
                    line += (f"; phase {phase}: device / SDPA device "
                             f"{ms / lib_ms!r}")
            print(f"{line}  [{card}]")
    hy_k2 = next(c for c in vl["K2"]["cases"] if c["name"].startswith(
        f"K2 (1, 16, {HY_VISION_TOKENS}, 72)") and c["name"].endswith(
        "bf16 tower view"))

    # launches: each main path's run (counts zeroed before, read after),
    # summed over the paths that run the kernel
    launches["mesh_ocr"] = mesh["launches"]["K1"]
    records = [
        (K1, k1, launches),
        (K2, vl["K2"], {"vl": vl["launches"]["K2"],
                        "hunyuan": hy["launches"]["K2"],
                        "speculative_families": spec["launches"]["K2"],
                        "exact_docparser": exact["launches"]["K2"],
                        "tp_glmocr": mesh["launches"]["K2"]}),
        (K3, vl["K3"], {"vl": vl["launches"]["K3"],
                        "hunyuan": hy["launches"]["K3"],
                        "speculative_families": spec["launches"]["K3"],
                        "exact_docparser": exact["launches"]["K3"],
                        "tp_glmocr": mesh["launches"]["K3"]}),
        (K4, hy["K4"], {"hunyuan": hy["launches"]["K4"],
                        "speculative_families": spec["launches"]["K4"],
                        "exact_docparser": exact["launches"]["K4"]})]
    print(f"chip_smoke: {time.perf_counter() - t_start!r} s in all")
    kernels_json = [{
        "name": k.name, "route": "cuda",
        "source": f"oar_ocr_tpu_torch/csrc/{k.source}",
        "replaces": k.replaces, "launches": sum(paths.values()),
        "launches_by_path": paths, "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "host_ms": rec["host_ms"],
        "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
        "mesh_launches_by_card": mesh["by_card"].get(label, {})}
        for label, (k, rec, paths) in zip(("K1", "K2", "K3", "K4"),
                                          records)]
    kernels_json[1]["bf16_hunyuan"] = {
        key: hy_k2[key] for key in ("name", "max_abs_err", "ms", "host_ms",
                                    "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms",
                                    "library_device_ms")}
    keys = ("name", "max_abs_err", "ms", "host_ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "device_over_sdpa")
    for i, tag, rec in (
            (1, "d64", spec["records"]["K2"]["cases"][0]),
            (1, "d80", exact["records"]["K2"]["cases"][0]),
            (1, "d80_crop", exact["records"]["K2"]["cases"][1]),
            (1, "glm_d128", next(
                rec for rec in exact["records"]["K2"]["cases"]
                if "GLM-OCR" in rec["name"])),
            (2, "mineru_prefill", exact["records"]["K3"]["cases"][0]),
            (2, "mineru_decode", exact["records"]["K3"]["cases"][1]),
            (3, "verify_device_slot", spec["records"]["K4"]["cases"][1]),
            (3, "per_row", exact["records"]["K4"]["cases"][0]),
            (3, "sdar_device_slot", exact["records"]["K4"]["cases"][1]),
            (3, "hpd_round_per_row", exact["records"]["K4"]["cases"][2]),
            (3, "sdar_block_device_slot",
             exact["records"]["K4"]["cases"][3])):
        kernels_json[i][tag] = {key: rec.get(key) for key in keys}
    kernels_json[1]["glm_tower"] = exact["glm_tower"]
    kernels_json[1]["hpd_d64"] = [
        {key: rec.get(key) for key in keys}
        for rec in exact["records"]["K2"]["cases"] if "HPD" in rec["name"]]
    kernels_json[1]["hpd_tower"] = exact["hpd_tower"]
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
