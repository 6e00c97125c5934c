"""The mesh layer on the card(s): every hand kernel on its tensor's card,
the NCCL all-reduce, and the data- and tensor-parallel paths against one
card.

The CPU side is held to the JAX package in ``test_torch_parallel.py`` and
``test_torch_parallel_tp.py``; this file imports only the port. Every
test needs a card and is marked ``cuda``; those that need two cards skip
below two. With one card the mesh runs two shards on it (a device list
that repeats ``cuda:0``), where the all-reduces are plain sums.

- K1-K4 on tensors on the last visible card against their plain
  versions on the CPU (K1, K3: float32 ≤ 1e-6; K2, K4: ≤ 2e-5), each
  launch counted on that card (``launches_by_device``).
- ``parallel.tp.all_reduce`` over the cards (NCCL) against the plain
  sum.
- ``OAROCR.predict`` over the mesh against one card (PERF.md §2's OCR
  gates: same regions, quad IoU ≥ 0.95, texts identical) and a
  small GLM-OCR's generate at ``n_model`` 2 against one card (identical
  ids, logits ≤ 1e-3 · max|logit|). Its tower has head dim 64, one the
  flash kernel is built for (the tiny config's 16 is not).
"""

import numpy as np
import pytest
import torch

from oar_ocr_tpu_torch.config.runtime import MeshConfig, RuntimeConfig
from oar_ocr_tpu_torch.runtime.runtime import Runtime

pytestmark = pytest.mark.cuda


def _cards(n: int = 1) -> list:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU form")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh_devices(n: int) -> list:
    """``n`` shards over the visible cards, one a card where there are
    enough, else all on card 0."""
    cards = _cards()
    return cards[:n] if len(cards) >= n else [cards[0]] * n


def _last() -> torch.device:
    return _cards()[-1]


def test_k1_on_last_card():
    from oar_ocr_tpu_torch.ops import normalize as k1

    dev = _last()
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (3, 40, 56, 3), dtype=np.uint8))
    alpha, beta = k1.coefficients((0.485, 0.456, 0.406),
                                  (0.229, 0.224, 0.225))
    before = k1.KERNEL.launches_by_device[dev.index]
    got = k1.normalize_masked(
        x.to(dev), alpha, beta, valid_h=torch.tensor([40, 30, 1], device=dev),
        valid_w=torch.tensor([56, 20, 1], device=dev), pad=-1.0, swap_rb=True)
    torch.cuda.synchronize(dev)
    assert got.device == dev
    assert k1.KERNEL.launches_by_device[dev.index] == before + 1
    ref = k1.normalize_ref(x, alpha, beta, swap_rb=True,
                           out_dtype=torch.float32,
                           valid_h=torch.tensor([40, 30, 1]),
                           valid_w=torch.tensor([56, 20, 1]), pad=-1.0)
    assert float((got.cpu() - ref).abs().max()) <= 1e-6


def test_k2_on_last_card():
    from oar_ocr_tpu_torch.ops import flash_attention as k2

    dev = _last()
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 4, 100, 64, generator=g) for _ in range(3))
    vl = torch.tensor([100, 61])
    before = k2.KERNEL.launches_by_device[dev.index]
    got = k2.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                             valid_len=vl.to(dev))
    torch.cuda.synchronize(dev)
    assert k2.KERNEL.launches_by_device[dev.index] == before + 1
    ref = k2.flash_attention_ref(q, k, v, valid_len=vl)
    assert float((got.cpu() - ref).abs().max()) <= 2e-5


def test_k3_on_last_card():
    """Both K3 paths (fewer rows than SMs, and more), on the SM count of
    the last card."""
    from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr

    dev = _last()
    g = torch.Generator().manual_seed(2)
    for rows in (3, 600):
        x, r = (torch.randn(rows, 1536, generator=g) for _ in range(2))
        w = torch.rand(1536, generator=g) + 0.5
        before = fnr.KERNEL.launches_by_device[dev.index]
        normed, total = fnr.fused_add_rmsnorm(x.to(dev), r.to(dev),
                                              w.to(dev))
        torch.cuda.synchronize(dev)
        assert fnr.KERNEL.launches_by_device[dev.index] == before + 1
        ref_n, ref_t = fnr.add_rmsnorm_ref(x, r, w, 1e-6)
        assert float((normed.cpu() - ref_n).abs().max()) <= 1e-5
        assert float((total.cpu() - ref_t).abs().max()) <= 1e-6


def test_k4_on_last_card():
    from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr

    dev = _last()
    g = torch.Generator().manual_seed(3)
    b, t, hq, hk, d, cap = 1, 5, 4, 2, 128, 16
    q = torch.randn(b, t, hq, d, generator=g)
    k = torch.randn(b, t, hk, d, generator=g)
    qs, ks = (torch.rand(d, generator=g) + 0.5 for _ in range(2))
    ang = torch.rand(b, t, d // 2, generator=g) * 6.0
    cos, sin = ang.cos(), ang.sin()
    slot = torch.tensor(7, dtype=torch.int64)
    k_out = torch.zeros(b, hk, cap, d)
    before = fnr.KERNEL_QK.launches_by_device[dev.index]
    k_dev = k_out.to(dev)
    got = fnr.fused_qk_norm_rope_qk(
        q.to(dev), k.to(dev), qs.to(dev), ks.to(dev), cos.to(dev),
        sin.to(dev), k_out=k_dev, slot=slot.to(dev))
    torch.cuda.synchronize(dev)
    assert fnr.KERNEL_QK.launches_by_device[dev.index] == before + 1
    ref = fnr.qk_norm_rope_qk_ref(q, k, qs, ks, cos, sin, k_out=k_out,
                                  slot=slot)
    assert float((got.cpu() - ref).abs().max()) <= 2e-5
    assert float((k_dev.cpu() - k_out).abs().max()) <= 2e-5


def test_nccl_all_reduce_matches_sum():
    from oar_ocr_tpu_torch.parallel.tp import all_reduce

    cards = _cards(2)
    g = torch.Generator().manual_seed(4)
    parts = [torch.randn(3, 1536, generator=g) for _ in cards]
    # two shards on card 0, one on each other card
    devs = [cards[0]] + cards
    parts = [parts[0] * 0.5] + [parts[0] * 0.5] + parts[1:]
    out = all_reduce([p.to(d) for p, d in zip(parts, devs)])
    torch.cuda.synchronize()
    want = torch.stack(parts).sum(0)
    for o, d in zip(out, devs):
        assert o.device == d
        assert float((o.cpu() - want).abs().max()) <= 1e-5


def test_named_card_leads_the_mesh():
    """``cuda:1`` leads the mesh it asks for, or the one made by itself
    on a machine of several cards; a device list that does not start
    with it is refused."""
    from oar_ocr_tpu_torch.errors import ConfigError

    cards = _cards(2)
    for cfg in (RuntimeConfig(use_mesh=True), None):
        rt = Runtime("float32", device="cuda:1", cfg=cfg)
        assert rt.device == cards[1] and rt.data_devices[0] == cards[1]
        assert sorted(d.index for d in rt.data_devices) == list(
            range(len(cards)))
    with pytest.raises(ConfigError):
        Runtime("float32", device="cuda:1", devices=cards,
                cfg=RuntimeConfig(use_mesh=True))


def _ocr_pages(n: int = 4):
    """The JAX bench's flat pages (``chip_smoke.make_pages``): dark text
    blocks on white, 1280×960."""
    rng = np.random.default_rng(0)
    dims = [(700, 28), (420, 26), (180, 24), (760, 34), (260, 22)]
    pages = []
    for _ in range(n):
        img = np.full((1280, 960, 3), 255, np.uint8)
        for r in range(20):
            w, h = dims[r % len(dims)]
            img[40 + r * 60: 40 + r * 60 + h, 60:60 + w] = \
                rng.integers(0, 80)
        pages.append(img)
    return pages


@pytest.mark.parametrize("n_data", [2, 4])
def test_dp_predict_matches_one_card(n_data):
    """``OAROCR.predict`` over ``n_data`` shards (one a card where the
    cards suffice) against one card, on the trained det and the fitted
    recognizer: PERF.md §2's OCR gates (``utils/parity.compare_results``:
    same region counts, quad IoU ≥ 0.95, identical texts); K1 launched on
    every card of the mesh."""
    from pathlib import Path

    from safetensors.torch import load_file

    from oar_ocr_tpu_torch.ops import normalize as k1
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
    from oar_ocr_tpu_torch.runtime.weights import load_jax_checkpoint
    from oar_ocr_tpu_torch.utils.parity import compare_results

    devs = _mesh_devices(n_data)
    assets = Path(__file__).resolve().parents[1] / "assets"
    det = load_jax_checkpoint(str(assets / "bench_det.safetensors"))
    rec = load_file(str(assets / "fitted_rec.safetensors"))

    def build(rt):
        return (OAROCRBuilder("general").with_runtime(rt)
                .with_det_params(det).with_rec_params(rec)
                .with_batch_sizes(image=4, region=64).build())

    pages = _ocr_pages()
    want = build(Runtime("float32", cfg=RuntimeConfig(
        use_mesh=False))).predict(pages)
    rt = Runtime("float32", devices=devs, cfg=RuntimeConfig(use_mesh=True))
    assert rt.n_data == n_data
    k1.KERNEL.reset_counts()
    got = build(rt).predict(pages)
    assert set(k1.KERNEL.launches_by_device) == {d.index for d in devs}
    assert sum(len(r.regions) for r in want) >= 40
    report = compare_results(got, want)
    assert report["ok"], report


def test_tp_generate_matches_one_card():
    """A small GLM-OCR at ``n_model`` 2 (over two cards where there
    are two, else two shards on one card), its decode a CUDA graph,
    against one card: identical ids, every step's logits ≤ 1e-3 ·
    max|logit|; K2 and K3 launched on every model card; the graph
    against the same model's eager decode, bit for bit."""
    import dataclasses

    from oar_ocr_tpu_torch.ops import flash_attention as k2
    from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr
    from oar_ocr_tpu_torch.vl.families import (FAMILY_CONFIGS, GLMOCR,
                                               VisionConfig)

    devs = _mesh_devices(2)
    cfg = dataclasses.replace(FAMILY_CONFIGS["glmocr"].tiny(),
                              vision=VisionConfig(dim=128, layers=2,
                                                  heads=2))
    one = GLMOCR(cfg=cfg, seed=5, runtime=Runtime(
        "float32", cfg=RuntimeConfig(use_mesh=False)))
    rt = Runtime("float32", devices=devs, cfg=RuntimeConfig(
        use_mesh=True, mesh=MeshConfig(n_model=2)))
    tp = GLMOCR(one.module.state_dict(), cfg=cfg, runtime=rt)
    assert tp.decode_path == ("graph" if devs[0] == devs[1] else
                              "graph over 2 cards")
    img = np.random.default_rng(3).integers(0, 255, (48, 64, 3),
                                            dtype=np.uint8)
    e, p, vl, n = one._build_inputs([img], "ocr")
    want = []
    ids1 = one._generate_impl(e, p, vl, max_new=12, capacity=256,
                              step_logits=want)
    k2.KERNEL.reset_counts()
    fnr.KERNEL.reset_counts()
    te, tp_pos, tvl, _ = tp._build_inputs([img], "ocr")
    got = []
    ids2 = tp._generate_impl(te, tp_pos, tvl, max_new=12, capacity=256,
                             step_logits=got)
    torch.cuda.synchronize()
    assert ids1.cpu().tolist() == ids2.cpu().tolist()
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())
    for kernel in (k2.KERNEL, fnr.KERNEL):
        assert set(kernel.launches_by_device) == {d.index for d in devs}
    assert any(st.graph is not None
               for st in tp.decode_graphs.states.values())
    eager = []
    ids3 = tp._generate_impl(te, tp_pos, tvl, max_new=12, capacity=256,
                             step_logits=eager, graph=False)
    assert ids3.cpu().tolist() == ids2.cpu().tolist()
    for g, e_ in zip(got, eager):
        assert torch.equal(g.cpu().view(torch.int32),
                           e_.cpu().view(torch.int32))
