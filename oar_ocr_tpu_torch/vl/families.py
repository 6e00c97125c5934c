"""The VLM family lineup over the shared decoder.

Counterpart of ``oar_ocr_tpu/vl/families.py``: each family is a config,
the shared vision tower and projector, the shared decoder
(``vl/decoder.py``) and generation harness (:class:`VLMFamily`), and its
own decode mechanism:

| Family            | Mechanism here                                        |
|-------------------|-------------------------------------------------------|
| HunyuanOCR        | XDRoPE decoder + DFlash block-draft speculation       |
| GLM-OCR           | MTP recurrent draft layer + one verify pass           |
| MinerU2.5         | MRoPE decoder, two-step layout → extraction           |
| MinerU-Diffusion  | SDAR block-diffusion decode (``vl/diffusion.py``)     |
| HPD-Parsing       | ``<FORK>`` children continued from the parent's KV    |
| OvisOCR2          | hybrid gated-delta + full-attention layers            |
| MonkeyOCRv2       | task prompts: end2end / layout / table (OTSL) / …     |

Module names are the flax ones (``vision.VisionBlock_0.qkv``,
``lm.layer0.q``, ``vp1``, ``mtp.draft_emb``, ``dflash.layers.0.…``), so
a JAX parameter tree converts by ``runtime/weights.params_from_jax``.

Kernels: every vision block's attention runs the flash kernel (K2,
``ops/flash_attention.py``; head dim 64 in every family) with the count
of valid patches as ``valid_len``; the JAX block switches to its Pallas
kernel only above 8192 tokens and uses plain SDPA with the same key mask
below (``families.py:49-88``): the valid patches are a prefix, so both
compute the same function. The decoders run K3 at every residual norm
(``vl/decoder.py``). The image preprocess stays on the host (numpy and
``cv2``), as in the JAX package.

Dtypes: under a bfloat16 Runtime the vision tower and projector compute
in bfloat16 and the decoder, its KV cache and the logits stay float32,
the policy of the port's other VL models (``model.apply_dtype_policy``).
The JAX families cast the fused embeddings to the compute dtype instead;
the two agree in float32, where the tests hold them.

Control flow follows the JAX package: the greedy decode is the step of
``vl/decode_graph.py`` (one CUDA graph per (batch, KV capacity, dtype),
replayed per token on the card, the prefill eager) and reads the ids
once; the MTP and DFlash rounds (``families.py:489, 584``, one jit each,
DFlash's per page bucket) run on the static buffers of one (batch, KV
capacity, dtype) key and replay as two CUDA graphs on the card
(``vl/decode_graph.SpecRounds``), the host reading the accept count once
a round (``families.py:570-580, 677-690``); SDAR's trial and commit
passes replay as two CUDA graphs of one (block length, capacity, dtype)
key (``vl/diffusion.DiffusionBlocks``), the host reading each unmask
step's tokens as there; HPD's parent and children decode through the
decode graph, the children at per-row slots, and the host reads the
parent's ids as there.

Under a Runtime with ``n_model`` > 1 (``parallel/tp.py``) the family's
module is one :class:`FamilyModule` a ``model`` shard, run in lockstep
by :class:`TensorParallelFamily`: the towers' MLPs and the decoder
split by the JAX package's rules (``families.py:402``,
``put_params_vl``), the all-reduces explicit. Only the greedy
``generate`` has this form yet; the speculative rounds, SDAR, HPD's
forks and OvisOCR2's delta layers raise ``ConfigError`` there.

Four published configs (hunyuanocr, glmocr, mineru, mineru_diffusion)
have head_dim 128 with rope sections that cover 32 of its 64 frequency
pairs; the JAX package fails to broadcast their rotary in the first
forward, and the port raises ``ConfigError`` at construction
(``decoder.check_rope_sections``). They run with sections that cover
head_dim / 2, given in the config.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..errors import ConfigError, InvalidInputError
from ..models.layers import init_state_dict
from ..ops.flash_attention import flash_attention
from ..runtime.runtime import Runtime
from ..utils.tracing import stage_timer
from .attention import (combine_masks, create_causal_mask,
                        create_left_padding_mask)
from .decode_graph import DecodeGraphs, RoundState, SpecRounds
from .decoder import (CausalLM, DecoderConfig, TensorParallelLM,
                      check_rope_sections)
from .dflash import DFlashConfig, DFlashDraft, check_draft_fits
from .diffusion import BlockState, DiffusionBlocks
from .kv_cache import KVCache, decoder_cache_capacity
from .model import ByteTokenizer, _mrope_positions, apply_dtype_policy
from .paddleocr_vl import ErnieMlp
from .paged_kv import PagedKVCache
from .processing import (VisionProcessorConfig, clamp_to_max_image_size,
                         smart_resize, smart_resize_token_limited)
from .speculative import verify_draft

_LN_EPS = 1e-6   # flax LayerNorm's default


class VisionBlock(nn.Module):
    """Pre-LN ViT block shared by the family towers (``families.py:49-88``)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.SwiGLU_0 = ErnieMlp(dim, 4 * dim)

    def attend(self, x: torch.Tensor, valid_len: torch.Tensor):
        """x + the attention block (K2, every head: ``qkv`` is not a
        tensor-parallel name, so each ``model`` shard attends in full)."""
        b, t, d = x.shape
        q, k, v = self.qkv(self.LayerNorm_0(x)).chunk(3, dim=-1)

        def heads(y):
            return y.view(b, t, self.heads, d // self.heads).transpose(1, 2)

        o = flash_attention(heads(q), heads(k), heads(v), valid_len=valid_len)
        return x + self.proj(o.transpose(1, 2).reshape(b, t, d))

    def mlp(self, x: torch.Tensor):
        """The MLP branch: a shard's partial ``down_proj`` under tensor
        parallelism (its gate/up/down match the rules)."""
        return self.SwiGLU_0(self.LayerNorm_1(x))

    def forward(self, x: torch.Tensor, valid_len: torch.Tensor):
        x = self.attend(x, valid_len)
        return x + self.mlp(x)


@dataclass(frozen=True)
class VisionConfig:
    dim: int = 1024
    layers: int = 24
    heads: int = 16
    patch: int = 14
    merge: int = 2

    def tiny(self) -> "VisionConfig":
        return dataclasses.replace(self, dim=64, layers=2, heads=4)


@dataclass(frozen=True)
class FamilyConfig:
    """``families.py:105-143``, field for field."""

    name: str
    decoder: DecoderConfig
    vision: VisionConfig
    tasks: Tuple[str, ...] = ("ocr",)
    prompt_templates: Optional[Dict[str, str]] = None
    min_pixels: Optional[int] = None
    max_pixels: Optional[int] = None
    task_min_pixels: Optional[Dict[str, int]] = None
    img_max_tokens: Optional[int] = None
    max_image_size: Optional[int] = None
    draft_len: int = 0              # speculation block size (0 = greedy)
    dflash: Optional[DFlashConfig] = None
    diffusion_block: int = 0        # SDAR block length (0 = AR)
    fork_token: str = "<FORK>"
    max_active_branches: int = 64

    def tiny(self) -> "FamilyConfig":
        return dataclasses.replace(
            self, decoder=self.decoder.tiny(),
            vision=self.vision.tiny(),
            dflash=None if self.dflash is None else self.dflash.tiny(
                vocab_size=256, hidden=64, heads=4, kv_heads=2, head_dim=16))


# Official OvisOCR2 instruction — the leading newline is part of the
# prompt (ovisocr2/model.rs:20 DEFAULT_PROMPT; docs/usage.md:397-404).
OVIS_OCR2_PROMPT = (
    "\nExtract all readable content from the image in natural human "
    "reading order and output the result as a single Markdown document. "
    "For charts or images, represent them using an HTML image tag: "
    '<img src="images/bbox_{left}_{top}_{right}_{bottom}.jpg" />, where '
    "left, top, right, bottom are bounding box coordinates scaled to "
    "[0, 1000). Format formulas as LaTeX. Format tables as HTML: "
    "<table>...</table>. Transcribe all other text as standard Markdown. "
    "Preserve the original text without translation or paraphrasing.")


FAMILY_CONFIGS: Dict[str, FamilyConfig] = {
    "hunyuanocr": FamilyConfig(
        "hunyuanocr",
        DecoderConfig(vocab_size=128000, hidden=2048, layers=24, heads=16,
                      kv_heads=4, ffn=6144, rope_kind="xdrope"),
        VisionConfig(), tasks=("ocr", "table", "formula"), draft_len=8,
        dflash=DFlashConfig(),
        min_pixels=32 * 32, max_pixels=16_777_216,
        img_max_tokens=4096, max_image_size=2048),
    "glmocr": FamilyConfig(
        "glmocr",
        DecoderConfig(vocab_size=151552, hidden=1536, layers=24, heads=12,
                      kv_heads=2, ffn=4608, rope_kind="mrope"),
        VisionConfig(), tasks=("ocr", "table", "formula"), draft_len=4),
    "mineru": FamilyConfig(
        "mineru",
        DecoderConfig(vocab_size=151936, hidden=1536, layers=28, heads=12,
                      kv_heads=2, ffn=8960, rope_kind="mrope"),
        VisionConfig(), tasks=("layout", "extract", "ocr", "table")),
    "mineru_diffusion": FamilyConfig(
        "mineru_diffusion",
        DecoderConfig(vocab_size=151936, hidden=2048, layers=24, heads=16,
                      kv_heads=2, ffn=8192, rope_kind="mrope"),
        VisionConfig(), tasks=("ocr",), diffusion_block=16,
        prompt_templates={"ocr": "\nText Recognition:"}),
    "hpd_parsing": FamilyConfig(
        "hpd_parsing",
        DecoderConfig(vocab_size=92553, hidden=1024, layers=24, heads=16,
                      kv_heads=8, ffn=4096, rope_kind="rope"),
        VisionConfig(patch=14, merge=1), tasks=("parse",), draft_len=6,
        prompt_templates={"parse": "document parsing with fork."}),
    "ovisocr2": FamilyConfig(
        "ovisocr2",
        DecoderConfig(vocab_size=151936, hidden=1024, layers=24, heads=16,
                      kv_heads=4, ffn=4096, rope_kind="rope",
                      layer_pattern=("delta", "delta", "delta", "attn")),
        VisionConfig(), tasks=("markdown",),
        prompt_templates={"markdown": OVIS_OCR2_PROMPT},
        min_pixels=448 * 448, max_pixels=2880 * 2880),
    "monkeyocrv2": FamilyConfig(
        "monkeyocrv2",
        DecoderConfig(vocab_size=151936, hidden=896, layers=24, heads=14,
                      kv_heads=2, ffn=4864, rope_kind="mrope"),
        VisionConfig(dim=384, layers=12, heads=6),
        tasks=("end2end", "layout", "text", "table", "formula"),
        prompt_templates={
            "layout": "Please output the categories and coordinates of "
                      "the document elements in reading order.",
            "end2end": "List the document elements in reading order, "
                       "including their categories, coordinates, and the "
                       "content of each element.",
            "text": "Please output the text content from the image.",
            "formula": "Please write out the expression of the formula in "
                       "the image using LaTeX format.",
            "table": "Please extract the table from the image and "
                     "represent it in OTSL format.",
        },
        task_min_pixels={"layout": 1_003_520}),
}


class VisionTower(nn.Module):
    """Patch embedding + ViT stack + final LayerNorm."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Linear(cfg.patch ** 2 * 3, cfg.dim)
        for i in range(cfg.layers):
            self.add_module(f"VisionBlock_{i}", VisionBlock(cfg.dim,
                                                            cfg.heads))
        self.LayerNorm_0 = nn.LayerNorm(cfg.dim, eps=_LN_EPS)

    def forward(self, patches: torch.Tensor, valid: torch.Tensor):
        x = self.patch_embed(patches)
        vlen = valid.to(torch.int32).sum(-1, dtype=torch.int32)
        for i in range(self.cfg.layers):
            x = getattr(self, f"VisionBlock_{i}")(x, vlen)
        return self.LayerNorm_0(x)


class MTPDraftLayer(nn.Module):
    """One multi-token-prediction draft layer, rolled recurrently
    (``families.py:253-273``): (hidden, token) → (next hidden, logits)."""

    def __init__(self, hidden: int, vocab_size: int):
        super().__init__()
        self.hidden = hidden
        self.draft_emb = nn.Embedding(vocab_size, hidden)
        self.fuse = nn.Linear(2 * hidden, hidden)
        self.up = nn.Linear(hidden, 2 * hidden)
        self.mix = nn.Linear(hidden, hidden)
        self.draft_head = nn.Linear(hidden, vocab_size)

    def forward(self, h: torch.Tensor, tok: torch.Tensor):
        x = torch.cat([h, self.draft_emb(tok.long()).to(h.dtype)], -1)
        x = F.silu(self.fuse(x))
        x = x + self.mix(F.silu(self.up(x))[..., :self.hidden])
        return x, self.draft_head(x).float()


class FamilyModule(nn.Module):
    """Vision tower + merge projector + CausalLM (+ the draft) in one
    state_dict (``families.py:276-385``)."""

    def __init__(self, cfg: FamilyConfig):
        super().__init__()
        self.cfg = cfg
        check_rope_sections(cfg.decoder)
        m2 = cfg.vision.merge ** 2
        self.vision = VisionTower(cfg.vision)
        self.lm = CausalLM(cfg.decoder)
        self.vp1 = nn.Linear(m2 * cfg.vision.dim, cfg.decoder.hidden * 2)
        self.vp2 = nn.Linear(cfg.decoder.hidden * 2, cfg.decoder.hidden)
        if cfg.dflash is not None:
            check_draft_fits(cfg.dflash, cfg.decoder.hidden,
                             cfg.decoder.layers)
            self.dflash = DFlashDraft(cfg.dflash)
        elif cfg.draft_len > 0:
            self.mtp = MTPDraftLayer(cfg.decoder.hidden,
                                     cfg.decoder.vocab_size)

    def encode_vision(self, patches, valid):
        return self.project(self.vision(patches, valid))

    def project(self, x):
        """The merge projector over the tower's output."""
        m2 = self.cfg.vision.merge ** 2
        b, t, d = x.shape
        if m2 > 1:
            x = x.reshape(b, t // m2, m2 * d)
        return self.vp2(F.gelu(self.vp1(x), approximate="tanh"))

    def aux_taps(self) -> Tuple[int, ...]:
        """The DFlash config's 0-based ids as 1-based post-layer taps."""
        return tuple(i + 1 for i in self.cfg.dflash.target_layer_ids)

    def dflash_proposals(self, bonus_tok, ctx: PagedKVCache, n_pages: int,
                         start):
        """[bonus, mask × (block − 1)] through the draft, rows 1..
        through the target's LM head → drafts (B, block − 1) int32
        (``families.py:350-364``)."""
        d = self.cfg.dflash
        b = bonus_tok.shape[0]
        mask_ids = torch.full((b, d.block_size - 1), d.mask_token_id,
                              dtype=torch.int64, device=bonus_tok.device)
        q_ids = torch.cat([bonus_tok.long()[:, None], mask_ids], dim=1)
        hidden = self.dflash.draft_hidden(self.lm.embed_tokens(q_ids), ctx,
                                          n_pages, start)
        return self.lm.logits_for(hidden[:, 1:]).argmax(-1).to(torch.int32)


class TensorParallelFamily:
    """A :class:`FamilyModule` over one shard a ``model`` device
    (``Runtime.put_params_vl``): the tower's blocks in lockstep, each
    shard attending in full and running its MLP columns, the partial
    ``down_proj`` all-reduced (the JAX ``SwiGLU`` matches the rules in
    the towers too); the projector on shard 0; the decoder as
    :class:`~oar_ocr_tpu_torch.vl.decoder.TensorParallelLM`."""

    def __init__(self, shards):
        from ..parallel.mesh import on_device
        from ..parallel.tp import all_reduce, broadcast

        self._on, self._reduce, self._broadcast = (on_device, all_reduce,
                                                   broadcast)
        self.shards = list(shards)
        self.cfg = self.shards[0].cfg
        self.lm = TensorParallelLM([sh.lm for sh in self.shards])
        self.devices = self.lm.devices

    def encode_vision(self, patches, valid):
        towers = [sh.vision for sh in self.shards]
        devs = self.devices
        xs, vls = [], []
        for tower, p, v, d in zip(towers, self._broadcast(patches, devs),
                                  self._broadcast(valid, devs), devs):
            with self._on(d):
                xs.append(tower.patch_embed(p))
                vls.append(v.to(torch.int32).sum(-1, dtype=torch.int32))
        for i in range(self.cfg.vision.layers):
            blocks = [getattr(t, f"VisionBlock_{i}") for t in towers]
            parts = []
            for s, (blk, d) in enumerate(zip(blocks, devs)):
                with self._on(d):
                    xs[s] = blk.attend(xs[s], vls[s])
                    parts.append(blk.mlp(xs[s]))
            xs = [x + m for x, m in zip(xs, self._reduce(parts))]
        return self.shards[0].project(towers[0].LayerNorm_0(xs[0]))


class VLMFamily:
    """The generation harness every family shares.

    ``state_dict`` holds the weights under the flax names
    (``params_from_jax`` of the JAX tree); without one they are seeded
    random, made on the runtime's device from ``seed``.
    """

    IMAGE_PAD_ID = 3
    IMAGE_START_ID = 4
    IMAGE_END_ID = 5

    def __init__(self, cfg: FamilyConfig, state_dict=None, *, tokenizer=None,
                 runtime: Optional[Runtime] = None, seed: int = 0):
        self.cfg = cfg
        self.runtime = runtime or Runtime()
        self.tokenizer = tokenizer or ByteTokenizer()
        dev = self.runtime.device
        with torch.device("meta"):
            net = FamilyModule(cfg)
        if state_dict is None:
            state_dict = init_state_dict(
                net, torch.Generator(device=dev).manual_seed(seed))
        net.load_state_dict(state_dict, strict=True, assign=True)
        self.module = apply_dtype_policy(net, dev,
                                         self.runtime.compute_dtype,
                                         vision=("vision", "vp1", "vp2"))
        # tensor parallelism over the runtime's ``model`` axis
        # (``families.py:402``): one module a shard, run in lockstep
        shards = self.runtime.put_params_vl(self.module)
        make_cache = None
        if len(shards) > 1:
            self.module = TensorParallelFamily(shards)
            make_cache = self.module.lm.new_cache
        # the greedy decode: one graph per (batch, capacity, dtype), the
        # delta state static
        self.decode_graphs = DecodeGraphs(
            self._decode_step, cfg.decoder, axes=3,
            states=lambda b, d: (self.module.lm.empty_delta_state(b, d),),
            make_cache=make_cache)
        # the speculative rounds: DFlash where the config has a draft,
        # else MTP
        self.spec_rounds = (
            SpecRounds(self._dflash_draft_half, self._dflash_verify_half)
            if cfg.dflash is not None else
            SpecRounds(self._mtp_draft_half, self._mtp_verify_half))

    @property
    def tensor_parallel(self) -> bool:
        return isinstance(self.module, TensorParallelFamily)

    @property
    def decode_path(self) -> str:
        """How the greedy decode runs on the card, fixed by the layout: a
        CUDA graph a step, on one card or over every card the ``model``
        shards span (``decode_graph.forked``)."""
        if self.tensor_parallel and not self.module.lm.single_device:
            return f"graph over {len(set(self.module.devices))} cards"
        return "graph"

    def _single_shard(self, what: str) -> None:
        """``what`` has no tensor-parallel form yet."""
        if self.tensor_parallel:
            raise ConfigError(f"{what} runs on one model shard; tensor "
                              "parallelism covers the greedy generate",
                              family=self.cfg.name,
                              n_model=len(self.module.shards))

    # ------------------------------ inputs ------------------------------
    def _prepare_image(self, image: np.ndarray,
                       min_pixels: Optional[int] = None):
        """smart_resize (or HunyuanOCR V1's token-capped resize) and
        patchify on the host (``families.py:697-735``) → ((T, p·p·3)
        float32 patches, (gh, gw))."""
        import cv2

        v = self.cfg.vision
        kw = {}
        if min_pixels is not None or self.cfg.min_pixels is not None:
            kw["min_pixels"] = (min_pixels if min_pixels is not None
                                else self.cfg.min_pixels)
        if self.cfg.max_pixels is not None:
            kw["max_pixels"] = self.cfg.max_pixels
        pcfg = VisionProcessorConfig(patch_size=v.patch, merge_size=v.merge,
                                     **kw)
        h, w = image.shape[:2]
        if self.cfg.img_max_tokens is not None:
            th, tw = smart_resize_token_limited(h, w, pcfg,
                                                self.cfg.img_max_tokens)
            if self.cfg.max_image_size is not None:
                th, tw = clamp_to_max_image_size(th, tw, pcfg.factor,
                                                 self.cfg.max_image_size)
        else:
            th, tw = smart_resize(h, w, pcfg)
        resized = cv2.resize(image, (tw, th), interpolation=cv2.INTER_LINEAR)
        x = (resized.astype(np.float32) / 255.0 - 0.5) / 0.5
        p, m = v.patch, v.merge
        gh, gw = th // p, tw // p
        if m > 1:
            x = x.reshape(gh // m, m, p, gw // m, m, p, 3)
            x = x.transpose(0, 3, 1, 4, 2, 5, 6)
        else:
            x = x.reshape(gh, p, gw, p, 3).transpose(0, 2, 1, 3, 4)
        return x.reshape(gh * gw, p * p * 3), (gh, gw)

    def _prompt_for(self, task: str) -> str:
        if self.cfg.prompt_templates and task in self.cfg.prompt_templates:
            return self.cfg.prompt_templates[task]
        return f"{task}:"

    @torch.inference_mode()
    def _build_inputs(self, images, task, prompt: Optional[str] = None):
        """Vision on the device, prompts on the host, then the fused
        embeddings (``families.py:778-828``) → (embeds (B, L, hidden)
        float32, MRoPE positions (3, B, L) int32, valid lengths (B,)
        numpy, L)."""
        rt = self.runtime
        m2 = self.cfg.vision.merge ** 2
        task_min = (self.cfg.task_min_pixels or {}).get(task)
        prepared = [self._prepare_image(im, min_pixels=task_min)
                    for im in images]
        max_t = max(p.shape[0] for p, _ in prepared)
        max_t = ((max_t + m2 - 1) // m2) * m2
        b = len(images)
        pd = self.cfg.vision.patch ** 2 * 3
        batch = np.zeros((b, max_t, pd), np.float32)
        valid = np.zeros((b, max_t), bool)
        for i, (p, _) in enumerate(prepared):
            batch[i, :p.shape[0]] = p
            valid[i, :p.shape[0]] = True
        with stage_timer(f"vl[{self.cfg.name}].vision", batch=b,
                         tokens=max_t):
            img_embeds = self.module.encode_vision(
                rt.put(batch).to(rt.compute_dtype), rt.put(valid))

        instruction = prompt if prompt is not None \
            else self._prompt_for(task)
        rows = []
        for p, _ in prepared:
            n_tok = p.shape[0] // m2
            rows.append(self.tokenizer.encode("User: ")
                        + [self.IMAGE_START_ID]
                        + [self.IMAGE_PAD_ID] * n_tok
                        + [self.IMAGE_END_ID]
                        + self.tokenizer.encode(
                            f"{instruction}\nAssistant: "))
        max_len = max(len(r) for r in rows)
        ids = np.zeros((b, max_len), np.int64)
        valid_lengths = np.zeros((b,), np.int32)
        positions = np.zeros((3, b, max_len), np.int32)
        starts = np.zeros((b,), np.int64)
        counts = np.zeros((b,), np.int64)
        m = self.cfg.vision.merge
        for i, row in enumerate(rows):
            off = max_len - len(row)
            ids[i, off:] = row
            valid_lengths[i] = len(row)
            gh, gw = prepared[i][1]
            positions[:, i, :], (starts[i], counts[i]) = _mrope_positions(
                row, off, max_len, (gh // m, gw // m), self.IMAGE_PAD_ID)
        ids_t = rt.put(ids)
        embeds = self.module.lm.embed_tokens(ids_t)
        idx = torch.arange(max_len, device=ids_t.device)[None, :] \
            - rt.put(starts)[:, None]
        take = (idx >= 0) & (idx < rt.put(counts)[:, None])
        gathered = torch.gather(img_embeds, 1, idx.clamp(
            0, img_embeds.shape[1] - 1)[:, :, None].expand(
                -1, -1, img_embeds.shape[2]))
        embeds = torch.where(take[:, :, None], gathered.to(embeds.dtype),
                             embeds)
        return embeds, rt.put(positions), valid_lengths, max_len

    def _new_cache(self, embeds, valid_lengths, capacity: int,
                   cache: Optional[KVCache] = None):
        """A KV cache of ``capacity`` slots (``cache``, emptied, when
        given) with each row's left-pad count, and the prefill's
        (B, 1, T, capacity) mask."""
        c = self.cfg.decoder
        b, t, _ = embeds.shape
        dev = embeds.device
        vl = torch.as_tensor(np.asarray(valid_lengths), dtype=torch.int32,
                             device=dev)
        if cache is None:
            cache = KVCache.create(c.layers, b, c.kv_heads, capacity,
                                   c.head_dim, dtype=embeds.dtype, device=dev)
        cache.reset(t - vl)
        full = combine_masks(create_causal_mask(t, dev),
                             create_left_padding_mask(vl, t))
        full = torch.cat([full.expand(b, 1, t, t),
                          torch.zeros((b, 1, t, capacity - t),
                                      dtype=torch.bool, device=dev)], dim=-1)
        return cache, full, vl

    # ---------------------------- generation ----------------------------
    def _decode_step(self, tok, positions, cache, slot, dstate):
        """The decode graph's step: the delta state written in place."""
        return self.module.lm.decode_step(tok, positions, cache, slot,
                                          dstate)[0]

    @torch.inference_mode()
    def _generate_impl(self, embeds, position_ids, valid_lengths, *,
                       max_new: int, capacity: int,
                       step_logits: Optional[List[torch.Tensor]] = None,
                       graph: bool = True) -> torch.Tensor:
        """Prefill into the static KV cache of this (batch, capacity,
        dtype), then greedy decode with EOS latched, no host sync
        (``families.py:449-486``): each step a replay of the key's CUDA
        graph on the card unless ``graph`` is False (the same step body,
        eagerly; the CPU always) → ids (B, max_new) int32, from
        max_new − 1 steps (the scan's last step chooses nothing that is
        kept). When ``step_logits`` is a list, the logits that chose each
        id are appended to it (the prefill's first)."""
        b, t, _ = embeds.shape
        st = self.decode_graphs.state(b, capacity, embeds.dtype,
                                      embeds.device)
        cache, full, vl = self._new_cache(embeds, valid_lengths, capacity,
                                          cache=st.cache)
        pm = torch.arange(t, device=embeds.device)[None, :] \
            >= (t - vl)[:, None]
        logits, _, dstate = self.module.lm.prefill(
            embeds, position_ids, cache, full, pad_mask=pm)
        cache.advance(t)
        st.start(logits.argmax(-1).to(torch.int32),
                 (position_ids.amax(dim=(0, 2)) + 1)[None, :, None],
                 slot=t, states=(dstate,))
        if step_logits is not None:
            step_logits.append(logits)
        ids = self.decode_graphs.decode(st, max(max_new - 1, 0), graph=graph,
                                        step_logits=step_logits)
        return torch.cat([ids, st.tok[:, None]], dim=1)

    def generate(self, images: Sequence[np.ndarray], task: Optional[str] = None,
                 *, max_new_tokens: int = 256,
                 prompt: Optional[str] = None) -> List[str]:
        """Greedy decode; ``prompt`` overrides the task's template
        verbatim."""
        task = task or self.cfg.tasks[0]
        if task not in self.cfg.tasks:
            raise InvalidInputError("unknown task for family",
                                    family=self.cfg.name, task=task,
                                    known=list(self.cfg.tasks))
        if not images:
            return []
        embeds, positions, valid_lengths, max_len = self._build_inputs(
            images, task, prompt=prompt)
        capacity = decoder_cache_capacity(max_len, max_new_tokens)
        with stage_timer(f"vl[{self.cfg.name}].generate",
                         batch=len(images), prompt=max_len):
            ids = self._generate_impl(embeds, positions, valid_lengths,
                                      max_new=max_new_tokens,
                                      capacity=capacity).cpu().numpy()
        return [self._detok(row) for row in ids]

    def _detok(self, row) -> str:
        row = list(map(int, row))
        if self.cfg.decoder.eos_id in row:
            row = row[:row.index(self.cfg.decoder.eos_id)]
        return self.tokenizer.decode(row)

    # ------------------- speculative generation (MTP) -------------------
    def _round_state(self, b: int, capacity: int, dtype: torch.dtype,
                     dev: torch.device) -> RoundState:
        """The round key (batch, capacity, dtype): the static target
        cache and, for DFlash, the draft's paged context (as many pages
        as the capacity holds), for MTP the last hidden state."""
        c, d = self.cfg.decoder, self.cfg.dflash

        def make():
            cache = KVCache.create(c.layers, b, c.kv_heads, capacity,
                                   c.head_dim, dtype=dtype, device=dev)
            if d is None:
                return RoundState(cache, self.cfg.draft_len, h=torch.zeros(
                    (b, c.hidden), dtype=torch.float32, device=dev))
            return RoundState(cache, d.block_size - 1, ctx=PagedKVCache.create(
                d.layers, b, d.kv_heads, -(-capacity // d.page_size),
                d.page_size, d.head_dim, dtype=dtype, device=dev))

        return self.spec_rounds.state((b, capacity, dtype), make)

    @torch.inference_mode()
    def _spec_start(self, embeds, positions, valid_lengths, capacity: int):
        """Prefill for the speculative paths into the static cache of
        this (batch, capacity, dtype) round key → (first token (B,)
        int32, normed hidden (B, T, hidden), cache, aux or None)."""
        b, t, _ = embeds.shape
        st = self._round_state(b, capacity, embeds.dtype, embeds.device)
        cache, full, _ = self._new_cache(embeds, valid_lengths, capacity,
                                         cache=st.cache)
        if self.cfg.dflash is not None:
            logits, hidden, aux = self.module.lm.prefill_aux(
                embeds, positions, cache, full, self.module.aux_taps())
        else:
            logits, hidden, _ = self.module.lm.prefill(embeds, positions,
                                                       cache, full)
            aux = None
        cache.advance(t)
        return logits.argmax(-1).to(torch.int32), hidden, cache, aux

    @torch.inference_mode()
    def mtp_draft(self, h: torch.Tensor, tok: torch.Tensor,
                  k: int) -> torch.Tensor:
        """The MTP round's draft half: the draft layer rolled ``k`` times
        from the last hidden state → drafts (B, k) int32."""
        drafts = []
        for _ in range(k):
            h, logits = self.module.mtp(h, tok)
            tok = logits.argmax(-1).to(torch.int32)
            drafts.append(tok)
        return torch.stack(drafts, dim=1)

    def _mtp_verify(self, tok, drafts, cache: KVCache, cpos: torch.Tensor,
                    wpos):
        """One causal target pass over [tok, drafts] at slot ``wpos`` (an
        int or a 0-d device slot), the cache trimmed to
        wpos + 1 + accepted, all on the device (``families.py:503-535``)
        → (emitted (B, k+1), accepted (B,), next hidden (B, hidden), next
        token (B,), the verify's logits)."""
        b, k = drafts.shape
        block = torch.cat([tok[:, None], drafts.to(torch.int32)], dim=1)
        pos_ids = (cpos[None, :, None] + torch.arange(
            k + 1, device=tok.device)[None, None, :]).expand(3, b, k + 1)
        logits, hidden = self.module.lm.decode_block(block, pos_ids, cache,
                                                     wpos)
        res = verify_draft(drafts, logits)
        a = res.accepted
        cache.trim_to(wpos + 1 + a[0])
        at = a.long()[:, None]
        h = hidden.gather(1, at[:, :, None].expand(b, 1, hidden.shape[-1]))
        return (res.next_tokens, a, h[:, 0].float(),
                res.next_tokens.gather(1, at)[:, 0], logits)

    @torch.inference_mode()
    def mtp_verify(self, tok, drafts, cache: KVCache, cpos: torch.Tensor,
                   wpos: int):
        """The MTP round's verify half alone, with its own read of the
        accept count → (emitted (B, k+1), accepted, next hidden
        (B, hidden), next token (B,))."""
        emitted, a, h, nxt, _ = self._mtp_verify(tok, drafts, cache, cpos,
                                                 wpos)
        return emitted, int(a[0]), h, nxt

    def _mtp_draft_half(self, st: RoundState, _bucket) -> None:
        st.drafts.copy_(self.mtp_draft(st.h, st.tok, st.k))

    def _mtp_verify_half(self, st: RoundState) -> torch.Tensor:
        emitted, a, h, nxt, logits = self._mtp_verify(
            st.tok, st.drafts, st.cache, st.cpos, st.wpos)
        st.h.copy_(h)
        st.commit(emitted, a, nxt)
        return logits

    def generate_speculative(self, images: Sequence[np.ndarray],
                             task: Optional[str] = None, *,
                             max_new_tokens: int = 256,
                             rounds: Optional[List[int]] = None
                             ) -> List[str]:
        """Greedy-exact speculative decoding, batch 1 per image: the MTP
        draft, or DFlash where the config has one; a family without a
        draft decodes greedily (``families.py:537-580``). ``rounds``, when
        a list, receives each round's accept count; on the card the
        rounds replay their graphs."""
        self._single_shard("speculative decoding")
        if self.cfg.draft_len <= 0:
            return self.generate(images, task, max_new_tokens=max_new_tokens)
        task = task or self.cfg.tasks[0]
        decode = (self.decode_dflash if self.cfg.dflash is not None
                  else self.decode_mtp)
        out: List[str] = []
        for image in images:
            embeds, positions, valid_lengths, _ = self._build_inputs(
                [image], task)
            ids = decode(embeds, positions, valid_lengths,
                         max_new=max_new_tokens, rounds=rounds)
            out.append(self._detok(ids))
        return out

    @torch.inference_mode()
    def mtp_start(self, embeds, positions, valid_lengths, *,
                  max_new: int) -> RoundState:
        """Prefill into the round key's static buffers and load the first
        round's inputs (the last hidden state, each row's next rotary
        position) → the key's state."""
        k = self.cfg.draft_len
        b, t, _ = embeds.shape
        capacity = decoder_cache_capacity(t, max_new + k + 1)
        tok, hidden, _, _ = self._spec_start(embeds, positions,
                                             valid_lengths, capacity)
        st = self._round_state(b, capacity, embeds.dtype, embeds.device)
        st.h.copy_(hidden[:, -1].float())
        st.begin(tok, t, positions.amax(dim=(0, 2)) + 1)
        return st

    def decode_mtp(self, embeds, positions, valid_lengths, *, max_new: int,
                   rounds: Optional[List[int]] = None) -> List[int]:
        """Prefill and MTP rounds for one prompt → the emitted ids."""
        self._single_shard("speculative decoding")
        st = self.mtp_start(embeds, positions, valid_lengths,
                            max_new=max_new)
        return self.spec_rounds.decode(
            st, int(st.tok[0]), max_new, self.cfg.decoder.eos_id,
            rounds=rounds)

    # ------------------------ DFlash generation ------------------------
    def _dflash_verify(self, tok, drafts, cache: KVCache, ctx: PagedKVCache,
                       cpos: torch.Tensor, wpos):
        """The causal verify with the taps at slot ``wpos`` (an int or a
        0-d device slot), the cache rolled back and the verified rows'
        context appended to the draft's pages, all on the device
        (``families.py:597-617``) → (emitted, accepted (B,), next token,
        the verify's logits)."""
        d = self.cfg.dflash
        b = tok.shape[0]
        k = d.block_size - 1
        block = torch.cat([tok[:, None], drafts.to(torch.int32)], dim=1)
        pos_ids = (cpos[None, :, None] + torch.arange(
            k + 1, device=tok.device)[None, None, :]).expand(3, b, k + 1)
        logits, _, aux = self.module.lm.decode_block_aux(
            block, pos_ids, cache, wpos, self.module.aux_taps())
        res = verify_draft(drafts, logits)
        a = res.accepted
        cache.trim_to(wpos + 1 + a[0])
        ks, vs = self.module.dflash.context_rows(aux, wpos)
        for li in range(d.layers):
            ctx.append(li, ks[li], vs[li], wpos)
        ctx.trim_to(wpos + 1 + a[0])
        return (res.next_tokens, a,
                res.next_tokens.gather(1, a.long()[:, None])[:, 0], logits)

    @torch.inference_mode()
    def dflash_round(self, tok, cache: KVCache, ctx: PagedKVCache,
                     cpos: torch.Tensor, wpos: int, drafts: torch.Tensor):
        """A DFlash round's verify half given its ``drafts``
        (``families.py:597-617``), with its own read of the accept count
        → (emitted, accepted, next token)."""
        emitted, a, nxt, _ = self._dflash_verify(tok, drafts, cache, ctx,
                                                 cpos, wpos)
        return emitted, int(a[0]), nxt

    def _dflash_draft_half(self, st: RoundState, n_pages: int) -> None:
        st.drafts.copy_(self.module.dflash_proposals(st.tok, st.ctx,
                                                     n_pages, st.wpos))

    def _dflash_verify_half(self, st: RoundState) -> torch.Tensor:
        emitted, a, nxt, logits = self._dflash_verify(
            st.tok, st.drafts, st.cache, st.ctx, st.cpos, st.wpos)
        st.commit(emitted, a, nxt)
        return logits

    def dflash_bucket(self, st: RoundState) -> int:
        """The state's next page bucket (``families.py:677-679``)."""
        return st.ctx.bucket(st.at + self.cfg.dflash.block_size)

    @torch.inference_mode()
    def dflash_start(self, embeds, positions, valid_lengths, *,
                     max_new: int):
        """Prefill with the taps, and the draft's paged context primed
        with the prompt's rows, left-pad rows masked by ``ctx.pad``
        (``families.py:631-667``), into the round key's static buffers,
        which then hold the first round's inputs → (first token, cache,
        context)."""
        d = self.cfg.dflash
        k = d.block_size - 1
        b, t, _ = embeds.shape
        capacity = decoder_cache_capacity(t, max_new + k + 1)
        tok, _, cache, aux = self._spec_start(embeds, positions,
                                              valid_lengths, capacity)
        st = self._round_state(b, capacity, embeds.dtype, embeds.device)
        ctx = st.ctx.reset(t + max_new + k + 1)
        ctx.pad.copy_(cache.pad)
        ks, vs = self.module.dflash.context_rows(aux, 0)
        for li in range(d.layers):
            ctx.append(li, ks[li], vs[li], 0)
        ctx.advance(t)
        st.begin(tok, t, positions.amax(dim=(0, 2)) + 1)
        return tok, cache, ctx

    def decode_dflash(self, embeds, positions, valid_lengths, *,
                      max_new: int, rounds: Optional[List[int]] = None
                      ) -> List[int]:
        """Prefill and DFlash rounds for one prompt → the emitted ids."""
        self._single_shard("speculative decoding")
        tok, cache, _ = self.dflash_start(embeds, positions, valid_lengths,
                                          max_new=max_new)
        st = self._round_state(tok.shape[0], cache.capacity, embeds.dtype,
                               embeds.device)
        return self.spec_rounds.decode(
            st, int(tok[0]), max_new, self.cfg.decoder.eos_id,
            bucket=self.dflash_bucket, rounds=rounds)


# ----------------------- mechanism-bearing families -----------------------

class HunyuanOCR(VLMFamily):
    """XDRoPE decoder with the DFlash block draft
    (``generate_speculative``)."""

    def __init__(self, state_dict=None, *, tiny: bool = False,
                 cfg: Optional[FamilyConfig] = None, **kw):
        base = FAMILY_CONFIGS["hunyuanocr"]
        super().__init__(cfg or (base.tiny() if tiny else base), state_dict,
                         **kw)


class GLMOCR(VLMFamily):
    """MRoPE decoder + MTP recurrent-draft speculation."""

    def __init__(self, state_dict=None, *, tiny: bool = False,
                 cfg: Optional[FamilyConfig] = None, **kw):
        base = FAMILY_CONFIGS["glmocr"]
        super().__init__(cfg or (base.tiny() if tiny else base), state_dict,
                         **kw)


class MinerU(VLMFamily):
    """Qwen2-VL-style backbone with the two-step layout → extraction."""

    def __init__(self, state_dict=None, *, tiny: bool = False,
                 cfg: Optional[FamilyConfig] = None, **kw):
        base = FAMILY_CONFIGS["mineru"]
        super().__init__(cfg or (base.tiny() if tiny else base), state_dict,
                         **kw)

    def parse_two_step(self, image: np.ndarray, *,
                       max_new_tokens: int = 256):
        """Layout on the 1036² resize, then each block with its prompt
        (``vl/mineru_layout.run_two_step``) → the typed ContentBlocks."""
        from .mineru_layout import run_two_step

        return run_two_step(self, image, max_new_tokens=max_new_tokens)


class MinerUDiffusion(VLMFamily):
    """SDAR block diffusion (``families.py:309-393``): each block of L
    tokens is predicted in parallel, unmasked by confidence, then
    committed to the KV cache by one causal pass; the two passes run on
    one (block length, KV capacity, dtype) key's static buffers as CUDA
    graphs on the card (``vl/diffusion.DiffusionBlocks``), at the 0-d
    device slot ``wpos`` and the family's rotary positions ``cpos``."""

    MASK_TOKEN_OFFSET = 1   # vocab_size - 1 is the mask embedding id

    def __init__(self, state_dict=None, *, tiny: bool = False,
                 cfg: Optional[FamilyConfig] = None, **kw):
        base = FAMILY_CONFIGS["mineru_diffusion"]
        super().__init__(cfg or (base.tiny() if tiny else base), state_dict,
                         **kw)
        # one state per (block length, capacity, dtype)
        self.diffusion = DiffusionBlocks(self._trial_pass,
                                         self._commit_pass)

    def generate(self, images, task=None, *, max_new_tokens: int = 256,
                 num_unmask_steps: int = 4,
                 confidence_threshold: float = 0.9,
                 prompt: Optional[str] = None) -> List[str]:
        self._single_shard("block diffusion")
        task = task or self.cfg.tasks[0]
        out: List[str] = []
        for image in images:
            embeds, positions, valid_lengths, _ = self._build_inputs(
                [image], task, prompt=prompt)
            out.append(self._detok(self.decode_blocks(
                embeds, positions, valid_lengths,
                max_new=max_new_tokens, num_unmask_steps=num_unmask_steps,
                confidence_threshold=confidence_threshold)))
        return out

    def diffusion_state(self, capacity: int, dtype: torch.dtype,
                        dev: torch.device) -> BlockState:
        """The key's state: the static cache and the block's (3, 1, L)
        int32 positions."""
        c, L = self.cfg.decoder, self.cfg.diffusion_block

        def make():
            return BlockState(
                KVCache.create(c.layers, 1, c.kv_heads, capacity,
                               c.head_dim, dtype=dtype, device=dev),
                torch.zeros((3, 1, L), dtype=torch.int32, device=dev),
                c.vocab_size - self.MASK_TOKEN_OFFSET)

        return self.diffusion.state((L, capacity, dtype), make)

    def _trial_pass(self, st: BlockState, feed: torch.Tensor):
        return self.module.lm.decode_block_bidir(feed, st.positions,
                                                 st.cache, st.wpos)[0]

    def _commit_pass(self, st: BlockState) -> None:
        self.module.lm.decode_block(st.tokens, st.positions, st.cache,
                                    st.wpos)

    @torch.inference_mode()
    def decode_blocks(self, embeds, positions, valid_lengths, *,
                      max_new: int, num_unmask_steps: int = 4,
                      confidence_threshold: float = 0.9, graph: bool = True,
                      logits: Optional[List[torch.Tensor]] = None
                      ) -> List[int]:
        """One prompt's blocks → its ids, EOS appended: the prefill into
        the key's static cache, then the block loop (``families.py:
        915-949``), its passes replaying their graphs on the card unless
        ``graph`` is False. ``logits``, when a list, receives each
        trial's logits."""
        c = self.cfg.decoder
        L = self.cfg.diffusion_block
        t = embeds.shape[1]
        n_blocks = max(1, -(-max_new // L))
        capacity = decoder_cache_capacity(t, n_blocks * L + L)
        st = self.diffusion_state(capacity, embeds.dtype, embeds.device)
        cache, full, _ = self._new_cache(embeds, valid_lengths, capacity,
                                         cache=st.cache)
        self.module.lm.prefill(embeds, positions, cache, full)
        cache.advance(t)
        cpos = int(positions.max()) + 1
        st.begin(t, cpos + torch.arange(L, device=embeds.device),
                 confidence_threshold)
        ids = self.diffusion.decode(st, n_blocks, num_unmask_steps,
                                    c.eos_id, graph=graph, logits=logits)
        return ids + [c.eos_id]


class HPDParsing(VLMFamily):
    """Parent pass, then the ``<FORK>`` children continued from the
    parent's KV through each fork point, one batch of per-row lengths and
    positions (``families.py:396-519``)."""

    def __init__(self, state_dict=None, *, tiny: bool = False,
                 cfg: Optional[FamilyConfig] = None, **kw):
        base = FAMILY_CONFIGS["hpd_parsing"]
        super().__init__(cfg or (base.tiny() if tiny else base), state_dict,
                         **kw)

    def parse_with_forks(self, image: np.ndarray, *,
                         max_new_tokens: int = 128,
                         max_children: Optional[int] = None) -> Dict:
        """The parent's greedy decode, then its children's, each through
        :meth:`_decode_from_cache` (CUDA graphs on the card)."""
        self._single_shard("the forked children")
        c = self.cfg.decoder
        embeds, positions, valid_lengths, t = self._build_inputs(
            [image], "parse")
        capacity = decoder_cache_capacity(t, max_new_tokens + 1)
        with torch.inference_mode():
            # the prefill goes straight into the parent key's static cache
            st = self.decode_graphs.state(1, capacity, embeds.dtype,
                                          embeds.device)
            cache, full, _ = self._new_cache(embeds, valid_lengths, capacity,
                                             cache=st.cache)
            logits, _, _ = self.module.lm.prefill(embeds, positions, cache,
                                                  full)
            cache.advance(t)
        first = logits.argmax(-1).to(torch.int32)
        npos = int(positions.max()) + 1
        parent_ids, parent_cache = self._decode_from_cache(
            first, cache, npos, t, max_new_tokens)
        parent = self._detok(parent_ids[0].tolist())

        forks = _fork_points(parent_ids[0].tolist(),
                             self.tokenizer.encode(self.cfg.fork_token))
        forks = forks[:max_children or self.cfg.max_active_branches]
        children: List[str] = []
        child_ids = None
        if forks:
            n = len(forks)
            ends = [end for end, _ in forks]
            child_cache = parent_cache.keep_indices([0] * n)
            child_cache.with_lengths([t + e for e in ends])
            dev = self.runtime.device
            child_ids, _ = self._decode_from_cache(
                torch.tensor([tok for _, tok in forks], dtype=torch.int32,
                             device=dev),
                child_cache,
                torch.tensor([npos + e for e in ends], device=dev),
                torch.tensor([t + e for e in ends], device=dev),
                max_new_tokens)
            children = [self._detok(row.tolist()) for row in child_ids]
        return {"parent": parent, "children": children,
                "stats": {"prefix_len": int(t),
                          "parent_tokens": sum(
                              1 for i in parent_ids[0].tolist()
                              if i != c.eos_id),
                          "num_children": len(children),
                          "child_tokens": sum(
                              sum(1 for i in row.tolist() if i != c.eos_id)
                              for row in child_ids) if forks else 0}}

    @torch.inference_mode()
    def _decode_from_cache(self, first_tok, cache: KVCache, npos, wpos,
                           max_new: int,
                           step_logits: Optional[List[torch.Tensor]] = None,
                           graph: bool = True):
        """Greedy decode of ``max_new`` steps continuing ``cache`` (B rows)
        → (ids (B, max_new) numpy, the key's cache after them), the JAX
        ``lax.scan`` (``families.py:1041-1081``) as the decode graph's step
        (``vl/decode_graph.py``): ``npos``/``wpos`` an int (the parent, at
        the 0-d device slot) or per-row (B,) tensors (children at their
        own depths, a per-row key's (B,) slot vector). ``cache`` is loaded
        into the key's static cache unless it is that cache. On a CUDA
        tensor each step replays the key's graph unless ``graph`` is
        False; the ids are read once. When ``step_logits`` is a list,
        each step's logits are appended to it (step i's chose id i + 1;
        after a replay, a copy of the graph's output)."""
        b = first_tok.shape[0]
        dev = first_tok.device
        per_row = isinstance(wpos, torch.Tensor) and wpos.ndim == 1
        st = self.decode_graphs.state(b, cache.capacity, cache.k.dtype, dev,
                                      per_row=per_row)
        cache.pad_into(st.cache)
        npos_v = torch.as_tensor(npos, device=dev).to(torch.int64).expand(b)
        st.start(first_tok, npos_v[None, :, None].expand(3, b, 1),
                 slot=wpos.to(torch.int64) if per_row else int(wpos),
                 states=None)
        ids = self.decode_graphs.decode(st, max_new, graph=graph,
                                        step_logits=step_logits)
        return ids.cpu().numpy(), st.cache


def filter_visual_image_tags(text: str) -> str:
    """Drop standalone visual-region ``<img src="images/bbox_…">`` blocks
    (ovisocr2/model.rs:546 filter_visual_image_tags)."""
    return "\n\n".join(
        block for block in text.split("\n\n")
        if not block.strip().startswith('<img src="images/bbox_'))


def clean_truncated_repeats(text: str) -> str:
    """Official OvisOCR2 truncated-repeat cleanup
    (ovisocr2/model.rs:553-586): for long outputs (≥8000 chars), find the
    shortest period ≤200 whose repetition covers ≥100 chars ≥5 times at
    the tail, and collapse it to one period (+ the partial tail)."""
    MIN_TEXT_LEN, MAX_PERIOD = 8000, 200
    MIN_REPEAT_CHARS, MIN_REPEAT_TIMES = 100, 5
    n = len(text)
    if n < MIN_TEXT_LEN:
        return text
    for unit in range(1, min(MAX_PERIOD, n - 1) + 1):
        if text[n - 1] != text[n - 1 - unit]:
            continue
        match_len = 1
        i = n - 2
        while i >= unit and text[i] == text[i - unit]:
            match_len += 1
            i -= 1
        total = match_len + unit
        times = total // unit
        tail = total % unit
        if times >= MIN_REPEAT_TIMES and total >= MIN_REPEAT_CHARS:
            prefix_end = n - total + unit
            return text[:prefix_end] + (text[n - tail:] if tail else "")
    return text


class OvisOCR2(VLMFamily):
    """Hybrid gated-delta / full-attention decoder (3:1); page →
    Markdown with the official prompt and post-processing."""

    def __init__(self, state_dict=None, *, tiny: bool = False,
                 cfg: Optional[FamilyConfig] = None, **kw):
        base = FAMILY_CONFIGS["ovisocr2"]
        super().__init__(cfg or (base.tiny() if tiny else base), state_dict,
                         **kw)

    def parse(self, images: Sequence[np.ndarray], *,
              max_new_tokens: int = 16384,
              keep_image_tags: bool = False) -> List[str]:
        """Page(s) → Markdown: truncated-repeat cleanup, then standalone
        image tags removed unless ``keep_image_tags``."""
        outs = self.generate(images, "markdown",
                             max_new_tokens=max_new_tokens)
        cleaned = [clean_truncated_repeats(t) for t in outs]
        if keep_image_tags:
            return cleaned
        return [filter_visual_image_tags(t) for t in cleaned]


class MonkeyOCRv2(VLMFamily):
    """Task-prompted parsing; the EndToEnd task's JSON list is parsed by
    :meth:`parse_end2end`."""

    def __init__(self, state_dict=None, *, tiny: bool = False,
                 cfg: Optional[FamilyConfig] = None, **kw):
        base = FAMILY_CONFIGS["monkeyocrv2"]
        super().__init__(cfg or (base.tiny() if tiny else base), state_dict,
                         **kw)

    def parse_end2end(self, image: np.ndarray, *,
                      max_new_tokens: int = 1024):
        """EndToEnd task → StructureResult via the JSON-list output."""
        text = self.generate([image], "end2end",
                             max_new_tokens=max_new_tokens)[0]
        h, w = image.shape[:2]
        return monkey_end2end_to_structure(text, w, h)


def monkey_end2end_to_structure(text: str, page_w: int, page_h: int):
    """Parse MonkeyOCR's EndToEnd output — a JSON list of
    {"bbox": [x0, y0, x1, y1] (normalized 0-1 or 0-1000), "category":
    label, "text"/"content": str} — into a StructureResult. Tolerant of
    trailing junk (truncated generations)."""
    from ..domain.structure import (LayoutElement, LayoutElementType,
                                    StructureResult)

    items = []
    m = re.search(r"\[.*\]", text, re.DOTALL)
    if m:
        try:
            parsed = json.loads(m.group(0))
            items = [x for x in parsed if isinstance(x, dict)]
        except json.JSONDecodeError:
            items = []
    if not items:
        for o in re.findall(r"\{[^{}]*\}", text):
            try:
                obj = json.loads(o)
                if isinstance(obj, dict):
                    items.append(obj)
            except json.JSONDecodeError:
                continue
    elements = []
    for item in items:
        if not isinstance(item, dict):
            continue
        bbox = item.get("bbox") or item.get("box")
        if not bbox or len(bbox) < 4:
            continue
        b = [float(v) for v in bbox[:4]]
        if max(b) <= 1.5:
            scale_x, scale_y = page_w, page_h
        elif max(b) <= 1000.0:
            scale_x, scale_y = page_w / 1000.0, page_h / 1000.0
        else:
            scale_x = scale_y = 1.0
        box = np.array([b[0] * scale_x, b[1] * scale_y,
                        b[2] * scale_x, b[3] * scale_y], np.float32)
        elements.append(LayoutElement(
            element_type=LayoutElementType.from_label(
                str(item.get("category", item.get("type", "text")))),
            box=box, score=float(item.get("score", 1.0)),
            text=item.get("text") or item.get("content")))
    return StructureResult(elements=elements, width=page_w, height=page_h)


def _fork_points(ids: List[int], pattern: List[int]
                 ) -> List[Tuple[int, int]]:
    """(marker-end index, seed token) for each ``pattern`` occurrence
    followed by a token — the fork boundary within the parent stream."""
    out: List[Tuple[int, int]] = []
    if not pattern:
        return out
    n, m = len(ids), len(pattern)
    i = 0
    while i <= n - m:
        if ids[i:i + m] == pattern:
            if i + m < n:
                out.append((i + m, ids[i + m]))
            i += m
        else:
            i += 1
    return out


FAMILY_CLASSES = {
    "hunyuanocr": HunyuanOCR,
    "glmocr": GLMOCR,
    "mineru": MinerU,
    "mineru_diffusion": MinerUDiffusion,
    "hpd_parsing": HPDParsing,
    "ovisocr2": OvisOCR2,
    "monkeyocrv2": MonkeyOCRv2,
}
