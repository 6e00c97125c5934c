"""HunyuanOCR (~1B): ViT tower + perceive projector + qk-norm XDRoPE
decoder, and its greedy generate path.

Counterpart of ``oar_ocr_tpu/vl/hunyuan.py`` (``HunyuanOCRConfig``,
``HunyuanOCRModule``, ``HunyuanOCRModel.generate``). Module attribute
names follow the HF checkpoint tree, so the state_dict keys are the
checkpoint's tensor names (``vit.layers.{i}.self_attn.q_proj.weight``,
``vit.perceive.proj.0.weight``, ``model.layers.{i}.self_attn.
query_layernorm.weight``; ``runtime/weights.hunyuan_params_from_jax``
converts the JAX parameters to them).

Kernels on this path:

- the vision attention of all 27 layers runs the flash kernel (K2,
  ``ops/flash_attention.py``) at every length. The JAX module uses plain
  SDPA below its 8192-token memory guard (``hunyuan.py:135-142``); both
  compute the same function, and the online softmax never builds the
  (T, T) scores;
- every decoder layer runs the qk-norm + rotary kernel (K4,
  ``ops/fused_norm_rope.fused_qk_norm_rope_qk``) once, on q and k of
  every batch row together, in place of the JAX module's RMSNorm
  followed by a float32 ``apply_rope`` (``:273-283``); it writes k
  straight into the layer's KV-cache slot;
- the residual add + RMSNorm kernel (K3) runs at the decoder's residual
  boundaries as in the port's Ernie decoder: layer 0's
  ``input_layernorm`` is the plain :class:`RMSNorm`, then 23 input + 24
  post-attention sites and the final ``model.norm``, 48 per forward.

Details kept from the JAX module: the vision LayerNorms have eps
``v_ln_eps`` (1e-5) and the vision MLP and the perceive projector use the
exact erf GELU (``:159``, ``:178``); ``after_rms`` normalises the whole
[begin ‖ tokens ‖ end] concatenation (``:191-193``); the XDRoPE tables
stay float32 (``:304-307``); the LM head is tied to ``embed_tokens`` and
computed in float32 (``:347-349``); the patch embedding keeps the HF
Conv2d (D, 3, p, p) weight and applies it as a dense layer over
HWC-flattened patches in raster order.

Dtypes follow the JAX package (``model.apply_dtype_policy``): under a
bfloat16 Runtime only the patch embedding and the 27 tower layers are
bfloat16; the perceive projector, the decoder, its KV cache and the
logits are float32, as JAX computes them. So K3 and K4 run in float32
on the decoder in both runtimes, where rounding once after the scale
(and the rotary) and the JAX RMSNorm's rounding before it agree to
float32 rounding.

:class:`HunyuanOCRSpeculative` adds the DFlash block draft
(``vl/dflash.py``, ``hunyuan.py:563-757``): the target taps its hidden
states after the draft's ``target_layer_ids`` (``prefill_aux``,
``decode_block_aux``), each round drafts ``block_size − 1`` tokens in one
draft forward and verifies [last token, drafts] in one causal target
pass through the same K3 and K4 sites (K4 writes k at the round's device
slot for ``block_size`` tokens), then rolls the KV cache back to the
accepted length. The round is the JAX jitted ``_spec_round``
(``hunyuan.py:635``, one program per page bucket): its two halves run on
the static buffers of one (batch, KV capacity, dtype) key
(``vl/decode_graph.RoundState``) and replay as two CUDA graphs on the
card, one per page bucket for the draft half; the host reads the accept
count once a round, as the JAX loop does (``hunyuan.py:738-753``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import init_state_dict
from ..ops.flash_attention import flash_attention
from ..ops.fused_norm_rope import fused_add_rmsnorm, fused_qk_norm_rope_qk
from ..runtime.runtime import Runtime
from ..utils.tracing import stage_timer
from .attention import (apply_rope, create_causal_mask,
                        create_generation_mask, mrope_cos_sin,
                        scaled_dot_product_attention)
from .decode_graph import DecodeGraphs, RoundState, SpecRounds
from .dflash import DFlashConfig, DFlashDraft, check_draft_fits
from .kv_cache import KVCache, decoder_cache_capacity
from .model import ByteTokenizer, apply_dtype_policy
from .paddleocr_vl import ErnieMlp, RMSNorm, conv_as_dense
from .paged_kv import PagedKVCache
from .processing import (VisionProcessorConfig, clamp_to_max_image_size,
                         smart_resize, smart_resize_token_limited)
from .speculative import verify_draft

POS_TABLE = "vit.embeddings.position_embedding.weight"
# learned markers that flax initialises with normal(0.02) (``:181-190``)
_MARKERS = ("vit.perceive.image_newline", "vit.perceive.image_begin",
            "vit.perceive.image_end")


@dataclass(frozen=True)
class HunyuanOCRConfig:
    """``hunyuan.py:54-113``, value for value."""

    # text backbone
    vocab_size: int = 120818
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    kv_heads: int = 4
    head_dim: int = 128
    ffn: int = 4096
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    use_qk_norm: bool = True
    # 4-axis XDRoPE [seq, w, h, t]; sums to head_dim/2
    xdrope_section: Tuple[int, ...] = (16, 16, 16, 16)
    # vision
    v_dim: int = 1152
    v_ffn: int = 4304
    v_layers: int = 27
    v_heads: int = 16
    v_patch: int = 16
    v_merge: int = 2
    v_ln_eps: float = 1e-5
    v_max_image: int = 2048       # learned-position base grid
    add_patchemb_bias: bool = True
    # V1 preprocessor budget
    min_pixels: int = 32 * 32
    max_pixels: int = 16_777_216
    img_max_token_num: Optional[int] = 4096
    # token ids
    bos_id: int = 1
    eos_id: int = 2
    image_start_id: int = 120814
    image_end_id: int = 120815
    image_token_id: int = 120816

    @property
    def v_grid(self) -> int:
        return self.v_max_image // self.v_patch

    @property
    def merged_dim(self) -> int:
        return self.v_merge ** 2 * self.v_dim

    def tiny(self) -> "HunyuanOCRConfig":
        return dataclasses.replace(
            self, vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2,
            head_dim=16, ffn=128, xdrope_section=(2, 2, 2, 2), v_dim=32,
            v_ffn=64, v_layers=2, v_heads=4, v_patch=4, v_max_image=32)


# ------------------------------- vision -------------------------------

class HyVisionAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.o_proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, t, d = x.shape

        def heads_of(y):
            return y.view(b, t, self.heads, d // self.heads).transpose(1, 2)

        o = flash_attention(heads_of(self.q_proj(x)), heads_of(self.k_proj(x)),
                            heads_of(self.v_proj(x)))
        return self.o_proj(o.transpose(1, 2).reshape(b, t, d))


class HyVisionMlp(nn.Module):
    def __init__(self, dim: int, ffn: int):
        super().__init__()
        self.dense_h_to_4h = nn.Linear(dim, ffn)
        self.dense_4h_to_h = nn.Linear(ffn, dim)

    def forward(self, x):
        return self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(x)))


class HyVisionLayer(nn.Module):
    def __init__(self, cfg: HunyuanOCRConfig):
        super().__init__()
        self.input_layernorm = nn.LayerNorm(cfg.v_dim, eps=cfg.v_ln_eps)
        self.self_attn = HyVisionAttention(cfg.v_dim, cfg.v_heads)
        self.post_attention_layernorm = nn.LayerNorm(cfg.v_dim,
                                                     eps=cfg.v_ln_eps)
        self.mlp = HyVisionMlp(cfg.v_dim, cfg.v_ffn)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class HyVisionPerceive(nn.Module):
    """before_rms → 2×2 stride-2 conv → GELU(erf) → 1×1 conv → a newline
    column per merged row → mlp → [begin ‖ tokens ‖ end] → after_rms."""

    def __init__(self, cfg: HunyuanOCRConfig):
        super().__init__()
        md, m = cfg.merged_dim, cfg.v_merge
        self.v_dim = cfg.v_dim
        self.before_rms = RMSNorm(cfg.v_dim, cfg.v_ln_eps)
        self.proj = nn.Sequential(nn.Conv2d(cfg.v_dim, md, m, m), nn.GELU(),
                                  nn.Conv2d(md, md, 1))
        self.image_newline = nn.Parameter(torch.zeros(md))
        self.mlp = nn.Linear(md, cfg.hidden)
        self.image_begin = nn.Parameter(torch.zeros(cfg.hidden))
        self.image_end = nn.Parameter(torch.zeros(cfg.hidden))
        self.after_rms = RMSNorm(cfg.hidden, cfg.v_ln_eps)

    def forward(self, tokens, grid_h: int, grid_w: int):
        x = self.before_rms(tokens)
        x = x.view(1, grid_h, grid_w, self.v_dim).permute(0, 3, 1, 2)
        x = self.proj(x).permute(0, 2, 3, 1)               # (1, h2, w2, md)
        _, h2, w2, md = x.shape
        nl = self.image_newline.to(x.dtype).expand(1, h2, 1, md)
        x = torch.cat([x, nl], dim=2).reshape(h2 * (w2 + 1), md)
        x = self.mlp(x)
        cat = torch.cat([self.image_begin[None].to(x.dtype), x,
                         self.image_end[None].to(x.dtype)], dim=0)
        return self.after_rms(cat)


class HyVisionEmbeddings(nn.Module):
    def __init__(self, cfg: HunyuanOCRConfig):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.v_dim, cfg.v_patch,
                                         cfg.v_patch,
                                         bias=cfg.add_patchemb_bias)
        self.position_embedding = nn.Embedding(cfg.v_grid * cfg.v_grid + 1,
                                               cfg.v_dim)


class HunyuanVisionModel(nn.Module):
    """``vit``: one image per call, (1, h·w, p·p·3) raster-order patches +
    the host-interpolated position rows → (1 + h2·(w2+1) + 1, hidden)
    image token embeddings."""

    def __init__(self, cfg: HunyuanOCRConfig):
        super().__init__()
        self.embeddings = HyVisionEmbeddings(cfg)
        self.layers = nn.ModuleList(HyVisionLayer(cfg)
                                    for _ in range(cfg.v_layers))
        self.perceive = HyVisionPerceive(cfg)

    def forward(self, patches, pos_embed, grid_h: int, grid_w: int):
        x = conv_as_dense(patches, self.embeddings.patch_embedding)
        x = x + pos_embed.to(x.dtype)[None]
        for layer in self.layers:
            x = layer(x)
        return self.perceive(x[0], grid_h, grid_w)


# ------------------------------- decoder -------------------------------

class HunyuanAttention(nn.Module):
    def __init__(self, cfg: HunyuanOCRConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = nn.Linear(cfg.hidden, cfg.heads * hd, bias=False)
        self.k_proj = nn.Linear(cfg.hidden, cfg.kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(cfg.hidden, cfg.kv_heads * hd, bias=False)
        self.o_proj = nn.Linear(cfg.heads * hd, cfg.hidden, bias=False)
        if cfg.use_qk_norm:
            self.query_layernorm = RMSNorm(hd, cfg.rms_eps)
            self.key_layernorm = RMSNorm(hd, cfg.rms_eps)

    def forward(self, h, cos, sin, cache: KVCache, layer_idx: int,
                pos: Union[int, torch.Tensor], mask):
        """Writes this layer's K/V at slot ``pos`` (an int, or the decode
        step's 0-d device slot, which K4 reads on the device), attends
        over the cache, returns o_proj of the attention output. cos/sin
        are the float32 (B, T, D/2) XDRoPE tables."""
        c = self.cfg
        b, t, _ = h.shape
        q = self.q_proj(h).view(b, t, c.heads, c.head_dim)
        k = self.k_proj(h).view(b, t, c.kv_heads, c.head_dim)
        v = self.v_proj(h).view(b, t, c.kv_heads, c.head_dim).transpose(1, 2)
        if c.use_qk_norm:
            # K4, one launch: q and k of every row; k lands in the cache
            q = fused_qk_norm_rope_qk(
                q, k, self.query_layernorm.weight, self.key_layernorm.weight,
                cos, sin, k_out=cache.k_slot(layer_idx, pos, t),
                slot=pos if isinstance(pos, torch.Tensor) else None,
                eps=c.rms_eps)
            cache.append(layer_idx, None, v, pos)
        else:       # the float32 rotary alone (``hunyuan.py:279-283``)
            q, k = (apply_rope(x.transpose(1, 2).float(), cos[:, None],
                               sin[:, None]).to(h.dtype) for x in (q, k))
            cache.append(layer_idx, k, v, pos)
        ck, cv = cache.layer(layer_idx)
        o = scaled_dot_product_attention(q, ck, cv, mask)
        return self.o_proj(o.transpose(1, 2).reshape(b, t, c.heads * c.head_dim))


class HunyuanLayer(nn.Module):
    def __init__(self, cfg: HunyuanOCRConfig, layer_idx: int):
        super().__init__()
        self.layer_idx = layer_idx
        self.eps = cfg.rms_eps
        self.input_layernorm = RMSNorm(cfg.hidden, cfg.rms_eps)
        self.self_attn = HunyuanAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden, cfg.rms_eps)
        self.mlp = ErnieMlp(cfg.hidden, cfg.ffn)

    def forward(self, residual, delta, cos, sin, cache, pos, mask):
        """(residual, delta) in → (residual, delta) out; the layer's
        hidden state is residual + delta. ``delta`` is None before
        layer 0."""
        if delta is None:
            h = self.input_layernorm(residual)
        else:
            h, residual = fused_add_rmsnorm(delta, residual,
                                            self.input_layernorm.weight,
                                            eps=self.eps)
        attn = self.self_attn(h, cos, sin, cache, self.layer_idx, pos, mask)
        h, residual = fused_add_rmsnorm(attn, residual,
                                        self.post_attention_layernorm.weight,
                                        eps=self.eps)
        return residual, self.mlp(h)


class HunyuanDecoder(nn.Module):
    """``model``: token embedding, the decoder layers, the final norm."""

    def __init__(self, cfg: HunyuanOCRConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.layers = nn.ModuleList(HunyuanLayer(cfg, i)
                                    for i in range(cfg.layers))
        self.norm = RMSNorm(cfg.hidden, cfg.rms_eps)

    def forward(self, embeds, position_ids, cache: KVCache, pos: int, mask,
                aux_layers: Tuple[int, ...] = ()):
        """The normed hidden states; with ``aux_layers`` (1-based
        post-layer taps, ``hunyuan.py:299-317``) also the hidden states
        after those layers, concatenated along the hidden axis."""
        c = self.cfg
        cos, sin = mrope_cos_sin(position_ids, c.head_dim, c.xdrope_section,
                                 c.rope_theta)              # float32
        residual, delta = embeds, None
        aux = []
        for li, layer in enumerate(self.layers):
            residual, delta = layer(residual, delta, cos, sin, cache, pos,
                                    mask)
            if li + 1 in aux_layers:
                aux.append(residual + delta)
        normed, _ = fused_add_rmsnorm(delta, residual, self.norm.weight,
                                      eps=c.rms_eps)
        if aux_layers:
            return normed, torch.cat(aux, dim=-1)
        return normed


class HunyuanOCRNet(nn.Module):
    """The whole network (``HunyuanOCRModule``); its state_dict keys are
    the HF checkpoint's tensor names."""

    def __init__(self, cfg: HunyuanOCRConfig):
        super().__init__()
        self.cfg = cfg
        self.vit = HunyuanVisionModel(cfg)
        self.model = HunyuanDecoder(cfg)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The tied head in float32 (``hunyuan.py:347-349``); the table is
        float32 in either runtime (``model.apply_dtype_policy``)."""
        return hidden.float() @ self.model.embed_tokens.weight.T

    def prefill(self, embeds, position_ids, cache: KVCache,
                mask) -> torch.Tensor:
        """The prompt through the decoder, filling ``cache`` from slot 0;
        float32 logits (B, vocab) of the last position."""
        return self.lm_logits(self.model(embeds, position_ids, cache, 0,
                                         mask)[:, -1])

    def decode_step(self, tok, position_ids, cache: KVCache,
                    pos: int) -> torch.Tensor:
        """One token per row: tok (B,), positions (4, B, 1); writes slot
        ``pos`` and advances the cache."""
        embeds = self.model.embed_tokens(tok)[:, None, :]
        mask = create_generation_mask(cache.length + 1, cache.capacity,
                                      cache.pad)
        hidden = self.model(embeds, position_ids, cache, pos, mask)
        cache.advance(1)
        return self.lm_logits(hidden[:, -1])

    def prefill_aux(self, embeds, position_ids, cache: KVCache, mask,
                    aux_layers: Tuple[int, ...]):
        """Prefill + the tapped hidden states (``hunyuan.py:360-365``):
        (last-position logits (B, vocab), aux (B, T, hidden·|taps|))."""
        hidden, aux = self.model(embeds, position_ids, cache, 0, mask,
                                 aux_layers)
        return self.lm_logits(hidden[:, -1]), aux

    def decode_block_aux(self, tok_ids, position_ids, cache: KVCache,
                         pos: int, aux_layers: Tuple[int, ...]):
        """The causal verify block (``hunyuan.py:367-382``): tok_ids
        (B, T) written at slots [pos, pos + T) (K4 writes k there), each
        attending to the cache below its own slot; advances the cache by
        T. Returns (logits (B, T, vocab), aux (B, T, hidden·|taps|))."""
        b, t = tok_ids.shape
        embeds = self.model.embed_tokens(tok_ids)
        dev = embeds.device
        cap_pos = torch.arange(cache.capacity, device=dev)[None, None, None, :]
        q_pos = torch.arange(t, device=dev)[None, None, :, None]
        mask = (cap_pos < cache.length[:, None, None, None] + q_pos + 1) \
            & (cap_pos >= cache.pad[:, None, None, None])
        hidden, aux = self.model(embeds, position_ids, cache, pos, mask,
                                 aux_layers)
        cache.advance(t)
        return self.lm_logits(hidden), aux


# ------------------------------ generate ------------------------------

def interpolate_positions(table: np.ndarray, grid: int, out_h: int,
                          out_w: int) -> np.ndarray:
    """Host bilinear (align_corners=False) over the (grid², D) patch rows
    → (out_h·out_w, D), float32 (``hunyuan.py:229-250``)."""
    d = table.shape[-1]
    src = table.reshape(grid, grid, d).astype(np.float32)
    ys = (np.arange(out_h) + 0.5) * grid / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * grid / out_w - 0.5
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    fy = ys - y0
    fx = xs - x0
    y0c = np.clip(y0, 0, grid - 1)
    y1c = np.clip(y0 + 1, 0, grid - 1)
    x0c = np.clip(x0, 0, grid - 1)
    x1c = np.clip(x0 + 1, 0, grid - 1)
    out = (src[y0c][:, x0c] * ((1 - fy)[:, None] * (1 - fx)[None])[..., None]
           + src[y0c][:, x1c] * ((1 - fy)[:, None] * fx[None])[..., None]
           + src[y1c][:, x0c] * (fy[:, None] * (1 - fx)[None])[..., None]
           + src[y1c][:, x1c] * (fy[:, None] * fx[None])[..., None])
    return out.reshape(out_h * out_w, d)


def build_position_ids(seq_len: int, first_image_tok: int,
                       hm: int, wm: int) -> np.ndarray:
    """4-axis XDRoPE position ids [seq, w, h, t] (``hunyuan.py:405-419``):
    every axis holds the arange; the spatial run of (wm+1)·hm tokens
    starting one after the first image token gets w = column cycle,
    h = row, t = 0."""
    pos = np.broadcast_to(np.arange(seq_len, dtype=np.int32),
                          (4, seq_len)).copy()
    start = first_image_tok + 1
    n = (wm + 1) * hm
    j = np.arange(n)
    pos[1, start:start + n] = j % (wm + 1)
    pos[2, start:start + n] = j // (wm + 1)
    pos[3, start:start + n] = 0
    return pos


class HunyuanOCRModel:
    """Public entry: images + instruction → text, one image per request
    (``hunyuan.py:422-560``).

    ``state_dict`` holds the network's weights under the HF checkpoint
    names (``runtime/weights.hunyuan_params_from_jax``). Without one, the
    weights are seeded random, made on the runtime's device from ``seed``
    with ``models/layers.init_state_dict``'s distribution (the learned
    markers normal(0.02), as flax initialises them).

    The decode loop keeps every token on the device: exactly
    ``max_new_tokens`` greedy steps with EOS latched, no host sync per
    step, and the ids come back once per request. On the card the steps
    replay one captured CUDA graph per (batch, KV capacity, dtype), the
    counterpart of the JAX ``jit(scan)`` program
    (``vl/decode_graph.py``); ``graph=False`` runs the same step eagerly,
    for comparison, and on the CPU the step always runs eagerly.
    """

    def __init__(self, state_dict=None, *,
                 cfg: Optional[HunyuanOCRConfig] = None, tokenizer=None,
                 runtime: Optional[Runtime] = None, seed: int = 0):
        self.runtime = runtime or Runtime()
        self.runtime.require_one_model_shard("HunyuanOCR")
        self.cfg = cfg or HunyuanOCRConfig()
        self.tokenizer = tokenizer or ByteTokenizer()
        dev = self.runtime.device
        with torch.device("meta"):
            net = HunyuanOCRNet(self.cfg)
        if state_dict is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            state_dict = init_state_dict(net, gen)
            for name in _MARKERS:
                state_dict[name] = 0.02 * torch.randn(
                    state_dict[name].shape, generator=gen, device=dev)
        # the host copy of the learned position table, for per-grid
        # interpolation; read before the cast to the compute dtype
        self._pos_table = state_dict[POS_TABLE].detach().float().cpu().numpy()
        net.load_state_dict(state_dict, strict=True, assign=True)
        self.net = apply_dtype_policy(net, dev, self.runtime.compute_dtype,
                                      vision=("vit.embeddings", "vit.layers"))
        self.decode_graphs = DecodeGraphs(self.net.decode_step, self.cfg,
                                          axes=4)

    def prepare_image(self, image: np.ndarray
                      ) -> Tuple[np.ndarray, int, int]:
        """V1 preprocess (``hunyuan.py:492-520``): smart resize under the
        pixel budget, token cap Hm·(Wm+1) ≤ img_max_token_num, longer
        side clamped to v_max_image, cv2 bilinear, (x/255 − 0.5)/0.5,
        raster-order patches → ((1, gh·gw, p·p·3) float32, gh, gw)."""
        import cv2

        c = self.cfg
        h, w = image.shape[:2]
        pcfg = VisionProcessorConfig(
            patch_size=c.v_patch, merge_size=c.v_merge,
            min_pixels=c.min_pixels, max_pixels=c.max_pixels)
        if c.img_max_token_num is not None:
            th, tw = smart_resize_token_limited(h, w, pcfg,
                                                c.img_max_token_num)
            th, tw = clamp_to_max_image_size(th, tw, pcfg.factor,
                                             c.v_max_image)
        else:
            th, tw = smart_resize(h, w, pcfg)
        resized = cv2.resize(image, (tw, th),
                             interpolation=cv2.INTER_LINEAR)
        x = (resized.astype(np.float32) / 255.0 - 0.5) / 0.5
        p = c.v_patch
        gh, gw = th // p, tw // p
        patches = x.reshape(gh, p, gw, p, 3).transpose(0, 2, 1, 3, 4)
        return patches.reshape(1, gh * gw, p * p * 3), gh, gw

    def position_rows(self, gh: int, gw: int) -> np.ndarray:
        """The learned position table's patch rows interpolated on the
        host to the (gh, gw) grid: (gh·gw, v_dim) float32."""
        return interpolate_positions(self._pos_table[1:], self.cfg.v_grid,
                                     gh, gw)

    @torch.inference_mode()
    def encode_image(self, patches: np.ndarray, pos: np.ndarray, gh: int,
                     gw: int) -> torch.Tensor:
        """Upload, then vision tower + perceive on the device:
        (n_img, hidden)."""
        rt, dt = self.runtime, self.runtime.compute_dtype
        return self.net.vit(rt.put(patches).to(dt), rt.put(pos).to(dt),
                            gh, gw)

    def build_prompt(self, gh: int, gw: int, instruction: str
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
        """[bos, image_start, n_img image tokens, image_end, instruction]
        → (ids (L,) int32, XDRoPE positions (4, L), n_img)."""
        c = self.cfg
        hm, wm = gh // c.v_merge, gw // c.v_merge
        n_img = hm * (wm + 1) + 2          # incl. begin/end markers
        row = ([c.bos_id, c.image_start_id] + [c.image_token_id] * n_img
               + [c.image_end_id] + self.tokenizer.encode(instruction))
        return (np.asarray(row, np.int32),
                build_position_ids(len(row), 2, hm, wm), n_img)

    @torch.inference_mode()
    def fuse_embeds(self, ids: np.ndarray,
                    img_embeds: torch.Tensor) -> torch.Tensor:
        """(1, L, hidden) token embeddings with the expanded image run
        [2, 2 + n_img) replaced by the image embeddings."""
        embeds = self.net.model.embed_tokens(self.runtime.put(ids)[None])
        embeds[0, 2:2 + img_embeds.shape[0]] = img_embeds.to(embeds.dtype)
        return embeds

    @torch.inference_mode()
    def prefill_decode(self, embeds: torch.Tensor, position_ids: torch.Tensor,
                       *, max_new: int, capacity: int,
                       step_logits: Optional[List[torch.Tensor]] = None,
                       graph: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Causal prefill over the static KV cache of this (batch,
        capacity, dtype), then ``max_new`` greedy decode steps, all on
        the device (``hunyuan.py:460-490``); on the card the steps replay
        its captured graph unless ``graph`` is False. Returns (ids
        (B, max_new) int32, the prefill's float32 logits (B, vocab)).
        When ``step_logits`` is a list, each decode step's logits are
        appended to it."""
        b, t, _ = embeds.shape
        dev = embeds.device
        st = self.decode_graphs.state(b, capacity, embeds.dtype, dev)
        cache = st.cache.reset()
        full = torch.cat([create_causal_mask(t, dev).expand(b, 1, t, t),
                          torch.zeros((b, 1, t, capacity - t),
                                      dtype=torch.bool, device=dev)], dim=-1)
        logits = self.net.prefill(embeds, position_ids, cache, full)
        cache.advance(t)
        # step i's four XDRoPE axes all hold t + i (``hunyuan.py:480``)
        st.start(logits.argmax(-1).to(torch.int32), t, slot=t)
        return self.decode_graphs.decode(st, max_new, graph=graph,
                                         step_logits=step_logits), logits

    def generate(self, images: Sequence[np.ndarray],
                 instruction: str = "OCR:", *,
                 max_new_tokens: int = 256) -> List[str]:
        """One request per image: preprocess, vision, prompt, prefill and
        greedy decode; the text up to the first EOS."""
        c, rt = self.cfg, self.runtime
        out = []
        for image in images:
            patches, gh, gw = self.prepare_image(image)
            pos = self.position_rows(gh, gw)
            with stage_timer("hy.vision", tokens=gh * gw):
                img = self.encode_image(patches, pos, gh, gw)
            ids, pids, _ = self.build_prompt(gh, gw, instruction)
            embeds = self.fuse_embeds(ids, img)
            capacity = decoder_cache_capacity(len(ids), max_new_tokens)
            with stage_timer("hy.generate", prompt=len(ids),
                             capacity=capacity):
                toks, _ = self.prefill_decode(
                    embeds, rt.put(pids)[:, None, :], max_new=max_new_tokens,
                    capacity=capacity)
                toks = toks.cpu()[0].tolist()
            if c.eos_id in toks:
                toks = toks[: toks.index(c.eos_id)]
            out.append(self.tokenizer.decode(toks))
        return out


class HunyuanOCRSpeculative(HunyuanOCRModel):
    """HunyuanOCR + the DFlash block draft (``hunyuan.py:563-757``):
    greedy-exact, since every emitted token is a target argmax; the draft
    sets only the pace.

    ``dflash_state_dict`` holds the draft's weights under its checkpoint
    names (``layers.0.self_attn.q_proj.weight``; ``params_from_jax``
    converts the JAX draft tree). Without one they are seeded random,
    from ``seed + 1`` (the JAX package's key for them). The draft must be as
    wide as the target: the default ``DFlashConfig()`` (hidden 2048) over
    the default ``HunyuanOCRConfig()`` (hidden 1024) raises
    ``ConfigError`` here, before any weight is made, where the JAX
    package fails in its first forward; pass
    ``DFlashConfig(hidden=1024, vocab_size=120818)``.
    """

    def __init__(self, state_dict=None, *,
                 cfg: Optional[HunyuanOCRConfig] = None,
                 dflash_cfg=None, dflash_state_dict=None, tokenizer=None,
                 runtime: Optional[Runtime] = None, seed: int = 0):
        base_cfg = cfg or HunyuanOCRConfig()
        self.dcfg = dflash_cfg or DFlashConfig()
        check_draft_fits(self.dcfg, base_cfg.hidden, base_cfg.layers)
        # 0-based config ids → 1-based post-layer taps (llm.rs id + 1)
        self._aux_layers = tuple(i + 1 for i in self.dcfg.target_layer_ids)
        super().__init__(state_dict, cfg=base_cfg, tokenizer=tokenizer,
                         runtime=runtime, seed=seed)
        dev = self.runtime.device
        with torch.device("meta"):
            draft = DFlashDraft(self.dcfg)
        if dflash_state_dict is None:
            dflash_state_dict = init_state_dict(
                draft, torch.Generator(device=dev).manual_seed(seed + 1))
        draft.load_state_dict(dflash_state_dict, strict=True, assign=True)
        self.draft = draft.eval().requires_grad_(False).to(
            device=dev, dtype=torch.float32)
        self.spec_rounds = SpecRounds(self._draft_half, self._verify_half)

    def _round_state(self, b: int, capacity: int, dtype: torch.dtype,
                     dev: torch.device) -> RoundState:
        """The round key (batch, capacity, dtype): the static target
        cache and the draft's paged context, as many pages as the
        capacity holds."""
        c, d = self.cfg, self.dcfg

        def make():
            return RoundState(
                KVCache.create(c.layers, b, c.kv_heads, capacity,
                               c.head_dim, dtype=dtype, device=dev),
                d.block_size - 1,
                ctx=PagedKVCache.create(d.layers, b, d.kv_heads,
                                        -(-capacity // d.page_size),
                                        d.page_size, d.head_dim,
                                        dtype=dtype, device=dev))

        return self.spec_rounds.state((b, capacity, dtype), make)

    @torch.inference_mode()
    def start(self, embeds: torch.Tensor, position_ids: torch.Tensor, *,
              max_new: int):
        """Prefill with taps into the static buffers of this (batch, KV
        capacity, dtype) round key and prime the draft's paged context
        with the prompt's rows (``hunyuan.py:701-727``); the key's state
        then holds the first round's inputs. Returns (first token (B,)
        int32, target cache, draft context)."""
        c, d = self.cfg, self.dcfg
        b, t, _ = embeds.shape
        k = d.block_size - 1
        dev = embeds.device
        capacity = decoder_cache_capacity(t, max_new + k + 1)
        st = self._round_state(b, capacity, embeds.dtype, dev)
        cache, ctx = st.cache.reset(), st.ctx.reset(t + max_new + k + 1)
        full = torch.cat([create_causal_mask(t, dev).expand(b, 1, t, t),
                          torch.zeros((b, 1, t, capacity - t),
                                      dtype=torch.bool, device=dev)], dim=-1)
        logits, aux = self.net.prefill_aux(embeds, position_ids, cache,
                                           full, self._aux_layers)
        cache.advance(t)
        ks, vs = self.draft.context_rows(aux, 0)
        for li in range(d.layers):
            ctx.append(li, ks[li], vs[li], 0)
        ctx.advance(t)
        tok = logits.argmax(-1).to(torch.int32)
        st.begin(tok, t)
        return tok, cache, ctx

    def _drafts(self, tok: torch.Tensor, ctx, wpos, n_pages: int
                ) -> torch.Tensor:
        """[tok, mask × (block − 1)] through the draft over the context's
        first ``n_pages`` pages, rows 1.. through the target's tied head
        → drafts (B, block − 1) int32 (``hunyuan.py:643-655``). ``wpos``
        (an int or a 0-d device slot) is the context's length."""
        d = self.dcfg
        b = tok.shape[0]
        k = d.block_size - 1
        mask_ids = torch.full((b, k), d.mask_token_id % self.cfg.vocab_size,
                              dtype=torch.int64, device=tok.device)
        q_ids = torch.cat([tok.to(torch.int64)[:, None], mask_ids], dim=1)
        q_emb = self.net.model.embed_tokens(q_ids)
        hidden = self.draft.draft_hidden(q_emb, ctx, n_pages, wpos)
        return self.net.lm_logits(hidden[:, 1:]).argmax(-1).to(torch.int32)

    def _verify(self, tok: torch.Tensor, drafts: torch.Tensor, cache, ctx,
                wpos):
        """[tok, drafts] in one causal target pass at slot ``wpos`` (an
        int, or a 0-d device slot that K4 and the KV writes read on the
        device), ``verify_draft``, the target cache trimmed to
        wpos + 1 + accepted, the verified rows' context appended to the
        draft's pages and trimmed alike (``hunyuan.py:657-669``), all on
        the device → (emitted (B, block) int32, -1 padded; accepted (B,);
        the next token (B,) int32; the verify's logits)."""
        d = self.dcfg
        b = tok.shape[0]
        k = d.block_size - 1
        block = torch.cat([tok[:, None], drafts.to(torch.int32)], dim=1)
        pids = (wpos + torch.arange(k + 1, device=tok.device)).expand(
            4, b, k + 1)
        t_logits, aux = self.net.decode_block_aux(block, pids, cache, wpos,
                                                  self._aux_layers)
        res = verify_draft(drafts, t_logits)
        a = res.accepted
        cache.trim_to(wpos + 1 + a[0])
        nxt = res.next_tokens.gather(1, a[:, None].long())[:, 0]
        ks, vs = self.draft.context_rows(aux, wpos)
        for li in range(d.layers):
            ctx.append(li, ks[li], vs[li], wpos)
        ctx.trim_to(wpos + 1 + a[0])
        return res.next_tokens, a, nxt, t_logits

    @torch.inference_mode()
    def draft_block(self, tok: torch.Tensor, ctx, wpos: int) -> torch.Tensor:
        """The round's draft half alone (``hunyuan.py:643-655``) over the
        page bucket of a context holding ``wpos`` rows → drafts
        (B, block − 1) int32."""
        return self._drafts(tok, ctx, wpos,
                            ctx.bucket(wpos + self.dcfg.block_size))

    @torch.inference_mode()
    def verify_block(self, tok: torch.Tensor, drafts: torch.Tensor, cache,
                     ctx, wpos: int):
        """The round's verify half alone, given the drafts
        (``hunyuan.py:657-669``), with its own read of the accept count.
        Returns (emitted (B, block) int32, -1 padded; accepted (int); the
        next token (B,) int32)."""
        emitted, a, nxt, _ = self._verify(tok, drafts, cache, ctx, wpos)
        return emitted, int(a[0]), nxt

    def _draft_half(self, st: RoundState, n_pages: int) -> None:
        st.drafts.copy_(self._drafts(st.tok, st.ctx, st.wpos, n_pages))

    def _verify_half(self, st: RoundState) -> torch.Tensor:
        emitted, a, nxt, logits = self._verify(st.tok, st.drafts, st.cache,
                                               st.ctx, st.wpos)
        st.commit(emitted, a, nxt)
        return logits

    def bucket(self, st: RoundState) -> int:
        """The page bucket of the state's next round: the next power of
        two pages over wpos + block rows, capped at the request's pool
        (``hunyuan.py:739``)."""
        return st.ctx.bucket(st.at + self.dcfg.block_size)

    def generate_speculative(self, images: Sequence[np.ndarray],
                             instruction: str = "OCR:", *,
                             max_new_tokens: int = 128,
                             rounds: Optional[List[int]] = None
                             ) -> List[str]:
        """One request per image, decoded by draft → verify rounds until
        ``max_new_tokens`` or EOS (``hunyuan.py:671-757``); the text up to
        the first EOS. ``rounds``, when a list, receives each round's
        accept count."""
        c, rt = self.cfg, self.runtime
        out = []
        for image in images:
            patches, gh, gw = self.prepare_image(image)
            img = self.encode_image(patches, self.position_rows(gh, gw),
                                    gh, gw)
            ids, pids, _ = self.build_prompt(gh, gw, instruction)
            embeds = self.fuse_embeds(ids, img)
            with stage_timer("hy.speculative", prompt=len(ids)):
                toks = self.decode_speculative(
                    embeds, rt.put(pids)[:, None, :],
                    max_new=max_new_tokens, rounds=rounds)
            out.append(self.tokenizer.decode(
                [i for i in toks if i != c.eos_id]))
        return out

    def decode_speculative(self, embeds: torch.Tensor,
                           position_ids: torch.Tensor, *, max_new: int,
                           rounds: Optional[List[int]] = None
                           ) -> List[int]:
        """Prefill and rounds for one prompt (batch 1): the emitted ids,
        EOS included when reached, at most ``max_new``. On the card each
        round replays its key's graphs (the CPU runs the same halves
        eagerly)."""
        tok, cache, _ = self.start(embeds, position_ids, max_new=max_new)
        st = self._round_state(tok.shape[0], cache.capacity, embeds.dtype,
                               embeds.device)
        return self.spec_rounds.decode(
            st, int(tok[0]), max_new, self.cfg.eos_id,
            bucket=self.bucket, rounds=rounds)
