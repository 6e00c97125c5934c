"""UniMERNet: a Donut-Swin encoder and the MBart decoder shared by the
exact formula models.

Counterpart of ``oar_ocr_tpu/models/recognition/unimernet.py``:

- :class:`UniMERNetConfig` (:43-71), copied field for field, and the
  host helpers ``relative_position_index`` and ``shift_attn_mask``
  (:74-99);
- the MBart decoder (:242-325), shared by PP-FormulaNet-S/-L
  (``pp_formulanet_exact.py``): :class:`MBartAttention` (q scaled by
  head_dim^-½ BEFORE the product, float32 scores and softmax, a −inf
  causal mask), :class:`MBartDecoderLayer` (pre-LN self-attention,
  cross-attention, exact-erf GELU MLP), :class:`MBartDecoder` (token
  embeddings scaled by √d, learned positions with the MBart +2 offset,
  ``layernorm_embedding``, the final ``layer_norm``, and the LM head
  tied to the float32 ``embed_tokens``);
- the Swin encoder (:102-237): :class:`SwinBlock` (pad to window
  multiples at the right and bottom, a cyclic shift only when
  min(padded h, w) > window, −100 across shifted regions, a relative
  position bias table), :class:`PatchMerging`, :class:`DonutSwinEncoder`
  (a Dense over 4×4 patches, as the JAX module computes it);
- :class:`UniMERNetModule` and :class:`UniMERNetRecognizer` (:328-424):
  the grey < 200 crop, the aspect resize onto a 255 canvas at (192,
  672), K1 with mean 0.7931 / std 0.1738 (caller ``unimernet``), and the
  host greedy loop over pow2 query buckets padded with ``eos_id``
  (:meth:`UniMERNetRecognizer.decode_ids`), whose forwards replay CUDA
  graphs on the card (``exact_decode.py``).

Everything runs float32 in either Runtime, as the JAX recognizer feeds
float32 inputs to float32 parameters. Module paths are the flax names
(``encoder.layers.0.blocks.1.attention.self.query``,
``decoder.model.decoder.layers.0.fc1``), so ``runtime/weights.
params_from_jax`` maps the JAX parameters onto them. The cross-attention
K/V of the encoder sequence are computed once per crop
(:meth:`MBartDecoder.cross_kv`): each decode forward of the JAX loop
recomputes the same products on the same inputs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.normalize import normalize_images
from ...runtime.runtime import Runtime
from ...utils.tracing import stage_timer
from ..layers import init_state_dict, load_weights
from .exact_decode import DECODE_BUCKETS, EagerForward, ExactForwardGraphs


@dataclass(frozen=True)
class UniMERNetConfig:
    # encoder (DonutSwin config.json)
    image_hw: Tuple[int, int] = (192, 672)
    patch: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 14, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-5
    # decoder (MBart config.json)
    vocab_size: int = 50000
    d_model: int = 1024
    dec_layers: int = 8
    dec_heads: int = 16
    dec_ffn: int = 4096
    scale_embedding: bool = True
    max_positions: int = 1536
    sos_id: int = 0
    eos_id: int = 2

    def tiny(self) -> "UniMERNetConfig":
        return dataclasses.replace(
            self, image_hw=(32, 48), embed_dim=16, depths=(1, 2),
            num_heads=(2, 4), window=4, vocab_size=64, d_model=32,
            dec_layers=2, dec_heads=4, dec_ffn=64, max_positions=64)


# the normalization of the exact formula models' inputs
# (pp_formulanet.rs:30-35, unimernet_preprocess.rs)
FORMULA_EXACT_MEAN, FORMULA_EXACT_STD = (0.7931,) * 3, (0.1738,) * 3


class Module(nn.Module):
    """A container whose attributes are the given submodules (the flax
    names' dotted paths, e.g. ``attention.self.query``)."""

    def __init__(container, /, **modules):
        super().__init__()
        for name, m in modules.items():
            setattr(container, name, m)


# ------------------------------ Swin encoder ------------------------------

def relative_position_index(window: int) -> np.ndarray:
    """(w², w²) index into the (2w−1)² bias table (HF DonutSwin)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]          # (2, w², w²)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, w², w²) additive mask (−100 across shifted regions)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=None)
def _shift_mask(h: int, w: int, window: int, shift: int,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(shift_attn_mask(h, w, window, shift)).to(device)


class SwinSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, bias: bool):
        super().__init__()
        self.query = nn.Linear(dim, dim, bias=bias)
        self.key = nn.Linear(dim, dim, bias=bias)
        self.value = nn.Linear(dim, dim, bias=bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("index", torch.from_numpy(
            relative_position_index(window).reshape(-1)), persistent=False)


class SwinBlock(nn.Module):
    """A (shifted-)window attention block (:102-182) over (B, H·W, C)."""

    def __init__(self, cfg: UniMERNetConfig, dim: int, heads: int,
                 shift: int):
        super().__init__()
        self.cfg, self.heads, self.shift = cfg, heads, shift
        eps = cfg.ln_eps
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = Module(
            self=SwinSelfAttention(dim, heads, cfg.window, cfg.qkv_bias),
            output=Module(dense=nn.Linear(dim, dim)))
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        hidden = int(dim * cfg.mlp_ratio)
        self.intermediate = Module(dense=nn.Linear(dim, hidden))
        self.output = Module(dense=nn.Linear(hidden, dim))

    def _window_attention(self, x: torch.Tensor,
                          mask: Optional[torch.Tensor]) -> torch.Tensor:
        att = self.attention.self
        nb, t, d = x.shape
        hd = d // self.heads
        w2 = self.cfg.window ** 2
        rel_bias = att.relative_position_bias_table[att.index].reshape(
            w2, w2, self.heads).permute(2, 0, 1)[None]

        def heads_of(y):
            return y.reshape(nb, t, self.heads, hd).transpose(1, 2)

        q, k, v = (heads_of(att.query(x)), heads_of(att.key(x)),
                   heads_of(att.value(x)))
        scores = torch.matmul(q, k.transpose(-2, -1)).float()
        scores = scores * (hd ** -0.5) + rel_bias.float()
        if mask is not None:
            nw = mask.shape[0]
            scores = (scores.reshape(nb // nw, nw, self.heads, t, t)
                      + mask[None, :, None]).reshape(nb, self.heads, t, t)
        p = torch.softmax(scores, -1).to(x.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(nb, t, d)
        return self.attention.output.dense(o)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        win = self.cfg.window
        b, _, d = x.shape
        shortcut = x
        x = self.layernorm_before(x).reshape(b, h, w, d)
        ph, pw = (win - h % win) % win, (win - w % win) % win
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        shift = self.shift if min(hp, wp) > win else 0
        mask = None
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _shift_mask(hp, wp, win, shift, x.device)
        x = x.reshape(b, hp // win, win, wp // win, win, d)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, d)
        x = self._window_attention(x, mask)
        x = x.reshape(b, hp // win, wp // win, win, win, d)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, d)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w].reshape(b, h * w, d)
        m = self.intermediate.dense(self.layernorm_after(x))
        return x + self.output.dense(F.gelu(m))


class PatchMerging(nn.Module):
    """2×2 neighbours concatenated → LayerNorm → 4C→2C (:185-203)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, h: int, w: int):
        b, _, d = x.shape
        x = F.pad(x.reshape(b, h, w, d), (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        nh, nw = x.shape[1], x.shape[2]
        x = self.norm(x.reshape(b, nh * nw, 4 * d))
        return self.reduction(x), nh, nw


class SwinStage(nn.Module):
    def __init__(self, cfg: UniMERNetConfig, si: int, dim: int):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(cfg, dim, cfg.num_heads[si],
                      0 if bi % 2 == 0 else cfg.window // 2)
            for bi in range(cfg.depths[si])])
        if si < len(cfg.depths) - 1:
            self.downsample = PatchMerging(dim, cfg.ln_eps)
        else:
            self.downsample = None


class DonutSwinEncoder(nn.Module):
    """HF ``encoder`` subtree → (B, T, final_dim) sequence (:206-237);
    (B, H, W, 3) normalized NHWC in."""

    def __init__(self, cfg: UniMERNetConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        self.embeddings = Module(
            patch_embeddings=Module(projection=nn.Linear(
                cfg.patch * cfg.patch * 3, c)),
            norm=nn.LayerNorm(c, eps=cfg.ln_eps))
        stages = []
        for si in range(len(cfg.depths)):
            stages.append(SwinStage(cfg, si, c))
            c *= 2
        self.encoder = Module(layers=nn.ModuleList(stages))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        p = self.cfg.patch
        b = pixels.shape[0]
        gh, gw = pixels.shape[1] // p, pixels.shape[2] // p
        patches = pixels.reshape(b, gh, p, gw, p, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
        x = self.embeddings.norm(
            self.embeddings.patch_embeddings.projection(patches))
        h, w = gh, gw
        for stage in self.encoder.layers:
            for block in stage.blocks:
                x = block(x, h, w)
            if stage.downsample is not None:
                x, h, w = stage.downsample(x, h, w)
        return x


# ------------------------------ MBart decoder ------------------------------

class MBartAttention(nn.Module):
    def __init__(self, heads: int, d_model: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def kv(self, kv_in: torch.Tensor):
        """(k, v) as (B, heads, T, head_dim)."""
        b, t, d = kv_in.shape
        hd = d // self.heads
        return tuple(p(kv_in).reshape(b, t, self.heads, hd).transpose(1, 2)
                     for p in (self.k_proj, self.v_proj))

    def forward(self, q_in: torch.Tensor, kv, mask) -> torch.Tensor:
        """``kv``: the key/value input (B, T, d), or its :meth:`kv`."""
        b, tq, d = q_in.shape
        hd = d // self.heads
        k, v = self.kv(kv) if torch.is_tensor(kv) else kv
        q = (self.q_proj(q_in) * (hd ** -0.5)).reshape(
            b, tq, self.heads, hd).transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-2, -1)).float()
        if mask is not None:
            attn = attn.masked_fill(~mask, float("-inf"))
        attn = torch.softmax(attn, -1).to(q_in.dtype)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(b, tq, d)
        return self.out_proj(o)


class MBartDecoderLayer(nn.Module):
    def __init__(self, cfg: UniMERNetConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.ln_eps
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.self_attn = MBartAttention(cfg.dec_heads, d)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.encoder_attn = MBartAttention(cfg.dec_heads, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.dec_ffn)
        self.fc2 = nn.Linear(cfg.dec_ffn, d)

    def forward(self, x, enc_kv, causal) -> torch.Tensor:
        h = self.self_attn_layer_norm(x)
        x = x + self.self_attn(h, h, causal)
        h = self.encoder_attn_layer_norm(x)
        x = x + self.encoder_attn(h, enc_kv, None)
        h = self.final_layer_norm(x)
        return x + self.fc2(F.gelu(self.fc1(h)))


class MBartDecoder(nn.Module):
    """HF ``decoder.model.decoder`` subtree + the tied LM head
    (:291-325)."""

    def __init__(self, cfg: UniMERNetConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        # MBart learned positions carry a +2 offset (HF
        # MBartLearnedPositionalEmbedding)
        self.embed_positions = nn.Embedding(cfg.max_positions + 2, d)
        self.layernorm_embedding = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.layers = nn.ModuleList([MBartDecoderLayer(cfg)
                                     for _ in range(cfg.dec_layers)])
        self.layer_norm = nn.LayerNorm(d, eps=cfg.ln_eps)

    def cross_kv(self, enc: torch.Tensor) -> list:
        """Each layer's cross-attention (k, v) of the encoder sequence."""
        return [layer.encoder_attn.kv(enc) for layer in self.layers]

    def hidden(self, ids: torch.Tensor, enc, start_pos: int = 0
               ) -> torch.Tensor:
        """The final LayerNorm's (B, T, d); ``enc`` the encoder sequence
        or its :meth:`cross_kv`."""
        c = self.cfg
        b, t = ids.shape
        scale = float(np.sqrt(c.d_model)) if c.scale_embedding else 1.0
        x = self.embed_tokens(ids) * scale
        pos = torch.arange(start_pos, start_pos + t, device=ids.device) + 2
        x = self.layernorm_embedding(x + self.embed_positions(pos)[None])
        causal = torch.ones((t, t), dtype=torch.bool,
                            device=ids.device).tril()[None, None]
        kvs = self.cross_kv(enc) if torch.is_tensor(enc) else enc
        for layer, kv in zip(self.layers, kvs):
            x = layer(x, kv, causal)
        return self.layer_norm(x)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden.float() @ self.embed_tokens.weight.float().t()

    def forward(self, ids: torch.Tensor, enc, start_pos: int = 0
                ) -> torch.Tensor:
        return self.logits(self.hidden(ids, enc, start_pos))


class UniMERNetModule(nn.Module):
    """encoder + decoder under the VisionEncoderDecoder root names
    (:328-344)."""

    def __init__(self, cfg: UniMERNetConfig):
        super().__init__()
        self.encoder = DonutSwinEncoder(cfg)
        self.decoder = Module(model=Module(decoder=MBartDecoder(cfg)))

    @property
    def mbart(self) -> MBartDecoder:
        return self.decoder.model.decoder

    def encode(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.encoder(pixels)

    def decode(self, ids, enc, start_pos: int = 0) -> torch.Tensor:
        return self.mbart(ids, enc, start_pos)

    def forward(self, pixels, ids):
        return self.decode(ids, self.encode(pixels))


# ------------------------------ recognizer ------------------------------

def decode_bucket(n: int) -> int:
    """Pow2 decode-length buckets (decoder_graph.rs:14 analog) — keeps
    the per-shape compile count at ~5 for a whole formula
    (``pp_formulanet_exact.py:180-186``)."""
    for b in DECODE_BUCKETS:
        if n <= b:
            return b
    return n


def token_string(toks: Sequence[int], vocab: Optional[Sequence[str]]
                 ) -> str:
    """Ids → the recognizers' string (``pp_formulanet_exact.py:264-269``,
    ``unimernet.py:418-423``)."""
    if vocab:
        return " ".join(vocab[t] for t in toks if t < len(vocab))
    return " ".join(f"⟨{t}⟩" for t in toks)


class UniMERNetRecognizer:
    """Crop → (192, 672) normalized input → greedy LaTeX token decode
    (:349-424). ``state_dict``: port weights (``params_from_jax``);
    seeded random weights when None."""

    TIMER = "unimernet.device"

    def __init__(self, state_dict=None, *,
                 cfg: Optional[UniMERNetConfig] = None,
                 vocab: Optional[Sequence[str]] = None,
                 runtime: Optional[Runtime] = None, seed: int = 0):
        self.cfg = cfg or UniMERNetConfig()
        self.runtime = runtime or Runtime()
        self.vocab = list(vocab) if vocab else None
        model = UniMERNetModule(self.cfg)
        if state_dict is None:
            state_dict = init_state_dict(model,
                                         torch.Generator().manual_seed(seed))
        self.model = load_weights(model, state_dict,
                                  device=self.runtime.device)
        self.graphs = ExactForwardGraphs(self.model.mbart)

    def canvas(self, image: np.ndarray) -> np.ndarray:
        """crop margins → aspect resize → pad to (192, 672) with 255
        (unimernet_preprocess.rs:50-200): the uint8 canvas K1 normalizes."""
        import cv2

        th, tw = self.cfg.image_hw
        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
        ys, xs = np.where(gray < 200)
        if len(ys):
            image = image[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
        h, w = image.shape[:2]
        scale = min(th / h, tw / w)
        nh, nw = max(int(h * scale), 1), max(int(w * scale), 1)
        resized = cv2.resize(image, (nw, nh),
                             interpolation=cv2.INTER_LINEAR)
        canvas = np.full((th, tw, 3), 255, np.uint8)
        canvas[:nh, :nw] = resized
        return canvas

    @torch.no_grad()
    def inputs(self, crops: Sequence[np.ndarray]) -> torch.Tensor:
        """(N, 192, 672, 3) float32: every crop's canvas, one upload, one
        K1."""
        x = self.runtime.put(np.stack([self.canvas(c) for c in crops]))
        return normalize_images(x, mean=FORMULA_EXACT_MEAN,
                                std=FORMULA_EXACT_STD, caller="unimernet")

    @property
    def forward(self):
        """The decode forward: the graphs on the card, else eager."""
        if self.runtime.device.type == "cuda":
            return self.graphs
        return EagerForward(self.model.mbart)

    def decode_ids(self, forward, cross, max_new_tokens: int) -> List[int]:
        """The greedy host loop of one crop (:395-417) through
        ``forward``: the ids from ``sos_id``, each query right-padded
        with ``eos_id`` to a pow2 length bucket (the causal decoder
        leaves the read row unaffected), a stop at ``eos_id`` or an id ≥
        ``vocab_size``."""
        c = self.cfg
        forward.begin(cross)
        ids = [c.sos_id]
        for _ in range(max_new_tokens):
            query = ids + [c.eos_id] * (decode_bucket(len(ids)) - len(ids))
            nxt = int(forward(query, [len(ids) - 1])[0])
            if nxt == c.eos_id or nxt >= c.vocab_size:
                break
            ids.append(nxt)
        return ids

    @torch.no_grad()
    def recognize(self, crops: Sequence[np.ndarray], *,
                  max_new_tokens: int = 96) -> List[str]:
        if not crops:
            return []
        mbart, forward = self.model.mbart, self.forward
        out = []
        with stage_timer(self.TIMER, batch=len(crops)):
            x = self.inputs(crops)
            for i in range(len(crops)):
                with stage_timer("unimernet.encode"):
                    cross = mbart.cross_kv(self.model.encode(x[i:i + 1]))
                ids = self.decode_ids(forward, cross, max_new_tokens)
                out.append(token_string(ids[1:], self.vocab))
        return out
