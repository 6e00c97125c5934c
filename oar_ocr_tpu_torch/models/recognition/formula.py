"""Formula recognition: the JAX package's default formula recognizer.

Counterpart of ``oar_ocr_tpu/models/recognition/formula.py``:

- host pieces copied line for line: ``BOS_ID``/``EOS_ID``/``PAD_ID``
  (:31), ``crop_formula_margins`` (:159-171), ``unimernet_preprocess``
  (:174-193), ``normalize_latex`` (:196-203), ``FormulaResult``
  (:206-208) and ``filter_tokens`` (:273-279);
- :class:`FormulaEncoder` (:34-50): five stride-2 ``ConvBNAct`` (ReLU,
  flax ``"SAME"`` padding) to 1/32, one pre-LN ``TransformerBlock``
  (``layers.py:113-151``: 8 heads, tanh-approximated GELU MLP of 2×)
  and a final LayerNorm; flax's ``nn.LayerNorm()`` has eps 1e-6;
- :class:`DecodeCell` (:53-117): one greedy decode step of the
  transformer decoder, the body of the JAX ``nn.scan``: token and
  learned position embeddings; per layer pre-LN self-attention over
  the whole ``max_len`` cache with −1e9 above the step's position,
  cross-attention over the per-layer memory K/V, a GELU MLP; the logits
  of the final LayerNorm; ``nxt = argmax``, ``prob`` the max of the
  float32 softmax;
- :class:`PPFormulaNet` (:120-156): the encoder, its memory cast to
  float32, the per-layer cross K/V (``mem_k{i}``/``mem_v{i}``) computed
  once, then ``max_len`` steps from BOS with no early exit. The loop
  itself is ``models/recognition/formula_decode.py`` (eager here, one
  CUDA graph on the card);
- :class:`FormulaRecognizer` (:211-270): the crops cropped and resized
  on the host into one uint8 (B, 192, 672, 3) canvas padded with 0,
  uploaded once, and normalized by K1 (mean 0.5, std 0.5, scale 1/255,
  caller ``formula``) into the compute dtype: the JAX host's
  ``(batch/255 − 0.5)/0.5``, the pad 0 becoming −1. One fetch of
  (ids, probs) under the ``formula.device`` timer; the host decode.

The dtype policy is the JAX one: the convolutions, the transformer
block and the encoder's LayerNorm run in the input's dtype (bfloat16
under a bfloat16 Runtime); the memory is cast to float32, and the cross
K/V, the decoder and the logits are float32.

The flax modules carry no names but the decoder's own (``ConvBNAct_0``,
``TransformerBlock_0``, ``mem_k0``, ``decoder/ln_a0``, ``decoder/mlp0/
Dense_0``); the attributes here carry the same, so
``runtime/weights.params_from_jax`` maps the JAX parameters onto them.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.normalize import normalize_images
from ...runtime.runtime import Runtime
from ...utils.tracing import stage_timer
from ..backbones import ConvBNAct
from ..layers import init_state_dict, load_weights

BOS_ID, EOS_ID, PAD_ID = 0, 2, 1  # BART-style special tokens (PP-FormulaNet)

# the JAX host's (batch/255 − 0.5)/0.5 as K1's mean, std (scale 1/255)
FORMULA_MEAN, FORMULA_STD = (0.5,) * 3, (0.5,) * 3


class Dense2(nn.Module):
    """flax ``layers.MLP``: ``Dense_0`` → GELU (tanh, ``jax.nn.gelu``'s
    default) → ``Dense_1``."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class MultiHeadSelfAttention(nn.Module):
    """``layers.MultiHeadSelfAttention`` (:113-136): ``Dense_0`` to q, k,
    v; scores divided by √head_dim; softmax (float32, cast back);
    ``Dense_1``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.Dense_0 = nn.Linear(dim, 3 * dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        hd = c // self.heads
        qkv = self.Dense_0(x).reshape(b, t, 3, self.heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(hd)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, c)
        return self.Dense_1(o)


class TransformerBlock(nn.Module):
    """``layers.TransformerBlock`` (:139-151): pre-LN attention and MLP
    (ratio 2), flax LayerNorm eps 1e-6."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 2.0):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(dim, heads)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-6)
        self.MLP_0 = Dense2(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadSelfAttention_0(self.LayerNorm_0(x))
        return x + self.MLP_0(self.LayerNorm_1(x))


class FormulaEncoder(nn.Module):
    """Conv trunk → (B, L, D) visual memory (:34-50); NCHW in."""

    def __init__(self, dim: int = 384):
        super().__init__()
        w = 32
        chans = (3, w, w * 2, w * 4, w * 8, dim)
        for i in range(5):
            setattr(self, f"ConvBNAct_{i}",
                    ConvBNAct(chans[i], chans[i + 1], 3, 2, act="relu"))
        self.TransformerBlock_0 = TransformerBlock(dim, 8)
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(5):
            x = getattr(self, f"ConvBNAct_{i}")(x)
        seq = x.flatten(2).transpose(1, 2)
        return self.LayerNorm_0(self.TransformerBlock_0(seq))


class DecodeCell(nn.Module):
    """One greedy decode step (:53-117) on a preallocated self-attention
    cache; float32. :meth:`forward` writes the step's k and v into
    ``self_k``/``self_v`` (layers, B, max_len, dim) at ``pos`` (a Python
    int: every position is known when the loop is built) and returns the
    (B, vocab) float32 logits."""

    def __init__(self, vocab_size: int, dim: int, layers: int, heads: int,
                 max_len: int):
        super().__init__()
        self.dim, self.layers, self.heads = dim, layers, heads
        self.max_len = max_len
        self.tok_emb = nn.Embedding(vocab_size, dim)
        self.pos_emb = nn.Parameter(torch.zeros(max_len, dim))
        for li in range(layers):
            for name in ("q", "k", "v", "o", "qc", "oc"):
                setattr(self, f"{name}{li}", nn.Linear(dim, dim))
            for name in ("ln_a", "ln_b", "ln_c"):
                setattr(self, f"{name}{li}", nn.LayerNorm(dim, eps=1e-6))
            setattr(self, f"mlp{li}", Dense2(dim, dim * 4, dim))
        self.ln_f = nn.LayerNorm(dim, eps=1e-6)
        self.lm_head = nn.Linear(dim, vocab_size)

    def forward(self, tok: torch.Tensor, pos: int, self_k: torch.Tensor,
                self_v: torch.Tensor, mem_k: torch.Tensor,
                mem_v: torch.Tensor, masked: torch.Tensor) -> torch.Tensor:
        """``masked``: (max_len,) bool, True above ``pos``."""
        b, d, h = tok.shape[0], self.dim, self.heads
        hd = d // h
        x = self.tok_emb(tok) + self.pos_emb[pos]
        for li in range(self.layers):
            xi = getattr(self, f"ln_a{li}")(x)
            q = getattr(self, f"q{li}")(xi)
            self_k[li, :, pos] = getattr(self, f"k{li}")(xi)
            self_v[li, :, pos] = getattr(self, f"v{li}")(xi)
            kh = self_k[li].view(b, self.max_len, h, hd)
            vh = self_v[li].view(b, self.max_len, h, hd)
            att = torch.einsum("bhd,bthd->bht", q.view(b, h, hd),
                               kh) / math.sqrt(hd)
            att = torch.softmax(att.masked_fill(masked, -1e9), dim=-1)
            ctx = torch.einsum("bht,bthd->bhd", att, vh).reshape(b, d)
            x = x + getattr(self, f"o{li}")(ctx)
            xi = getattr(self, f"ln_b{li}")(x)
            qc = getattr(self, f"qc{li}")(xi).view(b, h, hd)
            kc = mem_k[li].view(b, -1, h, hd)
            vc = mem_v[li].view(b, -1, h, hd)
            attc = torch.einsum("bhd,bthd->bht", qc, kc) / math.sqrt(hd)
            attc = torch.softmax(attc, dim=-1)
            ctxc = torch.einsum("bht,bthd->bhd", attc, vc).reshape(b, d)
            x = x + getattr(self, f"oc{li}")(ctxc)
            x = x + getattr(self, f"mlp{li}")(getattr(self, f"ln_c{li}")(x))
        return self.lm_head(self.ln_f(x)).float()


class PPFormulaNet(nn.Module):
    """Encoder + greedy AR decoder (:120-156). :meth:`encode` gives the
    float32 memory of an NCHW input, :meth:`prefill` its per-layer cross
    K/V; ``forward`` returns (ids (B, max_len), probs (B, max_len)) of the
    eager loop."""

    def __init__(self, vocab_size: int = 50000, dim: int = 384,
                 dec_layers: int = 2, heads: int = 8, max_len: int = 256):
        super().__init__()
        self.dec_layers, self.max_len = dec_layers, max_len
        self.FormulaEncoder_0 = FormulaEncoder(dim)
        for li in range(dec_layers):
            setattr(self, f"mem_k{li}", nn.Linear(dim, dim))
            setattr(self, f"mem_v{li}", nn.Linear(dim, dim))
        self.decoder = DecodeCell(vocab_size, dim, dec_layers, heads,
                                  max_len)

    def apply_dtype_policy(self, dtype: torch.dtype) -> "PPFormulaNet":
        """The encoder in ``dtype``; the cross K/V and the decoder float32
        (:131: ``FormulaEncoder(...)(x).astype(jnp.float32)``)."""
        self.FormulaEncoder_0.to(dtype)
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.FormulaEncoder_0(x).float()

    def prefill(self, memory: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mem_k, mem_v), each (layers, B, L, dim) float32."""
        mk = torch.stack([getattr(self, f"mem_k{li}")(memory)
                          for li in range(self.dec_layers)])
        mv = torch.stack([getattr(self, f"mem_v{li}")(memory)
                          for li in range(self.dec_layers)])
        return mk, mv

    def forward(self, x: torch.Tensor):
        from .formula_decode import decode_eager

        return decode_eager(self.decoder, *self.prefill(self.encode(x)))


# ------------------------- preprocessing (host) -------------------------

def crop_formula_margins(img: np.ndarray, *, thresh: int = 245,
                         pad: int = 8) -> np.ndarray:
    """Crop white margins around the formula (processors/
    formula_preprocess.rs margin crop by threshold)."""

    gray = img.mean(axis=2) if img.ndim == 3 else img
    mask = gray < thresh
    if not mask.any():
        return img
    ys, xs = np.nonzero(mask)
    y0, y1 = max(ys.min() - pad, 0), min(ys.max() + pad + 1, img.shape[0])
    x0, x1 = max(xs.min() - pad, 0), min(xs.max() + pad + 1, img.shape[1])
    return img[y0:y1, x0:x1]


def unimernet_preprocess(img: np.ndarray, *, target_h: int = 192,
                         target_w: int = 672) -> np.ndarray:
    """UniMERNet's distinct preprocessing (processors/
    unimernet_preprocess.rs:1-281): grayscale-equalized crop, resize
    keeping ratio, pad to multiples of 32, ImageNet-style scaling."""

    import cv2

    c = crop_formula_margins(img, thresh=240, pad=4)
    h, w = c.shape[:2]
    scale = min(target_h / h, target_w / w)
    nh = max(int(h * scale), 1)
    nw = max(int(w * scale), 1)
    # pad to multiple of 32
    ph = -(-nh // 32) * 32
    pw = -(-nw // 32) * 32
    r = cv2.resize(c, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = np.full((min(ph, target_h), min(pw, target_w), 3), 255, np.uint8)
    out[:nh, :nw] = r[: out.shape[0], : out.shape[1]]
    return out


def normalize_latex(latex: str) -> str:
    """LaTeX whitespace normalization (formula_preprocess.rs)."""
    s = re.sub(r"\s+", " ", latex).strip()
    s = s.replace("\\ ", " ")
    return s


@dataclass
class FormulaResult:
    latex: str
    score: float


def filter_tokens(latex: str) -> str:
    """Strip model-control artifacts from decoded LaTeX
    (pp_formulanet.rs:215 filter_tokens)."""

    for artifact in ("<s>", "</s>", "<pad>", "<unk>"):
        latex = latex.replace(artifact, "")
    return latex


def formula_canvas(crops: Sequence[np.ndarray],
                   input_hw: Tuple[int, int]) -> np.ndarray:
    """The (B, H, W, 3) uint8 canvas of :meth:`FormulaRecognizer.
    recognize` (:237-247): each crop's margins cropped, resized keeping
    its ratio to fit, at the top left, 0 elsewhere."""
    import cv2

    ih, iw = input_hw
    batch = np.zeros((len(crops), ih, iw, 3), np.uint8)
    for i, crop in enumerate(crops):
        c = crop_formula_margins(crop)
        h, w = c.shape[:2]
        scale = min(ih / h, iw / w)
        nh, nw = max(int(h * scale), 1), max(int(w * scale), 1)
        batch[i, :nh, :nw] = cv2.resize(c, (nw, nh),
                                        interpolation=cv2.INTER_LINEAR)
    return batch


def decode_ids(ids: np.ndarray, probs: np.ndarray,
               vocab: Optional[Sequence[str]]) -> FormulaResult:
    """One row's ids → LaTeX and score (:255-269): BOS and PAD skipped,
    stop at EOS, ``⟨id⟩`` without a vocab, the mean prob of the kept
    tokens."""
    toks, ps = [], []
    for t in range(ids.shape[0]):
        tid = int(ids[t])
        if tid == EOS_ID:
            break
        if tid in (BOS_ID, PAD_ID):
            continue
        toks.append(vocab[tid] if vocab and tid < len(vocab)
                    else f"⟨{tid}⟩")
        ps.append(float(probs[t]))
    latex = normalize_latex(filter_tokens("".join(toks)))
    return FormulaResult(latex=latex,
                         score=float(np.mean(ps)) if ps else 0.0)


class FormulaRecognizer:
    """Wrapper: formula crop images → LaTeX strings (:211-270).

    ``state_dict``: port weights (``params_from_jax``); seeded random
    weights when None (``pos_emb`` ~ N(0, 0.02), flax's init of it).
    Without a ``vocab`` the ids render as ``⟨id⟩``. ``model_kw`` sizes the
    network (``dim``, ``dec_layers``, ``heads``) and ``input_hw`` the
    canvas; the defaults are the JAX recognizer's (192×672, dim 384, 2
    decoder layers, 8 heads, vocab 8000, 64 steps). The decode runs
    through :class:`~.formula_decode.FormulaDecodeGraphs`: one CUDA graph
    of all ``max_len`` steps per (batch, memory length) on the card.
    """

    INPUT_HW = (192, 672)   # h, w (pad-to-multiple-32 operating shape)
    TIMER = "formula.device"

    def __init__(self, state_dict=None, *,
                 vocab: Optional[Sequence[str]] = None, max_len: int = 64,
                 vocab_size: Optional[int] = None,
                 runtime: Optional[Runtime] = None,
                 input_hw: Optional[Tuple[int, int]] = None, **model_kw):
        from .formula_decode import FormulaDecodeGraphs

        self.runtime = runtime or Runtime()
        self.vocab = list(vocab) if vocab else None
        self.input_hw = tuple(input_hw or self.INPUT_HW)
        vs = vocab_size or (len(self.vocab) if self.vocab else 8000)
        model = PPFormulaNet(vocab_size=vs, max_len=max_len, **model_kw)
        if state_dict is None:
            gen = torch.Generator().manual_seed(0)
            state_dict = init_state_dict(model, gen)
            state_dict["decoder.pos_emb"] = torch.randn(
                model.decoder.pos_emb.shape, generator=gen) * 0.02
        self.model = load_weights(model, state_dict,
                                  device=self.runtime.device
                                  ).apply_dtype_policy(
                                      self.runtime.compute_dtype)
        self.graphs = FormulaDecodeGraphs(self.model.decoder)

    @torch.no_grad()
    def inputs(self, crops: Sequence[np.ndarray]) -> torch.Tensor:
        """The (B, H, W, 3) normalized NHWC input in the compute dtype:
        the host canvas, one upload, K1."""
        x = self.runtime.put(formula_canvas(crops, self.input_hw))
        return normalize_images(x, mean=FORMULA_MEAN, std=FORMULA_STD,
                                out_dtype=self.runtime.compute_dtype,
                                caller="formula")

    @torch.no_grad()
    def run(self, x: torch.Tensor):
        """(ids, probs) on the device, each (B, max_len), of a normalized
        NHWC input: the encoder, the cross K/V, then the decode (its CUDA
        graph on the card)."""
        memory = self.model.encode(x.permute(0, 3, 1, 2))
        return self.graphs.decode(*self.model.prefill(memory))

    def recognize(self, crops: Sequence[np.ndarray]) -> List[FormulaResult]:
        if not crops:
            return []
        with stage_timer(self.TIMER, batch=len(crops)):
            ids, probs = self.graphs.fetch(*self.run(self.inputs(crops)))
        return [decode_ids(ids[i], probs[i], self.vocab)
                for i in range(len(crops))]
