"""SLANet table-structure recognition: the JAX package's default model.

Counterpart of ``oar_ocr_tpu/models/recognition/slanet.py``:

- host pieces copied line for line: ``TABLE_STRUCTURE_VOCAB``,
  ``SOS_ID``/``EOS_ID``, ``CELL_TOKENS`` (:33-50), ``derot_dims``,
  ``rotation_matrix``, ``rotate_boxes_back`` (:154-187),
  ``TableStructure`` (:189-199) and ``decode_structure`` (:273-295);
- :class:`SLANet` (:136-151): the parametric ``PPLCNetV3`` in det mode
  (``models/backbones.py``), a 1×1 ``ConvBNAct`` to 96 channels, and
  :class:`SLAHead` (:80-133), whose decoder runs in float32 whatever the
  backbone's dtype (:148-150);
- :class:`SLANetModel` (:201-271): the table crop sampled straight from
  the resident page batch into a 488×488 tile (``ops/warp.
  sample_transform``: the gather, then K1 with the BGR ImageNet
  normalization, caller ``"table"``), the network, and the host decode.

The flax modules of ``SLANet`` carry no names (``PPLCNetV3_0``,
``ConvBNAct_0``, ``SLAHead_0``); the attributes here carry the same
ones. The decoder cell's flax ``nn.GRUCell`` (``ir``/``iz``/``in`` with
bias, ``hr``/``hz`` without, ``hn`` with bias, n-gate ``tanh(in(x) +
r·hn(h))``) is held here in Paddle's fused layout (:class:`GRUWeights`:
``weight_ih`` = [ir; iz; in]ᵀ, ``bias_ih`` = [ir; iz; in] biases,
``weight_hh`` = [hr; hz; hn]ᵀ, ``bias_hh`` = [0; 0; hn bias]), the
layout of SLANet_plus's ``rnn`` as well, so that both heads run one
:func:`gru_step`; ``runtime/weights.params_from_jax`` makes the fused
tensors from the flax ones. The autoregressive loop is
``models/recognition/sla_decode.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.warp import NormSpec, resize_matrix, sample_transform
from ...runtime.runtime import Runtime
from ...utils.tracing import stage_timer
from ..backbones import ConvBNAct, PPLCNetV3
from ..layers import init_state_dict, load_weights
from .sla_decode import DecodeGraphs, SLADecoder

# PaddleOCR table structure vocabulary (table_structure_dict.txt): control
# tokens + HTML structure tokens. '<td></td>' and '<td' mark cells.
TABLE_STRUCTURE_VOCAB: Tuple[str, ...] = (
    "sos", "eos",
    "<thead>", "</thead>", "<tbody>", "</tbody>",
    "<tr>", "</tr>", "<td></td>", "<td", ">", "</td>",
    ' colspan="2"', ' colspan="3"', ' colspan="4"', ' colspan="5"',
    ' colspan="6"', ' colspan="7"', ' colspan="8"', ' colspan="9"',
    ' colspan="10"', ' colspan="11"', ' colspan="12"', ' colspan="13"',
    ' colspan="14"', ' colspan="15"', ' colspan="16"', ' colspan="17"',
    ' colspan="18"', ' colspan="19"', ' colspan="20"',
    ' rowspan="2"', ' rowspan="3"', ' rowspan="4"', ' rowspan="5"',
    ' rowspan="6"', ' rowspan="7"', ' rowspan="8"', ' rowspan="9"',
    ' rowspan="10"', ' rowspan="11"', ' rowspan="12"', ' rowspan="13"',
    ' rowspan="14"', ' rowspan="15"', ' rowspan="16"', ' rowspan="17"',
    ' rowspan="18"', ' rowspan="19"', ' rowspan="20"',
)
SOS_ID, EOS_ID = 0, 1
CELL_TOKENS = {"<td></td>", "<td"}

# the BGR ImageNet normalization of every table model's input
# (slanet.py:219-220, slanet_exact.py:445-446)
TABLE_NORM = NormSpec(NormSpec.imagenet_rgb().alpha,
                      NormSpec.imagenet_rgb().beta, swap_rb=True)


class GRUWeights(nn.Module):
    """A GRU cell's parameters in Paddle's (and PyTorch's) fused layout:
    ``weight_ih`` (3H, in), ``weight_hh`` (3H, H), ``bias_ih``,
    ``bias_hh`` (3H,), gates in the order r, z, n."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.zeros(3 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.zeros(3 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.bias_hh = nn.Parameter(torch.zeros(3 * hidden))


def gru_step(x: torch.Tensor, h: torch.Tensor,
             w: GRUWeights) -> torch.Tensor:
    """One GRU step, ``slanet_exact.py:290-303`` term for term:
    r = σ(x_r + h_r), z = σ(x_z + h_z), c = tanh(x_c + r·h_c),
    h' = (1 − z)·c + z·h (the flax ``GRUCell`` of ``slanet.py:70`` is
    the same arithmetic on the fused weights)."""
    xg = F.linear(x, w.weight_ih, w.bias_ih)
    hg = F.linear(h, w.weight_hh, w.bias_hh)
    x_r, x_z, x_c = xg.chunk(3, -1)
    h_r, h_z, h_c = hg.chunk(3, -1)
    r = torch.sigmoid(x_r + h_r)
    z = torch.sigmoid(x_z + h_z)
    c = torch.tanh(x_c + r * h_c)
    return (1.0 - z) * c + z * h


class SLADecoderCell(nn.Module):
    """One GRU + attention decode step (``slanet.py:53-77``); the flax
    names, and the GRU fused (:class:`GRUWeights`)."""

    def __init__(self, vocab_size: int, hidden: int, mem_c: int):
        super().__init__()
        self.hidden = hidden
        self.attn_q = nn.Linear(hidden, hidden)
        self.token_emb = nn.Embedding(vocab_size, hidden)
        self.in_proj = nn.Linear(hidden + mem_c, hidden)
        self.gru = GRUWeights(hidden, hidden)
        self.out_struct = nn.Linear(hidden, vocab_size)
        self.out_loc = nn.Linear(hidden, 8)


class SLAHead(SLADecoder):
    """The autoregressive structure decoder (``slanet.py:80-133``):
    ``attn_k`` of the memory once, then per step dot-product attention
    of ``attn_q(h)`` over the keys, the token embedding and the context
    through ``in_proj``, the GRU, and the logits and sigmoid corners of
    the new hidden state; argmax feedback. float32 throughout."""

    def __init__(self, vocab_size: int, mem_c: int, hidden: int = 256,
                 max_steps: int = 500):
        super().__init__(vocab_size, hidden, loc_dim=8, steps=max_steps)
        self.attn_k = nn.Linear(mem_c, hidden)
        self.cell = SLADecoderCell(vocab_size, hidden, mem_c)

    def prepare(self, memory: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return memory, self.attn_k(memory)

    def step(self, h, tok, ctx):
        memory, keys = ctx
        c = self.cell
        q = c.attn_q(h)
        scores = (q[:, None, :] * keys).sum(-1) / float(np.sqrt(self.hidden))
        w = torch.softmax(scores, -1)
        context = torch.einsum("bl,blc->bc", w, memory)
        x = c.in_proj(torch.cat([c.token_emb(tok), context], -1))
        new_h = gru_step(x, h, c.gru)
        return new_h, c.out_struct(new_h), torch.sigmoid(c.out_loc(new_h))


class SLANet(nn.Module):
    """Input (N, 3, 488, 488) normalized BGR (NCHW); outputs (N, T,
    vocab) float32 logits and (N, T, 8) normalized cell corners
    (``slanet.py:136-151``). :meth:`features` is the backbone and the
    1×1 projection, flattened to the decoder's float32 (N, HW, 96)
    memory; ``forward`` decodes it eagerly (``sla_decode``'s plain
    loop)."""

    def __init__(self, vocab_size: int = len(TABLE_STRUCTURE_VOCAB),
                 backbone_scale: float = 1.0, max_steps: int = 500):
        super().__init__()
        self.PPLCNetV3_0 = PPLCNetV3(backbone_scale, mode="det")
        self.ConvBNAct_0 = ConvBNAct(self.PPLCNetV3_0.out_channels, 96, 1)
        self.SLAHead_0 = SLAHead(vocab_size, 96, max_steps=max_steps)

    @property
    def head(self) -> SLAHead:
        return self.SLAHead_0

    def apply_dtype_policy(self, dtype: torch.dtype) -> "SLANet":
        """The backbone and the projection in ``dtype``, the decoder in
        float32 (``slanet.py:148-150``)."""
        self.PPLCNetV3_0.to(dtype)
        self.ConvBNAct_0.to(dtype)
        return self

    def features(self, x: torch.Tensor) -> torch.Tensor:
        f = self.ConvBNAct_0(self.PPLCNetV3_0(x)[-1])
        return f.flatten(2).transpose(1, 2).float()

    def forward(self, x: torch.Tensor):
        return self.head.decode(self.features(x))


def derot_dims(angle: int, w: int, h: int) -> Tuple[int, int]:
    """(w', h') of a crop after de-rotating a k·90° table orientation."""
    return (w, h) if angle % 180 == 0 else (h, w)


def rotation_matrix(angle: int, w: int, h: int) -> np.ndarray:
    """3×3 map from DE-ROTATED crop px → original crop px for a table
    whose content appears rotated ``angle``° CCW (np.rot90(crop, k)
    pixel correspondence; the reference rotates table crops upright
    before structure recognition and maps cells back,
    structure.rs:2688-2758)."""
    if angle % 360 == 0:
        return np.eye(3, dtype=np.float64)
    k = (angle // 90) % 4
    if k == 1:
        return np.array([[0, -1, w - 1], [1, 0, 0], [0, 0, 1]], np.float64)
    if k == 2:
        return np.array([[-1, 0, w - 1], [0, -1, h - 1], [0, 0, 1]],
                        np.float64)
    return np.array([[0, 1, 0], [-1, 0, h - 1], [0, 0, 1]], np.float64)


def rotate_boxes_back(boxes: np.ndarray, angle: int, w: int, h: int
                      ) -> np.ndarray:
    """Map (N, 2k) point lists from the de-rotated frame back to the
    original crop frame."""
    if boxes.size == 0 or angle % 360 == 0:
        return boxes
    R = rotation_matrix(angle, w, h)
    pts = boxes.reshape(len(boxes), -1, 2)
    out = pts @ R[:2, :2].T + R[:2, 2]
    return out.reshape(boxes.shape).astype(np.float32)


@dataclass
class TableStructure:
    """Decoded structure for one table crop."""

    tokens: List[str]
    cell_boxes: np.ndarray        # (num_cells, 8) absolute crop coords
    score: float

    @property
    def html_body(self) -> str:
        return "".join(self.tokens)


def crop_matrix(region: Tuple[int, int, int, int], angle: int,
                out_h: int, out_w: int, src_h: int, src_w: int
                ) -> np.ndarray:
    """The float32 3×3 map from tile px to page px of a table crop at
    ``region``'s corner: the de-rotation, a resize of the (src_h, src_w)
    de-rotated crop to (out_h, out_w), and the shift to the crop
    (``slanet.py:245-248``, ``slanet_exact.py:431-434``)."""
    x0, y0 = region[0], region[1]
    w, h = max(region[2] - x0, 1), max(region[3] - y0, 1)
    m = (rotation_matrix(angle, w, h)
         @ resize_matrix(src_h, src_w, out_h, out_w).astype(np.float64))
    shift = np.array([[1, 0, x0], [0, 1, y0], [0, 0, 1]], np.float64)
    return (shift @ m).astype(np.float32)


def fetch_decoded(logits: torch.Tensor, locs: torch.Tensor):
    """(ids, conf, locs) as numpy: argmax ids, max softmax probability,
    corners (``slanet.py:224-227``)."""
    ids = logits.argmax(-1).to(torch.int32)
    conf = torch.softmax(logits, -1).amax(-1)
    return ids.cpu().numpy(), conf.cpu().numpy(), locs.cpu().numpy()


class SLANetModel:
    """Wrapper: table crop → structure tokens + cell boxes
    (``slanet.py:201-271``). ``state_dict``: port weights
    (``params_from_jax``); seeded random weights when None. ``model_kw``
    sizes the network (``backbone_scale``, ``max_steps``). The decoder
    runs through :class:`~.sla_decode.DecodeGraphs` on the card."""

    INPUT_HW = (488, 488)
    TIMER = "slanet.device"

    def __init__(self, state_dict=None, *, runtime: Optional[Runtime] = None,
                 **model_kw):
        self.runtime = runtime or Runtime()
        model = SLANet(**model_kw)
        if state_dict is None:
            state_dict = init_state_dict(model,
                                         torch.Generator().manual_seed(0))
        self.model = load_weights(model, state_dict,
                                  device=self.runtime.device
                                  ).apply_dtype_policy(
                                      self.runtime.compute_dtype)
        self.graphs = DecodeGraphs(self.model.head)

    @torch.no_grad()
    def inputs(self, pages_u8: torch.Tensor,
               regions: Sequence[Tuple[int, Tuple[int, int, int, int]]],
               angles: Sequence[int]) -> torch.Tensor:
        """The (N, 488, 488, 3) tile of the table crops in the compute
        dtype: the gather, then K1 (``slanet.py:211-222``)."""
        ih, iw = self.INPUT_HW
        mats, idxs = [], []
        for (page_i, box), ang in zip(regions, angles):
            w, h = max(box[2] - box[0], 1), max(box[3] - box[1], 1)
            dw, dh = derot_dims(ang, w, h)
            mats.append(crop_matrix(box, ang, ih, iw, dh, dw))
            idxs.append(page_i)
        n = len(mats)
        put, dev = self.runtime.put, self.runtime.device
        full_w = torch.full((n,), iw, dtype=torch.int32, device=dev)
        full_h = torch.full((n,), ih, dtype=torch.int32, device=dev)
        return sample_transform(pages_u8, put(np.stack(mats)),
                                put(np.asarray(idxs, np.int64)), full_w,
                                full_h, out_h=ih, out_w=iw, norm=TABLE_NORM,
                                out_dtype=self.runtime.compute_dtype,
                                caller="table")

    @torch.no_grad()
    def decode_inputs(self, x: torch.Tensor):
        """(logits, corners) of an NHWC input tile: the backbone, then
        the decoder through its graph (the plain loop on the CPU)."""
        memory = self.model.features(x.permute(0, 3, 1, 2))
        return self.graphs.decode(memory)[:2]

    def recognize(self, pages_u8: torch.Tensor,
                  regions: Sequence[Tuple[int, Tuple[int, int, int, int]]],
                  angles: Optional[Sequence[int]] = None
                  ) -> List[TableStructure]:
        """regions: (page_index, (x0, y0, x1, y1)) table crops; ``angles``
        (optional, k·90°) de-rotates each table's content before the
        decode and maps the cell boxes back (:229-271)."""
        if not regions:
            return []
        angles = list(angles) if angles is not None else [0] * len(regions)
        with stage_timer(self.TIMER, batch=len(regions)):
            ids, conf, locs = fetch_decoded(*self.decode_inputs(
                self.inputs(pages_u8, regions, angles)))

        out = []
        for i, (_page, box) in enumerate(regions):
            w, h = max(box[2] - box[0], 1), max(box[3] - box[1], 1)
            tokens, boxes, scores = decode_structure(ids[i], conf[i], locs[i])
            dw, dh = derot_dims(angles[i], w, h)
            boxes = boxes * np.array([dw, dh] * 4, np.float32)
            boxes = rotate_boxes_back(boxes, angles[i], w, h)
            out.append(TableStructure(
                tokens=tokens, cell_boxes=boxes,
                score=float(np.mean(scores)) if scores else 0.0))
        return out


def decode_structure(ids: np.ndarray, conf: np.ndarray, locs: np.ndarray,
                     vocab: Sequence[str] = TABLE_STRUCTURE_VOCAB
                     ) -> Tuple[List[str], np.ndarray, List[float]]:
    """Token ids → HTML token list + per-cell boxes, stopping at EOS
    (processors/table_structure_decode.rs:1-120 semantics: structure tokens
    accumulate; each cell token also captures its bbox)."""

    tokens: List[str] = []
    boxes: List[np.ndarray] = []
    scores: List[float] = []
    for t in range(len(ids)):
        tid = int(ids[t])
        if tid == EOS_ID:
            break
        if tid == SOS_ID:
            continue
        tok = vocab[tid] if tid < len(vocab) else ""
        tokens.append(tok)
        scores.append(float(conf[t]))
        if tok in CELL_TOKENS:
            boxes.append(locs[t].astype(np.float32))
    return tokens, (np.stack(boxes) if boxes
                    else np.zeros((0, 8), np.float32)), scores
