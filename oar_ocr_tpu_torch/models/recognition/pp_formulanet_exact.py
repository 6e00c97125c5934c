"""Exact PP-FormulaNet-S and -L: the deploy checkpoints' topology.

Counterpart of ``oar_ocr_tpu/models/recognition/pp_formulanet_exact.py``:

- :class:`VaryConfig` and :class:`PPFormulaNetConfig` with ``tiny``,
  ``large``, ``tiny_large`` and ``mbart`` (:51-130), copied field for
  field;
- :class:`PPFormulaNetModule` (:133-177): the backbone at ``backbone``
  (-S: ``PPHGNetV2Det(arch="L", return_idx=(3,))``, HGNetV2-B4, its
  stride-32 map flattened to (B, H·W/1024, 2048); -L: the full Vary
  ViT-B with ``net_3`` and ``mm_projector_vary``), the
  ``head.enc_to_dec_proj`` Dense where the encoder and decoder widths
  differ, and the MBart decoder of ``unimernet.py`` at
  ``head.decoder.model.decoder``;
- ``_decode_bucket`` (:180-186), copied as ``unimernet.decode_bucket``;
- :class:`PPFormulaNetRecognizer` (:189-270): the margin crop
  (threshold 200) and ``cv2.resize`` to ``image_hw`` as uint8 on the
  host, every crop's canvas in one upload and one K1 launch (mean
  0.7931, std 0.1738, caller ``formulanet``), then per crop the encode
  and the JAX host greedy loop (:meth:`PPFormulaNetRecognizer.decode_ids`):
  the query right-padded with ``pad_id`` to a pow2 bucket,
  ``parallel_step`` positions read per forward (3 for -S, 1 for -L), a
  stop at ``eos_id`` (or an id ≥ vocab) or after ``max_new_tokens``;
- :class:`PPFormulaNetExactAdapter` (:273-286).

These models run float32 in either Runtime, as the JAX recognizer feeds
float32 inputs to float32 parameters. Each decode forward makes one host
read; on the card it replays the CUDA graph of its (bucket, rows, memory
length) key (``exact_decode.py``), on the CPU it runs eagerly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops.normalize import normalize_images
from ...runtime.runtime import Runtime
from ...utils.tracing import stage_timer
from ..detection.rtdetr import PPHGNetV2Det
from ..layers import init_state_dict, load_weights
from .exact_decode import EagerForward, ExactForwardGraphs
from .formula import FormulaResult, crop_formula_margins, normalize_latex
from .slanext_exact import VaryVITB
from .unimernet import (FORMULA_EXACT_MEAN, FORMULA_EXACT_STD, MBartDecoder,
                        Module, UniMERNetConfig, decode_bucket, token_string)


@dataclass(frozen=True)
class VaryConfig:
    """Vary_VIT_B tower dims for PP-FormulaNet-L (the FULL Vary tower:
    SAM ViT-B + net_2 + net_3 → 1024ch at stride 64 + mm_projector_vary
    — slanext_exact.VaryVITB with projector=True).  Pinned by byte
    arithmetic on pp-formulanet-l.onnx (730,379,948 bytes = 182.6M f32):
    tower 95.2M + MBart(d=1024, 2 layers, ffn 4096, vocab 50000,
    max_pos 2560, untied-pos) 87.4M = 182.58M — an exact fit; the
    net_2-only SLANeXt tower or a deeper decoder miss by >10MB."""

    patch: int = 16
    dim: int = 768
    depth: int = 12
    heads: int = 12
    out_chans: int = 256
    window: int = 14
    global_idx: Tuple[int, ...] = (2, 5, 8, 11)
    net2_out: int = 512
    net3_out: int = 1024
    pos_grid: int = 48          # 768-px training grid


@dataclass(frozen=True)
class PPFormulaNetConfig:
    """PP-FormulaNet-S deploy config (rec_pp_formulanet_s.yml)."""

    image_hw: Tuple[int, int] = (384, 384)
    hg_arch: str = "L"              # HGNetV2-B4 stage table
    vocab_size: int = 50000
    d_model: int = 384              # decoder_hidden_size
    dec_layers: int = 2
    dec_heads: int = 16
    dec_ffn: int = 1536
    encoder_hidden: int = 2048
    max_positions: int = 1536
    sos_id: int = 0
    eos_id: int = 2
    pad_id: int = 1
    parallel_step: int = 3          # use_parallel (S)
    # preprocess (pp_formulanet.rs:30-35)
    norm_mean: float = 0.7931
    norm_std: float = 0.1738
    crop_threshold: int = 200
    padding_multiple: int = 16

    # None → PPHGNetV2 trunk (S/plus-S); set → Vary-ViT tower (L)
    vary: Optional["VaryConfig"] = None

    def tiny(self) -> "PPFormulaNetConfig":
        return dataclasses.replace(
            self, image_hw=(64, 64), hg_arch="T", vocab_size=64,
            d_model=32, dec_layers=2, dec_heads=4, dec_ffn=48,
            encoder_hidden=256, max_positions=64)

    def large(self) -> "PPFormulaNetConfig":
        """PP-FormulaNet-L (rec_pp_formulanet_l.yml): Vary_VIT_B encoder
        at 768×768, MBart d_model 1024 / 2 layers / ffn 4096; encoder
        width equals decoder width so there is no enc_to_dec_proj; the
        L variant decodes strictly token-by-token (use_parallel off)."""
        return dataclasses.replace(
            self, image_hw=(768, 768), d_model=1024, dec_layers=2,
            dec_heads=16, dec_ffn=4096, encoder_hidden=1024,
            max_positions=2560, parallel_step=1, vary=VaryConfig())

    def tiny_large(self) -> "PPFormulaNetConfig":
        """Small-dims L-shape for parity tests (vary tower + no proj)."""
        return dataclasses.replace(
            self, image_hw=(32, 32), vocab_size=64, d_model=24,
            dec_layers=2, dec_heads=4, dec_ffn=48, encoder_hidden=24,
            max_positions=64, parallel_step=1,
            vary=VaryConfig(patch=8, dim=16, depth=4, heads=2,
                            out_chans=12, window=2, global_idx=(1, 3),
                            net2_out=20, net3_out=24, pos_grid=4))

    def mbart(self) -> UniMERNetConfig:
        return dataclasses.replace(
            UniMERNetConfig(), vocab_size=self.vocab_size,
            d_model=self.d_model, dec_layers=self.dec_layers,
            dec_heads=self.dec_heads, dec_ffn=self.dec_ffn,
            max_positions=self.max_positions, sos_id=self.sos_id,
            eos_id=self.eos_id)


class PPFormulaNetModule(nn.Module):
    """backbone + enc_to_dec_proj + MBart decoder under the checkpoint
    roots ``backbone`` / ``head.enc_to_dec_proj`` /
    ``head.decoder.model.decoder`` (:133-177); NHWC in."""

    def __init__(self, cfg: PPFormulaNetConfig):
        super().__init__()
        self.cfg = c = cfg
        if c.vary is not None:
            v = c.vary
            self.backbone = VaryVITB(
                patch=v.patch, dim=v.dim, depth=v.depth, heads=v.heads,
                out_chans=v.out_chans, window=v.window,
                global_idx=v.global_idx, net2_out=v.net2_out,
                net3_out=v.net3_out, pos_grid=v.pos_grid, projector=True)
        else:
            self.backbone = PPHGNetV2Det(arch=c.hg_arch, return_idx=(3,))
        # the VisionEncoderDecoder bridge exists only when widths differ
        proj = (nn.Linear(c.encoder_hidden, c.d_model)
                if c.encoder_hidden != c.d_model else None)
        self.head = Module(enc_to_dec_proj=proj, decoder=Module(
            model=Module(decoder=MBartDecoder(c.mbart()))))

    @property
    def mbart(self) -> MBartDecoder:
        return self.head.decoder.model.decoder

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.vary is not None:
            seq = self.backbone(x)                     # (B, N, C) projected
        else:
            (f,) = self.backbone(x.permute(0, 3, 1, 2))
            seq = f.flatten(2).transpose(1, 2)         # (B, H·W, C)
        if self.head.enc_to_dec_proj is not None:
            seq = self.head.enc_to_dec_proj(seq)
        return seq

    def decode(self, ids: torch.Tensor, enc) -> torch.Tensor:
        return self.mbart(ids, enc)

    def forward(self, x, ids):
        return self.decode(ids, self.encode(x))


class PPFormulaNetRecognizer:
    """Crop → ``image_hw`` normalized input → greedy LaTeX token decode
    (:189-270). ``state_dict``: port weights (``params_from_jax``);
    seeded random weights when None."""

    TIMER = "formulanet.device"

    def __init__(self, state_dict=None, *,
                 cfg: Optional[PPFormulaNetConfig] = None,
                 vocab: Optional[Sequence[str]] = None,
                 runtime: Optional[Runtime] = None, seed: int = 0):
        self.cfg = cfg or PPFormulaNetConfig()
        self.runtime = runtime or Runtime()
        self.vocab = list(vocab) if vocab else None
        model = PPFormulaNetModule(self.cfg)
        if state_dict is None:
            state_dict = init_state_dict(model,
                                         torch.Generator().manual_seed(seed))
        self.model = load_weights(model, state_dict,
                                  device=self.runtime.device)
        self.graphs = ExactForwardGraphs(self.model.mbart)

    def canvas(self, image: np.ndarray) -> np.ndarray:
        """The uint8 ``image_hw`` input before K1 (:216-226)."""
        import cv2

        c = self.cfg
        img = crop_formula_margins(image, thresh=c.crop_threshold)
        h, w = c.image_hw
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)

    @torch.no_grad()
    def inputs(self, crops: Sequence[np.ndarray]) -> torch.Tensor:
        """(N, H, W, 3) float32: every crop's canvas, one upload, one K1
        (``(x/255 − mean)/std``)."""
        c = self.cfg
        x = self.runtime.put(np.stack([self.canvas(im) for im in crops]))
        return normalize_images(x, mean=(c.norm_mean,) * 3,
                                std=(c.norm_std,) * 3, caller="formulanet")

    @property
    def forward(self):
        """The decode forward: the graphs on the card, else eager."""
        if self.runtime.device.type == "cuda":
            return self.graphs
        return EagerForward(self.model.mbart)

    def decode_ids(self, forward, cross, max_new_tokens: int) -> List[int]:
        """The greedy host loop of one crop (:228-262) through
        ``forward``: the last ``parallel_step`` query positions read per
        forward, the query right-padded with ``pad_id`` to a pow2 bucket
        (causal: the pad tail is inert for the read rows), a stop at
        ``eos_id`` (or an id ≥ vocab) or after ``max_new_tokens``."""
        c = self.cfg
        step = max(c.parallel_step, 1)
        forward.begin(cross)
        ids: List[int] = [c.sos_id]
        done = False
        while len(ids) - 1 < max_new_tokens and not done:
            query = ids + [c.pad_id] * (step - 1)
            query = query + [c.pad_id] * (decode_bucket(len(query))
                                          - len(query))
            r = len(ids) - 1
            nxt = forward(query, range(r, r + step))
            for tok in nxt[:step].tolist():
                if tok == c.eos_id or tok >= c.vocab_size:
                    done = True
                    break
                ids.append(tok)
                if len(ids) - 1 >= max_new_tokens:
                    break
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
                with stage_timer("formula.encode"):
                    cross = mbart.cross_kv(self.model.encode(x[i:i + 1]))
                ids = self.decode_ids(forward, cross, max_new_tokens)
                out.append(token_string(ids[1:], self.vocab))
        return out


class PPFormulaNetExactAdapter:
    """Pipeline-facing adapter: the ``recognize → FormulaResult``
    contract of ``formula.FormulaRecognizer``, backed by the exact
    topology (:273-286)."""

    def __init__(self, state_dict=None, *, cfg=None, vocab=None,
                 runtime=None, seed: int = 0):
        self.rec = PPFormulaNetRecognizer(state_dict, cfg=cfg, vocab=vocab,
                                          runtime=runtime, seed=seed)

    def recognize(self, crops: Sequence[np.ndarray]) -> List[FormulaResult]:
        return [FormulaResult(latex=normalize_latex(t), score=1.0)
                for t in self.rec.recognize(crops)]
