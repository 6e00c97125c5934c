"""PaddleOCR-VL orchestrator: preprocess → vision → prefill → greedy decode.

Counterpart of ``oar_ocr_tpu/vl/model.py``: smart_resize preprocessing
(with the Spotting task's Lanczos 2× pre-upscale), host-side patch
packing and position-embedding interpolation, prompt assembly with image
placeholder tokens, the left-padded batched prefill and the greedy decode
loop, then tokenizer decode.

Dtypes follow the JAX package (:func:`apply_dtype_policy`): under a
bfloat16 Runtime the vision tower and projector compute in bfloat16, and
the decoder, its KV cache and the logits stay float32.

The decode loop keeps every token on the device: it makes no host sync
per step (no ``.item()``, no ``.cpu()``, no branch on a device value) and
runs exactly ``max_new`` steps with EOS latched per row, as the JAX
``lax.scan``; the ids come back once, after the loop. On the card the
steps replay one captured CUDA graph per (batch, KV capacity, dtype),
the counterpart of the JAX ``jit(scan)`` program (``vl/decode_graph.py``);
``graph=False`` runs the same step eagerly, for comparison, and on the
CPU the step always runs eagerly.

Per-image isolation (``model.py:275-294``) is kept for host errors: a
failed batch retries image by image, and an image that fails alone gives
an empty result. Device faults do not degrade: torch raises CUDA errors,
failed kernel builds or launches and device out-of-memory as
``RuntimeError``, and those propagate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..errors import InvalidInputError
from ..models.layers import init_state_dict
from ..runtime.runtime import Runtime
from ..utils.tracing import logger, stage_timer
from .attention import (combine_masks, create_causal_mask,
                        create_left_padding_mask)
from .decode_graph import DecodeGraphs
from .kv_cache import decoder_cache_capacity
from .paddleocr_vl import (TASK_PROMPTS, PaddleOCRVLConfig, PaddleOCRVLModel,
                           postprocess_task_output)
from .processing import (VisionProcessorConfig, smart_resize,
                         spotting_preprocess_plan)

POS_TABLE = "visual.vision_model.embeddings.position_embedding.weight"


def apply_dtype_policy(net: nn.Module, device: torch.device,
                       compute_dtype: torch.dtype,
                       vision: Sequence[str]) -> nn.Module:
    """Place a VL network as the JAX package types it: the ``vision``
    submodules in the Runtime's compute dtype, everything else (the
    decoder's embedding, layers and final norm, the LM head) float32.

    The JAX Runtime places parameters without casting them
    (``oar_ocr_tpu/runtime/runtime.py:461-479``), so they stay float32.
    ``nn.Embed`` returns float32 (``vl/paddleocr_vl.py:391-392``,
    ``vl/hunyuan.py:334-335``), every decoder ``Dense`` computes in
    ``dtype=x.dtype`` (``paddleocr_vl.py:334-350``, ``hunyuan.py:265-291``),
    the KV cache takes ``embeds.dtype`` (``vl/model.py:180-181``,
    ``hunyuan.py:466-467``) and the LM heads run in float32
    (``paddleocr_vl.py:393, 425, 435``, ``hunyuan.py:347-349``): the
    decoders, their caches and their logits are float32 whatever the
    compute dtype. Only the vision input is cast to it
    (``vl/model.py:323-325``, ``hunyuan.py:534-535``), and the layers it
    reaches compute in it. HunyuanOCR's perceive projector is not among
    them: its first ``RMSNorm`` multiplies by a float32 scale
    (``paddleocr_vl.py:148``), which hands float32 on
    (``hunyuan.py:173-193``)."""
    net = net.eval().requires_grad_(False).to(device=device,
                                              dtype=torch.float32)
    for name in vision:
        net.get_submodule(name).to(dtype=compute_dtype)
    return net


class ByteTokenizer:
    """Reversible development tokenizer (UTF-8 bytes + specials)."""

    OFFSET = 128  # ids 0..127 reserved for specials

    def encode(self, text: str) -> List[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - self.OFFSET for i in ids
                     if self.OFFSET <= i < self.OFFSET + 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """A Hugging Face ``tokenizer.json`` through the ``tokenizers``
    package (``model.py:53-64``), imported when one is made: the package
    is optional, and the card's machine has none."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(path)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids))


@dataclass
class GenerationResult:
    text: str
    token_ids: List[int]
    num_prompt_tokens: int


@dataclass
class VisionBatch:
    """Host-side vision inputs of one batch, padded to a common length:
    patches (B, T, p·p·3), valid_len (B,), h/w ids (B, T), pos_embed
    (B, T, v_dim), and each image's patch grid."""

    patches: np.ndarray
    valid_len: np.ndarray
    h_ids: np.ndarray
    w_ids: np.ndarray
    pos_embed: np.ndarray
    grids: List[Tuple[int, int]]


@dataclass
class PromptBatch:
    """Left-padded prompt ids (B, L), their valid lengths, MRoPE positions
    (3, B, L) and each row's image span (start, count)."""

    ids: np.ndarray
    valid_lengths: np.ndarray
    positions: np.ndarray
    starts: np.ndarray
    counts: np.ndarray


class PaddleOCRVL:
    """Public VLM entry: images + task → text.

    ``state_dict`` holds the network's weights under the HF checkpoint
    names (``runtime/weights.vl_params_from_jax``, or a published
    checkpoint read with ``load_hf_vl_checkpoint``). Without one, the weights
    are seeded random, made on the runtime's device from ``seed`` with
    ``models/layers.init_state_dict``'s distribution.
    """

    def __init__(self, state_dict=None, *,
                 cfg: Optional[PaddleOCRVLConfig] = None, tokenizer=None,
                 runtime: Optional[Runtime] = None, seed: int = 0):
        self.runtime = runtime or Runtime()
        self.runtime.require_one_model_shard("PaddleOCR-VL")
        self.cfg = cfg or PaddleOCRVLConfig()
        self.vcfg = VisionProcessorConfig(patch_size=self.cfg.v_patch,
                                          merge_size=self.cfg.v_merge)
        self.tokenizer = tokenizer or ByteTokenizer()
        dev = self.runtime.device
        with torch.device("meta"):
            net = PaddleOCRVLModel(self.cfg)
        if state_dict is None:
            state_dict = init_state_dict(
                net, torch.Generator(device=dev).manual_seed(seed))
        # the host copy of the learned position table, for per-grid
        # interpolation; read before the cast to the compute dtype
        self._pos_table = state_dict[POS_TABLE].detach().float().cpu().numpy()
        net.load_state_dict(state_dict, strict=True, assign=True)
        self.net = apply_dtype_policy(net, dev, self.runtime.compute_dtype,
                                      vision=("visual", "mlp_AR"))
        self.decode_graphs = DecodeGraphs(self.net.decode_step, self.cfg,
                                          axes=3)

    # ------------------------------------------------------------------
    def _prepare_image(self, image: np.ndarray, spotting: bool = False
                       ) -> Tuple[np.ndarray, Tuple[int, int],
                                  np.ndarray, np.ndarray]:
        """smart_resize + patchify → ((T, p·p·3) float32, grid, h_ids,
        w_ids), patches in 2×2-block order, ids the raster grid position
        (``model.py:214-253``)."""
        import cv2

        vcfg = self.vcfg
        h, w = image.shape[:2]
        if spotting:
            (uh, uw), vcfg = spotting_preprocess_plan(h, w, vcfg)
            if (uh, uw) != (h, w):
                image = cv2.resize(image, (uw, uh),
                                   interpolation=cv2.INTER_LANCZOS4)
                h, w = uh, uw
        th, tw = smart_resize(h, w, vcfg)
        resized = cv2.resize(image, (tw, th), interpolation=cv2.INTER_LINEAR)
        x = resized.astype(np.float32) / 255.0
        x = (x - 0.5) / 0.5
        p, m = self.cfg.v_patch, self.cfg.v_merge
        gh, gw = th // p, tw // p
        x = x.reshape(gh // m, m, p, gw // m, m, p, 3)
        x = x.transpose(0, 3, 1, 4, 2, 5, 6)
        patches = x.reshape(gh * gw, p * p * 3)
        hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        ids = np.stack([hh, ww], -1).reshape(gh // m, m, gw // m, m, 2)
        ids = ids.transpose(0, 2, 1, 3, 4).reshape(gh * gw, 2)
        return patches, (gh, gw), ids[:, 0].astype(np.int32), \
            ids[:, 1].astype(np.int32)

    def _interp_pos_embed(self, gh: int, gw: int) -> np.ndarray:
        """Bilinear (align_corners=False) interpolation of the learned
        (grid², v_dim) table to (gh·gw, v_dim), in 2×2-block token order
        (``model.py:129-155``)."""
        table = self._pos_table
        g = int(round(len(table) ** 0.5))
        grid = table.reshape(g, g, -1)

        def axis_weights(dst, src):
            pos = np.clip((np.arange(dst) + 0.5) * src / dst - 0.5,
                          0, src - 1)
            lo = np.floor(pos).astype(np.int64)
            hi = np.minimum(lo + 1, src - 1)
            return lo, hi, (pos - lo)[:, None]

        ylo, yhi, fy = axis_weights(gh, g)
        xlo, xhi, fx = axis_weights(gw, g)
        top = grid[ylo][:, xlo] * (1 - fx) + grid[ylo][:, xhi] * fx
        bot = grid[yhi][:, xlo] * (1 - fx) + grid[yhi][:, xhi] * fx
        out = top * (1 - fy[:, None]) + bot * fy[:, None]
        m = self.cfg.v_merge
        out = out.reshape(gh // m, m, gw // m, m, -1).transpose(0, 2, 1, 3, 4)
        return out.reshape(gh * gw, -1).astype(np.float32)

    def prepare_vision(self, images: Sequence[np.ndarray],
                       task: str) -> VisionBatch:
        """Preprocess and pack a batch on the host."""
        c = self.cfg
        prepared = [self._prepare_image(im, spotting=task == "spotting")
                    for im in images]
        m2 = c.v_merge ** 2
        max_t = max(p.shape[0] for p, _, _, _ in prepared)
        max_t = ((max_t + m2 - 1) // m2) * m2
        b = len(images)
        patches = np.zeros((b, max_t, c.v_patch * c.v_patch * 3), np.float32)
        valid_len = np.zeros((b,), np.int32)
        h_ids = np.zeros((b, max_t), np.int32)
        w_ids = np.zeros((b, max_t), np.int32)
        pos_embed = np.zeros((b, max_t, c.v_dim), np.float32)
        for i, (p, (gh, gw), hi, wi) in enumerate(prepared):
            n = p.shape[0]
            patches[i, :n], valid_len[i] = p, n
            h_ids[i, :n], w_ids[i, :n] = hi, wi
            pos_embed[i, :n] = self._interp_pos_embed(gh, gw)
        return VisionBatch(patches, valid_len, h_ids, w_ids, pos_embed,
                           [g for _, g, _, _ in prepared])

    @torch.inference_mode()
    def encode_vision(self, batch: VisionBatch) -> torch.Tensor:
        """Vision tower + projector on the device: (B, T/4, hidden)."""
        rt, dt = self.runtime, self.runtime.compute_dtype
        return self.net.encode_vision(
            rt.put(batch.patches).to(dt), rt.put(batch.valid_len),
            rt.put(batch.h_ids), rt.put(batch.w_ids),
            rt.put(batch.pos_embed).to(dt))

    def build_prompts(self, batch: VisionBatch, task: str) -> PromptBatch:
        """``User: <image span> {task prompt}\\nAssistant: `` per image,
        left-padded to one length (``model.py:327-354``)."""
        c = self.cfg
        m2 = c.v_merge ** 2
        prefix = self.tokenizer.encode("User: ")
        suffix = self.tokenizer.encode(f"{TASK_PROMPTS[task]}\nAssistant: ")
        rows = [prefix + [c.image_start_id] + [c.image_pad_id] * (n // m2)
                + [c.image_end_id] + suffix for n in batch.valid_len.tolist()]
        b, max_len = len(rows), max(len(r) for r in rows)
        ids = np.zeros((b, max_len), np.int32)
        valid_lengths = np.zeros((b,), np.int32)
        positions = np.zeros((3, b, max_len), np.int32)
        starts = np.zeros((b,), np.int32)
        counts = np.zeros((b,), np.int32)
        for i, row in enumerate(rows):
            off = max_len - len(row)
            ids[i, off:] = row
            valid_lengths[i] = len(row)
            gh, gw = batch.grids[i]
            positions[:, i, :], (starts[i], counts[i]) = _mrope_positions(
                row, off, max_len, (gh // c.v_merge, gw // c.v_merge),
                c.image_pad_id)
        return PromptBatch(ids, valid_lengths, positions, starts, counts)

    @torch.inference_mode()
    def fuse_embeds(self, prompts: PromptBatch,
                    img_embeds: torch.Tensor) -> torch.Tensor:
        """Token embeddings with each row's image span overwritten by
        that row's vision embeddings, on the device
        (``model.py:158-172``)."""
        rt = self.runtime
        ids = rt.put(prompts.ids)
        starts, counts = rt.put(prompts.starts), rt.put(prompts.counts)
        embeds = self.net.model.embed_tokens(ids)
        t, ti = ids.shape[1], img_embeds.shape[1]
        idx = torch.arange(t, device=ids.device)[None, :] - starts[:, None]
        take = (idx >= 0) & (idx < counts[:, None])
        gathered = torch.gather(
            img_embeds, 1,
            idx.clamp(0, ti - 1)[:, :, None].expand(-1, -1, img_embeds.shape[2]))
        return torch.where(take[:, :, None], gathered.to(embeds.dtype), embeds)

    @torch.inference_mode()
    def prefill_decode(self, embeds: torch.Tensor, positions: torch.Tensor,
                       valid_lengths: torch.Tensor, *, max_new: int,
                       capacity: int,
                       step_logits: Optional[List[torch.Tensor]] = None,
                       graph: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefill + ``max_new`` greedy decode steps, all on the device
        (``model.py:174-211``), in the static KV cache of this (batch,
        capacity, dtype); on the card the steps replay its captured
        graph unless ``graph`` is False. Returns (ids (B, max_new) int32,
        the prefill's float32 logits (B, vocab)). When ``step_logits`` is
        a list, each decode step's logits are appended to it (the logits
        that chose ids[:, i + 1] come from step i)."""
        b, t, _ = embeds.shape
        dev = embeds.device
        st = self.decode_graphs.state(b, capacity, embeds.dtype, dev)
        cache = st.cache.reset(t - valid_lengths)
        full = combine_masks(create_causal_mask(t, dev),
                             create_left_padding_mask(valid_lengths, t))
        full = torch.cat([full.expand(b, 1, t, t),
                          torch.zeros((b, 1, t, capacity - t),
                                      dtype=torch.bool, device=dev)], dim=-1)
        logits = self.net.prefill(embeds, positions, cache, full)
        cache.advance(t)
        # the first step's MRoPE positions: each row's next index
        st.start(logits.argmax(-1).to(torch.int32),
                 (positions.amax(dim=(0, 2)) + 1)[None, :, None], slot=t)
        return self.decode_graphs.decode(st, max_new, graph=graph,
                                         step_logits=step_logits), logits

    # ------------------------------------------------------------------
    def generate(self, images: Sequence[np.ndarray], task: str = "ocr", *,
                 max_new_tokens: int = 512, raw: bool = False,
                 min_capacity: int = 0) -> List[GenerationResult]:
        """``raw=True`` skips the per-task output postprocess.
        ``min_capacity`` pins the KV cache to at least this many slots."""
        if task not in TASK_PROMPTS:
            raise InvalidInputError("unknown task", task=task,
                                    known=sorted(TASK_PROMPTS))
        if not images:
            return []
        kw = dict(max_new_tokens=max_new_tokens, raw=raw,
                  min_capacity=min_capacity)
        try:
            return self._generate_batch(images, task, **kw)
        except RuntimeError:
            raise
        except Exception:
            if len(images) == 1:
                raise
            out: List[GenerationResult] = []
            for im in images:
                try:
                    out.extend(self._generate_batch([im], task, **kw))
                except RuntimeError:
                    raise
                except Exception:
                    logger.warning("VLM generation failed for one image",
                                   exc_info=True)
                    out.append(GenerationResult(text="", token_ids=[],
                                                num_prompt_tokens=0))
            return out

    def _generate_batch(self, images, task: str, *, max_new_tokens: int,
                        raw: bool, min_capacity: int
                        ) -> List[GenerationResult]:
        c, rt = self.cfg, self.runtime
        vision = self.prepare_vision(images, task)
        with stage_timer("vl.vision", batch=len(images),
                         tokens=vision.patches.shape[1]):
            img_embeds = self.encode_vision(vision)
        prompts = self.build_prompts(vision, task)
        max_len = prompts.ids.shape[1]
        capacity = max(decoder_cache_capacity(max_len, max_new_tokens),
                       min_capacity)
        if max_len + max_new_tokens > capacity:
            raise InvalidInputError("prompt + max_new_tokens exceed the KV "
                                    "cache", prompt=max_len,
                                    max_new_tokens=max_new_tokens,
                                    capacity=capacity)
        embeds = self.fuse_embeds(prompts, img_embeds)
        with stage_timer("vl.generate", batch=len(images), prompt=max_len,
                         capacity=capacity):
            out_ids, _ = self.prefill_decode(
                embeds, rt.put(prompts.positions), rt.put(prompts.valid_lengths),
                max_new=max_new_tokens, capacity=capacity)
            out_ids = out_ids.cpu().numpy()
        results = []
        for i in range(len(images)):
            row = out_ids[i].tolist()
            if c.eos_id in row:
                row = row[: row.index(c.eos_id)]
            decoded = self.tokenizer.decode(row)
            results.append(GenerationResult(
                text=decoded if raw else postprocess_task_output(decoded,
                                                                 task),
                token_ids=row,
                num_prompt_tokens=int(prompts.valid_lengths[i])))
        return results


def _mrope_positions(row: List[int], offset: int, total: int,
                     grid_hw: Tuple[int, int], image_pad_id: int
                     ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """3-D MRoPE positions of one left-padded prompt row
    (``model.py:387-422``): text advances all three axes together; the
    image tokens share one temporal index while (h, w) walk the merged
    grid. Returns ((3, total) positions, (image start, image length))."""
    gh, gw = grid_hw
    pos = np.zeros((3, total), np.int32)
    t = 0
    img_start_abs, img_len = offset, 0
    i, n = 0, len(row)
    while i < n:
        if row[i] == image_pad_id:
            j = i
            while j < n and row[j] == image_pad_id:
                j += 1
            run = j - i
            img_start_abs, img_len = offset + i, run
            for k in range(run):
                hh, ww = divmod(k, max(gw, 1))
                pos[0, offset + i + k] = t
                pos[1, offset + i + k] = t + hh
                pos[2, offset + i + k] = t + ww
            t = t + max(gh, gw)
            i = j
        else:
            pos[:, offset + i] = t
            t += 1
            i += 1
    return pos, (img_start_abs, img_len)
