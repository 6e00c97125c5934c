"""End-to-end exact VLMs: MinerU, GLM-OCR, OvisOCR2, HPD, Monkey.

Counterpart of ``oar_ocr_tpu/vl/exact_models.py``: each family's exact
vision tower (``vl/vision_towers.py``) and exact text decoder
(``vl/llm_decoders.py``) under the checkpoint's own tree roots, with the
batched greedy harness and the other entry points:

| family          | vision root        | text root                  |
|-----------------|--------------------|----------------------------|
| MinerU 2.5      | ``visual.``        | ``model.`` + ``lm_head``   |
| GLM-OCR         | ``model.visual.``  | ``model.language_model.`` + ``lm_head`` |
| OvisOCR2        | ``model.visual.``  | ``model.language_model.`` + ``lm_head`` |
| HPD-Parsing     | ``vision_model.``/``mlp1.`` | ``language_model.model.`` + ``language_model.lm_head`` |
| MonkeyOCRv2     | ``vision_tower.``  | ``model.`` + ``lm_head``   |

The port's state_dict keys are these HF names (``visual.blocks.0.attn.
qkv.weight``, ``model.language_model.layers.3.linear_attn.A_log``,
``language_model.lm_head.weight``). The JAX package nests HPD's tower
under a flax module ``hpd_vision`` that the checkpoint does not have;
here its two subtrees sit at the root, and ``runtime/weights.torch_name``
strips that one prefix (``flax_prefixes`` gives it back).

Image-token positions: MinerU uses the Qwen2-VL 3-axis MRoPE rule
when ``mrope_images`` (text axes together; an image span takes (t, row,
col) grid ids from a common base; following text resumes at max + 1). The
grid is passed from the tower inputs to the prompt explicitly (the JAX
module keeps it in ``self._last_grid``). The other decoders take plain
sequential positions.

Dtypes: float32 whatever the Runtime's compute dtype, as in the JAX
package, whose tower inputs and fused embeddings are float32 and whose
every ``Dense`` computes in ``x.dtype``.

Control flow: the JAX greedy ``lax.scan`` (``exact_models.py:401-445``)
is the step of ``vl/decode_graph.py``, one CUDA graph per (batch, KV
capacity) replayed per token on the card (the prefill eager), with the
ids read once after it. The speculative rounds, n-gram
(``exact_models.py:533``, one jit per (k, ngram)) and GLM-OCR's MTP
(``:883``, one per k), run on the static buffers of one round key and
replay as two CUDA graphs on the card (``vl/decode_graph.SpecRounds``):
the n-gram history and its length, the delta carry and the MTP cache
advance on the device, and the host reads the accept count once a round,
as the JAX loops do. SDAR's block diffusion (``exact_models.py:761``,
its trial and commit jitted) runs its two passes as CUDA graphs on one
(block length, capacity) key (``vl/diffusion.DiffusionBlocks``), the
host reading the tokens once per unmask step as JAX's does; HPD's fork
scheduler runs one graph per round key (``vl/hpd_scheduler.py``). The
KV cache is written in place, so the passes whose JAX cache is thrown
away — the SDAR trials, the verify blocks — are rolled back with
``trim_to`` before the commit, and the scheduler's frozen rows by
``with_lengths``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..errors import ConfigError, InvalidInputError
from ..models.layers import init_state_dict
from ..runtime.runtime import Runtime
from ..utils.tracing import stage_timer
from .attention import (combine_masks, create_causal_mask,
                        create_generation_mask, create_left_padding_mask)
from .decode_graph import DecodeGraphs, RoundState, SpecRounds
from .diffusion import BlockState, DiffusionBlocks
from .kv_cache import KVCache, RowBuffers, decoder_cache_capacity
from .llm_decoders import (GLM_TEXT, MINERU_TEXT, OVIS_TEXT, SDAR_TEXT,
                           GlmMtpHead, UnifiedDecoder, UnifiedLMConfig)
from .speculative import ngram_draft, verify_draft
from .vision_towers import (TOWERS, GlmVisionConfig, Group, HpdVisionConfig,
                            MinerUVisionConfig, MonkeyVisionConfig,
                            OvisVisionConfig, _qwen_vision_rope,
                            intern_tile_image, mineru_vision_positions)

# a flax root the HF tree does not have: its children sit at the root
_FLAX_ONLY_ROOTS = ("hpd_vision",)


@dataclass(frozen=True)
class ExactVLMSpec:
    """One family's wiring: tower kind + tree roots + position rule."""

    name: str
    text_cfg: UnifiedLMConfig
    tower: str                       # qwen2vl | glm | ovis | monkey | internvit
    vision_root: str
    text_root: str
    lm_head_name: str
    image_token_id: int = 151655
    mrope_images: bool = False       # Qwen2-VL 3-axis image positions


def _tiny_text(cfg: UnifiedLMConfig, **kw) -> UnifiedLMConfig:
    base = dict(vocab_size=256, hidden=48, layers=2, heads=4, kv_heads=2,
                head_dim=12, ffn=96)
    base.update(kw)
    return dataclasses.replace(cfg, **base)


def _place(root: nn.Module, path: str, module: nn.Module) -> None:
    """Register ``module`` at the dotted ``path`` under ``root``, making
    the joined containers (``model`` of ``model.visual``) on the way."""
    if path in _FLAX_ONLY_ROOTS:
        for name, child in module.named_children():
            root.add_module(name, child)
        return
    *heads, leaf = path.split(".")
    node = root
    for h in heads:
        if not hasattr(node, h):
            node.add_module(h, Group())
        node = getattr(node, h)
    node.add_module(leaf, module)


class ExactVLMNet(nn.Module):
    """Vision tower + UnifiedDecoder + LM head in one module tree, with
    the checkpoint's roots (``ExactVLMModule``, ``exact_models.py:73-327``).
    The cache is updated in place; the methods return what the JAX ones
    return without it."""

    def __init__(self, spec: ExactVLMSpec, vision_cfg):
        super().__init__()
        self.spec = spec
        c = spec.text_cfg
        tower = TOWERS[spec.tower](vision_cfg)
        text = UnifiedDecoder(c)
        head = nn.Linear(c.hidden, c.vocab_size, bias=False)
        for path, m in ((spec.vision_root, tower), (spec.text_root, text),
                        (spec.lm_head_name, head)):
            _place(self, path, m)
        # unregistered handles: the modules are registered at their roots
        object.__setattr__(self, "visual", tower)
        object.__setattr__(self, "text", text)
        object.__setattr__(self, "head", head)
        # port key's first part → the flax module it nests under
        self.flax_prefixes = (
            {name: spec.vision_root for name, _ in tower.named_children()}
            if spec.vision_root in _FLAX_ONLY_ROOTS else {})

    def encode_image(self, *tower_args):
        return self.visual(*tower_args)

    def embed(self, ids):
        return self.text.embed(ids)

    def lm_logits(self, hidden):
        return self.head(hidden).float()

    def prefill(self, embeds, position_ids, cache, mask, dstate, conv_state,
                pad_mask=None):
        """→ (last logits, dstate, conv); the caller advances the cache."""
        hidden, _, dstate, conv_state = self.text(
            embeds, position_ids, cache, 0, mask, dstate, conv_state,
            pad_mask=pad_mask)
        return self.lm_logits(hidden[:, -1]), dstate, conv_state

    def prefill_hidden_all(self, embeds, position_ids, cache, mask, dstate,
                           conv_state):
        """Prefill that also returns every hidden state (the P-MTP and
        GLM-MTP producers) → (last logits, hidden, dstate, conv)."""
        hidden, _, dstate, conv_state = self.text(
            embeds, position_ids, cache, 0, mask, dstate, conv_state)
        return self.lm_logits(hidden[:, -1]), hidden, dstate, conv_state

    def decode_step(self, tok_ids, position_ids, cache, pos, dstate,
                    conv_state):
        """One token per row at slot ``pos`` (an int or a 0-d device
        slot); advances the cache by 1 and writes the new delta carry
        into ``dstate`` / ``conv_state`` (the decode graph's static
        buffers) → (B, V) float32 logits."""
        embeds = self.text.embed(tok_ids)[:, None, :]
        mask = create_generation_mask(cache.length + 1, cache.capacity,
                                      cache.pad)
        hidden, _, _, _ = self.text(embeds, position_ids, cache, pos, mask,
                                    dstate, conv_state)
        cache.advance(1)
        return self.lm_logits(hidden[:, -1])

    def _block_mask(self, cache: KVCache, t: int, bidirectional: bool):
        dev = cache.k.device
        cap_pos = torch.arange(cache.capacity, device=dev)[None, None, None]
        length = cache.length[:, None, None, None]
        if bidirectional:
            mask = (cap_pos < length + t).expand(
                cache.length.shape[0], 1, t, cache.capacity)
        else:
            q_pos = torch.arange(t, device=dev)[None, None, :, None]
            mask = cap_pos < length + q_pos + 1
        return mask & (cap_pos >= cache.pad[:, None, None, None])

    def decode_block(self, tok_ids, position_ids, cache, pos, dstate,
                     conv_state, *, bidirectional: bool = False,
                     collect_states: bool = False):
        """A (B, T) block at slot ``pos`` (an int or per-row slots),
        causal or bidirectional (SDAR's trials); advances the cache by T
        → (logits (B, T, V) float32, hidden, dstate, conv). With
        ``collect_states`` the states are the delta layers' per-step ones
        (``decode_block_spec``)."""
        t = tok_ids.shape[1]
        hidden, _, dstate, conv_state = self.text(
            self.text.embed(tok_ids), position_ids, cache, pos,
            self._block_mask(cache, t, bidirectional), dstate, conv_state,
            collect_states)
        cache.advance(t)
        return self.lm_logits(hidden), hidden, dstate, conv_state


def qwen2vl_positions(seq_len: int, image_start: int, n_image: int,
                      grid_hw: Tuple[int, int], merge: int) -> np.ndarray:
    """Qwen2-VL get_rope_index for one image: 3 axes (t, h, w); text runs
    all axes together; the image span uses grid coordinates from the text
    base; following text resumes at max+1."""
    hm, wm = grid_hw[0] // merge, grid_hw[1] // merge
    pos = np.zeros((3, seq_len), np.int32)
    pos[:, :image_start] = np.arange(image_start)
    base = image_start
    j = np.arange(n_image)
    pos[0, image_start:image_start + n_image] = base
    pos[1, image_start:image_start + n_image] = base + j // wm
    pos[2, image_start:image_start + n_image] = base + j % wm
    nxt = int(pos[:, image_start:image_start + n_image].max()) + 1 \
        if n_image else base
    tail = seq_len - image_start - n_image
    pos[:, image_start + n_image:] = nxt + np.arange(tail)
    return pos


def exact_state_dict(net: nn.Module, generator: torch.Generator) -> dict:
    """Seeded weights: ``init_state_dict``'s distribution, with the raw
    parameters flax initialises otherwise: the InternViT layer scales
    ``ls1``/``ls2`` ones, its class and position embeddings normal(0.02)."""
    sd = init_state_dict(net, generator)
    dev = generator.device
    for name, t in sd.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ls1", "ls2"):
            sd[name] = torch.ones(t.shape, device=dev)
        elif leaf in ("class_embedding", "position_embedding"):
            sd[name] = 0.02 * torch.randn(t.shape, generator=generator,
                                          device=dev)
    return sd


def check_widths(spec: ExactVLMSpec, vision_cfg) -> None:
    """The tower's output must be the decoder's width: the fused prompt
    puts one into the other. The published MinerU-Diffusion pairing
    (MinerU's tower to 1536, SDAR's decoder at 1024) fails there in the
    JAX package at its first prompt; here it raises ``ConfigError`` at
    construction."""
    out = getattr(vision_cfg, "out_hidden",
                  getattr(vision_cfg, "llm_hidden", None))
    if out != spec.text_cfg.hidden:
        raise ConfigError("the vision tower's output width must equal the "
                          "decoder's hidden size", family=spec.name,
                          tower_out=out, hidden=spec.text_cfg.hidden)


def _causal_prefill_mask(b: int, t: int, capacity: int, device,
                         valid_lengths: Optional[torch.Tensor] = None):
    """(B, 1, T, C) prefill mask: causal (and left-padding) over the
    prompt, nothing past it."""
    mask = create_causal_mask(t, device)
    if valid_lengths is not None:
        mask = combine_masks(mask, create_left_padding_mask(valid_lengths, t))
    mask = mask.expand(b, 1, t, t)
    return torch.cat([mask, torch.zeros((b, 1, t, capacity - t),
                                        dtype=torch.bool, device=device)], -1)


class ExactVLM:
    """Batched greedy harness over :class:`ExactVLMNet`.

    ``state_dict`` holds the weights under the HF names; without one they
    are seeded random (:func:`exact_state_dict`) on the runtime's device.
    """

    def __init__(self, spec: ExactVLMSpec, vision_cfg, state_dict=None, *,
                 tokenizer=None, runtime: Optional[Runtime] = None,
                 seed: int = 0):
        from .model import ByteTokenizer

        check_widths(spec, vision_cfg)
        self.spec = spec
        self.vision_cfg = vision_cfg
        self.runtime = runtime or Runtime()
        self.runtime.require_one_model_shard("the exact VLM stacks")
        self.tokenizer = tokenizer or ByteTokenizer()
        dev = self.runtime.device
        with torch.device("meta"):
            net = ExactVLMNet(spec, vision_cfg)
        if state_dict is None:
            state_dict = exact_state_dict(
                net, torch.Generator(device=dev).manual_seed(seed))
        if spec.tower == "ovis":
            # the host copy of the position table, for per-grid rows
            self._pos_table = state_dict[
                f"{spec.vision_root}.pos_embed.weight"].detach().float() \
                .cpu().numpy()
        net.load_state_dict(state_dict, strict=True, assign=True)
        self.net = net.eval().requires_grad_(False).to(device=dev,
                                                       dtype=torch.float32)
        # one decode graph per (batch, capacity), the delta carry static
        self.decode_graphs = DecodeGraphs(
            self.net.decode_step, spec.text_cfg,
            axes=3 if spec.text_cfg.rope_kind == "mrope" else None,
            states=self.net.text.empty_states)
        # the n-gram speculative rounds, one state per (capacity, history
        # capacity, k, n)
        self.spec_rounds = SpecRounds(self._ngram_draft_half,
                                      self._ngram_verify_half)

    @property
    def device(self) -> torch.device:
        return self.runtime.device

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return self.runtime.put(np.ascontiguousarray(a))

    # -------------------- tower preprocessing --------------------
    def tower_inputs(self, image: np.ndarray):
        """→ (tower arguments on the device, merged image tokens, patch
        grid (gh, gw); (0, 0) for the tiled InternViT)."""
        import cv2

        s, v = self.spec, self.vision_cfg
        if s.tower == "internvit":
            tiles = intern_tile_image(image, image_size=v.image_size,
                                      max_blocks=4)
            p, g = v.patch, v.grid
            arr = np.stack(tiles).astype(np.float32) / 255.0
            arr = (arr - 0.5) / 0.5
            n = arr.shape[0]
            patches = arr.reshape(n, g, p, g, p, 3).transpose(
                0, 1, 3, 2, 4, 5).reshape(n, g * g, 3 * p * p)
            return ((self._put(patches),),
                    len(tiles) * (g // v.downsample) ** 2, (0, 0))
        # qwen-style towers: resize to patch·merge multiples, merge-block
        # patch order + 2-D rope tables
        unit = v.patch * v.merge
        h, w = image.shape[:2]
        th = max(unit, int(round(h / unit)) * unit)
        tw = max(unit, int(round(w / unit)) * unit)
        resized = cv2.resize(image, (tw, th), interpolation=cv2.INTER_LINEAR)
        x = (resized.astype(np.float32) / 255.0 - 0.5) / 0.5
        p, m = v.patch, v.merge
        gh, gw = th // p, tw // p
        x = x.reshape(gh // m, m, p, gw // m, m, p, 3)
        x = x.transpose(0, 3, 1, 4, 2, 5, 6).reshape(gh * gw, p * p * 3)
        if s.tower == "qwen2vl":
            x = np.tile(x, (1, v.temporal_patch))     # temporal duplication
        hp, wp = mineru_vision_positions(gh, gw, m)
        cos, sin = _qwen_vision_rope(hp, wp, v.head_dim, v.rope_theta)
        n_img = (gh // m) * (gw // m)
        args = [self._put(x), self._put(cos), self._put(sin)]
        if s.tower == "ovis":
            args.insert(1, self._put(self._ovis_pos_rows(gh, gw)))
        return tuple(args), n_img, (gh, gw)

    def _ovis_pos_rows(self, gh: int, gw: int) -> np.ndarray:
        """The position table interpolated to the grid, in the patches'
        merge-block order."""
        from .hunyuan import interpolate_positions

        v = self.vision_cfg
        rows = interpolate_positions(self._pos_table, v.pos_grid, gh, gw)
        m = v.merge
        rows = rows.reshape(gh // m, m, gw // m, m, -1)
        return rows.transpose(0, 2, 1, 3, 4).reshape(gh * gw, -1)

    def empty_states(self, batch: int):
        return self.net.text.empty_states(batch, self.device)

    def new_cache(self, batch: int, capacity: int,
                  layers: Optional[int] = None) -> KVCache:
        c = self.spec.text_cfg
        return KVCache.create(layers or c.layers, batch, c.kv_heads,
                              capacity, c.head_dim, dtype=torch.float32,
                              device=self.device)

    @torch.no_grad()
    def prepare_prompt(self, image, instruction: str):
        """Tower encode + prompt row + fused embeds + position ids →
        (embeds (1, T, H) float32, positions (3, 1, T) or (1, T) int32
        numpy, T)."""
        s = self.spec
        c = s.text_cfg
        with stage_timer("exact.vision"):
            tower_args, n_img, grid = self.tower_inputs(image)
            img_emb = self.net.encode_image(*tower_args)
        prompt = self.tokenizer.encode(instruction)
        row = [c.eos_id] + [s.image_token_id % c.vocab_size] * n_img + prompt
        t = len(row)
        if c.rope_kind == "mrope" and s.mrope_images:
            pids = qwen2vl_positions(t, 1, n_img, grid,
                                     getattr(self.vision_cfg, "merge", 2)
                                     )[:, None, :]
        elif c.rope_kind == "mrope":
            pids = np.broadcast_to(np.arange(t, dtype=np.int32),
                                   (3, 1, t)).copy()
        else:
            pids = np.arange(t, dtype=np.int32)[None]
        embeds = self.net.embed(self._put(np.asarray(row, np.int64))[None])
        embeds[0, 1:1 + n_img] = img_emb[:n_img].to(embeds.dtype)
        return embeds, pids, t

    def _npos(self, pids: torch.Tensor) -> torch.Tensor:
        """Each row's next position: max over the prompt's axes + 1."""
        if pids.ndim == 3:
            return pids.amax(dim=(0, 2)) + 1
        return pids.amax(dim=-1) + 1

    def _step_pids(self, npos: torch.Tensor, t: int = 1) -> torch.Tensor:
        p = npos[:, None] + torch.arange(t, device=npos.device)[None]
        if self.spec.text_cfg.rope_kind == "mrope":
            return p[None].expand(3, -1, -1)
        return p

    @torch.no_grad()
    def prefill_decode(self, embeds: torch.Tensor, position_ids: torch.Tensor,
                       valid_lengths: torch.Tensor, *, max_new: int,
                       capacity: int, step_logits: Optional[list] = None,
                       graph: bool = True) -> torch.Tensor:
        """Left-padded batched prefill into the static KV cache of this
        (batch, capacity), then ``max_new`` greedy steps with EOS latched
        per row (the JAX ``lax.scan``), each a replay of the key's CUDA
        graph on the card unless ``graph`` is False (the same step body,
        eagerly; the CPU always) → (B, max_new) ids on the device.
        ``step_logits``, when a list, receives the (B, V) logits that
        chose each id: the prefill's, then each step's but the last."""
        b, t, _ = embeds.shape
        dev = embeds.device
        st = self.decode_graphs.state(b, capacity, torch.float32, dev)
        cache = st.cache.reset(t - valid_lengths)
        mask = _causal_prefill_mask(b, t, capacity, dev, valid_lengths)
        # delta layers have no per-slot mask: left-pad rows are
        # neutralized at fold time (True = real token)
        pad_mask = (torch.arange(t, device=dev)[None, :]
                    >= (t - valid_lengths)[:, None])
        with stage_timer("exact.prefill"):
            logits, ds, cv = self.net.prefill(
                embeds, position_ids, cache, mask, *self.empty_states(b),
                pad_mask=pad_mask)
            cache.advance(t)
        st.start(logits.argmax(-1).to(torch.int32),
                 self._step_pids(self._npos(position_ids)), slot=t,
                 states=(ds, cv))
        steps = None if step_logits is None else [logits]
        with stage_timer("exact.decode", steps=max_new):
            ids = self.decode_graphs.decode(st, max_new, graph=graph,
                                            step_logits=steps)
        if step_logits is not None:
            step_logits.extend(steps[:max_new])
        return ids

    def _texts(self, rows) -> List[str]:
        eos = self.spec.text_cfg.eos_id
        out = []
        for row in rows:
            ids = []
            for v in row:
                if v == eos:
                    break
                ids.append(int(v))
            out.append(self.tokenizer.decode(ids))
        return out

    @torch.no_grad()
    def generate(self, images: Sequence[np.ndarray], instruction: str = "OCR:",
                 *, max_new_tokens: int = 64,
                 token_ids: Optional[list] = None) -> List[str]:
        """Batched greedy generation: prompts are LEFT-padded to the batch
        max, the pad slots masked through ``KVCache.pad``, the delta
        layers' through the pad mask. ``token_ids``, when a list, receives
        each row's ``max_new_tokens`` ids."""
        if not images:
            return []
        prepared = [self.prepare_prompt(img, instruction) for img in images]
        b = len(prepared)
        max_len = max(t for _, _, t in prepared)
        mrope = prepared[0][1].ndim == 3
        pids = np.zeros((3, b, max_len) if mrope else (b, max_len), np.int32)
        valid = np.zeros((b,), np.int64)
        rows = []
        for i, (e, p, t) in enumerate(prepared):
            off = max_len - t
            rows.append(torch.nn.functional.pad(e, (0, 0, off, 0)))
            if mrope:
                pids[:, i, off:] = p[:, 0]
            else:
                pids[i, off:] = p[0]
            valid[i] = t
        embeds = torch.cat(rows, 0).float()
        capacity = decoder_cache_capacity(max_len, max_new_tokens)
        toks = self.prefill_decode(embeds, self._put(pids).long(),
                                   self._put(valid), max_new=max_new_tokens,
                                   capacity=capacity).cpu().numpy()
        if token_ids is not None:
            token_ids.extend(r.tolist() for r in toks)
        return self._texts(toks.tolist())

    # ------------------ speculative generation (batch-1) ------------------
    def ngram_state(self, capacity: int, hist_cap: int, k: int,
                    ngram: int) -> RoundState:
        """The n-gram round key's state (batch 1): the static KV cache and
        delta carry, the history (1, hist_cap + 1) int32 (its last column
        takes the writes past the cap) and its length (1,) int32."""
        c = self.spec.text_cfg

        def make():
            dstate, conv = self.empty_states(1)
            return RoundState(
                self.new_cache(1, capacity), k, ngram=ngram, dstate=dstate,
                conv=conv, delta_idx=torch.as_tensor(
                    c.delta_layers(), dtype=torch.int64, device=self.device),
                hist=torch.full((1, hist_cap + 1), -1, dtype=torch.int32,
                                device=self.device),
                hist_len=torch.zeros((1,), dtype=torch.int32,
                                     device=self.device))

        return self.spec_rounds.state((capacity, hist_cap, k, ngram), make)

    def _ngram_draft_half(self, st: RoundState, _bucket) -> None:
        st.drafts.copy_(ngram_draft(st.hist[:, :-1], st.hist_len, k=st.k,
                                    n=st.ngram))

    def _ngram_verify_half(self, st: RoundState) -> torch.Tensor:
        """The n-gram round's verify (``exact_models.py:533-566``), in
        place on the device: [tok, drafts] at slot ``wpos``, the KV cache
        trimmed to the accepted length, the delta layers resumed from the
        block's per-step states at the accepted position (``index_select``
        into the static carry), and the emitted ids written into the
        history, which JAX's host loop appends (``:635-647``)."""
        k = st.k
        block = torch.cat([st.tok[:, None], st.drafts], 1)      # (1, K+1)
        logits, _, step_ds, step_cs = self.net.decode_block(
            block, self._step_pids(st.cpos, k + 1), st.cache, st.wpos,
            st.dstate, st.conv, collect_states=True)
        res = verify_draft(st.drafts, logits)
        a = res.accepted
        st.cache.trim_to(st.wpos + 1 + a[0])
        if st.delta_idx.numel():
            # step_ds holds the DELTA layers only, (Ld, B, T, …)
            at = a[:1].long()
            st.dstate.index_copy_(0, st.delta_idx,
                                  step_ds.index_select(2, at)[:, :, 0])
            st.conv.index_copy_(0, st.delta_idx,
                                step_cs.index_select(2, at)[:, :, 0])
        cap = st.hist.shape[1] - 1
        j = torch.arange(k + 1, device=a.device)[None]
        col = st.hist_len.long()[:, None] + j
        col = torch.where((j <= a[:, None]) & (col < cap), col, cap)
        st.hist.scatter_(1, col, res.next_tokens)
        st.hist_len.copy_(torch.clamp(st.hist_len + a + 1, max=cap))
        st.commit(res.next_tokens, a,
                  res.next_tokens.gather(1, a.long()[:, None])[:, 0])
        return logits

    @torch.no_grad()
    def ngram_start(self, embeds: torch.Tensor, pids: torch.Tensor,
                    prompt_ids: Sequence[int], *, max_new_tokens: int,
                    draft_k: int, ngram: int) -> RoundState:
        """Prefill one prompt (``prepare_prompt``'s embeddings and int64
        positions) into its n-gram round key's static buffers and load
        the first round's inputs: the first token, the history of the
        prompt's TEXT ids ``prompt_ids`` and that token, the next
        position (``exact_models.py:600-633``) → the key's state."""
        t = embeds.shape[1]
        capacity = decoder_cache_capacity(t, max_new_tokens + draft_k + 1)
        prompt_ids = list(prompt_ids)
        hist_cap = int(decoder_cache_capacity(
            len(prompt_ids) + 1, max_new_tokens + draft_k + 1))
        st = self.ngram_state(capacity, hist_cap, draft_k, ngram)
        cache = st.cache.reset()
        mask = _causal_prefill_mask(1, t, capacity, self.device)
        st.dstate.zero_()
        st.conv.zero_()
        logits, _, _ = self.net.prefill(embeds, pids, cache, mask,
                                        st.dstate, st.conv)
        cache.advance(t)
        tok = logits.argmax(-1).to(torch.int32)             # (1,)
        hist = np.full((1, hist_cap + 1), -1, np.int32)
        hist[0, :len(prompt_ids)] = prompt_ids
        hist[0, len(prompt_ids)] = int(tok[0])
        st.hist.copy_(self._put(hist))
        st.hist_len.fill_(len(prompt_ids) + 1)
        st.begin(tok, t, self._npos(pids))
        return st

    @torch.no_grad()
    def generate_speculative(self, images: Sequence[np.ndarray],
                             instruction: str = "OCR:", *,
                             max_new_tokens: int = 64, draft_k: int = 6,
                             ngram: int = 2, stats: Optional[dict] = None,
                             token_ids: Optional[list] = None
                             ) -> List[str]:
        """Greedy-exact speculative decoding for any exact stack, hybrid
        delta-layer decoders (OvisOCR2) included: training-free n-gram
        drafts, every emitted token a target argmax, so the ids are
        :meth:`generate`'s and only latency differs. Batch 1 per image;
        on the card the rounds replay their graphs. ``stats`` accumulates
        rounds, drafted, accepted, emitted; ``token_ids``, when a list,
        receives each image's emitted ids."""
        c = self.spec.text_cfg
        out: List[str] = []
        for image in images:
            embeds, pids, _ = self.prepare_prompt(image, instruction)
            st = self.ngram_start(embeds, self._put(pids).long(),
                                  self.tokenizer.encode(instruction),
                                  max_new_tokens=max_new_tokens,
                                  draft_k=draft_k, ngram=ngram)
            rounds: List[int] = []
            ids = self.spec_rounds.decode(st, int(st.tok[0]), max_new_tokens,
                                          c.eos_id, rounds=rounds)
            add_stats(stats, rounds, draft_k)
            if token_ids is not None:
                token_ids.append(ids)
            out.extend(self._texts([ids]))
        return out


def add_stats(stats: Optional[dict], rounds: List[int], k: int) -> None:
    """Add a request's rounds (their accept counts) to ``stats``: rounds,
    drafted, accepted and emitted tokens."""
    if stats is None:
        return
    for key, n in (("rounds", len(rounds)), ("drafted", k * len(rounds)),
                   ("accepted", sum(rounds)),
                   ("emitted", sum(rounds) + len(rounds))):
        stats[key] = stats.get(key, 0) + n


# ----------------------------- family factories -----------------------------

def family_spec(family: str, tiny: bool = False):
    """(spec, vision config) of an exact family: ``mineru``, ``glmocr``,
    ``ovisocr2``, ``hpd_parsing``, ``monkeyocrv2`` or ``mineru_diffusion``
    (the factories' wiring, ``exact_models.py:664-712, 904-911``)."""
    def text(cfg, **kw):
        return _tiny_text(cfg, **kw) if tiny else cfg

    def vision(cls):
        return cls().tiny() if tiny else cls()

    if family == "mineru":
        return (ExactVLMSpec("mineru", text(MINERU_TEXT,
                                            mrope_sections=(2, 2, 2)),
                             "qwen2vl", "visual", "model", "lm_head",
                             mrope_images=True),
                vision(MinerUVisionConfig))
    if family == "glmocr":
        return (ExactVLMSpec("glmocr", text(GLM_TEXT), "glm", "model.visual",
                             "model.language_model", "lm_head"),
                vision(GlmVisionConfig))
    if family == "ovisocr2":
        return (ExactVLMSpec("ovisocr2", text(OVIS_TEXT, layers=4,
                                              linear_head_dim=8),
                             "ovis", "model.visual", "model.language_model",
                             "lm_head"),
                vision(OvisVisionConfig))
    if family == "hpd_parsing":
        # the checkpoint keeps the tower at the ROOT (vision_model.,
        # mlp1.); the JAX package nests it under "hpd_vision"
        return (ExactVLMSpec("hpd_parsing", text(SDAR_TEXT), "internvit",
                             "hpd_vision", "language_model.model",
                             "language_model.lm_head"),
                vision(HpdVisionConfig))
    if family == "monkeyocrv2":
        return (ExactVLMSpec("monkeyocrv2", text(SDAR_TEXT), "monkey",
                             "vision_tower", "model", "lm_head"),
                vision(MonkeyVisionConfig))
    if family == "mineru_diffusion":
        return (ExactVLMSpec("mineru_diffusion", text(SDAR_TEXT), "qwen2vl",
                             "vision_tower", "language_model.model",
                             "language_model.lm_head"),
                vision(MinerUVisionConfig))
    raise InvalidInputError("unknown exact VLM family", family=family)


def mineru_exact(tiny: bool = False, **kw) -> ExactVLM:
    return ExactVLM(*family_spec("mineru", tiny), **kw)


def glm_exact(tiny: bool = False, **kw) -> ExactVLM:
    return ExactVLM(*family_spec("glmocr", tiny), **kw)


def ovis_exact(tiny: bool = False, **kw) -> ExactVLM:
    return ExactVLM(*family_spec("ovisocr2", tiny), **kw)


def hpd_exact(tiny: bool = False, **kw) -> ExactVLM:
    return ExactVLM(*family_spec("hpd_parsing", tiny), **kw)


def monkey_exact(tiny: bool = False, **kw) -> ExactVLM:
    return ExactVLM(*family_spec("monkeyocrv2", tiny), **kw)


# Registry name → exact-stack factory
EXACT_FACTORIES = {
    "mineru-2.5": mineru_exact,
    "mineru-2.5-pro": mineru_exact,
    "glm-ocr": glm_exact,
    "ovisocr2-0.8b": ovis_exact,
    "hpd-parsing-1b": hpd_exact,
    "monkeyocrv2-s": monkey_exact,
    "monkeyocrv2-b": monkey_exact,
}


# Registry name → exact family (the converter builds the network alone)
REGISTRY_FAMILIES = {
    "mineru-2.5": "mineru", "mineru-2.5-pro": "mineru",
    "glm-ocr": "glmocr", "ovisocr2-0.8b": "ovisocr2",
    "hpd-parsing-1b": "hpd_parsing", "monkeyocrv2-s": "monkeyocrv2",
    "monkeyocrv2-b": "monkeyocrv2", "mineru-diffusion-v1": "mineru_diffusion",
}


def exact_from_registry(name: str, **kw):
    """Construct the exact architecture for a VLM registry entry
    (``registry/models.py`` names). PaddleOCR-VL and HunyuanOCR have their
    own full modules (``vl/model.PaddleOCRVL``, ``vl/hunyuan.
    HunyuanOCRModel``)."""
    tiny = kw.pop("tiny", False)
    if name.startswith("paddleocr-vl"):
        from .model import PaddleOCRVL
        from .paddleocr_vl import PaddleOCRVLConfig

        cfg = PaddleOCRVLConfig().tiny() if tiny else PaddleOCRVLConfig()
        return PaddleOCRVL(cfg=cfg, **kw)
    if name.startswith("hunyuanocr"):
        from .hunyuan import HunyuanOCRConfig, HunyuanOCRModel

        cfg = HunyuanOCRConfig().tiny() if tiny else HunyuanOCRConfig()
        return HunyuanOCRModel(cfg=cfg, **kw)
    kw["tiny"] = tiny
    if name == "mineru-diffusion-v1":
        return mineru_diffusion_exact(**kw)
    try:
        factory = EXACT_FACTORIES[name]
    except KeyError:
        raise InvalidInputError("unknown exact VLM registry name",
                                name=name,
                                known=sorted(EXACT_FACTORIES)) from None
    return factory(**kw)


class SdarDiffusionExact(ExactVLM):
    """MinerU-Diffusion on the exact stack: SDAR/Qwen3 decoder + MinerU
    tower, decoding by block diffusion (bidirectional trials → confidence
    unmasking → causal KV commit; ``vl/diffusion.py``'s schedule). The
    trial and the commit are the passes of ``vl/diffusion.DiffusionBlocks``
    on one (block length, KV capacity) key's static buffers, CUDA graphs
    on the card, at the 0-d device slot ``wpos``; each trial writes the
    block's K/V (K4 at the device slot over L rows) and is rolled back
    (``trim_to(wpos)``) before the next pass, which writes the same
    slots."""

    MASK_TOKEN_OFFSET = 1

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # one state per (block length, capacity)
        self.diffusion = DiffusionBlocks(self._trial_pass,
                                         self._commit_pass)

    def diffusion_state(self, block_len: int, capacity: int) -> BlockState:
        """The key's state: the static cache, the block's positions
        ((3, 1, L) MRoPE or (1, L), int64) and the delta carry."""
        c = self.spec.text_cfg

        def make():
            dstate, conv = self.empty_states(1)
            shape = ((3, 1, block_len) if c.rope_kind == "mrope"
                     else (1, block_len))
            return BlockState(
                self.new_cache(1, capacity),
                torch.zeros(shape, dtype=torch.int64, device=self.device),
                c.vocab_size - self.MASK_TOKEN_OFFSET, dstate=dstate,
                conv=conv)

        return self.diffusion.state((block_len, capacity), make)

    def _trial_pass(self, st: BlockState, feed: torch.Tensor):
        logits, _, _, _ = self.net.decode_block(
            feed, st.positions, st.cache, st.wpos, st.dstate, st.conv,
            bidirectional=True)
        return logits

    def _commit_pass(self, st: BlockState) -> None:
        self.net.decode_block(st.tokens, st.positions, st.cache, st.wpos,
                              st.dstate, st.conv)

    @torch.no_grad()
    def diffusion_start(self, embeds: torch.Tensor, pids: torch.Tensor, *,
                        max_new_tokens: int, block_len: int,
                        confidence_threshold: float) -> BlockState:
        """Prefill one prompt (``prepare_prompt``'s embeddings and int64
        positions) into its key's static buffers and load the first
        block (``exact_models.py:786-800``) → the key's state."""
        t = embeds.shape[1]
        n_blocks = max(1, -(-max_new_tokens // block_len))
        capacity = decoder_cache_capacity(t, n_blocks * block_len
                                          + block_len)
        st = self.diffusion_state(block_len, capacity)
        cache = st.cache.reset()
        st.dstate.zero_()
        st.conv.zero_()
        mask = _causal_prefill_mask(1, t, capacity, self.device)
        self.net.prefill(embeds, pids, cache, mask, st.dstate, st.conv)
        cache.advance(t)
        st.begin(t, t + torch.arange(block_len, device=self.device),
                 confidence_threshold)
        return st

    @torch.no_grad()
    def generate(self, images, instruction: str = "OCR:", *,
                 max_new_tokens: int = 64, block_len: int = 8,
                 num_unmask_steps: int = 4,
                 confidence_threshold: float = 0.9, token_ids=None):
        """Block-diffusion decoding, one image at a time: the passes
        replay their graphs on the card. ``token_ids``, when a list,
        receives each image's ids."""
        c = self.spec.text_cfg
        n_blocks = max(1, -(-max_new_tokens // block_len))
        out = []
        for image in images:
            embeds, pids, _ = self.prepare_prompt(image, instruction)
            st = self.diffusion_start(
                embeds, self._put(pids).long(),
                max_new_tokens=max_new_tokens, block_len=block_len,
                confidence_threshold=confidence_threshold)
            ids = self.diffusion.decode(st, n_blocks, num_unmask_steps,
                                        c.eos_id)
            if token_ids is not None:
                token_ids.append(ids[:max_new_tokens])
            out.append(self.tokenizer.decode(ids[:max_new_tokens]))
        return out


def mineru_diffusion_exact(tiny: bool = False, **kw) -> SdarDiffusionExact:
    return SdarDiffusionExact(*family_spec("mineru_diffusion", tiny), **kw)


class GlmSpeculativeExact(ExactVLM):
    """GLM-OCR with its trained MTP draft on the exact stack: the draft
    (``llm_decoders.GlmMtpHead``) proposes K tokens recurrently from
    (prev_hidden, token), one causal target pass verifies them;
    greedy-exact by construction. ``mtp_state_dict`` holds the draft's
    weights; without one they are seeded from 11, as the JAX draft's."""

    def __init__(self, spec, vision_cfg, state_dict=None, *,
                 draft_k: int = 4, mtp_state_dict=None, **kw):
        super().__init__(spec, vision_cfg, state_dict, **kw)
        self.draft_k = draft_k
        dev = self.device
        with torch.device("meta"):
            mtp = GlmMtpHead(spec.text_cfg)
        if mtp_state_dict is None:
            mtp_state_dict = init_state_dict(
                mtp, torch.Generator(device=dev).manual_seed(11))
        mtp.load_state_dict(mtp_state_dict, strict=True, assign=True)
        self.mtp = mtp.eval().requires_grad_(False).to(device=dev,
                                                       dtype=torch.float32)
        # the MTP rounds, one state per (capacity, k)
        self.mtp_rounds = SpecRounds(self._mtp_draft_half,
                                     self._mtp_verify_half)

    def mtp_state(self, capacity: int, k: int) -> RoundState:
        """The MTP round key's state (batch 1): the static target cache,
        the draft's one-layer cache, its prev-hidden (1, hidden) and the
        zero delta states the verify block takes."""
        def make():
            dstate, conv = self.empty_states(1)
            return RoundState(
                self.new_cache(1, capacity), k,
                mtp_cache=self.new_cache(1, capacity, layers=1),
                h=torch.zeros((1, self.spec.text_cfg.hidden),
                              dtype=torch.float32, device=self.device),
                dstate=dstate, conv=conv)

        return self.mtp_rounds.state((capacity, k), make)

    def _mtp_draft_half(self, st: RoundState, _bucket) -> None:
        """k draft steps through the MTP layer at slots and positions
        wpos + i of its own cache, each from the last step's hidden and
        token (``exact_models.py:889-905``), on the device."""
        b = st.tok.shape[0]
        mc = st.mtp_cache
        col = torch.arange(mc.capacity, device=st.tok.device)[None, None,
                                                             None]
        cur_tok, cur_h = st.tok, st.h
        for i in range(st.k):
            pos = st.wpos + i
            mask = col < (mc.length[:, None, None, None] + 1)
            logits, hid, _ = self.mtp(cur_tok[:, None], cur_h[:, None],
                                      pos.expand(b, 1), mc, pos, mask)
            mc.advance(1)
            cur_h = hid[:, -1]
            cur_tok = logits[:, -1].argmax(-1).to(torch.int32)
            st.drafts[:, i] = cur_tok

    def _mtp_verify_half(self, st: RoundState) -> torch.Tensor:
        """[tok, drafts] through the target at slot ``wpos``, both caches
        trimmed to the accepted length and the draft's next prev-hidden
        the TARGET hidden at the last accepted position
        (``exact_models.py:907-930``), on the device."""
        k = st.k
        block = torch.cat([st.tok[:, None], st.drafts], 1)
        bpids = (st.wpos + torch.arange(k + 1, device=st.tok.device))[None]
        t_logits, t_hidden, _, _ = self.net.decode_block(
            block, bpids, st.cache, st.wpos, st.dstate, st.conv)
        res = verify_draft(st.drafts, t_logits)
        a = res.accepted
        st.cache.trim_to(st.wpos + 1 + a[0])
        st.mtp_cache.trim_to(st.wpos + 1 + a[0])
        at = a.long()[:, None]
        st.h.copy_(t_hidden.gather(1, at[:, :, None].expand(
            -1, 1, t_hidden.shape[-1]))[:, 0])
        st.commit(res.next_tokens, a, res.next_tokens.gather(1, at)[:, 0])
        return t_logits

    @torch.no_grad()
    def mtp_start(self, embeds: torch.Tensor, pids: torch.Tensor, *,
                  max_new_tokens: int) -> RoundState:
        """Prefill one prompt (``prepare_prompt``'s embeddings and int64
        positions; every hidden state kept) into its MTP round key's
        static buffers, then the MTP prefill over the prompt: position j
        consumes (embeds[j+1], hidden[j]), the last pair the first
        generated token's embedding (``exact_models.py:960-975``) → the
        key's state."""
        k = self.draft_k
        t = embeds.shape[1]
        capacity = decoder_cache_capacity(t, max_new_tokens + k + 1)
        st = self.mtp_state(capacity, k)
        cache, mtp_cache = st.cache.reset(), st.mtp_cache.reset()
        mask = _causal_prefill_mask(1, t, capacity, self.device)
        logits, hiddens, _, _ = self.net.prefill_hidden_all(
            embeds, pids, cache, mask, st.dstate, st.conv)
        cache.advance(t)
        tok = logits.argmax(-1).to(torch.int32)
        emb_mtp = torch.cat([embeds[:, 1:], self.net.embed(tok[:, None])], 1)
        self.mtp(None, hiddens, torch.arange(t, device=self.device)[None],
                 mtp_cache, 0, mask, emb=emb_mtp)
        mtp_cache.advance(t)
        st.h.copy_(hiddens[:, -1])      # target hidden, not an embedding
        st.begin(tok, t)
        return st

    @torch.no_grad()
    def generate_speculative(self, images, instruction: str = "OCR:", *,
                             max_new_tokens: int = 64,
                             stats: Optional[dict] = None,
                             token_ids: Optional[list] = None):
        """MTP speculative decoding, batch 1 per image; on the card the
        rounds replay their graphs. ``stats``
        and ``token_ids`` as :meth:`ExactVLM.generate_speculative`'s."""
        c = self.spec.text_cfg
        out = []
        for image in images:
            embeds, pids, _ = self.prepare_prompt(image, instruction)
            st = self.mtp_start(embeds, self._put(pids).long(),
                                max_new_tokens=max_new_tokens)
            rounds: List[int] = []
            ids = self.mtp_rounds.decode(st, int(st.tok[0]), max_new_tokens,
                                         c.eos_id, rounds=rounds)
            add_stats(stats, rounds, self.draft_k)
            if token_ids is not None:
                token_ids.append(ids)
            out.append(self.tokenizer.decode([i for i in ids
                                              if i != c.eos_id]))
        return out


def glm_speculative_exact(tiny: bool = False, **kw) -> GlmSpeculativeExact:
    return GlmSpeculativeExact(*family_spec("glmocr", tiny), **kw)


class HpdForkExact(ExactVLM):
    """HPD-Parsing fork decoding on the exact stack (InternViT tiles +
    SDAR decoder), driven by the continuous-batching scheduler
    (``vl/hpd_scheduler.py``): every emitted ``<FORK>`` spawns a child
    whose KV is the parent's cache at the fork position; children join
    the running decode batch with admission priority; P-MTP drafts
    tokens per branch per round."""

    FORK_TOKEN = "<FORK>"
    CHILD_TOKEN = "<CHILD>"
    # ByteTokenizer reserves ids 0..127 for specials (vl/model.py); the
    # real checkpoint config pins 151679/151680 (hpd config.rs:54-55)
    DEV_FORK_ID = 2
    DEV_CHILD_ID = 3

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        c = self.spec.text_cfg
        # the slot pools' rows, shared by both modes' schedulers (they
        # never run at once)
        self.slot_rows = RowBuffers(c.layers, c.kv_heads, c.head_dim)

    def _special_ids(self):
        fork = self.tokenizer.encode(self.FORK_TOKEN)
        child = self.tokenizer.encode(self.CHILD_TOKEN)
        if len(fork) == 1 and len(child) == 1:
            return fork[0], child[0]
        return self.DEV_FORK_ID, self.DEV_CHILD_ID

    def scheduler(self, use_mtp: bool):
        """The scheduler of one mode, made once (its P-MTP head seeded
        from 11, as the JAX one)."""
        from .hpd_scheduler import HpdContinuousScheduler

        key = "_sched_mtp" if use_mtp else "_sched"
        sched = getattr(self, key, None)
        if sched is None:
            fork_id, child_id = self._special_ids()
            sched = HpdContinuousScheduler(
                self, fork_token_id=fork_id, child_token_id=child_id)
            setattr(self, key, sched)
        return sched

    @torch.no_grad()
    def parse_with_forks(self, image: np.ndarray, *,
                         instruction: str = "Parse:",
                         max_new_tokens: int = 48, max_children: int = 8,
                         use_mtp: bool = False,
                         num_speculative_tokens: int = 6,
                         max_active_branches: int = 64):
        """The prompt's prefill, then the fork scheduler's rounds, each
        a replay of its slot pool's CUDA graph on the card
        (``vl/hpd_scheduler.py``)."""
        from .hpd_scheduler import HpdSchedulerConfig

        c = self.spec.text_cfg
        embeds, pids, t = self.prepare_prompt(image, instruction)
        capacity = decoder_cache_capacity(t + max_new_tokens, max_new_tokens)
        cache = self.new_cache(1, capacity)
        mask = _causal_prefill_mask(1, t, capacity, self.device)
        logits, hidden, _, _ = self.net.prefill_hidden_all(
            embeds, self._put(pids).long(), cache, mask,
            *self.empty_states(1))
        cache.advance(t)
        first = int(logits.argmax(-1)[0])

        sched = self.scheduler(use_mtp)
        out = sched.run(cache, first, hidden[:, -1],
                        HpdSchedulerConfig(
                            max_new_tokens=max_new_tokens, use_mtp=use_mtp,
                            num_speculative_tokens=num_speculative_tokens,
                            max_active_branches=max_active_branches))

        drop = {c.eos_id, sched.fork_token_id, sched.child_token_id}
        parent = self.tokenizer.decode(
            [i for i in out.parent_tokens if i not in drop])
        children = [self.tokenizer.decode([i for i in row if i not in drop])
                    for row in out.children[:max_children]]
        st = out.stats
        # stats mirror HpdRuntimeStats (hpd_parsing/model.rs:71)
        return {"parent": parent, "children": children,
                "token_ids": out.token_ids,
                "stats": {"prefix_len": t,
                          "parent_tokens": sum(
                              1 for i in out.parent_tokens if i != c.eos_id),
                          "num_children": len(out.children),
                          "child_tokens": sum(
                              sum(1 for i in row if i != c.eos_id)
                              for row in out.children),
                          "scheduler_rounds": st.scheduler_rounds,
                          "peak_active_branches": st.peak_active_branches,
                          "forked_branches": st.forked_branches,
                          "shared_prefix_tokens": st.shared_prefix_tokens,
                          "mtp_drafted_tokens": st.mtp_drafted_tokens,
                          "mtp_accepted_tokens": st.mtp_accepted_tokens}}


def hpd_fork_exact(tiny: bool = False, **kw) -> HpdForkExact:
    return HpdForkExact(*family_spec("hpd_parsing", tiny), **kw)
