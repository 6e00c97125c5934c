"""The causal-LM decoder the VLM families share.

Counterpart of ``oar_ocr_tpu/vl/decoder.py``: one configurable decoder
over the design space the families span — standard RoPE, 3-axis MRoPE or
XDRoPE tables; GQA attention, SwiGLU MLP and RMSNorm; each layer either
full attention over the KV cache (:class:`AttnLayer`) or a gated-delta
linear-attention layer with an O(1) recurrent state
(:class:`DeltaLayer`, OvisOCR2's hybrid). Module names are the flax
ones (``lm.layer0.q``, ``lm.layer0.SwiGLU_0.gate_proj``), so a JAX
parameter tree converts by ``runtime/weights.params_from_jax``.

Kernels: each layer's ``x + o`` followed by its post-norm, and the next
layer's ``x + mlp`` followed by its input norm, run the residual add +
RMSNorm kernel (K3, ``ops/fused_norm_rope.fused_add_rmsnorm``) as the
port's Ernie decoder does: the layers hand on ``(residual, delta)``, the
first layer's input norm is the plain :class:`RMSNorm`, and the final
norm is the last K3 site, 2 per layer and forward. The attention is the
plain ``vl/attention.scaled_dot_product_attention``, as on the other VL
decoders. The delta layers run ``vl/gated_delta.py``: the scan for one
token, the chunked form for more.

Tensor parallelism (``parallel/tp.py``, a Runtime with ``n_model`` > 1):
:class:`TensorParallelLM` drives one :class:`CausalLM` a ``model`` shard,
each holding its q/k/v/gate/up/lm_head rows and o/down columns, in
lockstep from the one host thread. Each layer runs :meth:`AttnLayer.attend`
on every shard, all-reduces the partial ``o`` (where GSPMD inserts it),
runs :meth:`AttnLayer.feed_forward` (K3 on each shard's copy of the
replicated residual) and all-reduces the partial ``down_proj``; the
logits of the column-parallel LM head are gathered before the argmax.
The delta layers have no tensor-parallel form yet and raise
``ConfigError``.

Return values follow the JAX methods without the cache, which is
updated in place (``vl/kv_cache.py``). The JAX rope tables of a
``mrope`` or ``xdrope`` config whose sections do not cover head_dim / 2
fail to broadcast in the first forward; :func:`check_rope_sections`
raises ``ConfigError`` for them before any weight is made.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..errors import ConfigError
from ..ops.fused_norm_rope import fused_add_rmsnorm
from .attention import (apply_rope, create_generation_mask, mrope_cos_sin,
                        scaled_dot_product_attention)
from .gated_delta import gated_delta_rule, gated_delta_rule_chunked
from .kv_cache import KVCache, ShardedKVCache
from .paddleocr_vl import ErnieMlp, RMSNorm

EPS = 1e-6   # flax RMSNorm's default, which every decoder norm takes


@dataclass(frozen=True)
class DecoderConfig:
    """``decoder.py:37-64``, value for value."""

    vocab_size: int = 32000
    hidden: int = 1024
    layers: int = 16
    heads: int = 16
    kv_heads: int = 4
    ffn: int = 3072
    rope_theta: float = 10000.0
    rope_kind: str = "rope"                      # rope | mrope | xdrope
    mrope_sections: Tuple[int, ...] = (16, 8, 8)
    xdrope_sections: Tuple[int, ...] = (24, 4, 4)
    # layer kinds, cycled over depth: "attn" or "delta"
    layer_pattern: Tuple[str, ...] = ("attn",)
    eos_id: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    def kind(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def tiny(self, **overrides) -> "DecoderConfig":
        base = dataclasses.replace(
            self, vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2,
            ffn=128, mrope_sections=(4, 2, 2), xdrope_sections=(4, 2, 2))
        return dataclasses.replace(base, **overrides)


def check_rope_sections(cfg: DecoderConfig) -> None:
    """A ``mrope``/``xdrope`` config's sections must sum to head_dim / 2:
    its tables are that wide, and the rotary multiplies them into each
    half of a head."""
    if cfg.rope_kind in ("mrope", "xdrope"):
        sections = (cfg.mrope_sections if cfg.rope_kind == "mrope"
                    else cfg.xdrope_sections)
        if sum(sections) != cfg.head_dim // 2:
            raise ConfigError(
                f"{cfg.rope_kind} sections must sum to head_dim / 2",
                sections=tuple(sections), head_dim=cfg.head_dim,
                hidden=cfg.hidden, heads=cfg.heads)


def _rope_tables(cfg: DecoderConfig, position_ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """position_ids (3, B, T) for mrope/xdrope, (B, T) or (3, B, T) for
    rope → float32 cos/sin (B, T, head_dim / 2) (``decoder.py:67-86``)."""
    if cfg.rope_kind == "mrope":
        return mrope_cos_sin(position_ids, cfg.head_dim, cfg.mrope_sections,
                             cfg.rope_theta)
    if cfg.rope_kind == "xdrope":
        return mrope_cos_sin(position_ids, cfg.head_dim,
                             cfg.xdrope_sections, cfg.rope_theta)
    pos = position_ids if position_ids.ndim == 2 else position_ids[0]
    d = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=pos.device) / d))
    freqs = pos[..., None].float() * inv
    return freqs.cos(), freqs.sin()


def _norm(residual, delta, norm: RMSNorm):
    """A layer's input norm: plain before layer 0, else K3 on
    residual + delta. Returns (normed, the new residual)."""
    if delta is None:
        return norm(residual), residual
    return fused_add_rmsnorm(delta, residual, norm.weight, eps=EPS)


class AttnLayer(nn.Module):
    """Full attention over the KV cache (``decoder.py:89-115``).

    The head counts are read from the projections' widths, so a
    ``model`` shard's layer (``parallel/tp.partition_module``) attends
    over its own q heads and the kv heads they read (:meth:`tp_splits`);
    its ``o`` and MLP ``down_proj`` then give partial sums, which the
    caller all-reduces between :meth:`attend` and :meth:`feed_forward`
    (:class:`TensorParallelLM`)."""

    def __init__(self, cfg: DecoderConfig, layer_idx: int):
        super().__init__()
        self.cfg, self.layer_idx = cfg, layer_idx
        hd = cfg.head_dim
        self.input_norm = RMSNorm(cfg.hidden, EPS)
        self.q = nn.Linear(cfg.hidden, cfg.heads * hd, bias=False)
        self.k = nn.Linear(cfg.hidden, cfg.kv_heads * hd, bias=False)
        self.v = nn.Linear(cfg.hidden, cfg.kv_heads * hd, bias=False)
        self.o = nn.Linear(cfg.heads * hd, cfg.hidden, bias=False)
        self.post_norm = RMSNorm(cfg.hidden, EPS)
        self.SwiGLU_0 = ErnieMlp(cfg.hidden, cfg.ffn)

    def tp_splits(self, n: int):
        """Each of ``n`` shards' k/v rows: the kv heads its q heads read
        (contiguous q heads a shard; a kv head shared by the q heads of
        several shards is replicated on each)."""
        c = self.cfg
        hq, hk, hd = c.heads, c.kv_heads, c.head_dim
        per = hq // n
        group = hq // hk
        if hq % n or (per % group and group % per):
            raise ConfigError("tensor parallelism needs the q heads to "
                              "divide over the model shards along whole "
                              "kv groups", heads=hq, kv_heads=hk, n_model=n)
        rows = [slice(s * per // group * hd,
                      ((s + 1) * per - 1) // group * hd + hd)
                for s in range(n)]
        return {"k.weight": rows, "v.weight": rows}

    def attend(self, residual, delta, cos, sin, cache: KVCache, pos, mask):
        """The input norm, the attention and ``o`` → (o (B, T, hidden),
        the residual): a shard's partial ``o`` under tensor
        parallelism."""
        hd = self.cfg.head_dim
        hq, hk = self.q.out_features // hd, self.k.out_features // hd
        h, residual = _norm(residual, delta, self.input_norm)
        b, t, _ = h.shape
        q = self.q(h).view(b, t, hq, hd).transpose(1, 2)
        k = self.k(h).view(b, t, hk, hd).transpose(1, 2)
        v = self.v(h).view(b, t, hk, hd).transpose(1, 2)
        q = apply_rope(q, cos[:, None], sin[:, None])
        k = apply_rope(k, cos[:, None], sin[:, None])
        cache.append(self.layer_idx, k, v, pos)
        ck, cv = cache.layer(self.layer_idx)
        o = scaled_dot_product_attention(q, ck, cv, mask)
        return self.o(o.transpose(1, 2).reshape(b, t, hq * hd)), residual

    def feed_forward(self, o, residual):
        """K3 on residual + o, then the MLP → (residual, its output): a
        shard's partial ``down_proj`` under tensor parallelism."""
        h, residual = fused_add_rmsnorm(o, residual, self.post_norm.weight,
                                        eps=EPS)
        return residual, self.SwiGLU_0(h)

    def forward(self, residual, delta, cos, sin, cache: KVCache, pos, mask,
                dstate, pad_mask=None):
        """(residual, delta) in and out, as the Ernie layers; ``dstate``
        passes through."""
        o, residual = self.attend(residual, delta, cos, sin, cache, pos,
                                  mask)
        residual, delta = self.feed_forward(o, residual)
        return residual, delta, dstate


class DeltaLayer(nn.Module):
    """Gated-delta linear attention with its state in slice
    ``layer_idx`` of the (L, B, H, D, D) float32 ``dstate``
    (``decoder.py:118-170``); the KV cache passes through."""

    def __init__(self, cfg: DecoderConfig, layer_idx: int):
        super().__init__()
        self.cfg, self.layer_idx = cfg, layer_idx
        hd = cfg.head_dim
        self.input_norm = RMSNorm(cfg.hidden, EPS)
        self.q = nn.Linear(cfg.hidden, cfg.heads * hd, bias=False)
        self.k = nn.Linear(cfg.hidden, cfg.heads * hd, bias=False)
        self.v = nn.Linear(cfg.hidden, cfg.heads * hd, bias=False)
        self.gates = nn.Linear(cfg.hidden, 2 * cfg.heads)
        self.o = nn.Linear(cfg.heads * hd, cfg.hidden, bias=False)
        self.post_norm = RMSNorm(cfg.hidden, EPS)
        self.SwiGLU_0 = ErnieMlp(cfg.hidden, cfg.ffn)

    def tp_splits(self, n: int):
        """Not split yet: a later slice shards the delta layers."""
        if n > 1:
            raise ConfigError("the gated-delta layers (OvisOCR2) have no "
                              "tensor-parallel form yet", n_model=n)
        return {}

    def forward(self, residual, delta, cos, sin, cache: KVCache, pos, mask,
                dstate, pad_mask=None):
        """``pad_mask`` (B, T) bool, True = a real token: a left-pad
        token neither decays nor writes the state (α = 1, β = 0)."""
        c = self.cfg
        hd = c.head_dim
        h, residual = _norm(residual, delta, self.input_norm)
        b, t, _ = h.shape
        g = self.gates(h).float()
        alpha = torch.sigmoid(g[..., :c.heads])
        beta = torch.sigmoid(g[..., c.heads:])
        if pad_mask is not None:
            beta = beta * pad_mask[:, :, None].to(beta.dtype)
            alpha = torch.where(pad_mask[:, :, None], alpha,
                                torch.ones_like(alpha))

        def heads(y):
            return y.view(b, t, c.heads, hd).transpose(1, 2)

        rule = gated_delta_rule if t <= 1 else gated_delta_rule_chunked
        o, s_final = rule(heads(self.q(h)), heads(self.k(h)),
                          heads(self.v(h)), alpha.transpose(1, 2),
                          beta.transpose(1, 2),
                          initial_state=dstate[self.layer_idx],
                          return_state=True)
        dstate[self.layer_idx] = s_final
        o = self.o(o.transpose(1, 2).reshape(b, t, c.heads * hd).to(h.dtype))
        h, residual = fused_add_rmsnorm(o, residual, self.post_norm.weight,
                                        eps=EPS)
        return residual, self.SwiGLU_0(h), dstate


class CausalLM(nn.Module):
    """Embedding, the layers (``layer0``, ``layer1``, …), the final norm
    and the LM head (``decoder.py:173-310``)."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.lm_head = nn.Linear(cfg.hidden, cfg.vocab_size, bias=False)
        for li in range(cfg.layers):
            cls = AttnLayer if cfg.kind(li) == "attn" else DeltaLayer
            self.add_module(f"layer{li}", cls(cfg, li))
        self.final_norm = RMSNorm(cfg.hidden, EPS)

    @property
    def decoder_layers(self):
        return [getattr(self, f"layer{li}") for li in range(self.cfg.layers)]

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        return self.tok_emb(ids.long())

    def empty_delta_state(self, batch: int, device=None) -> torch.Tensor:
        c = self.cfg
        return torch.zeros((c.layers, batch, c.heads, c.head_dim,
                            c.head_dim), dtype=torch.float32,
                           device=device)

    def trunk(self, embeds, position_ids, cache: KVCache, pos, mask,
              dstate: Optional[torch.Tensor] = None,
              aux_layers: Tuple[int, ...] = (), pad_mask=None):
        """The layers and the final norm → (normed (B, T, hidden), the
        delta state[, the hidden states after the 1-based ``aux_layers``,
        concatenated]). The delta layers update a given ``dstate`` in
        place (a decode graph's static buffer); without one they start
        from zero."""
        cos, sin = _rope_tables(self.cfg, position_ids)
        cos, sin = cos.to(embeds.dtype), sin.to(embeds.dtype)
        if dstate is None:
            dstate = self.empty_delta_state(embeds.shape[0], embeds.device)
        residual, delta = embeds, None
        aux = []
        for li, layer in enumerate(self.decoder_layers):
            residual, delta, dstate = layer(residual, delta, cos, sin, cache,
                                            pos, mask, dstate, pad_mask)
            if li + 1 in aux_layers:
                aux.append(residual + delta)
        out, _ = fused_add_rmsnorm(delta, residual, self.final_norm.weight,
                                   eps=EPS)
        if aux_layers:
            return out, dstate, torch.cat(aux, dim=-1)
        return out, dstate

    def logits_for(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.lm_head(hidden).float()

    def prefill(self, embeds, position_ids, cache: KVCache, mask,
                dstate=None, pad_mask=None):
        """→ (last-position logits (B, V), hidden (B, T, hidden), dstate);
        the caller advances the cache."""
        hidden, dstate = self.trunk(embeds, position_ids, cache, 0, mask,
                                    dstate, pad_mask=pad_mask)
        return self.logits_for(hidden[:, -1]), hidden, dstate

    def decode_step(self, tok_ids, position_ids, cache: KVCache, pos,
                    dstate=None):
        """One token per row at slot ``pos`` (an int, a 0-d device slot
        or per-row slots); advances the cache by 1 and updates ``dstate``
        in place → (logits (B, V), hidden, dstate)."""
        embeds = self.embed_tokens(tok_ids)[:, None, :]
        mask = create_generation_mask(cache.length + 1, cache.capacity,
                                      cache.pad)
        hidden, dstate = self.trunk(embeds, position_ids, cache, pos, mask,
                                    dstate)
        cache.advance(1)
        return self.logits_for(hidden[:, -1]), hidden, dstate

    def _block_mask(self, cache: KVCache, t: int, causal: bool):
        dev = cache.k.device
        cap_pos = torch.arange(cache.capacity, device=dev)[None, None, None, :]
        limit = cache.length[:, None, None, None] + (
            torch.arange(t, device=dev)[None, None, :, None] + 1 if causal
            else t)
        mask = (cap_pos < limit) & (cap_pos >= cache.pad[:, None, None, None])
        return mask.expand(cache.length.shape[0], 1, t, cache.capacity)

    def decode_block_bidir(self, tok_ids, position_ids, cache: KVCache, pos):
        """Every block position attends to the committed prefix and the
        whole block (SDAR's predictor, ``decoder.py:234-255``); advances
        the cache by T → (logits (B, T, V), hidden)."""
        t = tok_ids.shape[1]
        hidden, _ = self.trunk(self.embed_tokens(tok_ids), position_ids,
                               cache, pos, self._block_mask(cache, t, False))
        cache.advance(t)
        return self.logits_for(hidden), hidden

    def decode_block(self, tok_ids, position_ids, cache: KVCache, pos):
        """The causal verify pass over a (B, T) block at slot ``pos``
        (``decoder.py:257-275``); advances the cache by T → (logits
        (B, T, V), hidden)."""
        t = tok_ids.shape[1]
        hidden, _ = self.trunk(self.embed_tokens(tok_ids), position_ids,
                               cache, pos, self._block_mask(cache, t, True))
        cache.advance(t)
        return self.logits_for(hidden), hidden

    def prefill_aux(self, embeds, position_ids, cache: KVCache, mask,
                    aux_layers: Tuple[int, ...]):
        """Prefill + the DFlash taps → (logits (B, V), hidden, aux)."""
        hidden, _, aux = self.trunk(embeds, position_ids, cache, 0, mask,
                                    aux_layers=aux_layers)
        return self.logits_for(hidden[:, -1]), hidden, aux

    def decode_block_aux(self, tok_ids, position_ids, cache: KVCache, pos,
                         aux_layers: Tuple[int, ...]):
        """The causal verify block + the DFlash taps; advances the cache
        by T → (logits (B, T, V), hidden, aux)."""
        t = tok_ids.shape[1]
        hidden, _, aux = self.trunk(self.embed_tokens(tok_ids), position_ids,
                                    cache, pos,
                                    self._block_mask(cache, t, True),
                                    aux_layers=aux_layers)
        cache.advance(t)
        return self.logits_for(hidden), hidden, aux


class TensorParallelLM:
    """The :class:`CausalLM` API of the greedy decode over one shard a
    ``model`` device (``Runtime.put_params_vl``), run in lockstep:
    ``embed_tokens``, ``prefill`` and ``decode_step`` on a
    :class:`ShardedKVCache` (:meth:`new_cache`). The inputs and outputs
    lie on shard 0's device."""

    def __init__(self, shards):
        from ..parallel.mesh import on_device
        from ..parallel.tp import all_reduce, broadcast, gather_columns

        self._on, self._reduce = on_device, all_reduce
        self._broadcast, self._gather = broadcast, gather_columns
        self.shards = list(shards)
        self.cfg = self.shards[0].cfg
        self.devices = [sh.tok_emb.weight.device for sh in self.shards]
        self.device = self.devices[0]
        self._layers = [sh.decoder_layers for sh in self.shards]
        if any(not isinstance(layer, AttnLayer)
               for layers in self._layers for layer in layers):
            raise ConfigError("tensor parallelism covers the attention "
                              "layers only", n_model=len(self.shards))

    @property
    def single_device(self) -> bool:
        """Whether every shard lies on one device (then the all-reduces
        are plain sums; else NCCL across the cards)."""
        return len(set(self.devices)) == 1

    def kv_heads(self):
        """Each shard's kv heads (its k projection's width)."""
        hd = self.cfg.head_dim
        return [layers[0].k.out_features // hd for layers in self._layers]

    def new_cache(self, batch: int, capacity: int, dtype: torch.dtype,
                  device=None) -> ShardedKVCache:
        """A cache of ``capacity`` slots, each shard's kv heads on its
        device (``device``, shard 0's, is implied)."""
        return ShardedKVCache.create_sharded(
            self.cfg.layers, batch, self.kv_heads(), capacity,
            self.cfg.head_dim, dtype=dtype, devices=self.devices)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        return self.shards[0].embed_tokens(ids)

    def empty_delta_state(self, batch: int, device=None) -> torch.Tensor:
        return self.shards[0].empty_delta_state(batch, device)

    def _trunk(self, embeds, position_ids, cache: ShardedKVCache, pos,
               mask):
        """Every shard's normed output (B, T, hidden), each on its
        device."""
        cos, sin = _rope_tables(self.cfg, position_ids)
        cos, sin = cos.to(embeds.dtype), sin.to(embeds.dtype)
        devs = self.devices
        res, cs, sn, ps, ms = (self._broadcast(x, devs)
                               for x in (embeds, cos, sin, pos, mask))
        delta = [None] * len(devs)
        for li in range(self.cfg.layers):
            parts = []
            for s, d in enumerate(devs):
                with self._on(d):
                    parts.append(self._layers[s][li].attend(
                        res[s], delta[s], cs[s], sn[s], cache.shards[s],
                        ps[s], ms[s]))
            o = self._reduce([p[0] for p in parts])
            res = [p[1] for p in parts]
            outs = []
            for s, d in enumerate(devs):
                with self._on(d):
                    outs.append(self._layers[s][li].feed_forward(o[s],
                                                                 res[s]))
            res = [x[0] for x in outs]
            delta = self._reduce([x[1] for x in outs])
        normed = []
        for s, d in enumerate(devs):
            with self._on(d):
                normed.append(fused_add_rmsnorm(
                    delta[s], res[s], self.shards[s].final_norm.weight,
                    eps=EPS)[0])
        return normed

    def _logits(self, hidden) -> torch.Tensor:
        """The LM head's vocab shards of each shard's ``hidden``, gathered
        on shard 0's device, float32."""
        parts = []
        for sh, h, d in zip(self.shards, hidden, self.devices):
            with self._on(d):
                parts.append(sh.lm_head(h).float())
        return self._gather(parts, self.device)

    def prefill(self, embeds, position_ids, cache: ShardedKVCache, mask,
                dstate=None, pad_mask=None):
        """As :meth:`CausalLM.prefill`."""
        if dstate is None:
            dstate = self.empty_delta_state(embeds.shape[0], embeds.device)
        outs = self._trunk(embeds, position_ids, cache, 0, mask)
        return self._logits([o[:, -1] for o in outs]), outs[0], dstate

    def decode_step(self, tok_ids, position_ids, cache: ShardedKVCache, pos,
                    dstate=None):
        """As :meth:`CausalLM.decode_step`."""
        embeds = self.embed_tokens(tok_ids)[:, None, :]
        mask = create_generation_mask(cache.length + 1, cache.capacity,
                                      cache.pad)
        outs = self._trunk(embeds, position_ids, cache, pos, mask)
        cache.advance(1)
        return self._logits([o[:, -1] for o in outs]), outs[0], dstate
