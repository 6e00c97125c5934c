"""The exact per-family LLM decoders: one flag-driven decoder that emits
each family's checkpoint tree.

Counterpart of ``oar_ocr_tpu/vl/llm_decoders.py``, flag for flag:

- MinerU 2.5 — Qwen2-VL text: q/k/v with bias, o_proj bias-free, 3-axis
  MRoPE, RMSNorm pair, SwiGLU (``model.layers.{i}.self_attn.q_proj`` …);
- SDAR / Qwen3 (MinerU-Diffusion, MonkeyOCRv2, HPD-Parsing): bias-free
  projections + per-head q_norm/k_norm RMSNorms, standard RoPE;
- GLM-OCR: partial interleaved rotary, fused ``mlp.gate_up_proj``, the
  sandwich norms;
- OvisOCR2: hybrid layers — full attention with additive q/k RMSNorms
  ((1 + w)·x̂) and GatedDeltaNet layers (``in_proj_qkv/z/b/a``, the
  depthwise ``conv1d``, ``dt_bias``, ``A_log``, ``norm``, ``out_proj``)
  over the gated delta rule (``vl/gated_delta.py``).

The module tree is the HF checkpoint's; the raw flax parameter
``conv1d.weight`` is a :class:`~.vision_towers.RawWeight`.

Kernels, as in the port's other decoders (``vl/decoder.py``): every
residual add + RMSNorm pair is K3 (``ops/fused_norm_rope.
fused_add_rmsnorm``) — the layers hand on ``(residual, delta)``; layer 0's
input norm is the plain RMSNorm and the final norm the last K3 site, so a
forward runs 2 per layer. Where a layer computes its q/k RMSNorm and then
a half-split rotary over the whole head (``qk_norm="rms"``, not
interleaved, full rotary: SDAR) one K4 launch (``fused_qk_norm_rope_qk``)
does both for q and k and writes k into the KV cache — at one slot for
every row, or at each row's own slot when ``pos`` is a (B,) vector (the
HPD scheduler's branches). GLM's interleaved partial rotary and Ovis's
additive q/k norms stay plain PyTorch: no Pallas kernel computes them.
The attention over the cache is the plain
``vl/attention.scaled_dot_product_attention``.

The cache is updated in place (``vl/kv_cache.py``); the delta states are
tensors the layers return, as the JAX ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_norm_rope import fused_add_rmsnorm, fused_qk_norm_rope_qk
from .attention import mrope_cos_sin, scaled_dot_product_attention
from .gated_delta import gated_delta_rule, gated_delta_rule_chunked
from .kv_cache import KVCache
from .paddleocr_vl import RMSNorm
from .vision_towers import Group, RawWeight


@dataclass(frozen=True)
class UnifiedLMConfig:
    vocab_size: int = 512
    hidden: int = 64
    layers: int = 2
    heads: int = 4
    kv_heads: int = 2
    head_dim: int = 16
    ffn: int = 128
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    # structural flags (see module docstring)
    qkv_bias: bool = False
    qk_norm: Optional[str] = None            # None | "rms" | "additive"
    partial_rotary: float = 1.0
    interleaved_rotary: bool = False
    fused_gate_up: bool = False
    sandwich_norms: bool = False
    rope_kind: str = "rope"                  # rope | mrope
    mrope_sections: Tuple[int, ...] = ()
    # "full_attention" / "linear_attention" per layer (Ovis hybrid);
    # empty = all full
    layer_types: Tuple[str, ...] = ()
    # GatedDeltaNet dims (Ovis linear layers)
    linear_v_heads: int = 4
    linear_k_heads: int = 2
    linear_head_dim: int = 16
    conv_kernel: int = 4
    eos_id: int = 2

    def kind(self, i: int) -> str:
        if not self.layer_types:
            return "full_attention"
        return self.layer_types[i % len(self.layer_types)]

    def delta_layers(self) -> Tuple[int, ...]:
        """Indices of the linear-attention (gated-delta) layers."""
        return tuple(i for i in range(self.layers)
                     if self.kind(i) == "linear_attention")

    @property
    def fused_qk(self) -> bool:
        """Whether the q/k norm + rotary site is K4's function."""
        return (self.qk_norm == "rms" and not self.interleaved_rotary
                and self.partial_rotary == 1.0)


# Published-config presets (dims are config.json data; flags are the
# architecture facts the reference encodes)
MINERU_TEXT = UnifiedLMConfig(
    vocab_size=151936, hidden=1536, layers=28, heads=12, kv_heads=2,
    head_dim=128, ffn=8960, rms_eps=1e-6, rope_theta=1000000.0,
    qkv_bias=True, rope_kind="mrope", mrope_sections=(16, 24, 24))
SDAR_TEXT = UnifiedLMConfig(
    vocab_size=151936, hidden=1024, layers=28, heads=16, kv_heads=8,
    head_dim=128, ffn=3072, rms_eps=1e-6, rope_theta=1000000.0,
    qk_norm="rms")
GLM_TEXT = UnifiedLMConfig(
    vocab_size=151552, hidden=1536, layers=40, heads=12, kv_heads=2,
    head_dim=128, ffn=4608, rms_eps=1e-5, rope_theta=10000.0,
    partial_rotary=0.5, interleaved_rotary=True, fused_gate_up=True,
    sandwich_norms=True)
OVIS_TEXT = UnifiedLMConfig(
    vocab_size=151936, hidden=1024, layers=24, heads=16, kv_heads=4,
    head_dim=128, ffn=4096, rms_eps=1e-6, rope_theta=1000000.0,
    qk_norm="additive",
    layer_types=("linear_attention", "linear_attention",
                 "linear_attention", "full_attention"))


def _embedding(num: int, dim: int) -> nn.Embedding:
    """An ``nn.Embedding`` whose table is left unset: every caller loads
    one. Its own ``normal_`` init, on the ``meta`` device the stacks are
    built on, runs torch's reference ops, which import ``torch._dynamo``:
    about 3 s at a process's first model."""
    return nn.Embedding(num, dim, _weight=torch.empty(num, dim))


class AdditiveRMSNorm(nn.Module):
    """Ovis AdditiveRmsNorm: x̂ · (1 + weight) (ovisocr2/text.rs:456)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)
                * (1.0 + self.weight.float())).to(x.dtype)


def _rope_tables(cfg: UnifiedLMConfig, position_ids: torch.Tensor):
    """cos/sin over the ROTARY dims only (partial_rotary · head_dim),
    float32 (B, T, rot/2)."""
    rot = int(cfg.head_dim * cfg.partial_rotary)
    if cfg.rope_kind == "mrope":
        return mrope_cos_sin(position_ids, rot, cfg.mrope_sections,
                             cfg.rope_theta)
    pos = position_ids if position_ids.ndim == 2 else position_ids[0]
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, rot, 2, dtype=torch.float32, device=pos.device) / rot))
    freqs = pos[..., None].float() * inv
    return freqs.cos(), freqs.sin()


def _apply_rotary(x, cos, sin, *, interleaved: bool):
    """Rotate the first ``2·cos.shape[-1]`` dims of x; pass the rest
    through (partial rotary). Interleaved = GLM's pairwise layout."""
    rot = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xf = x_rot.float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          -1).reshape(xf.shape)
    else:
        d2 = rot // 2
        x1, x2 = xf[..., :d2], xf[..., d2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.to(x.dtype), x_pass], -1)


class UnifiedAttention(nn.Module):
    def __init__(self, cfg: UnifiedLMConfig, layer_idx: int):
        super().__init__()
        c = self.cfg = cfg
        self.layer_idx = layer_idx
        hd, b = c.head_dim, c.qkv_bias
        self.q_proj = nn.Linear(c.hidden, c.heads * hd, bias=b)
        self.k_proj = nn.Linear(c.hidden, c.kv_heads * hd, bias=b)
        self.v_proj = nn.Linear(c.hidden, c.kv_heads * hd, bias=b)
        if c.qk_norm == "rms":
            self.q_norm = RMSNorm(hd, c.rms_eps)
            self.k_norm = RMSNorm(hd, c.rms_eps)
        elif c.qk_norm == "additive":
            self.q_norm = AdditiveRMSNorm(hd, c.rms_eps)
            self.k_norm = AdditiveRMSNorm(hd, c.rms_eps)
        self.o_proj = nn.Linear(c.heads * hd, c.hidden, bias=False)

    def forward(self, x, cos, sin, cache: KVCache, pos, mask):
        """Writes this layer's K/V at slot ``pos`` (an int, a 0-d device
        slot or a (B,) vector of per-row slots) and attends over the
        cache."""
        c = self.cfg
        hd = c.head_dim
        b, t, _ = x.shape
        li = self.layer_idx
        q = self.q_proj(x).view(b, t, c.heads, hd)
        k = self.k_proj(x).view(b, t, c.kv_heads, hd)
        v = self.v_proj(x).view(b, t, c.kv_heads, hd).transpose(1, 2)
        if c.fused_qk:
            # K4, one launch: q and k of every row; k lands in the cache
            q = fused_qk_norm_rope_qk(
                q, k, self.q_norm.weight, self.k_norm.weight, cos, sin,
                k_out=cache.k_slot(li, pos, t),
                slot=pos if isinstance(pos, torch.Tensor) else None,
                eps=c.rms_eps)
            cache.append(li, None, v, pos)
        else:
            if c.qk_norm is not None:
                q, k = self.q_norm(q), self.k_norm(k)
            q, k = (_apply_rotary(y.transpose(1, 2), cos[:, None],
                                  sin[:, None],
                                  interleaved=c.interleaved_rotary)
                    for y in (q, k))
            cache.append(li, k, v, pos)
        ck, cv = cache.layer(li)
        o = scaled_dot_product_attention(q, ck, cv, mask)
        return self.o_proj(o.transpose(1, 2).reshape(b, t, c.heads * hd))


class GatedDeltaNetLayer(nn.Module):
    """Ovis "linear_attention" mixer — the published tree + the gated
    delta rule (``llm_decoders.py:187-343``). ``collect_states`` (the
    speculative verify block) returns the PER-STEP states, (B, T, Hv, d,
    d) and (B, T, K−1, conv_dim), so the caller resumes from the last
    accepted position; ``pad_mask`` (B, T), True = a real token, keeps
    left-pad rows out of the recurrent fold (α = 1, β = 0, a zero conv
    input)."""

    def __init__(self, cfg: UnifiedLMConfig):
        super().__init__()
        c = self.cfg = cfg
        hk, hv, d = c.linear_k_heads, c.linear_v_heads, c.linear_head_dim
        conv_dim = 2 * hk * d + hv * d
        self.in_proj_qkv = nn.Linear(c.hidden, conv_dim, bias=False)
        self.in_proj_z = nn.Linear(c.hidden, hv * d, bias=False)
        self.in_proj_b = nn.Linear(c.hidden, hv, bias=False)
        self.in_proj_a = nn.Linear(c.hidden, hv, bias=False)
        self.conv1d = RawWeight(conv_dim, 1, c.conv_kernel)
        self.dt_bias = nn.Parameter(torch.zeros(hv))
        self.A_log = nn.Parameter(torch.zeros(hv))
        self.norm = RMSNorm(d, c.rms_eps)
        self.out_proj = nn.Linear(hv * d, c.hidden, bias=False)

    def forward(self, x, dstate, conv_state, collect_states: bool = False,
                pad_mask=None):
        c = self.cfg
        b, t, _ = x.shape
        hk, hv, d = c.linear_k_heads, c.linear_v_heads, c.linear_head_dim
        key_dim, value_dim = hk * d, hv * d
        kk = c.conv_kernel
        qkv = self.in_proj_qkv(x)
        z = self.in_proj_z(x)
        beta_in = self.in_proj_b(x)
        a_in = self.in_proj_a(x)
        if pad_mask is not None:
            qkv = qkv * pad_mask[:, :, None].to(qkv.dtype)

        # depthwise causal conv over time with the carried state
        kern = self.conv1d.weight[:, 0].float()              # (C, K)
        seq = torch.cat([conv_state.float(), qkv.float()], 1)  # (B, K-1+T, C)
        windows = seq.unfold(1, kk, 1)                       # (B, T, C, K)
        conv_out = F.silu(torch.einsum("btck,ck->btc", windows, kern))
        new_conv_state = seq[:, -(kk - 1):] if kk > 1 else conv_state

        def heads(y, n):
            return y.reshape(b, t, n, d).transpose(1, 2)

        qh = heads(conv_out[..., :key_dim], hk)
        kh = heads(conv_out[..., key_dim:2 * key_dim], hk)
        vh = heads(conv_out[..., 2 * key_dim:], hv)
        if hv != hk:                                        # GVA broadcast
            qh = qh.repeat_interleave(hv // hk, dim=1)
            kh = kh.repeat_interleave(hv // hk, dim=1)
        # Qwen3-Next GDN L2-normalizes q/k before the rule
        qh = qh / qh.float().norm(dim=-1, keepdim=True).clamp(
            min=1e-12).to(qh.dtype)
        kh = kh / kh.float().norm(dim=-1, keepdim=True).clamp(
            min=1e-12).to(kh.dtype)
        beta = torch.sigmoid(beta_in.float())               # (B, T, Hv)
        alpha = torch.exp(-torch.exp(self.A_log.float())[None, None]
                          * F.softplus(a_in.float()
                                       + self.dt_bias.float()[None, None]))
        if pad_mask is not None:
            beta = beta * pad_mask[:, :, None].to(beta.dtype)
            alpha = torch.where(pad_mask[:, :, None], alpha,
                                torch.ones_like(alpha))
        if collect_states:
            o, steps = gated_delta_rule(
                qh, kh, vh, alpha.transpose(1, 2), beta.transpose(1, 2),
                initial_state=dstate, return_all_states=True)
            if kk > 1:
                # the conv state after step j: the K−1 inputs ending at j
                step_convs = windows[..., 1:].transpose(2, 3)
            else:
                step_convs = conv_state[:, None].expand(
                    (b, t) + tuple(conv_state.shape[1:]))
            s_final, new_conv_state = steps, step_convs
        else:
            rule = gated_delta_rule if t <= 1 else gated_delta_rule_chunked
            o, s_final = rule(qh, kh, vh, alpha.transpose(1, 2),
                              beta.transpose(1, 2), initial_state=dstate,
                              return_state=True)
        o = self.norm(o.transpose(1, 2).to(x.dtype))         # (B, T, Hv, d)
        o = o * F.silu(z.reshape(b, t, hv, d))
        return (self.out_proj(o.reshape(b, t, value_dim)), s_final,
                new_conv_state)


class UnifiedMlp(nn.Module):
    def __init__(self, cfg: UnifiedLMConfig):
        super().__init__()
        c = self.cfg = cfg
        if c.fused_gate_up:
            self.gate_up_proj = nn.Linear(c.hidden, 2 * c.ffn, bias=False)
        else:
            self.gate_proj = nn.Linear(c.hidden, c.ffn, bias=False)
            self.up_proj = nn.Linear(c.hidden, c.ffn, bias=False)
        self.down_proj = nn.Linear(c.ffn, c.hidden, bias=False)

    def forward(self, x):
        c = self.cfg
        if c.fused_gate_up:
            gu = self.gate_up_proj(x)
            gate, up = gu[..., :c.ffn], gu[..., c.ffn:]
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class UnifiedLayer(nn.Module):
    def __init__(self, cfg: UnifiedLMConfig, layer_idx: int):
        super().__init__()
        c = self.cfg = cfg
        self.layer_idx = layer_idx
        self.input_layernorm = RMSNorm(c.hidden, c.rms_eps)
        if c.kind(layer_idx) == "linear_attention":
            self.linear_attn = GatedDeltaNetLayer(c)
        else:
            self.self_attn = UnifiedAttention(c, layer_idx)
        if c.sandwich_norms:
            self.post_self_attn_layernorm = RMSNorm(c.hidden, c.rms_eps)
        self.post_attention_layernorm = RMSNorm(c.hidden, c.rms_eps)
        self.mlp = UnifiedMlp(c)
        if c.sandwich_norms:
            self.post_mlp_layernorm = RMSNorm(c.hidden, c.rms_eps)

    def forward(self, residual, delta, cos, sin, cache, pos, mask, dstate,
                conv_state, collect_states: bool = False, pad_mask=None):
        """(residual, delta) in and out: ``residual + delta`` is the
        layer's input; its input norm is K3 on that sum, except before
        layer 0 (``delta`` None)."""
        c = self.cfg
        eps = c.rms_eps
        if delta is None:
            h = self.input_layernorm(residual)
        else:
            h, residual = fused_add_rmsnorm(delta, residual,
                                            self.input_layernorm.weight,
                                            eps=eps)
        if c.kind(self.layer_idx) == "linear_attention":
            attn, dstate, conv_state = self.linear_attn(
                h, dstate, conv_state, collect_states, pad_mask)
        else:
            attn = self.self_attn(h, cos, sin, cache, pos, mask)
        if c.sandwich_norms:
            attn = self.post_self_attn_layernorm(attn)
        h, residual = fused_add_rmsnorm(attn, residual,
                                        self.post_attention_layernorm.weight,
                                        eps=eps)
        m = self.mlp(h)
        if c.sandwich_norms:
            m = self.post_mlp_layernorm(m)
        return residual, m, dstate, conv_state


class UnifiedDecoder(nn.Module):
    """model.* subtree: embed_tokens + layers.{i} + norm (the LM head sits
    at the wrapper level)."""

    def __init__(self, cfg: UnifiedLMConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = _embedding(cfg.vocab_size, cfg.hidden)
        self.layers = nn.ModuleList(UnifiedLayer(cfg, i)
                                    for i in range(cfg.layers))
        self.norm = RMSNorm(cfg.hidden, cfg.rms_eps)

    def empty_states(self, batch: int, device=None):
        """Zero (L, B, Hv, d, d) delta and (L, B, max(K−1, 1), conv_dim)
        conv states, float32."""
        c = self.cfg
        d = c.linear_head_dim
        dstate = torch.zeros((c.layers, batch, c.linear_v_heads, d, d),
                             dtype=torch.float32, device=device)
        conv_dim = 2 * c.linear_k_heads * d + c.linear_v_heads * d
        conv = torch.zeros((c.layers, batch, max(c.conv_kernel - 1, 1),
                            conv_dim), dtype=torch.float32, device=device)
        return dstate, conv

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(ids.long())

    def forward(self, embeds, position_ids, cache: KVCache, pos, mask,
                dstate=None, conv_state=None, collect_states: bool = False,
                pad_mask=None):
        """→ (final-normed hidden, cache, dstate, conv_state). With
        ``collect_states`` the states are the delta layers' per-step ones,
        (Ld, B, T, …), rows in ``cfg.delta_layers()`` order, and a given
        carry is not changed; otherwise the (L, B, …) carry, the delta
        layers' rows written into the given one in place (a decode
        graph's static buffers), or into zeros when none is given."""
        c = self.cfg
        cos, sin = _rope_tables(c, position_ids)
        b, t = embeds.shape[:2]
        if dstate is None or conv_state is None:
            dstate, conv_state = self.empty_states(b, embeds.device)
        residual, delta = embeds, None
        step_ds, step_cs = [], []
        for i, layer in enumerate(self.layers):
            residual, delta, ds_i, cs_i = layer(
                residual, delta, cos, sin, cache, pos, mask, dstate[i],
                conv_state[i], collect_states, pad_mask)
            if c.kind(i) != "linear_attention":
                continue
            if collect_states:
                step_ds.append(ds_i)
                step_cs.append(cs_i)
            else:
                dstate[i] = ds_i
                conv_state[i] = cs_i
        out, _ = fused_add_rmsnorm(delta, residual, self.norm.weight,
                                   eps=c.rms_eps)
        if collect_states:
            if step_ds:
                dstate, conv_state = torch.stack(step_ds), torch.stack(step_cs)
            else:
                dstate = dstate.new_zeros((0, b, t) + dstate.shape[2:])
                conv_state = conv_state.new_zeros(
                    (0, b, t) + conv_state.shape[2:])
        return out, cache, dstate, conv_state


class GlmMtpHead(nn.Module):
    """GLM-OCR's trained MTP draft layer (glmocr/mtp.rs:40-155): fuse
    [enorm(embed(token)) ‖ hnorm(prev_hidden)] through ``eh_proj``, run
    one full GLM decoder layer (its parts at this level), then
    ``shared_head.norm`` + ``shared_head.head`` logits. Its K/V go to
    layer 0 of its own one-layer cache."""

    def __init__(self, cfg: UnifiedLMConfig):
        super().__init__()
        c = self.cfg = cfg
        self.embed_tokens = _embedding(c.vocab_size, c.hidden)
        self.enorm = RMSNorm(c.hidden, c.rms_eps)
        self.hnorm = RMSNorm(c.hidden, c.rms_eps)
        self.eh_proj = nn.Linear(2 * c.hidden, c.hidden, bias=False)
        self.input_layernorm = RMSNorm(c.hidden, c.rms_eps)
        self.self_attn = UnifiedAttention(c, 0)
        if c.sandwich_norms:
            self.post_self_attn_layernorm = RMSNorm(c.hidden, c.rms_eps)
        self.post_attention_layernorm = RMSNorm(c.hidden, c.rms_eps)
        self.mlp = UnifiedMlp(c)
        if c.sandwich_norms:
            self.post_mlp_layernorm = RMSNorm(c.hidden, c.rms_eps)
        self.shared_head = Group(
            norm=RMSNorm(c.hidden, c.rms_eps),
            head=nn.Linear(c.hidden, c.vocab_size, bias=False))

    def forward(self, ids, prev_hidden, position_ids, cache: KVCache, pos,
                mask, emb=None):
        """``emb`` (B, T, hidden), when given, takes the place of the
        token embedding (the prefill, whose image positions hold fused
        vision embeddings). → (logits float32, hidden, cache)."""
        c = self.cfg
        if emb is None:
            emb = self.embed_tokens(ids.long())
        x = self.eh_proj(torch.cat([self.enorm(emb),
                                    self.hnorm(prev_hidden)], -1))
        cos, sin = _rope_tables(c, position_ids)
        attn = self.self_attn(self.input_layernorm(x), cos, sin, cache, pos,
                              mask)
        if c.sandwich_norms:
            attn = self.post_self_attn_layernorm(attn)
        h, x = fused_add_rmsnorm(attn, x,
                                 self.post_attention_layernorm.weight,
                                 eps=c.rms_eps)
        m = self.mlp(h)
        if c.sandwich_norms:
            m = self.post_mlp_layernorm(m)
        out, x = fused_add_rmsnorm(m, x, self.shared_head.norm.weight,
                                   eps=c.rms_eps)
        return self.shared_head.head(out).float(), x, cache


class HpdMtpHead(nn.Module):
    """HPD-Parsing P-MTP draft head (hpd_parsing/model.rs:83-180): fused =
    fc(cat(rms(hidden), rms(prev-token embedding))), SwiGLU MLP with
    residual, final norm. One call drafts one token's hidden; the target
    LM head projects it to logits."""

    def __init__(self, cfg: UnifiedLMConfig):
        super().__init__()
        c = self.cfg = cfg
        self.pre_fc_norm_hidden = RMSNorm(c.hidden, c.rms_eps)
        self.pre_fc_norm_embedding = RMSNorm(c.hidden, c.rms_eps)
        self.fc = nn.Linear(2 * c.hidden, c.hidden, bias=False)
        self.gate_proj = nn.Linear(c.hidden, c.ffn, bias=False)
        self.up_proj = nn.Linear(c.hidden, c.ffn, bias=False)
        self.down_proj = nn.Linear(c.ffn, c.hidden, bias=False)
        self.norm = RMSNorm(c.hidden, c.rms_eps)

    def forward(self, hidden, embedding):
        fused = self.fc(torch.cat([self.pre_fc_norm_hidden(hidden),
                                   self.pre_fc_norm_embedding(embedding)],
                                  -1))
        mlp = self.down_proj(F.silu(self.gate_proj(fused))
                             * self.up_proj(fused))
        out, _ = fused_add_rmsnorm(mlp, fused, self.norm.weight,
                                   eps=self.cfg.rms_eps)
        return out
