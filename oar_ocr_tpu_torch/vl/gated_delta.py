"""Gated delta rule linear attention (OvisOCR2's hybrid layers).

Counterpart of ``oar_ocr_tpu/vl/gated_delta.py``. Per head, with state
S ∈ R^{Dk×Dv}, decay gate α_t ∈ (0, 1) and write strength β_t ∈ (0, 1):

    S_t = α_t · (I − β_t k_t k_tᵀ) S_{t-1} + β_t k_t v_tᵀ
    o_t = S_tᵀ q_t

:func:`gated_delta_rule` runs the recurrence token by token (the JAX
``lax.scan``), :func:`gated_delta_rule_chunked` the blockwise WY form
(a few matrix products a chunk, a triangular solve for the
pseudo-values), :func:`gated_delta_step` one decode step. The state is
float32 in all three. The JAX package has no Pallas kernel here, so the
port's is plain PyTorch too; a hand-written kernel is later work.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _fold(s, kt, vt, at, bt):
    """One token into the state: s (B, H, Dk, Dv), kt (B, H, Dk),
    vt (B, H, Dv), at/bt (B, H)."""
    ks = torch.einsum("bhk,bhkv->bhv", kt, s)
    s = at[..., None, None] * (
        s - bt[..., None, None] * torch.einsum("bhk,bhv->bhkv", kt, ks))
    return s + bt[..., None, None] * torch.einsum("bhk,bhv->bhkv", kt, vt)


def gated_delta_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     alpha: torch.Tensor, beta: torch.Tensor,
                     initial_state: Optional[torch.Tensor] = None, *,
                     return_state: bool = False,
                     return_all_states: bool = False):
    """q, k (B, H, T, Dk), v (B, H, T, Dv), alpha, beta (B, H, T) →
    (B, H, T, Dv) in q's dtype [, final state (B, H, Dk, Dv)], or with
    ``return_all_states`` [, every step's state (B, T, H, Dk, Dv)]
    (``gated_delta.py:23-74``)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    f = torch.float32
    q32, k32, v32 = q.to(f), k.to(f), v.to(f)
    a32, b32 = alpha.to(f), beta.to(f)
    s = (initial_state.to(f) if initial_state is not None
         else q.new_zeros((b, h, dk, dv), dtype=f))
    outs, states = [], []
    for i in range(t):
        s = _fold(s, k32[:, :, i], v32[:, :, i], a32[:, :, i], b32[:, :, i])
        outs.append(torch.einsum("bhkv,bhk->bhv", s, q32[:, :, i]))
        if return_all_states:
            states.append(s)
    out = (torch.stack(outs, dim=2) if outs
           else q.new_zeros((b, h, 0, dv), dtype=f)).to(q.dtype)
    if return_all_states:
        return out, torch.stack(states, dim=1)
    if return_state:
        return out, s
    return out


def gated_delta_rule_chunked(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, alpha: torch.Tensor,
                             beta: torch.Tensor,
                             initial_state: Optional[torch.Tensor] = None,
                             *, chunk: int = 64, return_state: bool = False):
    """The same function in chunks of ``chunk`` tokens
    (``gated_delta.py:77-171``): with γ_i the product of α from the chunk
    start, the pseudo-values Y solve (I + diag(β)·D) Y =
    diag(β)(V − γ∘(K S_0)), D[i, m] = (γ_i/γ_m)(k_i·k_m) for m < i; the
    outputs are γ∘(Q S_0) + (E ⊙ QKᵀ) Y with E[j, i] = γ_j/γ_i (i ≤ j),
    and the chunk-end state γ_C S_0 + Kᵀ((γ_C/γ)∘Y). Every ratio has
    i ≤ j, so no factor exceeds 1. Pad steps have α = 1, β = 0."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, max(t, 1))
    n = -(-t // c)
    pad = n * c - t
    f = torch.float32
    qf, kf, vf = q.to(f), k.to(f), v.to(f)
    af, bf = alpha.to(f), beta.to(f)
    if pad:
        qf, kf, vf = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                      for x in (qf, kf, vf))
        af = torch.nn.functional.pad(af, (0, pad), value=1.0)
        bf = torch.nn.functional.pad(bf, (0, pad))

    def chunks(x):
        return x.reshape(b, h, n, c, *x.shape[3:]).movedim(2, 0)

    qc, kc, vc, ac, bc = (chunks(x) for x in (qf, kf, vf, af, bf))
    dev = q.device
    tri_lo = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)
    tri_le = torch.ones((c, c), dtype=torch.bool, device=dev).tril()
    eye = torch.eye(c, dtype=f, device=dev)
    s = (initial_state.to(f) if initial_state is not None
         else q.new_zeros((b, h, dk, dv), dtype=f))
    outs = []
    for j in range(n):
        qi, ki, vi, ai, bi = qc[j], kc[j], vc[j], ac[j], bc[j]
        g = torch.log(ai.clamp(min=1e-30)).cumsum(-1)
        r0 = g.exp()
        ratio = (g[..., :, None] - g[..., None, :]).exp()
        ks0 = ki @ s
        rhs = bi[..., None] * (vi - r0[..., None] * ks0)
        kk = ki @ ki.transpose(-1, -2)
        m = eye + torch.where(tri_lo, bi[..., :, None] * ratio * kk, 0.0)
        y = torch.linalg.solve_triangular(m, rhs, upper=False,
                                          unitriangular=True)
        qk = qi @ ki.transpose(-1, -2)
        e = torch.where(tri_le, ratio, 0.0)
        outs.append(r0[..., None] * (qi @ s) + (e * qk) @ y)
        g_c = g[..., -1:]
        s = g_c.exp()[..., None] * s + ki.transpose(-1, -2) @ (
            (g_c - g).exp()[..., None] * y)
    out = torch.stack(outs, dim=2).reshape(b, h, n * c, dv)[:, :, :t]
    out = out.to(q.dtype)
    if return_state:
        return out, s
    return out


def gated_delta_step(s: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: state (B, H, Dk, Dv) and token inputs q, k
    (B, H, Dk), v (B, H, Dv), alpha, beta (B, H) → (new state, output
    (B, H, Dv)) (``gated_delta.py:174-191``)."""
    s = _fold(s, k, v, alpha, beta)
    return s, torch.einsum("bhkv,bhk->bhv", s, q)
