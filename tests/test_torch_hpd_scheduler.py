"""The port's HPD fork scheduler against the JAX package's, on the CPU.

HPD-Parsing's tiny exact stack runs in float32 in both packages on the
port's seeded weights (``torch_exact_common``), its P-MTP head's too; the
development fork id is set to a token the model emits, so every run
forks. The gates: the greedy decode of a left-padded batch identical to
JAX's; the parent's and the children's ids identical to JAX's,
greedy and P-MTP, with the scheduler's counters; P-MTP equal to greedy;
two runs equal; a pool capped at one active branch (FIFO preemption)
equal to the uncapped run. The verify block writes each branch's k at its
own slot through K4's per-row form (``KVCache.k_slot`` with a (B,)
vector), held here against ``_row_indices`` + ``append``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.vl import hpd_scheduler as jhs
from oar_ocr_tpu.vl import llm_decoders as jld
from oar_ocr_tpu_torch.ops.fused_norm_rope import (fused_qk_norm_rope_qk,
                                                   row_slot_indices)
from oar_ocr_tpu_torch.vl.kv_cache import KVCache
from torch_exact_common import check_generate, imgs, make_pair
from torch_jax_tree import jax_tree_from_port, one_torch_thread  # noqa: F401

MAX_NEW = 8


@pytest.fixture(scope="module")
def pair():
    """(port HpdForkExact, JAX HpdForkExact) whose fork id the model
    emits, each with both schedulers on the port's P-MTP weights."""
    ours, ref = make_pair("hpd_fork_exact", seed=4)
    img = imgs()[0]
    fork_id = ours.parse_with_forks(img, max_new_tokens=MAX_NEW)[
        "token_ids"][0]
    for m in (ours, ref):
        m.DEV_FORK_ID = int(fork_id)
        for key in ("_sched", "_sched_mtp"):
            if hasattr(m, key):
                delattr(m, key)
    c = ours.spec.text_cfg
    jc = jld.UnifiedLMConfig(**dataclasses.asdict(c))
    head = jld.HpdMtpHead(jc)
    for use_mtp, key in ((False, "_sched"), (True, "_sched_mtp")):
        sched = ours.scheduler(use_mtp)
        tree = jax_tree_from_port(head, None, sched.mtp.state_dict(), init=(
            lambda r: head.init(r, jnp.zeros((1, c.hidden)),
                                jnp.zeros((1, c.hidden)))))
        setattr(ref, key, jhs.HpdContinuousScheduler(
            ref, fork_token_id=sched.fork_token_id,
            child_token_id=sched.child_token_id, mtp_params=tree))
    return ours, ref, img


def test_generate_matches_jax(pair):
    """HPD-Parsing's greedy decode of a left-padded batch of two pages, as
    ``torch_exact_common.check_generate`` holds it (the fork stack's
    ``generate`` is the exact stack's)."""
    ours, ref, _ = pair
    check_generate(ours, ref)


def _strip(out):
    return {k: out[k] for k in ("parent", "children", "token_ids", "stats")}


@pytest.mark.parametrize("use_mtp", [False, True])
def test_parse_with_forks_matches_jax(pair, use_mtp):
    """Parent, children, spliced ids and counters equal to JAX's; P-MTP
    equal to greedy, with drafts made and some accepted."""
    ours, ref, img = pair
    kw = dict(max_new_tokens=MAX_NEW, use_mtp=use_mtp,
              num_speculative_tokens=3)
    got = ours.parse_with_forks(img, **kw)
    assert got["stats"]["forked_branches"] >= 1
    assert _strip(got) == _strip(ref.parse_with_forks(img, **kw))
    greedy = ours.parse_with_forks(img, max_new_tokens=MAX_NEW)
    for k in ("parent", "children", "token_ids"):
        assert got[k] == greedy[k]
    if use_mtp:
        assert got["stats"]["mtp_drafted_tokens"] > 0


def test_determinism_and_preemption(pair):
    """Two runs equal; a pool capped at one active branch (children
    admitted first, older branches preempted into the FIFO queue) emits
    what the uncapped pool emits, over more rounds, as JAX's does."""
    ours, ref, img = pair
    a = ours.parse_with_forks(img, max_new_tokens=MAX_NEW)
    assert _strip(a) == _strip(ours.parse_with_forks(img,
                                                     max_new_tokens=MAX_NEW))
    capped = ours.parse_with_forks(img, max_new_tokens=MAX_NEW,
                                   max_active_branches=1)
    for k in ("parent", "children", "token_ids"):
        assert capped[k] == a[k]
    assert capped["stats"]["peak_active_branches"] == 1
    assert capped["stats"]["scheduler_rounds"] >= a["stats"][
        "scheduler_rounds"]
    assert _strip(capped) == _strip(ref.parse_with_forks(
        img, max_new_tokens=MAX_NEW, max_active_branches=1))


@pytest.mark.parametrize("pos", [[3, 0, 7, 12], [13, 2, 2, 9]])
def test_k_slot_per_row_matches_row_indices_append(pos):
    """K4 with a (B,) per-row slot vector writes each row's k at its own
    slot, clamped to [0, C − t] as ``_row_indices`` clamps: the cache
    equals the plain path's (normed, rotated k through ``append``'s
    per-row write), and the q it returns is the 0-d slot's."""
    b, t, hq, hk, d, cap = 4, 3, 4, 2, 16, 16
    rng = np.random.default_rng(sum(pos))
    q, k = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)) for h in (hq, hk))
    qs, ks = (torch.from_numpy(rng.standard_normal(d).astype(np.float32))
              for _ in range(2))
    cos, sin = (torch.from_numpy(rng.standard_normal((b, t, d // 2)).astype(
        np.float32)) for _ in range(2))
    slots = torch.tensor(pos, dtype=torch.int64)
    got = KVCache.create(1, b, hk, cap, d, dtype=torch.float32,
                         device=torch.device("cpu"))
    q_out = fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin,
                                  k_out=got.k_slot(0, slots, t), slot=slots)
    want = KVCache.create(1, b, hk, cap, d, dtype=torch.float32,
                          device=torch.device("cpu"))
    k_plain = torch.empty((b, hk, t, d))
    q_ref = fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin, k_out=k_plain)
    want.append(0, k_plain, k_plain, slots)
    assert torch.equal(got.k, want.k)
    assert torch.equal(q_out, q_ref)
    idx = want._row_indices(slots, t)
    assert torch.equal(idx, row_slot_indices(slots, t, cap))
    assert int(idx.max()) == cap - 1 or max(pos) + t <= cap
