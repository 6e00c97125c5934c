"""The port's tensor parallelism against the JAX package's, on the CPU.

The JAX side runs on ``conftest.py``'s 8 virtual CPU devices, the port's
on 8 virtual CPU devices (``[torch.device("cpu")] * 8``), where the
``model`` shards run one after the other and the all-reduces are plain
sums. Both packages run float32 on the port's seeded weights
(``torch_jax_tree``).

- ``tp_spec``: the JAX rule cases, and every parameter of
  ``GLMOCR(tiny=True)`` sharded on the matching axis in both packages
  (a torch weight is (out, in), a flax kernel (in, out)).
- The (2 data × 4 model) ``CausalLM`` of ``test_parallel.py``'s
  ``test_tp_matches_replicated``: prefill + 3 greedy steps against the
  JAX partitioned run, logits within 2e-4.
- ``GLMOCR(tiny=True).generate`` at ``n_model`` 2 and 4 (GLM's 2 kv
  heads over 4 shards: kv replication) against the JAX TP generate:
  identical ids, and identical to the port's one-shard generate.
- The delta layers (OvisOCR2), the speculative paths and the VL models
  without a tensor-parallel form raise ``ConfigError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.config.runtime import MeshConfig as JMeshConfig
from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.parallel.mesh import build_mesh as jbuild_mesh
from oar_ocr_tpu.parallel.tp import param_shardings as jparam_shardings
from oar_ocr_tpu.parallel.tp import partition_params as jpartition
from oar_ocr_tpu.parallel.tp import tp_spec as jtp_spec
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.vl import families as jfam
from oar_ocr_tpu_torch.config.runtime import MeshConfig, RuntimeConfig
from oar_ocr_tpu_torch.errors import ConfigError
from oar_ocr_tpu_torch.models.layers import init_state_dict
from oar_ocr_tpu_torch.parallel.mesh import build_mesh
from oar_ocr_tpu_torch.parallel.tp import (all_reduce, param_shardings,
                                           partition_module, tp_spec)
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import torch_name
from oar_ocr_tpu_torch.vl import families as fam
from oar_ocr_tpu_torch.vl.decoder import (CausalLM, DecoderConfig,
                                          TensorParallelLM)
from oar_ocr_tpu_torch.vl.kv_cache import KVCache
from test_torch_vl_families import jax_family
from torch_jax_tree import jax_tree_from_port, one_torch_thread  # noqa

CPU8 = [torch.device("cpu")] * 8
SEED = 5

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual JAX devices")


def tp_runtime(n_model: int) -> Runtime:
    return Runtime("float32", device="cpu", devices=CPU8, cfg=RuntimeConfig(
        use_mesh=True, mesh=MeshConfig(n_model=n_model)))


def _torch_spec(jspec, ndim: int):
    """A JAX kernel's (in, out) spec in a torch weight's (out, in) order."""
    axes = tuple(jspec) + (None,) * (ndim - len(tuple(jspec)))
    return tuple(reversed(axes)) if ndim == 2 else axes


@pytest.mark.parametrize("path,shape", [
    (("a", "q_proj", "kernel"), (4, 4)),
    (("a", "down_proj", "kernel"), (4, 4)),
    (("a", "lm_head", "kernel"), (4, 4)), (("a", "o", "kernel"), (4, 4)),
    (("a", "input_norm", "scale"), (4,)), (("a", "q_proj", "bias"), (4,)),
    (("a", "tok_emb", "embedding"), (4, 4)),
    (("a", "self_attn.q_proj", "kernel"), (4, 4)),
    (("a", "mlp.down_proj", "kernel"), (4, 4)),
    (("a", "qkv", "kernel"), (4, 4)), (("q",), (4, 4))])
def test_tp_spec_rules_match_jax(path, shape):
    """``test_parallel.py``'s rule cases: a flax kernel is the port's
    ``weight``, its (in, out) axes reversed."""
    leaf = np.zeros(shape)
    name = {"kernel": "weight", "scale": "weight",
            "embedding": "weight"}.get(path[-1], path[-1])
    jspec = tuple(jtp_spec(path, leaf))
    want = _torch_spec(jspec, len(shape)) if "model" in jspec else ()
    assert tp_spec(path[:-1] + (name,), leaf) == want


@pytest.fixture(scope="module")
def glm():
    """(the port's one-shard tiny GLM-OCR, the JAX family module, its
    tree) on the port's seeded weights."""
    ours = fam.GLMOCR(tiny=True, seed=SEED,
                      runtime=Runtime("float32", device="cpu"))
    ref, jcfg, tree = jax_family(ours)
    return ours, ref, jcfg, tree


def test_glmocr_tp_specs_match_jax(glm):
    """Every parameter of ``GLMOCR(tiny=True)``: sharded in both packages
    or in neither, on the matching axis (vision MLPs included)."""
    ours, _, _, tree = glm
    specs = param_shardings(ours.module.state_dict())
    jspecs = jparam_shardings(tree, jbuild_mesh(n_data=4, n_model=2))
    flat = jax.tree_util.tree_flatten_with_path(jspecs)[0]
    seen, sharded = set(), set()
    for path, sh in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        name = torch_name(key)
        ndim = ours.module.state_dict()[name].ndim
        want = (_torch_spec(sh.spec, ndim) if "model" in tuple(sh.spec)
                else ())
        assert specs[name] == want, (key, name, specs[name], sh.spec)
        seen.add(name)
        if want:
            sharded.add(name.rsplit(".", 2)[-2])
    assert seen == set(specs)
    assert sharded == {"q", "k", "v", "o", "gate_proj", "up_proj",
                       "down_proj", "lm_head"}
    assert any(n.startswith("vision.") and specs[n] for n in specs)


def test_partition_and_kv_replication(glm):
    """GLM's tiny decoder (4 q heads, 2 kv heads): at 2 shards each holds
    1 kv head; at 4 each holds the 1 kv head its q head reads (shards
    0-1 head 0, 2-3 head 1). The published config (12 heads, kv 2) at 4
    shards: 3 q heads and 1 kv head each."""
    ours = glm[0]
    hd = ours.cfg.decoder.head_dim
    k_full = ours.module.lm.layer0.k.weight
    for n, heads in ((2, [0, 1]), (4, [0, 0, 1, 1])):
        shards = partition_module(ours.module,
                                  build_mesh(8 // n, n, devices=CPU8))
        for sh, h in zip(shards, heads):
            assert torch.equal(sh.lm.layer0.k.weight,
                               k_full[h * hd:(h + 1) * hd])
            assert sh.lm.layer0.q.weight.shape[0] == 4 // n * hd
            assert sh.lm.lm_head.weight.shape[0] == \
                ours.cfg.decoder.vocab_size // n
    big = fam.FAMILY_CONFIGS["glmocr"].decoder
    from oar_ocr_tpu_torch.vl.decoder import AttnLayer

    with torch.device("meta"):
        layer = AttnLayer(big, 0)
    rows = layer.tp_splits(4)["k.weight"]
    assert [(s.start // 128, s.stop // 128) for s in rows] == \
        [(0, 1), (0, 1), (1, 2), (1, 2)]
    with pytest.raises(ConfigError):
        layer.tp_splits(5)


def test_all_reduce_plain_sum():
    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    out = all_reduce(parts)
    assert all(o is out[0] for o in out)
    assert out[0].eq(6.0).all()


def _jax_decoder_run(params, module, cfg, embeds, positions, n_steps=3):
    """``test_parallel.py``'s ``_decoder_run``."""
    from oar_ocr_tpu.vl.attention import create_causal_mask
    from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache

    b, t = embeds.shape[:2]
    cap = 32

    def step(params, embeds, positions):
        cache = JKVCache.create(cfg.layers, b, cfg.kv_heads, cap,
                                cfg.head_dim, dtype=jnp.float32)
        mask = jnp.broadcast_to(create_causal_mask(t), (b, 1, t, t))
        mask = jnp.concatenate(
            [mask, jnp.zeros((b, 1, t, cap - t), bool)], -1)
        logits, _, cache, _ = module.apply(
            params, embeds, positions, cache, mask, method="prefill")
        cache = cache.advance(t)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        outs = [logits]
        for i in range(n_steps):
            pos = jnp.full((1, b, 1), t + i, jnp.int32)
            logits, _, cache, _ = module.apply(
                params, tok, pos, cache, t + i, method="decode_step")
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            outs.append(logits)
        return jnp.stack(outs)

    return np.asarray(jax.jit(step)(params, embeds, positions))


def _port_decoder_run(lm, cfg, embeds, positions, n_steps=3):
    b, t = embeds.shape[:2]
    cap = 32
    cache = (lm.new_cache(b, cap, torch.float32)
             if isinstance(lm, TensorParallelLM) else
             KVCache.create(cfg.layers, b, cfg.kv_heads, cap, cfg.head_dim,
                            dtype=torch.float32, device=torch.device("cpu")))
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    mask = torch.cat([causal.expand(b, 1, t, t),
                      torch.zeros(b, 1, t, cap - t, dtype=torch.bool)], -1)
    with torch.no_grad():
        logits, _, _ = lm.prefill(embeds, positions, cache, mask)
        cache.advance(t)
        outs = [logits]
        for i in range(n_steps):
            tok = logits.argmax(-1).to(torch.int32)
            pos = torch.full((1, b, 1), t + i, dtype=torch.int32)
            logits, _, _ = lm.decode_step(tok, pos, cache, t + i)
            outs.append(logits)
    return torch.stack(outs).numpy()


@pytest.mark.parametrize("n_data,n_model", [(2, 4), (4, 2)])
def test_tp_causal_lm_matches_jax(n_data, n_model):
    """The CausalLM of ``test_tp_matches_replicated`` on a (data × model)
    mesh against the JAX partitioned run, and against the port's one
    shard, to 2e-4."""
    from oar_ocr_tpu.vl.decoder import CausalLM as JCausalLM
    from oar_ocr_tpu.vl.decoder import DecoderConfig as JDecoderConfig
    from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache

    kw = dict(vocab_size=64, hidden=128, layers=2, heads=8, kv_heads=4,
              ffn=256)
    cfg, jcfg = DecoderConfig(**kw), JDecoderConfig(**kw)
    lm = CausalLM(cfg)
    sd = init_state_dict(lm, torch.Generator().manual_seed(11))
    lm.load_state_dict(sd)
    lm.eval().requires_grad_(False)
    jmodule = JCausalLM(jcfg)
    b, t = 4, 6
    cache0 = JKVCache.create(cfg.layers, b, cfg.kv_heads, 32, cfg.head_dim,
                             dtype=jnp.float32)
    tree = jax_tree_from_port(jmodule, None, sd, init=lambda r: jmodule.init(
        r, jnp.zeros((b,), jnp.int32), jnp.zeros((1, b, 1), jnp.int32),
        cache0, 0, method="decode_step"))
    rng = np.random.default_rng(11)
    embeds = rng.normal(size=(b, t, cfg.hidden)).astype(np.float32)
    positions = np.broadcast_to(np.arange(t, dtype=np.int32)[None, None],
                                (1, b, t)).copy()

    jmesh = jbuild_mesh(n_data=n_data, n_model=n_model)
    ref = _jax_decoder_run(jpartition(tree, jmesh), jmodule, jcfg,
                           jnp.asarray(embeds), jnp.asarray(positions))
    tp = TensorParallelLM(partition_module(
        lm, build_mesh(n_data, n_model, devices=CPU8)))
    got = _port_decoder_run(tp, cfg, torch.from_numpy(embeds),
                            torch.from_numpy(positions))
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    one = _port_decoder_run(lm, cfg, torch.from_numpy(embeds),
                            torch.from_numpy(positions))
    np.testing.assert_allclose(got, one, atol=2e-4, rtol=2e-4)


def _img(seed=3):
    return np.random.default_rng(seed).integers(0, 255, (48, 64, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("n_model", [2, 4])
def test_glmocr_tp_generate_matches_jax(glm, n_model):
    """``test_tp_production_family_generate`` at ``n_model`` 2 and 4:
    the port's TP family (its tower's MLPs, its decoder) against the JAX
    TP family on the same weights, and against the port's one shard."""
    ours, ref_fam, jcfg, tree = glm
    rt = tp_runtime(n_model)
    assert (rt.n_data, rt.n_model) == (8 // n_model, n_model)
    tp = fam.GLMOCR(ours.module.state_dict(), tiny=True, runtime=rt)
    assert tp.tensor_parallel and tp.decode_path == "graph"
    assert len(tp.module.shards) == n_model
    jref = jfam.VLMFamily.__new__(jfam.GLMOCR)
    jfam.VLMFamily.__init__(jref, jcfg, tree, runtime=JRuntime(
        JRuntimeConfig(compute_dtype="float32", use_mesh=True,
                       mesh=JMeshConfig(n_model=n_model))))
    specs = {str(leaf.sharding.spec)
             for leaf in jax.tree_util.tree_leaves(jref.params)}
    assert any("model" in s for s in specs), specs
    for seed, max_new in ((3, 6), (4, 9)):
        img = _img(seed)
        want = jref.generate([img], "ocr", max_new_tokens=max_new)
        assert tp.generate([img], "ocr", max_new_tokens=max_new) == want
        assert ours.generate([img], "ocr", max_new_tokens=max_new) == want
    e, p, vl, n = ours._build_inputs([_img()], "ocr")
    te, tpos, tvl, tn = tp._build_inputs([_img()], "ocr")
    assert float((te - e).abs().max()) <= 1e-4 * max(1.0, float(
        e.abs().max()))
    assert (tvl.tolist(), tn) == (vl.tolist(), n)


def test_tp_logits_match_one_shard(glm):
    """The prefill and every greedy step's logits of the 4-shard GLM
    against the one-shard ones, ≤ 1e-4 · max|logit|."""
    ours = glm[0]
    tp = fam.GLMOCR(ours.module.state_dict(), tiny=True,
                    runtime=tp_runtime(4))
    got, want = [], []
    e, p, vl, n = ours._build_inputs([_img()], "ocr")
    for model, out in ((ours, want), (tp, got)):
        model._generate_impl(e, p, vl, max_new=8, capacity=256,
                             step_logits=out)
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


def test_unported_tp_paths_raise(glm):
    """OvisOCR2's delta layers, the speculative rounds and the VL models
    without a tensor-parallel form raise ``ConfigError`` under
    ``n_model`` > 1."""
    from oar_ocr_tpu_torch.vl.model import PaddleOCRVL

    with pytest.raises(ConfigError):
        fam.OvisOCR2(tiny=True, runtime=tp_runtime(2))
    tp = fam.GLMOCR(glm[0].module.state_dict(), tiny=True,
                    runtime=tp_runtime(2))
    with pytest.raises(ConfigError):
        tp.generate_speculative([_img()], "ocr", max_new_tokens=4)
    with pytest.raises(ConfigError):
        PaddleOCRVL(runtime=tp_runtime(2))
