"""The port's mesh layer against the JAX package's, on the CPU.

The JAX side runs on ``conftest.py``'s 8 virtual CPU devices; the port's
on 8 virtual CPU devices of its own, a device list that repeats
``torch.device("cpu")`` (``parallel/mesh.py``), where the shards run one
after the other and the all-reduces are plain sums. Both packages run
float32 on the port's seeded weights (``torch_jax_tree``).

- ``MeshConfig.build`` shapes and errors, ``build_mesh``, the env knobs
  ``OAR_TPU_MESH`` / ``OAR_TPU_TP`` and ``round_batch`` / ``pad_batch``:
  equal to the JAX package's (``tests/test_parallel.py:287-325``).
- The data-parallel det+rec step (``parallel/dp.py``) against JAX's
  ``make_dp_ocr_step``: prob maps within 1e-5 · max(1, max|ref|), CTC ids
  and keep flags equal.
- ``OAROCR.predict`` on the mesh against the JAX mesh predict on
  ``TestMeshPredict``'s pages and config, and against the port's own
  single-device predict: same region counts, boxes within 1e-4, same
  texts, confidence within 1e-5.

The tensor-parallel half is in ``test_torch_parallel_tp.py``.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from oar_ocr_tpu.config.runtime import MeshConfig as JMeshConfig
from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.errors import ConfigError as JConfigError
from oar_ocr_tpu.parallel.mesh import build_mesh as jbuild_mesh
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu_torch.config.runtime import MeshConfig, RuntimeConfig
from oar_ocr_tpu_torch.errors import ConfigError
from oar_ocr_tpu_torch.models.layers import init_state_dict, load_weights
from oar_ocr_tpu_torch.parallel.mesh import (Sharded, build_mesh,
                                             replicate, shard_batch)
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from torch_jax_tree import (jax_tree_from_port, one_db_path_module,  # noqa
                            one_torch_thread)

REPO = Path(__file__).resolve().parents[1]
CPU8 = [torch.device("cpu")] * 8

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual JAX devices")


def mesh_runtime(**mesh):
    """A float32 CPU Runtime with a mesh over 8 virtual devices."""
    return Runtime("float32", device="cpu", devices=CPU8, cfg=RuntimeConfig(
        use_mesh=True, mesh=MeshConfig(**mesh)))


def _outcome(build):
    """The mesh's shape, or "refused" (a ``ConfigError``; the JAX
    reshape of the devices to a shape that does not hold them all raises
    ``ValueError``)."""
    try:
        return dict(build().shape)
    except (ConfigError, JConfigError, ValueError):
        return "refused"


@pytest.mark.parametrize("kw", [
    {}, {"n_model": 2}, {"n_model": 4}, {"n_model": 8}, {"n_model": 3},
    {"shape": (8,), "n_model": 2}, {"shape": (8,), "n_model": 3},
    {"shape": (4,)}, {"axes": ("data", "model"), "shape": (2, 4)}])
def test_mesh_config_build_matches_jax(kw):
    ours = _outcome(lambda: MeshConfig(**kw).build(CPU8))
    ref = _outcome(lambda: JMeshConfig(**kw).build())
    assert ours == ref, (ours, ref)


@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2), (2, 4),
                                            (None, 2)])
def test_build_mesh_matches_jax(n_data, n_model):
    ours = build_mesh(n_data, n_model, devices=CPU8)
    ref = jbuild_mesh(n_data, n_model)
    assert ours.shape == dict(ref.shape)
    assert len(ours.data_devices) == ref.shape["data"]
    assert len(ours.model_devices) == ref.shape["model"]


@pytest.mark.parametrize("env", [{"OAR_TPU_TP": "2"},
                                 {"OAR_TPU_TP": "4", "OAR_TPU_MESH": "1"},
                                 {"OAR_TPU_MESH": "0"}, {"OAR_TPU_MESH": ""},
                                 {"OAR_TPU_MESH": "yes"}])
def test_env_knobs_match_jax(env, monkeypatch):
    for k in ("OAR_TPU_TP", "OAR_TPU_MESH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, ref = RuntimeConfig.from_env(), JRuntimeConfig.from_env()
    assert ours.use_mesh == ref.use_mesh
    assert ours.mesh.n_model == ref.mesh.n_model
    assert dict(ours.mesh.build(CPU8).shape) == dict(ref.mesh.build().shape)
    rt = Runtime("float32", device="cpu", devices=CPU8)
    assert (rt.mesh is not None) == bool(ref.use_mesh)
    if rt.mesh is not None:
        assert (rt.n_data, rt.n_model) == (8 // ref.mesh.n_model,
                                           ref.mesh.n_model)


def test_mesh_is_built_only_when_asked(monkeypatch):
    """No request, one device or a repeated CPU device list: no mesh (the
    auto rule needs more than one CUDA card). ``use_mesh=True`` and the
    builder's ``with_mesh`` reach the Runtime."""
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder

    monkeypatch.delenv("OAR_TPU_MESH", raising=False)
    monkeypatch.delenv("OAR_TPU_TP", raising=False)
    assert Runtime("float32", device="cpu").mesh is None
    assert Runtime("float32", device="cpu", devices=CPU8).mesh is None
    rt = mesh_runtime()
    assert (rt.n_data, rt.n_model, rt.device) == (8, 1, torch.device("cpu"))
    assert rt.layout().startswith("mesh {'data': 8}")
    monkeypatch.setattr("oar_ocr_tpu_torch.pipelines.ocr.Runtime",
                        lambda cfg=None: Runtime("float32", device="cpu",
                                                 devices=CPU8, cfg=cfg))
    assert OAROCRBuilder().with_mesh().build().runtime.n_data == 8
    assert OAROCRBuilder().with_mesh(False).build().runtime.mesh is None


def test_named_device_leads_the_mesh(monkeypatch):
    """A device named with its index is the mesh's first (the primary
    device); a device list that does not start with it is refused."""
    monkeypatch.delenv("OAR_TPU_MESH", raising=False)
    monkeypatch.delenv("OAR_TPU_TP", raising=False)
    cpu0 = torch.device("cpu", 0)
    rt = Runtime("float32", device=cpu0, devices=[cpu0] * 8,
                 cfg=RuntimeConfig(use_mesh=True))
    assert rt.device == cpu0 and rt.data_devices == [cpu0] * 8
    with pytest.raises(ConfigError):
        Runtime("float32", device=cpu0, devices=CPU8,
                cfg=RuntimeConfig(use_mesh=True))


def _jax_runtime():
    return JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=True))


@pytest.fixture(scope="module")
def runtimes():
    return mesh_runtime(), _jax_runtime()


@pytest.mark.parametrize("n", range(1, 18))
def test_round_and_pad_batch_match_jax(runtimes, n):
    ours, ref = runtimes
    assert ours.round_batch(n) == ref.round_batch(n)
    a = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    b = np.arange(n, dtype=np.int32)
    for got, want in zip(ours.pad_batch(a, b), ref.pad_batch(a, b)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    one = Runtime("float32", device="cpu")
    assert one.round_batch(n) == n and one.pad_batch(a)[0] is a


def test_shard_replicate_gather():
    mesh = build_mesh(n_data=8, devices=CPU8)
    x = shard_batch(mesh, np.arange(16, dtype=np.float32).reshape(8, 2))
    assert isinstance(x, Sharded) and len(x.shards) == 8
    assert x.shape == (8, 2) and x.gather().tolist() == \
        np.arange(16).reshape(8, 2).tolist()
    net = torch.nn.Linear(3, 2)
    reps = replicate(mesh, net)
    assert len(reps) == 8 and all(r is net for r in reps)  # one CPU copy
    assert [s.device for s in x.shards] == mesh.data_devices
    with pytest.raises(ConfigError):
        shard_batch(mesh, np.zeros((6, 2), np.float32))


def test_run_sharded_outputs():
    """``run_sharded``: one call a shard on its rows, "data" outputs kept
    per shard, "replicated" ones gathered."""
    rt = mesh_runtime()
    calls = []

    def fn(rep, rows):
        calls.append((rep, rows.shape[0]))
        return rows * 2.0, rows.sum(-1, keepdim=True)

    a, b = rt.run_sharded(fn, ["r"] * 8, [np.ones((16, 3), np.float32)],
                          out_spec=("data", "replicated"))
    assert calls == [("r", 2)] * 8
    assert isinstance(a, Sharded) and len(a.shards) == 8
    assert isinstance(b, torch.Tensor) and b.shape == (16, 1)
    assert a.gather().eq(2.0).all()


def test_captured_launches_by_card():
    """A CUDA graph's recorded launches are counted on their cards: taken
    back at the capture, added at every replay."""
    from oar_ocr_tpu_torch.ops import cuda_build
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as k

    saved = (k.launches, k.launches_by_device.copy())
    try:
        k.reset_counts()
        launches = cuda_build.CapturedLaunches()
        with launches.recording():
            k.launches += 3                  # what the wrappers count
            k.launches_by_device.update({0: 1, 1: 2})
        assert k.launches == 0 and not +k.launches_by_device
        launches.replayed()
        launches.replayed()
        assert k.launches == 6 and dict(k.launches_by_device) == {0: 2, 1: 4}
    finally:
        k.launches, k.launches_by_device = saved


# --------------------------- the DP det+rec step ---------------------------

def _ocr_models():
    from oar_ocr_tpu_torch.models.detection.db import DBNet
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer

    det = DBNet(backbone_scale=0.5)
    rec = SVTRRecognizer(32, backbone_scale=0.5, svtr_depth=1)
    out = []
    for m, seed in ((det, 1), (rec, 2)):
        sd = init_state_dict(m, torch.Generator().manual_seed(seed))
        out.append((load_weights(m, sd, dtype=torch.float32), sd))
    return out


def test_dp_step_matches_jax():
    from oar_ocr_tpu.models.detection.db import DBNet as JDBNet
    from oar_ocr_tpu.models.recognition.svtr import (
        SVTRRecognizer as JSVTR)
    from oar_ocr_tpu.parallel.dp import make_dp_ocr_step as jstep
    from oar_ocr_tpu.parallel.mesh import replicate as jreplicate
    from oar_ocr_tpu.parallel.mesh import shard_batch as jshard
    from oar_ocr_tpu_torch.parallel.dp import make_dp_ocr_step

    (det, det_sd), (rec, rec_sd) = _ocr_models()
    jdet = JDBNet(backbone_scale=0.5)
    jrec = JSVTR(vocab_size=32, backbone_scale=0.5, svtr_depth=1)
    det_tree = jax_tree_from_port(jdet, (1, 64, 64, 3), det_sd)
    rec_tree = jax_tree_from_port(jrec, (1, 48, 64, 3), rec_sd)

    rng = np.random.default_rng(7)
    n, m = 8, 16
    pages = rng.integers(0, 255, (n, 64, 64, 3), dtype=np.uint8)
    eye_n = np.tile(np.eye(3, dtype=np.float32)[None], (n, 1, 1))
    eye_m = np.tile(np.eye(3, dtype=np.float32)[None], (m, 1, 1))
    eye_m[1::2, 0, 2] = 3.0                   # the odd crops shifted
    full = np.full((n,), 64, np.int32)
    rec_idx = np.repeat(np.arange(n, dtype=np.int32), 2)[::-1].copy()
    rec_w = np.full((m,), 64, np.int32)
    args = (pages, eye_n, full, full, eye_m, rec_idx, rec_w)

    jmesh = jbuild_mesh(n_data=8)
    ref = jstep(jdet, jrec, jmesh, det_hw=(64, 64), rec_w=64,
                compute_dtype=jax.numpy.float32)(
        jreplicate(jmesh, det_tree), jreplicate(jmesh, rec_tree),
        *(jshard(jmesh, a) for a in args))
    ref = [np.asarray(r) for r in ref]

    mesh = build_mesh(n_data=8, devices=CPU8)
    got = make_dp_ocr_step(mesh, det_hw=(64, 64), rec_w=64,
                           compute_dtype=torch.float32)(
        replicate(mesh, det), replicate(mesh, rec),
        *(shard_batch(mesh, a) for a in args))
    assert all(len(g.shards) == 8 for g in got)
    prob, idx, p, keep = (g.gather().numpy() for g in got)
    err = float(np.abs(prob - ref[0]).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(ref[0]).max())), err
    np.testing.assert_array_equal(idx, ref[1])
    np.testing.assert_array_equal(keep, ref[3])
    np.testing.assert_allclose(p, ref[2], atol=1e-5, rtol=1e-5)


# ----------------------------- the mesh predict -----------------------------

def _pages():
    """``test_parallel.py``'s TestMeshPredict pages."""
    rng = np.random.default_rng(3)
    pages = []
    for _ in range(8):
        img = np.full((200, 160, 3), 255, np.uint8)
        for r in range(3):
            img[30 + 50 * r: 48 + 50 * r, 20:120] = rng.integers(0, 60)
        pages.append(img)
    return pages


def _same(got, want):
    assert sum(len(r.regions) for r in want) > 0, "vacuous: no regions"
    for a_page, b_page in zip(got, want):
        assert len(a_page.regions) == len(b_page.regions)
        for a, b in zip(a_page.regions, b_page.regions):
            np.testing.assert_allclose(a.box, b.box, atol=1e-4)
            assert a.text == b.text
            assert abs(a.confidence - b.confidence) < 1e-5


@pytest.fixture(scope="module")
def predicts(one_db_path_module):
    """(port mesh, port one device, JAX mesh) predicts of the pages, with
    TestMeshPredict's config on the port's seeded weights; the port's
    mesh pipeline too."""
    from oar_ocr_tpu.pipelines.ocr import OAROCRBuilder as JBuilder
    from oar_ocr_tpu.models.detection.db import DBNet as JDBNet
    from oar_ocr_tpu.models.recognition.svtr import (
        SVTRRecognizer as JSVTR)
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder

    def build(rt):
        return (OAROCRBuilder("general").with_runtime(rt)
                .with_det_config(thresh=0.48, box_thresh=0.0)
                .with_batch_sizes(image=4, region=16).build())

    one = build(Runtime("float32", device="cpu"))
    det_sd = {k: v.clone() for k, v in one.detector.model.state_dict().items()}
    rec_sd = {k: v.clone() for k, v in
              one.recognizer.model.state_dict().items()}
    vocab = one.recognizer.decoder.vocab_size
    jpipe = (JBuilder("general").with_runtime(_jax_runtime())
             .with_det_params(jax_tree_from_port(
                 JDBNet(), (1, 64, 64, 3), det_sd))
             .with_rec_params(jax_tree_from_port(
                 JSVTR(vocab_size=vocab), (1, 48, 64, 3), rec_sd))
             .with_det_config(thresh=0.48, box_thresh=0.0)
             .with_batch_sizes(image=4, region=16).build())
    assert jpipe.runtime.n_data == 8
    pipe = build(mesh_runtime())
    pages = _pages()
    return pipe.predict(pages), one.predict(pages), jpipe.predict(pages), pipe


def test_mesh_predict_matches_jax_mesh(predicts):
    got, _, ref, _ = predicts
    _same(got, ref)


def test_mesh_predict_matches_one_device(predicts):
    got, one, _, pipe = predicts
    assert pipe.runtime.n_data == 8
    _same(got, one)


def test_parallel_imports_no_jax():
    """The mesh layer loads neither jax nor the JAX package (a fresh
    interpreter)."""
    code = ("import sys; import oar_ocr_tpu_torch.parallel, "
            "oar_ocr_tpu_torch.parallel.mesh, oar_ocr_tpu_torch.parallel.dp, "
            "oar_ocr_tpu_torch.parallel.tp, "
            "oar_ocr_tpu_torch.config.runtime, "
            "oar_ocr_tpu_torch.runtime.runtime; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'oar_ocr_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
