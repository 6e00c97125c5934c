"""Shared pieces of the front-end tests (``test_torch_hgnet.py``,
``test_torch_server_ocr.py``, ``test_torch_rec_options.py``,
``test_torch_ocr_front.py``, ``test_torch_predictors*.py``,
``test_torch_serving.py``, ``test_torch_cli.py``): a JAX parameter tree
built from a port state_dict, the fixture that runs a module's tests on
one torch thread, and the fixtures that put both packages' DB
postprocess on one path (:func:`pin_db_path`).

``params_from_jax`` maps a flax flat key to the port's name and layout.
:func:`jax_tree_from_port` runs that map backwards over the flax
module's own parameter shapes (``jax.eval_shape`` of its ``init``, no
compute): each flat key's port name (``torch_name``) is looked up in the
port's state_dict and the layout undone (OIHW → HWIO, a transposed
convolution's (in, out, kH, kW) → flax's spatially flipped (kH, kW, in,
out), Linear (out, in) → (in, out)). Both packages then run the same
weights, and the port's seeded or calibrated weights serve the JAX model
without its slow eager ``init``. Every flax leaf must be found with its
own shape, and ``params_from_jax`` of the tree must give the port's
state_dict back, so the map is checked both ways.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.runtime.weights import unflatten_params
from oar_ocr_tpu_torch.runtime.weights import (_DECONV_NAMES,
                                               params_from_jax, torch_name)


def jax_tree_from_port(module, example_shape, state_dict, init=None):
    """The flax parameter tree of ``module`` (initialised on an input of
    ``example_shape``, or by ``init(rng)`` when given: a module whose
    ``init`` takes other inputs or a method) holding ``state_dict``'s
    values."""
    init = init or (lambda r: module.init(r, jnp.zeros(
        tuple(example_shape), jnp.float32)))
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        name = torch_name(key)
        v = state_dict[name].detach().float().cpu().numpy()
        if key.endswith("/kernel") and v.ndim == 4:
            v = (np.transpose(v, (2, 3, 0, 1))[::-1, ::-1]
                 if name in _DECONV_NAMES else np.transpose(v, (2, 3, 1, 0)))
        elif key.endswith("/kernel") and v.ndim == 2:
            v = v.T
        assert v.shape == tuple(leaf.shape), (key, v.shape, leaf.shape)
        flat[key] = np.ascontiguousarray(v, np.float32)
    back = params_from_jax(flat)
    assert set(back) == set(state_dict), set(back) ^ set(state_dict)
    for k, v in back.items():
        assert np.array_equal(v.numpy(), state_dict[k].float().numpy()), k
    return unflatten_params(flat)


def rel_err(got, ref) -> float:
    """max|got − ref| / max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's tests on one torch thread, then restore the count.
    The tier-1 run puts six pytest-xdist workers on the machine's cores,
    and each worker's torch pool would take every core: these modules ran
    about 4× slower under that oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pin_db_path(mp: pytest.MonkeyPatch) -> None:
    """Both packages' DB postprocess on one path, through ``mp``: their
    C++ extensions, or else both their Python paths. The two paths need
    not find the same boxes (on ``test_torch_rec_options.py``'s inverted
    page the Python one finds a region fewer, on
    ``test_torch_predictors_heavy.py``'s pages a corner moves by 285 px),
    and each package's two paths agree with the other package's. The JAX
    package builds its extension in place at first use (``native/setup.py
    build_ext --inplace``), and the test workers start together in a
    fresh checkout: a worker whose build collides with another's keeps
    the Python path for its life, so the reference would read the pages
    on the other path than the port. The reference retries its load
    until the extension another worker built is in place (up to 120 s);
    if it never is, the port takes its Python path too."""
    from oar_ocr_tpu import native as jnative
    from oar_ocr_tpu_torch import native as pnative

    deadline = time.monotonic() + 120.0
    while not (jnative.available() or os.environ.get("OAR_TPU_NO_NATIVE")
               or time.monotonic() > deadline):
        mp.setattr(jnative, "_tried", False)
        time.sleep(1.0)
    if not jnative.available():
        mp.setattr(pnative, "_tried", True)
        mp.setattr(pnative, "_native", None)


@pytest.fixture
def one_db_path(monkeypatch):
    """:func:`pin_db_path` for one test."""
    pin_db_path(monkeypatch)


@pytest.fixture(scope="module")
def one_db_path_module():
    """:func:`pin_db_path` for a module's fixtures and tests."""
    with pytest.MonkeyPatch.context() as mp:
        pin_db_path(mp)
        yield
