"""Shared pieces of the front-end tests (``test_torch_hgnet.py``,
``test_torch_server_ocr.py``, ``test_torch_rec_options.py``,
``test_torch_ocr_front.py``, ``test_torch_predictors*.py``,
``test_torch_serving.py``, ``test_torch_cli.py``): a JAX parameter tree
built from a port state_dict, and the fixture that runs a module's tests
on one torch thread.

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
