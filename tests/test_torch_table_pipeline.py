"""The port's ``TableAnalyzer`` against the JAX package on the CPU, in
float32, on the wired route; ``test_torch_table_wireless.py`` holds the
wireless route and SLANet_plus's host path, and
``test_torch_table_structure.py`` ``OARStructure`` with tables on (the
shared pieces are in ``torch_table_common.py``).

Models at the tests' size, their weights the JAX models'
``init_params_fast`` leaves plus seeded numpy noise, carried over by
``params_from_jax``: the table classifier (PP-LCNet v1 ×0.25), the
``rt-detr-l_wired_table_cell_det`` cell detector at the "T" arch (two
decoder layers, hidden 64, 32 queries, as ``test_torch_layout.py``) at
its 640×640 input, SLANet (PP-LCNetV3 ×0.25, 10 steps), SLANet_plus
(PP-LCNet ×0.25, 8 + 1 steps, a 128 canvas) and SLANeXt (ViT dim 64,
depth 2, 8 + 1 steps, a 128 canvas). The JAX table wrappers build their
full-size network, so the tests swap in the small one before its first
call. Pages: two 320×480 pages with a ruled (wired) and an unruled
(wireless) table of dark text blocks drawn with cv2.

The route of a table is the classifier's class, so each test biases the
classifier's last layer to the class it tests (the wired route: cell
detection, reconciliation, row-aware matching; the wireless route: the
structure decode's cells and the IoU/distance matcher) and the
structure decoders' ``<td></td>`` logit (SLANet's ``<tr>`` too), so
that the random decoders emit cells (SLANet: rows of them).

Gates: the same number of results, equal HTML, structure tokens, cell
texts, wired/end-to-end flags, cell boxes within 1e-3 px and structure
scores within 1e-5.
"""

import jax.numpy as jnp
import pytest
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from torch_table_common import (analyze, analyzer_pair, assert_same_tables,
                                detector_pair, make_flats)


@pytest.fixture(scope="module")
def jrt():
    return JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))


@pytest.fixture(scope="module")
def cpu():
    return Runtime("float32", device="cpu")


@pytest.fixture(scope="module")
def flats():
    return make_flats(("slanet", "slanext"))


@pytest.fixture(scope="module")
def detectors(flats, jrt, cpu):
    return detector_pair(flats, jrt, cpu)


def test_analyzer_wired_route(flats, jrt, cpu, detectors):
    """Wired tables, SLANet: cell detection in the crop frame, the
    detected cells reconciled with the decode's, row-aware matching."""
    j, t = analyzer_pair(flats, jrt, cpu, route="wired", structure="slanet",
                         detectors=detectors)
    got, ref = analyze(j, t)
    assert_same_tables(got, ref, wired=True)


def test_analyzer_cells_to_html(flats, jrt, cpu, detectors):
    """Wired tables, SLANeXt, ``use_cells_to_html``: the HTML rebuilt from
    the detected cells' grid."""
    j, t = analyzer_pair(flats, jrt, cpu, route="wired", structure="slanext",
                         detectors=detectors, use_cells_to_html=True)
    got, ref = analyze(j, t)
    assert_same_tables(got, ref, wired=True)
    assert j.analyze_tables(jnp.zeros((1, 8, 8, 3), jnp.uint8), []) == \
        t.analyze_tables(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), []) \
        == []
