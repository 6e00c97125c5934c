"""The port's ``TableAnalyzer`` on the wireless route, and SLANet_plus's
host path, against the JAX package on the CPU, in float32. Sizes,
weights, pages and gates as ``test_torch_table_pipeline.py`` (the
shared pieces are in ``torch_table_common.py``); and the table modules'
import check.
"""

import subprocess
import sys

import numpy as np
import pytest

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from torch_table_common import (REPO, analyze, analyzer_pair,
                                assert_same_tables, make_flats, pages,
                                structure_pair, table_boxes)


@pytest.fixture(scope="module")
def jrt():
    return JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))


@pytest.fixture(scope="module")
def cpu():
    return Runtime("float32", device="cpu")


@pytest.fixture(scope="module")
def flats():
    return make_flats(("slanet_plus",))


def test_analyzer_wireless_route(flats, jrt, cpu):
    """Wireless tables, SLANet_plus in its keep-ratio canvas: the
    decode's own cells (end to end), the IoU/distance matcher."""
    j, t = analyzer_pair(flats, jrt, cpu, route="wireless",
                         structure="slanet_plus")
    got, ref = analyze(j, t)
    assert_same_tables(got, ref, wired=False)


def test_recognize_images_matches(flats, jrt, cpu):
    """SLANet_plus's host path: keep-ratio nearest resize and pad of host
    crops, then the network; the same tokens, cell boxes within 1e-3 px,
    scores within 1e-5."""
    j, t = structure_pair("slanet_plus", flats["slanet_plus"], jrt, cpu)
    crops = [page[int(y0):int(y1), int(x0):int(x1)]
             for page in pages() for x0, y0, x1, y1 in table_boxes()]
    ref, got = j.recognize_images(crops), t.recognize_images(crops)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.tokens == r.tokens and "<td></td>" in g.tokens
        np.testing.assert_allclose(g.cell_boxes, r.cell_boxes, atol=1e-3,
                                   rtol=0)
        assert abs(g.score - r.score) <= 1e-5


def test_tables_import_no_jax():
    """The table modules load neither jax nor the JAX package (checked in
    a fresh interpreter)."""
    code = ("import sys; import oar_ocr_tpu_torch.pipelines.table_analyzer, "
            "oar_ocr_tpu_torch.models.recognition.slanext_exact, "
            "oar_ocr_tpu_torch.processors.layout_utils, "
            "oar_ocr_tpu_torch.processors.table_ocr_split; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'oar_ocr_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
