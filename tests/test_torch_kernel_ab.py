"""``tools/kernel_ab.py`` on the CPU: its cases, gates, bounds, turn order
and ratios, against a fake ``chip_smoke`` module in a temporary tree (the
real cases need a CUDA card)."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import statistics
import sys
import types

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

# a chip_smoke with two case functions a kernel (the K2 names as the real
# exact_k2_cases gives them); every call of device_ms and of a gate is
# written to LOG, a case's time is its bound times 1.5 (or the TIMES
# entry), and a case whose name holds "BAD" fails its gate
FAKE = '''
LOG = []
TIMES = {}


def device_ms(fn, symbol="", iters=20, bound_ms=0.0):
    fn()
    LOG.append(("time", symbol, bound_ms))
    return TIMES.get(bound_ms, 1.5 * bound_ms)


def _case(name, bound):
    def gate(got, ref):
        LOG.append(("gate", name))
        return 0.0, "BAD" not in name, "fake gate"
    return (name, lambda: name, lambda: name, lambda: name, gate,
            {"bound_ms": bound, "bound_by": "operations"})


def k1_cases():
    return [_case("K1 u8 (8, 1280, 960, 3) -> f32", 0.044)]


def k2_cases():
    return [_case("K2 (1, 16, 4800, 72) valid_len None f32 tower view", 1.585),
            _case("K2 (1, 16, 1024, 128) valid_len None causal f32", 0.0642)]


def exact_k2_cases():
    return [_case("K2 (1, 12, 6256, 128) valid_len None f32 GLM-OCR page "
                  "tower view", 3.589),
            _case("K2 (5, 16, 1025, 64) valid_len None f32 HPD tiles tower "
                  "view", 0.321)]


def k3_cases():
    return [_case("K3 (2508, 1024) f32", 0.0123)]


def k4_cases():
    return [_case("K4 q+k (16+4, 1249, 128) f32", 0.00783)]


def exact_k4_cases():
    return [_case("K4 q+k B=4 T=7 per-row slots f32 HPD verify block",
                  0.00021)]
'''


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_under_test", REPO / "tools" / "kernel_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def ab(monkeypatch):
    """The tool, with sys.path and any chip_smoke module restored after."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    saved = sys.modules.get("chip_smoke")
    yield _load_tool()
    if saved is None:
        sys.modules.pop("chip_smoke", None)
    else:
        sys.modules["chip_smoke"] = saved


def _tree(tmp_path, name="tree", extra=""):
    root = tmp_path / name
    root.mkdir()
    (root / "chip_smoke.py").write_text(FAKE + extra)
    return root


@pytest.mark.parametrize("kernel,makers", [
    ("K1", ("k1_cases",)), ("K2", ("k2_cases", "exact_k2_cases")),
    ("K3", ("k3_cases",)), ("K4", ("k4_cases", "exact_k4_cases"))])
def test_every_case_timed_with_its_bound(ab, tmp_path, kernel, makers):
    tree = _tree(tmp_path)
    out = ab.turn(str(tree), kernel)
    cs = sys.modules["chip_smoke"]
    want = [c for b in makers for c in getattr(cs, b)()]
    assert list(out) == [c[0] for c in want]
    times = [e for e in cs.LOG if e[0] == "time"]
    assert [e[2] for e in times] == [c[5]["bound_ms"] for c in want]
    assert {e[1] for e in times} == {ab.KERNELS[kernel][1]}
    for name, kernel_fn, *_rest, work in want:
        assert out[name] == {"device_ms": 1.5 * work["bound_ms"],
                             "bound_ms": work["bound_ms"]}


def test_k2_holds_the_exact_tower_cases_by_name(ab, tmp_path):
    names = list(ab.turn(str(_tree(tmp_path)), "K2"))
    assert any("GLM-OCR page" in n and "(1, 12, 6256, 128)" in n
               for n in names)
    assert any("HPD tiles" in n for n in names)
    # the real script has the case functions the tool names
    import ast

    real = ast.parse((REPO / "chip_smoke.py").read_text())
    defined = {f.name for f in real.body if isinstance(f, ast.FunctionDef)}
    for makers, *_ in ab.KERNELS.values():
        assert set(makers) <= defined
    assert {"device_ms", "ptxas_report", "demangle"} <= defined


def test_gate_runs_before_each_time(ab, tmp_path):
    ab.turn(str(_tree(tmp_path)), "K2")
    log = sys.modules["chip_smoke"].LOG
    assert [e[0] for e in log] == ["gate", "time"] * 4


def test_failing_gate_stops_the_turn(ab, tmp_path):
    extra = '''
_k2 = k2_cases
def k2_cases():
    return [_k2()[0], _case("K2 BAD (1, 2, 3, 128) f32", 1.0)] + _k2()[1:]
'''
    tree = _tree(tmp_path, extra=extra)
    with pytest.raises(AssertionError, match=r"K2 BAD \(1, 2, 3, 128\) f32"):
        ab.turn(str(tree), "K2")
    log = sys.modules["chip_smoke"].LOG
    # the first case was gated and timed, the bad one gated only, and no
    # case after it ran
    assert log == [("gate", log[0][1]), ("time", "flash_", 1.585),
                   ("gate", "K2 BAD (1, 2, 3, 128) f32")]


def test_only_selects_cases_by_regex(ab, tmp_path):
    out = ab.turn(str(_tree(tmp_path)), "K2", only=r", 128\)")
    assert sorted(out) == sorted(
        ["K2 (1, 16, 1024, 128) valid_len None causal f32",
         "K2 (1, 12, 6256, 128) valid_len None f32 GLM-OCR page tower view"])


@pytest.mark.parametrize("changes,order", [
    (1, [0, 1, 1, 0]), (3, [0, 1, 2, 3, 3, 2, 1, 0])])
def test_turn_order(ab, changes, order):
    assert ab.turn_order(changes) == order


def test_ratio_is_change_median_over_base_median(ab):
    runs = [(0, {"a": {"device_ms": 2.0, "bound_ms": 1.0}}),
            (1, {"a": {"device_ms": 1.0, "bound_ms": 1.0},
                 "b": {"device_ms": 5.0, "bound_ms": 4.0}}),
            (1, {"a": {"device_ms": 1.2, "bound_ms": 1.0},
                 "b": {"device_ms": 5.0, "bound_ms": 4.0}}),
            (0, {"a": {"device_ms": 2.2, "bound_ms": 1.0}})]
    rows = {r["name"]: r for r in ab.summarize(["base", "change"], runs)}
    assert rows["a"]["device_ms"] == [[2.0, 2.2], [1.0, 1.2]]
    assert rows["a"]["change_over_base"] == [
        pytest.approx(statistics.median([1.0, 1.2])
                      / statistics.median([2.0, 2.2]))]
    # a case only the change has: its times, no ratio
    assert rows["b"]["device_ms"] == [[], [5.0, 5.0]]
    assert rows["b"]["change_over_base"] == [None]
    assert rows["b"]["bound_ms"] == 4.0


def test_main_runs_base_change_change_base(ab, tmp_path, monkeypatch,
                                           capsys):
    base, change = _tree(tmp_path, "base"), _tree(tmp_path, "change")
    calls = []
    times = {str(base): [3.0, 3.4], str(change): [2.0, 2.2]}

    def fake_run(cmd, **kw):
        if cmd[0] == "nvidia-smi":
            out = "NVIDIA H100 80GB HBM3, 700.00 W\n"
        elif "--report" in cmd:
            out = json.dumps({"library": "libflash.so", "nvcc_s": 1.0,
                              "ptxas": {"flash_fma_kernel<X>": {
                                  "registers": 200, "smem": 0,
                                  "spill": 0}},
                              "fma": {"128": {"ctas_per_sm": 1}}})
        else:
            tree = cmd[cmd.index("--turn") + 1]
            calls.append(tree)
            out = json.dumps({"GLM": {"device_ms": times[tree].pop(0),
                                      "bound_ms": 1.0}})
        return types.SimpleNamespace(returncode=0, stdout=out, stderr="")

    monkeypatch.setattr(ab.subprocess, "run", fake_run)
    dest = tmp_path / "ab.json"
    assert ab.main(["--kernel", "K2", "--base", str(base), "--change",
                    str(change), "--out", str(dest)]) == 0
    assert calls == [str(base), str(change), str(change), str(base)]
    got = json.loads(dest.read_text())
    assert got["turns"] == [0, 1, 1, 0]
    assert got["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    (row,) = got["cases"]
    assert row["device_ms"] == [[3.0, 3.4], [2.0, 2.2]]
    assert row["change_over_base"] == [pytest.approx(2.1 / 3.2)]
    assert "700.00 W" in capsys.readouterr().out


def test_a_failed_turn_raises(ab, tmp_path, monkeypatch):
    def fake_run(cmd, **kw):
        if cmd[0] == "nvidia-smi":
            return types.SimpleNamespace(returncode=0, stdout="card, 1 W",
                                         stderr="")
        return types.SimpleNamespace(returncode=1, stdout="",
                                     stderr="AssertionError: K2 BAD")

    monkeypatch.setattr(ab.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="K2 BAD"):
        ab.main(["--kernel", "K2", "--base", str(tmp_path)])


def test_docstring_names_the_timing(ab):
    doc = ab.__doc__
    assert "torch.profiler" not in doc
    for words in ("CUDA events", "256 MB", "spin", "bound", "gate"):
        assert words in doc
