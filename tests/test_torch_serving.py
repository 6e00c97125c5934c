"""The port's serving engine: the JAX engine's tests
(``tests/test_serving.py``) over ``oar_ocr_tpu_torch.serving``, the real
CPU pipeline included, plus what the port adds: a device fault
(``RuntimeError``) from a batch reaches every request's Completion and
is not retried, while a host error still takes the per-request ladder;
and the worker thread runs the pipeline without autograd (grad mode is
per thread in PyTorch)."""

import threading
import time

import numpy as np
import pytest

import torch

from oar_ocr_tpu_torch.errors import InvalidInputError
from oar_ocr_tpu_torch.serving import ServingConfig, ServingEngine
from torch_jax_tree import one_torch_thread  # noqa: F401


class RecordingPipeline:
    """Fake pipeline: result = per-image checksum; records batch sizes."""

    def __init__(self, delay_s: float = 0.0, fail_on=None):
        self.batches = []
        self.delay_s = delay_s
        self.fail_on = fail_on        # image checksum that raises

    def predict(self, images):
        self.batches.append(len(images))
        if self.delay_s:
            time.sleep(self.delay_s)
        out = []
        for im in images:
            key = int(im.sum())
            if self.fail_on is not None and key == self.fail_on:
                raise ValueError(f"poison image {key}")
            out.append(key)
        return out


def _img(fill):
    return np.full((4, 4, 3), fill, np.uint8)


def test_results_match_and_coalesce():
    pipe = RecordingPipeline(delay_s=0.02)
    with ServingEngine(pipe, ServingConfig(max_batch_size=8,
                                           max_wait_ms=20)) as eng:
        handles = [eng.submit(_img(i)) for i in range(16)]
        results = [h.result(timeout=10) for h in handles]
    assert results == [int(_img(i).sum()) for i in range(16)]
    # the first predict blocks the worker while the rest queue up, so at
    # least one later batch must coalesce multiple requests
    assert sum(pipe.batches) == 16
    assert max(pipe.batches) > 1
    assert all(b <= 8 for b in pipe.batches)


def test_single_request_honors_deadline():
    pipe = RecordingPipeline()
    with ServingEngine(pipe, ServingConfig(max_wait_ms=10)) as eng:
        t0 = time.perf_counter()
        res = eng.predict(_img(3), timeout=5)
        dt = time.perf_counter() - t0
    assert res == int(_img(3).sum())
    assert dt < 2.0                     # did not wait for a full batch


def test_poison_request_is_isolated():
    poison = int(_img(7).sum())
    pipe = RecordingPipeline(fail_on=poison)
    with ServingEngine(pipe, ServingConfig(max_batch_size=4,
                                           max_wait_ms=50)) as eng:
        # hold the worker busy so all three land in one batch
        blocker = eng.submit(_img(0))
        time.sleep(0.01)
        good1 = eng.submit(_img(5))
        bad = eng.submit(_img(7))
        good2 = eng.submit(_img(9))
        assert blocker.result(5) == 0
        assert good1.result(5) == int(_img(5).sum())
        assert good2.result(5) == int(_img(9).sum())
        with pytest.raises(ValueError, match="poison"):
            bad.result(5)
    assert eng.stats()["failures"] == 1


def test_validation_rejects_bad_input():
    with ServingEngine(RecordingPipeline()) as eng:
        with pytest.raises(InvalidInputError):
            eng.submit(np.zeros((4, 4), np.uint8))          # no channels
        with pytest.raises(InvalidInputError):
            eng.submit(np.zeros((4, 4, 3), np.float32))     # wrong dtype


def test_concurrent_producers():
    pipe = RecordingPipeline(delay_s=0.005)
    results = {}
    lock = threading.Lock()

    def producer(base):
        with_engine = [eng.submit(_img(base + i)) for i in range(8)]
        for i, h in enumerate(with_engine):
            with lock:
                results[base + i] = h.result(10)

    with ServingEngine(pipe, ServingConfig(max_batch_size=8,
                                           max_wait_ms=10)) as eng:
        threads = [threading.Thread(target=producer, args=(b,))
                   for b in (0, 100, 200)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(results) == 24
    for k, v in results.items():
        assert v == int(_img(k).sum())
    stats = eng.stats()
    assert stats["requests"] == 24 and stats["batches"] >= 3


def test_close_rejects_new_work():
    eng = ServingEngine(RecordingPipeline())
    eng.close()
    with pytest.raises(InvalidInputError):
        eng.submit(_img(1))


class BatchRecorder:
    """Delegates to a pipeline and records each batch of images the
    engine dispatched, in order."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.batches = []

    def predict(self, images):
        self.batches.append(list(images))
        return self.pipe.predict(images)

    def predict_dispatch(self, images):
        self.batches.append(list(images))
        return self.pipe.predict_dispatch(images)

    def predict_collect(self, state):
        return self.pipe.predict_collect(state)


def _same_results(got, want):
    assert len(got.regions) == len(want.regions)
    for a, b in zip(got.regions, want.regions):
        assert np.allclose(a.box, b.box, atol=1e-4)
        assert a.text == b.text


def test_end_to_end_with_real_pipeline():
    """Engine over the port's OAROCR on the CPU (the trained bench
    detector). Copies of one page: every served result equals a direct
    predict of the page (JAX's test). Pages that differ: every served
    result equals its page's result in a direct predict of the batch the
    engine formed; the recognizer pools a batch's crops, so a page's
    texts can depend on its batch (the chunk's width bucket pads SVTR's
    attention), in the JAX package as here."""
    from pathlib import Path

    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
    from oar_ocr_tpu_torch.runtime.runtime import Runtime

    det = str(Path(__file__).resolve().parents[1] / "assets" /
              "bench_det.safetensors")
    imgs = []
    for i in range(3):
        img = np.full((64 + 16 * i, 96, 3), 255, np.uint8)
        img[20:34, 10:80 - 10 * i] = 20
        imgs.append(img)
    pipe = (OAROCRBuilder("general")
            .with_runtime(Runtime("float32", device="cpu"))
            .with_det_source(det)
            .with_det_config(thresh=0.3, box_thresh=0.3)
            .with_batch_sizes(image=2, region=4).build())
    direct = pipe.predict([imgs[0]])[0]
    assert len(direct.regions) >= 1, "vacuous"
    rec = BatchRecorder(pipe)
    with ServingEngine(rec, ServingConfig(max_batch_size=2,
                                          max_wait_ms=5)) as eng:
        copies = [eng.submit(imgs[0].copy()) for _ in range(3)]
        mixed = [eng.submit(im.copy()) for im in imgs + imgs[::-1]]
        served = [h.result(timeout=300) for h in copies + mixed]
    for res in served[:3]:
        _same_results(res, direct)
    # the engine keeps submission order: its batches, in order, are the
    # requests in order
    sent = [im for batch in rec.batches for im in batch]
    assert [im.shape for im in sent] == [
        im.shape for im in [imgs[0]] * 3 + imgs + imgs[::-1]]
    want = [res for batch in rec.batches for res in pipe.predict(batch)]
    for got, res in zip(served, want):
        _same_results(got, res)


def test_close_during_inflight_resolves_everything():
    """Shutdown race regression: every accepted request must resolve even
    when close() lands while requests are queued / in flight."""
    pipe = RecordingPipeline(delay_s=0.01)
    eng = ServingEngine(pipe, ServingConfig(max_batch_size=2,
                                            max_wait_ms=2))
    handles = []
    errors = []

    def producer():
        for i in range(20):
            try:
                handles.append(eng.submit(_img(i % 7)))
            except InvalidInputError:
                errors.append(i)    # engine closed mid-stream: acceptable
            time.sleep(0.002)

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.03)
    eng.close()
    t.join()
    for h in handles:               # accepted => must resolve, no hangs
        h.result(timeout=10)


class SplitPipeline(RecordingPipeline):
    """Fake dispatch/collect pipeline simulating async device work:
    dispatch stamps a ready-time (the "device" finishes device_s after
    dispatch, concurrently with host work); collect blocks until then.
    A sequential predict costs the full device_s per batch, so a
    double-buffering consumer overlaps batch N+1's device time with
    batch N's collect wait."""

    def __init__(self, device_s: float = 0.05, **kw):
        super().__init__(**kw)
        self.device_s = device_s
        self.dispatches = 0
        self.collects = 0
        self.events = []                 # ("d", n) / ("c", n) order probe

    def predict_dispatch(self, images):
        self.dispatches += 1
        self.events.append(("d", self.dispatches))
        out = self.predict(images)       # host-side compute (cheap here)
        return {"ready_at": time.perf_counter() + self.device_s,
                "out": out, "n": self.dispatches}

    def predict_collect(self, state):
        self.collects += 1
        self.events.append(("c", state["n"]))
        wait = state["ready_at"] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)             # "device" still busy
        return state["out"]


def test_double_buffer_overlaps_batches():
    """VERDICT r3 item 3: consecutive engine batches must double-buffer —
    batch N+1's dispatch precedes batch N's collect, and throughput beats
    sequential back-to-back predict by >=1.2x on the same load."""
    n_req, device_s = 6, 0.05
    imgs = [_img(i) for i in range(n_req)]

    # sequential baseline: dispatch+collect back-to-back per request
    seq = SplitPipeline(device_s=device_s)
    t0 = time.perf_counter()
    for im in imgs:
        seq.predict_collect(seq.predict_dispatch([im]))
    t_seq = time.perf_counter() - t0

    pipe = SplitPipeline(device_s=device_s)
    # max_batch_size=1 forces one batch per request: the overlap across
    # batches is the thing under test, not coalescing
    with ServingEngine(pipe, ServingConfig(max_batch_size=1,
                                           max_wait_ms=0)) as eng:
        t0 = time.perf_counter()
        handles = [eng.submit(im) for im in imgs]
        results = [h.result(timeout=10) for h in handles]
        t_pipe = time.perf_counter() - t0

    assert results == [int(im.sum()) for im in imgs]
    assert pipe.dispatches == n_req and pipe.collects == n_req
    # the order probe: some dispatch k+1 happened before collect k
    d_pos = {n: i for i, (kind, n) in enumerate(pipe.events) if kind == "d"}
    c_pos = {n: i for i, (kind, n) in enumerate(pipe.events) if kind == "c"}
    assert any(d_pos[k + 1] < c_pos[k] for k in range(1, n_req)), \
        pipe.events
    assert t_seq / t_pipe >= 1.2, (t_seq, t_pipe)


def test_collect_failure_falls_back_per_request():
    """A host error in collect: the per-request ladder re-runs plain
    predict() for every request (JAX's test raises RuntimeError here,
    which the port treats as a device fault, below)."""
    class FailingCollect(SplitPipeline):
        def predict_collect(self, state):
            raise ValueError("host post-processing fell over")

    pipe = FailingCollect(device_s=0.0)
    with ServingEngine(pipe, ServingConfig(max_batch_size=4,
                                           max_wait_ms=5)) as eng:
        handles = [eng.submit(_img(i)) for i in range(4)]
        results = [h.result(timeout=10) for h in handles]
    assert results == [int(_img(i).sum()) for i in range(4)]


@pytest.mark.parametrize("where", ["dispatch", "collect", "predict"])
def test_device_fault_reaches_every_request(where):
    """A RuntimeError (torch's CUDA fault, failed launch or device OOM)
    is set on each request's Completion as it is, counted as their
    failures, and never retried per request, so no retry can replace it
    with a result."""
    fault = RuntimeError("CUDA error: an illegal memory access was "
                         "encountered")

    class Faulting(SplitPipeline):
        retried = 0

        def predict(self, images):
            if where == "predict" or len(images) == 1:
                Faulting.retried += where != "predict"
                raise fault
            return super().predict(images)

        def predict_dispatch(self, images):
            if where == "dispatch":
                raise fault
            return super().predict_dispatch(images)

        def predict_collect(self, state):
            if where == "collect":
                raise fault
            return super().predict_collect(state)

    pipe = Faulting(device_s=0.0)
    if where == "predict":
        pipe.predict_dispatch = None          # no dispatch/collect split
    with ServingEngine(pipe, ServingConfig(max_batch_size=4,
                                           max_wait_ms=50)) as eng:
        handles = [eng.submit(_img(i)) for i in range(4)]
        for h in handles:
            with pytest.raises(RuntimeError) as info:
                h.result(timeout=10)
            assert info.value is fault
    assert Faulting.retried == 0
    assert eng.stats()["failures"] == 4


def test_worker_runs_without_autograd():
    """Grad mode is per thread: the consumer thread enters no_grad
    itself, so a served output never requires grad even where the
    pipeline's weights do."""
    class GradPipeline:
        def __init__(self):
            self.lin = torch.nn.Linear(3, 2)         # requires_grad=True

        def predict(self, images):
            x = torch.from_numpy(np.stack(images)[:, 0, 0].astype(
                np.float32))
            return list(self.lin(x))

    pipe = GradPipeline()
    assert pipe.predict([_img(1)])[0].requires_grad   # the main thread's
    with ServingEngine(pipe, ServingConfig(max_wait_ms=1)) as eng:
        out = eng.predict(_img(2), timeout=10)
    assert torch.is_grad_enabled()
    assert not out.requires_grad and out.grad_fn is None


def test_idle_engine_collects_immediately():
    """A lone request must not wait for a successor batch before its
    in-flight state is collected."""
    pipe = SplitPipeline(device_s=0.01)
    with ServingEngine(pipe, ServingConfig(max_wait_ms=1)) as eng:
        t0 = time.perf_counter()
        res = eng.predict(_img(5), timeout=5)
        dt = time.perf_counter() - t0
    assert res == int(_img(5).sum())
    assert dt < 1.0
