"""Micro-batching serving engine.

Counterpart of ``oar_ocr_tpu/serving/engine.py`` (:1-338), with its
semantics: deadline micro-batching (take the first queued request, then
drain up to ``max_batch_size`` more until ``max_wait_ms`` after ITS
arrival); two-deep pipelining through the pipeline's
``predict_dispatch`` / ``predict_collect`` split (``OAROCR``'s,
``pipelines/ocr.py``): batch N+1's upload and detection are queued on
the card before batch N is collected, and an idle engine collects at
once; backpressure (``submit`` blocks at ``max_queue``); ``close()``
resolves everything in flight; a pipeline without the split runs each
batch with ``predict``.

What the port adds, and why:

- **The consumer thread owns all device work, and runs it without
  autograd.** PyTorch's grad mode is per thread, so the worker enters
  ``torch.no_grad()`` itself, as the main thread's callers do
  (the model wrappers also hold their weights with
  ``requires_grad=False``).
- **A device fault is not retried.** A batch that fails with a host
  error falls back to one ``predict`` per request, as in JAX
  (``_fallback_per_request``), so one bad input cannot fail its
  neighbours. A ``RuntimeError`` is what torch raises for a CUDA fault,
  a failed kernel launch or device out-of-memory (the convention of
  ``pipelines/ocr.py``): it is set, as it is, on the ``Completion`` of
  every request of the batch and counted as their failures, so it
  reaches each caller and is never replaced by a retry's result.
- Dispatch does not wait for the device: ``predict_dispatch`` uploads
  through pinned memory with non-blocking copies (``Runtime.put``; the
  caching host allocator keeps each pinned block until its copy has
  run) and starts its fetches without joining them.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..errors import InvalidInputError


@dataclass(frozen=True)
class ServingConfig:
    """Engine knobs.

    max_batch_size: hard cap on requests coalesced into one predict call
        (match it to the pipeline's image_batch_size or a multiple).
    max_wait_ms: deadline from the FIRST queued request's arrival; a lone
        request never waits longer than this before running.
    max_queue: backpressure bound — ``submit`` blocks once this many
        requests are waiting (0 = unbounded).
    """

    max_batch_size: int = 16
    max_wait_ms: float = 5.0
    max_queue: int = 256

    def __post_init__(self):
        if self.max_batch_size < 1:
            raise InvalidInputError("max_batch_size must be >= 1")
        if self.max_wait_ms < 0:
            raise InvalidInputError("max_wait_ms must be >= 0")


@dataclass
class ServingStats:
    """Cumulative engine statistics (HpdRuntimeStats-style counters)."""

    requests: int = 0
    batches: int = 0
    batched_requests: int = 0
    failures: int = 0
    latencies_ms: List[float] = field(default_factory=list)

    @property
    def mean_batch_size(self) -> float:
        return self.batched_requests / self.batches if self.batches else 0.0

    def latency_quantile(self, q: float) -> float:
        if not self.latencies_ms:
            return 0.0
        xs = sorted(self.latencies_ms)
        idx = min(int(q * len(xs)), len(xs) - 1)
        return xs[idx]

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch_size": round(self.mean_batch_size, 2),
            "failures": self.failures,
            "p50_ms": round(self.latency_quantile(0.50), 1),
            "p99_ms": round(self.latency_quantile(0.99), 1),
        }


class Completion:
    """Handle for one submitted request (thin wrapper over a Future)."""

    def __init__(self):
        self._future: Future = Future()
        self._t_submit = time.perf_counter()

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None):
        """Block for the result; re-raises the request's failure."""
        return self._future.result(timeout)


class _Request:
    __slots__ = ("image", "completion")

    def __init__(self, image: np.ndarray, completion: Completion):
        self.image = image
        self.completion = completion


class ServingEngine:
    """Coalesce single-image requests into batched ``predict`` calls.

    Works with any pipeline object exposing
    ``predict(images: Sequence[np.ndarray]) -> Sequence[result]`` —
    OAROCR, OARStructure, or a bare predictor.
    """

    def __init__(self, pipeline, cfg: ServingConfig = ServingConfig(),
                 *, validate: Optional[Callable[[Any], None]] = None):
        self.pipeline = pipeline
        self.cfg = cfg
        # double-buffer across batches when the pipeline exposes the
        # dispatch/collect split (OAROCR does; bare predictors don't)
        self._can_pipeline = (
            callable(getattr(pipeline, "predict_dispatch", None))
            and callable(getattr(pipeline, "predict_collect", None)))
        self._validate = validate if validate is not None \
            else self._default_validate
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=cfg.max_queue)
        self._stats = ServingStats()
        self._stats_lock = threading.Lock()
        # serializes the closed-check+enqueue pair against close(), so the
        # shutdown sentinel is always the LAST item ever enqueued — no
        # request can land behind it and hang unresolved
        self._submit_lock = threading.Lock()
        self._closed = False
        self._drained = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="oar-serving-worker")
        self._worker.start()

    # ------------------------------ API ------------------------------

    def submit(self, image: np.ndarray) -> Completion:
        """Enqueue one page; returns immediately with a Completion.
        Blocks only when the queue is at its backpressure bound."""
        self._validate(image)
        completion = Completion()
        with self._submit_lock:
            if self._closed:
                raise InvalidInputError("engine is closed")
            self._queue.put(_Request(image, completion))
        with self._stats_lock:
            self._stats.requests += 1
        return completion

    def predict(self, image: np.ndarray, timeout: Optional[float] = None):
        """Synchronous convenience: submit + wait."""
        return self.submit(image).result(timeout)

    def stats(self) -> dict:
        with self._stats_lock:
            return self._stats.snapshot()

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain outstanding work and stop the worker."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)               # sentinel — final item
        self._worker.join(timeout)

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------- worker -----------------------------

    @staticmethod
    def _default_validate(image) -> None:
        if not isinstance(image, np.ndarray) or image.ndim != 3 \
                or image.shape[2] != 3 or image.dtype != np.uint8:
            raise InvalidInputError(
                "expected HWC uint8 RGB ndarray",
                shape=getattr(image, "shape", None),
                dtype=str(getattr(image, "dtype", None)))

    def _take_batch(self):
        """Block for the first request, then coalesce until the size cap
        or the deadline from ITS arrival. Returns (batch, shutting_down);
        the sentinel is guaranteed to be the final queue item (see
        _submit_lock), so seeing it — first or mid-batch — ends the loop
        after the current batch executes."""
        first = self._queue.get()
        if first is None:
            return [], True
        batch = [first]
        # anchor the deadline at the request's ARRIVAL (submit time), not
        # at dequeue: a request that aged in the queue behind a long
        # predict coalesces only from what is already waiting
        deadline = first.completion._t_submit + self.cfg.max_wait_ms / 1e3
        while len(batch) < self.cfg.max_batch_size:
            remaining = deadline - time.perf_counter()
            try:
                item = (self._queue.get_nowait() if remaining <= 0
                        else self._queue.get(timeout=remaining))
            except queue.Empty:
                return batch, False
            if item is None:
                return batch, True
            batch.append(item)
        return batch, False

    def _take_batch_nowait(self):
        """Non-blocking batch formation: coalesce whatever is queued RIGHT
        NOW (up to the size cap), never waiting. Used while a dispatched
        batch is in flight — if nothing is queued, the caller collects the
        in-flight batch instead of stalling it behind an idle wait."""
        batch = []
        while len(batch) < self.cfg.max_batch_size:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return batch, False
            if item is None:
                return batch, True
            batch.append(item)
        return batch, False

    def _run(self) -> None:
        with torch.no_grad():
            self._serve()

    def _serve(self) -> None:
        shutting_down = False
        pending = None              # (requests, dispatched state)
        while not shutting_down:
            if pending is None:
                batch, shutting_down = self._take_batch()
            else:
                batch, shutting_down = self._take_batch_nowait()
                if not batch and not shutting_down:
                    self._collect_pending(pending)
                    pending = None
                    continue
            if batch:
                if self._can_pipeline:
                    nxt = self._dispatch_batch(batch)
                    if pending is not None:
                        self._collect_pending(pending)
                    pending = nxt
                else:
                    self._execute(batch)
        if pending is not None:
            self._collect_pending(pending)
        # defensive: fail anything that slipped in (should be impossible
        # given the sentinel-last invariant)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item.completion._future.set_exception(
                    InvalidInputError("engine is closed"))

    def _deliver(self, batch: List[_Request], results) -> None:
        if len(results) != len(batch):
            raise InvalidInputError(
                "pipeline returned wrong result count",
                expected=len(batch), got=len(results))
        for r, res in zip(batch, results):
            r.completion._future.set_result(res)

    def _fail_batch(self, batch: List[_Request], exc: Exception) -> None:
        """A batch that failed: a device fault (``RuntimeError``) is set on
        every request's Completion; any other error takes the
        per-request ladder."""
        if not isinstance(exc, RuntimeError):
            self._fallback_per_request(batch)
            return
        for r in batch:
            if not r.completion.done():
                r.completion._future.set_exception(exc)
        with self._stats_lock:
            self._stats.failures += len(batch)

    def _fallback_per_request(self, batch: List[_Request]) -> None:
        """batched→per-request isolation ladder (ocr.rs:576-588):
        one bad input must not fail its co-batched neighbours."""
        for r in batch:
            try:
                (res,) = self.pipeline.predict([r.image])
                r.completion._future.set_result(res)
            except Exception as per_exc:  # noqa: BLE001
                r.completion._future.set_exception(per_exc)
                with self._stats_lock:
                    self._stats.failures += 1

    def _note_batch(self, batch: List[_Request]) -> None:
        with self._stats_lock:
            self._stats.batches += 1
            self._stats.batched_requests += len(batch)
            now = time.perf_counter()
            for r in batch:
                self._stats.latencies_ms.append(
                    (now - r.completion._t_submit) * 1e3)
            del self._stats.latencies_ms[:-1000]

    def _dispatch_batch(self, batch: List[_Request]):
        """Issue uploads + detection dispatches for a batch; returns the
        in-flight (requests, state) pair, or None when dispatch itself
        failed (the batch is then resolved via the per-request ladder)."""
        try:
            state = self.pipeline.predict_dispatch(
                [r.image for r in batch])
            return (batch, state)
        except Exception as exc:  # noqa: BLE001
            self._fail_batch(batch, exc)
            self._note_batch(batch)
            return None

    def _collect_pending(self, pending) -> None:
        batch, state = pending
        try:
            self._deliver(batch, self.pipeline.predict_collect(state))
        except Exception as exc:  # noqa: BLE001
            self._fail_batch(batch, exc)
        self._note_batch(batch)

    def _execute(self, batch: List[_Request]) -> None:
        try:
            self._deliver(batch,
                          self.pipeline.predict([r.image for r in batch]))
        except Exception as exc:  # noqa: BLE001
            self._fail_batch(batch, exc)
        self._note_batch(batch)
