"""Sampled request logging (TF-Serving's LoggingConfig surface).

A sample of the requests that succeeded is written as PredictionLog
TFRecords, framed by serving/warmup.py, so the file serves directly as a
version's `assets.extra/tf_serving_warmup_requests`: today's traffic warms
tomorrow's version. The records hold requests only (PredictLog.response
stays empty): warmup replay reads no responses.

- The request path never waits for the disk: it serializes the request
  and enqueues it on a bounded queue; a full queue drops the record and
  counts it (`dropped`), as upstream's log collector sheds rather than
  slows serving.
- A writer thread owns the file and builds the PredictionLog messages.
"""

from __future__ import annotations

import logging
import queue
import random
import threading

from .warmup import frame_tfrecord

log = logging.getLogger("dts_torch.request_log")

# RPC kind -> its PredictionLog field.
_KIND_FIELDS = {
    "predict": "predict_log",
    "classify": "classify_log",
    "regress": "regress_log",
    "multi_inference": "multi_inference_log",
}


class RequestLogger:
    """Sampled PredictionLog TFRecord writer with a bounded queue."""

    def __init__(self, path, sampling_rate: float = 0.01, max_queued: int = 256,
                 rng: random.Random | None = None):
        if not (0.0 <= sampling_rate <= 1.0):
            raise ValueError(f"sampling_rate must be in [0, 1], got {sampling_rate}")
        self.path = path
        self.sampling_rate = sampling_rate
        self.written = 0
        self.dropped = 0
        self._rng = rng or random.Random()
        self._queue: queue.Queue = queue.Queue(maxsize=max_queued)
        self._file = open(path, "ab")
        self._thread = threading.Thread(target=self._loop, name="request-log", daemon=True)
        self._thread.start()

    def maybe_log(self, kind: str, request) -> None:
        """Sample and enqueue one request; never blocks, never raises."""
        try:
            if self._rng.random() >= self.sampling_rate:
                return
            payload = request.SerializeToString()
            try:
                self._queue.put_nowait((kind, payload))
            except queue.Full:
                self.dropped += 1
        except Exception:  # noqa: BLE001 — logging must never cost a request
            log.exception("request sampling failed")

    def stats(self) -> dict:
        return {"path": str(self.path), "sampling_rate": self.sampling_rate,
                "written": self.written, "dropped": self.dropped,
                "queued": self._queue.qsize()}

    def _write_record(self, kind: str, payload: bytes) -> None:
        """Frame and write one record (the writer thread, or close()'s
        last drain; never the request path)."""
        from ..proto import serving_apis_pb2 as apis

        try:
            plog = apis.PredictionLog()
            getattr(plog, _KIND_FIELDS[kind]).request.MergeFromString(payload)
            # One write and flush per record: a crash truncates at most the
            # last record, never interleaves two.
            self._file.write(frame_tfrecord(plog.SerializeToString()))
            self._file.flush()
            self.written += 1
        except Exception:  # noqa: BLE001 — keep draining
            log.exception("request-log write failed")

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            self._write_record(*item)

    def close(self) -> None:
        """Write every pending record, then close the file; idempotent.

        The stop sentinel queues behind the pending records, so the writer
        writes them before it ends; records that came in behind the
        sentinel are written here. A writer still busy after the join's
        timeout keeps the file (closing it under the writer would corrupt
        the stream): close() returns and a later call retries."""
        if self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=10)
        if self._thread.is_alive():
            log.warning("request log %s: writer still busy after the close timeout "
                        "(%d records queued)", self.path, self._queue.qsize())
            return
        if not self._file.closed:
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    self._write_record(*item)
            self._file.close()
        if self.dropped:
            log.warning("request log %s dropped %d records (queue full)", self.path,
                        self.dropped)
