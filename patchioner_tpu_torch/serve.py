"""Dynamic-batching caption server for the port's `Patchioner`.

Twin of `patchioner_tpu/serve.py` (`CaptionServer`) on one device:
trace, box, region-set and whole-image requests. Requests enqueue from any
thread and return futures; a worker thread coalesces the queue into
micro-batches of up to `max_batch` items or `max_delay_ms` of waiting,
splits each by request kind and then by pixel type, pads each group to the
next size of a ladder of powers of two (so the device sees a few fixed
batch shapes) and runs the model's fused path for that kind
(`caption_traces_fused`, `caption_bboxes_fused`,
`caption_region_sets_fused` or `caption_images_fused`), or for a model
without them (a CLIP backbone, a ViECap decoder, or no support memory)
`forward`, with the flags the JAX server passes (`patchioner_tpu/serve.py:547-605`). Padding rows and
padding boxes are cut off before delivery, so a request's caption does not
depend on its neighbours in the batch.

`warmup` runs dummy batches of each bucket before traffic arrives, on the
worker thread: CUDA libraries keep some state per host thread, which a
warm-up on the caller's thread would leave cold, and a DeCap model's
decoder captures its CUDA graph for each bucket's row count there, so that
no served batch pays a capture (a ViECap model's searches run eagerly). Serving over several
devices (`mesh`) and several worker threads (`workers`) is not ported.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

__all__ = ["CaptionServer", "ServerStats", "ServerOverloaded"]


class ServerOverloaded(RuntimeError):
    """`submit` found the queue at `max_queue`: the request is shed at once,
    which bounds the latency of the requests already admitted."""


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))]


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    batched_items: int = 0  # real items, padding rows excluded
    errors: int = 0
    rejected: int = 0       # shed at admission (max_queue)
    completed: int = 0
    queue_wait_s_sum: float = 0.0  # enqueue -> batch starts
    latency_s_sum: float = 0.0     # enqueue -> future resolved
    latency_s_max: float = 0.0
    recent_latency_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=2048))

    @property
    def mean_batch_size(self) -> float:
        return self.batched_items / self.batches if self.batches else 0.0


class _Request:
    __slots__ = ("pixels", "trace", "bboxes", "region_set", "future", "t_enq")

    def __init__(self, pixels, trace, bboxes=None, region_set=False):
        self.pixels = pixels
        self.trace = trace
        self.bboxes = bboxes
        self.region_set = region_set
        self.future: Future = Future()
        self.t_enq = time.perf_counter()

    @property
    def mode(self) -> str:
        if self.trace is not None:
            return "trace"
        if self.bboxes is not None:
            return "region_set" if self.region_set else "bbox"
        return "cls"


class _Warmup:
    """Dummy (group, mode) batches for the worker thread to run outside
    `stats`; the future resolves when all have run."""

    __slots__ = ("groups", "future")

    def __init__(self, groups):
        self.groups = groups
        self.future: Future = Future()


# the order in which the worker serves the request kinds of one batch
_MODES = ("trace", "bbox", "region_set", "cls")


class CaptionServer:
    """Batched captioning over a built port `Patchioner`.

    Args:
      model: has `crop_dim`, `resize_dim` and either the fused caption
        paths (`caption_traces_fused`, `caption_bboxes_fused`,
        `caption_region_sets_fused`, `caption_images_fused`), when its
        `supports_fused_trace_path()` is true, or `forward`.
      max_batch: largest micro-batch, and the top of the bucket ladder.
      max_delay_ms: how long the worker holding one request waits to fill a
        batch; the latency/throughput knob.
      trace_points: fixed trace length; longer traces are truncated.
      max_boxes: fixed box count of a box or region-set request; more
        boxes are refused at admission.
      preprocess: PIL images are resized and cropped on the submitting
        thread (to uint8, normalised on the device); arrays pass as they are.
      max_queue: optional admission limit (`ServerOverloaded` beyond it).
    """

    def __init__(self, model, *, max_batch: int = 8, max_delay_ms: float = 5.0,
                 trace_points: int = 64, max_boxes: int = 16, preprocess: bool = True,
                 max_queue: Optional[int] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.model = model
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.trace_points = int(trace_points)
        self.max_boxes = int(max_boxes)
        self.preprocess = preprocess
        self.buckets = [1 << i for i in range(self.max_batch.bit_length())
                        if 1 << i < self.max_batch] + [self.max_batch]
        self.max_queue = max_queue
        self.stats = ServerStats()
        self._t0 = time.perf_counter()
        self._q: "queue.Queue[_Request | _Warmup | None]" = queue.Queue()
        self._closed = False
        self._stats_lock = threading.Lock()
        # submit's closed check + enqueue against close's sentinel: a request
        # enqueued after the sentinel would never resolve
        self._lifecycle_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="caption-server")
        self._worker.start()

    # ------------------------------------------------------------- client

    def submit(self, image, trace: Optional[Sequence] = None,
               bboxes: Optional[Sequence] = None, region_set: bool = False) -> Future:
        """Enqueue one request; resolves to the caption string, or for a box
        request without `region_set` to a list of one caption per box.

        `image`: a PIL image or an (H, W, 3) array at the model's crop
        size. `trace`: (x, y) points in [0, 1] or {'x', 'y'} dicts, for a
        trace caption. `bboxes`: up to `max_boxes` xyxy boxes in [0, 1] of
        the preprocessed square image, for a caption per box, or with
        `region_set` one caption for their union. Neither: a whole-image
        caption from the CLS token."""
        if self._closed:
            raise RuntimeError("CaptionServer is closed")
        if trace is not None and bboxes is not None:
            raise ValueError("a request is trace OR bboxes, not both")
        if region_set and (bboxes is None or len(bboxes) == 0):
            # an empty set pools a zero map: a silent garbage caption
            raise ValueError("region_set=True requires a non-empty bboxes")
        if trace is not None and len(trace) == 0:
            # an empty trace pools a zero feature: a NaN prefix under
            # normalize=True and a silent garbage caption
            raise ValueError("trace must contain at least one point")
        self._admit()
        px = self._prep(image)
        hw = self.model.crop_dim
        if px.shape != (hw, hw, 3):
            # reject here: one malformed array would fail its whole batch
            raise ValueError(f"pixels must be ({hw}, {hw}, 3); got {tuple(px.shape)} "
                             f"(preprocess={self.preprocess} does not resize arrays)")
        req = _Request(px, self._norm_trace(trace), self._norm_bboxes(bboxes), region_set)
        with self._lifecycle_lock:
            if self._closed:
                raise RuntimeError("CaptionServer is closed")
            self._admit()  # again under the lock: concurrent submitters
            self._q.put(req)
        with self._stats_lock:
            self.stats.requests += 1
        return req.future

    def caption(self, images: Sequence, traces: Optional[Sequence] = None,
                timeout: Optional[float] = None) -> list:
        """Submit all, wait for all; an image without a trace (`traces`
        None, or a None entry) gets a whole-image caption."""
        if traces is not None and len(traces) != len(images):
            raise ValueError(f"got {len(images)} images but {len(traces)} traces; "
                             "pass None entries for images without a trace")
        traces = traces if traces is not None else [None] * len(images)
        futs = [self.submit(im, tr) for im, tr in zip(images, traces)]
        return [f.result(timeout=timeout) for f in futs]

    def warmup(self, *, trace: bool = True, cls: bool = False, bbox: bool = False,
               region_set: bool = False, buckets: Optional[Sequence[int]] = None,
               pixel_dtype=None) -> None:
        """Run one dummy batch of each bucket (`buckets`, the whole ladder by
        default) for each kind asked for, before taking traffic, and return
        when they have run. They run on the worker thread, each as its own
        group, and stay out of `stats`. `pixel_dtype` is the pixel type the
        clients will send: uint8 when the server preprocesses, else f32."""
        if pixel_dtype is None:
            pixel_dtype = np.uint8 if self.preprocess else np.float32
        dummy = np.zeros((self.model.crop_dim, self.model.crop_dim, 3), pixel_dtype)
        dummy_trace = self._norm_trace([(0.5, 0.5)])
        dummy_boxes = self._norm_bboxes([(0.1, 0.1, 0.9, 0.9)])
        groups = []
        for b in (buckets if buckets is not None else self.buckets):
            if b > self.max_batch:
                raise ValueError(f"warmup bucket {b} exceeds max_batch={self.max_batch}")
            for wanted, mode, make in (
                    (trace, "trace", lambda: _Request(dummy, dummy_trace)),
                    (cls, "cls", lambda: _Request(dummy, None)),
                    (bbox, "bbox", lambda: _Request(dummy, None, dummy_boxes)),
                    (region_set, "region_set",
                     lambda: _Request(dummy, None, dummy_boxes, region_set=True))):
                if wanted:
                    groups.append(([make() for _ in range(b)], mode))
        job = _Warmup(groups)
        with self._lifecycle_lock:
            if self._closed:
                raise RuntimeError("CaptionServer is closed")
            self._q.put(job)
        job.future.result()

    def snapshot(self) -> dict:
        """JSON-ready telemetry. Latency percentiles cover the last 2048
        requests, enqueue to future resolved. A model with a graph decoder
        (`decode`) adds its CUDA graph captures and replays."""
        decode = getattr(self.model, "decode", None)
        graphs = ({} if decode is None else
                  {"decode_captures": decode.captures, "decode_replays": decode.replays})
        with self._stats_lock:
            s = self.stats
            recent = sorted(s.recent_latency_s)
            done = s.completed
            return graphs | {
                "uptime_s": round(time.perf_counter() - self._t0, 3),
                "requests": s.requests, "completed": done,
                "rejected": s.rejected, "errors": s.errors,
                "batches": s.batches,
                "mean_batch_size": round(s.mean_batch_size, 2),
                "queue_depth": self._q.qsize(), "max_queue": self.max_queue,
                "mean_queue_wait_ms": round(s.queue_wait_s_sum / done * 1e3, 3) if done else 0.0,
                "mean_latency_ms": round(s.latency_s_sum / done * 1e3, 3) if done else 0.0,
                "p50_latency_ms": round(_percentile(recent, 0.50) * 1e3, 3),
                "p95_latency_ms": round(_percentile(recent, 0.95) * 1e3, 3),
                "p99_latency_ms": round(_percentile(recent, 0.99) * 1e3, 3),
                "max_latency_ms": round(s.latency_s_max * 1e3, 3),
            }

    def close(self, timeout: Optional[float] = 10.0) -> None:
        with self._lifecycle_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker

    def _admit(self) -> None:
        if self.max_queue is not None and self._q.qsize() >= self.max_queue:
            with self._stats_lock:
                self.stats.rejected += 1
            raise ServerOverloaded(f"request queue at max_queue={self.max_queue}; retry later")

    def _prep(self, image) -> np.ndarray:
        if self.preprocess and not isinstance(image, np.ndarray):
            from patchioner_tpu_torch.utils import transforms

            return transforms.preprocess_pil_uint8(image, self.model.resize_dim,
                                                   self.model.crop_dim)
        return np.asarray(image)

    def _norm_trace(self, trace) -> Optional[list]:
        if trace is None:
            return None
        pts = [(float(p["x"]), float(p["y"])) if isinstance(p, dict)
               else (float(p[0]), float(p[1])) for p in trace]
        return pts[: self.trace_points]

    def _norm_bboxes(self, bboxes) -> Optional[list]:
        """Normalised xyxy boxes -> the model's pixel `[x1, y1, w, h]`."""
        if bboxes is None:
            return None
        if len(bboxes) > self.max_boxes:
            raise ValueError(f"{len(bboxes)} boxes > max_boxes={self.max_boxes} (the "
                             "fixed-shape serving contract; raise max_boxes at construction)")
        d = float(self.model.crop_dim)
        out = []
        for b in bboxes:
            x1, y1, x2, y2 = (float(v) for v in b)
            if x2 < x1 or y2 < y1:
                raise ValueError(f"inverted bbox {b!r} (xyxy expected)")
            out.append((x1 * d, y1 * d, (x2 - x1) * d, (y2 - y1) * d))
        return out

    def _fused_ok(self) -> bool:
        return (hasattr(self.model, "supports_fused_trace_path")
                and self.model.supports_fused_trace_path())

    def _bucket(self, n: int) -> int:
        return next((b for b in self.buckets if n <= b), self.max_batch)

    def _drain(self):
        """Block for one item, then gather requests until max_batch or
        max_delay; a warm-up job comes back alone, None means shut down."""
        first = self._q.get()
        if first is None or isinstance(first, _Warmup):
            return first
        batch = [first]
        deadline = time.perf_counter() + self.max_delay_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None or isinstance(nxt, _Warmup):
                self._q.put(nxt)  # for the next drain (shutdown, or a warm-up)
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        while (batch := self._drain()) is not None:
            if isinstance(batch, _Warmup):
                self._warm(batch)
                continue
            for mode in _MODES:
                # uint8 rows are normalised on the device, float rows are
                # not: stacking both would promote the uint8 rows and skip
                # that step
                in_mode = [r for r in batch if r.mode == mode]
                for group in ([r for r in in_mode if r.pixels.dtype == np.uint8],
                              [r for r in in_mode if r.pixels.dtype != np.uint8]):
                    if group:
                        self._serve(group, mode)

    def _warm(self, job: _Warmup) -> None:
        try:
            for group, mode in job.groups:
                self._run_group(group, mode, record_stats=False)
        except Exception as e:  # noqa: BLE001 - delivered to the warmup caller
            job.future.set_exception(e)
        else:
            job.future.set_result(None)

    def _serve(self, group: list, mode: str) -> None:
        t_start = time.perf_counter()
        try:
            caps = self._run_group(group, mode)
            if len(caps) != len(group):
                raise RuntimeError(f"model returned {len(caps)} captions for "
                                   f"a group of {len(group)}")
        except Exception as e:  # noqa: BLE001 - delivered to every caller
            with self._stats_lock:
                self.stats.errors += 1
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        t_done = time.perf_counter()
        for r, c in zip(group, caps):
            if not r.future.done():  # a caller may have cancelled
                r.future.set_result(c)
        with self._stats_lock:
            s = self.stats
            for r in group:
                lat = t_done - r.t_enq
                s.completed += 1
                s.queue_wait_s_sum += t_start - r.t_enq
                s.latency_s_sum += lat
                s.latency_s_max = max(s.latency_s_max, lat)
                s.recent_latency_s.append(lat)

    def _run_group(self, group: list, mode: str, record_stats: bool = True) -> list:
        n = len(group)
        nb = self._bucket(n)
        if record_stats:
            with self._stats_lock:
                self.stats.batches += 1
                self.stats.batched_items += n
        imgs = np.stack([r.pixels for r in group])
        if nb > n:  # pad with copies of row 0, cut off below
            imgs = np.concatenate([imgs, np.repeat(imgs[:1], nb - n, axis=0)])
        fused = self._fused_ok()
        if mode == "trace":
            if not fused:
                traces = [r.trace for r in group] + [group[0].trace] * (nb - n)
                return list(self.model.forward(imgs, get_cls_capt=False,
                                               traces=traces)["trace_capts"][:n])
            pts = np.zeros((nb, self.trace_points, 2), np.float32)
            valid = np.zeros((nb, self.trace_points), np.float32)
            for i, r in enumerate(group):
                pts[i, : len(r.trace)] = r.trace
                valid[i, : len(r.trace)] = 1.0
            return list(self.model.caption_traces_fused(imgs, pts, valid)[:n])
        if mode == "bbox":
            # padding boxes are the pixel box [0, 0, 1, 1] (the dense-
            # captioning convention, never an empty map); each request's
            # captions are cut back to its own boxes
            boxes = np.tile(np.asarray([0.0, 0.0, 1.0, 1.0], np.float32),
                            (nb, self.max_boxes, 1))
            for i, r in enumerate(group):
                if r.bboxes:
                    boxes[i, : len(r.bboxes)] = r.bboxes
            rows = (self.model.caption_bboxes_fused(imgs, boxes) if fused else
                    self.model.forward(imgs, get_cls_capt=False, bboxes=boxes)["bbox_capts"])
            return [list(rows[i][: len(r.bboxes)]) for i, r in enumerate(group)]
        if mode == "region_set":
            # [-1] * 4 rows pad a set; the merged map skips them
            boxes = np.full((nb, self.max_boxes, 4), -1.0, np.float32)
            for i, r in enumerate(group):
                boxes[i, : len(r.bboxes)] = r.bboxes
            caps = (self.model.caption_region_sets_fused(imgs, boxes) if fused else
                    self.model.forward(imgs, get_cls_capt=False, bboxes=boxes,
                                       get_controllable_capts=True)["set_controllable_capts"])
            return list(caps[:n])
        caps = (self.model.caption_images_fused(imgs) if fused else
                self.model.forward(imgs, get_cls_capt=True)["cls_capt"])
        return list(caps[:n])
