"""Shared eval-harness plumbing: timing, FLOPs, predictions, results CSVs.

Twin of `patchioner_tpu/eval/harness.py`. Mirrors the reference's
measurement machinery (SURVEY §2.5/§5): per-phase wall-clock stats
(eval_trace_captioning.py:216-262,326-388), fvcore-style FLOP counting —
here torch's FLOP counter over the plain path (`torch_flops`) — and the
config-keyed results CSV with skip-if-exists dedup
(compute_scores.py:72-119,365-404; run_tasks.py:467-600). `profile_trace`
writes a `torch.profiler` Chrome trace and raises when the profiler cannot
start. `stage_to_device` uploads a prefetched batch from pinned memory on
a side CUDA stream.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "PhaseTimer",
    "timing_summary",
    "torch_flops",
    "encoder_flops",
    "write_predictions",
    "append_results_csv",
    "result_exists",
    "batched",
    "prefetch",
    "parallel_image_loader",
    "stage_to_device",
    "score_and_log",
    "resolve_image_path",
    "profile_trace",
]


class PhaseTimer:
    """Accumulates per-batch wall times for named phases."""

    def __init__(self):
        self.times: dict[str, list] = {}

    def record(self, phase: str, seconds: float):
        self.times.setdefault(phase, []).append(seconds)

    class _Ctx:
        def __init__(self, timer, phase):
            self.timer, self.phase = timer, phase

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            self.timer.record(self.phase, time.perf_counter() - self.t0)

    def phase(self, name: str):
        return self._Ctx(self, name)

    def summary(self, num_items: int) -> dict:
        out = {}
        for phase, ts in self.times.items():
            ts = np.asarray(ts)
            total = float(ts.sum())
            out[phase] = {
                "total_s": total,
                "mean_batch_s": float(ts.mean()),
                "std_batch_s": float(ts.std()),
                "items_per_s": num_items / total if total > 0 else float("inf"),
            }
        return out


def timing_summary(timer: PhaseTimer, num_items: int) -> dict:
    s = timer.summary(num_items)
    inf = s.get("inference", {})
    return {
        "phases": s,
        "images_per_sec_inference": inf.get("items_per_s"),
        "images_per_sec_total": (
            num_items / sum(p["total_s"] for p in s.values()) if s else None
        ),
    }


def torch_flops(fn: Callable, *args) -> float:
    """FLOPs of `fn(*args)` by `torch.utils.flop_counter.FlopCounterMode`
    (replaces the reference's fvcore first-batch measurement).

    The count runs on the plain path: every tensor in `args` (nested in
    dicts, lists and tuples too) becomes a fake CPU tensor of its shape and
    type, so the kernel wrappers take their plain PyTorch versions, which
    compute the same function with the same products, and nothing is
    computed. Counting the card's own call would read 0: a kernel launched
    through ctypes is invisible to the counter."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    def fake(x):
        if isinstance(x, torch.Tensor):
            return torch.empty(x.shape, dtype=x.dtype, device="cpu")
        if isinstance(x, dict):
            return {k: fake(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(fake(v) for v in x)
        return x

    with FakeTensorMode():
        fakes = [fake(a) for a in args]
        counter = FlopCounterMode(display=False)
        with counter:
            fn(*fakes)
    return float(counter.get_total_flops())


def encoder_flops(model, imgs) -> float:
    """FLOPs of one `encode_images` call of `model` on the batch `imgs`
    (the image encoder and the CLS -> patch attention read), counted by
    `torch_flops` on a copy of the model whose weights and pixels are fake
    CPU tensors."""
    import copy

    def run(params, mean, std, pixels):
        twin = copy.copy(model)
        twin.vit_params, twin._mean, twin._std = params, mean, std
        twin.device = torch.device("cpu")
        return twin.encode_images(pixels)["x_norm_clstoken"]

    pixels = imgs if torch.is_tensor(imgs) else torch.from_numpy(np.asarray(imgs))
    return torch_flops(run, model.vit_params, model._mean, model._std, pixels)


def write_predictions(path: str, records) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(records, f)


def score_and_log(
    cands: Sequence[str],
    refs: Sequence[Sequence[str]],
    *,
    csv_path: Optional[str] = None,
    config_row: Optional[dict] = None,
    extra_scores: Optional[dict] = None,
    extra_row: Optional[dict] = None,
) -> dict:
    """Shared scoring tail of every captioning task: corpus metrics +
    per-metric std over instances (reference compute_scores.py:339-357),
    merged with task-supplied extras (PAC-S family), then one config-keyed
    CSV row carrying the METEOR/SPICE variant markers. One body so the
    three task CSVs can never desynchronize on columns or markers."""
    from patchioner_tpu_torch.eval import metrics

    per = metrics.compute_all_metrics(cands, refs)
    scores = {k: v[0] for k, v in per.items()}
    scores.update({f"{k}_std": float(np.std(v[1])) for k, v in per.items()})
    if extra_scores:
        scores.update(extra_scores)
    if csv_path is not None:
        row = dict(config_row or {})
        row.update({k: f"{v:.4f}" for k, v in scores.items()})
        # record which METEOR/SPICE variant ran (lexicon SPICE; synonym
        # stages only when a WordNet corpus is installed) so result CSVs
        # are never compared across machines unawares.
        row.update(metrics.variant_markers())
        if extra_row:
            row.update(extra_row)
        append_results_csv(
            csv_path, row, key_fields=list((config_row or {}).keys())
        )
    return scores


def resolve_image_path(image_roots, file_name: str) -> str:
    """Resolve `file_name` against an ordered list of image roots: first
    root that contains the file wins; otherwise fall back to roots[0] (the
    reference evals' multi-root search, letting the downstream open() raise
    the missing-file error with a concrete path). Accepts a single root
    string. Shared by all four task loaders."""
    if isinstance(image_roots, str):
        image_roots = [image_roots]
    for root in image_roots:
        cand = os.path.join(root, file_name)
        if os.path.exists(cand):
            return cand
    return os.path.join(image_roots[0], file_name)


def _row_key(row: dict, key_fields: Sequence[str]) -> tuple:
    return tuple(str(row.get(k, "")) for k in key_fields)


def result_exists(csv_path: str, row: dict, key_fields: Sequence[str]) -> bool:
    """Skip-if-done check, keyed by the full config combination
    (compute_scores.py:106-119; run_tasks.py:467-600)."""
    if not os.path.exists(csv_path) or not key_fields:
        # With no key fields there is no config identity to match on —
        # every row's key would be the empty tuple and the first row ever
        # written would shadow all later appends.
        return False
    key = _row_key(row, key_fields)
    with open(csv_path, newline="") as f:
        for existing in csv.DictReader(f):
            if _row_key(existing, key_fields) == key:
                return True
    return False


def append_results_csv(
    csv_path: str, row: dict, key_fields: Sequence[str], dedup: bool = True
) -> bool:
    """Append one results row; returns False when an identical config row
    already exists (and dedup is on). Columns grow monotonically."""
    if dedup and result_exists(csv_path, row, key_fields):
        return False
    rows = []
    fields: list = []
    if os.path.exists(csv_path):
        with open(csv_path, newline="") as f:
            reader = csv.DictReader(f)
            fields = list(reader.fieldnames or [])
            rows = list(reader)
    for k in row:
        if k not in fields:
            fields.append(k)
    rows.append({k: row.get(k, "") for k in fields})
    os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
    # atomic replace: the rewrite carries EVERY previously accumulated row,
    # so a crash mid-write must not truncate hours of grid results
    tmp_path = csv_path + f".tmp.{os.getpid()}"
    with open(tmp_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        for r in rows:
            writer.writerow({k: r.get(k, "") for k in fields})
    os.replace(tmp_path, csv_path)
    return True


def batched(items: Sequence, batch_size: int):
    for i in range(0, len(items), batch_size):
        yield i // batch_size, items[i : i + batch_size]


def prefetch(items: Sequence, fn: Callable, depth: int = 2,
             workers: int = 1):
    """Yield `fn(item)` for each item, computing up to `depth` items ahead
    in a background thread.

    The eval pipelines' host work (JPEG decode + resize) otherwise
    serializes with device compute — the accelerator idles while the next
    batch is decoded (reference behavior: a torch DataLoader with workers;
    eval_trace_captioning.py:233-330). With prefetch, the generator's yield
    only blocks when the host falls behind the device, so the
    "preprocessing" phase of PhaseTimer measures true pipeline STALL time,
    not total host work. An exception in `fn` is raised where its item is
    yielded."""
    from concurrent.futures import ThreadPoolExecutor

    if depth < 1:
        for it in items:
            yield fn(it)
        return
    # results are yielded strictly in order (futs[i]); workers>1 only adds
    # overlap between consecutive items' host work/uploads
    with ThreadPoolExecutor(max_workers=max(1, min(workers, depth))) as ex:
        futs = []
        items = list(items)
        for it in items[:depth]:
            futs.append(ex.submit(fn, it))
        for i, _ in enumerate(items):
            if i + depth < len(items):
                futs.append(ex.submit(fn, items[i + depth]))
            yield futs[i].result()


def parallel_image_loader(preprocess_one: Callable, workers: int = None,
                          collate: Callable = None):
    """Batch loader decoding images on a thread pool (PIL decode and
    resize release the GIL), so that prefetch can hide the host work
    behind the device's. `collate` combines the per-item results (default:
    np.stack)."""
    collate = collate or np.stack
    ex = _shared_decode_pool(workers)

    def load(items):
        return collate(list(ex.map(preprocess_one, items)))

    return load


_DECODE_POOLS: dict = {}


def decode_pool_width(workers: int = None) -> int:
    """The thread count of the shared decode pool for `workers` (None: the
    default, min(16, CPU count))."""
    return workers or min(16, os.cpu_count() or 8)


def _shared_decode_pool(workers: int = None):
    """One decode thread pool per worker count, shared process-wide.

    A pool per `parallel_image_loader` call would leak: the returned
    closure pins the executor alive and nothing ever shuts it down, so a
    grid of evaluate() runs accumulates idle worker threads. Decode
    threads are stateless, so sharing is safe."""
    from concurrent.futures import ThreadPoolExecutor

    workers = decode_pool_width(workers)
    pool = _DECODE_POOLS.get(workers)
    if pool is None:
        pool = _DECODE_POOLS[workers] = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="img-decode"
        )
    return pool


def stage_to_device(arrays: Sequence, device) -> list:
    """Host arrays (numpy or CPU tensors) as tensors on `device`, for a
    prefetch worker to hand over ready batches.

    On a CUDA device each array is copied into pinned memory and uploaded
    on a side stream, which the caller waits for before it returns: the
    upload then overlaps the previous batch's compute on the default
    stream and stays out of the timed inference phase. Each tensor is
    recorded on the default stream, which reads it, so that the caching
    allocator does not hand its memory to the side stream while that read
    may still be queued. On any other device the arrays become CPU
    tensors. A failure raises."""
    device = torch.device(device)
    host = [a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]
    if device.type != "cuda":
        return [t.to(device) for t in host]
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        out = [t.pin_memory().to(device, non_blocking=True) for t in host]
    side.synchronize()
    consumer = torch.cuda.default_stream(device)
    for t in out:
        t.record_stream(consumer)
    return out


class profile_trace:
    """Context manager around `torch.profiler.profile` (CPU activity, and
    CUDA when a card is present) that writes a Chrome trace to
    `log_dir/trace.json` on exit — the replacement for the reference's
    wall-clock-only instrumentation (SURVEY §5). Raises when the profiler
    cannot start; there is no silent no-op.

        with harness.profile_trace("/tmp/trace"):
            model.forward(...)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "trace.json")
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        self._prof = prof
        return self

    def __exit__(self, *exc):
        prof, self._prof = self._prof, None
        prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(self.path)
        return False
