"""Where the trace evaluator's time goes in the PyTorch port, on a card.

    python3 -m scripts.profile_torch_eval

Writes `chip_smoke.py` phase 13's seeded dataset (64 JPEG images of
640 x 480, 97 traces of 50-400 points) into a temporary directory, builds
the flagship (ViT-B/14-reg at 518 px, the 591,753-row bank, bf16, seeded)
once, warms its decode graphs, and runs the port's trace evaluator
(`eval/trace_captioning.py`, batches of 16) three times in each of six
setups:

- as it is: PIL decode and resize on the shared decode pool, and each
  batch staged on the card by the prefetch worker (pinned memory, a side
  stream);
- with the images decoded beforehand (a loader handing out cached uint8
  arrays), so that the host threads do no PIL work;
- the same without the staging: numpy batches, uploaded by the model
  inside the timed inference phase;
- PIL decode without the staging;
- PIL decode, each batch staged by the worker from pageable memory on the
  default stream (no pinned copy, no side stream);
- PIL decode, each batch staged by the worker from pinned memory on the
  default stream;

each with its inference and preprocessing (stall) seconds and traces/s in
inference. Then a bare loop of `caption_traces_fused` over the six full
batches, staged on the card beforehand (host clock, the card synchronised),
one batch's prefix step and decode by CUDA events, and three batches of
the evaluator under `torch.profiler` (device time against the inference
phase, the kernels by device time). Prints the card's name and power
limit. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from patchioner_tpu_torch import entry  # noqa: E402
from patchioner_tpu_torch.eval import harness, trace_captioning  # noqa: E402
from patchioner_tpu_torch.models.patchioner import trace_arrays  # noqa: E402

BATCH = cs.EVAL_BATCH


def _evaluate(model, paths, tag: str, **kw) -> None:
    out = []
    for _ in range(3):
        torch.cuda.synchronize()
        result = trace_captioning.evaluate(model, paths["trace"], paths["images"],
                                           batch_size=BATCH, **kw)
        phases = result["timing"]["phases"]
        out.append((phases["inference"]["total_s"], phases["preprocessing"]["total_s"],
                    result["timing"]["images_per_sec_inference"]))
    print(f"[profile eval {tag}] inference s, stall s, traces/s: "
          + "; ".join(f"{a:.3f} {b:.3f} {c:.1f}" for a, b, c in out), flush=True)


def main() -> None:
    _, smi = cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory(prefix="profile_eval_") as scratch:
        os.environ["IM2TXT_MEMORY_PATH"] = scratch
        paths = cs.write_eval_dataset(os.path.join(scratch, "eval"), 130)
        model = cs.build_model(cs.FLAGSHIP_CONFIG, 0, "[profile eval]")
        cs._eval_warmup(model)
        samples = trace_captioning.load_trace_dataset(paths["trace"], paths["images"])
        decoded = {p: cs._eval_pixels([p], model)[0] for p in set(samples["img_paths"])}

        def cached(batch_paths):
            return np.stack([decoded[p] for p in batch_paths])

        _evaluate(model, paths, "as is")
        _evaluate(model, paths, "pre-decoded pixels", loader=cached)

        def pageable(arrays, device):
            out = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
            torch.cuda.current_stream(device).synchronize()
            return out

        def pinned_default_stream(arrays, device):
            out = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
                device, non_blocking=True) for a in arrays]
            torch.cuda.current_stream(device).synchronize()
            return out

        staged = harness.stage_to_device
        try:
            harness.stage_to_device = lambda arrays, device: list(arrays)
            _evaluate(model, paths, "pre-decoded, not staged", loader=cached)
            _evaluate(model, paths, "PIL, not staged")
            harness.stage_to_device = pageable
            _evaluate(model, paths, "PIL, staged from pageable memory, default stream")
            harness.stage_to_device = pinned_default_stream
            _evaluate(model, paths, "PIL, staged from pinned memory, default stream")
        finally:
            harness.stage_to_device = staged

        max_pts = max(len(t) for t in samples["traces"])
        n_full = len(samples["traces"]) // BATCH
        batches = []
        for i in range(0, n_full * BATCH, BATCH):
            pts, valid = trace_arrays(samples["traces"][i:i + BATCH], max_points=max_pts)
            batches.append(harness.stage_to_device(
                [cached(samples["img_paths"][i:i + BATCH]), pts, valid], model.device))
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                model.caption_traces_fused(*b)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"[profile eval bare loop] {n_full} batches of {BATCH} staged: "
                  f"{dt * 1e3 / n_full:.1f} ms a batch, {n_full * BATCH / dt:.1f} traces/s",
                  flush=True)

        step = entry.make_prefix_step(model.vit_cfg, model.bank.num_real,
                                      use_attention=False, normalize=model.normalize)
        px, pts, valid = batches[0]
        pixels = model.pixels_to_device(px)
        for _ in range(3):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
            prefix = step(model.state(), pixels, pts, valid)
            events[1].record()
            model.decode(prefix)
            events[2].record()
            torch.cuda.synchronize()
            print(f"[profile eval split] prefix step {events[0].elapsed_time(events[1]):.2f} "
                  f"ms, decode {events[1].elapsed_time(events[2]):.2f} ms (CUDA events)",
                  flush=True)

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            result = trace_captioning.evaluate(model, paths["trace"], paths["images"],
                                               batch_size=BATCH, limit=3 * BATCH)
            torch.cuda.synchronize()
        averages = prof.key_averages()
        device_ms = sum(getattr(e, "self_device_time_total", 0) for e in averages) / 1e3
        phases = result["timing"]["phases"]
        print(f"[profile eval profiled] {3 * BATCH} traces: device {device_ms:.1f} ms, "
              f"inference {phases['inference']['total_s'] * 1e3:.1f} ms, stall "
              f"{phases['preprocessing']['total_s'] * 1e3:.1f} ms", flush=True)
        print(averages.table(sort_by="self_cuda_time_total", row_limit=12), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
