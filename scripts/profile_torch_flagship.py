"""Where the time of one flagship batch goes in the PyTorch port, on a card.

    python3 -m scripts.profile_torch_flagship             # every configuration
    python3 -m scripts.profile_torch_flagship flash ...   # the ones named

Builds the flagship model of `chip_smoke.py` (ViT-B/14-reg at 518 px, the
591,753-row bank, 30-step DeCap decode, seeded random bf16 weights), once
for each attention configuration of its encoder (`fusedqkv` and the ones
of `chip_smoke.CONFIGS`), then `int8_bank` (the flagship with
`memory_bank_int8: true`), `giant` (`chip_smoke.GIANT_CONFIG`, ViT-g/14
at full width with the 1536-wide bank) and `giant_fusedqkv_proj` (giant
with `attn_impl: fusedqkv_proj`), and captions one batch of 8 trace
requests:

- the stage split (encoder, trace pooling + memory projection, decode)
  with CUDA events, over 5 batches;
- one batch under `torch.profiler`: device time per kernel, the sum of the
  device time of all kernels and copies, and the card's idle share of the
  batch's wall time (1 - device time / wall time);
- the peak of allocated device memory.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from patchioner_tpu_torch import entry
from patchioner_tpu_torch.models import decap, vit
from patchioner_tpu_torch.models.patchioner import Patchioner
from patchioner_tpu_torch.ops import region_pooling as rp


def stage_ms(model, imgs, pts, valid) -> list:
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    state = model.state()
    with torch.no_grad():
        ev[0].record()
        outs = vit.vit_forward(state["vit"], model.pixels_to_device(imgs), model.vit_cfg)
        ev[1].record()
        grid = rp.traces_to_grid(pts, valid, model.vit_cfg.grid_size)
        feats = rp.trace_pool(outs["x_norm_patchtokens"], grid)
        prefix = entry.project(state, feats, model.bank.num_real, normalize=model.normalize)
        ev[2].record()
        decap.greedy_decode(model.decoder, prefix, model.gpt2_cfg)
        ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def profile_config(label: str, config: dict, smi: str) -> None:
    model = Patchioner.from_config(config, allow_missing_weights=True,
                                   dtype=torch.bfloat16, device="cuda")
    imgs, traces = chip_smoke._requests(chip_smoke.B, 0)
    pts, valid = chip_smoke._padded(traces)
    model.caption_traces_fused(imgs, pts, valid)  # first-call set-up
    pts_d, valid_d = torch.from_numpy(pts).cuda(), torch.from_numpy(valid).cuda()
    stages = [stage_ms(model, imgs, pts_d, valid_d) for _ in range(5)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.caption_traces_fused(imgs, pts, valid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    print(f"== {label} {config}")
    print(events.table(sort_by="self_cuda_time_total", row_limit=12))
    # only the device's own events: an operator's row repeats the time of
    # the kernels it launched
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    print(json.dumps({"config": label,
                      "stage_ms (encoder, pooling + projection, decode), 5 batches": stages,
                      "profiled_batch_wall_ms": wall_ms, "device_ms": device_ms,
                      "idle_share": 1 - device_ms / wall_ms,
                      "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "card": smi}))
    del model
    torch.cuda.empty_cache()


def main() -> None:
    flagship = chip_smoke.FLAGSHIP_CONFIG
    configs = {name: dict(flagship, **opts) for name, opts in (
        ("fusedqkv", {"attn_impl": "fusedqkv"}), *chip_smoke.CONFIGS.items(),
        ("int8_bank", {"memory_bank_int8": True}))}
    configs["giant"] = chip_smoke.GIANT_CONFIG
    configs["giant_fusedqkv_proj"] = dict(chip_smoke.GIANT_CONFIG,
                                          **chip_smoke.CONFIGS["fusedqkv_proj"])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("configs", nargs="*",
                    help=f"any of {', '.join(configs)}; every one when none is named")
    args = ap.parse_args()
    unknown = sorted(set(args.configs) - set(configs))
    if unknown:
        ap.error(f"unknown configurations {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_flagship: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    for label in args.configs or configs:
        profile_config(label, configs[label], smi)


if __name__ == "__main__":
    main()
