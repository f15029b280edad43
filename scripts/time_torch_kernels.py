"""Time some of the port's kernels on a card, at the shapes of `chip_smoke.py`.

    python3 -m scripts.time_torch_kernels memory_project memory_project_giant
    python3 -m scripts.time_torch_kernels memory_project_int8 memory_project_int8_giant
    python3 -m scripts.time_torch_kernels --dtype float32 memory_project

Runs the named cases of `chip_smoke._kernel_cases` (every case when none is
named; bf16 unless `--dtype float32`): each kernel call and its plain
version timed by `chip_smoke.cuda_ms` (CUDA events, median of 10 after 3
warm-ups), with the bytes it must move and the rate that makes, and the
device time of each kernel and copy the call launches (`torch.profiler`
over 5 calls, a call's mean). One JSON line a case, then the card's name
and power limit. To time another
checkout's kernels with this script, run it from that checkout's root with
`PYTHONPATH=.` and the script's path.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke

PROFILED_CALLS = 5


def device_ms(fn) -> dict:
    """{kernel or copy name: device ms a call} over PROFILED_CALLS calls."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / PROFILED_CALLS
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="cases of chip_smoke._kernel_cases")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cases = chip_smoke._kernel_cases(dtype, gen)
    known = [c[0] for c in cases]
    unknown = sorted(set(args.names) - set(known))
    if unknown:
        ap.error(f"unknown cases {unknown}; known: {known}")
    for name, source, _, kern, plain, _, flops, nbytes in cases:
        if args.names and name not in args.names:
            continue
        ms, plain_ms = chip_smoke.cuda_ms(kern), chip_smoke.cuda_ms(plain)
        print(json.dumps({"name": name, "dtype": args.dtype, "source": source, "ms": ms,
                          "plain_ms": plain_ms, "bytes": nbytes, "operations": flops,
                          "gb_per_s": nbytes / ms / 1e6,
                          "device_ms": device_ms(kern)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
