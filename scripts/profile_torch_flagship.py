"""Where the time of one flagship batch goes in the PyTorch port, on a card.

    python3 -m scripts.profile_torch_flagship             # every configuration
    python3 -m scripts.profile_torch_flagship flash ...   # the ones named
    python3 -m scripts.profile_torch_flagship --copy-stacks fusedqkv

Builds the flagship model of `chip_smoke.py` (ViT-B/14-reg at 518 px, the
591,753-row bank, 30-step DeCap decode, seeded random bf16 weights), once
for each attention configuration of its encoder (`fusedqkv` and the ones
of `chip_smoke.CONFIGS`), then `int8_bank` (the flagship with
`memory_bank_int8: true`), `giant` (`chip_smoke.GIANT_CONFIG`, ViT-g/14
at full width with the 1536-wide bank) and `giant_fusedqkv_proj` (giant
with `attn_impl: fusedqkv_proj`), and captions one batch of 8 trace
requests; then `bbox`, `region_set` and `cls`: the flagship's batch of 8
box requests (16 boxes an image, 128 rows after the encoder), region-set
requests and whole-image requests, as `chip_smoke.py` phase 4e sends them:

- the stage split (encoder, pooling + memory projection, decode) with
  CUDA events, over 5 batches; the decode is the model's `GreedyDecoder`,
  a replayed CUDA graph, as served; the eager loop (`decap.greedy_decode`)
  is timed beside it on one batch's prefix;
- one batch under `torch.profiler`: device time per kernel, the sum of the
  device time of all kernels and copies, and the card's idle share of the
  batch's wall time (1 - device time / wall time);
- the peak of allocated device memory;
- with `--copy-stacks`, one more batch with the eager decode under
  `torch.profiler`: the device time of `aten::copy_` by stage, and by
  calling operator, input shapes and the port's Python frames (where the
  profiler records them), largest first.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke
from patchioner_tpu_torch import entry
from patchioner_tpu_torch.models import decap, vit
from patchioner_tpu_torch.models.patchioner import Patchioner


STAGES = ("encoder", "pooling + projection", "decode")


def stage_ms(model, imgs, pool, args, decode=None) -> tuple[list, torch.Tensor]:
    """CUDA-event ms of the encoder, pooling + projection and the decode
    (`decode`, the model's graph decoder by default) of one batch, and its
    prefix."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    state, cfg = model.state(), model.vit_cfg
    with torch.no_grad():
        ev[0].record()
        with record_function(STAGES[0]):
            outs = vit.vit_forward(state["vit"], model.pixels_to_device(imgs), cfg)
        ev[1].record()
        with record_function(STAGES[1]):
            feats = pool(outs, lambda: vit.process_self_attention(
                outs["qkv_last"], num_heads=cfg.extract_heads,
                num_global_tokens=cfg.num_global_tokens, scale=cfg.extract_scale)[0],
                *args)
            prefix = entry.project(state, feats, model.bank.num_real,
                                   normalize=model.normalize)
        ev[2].record()
        with record_function(STAGES[2]):
            (decode or model.decode)(prefix)
        ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)], prefix


def eager_decode(model):
    return lambda prefix: decap.greedy_decode(model.decoder, prefix, model.gpt2_cfg)


def copy_stacks(model, imgs, pool, args) -> None:
    """The device time of `aten::copy_` in one batch with the eager decode,
    by stage, by the port's Python frames that called it (innermost
    first) where the profiler records them, by the operator that called
    it and by its input shapes."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True, record_shapes=True) as prof:
        stage_ms(model, imgs, pool, args, eager_decode(model))
    by_caller = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.name != "aten::copy_":
            continue
        # the Python frames are the op's own stack in some torch versions,
        # and function events above it in the tree in others
        names, parent = list(e.stack), e.cpu_parent
        while parent is not None:
            names.append(parent.name)
            parent = parent.cpu_parent
        stage = next((n for n in names if n in STAGES), "outside the stages")
        frames = [n.split("patchioner_tpu_torch/")[-1] for n in names
                  if "patchioner_tpu_torch" in n][:3]
        op = e.cpu_parent.name if e.cpu_parent is not None else "-"
        key = (stage, " <- ".join(frames), op, str(e.input_shapes[:2]))
        by_caller[key][0] += e.device_time_total / 1e3
        by_caller[key][1] += 1
    print(f"aten::copy_: {sum(ms for ms, _ in by_caller.values()):.3f} ms of device "
          f"time in {sum(n for _, n in by_caller.values())} calls (eager decode)")
    for stage in STAGES + ("outside the stages",):
        rows = {k: v for k, v in by_caller.items() if k[0] == stage}
        print(f"  {stage}: {sum(ms for ms, _ in rows.values()):.3f} ms, "
              f"{sum(n for _, n in rows.values())} calls")
    for (stage, frames, op, shapes), (ms, n) in sorted(
            by_caller.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"  {ms:.3f} ms, {n} calls: {stage}; called by {op}; shapes {shapes}; "
              f"{frames or 'no frames recorded'}")


def batch(model, kind: str):
    """The batch of 8 of a request kind: (images, its pool, the pool's
    arrays on the card, the model's caption call)."""
    imgs, traces = chip_smoke._requests(chip_smoke.B, 0)
    if kind == "trace":
        pts, valid = chip_smoke._padded(traces)
        return (imgs, entry.make_trace_pool(model.vit_cfg, use_attention=False),
                (torch.from_numpy(pts).cuda(), torch.from_numpy(valid).cuda()),
                lambda: model.caption_traces_fused(imgs, pts, valid))
    if kind == "cls":
        return imgs, entry.make_image_pool("cls"), (), lambda: model.caption_images_fused(imgs)
    sets = chip_smoke._query_boxes(chip_smoke.B, 4)
    if kind == "bbox":
        boxes = chip_smoke._pixel_boxes(sets, [0, 0, 1, 1])
        return (imgs, entry.make_bbox_pool(model.patch_size),
                (torch.from_numpy(boxes).cuda(),),
                lambda: model.caption_bboxes_fused(imgs, boxes))
    boxes = chip_smoke._pixel_boxes(sets, [-1] * 4)
    return (imgs, entry.make_region_set_pool(model.patch_size),
            (torch.from_numpy(boxes).cuda(),),
            lambda: model.caption_region_sets_fused(imgs, boxes))


def profile_config(label: str, config: dict, kind: str, smi: str,
                   stacks: bool = False) -> None:
    model = Patchioner.from_config(config, allow_missing_weights=True,
                                   dtype=torch.bfloat16, device="cuda")
    imgs, pool, args, caption = batch(model, kind)
    caption()  # first-call set-up, and the decode graph's capture
    stages = [stage_ms(model, imgs, pool, args)[0] for _ in range(5)]
    prefix = stage_ms(model, imgs, pool, args)[1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    eager_decode(model)(prefix)
    ev[1].record()
    torch.cuda.synchronize()
    eager_ms = ev[0].elapsed_time(ev[1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        caption()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    print(f"== {label} {config} {kind} requests")
    print(events.table(sort_by="self_cuda_time_total", row_limit=12))
    # only the device's own events: an operator's row repeats the time of
    # the kernels it launched
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    if stacks:
        copy_stacks(model, imgs, pool, args)
    print(json.dumps({"config": label,
                      "stage_ms (encoder, pooling + projection, decode), 5 batches": stages,
                      "eager_decode_ms": eager_ms, "decode_graphs": model.decode.captures,
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
    kinds = {label: "trace" for label in configs}
    for kind in ("bbox", "region_set", "cls"):
        configs[kind], kinds[kind] = flagship, kind
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("configs", nargs="*",
                    help=f"any of {', '.join(configs)}; every one when none is named")
    ap.add_argument("--copy-stacks", action="store_true",
                    help="also profile a batch with the eager decode, and print "
                         "where its device copies are called from")
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
        profile_config(label, configs[label], kinds[label], smi, args.copy_stacks)


if __name__ == "__main__":
    main()
