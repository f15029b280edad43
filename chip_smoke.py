#!/usr/bin/env python3
"""Smoke run of the PyTorch port (patchioner_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each reporting on its own lines; any failure raises, and the script
then exits non-zero without the final result line:

1. device: a CUDA card is required (no CPU fallback); prints its name and
   power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from `patchioner_tpu_torch/csrc`, one
   nvcc process per source, all started together; prints ptxas' registers,
   spills and wgmma remarks per kernel, and the HGMMA and IGMMA
   instructions that cuobjdump finds in each kernel. Every wgmma
   instantiation must have them, each found by its own mangled name
   (`WGMMA_KERNELS`): the online attention of B, F and K, J's exact-max
   attention, A's qkv GEMM, E's dense + residual GEMM, F's out-projection
   GEMM, and the fc1 and fc2 GEMMs of C and of G; I's integer GEMMs, fc1 and
   fc2 in both activation types, must have the integer warpgroup MMA
   (`INT_WGMMA_KERNELS`); and the projection's tensor-core kernels, D's
   over a bf16 bank and H's over an int8 one, must have mma.sync (HMMA) in
   both instantiations of each (`MMA_KERNELS`);
3. kernels: each kernel (A-K, and C with the tanh GELU) against its plain
   PyTorch version on the card, in float32 (TF32 off) and bfloat16, at the
   shapes its path gives it: the flagship's (B = 8, N = 1374, D = 768, 12
   heads of 64, the full 591,753-row bank, in int8 for H), ViT-g's for G
   (D = 1536, SwiGLU hidden 4096), and for A, E, F, D and H a second time
   at ViT-g's shapes (D = 1536, 24 heads, the 1536-wide bank), and the
   flagship MLP's for I (int8 weights), with CUDA-event timings,
   the least time the card could take for the same work, and torch's
   `scaled_dot_product_attention` on the same q, k, v as the attention
   kernels' library yardstick; the projections (D and H, each also at
   giant's width) also print the rate they read their bank at and its
   share of 3.35 TB/s. D and H also run at 128 batch rows (a served box
   batch: 8 images x 16 boxes) against the full flagship bank, printed
   with their bank rate, not rows of the JSON summary.
   No model path reaches I: its launches are this phase's;
4. main path: ViT-B/14-reg at 518 px, the 591,753-row bank and the 30-step
   DeCap decode behind the port's `CaptionServer`, seeded random weights in
   bfloat16; the kernels' launch counters prove the path ran through them,
   and the decoder's counters that every served batch replayed a CUDA
   graph of the decode, none captured after the server's `warmup()` (in
   every served phase below as well);
4b. the same for each further attention configuration of the encoder
   (`proj_fused`, `fusedqkv_proj`, `flash`, `flash1p`, `flash_builtin`):
   one batch of 8 served, the launch counters of its kernels asserted;
   for `flash_builtin` a batch through a new server, and one through a
   new server after `CaptionServer.warmup()`, their latencies printed
   beside the first server's;
4c. giant: ViT-g/14-reg at full width (40 layers, D = 1536, 24 heads,
   SwiGLU FFN) with the 591,753 x 1536 bank, one batch of 8 served: A, B
   and G 40 launches a batch, D one; then the same with
   `attn_impl: fusedqkv_proj`: A, F and G 40 launches a batch, D one;
4d. int8 bank: the flagship with `memory_bank_int8: true`, one batch of 8
   served: H one launch a batch, D none;
4e. the other spatial queries on phase 4's model: 8 whole-image
   requests, 8 box requests of 1-16 boxes (padded to 16: 128 rows through
   the projection and the decode) and 8 region-set requests, each kind one
   batch through the `CaptionServer`, A, B and C 12 launches and D one
   asserted for each; the box batch's prefix and decode (graph and eager)
   timed apart;
4f. decode graph vs eager: the flagship's decoder weights in bfloat16 and
   in float32, at 8 and 128 rows, as a replayed CUDA graph and as the
   eager loop on the same prefixes: tokens equal, scores within
   `SCORE_TOLERANCE`, and a clean batch after one with NaN rows still
   equal; each decode's time, launches a step and the graphs' memory;
5. f32 cross-check: the projected prefix on the card (kernels) against the
   CPU (plain versions) within 1e-4 * max(1, max|ref|), with layerscale
   drawn near 1 so that the kernels move the residual stream, for the
   flagship, the int8-bank flagship, and giant cut to 4 layers (full width)
   under `fusedqkv` and under `fusedqkv_proj`; for the flagship also the
   box path with the attention map, the region-set path with Gaussian
   weights and the whole-image `avg_self_attn` path;
5b. the same gate between each further attention configuration's prefix
   and the `fusedqkv` one's, both on the card: the flagship's, and giant's
   `fusedqkv_proj`.

Nothing of JAX or of the JAX package `patchioner_tpu` is imported.

The second-to-last line is the kernels' JSON summary, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# configs/mlp.k.yaml (the flagship config) as a dict: the card's machine
# has no PyYAML. tests/test_torch_slice.py holds it against the file.
FLAGSHIP_CONFIG = {
    "decap_weights": "weights/decap/talkingdino-ksplits/coco_karpathy-009.pt",
    "prefix_size": 768,
    "linear_talk2dino": False,
    "support_memory_size": 591753,
    "dino_model": "dinov2_vitb14_reg",
    "normalize": True,
    "attention_type": "qkv",
    "projection_type": "coco",
}
# ViT-g/14 with registers: the bank and prefix live in encoder space
GIANT_CONFIG = dict(FLAGSHIP_CONFIG, dino_model="dinov2_vitg14_reg", prefix_size=1536)

# Max |kernel - plain| over max |plain|. float32: the two differ only in the
# order of f32 sums (relative error ~1e-6 over <= 3072 terms), so 1e-4
# leaves a wide margin. bfloat16: a different f32 summation order can move
# a value across one bf16 rounding boundary (2^-8 = 3.9e-3 relative), and a
# result passes through up to three such roundings. The memory projection
# reads the same bank rows on both sides and computes in f32 whatever the
# bank's type, so it is held to the f32 bound in both (H dequantizes the
# same int8 rows on both sides). I quantizes its activations per row: an f32
# difference of one ulp in LN(x) or GELU can move a value across a rounding
# boundary of round(a / s), which moves an output by about amax / 127 * |w|,
# so it takes 1e-3 in float32.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PROJECTIONS = {"memory_project", "memory_project_int8", "memory_project_giant",
               "memory_project_int8_giant", "memory_project_128", "memory_project_int8_128"}
W8_F32_TOLERANCE = 1e-3
# The decode graph replays the very launches of the eager loop, so its
# scores should equal the loop's; any difference is a bug, and these
# bounds (relative) only leave room for what a different cuBLAS choice
# between the two could move.
SCORE_TOLERANCE = {torch.float32: 1e-6, torch.bfloat16: 1e-3}

B, IMG, N, D, HEADS = 8, 518, 1374, 768, 12
HD = D // HEADS
GD, GH, GHEADS = 1536, 4096, 24  # ViT-g's width, SwiGLU hidden and heads
MAX_BOXES = 16  # the server's boxes a request: a box batch is B * 16 rows

# The least time the card could take: the larger of the operations over the
# peak rate for their type (dense tensor cores in bf16 and int8, the SIMT
# pipes in f32; the projections' tensor-core bodies, D over a bf16 bank and
# H, at the bf16 rate) and the bytes over the memory rate, each input read
# once and each output written once. NVIDIA H100 SXM.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
PEAK_BYTES_PER_S = 3.35e12

# each further attention configuration of the encoder (phase 4b, 5b)
CONFIGS = {
    "proj_fused": {"attn_impl": "fusedqkv", "proj_fused": True},
    "fusedqkv_proj": {"attn_impl": "fusedqkv_proj"},
    "flash": {"attn_impl": "flash"},
    "flash1p": {"attn_impl": "flash1p"},
    "flash_builtin": {"attn_impl": "flash_builtin"},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "the port's smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, {torch.cuda.device_count()} card(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return name, smi


# Every wgmma kernel instantiation, by the parts of its mangled name: the
# kernel's name and its template argument (a bool, or an epilogue type),
# each with the length prefix it has there. Each must have HGMMA in SASS.
WGMMA_KERNELS = {
    "B, F and K, online softmax": ("attention_sm90_kernel", False),
    "J, exact-max softmax": ("attention_sm90_kernel", True),
    "A qkv": ("gemm_bf16_kernel", "QkvEpilogue"),
    "E dense + residual": ("gemm_bf16_kernel", "DenseResidualEpilogue"),
    "F out-projection": ("gemm_bf16_kernel", "AttnProjEpilogue"),
    "C fc1": ("gemm_bf16_kernel", "Fc1Epilogue"),
    "C fc2": ("gemm_bf16_kernel", "Fc2Epilogue"),
    "G fc1": ("gemm_bf16_kernel", "SwigluFc1Epilogue"),
    "G fc2": ("gemm_bf16_kernel", "SwigluFc2Epilogue"),
}
# Every mma.sync kernel instantiation, the same way; each must have HMMA.
MMA_KERNELS = {
    "D bf16, D <= 768": ("mem_proj_bf16_kernel", 6),
    "D bf16, D <= 1536": ("mem_proj_bf16_kernel", 12),
    "H int8, D <= 768": ("mem_proj_int8_kernel", 6),
    "H int8, D <= 1536": ("mem_proj_int8_kernel", 12),
}
# I's integer GEMMs (wgmma .s8); each instantiation (fc2's in both
# activation types) must have the integer warpgroup MMA, IGMMA.
INT_WGMMA_KERNELS = {
    "I fc1": ("gemm_s8_kernel", "W8Fc1Epilogue"),
    "I fc2": ("gemm_s8_kernel", "W8Fc2Epilogue"),
}


def _is_instantiation(fn: str, kernel: str, arg) -> bool:
    """Whether the mangled name `fn` is kernel<arg>."""
    targ = (f"Lb{int(arg)}E" if isinstance(arg, bool) else
            f"Li{arg}E" if isinstance(arg, int) else f"{len(arg)}{arg}")
    return f"{len(kernel)}{kernel}I" in fn and targ in fn


def phase_build() -> None:
    from patchioner_tpu_torch import kernels
    from patchioner_tpu_torch.kernels import build

    kernels.lib()
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{kernels.build_seconds:.1f} s for {len(build.sources())} sources")
    for line in build.build_log().splitlines():
        if "wgmma" in line:
            log(f"[build] {line.strip()}")
    resources = build.kernel_resources()
    for fn, (regs, stores, loads) in sorted(resources.items()):
        log(f"[build] {fn}: {regs} registers, spills {stores} B stored, {loads} B loaded")
    counts = {op: build.sass_counts(op) for op in ("HGMMA", "HMMA", "IGMMA")}
    for op in ("HGMMA", "IGMMA"):
        for fn, n in sorted(counts[op].items()):
            log(f"[build] {n} {op} in {fn}")
    # each wgmma instantiation must be a Hopper warpgroup design (HGMMA in
    # SASS, IGMMA for I's integer ones), and each mma.sync one must run on
    # the tensor cores (HMMA); every compiled instantiation that matches a
    # row is checked
    for opcode, table in (("HGMMA", WGMMA_KERNELS), ("HMMA", MMA_KERNELS),
                          ("IGMMA", INT_WGMMA_KERNELS)):
        for label, (kernel, arg) in table.items():
            found = [fn for fn in resources if _is_instantiation(fn, kernel, arg)]
            missing = [fn for fn in found if not counts[opcode].get(fn)]
            if not found or missing:
                raise AssertionError(f"no {opcode} instruction in {label} "
                                     f"({kernel}<{arg}>): {missing or 'not compiled'}")
            for fn in found:
                regs, stores, loads = resources[fn]
                log(f"[build] {label}: {counts[opcode][fn]} {opcode}, {regs} registers, "
                    f"spills {stores} B stored, {loads} B loaded")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _kernel_cases(dtype, gen):
    """(name, source, replaces, kernel call, plain call, library call or
    None, operations, bytes) at the shapes each kernel's path gives it;
    inputs are seeded random tensors in `dtype` (the banks' features f32, H's
    rows and I's weights int8), and the work is counted from them."""
    from patchioner_tpu_torch.ops import attention, memory_projection as mp, mlp

    dev = "cuda"

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    x, r = randn(B, N, D), randn(B, N, D)
    g, bg = 1 + randn(D, scale=0.1), randn(D, scale=0.1)
    wqkv, bqkv = randn(D, 3 * D, scale=D ** -0.5), randn(3 * D, scale=0.1)
    wproj, bproj = randn(D, D, scale=D ** -0.5), randn(D, scale=0.1)
    qkv = randn(B, N, 3 * D)
    q, k, v = attention.split_heads(qkv, HEADS)
    w1, b1 = randn(D, 4 * D, scale=D ** -0.5), randn(4 * D, scale=0.1)
    w2, b2 = randn(4 * D, D, scale=(4 * D) ** -0.5), randn(D, scale=0.1)
    # per channel, so a kernel that reads ls at the wrong index disagrees
    ls = 1 + randn(D, scale=0.1)
    bank = mp.prepare_bank(
        torch.randn(FLAGSHIP_CONFIG["support_memory_size"], D, generator=gen,
                    device=dev),
        dtype=dtype)
    feats = torch.randn(B, D, generator=gen, device=dev)
    eps, scale = 1e-6, HD ** -0.5
    rows, nb = B * N, bank.num_real
    # H: the flagship bank in int8; D over giant's 1536-wide bank
    qbank = mp.quantize_bank(torch.randn(nb, D, generator=gen, device=dev))
    gbank = mp.prepare_bank(torch.randn(nb, GD, generator=gen, device=dev), dtype=dtype)
    gfeats = torch.randn(B, GD, generator=gen, device=dev)
    # G, A and F at giant's shapes
    xg = randn(B, N, GD)
    gg, bgg, lsg = 1 + randn(GD, scale=0.1), randn(GD, scale=0.1), 1 + randn(GD, scale=0.1)
    swiglu_args = (xg, gg, bgg, randn(GD, 2 * GH, scale=GD ** -0.5),
                   randn(2 * GH, scale=0.1), randn(GH, GD, scale=GH ** -0.5),
                   randn(GD, scale=0.1), lsg)
    ln_dense_g = (xg, gg, bgg, randn(GD, 3 * GD, scale=GD ** -0.5), randn(3 * GD, scale=0.1))
    qkvg = randn(B, N, 3 * GD)
    qkv_proj_g = (qkvg, xg, randn(GD, GD, scale=GD ** -0.5), randn(GD, scale=0.1), lsg)
    dense_res_g = (xg, randn(B, N, GD), *qkv_proj_g[2:])
    # I: the flagship MLP's weights quantized per column
    w8_args = (x, g, bg, *mlp.quantize_mlp_weights(w1.float(), b1.float(), w2.float(),
                                                   b2.float()), ls)
    # H over giant's 1536-wide bank in int8
    qgbank = mp.quantize_bank(torch.randn(nb, GD, generator=gen, device=dev))
    # D and H at a served box batch's rows
    bfeats = torch.randn(B * MAX_BOXES, D, generator=gen, device=dev)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)

    attn_flops = 4 * B * HEADS * N * N * HD  # QK^T and PV
    gattn_flops = 4 * B * GHEADS * N * N * HD
    mlp_args = (x, g, bg, w1, b1, w2, b2, ls)
    qkv_proj_args = (qkv, x, wproj, bproj, ls)
    return [
        ("ln_dense", "patchioner_tpu_torch/csrc/ln_dense.cu",
         "patchioner_tpu/ops/mlp.py:188",
         lambda: mlp.fused_ln_dense(x, g, bg, wqkv, bqkv, eps=eps),
         lambda: mlp.ln_dense_plain(x, g, bg, wqkv, bqkv, eps=eps), None,
         2 * rows * D * 3 * D, _nbytes(x, g, bg, wqkv, bqkv, qkv)),
        ("qkv_attention", "patchioner_tpu_torch/csrc/qkv_attention.cu",
         "patchioner_tpu/ops/attention.py:220",
         lambda: attention.fused_qkv_attention(qkv, num_heads=HEADS, scale=scale),
         lambda: attention.qkv_attention_plain(qkv, num_heads=HEADS, scale=scale),
         sdpa, attn_flops, _nbytes(qkv, x)),
        ("ln_mlp", "patchioner_tpu_torch/csrc/ln_mlp.cu",
         "patchioner_tpu/ops/mlp.py:114",
         lambda: mlp.fused_ln_mlp(*mlp_args, eps=eps),
         lambda: mlp.ln_mlp_plain(*mlp_args, eps=eps), None,
         4 * rows * D * 4 * D, _nbytes(*mlp_args, x)),
        ("ln_mlp_gelu_approx", "patchioner_tpu_torch/csrc/ln_mlp.cu",
         "patchioner_tpu/ops/mlp.py:114",
         lambda: mlp.fused_ln_mlp(*mlp_args, eps=eps, gelu_approx=True),
         lambda: mlp.ln_mlp_plain(*mlp_args, eps=eps, gelu_approx=True), None,
         4 * rows * D * 4 * D, _nbytes(*mlp_args, x)),
        ("memory_project", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:521",
         lambda: mp.memory_project_streamed(feats, bank, normalize=True),
         lambda: mp.memory_project_plain(feats, bank, normalize=True), None,
         4 * B * nb * D, _nbytes(feats, bank.rows[:nb], bank.inv_norm[:nb], feats)),
        ("dense_residual", "patchioner_tpu_torch/csrc/ln_dense.cu",
         "patchioner_tpu/ops/mlp.py:261",
         lambda: mlp.fused_dense_residual(x, r, wproj, bproj, ls),
         lambda: mlp.dense_residual_plain(x, r, wproj, bproj, ls), None,
         2 * rows * D * D, _nbytes(x, r, wproj, bproj, ls, r)),
        ("qkv_attention_proj", "patchioner_tpu_torch/csrc/qkv_attention_proj.cu",
         "patchioner_tpu/ops/attention.py:342",
         lambda: attention.fused_qkv_attention_proj(*qkv_proj_args, num_heads=HEADS,
                                                    scale=scale),
         lambda: attention.qkv_attention_proj_plain(*qkv_proj_args, num_heads=HEADS,
                                                    scale=scale), None,
         attn_flops + 2 * rows * D * D, _nbytes(*qkv_proj_args, x)),
        ("flash_attention_1pass", "patchioner_tpu_torch/csrc/flash_attention_1pass.cu",
         "patchioner_tpu/ops/attention.py:139",
         lambda: attention.flash_attention_1pass(q, k, v, scale=scale),
         lambda: attention.attention_plain(q, k, v, scale=scale), sdpa,
         attn_flops, _nbytes(q, k, v, q)),
        ("flash_attention", "patchioner_tpu_torch/csrc/flash_attention.cu",
         "patchioner_tpu/ops/attention.py:437",
         lambda: attention.flash_attention(q, k, v, scale=scale),
         lambda: attention.attention_plain(q, k, v, scale=scale), sdpa,
         attn_flops, _nbytes(q, k, v, q)),
        ("ln_swiglu", "patchioner_tpu_torch/csrc/ln_swiglu.cu",
         "patchioner_tpu/ops/mlp.py:515",
         lambda: mlp.fused_ln_swiglu(*swiglu_args, eps=eps),
         lambda: mlp.ln_swiglu_plain(*swiglu_args, eps=eps), None,
         6 * rows * GD * GH, _nbytes(*swiglu_args, xg)),
        ("memory_project_int8", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:380",
         lambda: mp.memory_project_int8(feats, qbank, normalize=True),
         lambda: mp.memory_project_int8_plain(feats, qbank, normalize=True), None,
         4 * B * nb * D, _nbytes(feats, *qbank[:-1], feats)),
        ("ln_mlp_w8", "patchioner_tpu_torch/csrc/ln_mlp_w8.cu",
         "patchioner_tpu/ops/mlp.py:381",
         lambda: mlp.fused_ln_mlp_w8(*w8_args, eps=eps),
         lambda: mlp.ln_mlp_w8_plain(*w8_args, eps=eps), None,
         4 * rows * D * 4 * D, _nbytes(*w8_args, x)),
        ("memory_project_giant", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:521",
         lambda: mp.memory_project_streamed(gfeats, gbank, normalize=True),
         lambda: mp.memory_project_plain(gfeats, gbank, normalize=True), None,
         4 * B * nb * GD, _nbytes(gfeats, gbank.rows, gbank.inv_norm, gfeats)),
        ("ln_dense_giant", "patchioner_tpu_torch/csrc/ln_dense.cu",
         "patchioner_tpu/ops/mlp.py:188",
         lambda: mlp.fused_ln_dense(*ln_dense_g, eps=eps),
         lambda: mlp.ln_dense_plain(*ln_dense_g, eps=eps), None,
         2 * rows * GD * 3 * GD, _nbytes(*ln_dense_g, qkvg)),
        ("qkv_attention_proj_giant", "patchioner_tpu_torch/csrc/qkv_attention_proj.cu",
         "patchioner_tpu/ops/attention.py:342",
         lambda: attention.fused_qkv_attention_proj(*qkv_proj_g, num_heads=GHEADS,
                                                    scale=scale),
         lambda: attention.qkv_attention_proj_plain(*qkv_proj_g, num_heads=GHEADS,
                                                    scale=scale), None,
         gattn_flops + 2 * rows * GD * GD, _nbytes(*qkv_proj_g, xg)),
        ("dense_residual_giant", "patchioner_tpu_torch/csrc/ln_dense.cu",
         "patchioner_tpu/ops/mlp.py:261",
         lambda: mlp.fused_dense_residual(*dense_res_g),
         lambda: mlp.dense_residual_plain(*dense_res_g), None,
         2 * rows * GD * GD, _nbytes(*dense_res_g, xg)),
        ("memory_project_int8_giant", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:380",
         lambda: mp.memory_project_int8(gfeats, qgbank, normalize=True),
         lambda: mp.memory_project_int8_plain(gfeats, qgbank, normalize=True), None,
         4 * B * nb * GD, _nbytes(gfeats, *qgbank[:-1], gfeats)),
        ("memory_project_128", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:521",
         lambda: mp.memory_project_streamed(bfeats, bank, normalize=True),
         lambda: mp.memory_project_plain(bfeats, bank, normalize=True), None,
         4 * B * MAX_BOXES * nb * D,
         _nbytes(bfeats, bank.rows[:nb], bank.inv_norm[:nb], bfeats)),
        ("memory_project_int8_128", "patchioner_tpu_torch/csrc/memory_projection.cu",
         "patchioner_tpu/ops/memory_projection.py:380",
         lambda: mp.memory_project_int8(bfeats, qbank, normalize=True),
         lambda: mp.memory_project_int8_plain(bfeats, qbank, normalize=True), None,
         4 * B * MAX_BOXES * nb * D, _nbytes(bfeats, *qbank[:-1], bfeats)),
    ]


def phase_kernels(seed: int) -> dict:
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        sdpa_ms = None
        for (name, source, replaces, kern, plain, library, flops,
             nbytes) in _kernel_cases(dtype, gen):
            tol = TOLERANCE[torch.float32 if name in PROJECTIONS else dtype]
            if name == "ln_mlp_w8" and dtype == torch.float32:
                tol = W8_F32_TOLERANCE
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {dtype}: shape {tuple(got.shape)} "
                                     f"vs {tuple(ref.shape)} or non-finite output")
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            peak_type = dtype
            if name == "ln_mlp_w8":
                peak_type = torch.int8
            elif name.startswith("memory_project_int8"):  # H: always tensor cores
                peak_type = torch.bfloat16
            peak = PEAK_FLOPS[peak_type]
            op_ms, byte_ms = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
            bound_ms = max(op_ms, byte_ms)
            library_ms = None
            if library is not None:
                if sdpa_ms is None:
                    sdpa_ms = cuda_ms(library)
                    log(f"[kernels] scaled_dot_product_attention {str(dtype)[6:]} "
                        f"({B}, {HEADS}, {N}, {HD}): {sdpa_ms:.4f} ms")
                library_ms = sdpa_ms
            log(f"[kernels] {name} {str(dtype)[6:]}: max|d|={err:.3e} "
                f"rel={rel:.3e} (tol {tol:.0e}) kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({flops / 1e9:.1f} G operations, {nbytes / 1e6:.1f} MB)")
            if name in PROJECTIONS:
                rate = nbytes / (ms * 1e-3)
                log(f"[kernels] {name} {str(dtype)[6:]}: {rate / 1e9:.1f} GB/s, "
                    f"{rate / PEAK_BYTES_PER_S:.3f} of {PEAK_BYTES_PER_S / 1e12:.2f} TB/s")
            if not rel <= tol:
                raise AssertionError(f"{name} {dtype}: rel error {rel:.3e} > {tol:.0e}")
            if dtype == torch.bfloat16 and name in _wrappers():  # the main path's type
                summary[name] = {
                    "name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": None, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                    "library_ms": library_ms}
            del got, ref
        torch.cuda.empty_cache()
    return summary


def _wrappers() -> dict:
    """Every kernel wrapper, in the order of the kernel table (A-K)."""
    from patchioner_tpu_torch.ops import attention, memory_projection as mp, mlp

    return {"ln_dense": mlp.fused_ln_dense,
            "qkv_attention": attention.fused_qkv_attention,
            "ln_mlp": mlp.fused_ln_mlp,
            "memory_project": mp.memory_project_streamed,
            "dense_residual": mlp.fused_dense_residual,
            "qkv_attention_proj": attention.fused_qkv_attention_proj,
            "ln_swiglu": mlp.fused_ln_swiglu,
            "memory_project_int8": mp.memory_project_int8,
            "ln_mlp_w8": mlp.fused_ln_mlp_w8,
            "flash_attention_1pass": attention.flash_attention_1pass,
            "flash_attention": attention.flash_attention}


def expected_launches(config: dict, depth: int, batches: int) -> dict:
    """Launches of every kernel for `batches` batches of a configuration:
    A each layer, C (G for ViT-g's SwiGLU FFN) each layer, the attention
    kernel `attn_impl` selects each layer, D (H over an int8 bank) once a
    batch, every other kernel never."""
    impl = config.get("attn_impl", "xla")
    layer = {"ln_dense", "ln_swiglu" if "vitg" in config["dino_model"] else "ln_mlp"}
    if impl in ("xla", "fusedqkv"):
        layer.add("qkv_attention")
        if config.get("proj_fused"):
            layer.add("dense_residual")
    layer |= {"fusedqkv_proj": {"qkv_attention_proj"}, "flash": {"flash_attention"},
              "flash1p": {"flash_attention_1pass"}}.get(impl, set())
    counts = {name: depth * batches if name in layer else 0 for name in _wrappers()}
    counts["memory_project_int8" if config.get("memory_bank_int8")
           else "memory_project"] = batches
    return counts


def _requests(n: int, seed: int):
    """n seeded uint8 images and traces of 2..64 points in [0, 1]."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    traces = [rng.uniform(0, 1, (int(rng.integers(2, 65)), 2)).tolist()
              for _ in range(n)]
    return imgs, traces


def _padded(traces):
    """Traces as the (n, 64, 2) points and (n, 64) valid mask the model takes."""
    pts = np.zeros((len(traces), 64, 2), np.float32)
    valid = np.zeros((len(traces), 64), np.float32)
    for i, tr in enumerate(traces):
        pts[i, : len(tr)] = tr
        valid[i, : len(tr)] = 1.0
    return pts, valid


def build_model(config: dict, seed: int, tag: str):
    """The port's model of `config` in bf16 on the card, seeded random
    weights and bank."""
    from patchioner_tpu_torch.models.patchioner import Patchioner

    t0 = time.perf_counter()
    model = Patchioner.from_config(config, rng_seed=seed, allow_missing_weights=True,
                                   dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"{tag} {config['dino_model']}: model built in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{model.vit_cfg.depth} layers x D={model.vit_cfg.embed_dim} "
        f"({model.vit_cfg.ffn} FFN {model.vit_cfg.ffn_hidden}) at "
        f"{model.crop_dim} px ({model.vit_cfg.num_tokens} tokens), bank "
        f"{model.bank.num_real} x {model.bank.rows.shape[1]} "
        f"{str(model.bank.rows.dtype)[6:]}, decoder "
        f"{model.gpt2_cfg.n_layer}L/{model.gpt2_cfg.n_head}H/"
        f"{model.gpt2_cfg.n_embd}, vocab {model.gpt2_cfg.vocab_size}")
    return model


def _check_graphs(decoder, before: tuple, batches: int, tag: str) -> None:
    """The decoder replayed its CUDA graph at least once a served batch and
    captured none: `before` is its (captures, replays) before serving."""
    captured, replayed = decoder.captures - before[0], decoder.replays - before[1]
    log(f"{tag} decode graphs: {replayed} replays and {captured} captures for "
        f"{batches} served batches ({decoder.captures} graphs in all)")
    if captured or replayed < batches:
        raise AssertionError(f"{tag} the served batches did not all replay a captured "
                             f"decode graph: {captured} captures, {replayed} replays")


def _serve(model, requests: list, tag: str,
           kind: str = "trace") -> tuple[list, dict, int, float, dict]:
    """Serve (image, submit keywords) requests of one kind through a new
    server: its `warmup()` of every bucket first, then every launch counter
    zeroed; assert the counts, and that each batch replayed a decode graph
    that warm-up had captured; (results, the server's snapshot, batches,
    wall s, launch counts)."""
    from patchioner_tpu_torch.serve import CaptionServer

    wrappers = _wrappers()
    with CaptionServer(model, max_batch=B, max_delay_ms=200.0,
                       max_boxes=MAX_BOXES) as server:
        server.warmup(trace=kind == "trace", cls=kind == "cls", bbox=kind == "bbox",
                      region_set=kind == "region_set", pixel_dtype=np.uint8)
        for fn in wrappers.values():
            fn.launches = 0
        graphs = model.decode.captures, model.decode.replays
        t0 = time.perf_counter()
        futures = [server.submit(im, **kw) for im, kw in requests]
        results = [f.result(timeout=900) for f in futures]
        wall = time.perf_counter() - t0
        snap = server.snapshot()
        batches = server.stats.batches
    counts = {name: fn.launches for name, fn in wrappers.items()}
    expected = expected_launches(model.config, model.vit_cfg.depth, batches)
    log(f"{tag} {len(results)} requests answered in {batches} batches; "
        f"launches {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != {expected}")
    _check_graphs(model.decode, graphs, batches, tag)
    return results, snap, batches, wall, counts


def _host_ms(fn) -> float:
    """Median of 3 host-clock times of fn(), the card synchronised before
    and after each."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    return statistics.median(times) * 1e3


def phase_main_path(seed: int, smi: str, label: str = "main", opts=None,
                    n_requests: int = 2 * B, base: dict = FLAGSHIP_CONFIG,
                    model=None, warm: bool = False) -> tuple[dict, list]:
    """Serve `n_requests` trace requests through the `base` config (the
    flagship's by default) plus `opts`, on `model` if given (kept) or on
    one built here (dropped); returns the launch counts of the served run
    and the captions. With `warm`, two new servers serve one batch each,
    the second after its `warmup()`."""
    from patchioner_tpu_torch import entry

    tag = f"[{label}]"
    own = model is None
    if own:
        model = build_model(dict(base, **(opts or {})), seed, f"{tag} {opts or ''}")
    config = model.config

    imgs, traces = _requests(2 * B, seed)
    imgs, traces = imgs[:n_requests], traces[:n_requests]
    # one direct batch first, outside the counted run: first-call set-up
    pts, valid = _padded(traces[:B])
    model.caption_traces_fused(imgs[:B], pts, valid)

    captions, snap, _, wall, counts = _serve(
        model, [(im, {"trace": tr}) for im, tr in zip(imgs, traces)], tag)
    if not all(isinstance(c, str) for c in captions):
        raise AssertionError("a request did not resolve to a caption string")
    log(f"{tag} caption 0: {captions[0][:80]!r}")

    # the served path's projected prefixes: finite, (B, D), unit norm
    step = entry.make_prefix_step(model.vit_cfg, model.bank.num_real,
                                  use_attention=False, normalize=model.normalize)
    prefix = step(model.state(), model.pixels_to_device(imgs[:B]),
                  torch.from_numpy(pts).cuda(), torch.from_numpy(valid).cuda())
    norm_err = (prefix.norm(dim=-1) - 1).abs().max().item()
    log(f"{tag} prefix {tuple(prefix.shape)}, finite "
        f"{bool(torch.isfinite(prefix).all())}, max |norm - 1| {norm_err:.2e}")
    width = int(config["prefix_size"])
    if prefix.shape != (B, width) or not torch.isfinite(prefix).all() or norm_err > 1e-3:
        raise AssertionError("the main path's projected prefix is malformed")

    # steady-state batch time, outside the server
    batch_ms = _host_ms(lambda: model.caption_traces_fused(imgs[:B], pts, valid))
    log(f"{tag} {len(captions) / wall:.3f} captions/s through the server "
        f"({wall:.3f} s for {len(captions)}), mean request latency "
        f"{snap['mean_latency_ms']} ms, batch of {B}: {batch_ms:.1f} ms "
        f"(median of 3); {smi}")
    if warm:
        # two more new servers' first batches: one cold again, one after
        # warmup(), which runs its dummy batch on the server's worker thread
        from patchioner_tpu_torch.serve import CaptionServer

        for use_warmup in (False, True):
            with CaptionServer(model, max_batch=B, max_delay_ms=200.0) as server:
                t0 = time.perf_counter()
                if use_warmup:
                    server.warmup(buckets=[B], pixel_dtype=np.uint8)
                warm_s = time.perf_counter() - t0
                graphs = model.decode.captures, model.decode.replays
                futures = [server.submit(im, tr) for im, tr in zip(imgs[:B], traces[:B])]
                warm_caps = [f.result(timeout=900) for f in futures]
                warm_snap = server.snapshot()
            if use_warmup:
                _check_graphs(model.decode, graphs, warm_snap["batches"], tag)
            if not all(isinstance(c, str) for c in warm_caps):
                raise AssertionError("a request of a new server did not resolve to a caption")
            what = f"after warmup() ({warm_s:.3f} s)" if use_warmup else "without warmup()"
            log(f"{tag} a new server's first batch {what}: mean request latency "
                f"{warm_snap['mean_latency_ms']} ms in {warm_snap['batches']} batch(es), "
                f"against {snap['mean_latency_ms']} ms for the first server's; {smi}")
    if own:
        del model
        torch.cuda.empty_cache()
    return counts, captions


def _query_boxes(n: int, seed: int) -> list:
    """n sets of 1-16 normalised xyxy boxes (the first 16), seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = MAX_BOXES if i == 0 else int(rng.integers(1, MAX_BOXES + 1))
        lo = rng.uniform(0, 0.7, (k, 2))
        hi = np.minimum(lo + rng.uniform(0.05, 0.5, (k, 2)), 1.0)
        out.append(np.concatenate([lo, hi], -1).tolist())
    return out


def _pixel_boxes(sets: list, pad) -> np.ndarray:
    """Normalised xyxy box sets as the server hands them to the model:
    (n, 16, 4) pixel [x1, y1, w, h], padded with `pad`."""
    boxes = np.tile(np.asarray(pad, np.float32), (len(sets), MAX_BOXES, 1))
    for i, bs in enumerate(sets):
        b = np.asarray(bs, np.float32) * IMG
        boxes[i, : len(bs)] = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], -1)
    return boxes


def phase_other_queries(model, seed: int, smi: str) -> dict:
    """Phase 4e: whole-image, box and region-set requests, one batch of B
    each, through the server on `model`; returns each kind's launches."""
    from patchioner_tpu_torch import entry
    from patchioner_tpu_torch.models import decap

    imgs, _ = _requests(B, seed + 3)
    sets = _query_boxes(B, seed + 4)
    direct = {
        "cls": lambda: model.caption_images_fused(imgs),
        "bbox": lambda: model.caption_bboxes_fused(imgs, _pixel_boxes(sets, [0, 0, 1, 1])),
        "region_set": lambda: model.caption_region_sets_fused(
            imgs, _pixel_boxes(sets, [-1] * 4)),
    }
    requests = {
        "cls": [(im, {}) for im in imgs],
        "bbox": [(im, {"bboxes": bs}) for im, bs in zip(imgs, sets)],
        "region_set": [(im, {"bboxes": bs, "region_set": True})
                       for im, bs in zip(imgs, sets)],
    }
    rows = {"cls": B, "bbox": B * MAX_BOXES, "region_set": B}
    launches = {}
    for kind, call in direct.items():
        tag = f"[queries {kind}]"
        t0 = time.perf_counter()
        call()  # first call, outside the counted run
        first_ms = (time.perf_counter() - t0) * 1e3
        results, snap, batches, wall, launches[kind] = _serve(model, requests[kind], tag,
                                                              kind)
        for (_, kw), res in zip(requests[kind], results):
            want = len(kw["bboxes"]) if kind == "bbox" else None
            if (not isinstance(res, str) if want is None else
                    not (isinstance(res, list) and len(res) == want
                         and all(isinstance(c, str) for c in res))):
                raise AssertionError(f"{tag} a request resolved to {res!r}")
        log(f"{tag} result 0: {str(results[0])[:80]!r}")
        if kind == "bbox":
            n_boxes = sum(len(bs) for bs in sets)
            log(f"{tag} {n_boxes} boxes: {n_boxes / wall:.3f} box captions/s "
                "through the server")
        batch_ms = _host_ms(call)
        log(f"{tag} {len(results) / wall:.3f} requests/s through the server "
            f"({wall:.3f} s for {len(results)} in {batches} batch(es), {rows[kind]} rows "
            f"projected and decoded a batch), mean request latency "
            f"{snap['mean_latency_ms']} ms, first direct batch {first_ms:.1f} ms, "
            f"batch of {B}: {batch_ms:.1f} ms (median of 3); {smi}")

    # the box batch apart: its (128, D) prefix, finite and unit norm, and
    # the prefix step and the 128-row decode each timed
    step = entry.make_prefix_step(model.vit_cfg, model.bank.num_real,
                                  normalize=model.normalize,
                                  pool=entry.make_bbox_pool(model.patch_size))
    px = model.pixels_to_device(imgs)
    boxes = torch.from_numpy(_pixel_boxes(sets, [0, 0, 1, 1])).cuda()
    prefix = step(model.state(), px, boxes)
    norm_err = (prefix.norm(dim=-1) - 1).abs().max().item()
    if (prefix.shape != (B * MAX_BOXES, int(model.config["prefix_size"]))
            or not torch.isfinite(prefix).all() or norm_err > 1e-3):
        raise AssertionError(f"the box batch's prefix is malformed: {tuple(prefix.shape)}, "
                             f"max |norm - 1| {norm_err:.2e}")

    prefix_ms = _host_ms(lambda: step(model.state(), px, boxes))
    decode_ms = {(how, rows): _host_ms(lambda: fn(prefix[:rows]))
                 for how, fn in (("graph", model.decode), ("eager", lambda p: decap.greedy_decode(
                     model.decoder, p, model.gpt2_cfg)))
                 for rows in (B * MAX_BOXES, B)}
    log(f"[queries bbox] prefix {tuple(prefix.shape)}, max |norm - 1| {norm_err:.2e}; "
        f"encoder + pool + projection {prefix_ms:.1f} ms, decode of {B * MAX_BOXES} rows "
        f"{decode_ms['graph', B * MAX_BOXES]:.1f} ms as a graph "
        f"({decode_ms['eager', B * MAX_BOXES]:.1f} eager), of {B} rows "
        f"{decode_ms['graph', B]:.1f} ms ({decode_ms['eager', B]:.1f} eager) "
        f"(host clock, median of 3); {smi}")
    return launches


def _kernel_count(fn) -> tuple[int, float]:
    """(CUDA kernels launched, their device ms) in one call of fn(), by
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3)


def phase_decode_graph(model, seed: int, smi: str) -> None:
    """The decode as one CUDA graph against the eager loop (its plain
    version, `decap.greedy_decode`) on the same prefixes, on the flagship's
    decoder weights in bf16 and in f32, at B and at a box batch's B * 16
    rows: tokens equal, scores within SCORE_TOLERANCE relative; then a
    batch with NaN rows and after it a clean batch, whose tokens must still
    be the eager loop's. Each decoder here is new, so that the memory of
    its graphs shows. With the DeCap init's wte (std 0.02) the logits are
    near uniform and 30 steps' scores underflow to 0; wte is scaled by 10
    here so that the scores are compared as numbers."""
    from patchioner_tpu_torch.models import decap

    master = model.decoder
    sharp = master._replace(gpt2=dict(master.gpt2, wte=master.gpt2["wte"] * 10))
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    width = master.clip_project["w"].shape[0]

    def prefixes(rows):
        return torch.nn.functional.normalize(
            torch.randn(rows, width, generator=gen, device="cuda"), dim=-1)

    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(model.gpt2_cfg, dtype=dtype)
        tag = f"[decode graph {str(dtype)[6:]}]"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        decoder = decap.GreedyDecoder(sharp, cfg, model.entry_length)
        weights = torch.cuda.memory_reserved() - reserved
        for rows in (B, B * MAX_BOXES):
            clean, later = prefixes(rows), prefixes(rows)
            tokens, scores = decoder(clean)
            torch.cuda.empty_cache()
            want_tokens, want_scores = decap.greedy_decode(sharp, clean, cfg)
            nan = clean.clone()
            nan[::3] = float("nan")
            nan_tokens, _ = decoder(nan)
            later_tokens, _ = decoder(later)
            nan_same = torch.equal(nan_tokens, decap.greedy_decode(sharp, nan, cfg)[0])
            later_same = torch.equal(later_tokens, decap.greedy_decode(sharp, later, cfg)[0])
            score_err = ((scores - want_scores).abs()
                         / want_scores.abs().clamp_min(1e-30)).max().item()
            graph_ms = cuda_ms(lambda: decoder(clean))
            eager_ms = cuda_ms(lambda: decap.greedy_decode(sharp, clean, cfg))
            graph_kernels, graph_device_ms = _kernel_count(lambda: decoder(clean))
            eager_kernels, _ = _kernel_count(
                lambda: decap._decode(decoder.params, clean, cfg, decoder.n_steps))
            steps = decoder.n_steps
            log(f"{tag} {rows} rows: tokens equal {torch.equal(tokens, want_tokens)}, "
                f"scores > 0: {int((want_scores > 0).sum())}/{rows}, max rel score error "
                f"{score_err:.3e} (tol {SCORE_TOLERANCE[dtype]:.0e}); after a batch with "
                f"{int(nan.isnan().any(1).sum())} NaN rows (their tokens equal eager's: "
                f"{nan_same}) a clean batch's tokens equal eager's: {later_same}")
            log(f"{tag} {rows} rows: graph {graph_ms:.3f} ms, eager {eager_ms:.3f} ms "
                f"(CUDA events, median of 10); the graph's kernels {graph_device_ms:.3f} ms "
                f"of device time; {eager_kernels / steps:.1f} launches a step eager, "
                f"{graph_kernels / steps:.1f} kernels a step in the graph; "
                f"{decoder.captures} graphs, {decoder.replays} replays; {smi}")
            if not (torch.equal(tokens, want_tokens) and later_same
                    and score_err <= SCORE_TOLERANCE[dtype]):
                raise AssertionError(f"{tag} {rows} rows: the graph's decode differs "
                                     "from the eager loop's")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"{tag} {decoder.captures} graphs (rows {B} and {B * MAX_BOXES}) hold "
            f"{(torch.cuda.memory_reserved() - reserved - weights) / 2**20:.1f} MiB, "
            f"the cast weights {weights / 2**20:.1f} MiB")
        del decoder
    del sharp
    torch.cuda.empty_cache()


def phase_f32_crosscheck(seed: int, config: dict = FLAGSHIP_CONFIG, label: str = "f32",
                         configs: dict = None, queries: bool = False) -> None:
    """The f32 prefix of `config` on the card against the CPU; with
    `queries` also those of the box path (attention-map weights), the
    region-set path (Gaussian weights) and the whole image
    (`avg_self_attn`); then, for each of `configs`, the trace prefix
    against the `fusedqkv` one on the card."""
    from patchioner_tpu_torch import entry
    from patchioner_tpu_torch.models.patchioner import Patchioner

    gpu = Patchioner.from_config(config, rng_seed=seed, allow_missing_weights=True,
                                 dtype=torch.float32, device="cuda")
    # the random init's layerscale of 1e-5 would leave the residual stream
    # almost untouched by the kernels; draw it per channel near 1 instead
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    for blk in gpu.vit_params["blocks"]:
        for key in ("ls1", "ls2"):
            blk[key] = 1 + 0.1 * torch.randn(blk[key].shape, generator=gen,
                                             device="cuda")
    cpu = gpu.to("cpu")
    imgs, traces = _requests(2, seed + 1)
    pts, valid = _padded(traces)
    sets = _query_boxes(2, seed + 5)

    def prefix(m, vit_cfg, what="trace", pool=None, args=(pts, valid)):
        step = entry.make_prefix_step(vit_cfg, m.bank.num_real, use_attention=True,
                                      normalize=m.normalize, pool=pool)
        t0 = time.perf_counter()
        out = step(m.state(), m.pixels_to_device(imgs),
                   *(torch.from_numpy(a).to(m.device) for a in args))
        log(f"[{label}] {what} prefix on {m.device}, attn_impl={vit_cfg.attn_impl!r}, "
            f"proj_fused={vit_cfg.proj_fused}: {time.perf_counter() - t0:.1f} s")
        return out

    def gate(got, ref, what):
        err = (got - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        log(f"[{label}] prefix {what}: max|d|={err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"f32 prefix {what} differs: {err:.3e} > {tol:.3e}")

    on_card = prefix(gpu, gpu.vit_cfg)
    ref = prefix(cpu, cpu.vit_cfg)
    gate(on_card.cpu(), ref, "card vs CPU")
    tok_gpu, _ = gpu.decode(on_card)
    tok_cpu, _ = cpu.decode(ref)
    agree = (tok_gpu.cpu() == tok_cpu).float().mean().item()
    log(f"[{label}] caption-token agreement card vs CPU (reported, not asserted): "
        f"{agree:.4f}")
    del cpu, ref, tok_cpu
    if queries:
        patch = gpu.patch_size
        for what, pool, args in (
                ("bbox attention-map", entry.make_bbox_pool(patch, use_attn_map=True),
                 (_pixel_boxes(sets, [0, 0, 1, 1]),)),
                ("region-set gaussian", entry.make_region_set_pool(patch, gaussian_avg=True),
                 (_pixel_boxes(sets, [-1] * 4),)),
                ("avg_self_attn", entry.make_image_pool("avg_self_attn"), ())):
            on_card = prefix(gpu, gpu.vit_cfg, what, pool, args)
            cpu = gpu.to("cpu")
            gate(on_card.cpu(), prefix(cpu, cpu.vit_cfg, what, pool, args),
                 f"{what} card vs CPU")
            del cpu
    # phase 5b: each further attention configuration against fusedqkv's
    fusedqkv = dataclasses.replace(gpu.vit_cfg, attn_impl="fusedqkv")
    base = prefix(gpu, fusedqkv) if configs else None
    for name, opts in (configs or {}).items():
        gate(prefix(gpu, dataclasses.replace(fusedqkv, **opts)), base,
             f"{name} vs fusedqkv on the card")
    del gpu
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    from patchioner_tpu_torch.ops import mlp

    mlp.fused_ln_mlp_w8.launches = 0
    summary = phase_kernels(args.seed)
    # (count, the run it was read from) for every kernel
    launches = {"ln_mlp_w8": (mlp.fused_ln_mlp_w8.launches,
                              "kernels (no model path reaches I)")}
    flagship = build_model(FLAGSHIP_CONFIG, args.seed, "[main]")
    counts, captions = phase_main_path(args.seed, smi, model=flagship)
    launches.update({k: (counts[k], "main") for k in (
        "ln_dense", "qkv_attention", "ln_mlp", "memory_project")})
    # phase 4e: the other spatial queries on the same model; each kind's
    # launches were asserted batch by batch, the table keeps the trace run's
    phase_other_queries(flagship, args.seed, smi)
    phase_decode_graph(flagship, args.seed, smi)
    del flagship
    torch.cuda.empty_cache()
    # phase 4b: the kernel each further configuration adds is read from its
    # own served run
    added = {"proj_fused": "dense_residual", "fusedqkv_proj": "qkv_attention_proj",
             "flash1p": "flash_attention_1pass", "flash": "flash_attention"}
    for label, opts in CONFIGS.items():
        counts, caps = phase_main_path(args.seed, smi, label, opts, n_requests=B,
                                       warm=label == "flash_builtin")
        if label in added:
            launches[added[label]] = (counts[added[label]], label)
        same = sum(a == b for a, b in zip(caps, captions))
        log(f"[{label}] bf16 captions equal to fusedqkv's (reported, not "
            f"asserted): {same}/{len(caps)}")
    # phase 4c, 4d: the paths of G and H, each read from its own served run,
    # and giant under fusedqkv_proj
    counts, _ = phase_main_path(args.seed, smi, "giant", n_requests=B, base=GIANT_CONFIG)
    launches["ln_swiglu"] = (counts["ln_swiglu"], "giant")
    phase_main_path(args.seed, smi, "giant_fusedqkv_proj", CONFIGS["fusedqkv_proj"],
                    n_requests=B, base=GIANT_CONFIG)
    counts, _ = phase_main_path(args.seed, smi, "int8_bank", {"memory_bank_int8": True},
                                n_requests=B)
    launches["memory_project_int8"] = (counts["memory_project_int8"], "int8_bank")
    phase_f32_crosscheck(args.seed, configs=CONFIGS, queries=True)
    phase_f32_crosscheck(args.seed, dict(FLAGSHIP_CONFIG, memory_bank_int8=True),
                         "f32 int8_bank")
    giant4 = dict(GIANT_CONFIG, dino_geometry={"depth": 4})
    phase_f32_crosscheck(args.seed, giant4, "f32 giant")
    phase_f32_crosscheck(args.seed, dict(giant4, **CONFIGS["fusedqkv_proj"]),
                         "f32 giant fusedqkv_proj",
                         {"fusedqkv_proj": CONFIGS["fusedqkv_proj"]})
    reference = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "patchioner_tpu"))
    if reference:
        raise AssertionError(f"JAX or the JAX package was imported: {reference}")
    log("[imports] neither jax nor patchioner_tpu loaded")
    for key, row in summary.items():
        row["launches"], row["launched_in"] = launches[key]
        if not row["launches"]:
            raise AssertionError(f"{key} was never launched on its path")
    if len(summary) != len(_wrappers()):
        raise AssertionError(f"kernel rows {sorted(summary)} != {sorted(_wrappers())}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s for the whole run")
    log(smi)
    log(json.dumps({"kernels": [summary[k] for k in _wrappers()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
