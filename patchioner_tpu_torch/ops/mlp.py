"""LN + dense (kernel A), dense + layerscale + residual (kernel E) and
LN + MLP (kernel C) of the ViT encoder block.

Twins of `patchioner_tpu/ops/mlp.py:fused_ln_dense`, `fused_dense_residual`
and `fused_ln_mlp`. Each wrapper runs its hand-written CUDA kernel
(`csrc/ln_dense.cu` for A and E, `csrc/ln_mlp.cu`, whose notes give the
bound and design) on CUDA tensors and its plain PyTorch version on CPU
tensors. `launches` on each wrapper counts kernel launches.

Rounding points follow the reference kernels (ops/mlp.py:_kernel,
_ln_dense_kernel, _dense_res_kernel): f32 two-pass LN statistics, LN
output rounded to the activation type T before a product, every product's
f32 sum rounded to T before its bias, each elementwise step after it
rounded to T, GELU (exact erf, or tanh with `gelu_approx`) in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patchioner_tpu_torch import kernels

__all__ = [
    "ln_rows",
    "ln_dense_plain",
    "ln_mlp_plain",
    "dense_residual_plain",
    "fused_ln_dense",
    "fused_ln_mlp",
    "fused_dense_residual",
]


def ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with f32 two-pass statistics; the result
    is cast back to x's type (vit._ln, ops/mlp._ln_rows)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def ln_dense_plain(x, ln_scale, ln_bias, w, bias, *, eps: float):
    """`LN(x) @ w + bias`, (B, N, D) x (D, O) -> (B, N, O) in x's type."""
    y = ln_rows(x, ln_scale, ln_bias, eps)
    return torch.matmul(y, w) + bias


def ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ls, *, eps: float,
                 gelu_approx: bool = False):
    """`x + ls * fc2(GELU(fc1(LN(x))))`. The order of operations is the one
    kernel C follows: the fc2 product is summed in f32 over the whole
    hidden axis before it is rounded to T. `gelu_approx` takes the tanh
    GELU of `jax.nn.gelu(approximate=True)` in place of the exact erf."""
    y = ln_rows(x, ln_scale, ln_bias, eps)
    h = torch.matmul(y, w1) + b1
    h = F.gelu(h.float(), approximate="tanh" if gelu_approx else "none").to(x.dtype)
    o = torch.matmul(h, w2) + b2
    return x + o * ls


def dense_residual_plain(x, residual, w, bias, ls):
    """`residual + ls * (x @ w + bias)`, (B, N, D) x (D, O) -> (B, N, O):
    the product's f32 sum rounded to T, then each step rounded to T."""
    return residual + (torch.matmul(x, w) + bias) * ls


def fused_ln_dense(x, ln_scale, ln_bias, w, bias, *, eps: float):
    """Kernel A on CUDA tensors, `ln_dense_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return ln_dense_plain(x, ln_scale, ln_bias, w, bias, eps=eps)
    kernels.check_operands("fused_ln_dense", x, ln_scale, ln_bias, w, bias)
    d, o = w.shape
    if x.shape[-1] != d or (x.dtype == torch.bfloat16 and (d % 64 or o % 128)):
        raise ValueError(
            f"fused_ln_dense: needs x (..., D) and w (D, O), with D % 64 == 0 "
            f"and O % 128 == 0 in bfloat16; got x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}"
        )
    out = torch.empty(*x.shape[:-1], o, device=x.device, dtype=x.dtype)
    kernels.launch(
        "pt_ln_dense", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel() // d, d, o,
        float(eps), kernels.dtype_code(x),
    )
    fused_ln_dense.launches += 1
    return out


fused_ln_dense.launches = 0


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, ls, *, eps: float,
                 gelu_approx: bool = False):
    """Kernel C on CUDA tensors, `ln_mlp_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ls, eps=eps,
                            gelu_approx=gelu_approx)
    kernels.check_operands("fused_ln_mlp", x, ln_scale, ln_bias, w1, b1, w2, b2, ls)
    d = x.shape[-1]
    h = w1.shape[1]
    align = 128 if x.dtype == torch.bfloat16 else 32
    if d % align or d > 768 or h % 32 or tuple(w2.shape) != (h, d):
        raise ValueError(
            f"fused_ln_mlp: needs D % {align} == 0, D <= 768, H % 32 == 0; "
            f"got D={d}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}"
        )
    out = torch.empty_like(x)
    kernels.launch(
        "pt_ln_mlp", *(t.data_ptr() for t in (x, ln_scale, ln_bias, w1, b1,
                                               w2, b2, ls, out)),
        x.numel() // d, d, h, float(eps), int(bool(gelu_approx)),
        kernels.dtype_code(x),
    )
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0


def fused_dense_residual(x, residual, w, bias, ls):
    """Kernel E on CUDA tensors, `dense_residual_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return dense_residual_plain(x, residual, w, bias, ls)
    kernels.check_operands("fused_dense_residual", x, residual, w, bias, ls)
    d, o = w.shape
    if (x.shape[-1] != d or residual.shape != (*x.shape[:-1], o)
            or (x.dtype == torch.bfloat16 and (d % 64 or o % 128))):
        raise ValueError(
            f"fused_dense_residual: needs x (..., D), w (D, O), residual "
            f"(..., O), with D % 64 == 0 and O % 128 == 0 in bfloat16; got x "
            f"{tuple(x.shape)}, w {tuple(w.shape)}, residual "
            f"{tuple(residual.shape)}"
        )
    out = torch.empty_like(residual)
    kernels.launch(
        "pt_dense_residual", *(t.data_ptr() for t in (x, residual, w, bias, ls,
                                                      out)),
        x.numel() // d, d, o, kernels.dtype_code(x),
    )
    fused_dense_residual.launches += 1
    return out


fused_dense_residual.launches = 0
