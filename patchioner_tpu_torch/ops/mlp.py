"""LN + dense (kernel A), dense + layerscale + residual (kernel E), LN +
MLP (kernel C), LN + SwiGLU FFN (kernel G) and the W8A8 LN + MLP (kernel I)
of the ViT encoder block.

Twins of `patchioner_tpu/ops/mlp.py:fused_ln_dense`, `fused_dense_residual`,
`fused_ln_mlp`, `fused_ln_swiglu` and `fused_ln_mlp_w8`, with the int8
helpers `quantize_symmetric_int8` and `quantize_mlp_weights`. Each wrapper
runs its hand-written CUDA kernel (`csrc/ln_dense.cu` for A and E,
`csrc/ln_mlp.cu`, `csrc/ln_swiglu.cu`, `csrc/ln_mlp_w8.cu`, whose notes
give the bound and design) on CUDA tensors and its plain PyTorch version
on CPU tensors. `launches` on each wrapper counts the calls that ran its
kernel (A's bf16 call is two CUDA launches: LN, then the qkv GEMM; C's and
G's are three each: LN, fc1, fc2; I's five: the weights' transpose, LN and
quantize, fc1 twice, fc2).

Rounding points follow the reference kernels (ops/mlp.py:_kernel,
_ln_dense_kernel, _dense_res_kernel): f32 two-pass LN statistics, LN
output rounded to the activation type T before a product, every product's
f32 sum rounded to T before its bias, each elementwise step after it
rounded to T, GELU (exact erf, or tanh with `gelu_approx`) in f32. G
(_ln_swiglu_kernel) and I (_w8_kernel) keep their sums in f32 through the
bias and round only `o * ls` before the residual add; their plain versions
say where they round.

Gradients: a kernel writes its output through a pointer, outside autograd.
On CUDA tensors with grad on and an operand that requires grad, A and C
run their float32 kernel inside a `torch.autograd.Function` whose backward
is `ln_dense_backward` / `ln_mlp_backward` in torch ops (the JAX package
differentiates plain XLA ops and has no backward kernel); E, G and I raise
(`kernels.refuse_grad`). On CPU tensors the plain versions are
differentiated by autograd.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from patchioner_tpu_torch import kernels

__all__ = [
    "ln_rows",
    "ln_dense_plain",
    "ln_mlp_plain",
    "dense_residual_plain",
    "ln_swiglu_plain",
    "ln_mlp_w8_plain",
    "ln_dense_backward",
    "ln_mlp_backward",
    "quantize_symmetric_int8",
    "quantize_mlp_weights",
    "fused_ln_dense",
    "fused_ln_mlp",
    "fused_dense_residual",
    "fused_ln_swiglu",
    "fused_ln_mlp_w8",
]


def _ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with f32 two-pass statistics, in f32
    (ops/mlp._ln_rows)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y * scale.float() + bias.float()


def ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """`_ln_f32` cast back to x's type (vit._ln)."""
    return _ln_f32(x, scale, bias, eps).to(x.dtype)


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


def ln_swiglu_plain(x, ln_scale, ln_bias, w12, b12, w3, b3, ls, *, eps: float):
    """`x + ls * ((silu(x1) * x2) @ w3 + b3)` with `[x1 | x2] = LN(x) @ w12 +
    b12`, w12 (D, 2H), w3 (H, D). The order of operations is kernel G's
    (_ln_swiglu_kernel), not `ln_swiglu_reference`'s: LN(x) rounded to T,
    h1 and h2 f32 sums with the bias added in f32 (not rounded), silu(h1) *
    h2 in f32 rounded to T, the w3 sum and + b3 in f32, o * ls rounded to T
    before x + it."""
    y = ln_rows(x, ln_scale, ln_bias, eps)
    h1, h2 = (torch.matmul(y.float(), w12.float()) + b12.float()).chunk(2, dim=-1)
    g = (h1 * (1.0 / (1.0 + torch.exp(-h1))) * h2).to(x.dtype)
    o = torch.matmul(g.float(), w3.float()) + b3.float()
    return x + (o * ls.float()).to(x.dtype)


def quantize_symmetric_int8(x: torch.Tensor, dim: int):
    """Symmetric int8 with one scale per slice along `dim`:
    scale = max(amax / 127, 1e-12), q = clip(round(x / scale), -127, 127),
    rounding half to even (ops/mlp.quantize_symmetric_int8). Returns
    (q int8, scale f32 with `dim` kept)."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=dim, keepdim=True) / 127.0, 1e-12)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def quantize_mlp_weights(w1, b1, w2, b2):
    """Per-output-column int8 weights of the two MLP products, once at load
    (ops/mlp.quantize_mlp_weights): (w1q, w1s (1, H), b1, w2q, w2s (1, D),
    b2) with f32 scales and biases."""
    w1q, w1s = quantize_symmetric_int8(w1, dim=0)
    w2q, w2s = quantize_symmetric_int8(w2, dim=0)
    return w1q, w1s, b1.float(), w2q, w2s, b2.float()


def _ln_f64_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """`_ln_f32` with the mean and variance summed in f64 and rounded to f32
    once (kernel I's LN): both sums are exact there up to f64 rounding, so
    kernel and plain version agree on every bit of the activations they
    quantize, which f32 sums in two summation orders do not. The
    reference's f32 statistics differ from these by an ulp at most."""
    xf = x.float()
    n = xf.shape[-1]
    mu = (xf.double().sum(-1, keepdim=True) / n).float()
    c = xf - mu
    var = (c.double() ** 2).sum(-1, keepdim=True) / n
    eps32 = torch.tensor(eps, dtype=torch.float32).item()  # the kernel's f32 eps
    rstd = (1.0 / torch.sqrt(var + eps32)).float()
    return c * rstd * scale.float() + bias.float()


def _qdot(a: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """_w8_kernel's qdot: `a` quantized per row, the int8 product summed
    exactly (float64 holds |sum| <= 127^2 * K < 2^53; int8 matmul has no
    CUDA route in torch), dequantized as (acc * s_a) * s_w."""
    aq, sa = quantize_symmetric_int8(a, dim=-1)
    acc = torch.matmul(aq.double(), wq.double())
    return acc.float() * sa * ws.reshape(-1).float()


def ln_mlp_w8_plain(x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, ls, *,
                    eps: float, gelu_approx: bool = False):
    """`x + ls * fc2(GELU(fc1(LN(x))))` with int8 weights (per-column f32
    scales) and int8 activations quantized per row (_w8_kernel): LN in f32
    (statistics summed in f64, `_ln_f64_stats`), not rounded to T; GELU
    and both biases in f32; o * ls rounded to T before x + it."""
    y = _ln_f64_stats(x, ln_scale, ln_bias, eps)
    h = F.gelu(_qdot(y, w1q, w1s) + b1.float(),
               approximate="tanh" if gelu_approx else "none")
    o = _qdot(h, w2q, w2s) + b2.float()
    return x + (o * ls.float()).to(x.dtype)


# ------------------------------------------------------------- backward
#
# The float32 gradients of A and C in torch ops, from the saved inputs: the
# LN statistics and fc1's pre-activation are recomputed, as activation
# checkpointing would.


def _ln_stats(x: torch.Tensor, eps: float):
    """(x_hat, rstd) of `_ln_f32` over the last axis of f32 rows."""
    mu = x.mean(-1, keepdim=True)
    c = x - mu
    rstd = torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    return c * rstd, rstd


def _ln_backward(gy, x_hat, rstd, scale):
    """LayerNorm's backward from the gradient of its output: (dx, dscale,
    dbias), with x_hat and rstd its forward's."""
    gxh = gy * scale
    gx = rstd * (gxh - gxh.mean(-1, keepdim=True)
                 - x_hat * (gxh * x_hat).mean(-1, keepdim=True))
    return gx, (gy * x_hat).sum(0), gy.sum(0)


def _gelu_grad(h: torch.Tensor, approx: bool) -> torch.Tensor:
    """d GELU(h) / dh: Phi(h) + h phi(h) for the erf GELU; the tanh form's
    derivative under `approx`."""
    if approx:
        k = math.sqrt(2.0 / math.pi)
        t = torch.tanh(k * (h + 0.044715 * h ** 3))
        return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * k * (1.0 + 3 * 0.044715 * h * h)
    return (0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
            + h * torch.exp(-0.5 * h * h) * (1.0 / math.sqrt(2.0 * math.pi)))


def ln_dense_backward(g, x, ln_scale, ln_bias, w, *, eps: float):
    """Gradients of `LN(x) @ w + bias` from the output's gradient g:
    (dx, dln_scale, dln_bias, dw, dbias)."""
    d, o = w.shape
    xf, gf = x.reshape(-1, d), g.reshape(-1, o)
    x_hat, rstd = _ln_stats(xf, eps)
    y = x_hat * ln_scale + ln_bias
    gx, gs, gb_ln = _ln_backward(torch.matmul(gf, w.T), x_hat, rstd, ln_scale)
    return gx.reshape(x.shape), gs, gb_ln, torch.matmul(y.T, gf), gf.sum(0)


def ln_mlp_backward(g, x, ln_scale, ln_bias, w1, b1, w2, b2, ls, *, eps: float,
                    gelu_approx: bool = False):
    """Gradients of `x + ls * fc2(GELU(fc1(LN(x))))` from the output's
    gradient g: (dx, dln_scale, dln_bias, dw1, db1, dw2, db2, dls)."""
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d), g.reshape(-1, d)
    x_hat, rstd = _ln_stats(xf, eps)
    y = x_hat * ln_scale + ln_bias
    pre = torch.matmul(y, w1) + b1
    h = F.gelu(pre, approximate="tanh" if gelu_approx else "none")
    o = torch.matmul(h, w2) + b2
    go = gf * ls
    gpre = torch.matmul(go, w2.T) * _gelu_grad(pre, gelu_approx)
    gx, gs, gb_ln = _ln_backward(torch.matmul(gpre, w1.T), x_hat, rstd, ln_scale)
    return ((gf + gx).reshape(x.shape), gs, gb_ln, torch.matmul(y.T, gpre), gpre.sum(0),
            torch.matmul(h.T, go), go.sum(0), (gf * o).sum(0))


def _ln_dense_kernel(x, ln_scale, ln_bias, w, bias, eps: float):
    """Kernel A's launch on CUDA tensors, outside autograd."""
    kernels.check_operands("fused_ln_dense", x, ln_scale, ln_bias, w, bias)
    d, o = w.shape
    if x.shape[-1] != d or (x.dtype == torch.bfloat16 and (d % 64 or o % 128)):
        raise ValueError(
            f"fused_ln_dense: needs x (..., D) and w (D, O), with D % 64 == 0 "
            f"and O % 128 == 0 in bfloat16; got x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}"
        )
    rows = x.numel() // d
    out = torch.empty(*x.shape[:-1], o, device=x.device, dtype=x.dtype)
    # bf16 writes LN(x) into a scratch that the GEMM launch then reads
    ln = (torch.empty(rows, d, device=x.device, dtype=x.dtype)
          if x.dtype == torch.bfloat16 else None)
    kernels.launch(
        "pt_ln_dense", *(t.data_ptr() for t in (x, ln_scale, ln_bias, w, bias, out)),
        ln.data_ptr() if ln is not None else None, rows, d, o, float(eps),
        kernels.dtype_code(x),
    )
    fused_ln_dense.launches += 1
    return out


class _LnDense(torch.autograd.Function):
    """Kernel A's forward, `ln_dense_backward` as its backward."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w, bias, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w)
        ctx.eps = eps
        return _ln_dense_kernel(x, ln_scale, ln_bias, w, bias, eps)

    @staticmethod
    def backward(ctx, g):
        return (*ln_dense_backward(g, *ctx.saved_tensors, eps=ctx.eps), None)


def fused_ln_dense(x, ln_scale, ln_bias, w, bias, *, eps: float):
    """Kernel A on CUDA tensors, `ln_dense_plain` on CPU tensors. With grad
    on and an operand requiring it (float32 only), the kernel runs inside
    `_LnDense`, whose backward is `ln_dense_backward`."""
    if x.device.type == "cpu":
        return ln_dense_plain(x, ln_scale, ln_bias, w, bias, eps=eps)
    if kernels.wants_grad(x, ln_scale, ln_bias, w, bias):
        kernels.check_grad_dtype("fused_ln_dense", x)
        return _LnDense.apply(x, ln_scale, ln_bias, w, bias, eps)
    return _ln_dense_kernel(x, ln_scale, ln_bias, w, bias, eps)


fused_ln_dense.launches = 0


def _ln_mlp_kernel(x, ln_scale, ln_bias, w1, b1, w2, b2, ls, eps: float,
                   gelu_approx: bool):
    """Kernel C's launch on CUDA tensors, outside autograd."""
    kernels.check_operands("fused_ln_mlp", x, ln_scale, ln_bias, w1, b1, w2, b2, ls)
    d = x.shape[-1]
    h = w1.shape[1]
    bf16 = x.dtype == torch.bfloat16
    # bf16: 128-wide wgmma tiles of D and H; f32: the SIMT kernel's tiles
    if tuple(w2.shape) != (h, d) or (d % 128 or h % 128 if bf16 else
                                     d % 32 or d > 1024 or h % 32):
        raise ValueError(
            f"fused_ln_mlp: needs w2 (H, D) and D % 128 == 0, H % 128 == 0 in "
            f"bfloat16, or D % 32 == 0, D <= 1024, H % 32 == 0 in float32; got "
            f"{x.dtype}, D={d}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}"
        )
    rows = x.numel() // d
    out = torch.empty_like(x)
    # bf16 runs fc1 and fc2 as two launches with the hidden in between
    hidden = torch.empty(rows, h, device=x.device, dtype=x.dtype) if bf16 else None
    kernels.launch(
        "pt_ln_mlp", *(t.data_ptr() for t in (x, ln_scale, ln_bias, w1, b1,
                                               w2, b2, ls, out)),
        hidden.data_ptr() if bf16 else None, rows, d, h, float(eps),
        int(bool(gelu_approx)), kernels.dtype_code(x),
    )
    fused_ln_mlp.launches += 1
    return out


class _LnMlp(torch.autograd.Function):
    """Kernel C's forward, `ln_mlp_backward` as its backward."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, ls, eps, gelu_approx):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, ls)
        ctx.eps, ctx.gelu_approx = eps, gelu_approx
        return _ln_mlp_kernel(x, ln_scale, ln_bias, w1, b1, w2, b2, ls, eps, gelu_approx)

    @staticmethod
    def backward(ctx, g):
        return (*ln_mlp_backward(g, *ctx.saved_tensors, eps=ctx.eps,
                                 gelu_approx=ctx.gelu_approx), None, None)


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, ls, *, eps: float,
                 gelu_approx: bool = False):
    """Kernel C on CUDA tensors, `ln_mlp_plain` on CPU tensors. With grad
    on and an operand requiring it (float32 only), the kernel runs inside
    `_LnMlp`, whose backward is `ln_mlp_backward`."""
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2, ls)
    if x.device.type == "cpu":
        return ln_mlp_plain(*args, eps=eps, gelu_approx=gelu_approx)
    if kernels.wants_grad(*args):
        kernels.check_grad_dtype("fused_ln_mlp", x)
        return _LnMlp.apply(*args, eps, gelu_approx)
    return _ln_mlp_kernel(*args, eps, gelu_approx)


fused_ln_mlp.launches = 0


def fused_dense_residual(x, residual, w, bias, ls):
    """Kernel E on CUDA tensors, `dense_residual_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return dense_residual_plain(x, residual, w, bias, ls)
    kernels.refuse_grad("fused_dense_residual", x, residual, w, bias, ls)
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


def fused_ln_swiglu(x, ln_scale, ln_bias, w12, b12, w3, b3, ls, *, eps: float):
    """Kernel G on CUDA tensors, `ln_swiglu_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return ln_swiglu_plain(x, ln_scale, ln_bias, w12, b12, w3, b3, ls, eps=eps)
    kernels.refuse_grad("fused_ln_swiglu", x, ln_scale, ln_bias, w12, b12, w3, b3, ls)
    kernels.check_operands("fused_ln_swiglu", x, ln_scale, ln_bias, w12, b12, w3, b3, ls)
    d, h = x.shape[-1], w3.shape[0]
    bf16 = x.dtype == torch.bfloat16
    # bf16: fc1's paired 64-column tiles of H, fc2's 128-wide tiles of D;
    # f32: the SIMT kernel's tiles
    if (tuple(w12.shape) != (d, 2 * h) or tuple(w3.shape) != (h, d)
            or (d % 128 or h % 64 if bf16 else d % 32 or d > 1536 or h % 32)):
        raise ValueError(
            f"fused_ln_swiglu: needs w12 (D, 2H), w3 (H, D) and D % 128 == 0, "
            f"H % 64 == 0 in bfloat16, or D % 32 == 0, D <= 1536, H % 32 == 0 in "
            f"float32; got {x.dtype}, x {tuple(x.shape)}, w12 {tuple(w12.shape)}, "
            f"w3 {tuple(w3.shape)}"
        )
    rows = x.numel() // d
    out = torch.empty_like(x)
    # bf16 runs fc1 and fc2 as two launches with the hidden in between
    hidden = torch.empty(rows, h, device=x.device, dtype=x.dtype) if bf16 else None
    kernels.launch(
        "pt_ln_swiglu", *(t.data_ptr() for t in (x, ln_scale, ln_bias, w12, b12,
                                                  w3, b3, ls, out)),
        hidden.data_ptr() if bf16 else None, rows, d, h, float(eps),
        kernels.dtype_code(x),
    )
    fused_ln_swiglu.launches += 1
    return out


fused_ln_swiglu.launches = 0


def fused_ln_mlp_w8(x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, ls, *,
                    eps: float, gelu_approx: bool = False):
    """Kernel I on CUDA tensors, `ln_mlp_w8_plain` on CPU tensors. x,
    ln_scale, ln_bias and ls in the activation type; w1q (D, H) and w2q
    (H, D) int8; w1s, b1 (H values) and w2s, b2 (D values) f32."""
    args = (x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, ls)
    if x.device.type == "cpu":
        return ln_mlp_w8_plain(*args, eps=eps, gelu_approx=gelu_approx)
    kernels.refuse_grad("fused_ln_mlp_w8", *args)
    kernels.check_operands("fused_ln_mlp_w8", x, ln_scale, ln_bias, ls)
    kernels.check_operands("fused_ln_mlp_w8", w1q, w2q, device=x.device)
    kernels.check_operands("fused_ln_mlp_w8", w1s, b1, w2s, b2, device=x.device)
    d, h = x.shape[-1], w1q.shape[1]
    # 128-deep stages and 128-wide output tiles of both int8 GEMMs
    if (w1q.dtype != torch.int8 or w1s.dtype != torch.float32 or not d or d % 128
            or not h or h % 128 or tuple(w1q.shape) != (d, h)
            or tuple(w2q.shape) != (h, d) or w1s.numel() != h or b1.numel() != h
            or w2s.numel() != d or b2.numel() != d):
        raise ValueError(
            f"fused_ln_mlp_w8: needs int8 w1q (D, H) and w2q (H, D), f32 scales "
            f"and biases, D % 128 == 0 and H % 128 == 0; got x {tuple(x.shape)}, "
            f"w1q {tuple(w1q.shape)} {w1q.dtype}, w2q {tuple(w2q.shape)}, "
            f"scales {w1s.dtype}"
        )
    rows = x.numel() // d
    out = torch.empty_like(x)
    # the f32 hidden (rows, H), Xq (rows, D), Hq (rows, H), both weights
    # transposed, s_y and the hidden's amax (rows each, 4 bytes): the layout
    # pt_ln_mlp_w8 carves
    scratch = torch.empty(rows * (d + 5 * h + 8) + 2 * d * h, device=x.device,
                          dtype=torch.int8)
    kernels.launch(
        "pt_ln_mlp_w8", *(t.data_ptr() for t in (*args, out, scratch)),
        rows, d, h, float(eps), int(bool(gelu_approx)), kernels.dtype_code(x),
    )
    fused_ln_mlp_w8.launches += 1
    return out


fused_ln_mlp_w8.launches = 0
