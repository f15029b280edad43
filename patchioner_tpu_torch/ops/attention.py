"""The encoder's attention kernels: B, F, J and K.

Twins of `patchioner_tpu/ops/attention.py`:

- `fused_qkv_attention` (kernel B, `csrc/qkv_attention.cu`): attention read
  from the fused (B, N, 3D) qkv activation, laid out (3, H, hd) on the last
  axis, written as the merged (B, N, D) output;
- `fused_qkv_attention_proj` (kernel F, `csrc/qkv_attention_proj.cu`): B
  followed by the out-projection, with bias, layerscale and residual add in
  the product's f32 epilogue (two CUDA launches a call: B's attention into
  a merged scratch, then a GEMM);
- `flash_attention` (kernel K, `csrc/flash_attention.cu`): online-softmax
  attention on (B, H, N, hd) q, k and v;
- `flash_attention_1pass` (kernel J, `csrc/flash_attention_1pass.cu`):
  the same function with a one-pass exact softmax.

Each wrapper runs its hand-written CUDA kernel (whose note gives the bound
and design) on CUDA tensors and its plain PyTorch version on CPU tensors;
`launches` on each wrapper counts the calls that ran its kernel. In bf16, B,
F, J and K run one wgmma attention body (`csrc/attention_sm90.cuh`), and F's
out-projection the GEMM template of kernels A, C and G
(`csrc/gemm_sm90.cuh`). The kernels take head dim 64 and raise on any
other.

Semantics (ops/attention.py:_softmax_attend, _flash_kernel): q * scale
rounded to q's type T, f32 logits, keys at or beyond `num_real_k` masked
to -1e30, f32 softmax, probabilities rounded to T before PV, the f32 PV sum
divided by the f32 row sum. The plain versions take the exact softmax; K's
online rescaling differs from it only in where p is rounded.

Gradients: on CUDA tensors with grad on and an operand that requires
grad, B runs its float32 kernel inside a `torch.autograd.Function` whose
backward is `qkv_attention_backward` in torch ops; F, J and K raise
(`kernels.refuse_grad`): their backward is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from patchioner_tpu_torch import kernels

__all__ = [
    "attention_plain",
    "qkv_attention_plain",
    "qkv_attention_proj_plain",
    "qkv_attention_backward",
    "fused_qkv_attention",
    "fused_qkv_attention_proj",
    "flash_attention",
    "flash_attention_1pass",
    "split_heads",
    "merge_heads",
]

HEAD_DIM = 64


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, num_real_k: Optional[int] = None) -> torch.Tensor:
    """(B, H, N, hd) x3 -> (B, H, N, hd) in q's type."""
    n = k.shape[-2]
    q = q * torch.tensor(scale, dtype=q.dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))  # (B, H, N, N)
    if num_real_k is not None and num_real_k < n:
        s = s.masked_fill(torch.arange(n, device=q.device) >= num_real_k, -1e30)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype)


def split_heads(qkv: torch.Tensor, num_heads: int):
    """(B, N, 3D) fused qkv -> q, k, v, each (B, H, N, hd) and contiguous."""
    b, n, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    q, k, v = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    return q.contiguous(), k.contiguous(), v.contiguous()


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, H, N, hd) -> (B, N, H * hd)."""
    b, h, n, hd = o.shape
    return o.transpose(1, 2).reshape(b, n, h * hd)


def qkv_attention_plain(qkv: torch.Tensor, *, num_heads: int, scale: float,
                        num_real_k: Optional[int] = None) -> torch.Tensor:
    q, k, v = split_heads(qkv, num_heads)
    return merge_heads(attention_plain(q, k, v, scale=scale, num_real_k=num_real_k))


def qkv_attention_proj_plain(qkv, x_res, w_proj, b_proj, ls, *, num_heads: int,
                             scale: float, num_real_k: Optional[int] = None):
    """`x_res + ls * (attention(qkv) @ w_proj + b_proj)` with kernel F's
    rounding points (ops/attention.py:_fusedqkv_proj_kernel): each head's
    output rounded to T, the out-projection summed in f32 over all heads,
    bias, layerscale and residual added in f32, one rounding at the end."""
    merged = qkv_attention_plain(qkv, num_heads=num_heads, scale=scale,
                                 num_real_k=num_real_k)
    acc = torch.matmul(merged.float(), w_proj.float())
    out = x_res.float() + (acc + b_proj.float()) * ls.float()
    return out.to(x_res.dtype)


def _num_real_k(num_real_k, n, name):
    nrk = n if num_real_k is None else int(num_real_k)
    if not 1 <= nrk <= n:
        raise ValueError(f"{name}: num_real_k={nrk} not in [1, {n}]")
    return nrk


def _qkv_heads(name, qkv, num_heads):
    if qkv.dim() != 3:
        raise ValueError(f"{name}: qkv must be (B, N, 3D)")
    b, n, three_d = qkv.shape
    d = three_d // 3
    if d * 3 != three_d or d % num_heads or d // num_heads != HEAD_DIM:
        raise ValueError(f"{name}: needs head_dim {HEAD_DIM}, got 3D={three_d}, "
                         f"heads={num_heads}")
    return b, n, d


def _softmax_backward(p: torch.Tensor, gp: torch.Tensor) -> torch.Tensor:
    """Gradient of the logits from softmax's output p and its gradient gp,
    along the last axis: p * (gp - rowsum(gp * p))."""
    return p * (gp - (gp * p).sum(-1, keepdim=True))


def qkv_attention_backward(g: torch.Tensor, qkv: torch.Tensor, *, num_heads: int,
                           scale: float, num_real_k: Optional[int] = None) -> torch.Tensor:
    """Gradient of `qkv_attention_plain` with respect to the fused (B, N, 3D)
    qkv from the merged output's gradient g (B, N, D), in torch ops: the
    probabilities recomputed from q and k (float32), then dV = P^T dO,
    dS = P * (dO V^T - rowsum(dO * O)), dQ = scale dS K, dK = scale dS^T Q.
    Keys at or past `num_real_k` get a zero gradient (their P is 0)."""
    b, n, _ = qkv.shape
    q, k, v = split_heads(qkv, num_heads)
    go = g.reshape(b, n, num_heads, -1).transpose(1, 2)  # (B, H, N, hd)
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    if num_real_k is not None and num_real_k < n:
        s = s.masked_fill(torch.arange(n, device=qkv.device) >= num_real_k, -1e30)
    p = torch.softmax(s, dim=-1)
    gv = torch.matmul(p.transpose(-1, -2), go)
    gp = torch.matmul(go, v.transpose(-1, -2))
    gs = _softmax_backward(p, gp)
    gq = torch.matmul(gs, k) * scale
    gk = torch.matmul(gs.transpose(-1, -2), q) * scale
    if num_real_k is not None and num_real_k < n:
        gk[..., num_real_k:, :] = 0.0
        gv[..., num_real_k:, :] = 0.0
    # (3, B, H, N, hd) -> (B, N, 3, H, hd), the fused layout
    gqkv = torch.stack([gq, gk, gv]).permute(1, 3, 0, 2, 4)
    return gqkv.reshape(qkv.shape)


def _qkv_attention_kernel(qkv, num_heads, scale, num_real_k):
    """Kernel B's launch on a CUDA tensor, outside autograd."""
    kernels.check_operands("fused_qkv_attention", qkv)
    b, n, d = _qkv_heads("fused_qkv_attention", qkv, num_heads)
    nrk = _num_real_k(num_real_k, n, "fused_qkv_attention")
    out = torch.empty(b, n, d, device=qkv.device, dtype=qkv.dtype)
    kernels.launch("pt_qkv_attention", qkv.data_ptr(), out.data_ptr(), b, n,
                   num_heads, nrk, float(scale), kernels.dtype_code(qkv))
    fused_qkv_attention.launches += 1
    return out


class _QkvAttention(torch.autograd.Function):
    """Kernel B's forward, `qkv_attention_backward` as its backward."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, num_real_k):
        ctx.save_for_backward(qkv)
        ctx.args = dict(num_heads=num_heads, scale=scale, num_real_k=num_real_k)
        return _qkv_attention_kernel(qkv, num_heads, scale, num_real_k)

    @staticmethod
    def backward(ctx, g):
        return qkv_attention_backward(g, *ctx.saved_tensors, **ctx.args), None, None, None


def fused_qkv_attention(qkv: torch.Tensor, *, num_heads: int, scale: float,
                        num_real_k: Optional[int] = None) -> torch.Tensor:
    """Kernel B on CUDA tensors, `qkv_attention_plain` on CPU tensors. With
    grad on and qkv requiring it (float32 only), the kernel runs inside
    `_QkvAttention`, whose backward is `qkv_attention_backward`."""
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads=num_heads, scale=scale,
                                   num_real_k=num_real_k)
    if kernels.wants_grad(qkv):
        kernels.check_grad_dtype("fused_qkv_attention", qkv)
        return _QkvAttention.apply(qkv, num_heads, scale, num_real_k)
    return _qkv_attention_kernel(qkv, num_heads, scale, num_real_k)


fused_qkv_attention.launches = 0


def fused_qkv_attention_proj(qkv, x_res, w_proj, b_proj, ls, *, num_heads: int,
                             scale: float, num_real_k: Optional[int] = None):
    """Kernel F on CUDA tensors, `qkv_attention_proj_plain` on CPU tensors.
    `ls` is the (D,) layerscale (ones when the block has none)."""
    kw = dict(num_heads=num_heads, scale=scale, num_real_k=num_real_k)
    if qkv.device.type == "cpu":
        return qkv_attention_proj_plain(qkv, x_res, w_proj, b_proj, ls, **kw)
    name = "fused_qkv_attention_proj"
    kernels.refuse_grad(name, qkv, x_res, w_proj, b_proj, ls)
    kernels.check_operands(name, qkv, x_res, w_proj, b_proj, ls)
    b, n, d = _qkv_heads(name, qkv, num_heads)
    # bf16: the out-projection GEMM's 128-wide tiles of D, an even head count
    if (x_res.shape != (b, n, d) or w_proj.shape != (d, d)
            or b_proj.shape != (d,) or ls.shape != (d,)
            or (qkv.dtype == torch.bfloat16 and d % 128)):
        raise ValueError(
            f"{name}: needs x_res (B, N, D), w_proj (D, D), b_proj and ls (D,), "
            f"with D % 128 == 0 in bfloat16; got qkv {tuple(qkv.shape)} with "
            f"{num_heads} heads, x_res {tuple(x_res.shape)}, w_proj "
            f"{tuple(w_proj.shape)}")
    nrk = _num_real_k(num_real_k, n, name)
    out = torch.empty_like(x_res)
    # the merged attention output, between the attention and GEMM launches
    merged = torch.empty_like(x_res)
    kernels.launch("pt_qkv_attention_proj",
                   *(t.data_ptr() for t in (qkv, x_res, w_proj, b_proj, ls, out, merged)),
                   b, n, num_heads, nrk, float(scale), kernels.dtype_code(qkv))
    fused_qkv_attention_proj.launches += 1
    return out


fused_qkv_attention_proj.launches = 0


def _bhnd(name, q, k, v):
    kernels.check_operands(name, q, k, v)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape \
            or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: needs q, k, v of one shape (B, H, N, "
                         f"{HEAD_DIM}); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return q.shape


def flash_attention(q, k, v, *, scale: float, num_real_k: Optional[int] = None):
    """Kernel K on CUDA tensors, `attention_plain` on CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, num_real_k=num_real_k)
    kernels.refuse_grad("flash_attention", q, k, v)
    b, h, n, _ = _bhnd("flash_attention", q, k, v)
    nrk = _num_real_k(num_real_k, n, "flash_attention")
    out = torch.empty_like(q)
    kernels.launch("pt_flash_attention",
                   *(t.data_ptr() for t in (q, k, v, out)), b * h, n, nrk,
                   float(scale), kernels.dtype_code(q))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

# J's float32 kernel keeps a 16-query tile's whole f32 logit rows (N padded
# to 64 keys) in shared memory beside a 16-row q tile and a 64-key tile, 65
# floats a row: 20.8 KB + 16 x 3264 x 4 B fits the SM's 227 KB. The bf16
# kernel (two sweeps over the keys) takes any N.
FLASH1P_F32_MAX_N = 3264


def flash_attention_1pass(q, k, v, *, scale: float,
                          num_real_k: Optional[int] = None):
    """Kernel J on CUDA tensors, `attention_plain` on CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, num_real_k=num_real_k)
    kernels.refuse_grad("flash_attention_1pass", q, k, v)
    b, h, n, _ = _bhnd("flash_attention_1pass", q, k, v)
    if q.dtype == torch.float32 and n > FLASH1P_F32_MAX_N:
        raise ValueError(f"flash_attention_1pass: N={n} > {FLASH1P_F32_MAX_N} in "
                         "float32: the logit rows do not fit in shared memory "
                         "(bfloat16 takes any N)")
    nrk = _num_real_k(num_real_k, n, "flash_attention_1pass")
    out = torch.empty_like(q)
    kernels.launch("pt_flash_attention_1pass",
                   *(t.data_ptr() for t in (q, k, v, out)), b * h, n, nrk,
                   float(scale), kernels.dtype_code(q))
    flash_attention_1pass.launches += 1
    return out


flash_attention_1pass.launches = 0
