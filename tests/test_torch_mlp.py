"""Port's LN+dense (A), LN+MLP (C), LN+SwiGLU (G) and W8A8 LN+MLP (I)
plain versions against the JAX package's Pallas kernels (interpret mode)
and plain references.

On the CPU the wrappers run their plain versions; inputs are seeded numpy
arrays handed to both packages at f32.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from patchioner_tpu.models import vit as jvit
from patchioner_tpu.ops import mlp as jmlp
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.ops import mlp

# f32 on both sides; the sums differ only in order (~1e-6 relative). The
# Pallas MLP kernel's rational erf (|err| < 1.5e-7, ops/mlp.py:_erf) is
# amplified by fc2 to a few 1e-6 against the port's exact erf.
TOL = 2e-5


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _dense_inputs(rng, b=2, n=256, d=128, o=384):
    return (_arr(rng, b, n, d), 1 + _arr(rng, d, scale=0.1), _arr(rng, d, scale=0.1),
            _arr(rng, d, o, scale=d ** -0.5), _arr(rng, o, scale=0.1))


def _mlp_inputs(rng, b=2, n=256, d=128, h=512):
    return (_arr(rng, b, n, d), 1 + _arr(rng, d, scale=0.1), _arr(rng, d, scale=0.1),
            _arr(rng, d, h, scale=d ** -0.5), _arr(rng, h, scale=0.1),
            _arr(rng, h, d, scale=h ** -0.5), _arr(rng, d, scale=0.1),
            _arr(rng, d, scale=0.5))


def test_ln_dense_plain_matches_pallas_kernel_and_unfused_path():
    args = _dense_inputs(np.random.default_rng(0))
    got = mlp.fused_ln_dense(*_t(*args), eps=1e-6).numpy()
    pallas = jmlp.fused_ln_dense(*map(jnp.asarray, args), eps=1e-6, block_q=128,
                                 interpret=True)
    x, g, bg, w, b = map(jnp.asarray, args)
    unfused = jvit._dense(jvit._ln(x, {"scale": g, "bias": bg}, 1e-6),
                          {"w": w, "b": b})
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(unfused), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("oracle", ["pallas", "reference"])
def test_ln_mlp_plain_matches_jax(oracle):
    args = _mlp_inputs(np.random.default_rng(1))
    got = mlp.fused_ln_mlp(*_t(*args), eps=1e-6).numpy()
    x, g, bg, w1, b1, w2, b2, ls = map(jnp.asarray, args)
    if oracle == "pallas":
        want = jmlp.fused_ln_mlp(x, g, bg, w1, b1, w2, b2, ls, eps=1e-6,
                                 block_q=128, interpret=True)
    else:
        want = jmlp.ln_mlp_reference(
            x, {"norm2": {"scale": g, "bias": bg}, "fc1": {"w": w1, "b": b1},
                "fc2": {"w": w2, "b": b2}, "ls2": ls}, eps=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version_without_counting_a_launch():
    args = _t(*_mlp_inputs(np.random.default_rng(2), n=16))
    before = (mlp.fused_ln_dense.launches, mlp.fused_ln_mlp.launches)
    torch.testing.assert_close(mlp.fused_ln_mlp(*args, eps=1e-6),
                               mlp.ln_mlp_plain(*args, eps=1e-6), rtol=0, atol=0)
    dense = _t(*_dense_inputs(np.random.default_rng(3), n=16))
    torch.testing.assert_close(mlp.fused_ln_dense(*dense, eps=1e-6),
                               mlp.ln_dense_plain(*dense, eps=1e-6), rtol=0, atol=0)
    assert (mlp.fused_ln_dense.launches, mlp.fused_ln_mlp.launches) == before


def test_wrappers_raise_on_a_device_without_a_kernel():
    dense = [t.to("meta") for t in _t(*_dense_inputs(np.random.default_rng(4), n=8))]
    with pytest.raises(ValueError, match="no kernel"):
        mlp.fused_ln_dense(*dense, eps=1e-6)
    args = [t.to("meta") for t in _t(*_mlp_inputs(np.random.default_rng(5), n=8))]
    with pytest.raises(ValueError, match="no kernel"):
        mlp.fused_ln_mlp(*args, eps=1e-6)


def test_ln_mlp_plain_takes_the_tanh_gelu_of_the_pallas_kernel():
    args = _mlp_inputs(np.random.default_rng(6))
    got = mlp.fused_ln_mlp(*_t(*args), eps=1e-6, gelu_approx=True).numpy()
    x, g, bg, w1, b1, w2, b2, ls = map(jnp.asarray, args)
    want = jmlp.fused_ln_mlp(x, g, bg, w1, b1, w2, b2, ls, eps=1e-6,
                             gelu_approx=True, block_q=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    exact = mlp.fused_ln_mlp(*_t(*args), eps=1e-6).numpy()
    assert np.max(np.abs(got - exact)) > 10 * TOL  # a different function


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_residual_plain_matches_pallas_kernel(dtype):
    # f32: summation order only; bf16: max|d| / max|ref| <= 2e-2, a few
    # bf16 rounding boundaries (2^-8 relative) crossed in another order
    rng = np.random.default_rng(7)
    x, r = _arr(rng, 2, 256, 128), _arr(rng, 2, 256, 256)
    w, b = _arr(rng, 128, 256, scale=128 ** -0.5), _arr(rng, 256, scale=0.1)
    ls = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jmlp.fused_dense_residual(
        *(jnp.asarray(a, jdt) for a in (x, r, w, b, ls)), block_q=128,
        interpret=True).astype(jnp.float32))
    got = mlp.fused_dense_residual(*(torch.from_numpy(a).to(tdt)
                                     for a in (x, r, w, b, ls))).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        assert np.max(np.abs(got - want)) <= 2e-2 * np.max(np.abs(want))


# ------------------------------------------------------------ kernel G


def _swiglu_inputs(rng, b=2, n=256, d=128, h=256):
    return (_arr(rng, b, n, d), 1 + _arr(rng, d, scale=0.1), _arr(rng, d, scale=0.1),
            _arr(rng, d, 2 * h, scale=d ** -0.5), _arr(rng, 2 * h, scale=0.1),
            _arr(rng, h, d, scale=h ** -0.5), _arr(rng, d, scale=0.1),
            rng.uniform(0.5, 1.5, d).astype(np.float32))  # per-channel layerscale


@pytest.mark.parametrize("block_q,block_h", [(128, 128), (256, 256)])
def test_ln_swiglu_plain_matches_pallas_kernel(block_q, block_h):
    # f32 both sides: the plain version follows the kernel's rounding points,
    # which at f32 leave only the summation order (JAX's own gate, 2e-5)
    args = _swiglu_inputs(np.random.default_rng(8))
    got = mlp.fused_ln_swiglu(*_t(*args), eps=1e-6).numpy()
    want = jmlp.fused_ln_swiglu(*map(jnp.asarray, args), eps=1e-6, block_q=block_q,
                                block_h=block_h, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_ln_swiglu_plain_rounds_the_gate_product_to_bf16_before_w3():
    # bf16: g = silu(h1) * h2 is rounded before the w3 product, h1 and h2 are
    # not rounded before their bias (_ln_swiglu_kernel), so the plain
    # version agrees with the interpret-mode kernel to a few bf16 roundings
    args = _swiglu_inputs(np.random.default_rng(9), n=128)
    got = mlp.fused_ln_swiglu(*(torch.from_numpy(a).to(torch.bfloat16) for a in args),
                              eps=1e-6).float().numpy()
    want = np.asarray(jmlp.fused_ln_swiglu(
        *(jnp.asarray(a, jnp.bfloat16) for a in args), eps=1e-6, block_q=128,
        block_h=128, interpret=True).astype(jnp.float32))
    assert np.max(np.abs(got - want)) <= 2e-2 * np.max(np.abs(want))


# ------------------------------------------------------------ kernel I


def _w8_inputs(rng, b=2, n=256, d=128, h=512):
    x, g, bg, w1, b1, w2, b2, _ = _mlp_inputs(rng, b, n, d, h)
    return x, g, bg, w1, b1, w2, b2, rng.uniform(0.5, 1.5, d).astype(np.float32)


def test_quantize_mlp_weights_matches_jax_bit_for_bit():
    _, _, _, w1, b1, w2, b2, _ = _w8_inputs(np.random.default_rng(10))
    want = jmlp.quantize_mlp_weights(*map(jnp.asarray, (w1, b1, w2, b2)))
    got = mlp.quantize_mlp_weights(*_t(w1, b1, w2, b2))
    for g, w in zip(got, want):
        assert g.shape == w.shape and str(g.dtype).endswith(str(w.dtype))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("gelu_approx", [False, True])
def test_ln_mlp_w8_plain_matches_pallas_kernel(gelu_approx):
    # tests/test_mlp.py:83's shapes. Both sides quantize the same f32
    # activations; an LN or erf difference of ~1e-7 can still move a value
    # across a rounding boundary of round(a / s), which moves an output by
    # about amax / 127 * |w| ~ 1e-3 of max|ref|, hence that bound.
    x, g, bg, w1, b1, w2, b2, ls = _w8_inputs(np.random.default_rng(11))
    jq = jmlp.quantize_mlp_weights(*map(jnp.asarray, (w1, b1, w2, b2)))
    want = np.asarray(jmlp.fused_ln_mlp_w8(
        *map(jnp.asarray, (x, g, bg)), *jq, jnp.asarray(ls), eps=1e-6,
        gelu_approx=gelu_approx, block_q=128, interpret=True))
    q = bridge.mlp_w8_from_jax(jq)
    x_, g_, bg_, ls_ = _t(x, g, bg, ls)
    got = mlp.fused_ln_mlp_w8(x_, g_, bg_, *q, ls_, eps=1e-6,
                              gelu_approx=gelu_approx).numpy()
    assert np.max(np.abs(got - want)) <= 1e-3 * np.max(np.abs(want))


def test_cpu_tensors_take_the_plain_swiglu_and_w8_versions_without_a_launch():
    rng = np.random.default_rng(12)
    before = (mlp.fused_ln_swiglu.launches, mlp.fused_ln_mlp_w8.launches)
    sw = _t(*_swiglu_inputs(rng, n=16))
    torch.testing.assert_close(mlp.fused_ln_swiglu(*sw, eps=1e-6),
                               mlp.ln_swiglu_plain(*sw, eps=1e-6), rtol=0, atol=0)
    x, g, bg, w1, b1, w2, b2, ls = _t(*_w8_inputs(rng, n=16))
    w8 = (x, g, bg, *mlp.quantize_mlp_weights(w1, b1, w2, b2), ls)
    torch.testing.assert_close(mlp.fused_ln_mlp_w8(*w8, eps=1e-6),
                               mlp.ln_mlp_w8_plain(*w8, eps=1e-6), rtol=0, atol=0)
    assert (mlp.fused_ln_swiglu.launches, mlp.fused_ln_mlp_w8.launches) == before


def test_swiglu_and_w8_wrappers_raise_on_a_device_without_a_kernel():
    rng = np.random.default_rng(13)
    sw = [t.to("meta") for t in _t(*_swiglu_inputs(rng, n=8))]
    with pytest.raises(ValueError, match="no kernel"):
        mlp.fused_ln_swiglu(*sw, eps=1e-6)
    x, g, bg, w1, b1, w2, b2, ls = _t(*_w8_inputs(rng, n=8))
    w8 = [t.to("meta") for t in (x, g, bg, *mlp.quantize_mlp_weights(w1, b1, w2, b2), ls)]
    with pytest.raises(ValueError, match="no kernel"):
        mlp.fused_ln_mlp_w8(*w8, eps=1e-6)


# ---------------------------------- kernel I's launches, emulated on the CPU


def _transpose_by_tiles(src):
    """transpose_s8_kernel's 64 x 64 tiles, with its block indexing."""
    r, c = src.shape
    dst = torch.empty(c, r, dtype=src.dtype)
    for bx in range(r * c // 4096):
        r0, c0 = bx // (c // 64) * 64, bx % (c // 64) * 64
        dst[c0:c0 + 64, r0:r0 + 64] = src[r0:r0 + 64, c0:c0 + 64].t()
    return dst


def _gemm_s8(a, bt):
    """gemm_s8_kernel's int32 sums, one 128-deep stage at a time: A (M, K)
    against Bt (N, K), both K-major."""
    acc = torch.zeros(a.shape[0], bt.shape[0], dtype=torch.int64)
    for k0 in range(0, a.shape[1], 128):
        acc += a[:, k0:k0 + 128].long() @ bt[:, k0:k0 + 128].long().t()
    assert acc.abs().max() < 2 ** 31  # the kernel's int32 accumulators
    return acc.int()


def _row_scale(amax):
    return torch.clamp_min(amax / 127.0, 1e-12)


def _quantize(a, s):
    return torch.clamp(torch.round(a / s), -127, 127).to(torch.int8)


def _emulate_w8_launches(x, g, bg, w1q, w1s, b1, w2q, w2s, b2, ls, *, eps, gelu_approx,
                         rng):
    """pt_ln_mlp_w8's five launches in torch: the weights transposed, LN
    and quantize rows, fc1 storing the f32 hidden and folding |h| into the
    row amax by 128-column blocks as a max over float bits (blocks in a
    random order, as atomics land), the hidden quantized, fc2."""
    d, h = w1q.shape
    rows = x.reshape(-1, d)
    w1t, w2t = _transpose_by_tiles(w1q), _transpose_by_tiles(w2q)
    # ln_quant_rows_kernel: f64 statistics rounded to f32 once
    xf = rows.float()
    mu = (xf.double().sum(-1, keepdim=True) / d).float()
    c = xf - mu
    eps32 = torch.tensor(eps, dtype=torch.float32).item()
    rstd = (1.0 / torch.sqrt((c.double() ** 2).sum(-1, keepdim=True) / d + eps32)).float()
    y = c * rstd * g.float() + bg.float()
    sy = _row_scale(y.abs().amax(-1, keepdim=True))
    xq = _quantize(y, sy)
    # W8Fc1Epilogue: the f32 hidden, and its row amax a 128-column block at
    # a time
    hidden = F.gelu(_gemm_s8(xq, w1t).float() * sy * w1s.reshape(-1) + b1,
                    approximate="tanh" if gelu_approx else "none")
    bits = hidden.abs().view(torch.int32).reshape(len(rows), h // 128, 128).amax(-1)
    amax = torch.zeros(len(rows), dtype=torch.int32)  # zeroed by the LN launch
    for blk in rng.permutation(h // 128):
        amax = torch.maximum(amax, bits[:, blk])
    # quant_hidden_kernel, then fc2
    sh = _row_scale(amax.view(torch.float32)[:, None])
    hq = _quantize(hidden, sh)
    o = _gemm_s8(hq, w2t).float() * sh * w2s.reshape(-1) + b2
    return x + (o * ls.float()).reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("case", ["rows_512", "ragged_rows_400", "zero_row"])
def test_ln_mlp_w8_launches_match_plain_and_pallas(case, gelu_approx):
    # bit-exact against the plain version (the same f32 steps, int32 sums
    # exact in any order and amax order-free), and within 1e-3 of
    # max|ref| of the Pallas kernel as the plain test above; 400 rows are
    # ragged against the 128-row GEMM tile; the zero row, with zero LN and
    # MLP biases, quantizes zeros at the 1e-12 floor of both scales
    n = 200 if case == "ragged_rows_400" else 256
    rng = np.random.default_rng(14)
    x, g, bg, w1, b1, w2, b2, ls = _w8_inputs(rng, n=n)
    if case == "zero_row":
        x[1, 5], bg[:], b1[:], b2[:] = 0.0, 0.0, 0.0, 0.0
    jq = jmlp.quantize_mlp_weights(*map(jnp.asarray, (w1, b1, w2, b2)))
    q = bridge.mlp_w8_from_jax(jq)
    x_, g_, bg_, ls_ = _t(x, g, bg, ls)
    kw = dict(eps=1e-6, gelu_approx=gelu_approx)
    got = _emulate_w8_launches(x_, g_, bg_, *q, ls_, **kw, rng=rng)
    plain = mlp.ln_mlp_w8_plain(x_, g_, bg_, *q, ls_, **kw)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    want = np.asarray(jmlp.fused_ln_mlp_w8(
        *map(jnp.asarray, (x, g, bg)), *jq, jnp.asarray(ls), **kw, block_q=n,
        interpret=True))
    assert np.max(np.abs(got.numpy() - want)) <= 1e-3 * np.max(np.abs(want))
    if case == "zero_row":  # o = 0 there, so out is x's zero row
        assert not got[1, 5].any()
