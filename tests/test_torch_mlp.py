"""Port's LN+dense (kernel A) and LN+MLP (kernel C) plain versions against
the JAX package's Pallas kernels (interpret mode) and plain references.

On the CPU the wrappers run their plain versions; inputs are seeded numpy
arrays handed to both packages at f32.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from patchioner_tpu.models import vit as jvit
from patchioner_tpu.ops import mlp as jmlp
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
