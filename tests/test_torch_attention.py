"""Port's fused-qkv attention (kernel B) plain version against the JAX
package's Pallas kernel in interpret mode, padded keys masked by
num_real_k, and against the plain reference attention."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from patchioner_tpu.ops import attention as jattn
from patchioner_tpu_torch.ops import attention

# f32 on both sides; exact softmax both ways, sums in another order
TOL = 2e-5


@pytest.mark.parametrize("heads", [2, 4])
def test_plain_matches_pallas_fused_qkv_with_padded_keys(heads):
    rng = np.random.default_rng(heads)
    b, n, hd = 2, 128, 64
    qkv = rng.standard_normal((b, n, 3 * heads * hd)).astype(np.float32)
    want = jattn.fused_qkv_attention(jnp.asarray(qkv), num_heads=heads,
                                     scale=0.125, num_real_k=100, block_q=128,
                                     interpret=True)
    got = attention.fused_qkv_attention(torch.from_numpy(qkv), num_heads=heads,
                                        scale=0.125, num_real_k=100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_plain_matches_reference_attention_on_a_ragged_length():
    rng = np.random.default_rng(7)
    b, n, heads, hd = 2, 77, 3, 64
    qkv = rng.standard_normal((b, n, 3 * heads * hd)).astype(np.float32)
    q, k, v = (jnp.asarray(qkv).reshape(b, n, 3, heads, hd)[:, :, i]
               .transpose(0, 2, 1, 3) for i in range(3))
    want = jattn.attention_reference(q, k, v, scale=0.125)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b, n, heads * hd)
    got = attention.fused_qkv_attention(torch.from_numpy(qkv), num_heads=heads,
                                        scale=0.125)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_wrapper_raises_on_a_device_without_a_kernel():
    qkv = torch.zeros(1, 8, 3 * 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        attention.fused_qkv_attention(qkv, num_heads=2, scale=0.125)


# J, K and F against their Pallas kernels (interpret mode) on a ragged
# token count. f32: JAX's own tolerance for F (tests/test_attention.py);
# bf16: max|d| / max|ref|, since a different f32 summation order can move a
# value across a bf16 rounding boundary (2^-8 relative) a few times.
BF16_REL = 2e-2
F32_TOL = 2e-4
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert np.max(np.abs(got - want)) <= BF16_REL * np.max(np.abs(want))


def _both(a, dtype):
    """A numpy array as the same values in JAX and torch, in `dtype`."""
    _, jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", ["flash", "flash1p"])
def test_flash_plain_matches_pallas_on_a_ragged_length(kernel, dtype):
    rng = np.random.default_rng(11)
    b, heads, n, hd = 2, 3, 130, 64
    (jq, q), (jk, k), (jv, v) = (_both(rng.standard_normal((b, heads, n, hd))
                                       .astype(np.float32), dtype) for _ in range(3))
    if kernel == "flash":  # two key blocks: the online rescale runs
        want = jattn.flash_attention(jq, jk, jv, scale=0.125, block_q=128,
                                     block_k=128, interpret=True)
        got = attention.flash_attention(q, k, v, scale=0.125)
    else:
        want = jattn.flash_attention_1pass(jq, jk, jv, scale=0.125, block_q=128,
                                           interpret=True)
        got = attention.flash_attention_1pass(q, k, v, scale=0.125)
    _close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("heads", [4, 6])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qkv_attention_proj_plain_matches_pallas(dtype, heads):
    # the Pallas kernel needs N % 128 == 0: it runs on 256 tokens whose last
    # 126 are garbage keys masked by num_real_k; the port runs on the 130
    # real tokens alone, with no padding. Six heads: three head pairs, D = 384
    rng = np.random.default_rng(12)
    b, n, hd = 2, 130, 64
    d = heads * hd
    qkv = rng.standard_normal((b, 256, 3 * d)).astype(np.float32)
    x = rng.standard_normal((b, 256, d)).astype(np.float32)
    w = (rng.standard_normal((d, d)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(d) * 0.1).astype(np.float32)
    ls = rng.uniform(0.5, 1.5, d).astype(np.float32)
    (jqkv, tqkv), (jx, tx), (jw, tw), (jb, tb), (jls, tls) = (
        _both(a, dtype) for a in (qkv, x, w, bias, ls))
    want = jattn.fused_qkv_attention_proj(
        jqkv, jx, jw, jb, jls, num_heads=heads, scale=hd ** -0.5, num_real_k=n,
        block_q=128, interpret=True)[:, :n]
    got = attention.fused_qkv_attention_proj(
        tqkv[:, :n].contiguous(), tx[:, :n].contiguous(), tw, tb, tls,
        num_heads=heads, scale=hd ** -0.5)
    _close(got, want.astype(jnp.float32), dtype)


def test_qkv_attention_proj_plain_rounds_each_head_then_sums_in_f32():
    # in bf16, F's plain version is not B followed by E: the out-projection
    # sums in f32 and rounds once, where E rounds after each step
    from patchioner_tpu_torch.ops import mlp

    rng = np.random.default_rng(13)
    d = 128
    qkv, x = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
              for s in ((1, 40, 3 * d), (1, 40, d)))
    w = torch.from_numpy((rng.standard_normal((d, d)) * 0.1).astype(np.float32)).bfloat16()
    bias, ls = torch.full((d,), 0.1).bfloat16(), torch.full((d,), 0.7).bfloat16()
    merged = attention.qkv_attention_plain(qkv, num_heads=2, scale=0.125)
    got = attention.fused_qkv_attention_proj(qkv, x, w, bias, ls, num_heads=2,
                                             scale=0.125)
    want = (x.float() + (merged.float() @ w.float() + bias.float()) * ls.float()).bfloat16()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, mlp.dense_residual_plain(merged, x, w, bias, ls))


def test_flash_wrappers_raise_on_a_device_without_a_kernel():
    q = torch.zeros(1, 2, 8, 32, device="meta")
    for fn in (attention.flash_attention, attention.flash_attention_1pass):
        with pytest.raises(ValueError, match="no kernel"):
            fn(q, q, q, scale=0.125)
