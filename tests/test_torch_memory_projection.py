"""Port's support-memory projection (kernel D) plain version against the
JAX package's Pallas kernel (interpret mode) and its XLA path, on a bank
the JAX package padded to block_m, with padded rows present."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from patchioner_tpu.ops import memory_projection as jmp
from patchioner_tpu_torch.io import bridge
from patchioner_tpu_torch.ops import memory_projection as mp

# f32 both sides. T = 0.01 scales cosines to logits near +-100, so a 1e-7
# cosine difference becomes 1e-5 in a logit and in the softmax weights.
TOL = 5e-5


def _data(seed=0, b=5, m=200, d=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


@pytest.mark.parametrize("normalize", [True, False])
def test_plain_matches_pallas_and_xla_on_a_padded_bank(normalize):
    feats, rows = _data()
    jbank = jmp.prepare_bank(jnp.asarray(rows), block_m=128)
    assert jbank.rows.shape[0] == 256 and jbank.num_real == 200
    pallas = jmp.memory_project_pallas(jnp.asarray(feats), jbank, normalize=normalize,
                                       block_m=128, interpret=True)
    xla = jmp.memory_project_xla(jnp.asarray(feats), jnp.asarray(rows),
                                 normalize=normalize)
    got = mp.memory_project_streamed(torch.from_numpy(feats),
                                     bridge.bank_from_jax(jbank),
                                     normalize=normalize).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=TOL, atol=TOL)


def test_prepare_bank_matches_jax_layout():
    # the port does not pad: its bank is the JAX bank's first num_real rows
    _, rows = _data(1)
    jbank = jmp.prepare_bank(jnp.asarray(rows), block_m=128)
    bank = mp.prepare_bank(torch.from_numpy(rows))
    assert bank.num_real == jbank.num_real == bank.rows.shape[0] == 200
    np.testing.assert_array_equal(bank.rows.numpy(), np.asarray(jbank.rows)[:200])
    np.testing.assert_allclose(bank.inv_norm.numpy(), np.asarray(jbank.inv_norm)[:200],
                               rtol=1e-6)
    assert mp.prepare_bank(torch.from_numpy(rows), dtype=torch.bfloat16).rows.dtype \
        == torch.bfloat16


def test_padded_rows_are_masked_not_scored_zero():
    # features anti-aligned with every real row: a zero padding row would
    # win the softmax (cosine 0 > -1) if it were not masked
    rows = np.tile(np.eye(1, 16, dtype=np.float32), (10, 1))
    feats = -np.eye(1, 16, dtype=np.float32)
    real = mp.prepare_bank(torch.from_numpy(rows))
    bank = mp.PreparedBank(torch.cat([real.rows, torch.zeros(6, 16)]),
                           torch.cat([real.inv_norm, torch.zeros(6, 1)]), 10)
    out = mp.memory_project_streamed(torch.from_numpy(feats), bank, normalize=True)
    np.testing.assert_allclose(out.numpy(), rows[:1], atol=1e-6)


# ------------------------------------------------- kernel H (int8 bank)


def test_quantize_bank_matches_jax():
    # the JAX bank is padded to block_m; the port's is its first num_real rows
    _, rows = _data(2, m=300)
    jq = jmp.quantize_bank(jnp.asarray(rows))
    q = mp.quantize_bank(torch.from_numpy(rows), chunk_rows=128)  # three chunks
    assert q.num_real == jq.num_real == q.rows.shape[0] == 300 and q.rows.dtype == torch.int8
    np.testing.assert_array_equal(q.rows.numpy(), np.asarray(jq.rows)[:300])
    np.testing.assert_allclose(q.scale.numpy(), np.asarray(jq.scale)[:300], rtol=1e-6)
    np.testing.assert_allclose(q.inv_norm.numpy(), np.asarray(jq.inv_norm)[:300], rtol=1e-6)


@pytest.mark.parametrize("normalize", [True, False])
def test_int8_plain_matches_the_pallas_int8_kernel(normalize):
    # H scores with the ORIGINAL rows' inverse norms; so does the port. The
    # JAX package's CPU dispatcher renormalises the dequantized rows instead
    # (ROADMAP section 3), so the oracle is the kernel in interpret mode.
    feats, rows = _data(3, m=300)
    jq = jmp.quantize_bank(jnp.asarray(rows))
    want = np.asarray(jmp.memory_project_int8(jnp.asarray(feats), jq, normalize=normalize,
                                              interpret=True))
    bridged = bridge.bank_from_jax(jq)
    assert isinstance(bridged, mp.QuantizedBank) and bridged.rows.shape[0] == 1024
    before = mp.memory_project_int8.launches
    got = mp.memory_project_int8(torch.from_numpy(feats), bridged, normalize=normalize)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    own = mp.memory_project_int8(torch.from_numpy(feats), mp.quantize_bank(
        torch.from_numpy(rows)), normalize=normalize)
    np.testing.assert_allclose(own.numpy(), want, rtol=2e-4, atol=2e-5)
    assert mp.memory_project_int8.launches == before  # the CPU takes the plain version


# ------------------------------------- kernel D's bf16 tensor-core arithmetic


def _bf16_pieces(x: torch.Tensor, split: bool):
    """x as the bf16 operand pieces the kernel feeds the tensor cores: hi =
    bf16(x) and lo = bf16(x - hi) with `split`, else hi alone."""
    hi = x.to(torch.bfloat16).float()
    return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)


def _s8_pieces(x: torch.Tensor):
    """x (|x| <= 1) as the kernel's three int8 pieces with their weights:
    x = (p0 + p1 / 254 + p2 / 254^2) / 127 (csrc/memory_projection.cu,
    split_s8)."""
    r, pieces, w = x.double(), [], 1 / 127
    for m in (127.0, 254.0, 254.0):
        n = torch.round(r * m)
        r = r * m - n
        pieces.append((n.float(), w))
        w /= 254
    return pieces


def _emulate_bf16_kernel(feats, bank, *, temperature, normalize, blocks, split_f=True,
                         split_p=True, tile=mp.ROW_TILE):
    """The tensor-core kernel's arithmetic (csrc/memory_projection.cu) in
    plain torch: `blocks` ranges of whole `tile`-row tiles (the last ones
    empty), each an online softmax in f32 whose two products take f and the
    weights as two bf16 pieces (exact bf16 products summed in f32, as the
    tensor cores do; one piece without `split_f` / `split_p`); then the
    combine of the partial (max, denom, acc). A `QuantizedBank` (kernel H)
    feeds its int8 rows as they are, scores them against f's three int8
    pieces (exact integer products), folds its per-row scale into each
    row's score factor and into the weight before the split, and sums the
    unscaled weights in the denominator."""
    n = bank.num_real
    rows, inv = bank.rows.float(), bank.inv_norm.float()
    int8 = isinstance(bank, mp.QuantizedBank)
    scale = bank.scale.float() if int8 else torch.ones_like(inv)
    f = feats.float() / torch.linalg.vector_norm(feats.float(), dim=-1, keepdim=True)
    f_pieces = _s8_pieces(f) if int8 else [(p, 1.0) for p in _bf16_pieces(f, split_f)]
    chunk = -(-n // (blocks * tile)) * tile
    parts = []
    for c0 in range(0, blocks * chunk, chunk):
        c1 = min(c0 + chunk, n)
        m = torch.full((f.shape[0], 1), -1e30)
        l = torch.zeros(f.shape[0], 1)
        acc = torch.zeros_like(f)
        for r0 in range(c0, c1, tile):
            r, sc_r = rows[r0:r0 + tile], scale[r0:r0 + tile].T
            dot = sum((piece @ r.T) * w for piece, w in f_pieces)
            live = torch.arange(r0, r0 + r.shape[0]) < c1
            s = torch.where(live, dot * inv[r0:r0 + tile].T * sc_r / temperature,
                            torch.tensor(-1e30))
            m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
            sc, p = torch.exp(m - m_new), torch.exp(s - m_new)
            l = l * sc + p.sum(dim=1, keepdim=True)
            acc = acc * sc + sum(piece @ r for piece in _bf16_pieces(p * sc_r, split_p))
            m = m_new
        parts.append((m, l, acc))
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    return mp.combine_partials_plain(m[..., 0], l[..., 0], acc, normalize=normalize)


@pytest.mark.parametrize("split_f", [True, False])
def test_bf16_kernel_arithmetic_matches_the_pallas_kernel(split_f):
    # a bf16 bank of 203 rows padded to 256 by the JAX package; 40 ranges of
    # 16 rows, so 13 hold rows (the last one 11) and 27 are empty. Both sides
    # read the same bf16 rows. With f and P each split in two bf16 pieces
    # the kernel's arithmetic stays within the 1e-4 gate of the f32
    # reference; one bf16 rounding of f (logits are cosines x 100) exceeds it.
    feats, rows = _data(4, b=8, m=203, d=256)
    jbank = jmp.prepare_bank(jnp.asarray(rows).astype(jnp.bfloat16), block_m=128)
    want = np.asarray(jmp.memory_project_pallas(jnp.asarray(feats), jbank, normalize=True,
                                                block_m=128, interpret=True))
    bank = bridge.bank_from_jax(jbank)
    assert bank.rows.dtype == torch.bfloat16 and bank.rows.shape[0] == 256
    got = _emulate_bf16_kernel(torch.from_numpy(feats), bank, normalize=True,
                               temperature=mp.DEFAULT_TEMPERATURE, blocks=40,
                               split_f=split_f).numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    if split_f:
        assert rel <= 1e-4, rel
    else:
        assert rel > 1e-4, rel


# ---------------------------------- kernel H's int8 tensor-core arithmetic


def _wide_scale_rows(seed=5, m=203, d=256):
    """Rows whose norms (so int8 scales) spread over six decades, 1e-3 to
    1e3, and a row of +-3 whose every element quantizes to +-127."""
    feats, rows = _data(seed, b=8, m=m, d=d)
    rows *= np.logspace(-3, 3, m, dtype=np.float32)[:, None]
    rows[7] = np.where(np.arange(d) % 2, 3.0, -3.0)
    return feats, rows


@pytest.mark.parametrize("normalize,split_p", [(True, True), (False, True), (True, False)])
def test_int8_kernel_arithmetic_matches_the_pallas_kernel(normalize, split_p):
    # H on the tensor-core body: int8 rows scored exactly against f's three
    # int8 pieces, fed as exact bf16 to the weights' product with p * scale
    # split in two bf16 pieces, 40 ranges of 16-row tiles (13 hold rows),
    # against the Pallas int8 kernel on the bank the JAX package quantized
    # and padded to 1024 rows. With p * scale in one bf16 piece the error
    # grows past the split's.
    feats, rows = _wide_scale_rows()
    jq = jmp.quantize_bank(jnp.asarray(rows))
    bank = bridge.bank_from_jax(jq)
    assert bank.rows.shape[0] == 1024 and np.abs(bank.rows[7].numpy()).min() == 127
    scales = bank.scale[:203].numpy()
    assert scales.max() / scales.min() > 1e5
    want = np.asarray(jmp.memory_project_int8(jnp.asarray(feats), jq, normalize=normalize,
                                              interpret=True))

    def rel(split):
        got = _emulate_bf16_kernel(torch.from_numpy(feats), bank, normalize=normalize,
                                   temperature=mp.DEFAULT_TEMPERATURE, blocks=40,
                                   split_p=split).numpy()
        return np.abs(got - want).max() / np.abs(want).max()

    split_err = rel(True)
    assert split_err <= 1e-4, split_err
    if not split_p:
        assert rel(False) > split_err


def test_combine_partials_plain_matches_jax():
    # 5 partials of 3 batch rows, two of them empty ranges (max -1e30,
    # denominator 0, accumulators 0), as the kernels' blocks write them
    rng = np.random.default_rng(6)
    m = rng.normal(0, 20, (5, 3)).astype(np.float32)
    l = rng.uniform(1, 4, (5, 3)).astype(np.float32)
    acc = rng.normal(size=(5, 3, 64)).astype(np.float32)
    m[[1, 3]], l[[1, 3]], acc[[1, 3]] = -1e30, 0.0, 0.0
    for normalize in (True, False):
        want = jmp.combine_partials(
            jmp.PartialProjection(jnp.asarray(m[..., None]), jnp.asarray(l[..., None]),
                                  jnp.asarray(acc)), normalize=normalize)
        before = mp.combine_partials.launches
        got = mp.combine_partials(*(torch.from_numpy(a) for a in (m, l, acc)),
                                  normalize=normalize)
        assert mp.combine_partials.launches == before  # the CPU takes the plain version
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_int8_pieces_of_f_are_bytes_within_6e8():
    # H's three int8 pieces of a unit-norm f: each within +-127, and f
    # back from them to 6.1e-8 (half the last piece's step, 1 / (127 254^2))
    rng = np.random.default_rng(7)
    f = torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32))
    f = torch.cat([f / torch.linalg.vector_norm(f, dim=-1, keepdim=True),
                   torch.tensor([[1.0, -1.0, 0.5 / 127, -0.5 / 127] + [0.0] * 764])])
    pieces = _s8_pieces(f)
    assert max(p.abs().max().item() for p, _ in pieces) <= 127
    back = sum(p.double() * w for p, w in pieces)
    assert (back - f.double()).abs().max().item() <= 0.5 / (127 * 254 * 254) * 1.001
