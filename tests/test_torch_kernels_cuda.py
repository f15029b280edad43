"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA card (a CUDA kernel has no CPU mode) and skip
without one. This file imports no JAX, so on a machine without it run it
without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance: max |kernel - plain| over max |plain| (as chip_smoke.py): 1e-4
at float32, where only the order of f32 sums differs, and 2e-2 at
bfloat16, where that order can move a value across bf16 rounding
boundaries (2^-8 relative each). The W8A8 MLP (I) takes 1e-3 at float32:
an f32 difference of one ulp in LN(x) or GELU can move an activation
across a rounding boundary of its int8 quantization, which moves an
output by about amax / 127 * |w|.

The DeCap decode's CUDA graph (`decap.GreedyDecoder`) is held against the
eager loop, its plain version: the graph replays the loop's own launches,
so the tokens must be equal and the scores within 1e-6 (f32) and 1e-3
(bf16) relative; a row count shares its power-of-two bucket's graph, and
the graphs kept stay one a bucket. One decoder training step on the card
(kernel D's --im_proj step, and the packed step) is held against the
same step on the CPU under chip_smoke's f32 gate.

The argmax-text and n-best modes' `memory_argmax` and `memory_topk_sims`
(plain torch, no kernel) run on the card as on the CPU: the top-5
similarities within 1e-5, the argmax equal wherever the CPU's top-2 gap
exceeds 1e-5. Kernel D at unit norm at a flagship batch's 10,952 patch
rows (the context cleaner's projection) holds D's bound.

A CLIP-backbone DeCap model (the tower plain torch, kernel D over a
512-wide bank) runs `forward` on the card as on the CPU in f32, and so do
RegionCLIP (cuDNN's TF32 off), ProxyCLIP (its VFM on A, B and C) and
DINO.txt's ViT-L (A, B, C at D = 1024 and D over a 1024-wide bank).

ViECap's searches (plain torch, no kernel) run on the card as on the CPU:
on a small f32 GPT-2 whose wte is scaled so that no step is a near-tie,
the batched beam search equals the per-image one, and every search's
tokens equal the CPU's. So do ClipCap's sampler, given the same Gumbel
noise drawn on the CPU, and MeaCap's retrieval, hard prompts and greedy
sentences.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from patchioner_tpu_torch import entry
from patchioner_tpu_torch.models import clipcap, decap, gpt2, meacap, viecap, vit
from patchioner_tpu_torch.ops import attention, memory_projection as mp, mlp

pytestmark = pytest.mark.cuda

TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _check(got, ref, dtype, tol=None):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= (tol or TOLERANCE[dtype]) * ref.float().abs().max().item()


def _counted(wrapper, call):
    before = wrapper.launches
    out = call()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,o", [(128, 384), (128, 320),
                                 (768, 2304), (1536, 4608)])  # flagship, giant
def test_ln_dense_kernel(cuda, dtype, d, o):
    # 154 rows: one full 128-row GEMM tile and a ragged one
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = _randn(gen, 2, 77, d, dtype=dtype)
    args = (x, 1 + _randn(gen, d, dtype=dtype, scale=0.1),
            _randn(gen, d, dtype=dtype, scale=0.1),
            _randn(gen, d, o, dtype=dtype, scale=d ** -0.5),
            _randn(gen, o, dtype=dtype, scale=0.1))
    if dtype == torch.bfloat16 and o % 128:  # the tensor-core tile's width
        with pytest.raises(ValueError, match="O % 128"):
            mlp.fused_ln_dense(*args, eps=1e-6)
        return
    got = _counted(mlp.fused_ln_dense, lambda: mlp.fused_ln_dense(*args, eps=1e-6))
    _check(got, mlp.ln_dense_plain(*args, eps=1e-6), dtype)


@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [256, 96, 768])
def test_ln_mlp_kernel(cuda, dtype, d, gelu_approx):
    # 154 rows: one full 128-row GEMM tile and a ragged one; d = 768 is the
    # flagship's width (H = 3072)
    gen = torch.Generator(device="cuda").manual_seed(1)
    h = 4 * d
    args = (_randn(gen, 2, 77, d, dtype=dtype), 1 + _randn(gen, d, dtype=dtype, scale=0.1),
            _randn(gen, d, dtype=dtype, scale=0.1),
            _randn(gen, d, h, dtype=dtype, scale=d ** -0.5),
            _randn(gen, h, dtype=dtype, scale=0.1),
            _randn(gen, h, d, dtype=dtype, scale=h ** -0.5),
            _randn(gen, d, dtype=dtype, scale=0.1),
            1 + _randn(gen, d, dtype=dtype, scale=0.1))  # per-channel layerscale
    if dtype == torch.bfloat16 and d % 128:  # the wgmma GEMM tiles are 128 wide
        with pytest.raises(ValueError, match="D % 128"):
            mlp.fused_ln_mlp(*args, eps=1e-6)
        return
    kw = dict(eps=1e-6, gelu_approx=gelu_approx)
    got = _counted(mlp.fused_ln_mlp, lambda: mlp.fused_ln_mlp(*args, **kw))
    _check(got, mlp.ln_mlp_plain(*args, **kw), dtype)


@pytest.mark.parametrize("d", [768, 1024])
def test_ln_mlp_f32_kernel_at_the_flagship_and_vit_l_width(cuda, d):
    # C's f32 SIMT body: 24 columns a thread for D <= 768 (the flagship's
    # instantiation), 32 with W2 staged 8 rows at a time up to D = 1024
    # (ViT-L); 154 rows, a ragged last block of 32
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, dtype = 4 * d, torch.float32
    args = (_randn(gen, 2, 77, d, dtype=dtype), 1 + _randn(gen, d, dtype=dtype, scale=0.1),
            _randn(gen, d, dtype=dtype, scale=0.1),
            _randn(gen, d, h, dtype=dtype, scale=d ** -0.5),
            _randn(gen, h, dtype=dtype, scale=0.1),
            _randn(gen, h, d, dtype=dtype, scale=h ** -0.5),
            _randn(gen, d, dtype=dtype, scale=0.1),
            1 + _randn(gen, d, dtype=dtype, scale=0.1))
    got = _counted(mlp.fused_ln_mlp, lambda: mlp.fused_ln_mlp(*args, eps=1e-6))
    _check(got, mlp.ln_mlp_plain(*args, eps=1e-6), dtype)
    w = 1056  # past the widest instantiation: refused, never launched
    wide = [_randn(gen, *shape, dtype=dtype) for shape in
            ((1, 32, w), (w,), (w,), (w, 128), (128,), (128, w), (w,), (w,))]
    before = mlp.fused_ln_mlp.launches
    with pytest.raises(ValueError, match="D <= 1024"):
        mlp.fused_ln_mlp(*wide, eps=1e-6)
    assert mlp.fused_ln_mlp.launches == before


# N = 200 and 1374 are ragged against the 128-query and the 64-key tiles of
# B and K; num_real_k < N masks keys inside the last tiles
EDGES = [(200, 150), (1374, 1369)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,num_real_k,heads", [(77, None, 2), (128, 100, 2)] +
                         [(n, nrk, 12) for n, nrk in EDGES])
def test_qkv_attention_kernel(cuda, dtype, n, num_real_k, heads):
    gen = torch.Generator(device="cuda").manual_seed(2)
    qkv = _randn(gen, 2, n, 3 * heads * 64, dtype=dtype)  # the fused layout
    kw = dict(num_heads=heads, scale=0.125, num_real_k=num_real_k)
    got = _counted(attention.fused_qkv_attention,
                   lambda: attention.fused_qkv_attention(qkv, **kw))
    _check(got, attention.qkv_attention_plain(qkv, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,o", [(128, 256), (128, 320),
                                 (768, 768), (1536, 1536)])  # flagship, giant
def test_dense_residual_kernel(cuda, dtype, d, o):
    # 154 rows: one full 128-row GEMM tile and a ragged one
    gen = torch.Generator(device="cuda").manual_seed(6)
    args = (_randn(gen, 2, 77, d, dtype=dtype), _randn(gen, 2, 77, o, dtype=dtype),
            _randn(gen, d, o, dtype=dtype, scale=d ** -0.5),
            _randn(gen, o, dtype=dtype, scale=0.1),
            1 + _randn(gen, o, dtype=dtype, scale=0.1))  # per-channel layerscale
    if dtype == torch.bfloat16 and o % 128:  # the tensor-core tile's width
        with pytest.raises(ValueError, match="O % 128"):
            mlp.fused_dense_residual(*args)
        return
    got = _counted(mlp.fused_dense_residual, lambda: mlp.fused_dense_residual(*args))
    _check(got, mlp.dense_residual_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,num_real_k,heads", [
    (n, nrk, h) for h in (4, 3) for n, nrk in ((77, None), (130, 100))] + [
    (1374, 1369, 12), (1374, 1369, 24), (200, 150, 24)])  # flagship, giant heads
def test_qkv_attention_proj_kernel(cuda, dtype, heads, n, num_real_k):
    gen = torch.Generator(device="cuda").manual_seed(7)
    d = heads * 64
    args = (_randn(gen, 2, n, 3 * d, dtype=dtype), _randn(gen, 2, n, d, dtype=dtype),
            _randn(gen, d, d, dtype=dtype, scale=d ** -0.5),
            _randn(gen, d, dtype=dtype, scale=0.1),
            1 + _randn(gen, d, dtype=dtype, scale=0.1))
    kw = dict(num_heads=heads, scale=0.125, num_real_k=num_real_k)
    if dtype == torch.bfloat16 and heads % 2:  # the GEMM's 128-wide tiles of D
        with pytest.raises(ValueError, match="D % 128"):
            attention.fused_qkv_attention_proj(*args, **kw)
        return
    got = _counted(attention.fused_qkv_attention_proj,
                   lambda: attention.fused_qkv_attention_proj(*args, **kw))
    _check(got, attention.qkv_attention_proj_plain(*args, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,num_real_k,heads", [
    (77, None, 3), (130, 100, 3)] + [(n, nrk, 3) for n, nrk in EDGES] + [
    (1374, 1369, 12),  # the flagship's heads
    (3000, 2990, 3),   # above J's old cap of 2432 keys
    (3300, None, 3)])  # above J's float32 cap (FLASH1P_F32_MAX_N)
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_1pass"])
def test_flash_attention_kernels(cuda, dtype, n, num_real_k, heads, name):
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (_randn(gen, 2, heads, n, 64, dtype=dtype) for _ in range(3))
    wrapper = getattr(attention, name)
    kw = dict(scale=0.125, num_real_k=num_real_k)
    if (name == "flash_attention_1pass" and dtype == torch.float32
            and n > attention.FLASH1P_F32_MAX_N):  # the f32 kernel's logit rows
        with pytest.raises(ValueError, match="float32"):
            wrapper(q, k, v, **kw)
        return
    got = _counted(wrapper, lambda: wrapper(q, k, v, **kw))
    _check(got, attention.attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_memory_project_kernel(cuda, dtype, normalize):
    # 5000 rows: three 2048-row ranges combined in f32, one wave of 16-row
    # ranges in bf16; 11 features: two batch tiles; a zero tail as a bank
    # padded by the JAX package has, masked by num_real. Both sides read the
    # same rows and compute in f32 (bf16 with f and P split in two bf16
    # pieces): the f32 bound holds.
    gen = torch.Generator(device="cuda").manual_seed(3)
    real = mp.prepare_bank(torch.randn(5000, 128, generator=gen, device="cuda"),
                           dtype=dtype)
    bank = mp.PreparedBank(
        torch.cat([real.rows, real.rows.new_zeros(120, 128)]),
        torch.cat([real.inv_norm, real.inv_norm.new_zeros(120, 1)]), 5000)
    feats = torch.randn(11, 128, generator=gen, device="cuda")
    got = _counted(mp.memory_project_streamed,
                   lambda: mp.memory_project_streamed(feats, bank, normalize=normalize))
    _check(got, mp.memory_project_plain(feats, bank, normalize=normalize),
           torch.float32)


@pytest.mark.parametrize("bank_rows", ["ragged", "short"])
@pytest.mark.parametrize("b", [1, 8, 11, 48, 80, 125, 128])
@pytest.mark.parametrize("d", [128, 768, 1536])
def test_memory_project_bf16_kernel(cuda, d, b, bank_rows):
    # D's tensor-core body. "ragged": 5003 real rows (a multiple of neither
    # the 16-row tile nor a block's range) and a zero tail of 125 rows
    # masked by num_real; "short": 37 rows, fewer than the grid's blocks, so
    # most ranges are empty. 11 features: a second batch tile of 3; 48, 80
    # and 128: a served box batch of 3, 5 and 8 images x 16 boxes, 6 to 16
    # batch tiles; 125: a ragged last tile.
    gen = torch.Generator(device="cuda").manual_seed(13)
    n = 5003 if bank_rows == "ragged" else 37
    real = mp.prepare_bank(torch.randn(n, d, generator=gen, device="cuda"),
                           dtype=torch.bfloat16)
    bank = mp.PreparedBank(torch.cat([real.rows, real.rows.new_zeros(125, d)]),
                           torch.cat([real.inv_norm, real.inv_norm.new_zeros(125, 1)]), n)
    feats = torch.randn(b, d, generator=gen, device="cuda")
    for normalize in (True, False):
        got = _counted(mp.memory_project_streamed,
                       lambda: mp.memory_project_streamed(feats, bank, normalize=normalize))
        _check(got, mp.memory_project_plain(feats, bank, normalize=normalize),
               torch.float32)


def test_memory_project_bf16_kernel_at_a_batch_of_patch_rows(cuda):
    # a flagship batch's patch rows (8 x 1369 = 10,952), as `forward`'s
    # context cleaning projects them: at unit norm, over a 50,000-row bf16
    # bank (the plain version's (rows, bank) f32 matrices must fit twice)
    gen = torch.Generator(device="cuda").manual_seed(23)
    bank = mp.prepare_bank(torch.randn(50000, 768, generator=gen, device="cuda"),
                           dtype=torch.bfloat16)
    feats = torch.randn(8 * 1369, 768, generator=gen, device="cuda")
    got = _counted(mp.memory_project_streamed,
                   lambda: mp.memory_project_streamed(feats, bank, normalize=True))
    _check(got, mp.memory_project_plain(feats, bank, normalize=True), torch.float32)


@pytest.mark.parametrize("chunk_rows", [None, 7])
def test_memory_argmax_and_topk_sims_card_vs_cpu(cuda, chunk_rows, monkeypatch):
    # plain torch on both devices (no kernel): the card's f32 products (TF32
    # off) against the CPU's. The top-5 similarities within 1e-5; the argmax
    # equal on every row whose CPU top-2 gap exceeds 1e-5 (a row inside it
    # may take the other index on another summation order); duplicated
    # rows are an exact tie, which takes the lower index on both
    gen = torch.Generator(device="cuda").manual_seed(24)
    bank = torch.randn(50000, 768, generator=gen, device="cuda").to(torch.bfloat16).float()
    bank[41000] = bank[17]
    feats = torch.cat([torch.randn(62, 768, generator=gen, device="cuda"), bank[[17, 3]]])
    cpu_idx = mp.memory_argmax(feats.cpu(), bank.cpu())
    cpu_sims = mp.memory_topk_sims(feats.cpu(), bank.cpu(), 5)
    if chunk_rows is not None:  # the card's side in chunks of 7 feature rows
        monkeypatch.setattr(mp, "SIM_CHUNK_BYTES", chunk_rows * 4 * bank.shape[0])
    idx = mp.memory_argmax(feats, bank)
    sims = mp.memory_topk_sims(feats, bank, 5)
    assert idx.is_cuda and sims.shape == (64, 5)
    assert (sims.cpu() - cpu_sims).abs().max().item() <= 1e-5
    clear = (cpu_sims[:, 0] - cpu_sims[:, 1]) > 1e-5
    assert torch.equal(idx.cpu()[clear], cpu_idx[clear])
    assert idx[-2].item() == cpu_idx[-2].item() == 17 and idx[-1].item() == 3


@pytest.mark.parametrize("d", [96, 1664])
def test_memory_project_bf16_kernel_refuses_its_limits(cuda, d):
    # D % 128 != 0, or D > 1536: a ValueError, never another body
    bank = mp.prepare_bank(torch.randn(64, d, device="cuda"), dtype=torch.bfloat16)
    before = mp.memory_project_streamed.launches
    with pytest.raises(ValueError, match="D"):
        mp.memory_project_streamed(torch.randn(2, d, device="cuda"), bank)
    assert mp.memory_project_streamed.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,h,rows", [
    (256, 512, (2, 77)), (1536, 4096, (2, 77)), (96, 128, (2, 77)),
    (128, 192, (2, 77)),    # three 64-wide hidden tiles: an odd count of fc1 blocks
    (256, 512, (3, 300))])  # 900 rows: eight 128-row GEMM tiles, the last ragged
def test_ln_swiglu_kernel(cuda, dtype, d, h, rows):
    # (2, 77): 154 rows, ten 16-row blocks of the f32 kernel and two
    # 128-row GEMM tiles, the last one ragged in each
    gen = torch.Generator(device="cuda").manual_seed(9)
    args = (_randn(gen, *rows, d, dtype=dtype), 1 + _randn(gen, d, dtype=dtype, scale=0.1),
            _randn(gen, d, dtype=dtype, scale=0.1),
            _randn(gen, d, 2 * h, dtype=dtype, scale=d ** -0.5),
            _randn(gen, 2 * h, dtype=dtype, scale=0.1),
            _randn(gen, h, d, dtype=dtype, scale=h ** -0.5),
            _randn(gen, d, dtype=dtype, scale=0.1),
            1 + _randn(gen, d, dtype=dtype, scale=0.1))
    if dtype == torch.bfloat16 and d % 128:  # fc2's 128-wide wgmma tiles of D
        with pytest.raises(ValueError, match="D % 128"):
            mlp.fused_ln_swiglu(*args, eps=1e-6)
        return
    got = _counted(mlp.fused_ln_swiglu, lambda: mlp.fused_ln_swiglu(*args, eps=1e-6))
    _check(got, mlp.ln_swiglu_plain(*args, eps=1e-6), dtype)


def _w8_args(gen, dtype, d, h, rows=(2, 77)):
    f32 = torch.float32
    w1, b1 = _randn(gen, d, h, dtype=f32, scale=d ** -0.5), _randn(gen, h, dtype=f32, scale=0.1)
    w2, b2 = _randn(gen, h, d, dtype=f32, scale=h ** -0.5), _randn(gen, d, dtype=f32, scale=0.1)
    return (_randn(gen, *rows, d, dtype=dtype), 1 + _randn(gen, d, dtype=dtype, scale=0.1),
            _randn(gen, d, dtype=dtype, scale=0.1), *mlp.quantize_mlp_weights(w1, b1, w2, b2),
            1 + _randn(gen, d, dtype=dtype, scale=0.1))


@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,h", [(768, 3072), (128, 512),
                                 (1024, 4096), (1536, 6144)])  # ViT-L, giant's width
def test_ln_mlp_w8_kernel(cuda, dtype, d, h, gelu_approx):
    # 154 rows: one full 128-row GEMM tile and a ragged one
    gen = torch.Generator(device="cuda").manual_seed(10)
    args = _w8_args(gen, dtype, d, h)
    kw = dict(eps=1e-6, gelu_approx=gelu_approx)
    got = _counted(mlp.fused_ln_mlp_w8, lambda: mlp.fused_ln_mlp_w8(*args, **kw))
    _check(got, mlp.ln_mlp_w8_plain(*args, **kw), dtype,
           tol=1e-3 if dtype == torch.float32 else None)


@pytest.mark.parametrize("rows", [(1, 1), (3, 300)])
def test_ln_mlp_w8_kernel_ragged_rows(cuda, rows):
    # one row (a 128-row tile of 127 zero-filled rows), and 900 rows: eight
    # tiles, the last ragged
    gen = torch.Generator(device="cuda").manual_seed(17)
    args = _w8_args(gen, torch.bfloat16, 256, 512, rows)
    got = _counted(mlp.fused_ln_mlp_w8, lambda: mlp.fused_ln_mlp_w8(*args, eps=1e-6))
    _check(got, mlp.ln_mlp_w8_plain(*args, eps=1e-6), torch.bfloat16)


@pytest.mark.parametrize("d,h", [(96, 384), (128, 320), (192, 768)])
def test_ln_mlp_w8_kernel_refuses_its_limits(cuda, d, h):
    # D % 128 != 0 or H % 128 != 0: a ValueError before any launch
    gen = torch.Generator(device="cuda").manual_seed(18)
    args = _w8_args(gen, torch.bfloat16, d, h, (1, 8))
    before = mlp.fused_ln_mlp_w8.launches
    with pytest.raises(ValueError, match="D % 128 == 0 and H % 128 == 0"):
        mlp.fused_ln_mlp_w8(*args, eps=1e-6)
    assert mlp.fused_ln_mlp_w8.launches == before


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("d", [128, 1536])
def test_memory_project_int8_kernel(cuda, d, normalize):
    # kernel H: int8 rows with a zero tail masked by num_real, against its
    # plain version at the f32 bound (both dequantize the same rows in f32)
    gen = torch.Generator(device="cuda").manual_seed(11)
    real = mp.quantize_bank(torch.randn(5000, d, generator=gen, device="cuda"))
    bank = mp.QuantizedBank(*(torch.cat([t, t.new_zeros(120, t.shape[1])])
                              for t in real[:-1]), 5000)
    feats = torch.randn(11, d, generator=gen, device="cuda")
    got = _counted(mp.memory_project_int8,
                   lambda: mp.memory_project_int8(feats, bank, normalize=normalize))
    _check(got, mp.memory_project_int8_plain(feats, bank, normalize=normalize),
           torch.float32)


@pytest.mark.parametrize("bank_rows", ["ragged", "short"])
@pytest.mark.parametrize("b", [1, 8, 11, 48, 80, 125, 128])
@pytest.mark.parametrize("d", [128, 768, 1536])
def test_memory_project_int8_tc_kernel(cuda, d, b, bank_rows):
    # H's tensor-core body, as the bf16 test above: 5003 real int8 rows and
    # a zero tail of 125 masked by num_real, or 37 rows (most ranges empty)
    gen = torch.Generator(device="cuda").manual_seed(14)
    n = 5003 if bank_rows == "ragged" else 37
    real = mp.quantize_bank(torch.randn(n, d, generator=gen, device="cuda"))
    bank = mp.QuantizedBank(*(torch.cat([t, t.new_zeros(125, t.shape[1])])
                              for t in real[:-1]), n)
    feats = torch.randn(b, d, generator=gen, device="cuda")
    for normalize in (True, False):
        got = _counted(mp.memory_project_int8,
                       lambda: mp.memory_project_int8(feats, bank, normalize=normalize))
        _check(got, mp.memory_project_int8_plain(feats, bank, normalize=normalize),
               torch.float32)


@pytest.mark.parametrize("normalize", [True, False])
def test_memory_project_int8_kernel_on_a_wide_scale_bank(cuda, normalize):
    # the bank of tests/test_torch_memory_projection.py's H test: row norms
    # (so scales) over 1e-3 to 1e3, and a row whose every element is +-127
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((8, 256)).astype(np.float32)
    rows = rng.standard_normal((203, 256)).astype(np.float32)
    rows *= np.logspace(-3, 3, 203, dtype=np.float32)[:, None]
    rows[7] = np.where(np.arange(256) % 2, 3.0, -3.0)
    bank = mp.quantize_bank(torch.from_numpy(rows).cuda())
    assert bank.rows[7].abs().min().item() == 127
    feats = torch.from_numpy(feats).cuda()
    got = _counted(mp.memory_project_int8,
                   lambda: mp.memory_project_int8(feats, bank, normalize=normalize))
    _check(got, mp.memory_project_int8_plain(feats, bank, normalize=normalize),
           torch.float32)


def test_memory_project_int8_kernel_keeps_a_zero_feature_nan(cuda):
    # f's int8 pieces cannot carry the NaN of a zero feature's
    # normalisation; the kernel's batch row is NaN as the plain version's,
    # and the other rows are unaffected
    gen = torch.Generator(device="cuda").manual_seed(16)
    bank = mp.quantize_bank(torch.randn(3000, 768, generator=gen, device="cuda"))
    feats = torch.randn(11, 768, generator=gen, device="cuda")
    feats[9] = 0.0
    got = _counted(mp.memory_project_int8, lambda: mp.memory_project_int8(feats, bank))
    ref = mp.memory_project_int8_plain(feats, bank)
    assert torch.isnan(got[9]).all() and torch.isnan(ref[9]).all()
    keep = torch.arange(11, device="cuda") != 9
    _check(got[keep], ref[keep], torch.float32)


@pytest.mark.parametrize("d", [96, 1664])
def test_memory_project_int8_kernel_refuses_its_limits(cuda, d):
    # D % 128 != 0, or D > 1536: a ValueError before any launch
    bank = mp.quantize_bank(torch.randn(64, d, device="cuda"))
    before = mp.memory_project_int8.launches
    with pytest.raises(ValueError, match="D"):
        mp.memory_project_int8(torch.randn(2, d, device="cuda"), bank)
    assert mp.memory_project_int8.launches == before


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("nchunks,d", [(264, 768), (132, 1536), (1, 768), (3, 100)])
def test_memory_project_combine_kernel(cuda, nchunks, d, normalize):
    # the combine D and H end in, alone: the flagship's 264 partials
    # (giant's 132), one partial, and a width off the 32-column slice (the
    # f32 body takes any D); every fourth partial an empty range
    gen = torch.Generator(device="cuda").manual_seed(15)
    m = torch.randn(nchunks, 8, generator=gen, device="cuda") * 20
    l = torch.rand(nchunks, 8, generator=gen, device="cuda") * 3 + 1
    acc = torch.randn(nchunks, 8, d, generator=gen, device="cuda")
    if nchunks > 1:
        m[1::4], l[1::4], acc[1::4] = -1e30, 0.0, 0.0
    got = _counted(mp.combine_partials,
                   lambda: mp.combine_partials(m, l, acc, normalize=normalize))
    _check(got, mp.combine_partials_plain(m, l, acc, normalize=normalize), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_memory_project_kernel_at_giant_width(cuda, dtype):
    gen = torch.Generator(device="cuda").manual_seed(12)
    bank = mp.prepare_bank(torch.randn(5000, 1536, generator=gen, device="cuda"),
                           dtype=dtype)
    feats = torch.randn(8, 1536, generator=gen, device="cuda")
    got = _counted(mp.memory_project_streamed,
                   lambda: mp.memory_project_streamed(feats, bank, normalize=True))
    _check(got, mp.memory_project_plain(feats, bank, normalize=True), torch.float32)


@pytest.mark.parametrize("rows", [8, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_memory_project_kernel_at_clip_width(cuda, dtype, rows):
    # the CLIP DeCap configs' 512-wide bank (the tensor-core body in bf16,
    # 512 % 128 == 0; the SIMT body in f32), at a trace or whole-image
    # batch's 8 rows and a box batch's 128; the f32 bound in both types
    gen = torch.Generator(device="cuda").manual_seed(15)
    bank = mp.prepare_bank(torch.randn(20000, 512, generator=gen, device="cuda"), dtype=dtype)
    feats = torch.randn(rows, 512, generator=gen, device="cuda")
    for normalize in (True, False):
        got = _counted(mp.memory_project_streamed,
                       lambda: mp.memory_project_streamed(feats, bank, normalize=normalize))
        _check(got, mp.memory_project_plain(feats, bank, normalize=normalize), torch.float32)


def test_clip_model_on_the_card_matches_the_cpu(cuda):
    # DeCap on the full-width CLIP ViT-B/16 tower (plain PyTorch, as in the
    # JAX package) at 64 px, f32: the encoder's tokens, the projected prefix
    # (kernel D on the card) and the captions of forward, card vs CPU
    from patchioner_tpu_torch.models.patchioner import Patchioner

    config = {"dino_model": "vit_base_patch16_clip_224.openai", "crop_dim": 64,
              "prefix_size": 512, "support_memory_size": 3000, "normalize": False,
              "decap_arch": {"n_layer": 2, "n_embd": 128, "n_head": 4, "vocab_size": 1000}}
    gpu = Patchioner.from_config(config, allow_missing_weights=True, device="cuda")
    gpu.decoder.gpt2["wte"] *= 10  # sharp logits: no greedy step is a near-tie
    gpu = gpu.to("cuda")
    cpu = gpu.to("cpu")
    imgs = np.random.default_rng(16).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    enc, ref = gpu.encode_images(imgs), cpu.encode_images(imgs)
    for key in ("x_norm_clstoken", "x_norm_patchtokens"):
        assert (enc[key].cpu() - ref[key]).abs().max() <= 1e-4 * max(1.0, ref[key].abs().max())
    got = _counted(mp.memory_project_streamed,
                   lambda: gpu.project_features(enc["x_norm_clstoken"])).cpu()
    want = cpu.project_features(ref["x_norm_clstoken"])
    assert (got - want).abs().max() <= 1e-4 * max(1.0, want.abs().max())
    boxes = np.asarray([[[0, 0, 32, 32], [16, 8, 40, 50]]] * 3, np.float32)
    kw = dict(get_cls_capt=True, bboxes=boxes, traces=[[(0.2, 0.3), (0.7, 0.6)]] * 3,
              get_register_capts=True)  # a CLIP tower has none: no row to project
    out = gpu.forward(imgs, **kw)
    assert out == cpu.forward(imgs, **kw) and out["register_capts"] == [[], [], []]


BACKBONE_FAMILY = {
    "RegionCLIP": {"dino_model": "RN50_regionclip", "crop_dim": 64, "prefix_size": 1024,
                   "regionclip_config": {"embed_dim": 1024}},
    "ProxyCLIP": {"proxyclip_clipmodel": "ViT-B/16", "proxyclip_vfm": "dinov2", "crop_dim": 56,
                  "prefix_size": 512},
    "DINO.txt": {"dino_model": "dinov2_vitl14_reg4_dinotxt_tet1280d20h24l", "crop_dim": 56,
                 "dino_geometry": {"depth": 2}, "prefix_size": 1024},
}


@pytest.mark.parametrize("name", BACKBONE_FAMILY)
def test_backbone_family_on_the_card_matches_the_cpu(cuda, name):
    # random weights at full width, f32 (TF32 off in the matmuls and in
    # cuDNN's convolutions): the encoder's tokens and the projected prefix
    # of the whole image within 1e-4 * max(1, max|ref|), and forward's
    # captions equal; ProxyCLIP on 2 x 2 mosaics of flat colours, where
    # every row of its affinity keeps at least 10% off the diagonal
    from patchioner_tpu_torch.models import proxyclip
    from patchioner_tpu_torch.models.patchioner import Patchioner

    config = dict(BACKBONE_FAMILY[name], support_memory_size=3000, normalize=False,
                  decap_arch={"n_layer": 2, "n_embd": 128, "n_head": 4, "vocab_size": 1000})
    gpu = Patchioner.from_config(config, allow_missing_weights=True, device="cuda")
    gpu.decoder.gpt2["wte"] *= 10  # sharp logits: no greedy step is a near-tie
    gpu = gpu.to("cuda")
    cpu = gpu.to("cpu")
    crop = config["crop_dim"]
    rng = np.random.default_rng(17)
    imgs = rng.integers(0, 256, (3, crop, crop, 3), dtype=np.uint8)
    if name == "ProxyCLIP":
        tiles = np.repeat(np.repeat(rng.integers(0, 256, (3, 2, 2, 3)), crop // 2, 1),
                          crop // 2, 2)
        imgs = np.clip(tiles + rng.integers(-20, 21, tiles.shape), 0, 255).astype(np.uint8)
        cfg = cpu.vit_cfg
        feats = vit.vit_forward(cpu.vit_params["vfm"], cpu._pixels(imgs), cfg.vfm)
        affinity = proxyclip.proxy_affinity(feats["x_norm_patchtokens"], cfg.beta, cfg.gamma)
        assert (1 - torch.diagonal(affinity, dim1=-2, dim2=-1)).min() >= 0.1
    enc, ref = gpu.encode_images(imgs), cpu.encode_images(imgs)
    whole = "x_norm_patchtokens" if name == "ProxyCLIP" else "x_norm_clstoken"
    for key in {"x_norm_patchtokens", whole}:
        assert (enc[key].cpu() - ref[key]).abs().max() <= 1e-4 * max(1.0, ref[key].abs().max())
    feats, want = enc[whole], ref[whole]
    if name == "ProxyCLIP":
        feats, want = feats.mean(dim=1), want.mean(dim=1)
    got = _counted(mp.memory_project_streamed, lambda: gpu.project_features(feats)).cpu()
    want = cpu.project_features(want)
    assert (got - want).abs().max() <= 1e-4 * max(1.0, want.abs().max())
    kw = dict(get_cls_capt=name != "ProxyCLIP", get_avg_patch_capt=True,
              bboxes=np.asarray([[[0, 0, 14, 14], [7, 7, 21, 20]]] * 3, np.float32),
              traces=[[(0.2, 0.3), (0.7, 0.6)]] * 3)
    assert gpu.forward(imgs, **kw) == cpu.forward(imgs, **kw)


@pytest.mark.parametrize("opts", [
    {}, {"attn_impl": "fusedqkv", "proj_fused": True, "gelu_approx": True},
    {"attn_impl": "fusedqkv_proj"}, {"attn_impl": "flash"},
    {"attn_impl": "flash1p"}, {"attn_impl": "flash_builtin"}], ids=str)
def test_slice_on_the_card_matches_the_cpu(cuda, opts):
    cfg = vit.ViTConfig(img_size=56, embed_dim=128, depth=2, num_heads=2,
                        num_registers=4, extract_heads=4, pos_grid=4, **opts)
    gcfg = gpt2.GPT2Config(vocab_size=1000, n_positions=64, n_embd=128,
                           n_layer=2, n_head=4)
    gen = torch.Generator().manual_seed(4)
    params = vit.init_vit(cfg, gen)
    for blk in params["blocks"]:  # near 1, so kernels A-C move the residual
        blk["ls1"], blk["ls2"] = 1 + 0.1 * torch.randn(2, 128, generator=gen)
    decoder = decap.init_decap(gcfg, 128, gen)
    bank = mp.prepare_bank(torch.randn(300, 128, generator=gen))
    state = entry.make_state(params, decoder, bank)
    inputs = entry.example_inputs(batch=3, img=56, n_pts=16, seed=5, device="cpu")
    step = entry.make_prefix_step(cfg, bank.num_real)
    ref = step(state, *inputs)
    gpu_state = {k: v for k, v in state.items() if k not in ("vit", "decoder")}
    gpu_state = {k: v.cuda() for k, v in gpu_state.items()}
    gpu_state["vit"] = vit.cast_params(params, torch.float32, "cuda")
    counts = (mlp.fused_ln_dense.launches, mp.memory_project_streamed.launches)
    got = step(gpu_state, *(t.cuda() for t in inputs)).cpu()
    assert (mlp.fused_ln_dense.launches, mp.memory_project_streamed.launches) == (
        counts[0] + cfg.depth, counts[1] + 1)
    assert np.max(np.abs((got - ref).numpy())) <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("kind", ["swiglu", "int8_bank"])
def test_giant_and_int8_bank_slices_on_the_card_match_the_cpu(cuda, kind):
    # ViT-g's FFN (kernel G) at D = 384 (SwiGLU hidden 1024), and the int8
    # bank (kernel H)
    swiglu = kind == "swiglu"
    d = 384 if swiglu else 128
    cfg = vit.ViTConfig(img_size=56, embed_dim=d, depth=2, num_heads=d // 64,
                        num_registers=4, extract_heads=4, pos_grid=4,
                        ffn="swiglu" if swiglu else "mlp")
    gcfg = gpt2.GPT2Config(vocab_size=1000, n_positions=64, n_embd=128,
                           n_layer=2, n_head=4)
    gen = torch.Generator().manual_seed(5)
    params = vit.init_vit(cfg, gen)
    for blk in params["blocks"]:
        blk["ls1"], blk["ls2"] = 1 + 0.1 * torch.randn(2, d, generator=gen)
    decoder = decap.init_decap(gcfg, d, gen)
    rows = torch.randn(300, d, generator=gen)
    bank = mp.prepare_bank(rows) if swiglu else mp.quantize_bank(rows)
    state = entry.make_state(params, decoder, bank)
    inputs = entry.example_inputs(batch=3, img=56, n_pts=16, seed=6, device="cpu")
    step = entry.make_prefix_step(cfg, bank.num_real)
    ref = step(state, *inputs)
    gpu_state = {k: v.cuda() for k, v in state.items() if k not in ("vit", "decoder")}
    gpu_state["vit"] = vit.cast_params(params, torch.float32, "cuda")
    wrappers = (mlp.fused_ln_swiglu, mlp.fused_ln_mlp, mp.memory_project_int8,
                mp.memory_project_streamed)
    counts = [w.launches for w in wrappers]
    got = step(gpu_state, *(t.cuda() for t in inputs)).cpu()
    added = [w.launches - c for w, c in zip(wrappers, counts)]
    assert added == ([2, 0, 0, 1] if swiglu else [0, 2, 1, 0])
    assert np.max(np.abs((got - ref).numpy())) <= 1e-4 * max(1.0, ref.abs().max().item())


def _sharp_decoder(dtype, seed):
    """The DeCap decoder at full width, seeded, with wte scaled by 10: at the
    init's std of 0.02 the logits are near uniform and 30 steps' scores
    underflow to 0; sharper logits leave them numbers to compare."""
    cfg = dataclasses.replace(gpt2.DECAP_DECODER_CONFIG, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = decap.init_decap(gpt2.DECAP_DECODER_CONFIG, 768, gen, "cuda")
    params.gpt2["wte"] *= 10
    return params, cfg, gen


def _unit_prefix(gen, rows):
    return torch.nn.functional.normalize(
        torch.randn(rows, 768, generator=gen, device="cuda"), dim=-1)


# the graph replays the eager loop's launches: tokens equal, scores within
SCORE_RTOL = {torch.float32: 1e-6, torch.bfloat16: 1e-3}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 8, 128])
def test_decode_graph_equals_the_eager_loop(cuda, dtype, rows):
    params, cfg, gen = _sharp_decoder(dtype, 20)
    decoder = decap.GreedyDecoder(params, cfg)
    for call in range(2):  # a capture, then a replay of the same graph
        prefix = _unit_prefix(gen, rows)
        tokens, scores = decoder(prefix)
        want_tokens, want_scores = decap.greedy_decode(params, prefix, cfg)
        assert (decoder.captures, decoder.replays) == (1, call + 1)
        assert torch.equal(tokens, want_tokens)
        assert (want_scores > 0).all()
        torch.testing.assert_close(scores, want_scores, rtol=SCORE_RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_graph_after_a_nan_batch(cuda, dtype):
    # the KV cache is zeroed inside the graph: a NaN row of one batch (a
    # `[-1] * 4` box gives a NaN prefix) must not reach the next batch
    params, cfg, gen = _sharp_decoder(dtype, 21)
    decoder = decap.GreedyDecoder(params, cfg)
    nan = _unit_prefix(gen, 8)
    nan[::3] = float("nan")
    decoder(nan)
    clean = _unit_prefix(gen, 8)
    tokens, scores = decoder(clean)
    want_tokens, want_scores = decap.greedy_decode(params, clean, cfg)
    assert decoder.captures == 1 and torch.equal(tokens, want_tokens)
    torch.testing.assert_close(scores, want_scores, rtol=SCORE_RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_graphs_are_kept_per_power_of_two_rows(cuda, dtype):
    """Row counts share the graph of their power-of-two bucket: its real
    rows' tokens and scores are the eager loop's on the prefix padded with
    zero rows to the bucket (the graph's own batch); in f32 the tokens also
    equal the eager loop's on the real rows alone (rows decode
    independently; in bf16 the GEMMs cuBLAS picks for another row count
    can round a near-tie the other way, so that is not asserted there);
    and a sweep of every count in a bucket captures nothing more and
    reserves no more memory (at most 8 MiB of small-block slack)."""
    params, cfg, gen = _sharp_decoder(dtype, 23)
    decoder = decap.GreedyDecoder(params, cfg)
    for rows in (40, 3, 100, 64, 33, 128, 4, 65):
        prefix = _unit_prefix(gen, rows)
        tokens, scores = decoder(prefix)
        padded = torch.cat([prefix, prefix.new_zeros(decap.row_bucket(rows) - rows, 768)])
        want_tokens, want_scores = decap.greedy_decode(params, padded, cfg)
        assert tokens.shape == (rows, decoder.n_steps)
        assert torch.equal(tokens, want_tokens[:rows])
        torch.testing.assert_close(scores, want_scores[:rows], rtol=SCORE_RTOL[dtype], atol=0)
        if dtype == torch.float32:
            assert torch.equal(tokens, decap.greedy_decode(params, prefix, cfg)[0])
    assert decoder.captures == 3 and sorted(k[0] for k in decoder._graphs) == [4, 64, 128]
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for rows in range(33, 65):
        decoder(_unit_prefix(gen, rows))
    torch.cuda.synchronize()
    assert decoder.captures == 3
    assert torch.cuda.memory_reserved() - reserved <= 8 << 20


def test_decode_graph_keys_on_the_tf32_setting(cuda):
    params, cfg, gen = _sharp_decoder(torch.float32, 22)
    decoder = decap.GreedyDecoder(params, cfg)
    prefix = _unit_prefix(gen, 4)
    decoder(prefix)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tokens, _ = decoder(prefix)
        want, _ = decap.greedy_decode(params, prefix, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert decoder.captures == 2 and torch.equal(tokens, want)


def test_two_servers_on_two_threads_share_the_decode_graphs(cuda):
    from patchioner_tpu_torch.models.patchioner import Patchioner
    from patchioner_tpu_torch.serve import CaptionServer

    config = {"dino_model": "dinov2_vitb14_reg", "crop_dim": 56, "prefix_size": 128,
              "support_memory_size": 200, "normalize": True,
              "dino_geometry": {"embed_dim": 128, "depth": 2, "num_heads": 2,
                                "extract_heads": 4, "pos_grid": 4},
              "decap_arch": {"n_layer": 2, "n_embd": 128, "n_head": 4}}
    model = Patchioner.from_config(config, allow_missing_weights=True, device="cuda")
    rng = np.random.default_rng(23)
    imgs = rng.integers(0, 256, (2, 4, 56, 56, 3), dtype=np.uint8)
    traces = [[rng.uniform(0, 1, (6, 2)).tolist() for _ in range(4)] for _ in range(2)]
    servers = [CaptionServer(model, max_batch=4, max_delay_ms=200.0) for _ in range(2)]
    try:
        for server in servers:  # the first captures on its worker, the second replays
            server.warmup(buckets=[4], pixel_dtype=np.uint8)
        assert model.decode.captures == 1
        results = [None, None]

        def client(i):
            results[i] = servers[i].caption(list(imgs[i]), traces[i], timeout=300)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        snaps = [server.snapshot() for server in servers]
    finally:
        for server in servers:
            server.close()
    assert model.decode.captures == 1
    assert snaps[0]["decode_replays"] == model.decode.replays >= 2 + 2
    for i in range(2):
        pts = np.zeros((4, 64, 2), np.float32)
        valid = np.zeros((4, 64), np.float32)
        pts[:, :6], valid[:, :6] = np.asarray(traces[i]), 1.0
        assert results[i] == model.caption_traces_fused(imgs[i], pts, valid)


@pytest.mark.parametrize("bank", ["f32", "int8"])
def test_loaded_model_on_the_card_matches_the_same_files_on_the_cpu(cuda, tmp_path, bank):
    # checkpoints written in the published layouts by chip_smoke's writers;
    # no bank file (h5py may be absent on the card's machine): the CPU model
    # takes the rows the card drew
    import importlib.util
    import os

    from patchioner_tpu_torch.models.patchioner import Patchioner

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    geometry = {"embed_dim": 128, "depth": 2, "num_heads": 2, "extract_heads": 4,
                "pos_grid": 4}
    arch = {"n_layer": 2, "n_embd": 128, "n_head": 4, "vocab_size": 1000}
    gen = torch.Generator().manual_seed(24)
    tree = vit.init_vit(vit.config_for("dinov2_vitb14_reg", img_size=56, **geometry), gen)
    for blk in tree["blocks"]:  # near 1, so kernels A-C move the residual
        blk["ls1"], blk["ls2"] = 1 + 0.1 * torch.randn(2, 128, generator=gen)
    torch.save(smoke.hub_state_dict(tree), tmp_path / "dino.pth")
    torch.save(smoke.decap_state_dict(decap.init_decap(gpt2.GPT2Config(**arch), 128, gen)),
               tmp_path / "decap.pt")
    config = {"dino_model": "dinov2_vitb14_reg", "crop_dim": 56, "prefix_size": 128,
              "support_memory_size": 300, "dino_geometry": geometry, "decap_arch": arch,
              "dino_weights": str(tmp_path / "dino.pth"),
              "decap_weights": str(tmp_path / "decap.pt"),
              "memory_bank_path": str(tmp_path / "absent.h5"),
              "memory_bank_int8": bank == "int8"}
    gpu = Patchioner.from_config(config, allow_missing_weights=True, device="cuda")
    cpu = Patchioner.from_config(config, allow_missing_weights=True, random_bank_size=1,
                                 device="cpu")
    cpu.bank = type(gpu.bank)(*(t.cpu() for t in gpu.bank[:-1]), gpu.bank.num_real)
    inputs = entry.example_inputs(batch=3, img=56, n_pts=16, seed=25, device="cpu")
    step = entry.make_prefix_step(gpu.vit_cfg, gpu.bank.num_real)
    ref = step(cpu.state(), *inputs)
    wrapper = mp.memory_project_int8 if bank == "int8" else mp.memory_project_streamed
    got = _counted(wrapper, lambda: step(gpu.state(), *(t.cuda() for t in inputs))).cpu()
    assert np.max(np.abs((got - ref).numpy())) <= 1e-4 * max(1.0, ref.abs().max().item())


def _sharp_lm(seed):
    """A 2-layer, 32-wide GPT-2 over 263 tokens, wte scaled by 20 so that no
    step of a search is a near-tie; f32 on the CPU."""
    cfg = gpt2.GPT2Config(vocab_size=263, n_positions=128, n_embd=32, n_layer=2, n_head=2)
    params = gpt2.init_gpt2(cfg, torch.Generator().manual_seed(seed))
    params["wte"] *= 20
    return cfg, params


def test_viecap_batched_beam_search_on_the_card_equals_per_image(cuda):
    cfg, params = _sharp_lm(0)
    params = vit.cast_params(params, torch.float32, "cuda")
    embeds = torch.randn(6, 5, 32, generator=torch.Generator().manual_seed(1)).cuda()
    eos = torch.tensor([13, 27], device="cuda")
    toks, lengths, norm = viecap.beam_tokens(params, embeds, eos, cfg, 12, 5)
    for i in range(embeds.shape[0]):
        one = viecap.beam_tokens(params, embeds[i:i + 1], eos, cfg, 12, 5)
        assert torch.equal(toks[i], one[0][0]) and torch.equal(lengths[i], one[1][0])
        torch.testing.assert_close(norm[i], one[2][0], rtol=1e-5, atol=0)


def test_viecap_searches_on_the_card_equal_the_cpu(cuda):
    cfg, params = _sharp_lm(2)
    embeds = torch.randn(4, 7, 32, generator=torch.Generator().manual_seed(3))
    eos = torch.tensor([13, 27])
    on_card = vit.cast_params(params, torch.float32, "cuda")
    for name, call in (
            ("greedy", lambda p, e, q: viecap.greedy_tokens(p, e, cfg, 16)),
            ("beam", lambda p, e, q: viecap.beam_tokens(p, e, q, cfg, 12, 5)[0]),
            ("contrastive", lambda p, e, q: viecap.contrastive_tokens(p, e, cfg, 16, 8, 0.1))):
        got = call(on_card, embeds.cuda(), eos.cuda()).cpu()
        assert torch.equal(got, call(params, embeds, eos)), name


def test_clipcap_sampler_on_the_card_equals_the_cpu(cuda):
    cfg, params = _sharp_lm(4)
    params["wte"] /= 5  # wte x 4: top_p 0.8 keeps many tokens a step
    gen = torch.Generator().manual_seed(5)
    prefix = torch.randn(6, 10, 32, generator=gen)
    prefix[4] = float("nan")  # the stop id at every step
    noise = clipcap.gumbel_noise((16, 6, cfg.vocab_size), gen, "cpu")
    for top_p, temperature in ((0.8, 1.0), (0.0, 1.0), (0.3, 0.7)):
        want = clipcap.sample_tokens(params, prefix, noise, cfg, 13, top_p, temperature)
        got = clipcap.sample_tokens(vit.cast_params(params, torch.float32, "cuda"),
                                    prefix.cuda(), noise.cuda(), cfg, 13, top_p, temperature)
        assert torch.equal(got.cpu(), want) and (want[4] == 13).all()


def test_meacap_on_the_card_equals_the_cpu(cuda):
    cfg, params = _sharp_lm(6)
    vcfg = viecap.ViecapConfig(continuous_prompt_length=3, clip_project_length=2,
                               clip_hidden_size=64, num_layers=2, num_heads=2,
                               using_hard_prompt=True, soft_prompt_first=True,
                               using_greedy_search=True, max_len=12)
    gen = torch.Generator().manual_seed(7)
    words = ["dog", "cat", "park", "ball", "tree", "kite", "beach", "car"]
    idx = torch.randint(0, len(words), (20_000, 3), generator=gen).tolist()
    captions = [" ".join(["a"] + [words[j] for j in row]) for row in idx]

    class Words:
        pad_token_id = 0

        def __init__(self):
            self.vocab = {}

        def encode(self, text):
            return [self.vocab.setdefault(w, 10 + len(self.vocab) % 250) for w in text.split()]

        def decode(self, ids):
            return " ".join(str(i) for i in ids)

    cpu = meacap.MeaCap(vcfg, cfg, params, viecap.init_mapping_network(vcfg, 32, gen),
                        captions, torch.randn(20_000, 64, generator=gen), Words(), "cpu",
                        memory_caption_num=5)
    card = cpu.to("cuda")
    assert isinstance(card, meacap.MeaCap) and card.memory_clip_embeddings.is_cuda
    feats = torch.randn(8, 64, generator=gen)
    f = feats / feats.norm(dim=-1, keepdim=True)
    np.testing.assert_array_equal(
        meacap.retrieve_memory_captions(f.cuda(), card.memory_clip_embeddings, 5),
        meacap.retrieve_memory_captions(f, cpu.memory_clip_embeddings, 5))
    assert card._hard_prompt_token_rows(f.cuda()) == cpu._hard_prompt_token_rows(f)
    emb, ref = card.prompt_embeds(feats), cpu.prompt_embeds(feats)
    assert (emb.cpu() - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert card.forward(feats) == cpu.forward(feats)


def _f32_gate(got, ref):
    """chip_smoke's f32 gate: max|got - ref| <= 1e-4 * max(1, max|ref|)."""
    ref = ref.detach().float()
    err = (got.detach().cpu().float() - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("packed", [False, True])
def test_decoder_train_step_on_the_card_matches_the_cpu(cuda, packed):
    """One decoder step on the card against the same step on the CPU, same
    init, batch and CapDec noise: the --im_proj step through kernel D over
    a 4096-row f32 bank (its plain version on the CPU), or the packed step
    with the chunked head and two micro-batches; loss, accuracy and every
    gradient leaf after one step, the params after a second, under
    chip_smoke's f32 gate."""
    from patchioner_tpu_torch.train import decoder_train as dt, packing

    gcfg = gpt2.GPT2Config(vocab_size=1000, n_positions=64, n_embd=128, n_layer=2, n_head=4)
    gen = torch.Generator().manual_seed(0)
    params = decap.init_decap(gcfg, 128, gen)
    sides = {"cuda": decap.DecapParams(*(vit.cast_params(t, torch.float32, "cuda")
                                         for t in params)), "cpu": params}
    tcfg = dt.TrainConfig(lr=1e-3, warmup_steps=0, total_steps=10, gaussian_noise=0.016,
                          loss_chunk=4 if packed else 0, grad_accum=2 if packed else 1)
    states = {k: dt.make_optimizer(tcfg).init(p) for k, p in sides.items()}
    feats = torch.randn(32, 128, generator=gen)
    if packed:
        toks = torch.randint(1, 999, (32, 10), generator=gen).numpy()
        for i in range(32):  # EOT marks each caption's end for the packer
            cut = int(torch.randint(2, 11, (), generator=gen))
            toks[i, cut - 1], toks[i, cut:] = 49407, 0
        pack = packing.pack_captions(toks, 24)
        rows = pack.targets.shape[0] // 2 * 2
        pack = packing.PackedBatch(*(a[:rows].reshape(2, rows // 2, *a.shape[1:])
                                     for a in pack))
        pack = pack._replace(targets=np.where(pack.targets == 49407, 999, pack.targets),
                             input_tokens=np.where(pack.input_tokens == 49407, 999,
                                                   pack.input_tokens))
        step = dt.make_packed_train_step(gcfg, tcfg)
        noise = torch.randn(2, pack.seg_feature_idx[0].size, 128, generator=gen)
        args = {k: (feats.to(k), dt.pack_to_device(pack, k)) for k in sides}
        bank = {k: None for k in sides}
    else:
        toks = torch.randint(0, 1000, (32, 12), generator=gen)
        step = dt.make_train_step(gcfg, tcfg)
        noise = torch.randn(32, 128, generator=gen)
        args = {k: (feats.to(k), toks.to(k)) for k in sides}
        rows = torch.randn(4096, 128, generator=gen)
        bank = {k: mp.prepare_bank(rows.to(k)) for k in sides}
    before = mp.memory_project_streamed.launches
    for i in range(2):
        out = {k: step(sides[k], states[k], *args[k], bank=bank[k], noise=noise.to(k))[2]
               for k in sides}
        for key in ("loss", "acc"):
            _f32_gate(out["cuda"][key], out["cpu"][key])
        if i == 0:
            for g, r in zip(states["cuda"].leaves, states["cpu"].leaves):
                _f32_gate(g.grad, r.grad)
    for g, r in zip(states["cuda"].leaves, states["cpu"].leaves):
        _f32_gate(g, r)
    assert mp.memory_project_streamed.launches - before == (0 if packed else 2)


def test_eval_staging_lands_on_the_card(cuda):
    from patchioner_tpu_torch.eval import harness

    arrays = [np.arange(2 * 56 * 56 * 3, dtype=np.uint8).reshape(2, 56, 56, 3),
              np.random.default_rng(0).uniform(0, 1, (2, 9, 2)).astype(np.float32)]
    staged = harness.stage_to_device(arrays, cuda)
    assert [t.device.type for t in staged] == ["cuda", "cuda"]
    assert all(np.array_equal(t.cpu().numpy(), a) for t, a in zip(staged, arrays))


def test_eval_harness_on_the_card_equals_the_direct_calls(cuda, tmp_path):
    # chip_smoke's phase 13 on 8 seeded images of 320 x 240, the flagship
    # cut to 2 layers (bf16, a 4096-row bank): the trace, cls and dense
    # evaluators, each encoder pass's A-C launches, one D and one decode
    # replay a batch, no graph captured after the warm-up, and the first
    # batch of each equal to the direct fused calls on the same pixels and
    # padding
    import chip_smoke
    from patchioner_tpu_torch.eval import dense_captioning, image_captioning, trace_captioning
    from patchioner_tpu_torch.models.patchioner import Patchioner

    config = dict(chip_smoke.FLAGSHIP_CONFIG, dino_geometry={"depth": 2})
    model = Patchioner.from_config(config, allow_missing_weights=True, random_bank_size=4096,
                                   dtype=torch.bfloat16, device="cuda")
    paths = chip_smoke.write_eval_dataset(str(tmp_path), 3, n=8, size=(320, 240))
    chip_smoke._eval_warmup(model)
    runs = {}
    for label, mod, task, kw in (
            ("trace patches", trace_captioning, "trace", {"caption_from": "patches"}),
            ("image cls", image_captioning, "image", {"caption_from": "cls"}),
            ("dense patches", dense_captioning, "dense", {"caption_from": "patches"})):
        runs[label] = chip_smoke._eval_run(model, label, mod.evaluate, paths[task],
                                           paths["images"], True, "card test", **kw)
        assert runs[label]["counts"]["ln_dense"] == 2 * runs[label]["batches"]
    chip_smoke._eval_direct_checks(model, paths, runs)


# ------------------------------------------------ gradients (A, B, C; D-K)


def _abc_case(gen, which):
    """(wrapper call, plain call, its leaves) at the align path's shapes:
    64 x 17 rows of 384 (ViT-S at 56 px), 6 heads of 64."""
    f32 = torch.float32
    d = 384

    def leaf(*shape, scale=1.0, shift=0.0):
        return (shift + _randn(gen, *shape, dtype=f32, scale=scale)).requires_grad_()

    x = leaf(64, 17, d)
    if which == "A":
        args = (x, leaf(d, scale=0.1, shift=1.0), leaf(d, scale=0.1),
                leaf(d, 3 * d, scale=d ** -0.5), leaf(3 * d, scale=0.1))
        return (lambda: mlp.fused_ln_dense(*args, eps=1e-6),
                lambda: mlp.ln_dense_plain(*args, eps=1e-6), args)
    if which.startswith("B"):
        qkv = leaf(64, 17, 3 * d)
        kw = dict(num_heads=6, scale=0.125, num_real_k=11 if which == "B masked" else None)
        return (lambda: attention.fused_qkv_attention(qkv, **kw),
                lambda: attention.qkv_attention_plain(qkv, **kw), (qkv,))
    h = 4 * d
    args = (x, leaf(d, scale=0.1, shift=1.0), leaf(d, scale=0.1),
            leaf(d, h, scale=d ** -0.5), leaf(h, scale=0.1), leaf(h, d, scale=h ** -0.5),
            leaf(d, scale=0.1), leaf(d, scale=0.1, shift=1.0))
    kw = dict(eps=1e-6, gelu_approx=which == "C tanh")
    return (lambda: mlp.fused_ln_mlp(*args, **kw), lambda: mlp.ln_mlp_plain(*args, **kw),
            args)


@pytest.mark.parametrize("which", ["A", "B", "B masked", "C", "C tanh"])
def test_abc_autograd_functions_match_autograd_of_the_plain_versions(cuda, which):
    gen = torch.Generator(device="cuda").manual_seed(30)
    kernel, plain, leaves = _abc_case(gen, which)
    wrapper = {"A": mlp.fused_ln_dense, "C": mlp.fused_ln_mlp}.get(
        which[0], attention.fused_qkv_attention)
    out = _counted(wrapper, kernel)
    assert type(out.grad_fn).__name__ in ("_LnDenseBackward", "_QkvAttentionBackward",
                                          "_LnMlpBackward")
    ref = plain()
    _check(out.detach(), ref.detach(), torch.float32)
    g = _randn(gen, *out.shape, dtype=torch.float32)
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(ref, leaves, g)
    for a, b in zip(got, want):
        _check(a, b, torch.float32)


def test_abc_backward_is_float32_only(cuda):
    gen = torch.Generator(device="cuda").manual_seed(31)
    w = _randn(gen, 128, 384, dtype=torch.bfloat16).requires_grad_()
    x = _randn(gen, 2, 17, 128, dtype=torch.bfloat16)
    one = torch.ones(128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float32 only"):
        mlp.fused_ln_dense(x, one, one * 0, w, one.new_zeros(384), eps=1e-6)


def _grad_calls(gen):
    """A call of each of D-K and the combine, on CUDA tensors of which
    `probe` (returned) is the one operand that requires grad."""
    f32 = torch.float32
    d = 128
    probe = _randn(gen, d, d, dtype=f32, scale=d ** -0.5).requires_grad_()
    x = _randn(gen, 2, 17, d, dtype=f32)
    vec = torch.ones(d, device="cuda")
    qkv = _randn(gen, 2, 17, 3 * d, dtype=f32)
    q = _randn(gen, 1, 2, 17, 64, dtype=f32)
    w8 = mlp.quantize_mlp_weights(_randn(gen, d, 512, dtype=f32), torch.zeros(512, device="cuda"),
                                  _randn(gen, 512, d, dtype=f32), vec * 0)
    rows = _randn(gen, 64, d, dtype=f32)
    feats = probe[:2]
    m = torch.zeros(1, 2, device="cuda", requires_grad=True)
    return probe, {
        "memory_project": lambda: mp.memory_project_streamed(feats, mp.prepare_bank(rows)),
        "memory_project_int8": lambda: mp.memory_project_int8(feats, mp.quantize_bank(rows)),
        "combine_partials": lambda: mp.combine_partials(
            m, torch.ones(1, 2, device="cuda"), torch.ones(1, 2, d, device="cuda")),
        "dense_residual": lambda: mlp.fused_dense_residual(x, x, probe, vec * 0, vec),
        "qkv_attention_proj": lambda: attention.fused_qkv_attention_proj(
            qkv, x, probe, vec * 0, vec, num_heads=2, scale=0.125),
        "ln_swiglu": lambda: mlp.fused_ln_swiglu(
            x, vec, vec * 0, torch.cat([probe, probe], 1), torch.zeros(2 * d, device="cuda"),
            probe, vec * 0, vec, eps=1e-6),
        "ln_mlp_w8": lambda: mlp.fused_ln_mlp_w8(x, vec.requires_grad_(), vec * 0, *w8, vec,
                                                 eps=1e-6),
        "flash_attention": lambda: attention.flash_attention(
            q.requires_grad_(), q, q, scale=0.125),
        "flash_attention_1pass": lambda: attention.flash_attention_1pass(
            q.requires_grad_(), q, q, scale=0.125),
    }


@pytest.mark.parametrize("name", ["memory_project", "memory_project_int8", "combine_partials",
                                  "dense_residual", "qkv_attention_proj", "ln_swiglu",
                                  "ln_mlp_w8", "flash_attention", "flash_attention_1pass"])
def test_kernels_without_a_backward_refuse_grad(cuda, name):
    """D-K (and the combine D and H end in) raise on a grad-requiring
    operand rather than return a detached output; under no_grad they run."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    _, calls = _grad_calls(gen)
    with pytest.raises(NotImplementedError, match="backward is not ported"):
        calls[name]()
    with torch.no_grad():
        out = calls[name]()
    torch.cuda.synchronize()
    assert out.grad_fn is None and torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ffn,gelu_approx", [("mlp", False), ("mlp", True), ("swiglu", False)])
def test_last_block_rerun_through_the_kernels(cuda, dtype, ffn, gelu_approx):
    """The double-DINO re-run through A and C (G on a SwiGLU block) against
    its plain version on key-masked rows (one with every key masked), the
    layerscale near 1: the output and the block's own delta (out - tokens)
    within the tolerance of their largest; the same re-run with the key
    mask dropped must fail the delta's."""
    # hidden 512, or SwiGLU's 1024: the bf16 GEMMs' 128-wide (G's fc1: 64) tiles
    d = 128 if ffn == "mlp" else 384
    cfg = vit.ViTConfig(img_size=56, embed_dim=d, depth=1, num_heads=2, ffn=ffn,
                        gelu_approx=gelu_approx, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = vit.init_vit(cfg, gen, "cuda")
    blk = params["blocks"][-1]
    blk["ls1"], blk["ls2"] = 1 + 0.1 * torch.randn(2, d, generator=gen, device="cuda")
    params = vit.cast_params(params, dtype)
    tokens = torch.randn(6, 21, d, generator=gen, device="cuda").to(dtype)
    mask = torch.rand(6, 21, generator=gen, device="cuda") < 0.4
    mask[2] = False
    counts = (mlp.fused_ln_dense.launches, mlp.fused_ln_mlp.launches,
              mlp.fused_ln_swiglu.launches)
    got = vit.last_block_rerun(params, tokens, mask, cfg, chunk=4)
    ffn_fn = mlp.fused_ln_swiglu if ffn == "swiglu" else mlp.fused_ln_mlp
    assert mlp.fused_ln_dense.launches == counts[0] + 1
    assert ffn_fn.launches == counts[2 if ffn == "swiglu" else 1] + 1
    ref = vit.last_block_rerun_plain(params, tokens, mask, cfg, chunk=4)
    delta = (ref - tokens).float()
    tol = TOLERANCE[dtype]
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= tol
    assert (((got - tokens).float() - delta).abs().max() / delta.abs().max()).item() <= tol
    mutant = vit.last_block_rerun(params, tokens, torch.ones_like(mask), cfg)
    assert (((mutant - tokens).float() - delta).abs().max() / delta.abs().max()).item() > tol
