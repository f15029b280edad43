"""Support-memory projection (kernels D and H) — the DeCap Im2Txt step.

Twin of `patchioner_tpu/ops/memory_projection.py`:

    sim    = normalize(f) . (row * inv_norm)      (rows < num_real only)
    weight = softmax(sim / T)
    out    = weight @ rows ; optionally L2-normalised

`prepare_bank` stores the reciprocal norms of the f32 rows once, as the
reference does; `quantize_bank` stores int8 rows with a per-row scale
(row = q * scale) beside the ORIGINAL f32 rows' reciprocal norms. Neither
pads (a padded bank carried over from the JAX package keeps its tail,
which `num_real` masks).
`memory_project_streamed` (D, a `PreparedBank`) and `memory_project_int8`
(H, a `QuantizedBank`) run the hand-written CUDA kernels of
`csrc/memory_projection.cu` (whose note gives the bound and design) on
CUDA tensors and `memory_project_plain` / `memory_project_int8_plain` on
CPU tensors; `launches` on each counts kernel launches. A bf16 bank (D)
and every int8 bank (H) go to the tensor-core body (D % 128 == 0, D <=
1536; one wave of blocks), an f32 bank to the SIMT body (D <= 1536;
2048-row ranges). A bank the kernels do not take raises; nothing falls
back. Both bodies end in the combine of their partials
(`combine_partials`, `combine_partials_plain` on the CPU). The backward of
neither kernel is ported: on CUDA tensors with grad on and an operand that
requires grad they raise (`kernels.refuse_grad`).

`memory_argmax` and `memory_topk_sims` (the argmax-text and n-best modes)
are plain PyTorch on every device, as their JAX twins are plain XLA: each
is its own plain version. They score the bank's rows as given, at unit
norm by their OWN norms (not `inv_norm`), in f32, a chunk of feature rows
at a time so that one chunk's similarities stay near `SIM_CHUNK_BYTES`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from patchioner_tpu_torch import kernels
from patchioner_tpu_torch.ops.mlp import quantize_symmetric_int8

__all__ = [
    "DEFAULT_TEMPERATURE",
    "PreparedBank",
    "QuantizedBank",
    "prepare_bank",
    "quantize_bank",
    "memory_project_plain",
    "memory_project_int8_plain",
    "memory_project_streamed",
    "memory_project_int8",
    "combine_partials_plain",
    "combine_partials",
    "memory_argmax",
    "memory_topk_sims",
]

DEFAULT_TEMPERATURE = 0.01
# bank rows per block of the SIMT body (f32); ~290 blocks at 591,753 rows
CHUNK_ROWS = 2048
MAX_D = 1536
# the tensor-core body's row tile (its ranges are multiples of it) and the
# width its 8 warps split into 16-column steps
ROW_TILE = 16
TC_D_MULTIPLE = 128
# one chunk of feature rows' f32 similarities to the whole bank: 907 rows
# of the flagship's 591,753
SIM_CHUNK_BYTES = 2 << 30


class PreparedBank(NamedTuple):
    """rows: (M, D) f32 or bf16; inv_norm: (M, 1) f32 reciprocal norms of the
    f32 rows. Rows from `num_real` on (the padding of a bank prepared by the
    JAX package) are never read."""

    rows: torch.Tensor
    inv_norm: torch.Tensor
    num_real: int


class QuantizedBank(NamedTuple):
    """rows: (M, D) int8 with rows * scale the f32 rows; scale: (M, 1) f32;
    inv_norm: (M, 1) f32 reciprocal norms of the ORIGINAL f32 rows. Rows
    from `num_real` on are never read."""

    rows: torch.Tensor
    scale: torch.Tensor
    inv_norm: torch.Tensor
    num_real: int


def prepare_bank(bank: torch.Tensor, *,
                 dtype: Optional[torch.dtype] = None) -> PreparedBank:
    inv = 1.0 / torch.linalg.vector_norm(bank.float(), dim=-1, keepdim=True)
    return PreparedBank(bank.to(dtype or bank.dtype).contiguous(), inv, bank.shape[0])


def quantize_bank(bank: torch.Tensor, *, chunk_rows: int = 262_144) -> QuantizedBank:
    """Per-row symmetric int8 quantization of an (M, D) bank, once at load
    (the reference's `quantize_bank` without its padding). Chunked, so the
    f32 temporaries are one chunk's, not the bank's."""
    parts = []
    for lo in range(0, bank.shape[0], chunk_rows):
        bf = bank[lo:lo + chunk_rows].float()
        inv = 1.0 / torch.linalg.vector_norm(bf, dim=-1, keepdim=True)
        parts.append((*quantize_symmetric_int8(bf, dim=-1), inv))
    rows, scale, inv = (torch.cat(p) for p in zip(*parts))
    return QuantizedBank(rows, scale, inv, bank.shape[0])


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def memory_project_plain(features: torch.Tensor, bank: PreparedBank, *,
                         temperature: float = DEFAULT_TEMPERATURE,
                         normalize: bool = False) -> torch.Tensor:
    """Two-pass projection: (B, D) features -> (B, D) f32."""
    f = _l2_normalize(features.float())
    rows = bank.rows[: bank.num_real].float()
    sim = f @ (rows * bank.inv_norm[: bank.num_real]).T
    weight = torch.softmax(sim / temperature, dim=-1)
    out = weight @ rows
    return _l2_normalize(out) if normalize else out


def memory_project_int8_plain(features: torch.Tensor, bank: QuantizedBank, *,
                              temperature: float = DEFAULT_TEMPERATURE,
                              normalize: bool = False) -> torch.Tensor:
    """Kernel H's function (_mem_proj_kernel_q): the rows dequantized as
    q * scale, scored with the original rows' inverse norms. The JAX
    package's CPU path renormalises the dequantized rows instead
    (memory_project -> memory_project_xla), which differs from its TPU
    kernel within quantization noise; this follows the kernel."""
    n = bank.num_real
    rows = bank.rows[:n].float() * bank.scale[:n]
    return memory_project_plain(features, PreparedBank(rows, bank.inv_norm[:n], n),
                                temperature=temperature, normalize=normalize)


def _similarity_chunks(features: torch.Tensor, bank: torch.Tensor):
    """The f32 cosine similarities of (B, D) features to (M, D) bank rows,
    both at unit norm by their own norms, as many feature rows at a time as
    fit in `SIM_CHUNK_BYTES`. Chunks cut the feature rows only, so each row
    sees the whole bank at once."""
    f = _l2_normalize(features.float())
    b = _l2_normalize(bank.float())
    rows = max(1, SIM_CHUNK_BYTES // (4 * max(1, b.shape[0])))
    for lo in range(0, f.shape[0], rows):
        yield f[lo:lo + rows] @ b.T


def memory_argmax(features: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(B,) int64 index of each feature's nearest bank row by cosine
    similarity, the lowest index on a tie, as `jnp.argmax`. Twin of
    `memory_projection.py:86`; its own plain version."""
    parts = [s.argmax(dim=-1) for s in _similarity_chunks(features, bank)]
    return torch.cat(parts) if parts else features.new_zeros(0, dtype=torch.int64)


def memory_topk_sims(features: torch.Tensor, bank: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) f32 top-k cosine similarities of each feature to the bank
    rows, descending. Twin of `memory_projection.py:93`; its own plain
    version."""
    parts = [s.topk(k, dim=-1).values
             for s in _similarity_chunks(features, bank)]
    return torch.cat(parts) if parts else features.new_zeros(0, k, dtype=torch.float32)


def combine_partials_plain(m_part: torch.Tensor, l_part: torch.Tensor,
                           acc_part: torch.Tensor, *, normalize: bool = False) -> torch.Tensor:
    """Merge online-softmax partials, (C, B) maxima and denominators and
    (C, B, D) accumulators, into the (B, D) projection (the reference's
    `combine_partials`); a partial with max -1e30 and denominator 0 weighs 0."""
    w = torch.exp(m_part - m_part.max(dim=0).values)
    out = (acc_part * w[..., None]).sum(dim=0) / (l_part * w).sum(dim=0)[:, None]
    return _l2_normalize(out) if normalize else out


def combine_partials(m_part: torch.Tensor, l_part: torch.Tensor, acc_part: torch.Tensor, *,
                     normalize: bool = False) -> torch.Tensor:
    """The combine kernel D and H end in, on CUDA tensors (f32, contiguous);
    `combine_partials_plain` on CPU tensors."""
    if m_part.device.type == "cpu":
        return combine_partials_plain(m_part, l_part, acc_part, normalize=normalize)
    kernels.refuse_grad("combine_partials", m_part, l_part, acc_part)
    c, b, d = acc_part.shape
    if (m_part.shape != (c, b) or l_part.shape != (c, b) or d > MAX_D
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   or t.device != acc_part.device for t in (m_part, l_part, acc_part))):
        raise ValueError("combine_partials: needs contiguous f32 (C, B), (C, B) and "
                         f"(C, B, D <= {MAX_D}) partials on one device")
    out = torch.empty(b, d, device=acc_part.device, dtype=torch.float32)
    kernels.launch("pt_memory_project_combine", m_part.data_ptr(), l_part.data_ptr(),
                   acc_part.data_ptr(), out.data_ptr(), b, d, c, int(bool(normalize)))
    combine_partials.launches += 1
    return out


combine_partials.launches = 0


@functools.cache
def _tc_blocks(d: int, code: int, device_index: int) -> int:
    """Blocks of the tensor-core body for dtype `code` that fit on card
    `device_index` at once at width d."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        kernels.launch("pt_memory_project_blocks", d, code, ctypes.addressof(out))
    return out.value


def _project(name: str, features: torch.Tensor, rows, scale, inv, num_real: int,
             temperature: float, normalize: bool) -> torch.Tensor:
    """Launch the projection kernel: D when `scale` is None, else H."""
    if features.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {features.device}")
    b, d = features.shape
    bank = (rows, inv) if scale is None else (rows, scale, inv)
    kernels.refuse_grad(name, features, *bank)
    if any(t.device != features.device for t in bank):
        raise ValueError(f"{name}: bank and features on different devices")
    if (d > MAX_D or rows.shape[1] != d or inv.dtype != torch.float32
            or (scale is not None and (scale.dtype != torch.float32
                                       or rows.dtype != torch.int8))):
        raise ValueError(
            f"{name}: needs D <= {MAX_D} and f32 inv_norm (and scale); got "
            f"features {tuple(features.shape)}, rows {tuple(rows.shape)} {rows.dtype}"
        )
    if not all(t.is_contiguous() for t in bank):
        raise ValueError(f"{name}: bank must be contiguous")
    code = kernels.dtype_code(rows)
    f = _l2_normalize(features.float()).contiguous()
    if rows.dtype in (torch.bfloat16, torch.int8):
        if d % TC_D_MULTIPLE:
            raise ValueError(f"{name}: the tensor-core kernel needs D % {TC_D_MULTIPLE} == 0 "
                             f"and D <= {MAX_D}; got D = {d}")
        if any(t.data_ptr() % 16 for t in bank):
            raise ValueError(f"{name}: the tensor-core kernel needs a 16-byte aligned bank")
        # one wave: as many row ranges as blocks fit, each a whole number
        # of tiles (the last ones empty when the bank is short)
        nchunks = _tc_blocks(d, code, f.device.index)
        chunk_rows = -(-num_real // (nchunks * ROW_TILE)) * ROW_TILE
    else:
        nchunks, chunk_rows = -(-num_real // CHUNK_ROWS), CHUNK_ROWS
    m_part = torch.empty(nchunks * b, device=f.device, dtype=torch.float32)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty(nchunks * b, d, device=f.device, dtype=torch.float32)
    out = torch.empty(b, d, device=f.device, dtype=torch.float32)
    kernels.launch(
        "pt_memory_project", f.data_ptr(), rows.data_ptr(),
        None if scale is None else scale.data_ptr(),
        *(t.data_ptr() for t in (inv, m_part, l_part, acc_part, out)),
        b, d, int(num_real), chunk_rows, nchunks, float(1.0 / temperature),
        int(bool(normalize)), code,
    )
    return out


def memory_project_streamed(features: torch.Tensor, bank: PreparedBank, *,
                            temperature: float = DEFAULT_TEMPERATURE,
                            normalize: bool = False) -> torch.Tensor:
    """Kernel D on CUDA tensors, `memory_project_plain` on CPU tensors."""
    if features.device.type == "cpu":
        return memory_project_plain(features, bank, temperature=temperature,
                                    normalize=normalize)
    out = _project("memory_project_streamed", features, bank.rows, None,
                   bank.inv_norm, bank.num_real, temperature, normalize)
    memory_project_streamed.launches += 1
    return out


memory_project_streamed.launches = 0


def memory_project_int8(features: torch.Tensor, bank: QuantizedBank, *,
                        temperature: float = DEFAULT_TEMPERATURE,
                        normalize: bool = False) -> torch.Tensor:
    """Kernel H on CUDA tensors, `memory_project_int8_plain` on CPU tensors."""
    if features.device.type == "cpu":
        return memory_project_int8_plain(features, bank, temperature=temperature,
                                         normalize=normalize)
    out = _project("memory_project_int8", features, bank.rows, bank.scale,
                   bank.inv_norm, bank.num_real, temperature, normalize)
    memory_project_int8.launches += 1
    return out


memory_project_int8.launches = 0

