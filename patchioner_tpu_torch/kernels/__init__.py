"""ctypes binding of the port's hand-written CUDA kernels.

`lib()` builds the kernels on first use (`kernels.build`) and loads them.
Nothing here runs at import time, so the CPU tests import every module
without nvcc or a card. `check_operands` holds a wrapper's tensors to what
every kernel takes, and `launch(name, *args)` calls one C entry point on
the current CUDA stream and raises when it reports a CUDA error.
`wants_grad` says when a wrapper's output must carry a graph, and
`refuse_grad` raises in the wrappers whose backward is not ported, so that
no wrapper returns a detached output from inputs that require grad.
"""

from __future__ import annotations

import ctypes
import threading

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of each entry point; the stream is always the last argument
SIGNATURES = {
    "pt_ln_dense": [_P] * 7 + [_I, _I, _I, _F, _I, _P],
    "pt_dense_residual": [_P] * 6 + [_I, _I, _I, _I, _P],
    "pt_ln_mlp": [_P] * 10 + [_I, _I, _I, _F, _I, _I, _P],
    "pt_ln_swiglu": [_P] * 10 + [_I, _I, _I, _F, _I, _P],
    "pt_ln_mlp_w8": [_P] * 12 + [_I, _I, _I, _F, _I, _I, _P],
    "pt_qkv_attention": [_P, _P, _I, _I, _I, _I, _F, _I, _P],
    "pt_qkv_attention_proj": [_P] * 7 + [_I, _I, _I, _I, _F, _I, _P],
    "pt_flash_attention": [_P] * 4 + [_I, _I, _I, _F, _I, _P],
    "pt_flash_attention_1pass": [_P] * 4 + [_I, _I, _I, _F, _I, _P],
    "pt_memory_project": [_P] * 8 + [_I, _I, _I, _I, _I, _F, _I, _I, _P],
    "pt_memory_project_blocks": [_I, _I, _P, _P],
    "pt_memory_project_combine": [_P] * 4 + [_I, _I, _I, _I, _P],
}

DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}

_lock = threading.Lock()
_lib = None
build_seconds = None


def lib() -> ctypes.CDLL:
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            from patchioner_tpu_torch.kernels import build

            path, build_seconds = build.build()
            handle = ctypes.CDLL(path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"the kernels take float32, bfloat16 or int8, got {t.dtype}")
    return DTYPE_CODES[name]


def check_operands(name: str, *tensors, device=None) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor of the first one's type, on `device` (default: the first one's)."""
    dev, dtype = device or tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: every operand must be {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")


def wants_grad(*tensors) -> bool:
    """True when grad mode is on and any tensor requires grad."""
    import torch

    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when the call would need a backward that is not ported: a
    kernel writes its output through a pointer, outside autograd."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{name}: its backward is not ported; call it under torch.no_grad() or "
            "on tensors that do not require grad")


def check_grad_dtype(name: str, t) -> None:
    """The backwards of A, B and C are ported for float32 only."""
    import torch

    if t.dtype != torch.float32:
        raise NotImplementedError(f"{name}: the backward is ported for float32 only, "
                                  f"got {t.dtype}")


def launch(name: str, *args) -> None:
    import torch

    # the current stream's handle without building a Stream object, which
    # took ~9 us a launch on the card; PyTorch's own launchers read it so
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")
