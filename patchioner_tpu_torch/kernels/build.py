"""Build the port's CUDA kernels with nvcc into one shared library.

The sources are `patchioner_tpu_torch/csrc/*.cu` and `*.cuh`. They expose a
plain C interface, so the library links against nothing of PyTorch and is
loaded with ctypes (`kernels.lib()`). The build happens at first use, into
`build/kernels/<hash>/` at the root of the checkout, where the hash covers
the sources and the compiler flags: an edited source builds anew, an
unchanged one is reused. Each source compiles in its own nvcc process, all
started together, and one more links the objects.
"""

from __future__ import annotations

import glob
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
LIB_NAME = "libpatchioner_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + _headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


def build() -> tuple[str, float]:
    """Return (path of the built library, seconds spent building; 0 when an
    existing build of the same sources was reused)."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib):
        return lib, 0.0
    os.makedirs(out_dir, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{os.getpid()}.partial"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    tmp = f"{lib}.{tag}"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
    log, failed = [], False
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        failed |= proc.returncode != 0
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        failed = proc.returncode != 0
    seconds = time.perf_counter() - t0
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(log))
    os.replace(tmp, lib)
    return lib, seconds


def sass_counts(opcode: str) -> dict:
    """{kernel function: number of SASS instructions of `opcode`} in the
    built library, from cuobjdump (beside nvcc); functions without any are
    left out."""
    lib = os.path.join(BUILD_ROOT, source_hash(), LIB_NAME)
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
        elif fn and f" {opcode}" in line:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def build_log() -> str:
    """The compiler's output of the current build (registers, spills)."""
    path = os.path.join(BUILD_ROOT, source_hash(), "build.log")
    if not os.path.isfile(path):
        return ""
    with open(path) as f:
        return f.read()


def kernel_resources() -> dict:
    """{kernel function: (registers, spill store bytes, spill load bytes)} of
    the current build, from ptxas' -v lines in `build.log`."""
    usage, fn, spills = {}, None, (0, 0)
    for line in build_log().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = (int(m.group(1)), *spills)
            fn = None
    return usage
