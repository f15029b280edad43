"""The ctypes contract of the port's CUDA kernels, without nvcc or a card.

Every `extern "C" int pt_*(...)` in `patchioner_tpu_torch/csrc/*.cu` must
have an entry in `kernels.SIGNATURES` with one ctypes type per C argument:
`c_void_p` for a pointer (the stream included), `c_int` for an int and
`c_float` for a float. A pointer declared as an int would be cut to 32 bits
by ctypes without a word, which is what this test guards against.
"""

import ctypes
import glob
import os
import re

import pytest

from patchioner_tpu_torch import kernels
from patchioner_tpu_torch.kernels import build

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(pt_\w+)\s*\(([^)]*)\)', re.S)


def _entry_points() -> dict:
    found = {}
    for path in glob.glob(os.path.join(build.CSRC_DIR, "*.cu")):
        with open(path) as f:
            for name, args in _ENTRY.findall(f.read()):
                assert name not in found, f"{name} defined twice"
                found[name] = (os.path.basename(path), [a.strip() for a in args.split(",")])
    return found


def _ctype(decl: str):
    """The ctypes type a C parameter declaration needs."""
    if "*" in decl:
        return ctypes.c_void_p
    base = decl.replace("const", "").split()[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[base]


ENTRY_POINTS = _entry_points()


def test_every_entry_point_has_a_signature_and_back():
    assert sorted(ENTRY_POINTS) == sorted(kernels.SIGNATURES)


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    source, decls = ENTRY_POINTS[name]
    want = [_ctype(d) for d in decls]
    got = kernels.SIGNATURES[name]
    assert len(got) == len(want), f"{source}:{name} takes {len(want)} arguments"
    for i, (g, w, d) in enumerate(zip(got, want, decls)):
        assert g is w, f"{source}:{name} argument {i} ({d}) needs {w.__name__}"
    assert want[-1] is ctypes.c_void_p and decls[-1].endswith("stream")
