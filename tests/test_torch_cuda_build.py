"""The kernel library's ctypes signatures (``cuda_build._SIGS``) against
the launchers' declarations in ``csrc/sst_kernels.h``, on the CPU.

ctypes passes an argument past the listed ones as a C int, so a list one
short cuts the last pointer (the stream) to 32 bits: a launch on the
default stream still works, on any other it takes a bad handle.  Each
list must name every parameter with its type."""

import ctypes
import os
import re

from soundswallower_tpu_torch.utils import cuda_build

TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
         "double": ctypes.c_double}


def declarations() -> dict:
    """{name: [ctypes type of each parameter]} of the header's launchers."""
    with open(os.path.join(cuda_build.CSRC, "sst_kernels.h")) as f:
        text = f.read()
    out = {}
    for name, params in re.findall(r"\b(?:int|int64_t|const char\*) "
                                   r"(sst_\w+)\(([^)]*)\);", text):
        types = []
        for param in params.split(","):
            typ = param.replace("*", " * ").split()[:-1]
            if "*" in typ or typ == ["cudaStream_t"]:
                types.append(ctypes.c_void_p)
            else:
                types.append(TYPES[" ".join(typ)])
        out[name] = types
    return out


def test_signatures_match_the_header():
    decl = declarations()
    assert "sst_ms_senone_eval" in decl and "sst_fe_spec" in decl
    for name, argtypes in cuda_build._SIGS.items():
        assert name in decl, name
        assert argtypes == decl[name], name
    # every launcher the header declares is bound
    assert set(decl) - set(cuda_build._SIGS) <= {"sst_error_string"}
