"""Local-memory use of the port's CUDA kernels, per kernel: ptxas's
registers and stack frame, and the static count of local loads (LDL) and
stores (STL) in the SASS.  A kernel whose arrays the compiler could not
keep in registers shows a stack frame and LDL/STL here.

    python tools/kernel_local_memory.py yin feat

compiles each named ``soundswallower_tpu_torch/csrc/<name>.cu`` with the
build's own flags (``cuda_build.NVCC_FLAGS``) into a temporary directory
and prints one line a kernel.  Needs ``nvcc`` and ``cuobjdump``.
"""

import collections
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from soundswallower_tpu_torch.utils import cuda_build  # noqa: E402


def report(name: str, tmp: str) -> None:
    nvcc = cuda_build.nvcc_path()
    src = os.path.join(cuda_build.CSRC, f"{name}.cu")
    obj = os.path.join(tmp, f"{name}.o")
    log = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-c", "-o", obj, src], capture_output=True,
                         text=True, check=True).stderr
    ptxas = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and fn:
            ptxas.setdefault(fn, {})["stack"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            ptxas.setdefault(fn, {})["regs"] = int(m.group(1))
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", obj], capture_output=True, text=True,
                          check=True).stdout
    counts = collections.defaultdict(collections.Counter)
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
        elif fn:
            for op in ("LDL", "STL"):
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    for fn in sorted(ptxas):
        p, c = ptxas[fn], counts[fn]
        print(f"{name}: {fn}: {p.get('regs')} registers, stack "
              f"{p.get('stack')} bytes, LDL {c['LDL']}, STL {c['STL']}")


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        for name in sys.argv[1:]:
            report(name, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
