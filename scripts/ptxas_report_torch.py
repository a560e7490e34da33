"""Registers, shared memory and spills of every kernel instance in the
port's CUDA sources, as ``ptxas -v`` reports them for sm_90a.

    python3 scripts/ptxas_report_torch.py [source.cu ...]

Compiles each source (default: all of ``src/repro_torch/kernels/*/csrc``)
with the build's flags plus ``-Xptxas -v`` into a temporary object and
prints one JSON line per kernel instance: its demangled-enough name,
registers, static shared memory, stack and spill bytes.  Needs ``nvcc``
(the machine with the card); dynamic shared memory is set at launch and
is not in the report.
"""

import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def report(src: str):
    from repro_torch.kernels import _build
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", src,
             "-o", os.path.join(tmp, "k.o")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    rows, cur = [], None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(source=os.path.relpath(src, ROOT), kernel=m.group(1))
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return rows


def main() -> int:
    from repro_torch.kernels import _build
    srcs = sys.argv[1:] or [str(s) for s in _build.sources()]
    for src in srcs:
        for row in report(src):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
