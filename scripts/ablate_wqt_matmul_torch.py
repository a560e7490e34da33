"""Where the time of ``wqt_matmul.cu``'s tensor-core instances goes: the
source is rebuilt with one part switched off at a time and each variant's
kernel device time is read from a ``torch.profiler`` trace.

    python3 scripts/ablate_wqt_matmul_torch.py

Variants (their outputs are wrong by design; only their times count):

* ``base``   — the source as it is;
* ``nodq``   — the code words go to the tensor cores undequantized;
* ``nomma``  — each ``mma.sync`` is replaced by an add that keeps its
  operands live;
* ``noload`` — the ring is filled by the prologue only, so the main loop
  issues no ``cp.async`` and computes on stale tiles.

For each of one Granite layer's weight shapes (int4, per tensor and
block 128) at M = 8 (GEMV) and M = 1024 (GEMM), prints one JSON line with
the launch plan and the device microseconds of each variant, then the
card's name and power limit.  Needs CUDA and ``nvcc``; builds into a
temporary directory.
"""

import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

SRC = os.path.join(ROOT, "src/repro_torch/kernels/wq_matmul/csrc/wqt_matmul.cu")
# (text in the source, its replacement) per variant
EDITS = {
    "base": [],
    "nodq": [
        ("      dequant4<INT4>(code_word<INT4, KMAJOR, Codes::kStride>(cs, r0, kk),\n"
         "                     a[0], a[2]);",
         "      a[0] = code_word<INT4, KMAJOR, Codes::kStride>(cs, r0, kk);\n"
         "      a[2] = a[0] ^ 5u;"),
        ("      dequant4<INT4>(code_word<INT4, KMAJOR, Codes::kStride>(cs, r0 + 8, kk),\n"
         "                     a[1], a[3]);",
         "      a[1] = code_word<INT4, KMAJOR, Codes::kStride>(cs, r0 + 8, kk);\n"
         "      a[3] = a[1] ^ 5u;"),
        ("  dequant4<INT4>(h, b0, b1);", "  b0 = h;\n  b1 = h ^ 5u;")],
    "nomma": [
        ("        mma_bf16(part[mt], a, b.x, b.y);",
         "        part[mt][0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b.x ^ b.y) & 0x3f800000u);"),
        ("        for (int mi = 0; mi < 4; ++mi) mma_bf16(part[mi][ni], af[mi], b0, b1);",
         "        for (int mi = 0; mi < 4; ++mi) part[mi][ni][0] += __uint_as_float((af[mi][0] ^ af[mi][3] ^ b0 ^ b1) & 0x3f800000u);")],
    "noload": [
        ("    if (nx < steps) load_stage(nx % kGvStages, k_begin + nx * kGvK);", ""),
        ("    if (nx < steps) load_stage(nx % S, k_begin + nx * kGmK);", "")],
}


def build(tmp):
    from repro_torch.kernels import _build
    src = open(SRC).read()
    libs, procs = {}, []
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
        open(cu, "w").write(text)
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", os.path.dirname(SRC),
             "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(so)
        lib.wqt_matmul_launch.argtypes = _build.SIGNATURES["wqt_matmul_launch"]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_wqt_matmul_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core.qtensor import quantize_qtensor
    from repro_torch.kernels.wq_matmul import ops

    dev = torch.device("cuda")
    flush = torch.ones(512 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    def launch(lib, x, q, bk):
        M, K = x.shape
        N = q.codes.shape[0]
        out = torch.empty((M, N), dtype=x.dtype, device=dev)
        p = ops.launch_plan(x, q.codes, bk, 4)
        err = lib.wqt_matmul_launch(
            x.data_ptr(), q.codes.data_ptr(), q.scales.data_ptr(),
            out.data_ptr(), None, None, M, N, K, bk, 4, 1,
            ops.INSTANCES.index(p.instance), p.tile_m, p.tile_n, p.splits,
            p.k_per_split, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def device_us(fn, n=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.sum()                    # a cold L2, as decoding meets it
                fn()
            torch.cuda.synchronize()
        return sum(getattr(ev, "device_time_total", 0)
                   for ev in prof.key_averages()
                   if "gemv_kernel" in ev.key or "gemm_kernel" in ev.key) / n

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for n, k in cs.LAYER_MATMULS:
            w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
            for bk in (-1, 128):
                q = quantize_qtensor(w, "int4", bk)
                for m in (8, 1024):
                    x = torch.randn((m, k), generator=gen, device=dev).to(
                        torch.bfloat16)
                    row = dict(phase="ablation", N=n, K=k, M=m, block_k=bk,
                               plan=ops.launch_plan(x, q.codes, bk, 4)._asdict())
                    for name, lib in libs.items():
                        row[name + "_us"] = device_us(
                            lambda: launch(lib, x, q, bk))
                    print(json.dumps(row), flush=True)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
