"""Where ``lotion_reg``'s two per-matrix regimes cross: the same leaves
through the one-cluster launch (clusters of at most 16 or 8 blocks, grains
of 2048, 4096 or 8192 elements a block) and through the cooperative grid,
each checked against the plain version and timed on the card; and the
blockwise kernel's occupancy.

    python3 scripts/ablate_lotion_reg_torch.py

For each single-matrix leaf (the testbeds' (1, 16) and (12000,), (k,
12000) for k from 16 to 512, Granite's (40, 2048)) and each setting it
prints one JSON line: the plan, the device ms of one call
(``chip_smoke.Timer``: CUDA events, a cold L2) and the host us to enqueue
one call (wall clock over 200 calls with no synchronization); then the
leaf size above which the grid is faster than the best cluster setting.
``kernels/lotion_reg/ops.py``'s ``CLUSTER_NUMEL`` is read from this.

Then the blockwise kernel (block 128, int4 and fp4, at Granite leaves),
rebuilt from ``csrc/lotion_reg.cu`` as it is (``base``: fp4 element by
element, INT grids as float4), with ``__launch_bounds__(256, 6)`` or
``(256, 8)`` on it (at most 40 or 32 registers, so 6 or 8 blocks an SM
in its cooperative grid: ``lb6``, ``lb8``), with fp4 as float4 too
(``fp4_vec``), or with a prefetch of f's 16 bytes to L1 issued in the
absmax pass, so that the gradient pass does not wait a second round trip
(``pf_l1``): one JSON line per (variant, shape, format) with the blocks
an SM and the device ms.  Then the card's
name and power limit.  Needs CUDA and ``nvcc``.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

SHAPES = [(1, 16), (12000,), (40, 2048), (16, 12000), (32, 12000),
          (64, 12000), (96, 12000), (128, 12000), (192, 12000),
          (256, 12000), (512, 12000)]
# (name, regime, cluster_max, grain)
SETTINGS = [("cluster16", "cluster", 16, 4096),
            ("cluster16_g2048", "cluster", 16, 2048),
            ("cluster16_g8192", "cluster", 16, 8192),
            ("cluster8", "cluster", 8, 4096),
            ("grid", "grid", 16, 4096)]
LAM = 0.5

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/lotion_reg/csrc/"
                      "lotion_reg.cu")
BLOCK_KERNEL = "__launch_bounds__(kThreads)\nreg_block_kernel("
# the absmax pass's vector and scalar bodies; the prefetch variants ask
# for f's 16 (or 4) bytes there, so the gradient pass finds them on chip
SCAN_W = ("          m = max(m, qm::abs_bits4(*reinterpret_cast<const "
          "float4*>(w + i)));")
PREFETCH_F = ('asm volatile("prefetch.global.{} [%0];" :: "l"(f + i));\n')
FP4_VEC = ("const bool v4 = !FP4 && a.vec", "const bool v4 = a.vec")
BLOCK_VARIANTS = {
    "base": [],
    "lb6": [(BLOCK_KERNEL, BLOCK_KERNEL.replace("kThreads)", "kThreads, 6)"))],
    "lb8": [(BLOCK_KERNEL, BLOCK_KERNEL.replace("kThreads)", "kThreads, 8)"))],
    "fp4_vec": [FP4_VEC],
    "pf_l1": [(SCAN_W, PREFETCH_F.format("L1") + SCAN_W)],
}
BLOCK_SHAPES = [(40, 2048, 512), (49155, 2048), (40, 2048, 8192)]


def build_variants(tmp):
    """One shared library per blockwise variant, compiled in parallel (the
    copies include quant_math.cuh through -I the source's directory)."""
    from repro_torch.kernels import _build
    text = open(SOURCE).read()
    procs = []
    for name, edits in BLOCK_VARIANTS.items():
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            t = t.replace(old, new)
        cu = os.path.join(tmp, name + ".cu")
        so = os.path.join(tmp, name + ".so")
        open(cu, "w").write(t)
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
             os.path.dirname(SOURCE), "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(so)
        for fn in ("lotion_reg_launch", "lotion_reg_blocks_per_sm"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def block_rows(cs, timer, dev):
    """The blockwise variants, each launched as the wrapper launches it."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.lotion_reg import reg_ref
    from repro_torch.kernels.lotion_reg import ops as reg_ops
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(8)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for shape in BLOCK_SHAPES:
            w = torch.randn(shape, generator=gen, device=dev) * 0.02
            f = torch.rand(shape, generator=gen, device=dev) * 1e-6
            n = w.numel()
            for fmt in ("int4", "fp4"):
                fp4 = int(fmt == "fp4")
                pen_ref, grad_ref = reg_ref(w, f, fmt, 128, 1e3)
                for name, lib in libs.items():
                    per_sm = lib.lotion_reg_blocks_per_sm(2, fp4)
                    p = reg_ops.plan(n, n, 128, per_sm * sms)

                    def run():
                        grad = torch.empty_like(w)
                        pen = torch.empty((), device=dev)
                        scratch = torch.empty(8 * p.blocks, device=dev,
                                              dtype=torch.uint8)
                        err = lib.lotion_reg_launch(
                            w.data_ptr(), f.data_ptr(), grad.data_ptr(),
                            scratch.data_ptr(), pen.data_ptr(), n, n, 0, 0, 0,
                            128, 2, fp4, float(get_format(fmt).qmax), 500.0,
                            p.blocks, p.sum_blocks, None,
                            torch.cuda.current_stream(dev).cuda_stream)
                        if err:
                            raise RuntimeError(f"{name}: CUDA error {err}")
                        return pen, grad
                    pen, grad = run()
                    torch.cuda.synchronize()
                    ok = bool(torch.equal(grad, grad_ref)) and float(
                        (pen - pen_ref).abs() / pen_ref.abs()) <= \
                        cs.PENALTY_RTOL
                    row = dict(part="blockwise", variant=name,
                               shape=cs._fmt_shape(shape), fmt=fmt,
                               blocks_per_sm=per_sm, blocks=p.blocks,
                               ms=timer(run), correct=ok)
                    print(json.dumps(row), flush=True)
                    if not ok:
                        raise AssertionError(f"lotion_reg disagrees: {row}")
                del pen_ref, grad_ref
            del w, f


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_lotion_reg_torch: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.lotion_reg import lotion_penalty_fused_vg, reg_ref
    from repro_torch.kernels.lotion_reg import ops as reg_ops
    from repro_torch.kernels.quant import ops as quant_ops
    dev = torch.device("cuda")
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    plan0, launch_plan0 = reg_ops.CLUSTER_NUMEL, reg_ops.launch_plan
    grain0 = reg_ops.CLUSTER_GRAIN
    by_shape = {}
    for shape in SHAPES:
        w = torch.randn(shape, generator=gen, device=dev) * 0.02
        f = torch.rand(shape, generator=gen, device=dev)
        pen_ref, grad_ref = reg_ref(w, f, "int4", -1, LAM)
        n = w.numel()
        for name, regime, cluster_max, grain in SETTINGS:
            reg_ops.CLUSTER_NUMEL = n if regime == "cluster" else 0
            reg_ops.CLUSTER_GRAIN = grain

            def forced(x, fmt_name, block_size, cluster_max=cluster_max):
                co = torch.cuda.get_device_properties(dev).multi_processor_count
                co *= reg_ops._build.lib().lotion_reg_blocks_per_sm(1, 0)
                return reg_ops.plan(x.numel(), quant_ops.matrix_numel(x),
                                    block_size, co, cluster_max)
            reg_ops.launch_plan = forced
            try:
                p = forced(w, "int4", -1)
                pen, grad = lotion_penalty_fused_vg(w, f, "int4", -1, LAM)
                torch.cuda.synchronize()
                ok = bool(torch.equal(grad, grad_ref)) and float(
                    (pen - pen_ref).abs() / pen_ref.abs()) <= cs.PENALTY_RTOL
                ms = timer(lambda: lotion_penalty_fused_vg(w, f, "int4", -1,
                                                           LAM), iters=20)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    lotion_penalty_fused_vg(w, f, "int4", -1, LAM)
                host_us = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
            finally:
                reg_ops.CLUSTER_NUMEL, reg_ops.launch_plan = plan0, launch_plan0
                reg_ops.CLUSTER_GRAIN = grain0
            row = dict(shape=cs._fmt_shape(shape), n=n, setting=name,
                       plan=p._asdict(), ms=ms, host_us=host_us, correct=ok,
                       bound_ms=n * 12 / cs.HBM_BYTES_PER_S * 1e3)
            print(json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(f"lotion_reg disagrees: {row}")
            by_shape.setdefault(n, {})[name] = ms
        del w, f, pen_ref, grad_ref
    grid_wins = [n for n, t in sorted(by_shape.items())
                 if t["grid"] < min(v for k, v in t.items() if k != "grid")]
    print(json.dumps(dict(summary="crossover",
                          smallest_n_grid_faster=min(grid_wins, default=None),
                          by_n=by_shape)), flush=True)
    block_rows(cs, timer, dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
