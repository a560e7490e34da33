"""Where the time of ``wqt_matmul_a8.cu`` goes at decode: the source is
rebuilt with one part switched off or changed at a time, and each
variant is timed on one Granite layer's 7 weight shapes (M = 8 bf16
activations, int4 per tensor), as the kernel's device time in a
``torch.profiler`` trace and as ``chip_smoke.Timer``'s per-call event
time with a cold L2.

    python3 scripts/ablate_wqt_matmul_a8_torch.py

Variants (the outputs of those marked * are wrong by design; only their
times count):

* ``base``     — the source as it is, from bf16 activations;
* ``codes_in`` — the same build from int8 codes and row scales (no
  absmax, no cluster combine, no quantization arithmetic);
* ``noamax``*  — each block uses its own row maxima: no cluster barrier
  or distributed-shared-memory reads before the quantization;
* ``nomma``*   — each ``mma.sync`` is replaced by an add that keeps its
  operands live;
* ``noload``*  — the ring is filled by the prologue only;
* ``nowork``*  — no K step at all: launch, x slice, row scales, the
  epilogue's cluster reduction and the stores;
* ``divide``   — every activation code from the IEEE division, without
  the reciprocal fast path (the same codes);
* ``nomax``*   — the row maxima are not taken (a constant);
* ``nocode``*  — the x slice is read but no code computed;
* ``stages2`` / ``stages8`` — a cp.async ring 2 or 8 stages deep.

Prints one JSON line per shape with the launch plan and each variant's
device and event microseconds, one with the layer's sums (each shape
times its count), then the card's name and power limit.  Needs CUDA and
``nvcc``; builds into a temporary directory.
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

SRC = os.path.join(ROOT, "src/repro_torch/kernels/wq_matmul/csrc/"
                         "wqt_matmul_a8.cu")
STAGES = "constexpr int kStages = 4;"
# variant -> ((text in the source, its replacement), ...), ring depth
EDITS = {
    "base": ((), 4),
    "noamax": (((
        "    cluster.sync();                  // every block's maxima written\n"
        "    if (threadIdx.x < XM) {\n"
        "      uint32_t v = 0;\n"
        "      for (int r = 0; r < amax_ranks; ++r)\n"
        "        v = max(v, *cluster.map_shared_rank(&smax[threadIdx.x], r));\n",
        "    __syncthreads();\n"
        "    if (threadIdx.x < XM) {\n"
        "      uint32_t v = smax[threadIdx.x];\n"),), 4),
    "nomma": (((
        "        mma_s8(acc[mt], a, b.x, b.y);",
        "        acc[mt][0] += static_cast<int>(a[0] ^ a[1] ^ a[2] ^ a[3] ^ "
        "b.x ^ b.y);"),), 4),
    "noload": (((
        "    if (nx < steps) load_stage(nx % kStages, k_begin + nx * kK);",
        ""),), 4),
    "nowork": (((
        "  const int steps = klen / kK;", "  const int steps = 0;"),), 4),
    "divide": (((
        "  if (fabsf(t - q) < 0.499f)                     // q integral and finite\n",
        "  if (false)\n"),), 4),
    "nomax": (((
        "          v = abs_max16<TX>(xraw + (size_t)m * kps * sizeof(TX) + ch * 16, v);",
        "          v = 0x40000000u;"),), 4),
    "nocode": (((
        "          lo = act_codes4(f, sc, rs);\n"
        "          hi = act_codes4(f + 4, sc, rs);",
        "          lo = __float_as_uint(f[0] * sc) ^ __float_as_uint(f[7] * rs);\n"
        "          hi = lo;"),), 4),
    "stages2": (((STAGES, "constexpr int kStages = 2;"),), 2),
    "stages8": (((STAGES, "constexpr int kStages = 8;"),), 8),
}


def build(tmp):
    from repro_torch.kernels import _build
    src = open(SRC).read()
    procs, libs = [], {}
    for name, (edits, _) in EDITS.items():
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
        lib.wqt_matmul_a8_launch.argtypes = \
            _build.SIGNATURES["wqt_matmul_a8_launch"]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_wqt_matmul_a8_torch: needs a CUDA device",
              file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core.qtensor import quantize_qtensor
    from repro_torch.kernels.wq_matmul import ops, quantize_acts_ref

    dev = torch.device("cuda")
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(6)

    def launch(lib, stages, x, xs, q, out):
        M, K = x.shape
        N = q.codes.shape[0]
        p = ops.a8_plan(M, N, K, -1, 4, x.element_size())
        smem = ops.a8_smem(4, x.element_size(), p.tile_m, p.tile_n,
                           p.k_per_split, -1) + \
            (stages - ops.A8_STAGES) * p.tile_n * (ops.A8_K // 2 + 16)
        err = lib.wqt_matmul_a8_launch(
            x.data_ptr(), xs.data_ptr() if xs is not None else None,
            q.codes.data_ptr(), q.scales.data_ptr(), out.data_ptr(), M, N,
            K, -1, 4, 2 if xs is not None else 1, p.tile_m, p.tile_n,
            p.splits, p.k_per_split, p.amax_ranks, smem,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def device_us(fn, n=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                timer.flush.sum()              # a cold L2, as decoding meets it
                fn()
            torch.cuda.synchronize()
        return sum(getattr(ev, "device_time_total", 0)
                   for ev in prof.key_averages() if "wqt_a8" in ev.key) / n

    sums = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for (n, k), count in cs.LAYER_MATMULS.items():
            w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
            q = quantize_qtensor(w, "int4", -1)
            x = torch.randn((8, k), generator=gen, device=dev).to(
                torch.bfloat16)
            xq, xs = quantize_acts_ref(x)
            out = torch.empty((8, n), dtype=torch.bfloat16, device=dev)
            out32 = torch.empty((8, n), dtype=torch.float32, device=dev)
            row = dict(phase="ablation_a8", N=n, K=k, M=8, count=count,
                       plan=ops.a8_plan(8, n, k, -1, 4, 2)._asdict())
            runs = {name: (lambda lib=lib, st=st: launch(lib, st, x, None, q,
                                                         out))
                    for name, (lib, st) in
                    ((nm, (libs[nm], EDITS[nm][1])) for nm in EDITS)}
            runs["codes_in"] = lambda: launch(libs["base"], 4, xq, xs, q,
                                              out32)
            for name, fn in runs.items():
                dev_us = device_us(fn)
                ev_us = timer(fn, iters=20) * 1e3
                row[name + "_device_us"] = dev_us
                row[name + "_event_us"] = ev_us
                for key, v in ((name + "_device_us", dev_us),
                               (name + "_event_us", ev_us)):
                    sums[key] = sums.get(key, 0.0) + v * count
            print(json.dumps(row), flush=True)
    print(json.dumps(dict(phase="ablation_a8_layer", **sums)), flush=True)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
