"""Where the time of ``decode_attn.cu``'s tensor-core (``mma``) instance
goes: the source is rebuilt with one part switched off at a time and each
variant's kernel device time is read from a ``torch.profiler`` trace (so
the timer's own per-launch cost is not in it).

    python3 scripts/ablate_decode_attn_torch.py

Variants (their outputs are wrong by design; only their times count):

* ``base``    — the source as it is;
* ``noload``  — no ``cp.async`` at all: every tile is computed on whatever
  shared memory holds;
* ``nomma``   — each ``mma.sync`` is replaced by an add that keeps its
  operands live;
* ``nomerge`` — no cluster merge: every block normalizes its own partial
  and writes it (the blocks of a cluster race on the output).

For the check's main shapes (b = 8, g = 8, rep = 4, hd = 64, int8, bf16,
ragged positions, no window) at L = 256 and 4096, ring and paged (blocks
of 16), and at L = 4096 with every pos = 0, prints one JSON line with the
launch plan and the device microseconds of each variant.  Then the plan
sweep: the ring at L = 4096 (ragged) under other split and stage counts
than the plan's (``base`` source, same output bit for bit where the split
count is the plan's), one line each; then the card's name and power
limit.  Needs CUDA and ``nvcc``; builds into a temporary directory.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

SRC = os.path.join(ROOT,
                   "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu")
# (text in the source, its replacement) per variant
EDITS = {
    "base": [],
    "noload": [
        ("  auto load_tile = [&](int slot, int tile) {\n",
         "  auto load_tile = [&](int slot, int tile) {\n"
         "    if (slot >= 0) return;\n")],
    "nomma": [
        ("        mma_bf16(c, a, qf[j][0], qf[j][1]);",
         "        c[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ qf[j][0]"
         " ^ qf[j][1]) & 0x3f800000u);"),
        ("          mma_bf16(acc[(INT4 ? 4 : 2) * blk + j], a, pb.x, pb.y);",
         "          acc[(INT4 ? 4 : 2) * blk + j][0] += __uint_as_float((a[0]"
         " ^ a[1] ^ a[2] ^ a[3] ^ pb.x ^ pb.y) & 0x3f800000u);")],
    "nomerge": [("  if (gridDim.x == 1) {", "  if (gridDim.x > 0) {")],
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
        for fn in ("decode_attn_launch", "decode_attn_paged_launch"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_decode_attn_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels.decode_attn import ops

    dev = torch.device("cuda")
    flush = torch.ones(512 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    b, g, rep, hd = 8, 8, 4, 64

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
                   if "decode_attn" in ev.key) / n

    def ring_call(lib, q, kv, pos, L, **override):
        k, v = kv
        out = torch.empty_like(q)
        p = ops.launch_plan(q, k["codes"], v["codes"], L, 8)._replace(
            **override)
        err = lib.decode_attn_launch(
            q.data_ptr(), k["codes"].data_ptr(), k["scale"].data_ptr(),
            v["codes"].data_ptr(), v["scale"].data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, g, rep, hd, L, 8, 0, 0.0, 1,
            ops.INSTANCES.index(p.instance), p.splits, p.slots_per_split,
            p.tile, p.stages, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def paged_call(lib, q, kv, pos, bt, bs):
        k, v = kv
        out = torch.empty_like(q)
        bps = bt.shape[1]
        p = ops.launch_plan(q, k["codes"], v["codes"], bps * bs, 8)
        err = lib.decode_attn_paged_launch(
            q.data_ptr(), k["codes"].data_ptr(), k["scale"].data_ptr(),
            v["codes"].data_ptr(), v["scale"].data_ptr(), bt.data_ptr(),
            pos.data_ptr(), out.data_ptr(), b, g, rep, hd, bps, bs, 8, 0,
            0.0, 1, ops.INSTANCES.index(p.instance), p.splits,
            p.slots_per_split, p.tile, p.stages,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def ragged(L):
        return torch.tensor([0, 5, L // 3, L - 1, L, L + 7, 2 * L + 3,
                             5 * L - 2], dtype=torch.int32, device=dev)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        cases = []
        for L in (256, 4096):
            q, k, v = cs._attn_inputs(gen, dev, b, L, g, rep, hd, 8,
                                      torch.bfloat16)
            cases.append((dict(kernel="decode_attn", L=L, pos="ragged"),
                          lambda lib, q=q, k=k, v=v, L=L: ring_call(
                              lib, q, (k, v), ragged(L), L), (q, k, L)))
            if L == 4096:
                zero = torch.zeros(b, dtype=torch.int32, device=dev)
                cases.append((dict(kernel="decode_attn", L=L, pos="zero"),
                              lambda lib, q=q, k=k, v=v, L=L: ring_call(
                                  lib, q, (k, v), zero, L), (q, k, L)))
            bs, bps = 16, L // 16
            n_blocks = b * bps + 1
            bt = (torch.randperm(n_blocks - 1, generator=gen, device=dev)
                  + 1).reshape(b, bps).to(torch.int32)
            pq, pk, pv = cs._attn_inputs(gen, dev, n_blocks, bs, g, rep, hd,
                                         8, torch.bfloat16)
            pq = pq[:b].contiguous()
            cases.append((dict(kernel="decode_attn_paged", L=L, pos="ragged"),
                          lambda lib, pq=pq, pk=pk, pv=pv, bt=bt, L=L:
                          paged_call(lib, pq, (pk, pv), ragged(L), bt, 16),
                          (pq, pk, L)))
        for row, fn, (q, k, L) in cases:
            row = dict(phase="ablation", **row,
                       plan=ops.launch_plan(q, k["codes"], k["codes"], L,
                                            8)._asdict())
            for name, lib in libs.items():
                row[name + "_us"] = device_us(lambda: fn(lib))
            print(json.dumps(row), flush=True)
        q, k, v = cs._attn_inputs(gen, dev, b, 4096, g, rep, hd, 8,
                                  torch.bfloat16)
        for splits, stages in ((8, 1), (8, 2), (8, 4), (4, 2), (2, 2)):
            per = 4096 // splits
            us = device_us(lambda: ring_call(
                libs["base"], q, (k, v), ragged(4096), 4096, splits=splits,
                slots_per_split=per, stages=stages))
            print(json.dumps(dict(phase="plan_sweep", kernel="decode_attn",
                                  L=4096, pos="ragged", splits=splits,
                                  slots_per_split=per, stages=stages,
                                  base_us=us)), flush=True)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
