"""Where a training step's time goes: profile the port's LOTION training
of full-width Granite-3-2B (40 layers, batch 4 x 1024, bf16 activations,
fp32 master weights, fused AdamW with the decoupled int4 penalty) on one
GPU.

    python3 scripts/profile_train_torch.py [--steps 2] [--out DIR]

The workload is ``chip_smoke.granite_trainer``'s, the main path that
``chip_smoke.py`` trains.  After one warm-up step, ``--steps`` steps are
timed with the host clock, then one more is profiled with
``torch.profiler``.  Prints one JSON line: the step's wall time, its
device time by kernel group (cuBLAS matmuls, the ``opt_step`` kernel,
reductions, the rest), the top kernels by device time, the aten ops
that launched the most device time, and the device's busy share of the
step.  ``--out`` also gets the Chrome trace.
Needs CUDA.
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

# opt_step: the whole launch, the per-matrix absmax phase included
GROUPS = (("opt_step", ("opt_step_kernel", "opt_step_block_kernel")),
          ("matmul", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "gemv",
                      "nvjet")),
          ("reduction", ("reduce", "Reduce", "softmax", "logsumexp")))


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise, copies and the rest"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import TRAIN_BATCH, TRAIN_SEQ, _pipeline, granite_trainer
    from scripts.profile_serve_torch import _device_by_name

    dev = torch.device("cuda")
    cfg, train_step, _, state = granite_trainer(dev)
    pipe, _ = _pipeline(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    state, _ = train_step(state, next(pipe))                   # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.steps):
        batch = next(pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    batch = next(pipe)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
    pipe.close()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "train_trace.json"))
    kernels = _device_by_name(prof)
    # the aten ops that launched the device time (self time: each kernel
    # counted once, under the op that launched it)
    ops = sorted(((ev.key, getattr(ev, "self_device_time_total", 0) / 1e3,
                   ev.count) for ev in prof.key_averages()
                  if ev.key.startswith("aten::")), key=lambda r: -r[1])
    groups = {}
    for name, (ms, calls) in kernels.items():
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += ms
        g[1] += calls
    device_ms = sum(ms for ms, _ in kernels.values())
    wall = sorted(walls)[len(walls) // 2]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    print(json.dumps(dict(
        phase="profile_train", model=cfg.name, n_layers=cfg.n_layers,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtype=str(cfg.dtype),
        step_wall_ms=walls, step_device_ms=device_ms,
        device_busy_share=device_ms / wall,
        launches=sum(c for _, c in kernels.values()),
        groups={k: dict(device_ms=v[0], launches=v[1])
                for k, v in groups.items()},
        top=[dict(name=k[:80], device_ms=ms, calls=c)
             for k, (ms, c) in top],
        top_ops=[dict(op=k, device_ms=ms, calls=c)
                 for k, ms, c in ops[:15] if ms > 0],
        loss=float(m["loss"]), nvidia_smi=os.popen(
            "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader"
        ).read().strip())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
