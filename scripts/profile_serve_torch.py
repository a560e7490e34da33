"""Where a decode step's time goes: profile the port's ``Engine`` serving
full-width Granite-3-2B (int4 weights, int8 KV, batch 8) on one GPU.

    python3 scripts/profile_serve_torch.py [--steps 8] [--out DIR]

The workload is ``chip_smoke.granite_engine``'s, the main path that
``chip_smoke.py`` serves.  Two ``generate`` calls are timed with the host clock and profiled with
``torch.profiler``: one that only prefills (``max_new_tokens=1``) and one
that also decodes ``steps - 1`` tokens.  Their difference, divided by the
decode steps, gives each decode step's wall time, device time per kernel
name and launch count, and the device's busy share of the step.  Prints
one JSON line; writes the Chrome trace of the longer call to ``--out``.
Needs CUDA.
"""

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def _device_by_name(prof):
    """{kernel name: (device ms, launches)}.  Only the device-side kernel
    events count: an aten op's self device time repeats its kernels'."""
    from torch.autograd import DeviceType
    events = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            events.append((ev, us))
    kernels = [(ev, us) for ev, us in events
               if getattr(ev, "device_type", None) == DeviceType.CUDA]
    if not kernels:          # older profilers tag kernels by name only
        kernels = [(ev, us) for ev, us in events
                   if not ev.key.startswith("aten::")]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    out = defaultdict(lambda: [0.0, 0])
    for ev, us in kernels:
        out[ev.key][0] += us / 1e3
        out[ev.key][1] += ev.count
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import granite_engine

    cfg, eng, prompts = granite_engine(torch.device("cuda"), args.steps)
    eng.generate(prompts, max_new_tokens=2)                    # warm-up

    def wall(mnt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=mnt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def profiled(mnt):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.generate(prompts, max_new_tokens=mnt)
            torch.cuda.synchronize()
        return prof

    t_prefill, t_all = wall(1), wall(args.steps)
    p_prefill, p_all = profiled(1), profiled(args.steps)
    os.makedirs(args.out, exist_ok=True)
    p_all.export_chrome_trace(os.path.join(args.out, "serve_trace.json"))

    n_dec = args.steps - 1
    pre, full = _device_by_name(p_prefill), _device_by_name(p_all)
    step = {k: ((full[k][0] - pre.get(k, (0.0, 0))[0]) / n_dec,
                (full[k][1] - pre.get(k, (0.0, 0))[1]) / n_dec) for k in full}
    step_ms = (t_all - t_prefill) / n_dec
    step_dev = sum(ms for ms, _ in step.values())
    prefill_dev = sum(ms for ms, _ in pre.values())
    top = sorted(step.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps(dict(
        phase="profile", model=cfg.name, batch=len(prompts),
        decode_steps=n_dec, prefill_ms=t_prefill, prefill_device_ms=prefill_dev,
        decode_ms_per_step=step_ms, decode_device_ms_per_step=step_dev,
        decode_device_busy_share=step_dev / step_ms,
        decode_launches_per_step=sum(c for _, c in step.values()),
        decode_top=[dict(name=k[:80], device_ms=ms, calls=c)
                    for k, (ms, c) in top])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
