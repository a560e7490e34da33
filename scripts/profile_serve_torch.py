"""Where a serving step's time goes on one GPU, for full-width
Granite-3-2B or another config of the port.

    python3 scripts/profile_serve_torch.py [--workload engine|sched]
                                           [--steps 8] [--out DIR]
                                           [--arch ARCH [--layers N]
                                            [--prompt-len L]]

``--workload engine`` (the default) profiles the static ``Engine`` (int4
weights, int8 KV, batch 8), ``chip_smoke.granite_engine``'s workload: two
``generate`` calls are timed with the host clock and profiled with
``torch.profiler``, one that only prefills (``max_new_tokens=1``) and one
that also decodes ``steps - 1`` tokens; their difference, divided by the
decode steps, gives each decode step's wall time, device time per kernel
name and launch count, the decode attention kernels' device time, and
the device's busy share of the step; and the prefill's device time per
kernel name.  ``--arch`` serves that config instead (random weights from
seed 0, int4 QTensors with MoE experts as the dense cast, int8 KV, 8
prompts of 64-128 tokens or of ``--prompt-len``), its depth cut to
``--layers``.

``--workload sched`` profiles the continuous-batching ``Scheduler`` (W4A8,
paged int8 KV pool, chunked prefill with the prefix trie),
``chip_smoke.sched_full_width``'s workload: its 16 requests are submitted
at once and ``steps`` scheduler steps (each one prefill chunk and one
tick of 4 decode steps) are profiled after 3 unprofiled ones, giving the
same numbers per scheduler step, with the W4A8 kernels and the torch
kernels of the kind an activation row quantizer launches (reductions,
abs, round, clamp, where, divisions, casts) by name.

Prints one JSON line; writes the Chrome trace of the profiled window to
``--out``.  Needs CUDA.
"""

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np
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


def _top(by_name, per, n=12):
    return [dict(name=k[:80], device_ms=ms / per, calls=c / per)
            for k, (ms, c) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][0])[:n]]


def _attn_ms(by_name):
    """Device ms of the decode attention kernels (ring and paged)."""
    return sum(v[0] for k, v in by_name.items() if "decode_attn" in k)


# kernel-name fragments of the activation row quantizer's torch kernels
# (amax, abs, compare, where, divide, round, clamp, cast), which the KV
# quantizer also launches; the W4A8 kernel's own names
QUANT_LIKE = ("reduce_kernel", "abs", "round", "clamp", "where", "div",
              "compare", "copy_kernel")
A8_NAMES = ("wqt_a8", "a8_epilogue")


def _by_group(by_name, per, frags):
    """{name: [device ms, launches] per step} of the kernels whose name
    holds one of ``frags``."""
    return {k[:100]: [ms / per, c / per] for k, (ms, c) in by_name.items()
            if any(f in k for f in frags)}


def profile_sched(args) -> int:
    """``steps`` steady scheduler steps of the sched workload, profiled."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _prompts, granite_scheduler, sched_workload

    cfg, sch = granite_scheduler(torch.device("cuda"))
    sch.generate(_prompts(np.random.default_rng(5), 2, 20, 40, cfg.vocab),
                 max_new_tokens=5)                      # warm-up
    for w in sched_workload(cfg.vocab):
        sch.submit(w.prompt, w.max_new_tokens)
    for _ in range(3):
        sch.step()
    ticks0, chunks0 = sch.n_ticks, sch.n_prefills
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            sch.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ticks, chunks = sch.n_ticks - ticks0, sch.n_prefills - chunks0
    sch.run()
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "sched_trace.json"))
    by_name = _device_by_name(prof)
    dev_ms = sum(ms for ms, _ in by_name.values())
    n = args.steps
    print(json.dumps(dict(
        phase="profile_sched", model=cfg.name, steps=n,
        ticks=ticks, decode_steps=ticks * sch.sched.steps_per_tick,
        prefill_chunks=chunks,
        step_ms=wall_ms / n, step_device_ms=dev_ms / n,
        device_busy_share=dev_ms / wall_ms,
        launches_per_step=sum(c for _, c in by_name.values()) / n,
        decode_attn_device_ms=_attn_ms(by_name) / n,
        w4a8_kernels=_by_group(by_name, n, A8_NAMES),
        quantizer_like_kernels=_by_group(by_name, n, QUANT_LIKE),
        top=_top(by_name, n))), flush=True)
    return 0


def zoo_engine(dev, arch, n_layers, prompt_len, mnt):
    """``arch`` at full width (depth ``n_layers`` where given) served by
    the static Engine as ``chip_smoke.py``'s zoo phases serve it."""
    from chip_smoke import _prompts, zoo_cfg
    from repro_torch.models.lm import lm_init
    from repro_torch.serve import Engine, ServeConfig
    cfg = zoo_cfg(arch, n_layers)
    params = lm_init(cfg, seed=0, device=dev)
    eng = Engine(cfg, params, ServeConfig(weights="rtn:int4", kv_quant="int8",
                                          max_new_tokens=mnt), device=dev)
    del params
    torch.cuda.empty_cache()
    lo, hi = (prompt_len, prompt_len) if prompt_len else (64, 128)
    return cfg, eng, _prompts(np.random.default_rng(0), 8, lo, hi, cfg.vocab)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("engine", "sched"),
                    default="engine")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--arch", default=None,
                    help="profile this config's Engine instead of Granite")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve_torch: needs a CUDA device", file=sys.stderr)
        return 1
    if args.workload == "sched":
        return profile_sched(args)
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import granite_engine

    if args.arch:
        cfg, eng, prompts = zoo_engine(torch.device("cuda"), args.arch,
                                       args.layers, args.prompt_len,
                                       args.steps)
    else:
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
        phase="profile", model=cfg.name, n_layers=cfg.n_layers,
        batch=len(prompts), prompt_lens=sorted({len(p) for p in prompts}),
        decode_steps=n_dec, prefill_ms=t_prefill, prefill_device_ms=prefill_dev,
        decode_ms_per_step=step_ms, decode_device_ms_per_step=step_dev,
        decode_device_busy_share=step_dev / step_ms,
        decode_launches_per_step=sum(c for _, c in step.values()),
        decode_attn_device_ms=_attn_ms(step),
        decode_top=[dict(name=k[:80], device_ms=ms, calls=c)
                    for k, (ms, c) in top],
        prefill_top=_top(pre, 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
