"""Host cost of the testbeds' LOTION step on the card, for comparing two
trees (a parent archive and the working tree) in one call.

    python3 scripts/bench_synth_host_torch.py [--root DIR] [--repeats 3]

With DIR's own ``src/`` (default: this repository) it prints one JSON
line: the device activities (kernels, memsets, copies) that
``torch.profiler`` records per ``lotion_penalty_fused_vg`` call at
§4.1's (12000,) leaf and at Granite-3-2B's (40, 2048, 8192) leaf (int4
per matrix, 4 calls each), the host us to enqueue one call at (12000,)
(the median over 5 batches of 1000 calls, no synchronization inside a
batch), the us of one call followed by a synchronize (median of 1000),
and the seconds of ``repeats`` 8000-step §4.1 runs (``quadratic_train``
at lr 1.2, synchronized) of LOTION and of PTQ, alternating; then the
card's name and power limit.  The host clock of a one-card machine
varies with its neighbours: run the trees in turns and compare medians.
Needs CUDA.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def device_activities(fn, calls: int = 4) -> dict:
    """{name: count per call} of the device activities ``calls`` calls of
    ``fn`` record under ``torch.profiler`` (after one warm call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count / calls for ev in prof.key_averages()
            if getattr(ev, "device_type", None) == DeviceType.CUDA}


def main(argv=None) -> int:
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        print("bench_synth_host_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.lotion_reg import lotion_penalty_fused_vg
    from repro_torch.train import synthetic as syn
    dev = torch.device("cuda")
    spec, w_star = syn.problem(syn.PAPER_D, dev)
    w = w_star * 0.5

    def call():
        return lotion_penalty_fused_vg(w, spec, syn.FMT, -1, syn.QUAD_LAM)

    per_call = {}
    for shape, x, f in (((syn.PAPER_D,), w, spec),
                        ((40, 2048, 8192), None, None)):
        if x is None:
            gen = torch.Generator(device=dev).manual_seed(5)
            x = torch.randn(shape, generator=gen, device=dev) * 0.02
            f = torch.rand(shape, generator=gen, device=dev)
        per_call["x".join(map(str, shape))] = device_activities(
            lambda: lotion_penalty_fused_vg(x, f, syn.FMT, -1, 1e3))
        del x, f
    torch.cuda.empty_cache()
    for _ in range(100):
        call()
    torch.cuda.synchronize()
    enqueue = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(1000):
            call()
        enqueue.append((time.perf_counter() - t0) / 1000 * 1e6)
        torch.cuda.synchronize()
    synced = []
    for _ in range(1000):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e6)
    runs = {"lotion": [], "ptq": []}
    for _ in range(args.repeats):
        for method in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            syn.quadratic_train(w_star, spec, 1.2, method)
            torch.cuda.synchronize()
            runs[method].append(time.perf_counter() - t0)
    print(json.dumps(dict(
        root=root, device_activities_per_call=per_call, shape=[syn.PAPER_D],
        enqueue_us=statistics.median(enqueue), enqueue_batches_us=enqueue,
        synced_us=statistics.median(synced), quadratic_s=runs,
        quadratic_median_s={m: statistics.median(v)
                            for m, v in runs.items()})), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
