"""Run some phases of a tree's ``chip_smoke.py`` on the card, to compare
two trees (a parent archive and the working tree) in one call.

    python3 scripts/run_phases_torch.py [--root DIR] [--beside-dryrun]
        PHASE [PHASE ...]

Each PHASE names a module-level function of ``DIR/chip_smoke.py`` (DIR
defaults to this repository): a ``check_*`` function that takes ``(timer,
dev)`` gets ``chip_smoke.Timer``, any other ``(dev)``.  The tree's own
``src/`` is imported and its kernels built first.  Each phase prints its
own JSON lines; this script adds one ``{"phase": "timing", ...}`` line per
phase with the tree's root, and exits 1 if a phase raises.  With
``--beside-dryrun`` the dry-run's cells are traced in their background
process (``chip_smoke.start_dryrun_cells``) while the phases run, as in a
whole ``chip_smoke.py`` run: run the same phases with and without it to
see what the traces cost the phases' timings.  Needs CUDA.
"""

import argparse
import importlib
import inspect
import json
import os
import sys
import time


def main(argv=None) -> int:
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--beside-dryrun", action="store_true")
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    if not torch.cuda.is_available():
        print("run_phases_torch: needs a CUDA device", file=sys.stderr)
        return 1
    cs = importlib.import_module("chip_smoke")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    print(json.dumps(dict(phase="build", root=root,
                          seconds=time.perf_counter() - t0)), flush=True)
    dev = torch.device("cuda")
    timer = cs.Timer(dev)
    job = cs.start_dryrun_cells() if args.beside_dryrun else None
    try:
        failed = _run(cs, args.phases, root, timer, dev)
    finally:
        if job is not None:
            # the traces must still be running when the last phase ends
            print(json.dumps(dict(
                phase="dryrun_beside", root=root,
                running_at_end=job["proc"].poll() is None,
                seconds=time.perf_counter() - job["started"])), flush=True)
            cs.stop_dryrun_cells(job)
    return int(failed)


def _run(cs, phases, root, timer, dev) -> bool:
    import torch
    failed = False
    for name in phases:
        fn = getattr(cs, name)
        t0 = time.perf_counter()
        try:
            if "timer" in inspect.signature(fn).parameters:
                fn(timer, dev)
            else:
                fn(dev)
        except AssertionError as e:
            failed = True
            print(json.dumps(dict(phase="failed", of=name, root=root,
                                  error=str(e.args[0]))), flush=True)
        print(json.dumps(dict(phase="timing", of=name, root=root,
                              seconds=time.perf_counter() - t0)), flush=True)
        torch.cuda.empty_cache()
    return failed


if __name__ == "__main__":
    sys.exit(main())
