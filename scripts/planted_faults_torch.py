"""How much a wrong training kernel moves ``chip_smoke.py``'s card-against-
CPU training check: run that phase (2-layer Granite-3-2B at full width,
fp32, 3 LOTION steps, then the fp32 and RTN eval CE) once sound and once
with each fault planted on the card side only, by patching a wrapper for
the length of the run:

* ``no_penalty``    — ``opt_step`` with lam = 0 (the decoupled penalty dropped);
* ``no_update``     — ``opt_step`` with ok = 0 (no parameter update);
* ``unrounded_rtn`` — the RTN eval cast returns the weights unrounded.

    python3 scripts/planted_faults_torch.py

Prints one JSON line per run with the phase's ``max_rel_diff`` against its
limit and whether the phase failed, as each planted fault should.  The
code in the repository is not changed.  Needs CUDA.
"""

import contextlib
import json
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


@contextlib.contextmanager
def _patched(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _step_with(**override):
    def wrap(orig):
        def step(w, *args, **kw):
            if w.is_cuda:
                kw.update(override)
            return orig(w, *args, **kw)
        return step
    return wrap


def _unrounded(orig):
    def rtn(x, fmt_name, block_size=-1):
        return x.clone() if x.is_cuda else orig(x, fmt_name, block_size)
    return rtn


def main() -> int:
    if not torch.cuda.is_available():
        print("planted_faults_torch: needs a CUDA device", file=sys.stderr)
        return 1
    import repro_torch.kernels.quant as quant
    import repro_torch.optim.fused as fused
    from chip_smoke import TRAIN_CPU_RTOL, train_card_vs_cpu

    dev = torch.device("cuda")
    faults = {"sound": contextlib.nullcontext(),
              "no_penalty": _patched(fused, "fused_opt_step_leaf",
                                     _step_with(lam=0.0)),
              "no_update": _patched(fused, "fused_opt_step_leaf",
                                    _step_with(ok=0.0)),
              "unrounded_rtn": _patched(quant, "quant_rtn", _unrounded)}
    bad = False
    for name, ctx in faults.items():
        with ctx:
            try:
                row, failed = train_card_vs_cpu(dev), False
            except AssertionError as e:
                row, failed = e.args[1], True
        print(json.dumps(dict(phase="planted_fault", fault=name,
                              max_rel_diff=row["max_rel_diff"],
                              rtol=TRAIN_CPU_RTOL, phase_failed=failed)),
              flush=True)
        bad |= failed != (name != "sound")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    return int(bad)


if __name__ == "__main__":
    sys.exit(main())
