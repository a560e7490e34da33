"""How much a wrong kernel or a wrong piece of the serving path moves
``chip_smoke.py``'s card-against-CPU and ring-against-paged checks: run
each of those phases once sound and once with each fault planted on the
card side only, by patching a function for the length of the run.

Training (phase ``train_card_vs_cpu``: 2-layer Granite-3-2B at full width,
fp32, 3 LOTION steps, then the fp32 and RTN eval CE):

* ``no_penalty``    — ``opt_step`` with lam = 0 (the decoupled penalty dropped);
* ``no_update``     — ``opt_step`` with ok = 0 (no parameter update);
* ``unrounded_rtn`` — the RTN eval cast returns the weights unrounded.

Scheduling (phases ``sched_card_vs_cpu`` and ``sched_ring_vs_paged``: the
paged W4A8 scheduler on 2 and 4 full-width layers):

* ``paged_first_block`` — ``decode_attn_paged`` reads every tile through
  each row's first table entry;
* ``acts_scale_one``    — the int8 activation quantizer uses a row scale
  of 1 (codes saturate);
* ``shadow_view``       — prefix-trie payloads are views of the partial
  cache buffer instead of copies.

    python3 scripts/planted_faults_torch.py

Prints one JSON line per run of a phase with its numbers against their
limits and whether the phase failed.  Exits 1 unless every sound run
passes and every planted fault fails a phase it is run against.  The code
in the repository is not changed.  Needs CUDA.
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


def _first_block(orig):
    def attn(q, kc, ks, vc, vs, block_tables, pos, **kw):
        if q.is_cuda:
            block_tables = block_tables[:, :1].expand_as(
                block_tables).contiguous()
        return orig(q, kc, ks, vc, vs, block_tables, pos, **kw)
    return attn


def _scale_one(orig):
    def quantize(x):
        if not x.is_cuda:
            return orig(x)
        xf = x.to(torch.float32)
        return (torch.clamp(torch.round(xf), -127, 127).to(torch.int8),
                torch.ones(xf.shape[:-1] + (1,), device=x.device))
    return quantize


def _view(orig):
    def chunk(a, i, c):
        return a[:, :, i * c:(i + 1) * c] if a.is_cuda else orig(a, i, c)
    return chunk


def main() -> int:
    if not torch.cuda.is_available():
        print("planted_faults_torch: needs a CUDA device", file=sys.stderr)
        return 1
    import repro_torch.core.qtensor as qtensor
    import repro_torch.kernels.quant as quant
    import repro_torch.models.layers as layers
    import repro_torch.optim.fused as fused
    import repro_torch.serve.scheduler as scheduler
    import chip_smoke as cs

    dev = torch.device("cuda")
    sound = ("sound", contextlib.nullcontext)
    groups = [
        ([("train_card_vs_cpu", cs.train_card_vs_cpu)], [
            sound,
            ("no_penalty", lambda: _patched(fused, "fused_opt_step_leaf",
                                            _step_with(lam=0.0))),
            ("no_update", lambda: _patched(fused, "fused_opt_step_leaf",
                                           _step_with(ok=0.0))),
            ("unrounded_rtn", lambda: _patched(quant, "quant_rtn",
                                               _unrounded))]),
        ([("sched_card_vs_cpu", cs.sched_card_vs_cpu),
          ("sched_ring_vs_paged", cs.sched_ring_vs_paged)], [
            sound,
            ("paged_first_block", lambda: _patched(
                layers, "decode_attn_paged", _first_block)),
            ("acts_scale_one", lambda: _patched(
                qtensor, "quantize_acts_ref", _scale_one)),
            ("shadow_view", lambda: _patched(scheduler, "_chunk_copy",
                                             _view))]),
    ]
    keys = ("max_rel_diff", "rtol", "max_abs_logit_err", "tol", "partings",
            "tokens_identical", "token_agreement", "attn_launches_equal")
    bad = False
    for phases, faults in groups:
        for name, ctx in faults:
            failed_any = False
            for phase, run in phases:
                with ctx():
                    try:
                        row, failed = run(dev), False
                    except AssertionError as e:
                        row, failed = e.args[1], True
                failed_any |= failed
                print(json.dumps(dict(
                    phase="planted_fault", fault=name, of=phase,
                    phase_failed=failed,
                    **{k: row[k] for k in keys if k in row})), flush=True)
                if name == "sound":
                    bad |= failed
            if name != "sound":
                bad |= not failed_any
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    return int(bad)


if __name__ == "__main__":
    sys.exit(main())
