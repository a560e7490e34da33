"""How much a wrong kernel or a wrong piece of the serving path moves
``chip_smoke.py``'s card-against-CPU and ring-against-paged checks: run
each of those phases once sound and once with each fault planted on the
card side only, by patching a function for the length of the run.

Training (phase ``train_card_vs_cpu``: 2-layer Granite-3-2B at full width,
fp32, 3 LOTION steps, then the fp32 and RTN eval CE and the per-step
penalty):

* ``no_penalty``    — ``opt_step`` with lam = 0 (the decoupled penalty dropped);
* ``no_update``     — ``opt_step`` with ok = 0 (no parameter update);
* ``unrounded_rtn`` — the RTN eval cast returns the weights unrounded.

The W4A8 row quantizer inside ``wqt_matmul_a8.cu`` (phase
``a8_adversarial``: ``chip_smoke.py``'s adversarial rows of both W4A8
entries, among them rows whose absmax sits at K's last element or at the
first of the last K split):

* ``acts_absmax_short`` — the cluster combines the row maxima of all K
  splits but the last (the launch plan's ``amax_ranks`` one short; with
  one split no maxima, so every row scale is 1 and the codes saturate):
  rows whose absmax lies in the last split get too small a scale.  The
  scheduler's card-against-CPU phase, at its 5% logit tolerance for int8
  activations, does not see it; the bitwise check rows do.

The per-matrix absmax phase of ``quant`` and ``opt_step`` (phases
``quant_adversarial`` and ``opt_step_adversarial``: the adversarial check
rows of ``chip_smoke.py``, the largest |w| of each matrix at its first or
last element or on a chunk boundary, an all-zero matrix, a NaN):

* ``absmax_short`` — the launch plan's absmax phase walks one chunk fewer
  per matrix than the cast or step phase.

The paper's baselines (phases ``check_ste``: the straight-through
estimators on a stacked leaf, and ``train_baselines_card_vs_cpu``: QAT
and RAT on 2 full-width layers, card against CPU from the same uniforms,
then RAT's two microbatches against one on the card):

* ``ste_drops_grad``            — the STE of one weight leaf (the first
  (..., 2048, 8192) one of each forward: ``w_gate``) passes no gradient;
* ``rat_uniforms_per_microbatch`` — RAT's per-step generator is not
  re-seeded for the second microbatch, which casts against fresh draws.

Checkpoints and self-healing training (phases ``train_chaos``: the skip
gate on a NaN step, then the chaos harness on one and two simulated
hosts; ``train_resume``: crash-exact auto-resume on 2 full-width layers,
then a payload rewritten with one leaf changed):

* ``skip_gate_open``       — ``opt_step``'s ok operand forced to 1, so a
  poisoned step updates w, mu and nu;
* ``resume_drops_moments`` — ``checkpoint.load`` restores the parameters
  but zeroes mu and nu;
* ``load_skips_crc``       — ``checkpoint.load`` ignores ``verify`` (the
  manifest's crc32s are not checked).

Static serving (phase ``serve_card_vs_cpu``: 2-layer Granite-3-2B at full
width, int4 weights, prefill and first decode-step logits):

* ``dropped_k_split`` — ``wqt_matmul``'s launch plan drops its last K
  split (its last K step where there is one split), so every weight
  matmul on the card misses part of its contraction.

Scheduling (phases ``sched_card_vs_cpu`` and ``sched_ring_vs_paged``: the
paged W4A8 scheduler on 2 and 4 full-width layers):

* ``paged_first_block`` — ``decode_attn_paged`` reads every tile through
  each row's first table entry;
* ``shadow_view``       — prefix-trie payloads are views of the partial
  cache buffer instead of copies;
* ``dropped_attn_split`` — ``decode_attn``'s launch plan has one split
  fewer.  The splits end at the ring's end, so the first one is never
  read: at the scheduler's 256-slot ring (4 splits of 64) slots 0-63, the
  64-token system prompt every request of the workload starts with.

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


def _drop_grad(orig):
    """fake_quant_rtn whose every other call on a CUDA (..., 2048, 8192)
    tensor (the first such leaf of each forward_params) passes a zero
    gradient to it."""
    calls = [0]

    def fq(x, fmt, block_size=-1):
        if x.is_cuda and tuple(x.shape[-2:]) == (2048, 8192):
            calls[0] += 1
            if calls[0] % 2:
                return orig(x.detach(), fmt, block_size) + 0.0 * x
        return orig(x, fmt, block_size)
    return fq


def _one_generator_per_step(orig):
    """step_generator that hands every microbatch of a step the same
    generator object, so the second one draws on from the first's state."""
    made = {}

    def gen(seed, step, device):
        key = (seed, step, str(device))
        if key not in made:
            made[key] = orig(seed, step, device)
        return made[key]
    return gen


def _drop_moments(orig):
    """checkpoint.load that zeroes the restored fused state's mu and nu
    on the card."""
    def load(*args, **kw):
        tree, step = orig(*args, **kw)
        opt = tree.get("opt") if isinstance(tree, dict) else None
        if isinstance(opt, dict) and "mu" in opt:
            from repro_torch.core.policy import tree_leaves
            for x in tree_leaves(opt["mu"]) + tree_leaves(opt["nu"]):
                if x.is_cuda:
                    x.zero_()
        return tree, step
    return load


def _skip_crc(orig):
    def load(*args, **kw):
        kw["verify"] = False
        return orig(*args, **kw)
    return load


def _first_block(orig):
    def attn(q, kc, ks, vc, vs, block_tables, pos, **kw):
        if q.is_cuda:
            block_tables = block_tables[:, :1].expand_as(
                block_tables).contiguous()
        return orig(q, kc, ks, vc, vs, block_tables, pos, **kw)
    return attn


def _absmax_short(orig):
    def plan(*args, **kw):
        p = orig(*args, **kw)
        return p._replace(amax_ranks=p.splits - 1)
    return plan


def _view(orig):
    def chunk(a, i, c):
        return a[:, :, i * c:(i + 1) * c] if a.is_cuda else orig(a, i, c)
    return chunk


def _drop_last_split(orig):
    def plan(*args, **kw):
        p = orig(*args, **kw)
        if p.splits > 1:
            return p._replace(splits=p.splits - 1)
        return p._replace(k_per_split=p.k_per_split - p.tile_k)
    return plan


def _scan_short(orig):
    def plan(*args, **kw):
        p = orig(*args, **kw)
        return p._replace(scan_chunks=max(p.chunks - 1, 0))
    return plan


def _drop_first_split(orig):
    def plan(*args, **kw):
        p = orig(*args, **kw)
        if p.splits == 1:
            return p
        return p._replace(splits=p.splits - 1,
                          blocks=p.blocks // p.splits * (p.splits - 1))
    return plan


def main() -> int:
    if not torch.cuda.is_available():
        print("planted_faults_torch: needs a CUDA device", file=sys.stderr)
        return 1
    import repro_torch.checkpoint.io as ckpt_io
    import repro_torch.core.ste as ste
    import repro_torch.kernels.quant as quant
    import repro_torch.train.loop as loop
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.kernels.decode_attn import ops as attn_ops
    from repro_torch.kernels.wq_matmul import ops as wq_ops
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
        ([("check_ste", cs.check_ste),
          ("train_baselines_card_vs_cpu", cs.train_baselines_card_vs_cpu)], [
            sound,
            ("ste_drops_grad", lambda: _patched(ste, "fake_quant_rtn",
                                                _drop_grad)),
            ("rat_uniforms_per_microbatch", lambda: _patched(
                loop, "step_generator", _one_generator_per_step))]),
        ([("train_chaos", cs.train_chaos)], [
            sound,
            ("skip_gate_open", lambda: _patched(fused, "fused_opt_step_leaf",
                                                _step_with(ok=1.0)))]),
        ([("train_resume", cs.train_resume)], [
            sound,
            ("resume_drops_moments", lambda: _patched(ckpt_io, "load",
                                                      _drop_moments)),
            ("load_skips_crc", lambda: _patched(ckpt_io, "load",
                                                _skip_crc))]),
        ([("quant_adversarial", cs.check_quant_adversarial),
          ("opt_step_adversarial", cs.check_opt_adversarial)], [
            sound,
            ("absmax_short", lambda: _patched(quant_ops, "plan",
                                              _scan_short))]),
        ([("a8_adversarial", cs.check_a8_adversarial)], [
            sound,
            ("acts_absmax_short", lambda: _patched(wq_ops, "a8_plan",
                                                   _absmax_short))]),
        ([("serve_card_vs_cpu", cs.card_vs_cpu)], [
            sound,
            ("dropped_k_split", lambda: _patched(wq_ops, "plan",
                                                 _drop_last_split))]),
        ([("sched_card_vs_cpu", cs.sched_card_vs_cpu),
          ("sched_ring_vs_paged", cs.sched_ring_vs_paged)], [
            sound,
            ("paged_first_block", lambda: _patched(
                layers, "decode_attn_paged", _first_block)),
            ("shadow_view", lambda: _patched(scheduler, "_chunk_copy",
                                             _view)),
            ("dropped_attn_split", lambda: _patched(attn_ops, "plan",
                                                    _drop_first_split))]),
    ]
    keys = ("max_rel_diff", "rtol", "penalty_max_rel_diff", "penalty_rtol",
            "late_max_rel_diff", "late_rtol", "rat_micro_rel_diff",
            "rat_micro_rtol",
            "max_abs_logit_err", "tol", "partings", "tokens_identical",
            "token_agreement", "attn_launches_equal", "failed",
            "max_abs_err", "checks", "differing_leaves", "error", "gate")
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
