"""Training launcher of the port (``repro.launch.train``, one device):
LOTION (or a baseline) on an architecture's config with random weights
from seed 0, AdamW on a cosine schedule, the synthetic Markov stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --device cpu --steps 6 --batch 4 --seq 32 [--ckpt-dir D]

With ``--ckpt-dir`` the run checkpoints itself every ``steps // 2``
steps and resumes from the newest valid checkpoint there, so running
the same command again after a kill continues the run bitwise.
``--chaos`` instead drives the training chaos harness
(``train/faults.py``: seeded NaN batches, a loss spike, hard kills, a
mid-write kill and a corrupted checkpoint, every step audited) and exits
1 on any audit violation.

The flags are those of ``repro.launch.train``, plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions) and
``--layers`` (cut the depth).  ``--mesh`` is refused (the distributed
launch is ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import DataPipeline, lm_batch, permutation_table
from repro_torch.models.lm import lm_init
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train import (TrainConfig, init_state, make_optimizer,
                               make_train_step, run_loop)


def chaos_plan(seed: int, n_steps: int, n_hosts: int = 1):
    """The launcher's chaos plan, as the JAX launcher builds it: the
    seeded default, and with ``n_hosts > 1`` a peer kill and a straggler
    at the first hook ordinals clear of the seeded crashes, the bitflip
    on the last shard, a torn manifest at save 4, and the spike burst
    pinned late in the fetch stream (replays keep counting ordinals) so
    that it lands past the monitor's warmup and the rollback fires."""
    from repro_torch.train import faults as tfaults

    if n_hosts <= 1:
        return tfaults.chaos_train_plan(seed, n_steps=n_steps)
    taken = set(tfaults.chaos_train_plan(seed, n_steps=n_steps).crash_steps)
    free = (i for i in range(2, n_steps - 1) if i not in taken)
    kill_at = next(free)
    straggle_at = next(free)
    return tfaults.chaos_train_plan(
        seed, n_steps=n_steps, n_hosts=n_hosts, host_kill_at=kill_at,
        straggle_at=straggle_at, corrupt_mode=("bitflip", n_hosts - 1),
        torn_manifest_save=4, spike_at=(5 * n_steps) // 4, spike_len=3)


def chaos_ok(summary: dict, n_hosts: int = 1) -> bool:
    """The launcher's acceptance bar for a chaos run: no violation, a
    finished run with a finite loss, and with several hosts every
    host-level tier fired and healed."""
    ok = (not summary["violations"] and summary["result"] is not None
          and math.isfinite(summary["final_loss"]))
    if n_hosts > 1:
        ok = (ok and summary["host_kill_timeouts"] >= 1
              and summary["straggler_timeouts"] >= 1
              and summary["quarantined"] >= 1
              and summary["rollbacks"] >= 1
              and summary["divergence_checks"] >= 1)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 (data x model)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--method", default="lotion")
    ap.add_argument("--lam", type=float, default=1000.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--placement", default=None,
                    choices=["loss", "decoupled"],
                    help="LOTION penalty placement (default: decoupled)")
    ap.add_argument("--chaos", action="store_true",
                    help="run the training chaos harness (seeded faults "
                         "+ per-step invariant audit, train/faults.py) "
                         "instead of a plain run; exits nonzero on any "
                         "audit violation")
    ap.add_argument("--chaos-seed", type=int, default=1)
    args = ap.parse_args(argv)
    if args.chaos and args.microbatches != 1:
        ap.error("--chaos requires --microbatches 1 (the poison scalar "
                 "is per batch)")
    if args.mesh:
        raise NotImplementedError(
            "--mesh (sharded training over several devices) is not ported "
            "yet: ROADMAP Queue 1 item 8")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    qcfg = QuantConfig(method=args.method, fmt_name="int4", lam=args.lam,
                       policy=QuantPolicy(min_size=256 if args.smoke
                                          else 1024))
    tcfg = TrainConfig(quant=qcfg, n_microbatches=args.microbatches,
                       penalty_placement=args.placement)
    opt = make_optimizer(tcfg, adamw(cosine_with_warmup(args.lr, 5,
                                                        args.steps)))
    perm = permutation_table(0, cfg.vocab)

    def batch_fn(s):
        return lm_batch(0, s, args.batch, args.seq, cfg.vocab, perm)

    if args.chaos:
        from repro_torch.train import faults as tfaults

        def make_state():
            return init_state(lm_init(cfg, seed=0, device=dev), opt,
                              lr_scale=True)

        step = make_train_step(cfg, tcfg, opt,
                               loss_fn=tfaults.chaos_loss_fn(cfg, tcfg))
        plan = chaos_plan(args.chaos_seed, args.steps)
        ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="chaos_train_")
        print(f"chaos: {plan.describe()} n_hosts=1 ckpt_dir={ckpt_dir}")
        summary = tfaults.run_chaos(step, make_state, batch_fn, plan,
                                    args.steps, ckpt_dir, device=dev,
                                    log=print)
        counters = {k: summary[k] for k in
                    ("segments", "crashes", "resumes", "rollbacks",
                     "skipped", "replayed_steps", "saves", "quarantined",
                     "host_kill_timeouts", "straggler_timeouts",
                     "divergence_checks", "data_windows_skipped")}
        print(f"chaos done: violations={len(summary['violations'])} "
              f"{counters} final_loss={summary['final_loss']:.4f}")
        for v in summary["violations"]:
            print(f"  VIOLATION: {v}")
        raise SystemExit(0 if chaos_ok(summary) else 1)

    state = init_state(lm_init(cfg, seed=0, device=dev), opt)
    step = make_train_step(cfg, tcfg, opt)
    pipe = DataPipeline(batch_fn, device=dev, prefetch=1)
    hooks = {}
    if args.ckpt_dir:
        # the loop's own atomic checkpoints + crash-exact restart: running
        # the same command after a kill resumes from the newest valid one
        hooks = dict(ckpt_dir=args.ckpt_dir,
                     ckpt_every=max(args.steps // 2, 1), auto_resume=True)
    try:
        out = run_loop(step, state, pipe, args.steps, log_every=5, **hooks)
    finally:
        pipe.close()
    print(f"done: {int(out['state']['step'])} steps on {dev} "
          f"skipped={out['skipped']} rollbacks={out['rollbacks']} "
          f"resumed_from={out['resumed_from']}")
    return out


if __name__ == "__main__":
    main()
