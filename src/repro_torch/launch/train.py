"""Training launcher of the port (``repro.launch.train``): LOTION (or a
baseline) on an architecture's config with random weights from seed 0,
AdamW on a cosine schedule, the synthetic Markov stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --device cpu --steps 6 --batch 4 --seq 32 [--ckpt-dir D]

``--mesh DxM`` (or ``PxDxM``) trains sharded on a device mesh of that
shape, one process per rank: the state is placed by
``distributed.sharding.state_shardings``, each rank keeps its rows of
every batch and the step gathers each leaf where the model reads it
(``train.make_train_step(grad_shardings=)``); checkpoints hold the full
leaves, one payload per host (the product of the non-``model`` axes).
Under ``torchrun`` the world size must equal the mesh's size::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch granite-3-2b --smoke \\
        --device cpu --mesh 2x1 --steps 4

and ``--mesh 1x1`` needs no ``torchrun``.  Only rank 0 prints.

With ``--ckpt-dir`` the run checkpoints itself every ``steps // 2``
steps and resumes from the newest valid checkpoint there, so running
the same command again after a kill continues the run bitwise.
``--chaos`` instead drives the training chaos harness
(``train/faults.py``: seeded NaN batches, a loss spike, hard kills, a
mid-write kill and a corrupted checkpoint, every step audited) and exits
1 on any audit violation.  With ``--mesh`` it runs on the mesh's ranks
(``mesh_chaos``), one simulated host per slice of the non-``model``
axes, as the JAX launcher counts them; with more than one host the
host-level tier joins in (a killed and a straggling peer, a bitflip in
the last host's payload shard, a torn manifest, a coordinated rollback)
and every tier must fire and heal::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch granite-3-2b --smoke \\
        --device cpu --mesh 2x1 --chaos --steps 18 --batch 4 --seq 32

Every rank exits with the same code.

The flags are those of ``repro.launch.train``, plus ``--device``
(default ``cuda``, NCCL on a mesh; ``cpu`` runs the kernels' plain
versions, gloo on a mesh) and ``--layers`` (cut the depth).
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
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              state_shardings,
                                              train_batch_shardings)
from repro_torch.launch import specs
from repro_torch.launch.mesh import close_mesh, make_mesh, parse_mesh
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


def parser() -> argparse.ArgumentParser:
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
    return ap


def configure(args):
    """``(cfg, tcfg, opt, batch_fn)`` of the launcher's flags: the config
    (cut to ``--layers``), LOTION (or the method) at int4, AdamW on a
    cosine schedule with 5 warmup steps, the Markov stream from seed 0."""
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

    return cfg, tcfg, opt, batch_fn


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.chaos and args.microbatches != 1:
        ap.error("--chaos requires --microbatches 1 (the poison scalar "
                 "is per batch)")
    mesh = None
    if args.mesh:
        mesh = make_mesh(*parse_mesh(args.mesh), args.device)
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    cfg, tcfg, opt, batch_fn = configure(args)

    if args.chaos:
        ckpt_dir = args.ckpt_dir
        if ckpt_dir is None and (mesh is None or mesh.rank == 0):
            ckpt_dir = tempfile.mkdtemp(prefix="chaos_train_")
        if mesh is not None:
            # the ranks share rank 0's directory (on several hosts,
            # --ckpt-dir names one they all see)
            ckpt_dir = collectives.broadcast_object(ckpt_dir)
            rank = mesh.rank
            try:
                summary, n_hosts = mesh_chaos(
                    cfg, tcfg, opt, mesh, batch_fn, args.batch, args.seq,
                    n_steps=args.steps, ckpt_dir=ckpt_dir,
                    chaos_seed=args.chaos_seed)
            finally:
                close_mesh()
        else:
            from repro_torch.train import faults as tfaults

            def make_state():
                return init_state(lm_init(cfg, seed=0, device=dev), opt,
                                  lr_scale=True)

            step = make_train_step(cfg, tcfg, opt,
                                   loss_fn=tfaults.chaos_loss_fn(cfg, tcfg))
            plan = chaos_plan(args.chaos_seed, args.steps)
            print(f"chaos: {plan.describe()} n_hosts=1 ckpt_dir={ckpt_dir}")
            summary = tfaults.run_chaos(step, make_state, batch_fn, plan,
                                        args.steps, ckpt_dir, device=dev,
                                        log=print)
            n_hosts, rank = 1, 0
        if rank == 0:
            print(chaos_report(summary))
        raise SystemExit(0 if chaos_ok(summary, n_hosts) else 1)

    if mesh is not None:
        try:
            return train_on_mesh(args, cfg, tcfg, opt, mesh, batch_fn)
        finally:
            close_mesh()
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


def mesh_training(cfg, tcfg, opt, mesh, batch_fn, batch: int, seq: int,
                  seed: int = 0, prefetch: int = 1):
    """The pieces of a sharded run on ``mesh``: ``(state, train_step,
    pipeline, state_shardings)``, the state placed from ``seed`` (each
    rank keeps its blocks of every leaf as it is drawn), the step over
    the blocks and the pipeline of the rank's rows of ``batch_fn``'s
    global batches.  ``opt`` is ``make_optimizer(tcfg, ...)``."""
    state_sh = state_shardings(mesh, specs.state_specs(cfg, tcfg))
    params_sh = state_sh["params"]
    state = init_state(lm_init(cfg, seed=seed, device=mesh.device,
                               shardings=params_sh), opt)
    step = make_train_step(cfg, tcfg, opt, grad_shardings=params_sh)
    pipe = DataPipeline(batch_fn, device=mesh.device, prefetch=prefetch,
                        sharding=train_batch_shardings(
                            mesh, specs.train_batch_specs(cfg, batch, seq),
                            batch))
    return state, step, pipe, state_sh


CHAOS_COUNTERS = ("segments", "crashes", "resumes", "rollbacks", "skipped",
                  "replayed_steps", "saves", "quarantined",
                  "host_kill_timeouts", "straggler_timeouts",
                  "divergence_checks", "data_windows_skipped")


def chaos_report(summary: dict) -> str:
    """The chaos run's closing lines: its counters, final loss and
    violations."""
    counters = {k: summary[k] for k in CHAOS_COUNTERS}
    lines = [f"chaos done: violations={len(summary['violations'])} "
             f"{counters} final_loss={summary['final_loss']:.4f}"]
    lines += [f"  VIOLATION: {v}" for v in summary["violations"]]
    return "\n".join(lines)


def n_hosts_of(mesh) -> int:
    """Simulated hosts of a mesh: one per slice of the non-``model`` axes,
    as the JAX launcher counts them (the checkpoint's payload shards
    too)."""
    return math.prod(n for ax, n in mesh.shape.items() if ax != "model")


def mesh_chaos(cfg, tcfg, opt, mesh, batch_fn, batch: int, seq: int, *,
               n_steps: int, ckpt_dir: str, chaos_seed: int = 1,
               seed: int = 0, log=print, wrap=None, **chaos_kw):
    """The chaos harness of ``main`` on ``mesh`` (``--mesh ... --chaos``),
    called on every rank; returns ``(summary, n_hosts)``.  Each segment's
    state is drawn on the rank's blocks from ``seed`` (lr_scale included),
    the step is the sharded step with the poison seam, the pipeline hands
    the rank its rows, checkpoints hold ``n_hosts`` payload shards, and
    the plan is ``chaos_plan(chaos_seed, n_steps, n_hosts)``.  Only rank 0
    logs.  ``wrap(name, fn)`` may wrap the step (``"steps"``) and the
    state's init (``"reinits"``), to count or time them.  ``chaos_kw``
    goes to ``run_chaos`` (``audit_every``, ...)."""
    from repro_torch.train import faults as tfaults

    say = log if mesh.rank == 0 else (lambda *a, **k: None)
    state_sh = dict(state_shardings(mesh, specs.state_specs(cfg, tcfg)))
    state_sh["lr_scale"] = NamedSharding(mesh, P())
    params_sh = state_sh["params"]

    def make_state():
        return init_state(lm_init(cfg, seed=seed, device=mesh.device,
                                  shardings=params_sh), opt, lr_scale=True)

    step = make_train_step(
        cfg, tcfg, opt, grad_shardings=params_sh,
        loss_fn=tfaults.chaos_loss_fn(cfg, tcfg, params_sh))
    batch_sh = train_batch_shardings(
        mesh, specs.train_batch_specs(cfg, batch, seq), batch)
    n_hosts = n_hosts_of(mesh)
    plan = chaos_plan(chaos_seed, n_steps, n_hosts)
    say(f"chaos: {plan.describe()} n_hosts={n_hosts} mesh={mesh.shape} "
        f"ckpt_dir={ckpt_dir}")
    if wrap is not None:
        step, make_state = wrap("steps", step), wrap("reinits", make_state)
    summary = tfaults.run_chaos(
        step, make_state, batch_fn, plan, n_steps, ckpt_dir,
        n_hosts=n_hosts, ckpt_shards=n_hosts, batch_sharding=batch_sh,
        shardings=state_sh, device=mesh.device, log=say, **chaos_kw)
    return summary, n_hosts


def train_on_mesh(args, cfg, tcfg, opt, mesh, batch_fn, log=print):
    """The sharded run of ``main`` (``--mesh``): the state placed on
    ``mesh`` from seed 0, the rank's rows of each batch, the loop's
    checkpoints from and into the blocks.  Returns ``run_loop``'s
    result (the state holds this rank's blocks)."""
    say = log if mesh.rank == 0 else (lambda *a, **k: None)
    state, step, pipe, state_sh = mesh_training(
        cfg, tcfg, opt, mesh, batch_fn, args.batch, args.seq)
    n_hosts = n_hosts_of(mesh)
    hooks = {}
    if args.ckpt_dir:
        hooks = dict(ckpt_dir=args.ckpt_dir,
                     ckpt_every=max(args.steps // 2, 1), ckpt_shards=n_hosts,
                     auto_resume=True)
    try:
        out = run_loop(step, state, pipe, args.steps, log_every=5, log=say,
                       shardings=state_sh, **hooks)
    finally:
        pipe.close()
    say(f"done: {int(out['state']['step'])} steps on mesh {mesh.shape} "
        f"({mesh.backend}, {mesh.device.type}) skipped={out['skipped']} "
        f"rollbacks={out['rollbacks']} resumed_from={out['resumed_from']}")
    return out


if __name__ == "__main__":
    main()
