"""Deterministic fault injection and per-step invariant audit for the
training loop (port of ``repro.train.faults``).

The loop's self-healing claims ("a poisoned step applies no update", "a
crash resumes bitwise", "a corrupt checkpoint is quarantined, never
restored") mean something only if they survive faults happening:

* :func:`chaos_train_plan` builds a seeded, deterministic schedule.
  Transient data faults (NaN/inf poison, finite loss blow-ups that trip
  the spike monitor, pipeline stalls) are keyed by fetch ordinal (the
  i-th batch ever fetched), so a rollback's replay of a step fetches a
  clean batch; crashes by step-hook ordinal (after the step, before its
  checkpoint) and by save ordinal at a write stage (through
  :func:`repro_torch.checkpoint.write_fault_hook`); published payloads
  can be bit-flipped, truncated or deleted, and manifests torn.  With
  ``n_hosts > 1`` a simulated peer host can be killed or made to
  straggle on the coordinator's :class:`InProcessBus`.
* :class:`TrainAuditor` audits every step through ``run_loop``'s
  ``step_hook``: step monotonicity (backward jumps only by a resume or a
  rollback), a stable state structure, the skip flag raised on every
  non-finite loss, the skip and rollback counters against ``run_loop``'s
  returned ones, and a state fingerprint posted through the coordinator
  (the cross-host divergence audit and liveness heartbeat).
* :func:`run_chaos` drives segments of ``run_loop`` under a plan,
  emulating a hard kill per injected crash (``InjectedCrash`` derives
  from ``BaseException``) and a supervisor that restarts from a fresh
  state with ``auto_resume``.

On a mesh (``run_chaos(shardings=, batch_sharding=)`` on every rank;
``launch/train.py::mesh_chaos``) every rank runs the same plan: the
global losses and skip flags, the replayed write stages and the
per-rank buses make each fault fire on every rank at the same ordinal,
and the audit compares the full-leaf digest and the replicas across
ranks (``distributed.BlockDigests``).

Faults enter only through public seams (the batch function, the step
hook, the checkpoint write hook).  The poison is a 0-d fp32 tensor in
the batch (``DataPipeline`` moves every value to the device); the
fault-free value 1.0 multiplies the loss as a bitwise identity.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import io as ckpt_io
from ..data import DataPipeline
from .guard import InjectedCrash
from .loop import make_loss_fn, run_loop


@dataclasses.dataclass
class TrainFaultPlan:
    """One deterministic training chaos schedule.

    ``nan_fetches``/``spike_fetches``/``stall_fetches`` are keyed by
    fetch ordinal (transient faults — replays are clean);
    ``crash_steps`` by step-hook ordinal; ``ckpt_crashes`` and
    ``corrupt_saves`` by save ordinal (the i-th ``checkpoint.save`` of
    the run, the eager anchor save being ordinal 0).
    """

    seed: int
    # fetch ordinal -> poison scale multiplied into the loss (nan/inf:
    # non-finite loss AND gradients via the cotangent)
    nan_fetches: Dict[int, float] = dataclasses.field(default_factory=dict)
    # fetch ordinal -> large-but-finite loss blow-up (spike-monitor food)
    spike_fetches: Dict[int, float] = dataclasses.field(default_factory=dict)
    # fetch ordinal -> host-side stall seconds (prefetch/timing jitter)
    stall_fetches: Dict[int, float] = dataclasses.field(default_factory=dict)
    # step-hook ordinals at which the run is hard-killed (after the
    # step, before the checkpoint boundary — the adversarial window)
    crash_steps: frozenset = frozenset()
    # save ordinal -> write stage ("payload"|"shard{i}"|"manifest"|
    # "fsync"|"publish") at which the save is hard-killed mid-write
    ckpt_crashes: Dict[int, str] = dataclasses.field(default_factory=dict)
    # save ordinal -> mode or (mode, shard) applied AFTER publish, where
    # mode is "bitflip" | "truncate" | "delete" | "manifest": the newest
    # checkpoint on disk is poisoned (possibly one shard of many, or its
    # manifest torn), restore must quarantine the WHOLE step
    corrupt_saves: Dict[int, Any] = dataclasses.field(default_factory=dict)
    # host-level faults, keyed by step-hook ordinal like
    # crash_steps: the fault lands after that step's audit, and the NEXT
    # coordination round (fingerprint heartbeat / rollback election)
    # surfaces it as a CoordinatorTimeout
    # hook ordinal -> simulated peer host to kill (1..n_hosts-1)
    host_kills: Dict[int, int] = dataclasses.field(default_factory=dict)
    # hook ordinal -> (host, virtual delay seconds); delay > the
    # coordinator timeout is indistinguishable from dead
    stragglers: Dict[int, Any] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        return (f"TrainFaultPlan(seed={self.seed}, "
                f"nans={len(self.nan_fetches)}, "
                f"spikes={len(self.spike_fetches)}, "
                f"stalls={len(self.stall_fetches)}, "
                f"crashes={len(self.crash_steps)}, "
                f"ckpt_crashes={len(self.ckpt_crashes)}, "
                f"corrupt={len(self.corrupt_saves)}, "
                f"host_kills={len(self.host_kills)}, "
                f"stragglers={len(self.stragglers)})")


def chaos_train_plan(seed: int, n_steps: int = 18,
                     nan_rate: float = 0.12,
                     spike_scale: float = 1e4, spike_len: int = 2,
                     spike_at: Optional[int] = None,
                     stall_rate: float = 0.08,
                     n_crashes: int = 2,
                     ckpt_crash_save: Optional[int] = 2,
                     ckpt_crash_stage: str = "manifest",
                     corrupt_save: Optional[int] = 3,
                     corrupt_mode: str = "bitflip",
                     n_hosts: int = 1,
                     host_kill_at: Optional[int] = None,
                     host_kill_host: int = 1,
                     straggle_at: Optional[int] = None,
                     straggle_host: Optional[int] = None,
                     straggle_delay: float = 1e9,
                     torn_manifest_save: Optional[int] = None
                     ) -> TrainFaultPlan:
    """Sample a :class:`TrainFaultPlan` from a seeded generator — same
    arguments, same plan, machine-independent.

    The skeleton is partly structured (one spike burst placed after the
    monitor's warmup window; crash ordinals spread over the run
    including the replay-inflated tail) so a default plan exercises
    every recovery tier: skip, rollback, mid-write kill, quarantine.

    With ``n_hosts > 1`` the host-level tier joins in: a peer host kill
    at hook ordinal ``host_kill_at``, a straggler (virtual
    ``straggle_delay``, default far past any timeout) at ``straggle_at``,
    and — mesh or not — a torn manifest (``torn_manifest_save``) and
    shard-targeted corruption via ``corrupt_mode=(mode, shard)``.
    """
    rng = np.random.default_rng(seed)
    plan = TrainFaultPlan(seed=seed)
    for i in range(n_steps):
        if rng.random() < nan_rate:
            plan.nan_fetches[i] = (float("nan") if rng.random() < 0.5
                                   else float("inf"))
        if rng.random() < stall_rate:
            plan.stall_fetches[i] = float(rng.uniform(0.005, 0.02))
    # one sustained spike burst, placed past the monitor warmup
    lo = max(2, n_steps // 2)
    start = (spike_at if spike_at is not None
             else int(rng.integers(lo, max(lo + 1, n_steps - spike_len))))
    for j in range(spike_len):
        plan.nan_fetches.pop(start + j, None)
        plan.spike_fetches[start + j] = spike_scale
    # crashes: hook ordinals keep counting across replays, so spread
    # them past n_steps to also hit replayed regions
    if n_crashes > 0:
        hi = n_steps + n_steps // 2
        picks = rng.choice(np.arange(3, hi), size=min(n_crashes, hi - 3),
                           replace=False)
        plan.crash_steps = frozenset(int(x) for x in picks)
    if ckpt_crash_save is not None:
        plan.ckpt_crashes[int(ckpt_crash_save)] = ckpt_crash_stage
    if corrupt_save is not None:
        plan.corrupt_saves[int(corrupt_save)] = corrupt_mode
    if torn_manifest_save is not None:
        plan.corrupt_saves[int(torn_manifest_save)] = "manifest"
    if n_hosts > 1:
        if host_kill_at is not None:
            plan.host_kills[int(host_kill_at)] = int(host_kill_host)
        if straggle_at is not None:
            h = (int(straggle_host) if straggle_host is not None
                 else max(1, n_hosts - 1))
            plan.stragglers[int(straggle_at)] = (h, float(straggle_delay))
    return plan


def corrupt_checkpoint(path: str, mode: str = "bitflip",
                       rng: Optional[np.random.Generator] = None,
                       shard: int = 0) -> None:
    """Damage a published checkpoint in place.  ``bitflip`` inverts one
    byte in the middle of one payload npz (array data region — the
    per-leaf crc32 catches it even when the zip container still reads);
    ``truncate`` cuts the file (unreadable container); ``delete``
    removes it outright (lost shard); ``manifest`` tears the manifest
    json mid-file (torn metadata write).  ``shard`` selects which
    payload shard of a sharded save to hit — damaging ANY one shard must
    untrust the whole step."""
    if mode == "manifest":
        target = os.path.join(path, ckpt_io.MANIFEST)
        with open(target, "rb") as f:
            data = bytearray(f.read())
        with open(target, "wb") as f:
            f.write(bytes(data[: max(2, len(data) // 2)]))
        return
    with open(os.path.join(path, ckpt_io.MANIFEST)) as f:
        manifest = json.load(f)
    files = ckpt_io.payload_files(manifest)
    target = os.path.join(path,
                          files.get(int(shard), next(iter(files.values()))))
    if mode == "delete":
        os.remove(target)
        return
    with open(target, "rb") as f:
        data = bytearray(f.read())
    if mode == "truncate":
        data = data[: max(16, len(data) // 3)]
    elif mode == "bitflip":
        data[len(data) // 2] ^= 0xFF
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(target, "wb") as f:
        f.write(bytes(data))


def chaos_loss_fn(cfg, tcfg, shardings=None) -> Callable:
    """The standard LM loss with the chaos poison seam: the batch's
    ``poison`` scalar multiplies the loss, so a NaN/inf scale gives a
    non-finite loss and gradients, while 1.0 is a bitwise identity.  With
    ``shardings`` it is ``make_loss_fn(cfg, tcfg, shardings)``'s share of
    the global objective, times the poison (every rank gets the scalar
    whole: no batch sharding cuts a key it does not name); the sharded
    step reads its loss metric and skip gate from ``aux`` (the ranks'
    ``ce`` and ``ce_ex``), so the poison scales those too."""
    if tcfg.n_microbatches != 1:
        raise ValueError("chaos poison is a per-batch scalar: the "
                         "microbatch split would cut it — run chaos "
                         "with n_microbatches=1")
    base = make_loss_fn(cfg, tcfg, shardings)

    def loss_fn(params, batch, fisher, **kw):
        loss, aux = base(params, batch, fisher, **kw)
        if shardings is not None:
            aux = dict(aux, ce=aux["ce"] * batch["poison"],
                       ce_ex=aux["ce_ex"] * batch["poison"])
        return loss * batch["poison"], aux

    return loss_fn


class ChaosInjector:
    """Stateful fault applier: owns the fetch, hook and save ordinals and
    applies the plan through the public seams.  ``plan=None`` counts
    ordinals and stamps ``poison=1.0`` but injects nothing (the
    fault-free parity arm).  With a ``bus`` the plan's host-level faults
    mark simulated peers dead or straggling at their hook ordinal.  On a
    mesh every rank runs one injector on the same plan; only the
    checkpoint's writer (``writes``) damages the files, and every rank
    counts the damage."""

    def __init__(self, plan: Optional[TrainFaultPlan], bus=None,
                 writes: bool = True):
        self.plan = plan or TrainFaultPlan(seed=0)
        self.bus = bus
        self.writes = writes
        self.fetches = 0
        self.hook_calls = 0
        self.saves = 0
        self.crashes = 0
        self.host_kills = 0
        self.straggles = 0
        self.corrupted: List[str] = []
        self._cur_save = -1
        self._rng = np.random.default_rng(self.plan.seed + 101)

    def wrap_batch_fn(self, batch_fn: Callable[[int], dict]) -> Callable:
        def fn(step: int) -> dict:
            i = self.fetches
            self.fetches += 1
            b = dict(batch_fn(step))
            scale = 1.0
            if i in self.plan.nan_fetches:
                scale = self.plan.nan_fetches[i]
            elif i in self.plan.spike_fetches:
                scale = self.plan.spike_fetches[i]
            if i in self.plan.stall_fetches:
                time.sleep(self.plan.stall_fetches[i])
            b["poison"] = torch.tensor(scale, dtype=torch.float32)
            return b

        return fn

    def crash_hook(self) -> Callable:
        """``run_loop`` step hook raising :class:`InjectedCrash` at the
        plan's hook ordinals and marking host faults on the bus at
        theirs."""

        def hook(state, metrics):
            i = self.hook_calls
            self.hook_calls += 1
            if self.bus is not None and i in self.plan.host_kills:
                self.bus.kill(self.plan.host_kills[i])
                self.host_kills += 1
            if self.bus is not None and i in self.plan.stragglers:
                h, delay = self.plan.stragglers[i]
                self.bus.straggle(h, delay)
                self.straggles += 1
            if i in self.plan.crash_steps:
                self.crashes += 1
                raise InjectedCrash(
                    f"injected crash after step-hook ordinal {i} "
                    f"(state step {int(state['step'])})")

        return hook

    def write_hook(self) -> Callable:
        """Checkpoint write-stage hook: mid-write kills and post-publish
        corruption, keyed by save ordinal."""

        def hook(stage: str, path: str):
            if stage == "payload":
                self._cur_save = self.saves
                self.saves += 1
            n = self._cur_save
            if self.plan.ckpt_crashes.get(n) == stage:
                self.crashes += 1
                raise InjectedCrash(
                    f"injected crash mid-checkpoint-write "
                    f"(save {n}, stage {stage!r})")
            if stage == "done" and n in self.plan.corrupt_saves:
                spec = self.plan.corrupt_saves[n]
                mode, shard = (spec if isinstance(spec, tuple)
                               else (spec, 0))
                if self.writes:
                    corrupt_checkpoint(path, mode, self._rng, shard=shard)
                self.corrupted.append(path)

        return hook


def _structure(tree) -> tuple:
    """The tree's leaf keys in order: equal iff the structures agree."""
    return tuple(k for k, _ in ckpt_io._paths_and_leaves(tree))


class TrainAuditor:
    """Per-step invariant audit of a chaos run (``run_loop``'s
    ``step_hook``, before the injector's crash hook, so a killed step is
    still audited).  With a ``coordinator`` every ``audit_every`` steps
    the params+opt fingerprint is compared across hosts (the round is
    also the liveness heartbeat: a killed host surfaces here as
    ``CoordinatorTimeout``), and with ``replica_audit`` the replicas of
    each parameter are compared.  On a mesh (``shardings``: the state's
    NamedShardings) the digest is that of the full leaves
    (``distributed.BlockDigests``, one gather); a rank whose view of the
    state differs from rank 0's is a violation that names it, and the
    replicas compared are the copies of a window that ranks hold."""

    def __init__(self, coordinator=None, audit_every: int = 1,
                 replica_audit: bool = True, shardings=None):
        self.coordinator = coordinator
        self.shardings = shardings
        self.audit_every = max(1, int(audit_every))
        self.replica_audit = replica_audit
        self.violations: List[str] = []
        self.total_skips = 0
        self.total_rollbacks = 0
        self.total_resumes = 0
        self.replayed_steps = 0
        self.steps_seen = 0
        self.divergence_checks = 0
        self.last_loss = float("nan")
        self._structure = None
        self._prev_step: Optional[int] = None
        self._seg_skips = 0
        self._seg_rollbacks = 0
        self._seg_first = True

    def on_segment_start(self) -> None:
        self._seg_skips = 0
        self._seg_rollbacks = 0
        self._seg_first = True

    def on_step(self, state, metrics) -> None:
        self.steps_seen += 1
        step = int(state["step"])
        sig = _structure({"params": state["params"], "opt": state["opt"]})
        if self._structure is None:
            self._structure = sig
        elif sig != self._structure:
            self.violations.append(
                f"opt/param tree structure changed at step {step}")
        if self._prev_step is not None:
            if step > self._prev_step + 1:
                self.violations.append(
                    f"step jumped forward {self._prev_step} -> {step}: "
                    f"data was silently dropped")
            elif step <= self._prev_step:
                # a backward or repeated step: a resume (first audited
                # step of a segment) or a spike rollback
                self.replayed_steps += self._prev_step - step + 1
                if self._seg_first:
                    self.total_resumes += 1
                else:
                    self.total_rollbacks += 1
                    self._seg_rollbacks += 1
        self._seg_first = False
        self._prev_step = step
        skipped = bool(metrics["skipped"]) if "skipped" in metrics else False
        loss = float(metrics["loss"])
        self.last_loss = loss
        if skipped:
            self.total_skips += 1
            self._seg_skips += 1
        if not np.isfinite(loss) and not skipped:
            self.violations.append(
                f"non-finite loss at step {step} not flagged skipped: "
                f"the guard failed to gate the update")
        if (self.coordinator is not None
                and self.steps_seen % self.audit_every == 0):
            # a dead or straggling host raises CoordinatorTimeout out of
            # this hook; run_chaos (the supervisor) catches it
            from .. import distributed
            core = {"params": state["params"], "opt": state["opt"]}
            sh = self.shardings
            if sh is None:
                digest = distributed.tree_fingerprint(core)
            else:
                blocks = distributed.BlockDigests(
                    core, {"params": sh["params"], "opt": sh["opt"]})
                views = blocks.rank_digests()
                digest = views[blocks.rank]
                self.violations.extend(
                    f"rank {r} state fingerprint diverged at step {step}: "
                    f"{v!r} != rank 0's {views[0]!r}"
                    for r, v in enumerate(views) if v != views[0])
            self.divergence_checks += 1
            self.violations.extend(
                self.coordinator.check_fingerprint(step, digest))
            if self.replica_audit:
                self.violations.extend(
                    distributed.replica_divergence(state["params"])
                    if sh is None else blocks.divergence())

    def on_segment_end(self, result: Dict[str, Any]) -> None:
        """``run_loop``'s returned counters against the audit's tally for
        the completed segment."""
        if result["skipped"] != self._seg_skips:
            self.violations.append(
                f"skip-counter imbalance: run_loop says "
                f"{result['skipped']}, audit saw {self._seg_skips}")
        loop_rollbacks = (result["rollbacks"]
                          + result.get("eval_rollbacks", 0))
        if loop_rollbacks != self._seg_rollbacks:
            self.violations.append(
                f"rollback-counter imbalance: run_loop says "
                f"{loop_rollbacks}, audit saw {self._seg_rollbacks}")

    def finish(self) -> None:
        if not np.isfinite(self.last_loss):
            self.violations.append(
                f"final loss not finite after recovery: {self.last_loss}")


def run_chaos(train_step, make_state: Callable[[], dict], batch_fn,
              plan: Optional[TrainFaultPlan], n_steps: int, ckpt_dir: str,
              *, ckpt_every: int = 3, ckpt_keep: int = 3,
              ckpt_shards: int = 1,
              max_skips: int = 8,
              spike_zscore: float = 8.0, spike_warmup: int = 6,
              spike_patience: int = 2, backoff_scale: float = 0.5,
              cooldown_steps: int = 8, max_rollbacks: int = 4,
              rollback_reorder: bool = True,
              n_hosts: int = 1, audit_every: int = 1,
              replica_audit: bool = True,
              coordinator_timeout: float = 30.0,
              device=None, batch_sharding=None, shardings=None,
              max_segments: int = 32,
              log: Callable = lambda *a, **k: None) -> Dict[str, Any]:
    """Drive ``run_loop`` to completion under a fault plan, emulating a
    supervisor that restarts the job after every hard kill.

    Each segment builds a fresh state (``make_state()``) and a fresh
    ``prefetch=0`` pipeline moving batches to ``device`` (prefetch would
    consume fetch ordinals for batches then dropped), then calls
    ``run_loop(auto_resume=True)``.  An :class:`InjectedCrash` ends the
    segment like SIGKILL; a ``CoordinatorTimeout`` (dead or straggling
    host) the same way, and the bus is healed at the next segment start.
    Anything else propagates.  Returns the auditor's violations and the
    counters.

    On a mesh (``shardings``: the state's NamedShardings, with an entry
    for ``lr_scale``; ``make_state`` builds the rank's blocks and
    ``train_step`` is the sharded step) every rank runs this function:
    ``batch_sharding`` hands the pipeline the rank's rows, the loop
    checkpoints from and into the blocks, and each rank keeps its own
    ``InProcessBus`` of ``n_hosts`` simulated peers.  Every fault fires on
    every rank at the same ordinal: the plan, the losses and the skip
    flags are the same on every rank, and a checkpoint's write stages
    reach every rank's hook (``checkpoint.io``), so a segment ends on
    every rank with the same exception."""
    from ..distributed import Coordinator, CoordinatorTimeout, InProcessBus
    from ..distributed.sharding import mesh_of

    mesh = mesh_of(shardings)
    bus = InProcessBus(n_hosts)
    coord = Coordinator(bus, timeout=coordinator_timeout)
    inj = ChaosInjector(plan, bus=bus, writes=mesh is None or mesh.rank == 0)
    auditor = TrainAuditor(coordinator=coord, audit_every=audit_every,
                           replica_audit=replica_audit, shardings=shardings)
    chaos_batch_fn = inj.wrap_batch_fn(batch_fn)
    crash = inj.crash_hook()

    def hook(state, metrics):
        auditor.on_step(state, metrics)   # audit first: a killed step
        crash(state, metrics)             # is still audited

    result = None
    segments = 0
    host_kill_timeouts = 0
    straggler_timeouts = 0
    with ckpt_io.write_fault_hook(inj.write_hook()):
        while result is None:
            segments += 1
            if segments > max_segments:
                auditor.violations.append(
                    f"chaos run did not complete within {max_segments} "
                    f"segments")
                break
            auditor.on_segment_start()
            bus.heal_all()      # the supervisor replaces failed hosts
            pipe = DataPipeline(chaos_batch_fn, prefetch=0, device=device,
                                sharding=batch_sharding)
            state = make_state()
            try:
                result = run_loop(
                    train_step, state, pipe, n_steps,
                    log_every=0, log=log,
                    ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                    ckpt_keep=ckpt_keep, ckpt_shards=ckpt_shards,
                    auto_resume=True,
                    max_skips=max_skips,
                    spike_zscore=spike_zscore, spike_warmup=spike_warmup,
                    spike_patience=spike_patience,
                    backoff_scale=backoff_scale,
                    cooldown_steps=cooldown_steps,
                    max_rollbacks=max_rollbacks,
                    rollback_reorder=rollback_reorder,
                    coordinator=coord,
                    step_hook=hook, shardings=shardings)
            except InjectedCrash as e:
                log(f"chaos segment {segments}: {e}")
            except CoordinatorTimeout as e:
                # a dead host and a straggler past the deadline are the
                # same silence; classify by what the injector marked
                missing = set(e.missing)
                if missing & bus.dead:
                    host_kill_timeouts += 1
                elif missing & set(bus.straggling):
                    straggler_timeouts += 1
                else:
                    auditor.violations.append(
                        f"unattributable coordinator timeout: {e}")
                log(f"chaos segment {segments}: {e}")
            finally:
                pipe.close()
            del state
    if result is not None:
        auditor.on_segment_end(result)
    auditor.finish()

    quarantined = 0
    if os.path.isdir(ckpt_dir):
        quarantined = sum(1 for d in os.listdir(ckpt_dir)
                          if ".corrupt" in d)
    return {
        "violations": auditor.violations,
        "segments": segments,
        "crashes": inj.crashes,
        "resumes": auditor.total_resumes,
        "rollbacks": auditor.total_rollbacks,
        "skipped": auditor.total_skips,
        "replayed_steps": auditor.replayed_steps,
        "steps_seen": auditor.steps_seen,
        "saves": inj.saves,
        "corrupted_saves": len(inj.corrupted),
        "quarantined": quarantined,
        "n_hosts": bus.n_hosts,
        "host_kills": inj.host_kills,
        "straggles": inj.straggles,
        "host_kill_timeouts": host_kill_timeouts,
        "straggler_timeouts": straggler_timeouts,
        "divergence_checks": auditor.divergence_checks,
        "coord_rounds": coord.rounds,
        "data_windows_skipped": (result.get("data_windows_skipped", 0)
                                 if result is not None else 0),
        "eval_rollbacks": (result.get("eval_rollbacks", 0)
                           if result is not None else 0),
        "final_loss": auditor.last_loss,
        "state": (result["state"] if result is not None else None),
        "result": result,
    }
