"""Offered-load replay: a Poisson request stream served by static
batching vs the continuous-batching scheduler, on a shared virtual clock.

The replay drives both serving disciplines with the SAME workload
(seeded: ragged prompt lengths, heterogeneous per-request token budgets,
exponential inter-arrival gaps) and charges each host->device launch's
measured wall time to a virtual clock that also gates admissions — so
throughput, per-request latency and goodput are comparable between
disciplines and across machines, while arrivals stay deterministic.

Static discipline: a barrier server — take up to ``n_slots`` queued
requests that have arrived, run one ``Engine.generate`` (every row pays
the batch-max token budget), repeat.  Continuous discipline:
``Scheduler.step(now=clock)`` — admission happens whenever a slot frees,
finished requests retire mid-flight.

Used by ``repro_torch.launch.serve --scheduler`` and ``chip_smoke.py``.
On a device mesh every rank replays the whole stream: each step's wall
time is the largest rank's, so every rank's clock reads the same, and a
chaos audit violation on any rank fails the replay on every rank.

The port's copy of ``repro.serve.replay`` (plain Python, no JAX in either),
kept line for line so that the two packages' bookkeeping stays
comparable in the tests; the port imports nothing of ``repro``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ReplayRequest:
    prompt: List[int]
    max_new_tokens: int
    arrival: float                # seconds on the virtual clock
    # SLO fields (DESIGN.md §10): ``deadline`` is ABSOLUTE virtual-clock
    # time (None = best-effort); higher ``priority`` admits first and may
    # preempt lower-priority running slots
    deadline: Optional[float] = None
    priority: int = 0


def poisson_workload(seed: int, n_requests: int, vocab: int,
                     rate: float = 50.0,
                     prompt_lens=(2, 12),
                     budgets=(2, 2, 4, 8, 16, 24)) -> List[ReplayRequest]:
    """Seeded Poisson stream with ragged prompts and a long-tailed budget
    mix (the heterogeneity static batching pays max() over)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    out = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        out.append(ReplayRequest(
            prompt=rng.integers(0, vocab, plen).tolist(),
            max_new_tokens=int(rng.choice(budgets)),
            arrival=float(arrivals[i])))
    return out


def shared_prefix_workload(seed: int, n_requests: int, vocab: int,
                           rate: float = 50.0,
                           sys_len: int = 16,
                           tail_lens=(2, 8),
                           straggler_every: int = 6,
                           straggler_len: int = 48,
                           budgets=(2, 4, 8, 16)) -> List[ReplayRequest]:
    """Chat-shaped Poisson stream: every prompt opens with the SAME
    ``sys_len``-token system prompt (the dominant real-traffic pattern
    the prefix cache exists for) followed by a short unique tail, and
    every ``straggler_every``-th request is a long-prompt straggler
    (unique ``straggler_len``-token prompt) — the head-of-line blocker
    chunked prefill exists for."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    sys_prompt = rng.integers(0, vocab, sys_len).tolist()
    out = []
    for i in range(n_requests):
        if straggler_every and (i + 1) % straggler_every == 0:
            prompt = rng.integers(0, vocab, straggler_len).tolist()
        else:
            tail = int(rng.integers(tail_lens[0], tail_lens[1] + 1))
            prompt = sys_prompt + rng.integers(0, vocab, tail).tolist()
        out.append(ReplayRequest(
            prompt=prompt,
            max_new_tokens=int(rng.choice(budgets)),
            arrival=float(arrivals[i])))
    return out


def sla_workload(seed: int, n_requests: int, vocab: int,
                 rate: float = 50.0,
                 prompt_lens=(2, 12),
                 budgets=(2, 2, 4, 8, 16, 24),
                 deadline_frac: float = 0.5,
                 slack=(0.2, 3.0),
                 hi_priority_frac: float = 0.2) -> List[ReplayRequest]:
    """Poisson stream with SLOs attached: ``deadline_frac`` of requests
    carry an absolute deadline (arrival + a slack drawn from ``slack``),
    and ``hi_priority_frac`` arrive at priority 1 (the preemptors).  The
    base stream matches :func:`poisson_workload`'s shape so SLO behaviour
    is the only variable."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    out = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        deadline = None
        if rng.random() < deadline_frac:
            deadline = float(arrivals[i]) + float(
                rng.uniform(slack[0], slack[1]))
        out.append(ReplayRequest(
            prompt=rng.integers(0, vocab, plen).tolist(),
            max_new_tokens=int(rng.choice(budgets)),
            arrival=float(arrivals[i]),
            deadline=deadline,
            priority=1 if rng.random() < hi_priority_frac else 0))
    return out


def _metrics(latency: Dict[int, float], tokens: Dict[int, List[int]],
             makespan: float, slo: float) -> dict:
    lats = np.asarray([latency[i] for i in sorted(latency)])
    total = sum(len(t) for t in tokens.values())
    good = sum(len(tokens[i]) for i in tokens if latency[i] <= slo)
    return {
        "makespan_s": makespan,
        "total_tokens": total,
        "tok_per_s": total / max(makespan, 1e-9),
        "latency_p50_s": float(np.percentile(lats, 50)),
        "latency_p95_s": float(np.percentile(lats, 95)),
        # goodput: tokens of requests that met the latency SLO (compare()
        # sets it to the static run's MEDIAN latency)
        "goodput_tok_per_s": good / max(makespan, 1e-9),
        "slo_s": slo,
    }


def _agreed(server, seconds: float) -> float:
    """A step's wall time as every rank of the server's mesh charges it to
    the clock: the largest rank's (one collective), so that arrivals,
    barrier groups and deadlines fall on the same step everywhere."""
    if getattr(server, "mesh", None) is None:
        return seconds
    from ..distributed.collectives import world_gather
    return float(world_gather(torch.tensor([seconds],
                                           dtype=torch.float64)).max())


def replay_static(engine, workload: List[ReplayRequest],
                  n_slots: int) -> dict:
    """Barrier server: groups of <= n_slots arrived requests, one static
    ``generate`` per group.  Returns outputs + completion bookkeeping."""
    clock = 0.0
    pending = list(range(len(workload)))
    outputs: Dict[int, List[int]] = {}
    done_at: Dict[int, float] = {}
    n_launches = 0
    while pending:
        clock = max(clock, workload[pending[0]].arrival)
        group = [i for i in pending if workload[i].arrival <= clock][:n_slots]
        pending = [i for i in pending if i not in group]
        t0 = time.perf_counter()
        outs = engine.generate([workload[i].prompt for i in group],
                               max_new_tokens=[workload[i].max_new_tokens
                                               for i in group])
        dt = _agreed(engine, time.perf_counter() - t0)
        # the whole batch completes at the barrier
        clock += dt
        n_launches += 1 + max(w.max_new_tokens
                              for w in (workload[i] for i in group)) - 1
        for i, o in zip(group, outs):
            outputs[i] = o
            done_at[i] = clock
    latency = {i: done_at[i] - workload[i].arrival for i in done_at}
    return {"outputs": outputs, "latency": latency, "makespan": clock,
            "decode_launches": n_launches}


def replay_continuous(scheduler, workload: List[ReplayRequest]) -> dict:
    """Continuous server: submit the stream, drive ``step(now=clock)``."""
    rid_of = {}
    for i, w in enumerate(workload):
        rid_of[scheduler.submit(w.prompt, w.max_new_tokens,
                                arrival=w.arrival)] = i
    clock = 0.0
    start_ticks = scheduler.n_ticks   # scheduler may be warm (reused)
    start_computed = scheduler.prefill_tokens_computed
    start_skipped = scheduler.prefill_tokens_skipped
    done_at: Dict[int, float] = {}
    # per-step stall capture: scheduler.stall_log is a bounded deque (a
    # long-lived server must not grow host memory), so the replay keeps
    # its own complete list by reading the newest entry after each step
    stall_ticks: List[int] = []
    while scheduler.has_work():
        if not scheduler.pool.occupied():
            # idle: jump to the next arrival still in the queue
            nxt = min(scheduler.requests[r].arrival for r in scheduler.queue)
            clock = max(clock, nxt)
        t0 = time.perf_counter()
        completed = scheduler.step(now=clock)
        clock += _agreed(scheduler, time.perf_counter() - t0)
        stall_ticks.append(scheduler.stall_log[-1])
        for req in completed:
            done_at[rid_of[req.rid]] = clock
    outputs = {rid_of[r]: scheduler.requests[r].out for r in rid_of}
    latency = {i: done_at[i] - workload[i].arrival for i in done_at}
    ticks = {rid_of[r]: scheduler.requests[r].ticks for r in rid_of}
    return {"outputs": outputs, "latency": latency, "makespan": clock,
            "decode_launches": scheduler.n_ticks - start_ticks,
            "ticks": ticks,
            # structural decode-stall signal (ISSUE 5): prefill tokens
            # each step() interposed before its decode scan — bounded by
            # prefill_chunk under chunked admission, by the longest
            # prompt under monolithic prefill-insert
            "prefill_tokens_per_tick": stall_ticks,
            "prefill_tokens_computed":
                scheduler.prefill_tokens_computed - start_computed,
            "prefill_tokens_skipped":
                scheduler.prefill_tokens_skipped - start_skipped}


def compare(static: dict, continuous: dict) -> dict:
    """Joint summary at a shared SLO (the static run's median latency —
    requests a barrier server half-serves comfortably)."""
    slo = float(np.percentile(
        [static["latency"][i] for i in static["latency"]], 50))
    s = _metrics(static["latency"], static["outputs"],
                 static["makespan"], slo)
    c = _metrics(continuous["latency"], continuous["outputs"],
                 continuous["makespan"], slo)
    s["decode_launches"] = static["decode_launches"]
    c["decode_launches"] = continuous["decode_launches"]
    stall = continuous.get("prefill_tokens_per_tick")
    if stall is not None:
        busy = [t for t in stall if t > 0]
        c["prefill_stall_max_tokens"] = int(max(busy, default=0))
        c["prefill_stall_nonzero_p95_tokens"] = (
            float(np.percentile(busy, 95)) if busy else 0.0)
        c["prefill_tokens_computed"] = continuous["prefill_tokens_computed"]
        c["prefill_tokens_skipped"] = continuous["prefill_tokens_skipped"]
    return {
        "static": s,
        "continuous": c,
        "throughput_ratio": c["tok_per_s"] / max(s["tok_per_s"], 1e-9),
        "outputs_identical": static["outputs"] == continuous["outputs"],
    }


def replay_chaos(scheduler, workload: List[ReplayRequest],
                 plan=None, tick_s: float = 0.05,
                 max_ticks: int = 100_000) -> dict:
    """Fault-injecting replay on a FULLY DETERMINISTIC virtual clock
    (DESIGN.md §10).

    Unlike :func:`replay_continuous` (which charges measured wall time to
    the clock — right for throughput numbers, wrong for reproducible
    fault schedules), every tick here costs a fixed ``tick_s`` virtual
    seconds plus any straggler stall the plan injects — so deadline
    expiries, shed decisions and preemptions land on the SAME tick on
    every machine, and the robustness counters are zero-tolerance
    gateable in CI.

    Requests are submitted AT their arrival tick (not upfront), so the
    bounded queue and the SLO shed estimate see the real backlog.  After
    every tick the global invariant audit runs
    (:func:`repro_torch.serve.faults.check_invariants`); at drain the terminal
    contract is checked (:func:`~repro_torch.serve.faults.check_drained`).
    ``plan=None`` replays the same loop with zero faults — the bit-parity
    leg of the chaos gate.
    """
    from .faults import apply_tick_faults, check_drained, check_invariants
    rng = np.random.default_rng((plan.seed if plan is not None else 0) + 1)
    vocab = scheduler.cfg.vocab
    pending = collections.deque(sorted(range(len(workload)),
                                       key=lambda i: workload[i].arrival))
    rid_of: Dict[int, int] = {}
    done_at: Dict[int, float] = {}
    violations: List[str] = []
    clock, tick = 0.0, 0
    while pending or scheduler.has_work():
        if tick >= max_ticks:
            violations.append(
                f"livelock: replay did not drain within {max_ticks} ticks")
            break
        if not scheduler.has_work() and pending:
            # idle: jump the clock to the next arrival
            clock = max(clock, workload[pending[0]].arrival)
        while pending and workload[pending[0]].arrival <= clock:
            i = pending.popleft()
            w = workload[i]
            rid = scheduler.submit(w.prompt, w.max_new_tokens,
                                   arrival=w.arrival, deadline=w.deadline,
                                   priority=w.priority, strict=False)
            rid_of[rid] = i
        stall = apply_tick_faults(scheduler, plan, tick, rng, vocab)
        terminal = scheduler.step(now=clock)
        clock += tick_s + stall
        for req in terminal:
            req.t_done = clock
            if req.rid in rid_of:
                done_at[rid_of[req.rid]] = clock
        violations += [f"tick {tick}: {v}"
                       for v in check_invariants(scheduler)]
        tick += 1
    violations += [f"drain: {v}" for v in check_drained(scheduler)]
    if getattr(scheduler, "mesh", None) is not None:
        # a violation on any rank fails the run on every rank
        from ..distributed.collectives import world_gather
        per_rank = world_gather(torch.tensor([len(violations)]))
        me = scheduler.mesh.rank
        violations += [f"rank {r}: {int(n)} invariant violations"
                       for r, n in enumerate(per_rank.reshape(-1).tolist())
                       if n and r != me]

    # terminal-state accounting over the WORKLOAD's requests (the plan's
    # own malformed/burst submissions are counted separately)
    by_state: Dict[str, int] = {}
    deadlined = hit = 0
    outputs: Dict[int, List[int]] = {}
    for rid, i in rid_of.items():
        req = scheduler.requests[rid]
        by_state[req.state] = by_state.get(req.state, 0) + 1
        if req.done:
            outputs[i] = req.out
        if req.deadline is not None:
            deadlined += 1
            if req.done and req.t_done is not None \
                    and req.t_done <= req.deadline:
                hit += 1
    good = sum(len(outputs[i]) for i in outputs
               if workload[i].deadline is None
               or done_at.get(i, float("inf")) <= workload[i].deadline)
    return {
        "outputs": outputs,
        "by_state": by_state,
        "violations": violations,
        "counters": dict(scheduler.counters),
        "ticks": tick,
        "makespan": clock,
        "deadlined": deadlined,
        "deadline_hit_rate": hit / deadlined if deadlined else 1.0,
        # goodput: tokens of workload requests that completed within
        # their deadline (best-effort requests always count)
        "goodput_tok": good,
        "goodput_tok_per_s": good / max(clock, 1e-9),
        "resume_splice_tokens": scheduler.resume_splice_tokens,
        "resume_recompute_tokens": scheduler.resume_recompute_tokens,
    }
