"""Deterministic fault injection + global invariant audit for the serve
scheduler (DESIGN.md §10).

The scheduler's fault-tolerance claims are behavioural ("every request
terminally resolves", "overload sheds instead of collapsing", "a NaN
quarantines one slot, not the server") — claims that only hold if they
survive faults actually happening.  This module supplies both halves of
that proof:

* :func:`chaos_plan` builds a **seeded, fully deterministic** schedule of
  faults keyed by virtual-clock tick index: logit-NaN injection into
  chosen occupied slots, straggler ticks (virtual-clock stalls that make
  deadlines fire), prefix-cache eviction storms (``PrefixCache.flush``),
  malformed submissions (empty / over-``cache_len`` / out-of-vocab
  prompts), and burst arrivals sized past the bounded queue.  The same
  ``(seed, knobs)`` always yields the same plan — a chaos failure is
  reproducible by construction.
* :func:`check_invariants` audits the scheduler's GLOBAL consistency and
  is cheap enough to run after **every** tick of a chaos replay: slot
  accounting (free + occupied partitions the pool; no two live slots
  share a request; every occupant is in a live slot-holding state),
  prefix-trie refcount balance against the outstanding prefill pins (the
  pin-leak regression this PR fixes), queue/terminal-state consistency,
  and counter sanity.
* :func:`check_drained` asserts the terminal contract once a replay
  drains: every submitted request is in exactly one terminal state, all
  slots are free, all pins released, and the lifecycle counters balance
  (``submitted == completed + timed_out + rejected + shed + failed``).

Faults are injected through the scheduler's public hooks
(:meth:`~repro_torch.serve.scheduler.Scheduler.inject_nonfinite`,
``PrefixCache.flush``, ``submit(strict=False)``) — the chaos layer holds
no private state and cannot itself desynchronize the thing it audits.

The port's copy of ``repro.serve.faults`` (plain Python, no JAX in either),
kept line for line so that the two packages' bookkeeping stays
comparable in the tests; the port imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .slots import (DECODING, PREFILLING, QUEUED, TERMINAL)

# counter identity at drain: every submission resolves exactly once
_TERMINAL_COUNTERS = ("completed", "timed_out", "rejected", "shed", "failed")


@dataclasses.dataclass
class FaultPlan:
    """One deterministic chaos schedule (all keyed by tick index)."""

    seed: int
    # tick -> how many occupied slots get non-finite logits that tick
    nan_ticks: Dict[int, int] = dataclasses.field(default_factory=dict)
    # tick -> extra virtual-clock seconds (a straggler/GC-pause tick)
    straggler_ticks: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    # ticks at which every unpinned prefix-trie block is evicted
    storm_ticks: frozenset = frozenset()
    # tick -> list of malformed prompts to submit (strict=False)
    malformed: Dict[int, List[List[int]]] = dataclasses.field(
        default_factory=dict)
    # tick -> burst size of well-formed submissions (sized to overflow
    # the bounded queue when the plan wants queue_full rejections)
    bursts: Dict[int, int] = dataclasses.field(default_factory=dict)
    # fraction of NaN injections whose fallback retry ALSO faults
    fail_fallback_frac: float = 0.0

    def describe(self) -> str:
        return (f"FaultPlan(seed={self.seed}, nans={len(self.nan_ticks)}, "
                f"stragglers={len(self.straggler_ticks)}, "
                f"storms={len(self.storm_ticks)}, "
                f"malformed={sum(len(v) for v in self.malformed.values())}, "
                f"bursts={len(self.bursts)})")


def chaos_plan(seed: int, n_ticks: int = 64, vocab: int = 256,
               cache_len: int = 256,
               nan_rate: float = 0.08, straggler_rate: float = 0.08,
               storm_rate: float = 0.05, malformed_rate: float = 0.08,
               burst_rate: float = 0.03, burst_size: int = 32,
               fail_fallback_frac: float = 0.25) -> FaultPlan:
    """Sample a :class:`FaultPlan` over ``n_ticks`` replay ticks from a
    seeded generator — same arguments, same plan, machine-independent."""
    rng = np.random.default_rng(seed)
    plan = FaultPlan(seed=seed, fail_fallback_frac=fail_fallback_frac)
    storms = []
    for t in range(n_ticks):
        if rng.random() < nan_rate:
            plan.nan_ticks[t] = int(rng.integers(1, 3))
        if rng.random() < straggler_rate:
            plan.straggler_ticks[t] = float(rng.uniform(2.0, 8.0))
        if rng.random() < storm_rate:
            storms.append(t)
        if rng.random() < malformed_rate:
            kind = int(rng.integers(0, 3))
            if kind == 0:
                bad: List[int] = []                      # empty prompt
            elif kind == 1:
                bad = [int(x) for x in                   # over cache_len
                       rng.integers(0, vocab, cache_len + 1)]
            else:
                bad = [int(vocab) + 7, 0, 1]             # out-of-vocab id
            plan.malformed.setdefault(t, []).append(bad)
        if rng.random() < burst_rate:
            plan.bursts[t] = burst_size
    plan.storm_ticks = frozenset(storms)
    return plan


# ----------------------------------------------------------------------
# invariant audit
# ----------------------------------------------------------------------

def check_invariants(sch) -> List[str]:
    """Audit one scheduler's global consistency; returns a list of
    violation strings (empty == healthy).  Cheap (host-side bookkeeping
    only) — chaos replays run it after every tick."""
    v: List[str] = []
    pool = sch.pool

    # 1. slot accounting: free + occupied partitions [0, n_slots)
    free = pool.free_slots()
    occ = pool.occupied()
    seen = sorted(free + [s for s, _ in occ])
    if seen != list(range(pool.n_slots)):
        v.append(f"slot leak: free {free} + occupied "
                 f"{[s for s, _ in occ]} != range({pool.n_slots})")

    # 2. no two live slots share a request; occupants hold live states
    rids = [rid for _, rid in occ]
    if len(rids) != len(set(rids)):
        v.append(f"request holds two slots: {sorted(rids)}")
    for slot, rid in occ:
        req = sch.requests.get(rid)
        if req is None:
            v.append(f"slot {slot} occupied by unknown rid {rid}")
            continue
        if req.state not in (PREFILLING, DECODING):
            v.append(f"slot {slot} occupied by rid {rid} in "
                     f"non-slot-holding state {req.state!r}")
        if req.slot != slot:
            v.append(f"rid {rid} thinks it is in slot {req.slot}, "
                     f"pool says {slot}")

    # 3. queue consistency: queued rids exist, are in state QUEUED, hold
    #    no slot, and appear at most once
    qrids = list(sch.queue)
    if len(qrids) != len(set(qrids)):
        v.append("rid queued twice")
    for rid in qrids:
        req = sch.requests.get(rid)
        if req is None:
            v.append(f"queued rid {rid} unknown")
        elif req.state != QUEUED:
            v.append(f"queued rid {rid} in state {req.state!r}")
        elif req.slot is not None:
            v.append(f"queued rid {rid} still holds slot {req.slot}")

    # 4. every request is queued, slotted-or-prefilling, or terminal —
    #    nothing falls between the cracks
    slotted = set(rids)
    queued = set(qrids)
    for rid, req in sch.requests.items():
        if req.state in TERMINAL:
            if req.slot is not None:
                v.append(f"terminal rid {rid} ({req.state}) still holds "
                         f"slot {req.slot}")
            if rid in queued:
                v.append(f"terminal rid {rid} still queued")
            continue
        if req.state == QUEUED and rid not in queued:
            v.append(f"rid {rid} in state QUEUED but not in the queue")
        if req.state in (PREFILLING, DECODING) and rid not in slotted:
            v.append(f"rid {rid} in state {req.state!r} without a slot")

    # 5. prefill-job bookkeeping matches PREFILLING states
    jobs = getattr(sch, "_prefills", {})
    for rid in jobs:
        req = sch.requests.get(rid)
        if req is None or req.state != PREFILLING:
            v.append(f"prefill job for rid {rid} in state "
                     f"{req.state if req else '??'}")
    for slot, rid in occ:
        if sch.requests[rid].state == PREFILLING and rid not in jobs:
            v.append(f"PREFILLING rid {rid} has no prefill job")

    # 6. prefix-trie refcount balance vs outstanding pins (pin-leak gate)
    if sch.prefix is not None:
        pinned_paths = [j.pinned for j in jobs.values() if j.pinned]
        v += [f"prefix: {p}"
              for p in sch.prefix.refcount_imbalance(pinned_paths)]

    # 7. counters never go negative and terminal tallies match states
    for k, n in sch.counters.items():
        if n < 0:
            v.append(f"counter {k} negative: {n}")

    # 8. paged block pool (DESIGN.md §13): every live block's refcount
    #    equals its external holders — block-table entries + preempted
    #    victims' saved tables + trie-attached block ids — and the pool's
    #    own free/live partition is consistent (no aliasing, no leaks)
    bp = getattr(sch, "block_pool", None)
    if bp is not None:
        expected: Dict[int, int] = {}
        for row in sch._tables_host:
            for bid in row:
                if bid:
                    expected[int(bid)] = expected.get(int(bid), 0) + 1
        for rid, req in sch.requests.items():
            if not req.blocks:
                continue
            if req.state in TERMINAL:
                v.append(f"terminal rid {rid} ({req.state}) still holds "
                         f"pool blocks {req.blocks}")
            for bid in req.blocks:
                if bid:
                    expected[int(bid)] = expected.get(int(bid), 0) + 1
        if sch.prefix is not None:
            for node in sch.prefix.nodes():
                bid = getattr(node.payload, "block_id", None)
                if bid is not None:
                    expected[int(bid)] = expected.get(int(bid), 0) + 1
        v += [f"block_pool: {p}" for p in bp.audit(expected)]
    return v


def check_drained(sch) -> List[str]:
    """Terminal contract once a replay drains: every submission in
    exactly one terminal state, pool empty, pins released, counters
    balanced."""
    v = check_invariants(sch)
    if sch.has_work():
        v.append("drained scheduler still has work")
    for rid, req in sch.requests.items():
        if not req.terminal:
            v.append(f"rid {rid} never reached a terminal state "
                     f"(stuck in {req.state!r})")
    if sch.pool.occupied():
        v.append(f"slots still occupied at drain: {sch.pool.occupied()}")
    if sch.prefix is not None and sch.prefix.total_refcount():
        v.append(f"prefix pins leaked at drain: "
                 f"{sch.prefix.total_refcount()}")
    bp = getattr(sch, "block_pool", None)
    if bp is not None:
        if sch._tables_host.any():
            v.append("block tables still populated at drain")
        if getattr(sch, "_paged_reserved", None):
            v.append(f"paged block reservations leaked at drain: "
                     f"{sorted(sch._paged_reserved)}")
        trie_held = 0
        if sch.prefix is not None:
            trie_held = sum(
                1 for node in sch.prefix.nodes()
                if getattr(node.payload, "block_id", None) is not None)
        if bp.n_live != trie_held:
            v.append(f"pool blocks leaked at drain: {bp.n_live} live vs "
                     f"{trie_held} held by the trie")
    c = sch.counters
    resolved = sum(c[k] for k in _TERMINAL_COUNTERS)
    if c["submitted"] != resolved:
        v.append(f"counter imbalance: submitted {c['submitted']} != "
                 f"{' + '.join(_TERMINAL_COUNTERS)} = {resolved}")
    # cross-check counters against actual terminal states
    by_state: Dict[str, int] = {}
    for req in sch.requests.values():
        by_state[req.state] = by_state.get(req.state, 0) + 1
    want = {
        "completed": c["completed"],
        "timed_out": c["timed_out"],
        "rejected": c["rejected"] + c["shed"],
        "failed": c["failed"],
    }
    for state, n in want.items():
        if by_state.get(state, 0) != n:
            v.append(f"counter {state}={n} but {by_state.get(state, 0)} "
                     f"requests ended in that state")
    return v


def apply_tick_faults(sch, plan: Optional[FaultPlan], tick: int,
                      rng: np.random.Generator,
                      vocab: int) -> float:
    """Apply ``plan``'s faults for ``tick`` to ``sch`` (called by
    ``replay_chaos`` just before the scheduler steps).  Returns the extra
    virtual-clock delay this tick suffers (straggler stall)."""
    if plan is None:
        return 0.0
    if tick in plan.storm_ticks and sch.prefix is not None:
        sch.prefix.flush()
    for bad in plan.malformed.get(tick, []):
        sch.submit(bad, max_new_tokens=4, strict=False)
    if tick in plan.bursts:
        # a burst of well-formed submissions sized past max_queue: the
        # overflow must shed as queue_full, never queue unboundedly
        for _ in range(plan.bursts[tick]):
            p = [int(x) for x in rng.integers(0, vocab, 4)]
            sch.submit(p, max_new_tokens=4, strict=False)
    n_nan = plan.nan_ticks.get(tick, 0)
    if n_nan:
        decoding = [s for s, rid in sch.pool.occupied()
                    if sch.requests[rid].state == DECODING]
        if decoding:
            pick = rng.choice(len(decoding),
                              size=min(n_nan, len(decoding)),
                              replace=False)
            fail = bool(rng.random() < plan.fail_fallback_frac)
            sch.inject_nonfinite([decoding[i] for i in pick],
                                 fail_fallback=fail)
    return plan.straggler_ticks.get(tick, 0.0)
