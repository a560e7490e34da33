"""Host-side bookkeeping for continuous batching: the request lifecycle
state machine + the slot pool.

A *slot* is one row of the fixed-size decode batch (the compile-time
constant that keeps the scheduler at O(1) compiled decode programs).  The
pool hands out the lowest free index first — deterministic assignment, so
a replayed request stream reproduces slot placement exactly.

Request lifecycle (DESIGN.md §10).  Every submitted request moves through
an explicit state machine and MUST reach exactly one terminal state —
enforced by :meth:`Request.transition` (an illegal edge raises), and
audited globally by ``serve/faults.py``'s invariant checker::

    QUEUED ──► PREFILLING ──► DECODING ──► COMPLETED
      │  │          │             │   │
      │  │          │◄─ PREEMPTED ┘   └──► FAILED
      │  │          │   (→ QUEUED)
      │  └──────────┴────────────────────► TIMED_OUT
      └──────────────────────────────────► REJECTED

(The monolithic prefill-insert path admits QUEUED → DECODING directly —
its prefill is synchronous — and a budget-of-one request may complete
straight out of admission: QUEUED/PREFILLING → COMPLETED.)

Everything here is plain Python state; the device-side mirrors (token /
position / step-count / done-mask arrays) live in
:class:`repro_torch.serve.scheduler.Scheduler` and are updated in place by
its insert and tick functions.  The two views stay consistent because
both apply the SAME termination rule (``tokens_emitted >= max_new_tokens
or last_token == eos_id``) to the same token stream.

The port's copy of ``repro.serve.slots`` (plain Python, no JAX in either),
kept line for line so that the two packages' bookkeeping stays
comparable in the tests; the port imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

# live states
QUEUED, PREFILLING, DECODING = "queued", "prefilling", "decoding"
PREEMPTED = "preempted"        # transient: immediately re-enters QUEUED
# terminal states — exactly one per request, always reached
COMPLETED, TIMED_OUT, REJECTED, FAILED = (
    "completed", "timed_out", "rejected", "failed")

TERMINAL = frozenset({COMPLETED, TIMED_OUT, REJECTED, FAILED})

# legacy aliases (pre-lifecycle names, kept for external callers/tests)
ACTIVE, DONE = DECODING, COMPLETED

_TRANSITIONS = {
    QUEUED: frozenset({PREFILLING, DECODING, COMPLETED, TIMED_OUT,
                       REJECTED}),
    PREFILLING: frozenset({DECODING, COMPLETED, TIMED_OUT, FAILED,
                           PREEMPTED}),
    DECODING: frozenset({COMPLETED, TIMED_OUT, FAILED, PREEMPTED}),
    PREEMPTED: frozenset({QUEUED}),
    COMPLETED: frozenset(),
    TIMED_OUT: frozenset(),
    REJECTED: frozenset(),
    FAILED: frozenset(),
}


class RejectedError(ValueError):
    """Typed early rejection: the request can never be served as posed
    (malformed prompt, impossible budget) or admission control shed it.
    ``reason`` is the machine-readable tag recorded on the REJECTED
    request (``scheduler.submit(strict=False)`` returns the terminal
    request instead of raising)."""

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


def request_problem(prompt: Sequence[int], max_new_tokens: int,
                    cache_len: Optional[int],
                    vocab: Optional[int]) -> Optional[Tuple[str, str]]:
    """Validate a request AT THE DOOR (``(reason, message)`` or None) so a
    malformed submission becomes a typed REJECTED terminal state instead
    of a shape error deep inside prefill: empty prompts (prefill needs at
    least one real token), out-of-vocab token ids (the embedding gather
    would silently clamp), and prompts that cannot fit the slot's KV
    capacity alongside their token budget."""
    if len(prompt) == 0:
        return ("empty_prompt", "empty prompt: prefill needs at least one "
                                "real token")
    if vocab is not None:
        for t in prompt:
            if not isinstance(t, (int,)) or isinstance(t, bool):
                try:
                    t = int(t)
                except (TypeError, ValueError):
                    return ("oov_token",
                            f"non-integer prompt token {t!r}")
            if t < 0 or t >= vocab:
                return ("oov_token",
                        f"prompt token {t} outside vocab [0, {vocab})")
    if cache_len is not None and len(prompt) + max_new_tokens > cache_len:
        return ("over_cache_len",
                f"request needs {len(prompt)} + {max_new_tokens} cache "
                f"slots but the pool was built with cache_len={cache_len}")
    return None


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    state: str = QUEUED
    slot: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    # SLO fields: ``deadline`` is an ABSOLUTE virtual-clock time by which
    # the request must terminate (None = no deadline); higher ``priority``
    # admits first and may preempt lower-priority running slots
    deadline: Optional[float] = None
    priority: int = 0
    finish_reason: Optional[str] = None
    # structural accounting (ISSUE 4 acceptance: decode host->device
    # launches per request <= ceil(max_new_tokens / steps_per_tick))
    ticks: int = 0                  # decode ticks participated in
    admit_seq: Optional[int] = None  # global admission counter (fairness)
    # chunked-prefill / prefix-cache bookkeeping (DESIGN.md §8): a
    # PREFILLING request holds its slot while its prompt is admitted one
    # chunk per tick; prefix_hit_tokens were spliced from the trie and
    # never prefilled at all
    prefill_chunks: int = 0         # chunk launches spent on this prompt
    prefix_hit_tokens: int = 0
    # paged-KV bookkeeping (DESIGN.md §13): a preempted DECODING victim
    # keeps its quantized KV blocks pinned — ``blocks`` is the saved
    # block-table row (ownership moves here from the slot table) and
    # resume is a table re-attach, exact for ANY KV format
    blocks: Optional[List[int]] = None
    # fault-tolerance accounting (DESIGN.md §10)
    preemptions: int = 0            # times evicted back to the queue
    nan_retries: int = 0            # non-finite quarantines -> fallback
    resume_splice_tokens: int = 0   # resume-prefill tokens spliced from
    resume_total_tokens: int = 0    # ... the trie, of this many total
    # offered-load replay bookkeeping (virtual-clock seconds)
    arrival: float = 0.0
    t_admit: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.state == COMPLETED

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL

    def transition(self, new: str, reason: Optional[str] = None) -> None:
        """Move to ``new``, enforcing the lifecycle edges.  Illegal moves
        raise — a request can never leave a terminal state, and the graph
        above is the complete edge set."""
        if new not in _TRANSITIONS.get(self.state, frozenset()):
            raise RuntimeError(
                f"invalid lifecycle transition {self.state!r} -> {new!r} "
                f"for request {self.rid}")
        self.state = new
        if new in TERMINAL and reason is not None:
            self.finish_reason = reason

    def resume_tokens(self) -> List[int]:
        """The effective prompt for (re-)admission: the original prompt
        plus every emitted token EXCEPT the newest (``out[-1]`` has not
        been written to KV yet — it is the in-flight token the resumed
        decode feeds next, exactly where the preempted stream stopped)."""
        if self.out:
            return self.prompt + self.out[:-1]
        return list(self.prompt)

    def finished_by(self, tok: int, emitted: int) -> bool:
        """Termination rule — MUST match the device-side done-masking in
        the decode tick: the request ends with its ``emitted``-th token or
        on EOS (EOS is included in the output)."""
        return emitted >= self.max_new_tokens or (
            self.eos_id is not None and tok == self.eos_id)


class SlotPool:
    """Fixed pool of decode slots; lowest-free-index-first assignment."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self._free = list(range(n_slots))
        self._occupant = {}          # slot -> rid

    @property
    def n_free(self) -> int:
        return len(self._free)

    def occupied(self):
        """(slot, rid) pairs currently active, slot-ordered."""
        return sorted(self._occupant.items())

    def free_slots(self) -> List[int]:
        """Snapshot of the free list (for the invariant checker)."""
        return sorted(self._free)

    def acquire(self, rid: int) -> int:
        if not self._free:
            raise RuntimeError("no free slot")
        self._free.sort()
        slot = self._free.pop(0)
        self._occupant[slot] = rid
        return slot

    def release(self, slot: int) -> None:
        rid = self._occupant.pop(slot, None)
        if rid is None:
            raise KeyError(f"slot {slot} not occupied")
        self._free.append(slot)
