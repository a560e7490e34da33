"""Cross-host agreement seam of the self-healing training loop (port of
``repro.distributed.coordinator``, pure Python, copied).

Host-level decisions (which checkpoint to restore, which step a spike
rollback targets, where the data pipeline seeks) are made in Python, and
a host that decides alone diverges the replica set silently.  All such
decisions therefore flow through a :class:`Coordinator`:

* ``elect_checkpoint(local_best)`` — newest-common-valid election: the
  minimum over every host's newest locally valid step; ``None`` from any
  host elects ``None`` (fresh start).
* ``agree(kind, value)`` — every host must post the same value; a
  mismatch is a typed :class:`AgreementError`.
* ``barrier(name)`` / ``check_fingerprint(step, digest)`` — rendezvous
  and state-digest comparison; the fingerprint round doubles as the
  liveness heartbeat.

Every round carries a timeout: a dead or straggling host becomes a typed
:class:`CoordinatorTimeout` naming the missing hosts, never a hang.

:class:`InProcessBus` simulates ``n_hosts`` peers inside one process:
peers echo host 0's value by default; a ``peer_fn`` can make one lie,
return :data:`DEAD`, or return a :class:`Straggle` whose virtual delay is
compared against the timeout (no wall-clock sleeping).  It is the only
bus, as in the JAX package; the mesh's ranks agree on a restore target by
a broadcast from rank 0 (``train/loop.py::newest_valid_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


class _Dead:
    __slots__ = ()

    def __repr__(self):  # pragma: no cover - repr only
        return "DEAD"


#: sentinel a ``peer_fn`` returns for a host that never answers
DEAD = _Dead()


@dataclasses.dataclass(frozen=True)
class Straggle:
    """A peer response that arrives after a *virtual* ``delay`` seconds.
    ``delay > timeout`` is indistinguishable from dead and must convert
    into the same :class:`CoordinatorTimeout`."""

    delay: float


class CoordinatorTimeout(RuntimeError):
    """A coordination round timed out: ``missing`` hosts are dead or
    straggling past the deadline.  Raised instead of hanging — the
    supervisor restarts the job like any other crash."""

    def __init__(self, msg: str, key: str = "",
                 missing: Tuple[int, ...] = ()):
        super().__init__(msg)
        self.key = key
        self.missing = tuple(missing)


class AgreementError(RuntimeError):
    """Hosts posted different values for a decision that must be
    unanimous — a split-brain rollback/seek would silently diverge the
    replicas, so this aborts loudly instead."""

    def __init__(self, msg: str, votes: Optional[Dict[int, Any]] = None):
        super().__init__(msg)
        self.votes = dict(votes or {})


class InProcessBus:
    """Simulated ``n_hosts`` agreement bus for one-process testing.

    Host 0 is this process (the one running the loop); hosts
    ``1..n-1`` are simulated peers.  ``kill``/``straggle`` mark peer
    fault state (the chaos harness's host-level faults); ``heal_all``
    models the supervisor replacing failed hosts between segments.
    """

    def __init__(self, n_hosts: int = 1,
                 peer_fn: Optional[Callable[[int, str, Any], Any]] = None):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        self.n_hosts = int(n_hosts)
        self.peer_fn = peer_fn
        self.dead: set = set()
        self.straggling: Dict[int, float] = {}

    def _check_peer(self, host: int) -> int:
        host = int(host)
        if host == 0:
            raise ValueError("host 0 is this process — kill it with "
                             "InjectedCrash, not through the bus")
        if not 1 <= host < self.n_hosts:
            raise ValueError(f"no such host {host} (n_hosts="
                             f"{self.n_hosts})")
        return host

    def kill(self, host: int) -> None:
        self.dead.add(self._check_peer(host))

    def straggle(self, host: int, delay: float) -> None:
        self.straggling[self._check_peer(host)] = float(delay)

    def heal_all(self) -> None:
        self.dead.clear()
        self.straggling.clear()

    def round(self, key: str, value: Any, timeout: float
              ) -> Tuple[Dict[int, Any], List[int]]:
        """One agreement round: returns ``(votes, missing)`` where votes
        maps host -> posted value for every host that answered within
        the (virtual) timeout."""
        votes: Dict[int, Any] = {0: value}
        missing: List[int] = []
        for h in range(1, self.n_hosts):
            v = value if self.peer_fn is None else self.peer_fn(h, key,
                                                                value)
            delay = self.straggling.get(h, 0.0)
            if isinstance(v, Straggle):
                delay = max(delay, v.delay)
                v = value
            if h in self.dead or v is DEAD or delay > timeout:
                missing.append(h)
                continue
            votes[h] = v
        return votes, missing


class Coordinator:
    """Host-level decision funnel (see module docstring).  The default
    ``Coordinator()`` is a single-host bus: every round trivially
    succeeds with host 0's own value, so single-host ``run_loop``
    behavior is unchanged."""

    def __init__(self, bus: Optional[InProcessBus] = None,
                 timeout: float = 30.0):
        self.bus = bus if bus is not None else InProcessBus(1)
        self.timeout = float(timeout)
        self.rounds = 0
        self._seq = 0

    @property
    def n_hosts(self) -> int:
        return self.bus.n_hosts

    def _round(self, kind: str, value: Any) -> Dict[int, Any]:
        # monotonic sequence number: every decision is a distinct round,
        # a replayed/raced message can never satisfy a later decision
        self._seq += 1
        key = f"{kind}#{self._seq}"
        votes, missing = self.bus.round(key, value, self.timeout)
        self.rounds += 1
        if missing:
            raise CoordinatorTimeout(
                f"{kind}: host(s) {sorted(missing)} did not respond "
                f"within {self.timeout:g}s — dead or straggling; "
                f"converting the hang into a restartable error",
                key=key, missing=tuple(missing))
        return votes

    def elect_checkpoint(self, local_best: Optional[int]) -> Optional[int]:
        """Newest-common-valid checkpoint step across hosts (min over
        every host's newest locally-valid step), or None if any host has
        no valid checkpoint at all."""
        votes = self._round("elect_ckpt", local_best)
        if any(v is None for v in votes.values()):
            return None
        return min(int(v) for v in votes.values())

    def agree(self, kind: str, value: Any) -> Any:
        """Unanimous agreement on ``value``; returns it, or raises
        :class:`AgreementError` on any mismatch."""
        votes = self._round(kind, value)
        if any(v != value for v in votes.values()):
            raise AgreementError(
                f"hosts disagree on {kind}: {votes!r}", votes=votes)
        return value

    def barrier(self, name: str = "barrier") -> None:
        """Rendezvous: returns once every live host arrived; a missing
        host raises :class:`CoordinatorTimeout` instead of hanging."""
        self._round(f"barrier:{name}", True)

    def check_fingerprint(self, step: int, digest: str) -> List[str]:
        """Post the local param-tree digest and compare against every
        host's; returns one violation string per diverged host.  The
        round doubles as the liveness heartbeat — a dead host surfaces
        here as :class:`CoordinatorTimeout` within ``audit_every``
        steps."""
        votes = self._round(f"fingerprint@{step}", digest)
        return [f"host {h} param fingerprint diverged at step {step}: "
                f"{v!r} != {digest!r}"
                for h, v in sorted(votes.items()) if v != digest]
