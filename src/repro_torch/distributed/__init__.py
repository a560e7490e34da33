"""The cross-host agreement seam (coordinator) and the divergence audit
of the self-healing training loop (port of part of
``repro.distributed``; sharding and the store-backed bus are ROADMAP
Queue 1 item 8)."""

from .audit import replica_divergence, tree_fingerprint
from .coordinator import (DEAD, AgreementError, Coordinator,
                          CoordinatorTimeout, InProcessBus, Straggle)

__all__ = ["Coordinator", "CoordinatorTimeout", "AgreementError",
           "InProcessBus", "Straggle", "DEAD",
           "tree_fingerprint", "replica_divergence"]
