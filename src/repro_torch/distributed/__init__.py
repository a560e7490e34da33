"""The port's ``repro.distributed``: the sharding rules and placements
(``sharding``), the model's placement context (``context``), the
collectives over a mesh (``collectives``), and the self-healing loop's
cross-host agreement seam (``coordinator``: the in-process bus the JAX
package has) and divergence audit (``audit``)."""

from .audit import BlockDigests, replica_divergence, tree_fingerprint
from .coordinator import (DEAD, AgreementError, Coordinator,
                          CoordinatorTimeout, InProcessBus, Straggle)

__all__ = ["Coordinator", "CoordinatorTimeout", "AgreementError",
           "InProcessBus", "Straggle", "DEAD",
           "tree_fingerprint", "replica_divergence", "BlockDigests"]
