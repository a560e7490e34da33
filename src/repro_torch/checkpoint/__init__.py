"""Fault-tolerant checkpointing on the JAX package's layout, plus the
chain-tuple <-> fused-dict optimizer-state migration helper (port of
``repro.checkpoint``)."""

from .io import (CorruptCheckpointError, latest_step, latest_valid, load,
                 quarantine, save, verify_dir, write_fault_hook)
from .migrate import migrate_opt_state, opt_state_kind

__all__ = ["save", "load", "latest_step", "latest_valid", "verify_dir",
           "quarantine", "CorruptCheckpointError", "write_fault_hook",
           "migrate_opt_state", "opt_state_kind"]
