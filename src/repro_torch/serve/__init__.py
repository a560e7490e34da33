"""Serving of the port: the static-batch engine, the continuous-batching
scheduler over ring or paged KV, and its replay and fault harnesses."""

from .block_pool import BlockPool, PoolExhausted
from .engine import Engine, ServeConfig, attn_only, full_ring, prepare_params
from .faults import (FaultPlan, chaos_plan, check_drained, check_invariants)
from .prefix_cache import PrefixCache
from .scheduler import Scheduler, SchedulerConfig
from .slots import (COMPLETED, DECODING, FAILED, PREEMPTED, PREFILLING,
                    QUEUED, REJECTED, TERMINAL, TIMED_OUT, RejectedError,
                    Request, SlotPool)

__all__ = ["BlockPool", "PoolExhausted", "Engine", "ServeConfig",
           "attn_only", "full_ring", "prepare_params", "FaultPlan",
           "chaos_plan", "check_drained", "check_invariants", "PrefixCache",
           "Scheduler", "SchedulerConfig", "COMPLETED", "DECODING", "FAILED",
           "PREEMPTED", "PREFILLING", "QUEUED", "REJECTED", "TERMINAL",
           "TIMED_OUT", "RejectedError", "Request", "SlotPool"]
