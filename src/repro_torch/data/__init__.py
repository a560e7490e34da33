"""Deterministic, seekable synthetic data of the port."""

from .pipeline import DataPipeline
from .synthetic import (lm_batch, markov_ce_floor, markov_tokens,
                        permutation_table)

__all__ = ["DataPipeline", "lm_batch", "markov_tokens", "permutation_table",
           "markov_ce_floor"]
