"""Deterministic synthetic data (port of ``repro.data.synthetic``).

Streams are stateless functions of (seed, step): any batch is recomputed
from its index.  Numbers come from a ``torch.Generator`` on the CPU seeded
from (seed, step), so a batch is the same whatever device it is moved to;
they are not JAX's numbers (tests feed JAX's batches through the bridge).

* ``markov_tokens``: a fixed random permutation P of the vocab generates
  ``tok_{t+1} = P[tok_t]`` with probability ``1 - noise``, a uniform token
  otherwise; the CE floor is ``markov_ce_floor``.
* ``linreg_batch``: the paper's §4.1 setup, x ~ N(0, diag(spectrum)),
  y = x @ w*.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..numerics import sqrt_rn

_MASK63 = (1 << 63) - 1


def _generator(seed: int, step: int = 0) -> torch.Generator:
    # one 63-bit seed per (seed, step) pair: step in the low 32 bits, seed
    # mixed into the rest by a multiplicative hash
    s = ((int(seed) * 0x9E3779B97F4A7C15) ^ (int(step) & 0xFFFFFFFF)) & _MASK63
    return torch.Generator(device="cpu").manual_seed(s)


def permutation_table(seed: int, vocab: int) -> torch.Tensor:
    return torch.randperm(vocab, generator=_generator(seed ^ 0x5EED))


def markov_tokens(seed: int, step: int, batch: int, seq_len: int, vocab: int,
                  perm: torch.Tensor, noise: float = 0.2) -> torch.Tensor:
    """(batch, seq_len + 1) int64 tokens for step ``step`` (on the CPU)."""
    gen = _generator(seed, step)
    first = torch.randint(0, vocab, (batch,), generator=gen)
    flip = torch.rand((batch, seq_len), generator=gen) < noise
    rand = torch.randint(0, vocab, (batch, seq_len), generator=gen)
    perm = perm.cpu()
    toks = torch.empty((batch, seq_len + 1), dtype=torch.int64)
    toks[:, 0] = tok = first
    for t in range(seq_len):
        tok = torch.where(flip[:, t], rand[:, t], perm[tok])
        toks[:, t + 1] = tok
    return toks


def lm_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int,
             perm: torch.Tensor, noise: float = 0.2, n_codebooks: int = 1,
             device="cpu"):
    """{tokens, labels} for a train step, on ``device``.  Multi-codebook
    streams stack independent chains."""
    if n_codebooks == 1:
        toks = markov_tokens(seed, step, batch, seq_len, vocab, perm, noise)
    else:
        toks = torch.stack([markov_tokens(seed + 101 * c, step, batch,
                                          seq_len, vocab, perm, noise)
                            for c in range(n_codebooks)], dim=-1)
    toks = toks.to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def markov_ce_floor(vocab: int, noise: float) -> float:
    """Entropy floor of the Markov stream (nats/token)."""
    p_correct = (1 - noise) + noise / vocab
    p_other = noise / vocab
    return float(-(p_correct * np.log(p_correct)
                   + (vocab - 1) * p_other * np.log(p_other)))


def linreg_batch(seed: int, step: int, batch: int, w_star: torch.Tensor,
                 spectrum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ~ N(0, diag(spectrum)) of shape (batch, d), y = x @ w* (paper
    §4.1), on ``w_star``'s device (drawn on the CPU)."""
    z = torch.randn((batch, w_star.shape[0]), generator=_generator(seed, step))
    x = z.to(w_star.device) * sqrt_rn(spectrum)
    return x, x @ w_star
