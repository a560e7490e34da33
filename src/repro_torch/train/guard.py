"""Training-side numeric guards (port of ``repro.train.guard``, pure
Python, copied): the typed abort errors and the loss-spike monitor
behind ``run_loop``'s self-healing.

The on-device half lives in ``make_train_step`` and the optimizer cores:
``isfinite(loss) & all(isfinite(ce_ex)) & isfinite(gnorm)`` gates the
whole state update (``torch.where`` for the unfused chain, the ``ok``
operand of the ``opt_step`` kernel for the fused core), so a poisoned
step applies no update, and the flag rides the step's one host read.
The host half is here: :class:`SpikeMonitor` watches the loss (and
optionally the eval CE) for sustained z-score spikes against an EMA
baseline, and the typed errors carry diagnostics when a run exhausts
its skip or rollback budget.

The monitor's EMA statistics freeze while a spike is suspected
(``hot``): folding spike samples into the baseline would teach it that
spikes are normal.
"""

from __future__ import annotations

import math
from typing import Optional


class NonFiniteBudgetError(RuntimeError):
    """Too many CONSECUTIVE non-finite (skipped) steps: the run is not
    recovering by itself — abort with diagnostics instead of spinning."""

    def __init__(self, msg: str, diagnostics: Optional[dict] = None):
        super().__init__(msg)
        self.diagnostics = dict(diagnostics or {})


class RollbackBudgetError(RuntimeError):
    """Spike rollbacks exhausted (or no valid checkpoint to roll back
    to): the divergence is persistent, not transient."""

    def __init__(self, msg: str, diagnostics: Optional[dict] = None):
        super().__init__(msg)
        self.diagnostics = dict(diagnostics or {})


class InjectedCrash(BaseException):
    """A chaos-harness crash (``train/faults.py``): derives from
    BaseException so it behaves like a hard kill — ``except Exception``
    recovery paths must NOT be able to swallow it."""


class SpikeMonitor:
    """EMA/z-score loss-spike detector for ``run_loop``.

    Tracks an exponential moving estimate of the loss mean and second
    moment.  A sample more than ``zscore`` standard deviations above the
    mean marks the monitor *hot*; ``patience`` consecutive hot samples
    signal a sustained spike (``observe`` returns True — the caller rolls
    back and calls :meth:`reset`).  The first ``warmup`` finite samples
    only build the baseline (no detection), and non-finite samples are
    ignored entirely — those are the non-finite guard's job, not the
    spike detector's.
    """

    def __init__(self, zscore: float = 6.0, ema: float = 0.98,
                 patience: int = 2, warmup: int = 8):
        assert 0.0 < ema < 1.0, ema
        self.zscore = float(zscore)
        self.ema = float(ema)
        self.patience = int(patience)
        self.warmup = int(warmup)
        self.reset()

    def reset(self) -> None:
        self._mean = 0.0
        self._sq = 0.0
        self._n = 0
        self._hot = 0

    @property
    def hot(self) -> bool:
        """True while a spike is suspected (stats frozen, checkpointing
        of possibly-poisoned state should pause)."""
        return self._hot > 0

    def _fold(self, x: float) -> None:
        if self._n == 0:
            self._mean, self._sq = x, x * x
        else:
            a = self.ema
            self._mean = a * self._mean + (1 - a) * x
            self._sq = a * self._sq + (1 - a) * x * x
        self._n += 1

    def zvalue(self, loss: float) -> float:
        var = max(self._sq - self._mean * self._mean, 0.0)
        # absolute + relative floor: a flat loss curve must not turn the
        # detector into a hair trigger
        sd = math.sqrt(var) + 1e-8 + 1e-3 * abs(self._mean)
        return (loss - self._mean) / sd

    def observe(self, loss: float) -> bool:
        """Feed one loss sample; True == sustained spike, roll back now."""
        if not math.isfinite(loss):
            return False
        if self._n < self.warmup:
            self._fold(loss)
            return False
        if self.zvalue(loss) > self.zscore:
            self._hot += 1           # stats frozen while hot
            return self._hot >= self.patience
        self._hot = 0
        self._fold(loss)
        return False
