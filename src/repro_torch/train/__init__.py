"""Training of the port: step construction, quantized eval, the
self-healing training loop, its guards, EF compression and the training
chaos harness (``train.faults``)."""

from .guard import (InjectedCrash, NonFiniteBudgetError, RollbackBudgetError,
                    SpikeMonitor)
from .loop import (TrainConfig, cross_entropy, make_eval_fn, make_loss_fn,
                   make_optimizer, make_train_step, run_loop)
from .state import init_state

__all__ = ["TrainConfig", "make_train_step", "make_loss_fn", "make_eval_fn",
           "make_optimizer", "cross_entropy", "run_loop", "init_state",
           "NonFiniteBudgetError", "RollbackBudgetError", "SpikeMonitor",
           "InjectedCrash"]
