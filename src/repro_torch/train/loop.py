"""Training loop (port of ``repro.train.loop``): step construction
(LOTION penalty placement, microbatching, clipping, EF compression),
quantized evaluation, and the self-healing training loop.

The step is built on the update-transform chain::

    grads -> clip -> [ef_compress] -> [lotion_decoupled] -> optimizer core

``make_optimizer`` assembles it and, for AdamW and SGD cores without EF
compression, collapses it into the fused single-pass core (one
``opt_step`` launch per leaf; under qat, rat and loss-side LOTION at
lam = 0).  EF compression keeps the unfused chain (one ``quant`` launch
per gradient leaf).  ``make_train_step`` computes the gradients of the
loss at ``forward_params`` (the QAT/RAT straight-through casts) and runs
the chain; it never syncs with the host (the skip flag, the losses and
the norms come back as device tensors in the metrics), except that RAT
reads the step counter to seed its draw.  ``run_loop`` adds the loop's
own checkpoints, crash-exact auto-resume and spike rollback.
``TrainConfig.attn_chunk`` streams the attention over key chunks and
``logit_chunk`` runs the head and CE chunk by chunk (``models/lm.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.modes import (PENALTY_PLACEMENTS, QuantConfig, cast_params,
                          forward_params, penalty)
from ..core.policy import tree_leaves, tree_map
from ..distributed import collectives
from ..distributed.context import clear_constraints, set_constraints
from ..distributed.sharding import (LEAF_ROLES, dp_size, gather_at_use,
                                    mesh_of, unit_shardings)
from ..launch.mesh import dp_axes
from ..models.lm import LMConfig, lm_forward
from ..numerics import div_scalar
from ..optim import (UpdateTransform, apply_updates, as_transform, chain,
                     clip_global_norm, fused_lotion_adamw_core,
                     fused_lotion_sgd_core, global_norm, lotion_decoupled)
from .compress import ef_transform
from .guard import NonFiniteBudgetError, RollbackBudgetError, SpikeMonitor

__all__ = ["TrainConfig", "make_optimizer", "make_train_step",
           "make_loss_fn", "make_eval_fn", "cross_entropy", "run_loop",
           "NonFiniteBudgetError", "RollbackBudgetError"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    clip_norm: float = 1.0
    n_microbatches: int = 1
    ef_compress: bool = False    # error-feedback int8 gradient compression
    ef_block: int = 256
    seed: int = 0            # RAT's per-step draws come from (seed, step)
    attn_chunk: int = 0      # 0 = full-score attention, else streaming
    logit_chunk: int = 0     # 0 = full logits, else the chunked head
    # None = follow quant.penalty_placement; "loss"/"decoupled" overrides
    penalty_placement: Optional[str] = None

    def __post_init__(self):
        if (self.penalty_placement is not None
                and self.penalty_placement not in PENALTY_PLACEMENTS):
            raise ValueError(
                f"penalty_placement {self.penalty_placement!r} not in "
                f"{PENALTY_PLACEMENTS} (or None to follow quant config)")

    @property
    def placement(self) -> str:
        return self.penalty_placement or self.quant.penalty_placement


def make_optimizer(tcfg: TrainConfig, base) -> UpdateTransform:
    """Assemble the per-step update chain from a base optimizer, with the
    JAX package's rules: a pre-assembled chain or a pre-built fused core
    passes through if it agrees with ``tcfg``; without EF compression an
    AdamW core (or an SGD core that can weight LOTION) makes the whole
    ``clip -> [lotion] -> core`` chain the fused core (lam = 0 under
    loss-side placement); EF compression and any other core get the
    unfused ``clip -> [ef] -> [lotion] -> core`` chain."""
    base_t = as_transform(base)
    q = tcfg.quant
    wants_lotion = (q.method == "lotion" and q.lam != 0.0
                    and tcfg.placement == "decoupled")
    if base_t.links is not None:
        has_lotion = any(t.tag == "lotion_decoupled" for t in base_t.links)
        if wants_lotion and not has_lotion:
            raise ValueError(
                "pre-assembled chain has no lotion_decoupled link but the "
                "train config wants the decoupled LOTION penalty — build "
                "the chain with make_optimizer, or add the link")
        if has_lotion and not wants_lotion:
            raise ValueError(
                "pre-assembled chain contains a lotion_decoupled link but "
                "the train config does not use the decoupled placement — "
                "the penalty would be double-counted or misconfigured")
        return base_t
    if base_t.applies_updates:
        meta = base_t.meta or {}
        has_lotion = meta.get("lam", 0.0) != 0.0
        if wants_lotion and not has_lotion:
            raise ValueError(
                "pre-built fused core has lam=0 but the train config wants "
                "the decoupled LOTION penalty — build it with make_optimizer")
        if has_lotion and not wants_lotion:
            raise ValueError(
                "pre-built fused core carries a LOTION term the train "
                "config does not use — the penalty would be misconfigured")
        checks = [("clip_norm", tcfg.clip_norm)]
        if has_lotion:
            checks += [("lam", q.lam), ("fmt_name", q.fmt_name),
                       ("block_size", q.block_size), ("policy", q.policy)]
        for key, want in checks:
            if key in meta and meta[key] != want:
                raise ValueError(
                    f"pre-built fused core was built with {key}="
                    f"{meta[key]!r} but the train config says {want!r} — "
                    f"rebuild it with make_optimizer")
        if tcfg.ef_compress:
            raise ValueError(
                "EF compression cannot be fused — drop the pre-built "
                "fused core and let make_optimizer assemble the chain")
        return base_t
    meta = base_t.meta or {}
    can_fuse = (not tcfg.ef_compress
                and (meta.get("kind") == "adamw"
                     or (meta.get("kind") == "sgd"
                         and (not wants_lotion
                              or meta.get("fisher_decay") is not None))))
    if can_fuse and meta["kind"] == "adamw":
        return fused_lotion_adamw_core(
            meta["lr_fn"], b1=meta["b1"], b2=meta["b2"], eps=meta["eps"],
            weight_decay=meta["weight_decay"], fmt_name=q.fmt_name,
            lam=(q.lam if wants_lotion else 0.0), block_size=q.block_size,
            clip_norm=tcfg.clip_norm, policy=q.policy)
    if can_fuse:
        return fused_lotion_sgd_core(
            meta["lr_fn"], momentum=meta["momentum"],
            fisher_decay=meta["fisher_decay"], fmt_name=q.fmt_name,
            lam=(q.lam if wants_lotion else 0.0), block_size=q.block_size,
            clip_norm=tcfg.clip_norm, policy=q.policy)

    links = [clip_global_norm(tcfg.clip_norm)]
    if tcfg.ef_compress:
        links.append(ef_transform(tcfg.ef_block))
    if wants_lotion:
        links.append(lotion_decoupled(q.fmt_name, q.lam, q.block_size,
                                      policy=q.policy))
    links.append(base_t)
    return chain(*links)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE terms ``logz - gold`` with the logits' leading
    shape; ``cross_entropy`` is their mean and the per-example CE their
    mean over the non-batch axes."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE in nats.  logits: (b, l, v) fp32; labels: (b, l)."""
    return torch.mean(_ce_terms(logits, labels))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """RAT's generator of step ``step``, seeded from ``(seed, step)`` (JAX
    folds the step into ``PRNGKey(seed)``; the numbers differ).  Every
    microbatch of a step gets a generator in the same state, so all of
    them see the same cast, as in JAX."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


def make_loss_fn(cfg: LMConfig, tcfg: TrainConfig, shardings=None):
    """``loss_fn(params, batch, fisher, uniforms=None, generator=None) ->
    (loss, aux)``: the CE of the model at ``forward_params`` (RAT's
    uniforms keyed by path, or drawn from ``generator``); under loss-side
    placement the LOTION penalty of the master ``params`` is part of
    ``loss``.

    With ``shardings`` (the parameters' NamedShardings: ``params`` are
    this rank's blocks, ``batch`` its rows) the CE is over the rank's
    rows, and ``loss`` is the rank's share of the global objective: the
    CE over the data-parallel size (so that the gradients summed over the
    data ranks are the global mean's) plus the global penalty;
    ``aux["ce"]`` stays the rank's own mean."""
    from ..models.lm import lm_loss

    loss_side = tcfg.placement == "loss"
    n_dp = dp_size(mesh_of(shardings)) if shardings is not None else 1

    def loss_fn(params, batch, fisher, uniforms=None, generator=None):
        if cfg.ffn == "moe" and n_dp > 1:
            _check_moe_groups(cfg, batch["tokens"].shape, n_dp)
        fwd = forward_params(tcfg.quant, params, uniforms, generator,
                             shardings)
        ce, ce_ex = lm_loss(fwd, cfg, batch["tokens"], batch["labels"],
                            attn_chunk=tcfg.attn_chunk or None,
                            logit_chunk=tcfg.logit_chunk or None,
                            per_example=True,
                            image_embeds=batch.get("image_embeds"))
        del fwd
        aux = {"ce": ce, "ce_ex": ce_ex}
        obj = ce if shardings is None else div_scalar(ce, n_dp)
        if loss_side:
            pen = penalty(tcfg.quant, params, fisher, shardings)
            aux["penalty"] = pen
            return obj + pen, aux
        return obj, aux
    return loss_fn


def _check_moe_groups(cfg: LMConfig, shape, n_dp: int) -> None:
    """MoE's capacity dispatch runs over groups of tokens; a rank that
    computes on its rows must see whole groups of the global batch's, or
    the capacities (and the dropped tokens) differ."""
    from ..models.layers import moe_groups
    b, l = shape[0], shape[1]
    mine = moe_groups(cfg.moe_spec(), b, l)
    if mine != moe_groups(cfg.moe_spec(), b * n_dp, l):
        raise ValueError(
            f"{cfg.name}: a rank's {b} x {l} tokens are not whole MoE "
            f"dispatch groups of the global {b * n_dp} x {l} batch (groups "
            f"of {mine} here); give each data rank a multiple of "
            f"{cfg.moe_spec().group_size} tokens")


def model_constraints(shardings) -> Dict[str, Any]:
    """The placement roles a sharded step installs for the model
    (``distributed/context.py``): each leaf gathered where the model reads
    it (``sharding.gather_at_use``), one unit's stage leaves at a time."""
    def fns(tree):
        return tree_map(lambda s: (lambda x: gather_at_use(x, s)), tree)

    roles = {"stage_params": fns(unit_shardings(shardings["stage"]))}
    for key in LEAF_ROLES:
        if key in shardings:
            roles[key] = fns(shardings[key])
    return roles


def _link_metrics(opt_state, out=None) -> Dict[str, torch.Tensor]:
    """Per-link metric scalars ("gnorm", "penalty") of a (nested) chain
    state."""
    out = {} if out is None else out
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            _link_metrics(s, out)
    elif isinstance(opt_state, dict):
        for key in ("gnorm", "penalty"):
            if key in opt_state:
                out[key] = opt_state[key]
    return out


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda x: next(it), tree)


def _split(batch: dict, n: int, k: int) -> dict:
    """Microbatch ``k`` of ``n``: rows k*b/n .. (k+1)*b/n of every field,
    as JAX's reshape to (n, b/n, ...) gives."""
    out = {}
    for key, x in batch.items():
        m = x.shape[0] // n
        out[key] = x[k * m:(k + 1) * m]
    return out


def make_train_step(cfg: LMConfig, tcfg: TrainConfig, optimizer,
                    loss_fn: Optional[Callable] = None,
                    rat_uniforms: Optional[Callable] = None,
                    grad_shardings=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``optimizer`` is anything ``make_optimizer`` accepts; the SAME chain
    must have produced ``state["opt"]``.  Under RAT every microbatch of a
    step casts against the same uniforms: ``rat_uniforms(step)`` (a
    ``{path_str: tensor}`` dict, for tests that feed JAX's draws) or the
    draws of ``step_generator(tcfg.seed, step, device)``, one eligible
    leaf at a time.  With the fused core the new
    parameters and moments are written in place (the returned state holds
    the same tensors); with the unfused chain they are new tensors.  A
    step whose loss, per-example CE or gradient norm is not finite applies
    no update, decided on the device (``metrics["skipped"]``).

    ``grad_shardings`` (the parameters' NamedShardings,
    ``distributed.sharding.params_shardings``) makes it the sharded step
    of a mesh: the state holds each leaf's block and ``batch`` the rank's
    rows (``DataPipeline(sharding=...)``); the model gathers each leaf
    where it reads it and each gradient comes back to its block, summed
    over the data ranks; the norm, the penalty and the per-matrix absmax
    of every ``opt_step``, ``lotion_reg`` and ``quant`` call are global;
    the skip flag is decided over every rank's rows (a NaN on one rank
    skips the step on all); loss and aux metrics are means over the data
    ranks.  EF compression casts each gradient block (or, where the cut
    splits its quant blocks, the gathered leaf: ``train/compress.py``),
    bitwise the one-device cast of the same gradient.  ``loss_fn`` then
    follows ``make_loss_fn(..., shardings=)``'s convention.  On a mesh of
    one rank the step is bitwise the one-device step."""
    tx = make_optimizer(tcfg, optimizer)
    mesh = mesh_of(grad_shardings)
    n_dp = dp_size(mesh) if mesh is not None else 1
    roles = model_constraints(grad_shardings) if mesh is not None else None
    loss_fn = loss_fn or make_loss_fn(cfg, tcfg, grad_shardings)

    rat = tcfg.quant.method == "rat"

    def grads_of(params, batch, fisher, step):
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        kw = {}
        if rat and rat_uniforms is not None:
            kw["uniforms"] = rat_uniforms(step)
        elif rat:
            kw["generator"] = step_generator(
                tcfg.seed, step, tree_leaves(params)[0].device)
        if roles is not None:
            set_constraints(**roles)
        try:
            loss, aux = loss_fn(p, batch, fisher, **kw)
            leaves = tree_leaves(p)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            if roles is not None:
                clear_constraints()
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        aux = {k: v.detach() for k, v in aux.items()}
        return loss.detach(), aux, _unflatten_like(params, grads)

    def train_step(state, batch):
        params = state["params"]
        # pre-update Fisher (AdamW's nu), read through the chain
        fisher = tx.fisher(state["opt"])
        if fisher is None:
            fisher = tree_map(torch.zeros_like, params)

        step = int(state["step"]) if rat else None
        n = tcfg.n_microbatches
        if n > 1:
            acc_l, acc_g, auxs = 0.0, tree_map(torch.zeros_like, params), []
            for k in range(n):
                l_k, aux_k, g_k = grads_of(params, _split(batch, n, k),
                                           fisher, step)
                acc_l = acc_l + l_k
                acc_g = tree_map(torch.add, acc_g, g_k)
                auxs.append(aux_k)
            loss = div_scalar(acc_l, n)
            grads = tree_map(lambda g: div_scalar(g, n), acc_g)
            ce_ex = torch.stack([a.pop("ce_ex") for a in auxs])
            aux = {k: torch.mean(torch.stack([a[k] for a in auxs]))
                   for k in auxs[0]}
        else:
            loss, aux, grads = grads_of(params, batch, fisher, step)
            ce_ex = aux.pop("ce_ex", None)
        if mesh is not None:
            loss, aux = _global_metrics(aux, mesh, n_dp)

        # on-device skip gate: isfinite(loss) and all per-example CE (on
        # a mesh: every rank's rows)
        ok_loss = torch.isfinite(loss)
        if ce_ex is not None:
            ok_loss = torch.logical_and(ok_loss,
                                        torch.all(torch.isfinite(ce_ex)))
        if mesh is not None:
            ok_loss = collectives.all_reduce(
                ok_loss.to(torch.int32), "min", mesh,
                mesh.axis_names).to(torch.bool)
        extra = {} if mesh is None else {"shardings": grad_shardings}
        updates, new_opt = tx.update(grads, state["opt"], params,
                                     fisher=fisher, step_ok=ok_loss,
                                     lr_scale=state.get("lr_scale"), **extra)
        link = _link_metrics(new_opt)
        gnorm = link.get("gnorm")
        if gnorm is None:
            gnorm = global_norm(grads, grad_shardings)
        del grads
        ok = torch.logical_and(ok_loss, torch.isfinite(gnorm))

        if tx.applies_updates:
            # the fused core gated its update inside the kernel
            new_params, gated_opt = updates, new_opt
        else:
            def sel(new, old):
                return torch.where(ok, new, old)

            new_params = tree_map(sel, apply_updates(params, updates), params)
            gated_opt = tree_map(sel, new_opt, state["opt"])

        new_state = dict(state)
        new_state.update(params=new_params, opt=gated_opt,
                         step=state["step"] + 1)
        metrics = {"loss": loss, **aux, "grad_norm": gnorm,
                   "skipped": torch.logical_not(ok)}
        if "penalty" in link:       # decoupled placement
            metrics["penalty"] = link["penalty"]
            metrics["loss"] = loss + link["penalty"]
        return new_state, metrics

    train_step.optimizer = tx
    # (loss, aux, grads) of a step's batch, as the step computes them
    train_step.grads_of = grads_of
    return train_step


def _global_metrics(aux: dict, mesh, n_dp: int):
    """(loss, aux) of a sharded step over every data rank: each metric's
    mean over the data ranks (the sum of its shares), the penalty (global
    already) added to the CE for the loss."""
    out = {}
    for k, v in aux.items():
        out[k] = v if k == "penalty" else collectives.all_reduce(
            div_scalar(v, n_dp), "sum", mesh, dp_axes(mesh))
    loss = out["ce"] + out["penalty"] if "penalty" in out else out["ce"]
    return loss, out


# --------------------------------------------------------------------------
# Quantized evaluation (the paper's headline metric)
# --------------------------------------------------------------------------

def make_eval_fn(cfg: LMConfig, qcfg: QuantConfig):
    """``eval_fn(params, batch, mode="fp32", uniforms=None,
    generator=None) -> CE`` (a 0-d device tensor): fp32 weights, or the
    eligible leaves cast RTN or RR through the ``quant`` kernel (RR from
    explicit uniforms keyed by path, or drawn from ``generator``)."""

    @torch.no_grad()
    def eval_fn(params, batch, mode: str = "fp32", uniforms=None,
                generator=None):
        if mode == "fp32":
            p = params
        else:
            p = cast_params(params, qcfg.fmt, qcfg.policy, qcfg.block_size,
                            mode=mode, uniforms=uniforms, generator=generator)
        logits = lm_forward(p, cfg, batch["tokens"],
                            image_embeds=batch.get("image_embeds"))
        del p
        return cross_entropy(logits, batch["labels"])

    return eval_fn


# --------------------------------------------------------------------------
# The training loop: telemetry, checkpoints and the recovery tiers
# --------------------------------------------------------------------------

TELEMETRY_WINDOW = 200


def newest_valid_step(ckpt_dir: str, mesh=None,
                      quarantine_corrupt: bool = False) -> Optional[int]:
    """``checkpoint.io.latest_valid``; on a mesh decided on rank 0 (which
    alone quarantines) and broadcast, so every rank restores the same
    step."""
    from ..checkpoint import io as ckpt_io
    if mesh is None:
        return ckpt_io.latest_valid(ckpt_dir,
                                    quarantine_corrupt=quarantine_corrupt)
    return collectives.broadcast_object(
        ckpt_io.latest_valid(ckpt_dir, quarantine_corrupt=quarantine_corrupt)
        if mesh.rank == 0 else None)


def _eval_scalar(ev):
    """Scalar CE out of an ``eval_hook`` result for the eval-side
    :class:`SpikeMonitor`: a number (or 0-d tensor) passes through; a
    dict prefers the conventional CE keys, then the first value that
    converts to float.  ``None`` when nothing numeric is found."""
    if isinstance(ev, dict):
        keys = [k for k in ("ce", "eval_ce", "ce_fp32", "loss") if k in ev]
        candidates = [ev[k] for k in keys] or list(ev.values())
    else:
        candidates = [ev]
    for v in candidates:
        try:
            return float(v)
        except (TypeError, ValueError, RuntimeError):
            continue
    return None


def _read_step(metrics):
    """The step's one host read: the loss and the skip flag together."""
    loss, flag = metrics["loss"], metrics.get("skipped")
    if torch.is_tensor(loss) and torch.is_tensor(flag):
        loss_v, flag_v = torch.stack(
            [loss.detach().to(torch.float32),
             flag.to(torch.float32)]).tolist()
        return loss_v, bool(flag_v)
    return float(loss), bool(flag) if flag is not None else False


def run_loop(train_step, state, pipeline, n_steps: int,
             eval_every: int = 0, eval_hook: Optional[Callable] = None,
             ckpt_every: int = 0, ckpt_hook: Optional[Callable] = None,
             log_every: int = 50, log: Callable = print,
             straggler_pct: float = 95.0,
             ckpt_dir: Optional[str] = None, ckpt_keep: int = 3,
             ckpt_shards: int = 1,
             auto_resume: bool = False,
             max_skips: int = 8,
             spike_zscore: float = 0.0, spike_ema: float = 0.98,
             spike_patience: int = 2, spike_warmup: int = 8,
             eval_spike_zscore: float = 0.0, eval_spike_ema: float = 0.9,
             eval_spike_patience: int = 1, eval_spike_warmup: int = 4,
             backoff_scale: float = 0.5, cooldown_steps: int = 16,
             max_rollbacks: int = 4,
             rollback_reorder: bool = True,
             coordinator=None,
             step_hook: Optional[Callable] = None,
             shardings=None) -> Dict[str, Any]:
    """Self-healing loop of ``train_step`` over ``pipeline`` (the JAX
    package's ``run_loop``): telemetry, periodic eval and checkpoints,
    and three recovery tiers.

    * **Skip budget**: a poisoned step applied no update (decided on the
      device); more than ``max_skips`` consecutive skipped steps raise
      :class:`NonFiniteBudgetError` with diagnostics.
    * **Spike rollback**: with ``spike_zscore > 0`` (needs ``ckpt_dir``)
      a :class:`SpikeMonitor` watches the loss, and with
      ``eval_spike_zscore > 0`` a second one the eval CE; on a sustained
      spike the loop restores the newest valid checkpoint, seeks the
      pipeline (past the window that fed the spike with
      ``rollback_reorder``, else back to it) and scales the learning
      rate by ``backoff_scale`` for ``cooldown_steps`` steps through
      ``state["lr_scale"]``.  More than ``max_rollbacks`` raise
      :class:`RollbackBudgetError`.
    * **Auto-resume**: ``auto_resume=True`` (needs ``ckpt_dir``) restores
      the newest checkpoint whose crc32s verify, quarantining corrupt
      ones, and seeks the pipeline; batches are functions of the step,
      so the continued run is bitwise the run that never crashed.

    Every host-level decision (restore target, rollback target and seek)
    goes through ``coordinator`` (a single-host :class:`Coordinator` by
    default).  ``ckpt_dir`` turns on the loop's own checkpoints every
    ``ckpt_every`` steps (``ckpt_shards`` payload shards each; an anchor
    save when none is valid yet; none while a monitor is hot);
    ``ckpt_hook(state)`` is called at the same boundaries.  Restores
    copy into the state's tensors in place, so a rollback at full width
    holds one state on the card.  ``step_hook(state, metrics)`` runs
    after every step (the chaos harness's crash seam).  The loss and the
    skip flag come to the host in one read per step.

    On a mesh (``shardings``: the state's NamedShardings, the state this
    rank's blocks) checkpoints are saved from and loaded into the blocks
    (``checkpoint.io``), and the newest valid step is decided on rank 0
    (which alone quarantines) and broadcast; every other decision follows
    from the step's global metrics, the same on every rank.

    Returns ``{"state", "history", "step_times", "skipped", "rollbacks",
    "eval_rollbacks", "data_windows_skipped", "resumed_from"}``."""
    from ..checkpoint import io as ckpt_io
    from ..distributed.coordinator import Coordinator

    coord = coordinator if coordinator is not None else Coordinator()
    mesh = mesh_of(shardings)

    def newest_valid(quarantine_corrupt: bool):
        return newest_valid_step(ckpt_dir, mesh, quarantine_corrupt)
    spiking = spike_zscore > 0.0
    eval_spiking = eval_spike_zscore > 0.0
    any_spiking = spiking or eval_spiking
    if any_spiking and not ckpt_dir:
        raise ValueError("spike rollback (spike/eval_spike_zscore > 0) "
                         "needs ckpt_dir")
    if eval_spiking and not (eval_every and eval_hook):
        raise ValueError("eval spike monitor (eval_spike_zscore > 0) "
                         "needs eval_every and eval_hook")
    if auto_resume and not ckpt_dir:
        raise ValueError("auto_resume needs ckpt_dir")
    monitor = (SpikeMonitor(zscore=spike_zscore, ema=spike_ema,
                            patience=spike_patience, warmup=spike_warmup)
               if spiking else None)
    eval_monitor = (SpikeMonitor(zscore=eval_spike_zscore,
                                 ema=eval_spike_ema,
                                 patience=eval_spike_patience,
                                 warmup=eval_spike_warmup)
                    if eval_spiking else None)
    dev = tree_leaves(state["params"])[0].device

    def lr_scale_tensor(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=torch.float32, device=dev)

    # the lr_scale leaf joins the state (and so the checkpoint) exactly
    # when the JAX loop inserts it, so the two packages' layouts match
    if any_spiking and "lr_scale" not in state:
        state = dict(state)
        state["lr_scale"] = lr_scale_tensor(1.0)
    counters: Dict[str, Any] = {"skipped": 0, "rollbacks": 0,
                                "eval_rollbacks": 0,
                                "data_windows_skipped": 0,
                                "resumed_from": None}

    local_best = None
    if auto_resume:
        local_best = newest_valid(True)
        # newest-common-valid election across hosts
        best = coord.elect_checkpoint(local_best)
        if best is not None:
            state, s = ckpt_io.load(ckpt_dir, into=state, step=best,
                                    shardings=shardings)
            if any_spiking:
                # a fresh segment starts calm: a crash mid-cooldown must
                # not pin the reduced LR
                state = dict(state)
                state["lr_scale"] = lr_scale_tensor(1.0)
            counters["resumed_from"] = s
            pipeline.seek(s)
            log(f"run_loop: auto-resumed from {ckpt_dir} at step {s}")
    # anchor save: rollback and resume always have a target (after an
    # auto-resume scan the directory is unchanged: its answer stands)
    if (ckpt_dir and (ckpt_every or any_spiking)
            and (local_best if auto_resume
                 else newest_valid(False)) is None):
        ckpt_io.save(ckpt_dir, int(state["step"]), state, keep=ckpt_keep,
                     n_shards=ckpt_shards, shardings=shardings)

    history = []
    times = collections.deque(maxlen=TELEMETRY_WINDOW)
    fused = bool(getattr(getattr(train_step, "optimizer", None),
                         "applies_updates", False))
    log(f"run_loop: opt_fused={fused} device={dev}")
    cur = int(state["step"])
    consec_skips = 0
    lr_scale_now = 1.0
    cooldown = 0
    # cumulative data-reorder offset: each reordered rollback adds the
    # width of the window it skipped
    data_lead = 0

    def do_rollback(origin: str, trigger: float, counter: str) -> None:
        """One coordinated rollback: elect the newest checkpoint every
        host can restore, agree on (restore, seek, origin), then restore
        in place, seek and back the LR off."""
        nonlocal state, cur, lr_scale_now, cooldown, data_lead
        counters[counter] += 1
        total = counters["rollbacks"] + counters["eval_rollbacks"]
        if total > max_rollbacks:
            raise RollbackBudgetError(
                f"spike rollback budget ({max_rollbacks}) exhausted at "
                f"step {cur} ({origin} trigger={trigger:.4f})",
                {"step": cur, "loss": trigger, **counters})
        best = coord.elect_checkpoint(newest_valid(True))
        if best is None:
            raise RollbackBudgetError(
                f"{origin} spike at step {cur} but no commonly-valid "
                f"checkpoint in {ckpt_dir} to roll back to",
                {"step": cur, "loss": trigger, **counters})
        if rollback_reorder and cur > best:
            # replay with different data: skip the window [best, cur)
            data_lead += cur - best
            counters["data_windows_skipped"] += 1
        seek_to = best + data_lead
        # unanimity before mutating anything
        coord.agree("rollback", (best, seek_to, origin))
        state, s = ckpt_io.load(ckpt_dir, into=state, step=best,
                                shardings=shardings)
        pipeline.seek(seek_to)
        cur = s
        lr_scale_now *= backoff_scale
        cooldown = cooldown_steps
        state = dict(state)
        state["lr_scale"] = lr_scale_tensor(lr_scale_now)
        if monitor is not None:
            monitor.reset()
        if eval_monitor is not None:
            eval_monitor.reset()
        log(f"run_loop: {origin} spike ({trigger:.4f}) — rolled back to "
            f"step {s} (seek {seek_to}, lead {data_lead}), "
            f"lr_scale={lr_scale_now:g} for {cooldown_steps} steps")

    while cur < n_steps:
        batch = next(pipeline)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        loss_v, skipped = _read_step(metrics)
        times.append(time.perf_counter() - t0)
        cur += 1

        if skipped:
            counters["skipped"] += 1
            consec_skips += 1
            if consec_skips > max_skips:
                diag = {"step": cur, "loss": loss_v,
                        "grad_norm": float(metrics["grad_norm"]),
                        **counters}
                raise NonFiniteBudgetError(
                    f"{consec_skips} consecutive non-finite steps "
                    f"(budget {max_skips}) at step {cur}: loss={loss_v}, "
                    f"gnorm={diag['grad_norm']} — data or optimizer state "
                    f"is persistently poisoned", diag)
        else:
            consec_skips = 0
            if monitor is not None and monitor.observe(loss_v):
                do_rollback("loss", loss_v, "rollbacks")
                continue

        if cooldown > 0:
            cooldown -= 1
            if cooldown == 0 and lr_scale_now != 1.0:
                lr_scale_now = 1.0
                state = dict(state)
                state["lr_scale"] = lr_scale_tensor(1.0)
                log(f"run_loop: cooldown over at step {cur}, lr restored")

        if step_hook is not None:
            step_hook(state, metrics)

        step = cur
        if log_every and step % log_every == 0:
            window = np.asarray(times)
            p50, p95 = (np.percentile(window, 50),
                        np.percentile(window, straggler_pct))
            log(f"step {step:6d} loss {loss_v:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"dt_p50 {p50 * 1e3:.1f}ms p95 {p95 * 1e3:.1f}ms "
                f"skipped {counters['skipped']} "
                f"rollbacks {counters['rollbacks']} "
                f"resumed_from {counters['resumed_from']}")
        if eval_every and eval_hook and step % eval_every == 0:
            ev = eval_hook(state)
            history.append((step, ev))
            if eval_monitor is not None:
                ev_scalar = _eval_scalar(ev)
                if ev_scalar is not None and eval_monitor.observe(ev_scalar):
                    do_rollback("eval", ev_scalar, "eval_rollbacks")
                    continue
        if ckpt_every and step % ckpt_every == 0:
            # never checkpoint while a spike is suspected
            hot = ((monitor is not None and monitor.hot)
                   or (eval_monitor is not None and eval_monitor.hot))
            if ckpt_dir and not hot:
                ckpt_io.save(ckpt_dir, step, state, keep=ckpt_keep,
                             n_shards=ckpt_shards, shardings=shardings)
            if ckpt_hook:
                ckpt_hook(state)
    return {"state": state, "history": history, "step_times": list(times),
            **counters}
