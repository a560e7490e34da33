"""Training loop (port of ``repro.train.loop``): step construction
(LOTION penalty placement, microbatching, clipping), quantized
evaluation, and a driver loop.

The step is built on the update-transform chain::

    grads -> clip -> [lotion_decoupled] -> optimizer core

``make_optimizer`` assembles it and, for AdamW and SGD cores, collapses
it into the fused single-pass core (one ``opt_step`` launch per leaf;
under qat, rat and loss-side LOTION at lam = 0).  ``make_train_step``
computes the gradients of the loss at ``forward_params`` (the QAT/RAT
straight-through casts) and runs the chain; it never syncs with the host
(the skip flag, the losses and the norms come back as device tensors in
the metrics), except that RAT reads the step counter to seed its draw.
EF gradient compression, the chunked head and streaming attention,
checkpoints and spike rollback are not in this slice of the port.
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
from ..models.lm import LMConfig, lm_forward
from ..numerics import div_scalar
from ..optim import (UpdateTransform, apply_updates, as_transform, chain,
                     clip_global_norm, fused_lotion_adamw_core,
                     fused_lotion_sgd_core, global_norm, lotion_decoupled)


class NonFiniteBudgetError(RuntimeError):
    """More consecutive non-finite (skipped) steps than ``max_skips``."""

    def __init__(self, msg: str, diagnostics: Optional[dict] = None):
        super().__init__(msg)
        self.diagnostics = diagnostics or {}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    clip_norm: float = 1.0
    n_microbatches: int = 1
    seed: int = 0            # RAT's per-step draws come from (seed, step)
    attn_chunk: int = 0      # 0 = full-score attention (streaming: not ported)
    logit_chunk: int = 0     # 0 = full logits (chunked head: not ported)
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
    passes through if it agrees with ``tcfg``; an AdamW core (or an SGD
    core that can weight LOTION) makes the whole ``clip -> [lotion] ->
    core`` chain the fused core (lam = 0 under loss-side placement); any
    other core gets the unfused chain."""
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
        return base_t
    meta = base_t.meta or {}
    can_fuse = (meta.get("kind") == "adamw"
                or (meta.get("kind") == "sgd"
                    and (not wants_lotion
                         or meta.get("fisher_decay") is not None)))
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


def make_loss_fn(cfg: LMConfig, tcfg: TrainConfig):
    """``loss_fn(params, batch, fisher, uniforms=None, generator=None) ->
    (loss, aux)``: the CE of the model at ``forward_params`` (RAT's
    uniforms keyed by path, or drawn from ``generator``); under loss-side
    placement the LOTION penalty of the master ``params`` is part of
    ``loss``."""
    from ..models.lm import lm_loss

    loss_side = tcfg.placement == "loss"

    def loss_fn(params, batch, fisher, uniforms=None, generator=None):
        fwd = forward_params(tcfg.quant, params, uniforms, generator)
        ce, ce_ex = lm_loss(fwd, cfg, batch["tokens"], batch["labels"],
                            attn_chunk=tcfg.attn_chunk or None,
                            logit_chunk=tcfg.logit_chunk or None,
                            per_example=True)
        del fwd
        aux = {"ce": ce, "ce_ex": ce_ex}
        if loss_side:
            pen = penalty(tcfg.quant, params, fisher)
            aux["penalty"] = pen
            return ce + pen, aux
        return ce, aux
    return loss_fn


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
                    rat_uniforms: Optional[Callable] = None):
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
    no update, decided on the device (``metrics["skipped"]``)."""
    tx = make_optimizer(tcfg, optimizer)
    loss_fn = loss_fn or make_loss_fn(cfg, tcfg)

    rat = tcfg.quant.method == "rat"

    def grads_of(params, batch, fisher, step):
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        kw = {}
        if rat and rat_uniforms is not None:
            kw["uniforms"] = rat_uniforms(step)
        elif rat:
            kw["generator"] = step_generator(
                tcfg.seed, step, tree_leaves(params)[0].device)
        loss, aux = loss_fn(p, batch, fisher, **kw)
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
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

        # on-device skip gate: isfinite(loss) and all per-example CE
        ok_loss = torch.isfinite(loss)
        if ce_ex is not None:
            ok_loss = torch.logical_and(ok_loss,
                                        torch.all(torch.isfinite(ce_ex)))
        updates, new_opt = tx.update(grads, state["opt"], params,
                                     fisher=fisher, step_ok=ok_loss,
                                     lr_scale=state.get("lr_scale"))
        link = _link_metrics(new_opt)
        gnorm = link.get("gnorm")
        if gnorm is None:
            gnorm = global_norm(grads)
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
    return train_step


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
        logits = lm_forward(p, cfg, batch["tokens"])
        del p
        return cross_entropy(logits, batch["labels"])

    return eval_fn


# --------------------------------------------------------------------------
# Driver loop
# --------------------------------------------------------------------------

TELEMETRY_WINDOW = 200


def run_loop(train_step, state, pipeline, n_steps: int,
             eval_every: int = 0, eval_hook: Optional[Callable] = None,
             log_every: int = 50, log: Callable = print,
             straggler_pct: float = 95.0, max_skips: int = 8
             ) -> Dict[str, Any]:
    """Drive ``train_step`` for ``n_steps`` from ``pipeline``: step-time
    telemetry, periodic eval, and the skip budget (more than ``max_skips``
    consecutive skipped steps raises :class:`NonFiniteBudgetError`).  The
    loss read per step is the one host sync.  Checkpoints, auto-resume and
    spike rollback are not in this slice.

    Returns ``{"state", "history", "step_times", "skipped"}``."""
    history = []
    times = collections.deque(maxlen=TELEMETRY_WINDOW)
    fused = bool(getattr(getattr(train_step, "optimizer", None),
                         "applies_updates", False))
    log(f"run_loop: opt_fused={fused} device="
        f"{tree_leaves(state['params'])[0].device}")
    cur = int(state["step"])
    skipped = consec = 0
    while cur < n_steps:
        batch = next(pipeline)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        loss_v = float(metrics["loss"])
        times.append(time.perf_counter() - t0)
        cur += 1
        if bool(metrics["skipped"]):
            skipped += 1
            consec += 1
            if consec > max_skips:
                diag = {"step": cur, "loss": loss_v,
                        "grad_norm": float(metrics["grad_norm"]),
                        "skipped": skipped}
                raise NonFiniteBudgetError(
                    f"{consec} consecutive non-finite steps (budget "
                    f"{max_skips}) at step {cur}: loss={loss_v}, gnorm="
                    f"{diag['grad_norm']}", diag)
        else:
            consec = 0
        if log_every and cur % log_every == 0:
            window = np.asarray(times)
            p50, p95 = (np.percentile(window, 50),
                        np.percentile(window, straggler_pct))
            log(f"step {cur:6d} loss {loss_v:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"dt_p50 {p50 * 1e3:.1f}ms p95 {p95 * 1e3:.1f}ms "
                f"skipped {skipped}")
        if eval_every and eval_hook and cur % eval_every == 0:
            history.append((cur, eval_hook(state)))
    return {"state": state, "history": history, "step_times": list(times),
            "skipped": skipped}
