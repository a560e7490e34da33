"""The paper's synthetic testbeds on the port: what the JAX benches
``benchmarks/bench_quadratic.py`` (§4.1, Figure 2) and
``benchmarks/bench_twolayer.py`` (§4.2, Figure 3) compute.

Counterparts:

* ``quadratic_train`` (a loop of ``quadratic_step``) <-
  ``bench_quadratic._train``: SGD on the
  power-law quadratic at batch 32, LR ``lr0 (0.55 + 0.45 cos(pi t /
  steps))``, methods ``ptq``, ``qat`` (gradient at the RTN cast), ``rat``
  (at the RR cast) and ``lotion`` (the Eq. 3 penalty with the spectrum
  as its Fisher, lam 0.5);
* ``quadratic_eval`` <- ``bench_quadratic._eval``: the loss at the RTN
  cast, the exact E[RR] loss by Eq. 1, and the fp32 loss;
* ``quadratic_runs`` <- ``bench_quadratic.run`` (every run, with
  ``best_per_method`` picking as ``run`` does; ``fig2_claims`` is
  ``main``'s three checks);
* ``gn_diag`` <- ``bench_twolayer._gn_diag``; ``twolayer_train`` (a
  loop of ``twolayer_step``) <- ``bench_twolayer._train`` (the
  population gradient through autograd);
  ``twolayer_quant_loss`` <- ``bench_twolayer._quant_loss``;
  ``twolayer_rows`` <- ``bench_twolayer.main``'s loop over widths, with
  the GT construction and Lemma 4's check.

Casts and penalties go through the kernels' wrappers, which launch the
CUDA kernels for CUDA tensors and take the plain versions for CPU
tensors: QAT's cast is ``quant_rtn`` (``fake_quant_rtn`` where a gradient
flows through it, §4.2), RAT's ``quant_rr``, LOTION's penalty gradient
``lotion_penalty_fused_vg`` (§4.1) or the autograd ``lotion_penalty_fused``
(§4.2), all INT4 with per-matrix scales; the evals' RTN and RR casts are
``quant_rtn`` / ``quant_rr``, and Eq. 1's variance term is the Eq. 3
penalty with f = spectrum, from ``lotion_reg``.

Draws can be injected: ``normals(t)`` gives step t's (batch, d) standard
normals (x = normals * sqrt(spectrum)), ``uniforms(t)`` its RR uniforms
in w's shape.  By default they come from ``torch.Generator``s on the
tensors' device seeded ``seed + 1`` and ``seed + 2`` (JAX folds the step
into keys of the same seeds).  The loops make no host sync; the evals
read their losses back.

Numerics.  Weights, casts, penalties and LRs are fp32, as in the JAX
benches, but the trainers sum their gradients (§4.1's
``x^T (x (u - w*)) / batch``, §4.2's population loss and its backward)
in float64 and round each to fp32 once; the JAX benches sum in fp32.
The reason is LOTION's gradient at each matrix's absmax element: there
z = w / (absmax / qmax) is qmax, or an ulp below it with the bracket
[qmax - 1, qmax] and a gradient of f s / 2, so a last-bit difference in
w can move the step by that much.  With fp32 sums two devices (or two
summation orders on one) part by about 1e-3 within 200 steps; summed in
float64 (``gn_diag``'s sum over d too) the card and the CPU give the same
fp32 gradient bits, so their runs stay comparable.  The LR table is computed on the CPU for the same
reason.  No fp32 matmul is left, so TF32 settings
(``torch.backends.cuda.matmul.allow_tf32``) do not reach the trainers.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.ste import fake_quant_rtn
from ..kernels.lotion_reg import lotion_penalty_fused, lotion_penalty_fused_vg
from ..kernels.quant import quant_rr, quant_rtn
from ..models.linear import (linreg_population_loss, power_law_spectrum,
                             twolayer_ground_truth, twolayer_init,
                             twolayer_population_loss)
from ..numerics import div_scalar, sqrt_rn

FMT = "int4"
PAPER_D = 12000                    # the paper's d (§4.1)
QUAD_STEPS, QUAD_BATCH, QUAD_LAM = 8000, 32, 0.5
QUAD_METHODS = ("ptq", "qat", "rat", "lotion")
QUAD_LRS = (0.6, 1.2)
TWO_STEPS, TWO_LAM = 300, 1.0
TWO_KS = (16, 64, 256)
TWO_METHODS = ("ptq", "qat", "lotion")
TWO_LRS = (0.1, 0.3)

Draw = Callable[[int], torch.Tensor]


def lr_schedule(lr0: float, steps: int, device) -> torch.Tensor:
    """(steps,) fp32: ``lr0 (0.55 + 0.45 cos(pi t / steps))``, computed
    on the CPU (one table for every device) and moved to ``device``."""
    t = torch.arange(steps, dtype=torch.float32)
    return (lr0 * (0.55 + 0.45 * torch.cos(div_scalar(math.pi * t,
                                                      float(steps))))
            ).to(device)


def _draws(draw: Optional[Draw], seed: int, shape, device, fn) -> Draw:
    if draw is not None:
        return draw
    gen = torch.Generator(device=device).manual_seed(seed)
    return lambda t: fn(shape, generator=gen, device=device)


def problem(d: int, device, scale: float = 1.0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectrum, w*) of a testbed: the power-law spectrum of d and w* ~
    N(0, scale^2) from a generator on ``device`` seeded 7 (the JAX benches
    draw w* from PRNGKey(7); scale 1 for §4.1, 0.5 for §4.2)."""
    w_star = torch.randn(d, generator=torch.Generator(device=device)
                         .manual_seed(7), device=device)
    return power_law_spectrum(d, device=device), w_star * scale


# --- §4.1: linear regression on the power-law quadratic ---------------------

def quadratic_train(w_star: torch.Tensor, spec: torch.Tensor, lr0: float,
                    method: str, *, steps: int = QUAD_STEPS, seed: int = 0,
                    normals: Optional[Draw] = None,
                    uniforms: Optional[Draw] = None) -> torch.Tensor:
    """SGD at batch ``QUAD_BATCH`` from w = 0 for ``steps`` steps;
    returns the final w.  The minibatch gradient at u is ``x^T (x (u -
    w*)) / batch``, u being w (ptq, lotion), its RTN cast (qat) or its RR
    cast (rat)."""
    if method not in QUAD_METHODS:
        raise ValueError(f"method {method!r} not in {QUAD_METHODS}")
    dev, d = w_star.device, w_star.shape[0]
    normals = _draws(normals, seed + 1, (QUAD_BATCH, d), dev, torch.randn)
    if method == "rat":
        uniforms = _draws(uniforms, seed + 2, (d,), dev, torch.rand)
    sq = sqrt_rn(spec)
    lrs = lr_schedule(lr0, steps, dev)
    w = torch.zeros((d,), dtype=torch.float32, device=dev)
    for t in range(steps):
        w = quadratic_step(w, normals(t) * sq, lrs[t], method, w_star, spec,
                           u=uniforms(t) if method == "rat" else None)
    return w


def quadratic_step(w: torch.Tensor, x: torch.Tensor, lr, method: str,
                   w_star: torch.Tensor, spec: torch.Tensor,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One SGD step on the batch ``x`` (batch, d) at the LR ``lr``; ``u``
    are RAT's uniforms.  The minibatch gradient is summed in float64 and
    rounded to fp32 once (see the module's docstring)."""
    if method == "qat":
        at = quant_rtn(w, FMT, -1)
    elif method == "rat":
        at = quant_rr(w, u, FMT, -1)
    else:
        at = w
    x64 = x.to(torch.float64)
    g = div_scalar(x64.T @ (x64 @ (at - w_star).to(torch.float64)),
                   float(x.shape[0])).to(torch.float32)
    if method == "lotion":
        g = g + lotion_penalty_fused_vg(w, spec, FMT, -1, QUAD_LAM)[1]
    return w - lr * g


def quadratic_eval(w: torch.Tensor, w_star: torch.Tensor,
                   spec: torch.Tensor) -> Tuple[float, float, float]:
    """(loss at the RTN cast, exact E[loss at the RR cast], fp32 loss).
    For the quadratic, Eq. 1's ``1/2 sum_i lambda_i Var[eps_i]`` is the
    Eq. 3 penalty with the spectrum as its Fisher."""
    rtn = linreg_population_loss(quant_rtn(w, FMT, -1), w_star, spec)
    fp32 = linreg_population_loss(w, w_star, spec)
    pen = lotion_penalty_fused_vg(w, spec, FMT, -1)[0]
    return float(rtn), float(fp32 + pen), float(fp32)


def quadratic_runs(w_star: torch.Tensor, spec: torch.Tensor) -> List[dict]:
    """One trained and evaluated run per (method, lr), with its seconds
    (host clock, synchronized)."""
    runs = []
    for method in QUAD_METHODS:
        for lr in QUAD_LRS:
            _sync(w_star)
            t0 = time.perf_counter()
            w = quadratic_train(w_star, spec, lr, method)
            rtn, err, fp32 = quadratic_eval(w, w_star, spec)
            runs.append(dict(method=method, lr=lr, rtn=rtn, e_rr=err,
                             fp32=fp32, seconds=time.perf_counter() - t0))
    return runs


def best_per_method(runs: List[dict]) -> Dict[str, dict]:
    """Per method, the run with the least ``min(rtn, e_rr)`` (the first
    one on a tie), as ``bench_quadratic.run`` picks."""
    best: Dict[str, dict] = {}
    for r in runs:
        b = best.get(r["method"])
        if b is None or min(r["rtn"], r["e_rr"]) < min(b["rtn"], b["e_rr"]):
            best[r["method"]] = r
    return best


def fig2_claims(best: Dict[str, dict]) -> Dict[str, bool]:
    """Figure 2's claims as ``bench_quadratic.main`` checks them: LOTION
    best on E[RR]; QAT worst; RAT within 35% of PTQ on E[RR] (Lemma 3)."""
    q = {m: min(r["rtn"], r["e_rr"]) for m, r in best.items()}
    return {
        "lotion_best_on_rr": best["lotion"]["e_rr"] < min(
            best[m]["e_rr"] for m in ("ptq", "qat", "rat")),
        "qat_worst": q["qat"] > max(q[m] for m in ("ptq", "rat", "lotion")),
        "lemma3_rat_matches_ptq": abs(best["rat"]["e_rr"]
                                      - best["ptq"]["e_rr"])
        < 0.35 * best["ptq"]["e_rr"]}


# --- §4.2: the two-layer linear network -------------------------------------

def gn_diag(params, spec: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """The exact Gauss-Newton diagonal of v = W2 W1 / k:
    g(W1[i, j]) = lambda_j (W2[0, i] / k)^2,
    g(W2[0, i]) = sum_j lambda_j (W1[i, j] / k)^2 (summed in float64 and
    rounded once, as the trainers' gradients are)."""
    w1, w2 = params["w1"], params["w2"]
    g2 = torch.sum(spec[None, :] * div_scalar(w1, float(k)) ** 2, dim=-1,
                   keepdim=True, dtype=torch.float64)
    return {"w1": spec[None, :] * div_scalar(w2[0][:, None], float(k)) ** 2,
            "w2": g2.T.to(torch.float32).contiguous()}


def twolayer_train(w_star: torch.Tensor, spec: torch.Tensor, k: int,
                   lr0: float, method: str, *, p0: Dict[str, torch.Tensor],
                   steps: int = TWO_STEPS) -> Dict[str, torch.Tensor]:
    """Gradient descent on the population loss from the weights ``p0``
    (left as they are): ptq, qat (the straight-through RTN cast of both
    leaves) or lotion (the loss plus ``TWO_LAM`` times the Eq. 3 penalty
    of both leaves, the Fisher their Gauss-Newton diagonal, a constant)."""
    if method not in TWO_METHODS:
        raise ValueError(f"method {method!r} not in {TWO_METHODS}")
    p = {n: p0[n].detach().clone() for n in ("w1", "w2")}
    lrs = lr_schedule(lr0, steps, w_star.device)
    for t in range(steps):
        p = twolayer_step(p, lrs[t], method, w_star, spec, k)
    return p


def _loss64(p, w_star: torch.Tensor, spec: torch.Tensor, k: int):
    """The population loss of fp32 weights, summed in float64."""
    f64 = torch.float64
    return twolayer_population_loss({n: x.to(f64) for n, x in p.items()},
                                    w_star.to(f64), spec.to(f64), k)


def twolayer_step(p: Dict[str, torch.Tensor], lr, method: str,
                  w_star: torch.Tensor, spec: torch.Tensor, k: int
                  ) -> Dict[str, torch.Tensor]:
    """One gradient step on the population objective of ``method``.  The
    loss and its gradient are summed in float64, each leaf's gradient
    rounded to fp32 once (see the module's docstring)."""
    names = ("w1", "w2")
    u = {n: p[n].detach().requires_grad_(True) for n in names}
    if method == "qat":
        obj = _loss64({n: fake_quant_rtn(u[n], FMT, -1) for n in names},
                      w_star, spec, k)
    else:
        obj = _loss64(u, w_star, spec, k)
    if method == "lotion":
        with torch.no_grad():
            gn = gn_diag(u, spec, k)
        for n in names:
            obj = obj + lotion_penalty_fused(u[n], gn[n], FMT, -1, TWO_LAM)
    grads = torch.autograd.grad(obj, [u[n] for n in names])
    with torch.no_grad():
        return {n: u[n] - lr * g for n, g in zip(names, grads)}


def rr_uniforms(k: int, d: int, device, seed: int = 3
                ) -> Dict[str, torch.Tensor]:
    """The eval's RR uniforms: W1's (k, d), then W2's (1, k), from a
    generator seeded ``seed`` (the JAX bench splits PRNGKey(3))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"w1": torch.rand((k, d), generator=gen, device=device),
            "w2": torch.rand((1, k), generator=gen, device=device)}


def twolayer_quant_loss(p, w_star: torch.Tensor, spec: torch.Tensor, k: int,
                        uniforms: Dict[str, torch.Tensor]
                        ) -> Tuple[float, float]:
    """(loss at the RTN cast, loss at the RR cast) of both leaves."""
    names = ("w1", "w2")
    rtn = {n: quant_rtn(p[n], FMT, -1) for n in names}
    rr = {n: quant_rr(p[n], uniforms[n], FMT, -1) for n in names}
    return (float(twolayer_population_loss(rtn, w_star, spec, k)),
            float(twolayer_population_loss(rr, w_star, spec, k)))


def twolayer_rows(w_star: torch.Tensor, spec: torch.Tensor) -> List[dict]:
    """Per width k of ``TWO_KS``: each of ``TWO_METHODS``' best ``min(rtn,
    rr)`` over ``TWO_LRS`` (every run ``TWO_STEPS`` steps from
    ``twolayer_init`` seeded 0, as the JAX bench's from PRNGKey(0)), the
    GT construction's, the seconds of each run, and from the second width
    on Lemma 4's check (GT's loss at most 1.5x the previous width's)."""
    rows, gt_prev = [], None
    dev, d = w_star.device, w_star.shape[0]
    for k in TWO_KS:
        uni = rr_uniforms(k, d, dev)
        p0 = twolayer_init(torch.Generator(device=dev).manual_seed(0), d, k)
        row: dict = dict(k=k, seconds={})
        for method in TWO_METHODS:
            best = None
            for lr in TWO_LRS:
                _sync(w_star)
                t0 = time.perf_counter()
                p = twolayer_train(w_star, spec, k, lr, method, p0=p0,
                                   steps=TWO_STEPS)
                cand = min(twolayer_quant_loss(p, w_star, spec, k, uni))
                row["seconds"][f"{method}_lr{lr}"] = time.perf_counter() - t0
                best = cand if best is None or cand < best else best
            row[method] = best
        row["gt"] = min(twolayer_quant_loss(
            twolayer_ground_truth(w_star, k), w_star, spec, k, uni))
        if gt_prev is not None:
            row["lemma4_gt_decreasing"] = row["gt"] <= gt_prev * 1.5
        gt_prev = row["gt"]
        rows.append(row)
    return rows


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
