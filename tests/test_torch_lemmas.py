"""The paper's formal claims (RR axioms 1 and 3, Lemmas 1-4, Eq. 1, Eq. 3)
on the port's own functions, the twin of ``tests/test_lemmas.py``: the
same statements and formats, with draws from ``torch.Generator``s.

The statistical checks hold each element's Monte-Carlo mean within 5
standard errors of its expectation (the theoretical RR variance over the
sample count) for more than 97% of the elements, as the JAX test does.
"""

import pytest
import torch

from repro_torch.core import (FP4_E2M1, INT4, INT8, cast_rr, cast_rtn,
                              lotion_penalty, quadratic_smoothed,
                              rr_neighbors, rr_variance, smoothed_loss_mc)
from repro_torch.models.linear import (power_law_spectrum,
                                       twolayer_ground_truth,
                                       twolayer_population_loss)

FMTS = [INT4, INT8, FP4_E2M1]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(seed, shape):
    return torch.randn(shape, generator=_gen(seed))


def _rand(seed, shape):
    return torch.rand(shape, generator=_gen(seed))


@pytest.mark.parametrize("fmt", FMTS, ids=lambda f: f.name)
def test_rr_axiom1_unbiased(fmt):
    """RR axiom 1: E[q] = w."""
    w = _randn(0, (256,)) * 2
    n = 3000
    u = _rand(1, (n, 256))
    qs = torch.stack([cast_rr(w, fmt, u[i]) for i in range(n)])
    se = torch.sqrt(rr_variance(w, fmt) / n) + 1e-8
    frac_ok = float(((qs.mean(0) - w).abs() < 5 * se).float().mean())
    assert frac_ok > 0.97, frac_ok


@pytest.mark.parametrize("fmt", FMTS, ids=lambda f: f.name)
def test_rr_axiom3_fixed_points(fmt):
    """RR axiom 3: representable points round to themselves w.p. 1."""
    q = cast_rtn(_randn(2, (128,)), fmt)
    for seed in range(5):
        torch.testing.assert_close(cast_rr(q, fmt, _rand(seed, (128,))), q,
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("fmt", FMTS, ids=lambda f: f.name)
def test_lemma1_continuity(fmt):
    """Lemma 1: the smoothed loss is continuous across a quantization
    boundary, where the quantized loss L(cast(w)) jumps."""
    H = torch.diag(torch.linspace(1.0, 0.1, 16))
    w_star = torch.zeros(16)
    w = _randn(3, (16,))
    _, hi = rr_neighbors(w, fmt)
    wb = w.clone()
    wb[0] = hi[0]                   # a cell boundary in coordinate 0
    eps = 1e-4 * torch.ones_like(w)
    s_hi = quadratic_smoothed(wb + eps, w_star, H, fmt)
    s_lo = quadratic_smoothed(wb - eps, w_star, H, fmt)
    assert abs(float(s_hi - s_lo)) < 1e-2
    assert float(quadratic_smoothed(wb, w_star, H, fmt)) > 0


@pytest.mark.parametrize("fmt", [INT4, INT8], ids=lambda f: f.name)
def test_lemma2_global_minima_preserved(fmt):
    """Lemma 2: min_w E[L(RR(w))] == min_w L(cast(w)); on a 1-D quadratic
    with a representable minimizer both minima are 0 and attained."""
    target = cast_rtn(torch.tensor([0.5]), fmt)

    def loss(q):
        return torch.sum((q - target) ** 2)

    mc = smoothed_loss_mc(loss, target, fmt, _rand(4, (64, 1)))
    assert float(mc) < 1e-10
    w_off = target + 0.3 * (float(target[0]) or 1.0)
    assert float(smoothed_loss_mc(loss, w_off, fmt, _rand(5, (64, 1)))) > 0


def test_lemma3_rr_gradient_unbiased():
    """Lemma 3: E[grad L(w + eps)] = grad L(w) for a quadratic L."""
    d, n = 64, 4000
    h = _randn(6, (d,)).abs()
    w_star, w = _randn(7, (d,)), _randn(8, (d,))
    g_true = h * (w - w_star)
    u = _rand(9, (n, d))
    g_mc = torch.stack([h * (cast_rr(w, INT4, u[i]) - w_star)
                        for i in range(n)]).mean(0)
    se = torch.sqrt(h ** 2 * rr_variance(w, INT4) / n) + 1e-8
    ok = float(((g_mc - g_true).abs() < 5 * se).float().mean())
    assert ok > 0.97, ok


def test_eq1_quadratic_closed_form_vs_mc():
    """Eq. 1: L_smooth = L + 1/2 tr(H Sigma) matches the MC expectation."""
    d = 48
    H = torch.diag(_randn(10, (d,)).abs())
    w_star, w = _randn(11, (d,)), _randn(12, (d,))

    def loss(q):
        return 0.5 * (q - w_star) @ (H @ (q - w_star))

    mc = float(smoothed_loss_mc(loss, w, INT4, _rand(13, (8000, d))))
    cf = float(quadratic_smoothed(w, w_star, H, INT4))
    assert abs(mc - cf) / cf < 0.02, (mc, cf)


def test_eq3_penalty_is_half_fisher_times_variance():
    """Eq. 3: penalty == 1/2 sum g_ii sigma_i^2, sigma^2 = (hi-w)(w-lo)."""
    w = _randn(14, (128,)) * 2
    fisher = _randn(15, (128,)).abs()
    pen = float(lotion_penalty(w, fisher, INT4, -1))
    want = 0.5 * float((fisher.double() * rr_variance(w, INT4, -1)
                        .double()).sum())
    assert abs(pen - want) < 1e-4 * max(abs(want), 1)


def test_lemma4_twolayer_gt_loss_vanishes_with_width():
    """Lemma 4: the GT construction's quantized loss -> 0 as k grows."""
    d = 256
    spec = power_law_spectrum(d)
    w_star = _randn(16, (d,)) * 0.5
    losses = []
    for k in (4, 16, 64, 256):
        gt = twolayer_ground_truth(w_star, k)
        qt = {"w1": cast_rr(gt["w1"], INT4, _rand(k, (k, d))),
              "w2": gt["w2"]}      # W2 = ones is representable
        losses.append(float(twolayer_population_loss(qt, w_star, spec, k)))
    assert losses[-1] < losses[0] / 10, losses
    assert losses[2] < losses[0], losses
