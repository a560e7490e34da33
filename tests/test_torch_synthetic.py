"""The port's synthetic testbeds (``models/linear.py``,
``data/synthetic.py::linreg_batch``, ``core/lotion.py``'s smoothed loss,
Eq. 1 and Fisher EMA, ``train/synthetic.py``) against the JAX package and
the JAX benches ``bench_quadratic.py`` / ``bench_twolayer.py`` on the CPU.

Inputs come from numpy seeds or from JAX (the benches' initial weights,
x batches and RR uniforms are bridged and injected).  Tolerances:
``power_law_spectrum`` bitwise; the closed forms within 1e-6 relative
(fp32 summation order); the trainers within 1e-5 relative after 5 steps
at d = 64 (k = 8 for §4.2), against a lax.scan of the bench's own step
run op by op (``jax.disable_jit``), and for ptq, qat and rat also
against the bench's compiled ``_train``.  LOTION is held to the op-by-op
scan only: its gradient at each matrix's absmax element jumps with the
last bits of z = w / (absmax / qmax) (z = qmax gives the bracket [qmax,
qmax]; an ulp below it [qmax - 1, qmax] and a gradient of f s / 2), and
XLA's compiled step rounds that z otherwise than the op-by-op functions
(JAX's and the port's, which agree bitwise), so the compiled bench
leaves the op-by-op trajectory by up to 2e-3 within 5 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_quadratic as jbq
from benchmarks import bench_twolayer as jbt
from repro.core import INT4 as J_INT4
from repro.core import get_format as j_get_format
from repro.core import lotion as jlotion
from repro.core import cast_rr as j_cast_rr
from repro.models import linear as jlin
from repro_torch.core import (fisher_from_grads, get_format,
                              quadratic_smoothed, smoothed_loss_mc)
from repro_torch.data import linreg_batch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import linear as tlin
from repro_torch.train import synthetic as syn

D, K, STEPS = 64, 8, 5
FMTS = ["int4", "int8", "fp4"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _problem(d=D, scale=1.0):
    spec = jlin.power_law_spectrum(d)
    w_star = jax.random.normal(jax.random.PRNGKey(7), (d,)) * scale
    return spec, w_star, _t(spec), _t(w_star)


# --- models/linear.py -------------------------------------------------------

@pytest.mark.parametrize("d", [1, 64, 2000, 12000])
def test_power_law_spectrum_bitwise(d):
    np.testing.assert_array_equal(tlin.power_law_spectrum(d).numpy(),
                                  np.asarray(jlin.power_law_spectrum(d)))


def test_linreg_losses_match_jax():
    rng = np.random.default_rng(0)
    spec, w_star, tspec, tw_star = _problem()
    w = rng.standard_normal(D).astype(np.float32)
    x = rng.standard_normal((32, D)).astype(np.float32)
    y = rng.standard_normal(32).astype(np.float32)
    assert tuple(tlin.linreg_init(D)["w"].shape) == \
        jlin.linreg_init(None, D)["w"].shape
    assert _rel(tlin.linreg_population_loss(_t(w), tw_star, tspec),
                jlin.linreg_population_loss(w, w_star, spec)) <= 1e-6
    assert _rel(tlin.linreg_batch_loss(_t(w), _t(x), _t(y)),
                jlin.linreg_batch_loss(w, x, y)) <= 1e-6


def test_twolayer_functions_match_jax():
    spec, w_star, tspec, tw_star = _problem(scale=0.5)
    jp = jlin.twolayer_init(jax.random.PRNGKey(0), D, K)
    tp = {n: _t(x) for n, x in jp.items()}
    assert _rel(tlin.twolayer_effective(tp, K),
                jlin.twolayer_effective(jp, K)) <= 1e-6
    assert _rel(tlin.twolayer_population_loss(tp, tw_star, tspec, K),
                jlin.twolayer_population_loss(jp, w_star, spec, K)) <= 1e-6
    jgt, tgt = jlin.twolayer_ground_truth(w_star, K), \
        tlin.twolayer_ground_truth(tw_star, K)
    for n in ("w1", "w2"):
        np.testing.assert_array_equal(tgt[n].numpy(), np.asarray(jgt[n]))


def test_twolayer_init_shapes_and_scale():
    p = tlin.twolayer_init(torch.Generator().manual_seed(0), 4000, 16)
    assert tuple(p["w1"].shape) == (16, 4000) and tuple(p["w2"].shape) == \
        (1, 16)
    assert abs(float(p["w1"].std()) * np.sqrt(4000) - 1.0) < 0.02
    again = tlin.twolayer_init(torch.Generator().manual_seed(0), 4000, 16)
    assert all(torch.equal(p[n], again[n]) for n in p)


# --- data/synthetic.py::linreg_batch -----------------------------------------

def test_linreg_batch_shape_and_moments():
    d, b = 32, 20000
    tspec, tw_star = tlin.power_law_spectrum(d), _t(
        np.random.default_rng(1).standard_normal(d).astype(np.float32))
    x, y = linreg_batch(3, 7, b, tw_star, tspec)
    assert tuple(x.shape) == (b, d) and tuple(y.shape) == (b,)
    torch.testing.assert_close(y, x @ tw_star)
    var = x.var(dim=0).numpy()
    np.testing.assert_allclose(var, tspec.numpy(), rtol=0.05)
    assert float(x.mean(dim=0).abs().max()) < 0.03
    x2, _ = linreg_batch(3, 7, b, tw_star, tspec)
    x3, _ = linreg_batch(3, 8, b, tw_star, tspec)
    assert torch.equal(x, x2) and not torch.equal(x, x3)


# --- core/lotion.py ------------------------------------------------------------

@pytest.mark.parametrize("fmt", FMTS)
def test_smoothed_loss_mc_matches_jax(fmt):
    rng = np.random.default_rng(2)
    w = rng.standard_normal(48).astype(np.float32)
    h = np.abs(rng.standard_normal(48)).astype(np.float32)

    def jloss(q):
        return 0.5 * jnp.sum(h * q * q)

    def tloss(q):
        return 0.5 * torch.sum(_t(h) * q * q)

    key, n = jax.random.PRNGKey(4), 16
    want = jlotion.smoothed_loss_mc(jloss, jnp.asarray(w), j_get_format(fmt),
                                    key, n)
    # JAX's draws: split(key, n), then uniform(k_i, w.shape) per sample
    u = np.stack([np.asarray(jax.random.uniform(k, w.shape))
                  for k in jax.random.split(key, n)])
    got = smoothed_loss_mc(tloss, _t(w), get_format(fmt), _t(u))
    assert _rel(got, want) <= 1e-6
    with pytest.raises(ValueError):
        smoothed_loss_mc(tloss, _t(w), get_format(fmt), _t(u[:, :5]))


@pytest.mark.parametrize("fmt", FMTS)
def test_quadratic_smoothed_matches_jax(fmt):
    rng = np.random.default_rng(3)
    d = 40
    a = rng.standard_normal((d, d)).astype(np.float32)
    H = (a @ a.T / d).astype(np.float32)
    w, w_star = (rng.standard_normal(d).astype(np.float32) for _ in range(2))
    want = jlotion.quadratic_smoothed(w, w_star, H, j_get_format(fmt))
    got = quadratic_smoothed(_t(w), _t(w_star), _t(H), get_format(fmt))
    assert _rel(got, want) <= 1e-6


def test_fisher_from_grads_matches_jax():
    rng = np.random.default_rng(4)
    grads = [{"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
             for _ in range(3)]
    jf = tf = None
    for g in grads:
        jf = jlotion.fisher_from_grads(g, 0.9, jf)
        tf = fisher_from_grads({n: _t(x) for n, x in g.items()}, 0.9, tf)
    for n in ("a", "b"):
        assert _rel(tf[n], jf[n]) <= 1e-6


# --- train/synthetic.py against the JAX benches ------------------------------

@pytest.fixture
def small_benches(monkeypatch):
    """The JAX benches at d = 64 and 5 steps (their LR schedules read
    STEPS)."""
    for mod in (jbq, jbt):
        monkeypatch.setattr(mod, "D", D)
        monkeypatch.setattr(mod, "STEPS", STEPS)


def _quadratic_draws(seed=0):
    """bench_quadratic._train's draws: step t's x normals from
    fold_in(PRNGKey(seed + 1), t), its RR uniforms from fold_in(PRNGKey(
    seed + 2), t)."""
    xs = [np.asarray(jax.random.normal(jax.random.fold_in(
        jax.random.PRNGKey(seed + 1), t), (jbq.BSZ, D))) for t in range(STEPS)]
    us = [np.asarray(jax.random.uniform(jax.random.fold_in(
        jax.random.PRNGKey(seed + 2), t), (D,))) for t in range(STEPS)]
    return xs, us


def _jax_quadratic_scan(w_star, spec, lr0, method, lam=0.5):
    """Every weight of a lax.scan of ``bench_quadratic._train``'s step
    (the bench's own code; w_0 = 0 first)."""
    from repro.core import cast_rtn, lotion_penalty
    sq = jnp.sqrt(spec)

    def lr_at(t):
        return lr0 * (0.55 + 0.45 * jnp.cos(jnp.pi * t / jbq.STEPS))

    def sgd_grad(u, t):
        x = jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(1), t), (jbq.BSZ, D)) * sq
        return x.T @ (x @ (u - w_star)) / jbq.BSZ

    def step(w, t):
        if method == "lotion":
            g = sgd_grad(w, t) + lam * jax.grad(
                lambda u: lotion_penalty(u, spec, J_INT4, -1))(w)
        elif method == "qat":
            g = sgd_grad(cast_rtn(w, J_INT4), t)
        elif method == "rat":
            key = jax.random.fold_in(jax.random.PRNGKey(2), t)
            g = sgd_grad(j_cast_rr(w, J_INT4, key), t)
        else:
            g = sgd_grad(w, t)
        w = w - lr_at(t) * g
        return w, w

    w_end, ws = jax.lax.scan(step, jnp.zeros((D,)), jnp.arange(STEPS))
    return [np.zeros(D, np.float32)] + list(np.asarray(ws)), w_end


@pytest.mark.parametrize("lr", [0.6, 1.2])
@pytest.mark.parametrize("method", syn.QUAD_METHODS)
def test_quadratic_trainer_matches_jax_bench_scan(small_benches, method, lr):
    spec, w_star, tspec, tw_star = _problem()
    # the copy of the bench's step, compiled, is the bench's _train
    np.testing.assert_array_equal(
        np.asarray(_jax_quadratic_scan(w_star, spec, lr, method)[1]),
        np.asarray(jbq._train(w_star, spec, lr, method)))
    with jax.disable_jit():
        want = _jax_quadratic_scan(w_star, spec, lr, method)[1]
    xs, us = _quadratic_draws()
    got = syn.quadratic_train(tw_star, tspec, lr, method, steps=STEPS,
                              normals=lambda t: _t(xs[t]),
                              uniforms=lambda t: _t(us[t]))
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("lr", [0.6, 1.2])
@pytest.mark.parametrize("method", ["ptq", "qat", "rat"])
def test_quadratic_trainer_matches_jax_bench(small_benches, method, lr):
    spec, w_star, tspec, tw_star = _problem()
    want = jbq._train(w_star, spec, lr, method)
    xs, us = _quadratic_draws()
    reset_launch_counts()
    got = syn.quadratic_train(tw_star, tspec, lr, method, steps=STEPS,
                              normals=lambda t: _t(xs[t]),
                              uniforms=lambda t: _t(us[t]))
    assert _rel(got, want) <= 1e-5
    rtn, err = jbq._eval(want, w_star, spec)
    got_eval = syn.quadratic_eval(got, tw_star, tspec)
    assert _rel(got_eval[:2], (rtn, err)) <= 1e-5
    assert _rel(got_eval[2], jlin.linreg_population_loss(
        want, w_star, spec)) <= 1e-5
    # CPU tensors take the plain versions: the kernels count nothing
    assert set(launch_counts().values()) == {0}


@pytest.mark.parametrize("method", syn.QUAD_METHODS)
def test_quadratic_eval_matches_jax_bench(method):
    """The eval of a trained w (JAX's, 5 steps at d = 64)."""
    spec, w_star, tspec, tw_star = _problem()
    w = _jax_quadratic_scan(w_star, spec, 0.6, method)[1]
    rtn, err = jbq._eval(w, w_star, spec)
    got = syn.quadratic_eval(_t(w), tw_star, tspec)
    assert _rel(got[:2], (rtn, err)) <= 1e-6
    assert _rel(got[2], jlin.linreg_population_loss(w, w_star, spec)) <= 1e-6


def test_quadratic_trainer_default_draws_repeat():
    tspec, tw_star = tlin.power_law_spectrum(D), torch.randn(
        D, generator=torch.Generator().manual_seed(7))
    a = syn.quadratic_train(tw_star, tspec, 0.6, "rat", steps=3)
    b = syn.quadratic_train(tw_star, tspec, 0.6, "rat", steps=3)
    c = syn.quadratic_train(tw_star, tspec, 0.6, "rat", steps=3, seed=1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        syn.quadratic_train(tw_star, tspec, 0.6, "sgd", steps=1)


def test_fig2_claims_and_best_pick():
    def run(m, lr, rtn, err):
        return dict(method=m, lr=lr, rtn=rtn, e_rr=err, fp32=0.0)
    runs = [run("ptq", 0.6, 0.4, 0.30), run("ptq", 1.2, 0.5, 0.31),
            run("qat", 0.6, 0.9, 0.8), run("rat", 0.6, 0.4, 0.32),
            run("lotion", 0.6, 0.5, 0.2), run("lotion", 1.2, 0.3, 0.25)]
    best = syn.best_per_method(runs)
    assert best["lotion"]["lr"] == 0.6 and best["ptq"]["lr"] == 0.6
    assert syn.fig2_claims(best) == dict(lotion_best_on_rr=True,
                                         qat_worst=True,
                                         lemma3_rat_matches_ptq=True)


def test_gn_diag_matches_jax():
    spec, _, tspec, _ = _problem()
    jp = jlin.twolayer_init(jax.random.PRNGKey(1), D, K)
    want = jbt._gn_diag(jp, spec, K)
    got = syn.gn_diag({n: _t(x) for n, x in jp.items()}, tspec, K)
    for n in ("w1", "w2"):
        assert tuple(got[n].shape) == want[n].shape
        assert _rel(got[n], want[n]) <= 1e-6


def _jax_twolayer_scan(w_star, spec, lr0, method, lam=1.0):
    """Every weight of a lax.scan of ``bench_twolayer._train``'s step (the
    bench's own code; its init first)."""
    from repro.core import cast_rtn, lotion_penalty

    def loss(p):
        return jlin.twolayer_population_loss(p, w_star, spec, K)

    def lr_at(t):
        return lr0 * (0.55 + 0.45 * jnp.cos(jnp.pi * t / jbt.STEPS))

    def step(p, t):
        if method == "qat":
            def obj(u):
                q = jax.tree.map(
                    lambda x: cast_rtn(jax.lax.stop_gradient(x), J_INT4)
                    + (x - jax.lax.stop_gradient(x)), u)
                return loss(q)
            g = jax.grad(obj)(p)
        elif method == "lotion":
            def obj(u):
                gn = jbt._gn_diag(u, spec, K)
                pen = sum(lotion_penalty(u[n], jax.lax.stop_gradient(gn[n]),
                                         J_INT4, -1) for n in ("w1", "w2"))
                return loss(u) + lam * pen
            g = jax.grad(obj)(p)
        else:
            g = jax.grad(loss)(p)
        p = jax.tree.map(lambda x, gg: x - lr_at(t) * gg, p, g)
        return p, p

    p0 = jlin.twolayer_init(jax.random.PRNGKey(0), D, K)
    p_end, ps = jax.lax.scan(step, p0, jnp.arange(STEPS))
    return [p0] + [{n: ps[n][t] for n in p0} for t in range(STEPS)], p_end


def _tp(p):
    return {n: _t(x) for n, x in p.items()}


@pytest.mark.parametrize("lr", [0.1, 0.3])
@pytest.mark.parametrize("method", syn.TWO_METHODS)
def test_twolayer_trainer_matches_jax_bench_scan(small_benches, method, lr):
    spec, w_star, tspec, tw_star = _problem(scale=0.5)
    p_end = _jax_twolayer_scan(w_star, spec, lr, method)[1]
    want_end = jbt._train(w_star, spec, K, lr, method)
    for n in ("w1", "w2"):
        np.testing.assert_array_equal(np.asarray(p_end[n]),
                                      np.asarray(want_end[n]))
    with jax.disable_jit():
        ps, want = _jax_twolayer_scan(w_star, spec, lr, method)
    got = syn.twolayer_train(tw_star, tspec, K, lr, method, steps=STEPS,
                             p0=_tp(ps[0]))
    for n in ("w1", "w2"):
        assert _rel(got[n], want[n]) <= 1e-5


@pytest.mark.parametrize("lr", [0.1, 0.3])
@pytest.mark.parametrize("method", ["ptq", "qat"])
def test_twolayer_trainer_matches_jax_bench(small_benches, method, lr):
    spec, w_star, tspec, tw_star = _problem(scale=0.5)
    want = jbt._train(w_star, spec, K, lr, method)
    p0 = _tp(jlin.twolayer_init(jax.random.PRNGKey(0), D, K))
    got = syn.twolayer_train(tw_star, tspec, K, lr, method, steps=STEPS,
                             p0=p0)
    for n in ("w1", "w2"):
        assert _rel(got[n], want[n]) <= 1e-5


@pytest.mark.parametrize("method", syn.TWO_METHODS)
def test_twolayer_quant_loss_matches_jax_bench(small_benches, method):
    """The eval with JAX's split(PRNGKey(3), 2) uniforms, of JAX's
    weights after 5 steps."""
    spec, w_star, tspec, tw_star = _problem(scale=0.5)
    p = _jax_twolayer_scan(w_star, spec, 0.3, method)[1]
    key = jax.random.PRNGKey(3)
    ks = jax.random.split(key, 2)
    uni = {"w1": _t(jax.random.uniform(ks[0], (K, D))),
           "w2": _t(jax.random.uniform(ks[1], (1, K)))}
    assert _rel(syn.twolayer_quant_loss(_tp(p), tw_star, tspec, K, uni),
                jbt._quant_loss(p, w_star, spec, K, key)) <= 1e-6


def test_twolayer_rows_lemma4_and_gt(monkeypatch):
    """The rows' GT entry is GT's quantized loss, and Lemma 4's check is
    made from the second width on (plain path, tiny)."""
    tspec = tlin.power_law_spectrum(256)
    tw_star = torch.randn(256, generator=torch.Generator().manual_seed(7)
                          ) * 0.5
    for name, value in (("TWO_KS", (4, 64)), ("TWO_METHODS", ("ptq",)),
                        ("TWO_LRS", (0.3,)), ("TWO_STEPS", 2)):
        monkeypatch.setattr(syn, name, value)
    rows = syn.twolayer_rows(tw_star, tspec)
    assert [r["k"] for r in rows] == [4, 64]
    assert "lemma4_gt_decreasing" not in rows[0]
    assert rows[1]["lemma4_gt_decreasing"] and rows[1]["gt"] < rows[0]["gt"]
    uni = syn.rr_uniforms(4, 256, "cpu")
    assert rows[0]["gt"] == min(syn.twolayer_quant_loss(
        tlin.twolayer_ground_truth(tw_star, 4), tw_star, tspec, 4, uni))


def test_rr_eval_casts_follow_jax_cast_rr():
    """``quant_rr`` with JAX's per-tensor uniforms gives JAX's cast."""
    from repro_torch.kernels.quant import quant_rr
    w = jax.random.normal(jax.random.PRNGKey(5), (K, D))
    key = jax.random.PRNGKey(6)
    want = j_cast_rr(w, J_INT4, key)
    got = quant_rr(_t(w), _t(jax.random.uniform(key, w.shape)), "int4", -1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
