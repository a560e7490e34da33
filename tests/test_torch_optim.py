"""The port's optimizer (``repro_torch.optim``) against the JAX package on
the CPU: schedules, clipping, the unfused ``clip -> lotion_decoupled ->
core`` chain (built link by link on the port's side, by JAX's
``make_optimizer`` with kernels off on JAX's) and the fused cores, fed the
same parameters and gradients.

Inputs come from numpy seeds.  Tolerances: with ``clip_norm=inf`` the
chain and the fused cores give parameter updates, moments and counts
bitwise equal to JAX's over three steps (the fp32 bias corrections
``1 - b**count`` of the two frameworks agree at these counts; they part
by an ulp at some larger counts, which the test checks it avoids).  With
clipping on, the global norms agree within 1e-6 relative (summation order)
and the updates within 1e-6.  Schedules: constant and warmup bitwise,
cosine within 1 ulp (the frameworks' fp32 cosines differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantPolicy as JPolicy
from repro.optim import adamw as j_adamw
from repro.optim import clip as jclip
from repro.optim import constant as j_constant
from repro.optim import cosine_with_warmup as j_cosine
from repro.optim import fused_lotion_adamw_core as j_fused_adamw
from repro.optim import fused_lotion_sgd_core as j_fused_sgd
from repro.optim import linear_warmup as j_warmup
from repro.optim import sgd as j_sgd
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_optimizer as j_make_optimizer
from repro_torch import bridge
from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.optim import (adamw, chain, clip, clip_global_norm, constant,
                               cosine_with_warmup, fused_lotion_adamw_core,
                               fused_lotion_sgd_core, linear_warmup,
                               lotion_decoupled, sgd)
from repro_torch.train import TrainConfig, make_optimizer

LR = 1e-3


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"stage": {"w_up": (rng.standard_normal((2, 32, 64)) * 0.2
                               ).astype(np.float32),
                      "norm_scale": np.ones((2, 32), np.float32)},
            "wq": (rng.standard_normal((64, 48)) * 0.2).astype(np.float32),
            "embed": (rng.standard_normal((40, 32)) * 0.02
                      ).astype(np.float32)}


def _grads(seed):
    rng = np.random.default_rng(100 + seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05
                                   ).astype(np.float32), _params())


def _run_jax(tx, steps=3, fisher_from_state=True):
    p = jax.tree.map(jnp.asarray, _params())
    st = tx.init(p)
    for s in range(steps):
        g = jax.tree.map(jnp.asarray, _grads(s))
        fisher = tx.fisher(st) if fisher_from_state else None
        upd, st = tx.update(g, st, p, fisher=fisher)
        p = upd if tx.applies_updates else jax.tree.map(jnp.add, p, upd)
    return p, st


def _run_torch(tx, steps=3):
    p = bridge.to_torch(_params())
    st = tx.init(p)
    for s in range(steps):
        g = bridge.to_torch(_grads(s))
        upd, st = tx.update(g, st, p, fisher=tx.fisher(st))
        p = upd if tx.applies_updates else _add(p, upd)
    return p, st


def _add(a, b):
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


def _assert_trees_equal(tp, jp):
    jt = bridge.flatten(jax.tree.map(np.asarray, jp))
    tt = bridge.flatten(tp)
    assert set(jt) == set(tt)
    for k in jt:
        np.testing.assert_array_equal(tt[k].numpy(), jt[k], err_msg=k)


def _chain(fmt, lam, bs, core, clip_norm=float("inf")):
    """The port's unfused chain, built link by link (``make_optimizer``
    fuses every AdamW core and every SGD core that can weight LOTION)."""
    links = [clip_global_norm(clip_norm)]
    if lam:
        links.append(lotion_decoupled(fmt, lam, bs,
                                      policy=QuantPolicy(min_size=256)))
    return chain(*links, core.transform)


def _opt_state_leaves(st):
    """Moments of a chain state (tuple of link states) or a fused state."""
    if isinstance(st, (tuple, list)):
        out = {}
        for s in st:
            out.update(_opt_state_leaves(s))
        return out
    return {k: v for k, v in st.items() if k in ("mu", "nu", "count")}


def test_bias_corrections_agree_at_the_counts_used():
    c = np.arange(1, 4, dtype=np.float32)
    for b in (0.9, 0.95):
        np.testing.assert_array_equal(
            (1 - b ** torch.from_numpy(c)).numpy(),
            np.asarray(1 - b ** jnp.asarray(c)))


@pytest.mark.parametrize("method", ["lotion", "fp32"])
@pytest.mark.parametrize("fmt,bs", [("int4", -1), ("fp4", 64)])
def test_unfused_chain_bitwise_vs_jax(method, fmt, bs):
    lam = 1000.0 if method == "lotion" else 0.0
    jq = JQuantConfig(method=method, fmt_name=fmt, lam=lam, block_size=bs,
                      policy=JPolicy(min_size=256), use_kernel=False)
    jtx = j_make_optimizer(JTrainConfig(quant=jq, clip_norm=float("inf")),
                           j_adamw(j_constant(LR), weight_decay=0.01))
    ttx = _chain(fmt, lam, bs, adamw(constant(LR), weight_decay=0.01))
    assert ttx.links is not None and len(ttx.links) == len(jtx.links)
    jp, jst = _run_jax(jtx)
    tp, tst = _run_torch(ttx)
    _assert_trees_equal(tp, jp)
    js, ts = _opt_state_leaves(jst), _opt_state_leaves(tst)
    _assert_trees_equal(ts, js)
    if method == "lotion":
        np.testing.assert_allclose(float(tst[1]["penalty"]),
                                   float(jst[1]["penalty"]), rtol=1e-6)


@pytest.mark.parametrize("fmt,bs", [("int4", -1), ("int8", 128),
                                    ("fp4", -1)])
def test_fused_adamw_core_bitwise_vs_jax(fmt, bs):
    kw = dict(weight_decay=0.01, fmt_name=fmt, lam=2000.0, block_size=bs,
              clip_norm=float("inf"))
    jtx = j_fused_adamw(j_constant(LR), policy=JPolicy(min_size=256),
                        use_kernel=False, **kw)
    ttx = fused_lotion_adamw_core(constant(LR),
                                  policy=QuantPolicy(min_size=256), **kw)
    jp, jst = _run_jax(jtx)
    tp, tst = _run_torch(ttx)
    _assert_trees_equal(tp, jp)
    _assert_trees_equal(_opt_state_leaves(tst), _opt_state_leaves(jst))
    np.testing.assert_allclose(float(tst["penalty"]),
                               float(jst["penalty"]), rtol=1e-6)
    np.testing.assert_allclose(float(tst["gnorm"]), float(jst["gnorm"]),
                               rtol=1e-6)


@pytest.mark.parametrize("momentum,fd,lam", [(0.0, None, 0.0),
                                             (0.9, 0.99, 500.0)])
def test_sgd_chain_and_fused_bitwise_vs_jax(momentum, fd, lam):
    pol, tpol = JPolicy(min_size=256), QuantPolicy(min_size=256)
    jq = JQuantConfig(method="lotion", lam=lam, policy=pol, use_kernel=False)
    jtx = j_make_optimizer(JTrainConfig(quant=jq, clip_norm=float("inf")),
                           j_sgd(j_constant(0.05), momentum, fd))
    jp, _ = _run_jax(jtx)
    tp, _ = _run_torch(_chain("int4", lam, -1,
                              sgd(constant(0.05), momentum, fd)))
    _assert_trees_equal(tp, jp)
    kw = dict(fmt_name="int4", lam=lam, clip_norm=float("inf"))
    jp, _ = _run_jax(j_fused_sgd(j_constant(0.05), momentum, fd, policy=pol,
                                 use_kernel=False, **kw))
    tq = QuantConfig(method="lotion", lam=lam, policy=tpol)
    ttx = make_optimizer(TrainConfig(quant=tq, clip_norm=float("inf")),
                         sgd(constant(0.05), momentum, fd))
    assert ttx.applies_updates and ttx.meta["kind"] == "fused_lotion_sgd"
    for tx in (ttx, fused_lotion_sgd_core(constant(0.05), momentum, fd,
                                          policy=tpol, **kw)):
        tp, _ = _run_torch(tx)
        _assert_trees_equal(tp, jp)


def test_clipping_on_matches_jax_closely():
    """JAX's unfused chain against the port's chain and its fused core
    (what ``make_optimizer`` builds for AdamW)."""
    jq = JQuantConfig(method="lotion", lam=1000.0,
                      policy=JPolicy(min_size=256), use_kernel=False)
    tq = QuantConfig(method="lotion", lam=1000.0,
                     policy=QuantPolicy(min_size=256))
    jtx = j_make_optimizer(JTrainConfig(quant=jq, clip_norm=0.1),
                           j_adamw(j_constant(LR)))
    jp, jst = _run_jax(jtx)
    fused = make_optimizer(TrainConfig(quant=tq, clip_norm=0.1),
                           adamw(constant(LR)))
    assert fused.applies_updates
    for ttx in (_chain("int4", 1000.0, -1, adamw(constant(LR)), 0.1), fused):
        tp, tst = _run_torch(ttx)
        gnorm = tst["gnorm"] if ttx.applies_updates else tst[0]["gnorm"]
        np.testing.assert_allclose(float(gnorm), float(jst[0]["gnorm"]),
                                   rtol=1e-6)
        for k, v in bridge.flatten(jax.tree.map(np.asarray, jp)).items():
            np.testing.assert_allclose(bridge.flatten(tp)[k].numpy(), v,
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_clip_and_global_norm_match_jax():
    g = _grads(0)
    jn = jclip.global_norm(jax.tree.map(jnp.asarray, g))
    tn = clip.global_norm(bridge.to_torch(g))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for max_norm in (float("inf"), 0.3, 1e6):
        js = jclip.clip_scale(jn, max_norm)
        ts = clip.clip_scale(torch.tensor(float(jn)), max_norm)
        assert float(ts) == float(js)
    assert float(clip.clip_scale(torch.tensor(5.0), float("inf"))) == 1.0


def test_schedules_match_jax():
    steps = np.arange(0, 40, dtype=np.int32)
    t = torch.from_numpy(steps)
    for jf, tf in ((j_constant(3e-3), constant(3e-3)),
                   (j_warmup(3e-3, 7), linear_warmup(3e-3, 7))):
        np.testing.assert_array_equal(tf(t).numpy() * np.ones(len(steps)),
                                      np.asarray(jf(jnp.asarray(steps)))
                                      * np.ones(len(steps)))
    jv = np.asarray(j_cosine(3e-3, 5, 30)(jnp.asarray(steps)))
    tv = cosine_with_warmup(3e-3, 5, 30)(t).numpy()
    np.testing.assert_allclose(tv, jv, rtol=2.5e-7, atol=0)


def test_make_optimizer_rules():
    base = adamw(constant(LR))
    q = QuantConfig(method="lotion", lam=10.0)
    fused = make_optimizer(TrainConfig(quant=q), base)
    assert fused.applies_updates and fused.meta["lam"] == 10.0
    loss_side = make_optimizer(
        TrainConfig(quant=q, penalty_placement="loss"), base)
    assert loss_side.applies_updates and loss_side.meta["lam"] == 0.0
    # a pre-built fused core must agree with the train config
    assert make_optimizer(TrainConfig(quant=q), fused) is fused
    with pytest.raises(ValueError, match="clip_norm"):
        make_optimizer(TrainConfig(quant=q, clip_norm=2.0), fused)
    # a pre-assembled chain passes through if its penalty link agrees
    ch = _chain("int4", 10.0, -1, base)
    assert make_optimizer(TrainConfig(quant=q), ch) is ch
    with pytest.raises(ValueError, match="lotion_decoupled"):
        make_optimizer(TrainConfig(quant=q),
                       chain(clip_global_norm(1.0), base.transform))
    with pytest.raises(ValueError, match="double-counted"):
        make_optimizer(
            TrainConfig(quant=q, penalty_placement="loss"),
            chain(lotion_decoupled("int4", 10.0), base.transform))
    # SGD without a Fisher EMA cannot weight LOTION: stays unfused
    plain_sgd = make_optimizer(TrainConfig(quant=q), sgd(constant(0.1)))
    assert not plain_sgd.applies_updates
    assert [t.tag for t in plain_sgd.links][1:] == ["lotion_decoupled",
                                                    "sgd_core"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        QuantConfig(method="qat")
