"""The paper's baselines in the port against the JAX package on the CPU:
QAT and RAT training through the straight-through estimators (with
``act_fmt`` activations and with microbatches), the fused optimizer core
at lam = 0 that carries them, and serving the weights they train: the
RR cast into QTensor storage and the dense-cast path.

Weights come from the JAX ``lm_init`` through ``bridge``; batches are the
JAX ``lm_batch`` output; RAT and the RR casts are fed the uniforms JAX
draws (per step ``fold_in(PRNGKey(seed), step)``, then per eligible leaf
``fold_in(., i)`` in JAX's tree order).  Tolerances: the per-step loss,
CE and gradient norm and the eval CE with fp32, RTN and RR weights within
1e-4 relative, as ``test_torch_train.py`` holds LOTION (fp32 summation
order, moved through Adam's first steps); the RR QTensor codes and
scales and the dense casts bitwise.  RAT with int8 activations is held
on its first step only (1e-6): after it, Adam's first update of the few
elements whose gradient is below eps differs between the frameworks, and
the RR cast and the int8 activation codes amplify that past 1e-4 within
three steps.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantPolicy as JPolicy
from repro.core import cast_params as j_cast_params
from repro.core import get_format as j_get_format
from repro.core import quantize_params as j_quantize_params
from repro.data import lm_batch as j_lm_batch
from repro.data import permutation_table as j_perm
from repro.models import lm as jlm
from repro.optim import adamw as j_adamw
from repro.optim import cosine_with_warmup as j_cosine
from repro.serve import ServeConfig as JServeConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_state as j_init_state
from repro.train import make_eval_fn as j_make_eval_fn
from repro.train import make_optimizer as j_make_optimizer
from repro.train import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.core import dequantize_params, quantize_params
from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels.quant import quant_rr
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.serve import ServeConfig, prepare_params
from repro_torch.train import (TrainConfig, init_state, make_eval_fn,
                               make_optimizer, make_train_step)
from repro_torch.train import loop as tloop

JCFG = j_smoke("granite-3-2b")
RTOL = 1e-4
STEPS = 3
SEED = 5


def _key_path(path):
    return "/".join(str(p.key) for p in path).lower()


def _jax_leaf_uniforms(jparams, key, policy, fmt="int4", bs=-1,
                       stored=False):
    """The uniforms JAX draws for eligible leaf i (JAX's tree order, from
    1) from fold_in(key, i), keyed by path, in the leaf's shape.  With
    ``stored`` (``quantize_params``) a leaf that becomes a QTensor is drawn
    in its stored (transposed, except ``embed``) shape; blockwise casts
    draw in the padded block shape, cut back to the leaf's size."""
    from repro.core.qtensor import _NATURAL_LEAVES, _convertible
    from repro.core.quantize import _block_view
    out, counter = {}, [0]

    def leaf(path, x):
        if policy.eligible(path, x):
            counter[0] += 1
            p = _key_path(path)
            last = p.rsplit("/", 1)[-1]
            if stored and _convertible(last, x, j_get_format(fmt), bs) \
                    and last not in _NATURAL_LEAVES:
                x = jax.numpy.swapaxes(x, -1, -2)
            blocked = x if bs == -1 else _block_view(x, bs)[0]
            u = np.array(jax.random.uniform(
                jax.random.fold_in(key, counter[0]), blocked.shape, x.dtype))
            out[p] = torch.from_numpy(u.reshape(-1)[: x.size].reshape(x.shape))
        return x

    jax.tree_util.tree_map_with_path(leaf, jparams)
    return out


@functools.lru_cache(maxsize=None)
def _jax_init():
    return jlm.lm_init(jax.random.PRNGKey(0), JCFG)


def _tparams():
    return bridge.to_torch(jax.tree.map(np.asarray, _jax_init()))


@functools.lru_cache(maxsize=None)
def _jbatches(n=STEPS, b=4, l=32):
    perm = j_perm(0, JCFG.vocab)
    return tuple(j_lm_batch(0, s, b, l, JCFG.vocab, perm) for s in range(n))


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _configs(method, n_micro):
    kw = dict(method=method, fmt_name="int4")
    return (JTrainConfig(quant=JQuantConfig(policy=JPolicy(min_size=256),
                                            **kw),
                         clip_norm=1.0, n_microbatches=n_micro, seed=SEED),
            TrainConfig(quant=QuantConfig(policy=QuantPolicy(min_size=256),
                                          **kw),
                        clip_norm=1.0, n_microbatches=n_micro, seed=SEED))


def _rat_uniforms(step):
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    return _jax_leaf_uniforms(_jax_init(), rng, JPolicy(min_size=256))


@functools.lru_cache(maxsize=None)
def _jax_run(method, n_micro, act_fmt):
    jcfg = dataclasses.replace(JCFG, act_fmt=act_fmt)
    jt, _ = _configs(method, n_micro)
    tx = j_make_optimizer(jt, j_adamw(j_cosine(3e-3, 2, 10)))
    step = jax.jit(j_make_train_step(jcfg, jt, tx))
    st = j_init_state(_jax_init(), tx)
    metrics = []
    for b in _jbatches():
        st, m = step(st, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return st, metrics


def _torch_run(method, n_micro, act_fmt, rat_uniforms=_rat_uniforms):
    tcfg = dataclasses.replace(bridge.lm_config(JCFG), act_fmt=act_fmt)
    _, tt = _configs(method, n_micro)
    tx = make_optimizer(tt, adamw(cosine_with_warmup(3e-3, 2, 10)))
    step = make_train_step(tcfg, tt, tx, rat_uniforms=rat_uniforms)
    st = init_state(_tparams(), tx)
    metrics = []
    for b in _jbatches():
        st, m = step(st, _tb(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return tcfg, st, metrics, tx


@pytest.mark.parametrize("method,n_micro,act_fmt", [
    ("qat", 1, None), ("rat", 1, None), ("qat", 1, "int8"),
    ("qat", 2, None), ("rat", 2, None)])
def test_three_baseline_steps_and_eval_match_jax(method, n_micro, act_fmt):
    jst, jm = _jax_run(method, n_micro, act_fmt)
    tcfg, tst, tm, tx = _torch_run(method, n_micro, act_fmt)
    assert tx.applies_updates and tx.meta["lam"] == 0.0
    for t, j in zip(tm, jm):
        for k in ("loss", "ce", "grad_norm"):
            assert _rel(t[k], j[k]) <= RTOL, (k, t[k], j[k])
        assert not t["skipped"] and "penalty" not in t
    jq_, _ = _configs(method, n_micro)
    tq = QuantConfig(method=method, policy=QuantPolicy(min_size=256))
    jcfg = dataclasses.replace(JCFG, act_fmt=act_fmt)
    val = j_lm_batch(99, 10 ** 6, 4, 32, JCFG.vocab, j_perm(0, JCFG.vocab))
    jev, tev = j_make_eval_fn(jcfg, jq_.quant), make_eval_fn(tcfg, tq)
    key = jax.random.PRNGKey(1)
    uniforms = _jax_leaf_uniforms(jst["params"], key, jq_.quant.policy)
    for mode, kw, jkw in (("fp32", {}, {}), ("rtn", {}, {}),
                          ("rr", {"uniforms": uniforms}, {"key": key})):
        j = float(jev(jst["params"], val, mode, **jkw))
        t = float(tev(tst["params"], _tb(val), mode, **kw))
        assert _rel(t, j) <= RTOL, (mode, t, j)


def test_rat_with_int8_activations_first_step_matches_jax():
    _, jm = _jax_run("rat", 2, "int8")
    _, _, tm, _ = _torch_run("rat", 2, "int8")
    for k in ("loss", "ce", "grad_norm"):
        assert _rel(tm[0][k], jm[0][k]) <= 1e-6, (k, tm[0][k], jm[0][k])


def test_rat_microbatches_share_one_cast():
    """From the generator: two microbatches of a RAT step see the cast of
    one draw (the loss equals the one-microbatch loss to rounding); with a
    generator that is not re-seeded per microbatch they would not."""
    runs = {}
    for n in (1, 2):
        _, _, m, _ = _torch_run("rat", n, None, rat_uniforms=None)
        runs[n] = m
    for a, b in zip(runs[1], runs[2]):
        assert _rel(b["loss"], a["loss"]) <= 1e-6
    g1 = tloop.step_generator(SEED, 4, "cpu")
    g2 = tloop.step_generator(SEED, 4, "cpu")
    assert torch.equal(torch.rand(5, generator=g1), torch.rand(5, generator=g2))
    assert not torch.equal(
        torch.rand(5, generator=tloop.step_generator(SEED, 5, "cpu")),
        torch.rand(5, generator=tloop.step_generator(SEED, 4, "cpu")))


def test_make_optimizer_fuses_the_baselines_at_lam_zero():
    for method in ("qat", "rat", "ptq", "fp32"):
        _, tt = _configs(method, 1)
        tx = make_optimizer(tt, adamw(cosine_with_warmup(3e-3, 2, 10)))
        assert tx.applies_updates and tx.meta["lam"] == 0.0


# ---- serving what the baselines train --------------------------------------

SERVE_POLICY = dict(min_size=256)


@pytest.mark.parametrize("fmt,bs", [("int4", -1), ("int8", -1),
                                    ("int8", 32)])
def test_quantize_params_rr_matches_jax(fmt, bs):
    """RR in the stored orientation, re-quantized into QTensors: codes and
    scales bitwise, and the dequantized tree equals the dense RR cast of
    the same uniforms bitwise."""
    jparams, tparams = _jax_init(), _tparams()
    jpol, tpol = JPolicy(**SERVE_POLICY), QuantPolicy(**SERVE_POLICY)
    key = jax.random.PRNGKey(2)
    want = bridge.flatten(bridge.to_numpy(bridge.to_torch(jax.tree.map(
        np.asarray, j_quantize_params(jparams, fmt, jpol, bs, mode="rr",
                                      key=key)))))
    u = _jax_leaf_uniforms(jparams, key, jpol, fmt, bs, stored=True)
    got = quantize_params(tparams, fmt, tpol, bs, mode="rr", uniforms=u)
    flat = bridge.flatten(bridge.to_numpy(got))
    assert set(flat) == set(want)
    n_qt = 0
    for path, t in flat.items():
        if isinstance(t, dict):
            n_qt += 1
            for f in ("codes", "scales"):
                np.testing.assert_array_equal(t[f], want[path][f])
        else:
            np.testing.assert_array_equal(t, want[path])
    assert n_qt == 7
    # re-quantizing is the identity: the dequantized tree is the dense RR
    # cast of the same uniforms in the stored orientation, transposed back
    dense = bridge.flatten(dequantize_params(got))
    for path, x in bridge.flatten(tparams).items():
        if path in u:
            stored = x.transpose(-1, -2).contiguous()
            cast = quant_rr(stored, u[path], fmt, bs).transpose(-1, -2)
            assert torch.equal(dense[path], cast), path


@pytest.mark.parametrize("weights,storage", [
    ("rtn:fp4", None), ("rtn:int4", False), ("rr:int4", False),
    ("rr:fp4", None)])
def test_dense_cast_prepare_params_matches_jax(weights, storage):
    """``quantized_storage=False`` and formats without QTensor storage:
    the dense RTN/RR cast of ``cast_params``, bitwise."""
    jparams, tparams = _jax_init(), _tparams()
    pol = dict(min_size=256)
    jscfg = JServeConfig(weights=weights, quantized_storage=storage,
                         policy=JPolicy(**pol), seed=4)
    tscfg = ServeConfig(weights=weights, quantized_storage=storage,
                        policy=QuantPolicy(**pol), seed=4)
    from repro.serve.engine import prepare_params as j_prepare
    want = bridge.flatten(jax.tree.map(np.asarray,
                                       j_prepare(jparams, jscfg)))
    u = None
    if weights.startswith("rr"):
        u = _jax_leaf_uniforms(jparams, jax.random.PRNGKey(4),
                               JPolicy(**pol))
    got = bridge.flatten(prepare_params(tparams, tscfg, "cpu", uniforms=u))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[path])
    mode, fmt = weights.split(":")
    ref = bridge.flatten(jax.tree.map(np.asarray, j_cast_params(
        jparams, j_get_format(fmt), JPolicy(**pol), -1, mode=mode,
        key=jax.random.PRNGKey(4))))
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), ref[path])


def test_drivers_run_on_the_cpu_and_import_no_jax():
    """``examples/quickstart_torch.py`` and ``scripts/lm_quant_torch.py``
    at a few steps on the CPU (their plain paths)."""
    import ast
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    mods = {}
    for rel in ("examples/quickstart_torch.py", "scripts/lm_quant_torch.py"):
        path = root / rel
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert all(n.split(".")[0] not in ("jax", "repro")
                           for n in names), (rel, names)
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mods[rel] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[rel])
    table = mods["examples/quickstart_torch.py"].main(
        ["--device", "cpu", "--steps", "2"])
    assert set(table) == {"lotion", "qat", "ptq"}
    assert mods["scripts/lm_quant_torch.py"].main(
        ["--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
         "--val-batch", "4", "--fmts", "int4"]) == 0
