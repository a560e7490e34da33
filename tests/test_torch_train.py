"""The port's training slice (model loss, train step, eval, data, driver
loop, example) against the JAX package on the CPU.

Weights come from the JAX ``lm_init`` through ``bridge``; batches are the
JAX ``lm_batch`` output.  Tolerances: per-step loss and gradient norm,
and the eval CE with fp32, RTN and RR weights (RR fed the uniforms JAX
draws) agree with JAX within 1e-5 relative: fp32 matmuls and reductions
sum in another order in XLA and torch.  The penalty agrees within 1e-4:
Adam's update of an element whose gradient is near eps differs by up to
a percent of a step between the two, and where that element is its
matrix's absmax it moves the per-tensor scale, and with it every bracket
of the matrix (measured: 1.9e-5 at the third step of the smoke run).
Inside the port, DESIGN.md §2's window holds bitwise: with clip=inf and
one microbatch the loss-side placement (the ``lotion_reg`` autograd
function, then the fused core at lam = 0) and the decoupled one (the fused
core with the penalty) give bit-identical parameters.
"""

import ast
import dataclasses
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantPolicy as JPolicy
from repro.data import lm_batch as j_lm_batch
from repro.data import markov_ce_floor as j_ce_floor
from repro.data import permutation_table as j_perm
from repro.models import lm as jlm
from repro.optim import adamw as j_adamw
from repro.optim import cosine_with_warmup as j_cosine
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_state as j_init_state
from repro.train import make_eval_fn as j_make_eval_fn
from repro.train import make_optimizer as j_make_optimizer
from repro.train import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import (DataPipeline, lm_batch, markov_ce_floor,
                              permutation_table)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import lm as tlm
from repro_torch.optim import (adamw, chain, clip_global_norm, constant,
                               cosine_with_warmup, lotion_decoupled)
from repro_torch.train import (NonFiniteBudgetError, TrainConfig, init_state,
                               make_eval_fn, make_optimizer, make_train_step,
                               run_loop)
from repro_torch.train.loop import make_loss_fn

ROOT = Path(__file__).resolve().parents[1]
JCFG = j_smoke("granite-3-2b")
TCFG = bridge.lm_config(JCFG)
RTOL = 1e-5
PENALTY_RTOL = 1e-4
STEPS = 3


@functools.lru_cache(maxsize=None)
def _jax_init():
    return jlm.lm_init(jax.random.PRNGKey(0), JCFG)


def _tparams():
    return bridge.to_torch(jax.tree.map(np.asarray, _jax_init()))


@functools.lru_cache(maxsize=None)
def _jbatches(n=STEPS, b=4, l=32, seed=0):
    perm = j_perm(0, JCFG.vocab)
    return tuple(j_lm_batch(seed, s, b, l, JCFG.vocab, perm)
                 for s in range(n))


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


def _rel(a, b):
    a, b = (x.detach() if torch.is_tensor(x) else x for x in (a, b))
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _configs(placement="decoupled", n_micro=1, lam=1000.0):
    kw = dict(method="lotion", fmt_name="int4", lam=lam,
              penalty_placement=placement)
    jq_ = JQuantConfig(policy=JPolicy(min_size=256), **kw)
    tq = QuantConfig(policy=QuantPolicy(min_size=256), **kw)
    return (JTrainConfig(quant=jq_, clip_norm=1.0, n_microbatches=n_micro),
            TrainConfig(quant=tq, clip_norm=1.0, n_microbatches=n_micro))


@functools.lru_cache(maxsize=None)
def _jax_run(placement="decoupled", n_micro=1):
    jt, _ = _configs(placement, n_micro=n_micro)
    tx = j_make_optimizer(jt, j_adamw(j_cosine(3e-3, 2, 10)))
    step = jax.jit(j_make_train_step(JCFG, jt, tx))
    st = j_init_state(_jax_init(), tx)
    metrics = []
    for b in _jbatches():
        st, m = step(st, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return st, metrics


def _optimizer(tt, base, fused=True):
    """What ``make_optimizer`` builds (the fused core), or the unfused
    ``clip -> [lotion_decoupled] -> adamw_core`` chain built link by link
    and passed through it."""
    if fused:
        return make_optimizer(tt, base)
    q = tt.quant
    links = [clip_global_norm(tt.clip_norm)]
    if tt.placement == "decoupled":
        links.append(lotion_decoupled(q.fmt_name, q.lam, q.block_size,
                                      policy=q.policy))
    return make_optimizer(tt, chain(*links, base.transform))


def _torch_run(placement="decoupled", fused=True, n_micro=1):
    _, tt = _configs(placement, n_micro)
    tx = _optimizer(tt, adamw(cosine_with_warmup(3e-3, 2, 10)), fused)
    step = make_train_step(TCFG, tt, tx)
    st = init_state(_tparams(), tx)
    metrics = []
    for b in _jbatches():
        st, m = step(st, _tb(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return st, metrics, tx


def _check_metrics(tm, jm):
    for t, j in zip(tm, jm):
        for k in ("loss", "ce", "grad_norm"):
            assert _rel(t[k], j[k]) <= RTOL, (k, t[k], j[k])
        assert _rel(t["penalty"], j["penalty"]) <= PENALTY_RTOL
        assert not t["skipped"]


def _jax_rr_uniforms(jparams, key, policy):
    """The per-leaf uniforms JAX's cast_params(mode="rr") draws with
    per-tensor scales, keyed by path (eligible leaves counted from 1 in
    JAX's tree order)."""
    out, counter = {}, [0]

    def leaf(path, x):
        if policy.eligible(path, x):
            counter[0] += 1
            u = jax.random.uniform(jax.random.fold_in(key, counter[0]),
                                   x.shape, dtype=x.dtype)
            out["/".join(str(p.key) for p in path).lower()] = \
                torch.from_numpy(np.array(u))
        return x

    jax.tree_util.tree_map_with_path(leaf, jparams)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_three_lotion_steps_and_eval_match_jax(fused):
    """Granite smoke config, fp32, decoupled placement: the unfused chain
    and the fused core (on their plain paths) both follow JAX's run; then
    the eval CE with fp32, RTN and RR weights."""
    jst, jm = _jax_run()
    tst, tm, tx = _torch_run(fused=fused)
    assert tx.applies_updates == fused
    _check_metrics(tm, jm)
    assert jm[-1]["penalty"] > 0.0
    val = j_lm_batch(99, 10 ** 6, 4, 32, JCFG.vocab, j_perm(0, JCFG.vocab))
    jq_, tq = _configs()[0].quant, _configs()[1].quant
    jev, tev = j_make_eval_fn(JCFG, jq_), make_eval_fn(TCFG, tq)
    key = jax.random.PRNGKey(1)
    uniforms = _jax_rr_uniforms(jst["params"], key, jq_.policy)
    assert len(uniforms) == 7
    for mode, kw, jkw in (("fp32", {}, {}), ("rtn", {}, {}),
                          ("rr", {"uniforms": uniforms}, {"key": key})):
        j = float(jev(jst["params"], val, mode, **jkw))
        t = float(tev(tst["params"], _tb(val), mode, **kw))
        assert _rel(t, j) <= RTOL, (mode, t, j)


def test_loss_placement_matches_jax():
    """Loss-side penalty (the lotion_reg autograd function on its plain
    path) before the fused core at lam=0 and before the unfused chain."""
    _, jm = _jax_run("loss")
    for fused in (False, True):
        _, tm, tx = _torch_run("loss", fused)
        _check_metrics(tm, jm)
        if fused:
            assert tx.applies_updates and tx.meta["lam"] == 0.0


def test_microbatches_match_jax():
    _, jm = _jax_run(n_micro=2)
    _, tm, _ = _torch_run(n_micro=2)
    _check_metrics(tm, jm)


def test_loss_vs_decoupled_bit_identical():
    """DESIGN.md §2's window inside the port: with clip_norm=inf and one
    microbatch the decoupled placement gives bit-identical parameters to
    the loss-side one, over several steps (so the Fisher is non-zero and
    the penalty bites), with the fused core and with the unfused chain."""
    for fused in (True, False):
        out = {}
        for placement in ("loss", "decoupled"):
            q = QuantConfig(method="lotion", fmt_name="int4", lam=100.0,
                            policy=QuantPolicy(min_size=256),
                            penalty_placement=placement)
            tc = TrainConfig(quant=q, clip_norm=float("inf"))
            tx = _optimizer(tc, adamw(constant(1e-3)), fused)
            step = make_train_step(TCFG, tc, tx)
            st = init_state(_tparams(), tx)
            for b in _jbatches(4, 8, 32):
                st, m = step(st, _tb(b))
            out[placement] = (st, m)
        (sl, ml), (sd, md) = out["loss"], out["decoupled"]
        for k, v in bridge.flatten(sl["params"]).items():
            assert torch.equal(v, bridge.flatten(sd["params"])[k]), (fused, k)
        assert _rel(ml["penalty"], md["penalty"]) <= 1e-6
        assert _rel(ml["loss"], md["loss"]) <= 1e-6
        assert float(md["penalty"]) > 0.0


@pytest.mark.parametrize("fused", [False, True])
def test_nonfinite_step_applies_no_update(fused):
    _, tt = _configs()
    tx = _optimizer(tt, adamw(constant(1e-3)), fused)
    inner = make_loss_fn(TCFG, tt)
    poison = {"on": False}

    def loss_fn(params, batch, fisher):
        loss, aux = inner(params, batch, fisher)
        return (loss * float("nan"), aux) if poison["on"] else (loss, aux)

    step = make_train_step(TCFG, tt, tx, loss_fn=loss_fn)
    st = init_state(_tparams(), tx)
    st, _ = step(st, _tb(_jbatches()[0]))
    before = {k: v.clone() for k, v in bridge.flatten(
        {"p": st["params"], "o": _flat_opt(st["opt"])}).items()}
    poison["on"] = True
    st, m = step(st, _tb(_jbatches()[1]))
    assert bool(m["skipped"])
    after = bridge.flatten({"p": st["params"], "o": _flat_opt(st["opt"])})
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    poison["on"] = False
    st, m = step(st, _tb(_jbatches()[1]))
    assert not bool(m["skipped"])


def _flat_opt(opt):
    if isinstance(opt, (tuple, list)):
        return {str(i): _flat_opt(s) for i, s in enumerate(opt)}
    return opt


def test_lm_loss_per_example_and_remat_match():
    params = _tparams()
    b = _jbatches()[0]
    jce, jex = jlm.lm_loss(_jax_init(), JCFG, b["tokens"], b["labels"],
                           per_example=True)
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(TCFG, remat=remat)
        p = {k: v for k, v in params.items()}
        leaves = []

        def req(x):
            x = x.detach().requires_grad_(True)
            leaves.append(x)
            return x

        p = _map(req, p)
        ce, ex = tlm.lm_loss(p, cfg, *_tb(b).values(), per_example=True)
        assert _rel(ce, jce) <= RTOL
        np.testing.assert_allclose(ex.detach().numpy(), np.asarray(jex),
                                   rtol=RTOL)
        grads[remat] = torch.autograd.grad(ce, leaves)
    for a, c in zip(grads[False], grads[True]):
        assert torch.equal(a, c)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def test_unbind_views_give_the_indexing_gradient():
    params = _tparams()
    w = params["stage"]["b0_attn"]["mlp"]["w_up"].detach().requires_grad_()
    views = tlm.unbind_stage({"w": w})
    assert len(views) == TCFG.n_repeats
    sum((v["w"] * (i + 1)).sum() for i, v in enumerate(views)).backward()
    want = torch.stack([torch.full_like(w[0], i + 1.0)
                        for i in range(w.shape[0])])
    assert torch.equal(w.grad, want)


def test_data_stream_is_deterministic_and_seekable():
    perm = permutation_table(0, 131)
    assert sorted(perm.tolist()) == list(range(131))
    a = lm_batch(0, 5, 4, 16, 131, perm)
    b = lm_batch(0, 5, 4, 16, 131, perm)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (4, 16) and a["labels"].shape == (4, 16)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"], lm_batch(0, 6, 4, 16, 131,
                                                 perm)["tokens"])
    assert markov_ce_floor(131, 0.2) == pytest.approx(j_ce_floor(131, 0.2),
                                                      rel=1e-12)
    pipe = DataPipeline(lambda s: lm_batch(0, s, 2, 8, 131, perm))
    first = [next(pipe)["tokens"] for _ in range(3)]
    pipe.seek(1)
    assert torch.equal(next(pipe)["tokens"], first[1])
    pipe.close()


def test_pipeline_reraises_worker_errors_in_order():
    def batch_fn(s):
        if s == 2:
            raise RuntimeError("bad step 2")
        return {"x": torch.tensor([s])}

    pipe = DataPipeline(batch_fn, prefetch=2)
    assert [int(next(pipe)["x"]) for _ in range(2)] == [0, 1]
    with pytest.raises(RuntimeError, match="bad step 2"):
        next(pipe)
    pipe.seek(3)
    assert int(next(pipe)["x"]) == 3
    pipe.close()


def test_run_loop_counts_and_skip_budget():
    _, tt = _configs()
    tx = make_optimizer(tt, adamw(constant(1e-3)))
    perm = permutation_table(0, TCFG.vocab)
    reset_launch_counts()
    out = run_loop(make_train_step(TCFG, tt, tx), init_state(_tparams(), tx),
                   DataPipeline(lambda s: lm_batch(0, s, 2, 16, TCFG.vocab,
                                                   perm)),
                   4, log=lambda *_: None, eval_every=2,
                   eval_hook=lambda st: int(st["step"]))
    assert int(out["state"]["step"]) == 4 and out["skipped"] == 0
    assert [h[1] for h in out["history"]] == [2, 4]
    assert set(launch_counts().values()) == {0}   # CPU: plain paths only

    inner = make_loss_fn(TCFG, tt)

    def nan_loss(params, batch, fisher):
        loss, aux = inner(params, batch, fisher)
        return loss * float("nan"), aux

    with pytest.raises(NonFiniteBudgetError):
        run_loop(make_train_step(TCFG, tt, tx, loss_fn=nan_loss),
                 init_state(_tparams(), tx),
                 DataPipeline(lambda s: lm_batch(0, s, 2, 16, TCFG.vocab,
                                                 perm)),
                 10, log=lambda *_: None, max_skips=2)


def test_features_outside_the_slice_raise():
    """Streaming attention and the chunked head are ported now (held to
    JAX in test_torch_streaming.py), and so is the MoE FFN (trained on
    the CPU in test_torch_archs.py), and so are the SSM blocks and the
    shared zamba block (test_torch_ssm.py), and cross-attention
    (test_torch_xattn.py): a model with image tokens or a cross layer
    and no image embeddings raises a ValueError that names them (JAX's
    fails with an AttributeError there)."""
    params = _tparams()
    toks = torch.zeros(1, 8, dtype=torch.long)
    with torch.no_grad():
        full = tlm.lm_loss(params, TCFG, toks, toks)
        chunked = tlm.lm_loss(params, TCFG, toks, toks, attn_chunk=4,
                              logit_chunk=4)
    assert _rel(chunked, full) <= RTOL
    for bad in (dict(n_image_tokens=4, d_vision=8), dict(pattern=("xattn",))):
        cfg = dataclasses.replace(TCFG, **bad)
        with pytest.raises(ValueError, match=r"image_embeds|ctx=None"):
            tlm.lm_forward(tlm.lm_init(cfg, 0, "cpu"), cfg, toks)


def test_example_trains_on_the_cpu_and_imports_no_jax():
    import importlib.util
    path = ROOT / "examples" / "train_lm_torch.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module])
            assert all(n.split(".")[0] not in ("jax", "repro")
                       for n in names), names
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    final = mod.main(["--device", "cpu", "--smoke", "--steps", "6",
                      "--batch", "2", "--seq", "16"])
    assert all(np.isfinite(v) for v in final.values())
