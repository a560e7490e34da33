"""The port's GShard MoE (``models/layers.py::moe_apply``), its serving
paths and the 3-D QTensor matmul against the JAX package on the CPU.

Routing is held exactly: the top-k experts (ties to the lower index, as
``jax.lax.top_k`` takes them), each choice's queue position and whether
it fits the capacity are equal to JAX's, read from JAX's own
``moe_apply`` as it runs.  The output agrees within 1e-6 of its largest
value in fp32 (the combine sums each token's k expert outputs in another
order); logits of whole models within 1e-5; the 3-D QTensor matmul
within 1e-4 in fp32 (JAX's plain version contracts all experts in one
batched matmul, the port one expert at a time), within 2^-7 of its
largest in bf16 (both round an fp32 result to bf16 once, and the
summation order may move it across a rounding boundary).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as jqt
from repro.core.formats import get_format as jget_format
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.core import qtensor as tqt
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serve import Scheduler, SchedulerConfig, ServeConfig
from repro_torch.serve.replay import poisson_workload

OUT_RTOL = 1e-6
LOGIT_RTOL = 1e-5
QT3D_RTOL = 1e-4

# the tests/test_scheduler.py MoE config: capacity 0.6, drops do happen
CFG_TIGHT = jlm.LMConfig(name="moe", n_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=2, d_ff=64, vocab=64, ffn="moe",
                         n_experts=4, top_k=2, capacity_factor=0.6,
                         dtype=jnp.float32, remat=False)
# the tests/test_qtensor.py MoE config
CFG_QT = jlm.LMConfig(name="qt-moe", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab=256, dtype=jnp.float32,
                      remat=False, ffn="moe", n_experts=4, top_k=2)
POLICY = dict(min_size=256, include_embeddings=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@functools.lru_cache(maxsize=None)
def _model(cfg, seed=1):
    jparams = jlm.lm_init(jax.random.PRNGKey(seed), cfg)
    return jparams, bridge.lm_config(cfg)


def _tparams(cfg, seed=1):
    return bridge.to_torch(jax.tree.map(np.asarray, _model(cfg, seed)[0]))


# --------------------------------------------------------------------------
# moe_apply against JAX's, routing exactly
# --------------------------------------------------------------------------

def _jax_moe(monkeypatch, params, spec, x, token_mask=None):
    """JAX's ``moe_apply`` run op by op, with its top-k indices and the
    (keep, pos) pair of its capacity test read as they are made."""
    seen = {}
    top_k, where = jax.lax.top_k, jnp.where

    def spy_top_k(a, k):
        v, i = top_k(a, k)
        seen["topi"] = np.asarray(i)
        return v, i

    def spy_where(cond, *args, **kw):
        out = where(cond, *args, **kw)
        if getattr(cond, "dtype", None) == jnp.bool_ and cond.ndim == 3:
            seen["keep"], seen["pos"] = np.asarray(cond), np.asarray(out)
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jnp, "where", spy_where)
    with jax.disable_jit():
        out, aux = jlayers.moe_apply(
            params, spec, jnp.asarray(x),
            token_mask=None if token_mask is None else jnp.asarray(token_mask))
    monkeypatch.undo()
    return np.asarray(out), {k: float(v) for k, v in aux.items()}, seen


def _moe_params(spec, seed, tie=False):
    p = jlayers.moe_init(jax.random.PRNGKey(seed), spec)
    if tie:
        # experts 1 and 3 repeat experts 0 and 2 in the router: every
        # token's probabilities tie in pairs
        r = np.array(p["router"])
        r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
        p["router"] = jnp.asarray(r)
    return p


CASES = {
    # (spec kwargs, b, l, tie, mask)
    "drops": (dict(capacity_factor=0.6), 2, 16, False, None),
    "drops_masked": (dict(capacity_factor=0.3), 4, 4, False,
                     [True, False, True, False]),
    "ties": (dict(capacity_factor=1.0), 2, 8, True, None),
    "groups_fall_back": (dict(group_size=5, capacity_factor=0.8), 2, 8,
                         False, None),
    "groups_of_4": (dict(group_size=4, top_k=3, capacity_factor=1.0), 2, 8,
                    False, None),
    "geglu": (dict(kind="geglu", capacity_factor=1.25), 2, 6, False, None),
    "gelu": (dict(kind="gelu", capacity_factor=1.25), 2, 6, False, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(monkeypatch, case):
    kw, b, l, tie, mask = CASES[case]
    base = dict(d_model=32, d_ff=48, n_experts=4, top_k=2)
    base.update(kw)
    jspec, tspec = jlayers.MoESpec(**base), tlayers.MoESpec(**base)
    jp = _moe_params(jspec, 3, tie)
    x = np.random.default_rng(4).standard_normal((b, l, 32)).astype(
        np.float32)
    want, jaux, seen = _jax_moe(monkeypatch, jp, jspec, x, mask)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp))
    tx = torch.from_numpy(x)
    tm = None if mask is None else torch.tensor(mask)
    got, taux = tlayers.moe_apply(tp, tspec, tx, token_mask=tm)
    assert _rel(got, want) <= OUT_RTOL, _rel(got, want)
    for k, v in taux.items():
        assert abs(float(v) - jaux[k]) <= 1e-6 * max(abs(jaux[k]), 1.0), k
    g_sz = tlayers.moe_groups(tspec, b, l)
    route = tlayers.moe_route(tp["router"], tspec,
                              tx.reshape(-1, g_sz, 32), b, l, tm)
    np.testing.assert_array_equal(route["topi"].numpy(), seen["topi"])
    np.testing.assert_array_equal(route["keep"].numpy(), seen["keep"])
    np.testing.assert_array_equal(route["pos"].numpy(), seen["pos"])
    if kw.get("capacity_factor", 1.25) < 1.0:
        assert not seen["keep"].all(), "no choice was dropped"
    if tie:
        # each tied pair is taken lower index first
        topi = seen["topi"]
        assert ((topi[..., 0] % 2 == 0) & (topi[..., 1] == topi[..., 0] + 1)
                ).all()
    if mask is not None:
        dead = ~np.broadcast_to(np.asarray(mask)[:, None], (b, l)).reshape(
            -1, g_sz)
        assert (route["onehot"].numpy()[dead] == 0).all()
        assert (got.numpy()[~np.asarray(mask)] == 0).all()


def test_groups_and_capacity_are_jax_arithmetic():
    """Group size (with its fallback to one group per sequence) and the
    per-group capacity ceil(g * k / E * cf), at least k."""
    spec = tlayers.MoESpec(d_model=8, d_ff=8, n_experts=64, top_k=6,
                           group_size=2048, capacity_factor=1.25)
    assert tlayers.moe_groups(spec, 8, 1) == 8
    assert tlayers.moe_groups(spec, 8, 1536) == 2048
    assert tlayers.moe_groups(spec, 3, 1000) == 1000
    x = torch.zeros(1, 8, 8)
    r = tlayers.moe_route(torch.zeros(8, 64), spec, x, 8, 1)
    assert r["cap"] == 6                       # ceil(0.9375) = 1, then k
    r = tlayers.moe_route(torch.zeros(8, 64), spec,
                          torch.zeros(1, 2048, 8), 1, 2048)
    assert r["cap"] == 240


# --------------------------------------------------------------------------
# the model's MoE paths
# --------------------------------------------------------------------------

def test_free_slots_do_not_consume_moe_capacity():
    """Twin of test_scheduler.py's: masked decode rows are excluded from
    expert dispatch, so the live row's logits are bitwise invariant to
    what the dead rows hold, and equal JAX's."""
    jparams, tcfg = _model(CFG_TIGHT)
    params = _tparams(CFG_TIGHT)
    toks = [[3, 1, 4, 1, 5, 9, 2, 6]]
    with torch.no_grad():
        _, row = tlm.lm_prefill(params, tcfg, torch.tensor(toks),
                                cache_len=16)
    _, jrow = jlm.lm_prefill(jparams, CFG_TIGHT, jnp.asarray(toks, jnp.int32),
                             cache_len=16)
    mask = torch.tensor([True, False, False, False])
    pos = torch.zeros(4, dtype=torch.long)
    pos[0] = 7
    outs = []
    for garbage in (0, 17, 63):
        pool = tlm.cache_insert(tlm.init_cache(tcfg, 4, 16,
                                               dtype=torch.float32,
                                               device="cpu"), row, 0)
        tok = torch.full((4,), garbage, dtype=torch.long)
        tok[0] = 11
        with torch.no_grad():
            logits, _ = tlm.lm_decode(params, tcfg, pool, tok[:, None], pos,
                                      token_mask=mask)
        outs.append(logits[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    jpool = jlm.cache_insert(jlm.init_cache(CFG_TIGHT, 4, 16,
                                            dtype=jnp.float32), jrow, 0)
    jtok = jnp.full((4,), 0, jnp.int32).at[0].set(11)
    jlogits, _ = jlm.lm_decode(jparams, CFG_TIGHT, jpool, jtok[:, None],
                               jnp.asarray(pos.numpy(), jnp.int32),
                               token_mask=jnp.asarray(mask.numpy()))
    assert _rel(outs[0], jlogits[0]) <= LOGIT_RTOL
    # the live row in the last slot: queue positions are token-major, so
    # unmasked garbage rows ahead of it take the capacity of the experts
    # they share with it; masked, they take none
    pos, mask = pos.flip(0), mask.flip(0)
    moved = []
    for garbage in (0, 17, 63):
        tok = torch.full((4,), garbage, dtype=torch.long)
        tok[3] = 11
        for m in (mask, None):
            pool = tlm.cache_insert(tlm.init_cache(
                tcfg, 4, 16, dtype=torch.float32, device="cpu"), row, 3)
            with torch.no_grad():
                logits, _ = tlm.lm_decode(params, tcfg, pool, tok[:, None],
                                          pos, token_mask=m)
            if m is None:
                moved.append(not np.array_equal(logits[3].numpy(), outs[0]))
            else:
                assert _rel(logits[3], outs[0]) <= OUT_RTOL
    assert any(moved)


def _serving_logits(cfg, params, toks, l):
    b = toks.shape[0]
    with torch.no_grad():
        lg, cache = tlm.lm_prefill(params, cfg, toks, cache_len=l + 2)
        ld, _ = tlm.lm_decode(params, cfg, cache, toks[:, -1:],
                              torch.full((b,), l - 1, dtype=torch.long))
    return lg.numpy(), ld.numpy()


def test_serving_parity_moe():
    """Twin of test_qtensor.py::test_serving_parity_moe: int4 QTensor
    serving (attention and the untied head as QTensors, the router and
    the 4-D expert stacks as the dense cast) against the dequantized
    tree, and against JAX's QTensor serving, within 1e-5."""
    jparams, tcfg = _model(CFG_QT, 0)
    qp = tqt.quantize_params(_tparams(CFG_QT, 0), "int4",
                             QuantPolicy(**POLICY), -1)
    assert isinstance(qp["stage"]["b0_attn"]["attn"]["wq"], tqt.QTensor)
    assert not isinstance(qp["stage"]["b0_attn"]["moe"]["w_up"], tqt.QTensor)
    dp = tqt.dequantize_params(qp)
    b, l = 2, 12
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (b, l), 0,
                                         CFG_QT.vocab))
    tt = torch.from_numpy(toks).long()
    got = _serving_logits(tcfg, qp, tt, l)
    dense = _serving_logits(tcfg, dp, tt, l)
    jqp = jqt.quantize_params(jparams, "int4", JQuantPolicy(**POLICY), -1)
    with jqt.qtensor_use_kernel(False):
        jlg, jcache = jlm.lm_prefill(jqp, CFG_QT, jnp.asarray(toks),
                                     cache_len=l + 2)
        jld, _ = jlm.lm_decode(jqp, CFG_QT, jcache, jnp.asarray(toks[:, -1:]),
                               jnp.full((b,), l - 1, jnp.int32))
    for g, d, j in zip(got, dense, (jlg, jld)):
        assert _rel(g, d) <= LOGIT_RTOL
        assert _rel(g, j) <= LOGIT_RTOL


def test_scheduler_serves_moe_like_jax():
    """The continuous-batching scheduler on the tight MoE config (per-slot
    prefill, token_mask on every decode step, paged int8 KV, fp32
    weights): the same greedy tokens, ticks and counters as JAX's."""
    jparams, tcfg = _model(CFG_TIGHT)
    scfg = dict(max_new_tokens=6, kv_quant="int8")
    sched = dict(n_slots=3, steps_per_tick=2, cache_len=32, paged=True,
                 block_size=8)
    j = JScheduler(CFG_TIGHT, jparams, JServeConfig(**scfg),
                   JSchedulerConfig(**sched))
    t = Scheduler(tcfg, _tparams(CFG_TIGHT), ServeConfig(**scfg),
                  SchedulerConfig(**sched), device="cpu")
    wl = poisson_workload(5, 7, CFG_TIGHT.vocab, rate=100.0,
                          prompt_lens=(2, 9), budgets=(2, 4, 6))
    outs = []
    for s in (j, t):
        rids = [s.submit(list(r.prompt), max_new_tokens=r.max_new_tokens)
                for r in wl]
        s.run()
        outs.append([s.requests[r].out for r in rids])
    assert outs[0] == outs[1] and all(outs[1])
    assert (j.n_ticks, j.n_prefills, dict(j.counters)) == \
        (t.n_ticks, t.n_prefills, dict(t.counters))


def test_scheduler_refuses_chunked_prefill_for_moe():
    """Capacity routing depends on the chunk: both packages refuse
    chunked prefill for an MoE config, with the same reason."""
    jparams, tcfg = _model(CFG_TIGHT)
    sched = dict(n_slots=2, cache_len=32, prefill_chunk=4)
    with pytest.raises(ValueError) as jerr:
        JScheduler(CFG_TIGHT, jparams, JServeConfig(),
                   JSchedulerConfig(**sched))
    with pytest.raises(ValueError) as terr:
        Scheduler(tcfg, _tparams(CFG_TIGHT), ServeConfig(),
                  SchedulerConfig(**sched), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "MoE" in str(terr.value)


# --------------------------------------------------------------------------
# the 3-D QTensor matmul
# --------------------------------------------------------------------------

@pytest.mark.parametrize("act", [None, "int8"])
@pytest.mark.parametrize("block_k", [-1, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_qtensor_3d_matmul_matches_jax(bits, block_k, act):
    """x (E, M, K) against an (E, N, K) expert stack: JAX's plain version
    (one batched contraction) and the port's per-expert calls, with bf16
    and fp32 activations; per-matrix scales also as one (1, 1) scale that
    broadcasts over E."""
    e, m, k, n = 3, 6, 256, 96
    w = jax.random.normal(jax.random.PRNGKey(4), (e, k, n)) * 0.5
    jq = jqt.from_matmul_weight(w, jget_format(f"int{bits}"), block_k)
    shared = block_k == -1
    qts = [jq]
    if shared:
        qts.append(jqt.QTensor(jq.codes, jq.scales[:1, 0], jq.fmt_name,
                               jq.bits, jq.block_k))
    for dtype in (jnp.float32, jnp.bfloat16):
        x = (jax.random.normal(jax.random.PRNGKey(5), (e, m, k))
             ).astype(dtype)
        tx = bridge.to_torch({"x": np.asarray(x)})["x"]
        for q in qts:
            with jqt.qtensor_use_kernel(False), jqt.qtensor_act_fmt(act):
                want = np.asarray(jqt.matmul(x, q).astype(jnp.float32))
            tq = bridge.to_torch({"w": jax.tree.map(np.asarray, q)})["w"]
            with tqt.qtensor_act_fmt(act):
                got = tqt.matmul(tx, tq)
            assert got.dtype == tx.dtype and got.shape == (e, m, n)
            tol = QT3D_RTOL if dtype == jnp.float32 else 2.0 ** -7
            assert _rel(got.float().numpy(), want) <= tol, (dtype, q)
    with pytest.raises(ValueError, match="E, M, K"):
        tqt.matmul(torch.zeros(e + 1, m, k), tq)
