"""The port's SSM blocks (``repro_torch.models.ssm``) and the two SSM
configs it serves (Zamba2-2.7B: Mamba2 with a shared attention block;
RWKV6-1.6B) against the JAX package on the CPU, at small sizes in fp32.

Inputs are numpy draws from a seed; weights come from JAX's ``*_init``
and cross through ``bridge``.  Tolerances, relative to the largest value
compared: 1e-5 for the scans, blocks, logits and cache states (XLA's and
torch's fp32 einsums and exps round differently in the last bits); 1e-4
for gradients (``lm_loss``'s backward adds the differences of every
layer); quantized KV codes exactly, or within one code where a value of
the two sides lies on a rounding boundary.  Greedy tokens are equal.
The sequential scans run at short lengths only, and every JAX function
is traced once per shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import qtensor as jqt
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve import Engine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qtensor import QTensor
from repro_torch.models import lm as tlm
from repro_torch.models import ssm
from repro_torch.serve import Engine, Scheduler, SchedulerConfig, ServeConfig
from repro_torch.serve.engine import prepare_params

RTOL = 1e-5
GRAD_RTOL = 1e-4
SSM_ARCHS = ["zamba2-2.7b", "rwkv6-1.6b"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# --------------------------------------------------------------------------
# the scans: chunked and exact, below, at and past one chunk
# --------------------------------------------------------------------------

LENGTHS = [5, 8, 19]          # chunk 8: below, at, not a multiple


def _ssd_inputs(l, g, seed=0):
    b, h, p, n = 2, 4, 3, 5
    x, dt_raw, B, C = _draw(seed, (b, l, h, p), (b, l, h), (b, l, g, n),
                            (b, l, g, n))
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)         # softplus > 0
    a_neg = -np.arange(1, h + 1, dtype=np.float32)
    return x, dt, a_neg, B, C


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("l", LENGTHS)
def test_ssd_scans_match_jax(l, g):
    """``_ssd_chunked`` and ``_ssd_scan`` against JAX's, with n_groups 1
    and 2 (B, C repeated group-major over the heads), and the port's
    chunked form against its own scan."""
    args = _ssd_inputs(l, g)
    jy, jS = jax.jit(jssm._ssd_chunked, static_argnums=5)(*args, 8)
    sy, sS = jax.jit(jssm._ssd_scan)(*args)
    ty, tS = ssm._ssd_chunked(*map(_t, args), 8)
    ey, eS = ssm._ssd_scan(*map(_t, args))
    for got, want in ((ty, jy), (tS, jS), (ey, sy), (eS, sS), (ty, ey),
                      (tS, eS)):
        assert got.shape == want.shape
        assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("l", LENGTHS)
def test_wkv_scans_match_jax(l):
    """``_wkv_chunked`` and ``_wkv_scan`` against JAX's on log-decays in
    [-5, -1e-4] (the clamp's range), and chunked against the scan."""
    b, h, n = 2, 2, 4
    r, k, v, w_raw = _draw(1, (b, l, h, n), (b, l, h, n), (b, l, h, n),
                           (b, l, h, n))
    logw = np.clip(-np.exp(w_raw), -5.0, -1e-4).astype(np.float32)
    bonus = _draw(2, (h, n))[0] * np.float32(0.1)
    args = (r, k, v, logw, bonus)
    jy, jS = jax.jit(jssm._wkv_chunked, static_argnums=5)(*args, 8)
    sy, sS = jax.jit(jssm._wkv_scan)(*args)
    ty, tS = ssm._wkv_chunked(*map(_t, args), 8)
    ey, eS = ssm._wkv_scan(*map(_t, args))
    for got, want in ((ty, jy), (tS, jS), (ey, sy), (eS, sS), (ty, ey),
                      (tS, eS)):
        assert got.shape == want.shape
        assert _rel(got, want) <= RTOL


def test_masked_exponential_keeps_the_gradient_finite():
    """At Zamba2's 80 heads the intra-chunk exponent above the diagonal
    reaches +8 per token and overflows over a chunk of 64.  JAX takes
    ``exp`` of it and masks afterwards: its forward is finite, its
    gradient in dt is not (0 * inf).  The port masks first: the decay
    matrix is bitwise JAX's formula evaluated in torch, the forward
    agrees with JAX's, and the gradient is finite everywhere and equal to
    JAX's on every head where JAX's is finite."""
    b, l, h, p, g, n = 1, 64, 80, 4, 1, 8
    x, B, C, w = _draw(3, (b, l, h, p), (b, l, g, n), (b, l, g, n),
                       (b, l, h, p))
    dt = np.full((b, l, h), 0.1, np.float32)
    a_neg = -np.arange(1, h + 1, dtype=np.float32)

    def jloss(dt_):
        y, _ = jssm._ssd_chunked(jnp.asarray(x), dt_, jnp.asarray(a_neg),
                                 jnp.asarray(B), jnp.asarray(C), 64)
        return jnp.sum(y * w), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(dt))
    jg = np.asarray(jg)
    tdt = _t(dt).requires_grad_(True)
    ty, _ = ssm._ssd_chunked(_t(x), tdt, _t(a_neg), _t(B), _t(C), 64)
    (ty * _t(w)).sum().backward()
    tg = tdt.grad.numpy()

    A_cum = torch.cumsum(_t(dt) * _t(a_neg), dim=1)[:, None]  # one chunk
    seg = A_cum[:, :, :, None, :] - A_cum[:, :, None, :, :]
    tril = torch.tril(torch.ones(l, l, dtype=torch.bool))[None, None, :, :,
                                                            None]
    assert torch.isinf(torch.exp(seg)).any()
    assert torch.equal(ssm._intra_decay(A_cum),
                       torch.where(tril, torch.exp(seg), 0.0))
    assert np.isfinite(np.asarray(jy)).all()
    assert _rel(ty.detach(), jy) <= RTOL
    finite_heads = np.isfinite(jg).all(axis=(0, 1))
    assert (~finite_heads).sum() >= h // 2          # 66 of 80 on this draw
    assert np.isfinite(tg).all()
    assert _rel(tg[..., finite_heads], jg[..., finite_heads]) <= GRAD_RTOL


def test_softplus_is_jax_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``: the port's agrees to
    the last bits of exp and log1p everywhere (XLA flushes subnormal
    results to 0, torch keeps them), stays exact past torch's linear
    threshold of 20, and keeps NaN and the infinities."""
    x = np.concatenate([_draw(4, (4096,))[0] * 30,
                        np.float32([0.0, 20.0, 25.0, -90.0, 90.0])])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ssm.softplus(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -21,
                               atol=np.finfo(np.float32).tiny)
    ext = ssm.softplus(torch.tensor([float("nan"), float("inf"),
                                     float("-inf")]))
    assert torch.isnan(ext[0]) and ext[1] == float("inf") and ext[2] == 0


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------

MAMBA = jssm.Mamba2Spec(d_model=32, d_state=8, head_dim=8, chunk=8)
RWKV = jssm.RWKV6Spec(d_model=32, head_dim=8, chunk=8)


def _spec(jspec):
    cls = ssm.Mamba2Spec if isinstance(jspec, jssm.Mamba2Spec) \
        else ssm.RWKV6Spec
    return cls(**{f: getattr(jspec, f) for f in jspec.__dataclass_fields__})


def _params(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree))


def _tree_rel(got, want):
    got, want = bridge.flatten(bridge.to_numpy(got)), bridge.flatten(
        jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    return {k: _rel(got[k], want[k]) for k in want}


@pytest.mark.parametrize("exact", [False, True])
def test_mamba2_block_matches_jax(exact):
    """``mamba2_apply`` with ``return_state`` (chunked and exact: output,
    conv tail, SSM state), then two ``mamba2_decode`` steps from that
    state, each against JAX's and against the full forward's next rows."""
    jp = jssm.mamba2_init(jax.random.PRNGKey(1), MAMBA)
    tp, spec = _params(jp), _spec(MAMBA)
    x = _draw(5, (2, 21, MAMBA.d_model))[0]
    l = 19
    japply = jax.jit(jssm.mamba2_apply, static_argnums=1,
                     static_argnames=("exact", "return_state"))
    jdecode = jax.jit(jssm.mamba2_decode, static_argnums=1)
    jo, jst = japply(jp, MAMBA, x[:, :l], exact=exact, return_state=True)
    with torch.no_grad():
        full = ssm.mamba2_apply(tp, spec, _t(x), exact=exact)
        to, tst = ssm.mamba2_apply(tp, spec, _t(x[:, :l]), exact=exact,
                                   return_state=True)
        assert _rel(to, jo) <= RTOL
        assert max(_tree_rel(tst, jst).values()) <= RTOL
        for s in (l, l + 1):
            jo, jst = jdecode(jp, MAMBA, x[:, s:s + 1], jst)
            to, tst = ssm.mamba2_decode(tp, spec, _t(x[:, s:s + 1]), tst)
            assert _rel(to, jo) <= RTOL
            assert max(_tree_rel(tst, jst).values()) <= RTOL
            assert _rel(to, full[:, s:s + 1]) <= RTOL


@pytest.mark.parametrize("exact", [False, True])
def test_rwkv6_block_matches_jax(exact):
    """``rwkv6_time_mix`` with ``return_state``, ``rwkv6_channel_mix``
    (its own shift and a given one) and two ``rwkv6_time_mix_decode``
    steps, against JAX's and against the full forward's next rows."""
    jtm = jssm.rwkv6_time_mix_init(jax.random.PRNGKey(2), RWKV)
    jcm = jssm.rwkv6_channel_mix_init(jax.random.PRNGKey(3), 32, 64)
    ttm, tcm, spec = _params(jtm), _params(jcm), _spec(RWKV)
    x, xx = _draw(6, (2, 21, RWKV.d_model), (2, 21, RWKV.d_model))
    l = 19
    jmix = jax.jit(jssm.rwkv6_time_mix, static_argnums=1,
                   static_argnames=("exact", "return_state"))
    jdecode = jax.jit(jssm.rwkv6_time_mix_decode, static_argnums=1)
    with torch.no_grad():
        full = ssm.rwkv6_time_mix(ttm, spec, _t(x), exact=exact)
        jo, jst = jmix(jtm, RWKV, x[:, :l], exact=exact, return_state=True)
        to, tst = ssm.rwkv6_time_mix(ttm, spec, _t(x[:, :l]), exact=exact,
                                     return_state=True)
        assert _rel(to, jo) <= RTOL
        assert max(_tree_rel(tst, jst).values()) <= RTOL
        for s in (l, l + 1):
            jo, jst = jdecode(jtm, RWKV, x[:, s:s + 1], jst)
            to, tst = ssm.rwkv6_time_mix_decode(ttm, spec, _t(x[:, s:s + 1]),
                                                tst)
            assert _rel(to, jo) <= RTOL
            assert max(_tree_rel(tst, jst).values()) <= RTOL
            assert _rel(to, full[:, s:s + 1]) <= RTOL
        for shift in (None, xx):
            want = jax.jit(jssm.rwkv6_channel_mix)(jcm, x, shift)
            got = ssm.rwkv6_channel_mix(tcm, _t(x), None if shift is None
                                        else _t(shift))
            assert _rel(got, want) <= RTOL


def test_decay_clamp_at_logw_min():
    """The data-dependent log-decay is clamped to [logw_min, -1e-4]: with
    decay bases far outside it both bounds are hit, and the projections
    (r, k, v, g and the clamped log w) are JAX's."""
    jtm = jssm.rwkv6_time_mix_init(jax.random.PRNGKey(4), RWKV)
    base = np.where(np.arange(RWKV.d_model) % 2, 4.0, -20.0).astype(
        np.float32)
    jtm = dict(jtm, decay_base=jnp.asarray(base))
    ttm, spec = _params(jtm), _spec(RWKV)
    x, xx = _draw(7, (2, 6, RWKV.d_model), (2, 6, RWKV.d_model))
    want = jssm._rwkv_projections(jtm, RWKV, jnp.asarray(x), jnp.asarray(xx))
    got = ssm._rwkv_projections(ttm, spec, _t(x), _t(xx))
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL
    logw = got[-1]
    assert (logw == RWKV.logw_min).any() and (logw == np.float32(-1e-4)).any()
    assert logw.min() >= RWKV.logw_min and logw.max() <= np.float32(-1e-4)


# --------------------------------------------------------------------------
# the two configs, through the model and the serving entry points
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = j_smoke(arch)
    return jcfg, jlm.lm_init(jax.random.PRNGKey(0), jcfg), \
        bridge.lm_config(jcfg)


def _tparams(arch):
    return _params(_setup(arch)[1])


def _tokens(vocab, b, l, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(
        np.int32)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_lm_loss_and_gradient_match_jax(arch):
    """``lm_loss`` and its gradient in every leaf (the shared block's
    included) against JAX's."""
    jcfg, jparams, tcfg = _setup(arch)
    toks = _tokens(jcfg.vocab, 2, 20, 8)
    jl, jg = jax.jit(jax.value_and_grad(jlm.lm_loss), static_argnums=1)(
        jparams, jcfg, jnp.asarray(toks), jnp.asarray(toks))
    params = _tparams(arch)
    for leaf in bridge.flatten(params).values():
        leaf.requires_grad_(True)
    tt = torch.from_numpy(toks).long()
    loss = tlm.lm_loss(params, tcfg, tt, tt)
    loss.backward()
    assert _rel(loss.item(), float(jl)) <= RTOL
    want = bridge.flatten(jax.tree.map(np.asarray, jg))
    got = {k: v.grad.numpy() for k, v in bridge.flatten(params).items()}
    assert set(got) == set(want)
    assert ("shared/attn/wq" in want) == (arch == "zamba2-2.7b")
    for path, g in got.items():
        assert np.isfinite(g).all(), path
        assert _rel(g, want[path]) <= GRAD_RTOL, (path, _rel(g, want[path]))


def _codes_close(got, want):
    """Integer cache codes: equal, or one code apart where a value sits on
    a rounding boundary (int4 compared nibble by nibble)."""
    if got.dtype == np.uint8:
        def nib(a):
            a = a.astype(np.int16)
            lo, hi = a & 0xF, a >> 4
            return np.stack([np.where(lo > 7, lo - 16, lo),
                             np.where(hi > 7, hi - 16, hi)])
        got, want = nib(got), nib(want)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return diff.max() <= 1 and (diff > 0).mean() < 1e-3


def _assert_cache_matches(got, want):
    got = bridge.flatten(bridge.to_numpy(got))
    want = bridge.flatten(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if np.issubdtype(w.dtype, np.integer):
            assert _codes_close(g, w), path
        else:
            assert _rel(g, w) <= RTOL, (path, _rel(g, w))


# dense KV: test_torch_archs.py; RWKV6 has no KV to quantize: one case
@pytest.mark.parametrize("arch,kv", [("zamba2-2.7b", "int8"),
                                     ("zamba2-2.7b", "int4"),
                                     ("rwkv6-1.6b", "int8")])
def test_prefill_decode_and_cache_match_jax(arch, kv):
    """``lm_prefill`` and two ``lm_decode`` steps: logits and every cache
    leaf (conv tails, SSM and WKV states, shifts, the shared block's dense,
    int8 or int4 rings) against JAX's; RWKV6's cache holds only its
    states."""
    jcfg, jparams, tcfg = _setup(arch)
    b, l = 2, 13
    toks = _tokens(jcfg.vocab, b, l + 2, 9)
    params = _tparams(arch)
    jlg, jc = jlm.lm_prefill(jparams, jcfg, jnp.asarray(toks[:, :l]),
                             cache_len=16, kv_quant=kv)
    with torch.no_grad():
        lg, c = tlm.lm_prefill(params, tcfg, torch.from_numpy(toks[:, :l])
                               .long(), cache_len=16, kv_quant=kv)
    assert _rel(lg, jlg) <= RTOL
    _assert_cache_matches(c, jc)
    for s in (l, l + 1):
        jlg, jc = jlm.lm_decode(jparams, jcfg, jc,
                                jnp.asarray(toks[:, s:s + 1]),
                                jnp.full((b,), s, jnp.int32))
        with torch.no_grad():
            lg, c2 = tlm.lm_decode(params, tcfg, c, torch.from_numpy(
                toks[:, s:s + 1]).long(), torch.full((b,), s))
        assert c2 is c                                 # in place
        assert _rel(lg, jlg) <= RTOL
        _assert_cache_matches(c, jc)
    empty = tlm.init_cache(tcfg, b, 16, kv_quant=kv, device="cpu")
    jempty = jlm.init_cache(jcfg, b, 16, kv_quant=kv)
    _assert_cache_matches(empty, jempty)
    if arch == "rwkv6-1.6b":
        assert set(bridge.flatten(empty)) == {
            f"unit/b0_rwkv/{k}" for k in ("shift_tm", "shift_cm", "wkv")}


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_quantize_cache_and_cache_insert_match_jax(arch):
    """A dense prefill cache quantized to int8 (the shared rings only; the
    states pass through) and inserted into row 1 of a 3-row slot cache
    (every leaf, states included): JAX's results."""
    jcfg, jparams, tcfg = _setup(arch)
    toks = _tokens(jcfg.vocab, 1, 9, 10)
    _, jrow = jlm.lm_prefill(jparams, jcfg, jnp.asarray(toks), cache_len=16)
    with torch.no_grad():
        _, row = tlm.lm_prefill(_tparams(arch), tcfg,
                                torch.from_numpy(toks).long(), cache_len=16)
    jq, tq = jlm.quantize_cache(jcfg, jrow, "int8"), \
        tlm.quantize_cache(tcfg, row, "int8")
    _assert_cache_matches(tq, jq)
    jpool = jlm.cache_insert(jlm.init_cache(jcfg, 3, 16, kv_quant="int8"),
                             jq, 1)
    pool = tlm.init_cache(tcfg, 3, 16, kv_quant="int8", device="cpu")
    assert tlm.cache_insert(pool, tq, 1) is pool
    _assert_cache_matches(pool, jpool)


@pytest.mark.parametrize("include_embeddings", [False, True])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prepare_params_picks_jax_leaves(arch, include_embeddings):
    """``prepare_params`` (rtn:int4) makes QTensors of exactly the leaves
    JAX's ``quantize_params`` does (Zamba2's shared block, and the
    embedding or head under ``include_embeddings``; never an SSM leaf),
    with JAX's codes, and casts every other eligible leaf densely as JAX
    does; scales and casts to the last bit of XLA's compiled quantizer
    (the port's are held bitwise to JAX's op-by-op ones in
    test_torch_quant.py and test_torch_qtensor.py)."""
    jcfg, jparams, _ = _setup(arch)
    kw = dict(min_size=256, include_embeddings=include_embeddings)
    want = bridge.flatten(jax.tree.map(np.asarray, jax.jit(
        lambda p: jqt.quantize_params(p, "int4", JPolicy(**kw), -1))(
            jparams)))
    got = bridge.flatten(prepare_params(
        _tparams(arch), ServeConfig(weights="rtn:int4",
                                    policy=QuantPolicy(**kw)), "cpu"))
    assert set(got) == set(want)
    qt = {k for k, v in got.items() if isinstance(v, QTensor)}
    assert qt == {k for k, v in want.items() if hasattr(v, "codes")}
    assert bool(qt) == (arch == "zamba2-2.7b" or include_embeddings)
    assert not any(("mamba" in k or "rwkv" in k) for k in qt)
    # XLA's compiled quantizer may round a scale (absmax / 7) or w / s in
    # its last bit
    for k, v in got.items():
        if k in qt:
            np.testing.assert_array_equal(v.codes.numpy(), want[k].codes)
            v, want[k] = v.scales, want[k].scales
        np.testing.assert_allclose(v.numpy(), want[k], rtol=2 ** -22, atol=0)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_engine_and_scheduler_tokens_match_jax(arch):
    """Greedy tokens of the static ``Engine`` (int4 weights, int8 KV,
    left-padded ragged prompts whose pads run through the recurrences, as
    in JAX) and of the ring ``Scheduler`` (per-slot prefill, int8 KV):
    JAX's, with equal tick, prefill and counter records."""
    jcfg, jparams, tcfg = _setup(arch)
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(0, jcfg.vocab, n)) for n in (5, 9, 7)]
    kw = dict(weights="rtn:int4", kv_quant="int8", max_new_tokens=5)
    je = JEngine(jcfg, jparams, JServeConfig(policy=JPolicy(min_size=256),
                                             **kw))
    te = Engine(tcfg, _tparams(arch), ServeConfig(
        policy=QuantPolicy(min_size=256), **kw), device="cpu")
    want = je.generate(prompts)
    assert te.generate(prompts) == want and all(want)

    scfg = dict(max_new_tokens=6, kv_quant="int8")
    sched = dict(n_slots=3, steps_per_tick=2, cache_len=32)
    # two prompt widths: each is one prefill trace on JAX's side
    wl = [(list(rng.integers(0, jcfg.vocab, n)), m)
          for n, m in ((6, 6), (9, 2), (6, 4), (9, 6), (6, 3))]
    recs = []
    for s in (JScheduler(jcfg, jparams, JServeConfig(**scfg),
                         JSchedulerConfig(**sched)),
              Scheduler(tcfg, _tparams(arch), ServeConfig(**scfg),
                        SchedulerConfig(**sched), device="cpu")):
        rids = [s.submit(p, max_new_tokens=m) for p, m in wl]
        s.run()
        recs.append(([s.requests[r].out for r in rids], s.n_ticks,
                     s.n_prefills, dict(s.counters)))
    assert recs[1] == recs[0] and all(recs[1][0])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_chunked_and_paged_are_refused_like_jax(arch):
    """Recurrent state is not threaded across prefill chunks and has no
    position-keyed ring: the Scheduler refuses ``prefill_chunk`` and
    ``paged`` with JAX's reasons, ``lm_prefill_chunk`` raises as JAX's
    does, and paged ``lm_decode`` refuses the pattern as JAX's does."""
    jcfg, jparams, tcfg = _setup(arch)
    params = _tparams(arch)
    for bad in (dict(prefill_chunk=4), dict(paged=True, block_size=8)):
        with pytest.raises(ValueError) as jerr:
            JScheduler(jcfg, jparams, JServeConfig(),
                       JSchedulerConfig(cache_len=32, **bad))
        with pytest.raises(ValueError) as terr:
            Scheduler(tcfg, params, ServeConfig(),
                      SchedulerConfig(cache_len=32, **bad), device="cpu")
        assert str(terr.value) == str(jerr.value)
    toks = np.zeros((1, 4), np.int32)
    cache = tlm.init_cache(tcfg, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError) as jerr:
        jlm.lm_prefill_chunk(jparams, jcfg, jlm.init_cache(jcfg, 1, 16),
                             jnp.asarray(toks), jnp.zeros((1,), jnp.int32))
    with pytest.raises(NotImplementedError) as terr:
        tlm.lm_prefill_chunk(params, tcfg, cache, torch.zeros(1, 4).long(),
                             torch.zeros(1).long())
    assert str(terr.value) == str(jerr.value)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError) as jerr:
        jlm.lm_decode(jparams, jcfg, jlm.init_cache(jcfg, 1, 16),
                      jnp.asarray(toks[:, :1]), jnp.zeros((1,), jnp.int32),
                      block_tables=jnp.asarray(tables.numpy()), block_size=8)
    with pytest.raises(ValueError) as terr:
        tlm.lm_decode(params, tcfg, cache, torch.zeros(1, 1).long(),
                      torch.zeros(1).long(), block_tables=tables,
                      block_size=8)
    assert str(terr.value) == str(jerr.value)
