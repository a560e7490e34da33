"""The port's chunked prefill against the JAX package on the CPU: the
chunk attention (``attn_chunk_apply``), the whole-model chunk step
(``lm_prefill_chunk``), the deferred cache quantizer
(``quantize_cache``), and a prefix reused after its producer's partial
cache buffer was refilled by later chunks (the in-place trap: trie
payloads must be copies).

Inputs come from numpy, weights from the JAX ``lm_init`` through
``bridge``.  Tolerances: outputs, logits and dense caches 1e-5 relative
to their max (fp32 summation order); a quantized cache within one code
step (a value on a rounding boundary may flip when the two K projections
differ in the last bit) and its scales 1e-5; ``quantize_cache`` on the
same input bitwise; greedy tokens identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serve import Scheduler, SchedulerConfig, ServeConfig
from repro_torch.serve import scheduler as tsched

CFG = jlm.LMConfig(name="c", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=64, dtype=jnp.float32, remat=False)
L = 32


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _close_cache(t, j):
    """Port cache leaf (tensor or codes/scale dict) against JAX's."""
    if isinstance(j, dict):
        jc = np.asarray(j["codes"]).astype(np.int32)
        tc = t["codes"].numpy().astype(np.int32)
        if t["codes"].dtype == torch.uint8:
            jc, tc = (np.stack([c & 15, c >> 4], -1) for c in (jc, tc))
            diff = np.minimum(np.abs(jc - tc), 16 - np.abs(jc - tc))
        else:
            diff = np.abs(jc - tc)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        assert _rel(t["scale"].numpy(), j["scale"]) < 1e-5
    else:
        assert _rel(t.numpy(), j) < 1e-5


@functools.lru_cache(maxsize=None)
def _model():
    jparams = jlm.lm_init(jax.random.PRNGKey(0), CFG)
    return jparams, bridge.to_torch(jax.tree.map(np.asarray, jparams)), \
        bridge.lm_config(CFG)


@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
@pytest.mark.parametrize("window,softcap", [(None, None), (6, 30.0)])
def test_attn_chunk_apply_matches_jax(kv_quant, window, softcap):
    """One chunk of 8 columns (rows with 8, 5 and 3 real tokens) against a
    partial cache at starts 0, 13 and 29 (the last wraps the ring)."""
    jparams, tparams, _ = _model()
    spec = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                window=window, softcap=softcap)
    jspec, tspec = jlayers.AttnSpec(**spec), tlayers.AttnSpec(**spec)
    jp = jax.tree.map(lambda a: a[0], jparams["stage"]["b0_attn"]["attn"])
    tp = {k: v[0] for k, v in tparams["stage"]["b0_attn"]["attn"].items()}
    rng = np.random.default_rng(1)
    b, cw = 3, 8
    x = rng.normal(size=(b, cw, 64)).astype(np.float32)
    start = np.asarray([0, 13, 29])
    positions = (start[:, None] + np.arange(cw)[None]).astype(np.int32)
    lens = np.asarray([8, 5, 3], np.int32)
    dense = rng.normal(size=(b, L, 2, 16)).astype(np.float32)
    bits = jlayers.kv_bits(kv_quant)
    if bits:
        jk = jlayers.kv_quantize(jnp.asarray(dense), bits)
        jv = jlayers.kv_quantize(jnp.asarray(dense[::-1].copy()), bits)
        tk = {k: _t(v).clone() for k, v in jk.items()}
        tv = {k: _t(v).clone() for k, v in jv.items()}
    else:
        jk, jv = jnp.asarray(dense), jnp.asarray(dense[::-1].copy())
        tk, tv = _t(jk).clone(), _t(jv).clone()
    jo, jk2, jv2 = jlayers.attn_chunk_apply(
        jp, jspec, jnp.asarray(x), jnp.asarray(positions),
        jnp.asarray(lens), jk, jv)
    to, tk2, tv2 = tlayers.attn_chunk_apply(
        tp, tspec, _t(x), _t(positions).long(), _t(lens).long(), tk, tv)
    assert tk2 is tk and tv2 is tv                 # written in place
    # pad columns' outputs are garbage on both sides: compare real ones
    for i, n in enumerate(lens):
        assert _rel(to.numpy()[i, :n], np.asarray(jo)[i, :n]) < 1e-5
    _close_cache(tk, jk2)
    _close_cache(tv, jv2)


@pytest.mark.parametrize("arch", ["serve", "granite-3-2b"])
@pytest.mark.parametrize("chunk", [4, 7])
def test_lm_prefill_chunk_chain_matches_jax(arch, chunk):
    """A 19-token prompt (two rows, the second one 11 tokens) prefilled
    chunk by chunk: every chunk's last-token logits and the final dense
    cache within 1e-5 of JAX's."""
    from repro.configs import get_smoke_config
    jcfg = CFG if arch == "serve" else get_smoke_config(arch)
    if arch == "serve":
        jparams, tparams, tcfg = _model()
    else:
        jparams = jlm.lm_init(jax.random.PRNGKey(1), jcfg)
        tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
        tcfg = bridge.lm_config(jcfg)
    rng = np.random.default_rng(2)
    seqs = [rng.integers(0, jcfg.vocab, 19), rng.integers(0, jcfg.vocab, 11)]
    jcache = jlm.init_cache(jcfg, 2, L, dtype=jcfg.dtype, kv_quant=False)
    tcache = tlm.init_cache(tcfg, 2, L, dtype=tcfg.dtype, kv_quant=False,
                            device="cpu")
    jchunk = jax.jit(jlm.lm_prefill_chunk, static_argnames=("cfg",))
    for s in range(0, 19, chunk):
        toks = np.zeros((2, chunk), np.int32)
        lens = np.zeros(2, np.int32)
        for i, q in enumerate(seqs):
            take = max(0, min(chunk, len(q) - s))
            toks[i, :take] = q[s:s + take]
            lens[i] = max(take, 1)
        start = np.minimum(np.asarray([s, s]), [19, 10]).astype(np.int32)
        jl, jcache = jchunk(jparams, cfg=jcfg, cache=jcache,
                            tokens=jnp.asarray(toks),
                            start_pos=jnp.asarray(start),
                            chunk_lens=jnp.asarray(lens))
        tl, tcache2 = tlm.lm_prefill_chunk(tparams, tcfg, tcache,
                                           _t(toks).long(),
                                           _t(start).long(), _t(lens).long())
        assert tcache2 is tcache
        assert tl.shape == (2, 1, jcfg.vocab)
        assert _rel(tl.numpy(), jl) < 1e-5
    for name, leaf in jcache["unit"].items():
        for kv in ("k", "v"):
            _close_cache(tcache["unit"][name][kv], leaf[kv])


@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
def test_quantize_cache_bitwise_with_jax(kv_quant):
    rng = np.random.default_rng(3)
    jcache = jlm.init_cache(CFG, 1, L, dtype=jnp.float32, kv_quant=False)
    jcache = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), jcache)
    jcache["unit"]["b0_attn"]["k"] = jcache["unit"]["b0_attn"]["k"].at[
        :, :, 20:].set(0.0)                       # unwritten slots
    want = jlm.quantize_cache(CFG, jcache, kv_quant)
    tcache = bridge.to_torch(jax.tree.map(np.asarray, jcache))
    got = tlm.quantize_cache(bridge.lm_config(CFG), tcache, kv_quant)
    if not kv_quant:
        assert got is tcache
    for w, g in zip(jax.tree.leaves(want),
                    jax.tree.leaves(bridge.to_numpy(got))):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --------------------------------------------------------------------------
# the in-place trap: a prefix reused after later chunks refilled the
# buffer its payload was cut from
# --------------------------------------------------------------------------

SYS = [7, 3, 9, 1, 4, 4, 2, 8]


def _trap_stream():
    """A publishes SYS; B (no hit) then prefills through the partial-cache
    buffer A gave back; C hits A's chunks afterwards."""
    return [SYS + [11, 12, 13], [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
            SYS + [21, 22]]


def _trap_run(paged: bool, kv_quant):
    _, tparams, tcfg = _model()
    kw = dict(n_slots=1, steps_per_tick=2, cache_len=L, prefill_chunk=4,
              prefix_cache=True)
    if paged:
        kw.update(paged=True, block_size=4)
    sch = Scheduler(tcfg, tparams, ServeConfig(max_new_tokens=5,
                                               kv_quant=kv_quant),
                    SchedulerConfig(**kw), device="cpu")
    outs = [sch.generate([p])[0] for p in _trap_stream()]
    return outs, sch


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_quant", [False, "int8"])
def test_prefix_reused_after_its_buffer_was_refilled(paged, kv_quant):
    jparams, _, _ = _model()
    want = JEngine(CFG, jparams, JServeConfig(
        max_new_tokens=5, kv_quant=kv_quant)).generate(_trap_stream())
    outs, sch = _trap_run(paged, kv_quant)
    assert outs == want
    assert sch.prefix.stats()["hits"] >= 1 and sch.prefill_tokens_skipped >= 8
    assert len(sch._free_rows) == 1              # one buffer, reused


def test_prefix_payload_views_would_be_overwritten(monkeypatch):
    """The same stream with payloads cut as views of the buffer (no copy):
    C splices what B's prefill left there, and its tokens change.  Shows
    that the test above exercises the trap."""
    jparams, _, _ = _model()
    want = JEngine(CFG, jparams, JServeConfig(max_new_tokens=5)).generate(
        _trap_stream())
    monkeypatch.setattr(tsched, "_chunk_copy",
                        lambda a, i, c: a[:, :, i * c:(i + 1) * c])
    outs, _ = _trap_run(True, False)
    assert outs[:2] == want[:2]
    assert outs[2] != want[2]
