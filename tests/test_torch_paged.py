"""The port's paged KV path against the JAX package on the CPU: the
``decode_attn_paged`` wrapper (its plain version here) on shuffled block
tables, the pool gather and writes, paged decode attention and the
paged ``lm_decode``, and ``cache_insert_paged``.

Inputs come from numpy; quantized K/V from the JAX ``kv_quantize``.
Tolerances: attention outputs and logits 1e-5 relative to their max
(fp32 summation order; the Pallas kernel's online softmax against the
dense one); gathers, writes and inserts bitwise.  Block 0 is the
reserved dump block: idle rows and shared chunks write there several at
once, so its content is never compared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import decode_attn_paged as jax_paged
from repro.kernels.decode_attn import decode_attn_paged_ref as jax_paged_ref
from repro.kernels.decode_attn.ref import gather_pool_ref as jax_gather
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.kernels.decode_attn import (decode_attn, decode_attn_paged,
                                             gather_pool_ref)
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

B, BPS, BS, G, HD = 3, 4, 16, 2, 64
POS = (5, 63, 150)          # partial, exactly full, ring-wrapped
CFG = jlm.LMConfig(name="pg", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=128, dtype=jnp.float32, remat=False)


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _pool(seed, bits, bs=BS, bps=BPS):
    """A quantized pool of 1 + B*bps blocks and shuffled tables over
    blocks 1.. (block 0, the null block, holds noise and is never read)."""
    rng = np.random.default_rng(seed)
    nb = 1 + B * bps
    x = rng.normal(size=(nb, bs, G, HD)).astype(np.float32)
    q = jlayers.kv_quantize(jnp.asarray(x), bits)
    tables = rng.permutation(np.arange(1, nb)).reshape(B, bps).astype(
        np.int32)
    return np.asarray(q["codes"]), np.asarray(q["scale"]), tables


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window,softcap", [(None, None), (24, 30.0)])
@pytest.mark.parametrize("rep", [1, 2])
def test_decode_attn_paged_matches_jax(bits, window, softcap, rep):
    kc, ks, tables = _pool(1, bits)
    vc, vs, _ = _pool(1, bits)
    vc, vs = np.roll(vc, 1, axis=0), np.roll(vs, 1, axis=0)
    q = np.random.default_rng(3).normal(size=(B, G, rep, HD)).astype(
        np.float32)
    pos = np.asarray(POS, np.int32)
    kw = dict(bits=bits, window=window, softcap=softcap)
    jargs = [jnp.asarray(a) for a in (q, kc, ks, vc, vs, tables, pos)]
    want = np.asarray(jax_paged_ref(*jargs, **kw))
    kern = np.asarray(jax_paged(*jargs, **kw))          # interpret mode
    got = decode_attn_paged(*[_t(a) for a in (q, kc, ks, vc, vs, tables,
                                              pos)], **kw).numpy()
    assert got.shape == (B, G, rep, HD)
    assert _rel(got, want) < 1e-5
    assert _rel(got, kern) < 1e-5
    # the paged wrapper IS ring attention over the gathered view
    view = [gather_pool_ref(_t(a), _t(tables)) for a in (kc, ks, vc, vs)]
    ring = decode_attn(_t(q), *view, _t(pos), **kw).numpy()
    np.testing.assert_array_equal(got, ring)


@pytest.mark.parametrize("bits", [8, 4])
def test_gather_pool_and_paged_gather_bitwise(bits):
    kc, ks, tables = _pool(2, bits)
    np.testing.assert_array_equal(
        gather_pool_ref(_t(kc), _t(tables)).numpy(),
        np.asarray(jax_gather(jnp.asarray(kc), jnp.asarray(tables))))
    jview = jlayers.paged_gather({"codes": jnp.asarray(kc),
                                  "scale": jnp.asarray(ks)},
                                 jnp.asarray(tables))
    tview = tlayers.paged_gather({"codes": _t(kc), "scale": _t(ks)},
                                 _t(tables))
    for key in ("codes", "scale"):
        np.testing.assert_array_equal(tview[key].numpy(),
                                      np.asarray(jview[key]))


def test_decode_attn_paged_wrapper_checks_shapes():
    kc, ks, tables = _pool(3, 8)
    q = torch.zeros((B, G, 1, HD))
    args = (_t(kc), _t(ks), _t(kc), _t(ks))
    with pytest.raises(ValueError, match="block_tables"):
        decode_attn_paged(q, *args, _t(tables[:2]), torch.zeros(B))
    with pytest.raises(ValueError, match="k_codes"):
        decode_attn_paged(q, _t(kc[..., :32]), *args[1:], _t(tables),
                          torch.zeros(B))


@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
def test_cache_write_paged_bitwise_outside_block_0(kv_quant):
    """A new (b, kvh, hd) vector per row written through the table: rows
    with a live table land where JAX puts them; the idle row (table 0)
    goes to block 0."""
    bits = tlayers.kv_bits(kv_quant)
    rng = np.random.default_rng(4)
    nb = 1 + 2 * BPS
    tables = np.zeros((B, BPS), np.int32)
    tables[:2] = rng.permutation(np.arange(1, nb)).reshape(2, BPS)
    new = rng.normal(size=(B, G, HD)).astype(np.float32)
    slot = np.asarray([3, 37, 20], np.int32)
    if bits:
        base = jlayers.kv_quantize(jnp.asarray(rng.normal(
            size=(nb, BS, G, HD)).astype(np.float32)), bits)
        jcache = {k: v for k, v in base.items()}
        tcache = {k: _t(v).clone() for k, v in base.items()}
    else:
        base = rng.normal(size=(nb, BS, G, HD)).astype(np.float32)
        jcache, tcache = jnp.asarray(base), _t(base).clone()
    want = jlayers._cache_write_paged(jcache, jnp.asarray(new),
                                      jnp.asarray(tables), jnp.asarray(slot),
                                      BS)
    got = tlayers._cache_write_paged(tcache, _t(new), _t(tables), _t(slot),
                                     BS)
    assert got is tcache                          # in place
    for key in (("codes", "scale") if bits else (None,)):
        w = want[key] if key else want
        g = got[key] if key else got
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])


@functools.lru_cache(maxsize=None)
def _model():
    jparams = jlm.lm_init(jax.random.PRNGKey(0), CFG)
    return jparams, bridge.to_torch(jax.tree.map(np.asarray, jparams)), \
        bridge.lm_config(CFG)


def _jax_pool_cache(kv_quant, nb, seed):
    """A paged pool for CFG filled with quantized noise."""
    rng = np.random.default_rng(seed)
    cache = jlm.init_cache(CFG, nb, BS, dtype=jnp.float32, kv_quant=kv_quant)

    def fill(leaf):
        x = jnp.asarray(rng.normal(size=leaf.shape if not isinstance(
            leaf, dict) else leaf["scale"].shape[:-1] + (CFG.hd,)).astype(
            np.float32))
        bits = jlayers.kv_bits(kv_quant)
        return jlayers.kv_quantize(x, bits) if bits else x

    unit = {name: {kv: fill(c[kv]) for kv in ("k", "v")}
            for name, c in cache["unit"].items()}
    return {"unit": unit}


@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
def test_lm_decode_paged_matches_jax(kv_quant):
    """Three paged decode steps of the whole model: logits within 1e-5,
    the pool within one quantization step of JAX's outside block 0."""
    jparams, tparams, tcfg = _model()
    nb = 1 + B * BPS
    jpool = _jax_pool_cache(kv_quant, nb, 5)
    tpool = bridge.to_torch(jax.tree.map(np.asarray, jpool))
    tables = np.random.default_rng(6).permutation(np.arange(1, nb)).reshape(
        B, BPS).astype(np.int32)
    pos = np.asarray(POS, np.int32)
    toks = np.asarray([[3], [9], [27]], np.int32)
    jdec = jax.jit(jlm.lm_decode, static_argnames=("cfg", "block_size"))
    for _ in range(3):
        jl, jpool = jdec(jparams, cfg=CFG, cache=jpool,
                         tokens=jnp.asarray(toks), pos=jnp.asarray(pos),
                         block_tables=jnp.asarray(tables), block_size=BS)
        tl, tpool2 = tlm.lm_decode(tparams, tcfg, tpool, _t(toks).long(),
                                   _t(pos).long(), block_tables=_t(tables),
                                   block_size=BS)
        assert tpool2 is tpool
        assert _rel(tl.numpy(), jl) < 1e-5
        toks = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
        pos = pos + 1
    for name, leaf in jpool["unit"].items():
        for kv in ("k", "v"):
            j, t = leaf[kv], tpool["unit"][name][kv]
            if isinstance(j, dict):
                jc = np.asarray(j["codes"]).astype(np.int32)[:, 1:]
                tc = t["codes"].numpy().astype(np.int32)[:, 1:]
                if t["codes"].dtype == torch.uint8:
                    jc = np.stack([jc & 15, jc >> 4], -1)
                    tc = np.stack([tc & 15, tc >> 4], -1)
                    diff = np.minimum(np.abs(jc - tc), 16 - np.abs(jc - tc))
                else:
                    diff = np.abs(jc - tc)
                assert diff.max() <= 1
                assert _rel(t["scale"].numpy()[:, 1:],
                            np.asarray(j["scale"])[:, 1:]) < 1e-5
            else:
                assert _rel(t.numpy()[:, 1:], np.asarray(j)[:, 1:]) < 1e-5


@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
def test_cache_insert_paged_bitwise_outside_block_0(kv_quant):
    """A one-request row scattered into its table's blocks; shared chunks
    (write False) go to block 0 and leave their blocks untouched."""
    nb = 1 + 2 * BPS
    jpool = _jax_pool_cache(kv_quant, nb, 7)
    rng = np.random.default_rng(8)
    row = jlm.init_cache(CFG, 1, BPS * BS, dtype=jnp.float32,
                         kv_quant=kv_quant)
    row = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)).astype(a.dtype)
        if a.dtype == jnp.float32 else jnp.asarray(rng.integers(
            0, 100, size=a.shape)).astype(a.dtype), row)
    table = np.asarray([5, 2, 7, 1], np.int32)
    write = np.asarray([False, True, True, False])
    want = jlm.cache_insert_paged(jpool, row, jnp.asarray(table),
                                  jnp.asarray(write))
    tpool = bridge.to_torch(jax.tree.map(np.asarray, jpool))
    got = tlm.cache_insert_paged(tpool, bridge.to_torch(
        jax.tree.map(np.asarray, row)), _t(table), _t(write))
    assert got is tpool
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(
            bridge.to_numpy(got))):
        np.testing.assert_array_equal(np.asarray(g)[:, 1:],
                                      np.asarray(w)[:, 1:])


def test_init_cache_builds_the_pool_layout():
    _, _, tcfg = _model()
    for kv_quant in (False, "int8", "int4"):
        jpool = jlm.init_cache(CFG, 9, BS, dtype=jnp.float32,
                               kv_quant=kv_quant)
        tpool = tlm.init_cache(tcfg, 9, BS, dtype="float32",
                               kv_quant=kv_quant, device="cpu")
        for w, g in zip(jax.tree.leaves(jpool), jax.tree.leaves(
                bridge.to_numpy(tpool))):
            assert np.asarray(g).shape == w.shape
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
