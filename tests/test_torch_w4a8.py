"""The port's W4A8 serving and K-major matmul against the JAX package on
the CPU: the activation quantizer and the integer-activation matmul
(``wqt_matmul_a8``), the K-major ``wq_matmul`` with its packer, the
act-fmt context through ``matmul``, and whole-engine greedy tokens.

Inputs come from numpy.  Tolerances: the quantizers and the per-tensor
integer matmul are bitwise (the same IEEE operations in the same order);
the blockwise epilogue 1e-6 relative (JAX sums the blocks in XLA's order,
the port in block order); against the Pallas kernels in interpret mode
the JAX tests' own tolerances (``tests/test_w4a8.py``,
``tests/test_kernels.py``); fp32 contractions 1e-5 of the output's max;
greedy tokens identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wq_matmul import pack_weight as jax_pack_weight
from repro.kernels.wq_matmul import wq_matmul as jax_wq_matmul
from repro.kernels.wq_matmul import wqt_matmul_a8 as jax_wqt_matmul_a8
from repro.kernels.wq_matmul import ref as jref
from repro.models import lm as jlm
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.core import qtensor as tqt
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.wq_matmul import (dequant_ref, pack_weight,
                                           quantize_acts_ref,
                                           quantize_weights_ref, wq_matmul,
                                           wq_matmul_ref, wqt_matmul_a8,
                                           wqt_matmul_a8_ref)
from repro_torch.serve import Engine, ServeConfig

SERVE_CFG = jlm.LMConfig(name="s", n_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=2, d_ff=128, vocab=64, dtype=jnp.float32,
                         remat=False)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]]


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _out_major(k, n, bits, block_k, seed):
    """JAX-quantized out-major codes and scales of a (K, N) weight."""
    from repro.core.qtensor import from_matmul_weight
    qt = from_matmul_weight(jnp.asarray(_rand((k, n), seed)), f"int{bits}",
                            block_k)
    return np.array(qt.codes), np.array(qt.scales)


def _acts(m, k, seed, scale=0.5):
    xq, xs = jref.quantize_acts_ref(jnp.asarray(_rand((m, k), seed, scale)))
    return np.array(xq), np.array(xs)


# --------------------------------------------------------------------------
# the A8 half: per-row int8 activation quantization
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((8, 256), 3.0), ((5, 1000), 0.01),
                                         ((2, 3, 64), 1.0)])
def test_quantize_acts_bitwise_with_jax(shape, scale):
    x = _rand(shape, 1, scale)
    x[0, ..., :7] = 0.0
    jc, js = jref.quantize_acts_ref(jnp.asarray(x))
    tc, ts = quantize_acts_ref(torch.as_tensor(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_acts_zero_row_and_bf16():
    x = np.zeros((3, 64), np.float32)
    tc, ts = quantize_acts_ref(torch.as_tensor(x))
    assert not tc.any() and (ts == 1).all()
    xb = torch.as_tensor(_rand((4, 128), 2)).to(torch.bfloat16)
    jc, js = jref.quantize_acts_ref(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16))
    tc, ts = quantize_acts_ref(xb)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --------------------------------------------------------------------------
# the integer-activation matmul: plain version vs JAX oracle and kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block_k", [-1, 64])
@pytest.mark.parametrize("m", [1, 5, 128])
def test_wqt_matmul_a8_plain_matches_jax_oracle(bits, block_k, m):
    k, n = 256, 128
    xq, xs = _acts(m, k, 2)
    codes, scales = _out_major(k, n, bits, block_k, 3)
    want = np.asarray(jref.wqt_matmul_a8_ref(
        jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(codes),
        jnp.asarray(scales), block_k, bits == 4))
    got = wqt_matmul_a8(torch.as_tensor(xq), torch.as_tensor(xs),
                        torch.as_tensor(codes), torch.as_tensor(scales),
                        block_k, bits).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    if block_k == -1:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block_k", [-1, 64])
@pytest.mark.parametrize("m", [1, 5, 128])
def test_wqt_matmul_a8_plain_matches_pallas(bits, block_k, m):
    k, n = 256, 128
    xq, xs = _acts(m, k, 4)
    codes, scales = _out_major(k, n, bits, block_k, 5)
    want = np.asarray(jax_wqt_matmul_a8(
        jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(codes),
        jnp.asarray(scales), block_k=block_k, bits=bits))
    got = wqt_matmul_a8_ref(torch.as_tensor(xq), torch.as_tensor(xs),
                            torch.as_tensor(codes), torch.as_tensor(scales),
                            block_k, bits == 4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_wqt_matmul_a8_stacked_leading_dims_match_jax():
    """The plain version takes leading batch dims like the JAX oracle."""
    xq, xs = _acts(6, 128, 6)
    codes, scales = _out_major(128, 32, 4, 32, 7)
    xq3, xs3 = xq.reshape(2, 3, 128), xs.reshape(2, 3, 1)
    want = np.asarray(jref.wqt_matmul_a8_ref(
        jnp.asarray(xq3), jnp.asarray(xs3), jnp.asarray(codes),
        jnp.asarray(scales), 32, True))
    got = wqt_matmul_a8_ref(torch.as_tensor(xq3), torch.as_tensor(xs3),
                            torch.as_tensor(codes), torch.as_tensor(scales),
                            32, True).numpy()
    assert _rel(got, want) < 1e-6


def test_wqt_matmul_a8_wrapper_checks_shapes():
    xq = torch.zeros((4, 64), dtype=torch.int8)
    codes = torch.zeros((8, 32), dtype=torch.uint8)
    scales = torch.ones((1, 1))
    with pytest.raises(ValueError, match="xs"):
        wqt_matmul_a8(xq, torch.ones((4, 2)), codes, scales, -1, 4)
    with pytest.raises(ValueError, match="int8 codes"):
        wqt_matmul_a8(xq.float(), torch.ones((4, 1)), codes, scales, -1, 4)
    with pytest.raises(ValueError, match="uint8"):
        wqt_matmul_a8(xq, torch.ones((4, 1)), codes.to(torch.int8), scales,
                      -1, 4)


# --------------------------------------------------------------------------
# the K-major layout: pack_weight, dequant, wq_matmul
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block_k", [32, 128])
def test_pack_weight_bitwise_with_jax(bits, block_k):
    w = _rand((256, 96), 8)
    w[:block_k, 3] = 0.0                       # an all-zero block
    jc, js = jax_pack_weight(jnp.asarray(w), block_k=block_k, bits=bits)
    tc, ts = pack_weight(torch.as_tensor(w), block_k, bits)
    assert tc.dtype == (torch.uint8 if bits == 4 else torch.int8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequant_ref(tc, ts, block_k, bits == 4).numpy(),
        np.asarray(jref.dequant_ref(jc, js, block_k, bits == 4)))
    tc2, ts2 = quantize_weights_ref(torch.as_tensor(w), block_k, bits)
    assert torch.equal(tc2, tc) and torch.equal(ts2, ts)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mnk", [(32, 256, 256), (8, 128, 384),
                                 (130, 512, 256)])
def test_wq_matmul_matches_jax_oracle_and_pallas(bits, mnk):
    m, n, k = mnk
    x = _rand((m, k), 10)
    jc, js = jax_pack_weight(jnp.asarray(_rand((k, n), 11)), block_k=128,
                             bits=bits)
    got = wq_matmul(torch.as_tensor(x), torch.as_tensor(np.array(jc)),
                    torch.as_tensor(np.array(js)), 128, bits).numpy()
    oracle = np.asarray(jref.wq_matmul_ref(jnp.asarray(x), jc, js, 128,
                                           bits == 4))
    assert got.shape == (m, n)
    assert _rel(got, oracle) < 1e-5
    pallas = np.asarray(jax_wq_matmul(jnp.asarray(x), jc, js, block_k=128,
                                      bits=bits))
    np.testing.assert_allclose(got, pallas, atol=1e-4 * np.abs(pallas).max(),
                               rtol=1e-4)


def test_wq_matmul_wrapper_checks_shapes():
    x = torch.zeros((2, 64))
    codes, scales = pack_weight(torch.zeros((64, 16)), 32, 4)
    with pytest.raises(ValueError, match="K-major codes"):
        wq_matmul(x, codes.T.contiguous(), scales, 32, 4)
    with pytest.raises(ValueError, match="scales"):
        wq_matmul(x, codes, scales.T.contiguous(), 32, 4)
    with pytest.raises(ValueError, match="block_k"):
        wq_matmul(x, codes, scales, 48, 4)
    assert wq_matmul_ref(x, codes, scales, 32, True).shape == (2, 16)


# --------------------------------------------------------------------------
# matmul() plumbing: the act-fmt context
# --------------------------------------------------------------------------

def test_act_fmt_context_and_rejection():
    assert tqt.act_fmt_enabled() is None
    with pytest.raises(ValueError, match="act_fmt"):
        with tqt.qtensor_act_fmt("int4"):
            pass
    with tqt.qtensor_act_fmt("int8"):
        assert tqt.act_fmt_enabled() == "int8"
        with tqt.qtensor_act_fmt(None):
            assert tqt.act_fmt_enabled() is None
        assert tqt.act_fmt_enabled() == "int8"
    assert tqt.act_fmt_enabled() is None
    tqt.set_qtensor_act_fmt("int8")
    try:
        assert tqt.act_fmt_enabled() == "int8"
    finally:
        tqt.set_qtensor_act_fmt(None)
    with pytest.raises(ValueError):
        tqt.set_qtensor_act_fmt("fp8")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block_k", [-1, 32])
def test_matmul_under_int8_acts_matches_jax(bits, block_k):
    from repro.core.qtensor import from_matmul_weight as jfrom
    from repro.core.qtensor import matmul as jmatmul
    from repro.core.qtensor import qtensor_act_fmt as jact
    w, x = _rand((128, 48), 12), _rand((2, 3, 128), 13)
    jq = jfrom(jnp.asarray(w), f"int{bits}", block_k)
    tq = tqt.from_matmul_weight(torch.as_tensor(w), f"int{bits}", block_k)
    with jact("int8"):
        want = np.asarray(jmatmul(jnp.asarray(x), jq))
    with tqt.qtensor_act_fmt("int8"):
        got = tqt.matmul(torch.as_tensor(x), tq).numpy()
    dense = tqt.matmul(torch.as_tensor(x), tq).numpy()
    assert got.shape == want.shape == (2, 3, 48)
    if block_k == -1:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) < 1e-6
    assert not np.array_equal(got, dense)       # the int8 path ran


# --------------------------------------------------------------------------
# end to end: the Engine under W4A8
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(name):
    from repro.configs import get_smoke_config
    jcfg = SERVE_CFG if name == "serve" else get_smoke_config(name)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.lm_config(jcfg), tparams


@pytest.mark.parametrize("weights", ["rtn:int8", "rtn:int4"])
@pytest.mark.parametrize("kv_quant", [False, "int8"])
def test_engine_w4a8_tokens_match_jax(weights, kv_quant):
    jcfg, jparams, tcfg, tparams = _setup("serve")
    kw = dict(weights=weights, kv_quant=kv_quant, act_fmt="int8",
              max_new_tokens=8)
    want = JEngine(jcfg, jparams, JServeConfig(**kw)).generate(PROMPTS)
    got = Engine(tcfg, tparams, ServeConfig(**kw),
                 device="cpu").generate(PROMPTS)
    assert got == want


def test_engine_w4a8_granite_smoke_matches_jax_and_counts_nothing():
    jcfg, jparams, tcfg, tparams = _setup("granite-3-2b")
    kw = dict(weights="rtn:int4", kv_quant="int8", act_fmt="int8",
              max_new_tokens=6)
    want = JEngine(jcfg, jparams, JServeConfig(**kw)).generate(PROMPTS)
    reset_launch_counts()
    got = Engine(tcfg, tparams, ServeConfig(**kw),
                 device="cpu").generate(PROMPTS)
    assert got == want
    assert set(launch_counts().values()) == {0}    # CPU: plain versions
    assert tqt.act_fmt_enabled() is None           # the context unwound


def test_engine_rejects_unknown_act_fmt():
    _, _, tcfg, tparams = _setup("serve")
    with pytest.raises(ValueError, match="act_fmt"):
        Engine(tcfg, tparams, ServeConfig(act_fmt="int4"), device="cpu")
