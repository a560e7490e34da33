"""The port's quantization casts and the ``quant`` kernel's plain path
against the JAX package on the CPU.

Inputs come from numpy seeds.  Tolerance: none.  RTN casts, RR casts fed
the uniforms JAX draws, FP4 brackets, codes and per-block scales are
bitwise equal to ``repro.core`` (``core/quantize.py``'s contract: one
scale per matrix of a stacked leaf, the RR threshold in w-space).  The
Pallas wrapper ``kernels/quant/ops.py::quant_rtn`` (interpret mode) is
compared on 2-D inputs only (for ``block_size=-1`` it takes one scale over
the whole tensor, not one per matrix): the same rounding decision for
every element, values within 2 ulps (see that test for why not bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import modes as jmodes
from repro.core import quantize as jq
from repro.core.policy import QuantPolicy as JPolicy
from repro.kernels.quant import quant_rtn as j_quant_rtn
from repro_torch import bridge
from repro_torch.core import formats as tformats
from repro_torch.core import modes as tmodes
from repro_torch.core import quantize as tq
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.quant import quant_rr, quant_rtn

FMTS = ["int4", "int8", "fp4"]
SHAPES = [(8, 256), (3, 5, 256), (64, 384), (7, 33), (2, 3, 4, 40)]
BLOCKS = [-1, 128, 100]


def _w(shape, seed=0, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bs", BLOCKS)
@pytest.mark.parametrize("fmt", FMTS)
def test_cast_rtn_and_quant_rtn_bitwise(fmt, bs, shape):
    w = _w(shape)
    want = jq.cast_rtn(jnp.asarray(w), jformats.get_format(fmt), bs)
    _eq(tq.cast_rtn(torch.from_numpy(w), tformats.get_format(fmt), bs),
        want)
    _eq(quant_rtn(torch.from_numpy(w), fmt, bs), want)


@pytest.mark.parametrize("bs", BLOCKS)
@pytest.mark.parametrize("fmt", FMTS)
def test_rr_neighbors_variance_and_scales_bitwise(fmt, bs):
    w = _w((3, 16, 40), seed=1)
    jf, tf = jformats.get_format(fmt), tformats.get_format(fmt)
    jlo, jhi = jq.rr_neighbors(jnp.asarray(w), jf, bs)
    tlo, thi = tq.rr_neighbors(torch.from_numpy(w), tf, bs)
    _eq(tlo, jlo)
    _eq(thi, jhi)
    _eq(tq.rr_variance(torch.from_numpy(w), tf, bs),
        jq.rr_variance(jnp.asarray(w), jf, bs))
    _eq(tq.block_scales(torch.from_numpy(w), tf, bs),
        jq.block_scales(jnp.asarray(w), jf, bs))


def test_fp4_brackets_on_codes_zero_and_edges():
    """Values exactly on the e2m1 grid (0, +-6 s, interior codes) bracket
    to themselves, as jnp.searchsorted does; the rest bracket between
    neighbours."""
    s = np.float32(0.25)
    codes = np.asarray(jformats.FP4_E2M1.codes, np.float32)
    w = np.concatenate([codes * s, codes[:-1] * s + 0.03, [-0.0, 7.0, -9.0]]
                       ).astype(np.float32)
    jlo, jhi = jformats.FP4_E2M1.neighbors(jnp.asarray(w), jnp.float32(s))
    tlo, thi = tformats.FP4_E2M1.neighbors(torch.from_numpy(w),
                                           torch.tensor(s))
    _eq(tlo, jlo)
    _eq(thi, jhi)
    assert tformats.FP4_E2M1.codes == jformats.FP4_E2M1.codes


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_codes_and_dequantize_match_jax(fmt):
    w = _w((16, 64), seed=2)
    jf, tf = jformats.get_format(fmt), tformats.get_format(fmt)
    s = np.float32(np.abs(w).max() / jf.qmax)
    jc = jf.quantize_codes(jnp.asarray(w), jnp.float32(s))
    tc = tf.quantize_codes(torch.from_numpy(w), torch.tensor(s))
    _eq(tc, jc)
    _eq(tf.dequantize(tc, torch.tensor(s)), jf.dequantize(jc, jnp.float32(s)))


@pytest.mark.parametrize("bs", [-1, 128])
@pytest.mark.parametrize("fmt", FMTS)
def test_quant_rtn_matches_pallas_wrapper_on_2d(fmt, bs):
    """Same rounding decision for every element as the Pallas wrapper
    (interpret mode), values within 2 ulps.  Not bitwise: under jit XLA
    computes the wrapper's per-tensor scale as absmax * (1/qmax) and the
    kernel's w / s as w * (1/s), so the Pallas cast is itself an ulp of the
    scale away from core/quantize.py, which the port follows bitwise."""
    w = _w((16, 512), seed=3)
    got = quant_rtn(torch.from_numpy(w), fmt, bs).numpy()
    want = np.asarray(j_quant_rtn(jnp.asarray(w), fmt_name=fmt,
                                  block_size=bs))
    lo, hi = (np.asarray(a) for a in jq.rr_neighbors(
        jnp.asarray(w), jformats.get_format(fmt), bs))

    def side(q):
        return np.abs(q - lo) <= np.abs(hi - q)

    np.testing.assert_array_equal(side(got), side(want))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)


def _jax_rr_uniforms(jparams, key, policy, bs):
    """The uniforms JAX's cast_params(mode="rr") draws: leaf i (in JAX's
    tree order, counting eligible leaves from 1) from fold_in(key, i), in
    the blocked shape for blockwise casts; returned in each leaf's shape,
    keyed by path."""
    out, counter = {}, [0]

    def leaf(path, x):
        if not policy.eligible(path, x):
            return x
        counter[0] += 1
        k = jax.random.fold_in(key, counter[0])
        if bs == -1:
            u = jax.random.uniform(k, x.shape, dtype=x.dtype)
        else:
            blocked, _, _ = jq._block_view(x, bs)
            u = jax.random.uniform(k, blocked.shape, dtype=x.dtype)
            u = u.reshape(-1)[: x.size].reshape(x.shape)
        out["/".join(str(p.key) for p in path).lower()] = torch.from_numpy(
            np.asarray(u).copy())
        return x

    jax.tree_util.tree_map_with_path(leaf, jparams)
    return out


@pytest.mark.parametrize("bs", [-1, 128, 100])
@pytest.mark.parametrize("fmt", FMTS)
def test_rr_cast_params_bitwise_with_jax_uniforms(fmt, bs):
    rng = np.random.default_rng(4)
    jparams = {"layer": {"w_up": jnp.asarray(rng.standard_normal(
        (3, 32, 48)).astype(np.float32)),
        "wq": jnp.asarray(rng.standard_normal((40, 64)).astype(np.float32))},
        "norm_scale": jnp.ones((64,), jnp.float32)}
    key = jax.random.PRNGKey(7)
    jpol, tpol = JPolicy(min_size=256), QuantPolicy(min_size=256)
    want = jmodes.cast_params(jparams, jformats.get_format(fmt), jpol, bs,
                              mode="rr", key=key)
    uniforms = _jax_rr_uniforms(jparams, key, jpol, bs)
    assert len(uniforms) == 2
    got = tmodes.cast_params(bridge.to_torch(jax.tree.map(np.asarray,
                                                          jparams)),
                             tformats.get_format(fmt), tpol, bs, mode="rr",
                             uniforms=uniforms)
    for k, v in bridge.flatten(jax.tree.map(np.asarray, want)).items():
        _eq(bridge.flatten(got)[k], v)


def test_cast_params_rtn_matches_jax_and_counts_nothing_on_cpu():
    rng = np.random.default_rng(5)
    jparams = {"a": {"w": jnp.asarray(rng.standard_normal((4, 32, 64))
                                      .astype(np.float32))},
               "embed": jnp.asarray(rng.standard_normal((50, 64))
                                    .astype(np.float32))}
    want = jmodes.cast_params(jparams, jformats.get_format("int4"),
                              JPolicy(), -1, mode="rtn")
    reset_launch_counts()
    got = tmodes.cast_params(bridge.to_torch(jax.tree.map(np.asarray,
                                                          jparams)),
                             "int4", QuantPolicy(), -1, mode="rtn")
    assert set(launch_counts().values()) == {0}
    for k, v in bridge.flatten(jax.tree.map(np.asarray, want)).items():
        _eq(bridge.flatten(got)[k], v)


def test_rr_from_a_generator_is_unbiased_and_reproducible():
    w = torch.from_numpy(_w((64, 256), seed=6))
    tf = tformats.get_format("int4")
    draws = torch.stack([
        tq.cast_rr(w, tf, torch.rand(w.shape, generator=g), 128)
        for g in [torch.Generator().manual_seed(i) for i in range(400)]])
    se = torch.sqrt(tq.rr_variance(w, tf, 128) / 400) + 1e-7
    assert ((draws.mean(0) - w).abs() < 6 * se + 1e-4).float().mean() > 0.98
    p = {"m": {"w": w}}
    a = tmodes.cast_params(p, "int4", QuantPolicy(), 128, mode="rr",
                           generator=torch.Generator().manual_seed(1))
    b = tmodes.cast_params(p, "int4", QuantPolicy(), 128, mode="rr",
                           generator=torch.Generator().manual_seed(1))
    assert torch.equal(a["m"]["w"], b["m"]["w"])


def test_wrappers_reject_bad_inputs():
    w = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        quant_rr(w, torch.zeros(4, 9), "int4", -1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        quant_rtn(torch.zeros(4, 8, device="meta"), "int4", -1)
    with pytest.raises(ValueError, match="RR cast needs"):
        tmodes.cast_params({"w": w}, "int4", QuantPolicy(min_size=1),
                           mode="rr")
    with pytest.raises(ValueError, match="unknown quantization format"):
        tformats.get_format("int3")
