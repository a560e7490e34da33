"""The port's straight-through estimators, training-mode transforms,
bf16 activation cast and storage helpers against the JAX package on the
CPU.

Inputs come from numpy seeds; RR is fed the uniforms JAX draws (in the
padded block shape for blockwise casts, flattened and cut to the
tensor's size).  Tolerance: none.  ``fake_quant_rtn`` / ``fake_quant_rr``
forward values and the gradient reaching ``w``, ``forward_params`` trees,
the bf16 ``cast_rtn`` (one rounding to bf16 per operation, as XLA's CPU
backend gives for ``repro.core.quantize.cast_rtn`` on a bf16 array, jitted
or not) and ``scales_like`` / ``pack_int4`` / ``unpack_int4`` /
``quantize_store`` / ``dequantize_store`` / ``bits_of`` are bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import modes as jmodes
from repro.core import quantize as jq
from repro.core import ste as jste
from repro.core.modes import QuantConfig as JQuantConfig
from repro.core.policy import QuantPolicy as JPolicy
from repro.configs import get_smoke_config as j_smoke
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.core import formats as tformats
from repro_torch.core import modes as tmodes
from repro_torch.core import quantize as tq
from repro_torch.core import ste as tste
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels.quant import ops as quant_ops

FMTS = ["int4", "int8", "fp4"]
SHAPES = [(1000,), (48, 40), (3, 32, 48)]
BLOCKS = [-1, 64]


def _w(shape, seed=0, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _eq(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b))


def _jax_uniforms(key, x, bs):
    """What JAX's cast_rr draws for ``x``: in x's shape (per tensor) or in
    the padded block shape (blockwise), returned in x's shape."""
    if bs == -1:
        return np.array(jax.random.uniform(key, x.shape, dtype=x.dtype))
    blocked, _, _ = jq._block_view(x, bs)
    u = np.array(jax.random.uniform(key, blocked.shape, dtype=x.dtype))
    return u.reshape(-1)[: x.size].reshape(x.shape)


def _jax_vjp(fn, w, g):
    out, vjp = jax.vjp(fn, w)
    return out, vjp(g)[0]


def _torch_vjp(fn, w, g):
    wt = torch.from_numpy(w).requires_grad_(True)
    out = fn(wt)
    out.backward(torch.from_numpy(g))
    return out, wt.grad


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bs", BLOCKS)
@pytest.mark.parametrize("fmt", FMTS)
def test_fake_quant_rtn_forward_and_grad_bitwise(fmt, bs, shape):
    w, g = _w(shape), _w(shape, seed=1)
    jf = jformats.get_format(fmt)
    jout, jgrad = _jax_vjp(lambda x: jste.fake_quant_rtn(x, jf, bs),
                           jnp.asarray(w), jnp.asarray(g))
    tout, tgrad = _torch_vjp(
        lambda x: tste.fake_quant_rtn(x, tformats.get_format(fmt), bs), w, g)
    _eq(tout, jout)
    _eq(tgrad, jgrad)
    _eq(tgrad, g)            # the STE: the upstream gradient, unchanged


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bs", BLOCKS)
@pytest.mark.parametrize("fmt", FMTS)
def test_fake_quant_rr_forward_and_grad_bitwise(fmt, bs, shape):
    w, g = _w(shape, seed=2), _w(shape, seed=3)
    jf, key = jformats.get_format(fmt), jax.random.PRNGKey(7)
    u = torch.from_numpy(_jax_uniforms(key, jnp.asarray(w), bs))
    jout, jgrad = _jax_vjp(lambda x: jste.fake_quant_rr(x, jf, key, bs),
                           jnp.asarray(w), jnp.asarray(g))
    tout, tgrad = _torch_vjp(lambda x: tste.fake_quant_rr(x, fmt, u, bs),
                             w, g)
    _eq(tout, jout)
    _eq(tgrad, jgrad)


def test_ste_keeps_no_tensor_for_backward():
    w = torch.from_numpy(_w((8, 64))).requires_grad_(True)
    out = tste.fake_quant_rtn(w, "int4")
    assert out.grad_fn.saved_tensors == ()
    assert not torch.equal(out.detach(), w.detach())


def _bf16_acts(shape, seed, scale):
    x = _w(shape, seed=seed, scale=scale)
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    return jx, bridge._tensor(np.asarray(jx), "cpu")


@pytest.mark.parametrize("shape", [(4, 32, 64), (2, 1, 128)])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_bf16_cast_rtn_matches_jax_bitwise(fmt, shape):
    """The plain version of the bf16 instance (``cast_rtn`` on a bf16
    tensor, per batch row) against JAX's bf16 cast, eager and jitted, and
    the bf16 STE's gradient."""
    jf, tf = jformats.get_format(fmt), tformats.get_format(fmt)
    for seed, scale in ((0, 1.0), (1, 37.0), (2, 1e-3)):
        jx, tx = _bf16_acts(shape, seed, scale)
        want = jq.cast_rtn(jx, jf, -1)
        assert want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(jax.jit(lambda a: jq.cast_rtn(a, jf, -1))(jx)),
            np.asarray(want))
        got = tq.cast_rtn(tx, tf, -1)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(bridge._array(got), np.asarray(want))
        np.testing.assert_array_equal(
            bridge._array(quant_ops.quant_rtn(tx, fmt, -1)),
            np.asarray(want))
        g = tx.flip(-1)
        wt = tx.clone().requires_grad_(True)
        out = tste.fake_quant_rtn(wt, fmt)
        out.backward(g)
        np.testing.assert_array_equal(bridge._array(out), np.asarray(want))
        assert torch.equal(wt.grad.view(torch.int16), g.view(torch.int16))


def test_bf16_wrapper_refuses_what_the_instance_lacks():
    for rr, bs, fmt in ((True, -1, "int4"), (False, 128, "int4"),
                        (False, -1, "fp4")):
        with pytest.raises(ValueError, match="bf16"):
            quant_ops._check_bf16("quant_rtn", rr,
                                  tformats.get_format(fmt), bs)


@pytest.fixture(scope="module")
def smoke_params():
    jparams = jlm.lm_init(jax.random.PRNGKey(3), j_smoke("granite-3-2b"))
    return jparams, bridge.to_torch(jax.tree.map(np.asarray, jparams))


def _jax_forward_uniforms(jparams, key, policy):
    """The per-leaf uniforms JAX's forward_params(method="rat") draws:
    eligible leaf i (JAX's tree order, from 1) from fold_in(key, i)."""
    out, counter = {}, [0]

    def leaf(path, x):
        if policy.eligible(path, x):
            counter[0] += 1
            out["/".join(str(p.key) for p in path).lower()] = \
                torch.from_numpy(np.array(jax.random.uniform(
                    jax.random.fold_in(key, counter[0]), x.shape, x.dtype)))
        return x

    jax.tree_util.tree_map_with_path(leaf, jparams)
    return out


@pytest.mark.parametrize("method", ["qat", "rat", "lotion", "fp32", "ptq"])
def test_forward_params_trees_bitwise(smoke_params, method):
    jparams, tparams = smoke_params
    kw = dict(method=method, fmt_name="int4", lam=10.0)
    jcfg = JQuantConfig(policy=JPolicy(min_size=256), **kw)
    tcfg = tmodes.QuantConfig(policy=QuantPolicy(min_size=256), **kw)
    key = jax.random.PRNGKey(11)
    want = bridge.flatten(jmodes.forward_params(jcfg, jparams, key))
    uniforms = _jax_forward_uniforms(jparams, key, jcfg.policy)
    got = bridge.flatten(tmodes.forward_params(tcfg, tparams,
                                               uniforms=uniforms))
    assert set(got) == set(want)
    changed = 0
    for path, t in got.items():
        _eq(t, want[path])
        changed += not torch.equal(t, bridge.flatten(tparams)[path])
    assert changed == (7 if method in ("qat", "rat") else 0)
    if method == "rat":
        with pytest.raises(ValueError, match="uniforms or a generator"):
            tmodes.forward_params(tcfg, tparams)


@pytest.mark.parametrize("bs", [-1, 64, 100])
@pytest.mark.parametrize("fmt", FMTS)
def test_storage_helpers_bitwise(fmt, bs):
    jf, tf = jformats.get_format(fmt), tformats.get_format(fmt)
    for shape in ((3, 16, 40), (1000,), (7, 33)):
        w = _w(shape, seed=5)
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        _eq(tq.scales_like(tw, tf, bs), jq.scales_like(jw, jf, bs))
        jc, js, jmeta = jq.quantize_store(jw, jf, bs)
        tc, ts, tmeta = tq.quantize_store(tw, tf, bs)
        assert tc.dtype == (torch.int8 if fmt != "fp4" else torch.uint8)
        _eq(tc, jc)
        _eq(ts, js)
        assert tmeta == {k: (tuple(v) if k == "shape" else v)
                         for k, v in jmeta.items()}
        _eq(tq.dequantize_store(tc, ts, tmeta, tf),
            jq.dequantize_store(jc, js, jmeta, jf))
    assert tformats.bits_of(tf) == jformats.bits_of(jf)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1001])
def test_pack_unpack_int4_bitwise(n):
    codes = np.random.default_rng(n).integers(-7, 8, size=n).astype(np.int8)
    jp = jq.pack_int4(jnp.asarray(codes))
    tp = tq.pack_int4(torch.from_numpy(codes))
    assert tp.dtype == torch.uint8
    _eq(tp, jp)
    _eq(tq.unpack_int4(tp, n), jq.unpack_int4(jp, n))
    _eq(tq.unpack_int4(tp, n), codes)
