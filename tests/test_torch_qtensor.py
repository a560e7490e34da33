"""The port's QTensor storage and serving packer against the JAX package:
codes and scales must match bit for bit (elementwise absmax, division,
round-half-to-even and clip on the same fp32 inputs), for 2-D and stacked
3-D leaves, per-matrix and blockwise, int8 and int4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as jqt
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.core.quantize import cast_rtn as jax_cast_rtn
from repro.core.formats import get_format as jax_get_format
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.core import qtensor as tqt
from repro_torch.core.formats import get_format
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantize import cast_rtn
from repro_torch.models import layers as tlayers

CFG = jlm.LMConfig(name="q", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=64, dtype=jnp.float32, remat=False)


def _eq(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("shape", [(24, 32), (3, 24, 32)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block_k", [-1, 8])
def test_quantize_qtensor_bitwise(shape, bits, block_k):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w[..., 0, :] *= 10.0                      # an outlier row
    want = jqt.quantize_qtensor(jnp.asarray(w), f"int{bits}", block_k)
    got = tqt.quantize_qtensor(torch.as_tensor(w), f"int{bits}", block_k)
    _eq(got.codes, want.codes)
    _eq(got.scales, want.scales)
    assert (got.fmt_name, got.bits, got.block_k) == \
        (want.fmt_name, want.bits, want.block_k)
    assert got.shape == want.shape and got.nbytes == want.nbytes
    _eq(got.dequantize(), want.dequantize())
    if len(shape) == 3:
        lay = got.layer(1)
        assert lay.codes.ndim == 2
        _eq(lay.dequantize(), want.dequantize()[1])


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("block", [-1, 16, 24])
def test_quantize_params_bitwise(fmt, block):
    """block 24 divides no K here: every weight takes the dense RTN cast."""
    jparams = jlm.lm_init(jax.random.PRNGKey(1), CFG)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    jq = jqt.quantize_params(jparams, fmt, JQuantPolicy(), block)
    tq = tqt.quantize_params(tparams, fmt, QuantPolicy(), block)
    jflat = bridge.flatten(jax.tree.map(np.asarray, jq))
    tflat = bridge.flatten(tq)
    assert jflat.keys() == tflat.keys()
    n_qt = 0
    for k, j in jflat.items():
        t = tflat[k]
        if isinstance(t, tqt.QTensor):
            n_qt += 1
            _eq(t.codes, j.codes)
            _eq(t.scales, j.scales)
        else:
            _eq(t, j)
    assert n_qt == (0 if block == 24 else 7)
    assert tqt.param_nbytes(tq) == jqt.param_nbytes(jq)
    jd = bridge.flatten(jax.tree.map(np.asarray, jqt.dequantize_params(jq)))
    for k, t in bridge.flatten(tqt.dequantize_params(tq)).items():
        _eq(t, jd[k])


def test_quantize_params_with_embeddings():
    jparams = jlm.lm_init(jax.random.PRNGKey(1), CFG)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    pol_j, pol_t = (JQuantPolicy(include_embeddings=True),
                    QuantPolicy(include_embeddings=True))
    jq = jqt.quantize_params(jparams, "int4", pol_j)
    tq = tqt.quantize_params(tparams, "int4", pol_t)
    assert isinstance(tq["embed"], tqt.QTensor)
    _eq(tq["embed"].codes, jq["embed"].codes)
    idx = np.array([[0, 5, 63], [7, 7, 1]])
    _eq(tq["embed"].take(torch.as_tensor(idx)),
        jq["embed"].take(jnp.asarray(idx)))


@pytest.mark.parametrize("block", [-1, 16, 100])
@pytest.mark.parametrize("shape", [(40, 24), (2, 40, 24), (37,)])
def test_cast_rtn_bitwise(block, shape):
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = jax_cast_rtn(jnp.asarray(w), jax_get_format("int4"), block)
    _eq(cast_rtn(torch.as_tensor(w), get_format("int4"), block), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_layers_matmul_matches_jax(bits):
    from repro.models.layers import matmul as jax_matmul
    w = np.random.default_rng(3).normal(size=(64, 40)).astype(np.float32)
    x = np.random.default_rng(4).normal(size=(2, 3, 64)).astype(np.float32)
    jq = jqt.from_matmul_weight(jnp.asarray(w), f"int{bits}")
    tq = tqt.from_matmul_weight(torch.as_tensor(w), f"int{bits}")
    want = np.asarray(jax_matmul(jnp.asarray(x), jq))
    got = tlayers.matmul(torch.as_tensor(x), tq).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_policy_eligibility_matches_jax():
    jparams = jlm.lm_init(jax.random.PRNGKey(1), CFG)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    for inc in (False, True):
        jmask = bridge.flatten(JQuantPolicy(
            include_embeddings=inc).eligible_mask(jparams))
        tpol = QuantPolicy(include_embeddings=inc)
        tmask = {}
        from repro_torch.core.policy import tree_map_with_path
        tree_map_with_path(lambda p, x: tmask.__setitem__(
            "/".join(p).lower(), tpol.eligible(p, x)), tparams)
        assert tmask == {k: bool(v) for k, v in jmask.items()}


def test_unsupported_storage_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tqt.quantize_params({}, "int4", mode="rr")
    qt = tqt.quantize_qtensor(torch.zeros(2, 4, 8), "int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tqt.matmul(torch.zeros(2, 3, 8), qt)
