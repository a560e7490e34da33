"""The port's fused decode attention against the JAX package on the CPU.

Inputs (queries, and K/V quantized by the JAX ``kv_quantize``) come from
numpy.  The port's plain version (``decode_attn_ref``, which its wrapper
takes for CPU tensors) is held to the JAX oracle and to the JAX Pallas
kernel in interpret mode.  Tolerance: 1e-5 relative to the output's max
(fp32 summation order; the kernel's online softmax against the dense
one).  The quantizer, the int4 packing and the ring-validity mask must
match bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import decode_attn as jax_decode_attn
from repro.kernels.decode_attn import decode_attn_ref as jax_decode_attn_ref
from repro.kernels.decode_attn.ref import ring_validity as jax_ring_validity
from repro.kernels.decode_attn.ref import unpack_int4_ref as jax_unpack
from repro.models import layers as jlayers
from repro_torch.kernels.decode_attn import (decode_attn, ring_validity,
                                             unpack_int4_ref)
from repro_torch.models import layers as tlayers

B, L, G, HD = 3, 48, 2, 16
POS = (5, 47, 130)             # partially filled, exactly full, wrapped ring


def _kv(seed, bits):
    x = np.random.default_rng(seed).normal(size=(B, L, G, HD))
    q = jlayers.kv_quantize(jnp.asarray(x, jnp.float32), bits)
    return q["codes"], q["scale"]


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_decode_attn_ref_matches_jax(bits, rep, window, softcap):
    kc, ks = _kv(1, bits)
    vc, vs = _kv(2, bits)
    q = np.random.default_rng(3).normal(size=(B, G, rep, HD)).astype(
        np.float32)
    pos = np.asarray(POS, np.int32)
    kw = dict(bits=bits, window=window, softcap=softcap)
    want = jax_decode_attn_ref(jnp.asarray(q), kc, ks, vc, vs,
                               jnp.asarray(pos), **kw)
    kern = jax_decode_attn(jnp.asarray(q), kc, ks, vc, vs, jnp.asarray(pos),
                           block_l=16, **kw)            # interpret mode
    got = decode_attn(_t(q), _t(kc), _t(ks), _t(vc), _t(vs), _t(pos), **kw)
    assert tuple(got.shape) == (B, G, rep, HD)
    assert _rel(got.numpy(), want) < 1e-5
    assert _rel(got.numpy(), kern) < 1e-5


@pytest.mark.parametrize("window", [None, 1, 8, 100])
def test_ring_validity_bitwise(window):
    pos = np.array([0, 5, 47, 48, 130, 1000], np.int32)
    want = np.asarray(jax_ring_validity(jnp.asarray(pos), L, window))
    got = ring_validity(torch.as_tensor(pos), L, window).numpy()
    np.testing.assert_array_equal(got, want)


def test_unpack_int4_bitwise():
    packed = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = np.asarray(jax_unpack(jnp.asarray(packed)))
    np.testing.assert_array_equal(unpack_int4_ref(_t(packed)).numpy(), want)
    np.testing.assert_array_equal(tlayers._unpack_int4(_t(packed)).numpy(),
                                  want)


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quantize_and_pack_bitwise(bits):
    x = np.random.default_rng(4).normal(size=(2, 5, G, HD)).astype(np.float32)
    x[0, 0] = 0.0                             # an all-zero vector: scale 1
    want = jlayers.kv_quantize(jnp.asarray(x), bits)
    got = tlayers.kv_quantize(torch.as_tensor(x), bits)
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(want["codes"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    codes = np.random.default_rng(5).integers(-7, 8, size=(4, HD)).astype(
        np.int8)
    np.testing.assert_array_equal(
        tlayers._pack_int4(torch.as_tensor(codes)).numpy(),
        np.asarray(jlayers._pack_int4(jnp.asarray(codes))))


def test_wrapper_rejects_bad_layouts():
    kc, ks = _kv(1, 4)
    q = torch.zeros(B, G, 2, HD)
    with pytest.raises(ValueError, match="k_codes"):
        decode_attn(q, _t(kc), _t(ks), _t(kc), _t(ks), torch.zeros(B),
                    bits=8)
    with pytest.raises(ValueError, match="pos"):
        decode_attn(q, _t(kc), _t(ks), _t(kc), _t(ks), torch.zeros(B + 1),
                    bits=4)
