"""The port's weight-quantized matmul against the JAX package on the CPU.

Inputs come from numpy; the port's plain version (``wqt_matmul_ref``,
which its wrapper takes for CPU tensors) is held to the JAX oracle and to
the JAX Pallas kernel run in interpret mode.  Tolerance: 1e-5 relative to
the output's max, for the summation order of fp32 contractions.
Dequantization is elementwise and must match bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qtensor import from_matmul_weight as jax_from_matmul_weight
from repro.kernels.wq_matmul import wqt_matmul as jax_wqt_matmul
from repro.kernels.wq_matmul.ref import dequant_t_ref as jax_dequant_t_ref
from repro.kernels.wq_matmul.ref import wqt_matmul_ref as jax_wqt_matmul_ref
from repro_torch.kernels.wq_matmul import (dequant_t_ref, wqt_matmul,
                                           wqt_matmul_ref)

K = 64
RTOL = 1e-5


def _qt(n, bits, block_k, seed=0):
    w = np.random.default_rng(seed).normal(size=(K, n)).astype(np.float32)
    qt = jax_from_matmul_weight(jnp.asarray(w), f"int{bits}", block_k)
    return qt, torch.tensor(np.asarray(qt.codes)), \
        torch.tensor(np.asarray(qt.scales))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block_k", [-1, 16])
@pytest.mark.parametrize("m", [1, 5, 130])
def test_wqt_matmul_ref_matches_jax(bits, block_k, m):
    n = 37                                     # ragged N
    qt, codes, scales = _qt(n, bits, block_k)
    x = np.random.default_rng(1).normal(size=(m, K)).astype(np.float32)
    want = jax_wqt_matmul_ref(jnp.asarray(x), qt.codes, qt.scales, block_k,
                              bits == 4)
    got = wqt_matmul(torch.as_tensor(x), codes, scales, block_k=block_k,
                     bits=bits)
    assert tuple(got.shape) == (m, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < RTOL
    kern = jax_wqt_matmul(jnp.asarray(x), qt.codes, qt.scales,
                          block_k=block_k, bits=bits)      # interpret mode
    assert _rel(got.numpy(), kern) < RTOL


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block_k", [-1, 16])
def test_dequant_t_ref_bitwise(bits, block_k):
    qt, codes, scales = _qt(24, bits, block_k)
    want = np.asarray(jax_dequant_t_ref(qt.codes, qt.scales, block_k,
                                        bits == 4))
    got = dequant_t_ref(codes, scales, block_k, bits == 4).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_casts_like_x():
    qt, codes, scales = _qt(8, 4, -1)
    x = torch.randn(3, K, generator=torch.Generator().manual_seed(0))
    out = wqt_matmul(x.to(torch.bfloat16), codes, scales, bits=4)
    assert out.dtype == torch.bfloat16
    ref = wqt_matmul_ref(x.to(torch.bfloat16), codes, scales, -1, True)
    assert torch.equal(out, ref)


def test_wrapper_rejects_bad_inputs():
    qt, codes, scales = _qt(8, 4, 16)
    x = torch.zeros(2, K)
    with pytest.raises(ValueError, match="even K"):
        wqt_matmul(torch.zeros(2, K - 1), codes, scales, block_k=16, bits=4)
    with pytest.raises(ValueError, match="divisible"):
        wqt_matmul(x, codes, scales, block_k=24, bits=4)
    with pytest.raises(ValueError, match="int8 codes"):
        wqt_matmul(x, codes, scales, block_k=16, bits=8)
    with pytest.raises(ValueError, match="bits"):
        wqt_matmul(x, codes, scales, block_k=16, bits=2)
