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


# --------------------------------------------------------------------------
# The launch plan of wqt_matmul.cu (ops.plan): which instance runs, how K
# is split, and the workspace it needs.  Pure Python, so it is tested here.
# --------------------------------------------------------------------------

from repro_torch.kernels.wq_matmul.ops import (GEMM_K, GEMV_K, SMS,  # noqa: E402
                                               launch_plan, plan)

# the Granite-3-2B layer's weights and the tied head, (N, K)
MAIN_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192),
               (49155, 2048)]
PLAN_MS = [1, 8, 12, 16, 17, 64, 1024]
DECODE_MS = [1, 8, 12, 16]
# out-major takes per-tensor and block 128 scales, K-major (wq_matmul)
# block 128 on the layer's shapes
LAYOUTS = [(False, -1), (False, 128), (True, 128)]


def _cases(ms):
    return [(shape, m, bits, kmajor, bk) for shape in MAIN_SHAPES
            for m in ms for bits in (4, 8) for kmajor, bk in LAYOUTS
            if not (kmajor and shape[0] == 49155)]


def _tiles(p, m, n):
    return -(-m // p.tile_m) * -(-n // p.tile_n)


@pytest.mark.parametrize("shape,m,bits,kmajor,block_k", _cases(PLAN_MS))
def test_plan_instance_on_main_path(shape, m, bits, kmajor, block_k):
    n, k = shape
    p = plan(m, n, k, torch.bfloat16, bits, block_k, kmajor)
    assert p.instance == ("gemv" if m <= 16 else "gemm")
    assert p.tile_k == (GEMV_K if m <= 16 else GEMM_K)
    if p.instance == "gemv":
        assert p.tile_m == (8 if m <= 8 else 16)
    # fp32 activations never take the tensor cores (TF32 breaks 1e-5)
    assert plan(m, n, k, torch.float32, bits, block_k, kmajor).instance == \
        "fma"


@pytest.mark.parametrize("case", [
    dict(M=8, N=2048, K=2048, dtype=torch.float32, block_k=128),
    dict(M=64, N=2048, K=2048, dtype=torch.float32, block_k=-1),
    dict(M=8, N=1000, K=1000, dtype=torch.bfloat16, block_k=-1,
         aligned=False),
    dict(M=130, N=1000, K=1000, dtype=torch.bfloat16, block_k=-1,
         aligned=False),
    dict(M=8, N=1000, K=1000, dtype=torch.bfloat16, block_k=8),
    dict(M=64, N=2048, K=2048, dtype=torch.bfloat16, block_k=8),
    dict(M=8, N=2048, K=2080, dtype=torch.bfloat16, block_k=-1),
], ids=["fp32", "fp32_prefill", "k1000", "k1000_prefill", "block8",
        "block8_prefill", "k_not_step"])
def test_plan_fma_instance(case):
    case = dict(case)
    aligned = case.pop("aligned", True)
    p = plan(case["M"], case["N"], case["K"], case["dtype"], 4,
             case["block_k"], aligned=aligned)
    assert p.instance == "fma"
    assert (p.tile_m, p.tile_n) == ((16, 128) if case["M"] <= 16 else (64, 64))


@pytest.mark.parametrize("shape,m,bits,kmajor,block_k", _cases(DECODE_MS))
def test_plan_fills_the_sms_at_decode(shape, m, bits, kmajor, block_k):
    n, k = shape
    p = plan(m, n, k, torch.bfloat16, bits, block_k, kmajor)
    assert p.blocks == _tiles(p, m, n) * p.splits
    assert p.blocks >= SMS


@pytest.mark.parametrize("block_k", [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 1024])
@pytest.mark.parametrize("shape", [(512, 1536), (2048, 6144), (384, 1536)])
def test_plan_splits_never_cut_a_quant_block(shape, m, block_k):
    n, k = shape                        # K divisible by every block_k
    p = plan(m, n, k, torch.bfloat16, 4, block_k)
    assert p.instance in ("gemv", "gemm")
    assert p.k_per_split % block_k == 0 and p.k_per_split % p.tile_k == 0
    # every split is non-empty and together they cover K exactly once
    assert (p.splits - 1) * p.k_per_split < k <= p.splits * p.k_per_split


@pytest.mark.parametrize("shape,m,dtype,aligned,splits,workspace", [
    # the FMA instance: fp32 partial tiles of every split in global memory
    ((2048, 2048), 8, torch.float32, True, 16, 16 * 8 * 2048 * 4),
    ((1000, 1000), 8, torch.bfloat16, False, 16, 16 * 8 * 1000 * 4),
    ((2048, 8192), 64, torch.float32, True, 9, 9 * 64 * 2048 * 4),
    ((8192, 2048), 1024, torch.float32, True, 1, 0),
    # the tensor-core instances reduce inside a cluster: no workspace
    ((2048, 2048), 8, torch.bfloat16, True, 8, 0),
    ((512, 2048), 1024, torch.bfloat16, True, 5, 0),
    ((49155, 2048), 8, torch.bfloat16, True, 1, 0),
])
def test_plan_workspace(shape, m, dtype, aligned, splits, workspace):
    n, k = shape
    p = plan(m, n, k, dtype, 4, -1, aligned=aligned)
    assert p.splits == splits and p.workspace_bytes == workspace
    assert p.counters == (_tiles(p, m, n) if workspace else 0)
    if splits == 1:
        assert p.k_per_split == k


@pytest.mark.parametrize("shape,m,bits,kmajor,block_k", _cases(PLAN_MS))
def test_plan_tensor_core_splits_fit_a_cluster(shape, m, bits, kmajor,
                                               block_k):
    n, k = shape
    p = plan(m, n, k, torch.bfloat16, bits, block_k, kmajor)
    assert 1 <= p.splits <= 8
    assert p.tile_n in ((16, 32, 64) if p.instance == "gemv" else (128,))


def test_launch_plan_reads_the_tensors():
    x = torch.zeros(8, 1000, dtype=torch.bfloat16)
    codes = torch.zeros(64, 500, dtype=torch.uint8)     # 500-byte rows
    assert launch_plan(x, codes, -1, 4).instance == "fma"
    x = torch.zeros(8, 1024, dtype=torch.bfloat16)
    codes = torch.zeros(64, 512, dtype=torch.uint8)
    assert launch_plan(x, codes, -1, 4).instance == "gemv"
    assert launch_plan(x.float(), codes, -1, 4).instance == "fma"
    kn = torch.zeros(512, 40, dtype=torch.uint8)        # N = 40: not 16-aligned
    assert launch_plan(x, kn, 128, 4, kmajor=True).instance == "fma"
    kn = torch.zeros(512, 48, dtype=torch.uint8)
    assert launch_plan(x, kn, 128, 4, kmajor=True).instance == "gemv"
