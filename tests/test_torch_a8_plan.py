"""The fused W4A8 entry (``wqt_matmul_a8_x``: row quantizer, integer
matmul and cast in one launch of ``wqt_matmul_a8.cu``) on the CPU: its
plain version against the JAX package's ``core/qtensor.py::matmul`` under
``act_fmt="int8"``, the launch plan's invariants (``ops.a8_plan``), and a
plain model of the kernel's cluster algorithm held to the plain version.

Inputs come from numpy, with adversarial rows: all zero, values on .5
ties after scaling, the row's absmax in the last K split; the model also
gets NaN and inf rows.  Tolerances: the activation codes, the row scales
and the per-tensor result are bitwise equal to JAX's oracle (the same
IEEE operations in the same order).  Blockwise, JAX's oracle sums the
quant blocks with one ``einsum`` in XLA's order while the port folds them
in block order (as the kernel does), so the fp32 result is held within
1e-6 of its largest element and a bf16 result within 2^-7 (one rounding
of a last-bit difference); against the Pallas kernel in interpret mode,
which folds both scales per K tile in its own order, the JAX tests' own
tolerance (``tests/test_w4a8.py``: 1e-4) applies.  The model is bitwise
equal to the plain version everywhere.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qtensor import from_matmul_weight as jax_from_matmul_weight
from repro.core.qtensor import matmul as jax_matmul
from repro.core.qtensor import qtensor_act_fmt as jax_act_fmt
from repro.core.qtensor import qtensor_use_kernel as jax_use_kernel
from repro_torch.core import qtensor as tqt
from repro_torch.kernels.decode_attn import unpack_int4_ref
from repro_torch.kernels.wq_matmul import (quantize_acts_ref,
                                           wqt_matmul_a8_ref,
                                           wqt_matmul_a8_x,
                                           wqt_matmul_a8_x_ref)
from repro_torch.kernels.wq_matmul import ops

K, N = 512, 64           # K: four 128-wide units, so up to four K splits
MS = (1, 5, 8, 16, 17, 128)


def _acts(m, seed, k=K):
    """Activations with the adversarial rows: row 1 all zero (when m > 1),
    row 2 on .5 ties after scaling (its absmax 127 * 0.25, the rest
    multiples of 0.125), row 3 with its absmax in the last 128 of K."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    if m > 1:
        x[1] = 0.0
    if m > 2:
        x[2] = np.round(rng.uniform(-30, 30, size=k) * 8) / 8
        x[2, 0] = 127 * 0.25                 # scale 0.25: odd eighths tie
    if m > 3:
        x[3, -7] = 9.0
    return x


def _weight(bits, block_k, seed, k=K, n=N):
    w = (np.random.default_rng(seed).normal(size=(k, n)) / math.sqrt(k)
         ).astype(np.float32)
    jq = jax_from_matmul_weight(jnp.asarray(w), f"int{bits}", block_k)
    return jq, np.array(jq.codes), np.array(jq.scales)


def _jax_matmul(x, jq, dtype, kernel):
    xj = jnp.asarray(x).astype(dtype)
    with jax_act_fmt("int8"), jax_use_kernel(kernel):
        return np.asarray(jax_matmul(xj, jq).astype(jnp.float32))


def _torch_x(x, dtype):
    return torch.as_tensor(x).to(dtype)


# --------------------------------------------------------------------------
# the plain composition against JAX's matmul under act_fmt="int8"
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block_k", [-1, 32, 128])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a8_x_ref_matches_jax_oracle(dtype, m, block_k, bits):
    x = _acts(m, 100 + m)
    jq, codes, scales = _weight(bits, block_k, 7)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = _jax_matmul(x, jq, jdt, kernel=False)
    got = wqt_matmul_a8_x_ref(_torch_x(x, tdt), torch.as_tensor(codes),
                              torch.as_tensor(scales), block_k, bits == 4)
    assert got.dtype == tdt and got.shape == (m, N)
    got = got.float().numpy()
    if block_k == -1:
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-6 if dtype == "float32" else 2.0 ** -7
        assert np.abs(got - want).max() <= tol * np.abs(want).max()
    # the wrapper and QTensor matmul take the same plain path on the CPU
    wrapped = wqt_matmul_a8_x(_torch_x(x, tdt), torch.as_tensor(codes),
                              torch.as_tensor(scales), block_k, bits)
    np.testing.assert_array_equal(wrapped.float().numpy(), got)
    tq = tqt.QTensor(torch.as_tensor(codes), torch.as_tensor(scales),
                     f"int{bits}", bits, block_k)
    with tqt.qtensor_act_fmt("int8"):
        via = tqt.matmul(_torch_x(x, tdt), tq)
    np.testing.assert_array_equal(via.float().numpy(), got)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block_k", [-1, 32, 128])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a8_x_ref_matches_jax_pallas(dtype, m, block_k, bits):
    x = _acts(m, 200 + m)
    jq, codes, scales = _weight(bits, block_k, 8)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = _jax_matmul(x, jq, jdt, kernel=True)
    got = wqt_matmul_a8_x_ref(_torch_x(x, tdt), torch.as_tensor(codes),
                              torch.as_tensor(scales), block_k,
                              bits == 4).float().numpy()
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(),
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a8_x_ref_codes_and_scales_bitwise_with_jax(dtype):
    from repro.kernels.wq_matmul.ref import quantize_acts_ref as jquant
    x = _acts(16, 3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jc, js = jquant(jnp.asarray(x).astype(jdt))
    tc, ts = quantize_acts_ref(_torch_x(x, getattr(torch, dtype)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 0] == 1.0 and not tc[1].any()          # the zero row
    assert ts[2, 0] == 0.25                              # the tie row
    assert (np.abs(x[2] / 0.25) % 1 == 0.5).any()        # ties occur


# --------------------------------------------------------------------------
# the launch plan
# --------------------------------------------------------------------------

PLAN_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192),
               (49155, 2048), (1000, 1024), (64, 128), (4096, 32768)]


@pytest.mark.parametrize("n,k", PLAN_SHAPES)
def test_a8_plan_invariants(n, k):
    for m in (1, 8, 9, 16, 17, 128, 1024):
        for block_k in (-1, 32, 64, 128, 256):
            if block_k > 0 and k % block_k:
                continue
            for bits in (4, 8):
                for x_bytes in (1, 2, 4):
                    unit = math.lcm(ops.A8_K, block_k) if block_k > 0 \
                        else ops.A8_K
                    try:
                        p = ops.a8_plan(m, n, k, block_k, bits, x_bytes)
                    except ValueError:
                        # refused only where the narrowest tile on the
                        # most splits would not fit its shared memory
                        units = k // unit
                        per = -(-units // min(units, 8))
                        assert ops.a8_smem(
                            bits, x_bytes, 8 if m <= 8 else 16, 16,
                            per * unit, block_k) > ops.A8_SMEM_MAX
                        continue
                    assert p.tile_m == (8 if m <= 8 else 16)
                    assert p.m_tiles == -(-m // p.tile_m)
                    assert p.tile_n in (64, 32, 16)
                    assert 1 <= p.splits <= 8                 # one cluster
                    assert p.k_per_split % unit == 0         # block starts
                    assert p.splits * p.k_per_split >= k     # spans all of K
                    assert (p.splits - 1) * p.k_per_split < k  # none empty
                    assert p.amax_ranks == p.splits
                    assert p.smem_bytes == ops.a8_smem(
                        bits, x_bytes, p.tile_m, p.tile_n, p.k_per_split,
                        block_k) <= ops.A8_SMEM_MAX
                    assert p.blocks == (-(-n // p.tile_n) * p.m_tiles
                                        * p.splits)


def test_a8_plan_decode_shapes_fill_the_card():
    """At decode (M = 8, int4 per tensor, bf16 x) every Granite layer
    matmul runs at least one block per SM, the small ones on 8 splits."""
    for (n, k) in [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]:
        p = ops.a8_plan(8, n, k, -1, 4, 2)
        assert p.blocks >= ops.SMS, (n, k, p)
    assert ops.a8_plan(8, 2048, 2048, -1, 4, 2).splits == 8
    assert ops.a8_plan(8, 512, 2048, -1, 4, 2).tile_n == 16


def test_a8_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.a8_plan(8, 64, 1000, -1, 4, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.a8_plan(8, 64, 1024, 48, 4, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.a8_plan(8, 64, 1024, 8, 8, 2)
    with pytest.raises(ValueError, match="up to"):
        ops.a8_plan(8, 64, 2 * ops.A8_MAX_K, -1, 4, 2)


# --------------------------------------------------------------------------
# a plain model of the kernel's cluster algorithm
# --------------------------------------------------------------------------

def _nan_max(a, b):
    """max with NaN winning, as the kernel's unsigned max of |x| bits."""
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(a, float("nan")), torch.maximum(a, b))


def cluster_model(x, codes, scales, block_k, bits, plan=None):
    """What one cluster of ``wqt_matmul_a8.cu`` computes, split by split:
    each split takes the |x| max of its slice of every row (NaN wins), the
    maxima of ``plan.amax_ranks`` splits are combined, each split
    quantizes its slice with the row scales and contracts it exactly (int4
    codes as 16 * c, the sum shifted right by 4); per tensor the int32
    partial sums are added over the splits, blockwise each quant block's
    ``float(acc_b) * s_b`` is folded in block order across the splits;
    the result is cast to x's dtype."""
    M, K = x.shape
    plan = plan or ops.a8_plan(M, codes.shape[0], K, block_k, bits,
                               x.element_size())
    kps = plan.k_per_split
    bounds = [(z * kps, min(K, (z + 1) * kps)) for z in range(plan.splits)]
    xf = x.to(torch.float32)
    absmax = torch.zeros((M, 1))
    for k0, k1 in bounds[:plan.amax_ranks]:
        local = torch.amax(torch.abs(xf[:, k0:k1]), dim=1, keepdim=True)
        absmax = _nan_max(absmax, local)
    xs = torch.where(absmax > 0, absmax / torch.tensor(127.0),
                     torch.ones_like(absmax))
    w = unpack_int4_ref(codes) if bits == 4 else codes
    w16 = w.to(torch.int64) * (16 if bits == 4 else 1)
    shift = 4 if bits == 4 else 0
    xq_parts, acc, prods = [], torch.zeros((M, codes.shape[0]),
                                           dtype=torch.int64), []
    for k0, k1 in bounds:
        xq = torch.clamp(torch.round(xf[:, k0:k1] / xs), -127, 127
                         ).to(torch.int8)
        xq_parts.append(xq)
        if block_k == -1:
            acc += xq.to(torch.int64) @ w16[:, k0:k1].T
        else:
            for b0 in range(k0, k1, block_k):
                a = xq[:, b0 - k0:b0 - k0 + block_k].to(torch.int64) \
                    @ w16[:, b0:b0 + block_k].T
                prods.append((a >> shift).to(torch.int32).to(torch.float32)
                             * scales[:, b0 // block_k])
    if block_k == -1:
        out = (acc >> shift).to(torch.int32).to(torch.float32) * xs * scales
    else:
        out = prods[0]
        for p in prods[1:]:
            out = out + p
        out = out * xs
    return torch.cat(xq_parts, dim=1), xs, out.to(x.dtype)


def _model_inputs(m, bits, block_k, seed, dtype):
    x = torch.as_tensor(_acts(m, seed, k=1024))
    if m > 5:
        x[4, 10] = float("nan")
        x[5, 20] = float("inf")
    tq = tqt.from_matmul_weight(
        torch.as_tensor(np.random.default_rng(seed + 1).normal(
            size=(1024, 96)).astype(np.float32)), f"int{bits}", block_k)
    return x.to(dtype), tq


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block_k", [-1, 32, 128])
@pytest.mark.parametrize("m", [1, 8, 16, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_model_bitwise_with_plain(dtype, m, block_k, bits):
    x, tq = _model_inputs(m, bits, block_k, 300 + m, dtype)
    plan = ops.a8_plan(m, 96, 1024, block_k, bits, x.element_size())
    assert plan.splits > 1
    xq, xs, out = cluster_model(x, tq.codes, tq.scales, block_k, bits, plan)
    want_q, want_s = quantize_acts_ref(x)
    assert torch.equal(xq, want_q)
    assert torch.equal(xs, want_s)
    want = wqt_matmul_a8_x_ref(x, tq.codes, tq.scales, block_k, bits == 4)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert torch.equal(out.nan_to_num(), want.nan_to_num())
    mid = wqt_matmul_a8_ref(want_q, want_s, tq.codes, tq.scales, block_k,
                            bits == 4)
    assert torch.equal(mid.to(dtype).nan_to_num(), want.nan_to_num())


def test_cluster_model_shows_a_short_absmax_combine():
    """The planted fault of scripts/planted_faults_torch.py: a combine that
    skips the last split's maxima changes the row whose absmax is there
    (row 3) and leaves the others."""
    x, tq = _model_inputs(8, 4, -1, 400, torch.float32)
    plan = ops.a8_plan(8, 96, 1024, -1, 4, 4)
    good = cluster_model(x, tq.codes, tq.scales, -1, 4, plan)[2]
    bad = cluster_model(x, tq.codes, tq.scales, -1, 4,
                        plan._replace(amax_ranks=plan.splits - 1))[2]
    differs = ~torch.eq(good.nan_to_num(), bad.nan_to_num()).all(dim=1)
    assert differs[3] and not differs[[0, 1, 2]].any()
