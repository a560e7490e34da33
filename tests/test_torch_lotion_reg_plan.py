"""The one-launch ``lotion_reg`` kernel's plan on the CPU: the regime and
work split of ``kernels/lotion_reg/ops.py::plan``, a model of the
kernel's absmax and penalty sum that follows the plan, and ``reg_ref``
held to the JAX package on adversarial leaves.

The kernel takes each matrix's absmax inside its one launch, so the plan
must cover every matrix once per phase (absmax, then gradient), with no
chunk crossing a matrix, on a grid within the co-resident and cluster
limits it was given; in the grid regime each block writes one slot per
run of chunks it walks in one matrix, and those slots must be exactly the
matrix's first min(grid, scan) chunks, each written once, since nothing
zeroes them.  Tolerance: none for the plan and the scales (exact); the
gradient bitwise against JAX's ``reg_ref`` (lam = 1) and
``core.lotion.lotion_penalty_and_grad`` (lam = 3000), a NaN matching a
NaN; penalties within 1e-6 relative (summation order), or NaN on both.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import lotion as jlotion
from repro.kernels.lotion_reg.ref import reg_ref as j_reg_ref
from repro_torch.core import formats as tformats
from repro_torch.core import quantize as tq
from repro_torch.kernels.lotion_reg import ops as rops
from repro_torch.kernels.lotion_reg import reg_ref
from repro_torch.kernels.quant import ops as qops

# Granite-3-2B's leaf shapes (as tests/test_torch_absmax.py) and the
# paper's testbed leaves at d = 12000 (§4.1's w; §4.2's W1, W2 at k = 16,
# 64, 256)
GRANITE_SHAPES = [(40, 2048, 2048), (40, 2048, 512), (40, 2048, 8192),
                  (40, 8192, 2048), (49155, 2048), (40, 2048), (2048,)]
TESTBED_SHAPES = [(12000,), (16, 12000), (64, 12000), (256, 12000),
                  (1, 16), (1, 64), (1, 256)]
RAGGED_SHAPES = [(3, 5, 7), (7, 33, 65), (10001,), (5, 8193), (2, 3, 16385),
                 (3, 0, 5), (0, 4, 4), (1,)]
CO_RESIDENT = [1, 7, 132, 264, 1056]
CLUSTER = [1, 8, 16]

# The regime of each main-path shape (per-matrix scales): leaves of at
# most CLUSTER_NUMEL elements and CLUSTER_MATS matrices (the testbeds'
# (12000,) and (1, k), Granite's final norm scale) take the one-cluster
# launch, the rest the cooperative grid.
REGIME = {(40, 2048, 2048): "grid", (40, 2048, 512): "grid",
          (40, 2048, 8192): "grid", (40, 8192, 2048): "grid",
          (49155, 2048): "grid", (40, 2048): "grid", (2048,): "cluster",
          (12000,): "cluster", (16, 12000): "grid",
          (64, 12000): "grid", (256, 12000): "grid", (1, 16): "cluster",
          (1, 64): "cluster", (1, 256): "cluster", (3, 5, 7): "cluster",
          (7, 33, 65): "cluster", (10001,): "cluster", (5, 8193): "cluster",
          (2, 3, 16385): "grid", (3, 0, 5): "cluster",
          (0, 4, 4): "cluster", (1,): "cluster"}


def _numel(shape):
    n = math.prod(shape)
    return n, math.prod(shape[-2:]) if len(shape) >= 2 else n


def _spans(p, n, mat_numel, per_mat):
    """(block, start, end) of every chunk the plan's phase with per_mat
    chunks per matrix walks."""
    n_mats = n // mat_numel if mat_numel else 0
    if p.regime == "grid":
        return [(b, *qops.chunk_range(p, mat_numel, c, per_mat))
                for b in range(p.blocks)
                for c in qops.block_chunks(p, n_mats, b, per_mat)]
    # cluster: block r takes chunk r of each matrix, the matrices in turn
    return [(r, m * mat_numel + r * p.chunk,
             min(m * mat_numel + (r + 1) * p.chunk, (m + 1) * mat_numel))
            for m in range(n_mats) for r in range(min(p.blocks, per_mat))]


def _check_cover(spans, n, mat_numel):
    """Every element in exactly one span, none crossing a matrix."""
    at = 0
    for _, s, e in sorted(spans, key=lambda t: t[1]):
        assert s == at and s < e
        assert s // mat_numel == (e - 1) // mat_numel
        at = e
    assert at == n


@pytest.mark.parametrize("co_resident", CO_RESIDENT)
@pytest.mark.parametrize("shape",
                         GRANITE_SHAPES + TESTBED_SHAPES + RAGGED_SHAPES)
def test_plan_covers_each_element_once_per_phase(shape, co_resident):
    n, mat_numel = _numel(shape)
    p = rops.plan(n, mat_numel, -1, co_resident)
    assert p.regime == REGIME[shape]
    assert p.scan_chunks == p.chunks and p.sum_blocks == p.blocks
    assert p.blocks >= 1
    if n == 0:
        assert p.chunks == 0
        return
    assert p.chunk % qops.VEC_STRIDE == 0
    assert p.chunks == -(-mat_numel // p.chunk)
    if p.regime == "grid":
        assert p.blocks <= co_resident and p.chunk <= qops.TILE
    else:
        assert p.blocks == p.chunks <= rops.CLUSTER_MAX
        assert n // mat_numel <= rops.CLUSTER_MATS
    _check_cover(_spans(p, n, mat_numel, p.scan_chunks), n, mat_numel)
    _check_cover(_spans(p, n, mat_numel, p.chunks), n, mat_numel)


def _run_slots(p, n_mats, scan):
    """Python model of the grid kernel's phase 1: the slot each block's
    run of chunks in one matrix writes (``m * S + j`` at the run's first
    chunk j)."""
    S = min(p.blocks, scan)
    written = []
    for b in range(p.blocks):
        cur = None
        for c in qops.block_chunks(p, n_mats, b, scan):
            m, j = divmod(c, scan)
            if m != cur:
                assert j < S      # the slot lies in the matrix's table
                written.append(m * S + j)
                cur = m
    return S, written


@pytest.mark.parametrize("co_resident", CO_RESIDENT)
@pytest.mark.parametrize("shape", GRANITE_SHAPES[:5] + [
    (256, 12000), (9, 40, 1000), (40, 64, 130), (12, 7, 3000)])
def test_grid_run_slots_are_each_written_once(shape, co_resident):
    """The slot table the fold reads is written whole, each slot once, so
    it needs no zeroing; a walk one chunk short per matrix (the planted
    ``reg_absmax_short``) still writes each of its slots once."""
    n, mat_numel = _numel(shape)
    p = rops.plan(n, mat_numel, -1, co_resident)
    assert p.regime == "grid"
    n_mats = n // mat_numel
    for scan in {p.scan_chunks, max(p.scan_chunks - 1, 1)}:
        S, written = _run_slots(p, n_mats, scan)
        assert sorted(written) == list(range(n_mats * S))
        assert rops.scratch_bytes(p._replace(scan_chunks=scan), n_mats) == \
            8 * p.blocks + 4 * n_mats * (S + 1)


@pytest.mark.parametrize("cluster_max", CLUSTER)
@pytest.mark.parametrize("co_resident", CO_RESIDENT)
def test_grid_stays_within_its_limits(co_resident, cluster_max):
    for shape in GRANITE_SHAPES + TESTBED_SHAPES + RAGGED_SHAPES:
        n, mat_numel = _numel(shape)
        p = rops.plan(n, mat_numel, -1, co_resident, cluster_max)
        limit = cluster_max if p.regime == "cluster" else co_resident
        assert 1 <= p.blocks <= limit
        b = rops.plan(n, n, 128, co_resident, cluster_max)
        assert b.regime == "block" and 1 <= b.blocks <= co_resident
        assert b.sum_blocks == b.blocks
        assert rops.scratch_bytes(b, 1) == 8 * b.blocks


def test_cluster_regime_sizes_and_bad_limits():
    """The cluster is one block per grain of at least CLUSTER_GRAIN
    elements, up to the limit; chunks whole vectors; an empty leaf one
    block with no chunk (it writes a zero penalty)."""
    assert rops.plan(16, 16, -1, 132) == rops.Plan(
        "cluster", 1, qops.VEC_STRIDE, 1, 1, 1)
    assert rops.plan(12000, 12000, -1, 132)[:4] == ("cluster", 6, 2048, 6)
    assert rops.plan(65536, 65536, -1, 132)[:4] == ("cluster", 16, 4096, 16)
    assert rops.plan(65536, 65536, -1, 132, 8)[:4] == (
        "cluster", 8, 8192, 8)
    assert rops.plan(rops.CLUSTER_NUMEL + 1, rops.CLUSTER_NUMEL + 1, -1,
                     132).regime == "grid"
    assert rops.plan(9 * 16, 16, -1, 132).regime == "grid"   # 9 matrices
    assert rops.plan(0, 16, -1, 132) == rops.Plan(
        "cluster", 1, qops.VEC_STRIDE, 0, 0, 1)
    assert rops.scratch_bytes(rops.plan(12000, 12000, -1, 132), 1) == 0
    with pytest.raises(ValueError, match="co_resident"):
        rops.plan(16, 16, -1, 0)
    with pytest.raises(ValueError, match="cluster_max"):
        rops.plan(16, 16, -1, 132, 17)


# ------------------------------------------------------------------------
# Adversarial leaves: reg_ref against JAX, and the kernel's algorithm
# ------------------------------------------------------------------------

KINDS = ["max_first", "max_last", "max_boundary", "zero", "nan", "tie"]
ADV_SHAPES = [(3, 16, 40), (40, 64), (257,)]
FMTS = ["int4", "int8", "fp4"]


def _adversarial(shape, kind, p, seed=0):
    """randn * 0.02 viewed as (n_matrices, mat_numel) with the largest
    |w| of each matrix at its first or last element, at the first element
    of its last chunk of plan p (even matrices) or the element before it
    (odd), an all-zero matrix 0 with -0.0, a NaN in the last matrix's last
    chunk, or a +-max tie."""
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.02
         ).astype(np.float32)
    v = w.reshape(-1, _numel(shape)[1])
    last = (p.chunks - 1) * p.chunk
    if kind == "max_first":
        v[:, 0] = 1.0
    elif kind == "max_last":
        v[:, -1] = -1.0
    elif kind == "max_boundary":
        for m in range(v.shape[0]):
            v[m, max(last - m % 2, 0)] = 1.0
    elif kind == "zero":
        v[0] = 0.0
        v[0, 1::2] = -0.0
    elif kind == "nan":
        v[-1, last] = np.nan
    elif kind == "tie":
        v[:, 0], v[:, -1] = -0.5, 0.5
    return w


def _fisher(shape, seed=1):
    return np.abs(np.random.default_rng(seed).standard_normal(shape)
                  ).astype(np.float32)


def _eq_bits(a, b):
    """Bit for bit; a NaN matches a NaN at the same place."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    na, nb = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(na, nb)
    np.testing.assert_array_equal(np.where(na, 0, a).view(np.int32),
                                  np.where(nb, 0, b).view(np.int32))


def _pen_close(got, want):
    got, want = float(got), float(want)
    if math.isnan(want):
        assert math.isnan(got)
    else:
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30)


@pytest.mark.parametrize("ref", ["reg_ref", "closed_form_lam"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", FMTS)
def test_reg_ref_matches_jax_on_adversarial_leaves(fmt, kind, ref):
    for shape in ADV_SHAPES:
        n, mat_numel = _numel(shape)
        w = _adversarial(shape, kind, rops.plan(n, mat_numel, -1, 132))
        f = _fisher(shape)
        if ref == "reg_ref":
            lam = 1.0
            jv, jg = j_reg_ref(jnp.asarray(w), jnp.asarray(f), fmt, -1)
        else:
            lam = 3000.0
            jv, jg = jlotion.lotion_penalty_and_grad(
                jnp.asarray(w), jnp.asarray(f), jformats.get_format(fmt), -1,
                lam=lam)
        tv, tg = reg_ref(torch.from_numpy(w), torch.from_numpy(f), fmt, -1,
                         lam)
        _eq_bits(tg.numpy(), np.asarray(jg))
        _pen_close(tv, jv)


def _abs_bits(x):
    return (torch.from_numpy(x).reshape(-1).view(torch.int32)
            & 0x7fffffff).to(torch.int64)


def _model_absmax(w, p):
    """Each matrix's largest |w| bits as the kernel folds them under plan
    p: the grid regime's run slots, or the cluster's first scan_chunks
    blocks."""
    n, mat_numel = w.size, _numel(w.shape)[1]
    n_mats = n // mat_numel
    bits = _abs_bits(w)
    scan = p.scan_chunks
    if p.regime == "grid":
        S = min(p.blocks, scan)
        slots = [None] * (n_mats * S)
        for b in range(p.blocks):
            cur = None
            for c in qops.block_chunks(p, n_mats, b, scan):
                s, e = qops.chunk_range(p, mat_numel, c, scan)
                m, j = divmod(c, scan)
                if m != cur:
                    cur, at = m, m * S + j
                    slots[at] = 0
                slots[at] = max(slots[at], int(bits[s:e].max()))
        return [max(slots[m * S:(m + 1) * S], default=0)
                for m in range(n_mats)]
    return [max((int(bits[s:e].max()) for _, s, e in _spans(p, n, mat_numel,
                                                              scan)
                 if s // mat_numel == m), default=0) for m in range(n_mats)]


def _model_scales(w, p, fmt):
    amax = torch.tensor(_model_absmax(w, p), dtype=torch.int64
                        ).to(torch.int32).view(torch.float32)
    return tformats.get_format(fmt).scale(amax)


def _model_penalty(w, f, p, fmt):
    """0.5 * the terms f (hi - w)(w - lo) added in float64 block by block
    in the plan's phase-2 order, the blocks' partials in block order,
    rounded to fp32 once (the kernel's per-thread and tree orders differ
    only in the last bits of the double sum)."""
    n, mat_numel = w.size, _numel(w.shape)[1]
    wt, ft = torch.from_numpy(w), torch.from_numpy(f)
    lo, hi = tq.rr_neighbors(wt, tformats.get_format(fmt), -1)
    terms = (ft * ((hi - wt) * (wt - lo))).reshape(-1).double()
    partial = [0.0] * p.blocks
    for b, s, e in _spans(p, n, mat_numel, p.chunks):
        partial[b] += float(terms[s:e].sum())
    return np.float32(0.5 * sum(partial[:p.sum_blocks]))


MODEL_SHAPES = [(12000,), (16, 1200), (3, 40, 500), (9, 40, 1000),
                (40, 64, 130), (16, 12000)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_kernel_model_matches_the_plain_version(shape, kind):
    """The plan's absmax fold gives ``matrix_scales`` bit for bit and its
    penalty order the plain penalty within 1e-6; the planted faults'
    plans (one chunk or cluster block short of the absmax walk; the last
    block's partial dropped) give other scales and another penalty."""
    n, mat_numel = _numel(shape)
    p = rops.plan(n, mat_numel, -1, 132)
    w, f = _adversarial(shape, kind, p, seed=2), _fisher(shape, seed=3)
    for fmt in ("int4", "fp4"):
        want = tq.matrix_scales(torch.from_numpy(w),
                                tformats.get_format(fmt))
        _eq_bits(_model_scales(w, p, fmt), want)
        pen, _ = reg_ref(torch.from_numpy(w), torch.from_numpy(f), fmt, -1)
        _pen_close(_model_penalty(w, f, p, fmt), pen)
    if kind in ("max_last", "max_boundary"):
        short = p._replace(scan_chunks=p.chunks - 1)
        assert not torch.equal(_model_scales(w, short, "int4"), want)
    if kind not in ("nan", "zero"):
        dropped = _model_penalty(w, f, p._replace(sum_blocks=p.blocks - 1),
                                 "int4")
        pen, _ = reg_ref(torch.from_numpy(w), torch.from_numpy(f), "int4", -1)
        assert abs(float(dropped) - float(pen)) > 1e-6 * abs(float(pen))
