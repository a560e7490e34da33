"""The per-matrix absmax of ``quant.cu`` and ``opt_step.cu`` on the CPU:
the launch plan's chunk walk, a model of the kernels' chunk iterator, and
the plain versions held to the JAX package on adversarial leaves.

The kernels take each matrix's absmax inside their one launch (phase 1
walks the plan's chunks, a grid barrier, phase 2 walks them again), so
the plan must cut every matrix into chunks that cover it once per phase,
none crossing a matrix, on a grid within the co-resident limit it was
given.  Tolerance: none; the plan tests are exact, and
``matrix_scales``, ``rtn_ref``, ``rr_ref`` (fed JAX's uniforms) and
``opt_step_ref`` are bitwise equal to ``repro.core.quantize`` and
``repro.kernels.opt_step.ref`` with the largest |w| at a matrix's first or
last element, on an all-zero matrix with -0.0, on a NaN and on a +-max tie
(a NaN matches a NaN; the penalty within 1e-6 relative, or NaN on both).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import quantize as jq
from repro.kernels.opt_step import opt_step_ref as j_opt_ref
from repro_torch.core import formats as tformats
from repro_torch.core import quantize as tq
from repro_torch.kernels.opt_step import opt_step_ref
from repro_torch.kernels.quant import ops as qops
from repro_torch.kernels.quant import rr_ref, rtn_ref

# Granite-3-2B's leaf shapes: wq/wo, wk/wv, w_up/w_gate, w_down, the tied
# embedding, the stacked norm scales, the final norm scale
GRANITE_SHAPES = [(40, 2048, 2048), (40, 2048, 512), (40, 2048, 8192),
                  (40, 8192, 2048), (49155, 2048), (40, 2048), (2048,)]
# n % 4 != 0, odd matrices, 1-D, just over a tile, n = 0
RAGGED_SHAPES = [(3, 5, 7), (7, 33, 65), (10001,), (5, 8193), (2, 3, 16385),
                 (3, 0, 5), (0, 4, 4), (1,)]
CO_RESIDENT = [1, 7, 132, 264, 1056]


def _numel(shape):
    n = math.prod(shape)
    return n, math.prod(shape[-2:]) if len(shape) >= 2 else n


def _check_walk(p, n, mat_numel, per_mat):
    """Every element in exactly one chunk of a walk with per_mat chunks
    per matrix, no chunk crossing a matrix."""
    n_mats = n // mat_numel if mat_numel else 0
    spans = []
    for b in range(p.blocks):
        for c in qops.block_chunks(p, n_mats, b, per_mat):
            s, e = qops.chunk_range(p, mat_numel, c, per_mat)
            assert s < e and s // mat_numel == (e - 1) // mat_numel
            spans.append((s, e))
    spans.sort()
    at = 0
    for s, e in spans:
        assert s == at
        at = e
    assert at == n


@pytest.mark.parametrize("co_resident", CO_RESIDENT)
@pytest.mark.parametrize("shape", GRANITE_SHAPES + RAGGED_SHAPES)
def test_plan_covers_each_element_once_per_phase(shape, co_resident):
    n, mat_numel = _numel(shape)
    p = qops.plan(n, mat_numel, co_resident)
    assert 0 <= p.blocks <= co_resident
    assert p.scan_chunks == p.chunks
    if n == 0:
        assert p.blocks == 0
        return
    assert p.blocks >= 1
    assert p.chunk % qops.VEC_STRIDE == 0 and p.chunk <= qops.TILE
    assert p.chunks == -(-mat_numel // p.chunk)
    _check_walk(p, n, mat_numel, p.chunks)          # phase 2
    _check_walk(p, n, mat_numel, p.scan_chunks)     # phase 1 (the absmax)


@pytest.mark.parametrize("co_resident", CO_RESIDENT)
@pytest.mark.parametrize("shape", GRANITE_SHAPES)
def test_plan_balances_the_blocks(shape, co_resident):
    """No block walks more chunks than the flat split of the leaf's
    chunks over the grid would give it (rounded up); the grid is the
    co-resident count or the chunk count, whichever is smaller; a leaf of
    at least as many tiles as co-resident blocks is cut in tiles, a
    smaller one finer, onto more blocks."""
    n, mat_numel = _numel(shape)
    p = qops.plan(n, mat_numel, co_resident)
    n_mats = n // mat_numel
    total = n_mats * p.chunks
    busiest = max(len(qops.block_chunks(p, n_mats, b, p.chunks))
                  for b in range(p.blocks))
    assert busiest == -(-total // p.blocks)
    assert p.blocks == min(co_resident, total)
    tiles = n_mats * -(-mat_numel // qops.TILE)
    if tiles >= co_resident:
        assert p.chunk == qops.TILE
    else:
        assert p.blocks >= tiles


def _chunk_iter(blocks, total, per, b):
    """Python model of ``qm::ChunkIter``: block b's chunks as (matrix,
    chunk), stepping without a division."""
    left = (total - 1 - b) // blocks + 1 if b < total else 0
    m, j = divmod(b, per)
    dm, dj = divmod(blocks, per)
    out = []
    while left > 0:
        out.append((m, j))
        left -= 1
        m, j = m + dm, j + dj
        if j >= per:
            j, m = j - per, m + 1
    return out


@pytest.mark.parametrize("blocks,n_mats,per", [
    (1, 3, 5), (7, 3, 5), (264, 40, 2048), (1056, 40, 79), (10, 1, 10),
    (513, 1, 513), (132, 1000, 1), (5, 2, 1), (1040, 40, 26)])
def test_chunk_iterator_model_walks_the_plan_order(blocks, n_mats, per):
    total = n_mats * per
    for b in sorted({0, 1, blocks // 2, blocks - 1, total - 1, total}):
        want = [divmod(c, per) for c in range(b, total, blocks)]
        assert _chunk_iter(blocks, total, per, b) == want


def test_plan_rejects_no_room_and_block_grid_fits():
    with pytest.raises(ValueError, match="co_resident"):
        qops.plan(16, 16, 0)
    assert qops.block_grid(10, 128, 1056) == 1
    assert qops.block_grid(2048 * 128 * 8, 128, 1056) == 1056
    assert qops.matrix_numel(torch.zeros(3, 4, 5)) == 20
    assert qops.matrix_numel(torch.zeros(7)) == 7


# ------------------------------------------------------------------------
# The plain versions against JAX on adversarial leaves
# ------------------------------------------------------------------------

KINDS = ["max_first", "max_last", "zero", "nan", "tie"]
ADV_SHAPES = [(3, 16, 40), (40, 64), (257,)]


def _adversarial(shape, kind, seed=0):
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.02
         ).astype(np.float32)
    v = w.reshape(-1, math.prod(shape[-2:]) if len(shape) >= 2 else w.size)
    if kind == "max_first":
        v[:, 0] = 1.0
    elif kind == "max_last":
        v[:, -1] = -1.0
    elif kind == "zero":
        v[0] = 0.0
        v[0, 1::2] = -0.0
    elif kind == "nan":
        v[-1, v.shape[1] // 2] = np.nan
    elif kind == "tie":
        v[:, 0], v[:, -1] = -0.5, 0.5
    return w


def _eq_bits(a, b):
    """Bit for bit; a NaN matches a NaN at the same place."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    na, nb = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(na, nb)
    np.testing.assert_array_equal(np.where(na, 0, a).view(np.int32),
                                  np.where(nb, 0, b).view(np.int32))


@pytest.mark.parametrize("shape", ADV_SHAPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", ["int4", "fp4"])
def test_matrix_scales_match_jax_absmax(fmt, kind, shape):
    w = _adversarial(shape, kind)
    jf = jformats.get_format(fmt)
    want = jf.scale(jq._absmax_pertensor(jnp.asarray(w))).reshape(-1)
    _eq_bits(tq.matrix_scales(torch.from_numpy(w), tformats.get_format(fmt)),
             want)


@pytest.mark.parametrize("bs", [-1, 128])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", ["int4", "int8", "fp4"])
def test_rtn_ref_matches_jax_on_adversarial_leaves(fmt, kind, bs):
    for shape in ADV_SHAPES:
        w = _adversarial(shape, kind, seed=1)
        want = jq.cast_rtn(jnp.asarray(w), jformats.get_format(fmt), bs)
        _eq_bits(rtn_ref(torch.from_numpy(w), fmt, bs), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", ["int4", "int8", "fp4"])
def test_rr_ref_matches_jax_on_adversarial_leaves(fmt, kind):
    """Per-matrix scales; the uniforms are the ones JAX draws from the
    key (``_rr``: one uniform per element in w's shape)."""
    for i, shape in enumerate(ADV_SHAPES):
        w = _adversarial(shape, kind, seed=2)
        key = jax.random.PRNGKey(i)
        u = np.asarray(jax.random.uniform(key, w.shape, dtype=jnp.float32))
        want = jq.cast_rr(jnp.asarray(w), jformats.get_format(fmt), key, -1)
        _eq_bits(rr_ref(torch.from_numpy(w), torch.from_numpy(u.copy()), fmt,
                        -1), want)


HYP = dict(lr=1e-3, bc1=0.1, bc2=0.05, clip_scale=0.7, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.01)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", ["int4", "fp4"])
@pytest.mark.parametrize("shape", ADV_SHAPES)
def test_opt_step_ref_matches_jax_on_adversarial_leaves(shape, fmt, kind):
    w = _adversarial(shape, kind, seed=3)
    rng = np.random.default_rng(4)
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    mu = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    nu = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
    kw = dict(lam=3000.0, fmt_name=fmt, block_size=-1, **HYP)
    jout = j_opt_ref(*map(jnp.asarray, (w, g, mu, nu)), **kw)
    tout = opt_step_ref(*(torch.from_numpy(a.copy()) for a in (w, g, mu, nu)),
                        **kw)
    for a, b in zip(tout[:3], jout[:3]):
        _eq_bits(a, b)
    jp, tp = float(jout[3]), float(tout[3])
    if kind == "nan":
        assert math.isnan(jp) and math.isnan(tp)
    else:
        assert abs(jp - tp) <= 1e-6 * max(abs(jp), 1e-30)
