"""MoE and SSM training leaves of the port on the CPU: the launch plans of
``opt_step``, ``lotion_reg`` and ``quant`` at a Moonlight expert stack
past 2^31 elements, computed without allocating it, and the plain
versions of the three kernels on small 4-D leaves and on the SSM leaves'
layouts against the JAX package.

The plans are pure Python (the wrappers hand their numbers to the kernels
as 64-bit integers): at (12, 64, 2048, 1408), 2,214,592,512 elements in
768 matrices, every chunk offset is checked against numpy's int64
arithmetic, the chunk walk against an exact cover of the leaf, and the
scratch and scale buffers against their sizes.  Tolerances: the plans
exact; w', mu', nu', the casts and the penalty gradients bitwise equal to
JAX's references (``repro.kernels.opt_step.opt_step_ref``,
``repro.core.lotion.lotion_penalty_and_grad``,
``repro.core.quantize.cast_rtn``);
penalties within 1e-6 relative (summation order).
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import lotion as jlotion
from repro.core import quantize as jq
from repro.kernels.opt_step import opt_step_ref as j_opt_ref
from repro_torch.kernels.lotion_reg import lotion_penalty_fused_vg
from repro_torch.kernels.lotion_reg import ops as rops
from repro_torch.kernels.opt_step import fused_opt_step_leaf
from repro_torch.kernels.quant import ops as qops
from repro_torch.kernels.quant import quant_rtn

MOE_LEAF = (12, 64, 2048, 1408)     # Moonlight's w_up at 12 layers
CO_RESIDENT = [132, 264, 528, 1056]
HYP = dict(lr=1e-3, bc1=0.1, bc2=0.05, clip_scale=0.7, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.01)
# small leaves with the layouts item 10 trains: a 4-D expert stack (layers,
# experts, d, f), RWKV6's 4-D mu_lora_b (layers, 5, rank, d) in mode none,
# Zamba2's conv weight (blocks, d_conv, channels) and conv bias (blocks,
# channels)
SMALL_4D = (2, 3, 64, 48)
SMALL_LEAVES = [SMALL_4D, (2, 5, 4, 16), (3, 4, 40), (3, 40)]
ITEM = re.compile(r"item (7\(e\)|10)\b")


def _meta(shape):
    return torch.empty(shape, device="meta")


def test_the_moe_leaf_is_past_2_31():
    w = _meta(MOE_LEAF)
    assert w.numel() == 2_214_592_512 > 2 ** 31
    assert qops.matrix_numel(w) == 2048 * 1408
    assert w.numel() // qops.matrix_numel(w) == 768


@pytest.mark.parametrize("co_resident", CO_RESIDENT)
def test_per_matrix_walk_covers_the_moe_leaf_in_64_bit(co_resident):
    """``quant`` and ``opt_step``'s per-matrix walk (and ``lotion_reg``'s
    grid regime, which takes the same walk) at the 2.2e9-element stack:
    chunk c of matrix m starts at m * mat_numel + j * chunk, as numpy's
    int64 computes it (int32 would wrap past the first 744 matrices);
    the chunks cover the leaf exactly, none crossing a matrix; the blocks
    take every chunk once; the last chunk ends at n."""
    w = _meta(MOE_LEAF)
    n, mat = w.numel(), qops.matrix_numel(w)
    n_mats = n // mat
    p = qops.plan(n, mat, co_resident)
    assert p == qops.Plan(co_resident, qops.TILE, mat // qops.TILE,
                          mat // qops.TILE)
    c = np.arange(n_mats * p.chunks, dtype=np.int64)
    m, j = np.divmod(c, p.chunks)
    s = m * np.int64(mat) + j * np.int64(p.chunk)
    e = np.minimum(s + p.chunk, (m + 1) * np.int64(mat))
    assert s[0] == 0 and e[-1] == n and (s[1:] == e[:-1]).all()
    assert ((e - 1) // mat == m).all()
    assert (s > 2 ** 31 - 1).any() and (s.astype(np.int32) < 0).any()
    for ci in (0, p.chunks - 1, len(c) // 2, len(c) - 1):
        assert qops.chunk_range(p, mat, int(ci), p.chunks) == (s[ci], e[ci])
    taken = np.zeros(len(c), np.int64)
    for b in (0, p.blocks - 1):
        r = qops.block_chunks(p, n_mats, b, p.chunks)
        assert list(r) == list(range(b, len(c), p.blocks))
    for b in range(p.blocks):
        taken[b::p.blocks] += 1
    assert (taken == 1).all()


@pytest.mark.parametrize("co_resident", CO_RESIDENT)
def test_lotion_reg_plan_and_scratch_at_the_moe_leaf(co_resident):
    """``lotion_reg`` takes the grid regime there, one double partial per
    block and one uint32 run slot per (matrix, first min(grid, scan)
    chunks) plus one folded maximum per matrix, in bytes computed as
    Python integers; each slot is written once by the run model."""
    w = _meta(MOE_LEAF)
    n, mat = w.numel(), qops.matrix_numel(w)
    n_mats = n // mat
    p = rops.plan(n, mat, -1, co_resident)
    assert p.regime == "grid" and p.blocks == p.sum_blocks == co_resident
    assert (p.chunk, p.chunks, p.scan_chunks) == (qops.TILE, 352, 352)
    S = min(p.blocks, p.scan_chunks)
    assert rops.scratch_bytes(p, n_mats) == 8 * p.blocks + 4 * 768 * (S + 1)
    c = np.arange(n_mats * p.scan_chunks, dtype=np.int64)
    first = c[(c < p.blocks) | (c // p.scan_chunks != (c - p.blocks)
                                // p.scan_chunks)]
    m, jj = np.divmod(first, p.scan_chunks)
    slots = m * S + jj
    assert (jj < S).all()
    assert np.array_equal(np.sort(slots), np.arange(n_mats * S))


def test_blockwise_grids_at_the_moe_leaf():
    """Blockwise scales: one warp per quant block, the grid capped at the
    co-resident count however many blocks the leaf holds (8.6e6 of 256)."""
    n = math.prod(MOE_LEAF)
    for co in CO_RESIDENT:
        assert qops.block_grid(n, 256, co) == co
        assert rops.plan(n, n, 256, co) == rops.Plan("block", co, 0, 0, 0, co)


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * s).astype(np.float32)
            for s in (0.02, 1e-3, 1e-4)] + [
        (np.abs(rng.standard_normal(shape)) * 1e-6).astype(np.float32)]


@pytest.mark.parametrize("lam", [1e3, 0.0])
@pytest.mark.parametrize("shape", SMALL_LEAVES)
def test_opt_step_plain_matches_jax_on_zoo_leaves(shape, lam):
    """One AdamW step with the int4 per-matrix penalty (lam 1e3) or in
    mode none (lam 0, the excluded SSM leaves), through the wrapper on
    CPU tensors: JAX's reference bitwise, one scale per trailing
    matrix of the 4-D stacks."""
    w, g, mu, nu = _rand(shape, seed=len(shape))
    kw = dict(lam=lam, fmt_name="int4", block_size=-1, **HYP)
    want = j_opt_ref(*map(jnp.asarray, (w, g, mu, nu)), **kw)
    got = fused_opt_step_leaf(*map(torch.from_numpy, (w, g, mu, nu)), **kw)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jp, tp = float(want[3]), float(got[3])
    assert abs(jp - tp) <= 1e-6 * max(abs(jp), 1e-30)
    assert (tp > 0) == (lam > 0)


@pytest.mark.parametrize("shape", SMALL_LEAVES[:1] + SMALL_LEAVES[2:])
def test_lotion_reg_and_quant_plain_match_jax_on_zoo_leaves(shape):
    """The penalty and its gradient (lam 1e3, as the loss placement folds
    it) and the RTN cast of the eligible layouts, per-matrix int4:
    JAX's references bitwise; each matrix of the 4-D stack has its own
    scale (moving one matrix's absmax moves only its cast)."""
    w, _, _, _ = _rand(shape, seed=7)
    f = (np.random.default_rng(8).random(shape) * 1e-6).astype(np.float32)
    pen, grad = lotion_penalty_fused_vg(torch.from_numpy(w),
                                        torch.from_numpy(f), "int4", -1, 1e3)
    jpen, jgrad = jlotion.lotion_penalty_and_grad(
        jnp.asarray(w), jnp.asarray(f), jformats.get_format("int4"), -1,
        lam=1e3)
    np.testing.assert_array_equal(grad.numpy(), np.asarray(jgrad))
    assert abs(float(pen) - float(jpen)) <= 1e-6 * abs(float(jpen))
    cast = quant_rtn(torch.from_numpy(w), "int4", -1)
    want = jq.cast_rtn(jnp.asarray(w), jformats.get_format("int4"), -1)
    np.testing.assert_array_equal(cast.numpy(), np.asarray(want))
    if len(shape) == 4:
        w2 = w.copy()
        w2[-1, -1] *= 2.0
        cast2 = quant_rtn(torch.from_numpy(w2), "int4", -1).numpy()
        np.testing.assert_array_equal(cast2[:-1], cast.numpy()[:-1])
        np.testing.assert_array_equal(cast2[-1, :-1], cast.numpy()[-1, :-1])


def test_no_refusal_names_items_7e_or_10():
    """Cross-attention (item 7(e)) and MoE and SSM training on the card
    (item 10) are ported: no module of the port refuses either by name,
    ``make_train_step`` among them."""
    root = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    hits = [f"{p.relative_to(root)}:{i + 1}"
            for p in sorted(root.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines())
            if ITEM.search(line)]
    assert not hits, hits
