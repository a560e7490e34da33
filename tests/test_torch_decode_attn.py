"""The port's fused decode attention against the JAX package on the CPU.

Inputs (queries, and K/V quantized by the JAX ``kv_quantize``) come from
numpy.  The port's plain version (``decode_attn_ref``, which its wrapper
takes for CPU tensors) is held to the JAX oracle and to the JAX Pallas
kernel in interpret mode.  Tolerance: 1e-5 relative to the output's max
(fp32 summation order; the kernel's online softmax against the dense
one).  The quantizer, the int4 packing and the ring-validity mask must
match bit for bit.

The launch plan of ``decode_attn.cu`` (``ops.plan``) and its slot
arithmetic are checked in plain Python: the instance per dtype, head dim,
bits and alignment, splits that cover the ring, the block count on the
main path, one plan for ring and paged calls, and each split's valid slots
against ``ring_validity``.  A plain model of the kernel's split-and-merge
arithmetic (per-warp online softmax over 16-slot chunks, warps then splits
merged in order, chunks with no valid slot skipped) is held to
``decode_attn_ref``'s dense softmax within 1e-6 relative in fp32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import decode_attn as jax_decode_attn
from repro.kernels.decode_attn import decode_attn_ref as jax_decode_attn_ref
from repro.kernels.decode_attn.ref import ring_validity as jax_ring_validity
from repro.kernels.decode_attn.ref import unpack_int4_ref as jax_unpack
from repro.models import layers as jlayers
from repro_torch.kernels.decode_attn import (decode_attn, decode_attn_ref,
                                             ring_validity, unpack_int4_ref)
from repro_torch.kernels.decode_attn import ops as attn_ops
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


# --------------------------------------------------------------------------
# The launch plan of decode_attn.cu and its slot arithmetic (pure Python)
# --------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,hd,bits,rep,aligned,want", [
    (BF16, 64, 8, 4, True, "mma"),        # the main path (Granite-3-2B)
    (BF16, 64, 4, 4, True, "mma"),
    (BF16, 32, 8, 4, True, "mma"),
    (BF16, 128, 4, 8, True, "mma"),
    (BF16, 128, 8, 2, True, "mma"),
    (F32, 64, 8, 4, True, "fma"),         # fp32 queries
    (F32, 64, 4, 4, True, "fma"),
    (BF16, 16, 4, 4, True, "fma"),        # 8-byte int4 code rows
    (F32, 16, 4, 4, True, "fma"),
    (BF16, 16, 8, 4, True, "fma"),        # 16-byte code rows
    (BF16, 32, 4, 4, True, "fma"),
    (BF16, 256, 8, 2, True, "fma"),       # gemma2's head dim
    (BF16, 64, 8, 16, True, "fma"),       # more queries than an n8 tile
    (BF16, 64, 8, 4, False, "fma"),       # unaligned codes
])
def test_plan_instance(dtype, hd, bits, rep, aligned, want):
    p = attn_ops.plan(8, 8, rep, hd, 256, bits, dtype, aligned)
    assert p.instance == want
    assert p.tile == (attn_ops.MMA_TILE if want == "mma"
                      else max(8, min(64, 4096 // hd)))


@pytest.mark.parametrize("L", [1, 16, 48, 100, 256, 264, 288, 1000, 4096,
                               4100])
@pytest.mark.parametrize("dtype,hd,bits", [(BF16, 64, 8), (BF16, 64, 4),
                                           (F32, 64, 8), (BF16, 16, 4),
                                           (BF16, 256, 8)])
def test_plan_splits_cover_the_ring(L, dtype, hd, bits):
    p = attn_ops.plan(8, 8, 4, hd, L, bits, dtype)
    assert 1 <= p.splits <= attn_ops.CLUSTER_SPLITS
    assert p.slots_per_split % 16 == 0
    assert p.blocks == 8 * 8 * p.splits
    ranges = [attn_ops.split_range(p, L, z) for z in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == L
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    assert all(0 < hi - lo <= p.slots_per_split for lo, hi in ranges)
    tiles = -(-p.slots_per_split // p.tile)
    if p.instance == "mma":
        assert 1 <= p.stages <= min(tiles, attn_ops.MAX_STAGES)
        assert p.stages * attn_ops.mma_stage_bytes(hd, bits) <= max(
            attn_ops.RING_BYTES, 2 * attn_ops.mma_stage_bytes(hd, bits))
        if tiles >= 2:
            assert p.stages >= 2
    else:
        assert p.stages == 1


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("L", [256, 4096])
def test_plan_fills_the_card_on_the_main_path(bits, L):
    # serve and sched decode: b = 8 slots, Granite's 8 kv-heads of 4 queries
    p = attn_ops.plan(8, 8, 4, 64, L, bits, BF16)
    assert p.instance == "mma" and p.splits > 1
    assert p.blocks >= attn_ops.SMS
    if L == 256:
        assert (p.splits, p.slots_per_split, p.stages) == (4, 64, 1)
    else:
        assert p.stages >= 2


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("bs,bps", [(16, 16), (24, 11), (48, 6)])
def test_ring_and_paged_calls_get_one_plan(bits, dtype, bs, bps):
    b, g, rep, hd = 8, 8, 4, 64
    hd_c = hd // 2 if bits == 4 else hd
    cdt = torch.uint8 if bits == 4 else torch.int8
    q = torch.zeros(b, g, rep, hd, dtype=dtype)
    ring = torch.zeros(b, bps * bs, g, hd_c, dtype=cdt)
    pool = torch.zeros(b * bps + 1, bs, g, hd_c, dtype=cdt)
    p_ring = attn_ops.launch_plan(q, ring, ring, bps * bs, bits)
    p_pool = attn_ops.launch_plan(q, pool, pool, bps * bs, bits)
    assert p_ring == p_pool == attn_ops.plan(b, g, rep, hd, bps * bs, bits,
                                             dtype)


# (L, positions, window): partly filled, exactly full and wrapped rings;
# pos = 0 at L = 4096 (only the first split holds a valid slot); windows,
# one of which leaves a single split valid
VALID_CASES = [
    (256, [0, 5, 85, 255, 256, 263, 515, 1278], None),
    (256, [0, 5, 85, 255, 256, 263, 515, 1278], 64),
    (4096, [0, 0, 0, 0, 0, 0, 0, 0], None),
    (4096, [0, 5, 1365, 4095, 4096, 4103, 8195, 20478], 1024),
    (4096, [600, 1000, 1023, 1535, 5000, 4608, 8703, 4095], 400),
    (264, [0, 7, 100, 263, 264, 300, 527, 1000], 30),
    (16, [0, 3, 15, 16, 17, 31, 32, 100], None),
]


@pytest.mark.parametrize("L,positions,window", VALID_CASES)
def test_split_valid_slots_match_ring_validity(L, positions, window):
    pos = torch.tensor(positions)
    valid = ring_validity(pos, L, window)
    p = attn_ops.plan(len(positions), 8, 4, 64, L, 8, BF16)
    for row, pr in enumerate(positions):
        start, count = attn_ops.ring_window(pr, L, window)
        got = [(s - start) % L < count for s in range(L)]
        assert got == valid[row].tolist()
        for z in range(p.splits):
            lo, hi = attn_ops.split_range(p, L, z)
            iv = attn_ops.valid_intervals(start, count, L, lo, hi)
            assert [any(a <= s < b for a, b in iv) for s in range(lo, hi)] \
                == valid[row, lo:hi].tolist()
            assert attn_ops.any_valid(iv, lo, hi) == \
                bool(valid[row, lo:hi].any())
            for a in range(lo, hi, 16):       # the mma instance's chunks
                assert attn_ops.any_valid(iv, a, a + 16) == \
                    bool(valid[row, a:min(a + 16, hi)].any())


def _splits_with_valid(p, L, pos, window):
    start, count = attn_ops.ring_window(pos, L, window)
    out = []
    for z in range(p.splits):
        lo, hi = attn_ops.split_range(p, L, z)
        out.append(attn_ops.any_valid(
            attn_ops.valid_intervals(start, count, L, lo, hi), lo, hi))
    return out


def test_split_valid_slots_edge_cases():
    p = attn_ops.plan(8, 8, 4, 64, 4096, 8, BF16)
    assert _splits_with_valid(p, 4096, 0, None) == \
        [True] + [False] * (p.splits - 1)
    # a window of 100 inside split 2 (slots 1024 .. 1535) of a wrapped row
    assert _splits_with_valid(p, 4096, 4096 + 1400, 100) == \
        [z == 2 for z in range(p.splits)]
    # a wrapped window across the ring's end: the last and first splits
    assert _splits_with_valid(p, 4096, 2 * 4096 + 10, 40) == \
        [z in (0, p.splits - 1) for z in range(p.splits)]


# --------------------------------------------------------------------------
# A plain model of the kernel's split-and-merge arithmetic, held to the
# dense softmax of decode_attn_ref in fp32
# --------------------------------------------------------------------------

def _merge(parts):
    """Partials (m, s, acc) merged in the order given, as the kernel merges
    its warps and then its splits."""
    m = parts[0][0]
    for pm, _, _ in parts[1:]:
        m = torch.maximum(m, pm)
    s = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for pm, ps, pa in parts:
        w = torch.exp(pm - m)
        s = s + ps * w
        acc = acc + pa * w[..., None]
    return m, s, acc


def _split_merge_model(q, k, ks, v, vs, pos, p, window, softcap):
    """q (b, g, rep, hd) fp32; k, v (b, L, g, hd) unpacked codes; ks, vs
    (b, L, g).  Per split, the mma instance's 4 warps each keep an online
    softmax over their 16-slot chunk of every 64-slot tile (the fma
    instance: one over whole tiles); chunks without a valid slot are
    skipped; warps merge in order, then splits in order."""
    b, g, rep, hd = q.shape
    L = k.shape[1]
    warps, chunk = (4, 16) if p.instance == "mma" else (1, p.tile)
    out = torch.empty_like(q)
    for bi in range(b):
        start, count = attn_ops.ring_window(int(pos[bi]), L, window)
        splits = []
        for z in range(p.splits):
            lo, hi = attn_ops.split_range(p, L, z)
            iv = attn_ops.valid_intervals(start, count, L, lo, hi)
            state = [(torch.full((g, rep), -1e30), torch.zeros(g, rep),
                      torch.zeros(g, rep, hd)) for _ in range(warps)]
            for t0 in range(lo, hi, p.tile):
                for w in range(warps):
                    a = t0 + w * chunk
                    e = min(a + chunk, hi)
                    if not attn_ops.any_valid(iv, a, e):
                        continue
                    j = torch.arange(a, e)
                    valid = torch.zeros(e - a, dtype=torch.bool)
                    for x, y in iv:
                        valid |= (j >= x) & (j < y)
                    x = torch.einsum("grd,ngd->grn", q[bi], k[bi, a:e])
                    x = (x * ks[bi, a:e].T[:, None, :]) / math.sqrt(hd)
                    if softcap is not None:
                        x = softcap * torch.tanh(x / softcap)
                    x = x + torch.where(valid, 0.0, -1e30)
                    m, s, acc = state[w]
                    mn = torch.maximum(m, x.amax(-1))
                    al = torch.exp(m - mn)
                    pe = torch.exp(x - mn[..., None])
                    pv = torch.einsum("grn,ngd->grd",
                                      pe * vs[bi, a:e].T[:, None, :],
                                      v[bi, a:e])
                    state[w] = (mn, s * al + pe.sum(-1),
                                acc * al[..., None] + pv)
            splits.append(_merge(state))
        _, s, acc = _merge(splits)
        out[bi] = acc / s.clamp_min(1e-30)[..., None]
    return out


MODEL_CASES = [
    # (L, positions, window, softcap, bits, dtype of the plan)
    (256, [0, 5, 85, 255, 256, 263, 515, 1278], None, None, 8, BF16),
    (256, [0, 5, 85, 255, 256, 263, 515, 1278], 64, 50.0, 4, BF16),
    (256, [0, 5, 85, 255, 256, 263, 515, 1278], 64, 50.0, 8, F32),
    (4096, [0, 0, 0, 0], None, None, 8, BF16),          # 7 empty splits
    (4096, [0, 3, 4095, 6000], 1, None, 8, BF16),       # one valid slot
    (4096, [600, 1023, 5000, 20478], 100, 30.0, 4, BF16),
    (264, [0, 7, 263, 1000], 30, None, 8, BF16),         # a short split
    (16, [0, 3, 15, 100], None, None, 4, BF16),          # one tile
]


@pytest.mark.parametrize("L,positions,window,softcap,bits,dtype",
                         MODEL_CASES)
def test_split_merge_model_matches_dense_softmax(L, positions, window,
                                                 softcap, bits, dtype):
    b, g, rep, hd = len(positions), 2, 4, 64
    rng = np.random.default_rng(7)
    kq = tlayers.kv_quantize(torch.as_tensor(
        rng.normal(size=(b, L, g, hd)).astype(np.float32)), bits)
    vq = tlayers.kv_quantize(torch.as_tensor(
        rng.normal(size=(b, L, g, hd)).astype(np.float32)), bits)
    q = torch.as_tensor(rng.normal(size=(b, g, rep, hd)).astype(np.float32))
    pos = torch.tensor(positions, dtype=torch.int32)
    kw = dict(bits=bits, window=window, softcap=softcap)
    want = decode_attn_ref(q, kq["codes"], kq["scale"], vq["codes"],
                           vq["scale"], pos, **kw)
    unpack = unpack_int4_ref if bits == 4 else (lambda c: c)
    p = attn_ops.plan(b, g, rep, hd, L, bits, dtype)
    got = _split_merge_model(
        q, unpack(kq["codes"]).float(), kq["scale"][..., 0],
        unpack(vq["codes"]).float(), vq["scale"][..., 0], pos, p, window,
        softcap)
    assert torch.isfinite(got).all()
    assert _rel(got.numpy(), want.numpy()) < 1e-6
