"""Wrappers of the ``decode_attn`` CUDA kernel (``csrc/decode_attn.cu``):
``decode_attn`` over a ring KV cache and ``decode_attn_paged`` over the
paged KV pool (the same kernel, slots addressed through a block table).

For a CUDA tensor each launches the kernel or raises; for a CPU tensor it
takes the plain version in ``ref.py``.  Each wrapper's ``.launches``
counts its launches (nothing else adds to it).  ``plan`` chooses how
``decode_attn.cu`` runs a call: its instance (tensor-core ``mma`` for bf16
queries, CUDA-core ``fma`` otherwise), the splits of the ring (one thread
block each, one cluster per (b, kv-head)), the tile and the stage count.
``ring_window``, ``valid_intervals``, ``any_valid`` and ``split_range``
are the kernel's slot arithmetic in Python.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from .ref import decode_attn_paged_ref, decode_attn_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_kv(q, k_codes, k_scale, v_codes, v_scale, lead, bits: int):
    """Raise unless codes are ``lead + (g, hd[/2])`` and scales ``lead +
    (g, 1)``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    g, hd = q.shape[1], q.shape[3]
    hd_c = hd // 2 if bits == 4 else hd
    cdtype = torch.uint8 if bits == 4 else torch.int8
    for name, c in (("k_codes", k_codes), ("v_codes", v_codes)):
        if tuple(c.shape) != lead + (g, hd_c) or c.dtype != cdtype:
            raise ValueError(f"{name} must be {cdtype} {lead + (g, hd_c)} for "
                             f"bits={bits}, got {c.dtype} {tuple(c.shape)}")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != lead + (g, 1) or s.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {lead + (g, 1)}, got "
                             f"{s.dtype} {tuple(s.shape)}")


def _check_cuda(q, tensors, window, softcap) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cuda or cpu, got {q.device}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode_attn inputs must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("decode_attn inputs must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


# --------------------------------------------------------------------------
# The launch plan of decode_attn.cu (ring and paged alike)
# --------------------------------------------------------------------------

SMS = 132                    # streaming multiprocessors of an H100 SXM
INSTANCES = ("mma", "fma")   # index = the C launcher's ``instance``
MMA_TILE = 64                # slots a tile: one 16-slot chunk per warp
MMA_MAX_REP = 8              # queries per kv-head: one n8 tile
MMA_HD = (32, 64, 128)       # head dims with an mma instance
SPLIT_UNIT = 16              # splits hold a multiple of 16 slots
CLUSTER_SPLITS = 8           # at most 8 splits: one cluster per (b, head)
MAX_STAGES = 4               # the mma instance's cp.async ring
RING_BYTES = 24 * 1024       # ... and its shared-memory budget


class Plan(NamedTuple):
    """How ``decode_attn.cu`` runs one call: the instance, ``splits``
    splits of the ring of ``slots_per_split`` slots each (grid x, one
    cluster), walked in tiles of ``tile`` slots through ``stages``
    shared-memory stages (the ``fma`` instance loads synchronously: 1),
    and the grid's block count."""
    instance: str
    splits: int
    slots_per_split: int
    tile: int
    stages: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def mma_stage_bytes(hd: int, bits: int) -> int:
    """One stage of the mma instance's ring (``MmaTile::kStage``): K and V
    code tiles with padded rows, and their scales."""
    words = (hd // 2 if bits == 4 else hd) // 4
    k_stride = words + 4
    v_stride = words if words % 16 == 8 else words + 8
    return MMA_TILE * 4 * (k_stride + v_stride) + 2 * MMA_TILE * 4


@functools.lru_cache(maxsize=1024)
def plan(b: int, g: int, rep: int, hd: int, L: int, bits: int,
         dtype: torch.dtype, aligned: bool = True) -> Plan:
    """The launch plan for q (b, g, rep, hd) of ``dtype`` against a ring of
    L slots of ``bits``-bit codes; a function of the shapes only, so ring
    and paged calls of one shape run the same arithmetic.

    ``aligned``: q and both code tensors start 16-byte aligned and a code
    row is a multiple of 16 bytes.  bf16 q with rep <= 8, hd in (32, 64,
    128), code rows of a multiple of 32 bytes and ``aligned`` takes the
    tensor cores (``mma``, 64-slot tiles); anything else the CUDA-core
    ``fma`` instance (tiles of 4096 / hd slots, 8 to 64).  The ring splits
    into as many splits as it has tiles, at most 8, each a multiple of 16
    slots; the mma ring has as many stages as a split has tiles, at most 4
    within 24 KB (at least 2 where a split has 2 tiles: at L = 4096 the
    int8 ring holds 2 stages; 4 stages, 50 KB a block, measured slower)."""
    hd_c = hd // 2 if bits == 4 else hd
    mma = (dtype == torch.bfloat16 and aligned and rep <= MMA_MAX_REP
           and hd in MMA_HD and hd_c % 32 == 0)
    tile = MMA_TILE if mma else max(8, min(64, 4096 // hd))
    splits = max(1, min(CLUSTER_SPLITS, _cdiv(L, tile)))
    per = _cdiv(_cdiv(L, splits), SPLIT_UNIT) * SPLIT_UNIT
    splits = _cdiv(L, per)
    stages = 1
    if mma:
        stages = min(_cdiv(per, tile), MAX_STAGES,
                     max(2, RING_BYTES // mma_stage_bytes(hd, bits)))
    return Plan("mma" if mma else "fma", splits, per, tile, stages,
                b * g * splits)


def split_range(p: Plan, L: int, z: int) -> Tuple[int, int]:
    """Slots [lo, hi) of split z: the splits end at L, ``slots_per_split``
    each, the first one short where they overhang."""
    hi = L - (p.splits - 1 - z) * p.slots_per_split
    return max(0, hi - p.slots_per_split), hi


def ring_window(pos: int, L: int, window: Optional[int]) -> Tuple[int, int]:
    """(start, count): a row at ``pos`` holds valid positions in ring slots
    (start + i) % L for i < count, the ``count`` youngest, count = min(pos
    + 1, L, window)."""
    count = min(pos + 1, L)
    if window:
        count = min(count, window)
    return ((pos + 1 - count) % L if count > 0 else 0), count


Intervals = Tuple[Tuple[int, int], Tuple[int, int]]


def valid_intervals(start: int, count: int, L: int, lo: int,
                    hi: int) -> Intervals:
    """The valid slots of split [lo, hi): at most two intervals [a, b)
    (empty where a >= b), the kernel's ``Valid``."""
    end = start + count
    return ((max(lo, start), min(hi, end, L)), (lo, min(hi, end - L)))


def any_valid(iv: Intervals, a: int, b: int) -> bool:
    """Whether slots [a, b) hold a valid one."""
    return any(x < y and a < y and b > x for x, y in iv)


def launch_plan(q: torch.Tensor, k_codes: torch.Tensor,
                v_codes: torch.Tensor, L: int, bits: int) -> Plan:
    """``plan`` for these tensors (what the wrappers launch)."""
    b, g, rep, hd = q.shape
    aligned = ((hd // 2 if bits == 4 else hd) % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in (q, k_codes, v_codes)))
    return plan(b, g, rep, hd, L, bits, q.dtype, aligned)


# --------------------------------------------------------------------------
# The wrappers
# --------------------------------------------------------------------------

def decode_attn(q: torch.Tensor, k_codes: torch.Tensor, k_scale: torch.Tensor,
                v_codes: torch.Tensor, v_scale: torch.Tensor, pos: torch.Tensor,
                *, bits: int = 8, window=None, softcap=None) -> torch.Tensor:
    """One fused decode step: q (b, g, rep, hd) against an int8 / packed
    int4 ring KV cache (codes (b, L, g, hd[/2]), scales (b, L, g, 1),
    positions (b,)) -> (b, g, rep, hd) in q.dtype."""
    b, g, rep, hd = q.shape
    L = k_codes.shape[1]
    _check_kv(q, k_codes, k_scale, v_codes, v_scale, (b, L), bits)
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if _build.plain(q):
        return decode_attn_ref(q, k_codes, k_scale, v_codes, v_scale, pos,
                               bits=bits, window=window, softcap=softcap)
    _check_cuda(q, (q, k_codes, k_scale, v_codes, v_scale, pos), window,
                softcap)
    lib = _build.lib()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    p = launch_plan(q, k_codes, v_codes, L, bits)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attn_launch(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), pos32.data_ptr(),
        out.data_ptr(), b, g, rep, hd, L, bits, int(window or 0),
        float(softcap or 0.0), _DTYPES[q.dtype],
        INSTANCES.index(p.instance), p.splits, p.slots_per_split, p.tile,
        p.stages, stream)
    _build.check(err, "decode_attn")
    decode_attn.launches += 1
    return out


decode_attn.launches = 0


def decode_attn_paged(q: torch.Tensor, k_codes: torch.Tensor,
                      k_scale: torch.Tensor, v_codes: torch.Tensor,
                      v_scale: torch.Tensor, block_tables: torch.Tensor,
                      pos: torch.Tensor, *, bits: int = 8, window=None,
                      softcap=None) -> torch.Tensor:
    """One fused decode step against the paged pool: q (b, g, rep, hd),
    pool codes (n_blocks, bs, g, hd[/2]) and scales (n_blocks, bs, g, 1)
    shared by all rows, block tables (b, bps) of pool block ids (each
    below n_blocks: the kernel reads through them unchecked) and positions
    (b,) -> (b, g, rep, hd) in q.dtype.  Row i's ring slot j lives in
    block ``block_tables[i, j // bs]``; the ring length is bps * bs."""
    b, g, rep, hd = q.shape
    n_blocks, bs = k_codes.shape[0], k_codes.shape[1]
    _check_kv(q, k_codes, k_scale, v_codes, v_scale, (n_blocks, bs), bits)
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be ({b}, bps), got "
                         f"{tuple(block_tables.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if _build.plain(q):
        return decode_attn_paged_ref(q, k_codes, k_scale, v_codes, v_scale,
                                     block_tables, pos, bits=bits,
                                     window=window, softcap=softcap)
    _check_cuda(q, (q, k_codes, k_scale, v_codes, v_scale, block_tables, pos),
                window, softcap)
    lib = _build.lib()
    bps = block_tables.shape[1]
    bt32 = block_tables.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    p = launch_plan(q, k_codes, v_codes, bps * bs, bits)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attn_paged_launch(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), bt32.data_ptr(),
        pos32.data_ptr(), out.data_ptr(), b, g, rep, hd, bps, bs, bits,
        int(window or 0), float(softcap or 0.0), _DTYPES[q.dtype],
        INSTANCES.index(p.instance), p.splits, p.slots_per_split, p.tile,
        p.stages, stream)
    _build.check(err, "decode_attn_paged")
    decode_attn_paged.launches += 1
    return out


decode_attn_paged.launches = 0
