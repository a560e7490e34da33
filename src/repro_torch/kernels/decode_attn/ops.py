"""Wrappers of the ``decode_attn`` CUDA kernel (``csrc/decode_attn.cu``):
``decode_attn`` over a ring KV cache and ``decode_attn_paged`` over the
paged KV pool (the same kernel, slots addressed through a block table).

For a CUDA tensor each launches the kernel or raises; for a CPU tensor it
takes the plain version in ``ref.py``.  Each wrapper's ``.launches``
counts its launches (nothing else adds to it).
"""

from __future__ import annotations

import torch

from .ref import decode_attn_paged_ref, decode_attn_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_kv(q, k_codes, k_scale, v_codes, v_scale, lead, bits: int):
    """Codes ``lead + (g, hd[/2])`` and scales ``lead + (g, 1)``."""
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
    return hd_c


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


def decode_attn(q: torch.Tensor, k_codes: torch.Tensor, k_scale: torch.Tensor,
                v_codes: torch.Tensor, v_scale: torch.Tensor, pos: torch.Tensor,
                *, bits: int = 8, window=None, softcap=None) -> torch.Tensor:
    """One fused decode step: q (b, g, rep, hd) against an int8 / packed
    int4 ring KV cache (codes (b, L, g, hd[/2]), scales (b, L, g, 1),
    positions (b,)) -> (b, g, rep, hd) in q.dtype."""
    b, g, rep, hd = q.shape
    L = k_codes.shape[1]
    hd_c = _check_kv(q, k_codes, k_scale, v_codes, v_scale, (b, L), bits)
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if q.device.type == "cpu":
        return decode_attn_ref(q, k_codes, k_scale, v_codes, v_scale, pos,
                               bits=bits, window=window, softcap=softcap)
    _check_cuda(q, (q, k_codes, k_scale, v_codes, v_scale, pos), window,
                softcap)
    from repro_torch.kernels import _build
    lib = _build.lib()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    vec_ok = int(hd_c % 16 == 0 and k_codes.data_ptr() % 16 == 0
                 and v_codes.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attn_launch(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), pos32.data_ptr(),
        out.data_ptr(), b, g, rep, hd, L, bits, int(window or 0),
        float(softcap or 0.0), _DTYPES[q.dtype], vec_ok, stream)
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
    hd_c = _check_kv(q, k_codes, k_scale, v_codes, v_scale, (n_blocks, bs),
                     bits)
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be ({b}, bps), got "
                         f"{tuple(block_tables.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if q.device.type == "cpu":
        return decode_attn_paged_ref(q, k_codes, k_scale, v_codes, v_scale,
                                     block_tables, pos, bits=bits,
                                     window=window, softcap=softcap)
    _check_cuda(q, (q, k_codes, k_scale, v_codes, v_scale, block_tables, pos),
                window, softcap)
    from repro_torch.kernels import _build
    lib = _build.lib()
    bps = block_tables.shape[1]
    bt32 = block_tables.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    vec_ok = int(hd_c % 16 == 0 and k_codes.data_ptr() % 16 == 0
                 and v_codes.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attn_paged_launch(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
        v_codes.data_ptr(), v_scale.data_ptr(), bt32.data_ptr(),
        pos32.data_ptr(), out.data_ptr(), b, g, rep, hd, bps, bs, bits,
        int(window or 0), float(softcap or 0.0), _DTYPES[q.dtype], vec_ok,
        stream)
    _build.check(err, "decode_attn_paged")
    decode_attn_paged.launches += 1
    return out


decode_attn_paged.launches = 0
