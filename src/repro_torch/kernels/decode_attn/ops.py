"""Wrapper of the ``decode_attn`` CUDA kernel (``csrc/decode_attn.cu``).

For a CUDA tensor it launches the kernel or raises; for a CPU tensor it
takes the plain version in ``ref.py``.  ``decode_attn.launches`` counts the
kernel's launches (nothing else adds to it).
"""

from __future__ import annotations

import torch

from .ref import decode_attn_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attn(q: torch.Tensor, k_codes: torch.Tensor, k_scale: torch.Tensor,
                v_codes: torch.Tensor, v_scale: torch.Tensor, pos: torch.Tensor,
                *, bits: int = 8, window=None, softcap=None) -> torch.Tensor:
    """One fused decode step: q (b, g, rep, hd) against an int8 / packed
    int4 ring KV cache (codes (b, L, g, hd[/2]), scales (b, L, g, 1),
    positions (b,)) -> (b, g, rep, hd) in q.dtype."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    b, g, rep, hd = q.shape
    L = k_codes.shape[1]
    hd_c = hd // 2 if bits == 4 else hd
    cdtype = torch.uint8 if bits == 4 else torch.int8
    for name, c in (("k_codes", k_codes), ("v_codes", v_codes)):
        if tuple(c.shape) != (b, L, g, hd_c) or c.dtype != cdtype:
            raise ValueError(f"{name} must be {cdtype} {(b, L, g, hd_c)} for "
                             f"bits={bits}, got {c.dtype} {tuple(c.shape)}")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != (b, L, g, 1) or s.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(b, L, g, 1)}, got "
                             f"{s.dtype} {tuple(s.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if q.device.type == "cpu":
        return decode_attn_ref(q, k_codes, k_scale, v_codes, v_scale, pos,
                               bits=bits, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cuda or cpu, got {q.device}")
    tensors = (q, k_codes, k_scale, v_codes, v_scale, pos)
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
