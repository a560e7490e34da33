"""Plain PyTorch version of the fused quantized decode attention.

Line for line ``repro.kernels.decode_attn.ref`` (itself the quantized
fallback of ``attn_decode``): raw codes contract in the activation dtype,
the fp32 scales fold into the small score and probability tensors, softcap
comes before the ring-validity bias.  The CPU tests hold it to the JAX
oracle; ``chip_smoke.py`` holds the CUDA kernel to it on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def unpack_int4_ref(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., hd/2) -> int8 (..., hd); low nibble = even index,
    sign-extended [-8, 7] nibbles (the kv_quantize layout)."""
    c = packed.to(torch.int16)
    lo = c & 0xF
    hi = (c >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(packed.shape[:-1] + (2 * packed.shape[-1],))


def ring_validity(pos: torch.Tensor, cache_len: int,
                  window: Optional[int]) -> torch.Tensor:
    """(b, cache_len) bool: ring slot j of a row at ``pos`` holds absolute
    position p_j = the largest p <= pos with p % cache_len == j; valid iff
    p_j >= 0 (and pos - p_j < window).  torch's ``%`` on integer tensors
    is floored, like Python's and JAX's, so the modulo is non-negative."""
    j = torch.arange(cache_len, device=pos.device)
    p_j = pos[:, None] - torch.remainder(pos[:, None] - j[None, :], cache_len)
    valid = p_j >= 0
    if window is not None:
        valid &= (pos[:, None] - p_j) < window
    return valid


def decode_attn_ref(q: torch.Tensor, k_codes: torch.Tensor,
                    k_scale: torch.Tensor, v_codes: torch.Tensor,
                    v_scale: torch.Tensor, pos: torch.Tensor, *,
                    bits: int = 8, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q (b, g, rep, hd); codes (b, L, g, hd) int8 or (b, L, g, hd/2)
    uint8; scales (b, L, g, 1) fp32; pos (b,) int -> (b, g, rep, hd)."""
    hd = q.shape[-1]
    L = k_codes.shape[1]
    if bits == 4:
        k = unpack_int4_ref(k_codes)
        v = unpack_int4_ref(v_codes)
    else:
        k, v = k_codes, v_codes
    s = torch.einsum("bgrd,blgd->bgrl", q, k.to(q.dtype))
    scale_t = k_scale[..., 0].permute(0, 2, 1)[:, :, None, :]     # (b,g,1,l)
    logits = (s.to(torch.float32) * scale_t) / math.sqrt(hd)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    valid = ring_validity(pos, L, window)
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, :]     # (b,1,1,l)
    probs = torch.softmax(logits + bias, dim=-1)
    p = probs * v_scale[..., 0].permute(0, 2, 1)[:, :, None, :]
    return torch.einsum("bgrl,blgd->bgrd", p.to(q.dtype), v.to(q.dtype))


def gather_pool_ref(pool: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Pool leaf (n_blocks, bs, g, x) + tables (b, bps) -> the dense
    per-row ring view (b, bps * bs, g, x) the paged kernel reads over."""
    out = pool[block_tables.long()]                  # (b, bps, bs, g, x)
    return out.reshape((out.shape[0], out.shape[1] * out.shape[2])
                       + tuple(out.shape[3:]))


def decode_attn_paged_ref(q: torch.Tensor, k_codes: torch.Tensor,
                          k_scale: torch.Tensor, v_codes: torch.Tensor,
                          v_scale: torch.Tensor, block_tables: torch.Tensor,
                          pos: torch.Tensor, *, bits: int = 8,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Paged attention is ring attention over a scattered address space:
    gather each row's blocks into the dense ring view, then run
    ``decode_attn_ref`` on it."""
    return decode_attn_ref(
        q, gather_pool_ref(k_codes, block_tables),
        gather_pool_ref(k_scale, block_tables),
        gather_pool_ref(v_codes, block_tables),
        gather_pool_ref(v_scale, block_tables), pos,
        bits=bits, window=window, softcap=softcap)
