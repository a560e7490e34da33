"""Transformer layers of the port (``repro.models.layers``): norms, RoPE,
GQA attention (full sequence and one-token decode, sliding window, logit
softcap, QK-norm), the quantized KV cache and the MLP.

Layers are functional, as in the JAX package: ``*_init`` returns a dict of
tensors, ``*_apply`` takes (params, inputs).  The compute dtype is the
dtype of the incoming activations.  Plain attention is torch einsum and
softmax (the JAX code there is jnp, not Pallas); every weight matmul goes
through ``matmul`` (the ``wqt_matmul`` kernel for QTensor weights on the
card) and quantized-cache decode through the ``decode_attn`` kernel, or
``decode_attn_paged`` over the paged KV pool (``attn_decode_paged``).
Chunked prefill (``attn_chunk_apply``) is plain torch, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.qtensor import QTensor
from ..numerics import div_scalar
from ..core.qtensor import _pack_last as _pack_int4   # int8 -> packed nibbles
from ..core.qtensor import matmul as _qt_matmul
from ..kernels.decode_attn import (decode_attn, decode_attn_paged,
                                   ring_validity)
from ..kernels.decode_attn import unpack_int4_ref as _unpack_int4

NEG_INF = -1e30


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Central weight-matmul dispatch ``x @ w``: a dense (..., K, N)
    tensor cast to the activation dtype, or a QTensor stored out-major
    (N, K) and served by the ``wqt_matmul`` kernel."""
    if isinstance(w, QTensor):
        return _qt_matmul(x, w).to(x.dtype)
    return x @ w.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(dt)


def dense_init(gen: torch.Generator, shape, device, scale=None) -> torch.Tensor:
    """Normal(0, 1/sqrt(d_in)) weights of ``shape`` (..., d_in, d_out)."""
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[-2])
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies, computed in float64 (cast by the caller)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta).astype(np.float32),
                            device=x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None        # sliding-window size (local layers)
    softcap: Optional[float] = None     # gemma2-style logit soft-capping
    qk_norm: bool = False               # gemma3-style per-head RMS on q/k
    is_cross: bool = False              # KV from encoder context (VLM)

    @property
    def q_dim(self):
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self):
        return self.n_kv_heads * self.head_dim


def attn_init(gen: torch.Generator, spec: AttnSpec, device,
              lead=()) -> Dict[str, torch.Tensor]:
    """``lead`` prepends stacking axes (the layer repeats)."""
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (spec.d_model, spec.q_dim), device),
        "wk": dense_init(gen, lead + (spec.d_model, spec.kv_dim), device),
        "wv": dense_init(gen, lead + (spec.d_model, spec.kv_dim), device),
        "wo": dense_init(gen, lead + (spec.q_dim, spec.d_model), device),
    }
    if spec.qk_norm:
        p["q_norm_scale"] = torch.ones(lead + (spec.head_dim,), device=device)
        p["k_norm_scale"] = torch.ones(lead + (spec.head_dim,), device=device)
    return p


def _qkv(params, spec: AttnSpec, x: torch.Tensor):
    """Project q, k, v from x (self-attention)."""
    b, l = x.shape[0], x.shape[1]
    q = matmul(x, params["wq"]).reshape(b, l, spec.n_heads, spec.head_dim)
    k = matmul(x, params["wk"]).reshape(b, l, spec.n_kv_heads, spec.head_dim)
    v = matmul(x, params["wv"]).reshape(b, l, spec.n_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm_scale"])
        k = rms_norm(k, params["k_norm_scale"])
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, l, kvh, d) -> (b, l, h, d) by repeating groups."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(..., q_len, k_len) additive mask from absolute positions, flat
    ``(len,)`` or per-row ``(b, len)``; negative key positions (left pads)
    are always masked."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = k_pos[..., None, :] >= 0
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _sdpa(q, k, v, bias, softcap):
    """Scores in fp32; q (b, q, h, d), k/v (b, k, h, d)."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attn_apply(params, spec: AttnSpec, x: torch.Tensor,
               positions: torch.Tensor, causal: bool = True,
               return_kv: bool = False):
    """Full-sequence self-attention (prefill).  ``return_kv`` also returns
    the rotated (k, v) so prefill fills the decode cache.  The streaming
    (``chunk``) variant of the JAX function is not ported in this slice."""
    if spec.is_cross:
        raise NotImplementedError(
            "cross-attention (xattn) is not ported yet: ROADMAP Queue 1 "
            "item 7")
    b, l, _ = x.shape
    q, k, v = _qkv(params, spec, x)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    ke = _expand_kv(k, spec.n_heads)
    ve = _expand_kv(v, spec.n_heads)
    bias = _mask_bias(positions, positions, causal, spec.window)
    if bias.ndim == 3:          # per-row positions: (b, q, k) -> (b, 1, q, k)
        bias = bias[:, None]
    o = _sdpa(q, ke, ve, bias, spec.softcap).reshape(b, l, spec.q_dim)
    out = matmul(o, params["wo"])
    return (out, (k, v)) if return_kv else out


# ---- quantized KV cache: per-vector absmax codes, int8 or int4 (two
# nibbles per byte along head_dim, even index in the low nibble)

def kv_bits(kv_quant) -> int:
    """False/None -> 0 (dense), True/'int8' -> 8, 'int4' -> 4."""
    if not kv_quant:
        return 0
    if kv_quant is True or kv_quant == "int8":
        return 8
    if kv_quant == "int4":
        return 4
    raise ValueError(f"kv_quant must be False, True, 'int8' or 'int4'; "
                     f"got {kv_quant!r}")


def kv_quantize(k: torch.Tensor, bits: int = 8) -> Dict[str, torch.Tensor]:
    """k (b, l, kvh, hd) -> int8 codes (or packed int4) + fp32 scale per
    (b, l, kvh)."""
    qmax = {8: 127.0, 4: 7.0}[bits]
    absmax = torch.amax(torch.abs(k), dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, div_scalar(absmax, qmax),
                        torch.ones_like(absmax))
    codes = torch.clamp(torch.round(k / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        if k.shape[-1] % 2:
            raise ValueError(f"int4 KV cache needs even head_dim, got "
                             f"{k.shape[-1]}")
        codes = _pack_int4(codes)
    return {"codes": codes, "scale": scale.to(torch.float32)}


def _is_quantized_cache(c) -> bool:
    return isinstance(c, dict) and "codes" in c


def _cache_write(cache, new: torch.Tensor, slot: torch.Tensor,
                 bidx: torch.Tensor):
    """Write the (b, kvh, hd) vector ``new`` at ring slots, IN PLACE (the
    JAX function returns an updated copy); returns ``cache``."""
    if _is_quantized_cache(cache):
        q = kv_quantize(new[:, None], _cache_bits(cache))   # (b, 1, kvh, *)
        cache["codes"][bidx, slot] = q["codes"][:, 0]
        cache["scale"][bidx, slot] = q["scale"][:, 0]
    else:
        cache[bidx, slot] = new.to(cache.dtype)
    return cache


def attn_decode(params, spec: AttnSpec, x: torch.Tensor, pos: torch.Tensor,
                cache_k, cache_v):
    """Single-token self-attention decode against a ring KV cache.

    x (b, 1, d_model), pos (b,) current positions.  The new K/V are
    written at ``pos % cache_len`` in place.  A quantized cache goes
    through the ``decode_attn`` kernel (its plain version for CPU
    tensors); a dense cache through grouped einsums.  Returns
    (out, cache_k, cache_v)."""
    if spec.is_cross:
        raise NotImplementedError(
            "cross-attention (xattn) decode is not ported yet: ROADMAP "
            "Queue 1 item 7")
    b = x.shape[0]
    g = spec.n_kv_heads
    rep = spec.n_heads // g
    hd = spec.head_dim

    q, k, v = _qkv(params, spec, x)
    q = apply_rope(q, pos[:, None], spec.rope_theta)
    k = apply_rope(k, pos[:, None], spec.rope_theta)
    quant = _is_quantized_cache(cache_k)
    cache_len = (cache_k["codes"] if quant else cache_k).shape[1]
    slot = torch.remainder(pos, cache_len).long()
    bidx = torch.arange(b, device=x.device)
    _cache_write(cache_k, k[:, 0], slot, bidx)
    _cache_write(cache_v, v[:, 0], slot, bidx)

    q4 = q.reshape(b, g, rep, hd)
    if quant:
        o = decode_attn(q4, cache_k["codes"], cache_k["scale"],
                        cache_v["codes"], cache_v["scale"], pos,
                        bits=_cache_bits(cache_k), window=spec.window,
                        softcap=spec.softcap)
    else:
        o = _decode_dense(q4, cache_k, cache_v, pos, spec, x.dtype)
    o = o.reshape(b, 1, spec.q_dim)
    return matmul(o, params["wo"]), cache_k, cache_v


def _cache_bits(cache) -> int:
    """4 for a packed int4 cache (uint8 codes), else 8."""
    return 4 if cache["codes"].dtype == torch.uint8 else 8


def _cache_codes(c) -> torch.Tensor:
    """Quantized-cache codes as int8, unpacking int4 nibbles."""
    codes = c["codes"]
    return _unpack_int4(codes) if codes.dtype == torch.uint8 else codes


def _decode_dense(q4: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, pos: torch.Tensor, spec: AttnSpec,
                  dtype: torch.dtype) -> torch.Tensor:
    """Decode attention of q4 (b, g, rep, hd) over a dense ring cache
    (b, L, g, hd): grouped einsums, fp32 scores, the ring-validity bias."""
    cache_len = cache_k.shape[1]
    logits = torch.einsum("bgrd,blgd->bgrl", q4,
                          cache_k.to(q4.dtype)).to(torch.float32)
    logits = logits / math.sqrt(q4.shape[-1])
    if spec.softcap is not None:
        logits = spec.softcap * torch.tanh(logits / spec.softcap)
    valid = ring_validity(pos, cache_len, spec.window)
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    probs = torch.softmax(logits + bias, dim=-1)
    return torch.einsum("bgrl,blgd->bgrd", probs.to(dtype), cache_v.to(dtype))


# ---- paged KV: the per-slot ring is replaced by a shared pool of
# ``block_size``-token blocks plus an int32 block table per row.  Table
# entry i of a row holds ring slots [i*bs, (i+1)*bs), so validity, RoPE
# positions and the quantizer are those of the ring path; only the
# physical address of a slot moves (and can be shared between tables).

def paged_gather(cache, bt: torch.Tensor):
    """Pool leaf (n_blocks, bs, kvh, ...) (dense or codes/scale dict) and
    block table (b, bps) -> the dense (b, bps*bs, kvh, ...) ring view."""
    def g(a):
        out = a[bt.long()]                           # (b, bps, bs, ...)
        return out.reshape((out.shape[0], out.shape[1] * out.shape[2])
                           + tuple(out.shape[3:]))
    if _is_quantized_cache(cache):
        return {"codes": g(cache["codes"]), "scale": g(cache["scale"])}
    return g(cache)


def _cache_write_paged(cache, new: torch.Tensor, bt: torch.Tensor,
                       slot: torch.Tensor, block_size: int):
    """Write the (b, kvh, hd) vector ``new`` at ring slot ``slot`` of each
    row through the block table into the pool, IN PLACE; returns
    ``cache``.  Rows whose table entry is 0 (cleared or idle) write into
    the reserved dump block 0, possibly several at once: which of them
    lands is undefined on CUDA, and block 0 is never read."""
    bi = torch.div(slot, block_size, rounding_mode="floor")
    off = torch.remainder(slot, block_size)
    bid = torch.gather(bt.long(), 1, bi[:, None].long())[:, 0]
    if _is_quantized_cache(cache):
        q = kv_quantize(new[:, None], _cache_bits(cache))    # (b, 1, kvh, *)
        cache["codes"][bid, off] = q["codes"][:, 0]
        cache["scale"][bid, off] = q["scale"][:, 0]
    else:
        cache[bid, off] = new.to(cache.dtype)
    return cache


def attn_decode_paged(params, spec: AttnSpec, x: torch.Tensor,
                      pos: torch.Tensor, cache_k, cache_v,
                      block_tables: torch.Tensor, block_size: int):
    """Single-token decode against the paged KV pool.

    The new K/V are quantized and written through the block table first
    (the ring path's quantizer and slot, so the same bytes), then a
    quantized pool is read by the ``decode_attn_paged`` kernel (its plain
    version for CPU tensors: gather, then the ring math) and a dense pool
    is gathered and scored as ``attn_decode`` scores a ring.  Returns
    (out, cache_k, cache_v) with the pool leaves updated in place."""
    if spec.is_cross:
        raise ValueError("paged decode serves self-attention only")
    b = x.shape[0]
    g = spec.n_kv_heads
    rep = spec.n_heads // g
    hd = spec.head_dim
    bps = block_tables.shape[1]
    cache_len = bps * block_size

    q, k, v = _qkv(params, spec, x)
    q = apply_rope(q, pos[:, None], spec.rope_theta)
    k = apply_rope(k, pos[:, None], spec.rope_theta)
    slot = torch.remainder(pos, cache_len).long()
    _cache_write_paged(cache_k, k[:, 0], block_tables, slot, block_size)
    _cache_write_paged(cache_v, v[:, 0], block_tables, slot, block_size)

    q4 = q.reshape(b, g, rep, hd)
    if _is_quantized_cache(cache_k):
        o = decode_attn_paged(q4, cache_k["codes"], cache_k["scale"],
                              cache_v["codes"], cache_v["scale"],
                              block_tables, pos, bits=_cache_bits(cache_k),
                              window=spec.window, softcap=spec.softcap)
    else:
        o = _decode_dense(q4, paged_gather(cache_k, block_tables),
                          paged_gather(cache_v, block_tables), pos, spec,
                          x.dtype)
    o = o.reshape(b, 1, spec.q_dim)
    return matmul(o, params["wo"]), cache_k, cache_v


def attn_chunk_apply(params, spec: AttnSpec, x: torch.Tensor,
                     positions: torch.Tensor, chunk_lens: torch.Tensor,
                     cache_k, cache_v):
    """Chunked-prefill attention: a chunk of new prompt tokens x (b, cw,
    d) at absolute ``positions`` (b, cw), ``chunk_lens`` (b,) of them real
    (the rest right padding), against a partial KV ring cache.

    Queries attend the union of the pre-chunk cache (slot validity from
    ``start - 1``, as decode derives it from ``pos``) and the chunk's
    fresh keys under the causal and window masks; scoring the pre-write
    cache plus the fresh keys keeps sliding-window layers exact.  The
    chunk's K/V are then written at ``pos % L``, only each slot's newest
    real position (pad columns and older ring duplicates go to a dump row
    that is cut off), IN PLACE, so the cache ends as per-token decode
    writes would leave it.  Returns (out (b, cw, d), cache_k, cache_v)."""
    if spec.is_cross:
        raise NotImplementedError(
            "cross-attention (xattn) is not ported yet: ROADMAP Queue 1 "
            "item 7")
    b, cw, _ = x.shape
    g = spec.n_kv_heads
    rep = spec.n_heads // g
    hd = spec.head_dim
    dev = x.device

    q, k, v = _qkv(params, spec, x)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    quant = _is_quantized_cache(cache_k)
    L = (cache_k["codes"] if quant else cache_k).shape[1]
    q4 = q.reshape(b, cw, g, rep, hd)
    scale = float(1.0 / np.sqrt(hd))

    # (a) the pre-chunk cache: slot j holds p_j, the largest p <= start-1
    # with p % L == j
    prev_last = positions[:, 0] - 1
    j = torch.arange(L, device=dev)
    p_j = prev_last[:, None] - torch.remainder(prev_last[:, None] - j[None, :],
                                               L)

    def scale_t(c):                                  # (b, g, 1, 1, L)
        return c["scale"][..., 0].permute(0, 2, 1)[:, :, None, None, :]

    if quant:
        s_c = torch.einsum("bqgrd,blgd->bgrql", q4,
                           _cache_codes(cache_k).to(q4.dtype))
        s_c = s_c.to(torch.float32) * scale_t(cache_k)
    else:
        s_c = torch.einsum("bqgrd,blgd->bgrql", q4,
                           cache_k.to(q4.dtype)).to(torch.float32)
    ok_c = (p_j >= 0)[:, None, :]                                # (b, 1, L)
    if spec.window is not None:
        ok_c = ok_c & (positions[:, :, None] - p_j[:, None, :] < spec.window)
    bias_c = torch.where(ok_c, 0.0, NEG_INF).to(torch.float32)

    # (b) causal scores against the chunk's fresh keys
    kcol_ok = torch.arange(cw, device=dev)[None, :] < chunk_lens[:, None]
    d = positions[:, :, None] - positions[:, None, :]
    ok_f = (d >= 0) & kcol_ok[:, None, :]
    if spec.window is not None:
        ok_f = ok_f & (d < spec.window)
    bias_f = torch.where(ok_f, 0.0, NEG_INF).to(torch.float32)
    k4 = k.reshape(b, cw, g, hd)
    s_f = torch.einsum("bqgrd,bkgd->bgrqk", q4, k4).to(torch.float32)

    logits = torch.cat([s_c, s_f], -1) * scale
    if spec.softcap is not None:
        logits = spec.softcap * torch.tanh(logits / spec.softcap)
    lead = logits.shape[:-1]
    bias = torch.cat([bias_c[:, None, None].expand(lead + (L,)),
                      bias_f[:, None, None].expand(lead + (cw,))], -1)
    probs = torch.softmax(logits + bias, dim=-1)
    p_c = probs[..., :L]
    if quant:
        o = torch.einsum("bgrql,blgd->bqgrd",
                         (p_c * scale_t(cache_v)).to(x.dtype),
                         _cache_codes(cache_v).to(x.dtype))
    else:
        o = torch.einsum("bgrql,blgd->bqgrd", p_c.to(x.dtype),
                         cache_v.to(x.dtype))
    o = o + torch.einsum("bgrqk,bkgd->bqgrd", probs[..., L:].to(x.dtype),
                         v.reshape(b, cw, g, hd))
    out = matmul(o.reshape(b, cw, spec.q_dim), params["wo"])

    # scatter the chunk's K/V at ring slots: per slot only the newest real
    # position lands, the rest go to dump row L
    last_real = positions[:, 0] + chunk_lens - 1
    keep = kcol_ok & (positions >= (last_real - L + 1)[:, None])
    slots = torch.where(keep, torch.remainder(positions, L), L).long()
    bidx = torch.arange(b, device=dev)[:, None]

    def write(dst, vals, fill):
        buf = torch.cat([dst, torch.full((b, 1) + tuple(dst.shape[2:]), fill,
                                         dtype=dst.dtype, device=dev)], 1)
        buf[bidx, slots] = vals.to(dst.dtype)
        dst.copy_(buf[:, :L])

    for cache, vals in ((cache_k, k4), (cache_v, v.reshape(b, cw, g, hd))):
        if quant:
            qv = kv_quantize(vals, _cache_bits(cache))
            write(cache["codes"], qv["codes"], 0)
            write(cache["scale"], qv["scale"], 1.0)
        else:
            write(cache, vals, 0)
    return out, cache_k, cache_v


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLPSpec:
    d_model: int
    d_ff: int
    kind: str = "swiglu"   # swiglu | geglu | gelu


def mlp_init(gen: torch.Generator, spec: MLPSpec, device, lead=()):
    lead = tuple(lead)
    p = {"w_up": dense_init(gen, lead + (spec.d_model, spec.d_ff), device),
         "w_down": dense_init(gen, lead + (spec.d_ff, spec.d_model), device)}
    if spec.kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, lead + (spec.d_model, spec.d_ff), device)
    return p


def mlp_apply(params, spec: MLPSpec, x: torch.Tensor) -> torch.Tensor:
    up = matmul(x, params["w_up"])
    if spec.kind == "swiglu":
        h = F.silu(matmul(x, params["w_gate"])) * up
    elif spec.kind == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(matmul(x, params["w_gate"]), approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return matmul(h, params["w_down"])
