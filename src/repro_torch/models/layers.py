"""Transformer layers of the port (``repro.models.layers``): norms, RoPE,
GQA attention (full sequence and one-token decode, sliding window, logit
softcap, QK-norm; cross-attention from an encoder context with no RoPE
and no mask), the quantized KV cache, the MLP and the GShard MoE.

Layers are functional, as in the JAX package: ``*_init`` returns a dict of
tensors, ``*_apply`` takes (params, inputs).  The compute dtype is the
dtype of the incoming activations.  Plain attention is torch einsum and
softmax (the JAX code there is jnp, not Pallas); every weight matmul goes
through ``matmul`` (the ``wqt_matmul`` kernel for QTensor weights on the
card) and quantized-cache decode through the ``decode_attn`` kernel, or
``decode_attn_paged`` over the paged KV pool (``attn_decode_paged``).
Chunked prefill (``attn_chunk_apply``), streaming attention over key
chunks (``attn_apply(chunk=)``, ``_streaming_sdpa``) and cross-attention
(the dense cross K/V, never quantized) are plain torch, as in JAX; so
are the MoE's routing, its one-hot dispatch and combine, and its dense
expert einsums (JAX's are outside any Pallas kernel too); QTensor
experts go through the 3-D QTensor matmul.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

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


# lm_init's hook on each parameter leaf as it is finished (the sharded
# init keeps this rank's block of it); None keeps the leaf whole
_LEAF_HOOK: Optional[Callable] = None


def init_leaf(x: torch.Tensor) -> torch.Tensor:
    """A finished parameter leaf of an init function, through the hook."""
    return x if _LEAF_HOOK is None else _LEAF_HOOK(x)


def dense_init(gen: torch.Generator, shape, device, scale=None) -> torch.Tensor:
    """Normal(0, 1/sqrt(d_in)) weights of ``shape`` (..., d_in, d_out)."""
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[-2])
    return init_leaf(torch.randn(shape, generator=gen, device=device,
                                 dtype=torch.float32) * scale)


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
        p["q_norm_scale"] = init_leaf(torch.ones(lead + (spec.head_dim,),
                                                 device=device))
        p["k_norm_scale"] = init_leaf(torch.ones(lead + (spec.head_dim,),
                                                 device=device))
    return p


def _qkv(params, spec: AttnSpec, x: torch.Tensor,
         ctx: Optional[torch.Tensor] = None):
    """Project q from x, k and v from ``ctx`` (cross) or x (self)."""
    b, l = x.shape[0], x.shape[1]
    src = ctx if spec.is_cross else x
    if src is None:
        raise ValueError("cross-attention needs its context (the projected "
                         "image embeddings), got ctx=None")
    ls = src.shape[1]
    q = matmul(x, params["wq"]).reshape(b, l, spec.n_heads, spec.head_dim)
    k = matmul(src, params["wk"]).reshape(b, ls, spec.n_kv_heads,
                                          spec.head_dim)
    v = matmul(src, params["wv"]).reshape(b, ls, spec.n_kv_heads,
                                          spec.head_dim)
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
               chunk: Optional[int] = None, return_kv: bool = False,
               ctx: Optional[torch.Tensor] = None):
    """Full-sequence attention (train / prefill).  ``chunk`` streams the
    keys in chunks of that many through an online softmax
    (``_streaming_sdpa``), so no score tensor of the full key length is
    held; ``return_kv`` also returns the (rotated) (k, v) so prefill fills
    the decode cache.  Cross-attention (``spec.is_cross``) takes k and v
    from ``ctx`` (b, n, d_model): no RoPE, key positions ``arange(n)``,
    not causal."""
    b, l, _ = x.shape
    q, k, v = _qkv(params, spec, x, ctx)
    if spec.is_cross:
        k_pos = torch.arange(k.shape[1], device=x.device)
        causal = False
    else:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
        k_pos = positions
    if chunk is None or k.shape[1] <= chunk:
        ke = _expand_kv(k, spec.n_heads)
        ve = _expand_kv(v, spec.n_heads)
        bias = _mask_bias(positions, k_pos, causal, spec.window)
        if bias.ndim == 3:      # per-row positions: (b, q, k) -> (b, 1, q, k)
            bias = bias[:, None]
        o = _sdpa(q, ke, ve, bias, spec.softcap)
    else:
        o = _streaming_sdpa(q, k, v, positions, k_pos, causal,
                            spec.window, spec.softcap, chunk)
    out = matmul(o.reshape(b, l, spec.q_dim), params["wo"])
    return (out, (k, v)) if return_kv else out


PAD_POS = 10 ** 9     # key position of a padded slot: after every query


def _stream_step(m, s, o, logits, vc, dtype):
    """One key chunk of the online softmax: the running max ``m``,
    denominator ``s`` and output ``o`` (fp32, (b, g, rep, q[, d])) are
    rescaled by ``alpha = exp(m - m_new)`` and the chunk's probabilities
    (``logits`` (b, g, rep, q, chunk), fp32) and values ``vc`` (b, chunk,
    g, d) added."""
    m_new = torch.maximum(m, torch.amax(logits, dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    s_new = s * alpha + torch.sum(p, dim=-1)
    o_new = o * alpha[..., None] + torch.einsum(
        "bgrqk,bkgd->bgrqd", p.to(dtype), vc).to(torch.float32)
    return m_new, s_new, o_new


def _stream_chunk(m, s, o, q4, kc, vc, q_pos, kpc, causal, window, softcap,
                  scale):
    """The scores of one key chunk and its online-softmax step."""
    logits = torch.einsum("bqgrd,bkgd->bgrqk", q4, kc).to(torch.float32)
    logits = logits * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    bias = _mask_bias(q_pos, kpc, causal, window)
    # padded slots carry sentinel positions: masked even when non-causal
    bias = torch.where(kpc[..., None, :] >= PAD_POS, NEG_INF, bias)
    # (q, k) -> (1, 1, 1, q, k); per-row (b, q, k) -> (b, 1, 1, q, k)
    bias = bias[:, None, None] if bias.ndim == 3 else bias[None, None, None]
    return _stream_step(m, s, o, logits + bias, vc, q4.dtype)


def _streaming_sdpa(q, k, v, q_pos, k_pos, causal, window, softcap,
                    chunk: int):
    """Online softmax over key chunks of ``chunk`` (the flash-attention
    dataflow in torch ops), after the JAX function of the same name.

    GQA-native: k and v keep their ``g`` heads.  The key length is padded
    to a whole number of chunks, the padded slots at the sentinel future
    position ``PAD_POS``.  The running max, denominator and output are
    fp32; the output is cast to q's dtype at the end.  With gradients on,
    each chunk is recomputed in backward (``torch.utils.checkpoint``), so
    backward too holds one (b, g, rep, q, chunk) score tile at a time."""
    b, ql, h, d = q.shape
    g = k.shape[2]
    rep = h // g
    kl = k.shape[1]
    n_chunks = -(-kl // chunk)
    pad = n_chunks * chunk - kl
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=PAD_POS)
    q4 = q.reshape(b, ql, g, rep, d)
    scale = 1.0 / np.sqrt(d)
    m = torch.full((b, g, rep, ql), NEG_INF, dtype=torch.float32,
                   device=q.device)
    s = torch.zeros((b, g, rep, ql), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, g, rep, ql, d), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (m, s, o, q4, k[:, sl], v[:, sl], q_pos, k_pos[..., sl],
                causal, window, softcap, scale)
        if remat:
            m, s, o = torch.utils.checkpoint.checkpoint(
                _stream_chunk, *args, use_reentrant=False)
        else:
            m, s, o = _stream_chunk(*args)
    o = o / torch.clamp_min(s, 1e-30)[..., None]
    # (b, g, rep, q, d) -> (b, q, h, d)
    return o.permute(0, 3, 1, 2, 4).reshape(b, ql, h, d).to(q.dtype)


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
                cache_k, cache_v, cross_kv=None):
    """Single-token decode against a ring KV cache.

    x (b, 1, d_model), pos (b,) current positions.  The new K/V are
    written at ``pos % cache_len`` in place.  A quantized cache goes
    through the ``decode_attn`` kernel (its plain version for CPU
    tensors); a dense cache through grouped einsums.  Cross-attention
    (``spec.is_cross``) projects q only and attends ``cross_kv`` (the
    cached (k, v), (b, n, kvh, hd)) with no mask; its caches are returned
    unchanged.  Returns (out, cache_k, cache_v)."""
    if spec.is_cross:
        return _cross_decode(params, spec, x, cross_kv), cache_k, cache_v
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


def _cross_decode(params, spec: AttnSpec, x: torch.Tensor,
                  cross_kv) -> torch.Tensor:
    """One token's cross-attention over the cached cross K/V: grouped
    einsums, fp32 scores, a softmax over every context token (JAX's is
    jnp, outside any kernel)."""
    if cross_kv is None:
        raise ValueError("cross-attention decode needs the cached cross "
                         "K/V (cross_kv)")
    b = x.shape[0]
    g = spec.n_kv_heads
    hd = spec.head_dim
    q = matmul(x, params["wq"]).reshape(b, spec.n_heads, hd)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm_scale"])
    q4 = q.reshape(b, g, spec.n_heads // g, hd)
    k, v = cross_kv
    logits = torch.einsum("bgrd,blgd->bgrl", q4,
                          k.to(q4.dtype)).to(torch.float32)
    logits = div_scalar(logits, math.sqrt(hd))
    if spec.softcap is not None:
        logits = spec.softcap * torch.tanh(logits / spec.softcap)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bgrl,blgd->bgrd", probs.to(x.dtype), v.to(x.dtype))
    return matmul(o.reshape(b, 1, spec.q_dim), params["wo"])


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
    writes would leave it.  Cross-attention (``spec.is_cross``) attends
    the cached cross K/V (position-free context) with no mask and leaves
    the cache as it is.  Returns (out (b, cw, d), cache_k, cache_v)."""
    b, cw, _ = x.shape
    g = spec.n_kv_heads
    rep = spec.n_heads // g
    hd = spec.head_dim
    dev = x.device
    if spec.is_cross:
        q = matmul(x, params["wq"]).reshape(b, cw, spec.n_heads, hd)
        if spec.qk_norm:
            q = rms_norm(q, params["q_norm_scale"])
        ke = _expand_kv(cache_k.to(x.dtype), spec.n_heads)
        ve = _expand_kv(cache_v.to(x.dtype), spec.n_heads)
        bias = torch.zeros((1, 1, 1, ke.shape[1]), dtype=torch.float32,
                           device=dev)
        o = _sdpa(q, ke, ve, bias, spec.softcap)
        return (matmul(o.reshape(b, cw, spec.q_dim), params["wo"]), cache_k,
                cache_v)

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


# --------------------------------------------------------------------------
# MoE (GShard capacity dispatch, dense one-hot einsums)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int              # per-expert hidden
    n_experts: int
    top_k: int
    kind: str = "swiglu"
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    group_size: int = 2048  # dispatch group: keeps the one-hot O(G*E*C)


def moe_init(gen: torch.Generator, spec: MoESpec, device, lead=()):
    """Router (..., d, E) and expert stacks (..., E, d, f) / (..., E, f,
    d), at JAX's init scales; ``lead`` prepends the layer repeats."""
    lead = tuple(lead)
    e, d, f = spec.n_experts, spec.d_model, spec.d_ff
    p = {"router": dense_init(gen, lead + (d, e), device, scale=0.02),
         "w_up": dense_init(gen, lead + (e, d, f), device),
         "w_down": dense_init(gen, lead + (e, f, d), device)}
    if spec.kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, lead + (e, d, f), device)
    return p


def _moe_expert_matmul(xin: torch.Tensor, w) -> torch.Tensor:
    """Per-expert matmul ``xin (g, e, c, d) @ w (e, d, f) -> (g, e, c, f)``:
    one einsum for dense experts (cast to the compute dtype, as JAX does),
    the 3-D QTensor matmul over the experts' (g*c, d) slabs for QTensor
    experts (stored (e, f, d))."""
    if isinstance(w, QTensor):
        g, e, c, d = xin.shape
        xe = xin.permute(1, 0, 2, 3).reshape(e, g * c, d)
        out = _qt_matmul(xe, w).to(xin.dtype)
        return out.reshape(e, g, c, -1).permute(1, 0, 2, 3)
    return torch.einsum("gecd,edf->gecf", xin, w.to(xin.dtype))


def moe_route(router: torch.Tensor, spec: MoESpec, xt: torch.Tensor,
              b: int, l: int, token_mask: Optional[torch.Tensor] = None):
    """Routing of grouped tokens xt (g, t, d): fp32 router probabilities
    (g, t, E), the top-k experts ``topi`` (g, t, k) with their normalized
    weights ``topv``, each choice's queue position ``pos`` and whether it
    fits the group's capacity ``keep``, the one-hot choices ``onehot``
    (g, t, k, E) int32 (zero for rows that ``token_mask`` (b,) drops) and
    the capacity.  Ties of the top-k go to the lower expert index, as
    ``jax.lax.top_k`` takes them (a stable descending sort)."""
    n_g, g_sz = xt.shape[0], xt.shape[1]
    e, k = spec.n_experts, spec.top_k
    logits = (xt @ router.to(xt.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                        # (g, t, e)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = srt.values[..., :k], srt.indices[..., :k]       # (g, t, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    cap = int(np.ceil(g_sz * spec.top_k / e * spec.capacity_factor))
    cap = max(cap, spec.top_k)

    onehot = F.one_hot(topi, e).to(torch.int32)                  # (g, t, k, e)
    if token_mask is not None:
        tm = torch.broadcast_to(token_mask[:, None], (b, l)).reshape(n_g,
                                                                     g_sz)
        onehot = onehot * tm[..., None, None].to(onehot.dtype)
    # position of each (token, choice) in its expert's queue, token-major
    # over the group: an exact int32 cumsum
    pos_in_e = torch.cumsum(onehot.reshape(n_g, g_sz * k, e), dim=1,
                            dtype=torch.int32).reshape(n_g, g_sz, k, e) \
        - onehot
    pos = torch.sum(pos_in_e * onehot, dim=-1, dtype=torch.int32)  # (g, t, k)
    keep = pos < cap
    pos = torch.where(keep, pos, 0).to(torch.int32)
    return dict(probs=probs, topv=topv, topi=topi, onehot=onehot, pos=pos,
                keep=keep, cap=cap)


def moe_groups(spec: MoESpec, b: int, l: int) -> int:
    """Tokens per dispatch group: ``group_size`` when it divides the b*l
    tokens, else one group per sequence (or one group of all of them)."""
    t = b * l
    g_sz = min(spec.group_size, t)
    if t % g_sz != 0:
        g_sz = l if t % l == 0 else t
    return g_sz


def moe_apply(params, spec: MoESpec, x: torch.Tensor,
              token_mask: Optional[torch.Tensor] = None):
    """Capacity-based top-k dispatch (GShard) of x (b, l, d) -> (b, l, d)
    in groups of ``moe_groups`` tokens, capacity enforced per group, with
    dense one-hot dispatch and combine einsums in the compute dtype (0/1
    one-hots are exact in bf16).  ``token_mask`` (b,) drops rows from the
    dispatch entirely: they take no expert capacity and get zero output.
    Returns (out, aux) with the GShard load-balance terms."""
    b, l, d = x.shape
    e = spec.n_experts
    g_sz = moe_groups(spec, b, l)
    n_g = (b * l) // g_sz

    xt = x.reshape(n_g, g_sz, d)
    r = moe_route(params["router"], spec, xt, b, l, token_mask)
    probs, topv, topi = r["probs"], r["topv"], r["topi"]

    kept = (r["onehot"] * r["keep"][..., None]).to(x.dtype)      # (g, t, k, e)
    cap_onehot = F.one_hot(r["pos"].long(), r["cap"]).to(x.dtype)  # (g,t,k,c)
    dispatch = torch.einsum("gtke,gtkc->gtec", kept, cap_onehot)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", kept, cap_onehot,
                           topv.to(x.dtype))

    xin = torch.einsum("gtec,gtd->gecd", dispatch, xt)
    up = _moe_expert_matmul(xin, params["w_up"])
    if spec.kind in ("swiglu", "geglu"):
        gate = _moe_expert_matmul(xin, params["w_gate"])
        act = (F.silu(gate) if spec.kind == "swiglu"
               else F.gelu(gate, approximate="tanh"))
        h = act * up
    else:
        h = F.gelu(up, approximate="tanh")
    eout = _moe_expert_matmul(h, params["w_down"])
    out = torch.einsum("gtec,gecd->gtd", combine, eout)

    # GShard aux loss: mean fraction of tokens per expert * mean router prob
    me = torch.mean(F.one_hot(topi[..., 0], e).to(torch.float32),
                    dim=(0, 1))
    ce_ = torch.mean(probs, dim=(0, 1))
    aux = {"load_balance_loss": e * torch.sum(me * ce_),
           "router_entropy": -torch.mean(torch.sum(
               probs * torch.log(probs + 1e-9), -1))}
    return out.reshape(b, l, d), aux
