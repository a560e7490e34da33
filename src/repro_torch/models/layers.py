"""Transformer layers of the port (``repro.models.layers``): norms, RoPE,
GQA attention (full sequence and one-token decode, sliding window, logit
softcap, QK-norm), the quantized KV cache and the MLP.

Layers are functional, as in the JAX package: ``*_init`` returns a dict of
tensors, ``*_apply`` takes (params, inputs).  The compute dtype is the
dtype of the incoming activations.  Plain attention is torch einsum and
softmax (the JAX code there is jnp, not Pallas); every weight matmul goes
through ``matmul`` (the ``wqt_matmul`` kernel for QTensor weights on the
card) and quantized-cache decode through the ``decode_attn`` kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.qtensor import QTensor
from ..core.qtensor import _pack_last as _pack_int4   # int8 -> packed nibbles
from ..core.qtensor import matmul as _qt_matmul
from ..kernels.decode_attn import decode_attn, ring_validity
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
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
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
        bits = 4 if cache["codes"].dtype == torch.uint8 else 8
        q = kv_quantize(new[:, None], bits)          # (b, 1, kvh, *)
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
        bits = 4 if cache_k["codes"].dtype == torch.uint8 else 8
        o = decode_attn(q4, cache_k["codes"], cache_k["scale"],
                        cache_v["codes"], cache_v["scale"], pos,
                        bits=bits, window=spec.window, softcap=spec.softcap)
    else:
        logits = torch.einsum("bgrd,blgd->bgrl", q4,
                              cache_k.to(q4.dtype)).to(torch.float32)
        logits = logits / math.sqrt(hd)
        if spec.softcap is not None:
            logits = spec.softcap * torch.tanh(logits / spec.softcap)
        valid = ring_validity(pos, cache_len, spec.window)
        bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
        probs = torch.softmax(logits + bias, dim=-1)
        o = torch.einsum("bgrl,blgd->bgrd", probs.to(x.dtype),
                         cache_v.to(x.dtype))
    o = o.reshape(b, 1, spec.q_dim)
    return matmul(o, params["wo"]), cache_k, cache_v


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
