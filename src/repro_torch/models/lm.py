"""Language model of the port (``repro.models.lm``), attention-family
patterns only: ``attn`` (global) and ``local`` (sliding window) blocks,
each followed by a dense MLP.

A model is a unit ``pattern`` of block kinds tiled ``n_repeats`` times.
Parameters keep the JAX tree's layout: unit leaves are stacked along a
leading repeats axis under ``params["stage"]``, keyed ``b{i}_{kind}``.
Where JAX scans over the repeats, the port loops in Python over per-layer
views of the stacked leaves (``layer_params``).

Entry points: ``lm_init`` (random weights from a seed, on a device),
``lm_prefill`` (forward that fills the decode cache) and ``lm_decode``
(one token against the cache).  MoE, SSM (mamba/rwkv), cross-attention,
multi-codebook heads, activation quantization and the shared zamba block
are not in this slice of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.qtensor import QTensor
from ..core.policy import tree_map_with_path
from . import layers
from .layers import (AttnSpec, MLPSpec, attn_apply, attn_decode, attn_init,
                     dense_init, matmul, mlp_apply, mlp_init, rms_norm)

ATTN_KINDS = ("attn", "local", "xattn")
PORTED_KINDS = ("attn", "local")


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ('float32', ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...] = ("attn",)
    head_dim: Optional[int] = None
    mlp_kind: str = "swiglu"
    ffn: str = "dense"                    # dense | moe
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None   # gemma3 local layers
    window: Optional[int] = None
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    qk_norm: bool = False
    use_post_norm: bool = False           # gemma2/3 sandwich norms
    emb_scale: bool = False               # multiply embeddings by sqrt(d)
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    shared_attn_every: int = 0
    # RWKV
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 16
    # Vision / audio stubs
    n_image_tokens: int = 0
    d_vision: int = 0
    n_codebooks: int = 1
    # activation fake-quantization (not in this slice)
    act_fmt: Optional[str] = None
    # misc
    max_seq: int = 8192
    remat: bool = True                    # no effect in the port (no autodiff yet)
    sub_quadratic: bool = False
    dtype: Any = torch.bfloat16           # torch dtype or its name

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"unit length {len(self.pattern)}")
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_spec(self, kind: str) -> AttnSpec:
        local = kind == "local"
        theta = (self.rope_theta_local if (local and self.rope_theta_local)
                 else self.rope_theta)
        return AttnSpec(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            rope_theta=theta, window=self.window if local else None,
            softcap=self.softcap_attn, qk_norm=self.qk_norm,
            is_cross=(kind == "xattn"))

    def mlp_spec(self) -> MLPSpec:
        return MLPSpec(d_model=self.d_model, d_ff=self.d_ff, kind=self.mlp_kind)


def check_ported(cfg: LMConfig) -> None:
    """Raise NotImplementedError for features outside this slice."""
    bad = [k for k in cfg.pattern if k not in PORTED_KINDS]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported yet: ROADMAP "
            f"Queue 1 item 7 (mamba/rwkv in models/ssm.py, xattn)")
    unported = {"ffn": cfg.ffn != "dense",
                "n_codebooks": cfg.n_codebooks > 1,
                "shared_attn_every": bool(cfg.shared_attn_every),
                "n_image_tokens": bool(cfg.n_image_tokens),
                "act_fmt": cfg.act_fmt is not None}
    for field, bad in unported.items():
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not ported "
                f"yet: ROADMAP Queue 1 item 7")


# ==========================================================================
# Parameter init
# ==========================================================================

def _block_init(gen, cfg: LMConfig, kind: str, device, r: int):
    lead = (r,)

    def ones():
        return torch.ones(lead + (cfg.d_model,), device=device)

    p: Dict[str, Any] = {"pre_norm_scale": ones(),
                         "attn": attn_init(gen, cfg.attn_spec(kind), device,
                                           lead),
                         "ffn_norm_scale": ones(),
                         "mlp": mlp_init(gen, cfg.mlp_spec(), device, lead)}
    if cfg.use_post_norm:
        p["post_norm_scale"] = ones()
        p["ffn_post_norm_scale"] = ones()
    return p


def lm_init(cfg: LMConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random fp32 weights with the JAX tree's shapes and init scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (default ``"cuda"``).  The numbers differ from ``jax.random``'s; tests
    that compare with JAX move JAX's weights over with ``bridge``."""
    check_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                             device=device) * 0.02}
    r = cfg.n_repeats
    params["stage"] = {f"b{i}_{kind}": _block_init(gen, cfg, kind, device, r)
                       for i, kind in enumerate(cfg.pattern)}
    params["final_norm_scale"] = torch.ones((cfg.d_model,), device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), device)
    return params


def layer_params(stage, r: int):
    """Per-layer view of the stacked unit parameters (index r of every
    leaf; a stacked QTensor gives its 2-D ``layer(r)``)."""
    return tree_map_with_path(
        lambda p, x: x.layer(r) if isinstance(x, QTensor) else x[r], stage)


def _embed(params, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    x = emb.take(tokens) if isinstance(emb, QTensor) else emb[tokens]
    x = x.to(cfg.dtype)
    if cfg.emb_scale:
        # JAX multiplies by a NumPy float32 scalar, which promotes bf16 to
        # fp32; keep that promotion
        x = x.to(torch.promote_types(x.dtype, torch.float32)) * float(
            np.sqrt(cfg.d_model).astype(np.float32))
    return x


def _head(params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm_scale"])
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if isinstance(w, QTensor):
        logits = matmul(x, w)           # out-major (vocab, d) either way
    else:
        logits = x @ (w.T if cfg.tie_embeddings else w).to(x.dtype)
    logits = logits.to(torch.float32)
    if cfg.softcap_final is not None:
        logits = cfg.softcap_final * torch.tanh(logits / cfg.softcap_final)
    return logits


def _apply_ffn(p, cfg: LMConfig, x: torch.Tensor, o: torch.Tensor):
    """Residual add of the attention output ``o``, then the MLP sub-block."""
    if cfg.use_post_norm:
        o = rms_norm(o, p["post_norm_scale"])
    x = x + o
    h = mlp_apply(p["mlp"], cfg.mlp_spec(), rms_norm(x, p["ffn_norm_scale"]))
    if cfg.use_post_norm:
        h = rms_norm(h, p["ffn_post_norm_scale"])
    return x + h


# ==========================================================================
# Decode cache
# ==========================================================================

def _kv_zeros(shape, dtype, kv_quant, device):
    bits = layers.kv_bits(kv_quant)
    if bits:
        cshape = shape[:-1] + (shape[-1] // 2,) if bits == 4 else shape
        cdtype = torch.uint8 if bits == 4 else torch.int8
        return {"codes": torch.zeros(cshape, dtype=cdtype, device=device),
                "scale": torch.ones(shape[:-1] + (1,), device=device)}
    return torch.zeros(shape, dtype=dtype, device=device)


def init_cache(cfg: LMConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, kv_quant=False, device=None):
    """Cache tree stacked over repeats: ``{"unit": {name: {"k", "v"}}}``;
    global layers hold ``cache_len`` slots, local layers a ring of
    ``window``; ``kv_quant`` stores int8 / int4 codes + fp32 scales."""
    check_ported(cfg)
    device = resolve_device(device)
    r = cfg.n_repeats
    unit = {}
    for i, kind in enumerate(cfg.pattern):
        wl = min(cfg.window or cache_len, cache_len) if kind == "local" \
            else cache_len
        shape = (r, batch, wl, cfg.n_kv_heads, cfg.hd)
        unit[f"b{i}_{kind}"] = {
            "k": _kv_zeros(shape, torch_dtype(dtype), kv_quant, device),
            "v": _kv_zeros(shape, torch_dtype(dtype), kv_quant, device)}
    return {"unit": unit}


def _kv_to_cache(k, v, kind: str, cfg: LMConfig, cache_len: int,
                 kv_quant=False, pads: Optional[torch.Tensor] = None):
    """Pack full-sequence (k, v) (b, l, kvh, hd) into one layer's decode
    cache.  With ``pads`` (b,) (left-pad widths of ragged prompts) row i's
    column c holds position c - pads[i] and lands at ring slot
    ``pos % ring_len``; pad columns and positions older than the ring go
    to a dump row that is sliced off."""
    b, l = k.shape[0], k.shape[1]
    bits = layers.kv_bits(kv_quant)
    dev = k.device

    def store(x):
        return layers.kv_quantize(x, bits) if bits else x.to(cfg.dtype)

    if pads is not None:
        ring_len = (min(cfg.window or cache_len, cache_len)
                    if kind == "local" else cache_len)
        positions = torch.arange(l, device=dev)[None, :] - pads[:, None]
        length = l - pads
        keep = (positions >= 0) & (positions >= length[:, None] - ring_len)
        slots = torch.where(keep, torch.remainder(positions, ring_len),
                            ring_len)
        bidx = torch.arange(b, device=dev)[:, None]

        def one(vals, fill):
            buf = torch.full((b, ring_len + 1) + tuple(vals.shape[2:]), fill,
                             dtype=vals.dtype, device=dev)
            buf[bidx, slots] = vals
            return buf[:, :ring_len]

        def scatter(t):
            s = store(t)
            if bits:
                return {"codes": one(s["codes"], 0),
                        "scale": one(s["scale"], 1.0)}
            return one(s, 0)

        return {"k": scatter(k), "v": scatter(v)}

    if kind == "local":
        wl = min(cfg.window or cache_len, cache_len)
        take = min(wl, l)
        slots = torch.remainder(torch.arange(l - take, l, device=dev), wl)

        def ring(t):
            vals = store(t[:, l - take:])
            if bits:
                codes = torch.zeros((b, wl) + tuple(vals["codes"].shape[2:]),
                                    dtype=vals["codes"].dtype, device=dev)
                scale = torch.ones((b, wl) + tuple(t.shape[2:-1]) + (1,),
                                   device=dev)
                codes[:, slots] = vals["codes"]
                scale[:, slots] = vals["scale"]
                return {"codes": codes, "scale": scale}
            out = torch.zeros((b, wl) + tuple(t.shape[2:]), dtype=cfg.dtype,
                              device=dev)
            out[:, slots] = vals
            return out

        return {"k": ring(k), "v": ring(v)}

    pad = cache_len - l

    def pad_one(a, fill):
        return torch.nn.functional.pad(
            a, (0, 0) * (a.ndim - 2) + (0, pad), value=fill)

    def pad_store(t):
        s = store(t)
        if bits:
            return {"codes": pad_one(s["codes"], 0),
                    "scale": pad_one(s["scale"], 1.0)}
        return pad_one(s, 0)

    return {"k": pad_store(k), "v": pad_store(v)}


def _stack_caches(per_layer):
    """List (over repeats) of one-layer caches -> the stacked cache."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack_caches([c[k] for c in per_layer]) for k in first}
    return torch.stack(per_layer)


# ==========================================================================
# Prefill (fills cache) and decode (one token)
# ==========================================================================

def lm_prefill(params, cfg: LMConfig, tokens: torch.Tensor,
               cache_len: Optional[int] = None, kv_quant=False,
               prompt_lens: Optional[torch.Tensor] = None):
    """Forward + cache fill in one pass.  Returns (last logits (b, 1, V)
    fp32, cache).

    ``prompt_lens`` (b,): real prompt length per row of a left-padded
    ragged batch; rows get per-row positions ``col - pad``, pad keys are
    masked out of every score, and the KV cache is written at
    position-indexed ring slots, so a row's generation does not depend on
    its batchmates."""
    check_ported(cfg)
    b, l = tokens.shape[0], tokens.shape[1]
    cache_len = cache_len or l
    dev = tokens.device
    x = _embed(params, cfg, tokens)
    pads = None
    if prompt_lens is None:
        positions = torch.arange(l, device=dev)
    else:
        pads = (l - prompt_lens).to(torch.int64)
        positions = torch.arange(l, device=dev)[None, :] - pads[:, None]

    per_layer = {f"b{i}_{kind}": [] for i, kind in enumerate(cfg.pattern)}
    for r in range(cfg.n_repeats):
        unit_p = layer_params(params["stage"], r)
        for i, kind in enumerate(cfg.pattern):
            name = f"b{i}_{kind}"
            p = unit_p[name]
            h = rms_norm(x, p["pre_norm_scale"])
            o, (k, v) = attn_apply(p["attn"], cfg.attn_spec(kind), h,
                                   positions, return_kv=True)
            per_layer[name].append(_kv_to_cache(k, v, kind, cfg, cache_len,
                                                kv_quant, pads=pads))
            x = _apply_ffn(p, cfg, x, o)
    cache = {"unit": {name: _stack_caches(c) for name, c in per_layer.items()}}
    return _head(params, cfg, x[:, -1:]), cache


def _layer_cache(leaf, r: int):
    if isinstance(leaf, dict):
        return {k: v[r] for k, v in leaf.items()}
    return leaf[r]


def lm_decode(params, cfg: LMConfig, cache, tokens: torch.Tensor,
              pos: torch.Tensor, block_tables: Optional[torch.Tensor] = None):
    """One-token decode.  tokens (b, 1), pos (b,) current positions.

    The cache is updated IN PLACE: each layer writes its new K/V into its
    slice of the stacked cache tensors (JAX carries the cache through a
    scan with a dynamic update instead).  Returns (logits (b, 1, V) fp32,
    cache) with ``cache`` the same object that was passed in.  Paged KV
    (``block_tables``) is not in this slice."""
    check_ported(cfg)
    if block_tables is not None:
        raise NotImplementedError(
            "paged KV decode (block_tables) is not ported yet: ROADMAP "
            "Queue 1 item 9 (attn_decode_paged) and Queue 2 #4")
    x = _embed(params, cfg, tokens)
    for r in range(cfg.n_repeats):
        unit_p = layer_params(params["stage"], r)
        for i, kind in enumerate(cfg.pattern):
            name = f"b{i}_{kind}"
            p = unit_p[name]
            c = cache["unit"][name]
            h = rms_norm(x, p["pre_norm_scale"])
            o, _, _ = attn_decode(p["attn"], cfg.attn_spec(kind), h, pos,
                                  _layer_cache(c["k"], r),
                                  _layer_cache(c["v"], r))
            x = _apply_ffn(p, cfg, x, o)
    return _head(params, cfg, x), cache
