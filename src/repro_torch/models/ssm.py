"""State-space and linear-recurrence blocks of the port
(``repro.models.ssm``): Mamba2 (SSD) and RWKV6 (Finch).

Each block has three faces, as in JAX:

* ``*_apply`` / ``rwkv6_time_mix``: the full-sequence forward through the
  chunked parallel form (SSD for Mamba2, GLA-style chunks for RWKV6);
* ``_ssd_scan`` / ``_wkv_scan``: the exact sequential recurrence
  (``exact=True``, the oracle of the tests);
* ``*_decode``: one token against a recurrent state.

All of it is plain PyTorch: the JAX code is einsums and ``lax.scan``s with
no Pallas kernel behind them.  The inter-chunk scans become Python loops
over chunks.  The recurrences run in fp32; RWKV6's decays are clamped to
``log w >= logw_min`` so that the chunked factorization ``exp(-cumsum log
w)`` stays inside fp32 (e^80 at chunk 16), and nothing here may turn on
TF32.  Every projection is ``x @ W`` on the dense leaf (the serving packer
keeps SSM leaves dense, cast through ``quant``).

One difference by design: ``_ssd_chunked`` takes the exponential of the
intra-chunk decays with the upper triangle already at ``-inf``, where JAX
takes ``exp`` of every entry and masks afterwards.  The forward is the
same bit for bit (``exp(-inf)`` is 0); the gradient stays finite where
JAX's multiplies 0 by an overflowed ``exp`` (ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .layers import dense_init, init_leaf, rms_norm


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))``, NaN kept (``F.softplus`` rounds otherwise and
    turns linear above a threshold)."""
    out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def _carry(states: torch.Tensor, decay: torch.Tensor):
    """The inter-chunk recurrence ``S_c = decay_c * S_{c-1} + states_c``
    from S = 0, over chunk axis 1 (JAX's ``lax.scan``): returns the state
    before each chunk, stacked on axis 1, and the final state.  ``decay``
    is broadcastable against one chunk's state."""
    S = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(states.shape[1]):
        prev.append(S)
        S = S * decay[:, c] + states[:, c]
    return torch.stack(prev, dim=1), S


# ==========================================================================
# Mamba2 (SSD)
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    d_state: int = 64          # n
    head_dim: int = 64         # p
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1          # B/C groups (g)
    chunk: int = 64

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def n_heads(self):
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba2_init(gen: torch.Generator, spec: Mamba2Spec, device, lead=()):
    """JAX's shapes and init scales, with ``lead`` (repeats) axes in front
    of every leaf; the draws are ``gen``'s."""
    lead = tuple(lead)
    h = spec.n_heads
    d_in_proj = 2 * spec.d_inner + 2 * spec.n_groups * spec.d_state + h
    u = torch.rand(lead + (h,), generator=gen, device=device)
    dt = torch.exp(u * float(np.log(0.1) - np.log(0.001))
                   + float(np.log(0.001)))
    a = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, lead + (spec.d_model, d_in_proj), device),
        "conv_w": init_leaf(torch.randn(lead + (spec.d_conv, spec.conv_dim),
                                        generator=gen, device=device)
                            / float(np.sqrt(spec.d_conv))),
        "conv_b": init_leaf(torch.zeros(lead + (spec.conv_dim,),
                                        device=device)),
        "a_log": init_leaf(torch.log(a).expand(lead + (h,)).clone()),
        # softplus^-1(dt)
        "dt_bias": init_leaf(torch.log(torch.expm1(dt))),
        "d_skip": init_leaf(torch.ones(lead + (h,), device=device)),
        "out_norm_scale": init_leaf(torch.ones(lead + (spec.d_inner,),
                                               device=device)),
        "out_proj": dense_init(gen, lead + (spec.d_inner, spec.d_model),
                               device),
    }


def _split_in_proj(spec: Mamba2Spec, zxbcdt: torch.Tensor):
    """(z, xBC, dt) of the input projection (``jnp.split`` at indices)."""
    d_in, cd = spec.d_inner, spec.conv_dim
    return zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + cd], \
        zxbcdt[..., d_in + cd:]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d over (b, l, c): JAX's unrolled sum of k
    shifted products (no ``F.conv1d``, whose cuDNN path may take TF32)."""
    k, l = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + l, :] * w[i]
    return out + b


def _intra_decay(A_cum: torch.Tensor) -> torch.Tensor:
    """L_ij = exp(A_cum_i - A_cum_j) for j <= i, else 0, from the
    inclusive cumsum A_cum (b, nc, q, h): (b, nc, i, j, h).  Above the
    diagonal the exponent is positive and may overflow, so it is -inf
    before the exp (0 after it), never an inf masked afterwards."""
    q = A_cum.shape[2]
    seg = A_cum[:, :, :, None, :] - A_cum[:, :, None, :, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                 device=A_cum.device))
    return torch.exp(seg.masked_fill(~mask[None, None, :, :, None],
                                     float("-inf")))


def _ssd_chunked(x, dt, a_neg, B, C, chunk: int):
    """SSD chunked scan.  x (b, l, h, p); dt (b, l, h); a_neg (h,)
    negative; B, C (b, l, g, n).  Returns y (b, l, h, p) fp32 and the
    final state (b, h, p, n) fp32."""
    b, l, h, p = x.shape
    n = B.shape[3]
    q = min(chunk, l)
    nc = (l + q - 1) // q
    pad = nc * q - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))

    # jnp.repeat over the groups: each group's B, C for rep heads in a row
    rep = h // B.shape[2]
    f32 = torch.float32
    Bc = B.repeat_interleave(rep, 2).to(f32).reshape(b, nc, q, h, n)
    Cc = C.repeat_interleave(rep, 2).to(f32).reshape(b, nc, q, h, n)
    xc = x.to(f32).reshape(b, nc, q, h, p)
    dtc = dt.to(f32).reshape(b, nc, q, h)

    dA = dtc * a_neg.to(f32)                              # (b, nc, q, h) <= 0
    A_cum = torch.cumsum(dA, dim=2)                       # inclusive
    Lmat = _intra_decay(A_cum)
    xdt = xc * dtc[..., None]                             # (b,nc,q,h,p)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
    y_diag = torch.einsum("bcijh,bcijh,bcjhp->bcihp", scores, Lmat, xdt)

    # chunk states: sum_j exp(A_cum_last - A_cum_j) * B_j (x_j dt_j)
    decay_states = torch.exp(A_cum[:, :, -1:, :] - A_cum)     # <= 1
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", Bc, decay_states, xdt)
    chunk_decay = torch.exp(A_cum[:, :, -1, :])               # (b, nc, h)
    S_prev, S_final = _carry(states, chunk_decay[..., None, None])

    # the carried-in state's contribution: C_i exp(A_cum_i) S_prev
    y_off = torch.einsum("bcihn,bcih,bchpn->bcihp", Cc, torch.exp(A_cum),
                         S_prev)
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :l]
    return y, S_final


def _ssd_scan(x, dt, a_neg, B, C):
    """The exact sequential SSD recurrence (the oracle), one step a
    token."""
    b, l, h, p = x.shape
    n = B.shape[3]
    rep = h // B.shape[2]
    f32 = torch.float32
    Bh = B.repeat_interleave(rep, 2).to(f32)
    Ch = C.repeat_interleave(rep, 2).to(f32)
    xf = (x * dt[..., None]).to(f32)
    dA = (dt * a_neg).to(f32)
    S = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(l):
        S = S * torch.exp(dA[:, t])[..., None, None] + (
            xf[:, t][..., :, None] * Bh[:, t][..., None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], S))
    return torch.stack(ys, dim=1), S


def _bc_heads(spec: Mamba2Spec, xbc: torch.Tensor):
    """(x, B, C) of the convolved xBC, split at JAX's indices."""
    gn = spec.n_groups * spec.d_state
    return (xbc[..., :spec.d_inner], xbc[..., spec.d_inner:spec.d_inner + gn],
            xbc[..., spec.d_inner + gn:])


def mamba2_apply(params, spec: Mamba2Spec, x: torch.Tensor,
                 exact: bool = False, return_state: bool = False):
    """Full-sequence Mamba2 block.  x (b, l, d_model).  With
    ``return_state`` also returns the decode state: the conv tail (the
    last d_conv - 1 raw xBC rows, in x's dtype) and the final SSM state
    (fp32), so prefill fills the cache in the same pass."""
    b, l, _ = x.shape
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xbc_raw, dt_raw = _split_in_proj(spec, zxbcdt)
    xbc = F.silu(_causal_conv(xbc_raw, params["conv_w"].to(x.dtype),
                              params["conv_b"].to(x.dtype)))
    xs, B, C = _bc_heads(spec, xbc)
    xh = xs.reshape(b, l, spec.n_heads, spec.head_dim)
    B = B.reshape(b, l, spec.n_groups, spec.d_state)
    C = C.reshape(b, l, spec.n_groups, spec.d_state)
    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    a_neg = -torch.exp(params["a_log"])

    if exact:
        y, S = _ssd_scan(xh, dt, a_neg, B, C)
    else:
        y, S = _ssd_chunked(xh, dt, a_neg, B, C, spec.chunk)
    y = y + xh.to(torch.float32) * params["d_skip"][:, None]
    y = y.reshape(b, l, spec.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm_scale"])
    out = y @ params["out_proj"].to(x.dtype)
    if not return_state:
        return out
    k1 = spec.d_conv - 1
    tail = F.pad(xbc_raw, (0, 0, max(k1 - l, 0), 0))[:, -k1:]
    return out, {"conv": tail, "ssm": S}


def mamba2_init_state(spec: Mamba2Spec, batch: int, dtype=torch.float32,
                      device=None) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, spec.d_conv - 1, spec.conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, spec.n_heads, spec.head_dim,
                            spec.d_state), device=device),
    }


def mamba2_decode(params, spec: Mamba2Spec, x: torch.Tensor, state):
    """One token.  x (b, 1, d_model); ``state`` {"conv", "ssm"}.  Returns
    (out (b, 1, d_model), new state); the new conv state is a slice of a
    new tensor, never a view of ``state``'s."""
    b = x.shape[0]
    zxbcdt = x[:, 0] @ params["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_in_proj(spec, zxbcdt)
    conv_in = torch.cat([state["conv"],
                         xbc[:, None, :].to(state["conv"].dtype)], dim=1)
    cdt = torch.promote_types(conv_in.dtype, x.dtype)
    w = params["conv_w"].to(x.dtype)
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_in.to(cdt), w.to(cdt))
                 + params["conv_b"].to(x.dtype))
    new_conv = conv_in[:, 1:]

    xs, B, C = _bc_heads(spec, xbc)
    f32 = torch.float32
    xh = xs.reshape(b, spec.n_heads, spec.head_dim).to(f32)
    rep = spec.n_heads // spec.n_groups
    Bh = B.reshape(b, spec.n_groups, spec.d_state).to(f32).repeat_interleave(
        rep, 1)
    Ch = C.reshape(b, spec.n_groups, spec.d_state).to(f32).repeat_interleave(
        rep, 1)
    dt = softplus(dt_raw.to(f32) + params["dt_bias"])
    a_neg = -torch.exp(params["a_log"])

    S = state["ssm"] * torch.exp(dt * a_neg)[..., None, None] + (
        (xh * dt[..., None])[..., :, None] * Bh[..., None, :])
    y = torch.einsum("bhn,bhpn->bhp", Ch, S) + xh * params["d_skip"][:, None]
    y = y.reshape(b, spec.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm_scale"])
    out = (y @ params["out_proj"].to(x.dtype))[:, None, :]
    return out, {"conv": new_conv, "ssm": S}


# ==========================================================================
# RWKV6 (Finch)
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class RWKV6Spec:
    d_model: int
    head_dim: int = 64
    lora_rank: int = 32
    decay_lora_rank: int = 64
    chunk: int = 16
    logw_min: float = -5.0     # decay clamp; see the module docstring

    @property
    def n_heads(self):
        return self.d_model // self.head_dim


def rwkv6_time_mix_init(gen: torch.Generator, spec: RWKV6Spec, device,
                        lead=()):
    lead = tuple(lead)
    d, r = spec.d_model, spec.lora_rank

    def normal(shape, scale):
        return torch.randn(lead + shape, generator=gen, device=device) * scale

    return {
        # data-dependent token shift (ddlerp): base coefficients + LoRA
        "mu_base": init_leaf(torch.rand(lead + (5, d), generator=gen,
                                        device=device)),
        "mu_lora_a": init_leaf(normal((d, 5 * r), 0.01)),
        "mu_lora_b": init_leaf(normal((5, r, d), 0.01)),
        "w_r": dense_init(gen, lead + (d, d), device),
        "w_k": dense_init(gen, lead + (d, d), device),
        "w_v": dense_init(gen, lead + (d, d), device),
        "w_g": dense_init(gen, lead + (d, d), device),
        "w_o": dense_init(gen, lead + (d, d), device),
        # data-dependent decay
        "decay_base": init_leaf(normal((d,), 1.0) - 4.0),
        "decay_lora_a": init_leaf(normal((d, spec.decay_lora_rank), 0.01)),
        "decay_lora_b": init_leaf(normal((spec.decay_lora_rank, d), 0.01)),
        "bonus": init_leaf(normal((spec.n_heads, spec.head_dim), 0.1)),
        "ln_scale": init_leaf(torch.ones(lead + (d,), device=device)),
    }


def _ddlerp(params, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Data-dependent lerp: the 5 mixed inputs (r, k, v, w, g),
    (..., 5, d)."""
    r5 = params["mu_lora_a"].shape[1] // 5
    delta = xx - x
    base = params["mu_base"].to(x.dtype)                      # (5, d)
    lora_in = torch.tanh((x + delta * base[4])
                         @ params["mu_lora_a"].to(x.dtype))
    lora_in = lora_in.reshape(x.shape[:-1] + (5, r5))
    adj = torch.einsum("...fr,frd->...fd", lora_in,
                       params["mu_lora_b"].to(x.dtype))
    mu = base + adj
    return x[..., None, :] + delta[..., None, :] * mu


def _rwkv_projections(params, spec: RWKV6Spec, x: torch.Tensor,
                      xx: torch.Tensor):
    """r, k, v, g in x's dtype and the clamped log-decay (fp32)."""
    mixed = _ddlerp(params, x, xx)
    xr, xk, xv, xw, xg = (mixed[..., i, :] for i in range(5))
    r = xr @ params["w_r"].to(x.dtype)
    k = xk @ params["w_k"].to(x.dtype)
    v = xv @ params["w_v"].to(x.dtype)
    g = F.silu(xg @ params["w_g"].to(x.dtype))
    logw_raw = params["decay_base"].to(torch.float32) + (
        torch.tanh(xw.to(torch.float32) @ params["decay_lora_a"])
        @ params["decay_lora_b"])
    logw = torch.clamp(-torch.exp(logw_raw), spec.logw_min, -1e-4)
    return r, k, v, g, logw


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (h, x.shape[-1] // h))


def _wkv_scan(r, k, v, logw, bonus):
    """Exact recurrence: S_t = diag(w_t) S_{t-1} + k_t v_t^T;
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T).  Shapes (b, l, h, n)."""
    b, l, h, n = r.shape
    S = torch.zeros((b, h, n, v.shape[-1]), dtype=torch.float32,
                    device=r.device)
    ys = []
    for t in range(l):
        kv = k[:, t][..., :, None] * v[:, t][..., None, :]     # (b,h,n,m)
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t],
                               S + bonus[..., None] * kv))
        S = torch.exp(logw[:, t])[..., None] * S + kv
    return torch.stack(ys, dim=1), S


def _wkv_chunked(r, k, v, logw, bonus, chunk: int):
    """The chunked GLA-style parallel form.  All inputs (b, l, h, n) fp32;
    fp32 end to end (``k * exp(-Lc)`` reaches e^80 on purpose)."""
    b, l, h, n = r.shape
    m = v.shape[-1]
    q = min(chunk, l)
    nc = (l + q - 1) // q
    pad = nc * q - l
    if pad:
        z = (0, 0, 0, 0, 0, pad)
        r, k, v = F.pad(r, z), F.pad(k, z), F.pad(v, z)
        logw = F.pad(logw, z)      # a 0 log-decay (w = 1) is harmless
    rc = r.reshape(b, nc, q, h, n)
    kc = k.reshape(b, nc, q, h, n)
    vc = v.reshape(b, nc, q, h, m)
    wc = logw.reshape(b, nc, q, h, n)

    Lc = torch.cumsum(wc, dim=2)                      # inclusive; <= 0
    Lc_prev = Lc - wc                                 # exclusive
    q_star = rc * torch.exp(Lc_prev)                  # exponent <= 0
    k_star = kc * torch.exp(-Lc)                      # bounded by the clamp
    scores = torch.einsum("bcihn,bcjhn->bchij", q_star, k_star)
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=r.device),
                      diagonal=-1)                    # strictly causal
    scores = torch.where(mask, scores, 0.0)
    y_intra = torch.einsum("bchij,bcjhm->bcihm", scores, vc)
    # the bonus (j == i) term
    y_bonus = torch.einsum("bcihn,bcihn,bcihm->bcihm", rc * bonus, kc, vc)

    decay_to_end = torch.exp(Lc[:, :, -1:] - Lc)      # <= 1
    states = torch.einsum("bcjhn,bcjhn,bcjhm->bchnm", kc, decay_to_end, vc)
    chunk_decay = torch.exp(Lc[:, :, -1])             # (b, nc, h, n)
    S_prev, S_final = _carry(states, chunk_decay[..., None])

    y_inter = torch.einsum("bcihn,bchnm->bcihm", q_star, S_prev)
    y = (y_intra + y_bonus + y_inter).reshape(b, nc * q, h, m)[:, :l]
    return y, S_final


def _group_norm(y: torch.Tensor, h: int) -> torch.Tensor:
    """Per-head normalization of y (..., d) fp32 over each head's values:
    population variance (``jnp.var``), eps 64e-5; no scale."""
    yh = _heads(y, h)
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    return ((yh - mean) * torch.rsqrt(var + 64e-5)).reshape(y.shape)


def rwkv6_time_mix(params, spec: RWKV6Spec, x: torch.Tensor,
                   exact: bool = False, return_state: bool = False):
    """Full-sequence RWKV6 time-mix.  x (b, l, d_model).  With
    ``return_state`` also returns {"shift_tm": the last input row (fp32),
    "wkv": the final state}."""
    b, l, d = x.shape
    xx = F.pad(x, (0, 0, 1, 0))[:, :-1]              # token shift
    r, k, v, g, logw = _rwkv_projections(params, spec, x, xx)
    h = spec.n_heads
    f32 = torch.float32
    rh, kh, vh = (_heads(t.to(f32), h) for t in (r, k, v))
    wh = _heads(logw, h)
    if exact:
        y, S = _wkv_scan(rh, kh, vh, wh, params["bonus"])
    else:
        y, S = _wkv_chunked(rh, kh, vh, wh, params["bonus"], spec.chunk)
    y = _group_norm(y.reshape(b, l, d), h) * params["ln_scale"]
    out = (y.to(x.dtype) * g) @ params["w_o"].to(x.dtype)
    if not return_state:
        return out
    return out, {"shift_tm": x[:, -1].to(f32), "wkv": S}


def rwkv6_channel_mix_init(gen: torch.Generator, d_model: int, d_ff: int,
                           device, lead=()):
    lead = tuple(lead)
    return {
        "mu_k": init_leaf(torch.rand(lead + (d_model,), generator=gen,
                                     device=device)),
        "mu_r": init_leaf(torch.rand(lead + (d_model,), generator=gen,
                                     device=device)),
        "w_k_cm": dense_init(gen, lead + (d_model, d_ff), device),
        "w_v_cm": dense_init(gen, lead + (d_ff, d_model), device),
        "w_r_cm": dense_init(gen, lead + (d_model, d_model), device),
    }


def rwkv6_channel_mix(params, x: torch.Tensor,
                      xx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channel-mix of x (b, l, d); ``xx`` is the shifted input (default:
    x shifted by one token, zeros first)."""
    if xx is None:
        xx = F.pad(x, (0, 0, 1, 0))[:, :-1]
    xk = x + (xx - x) * params["mu_k"].to(x.dtype)
    xr = x + (xx - x) * params["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(xk @ params["w_k_cm"].to(x.dtype)))
    kv = k @ params["w_v_cm"].to(x.dtype)
    return torch.sigmoid(xr @ params["w_r_cm"].to(x.dtype)) * kv


def rwkv6_init_state(spec: RWKV6Spec, batch: int,
                     device=None) -> Dict[str, Any]:
    hd = spec.head_dim
    return {
        "shift_tm": torch.zeros((batch, spec.d_model), device=device),
        "shift_cm": torch.zeros((batch, spec.d_model), device=device),
        "wkv": torch.zeros((batch, spec.n_heads, hd, hd), device=device),
    }


def rwkv6_time_mix_decode(params, spec: RWKV6Spec, x: torch.Tensor, state):
    """One token.  x (b, 1, d); ``state`` {"shift_tm", "wkv"}.  Returns
    (out (b, 1, d), {"shift_tm", "wkv"} new)."""
    b, _, d = x.shape
    xx = state["shift_tm"].to(x.dtype)[:, None, :]
    r, k, v, g, logw = _rwkv_projections(params, spec, x, xx)
    h = spec.n_heads
    f32 = torch.float32
    rt, kt, vt = (_heads(t[:, 0].to(f32), h) for t in (r, k, v))
    wt = _heads(logw[:, 0], h)
    S = state["wkv"]
    kv = kt[..., :, None] * vt[..., None, :]
    y = torch.einsum("bhn,bhnm->bhm", rt, S + params["bonus"][..., None] * kv)
    S = torch.exp(wt)[..., None] * S + kv
    yd = (_group_norm(y.reshape(b, d), h) * params["ln_scale"]).to(x.dtype)
    out = ((yd * g[:, 0]) @ params["w_o"].to(x.dtype))[:, None, :]
    return out, {"shift_tm": x[:, 0].to(f32), "wkv": S}
