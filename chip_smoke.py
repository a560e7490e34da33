"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each kernel against its plain PyTorch version on the card at the
shapes its path gives it (and times kernel, plain version, a one-call
PyTorch yardstick where there is one and the least time the card could
take), drives the K-major ``wq_matmul`` (which no serving path reaches)
through one layer's matmuls, then drives the ported paths with their
launch counts checked:

* serving: full-width 40-layer Granite-3-2B with int4 weights and an int8
  KV cache through ``Engine``, and the card's prefill and first
  decode-step logits against the CPU's on a 2-layer cut;
* scheduling: full-width 40-layer Granite-3-2B served W4A8 (int4 weights,
  int8 activations) from a paged int8 KV pool through the continuous-
  batching ``Scheduler`` with chunked prefill and the prefix trie; ring
  against paged on a 4-layer cut (identical tokens); the card against
  the CPU on a 2-layer cut (fp32); a seeded chaos replay on 2 layers;
* training: full-width 40-layer Granite-3-2B trained 3 LOTION steps
  (fused AdamW, decoupled penalty) then evaluated with fp32, RTN and RR
  weights; 8 layers with the loss-side penalty; and 2 layers trained on
  the card and on the CPU from the same weights and batches.

Each phase prints one JSON line; a failed check raises and the script
exits non-zero.  The last three lines are the ``kernels`` summary, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.

Needs one CUDA device; without one it exits with an error and no result.
Imports only torch, numpy, the standard library and the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12               # H100 SXM dense int8 tensor-core peak
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
# penalty sums: the kernel adds in double in a fixed tree, the plain version
# in fp32 in PyTorch's order; the two differ by summation order only
PENALTY_RTOL = 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_tol(dtype: torch.dtype) -> float:
    """Error allowed relative to the largest output.  bf16: two rounding
    steps (both sides round an fp32 result to bf16, and fp32 summation
    order may move it across one rounding boundary).  fp32: summation
    order only."""
    return 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5


class Timer:
    """Per-launch CUDA-event timing of device time with a cold L2 (the
    serving path reads every weight once per step).  Before each launch a
    512 MiB read evicts the 50 MB L2 without leaving dirty lines, and it
    keeps the card busy for about 0.2 ms, longer than the host needs to
    enqueue the event and the launch, so the events bracket the kernel's
    device time and not the wrapper's host time."""

    def __init__(self, dev):
        self.flush = torch.ones(512 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.sum()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / iters


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """Least time in ms: bytes over HBM rate vs operations over ``peak``
    (the bf16 peak unless given)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# --------------------------------------------------------------------------
# phase 3a: wqt_matmul against its plain version
# --------------------------------------------------------------------------

WQT_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192),
              (49155, 2048)]
# beyond the main path: fp32 activations, and code rows that are not a
# multiple of 16 bytes (K = 1000), which take the scalar code loads:
# (N, K, block_k, M values, dtype)
WQT_EXTRA = [(2048, 2048, 128, (1, 8, 64), torch.float32),
             (1000, 1000, 8, (1, 8, 130), torch.float32),
             (1000, 1000, -1, (1, 8, 130), torch.bfloat16)]
# the 7 weight matmuls of one Granite layer: (N, K) -> count
LAYER_MATMULS = {(2048, 2048): 2, (512, 2048): 2, (8192, 2048): 2,
                 (2048, 8192): 1}


def check_wqt_one(timer, gen, dev, qt, w_lib, *, m, n, k, bits, block_k,
                  dtype):
    from repro_torch.kernels.wq_matmul import wqt_matmul
    from repro_torch.kernels.wq_matmul.ref import wqt_matmul_ref
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    got = wqt_matmul(x, qt.codes, qt.scales, block_k, bits)
    ref = wqt_matmul_ref(x, qt.codes, qt.scales, block_k, bits == 4)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    tol = rel_tol(dtype) * float(ref.float().abs().max())
    row = dict(phase="check", kernel="wqt_matmul", M=m, N=n, K=k, bits=bits,
               block_k=block_k, dtype=str(dtype).replace("torch.", ""),
               vec_loads=qt.codes.shape[1] % 16 == 0, max_abs_err=err,
               tol=tol)
    if not (err <= tol and torch.isfinite(got).all()):
        emit(row)
        raise AssertionError(f"wqt_matmul disagrees: {row}")
    nbytes = x.numel() * x.element_size() + qt.nbytes \
        + m * n * x.element_size()
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
    w_x = w_lib.to(dtype)
    row.update(
        ms=timer(lambda: wqt_matmul(x, qt.codes, qt.scales, block_k, bits)),
        plain_ms=timer(lambda: wqt_matmul_ref(x, qt.codes, qt.scales,
                                              block_k, bits == 4), iters=3),
        library_ms=timer(lambda: torch.matmul(x, w_x.T)),
        bound_ms=b_ms, bound_by=b_by)
    emit(row)
    return row


def check_wqt(timer, dev):
    from repro_torch.core.qtensor import quantize_qtensor
    from repro_torch.kernels.wq_matmul import dequant_t_ref
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(n, k, bk, (1, 8, 64, 1024), torch.bfloat16)
             for n, k in WQT_SHAPES for bk in (-1, 128)]
    cases += WQT_EXTRA
    rows = []
    for n, k, block_k, ms, dtype in cases:
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        for bits in (8, 4):
            qt = quantize_qtensor(w, f"int{bits}", block_k)
            w_lib = dequant_t_ref(qt.codes, qt.scales, block_k, bits == 4)
            for m in ms:
                rows.append(check_wqt_one(
                    timer, gen, dev, qt, w_lib, m=m, n=n, k=k, bits=bits,
                    block_k=block_k, dtype=dtype))
            del qt, w_lib
        del w
    return rows


# --------------------------------------------------------------------------
# phase 3b: decode_attn against its plain version
# --------------------------------------------------------------------------

def _attn_inputs(gen, dev, b, L, g, rep, hd, bits, dtype):
    from repro_torch.models.layers import kv_quantize
    k = kv_quantize(torch.randn((b, L, g, hd), generator=gen, device=dev),
                    bits)
    v = kv_quantize(torch.randn((b, L, g, hd), generator=gen, device=dev),
                    bits)
    q = torch.randn((b, g, rep, hd), generator=gen, device=dev).to(dtype)
    return q, k, v


def _dense_kv(c, bits):
    from repro_torch.kernels.decode_attn import unpack_int4_ref
    codes = unpack_int4_ref(c["codes"]) if bits == 4 else c["codes"]
    return codes.float() * c["scale"]


def check_attn_one(timer, gen, dev, *, b, L, g, rep, hd, bits, window,
                   softcap, pos, dtype=torch.bfloat16):
    from repro_torch.kernels.decode_attn import (decode_attn,
                                                 decode_attn_ref,
                                                 ring_validity)
    q, k, v = _attn_inputs(gen, dev, b, L, g, rep, hd, bits, dtype)
    args = (k["codes"], k["scale"], v["codes"], v["scale"], pos)
    kw = dict(bits=bits, window=window, softcap=softcap)
    got = decode_attn(q, *args, **kw)
    # the plain version in fp32 on the same (exactly upcast) inputs
    ref = decode_attn_ref(q.float(), *args, **kw)
    torch.cuda.synchronize()
    # each (b, g) row is held at its own scale: a row with one valid slot
    # returns v itself (about 3), a full ring of 4096 slots about 0.03
    err_bg = (got.float() - ref).abs().amax(dim=(2, 3))
    tol_bg = rel_tol(dtype) * ref.abs().amax(dim=(2, 3))
    worst = float((err_bg / tol_bg.clamp_min(1e-30)).max())
    err, tol = float(err_bg.max()), float(tol_bg.min())
    row = dict(phase="check", kernel="decode_attn", b=b, L=L, g=g, rep=rep,
               hd=hd, bits=bits, window=window, softcap=softcap,
               dtype=str(dtype).replace("torch.", ""), vec_loads=(
                   hd // 2 if bits == 4 else hd) % 16 == 0,
               pos=pos.tolist(), max_abs_err=err, min_row_tol=tol,
               worst_err_over_tol=worst)
    if not (bool((err_bg <= tol_bg).all()) and torch.isfinite(got).all()):
        emit(row)
        raise AssertionError(f"decode_attn disagrees: {row}")
    valid = ring_validity(pos, L, window)
    n_valid = int(valid.sum())            # slots this data needs, all rows
    hd_c = hd // 2 if bits == 4 else hd
    nbytes = (2 * q.numel() * q.element_size() + 2 * n_valid * g * (hd_c + 4)
              + b * 4)
    flops = 4.0 * n_valid * g * rep * hd
    b_ms, b_by = bound(nbytes, flops)
    library_ms = None
    if softcap is None:
        # yardstick: SDPA on the dequantized bf16 cache, GQA expanded
        ke = torch.repeat_interleave(_dense_kv(k, bits), rep, dim=2).permute(
            0, 2, 1, 3).to(torch.bfloat16)
        ve = torch.repeat_interleave(_dense_kv(v, bits), rep, dim=2).permute(
            0, 2, 1, 3).to(torch.bfloat16)
        qh = q.reshape(b, g * rep, 1, hd).to(torch.bfloat16)
        mask = valid[:, None, None, :]
        library_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, ke, ve, attn_mask=mask))
    row.update(ms=timer(lambda: decode_attn(q, *args, **kw), iters=20),
               plain_ms=timer(lambda: decode_attn_ref(q.float(), *args, **kw),
                              iters=5),
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    emit(row)
    return row


def check_attn(timer, dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    b, g, rep = 8, 8, 4

    def ragged(L):
        # one slot, partly filled rows, an exactly full one, wrapped rings
        return torch.tensor([0, 5, L // 3, L - 1, L, L + 7, 2 * L + 3,
                             5 * L - 2], dtype=torch.int32, device=dev)

    for L in (256, 4096):
        for bits in (8, 4):
            for window, softcap in ((None, None), (L // 4, 50.0)):
                rows.append(check_attn_one(
                    timer, gen, dev, b=b, L=L, g=g, rep=rep, hd=64,
                    bits=bits, window=window, softcap=softcap,
                    pos=ragged(L)))
    # beyond the main path: fp32 queries, and hd = 16 (int4 code rows of 8
    # bytes take the scalar code loads)
    for hd, bits, dtype in ((64, 8, torch.float32), (64, 4, torch.float32),
                            (16, 4, torch.bfloat16), (16, 4, torch.float32)):
        rows.append(check_attn_one(
            timer, gen, dev, b=b, L=256, g=g, rep=rep, hd=hd, bits=bits,
            window=64, softcap=50.0, pos=ragged(256), dtype=dtype))
    return rows


# --------------------------------------------------------------------------
# phase 3b': decode_attn_paged against its plain version and against
# decode_attn on the gathered view
# --------------------------------------------------------------------------

def check_paged_one(timer, gen, dev, *, b, bs, bps, g, rep, hd, bits, window,
                    softcap, pos, dtype=torch.bfloat16):
    from repro_torch.kernels.decode_attn import (decode_attn,
                                                 decode_attn_paged,
                                                 decode_attn_paged_ref,
                                                 gather_pool_ref,
                                                 ring_validity)
    n_blocks = b * bps + 1                # block 0 is the never-read null
    # every row's blocks, shuffled over the pool
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(b, bps).to(torch.int32)
    q, k, v = _attn_inputs(gen, dev, n_blocks, bs, g, rep, hd, bits, dtype)
    q = q[:b].contiguous()
    args = (k["codes"], k["scale"], v["codes"], v["scale"], bt, pos)
    kw = dict(bits=bits, window=window, softcap=softcap)
    got = decode_attn_paged(q, *args, **kw)
    ref = decode_attn_paged_ref(q.float(), *args, **kw)
    view = [gather_pool_ref(t, bt) for t in args[:4]]
    ring = decode_attn(q, *view, pos, **kw)
    torch.cuda.synchronize()
    err_bg = (got.float() - ref).abs().amax(dim=(2, 3))
    tol_bg = rel_tol(dtype) * ref.abs().amax(dim=(2, 3))
    L = bps * bs
    row = dict(phase="check", kernel="decode_attn_paged", b=b, bs=bs, bps=bps,
               L=L, g=g, rep=rep, hd=hd, bits=bits, window=window,
               softcap=softcap, dtype=str(dtype).replace("torch.", ""),
               pos=pos.tolist(), max_abs_err=float(err_bg.max()),
               min_row_tol=float(tol_bg.min()),
               worst_err_over_tol=float((err_bg / tol_bg.clamp_min(1e-30)).max()),
               bitwise_vs_decode_attn=bool(torch.equal(got, ring)))
    if not (bool((err_bg <= tol_bg).all()) and torch.isfinite(got).all()
            and row["bitwise_vs_decode_attn"]):
        emit(row)
        raise AssertionError(f"decode_attn_paged disagrees: {row}")
    n_valid = int(ring_validity(pos, L, window).sum())
    hd_c = hd // 2 if bits == 4 else hd
    nbytes = (2 * q.numel() * q.element_size() + 2 * n_valid * g * (hd_c + 4)
              + b * 4 + bt.numel() * 4)
    b_ms, b_by = bound(nbytes, 4.0 * n_valid * g * rep * hd)
    library_ms = None
    if softcap is None:
        # yardstick: SDPA on the gathered, dequantized bf16 view
        ke = torch.repeat_interleave(_dense_kv(dict(codes=view[0], scale=view[1]),
                                               bits), rep, dim=2)
        ve = torch.repeat_interleave(_dense_kv(dict(codes=view[2], scale=view[3]),
                                               bits), rep, dim=2)
        ke = ke.permute(0, 2, 1, 3).to(torch.bfloat16)
        ve = ve.permute(0, 2, 1, 3).to(torch.bfloat16)
        qh = q.reshape(b, g * rep, 1, hd).to(torch.bfloat16)
        mask = ring_validity(pos, L, window)[:, None, None, :]
        library_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, ke, ve, attn_mask=mask))
    row.update(ms=timer(lambda: decode_attn_paged(q, *args, **kw), iters=20),
               plain_ms=timer(lambda: decode_attn_paged_ref(q.float(), *args,
                                                            **kw), iters=5),
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    emit(row)
    return row


def check_paged(timer, dev):
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    b, bs, bps = 8, 16, 16
    L = bs * bps
    # one slot, partly filled rows, an exactly full one, wrapped rings
    pos = torch.tensor([0, 5, L // 3, L - 1, L, L + 7, 2 * L + 3, 5 * L - 2],
                       dtype=torch.int32, device=dev)
    for bits in (8, 4):
        for window, softcap in ((None, None), (64, 50.0)):
            rows.append(check_paged_one(
                timer, gen, dev, b=b, bs=bs, bps=bps, g=8, rep=4, hd=64,
                bits=bits, window=window, softcap=softcap, pos=pos))
    # beyond the main path: blocks that do not divide the 64-slot tile
    # (bs = 24), and fp32 queries
    rows.append(check_paged_one(timer, gen, dev, b=b, bs=24, bps=11, g=8,
                                rep=4, hd=64, bits=8, window=None,
                                softcap=None, pos=pos % (24 * 11 * 3)))
    rows.append(check_paged_one(timer, gen, dev, b=b, bs=bs, bps=bps, g=8,
                                rep=4, hd=64, bits=4, window=64, softcap=50.0,
                                pos=pos, dtype=torch.float32))
    return rows


# --------------------------------------------------------------------------
# phase 3b'': wqt_matmul_a8 (W4A8) and wq_matmul (K-major) against their
# plain versions at the seven matmul shapes of a Granite layer
# --------------------------------------------------------------------------

A8_MS = (8, 16, 128)      # decode (8 slots), a 16-token prefill chunk, more


def _int_mm_epilogue(xq, xs, w_kn, s):
    """Yardstick of the per-tensor W8A8 function: ``torch._int_mm`` (int8
    x int8 -> int32 on cuBLAS; it takes M > 16, so small M is padded to
    32 rows) and the scale epilogue."""
    return torch._int_mm(xq, w_kn).float() * xs * s


def check_a8_one(timer, gen, dev, *, m, n, k, bits, block_k):
    from repro_torch.core.qtensor import quantize_qtensor
    from repro_torch.kernels.decode_attn import unpack_int4_ref
    from repro_torch.kernels.wq_matmul import (quantize_acts_ref,
                                               wqt_matmul_a8,
                                               wqt_matmul_a8_ref)
    w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
    qt = quantize_qtensor(w, f"int{bits}", block_k)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    xq, xs = quantize_acts_ref(x)
    args = (xq, xs, qt.codes, qt.scales, block_k)
    got = wqt_matmul_a8(*args, bits)
    ref = wqt_matmul_a8_ref(*args, bits == 4)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, ref))
    row = dict(phase="check", kernel="wqt_matmul_a8", M=m, N=n, K=k,
               bits=bits, block_k=block_k, bitwise=same,
               max_abs_err=float((got - ref).abs().max()))
    if not (same and torch.isfinite(got).all()):
        emit(row)
        raise AssertionError(f"wqt_matmul_a8 disagrees: {row}")
    nbytes = xq.numel() + xs.numel() * 4 + qt.nbytes + m * n * 4
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k, INT8_OPS)
    library_ms = lib_m = None
    if block_k == -1:
        codes = unpack_int4_ref(qt.codes) if bits == 4 else qt.codes
        w_kn = codes.contiguous().t()          # (K, N), column-major
        lib_m = max(m, 32)
        xq_l = torch.zeros((lib_m, k), dtype=torch.int8, device=dev)
        xq_l[:m] = xq
        xs_l = torch.ones((lib_m, 1), device=dev)
        xs_l[:m] = xs
        try:
            library_ms = timer(lambda: _int_mm_epilogue(xq_l, xs_l, w_kn,
                                                        qt.scales))
        except RuntimeError as e:          # a build without int8 cuBLASLt
            row["library_error"] = str(e)[:200]
    row.update(ms=timer(lambda: wqt_matmul_a8(*args, bits)),
               plain_ms=timer(lambda: wqt_matmul_a8_ref(*args, bits == 4),
                              iters=3),
               library_ms=library_ms, library_M=lib_m, bound_ms=b_ms,
               bound_by=b_by)
    emit(row)
    return row


def check_a8(timer, dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    return [check_a8_one(timer, gen, dev, m=m, n=n, k=k, bits=bits,
                         block_k=bk)
            for (n, k) in LAYER_MATMULS for bits in (4, 8)
            for bk in (-1, 128) for m in A8_MS]


def check_wq_one(timer, gen, dev, *, m, n, k, bits, block_k=128,
                 dtype=torch.bfloat16):
    from repro_torch.kernels.wq_matmul import (dequant_ref, pack_weight,
                                               wq_matmul, wq_matmul_ref)
    w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
    codes, scales = pack_weight(w, block_k, bits)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    got = wq_matmul(x, codes, scales, block_k, bits)
    ref = wq_matmul_ref(x, codes, scales, block_k, bits == 4)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    tol = rel_tol(dtype) * float(ref.float().abs().max())
    row = dict(phase="check", kernel="wq_matmul", M=m, N=n, K=k, bits=bits,
               block_k=block_k, dtype=str(dtype).replace("torch.", ""),
               max_abs_err=err, tol=tol)
    if not (err <= tol and torch.isfinite(got).all()):
        emit(row)
        raise AssertionError(f"wq_matmul disagrees: {row}")
    nbytes = (x.numel() * x.element_size() + codes.numel() + scales.numel() * 4
              + m * n * x.element_size())
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
    w_lib = dequant_ref(codes, scales, block_k, bits == 4).to(dtype)
    row.update(ms=timer(lambda: wq_matmul(x, codes, scales, block_k, bits)),
               plain_ms=timer(lambda: wq_matmul_ref(x, codes, scales, block_k,
                                                    bits == 4), iters=3),
               library_ms=timer(lambda: torch.matmul(x, w_lib)),
               bound_ms=b_ms, bound_by=b_by)
    emit(row)
    return row


def wq_path(dev):
    """The K-major layout's path: no serving path of the package reaches
    it, so this drives one Granite layer's 7 weight matmuls through
    ``wq_matmul`` at decode width (M = 8, int4, block 128) from K-major
    codes packed by ``pack_weight``, with its launches counted."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.wq_matmul import pack_weight, wq_matmul
    gen = torch.Generator(device=dev).manual_seed(8)
    packed = {s: pack_weight(torch.randn((s[1], s[0]), generator=gen,
                                         device=dev) / math.sqrt(s[1]), 128, 4)
              for s in LAYER_MATMULS}
    x = {k: torch.randn((8, k), generator=gen, device=dev).to(torch.bfloat16)
         for k in {s[1] for s in LAYER_MATMULS}}
    reset_launch_counts()
    outs = [wq_matmul(x[k], *packed[(n, k)], 128, 4)
            for (n, k), c in LAYER_MATMULS.items() for _ in range(c)]
    counts = launch_counts()
    want = dict.fromkeys(counts, 0)
    want["wq_matmul"] = sum(LAYER_MATMULS.values())
    ok = counts == want and all(torch.isfinite(o).all() for o in outs)
    row = dict(phase="wq_path", launches=counts, expected_launches=want,
               shapes=[list(o.shape) for o in outs])
    emit(row)
    if not ok:
        raise AssertionError(f"wq_matmul path failed: {row}")
    return row


def check_wq(timer, dev):
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = [check_wq_one(timer, gen, dev, m=m, n=n, k=k, bits=bits)
            for (n, k) in LAYER_MATMULS for bits in (4, 8) for m in A8_MS]
    # beyond the main shapes: fp32 activations and a ragged N (scalar loads)
    rows.append(check_wq_one(timer, gen, dev, m=8, n=1000, k=1024, bits=4,
                             block_k=64, dtype=torch.float32))
    rows.append(check_wq_one(timer, gen, dev, m=130, n=1000, k=1024, bits=8,
                             block_k=64, dtype=torch.float32))
    return rows


# --------------------------------------------------------------------------
# phase 3c: the training kernels (quant, lotion_reg, opt_step) against
# their plain versions at the Granite-3-2B leaf shapes
# --------------------------------------------------------------------------

# (shape, leaves of Granite-3-2B with that shape, eligible under the
# default policy): wq/wo, wk/wv, w_up/w_gate, w_down, the tied embedding,
# the stacked norm scales, the final norm scale
GRANITE_LEAVES = [((40, 2048, 2048), 2, True), ((40, 2048, 512), 2, True),
                  ((40, 2048, 8192), 2, True), ((40, 8192, 2048), 1, True),
                  ((49155, 2048), 1, False), ((40, 2048), 2, False),
                  ((2048,), 1, False)]
CHECK_SHAPES = [s for s, _, _ in GRANITE_LEAVES[:6]]
OTHER_FMT_SHAPES = [(40, 2048, 512), (49155, 2048)]
# fp32 operations per element, the least each function needs (for the
# operations side of the bound; the bytes side dominates by far)
OPS_PER_ELEM = {"quant": 4, "lotion_reg": 10, "opt_step": 16}


def _fmt_shape(shape):
    return "x".join(map(str, shape))


def _bitwise(pairs):
    """Largest |a - b| over (name, got, want) triples and whether every
    pair is bitwise equal (NaN never appears in these inputs)."""
    err, same, bad = 0.0, True, []
    for name, a, b in pairs:
        eq = torch.equal(a, b)
        if not eq:
            bad.append(name)
            err = max(err, float((a.float() - b.float()).abs().max()))
        same = same and eq
    return err, same, bad


def _elem_bound(kernel, n, nbytes):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = OPS_PER_ELEM[kernel] * n / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_quant_one(timer, gen, dev, shape, fmt, bs, rr):
    from repro_torch.kernels.quant import quant_rr, quant_rtn, rr_ref, rtn_ref
    w = torch.randn(shape, generator=gen, device=dev) * 0.02
    u = torch.rand(shape, generator=gen, device=dev) if rr else None
    if rr:
        def run():
            return quant_rr(w, u, fmt, bs)

        def plain():
            return rr_ref(w, u, fmt, bs)
    else:
        def run():
            return quant_rtn(w, fmt, bs)

        def plain():
            return rtn_ref(w, fmt, bs)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err, same, _ = _bitwise([("cast", got, want)])
    n = w.numel()
    row = dict(phase="check", kernel="quant", cast="rr" if rr else "rtn",
               shape=_fmt_shape(shape), fmt=fmt, block_size=bs,
               bitwise=same, max_abs_err=err)
    if not same:
        emit(row)
        raise AssertionError(f"quant disagrees: {row}")
    del got, want
    b_ms, b_by = _elem_bound("quant", n, n * 4 * (3 if rr else 2))
    library_ms = None
    if not rr and bs == -1 and fmt.startswith("int"):
        qmax = 2 ** (int(fmt[3:]) - 1) - 1
        library_ms = timer(lambda: torch.fake_quantize_per_tensor_affine(
            w, 0.01, 0, -qmax, qmax))
    row.update(ms=timer(run), plain_ms=timer(plain, iters=3),
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    emit(row)
    return row


def check_quant(timer, dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for shape in CHECK_SHAPES:
        for bs in (-1, 128):
            rows.append(check_quant_one(timer, gen, dev, shape, "int4", bs,
                                        False))
        rows.append(check_quant_one(timer, gen, dev, shape, "int4", -1, True))
    for shape in OTHER_FMT_SHAPES:
        rows.append(check_quant_one(timer, gen, dev, shape, "int4", 128, True))
        for fmt in ("int8", "fp4"):
            for bs in (-1, 128):
                for rr in (False, True):
                    rows.append(check_quant_one(timer, gen, dev, shape, fmt,
                                                bs, rr))
    return rows


def check_reg_one(timer, gen, dev, shape, fmt, bs, lam=1e3):
    """``lam`` as the loss-placement phase folds it into the gradient."""
    from repro_torch.kernels.lotion_reg import (lotion_penalty_fused_vg,
                                                 reg_ref)
    w = torch.randn(shape, generator=gen, device=dev) * 0.02
    f = torch.rand(shape, generator=gen, device=dev) * 1e-6
    pen, grad = lotion_penalty_fused_vg(w, f, fmt, bs, lam)
    pen_ref, grad_ref = reg_ref(w, f, fmt, bs, lam)
    torch.cuda.synchronize()
    err, same, _ = _bitwise([("grad", grad, grad_ref)])
    pen_rel = float((pen - pen_ref).abs() / pen_ref.abs().clamp_min(1e-30))
    n = w.numel()
    row = dict(phase="check", kernel="lotion_reg", shape=_fmt_shape(shape),
               fmt=fmt, block_size=bs, lam=lam, bitwise=same, max_abs_err=err,
               penalty=float(pen), penalty_rel_err=pen_rel)
    if not (same and pen_rel <= PENALTY_RTOL):
        emit(row)
        raise AssertionError(f"lotion_reg disagrees: {row}")
    del pen, grad, pen_ref, grad_ref
    b_ms, b_by = _elem_bound("lotion_reg", n, n * 4 * 3)
    row.update(ms=timer(lambda: lotion_penalty_fused_vg(w, f, fmt, bs, lam)),
               plain_ms=timer(lambda: reg_ref(w, f, fmt, bs, lam), iters=3),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    emit(row)
    return row


def check_lotion_reg(timer, dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = [check_reg_one(timer, gen, dev, shape, "int4", bs)
            for shape in CHECK_SHAPES for bs in (-1, 128)]
    rows += [check_reg_one(timer, gen, dev, shape, fmt, bs)
             for shape in OTHER_FMT_SHAPES for fmt in ("int8", "fp4")
             for bs in (-1, 128)]
    return rows


OPT_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)


def check_opt_one(timer, gen, dev, shape, fmt, bs, *, lam=1e3, core="adamw",
                  momentum=0.0, fisher_decay=None, ok=1.0):
    from repro_torch.kernels.opt_step import fused_opt_step_leaf, opt_step_ref
    w = torch.randn(shape, generator=gen, device=dev) * 0.02
    g = torch.randn(shape, generator=gen, device=dev) * 1e-3
    mu = torch.randn(shape, generator=gen, device=dev) * 1e-4
    nu = torch.rand(shape, generator=gen, device=dev) * 1e-6
    t = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    count = 3.0
    scal = dict(lr=t(3e-4), bc1=t(1 - 0.9 ** count), bc2=t(1 - 0.95 ** count),
                clip_scale=t(0.5), ok=t(ok))
    kw = dict(lam=lam, fmt_name=fmt, block_size=bs, core=core,
              momentum=momentum, fisher_decay=fisher_decay, **OPT_HYPER)
    want = opt_step_ref(w, g, mu, nu, **scal, **kw)
    w_k, mu_k, nu_k = w.clone(), mu.clone(), nu.clone()
    got = fused_opt_step_leaf(w_k, g, mu_k, nu_k, **scal, **kw)
    torch.cuda.synchronize()
    if not (got[0] is w_k and got[1] is mu_k and got[2] is nu_k):
        raise AssertionError("opt_step did not update in place")
    pairs = [("w", got[0], want[0]), ("mu", got[1], want[1]),
             ("nu", got[2], want[2])]
    if ok == 0.0:
        pairs += [("w_frozen", got[0], w), ("mu_frozen", got[1], mu),
                  ("nu_frozen", got[2], nu)]
    err, same, bad = _bitwise(pairs)
    pen_rel = (float((got[3] - want[3]).abs()
                     / want[3].abs().clamp_min(1e-30)) if lam else 0.0)
    n = w.numel()
    mode = "none" if lam == 0.0 else "matrix" if bs == -1 else "block"
    row = dict(phase="check", kernel="opt_step", shape=_fmt_shape(shape),
               fmt=fmt, block_size=bs, mode=mode, core=core, ok=ok,
               momentum=momentum, fisher_decay=fisher_decay, bitwise=same,
               not_bitwise=bad, max_abs_err=err, penalty_rel_err=pen_rel)
    if not (same and pen_rel <= PENALTY_RTOL):
        emit(row)
        raise AssertionError(f"opt_step disagrees: {row}")
    del got, want, w_k, mu_k, nu_k
    # w and g, plus each moment the core keeps: read once, written once;
    # with ok = 0 the step is the identity and needs only the flag
    moments = (2 if core == "adamw"
               else int(bool(momentum)) + int(fisher_decay is not None))
    b_ms, b_by = (_elem_bound("opt_step", n, n * 4 * (3 + 2 * moments))
                  if ok else _elem_bound("opt_step", 0, 4))
    w_k, mu_k, nu_k = w.clone(), mu.clone(), nu.clone()
    library_ms = None
    if lam == 0.0 and core == "adamw":
        # yardstick: PyTorch's fused AdamW kernel on the same leaf
        w_l, mu_l, nu_l = w.clone(), mu.clone(), nu.clone()
        steps = [torch.tensor(count, device=dev)]
        library_ms = timer(lambda: torch._fused_adamw_(
            [w_l], [g], [mu_l], [nu_l], [], steps, lr=3e-4, beta1=0.9,
            beta2=0.95, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False))
        del w_l, mu_l, nu_l
    row.update(ms=timer(lambda: fused_opt_step_leaf(w_k, g, mu_k, nu_k,
                                                    **scal, **kw)),
               plain_ms=timer(lambda: opt_step_ref(w, g, mu, nu, **scal,
                                                   **kw), iters=3),
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    emit(row)
    return row


def check_opt_step(timer, dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for shape in CHECK_SHAPES:
        for bs in (-1, 128):
            rows.append(check_opt_one(timer, gen, dev, shape, "int4", bs))
    for shape, _, _ in GRANITE_LEAVES:
        rows.append(check_opt_one(timer, gen, dev, shape, "int4", -1, lam=0.0))
    for shape in OTHER_FMT_SHAPES:
        for fmt in ("int8", "fp4"):
            for bs in (-1, 128):
                rows.append(check_opt_one(timer, gen, dev, shape, fmt, bs))
    sgd = dict(core="sgd", momentum=0.9, fisher_decay=0.99)
    for bs in (-1, 128):
        rows.append(check_opt_one(timer, gen, dev, (40, 2048, 2048), "int4",
                                  bs, **sgd))
    rows.append(check_opt_one(timer, gen, dev, (40, 2048, 2048), "int4", -1,
                              lam=0.0, core="sgd"))
    for core in ("adamw", "sgd"):
        rows.append(check_opt_one(
            timer, gen, dev, (40, 2048, 512), "int4", -1, ok=0.0,
            **(sgd if core == "sgd" else {})))
    return rows


# --------------------------------------------------------------------------
# phase 4: full-width Granite-3-2B served through Engine
# --------------------------------------------------------------------------

def _prompts(rng, n, lo, hi, vocab):
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def granite_engine(dev, max_new_tokens: int):
    """The main path's workload, also profiled by
    ``scripts/profile_serve_torch.py``: full-width Granite-3-2B from seed
    0 served with int4 weights and an int8 KV cache, and 8 seeded prompts
    of 64-128 tokens.  Returns (cfg, engine, prompts)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import lm_init
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config("granite-3-2b")
    eng = Engine(cfg, lm_init(cfg, seed=0, device=dev),
                 ServeConfig(weights="rtn:int4", kv_quant="int8",
                             max_new_tokens=max_new_tokens), device=dev)
    prompts = _prompts(np.random.default_rng(0), 8, 64, 128, cfg.vocab)
    return cfg, eng, prompts


def serve_full_width(dev):
    from repro_torch.core import param_nbytes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import lm_prefill

    mnt = 32
    t0 = time.perf_counter()
    cfg, eng, prompts = granite_engine(dev, mnt)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    eng.generate(prompts[:2], max_new_tokens=2)               # warm-up

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = launch_counts()

    per_forward = 7 * cfg.n_layers
    want = dict.fromkeys(counts, 0)
    want.update(wqt_matmul=per_forward * mnt,
                decode_attn=cfg.n_layers * (mnt - 1))
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if [len(o) for o in outs] != [mnt] * len(prompts) or not all(
            0 <= t < cfg.vocab for o in outs for t in o):
        raise AssertionError("generated tokens out of shape or vocabulary")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=1)                   # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    # the prefill logits are finite and shaped (b, 1, vocab)
    toks = torch.tensor([p[:64] for p in prompts[:2]], device=dev)
    logits, _ = lm_prefill(eng.params, cfg, toks, cache_len=128,
                           kv_quant="int8")
    if tuple(logits.shape) != (2, 1, cfg.vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError("prefill logits not finite or misshapen")

    row = dict(phase="serve", model=cfg.name, n_layers=cfg.n_layers,
               d_model=cfg.d_model, dtype=str(cfg.dtype),
               weights="rtn:int4", kv_quant="int8", batch=len(prompts),
               prompt_lens=[len(p) for p in prompts], max_new_tokens=mnt,
               launches=counts, expected_launches=want,
               setup_s=setup_s, generate_s=gen_s, prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=(gen_s - prefill_s) * 1e3 / (mnt - 1),
               tok_per_s=len(prompts) * mnt / gen_s,
               weight_storage_mib=param_nbytes(eng.params) / 2 ** 20,
               max_memory_allocated_mib=torch.cuda.max_memory_allocated()
               / 2 ** 20, first_tokens=[o[:8] for o in outs[:2]])
    emit(row)
    del eng
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# phase 5: the card against the CPU, 2 layers at full width
# --------------------------------------------------------------------------

def card_vs_cpu(dev):
    from repro_torch.configs import get_config
    from repro_torch.core.policy import tree_map_with_path
    from repro_torch.models.lm import lm_decode, lm_init, lm_prefill
    from repro_torch.serve import Engine, ServeConfig

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2)
    scfg = ServeConfig(weights="rtn:int4", kv_quant="int8", max_new_tokens=8)
    params = lm_init(cfg, seed=1, device=dev)
    cpu_params = tree_map_with_path(lambda p, x: x.cpu(), params)
    eng_gpu = Engine(cfg, params, scfg, device=dev)
    eng_cpu = Engine(cfg, cpu_params, scfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = _prompts(rng, 4, 16, 32, cfg.vocab)
    max_len = max(map(len, prompts))
    toks = np.zeros((len(prompts), max_len), np.int64)
    for i, p in enumerate(prompts):
        toks[i, max_len - len(p):] = p
    lens = [len(p) for p in prompts]

    def step_logits(eng, device, next_tok=None):
        """Prefill logits, then the first decode step's (through
        decode_attn on the card, its plain version on the CPU), fed
        ``next_tok`` or the greedy first tokens."""
        logits, cache = lm_prefill(
            eng.params, cfg, torch.as_tensor(toks, device=device),
            cache_len=64, kv_quant="int8",
            prompt_lens=torch.tensor(lens, device=device))
        tok = next_tok if next_tok is not None else logits[:, 0].argmax(-1)
        dec, _ = lm_decode(eng.params, cfg, cache,
                           tok.to(device)[:, None].long(),
                           torch.tensor(lens, device=device))
        return logits.float().cpu(), dec.float().cpu(), tok.cpu()

    with torch.inference_mode():
        pc, dc, next_tok = step_logits(eng_cpu, "cpu")
        pg, dg, _ = step_logits(eng_gpu, dev, next_tok)
    errs = dict(prefill=float((pg - pc).abs().max()),
                decode=float((dg - dc).abs().max()))
    scale = max(float(pc.abs().max()), float(dc.abs().max()))
    err = max(errs.values())
    # bf16 activations on both sides, rounded at different places (the
    # kernels accumulate in fp32 and round once; the CPU rounds bf16
    # matmul outputs its own way): 5% of the largest logit
    tol = 0.05 * scale
    out_gpu, out_cpu = eng_gpu.generate(prompts), eng_cpu.generate(prompts)
    agree = float(np.mean([a == c for og, oc in zip(out_gpu, out_cpu)
                           for a, c in zip(og, oc)]))
    first_agree = float(np.mean([og[0] == oc[0]
                                 for og, oc in zip(out_gpu, out_cpu)]))
    row = dict(phase="card_vs_cpu", model=cfg.name, n_layers=cfg.n_layers,
               dtype=str(cfg.dtype), max_abs_logit_err=errs, tol=tol,
               max_abs_logit=scale, greedy_token_agreement=agree,
               first_token_agreement=first_agree)
    emit(row)
    if not err <= tol:
        raise AssertionError(f"card and CPU logits disagree: {row}")
    return row


# --------------------------------------------------------------------------
# phases 5b-5e: the continuous-batching scheduler, W4A8 over a paged int8
# KV pool
# --------------------------------------------------------------------------

SCHED_SCFG = dict(weights="rtn:int4", kv_quant="int8", act_fmt="int8")
SCHED_CFG = dict(n_slots=8, steps_per_tick=4, cache_len=256,
                 prefill_chunk=16, prefix_cache=True, paged=True,
                 block_size=16)


def sched_workload(vocab: int, n_requests: int = 16, seed: int = 0):
    """Chat-shaped traffic: a 64-token system prompt shared by every
    request but the stragglers, tails of 8-64 tokens, every sixth request
    a unique 128-token prompt, budgets of 8, 16 or 32 tokens."""
    from repro_torch.serve.replay import shared_prefix_workload
    return shared_prefix_workload(seed=seed, n_requests=n_requests,
                                  vocab=vocab, sys_len=64, tail_lens=(8, 64),
                                  straggler_len=128, budgets=(8, 16, 32))


def granite_cfg(n_layers=None, dtype=None):
    """Granite-3-2B at full width, its depth cut to ``n_layers`` and its
    activations in ``dtype`` where given."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-3-2b")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg


def granite_scheduler(dev, cfg=None, *, seed=0, params=None, **sched_kw):
    """The scheduler path's workload: ``cfg`` (default full-width 40-layer
    Granite-3-2B) from random weights of ``seed`` (or ``params``), served
    W4A8 with an int8 KV pool under ``SCHED_CFG`` (overridden by
    ``sched_kw``).  Returns (cfg, scheduler)."""
    from repro_torch.models.lm import lm_init
    from repro_torch.serve import Scheduler, SchedulerConfig, ServeConfig
    cfg = cfg or granite_cfg()
    if params is None:
        params = lm_init(cfg, seed=seed, device=dev)
    sch = Scheduler(cfg, params, ServeConfig(max_new_tokens=32, **SCHED_SCFG),
                    SchedulerConfig(**dict(SCHED_CFG, **sched_kw)),
                    device=dev)
    return cfg, sch


def sched_full_width(dev):
    """The main path: 40 layers, 16 requests replayed on the scheduler's
    wall-time clock, every launch counted and derived from the schedule:
    280 ``wqt_matmul_a8`` per forward (decode steps and prefill chunks
    alike), 40 ``decode_attn_paged`` per decode step."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import COMPLETED, check_drained
    from repro_torch.serve.replay import replay_continuous
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, sch = granite_scheduler(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # warm-up on other prompts (cuBLAS, the allocator, the row buffers)
    sch.generate(_prompts(np.random.default_rng(5), 2, 20, 40, cfg.vocab),
                 max_new_tokens=5)
    wl = sched_workload(cfg.vocab)
    before = dict(ticks=sch.n_ticks, prefills=sch.n_prefills,
                  shared=sch.prefix_blocks_shared, nan=sch.counters[
                      "nan_events"], rid=sch._next_rid)
    peak = [0]
    step = sch.step

    def counted_step(now=None):
        out = step(now)
        peak[0] = max(peak[0], sch.block_pool.n_live)
        return out

    sch.step = counted_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rec = replay_continuous(sch, wl)
    torch.cuda.synchronize()
    counts = launch_counts()
    del sch.step
    ticks = sch.n_ticks - before["ticks"]
    chunks = sch.n_prefills - before["prefills"]
    k = sch.sched.steps_per_tick
    want = dict.fromkeys(counts, 0)
    want.update(wqt_matmul_a8=7 * cfg.n_layers * (ticks * k + chunks),
                decode_attn_paged=cfg.n_layers * ticks * k)
    rids = range(before["rid"], before["rid"] + len(wl))
    outs = [sch.requests[r].out for r in rids]
    shared = sch.prefix_blocks_shared - before["shared"]
    checks = {
        "completed": all(sch.requests[r].state == COMPLETED for r in rids),
        "budgets": [len(o) for o in outs] == [w.max_new_tokens for w in wl],
        "vocab": all(0 <= t < cfg.vocab for o in outs for t in o),
        "drained": check_drained(sch) == [],
        "nan_events": sch.counters["nan_events"] == before["nan"],
        "prefix_blocks_shared": shared > 0,
        "splice_host_transfers": sch.splice_host_transfers == 0,
        "launches": counts == want}
    lat = np.asarray([rec["latency"][i] for i in sorted(rec["latency"])])
    total = sum(len(o) for o in outs)
    row = dict(phase="sched", model=cfg.name, n_layers=cfg.n_layers,
               d_model=cfg.d_model, dtype=str(cfg.dtype), **SCHED_SCFG,
               sched=SCHED_CFG, requests=len(wl),
               prompt_lens=[len(w.prompt) for w in wl],
               budgets=[w.max_new_tokens for w in wl], setup_s=setup_s,
               makespan_s=rec["makespan"], tokens=total,
               tok_per_s=total / rec["makespan"],
               latency_p50_s=float(np.percentile(lat, 50)),
               latency_p95_s=float(np.percentile(lat, 95)),
               ticks=ticks, decode_steps=ticks * k, prefill_chunks=chunks,
               prefill_tokens_computed=rec["prefill_tokens_computed"],
               prefill_tokens_skipped=rec["prefill_tokens_skipped"],
               prefix_blocks_shared=shared,
               pool_blocks=sch.block_pool.n_blocks,
               pool_blocks_live_peak=peak[0],
               launches=counts, expected_launches=want,
               max_memory_allocated_mib=torch.cuda.max_memory_allocated()
               / 2 ** 20, first_tokens=[o[:8] for o in outs[:2]],
               checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"sched phase failed its checks: {checks}")
    del sch
    torch.cuda.empty_cache()
    return row


def sched_ring_vs_paged(dev, n_layers=4, n_requests=8):
    """Ring against paged, same weights and traffic: identical greedy
    tokens, and the ring run's ``decode_attn`` launches equal the paged
    run's ``decode_attn_paged`` launches."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import lm_init
    torch.cuda.empty_cache()
    cfg = granite_cfg(n_layers)
    params = lm_init(cfg, seed=3, device=dev)
    wl = sched_workload(cfg.vocab, n_requests)
    prompts = [w.prompt for w in wl]
    budgets = [w.max_new_tokens for w in wl]
    out, counts = {}, {}
    for mode, paged in (("ring", False), ("paged", True)):
        _, sch = granite_scheduler(dev, cfg, params=params, paged=paged)
        reset_launch_counts()
        out[mode] = sch.generate(prompts, max_new_tokens=budgets)
        counts[mode] = launch_counts()
        del sch
    same = out["ring"] == out["paged"]
    attn_equal = counts["ring"]["decode_attn"] == \
        counts["paged"]["decode_attn_paged"] > 0
    row = dict(phase="sched_ring_vs_paged", n_layers=n_layers,
               requests=n_requests, tokens_identical=same,
               launches=counts, attn_launches_equal=attn_equal,
               first_tokens=out["paged"][0][:8])
    emit(row)
    if not (same and attn_equal):
        raise AssertionError("ring and paged schedulers disagree", row)
    del params
    torch.cuda.empty_cache()
    return row


# card against CPU, fp32, TF32 off.  With dense activations the two differ
# by summation order only: logits within 1e-4 of their largest.  With int8
# activations each side rounds its activations to codes, and a last-bit
# difference moves a code by one now and then, which moves the logits by
# about a percent of their largest: the phase measures, on the CPU, how
# far a 2-ulp change of the embeddings moves the logits with dense and
# with int8 activations (``sensitivity_2ulp``).  The card's int8-activation
# logits must stay within SCHED_A8_RTOL of the CPU's, and where the two
# schedulers' tokens part, the CPU's top two logits must be closer than
# that (a near tie that either side may break).
SCHED_DENSE_RTOL = 1e-4
SCHED_A8_RTOL = 0.05


def sched_card_vs_cpu(dev, n_layers=2, n_requests=4):
    """The paged W4A8 scheduler on the card and on the CPU from the same
    weights (fp32, TF32 off): identical greedy tokens, or partings at near
    ties; and the two sides' prefill logits with dense and with int8
    activations within their tolerances."""
    from repro_torch.core.policy import tree_map_with_path
    from repro_torch.core.qtensor import qtensor_act_fmt
    from repro_torch.models.lm import lm_init, lm_prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = granite_cfg(n_layers, "float32")
    params = lm_init(cfg, seed=4, device=dev)
    cpu_params = tree_map_with_path(lambda p, x: x.cpu(), params)
    _, sch = granite_scheduler(dev, cfg, params=params)
    del params
    _, sch_cpu = granite_scheduler(torch.device("cpu"), cfg,
                                   params=cpu_params)
    wl = sched_workload(cfg.vocab, n_requests, seed=1)
    prompts = [w.prompt for w in wl]
    budgets = [w.max_new_tokens for w in wl]

    def last_logits(s, seq, fmt, scale_embed=1.0):
        params = dict(s.params, embed=s.params["embed"] * scale_embed)
        toks = torch.tensor([seq], device=s.device)
        with torch.inference_mode(), qtensor_act_fmt(fmt):
            logits, _ = lm_prefill(params, cfg, toks, kv_quant="int8")
        return logits[0, 0].float().cpu()

    # prefill logits of the first two prompts (the CPU's fp32 prefills are
    # most of the phase's time), the sensitivity on the first
    errs = {"dense": 0.0, "int8": 0.0}
    sens = {"dense": 0.0, "int8": 0.0}
    scale = 0.0
    for n, seq in enumerate(prompts[:2]):
        for fmt, key in ((None, "dense"), ("int8", "int8")):
            c = last_logits(sch_cpu, seq, fmt)
            errs[key] = max(errs[key], float(
                (last_logits(sch, seq, fmt) - c).abs().max()))
            scale = max(scale, float(c.abs().max()))
            if n == 0:
                sens[key] = float((last_logits(
                    sch_cpu, seq, fmt, 1 + 2.0 ** -22) - c).abs().max())
    out_card = sch.generate(prompts, max_new_tokens=budgets)
    out_cpu = sch_cpu.generate(prompts, max_new_tokens=budgets)
    partings = []
    for i, (a, c) in enumerate(zip(out_card, out_cpu)):
        t = next((j for j, (x, y) in enumerate(zip(a, c)) if x != y), None)
        if t is not None:
            top2 = torch.topk(last_logits(sch_cpu, prompts[i] + c[:t],
                                          "int8"), 2).values
            partings.append(dict(request=i, step=t, card=a[t], cpu=c[t],
                                 cpu_top2_gap=float(top2[0] - top2[1])))
    tol = dict(dense=SCHED_DENSE_RTOL * scale, int8=SCHED_A8_RTOL * scale)
    ok = (errs["dense"] <= tol["dense"] and errs["int8"] <= tol["int8"]
          and [len(o) for o in out_card] == [len(o) for o in out_cpu]
          and all(p["cpu_top2_gap"] < tol["int8"] for p in partings))
    row = dict(phase="sched_card_vs_cpu", n_layers=n_layers, dtype="float32",
               requests=n_requests, budgets=budgets,
               max_abs_logit=scale, max_abs_logit_err=errs,
               sensitivity_2ulp=sens, tol=tol,
               tokens_identical=out_card == out_cpu,
               token_agreement=float(np.mean([x == y for a, c in zip(
                   out_card, out_cpu) for x, y in zip(a, c)])),
               partings=partings, first_tokens=out_card[0][:8])
    emit(row)
    if not ok:
        raise AssertionError("card and CPU schedulers disagree", row)
    del sch, sch_cpu
    torch.cuda.empty_cache()
    return row


def sched_chaos(dev, n_layers=2, n_requests=48):
    """The seeded chaos replay (non-finite slots with their counted
    retries, straggler ticks, prefix-trie eviction storms, malformed and
    burst submissions) on the paged scheduler: no invariant violation."""
    from repro_torch.serve import chaos_plan
    from repro_torch.serve.replay import replay_chaos, sla_workload
    cfg, sch = granite_scheduler(dev, granite_cfg(n_layers), seed=5,
                                 cache_len=64, max_queue=4 * n_requests,
                                 est_tok_per_s=200.0)
    wl = sla_workload(13, n_requests, cfg.vocab, rate=100.0,
                      prompt_lens=(2, 32), budgets=(8, 16))
    plan = chaos_plan(seed=13, n_ticks=128, vocab=cfg.vocab, cache_len=64)
    res = replay_chaos(sch, wl, plan=plan)
    row = dict(phase="sched_chaos", n_layers=n_layers, requests=n_requests,
               plan=plan.describe(), by_state=res["by_state"],
               counters=res["counters"], ticks=res["ticks"],
               violations=res["violations"][:20],
               deadline_hit_rate=res["deadline_hit_rate"],
               resume_splice_tokens=res["resume_splice_tokens"],
               resume_recompute_tokens=res["resume_recompute_tokens"])
    emit(row)
    if res["violations"]:
        raise AssertionError(f"chaos replay failed: {row}")
    del sch
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# phases 6-8: LOTION training of Granite-3-2B through the fused kernels
# --------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 4, 1024


def granite_trainer(dev, *, n_layers=None, dtype="bfloat16",
                    placement="decoupled", lam=1e3, seed=0):
    """The training path's workload: Granite-3-2B at full width (depth
    ``n_layers`` if given), random fp32 master weights from ``seed``,
    ``dtype`` activations; LOTION int4 per-tensor at ``lam`` with the given
    penalty placement; AdamW on a cosine schedule with warmup, fused into
    the opt_step core.  Returns (cfg, train_step, eval_fn, state)."""
    from repro_torch.configs import get_config
    from repro_torch.core.modes import QuantConfig
    from repro_torch.models.lm import lm_init
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.train import (TrainConfig, init_state, make_eval_fn,
                                   make_optimizer, make_train_step)
    cfg = dataclasses.replace(get_config("granite-3-2b"), dtype=dtype)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    qcfg = QuantConfig(method="lotion", fmt_name="int4", block_size=-1,
                       lam=lam, penalty_placement=placement)
    tcfg = TrainConfig(quant=qcfg, clip_norm=1.0)
    opt = make_optimizer(tcfg, adamw(cosine_with_warmup(3e-3, 5, 100)))
    state = init_state(lm_init(cfg, seed=seed, device=dev), opt)
    return cfg, make_train_step(cfg, tcfg, opt), make_eval_fn(cfg, qcfg), state


def _pipeline(cfg, dev, batch, seq):
    from repro_torch.data import DataPipeline, lm_batch, permutation_table
    perm = permutation_table(0, cfg.vocab)
    val = lm_batch(99, 10 ** 6, batch, seq, cfg.vocab, perm, device=dev)
    return DataPipeline(lambda s: lm_batch(0, s, batch, seq, cfg.vocab, perm),
                        device=dev), val


def _train_steps(train_step, state, pipe, n, profile_last=False):
    """n steps; per step the host-clock wall ms (synchronized) and the
    metrics as floats.  With ``profile_last`` the last step runs under
    ``torch.profiler`` (its wall time then includes the tracing) and its
    row also gets the device ms of the ``opt_step`` kernel group, grouped
    as ``scripts/profile_train_torch.py`` groups a step's kernels."""
    from torch.profiler import ProfilerActivity, profile
    rows = []
    for i in range(n):
        batch = next(pipe)
        torch.cuda.synchronize()
        traced = profile_last and i == n - 1
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            state, m = train_step(state, batch)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        row = dict(step_ms=step_ms,
                   **{k: float(m[k]) for k in ("loss", "ce", "grad_norm",
                                                "penalty") if k in m},
                   skipped=bool(m["skipped"]))
        if traced:
            from scripts.profile_serve_torch import _device_by_name
            from scripts.profile_train_torch import _group
            row.update(profiled=True, opt_step_device_ms=sum(
                ms for name, (ms, _) in _device_by_name(prof).items()
                if _group(name) == "opt_step"))
        rows.append(row)
        if not (math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])
                and not row["skipped"]):
            raise AssertionError(f"training step not finite: {row}")
    return state, rows


def train_full_width(dev, steps=3):
    """The main path: 40 layers at full width, decoupled placement, then
    the eval CE with fp32, RTN and RR weights.  The last step is profiled
    for the opt_step kernels' device time."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, train_step, eval_fn, state = granite_trainer(dev)
    pipe, val = _pipeline(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_leaves = len(tree_leaves(state["params"]))
    n_eligible = sum(1 for _ in _eligible(state["params"]))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        state, rows = _train_steps(train_step, state, pipe, steps,
                                   profile_last=True)
    finally:
        pipe.close()
    train_peak = torch.cuda.max_memory_allocated()
    after_train = launch_counts()
    ce = {"fp32": float(eval_fn(state["params"], val))}
    ce["rtn"] = float(eval_fn(state["params"], val, "rtn"))
    after_rtn = launch_counts()
    ce["rr"] = float(eval_fn(state["params"], val, "rr",
                             generator=torch.Generator(device=dev)
                             .manual_seed(1)))
    counts = launch_counts()
    want = dict(counts, opt_step=n_leaves * steps, lotion_reg=0,
                quant=2 * n_eligible, wqt_matmul=0, decode_attn=0)
    checks = {"after_train_quant": after_train["quant"] == 0,
              "after_rtn_quant": after_rtn["quant"] == n_eligible,
              "counts": counts == want, "leaves": (n_leaves, n_eligible)
              == (11, 7), "ce_finite": all(map(math.isfinite, ce.values()))}
    row = dict(phase="train", model=cfg.name, n_layers=cfg.n_layers,
               d_model=cfg.d_model, dtype=str(cfg.dtype),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, method="lotion int4 "
               "per-tensor, decoupled, lam=1e3", optimizer="fused AdamW, "
               "cosine warmup", params=sum(t.numel() for t in
                                           tree_leaves(state["params"])),
               setup_s=setup_s, steps=rows, eval_ce=ce, launches=counts,
               expected_launches=want,
               peak_memory_gib_train=train_peak / 2 ** 30,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"train phase failed its checks: {checks}")
    del state, train_step, eval_fn
    torch.cuda.empty_cache()
    return row


def _eligible(params):
    from repro_torch.core.policy import QuantPolicy, tree_map_with_path
    pol, out = QuantPolicy(), []
    tree_map_with_path(lambda p, x: out.append(p) if pol.eligible(p, x)
                       else None, params)
    return out


def tree_leaves(tree):
    from repro_torch.core.policy import tree_leaves as leaves
    return leaves(tree)


def train_loss_placement(dev, n_layers=8, steps=2):
    """Loss-side placement: the penalty through the lotion_reg kernel's
    autograd function (7 launches per step), the fused core with lam = 0
    (mode none, 11 launches per step)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.empty_cache()
    cfg, train_step, _, state = granite_trainer(dev, n_layers=n_layers,
                                                placement="loss")
    pipe, _ = _pipeline(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    mode_none = train_step.optimizer.meta["lam"] == 0.0
    reset_launch_counts()
    try:
        state, rows = _train_steps(train_step, state, pipe, steps)
    finally:
        pipe.close()
    counts = launch_counts()
    want = dict(counts, lotion_reg=7 * steps, opt_step=11 * steps, quant=0,
                wqt_matmul=0, decode_attn=0)
    penalties = [r.get("penalty", 0.0) for r in rows]
    row = dict(phase="train_loss_placement", model=cfg.name,
               n_layers=cfg.n_layers, d_model=cfg.d_model,
               dtype=str(cfg.dtype), steps=rows, launches=counts,
               expected_launches=want, opt_step_mode_none=mode_none)
    emit(row)
    if counts != want or not mode_none or not penalties[-1] > 0.0:
        raise AssertionError(f"loss-placement phase failed: {row}")
    del state, train_step
    torch.cuda.empty_cache()
    return row


# card against CPU: fp32 activations on both sides and TF32 off, so the two
# differ by summation order and by Adam's first steps on elements whose
# gradient is within rounding of zero: held at 1e-4 relative.  Step 1's
# loss precedes any update; steps 2 and 3 and the eval CEs follow the
# opt_step updates, and the RTN CE the quant cast
TRAIN_CPU_RTOL = 1e-4


def train_card_vs_cpu(dev, steps=3):
    from repro_torch.core.policy import tree_map_with_path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for side in ("cpu", "cuda"):
        d = torch.device("cpu") if side == "cpu" else dev
        cfg, train_step, eval_fn, state = granite_trainer(
            dev, n_layers=2, dtype="float32", seed=2)
        if side == "cpu":
            # the same random weights (drawn on the card), moved over; the
            # step and eval rebuilt for CPU tensors take the plain versions
            state = tree_map_with_path(
                lambda p, x: x.cpu() if torch.is_tensor(x) else x, state)
        pipe, val = _pipeline(cfg, d, 2, 128)
        state, rows = _train_steps(train_step, state, pipe, steps)
        pipe.close()
        out[side] = dict(losses=[r["loss"] for r in rows],
                         ce_fp32=float(eval_fn(state["params"], val)),
                         ce_rtn=float(eval_fn(state["params"], val, "rtn")))
        del state, train_step, eval_fn
    c, g = out["cpu"], out["cuda"]
    pairs = list(zip(c["losses"], g["losses"])) + [
        (c["ce_fp32"], g["ce_fp32"]), (c["ce_rtn"], g["ce_rtn"])]
    worst = max(abs(a - b) / abs(a) for a, b in pairs)
    row = dict(phase="train_card_vs_cpu", n_layers=2, dtype="float32",
               batch=2, seq=128, steps=steps, cpu=c, card=g,
               max_rel_diff=worst, rtol=TRAIN_CPU_RTOL)
    emit(row)
    if not worst <= TRAIN_CPU_RTOL:
        raise AssertionError("card and CPU training disagree", row)
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    emit(dict(phase="device", nvidia_smi=smi,
              device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))

    t0 = time.perf_counter()
    _build.lib()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              sources=[os.path.relpath(s, ROOT) for s in _build.sources()]))

    timer = Timer(dev)
    phases = {"wqt": lambda: check_wqt(timer, dev),
              "attn": lambda: check_attn(timer, dev),
              "paged": lambda: check_paged(timer, dev),
              "a8": lambda: check_a8(timer, dev),
              "wq": lambda: check_wq(timer, dev),
              "wq_path": lambda: wq_path(dev),
              "quant": lambda: check_quant(timer, dev),
              "lotion_reg": lambda: check_lotion_reg(timer, dev),
              "opt_step": lambda: check_opt_step(timer, dev),
              "serve": lambda: serve_full_width(dev),
              "serve_card_vs_cpu": lambda: card_vs_cpu(dev),
              "sched": lambda: sched_full_width(dev),
              "sched_ring_vs_paged": lambda: sched_ring_vs_paged(dev),
              "sched_card_vs_cpu": lambda: sched_card_vs_cpu(dev),
              "sched_chaos": lambda: sched_chaos(dev),
              "train": lambda: train_full_width(dev),
              "train_loss_placement": lambda: train_loss_placement(dev),
              "train_card_vs_cpu": lambda: train_card_vs_cpu(dev)}
    out = {}
    for name, run in phases.items():
        t0 = time.perf_counter()
        out[name] = run()
        emit(dict(phase="timing", of=name, seconds=time.perf_counter() - t0))
        if name in ("a8", "wq", "quant", "lotion_reg", "opt_step"):
            # the timer's flush buffer stays; the checks' inputs go
            torch.cuda.empty_cache()

    emit({"kernels": kernels_line(out)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _leaf_sum(rows, key, pick, eligible_only=False):
    """Sum of ``key`` over Granite-3-2B's leaves (only the policy-eligible
    ones with ``eligible_only``), each leaf taking the check row that
    ``pick(row, eligible)`` selects for its shape."""
    total = 0.0
    for shape, count, eligible in GRANITE_LEAVES:
        if eligible or not eligible_only:
            row = next(r for r in rows if r["shape"] == _fmt_shape(shape)
                       and pick(r, eligible))
            total += row[key] * count
    return total


def kernels_line(out):
    """One entry per ported kernel.  The serving kernels are timed at the
    serve phase's decode shapes (one Granite layer's 7 matmuls at M = batch
    8, int4 per-tensor, and one attention call); the training kernels over
    all of Granite-3-2B's leaves at the train phase's settings (int4,
    per-tensor scales; the 4 ineligible leaves run opt_step in mode none),
    summed from the check rows.  ``launches`` come from each kernel's own
    path: the serve phase, the train phase (opt_step, quant: the RTN and
    RR eval casts) and the loss-placement phase (lotion_reg).
    ``worst_err_over_tol`` is over every check row of the kernel."""
    wqt_rows, attn_rows, serve = out["wqt"], out["attn"], out["serve"]
    dec = {(r["N"], r["K"]): r for r in wqt_rows
           if r["M"] == 8 and r["bits"] == 4 and r["block_k"] == -1
           and r["dtype"] == "bfloat16" and (r["N"], r["K"]) in LAYER_MATMULS}

    b_bytes = sum(
        (8 * s[1] * 2 + s[0] * s[1] // 2 + 4 + 8 * s[0] * 2) * c
        for s, c in LAYER_MATMULS.items())
    b_flops = sum(2.0 * 8 * s[0] * s[1] * c for s, c in LAYER_MATMULS.items())
    wqt_bound, wqt_by = bound(b_bytes, b_flops)
    main_attn = next(r for r in attn_rows if r["L"] == 256 and r["bits"] == 8
                     and r["window"] is None and r["dtype"] == "bfloat16")
    lines = [
        dict(name="wqt_matmul", route="cuda",
             source="src/repro_torch/kernels/wq_matmul/csrc/wqt_matmul.cu",
             replaces="src/repro/kernels/wq_matmul/wq_matmul.py:279",
             path="serve", launches=serve["launches"]["wqt_matmul"],
             max_abs_err=max(dec[s]["max_abs_err"] for s in LAYER_MATMULS),
             tol="2^-7 (bf16) or 1e-5 (fp32) of the largest output",
             worst_err_over_tol=max(r["max_abs_err"] / r["tol"]
                                    for r in wqt_rows),
             shape="one decode layer: 7 matmuls, M=8, int4 per-tensor, bf16",
             ms=_layer_sum(dec, "ms"), plain_ms=_layer_sum(dec, "plain_ms"),
             bound_ms=wqt_bound, bound_by=wqt_by,
             library_ms=_layer_sum(dec, "library_ms")),
        dict(name="decode_attn", route="cuda",
             source="src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
             replaces="src/repro/kernels/decode_attn/decode_attn.py:123",
             path="serve", launches=serve["launches"]["decode_attn"],
             max_abs_err=main_attn["max_abs_err"],
             tol="2^-7 (bf16) or 1e-5 (fp32) of each (b, kv-head) row's "
                 "largest output",
             worst_err_over_tol=max(r["worst_err_over_tol"]
                                    for r in attn_rows),
             shape="b=8 g=8 rep=4 hd=64 L=256 int8, ragged and wrapped pos",
             ms=main_attn["ms"], plain_ms=main_attn["plain_ms"],
             bound_ms=main_attn["bound_ms"], bound_by=main_attn["bound_by"],
             library_ms=main_attn["library_ms"]),
    ]

    def rtn4(r, eligible):
        return (r["cast"] == "rtn" and r["fmt"] == "int4"
                and r["block_size"] == -1)

    def reg4(r, eligible):
        return r["fmt"] == "int4" and r["block_size"] == -1

    def opt4(r, eligible):
        return (r["fmt"] == "int4" and r["block_size"] == -1
                and r["core"] == "adamw" and r["ok"] == 1.0
                and r["mode"] == ("matrix" if eligible else "none"))

    def opt_lib(r, eligible):
        return r["mode"] == "none" and r["core"] == "adamw"

    def stats(rows, pick, lib_pick=None, eligible_only=False):
        def total(key, p=pick):
            return _leaf_sum(rows, key, p, eligible_only)
        return dict(ms=total("ms"), plain_ms=total("plain_ms"),
                    bound_ms=total("bound_ms"), bound_by="bytes",
                    library_ms=total("library_ms", lib_pick)
                    if lib_pick else None,
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    bitwise=all(r["bitwise"] for r in rows))

    lines += sched_kernel_lines(out)

    q, reg, opt = out["quant"], out["lotion_reg"], out["opt_step"]
    train, loss_ph = out["train"], out["train_loss_placement"]
    tol = "bitwise equal elementwise outputs"
    lines.append(dict(
        name="quant", route="cuda",
        source="src/repro_torch/kernels/quant/csrc/quant.cu",
        replaces="src/repro/kernels/quant/quant_blockwise.py:113",
        path="train (eval casts)", launches=train["launches"]["quant"],
        tol=tol, shape="one RTN cast of Granite-3-2B's 7 eligible leaves, "
        "int4 per-tensor, fp32",
        **stats(q, rtn4, rtn4, eligible_only=True)))
    lines.append(dict(
        name="lotion_reg", route="cuda",
        source="src/repro_torch/kernels/lotion_reg/csrc/lotion_reg.cu",
        replaces="src/repro/kernels/lotion_reg/lotion_reg.py:76",
        path="train_loss_placement",
        launches=loss_ph["launches"]["lotion_reg"],
        tol=tol + "; penalty within 1e-6 relative",
        shape="one step over Granite-3-2B's 7 eligible leaves, int4 "
        "per-tensor, fp32",
        **stats(reg, reg4, eligible_only=True)))
    step_dev = next(r["opt_step_device_ms"] for r in train["steps"]
                    if r.get("profiled"))
    lines.append(dict(
        name="opt_step", route="cuda",
        source="src/repro_torch/kernels/opt_step/csrc/opt_step.cu",
        replaces="src/repro/kernels/opt_step/opt_step.py:115",
        path="train", launches=train["launches"]["opt_step"],
        tol=tol + "; penalty within 1e-6 relative",
        shape="one AdamW step over all 11 leaves of Granite-3-2B (7 with "
        "the int4 per-tensor penalty), fp32",
        train_step_device_ms=step_dev,
        **stats(opt, opt4, opt_lib)))
    return lines


def _layer_sum(rows, key):
    """One Granite layer's 7 matmuls summed from the rows keyed (N, K);
    None when a row has no such number."""
    vals = [rows[sh][key] for sh in LAYER_MATMULS]
    if any(v is None for v in vals):
        return None
    return sum(v * c for v, c in zip(vals, LAYER_MATMULS.values()))


def sched_kernel_lines(out):
    """The scheduler path's kernels: ``wqt_matmul_a8`` timed over one
    decode layer's 7 matmuls (M = 8 slots, int4 per-tensor) and
    ``decode_attn_paged`` at b = 8, bs = 16, 16 blocks, int8, both
    launched by the ``sched`` phase; ``wq_matmul`` over the same 7 shapes
    (M = 8, int4, block 128), launched by its own ``wq_path``."""
    a8 = {(r["N"], r["K"]): r for r in out["a8"]
          if r["M"] == 8 and r["bits"] == 4 and r["block_k"] == -1}
    wq = {(r["N"], r["K"]): r for r in out["wq"]
          if r["M"] == 8 and r["bits"] == 4 and r["dtype"] == "bfloat16"
          and (r["N"], r["K"]) in LAYER_MATMULS}
    a8_bound = bound(sum((8 * k + 8 * 4 + n * k // 2 + 4 + 8 * n * 4) * c
                         for (n, k), c in LAYER_MATMULS.items()),
                     sum(2.0 * 8 * n * k * c
                         for (n, k), c in LAYER_MATMULS.items()), INT8_OPS)
    wq_bound = bound(sum((8 * k * 2 + n * k // 2 + (k // 128) * n * 4
                          + 8 * n * 2) * c
                         for (n, k), c in LAYER_MATMULS.items()),
                     sum(2.0 * 8 * n * k * c
                         for (n, k), c in LAYER_MATMULS.items()))
    paged = next(r for r in out["paged"] if r["bs"] == 16 and r["bits"] == 8
                 and r["window"] is None and r["dtype"] == "bfloat16")
    sched = out["sched"]
    return [
        dict(name="wqt_matmul_a8", route="cuda",
             source="src/repro_torch/kernels/wq_matmul/csrc/wqt_matmul_a8.cu",
             replaces="src/repro/kernels/wq_matmul/wq_matmul.py:215",
             path="sched", launches=sched["launches"]["wqt_matmul_a8"],
             max_abs_err=max(r["max_abs_err"] for r in out["a8"]),
             tol="bitwise equal to the plain version",
             bitwise=all(r["bitwise"] for r in out["a8"]),
             shape="one decode layer: 7 matmuls, M=8, int4 per-tensor, "
                   "int8 activations",
             ms=_layer_sum(a8, "ms"), plain_ms=_layer_sum(a8, "plain_ms"),
             bound_ms=a8_bound[0], bound_by=a8_bound[1],
             library_ms=_layer_sum(a8, "library_ms")),
        dict(name="decode_attn_paged", route="cuda",
             source="src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
             replaces="src/repro/kernels/decode_attn/decode_attn.py:249",
             path="sched", launches=sched["launches"]["decode_attn_paged"],
             max_abs_err=paged["max_abs_err"],
             tol="2^-7 (bf16) or 1e-5 (fp32) of each (b, kv-head) row's "
                 "largest output; bitwise equal to decode_attn on the "
                 "gathered view",
             worst_err_over_tol=max(r["worst_err_over_tol"]
                                    for r in out["paged"]),
             bitwise_vs_decode_attn=all(r["bitwise_vs_decode_attn"]
                                        for r in out["paged"]),
             shape="b=8 g=8 rep=4 hd=64, 16 shuffled blocks of 16, int8",
             ms=paged["ms"], plain_ms=paged["plain_ms"],
             bound_ms=paged["bound_ms"], bound_by=paged["bound_by"],
             library_ms=paged["library_ms"]),
        dict(name="wq_matmul", route="cuda",
             source="src/repro_torch/kernels/wq_matmul/csrc/wqt_matmul.cu",
             replaces="src/repro/kernels/wq_matmul/wq_matmul.py:98",
             path="wq_path", launches=out["wq_path"]["launches"]["wq_matmul"],
             max_abs_err=max(r["max_abs_err"] for r in wq.values()),
             tol="2^-7 (bf16) or 1e-5 (fp32) of the largest output",
             worst_err_over_tol=max(r["max_abs_err"] / r["tol"]
                                    for r in out["wq"]),
             shape="one decode layer: 7 matmuls, M=8, K-major int4, "
                   "block 128, bf16",
             ms=_layer_sum(wq, "ms"), plain_ms=_layer_sum(wq, "plain_ms"),
             bound_ms=wq_bound[0], bound_by=wq_bound[1],
             library_ms=_layer_sum(wq, "library_ms")),
    ]


if __name__ == "__main__":
    sys.exit(main())
