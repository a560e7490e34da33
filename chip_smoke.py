"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each kernel against its plain PyTorch version on the card at the
shapes its path gives it (and times kernel, plain version, a one-call
PyTorch yardstick where there is one and the least time the card could
take; ``wqt_matmul``, ``wq_matmul``, ``decode_attn`` and
``decode_attn_paged`` rows also name the instance that ran and its
splits, and check that two launches agree bit for bit; ``quant`` and
``opt_step`` are also held on adversarial leaves for their in-kernel
per-matrix absmax; the two W4A8 entries, ``wqt_matmul_a8`` from int8
codes and ``wqt_matmul_a8_x`` with the row quantizer inside, bitwise,
also on adversarial rows: zero, NaN, inf, ties, the absmax in the last K
split), drives the K-major
``wq_matmul`` (which no serving path reaches) through one layer's
matmuls, times one decode layer's 7 matmuls back to back for each (the
``layer`` rows; W4A8 beside the parent's composition of quantizer,
kernel and cast), then drives the ported paths with their launch counts
checked:

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
  the card and on the CPU from the same weights and batches (losses,
  per-step penalties and eval CEs compared);
* the paper's baselines: the straight-through estimators on the card
  (forward bitwise equal to the cast, gradient to the upstream one);
  full-width 40-layer QAT and RAT (3 steps each) with exact cast counts;
  RAT on 8 layers with and without int8 activations (the ``quant``
  kernel's bf16 instance, recomputed in backward); QAT and RAT on 2
  layers, card against CPU from the same uniforms, and RAT's two
  microbatches against one (one cast per step);
* serving what they train: RR-cast int4 QTensors (re-quantizing the
  cast is the identity, bitwise) through ``wqt_matmul`` and the dense
  fp4 cast, 4 layers, prefill logits against the CPU's;
* checkpoints and self-healing training: EF int8 gradient compression
  on 8 layers (``quant``'s block-256 instance, one launch per gradient
  leaf, bitwise against the plain version); crash-exact auto-resume on
  2 layers (bitwise) and a tampered payload refused by its crc32; the
  skip gate (a NaN step leaves the state bitwise unchanged) and the
  training chaos harness on 2 layers with one and two simulated hosts;
  the 40-layer state saved in the JAX checkpoint layout and loaded back
  in place (the next step bitwise), with save and load rates.

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
import shutil
import subprocess
import sys
import tempfile
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

    def __call__(self, fn, iters: int = 10, warmup: int = 2,
                 flushes: int = 1) -> float:
        """``flushes`` reads of the buffer before each launch: more keep
        the card busy while the host enqueues a longer ``fn``."""
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            for _ in range(flushes):
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
# decode (1, 8), the GEMV's edge (12, 16), the GEMM's first M (17), prefill
WQT_MS = (1, 8, 12, 16, 17, 64, 1024)
# beyond the main path: fp32 activations, and code rows that are not a
# multiple of 16 bytes (K = 1000), which take the scalar code loads; quant
# blocks of 32 (several per K step of the GEMV and the GEMM):
# (N, K, block_k, M values, dtype)
WQT_EXTRA = [(2048, 2048, 128, (1, 8, 64), torch.float32),
             (1000, 1000, 8, (1, 8, 130), torch.float32),
             (1000, 1000, -1, (1, 8, 130), torch.bfloat16),
             (1024, 1024, 32, (8, 40), torch.bfloat16)]
# the 7 weight matmuls of one Granite layer: (N, K) -> count
LAYER_MATMULS = {(2048, 2048): 2, (512, 2048): 2, (8192, 2048): 2,
                 (2048, 8192): 1}


def check_wqt_one(timer, gen, dev, qt, w_lib, *, m, n, k, bits, block_k,
                  dtype):
    from repro_torch.kernels.wq_matmul import wqt_matmul
    from repro_torch.kernels.wq_matmul.ops import launch_plan
    from repro_torch.kernels.wq_matmul.ref import wqt_matmul_ref
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    got = wqt_matmul(x, qt.codes, qt.scales, block_k, bits)
    again = wqt_matmul(x, qt.codes, qt.scales, block_k, bits)
    ref = wqt_matmul_ref(x, qt.codes, qt.scales, block_k, bits == 4)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    tol = rel_tol(dtype) * float(ref.float().abs().max())
    plan = launch_plan(x, qt.codes, block_k, bits)
    row = dict(phase="check", kernel="wqt_matmul", M=m, N=n, K=k, bits=bits,
               block_k=block_k, dtype=str(dtype).replace("torch.", ""),
               variant=plan.instance, splits=plan.splits,
               vec_loads=qt.codes.shape[1] % 16 == 0, max_abs_err=err,
               tol=tol, deterministic=bool(torch.equal(got, again)))
    if not (err <= tol and torch.isfinite(got).all()
            and row["deterministic"]):
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
    cases = [(n, k, bk, WQT_MS, torch.bfloat16)
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
    from repro_torch.kernels.decode_attn.ops import launch_plan
    q, k, v = _attn_inputs(gen, dev, b, L, g, rep, hd, bits, dtype)
    args = (k["codes"], k["scale"], v["codes"], v["scale"], pos)
    kw = dict(bits=bits, window=window, softcap=softcap)
    got = decode_attn(q, *args, **kw)
    again = decode_attn(q, *args, **kw)
    # the plain version in fp32 on the same (exactly upcast) inputs
    ref = decode_attn_ref(q.float(), *args, **kw)
    torch.cuda.synchronize()
    # each (b, g) row is held at its own scale: a row with one valid slot
    # returns v itself (about 3), a full ring of 4096 slots about 0.03
    err_bg = (got.float() - ref).abs().amax(dim=(2, 3))
    tol_bg = rel_tol(dtype) * ref.abs().amax(dim=(2, 3))
    worst = float((err_bg / tol_bg.clamp_min(1e-30)).max())
    err, tol = float(err_bg.max()), float(tol_bg.min())
    plan = launch_plan(q, k["codes"], v["codes"], L, bits)
    row = dict(phase="check", kernel="decode_attn", b=b, L=L, g=g, rep=rep,
               hd=hd, bits=bits, window=window, softcap=softcap,
               dtype=str(dtype).replace("torch.", ""), vec_loads=(
                   hd // 2 if bits == 4 else hd) % 16 == 0,
               variant=plan.instance, splits=plan.splits,
               slots_per_split=plan.slots_per_split, stages=plan.stages,
               blocks=plan.blocks, pos=pos.tolist(), max_abs_err=err,
               min_row_tol=tol, worst_err_over_tol=worst,
               deterministic=bool(torch.equal(got, again)))
    if not (bool((err_bg <= tol_bg).all()) and torch.isfinite(got).all()
            and row["deterministic"]):
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
    # one tile (L = 16), and a long ring where every row holds one slot
    # (pos = 0: all splits but the first are empty)
    rows.append(check_attn_one(timer, gen, dev, b=b, L=16, g=g, rep=rep,
                               hd=64, bits=8, window=None, softcap=None,
                               pos=ragged(16)))
    rows.append(check_attn_one(
        timer, gen, dev, b=b, L=4096, g=g, rep=rep, hd=64, bits=8,
        window=None, softcap=None,
        pos=torch.zeros(b, dtype=torch.int32, device=dev)))
    # beyond the main path (the fma instance): fp32 queries, and hd = 16
    # (int4 code rows of 8 bytes take the scalar code loads)
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
    from repro_torch.kernels.decode_attn.ops import launch_plan
    n_blocks = b * bps + 1                # block 0 is the never-read null
    # every row's blocks, shuffled over the pool
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(b, bps).to(torch.int32)
    q, k, v = _attn_inputs(gen, dev, n_blocks, bs, g, rep, hd, bits, dtype)
    q = q[:b].contiguous()
    args = (k["codes"], k["scale"], v["codes"], v["scale"], bt, pos)
    kw = dict(bits=bits, window=window, softcap=softcap)
    got = decode_attn_paged(q, *args, **kw)
    again = decode_attn_paged(q, *args, **kw)
    ref = decode_attn_paged_ref(q.float(), *args, **kw)
    view = [gather_pool_ref(t, bt) for t in args[:4]]
    ring = decode_attn(q, *view, pos, **kw)
    torch.cuda.synchronize()
    err_bg = (got.float() - ref).abs().amax(dim=(2, 3))
    tol_bg = rel_tol(dtype) * ref.abs().amax(dim=(2, 3))
    L = bps * bs
    plan = launch_plan(q, k["codes"], v["codes"], L, bits)
    row = dict(phase="check", kernel="decode_attn_paged", b=b, bs=bs, bps=bps,
               L=L, g=g, rep=rep, hd=hd, bits=bits, window=window,
               softcap=softcap, dtype=str(dtype).replace("torch.", ""),
               variant=plan.instance, splits=plan.splits,
               slots_per_split=plan.slots_per_split, stages=plan.stages,
               blocks=plan.blocks, pos=pos.tolist(),
               max_abs_err=float(err_bg.max()),
               min_row_tol=float(tol_bg.min()),
               worst_err_over_tol=float((err_bg / tol_bg.clamp_min(1e-30)).max()),
               bitwise_vs_decode_attn=bool(torch.equal(got, ring)),
               deterministic=bool(torch.equal(got, again)))
    if not (bool((err_bg <= tol_bg).all()) and torch.isfinite(got).all()
            and row["bitwise_vs_decode_attn"] and row["deterministic"]):
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
    # a long pool ring (4096 slots in 256 blocks of 16)
    L4 = 16 * 256
    rows.append(check_paged_one(
        timer, gen, dev, b=b, bs=16, bps=256, g=8, rep=4, hd=64, bits=8,
        window=None, softcap=None,
        pos=torch.tensor([0, 5, L4 // 3, L4 - 1, L4, L4 + 7, 2 * L4 + 3,
                          5 * L4 - 2], dtype=torch.int32, device=dev)))
    # beyond the main path: blocks that divide neither the 64-slot tile nor
    # the split (bs = 24 and 48; splits of 64 slots), and fp32 queries
    rows.append(check_paged_one(timer, gen, dev, b=b, bs=24, bps=11, g=8,
                                rep=4, hd=64, bits=8, window=None,
                                softcap=None, pos=pos % (24 * 11 * 3)))
    rows.append(check_paged_one(timer, gen, dev, b=b, bs=48, bps=6, g=8,
                                rep=4, hd=64, bits=4, window=100,
                                softcap=50.0, pos=pos % (48 * 6 * 3)))
    rows.append(check_paged_one(timer, gen, dev, b=b, bs=bs, bps=bps, g=8,
                                rep=4, hd=64, bits=4, window=64, softcap=50.0,
                                pos=pos, dtype=torch.float32))
    return rows


# --------------------------------------------------------------------------
# phase 3b'': wqt_matmul_a8 / wqt_matmul_a8_x (W4A8) and wq_matmul
# (K-major) against their plain versions at the seven matmul shapes of a
# Granite layer
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
               bits=bits, block_k=block_k, **_a8_plan_fields(xq, qt, block_k),
               bitwise=same, max_abs_err=float((got - ref).abs().max()))
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


def _a8_plan_fields(x, qt, block_k):
    from repro_torch.kernels.wq_matmul.ops import a8_plan
    p = a8_plan(x.shape[0], qt.codes.shape[0], x.shape[1], block_k, qt.bits,
                x.element_size())
    return dict(variant=f"mma_s8 {p.tile_m}x{p.tile_n}", splits=p.splits)


def _composed_a8(x, qt):
    """The parent's serving composition of a W4A8 matmul: the plain row
    quantizer, the integer matmul from codes, the cast to x's dtype."""
    from repro_torch.kernels.wq_matmul import quantize_acts_ref, wqt_matmul_a8
    xq, xs = quantize_acts_ref(x)
    return wqt_matmul_a8(xq, xs, qt.codes, qt.scales, qt.block_k,
                         qt.bits).to(x.dtype)


def check_a8_x_one(timer, gen, dev, *, m, n, k, bits, block_k):
    """``wqt_matmul_a8_x`` (row quantizer inside) against its plain
    version, bitwise; timed beside the parent-style composition."""
    from repro_torch.core.qtensor import quantize_qtensor
    from repro_torch.kernels.wq_matmul import (wqt_matmul_a8_x,
                                               wqt_matmul_a8_x_ref)
    w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
    qt = quantize_qtensor(w, f"int{bits}", block_k)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    args = (x, qt.codes, qt.scales, block_k)
    got = wqt_matmul_a8_x(*args, bits)
    ref = wqt_matmul_a8_x_ref(*args, bits == 4)
    torch.cuda.synchronize()
    same = _same_bits(got, ref)
    row = dict(phase="check", kernel="wqt_matmul_a8_x", M=m, N=n, K=k,
               bits=bits, block_k=block_k, dtype="bfloat16",
               **_a8_plan_fields(x, qt, block_k), bitwise=same,
               max_abs_err=float((got.float() - ref.float()).abs().max()))
    if not (same and torch.isfinite(got).all()):
        emit(row)
        raise AssertionError(f"wqt_matmul_a8_x disagrees: {row}")
    nbytes = x.numel() * 2 + qt.nbytes + m * n * 2
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k, INT8_OPS)
    row.update(ms=timer(lambda: wqt_matmul_a8_x(*args, bits)),
               composed_ms=timer(lambda: _composed_a8(x, qt)),
               plain_ms=timer(lambda: wqt_matmul_a8_x_ref(*args, bits == 4),
                              iters=3),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    emit(row)
    return row


A8_X_MS = (1, 8, 16, 128)


def check_a8(timer, dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = [check_a8_one(timer, gen, dev, m=m, n=n, k=k, bits=bits,
                         block_k=bk)
            for (n, k) in LAYER_MATMULS for bits in (4, 8)
            for bk in (-1, 128) for m in A8_MS]
    rows += [check_a8_x_one(timer, gen, dev, m=m, n=n, k=k, bits=bits,
                            block_k=bk)
             for (n, k) in LAYER_MATMULS for bits in (4, 8)
             for bk in (-1, 128) for m in A8_X_MS]
    return rows + check_a8_adversarial(dev)


def _adversarial_acts(gen, dev, m, k, dtype, split_k):
    """Rows that stress the in-kernel row quantizer: 0 all zero, 1 a NaN,
    2 a +inf, 3 a -inf, 4 on .5 ties after scaling (absmax 127 / 4, the
    rest multiples of 1/8), 5 its absmax at K's last element, 6 its
    absmax at the first element of the last K split (``split_k``), 7 and
    on ordinary."""
    x = torch.randn((m, k), generator=gen, device=dev)
    x[0] = 0.0
    x[1, k // 3] = float("nan")
    x[2, 5] = float("inf")
    x[3, k - 9] = float("-inf")
    x[4] = torch.round(torch.rand((k,), generator=gen, device=dev) * 240
                       - 120) / 8
    x[4, k // 2] = 127 / 4
    x[5, k - 1] = 11.0
    x[6, split_k] = -12.0
    return x.to(dtype)


def check_a8_adversarial(dev):
    """Both W4A8 entries on adversarial rows (``_adversarial_acts``) at
    two Granite shapes, bitwise (NaN places aside) against their plain
    versions: what a wrong absmax combine or code cast in the kernel
    fails.  M = 16 also puts the rows in the second n8 tile."""
    from repro_torch.core.qtensor import quantize_qtensor
    from repro_torch.kernels.wq_matmul import (quantize_acts_ref,
                                               wqt_matmul_a8,
                                               wqt_matmul_a8_ref,
                                               wqt_matmul_a8_x,
                                               wqt_matmul_a8_x_ref)
    from repro_torch.kernels.wq_matmul.ops import a8_plan
    gen = torch.Generator(device=dev).manual_seed(17)
    rows, failed = [], []
    for (n, k) in ((2048, 2048), (2048, 8192)):
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        for bits in (4, 8):
            for block_k in (-1, 128):
                qt = quantize_qtensor(w, f"int{bits}", block_k)
                for dtype in (torch.bfloat16, torch.float32):
                    for m in (8, 16):
                        p = a8_plan(m, n, k, block_k, bits,
                                    torch.empty((), dtype=dtype).element_size())
                        x = _adversarial_acts(
                            gen, dev, m, k, dtype,
                            (p.splits - 1) * p.k_per_split)
                        if m == 16:
                            x = x.roll(8, dims=0)
                        args = (qt.codes, qt.scales, block_k)
                        got = wqt_matmul_a8_x(x, *args, bits)
                        ref = wqt_matmul_a8_x_ref(x, *args, bits == 4)
                        xq, xs = quantize_acts_ref(x)
                        got8 = wqt_matmul_a8(xq, xs, *args, bits)
                        ref8 = wqt_matmul_a8_ref(xq, xs, *args, bits == 4)
                        torch.cuda.synchronize()
                        err, same, _ = _bitwise(
                            [("x", got.float(), ref.float()),
                             ("codes", got8, ref8)])
                        row = dict(phase="check", kernel="wqt_matmul_a8_x",
                                   adversarial=True, M=m, N=n, K=k, bits=bits,
                                   block_k=block_k,
                                   dtype=str(dtype).replace("torch.", ""),
                                   **_a8_plan_fields(x, qt, block_k),
                                   bitwise=same and _same_bits(got, ref),
                                   max_abs_err=err)
                        emit(row)
                        rows.append(row)
                        if not row["bitwise"]:
                            failed.append(row)
    emit(dict(phase="a8_adversarial", rows=len(rows), failed=len(failed),
              max_abs_err=max(r["max_abs_err"] for r in rows)))
    if failed:
        raise AssertionError(
            "wqt_matmul_a8 disagrees on adversarial rows",
            dict(failed=len(failed), max_abs_err=max(
                r["max_abs_err"] for r in failed)))
    return rows


def check_wq_one(timer, gen, dev, *, m, n, k, bits, block_k=128,
                 dtype=torch.bfloat16):
    from repro_torch.kernels.wq_matmul import (dequant_ref, pack_weight,
                                               wq_matmul, wq_matmul_ref)
    from repro_torch.kernels.wq_matmul.ops import launch_plan
    w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
    codes, scales = pack_weight(w, block_k, bits)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    got = wq_matmul(x, codes, scales, block_k, bits)
    again = wq_matmul(x, codes, scales, block_k, bits)
    ref = wq_matmul_ref(x, codes, scales, block_k, bits == 4)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    tol = rel_tol(dtype) * float(ref.float().abs().max())
    plan = launch_plan(x, codes, block_k, bits, kmajor=True)
    row = dict(phase="check", kernel="wq_matmul", M=m, N=n, K=k, bits=bits,
               block_k=block_k, dtype=str(dtype).replace("torch.", ""),
               variant=plan.instance, splits=plan.splits, max_abs_err=err,
               tol=tol, deterministic=bool(torch.equal(got, again)))
    if not (err <= tol and torch.isfinite(got).all()
            and row["deterministic"]):
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


# the decode edge (12), the GEMV's last M (16), the GEMM's first (17)
WQ_MS = (8, 12, 16, 17, 128)


def check_wq(timer, dev):
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = [check_wq_one(timer, gen, dev, m=m, n=n, k=k, bits=bits)
            for (n, k) in LAYER_MATMULS for bits in (4, 8) for m in WQ_MS]
    # beyond the main shapes: fp32 activations and a ragged N (scalar
    # loads); quant blocks of 16 in the GEMV and the GEMM
    rows.append(check_wq_one(timer, gen, dev, m=8, n=1000, k=1024, bits=4,
                             block_k=64, dtype=torch.float32))
    rows.append(check_wq_one(timer, gen, dev, m=130, n=1000, k=1024, bits=8,
                             block_k=64, dtype=torch.float32))
    rows.append(check_wq_one(timer, gen, dev, m=8, n=1024, k=1024, bits=4,
                             block_k=16))
    rows.append(check_wq_one(timer, gen, dev, m=40, n=1024, k=1024, bits=8,
                             block_k=16))
    return rows


def layer_rows(timer, dev):
    """One Granite layer's 7 weight matmuls at M = 8 (bf16 x) launched back
    to back between one pair of events after one L2 flush, as a decode
    step meets them (no per-call floor counted seven times), for each
    kernel and for its library call (``torch.matmul`` on the dequantized
    bf16 weights): ``wqt_matmul`` on int4 per-tensor out-major codes,
    ``wq_matmul`` on K-major int4 codes with block 128; and W4A8 on the
    same codes, ``wqt_matmul_a8_x`` (quantizer inside) against the
    parent's composition of each call (``_composed_a8``: the plain row
    quantizer, ``wqt_matmul_a8`` from codes, the cast).  Four flush reads
    (about 0.6 ms of device work) cover the host's enqueue of 7 calls,
    sixteen that of the composition's 7 x 15 launches."""
    from repro_torch.core.qtensor import quantize_qtensor
    from repro_torch.kernels.wq_matmul import (dequant_ref, dequant_t_ref,
                                               pack_weight, wq_matmul,
                                               wqt_matmul, wqt_matmul_a8_x)
    gen = torch.Generator(device=dev).manual_seed(10)
    x = {k: torch.randn((8, k), generator=gen, device=dev).to(torch.bfloat16)
         for k in {s[1] for s in LAYER_MATMULS}}
    mats = [s for s, c in LAYER_MATMULS.items() for _ in range(c)]
    ws = [torch.randn(s, generator=gen, device=dev) / math.sqrt(s[1])
          for s in mats]
    qts = [quantize_qtensor(w, "int4", -1) for w in ws]
    kn = [pack_weight(w.T.contiguous(), 128, 4) for w in ws]
    lib_t = [dequant_t_ref(q.codes, q.scales, -1, True).to(torch.bfloat16)
             for q in qts]
    lib_k = [dequant_ref(c, s, 128, True).to(torch.bfloat16) for c, s in kn]
    del ws

    def wqt():
        for (_, k), q in zip(mats, qts):
            wqt_matmul(x[k], q.codes, q.scales, -1, 4)

    def wqt_lib():
        for (_, k), w in zip(mats, lib_t):
            torch.matmul(x[k], w.T)

    def wq():
        for (_, k), (c, s) in zip(mats, kn):
            wq_matmul(x[k], c, s, 128, 4)

    def wq_lib():
        for (_, k), w in zip(mats, lib_k):
            torch.matmul(x[k], w)

    def a8():
        for (_, k), q in zip(mats, qts):
            wqt_matmul_a8_x(x[k], q.codes, q.scales, -1, 4)

    def a8_composed():
        for (_, k), q in zip(mats, qts):
            _composed_a8(x[k], q)

    rows = []
    for name, run, lib in (("wqt_matmul", wqt, wqt_lib),
                           ("wq_matmul", wq, wq_lib)):
        row = dict(phase="layer", kernel=name, M=8, matmuls=len(mats),
                   ms=timer(run, flushes=4),
                   library_ms=timer(lib, flushes=4))
        emit(row)
        rows.append(row)
    row = dict(phase="layer", kernel="wqt_matmul_a8_x", M=8,
               matmuls=len(mats), ms=timer(a8, flushes=4),
               composed_ms=timer(a8_composed, flushes=16), library_ms=None)
    emit(row)
    rows.append(row)
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
# EF gradient compression's cast (train/compress.py): blockwise int8 RTN of
# every gradient leaf, at the shapes of Granite-3-2B's 11 leaves
EF_FMT, EF_BLOCK = "int8", 256
EF_SHAPES = [s for s, _, _ in GRANITE_LEAVES]


def _fmt_shape(shape):
    return "x".join(map(str, shape))


def _same_bits(a, b):
    """Bit for bit (so -0.0 is not 0.0), where a NaN matches a NaN at the
    same place whatever its payload."""
    na, nb = torch.isnan(a), torch.isnan(b)
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0.0).view(bits), b.masked_fill(nb, 0.0).view(bits))


def _bitwise(pairs):
    """Largest |a - b| (NaN places aside) over (name, got, want) triples
    and whether every pair is bitwise equal (``_same_bits``)."""
    err, same, bad = 0.0, True, []
    for name, a, b in pairs:
        eq = _same_bits(a, b)
        if not eq:
            bad.append(name)
            d = (a.float() - b.float()).abs()
            err = max(err, float(d.masked_fill(d.isnan(), 0.0).max()))
        same = same and eq
    return err, same, bad


def _pen_rel(got, want):
    """Relative error of a penalty; two NaNs agree."""
    if math.isnan(float(got)) and math.isnan(float(want)):
        return 0.0
    return float((got - want).abs() / want.abs().clamp_min(1e-30))


# Adversarial leaves for the per-matrix absmax phase, planted into randn *
# 0.02 weights viewed as (n_matrices, mat_numel) (a plan's chunk walk is
# given for the call checked):
#   max_last / max_first: every matrix's largest |w| at its last (negative)
#     or first element;
#   max_boundary: at the first element of a matrix's last chunk (even
#     matrices) or the last element before it (odd), a block's chunk
#     boundary of the plan;
#   zero: matrix 0 all zero, every other element -0.0 (scale 1);
#   nan: a NaN at the first element of the last matrix's last chunk (the
#     matrix's absmax is NaN, its scale 1, as torch's amax gives).
ADVERSARIAL = ("max_last", "max_first", "max_boundary", "zero", "nan")
ADVERSARIAL_SHAPES = [(40, 2048, 8192), (40, 2048)]
# the normed block inputs of a full-width training step (batch 4 x 1024,
# d_model 2048) that LMConfig.act_fmt fake-quantizes, one scale per row
ACT_SHAPE = (4, 1024, 2048)


def _plant(w, kind, plan):
    from repro_torch.kernels.quant import ops as quant_ops
    v = w.view(-1, quant_ops.matrix_numel(w))
    last = (plan.chunks - 1) * plan.chunk
    if kind == "max_last":
        v[:, -1] = -1.0
    elif kind == "max_first":
        v[:, 0] = 1.0
    elif kind == "max_boundary":
        for m in range(v.shape[0]):
            v[m, max(last - m % 2, 0)] = 1.0
    elif kind == "zero":
        v[0] = 0.0
        v[0, 1::2] = -0.0
    elif kind == "nan":
        v[-1, last] = float("nan")
    else:
        raise ValueError(kind)
    return w


def _elem_bound(kernel, n, nbytes):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = OPS_PER_ELEM[kernel] * n / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_quant_one(timer, gen, dev, shape, fmt, bs, rr, adversarial=None,
                    dtype=torch.float32):
    """One check row; with ``adversarial`` (per-matrix scales) the leaf
    gets that planted case and the row is checked, not timed.  ``dtype``
    bf16 is the bf16 instance (per-matrix RTN, activations)."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.quantize import matrix_scales
    from repro_torch.kernels.quant import quant_rr, quant_rtn, rr_ref, rtn_ref
    from repro_torch.kernels.quant import ops as quant_ops
    w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
    u = torch.rand(shape, generator=gen, device=dev) if rr else None
    plan = quant_ops.launch_plan(w, fmt, rr) if bs == -1 else None
    if adversarial:
        _plant(w, adversarial, plan)
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
               dtype=str(dtype).replace("torch.", ""),
               adversarial=adversarial, bitwise=same, max_abs_err=err,
               blocks=plan.blocks if plan else None)
    if not same or adversarial:
        emit(row)
    if not same:
        raise AssertionError("quant disagrees", row)
    if adversarial:
        return row
    del got, want
    b_ms, b_by = _elem_bound("quant", n,
                             n * w.element_size() * (3 if rr else 2))
    library_ms = library_with_scale_ms = None
    if not rr and bs == -1 and fmt.startswith("int") \
            and dtype == torch.float32:
        qmax = 2 ** (int(fmt[3:]) - 1) - 1
        library_ms = timer(lambda: torch.fake_quantize_per_tensor_affine(
            w, 0.01, 0, -qmax, qmax))
        # the same function: the per-matrix scales, then the cast
        f, mats = get_format(fmt), w.view(-1, quant_ops.matrix_numel(w))
        zp = torch.zeros(mats.shape[0], dtype=torch.int32, device=dev)
        library_with_scale_ms = timer(
            lambda: torch.fake_quantize_per_channel_affine(
                mats, matrix_scales(w, f), zp, 0, -qmax, qmax))
    row.update(ms=timer(run), plain_ms=timer(plain, iters=3),
               library_ms=library_ms,
               library_with_scale_ms=library_with_scale_ms, bound_ms=b_ms,
               bound_by=b_by)
    emit(row)
    return row


def check_quant_adversarial(dev, casts=(False, True)):
    """The adversarial per-matrix rows (int4, RTN and RR in fp32; the bf16
    instance's RTN at the activation shape and a weight shape, int4 and
    int8); raises AssertionError(message, summary) after all of them if
    any disagrees."""
    gen = torch.Generator(device=dev).manual_seed(13)
    rows, failed = [], []
    cases = [(shape, "int4", rr, torch.float32)
             for shape in ADVERSARIAL_SHAPES for rr in casts]
    if False in casts:
        cases += [(shape, fmt, False, torch.bfloat16)
                  for shape in (ACT_SHAPE, ADVERSARIAL_SHAPES[0])
                  for fmt in ("int4", "int8")]
    for shape, fmt, rr, dtype in cases:
        for kind in ADVERSARIAL:
            try:
                rows.append(check_quant_one(None, gen, dev, shape, fmt, -1,
                                            rr, adversarial=kind,
                                            dtype=dtype))
            except AssertionError as e:
                rows.append(e.args[1])
                failed.append(f"{'rr' if rr else 'rtn'} {fmt} "
                              f"{_fmt_shape(shape)} {dtype} {kind}")
    torch.cuda.empty_cache()
    return _adversarial_summary("quant", rows, failed)


def _adversarial_summary(kernel, rows, failed):
    """One summary line of a kernel's adversarial rows; returned with the
    rows under "rows", or raised with them."""
    row = dict(phase="check_adversarial", kernel=kernel, n_rows=len(rows),
               failed=failed, bitwise=not failed,
               max_abs_err=max(r["max_abs_err"] for r in rows))
    emit(row)
    row["rows"] = rows
    if failed:
        raise AssertionError(f"{kernel}: adversarial rows disagree", row)
    return row


def check_quant(timer, dev):
    rows = check_quant_adversarial(dev)["rows"]
    gen = torch.Generator(device=dev).manual_seed(3)
    for fmt in ("int8", "int4"):         # the bf16 instance: activations
        rows.append(check_quant_one(timer, gen, dev, ACT_SHAPE, fmt, -1,
                                    False, dtype=torch.bfloat16))
    for shape in CHECK_SHAPES:
        for bs in (-1, 128):
            rows.append(check_quant_one(timer, gen, dev, shape, "int4", bs,
                                        False))
        rows.append(check_quant_one(timer, gen, dev, shape, "int4", -1, True))
    for shape in EF_SHAPES:
        rows.append(check_quant_one(timer, gen, dev, shape, EF_FMT, EF_BLOCK,
                                    False))
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
                  momentum=0.0, fisher_decay=None, ok=1.0, adversarial=None):
    """One check row; with ``adversarial`` (per-matrix scales) w gets that
    planted case and the row is checked, not timed."""
    from repro_torch.kernels.opt_step import fused_opt_step_leaf, opt_step_ref
    from repro_torch.kernels.opt_step import ops as opt_ops
    w = torch.randn(shape, generator=gen, device=dev) * 0.02
    plan = (opt_ops.launch_plan(w, lam=lam, fmt_name=fmt, core=core,
                                momentum=momentum, fisher_decay=fisher_decay)
            if bs == -1 else None)
    if adversarial:
        _plant(w, adversarial, plan)
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
    pen_rel = _pen_rel(got[3], want[3]) if lam else 0.0
    n = w.numel()
    mode = "none" if lam == 0.0 else "matrix" if bs == -1 else "block"
    row = dict(phase="check", kernel="opt_step", shape=_fmt_shape(shape),
               fmt=fmt, block_size=bs, mode=mode, core=core, ok=ok,
               momentum=momentum, fisher_decay=fisher_decay,
               adversarial=adversarial, bitwise=same, not_bitwise=bad,
               max_abs_err=err, penalty=float(got[3]),
               penalty_rel_err=pen_rel,
               blocks=plan.blocks if plan else None)
    if not (same and pen_rel <= PENALTY_RTOL) or adversarial:
        emit(row)
    if not (same and pen_rel <= PENALTY_RTOL):
        raise AssertionError("opt_step disagrees", row)
    if adversarial:
        return row
    del got, want, w_k, mu_k, nu_k
    # w and g, plus each moment the core keeps: read once, written once
    # (and nu read as the Fisher where SGD keeps no EMA); with ok = 0 the
    # step is the identity and needs only the flag
    moments = (2 if core == "adamw"
               else int(bool(momentum)) + int(fisher_decay is not None))
    nu_read = int(core == "sgd" and fisher_decay is None and lam != 0.0)
    b_ms, b_by = (_elem_bound("opt_step", n,
                              n * 4 * (3 + 2 * moments + nu_read))
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


def check_opt_adversarial(dev):
    """The adversarial rows of the per-matrix AdamW step (int4, lam 1e3);
    raises AssertionError(message, summary) after all of them if any
    disagrees."""
    gen = torch.Generator(device=dev).manual_seed(15)
    rows, failed = [], []
    for shape in ADVERSARIAL_SHAPES:
        for kind in ADVERSARIAL:
            try:
                rows.append(check_opt_one(None, gen, dev, shape, "int4", -1,
                                          adversarial=kind))
            except AssertionError as e:
                rows.append(e.args[1])
                failed.append(f"{_fmt_shape(shape)} {kind}")
    torch.cuda.empty_cache()
    return _adversarial_summary("opt_step", rows, failed)


def check_opt_step(timer, dev):
    rows = check_opt_adversarial(dev)["rows"]
    gen = torch.Generator(device=dev).manual_seed(5)
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
        raise AssertionError("card and CPU logits disagree", row)
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
                    placement="decoupled", lam=1e3, seed=0, method="lotion",
                    act_fmt=None, n_microbatches=1, rat_uniforms=None,
                    ef_compress=False, chaos=False, lr=3e-3):
    """The training path's workload: Granite-3-2B at full width (depth
    ``n_layers`` if given), random fp32 master weights from ``seed``,
    ``dtype`` activations (fake-quantized under ``act_fmt``); ``method``
    int4 per-tensor (LOTION at ``lam`` with the given penalty placement,
    or the QAT/RAT baselines: RAT from ``rat_uniforms(step)`` or the
    per-step generator of ``seed``); AdamW on a cosine schedule with
    warmup to ``lr``, fused into the opt_step core (with ``ef_compress`` the
    unfused chain with EF int8 gradient compression); with ``chaos`` the
    loss carries the chaos harness's poison seam and the state its
    ``lr_scale`` leaf.  Returns (cfg, train_step, eval_fn, state)."""
    from repro_torch.configs import get_config
    from repro_torch.core.modes import QuantConfig
    from repro_torch.models.lm import lm_init
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.train import (TrainConfig, init_state, make_eval_fn,
                                   make_optimizer, make_train_step)
    cfg = dataclasses.replace(get_config("granite-3-2b"), dtype=dtype,
                              act_fmt=act_fmt)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    qcfg = QuantConfig(method=method, fmt_name="int4", block_size=-1,
                       lam=lam if method == "lotion" else 0.0,
                       penalty_placement=placement)
    tcfg = TrainConfig(quant=qcfg, clip_norm=1.0,
                       n_microbatches=n_microbatches, seed=seed,
                       ef_compress=ef_compress)
    opt = make_optimizer(tcfg, adamw(cosine_with_warmup(lr, 5, 100)))
    state = init_state(lm_init(cfg, seed=seed, device=dev), opt,
                       lr_scale=chaos)
    loss_fn = None
    if chaos:
        from repro_torch.train.faults import chaos_loss_fn
        loss_fn = chaos_loss_fn(cfg, tcfg)
    return (cfg, make_train_step(cfg, tcfg, opt, loss_fn=loss_fn,
                                 rat_uniforms=rat_uniforms),
            make_eval_fn(cfg, qcfg), state)


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
# The per-step decoupled penalty (opt_step's output) on its own bound.  The
# sound card and CPU runs agree to 9.6e-8 relative (one fp32 ulp at step 2,
# equal at steps 1 and 3; NVIDIA H100 80GB HBM3 at 700 W); 1e-5 leaves 100x
# that for other cards and builds, while dropping the penalty (or the
# update) on the card reads 1.0.
TRAIN_CPU_PENALTY_RTOL = 1e-5


def _rel(a, b):
    return abs(a - b) / abs(a) if a else abs(b)


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
                         penalties=[r["penalty"] for r in rows],
                         ce_fp32=float(eval_fn(state["params"], val)),
                         ce_rtn=float(eval_fn(state["params"], val, "rtn")))
        del state, train_step, eval_fn
    c, g = out["cpu"], out["cuda"]
    pairs = list(zip(c["losses"], g["losses"])) + [
        (c["ce_fp32"], g["ce_fp32"]), (c["ce_rtn"], g["ce_rtn"])]
    worst = max(_rel(a, b) for a, b in pairs)
    pen_worst = max(_rel(a, b) for a, b in zip(c["penalties"],
                                                g["penalties"]))
    row = dict(phase="train_card_vs_cpu", n_layers=2, dtype="float32",
               batch=2, seq=128, steps=steps, cpu=c, card=g,
               max_rel_diff=worst, rtol=TRAIN_CPU_RTOL,
               penalty_max_rel_diff=pen_worst,
               penalty_rtol=TRAIN_CPU_PENALTY_RTOL)
    emit(row)
    if not (worst <= TRAIN_CPU_RTOL
            and pen_worst <= TRAIN_CPU_PENALTY_RTOL):
        raise AssertionError("card and CPU training disagree", row)
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# phase 7: the paper's QAT and RAT baselines (straight-through estimators
# on the quant kernel) and serving what they train (RR QTensors, dense
# casts)
# --------------------------------------------------------------------------

STE_SHAPE = (40, 2048, 8192)     # Granite-3-2B's stacked w_up / w_gate


def check_ste(dev):
    """The straight-through estimators on the card: the forward value
    bitwise equal to ``quant_rtn`` / ``quant_rr`` on the same input and
    the gradient reaching ``w`` bitwise equal to the upstream gradient,
    for a stacked (40, 2048, 8192) fp32 leaf (RTN and RR, int4) and the
    bf16 activations of a training step (RTN, int8)."""
    from repro_torch.core import ste
    from repro_torch.kernels.quant import quant_rr, quant_rtn
    gen = torch.Generator(device=dev).manual_seed(21)
    rows, failed = [], []
    for shape, dtype, cast, fmt in ((STE_SHAPE, torch.float32, "rtn", "int4"),
                                    (STE_SHAPE, torch.float32, "rr", "int4"),
                                    (ACT_SHAPE, torch.bfloat16, "rtn",
                                     "int8")):
        w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
        w.requires_grad_(True)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        if cast == "rr":
            u = torch.rand(shape, generator=gen, device=dev)
            q = ste.fake_quant_rr(w, fmt, u, -1)
            want = quant_rr(w.detach(), u, fmt, -1)
            del u
        else:
            q = ste.fake_quant_rtn(w, fmt, -1)
            want = quant_rtn(w.detach(), fmt, -1)
        q.backward(g)
        torch.cuda.synchronize()
        fwd = _same_bits(q.detach(), want)
        grad = w.grad is not None and _same_bits(w.grad, g)
        row = dict(phase="check_ste", shape=_fmt_shape(shape),
                   dtype=str(dtype).replace("torch.", ""), cast=cast,
                   fmt=fmt, forward_bitwise=fwd, grad_bitwise=grad)
        emit(row)
        rows.append(row)
        if not (fwd and grad):
            failed.append(f"{cast} {row['shape']} {row['dtype']}")
        del w, g, q, want
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("the STE disagrees", dict(
            phase="check_ste", failed=failed, rows=rows))
    return rows


def _baseline_run(dev, method, *, steps, n_layers=None, act_fmt=None):
    """``method`` (qat or rat) int4 per-tensor training of Granite-3-2B at
    full width, then the fp32, RTN and RR eval CE, with its launch counts
    checked exactly: per step 7 weight casts (``quant_rtn`` for QAT,
    ``quant_rr`` for RAT) and 11 ``opt_step`` launches; under ``act_fmt``
    2 activation casts per layer and forward (the bf16 instance), whose
    forward recomputation in backward (``cfg.remat``) casts again; the RTN
    and RR evals 7 casts each plus their forwards' activation casts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.quant import quant_rr, quant_rtn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, train_step, eval_fn, state = granite_trainer(
        dev, n_layers=n_layers, method=method, act_fmt=act_fmt)
    pipe, val = _pipeline(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_leaves = len(tree_leaves(state["params"]))
    n_eligible = len(_eligible(state["params"]))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        state, rows = _train_steps(train_step, state, pipe, steps)
    finally:
        pipe.close()
    train_peak = torch.cuda.max_memory_allocated()
    ce = {"fp32": float(eval_fn(state["params"], val)),
          "rtn": float(eval_fn(state["params"], val, "rtn")),
          "rr": float(eval_fn(state["params"], val, "rr",
                              generator=torch.Generator(device=dev)
                              .manual_seed(1)))}
    counts = launch_counts()
    got = {"quant_rtn": quant_rtn.launches, "quant_rr": quant_rr.launches}
    acts = 2 * cfg.n_layers if act_fmt else 0
    act_train = acts * (2 if cfg.remat else 1)
    per_step = {"quant_rtn": act_train, "quant_rr": 0}
    per_step["quant_rtn" if method == "qat" else "quant_rr"] += n_eligible
    want_casts = {"quant_rtn": steps * per_step["quant_rtn"] + n_eligible
                  + 3 * acts,
                  "quant_rr": steps * per_step["quant_rr"] + n_eligible}
    want = dict.fromkeys(counts, 0)
    want.update(opt_step=n_leaves * steps, quant=sum(want_casts.values()))
    checks = {"counts": counts == want, "casts": got == want_casts,
              "leaves": (n_leaves, n_eligible) == (11, 7),
              "ce_finite": all(map(math.isfinite, ce.values()))}
    row = dict(method=f"{method} int4 per-tensor", act_fmt=act_fmt,
               n_layers=cfg.n_layers, setup_s=setup_s, steps=rows,
               step_ms=[r["step_ms"] for r in rows], eval_ce=ce,
               launches=counts, expected_launches=want, casts=got,
               expected_casts=want_casts,
               # the bf16 instance's: all quant_rtn launches but the
               # weights' (QAT's per step, the RTN eval's)
               act_cast_launches=got["quant_rtn"] - n_eligible * (
                   1 + (steps if method == "qat" else 0)),
               peak_memory_gib_train=train_peak / 2 ** 30,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               checks=checks)
    del state, train_step, eval_fn
    torch.cuda.empty_cache()
    return cfg, row


def train_qat_full_width(dev, steps=3):
    """The baselines' main path: 40 layers at full width, QAT then RAT
    (3 steps each, fused AdamW at lam = 0), then the eval CEs."""
    out = {}
    for method in ("qat", "rat"):
        cfg, out[method] = _baseline_run(dev, method, steps=steps)
    row = dict(phase="train_qat_full_width", model=cfg.name,
               n_layers=cfg.n_layers, d_model=cfg.d_model,
               dtype=str(cfg.dtype), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               optimizer="fused AdamW, cosine warmup", **out)
    emit(row)
    bad = {m: r["checks"] for m, r in out.items()
           if not all(r["checks"].values())}
    if bad:
        raise AssertionError(f"baseline training failed its checks: {bad}")
    return row


def train_rat_act(dev, n_layers=8, steps=2):
    """RAT at 8 layers, then RAT with int8 activations (the bf16 instance
    of quant, its launches counted with the recomputation)."""
    out = {}
    for act in (None, "int8"):
        cfg, out[f"act_{act}"] = _baseline_run(dev, "rat", steps=steps,
                                               n_layers=n_layers, act_fmt=act)
    row = dict(phase="train_rat_act", model=cfg.name, n_layers=cfg.n_layers,
               d_model=cfg.d_model, dtype=str(cfg.dtype), remat=cfg.remat,
               **out)
    emit(row)
    bad = {k: r["checks"] for k, r in out.items()
           if not all(r["checks"].values())}
    if bad:
        raise AssertionError(f"RAT phase failed its checks: {bad}")
    return row


# RAT's microbatches on the card: one step from the generator with 2
# microbatches against 1 on the same state and batch (fp32, TF32 off).
# Sharing one cast, they differ by summation order only (9.9e-8); fresh
# uniforms in the second microbatch read 4.4e-3 (planted_faults_torch.py,
# rat_uniforms_per_microbatch; NVIDIA H100 80GB HBM3 at 700 W).
RAT_MICRO_RTOL = 1e-5
# QAT and RAT, card against CPU: the first two steps' losses and the fp32
# eval CE are held at TRAIN_CPU_RTOL (the sound runs agree to 7e-6).  The
# third step's loss and the RTN and RR eval CEs run cast weights after two
# updates: Adam's first steps on elements whose gradient is within
# rounding of eps differ between card and CPU, and where such an element
# is its matrix's absmax the per-tensor scale, and every code of the
# matrix, moves (ROADMAP Queue 3).  The sound run read up to 4.4e-4
# there (QAT's RR CE; NVIDIA H100 80GB HBM3 at 700 W), so they are held at
# 1e-3.  A dropped STE gradient (w_gate) reads 2.4e-3 on the first two
# steps and 1.9e-3 after (planted_faults_torch.py, ste_drops_grad).
TRAIN_BASELINE_LATE_RTOL = 1e-3


def _uniform_source(dev, params, seed, n):
    """n dicts of uniforms (eligible leaf path -> tensor on the card, in
    the leaf's shape), drawn from a generator seeded with ``seed``."""
    from repro_torch.core.policy import path_str
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [{path_str(p): torch.rand(_get(params, p).shape, generator=gen,
                                     device=dev) for p in _eligible(params)}
            for _ in range(n)]


def train_baselines_card_vs_cpu(dev, steps=3):
    """QAT and RAT on 2 full-width layers, fp32, trained on the card and
    on the CPU from the same weights, batches and (RAT) uniforms: the
    first two steps' losses and the fp32 eval CE within TRAIN_CPU_RTOL,
    the third step's loss and the RTN and RR eval CEs within
    TRAIN_BASELINE_LATE_RTOL.  Then RAT's microbatches on the card
    against one microbatch (RAT_MICRO_RTOL)."""
    from repro_torch.core.policy import tree_map_with_path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for method in ("qat", "rat"):
        res = {}
        for side in ("cpu", "cuda"):
            d = torch.device("cpu") if side == "cpu" else dev
            draws = []          # per step, then the RR eval's
            cfg, train_step, eval_fn, state = granite_trainer(
                dev, n_layers=2, dtype="float32", seed=3, method=method,
                rat_uniforms=(lambda step: draws[step]) if method == "rat"
                else None)
            draws += [{k: v.to(d) for k, v in u.items()} for u in
                      _uniform_source(dev, state["params"], 17, steps + 1)]
            if side == "cpu":
                # the same random weights (drawn on the card), moved over
                state = tree_map_with_path(
                    lambda p, x: x.cpu() if torch.is_tensor(x) else x, state)
            pipe, val = _pipeline(cfg, d, 2, 128)
            state, rows = _train_steps(train_step, state, pipe, steps)
            pipe.close()
            p = state["params"]
            res[side] = dict(losses=[r["loss"] for r in rows],
                             ce_fp32=float(eval_fn(p, val)),
                             ce_rtn=float(eval_fn(p, val, "rtn")),
                             ce_rr=float(eval_fn(p, val, "rr",
                                                 uniforms=draws[steps])))
            del state, train_step, eval_fn, draws
        c, g = res["cpu"], res["cuda"]
        early = list(zip(c["losses"][:2], g["losses"][:2])) + [
            (c["ce_fp32"], g["ce_fp32"])]
        late = list(zip(c["losses"][2:], g["losses"][2:])) + [
            (c[k], g[k]) for k in ("ce_rtn", "ce_rr")]
        out[method] = dict(cpu=c, card=g,
                           max_rel_diff=max(_rel(a, b) for a, b in early),
                           late_max_rel_diff=max(_rel(a, b)
                                                 for a, b in late))
    # RAT's microbatches share one cast (the generator, on the card)
    micro = {}
    for n in (1, 2):
        cfg, train_step, _, state = granite_trainer(
            dev, n_layers=2, dtype="float32", seed=3, method="rat",
            n_microbatches=n)
        pipe, _ = _pipeline(cfg, dev, 4, 128)
        _, rows = _train_steps(train_step, state, pipe, 1)
        pipe.close()
        micro[n] = rows[0]
        del state, train_step
    micro_diff = max(_rel(micro[1][k], micro[2][k])
                     for k in ("loss", "grad_norm"))
    worst = max(r["max_rel_diff"] for r in out.values())
    late = max(r["late_max_rel_diff"] for r in out.values())
    row = dict(phase="train_baselines_card_vs_cpu", n_layers=2,
               dtype="float32", batch=2, seq=128, steps=steps, **out,
               max_rel_diff=worst, rtol=TRAIN_CPU_RTOL,
               late_max_rel_diff=late, late_rtol=TRAIN_BASELINE_LATE_RTOL,
               rat_microbatches={n: {k: micro[n][k] for k in
                                     ("loss", "grad_norm")} for n in micro},
               rat_micro_rel_diff=micro_diff, rat_micro_rtol=RAT_MICRO_RTOL)
    emit(row)
    if not (worst <= TRAIN_CPU_RTOL and late <= TRAIN_BASELINE_LATE_RTOL
            and micro_diff <= RAT_MICRO_RTOL):
        raise AssertionError("baseline training: card and CPU, or RAT's "
                             "microbatches, disagree", row)
    torch.cuda.empty_cache()
    return row


def _prefill_logits(params, cfg, toks, lens, device):
    from repro_torch.models.lm import lm_prefill
    with torch.inference_mode():
        logits, _ = lm_prefill(params, cfg, torch.as_tensor(toks,
                                                            device=device),
                               cache_len=64, kv_quant="int8",
                               prompt_lens=torch.tensor(lens, device=device))
    return logits.float().cpu()


def serve_rr(dev, n_layers=4, mnt=8):
    """Serving what the baselines train, 4 full-width layers: RR-cast int4
    QTensors (the cast in the stored orientation, re-quantized: from
    explicit uniforms its dequantized tree equals the dense RR cast of the
    same uniforms through quant_rr, bitwise up to the sign of zero)
    served by ``rr:int4`` (drawn
    from ``ServeConfig.seed``) through wqt_matmul, and the dense fp4 RTN
    cast (``rtn:fp4``, no QTensor) served dense; each engine's launches
    (its preparation's and its generation's) counted exactly and its
    prefill logits held to the CPU's on the same weights (5% of the
    largest logit, as card_vs_cpu)."""
    from repro_torch.configs import get_config
    from repro_torch.core import (QuantPolicy, dequantize_params,
                                  quantize_params)
    from repro_torch.core.policy import path_str, tree_map_with_path
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.quant import quant_rr
    from repro_torch.models.lm import lm_init
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=n_layers)
    params = lm_init(cfg, seed=4, device=dev)
    stored = tree_map_with_path(
        lambda p, x: x.transpose(-1, -2).contiguous()
        if x.ndim >= 2 and p[-1] != "embed" else x, params)
    u = _uniform_source(dev, stored, 23, 1)[0]
    reset_launch_counts()
    qparams = quantize_params(params, "int4", QuantPolicy(), -1, mode="rr",
                              uniforms=u)
    prep_counts = launch_counts()
    # 7 casts: quant_rr (rr:int4) or quant_rtn (rtn:fp4), one per leaf
    want_prep = dict.fromkeys(prep_counts, 0)
    want_prep.update(quant=len(_eligible(params)))
    dense = dequantize_params(qparams)
    identity = {}
    for path in _eligible(params):
        key = path_str(path)
        cast = quant_rr(_get(stored, path), u[key], "int4", -1)
        # equal values: a -0.0 of the cast comes back from its code as 0.0
        identity[key] = torch.equal(_get(dense, path),
                                    cast.transpose(-1, -2))
        del cast
    del dense, stored, u
    torch.cuda.empty_cache()
    rng = np.random.default_rng(4)
    prompts = _prompts(rng, 4, 16, 32, cfg.vocab)
    max_len = max(map(len, prompts))
    toks = np.zeros((len(prompts), max_len), np.int64)
    for i, p in enumerate(prompts):
        toks[i, max_len - len(p):] = p
    lens = [len(p) for p in prompts]
    runs = {}
    del qparams
    for name in ("rr:int4", "rtn:fp4"):
        reset_launch_counts()
        eng = Engine(cfg, params, ServeConfig(weights=name, kv_quant="int8",
                                              max_new_tokens=mnt, seed=4),
                     device=dev)
        prep = launch_counts()
        reset_launch_counts()
        outs = eng.generate(prompts)
        torch.cuda.synchronize()
        counts = launch_counts()
        qt = name.startswith("rr")
        want = dict.fromkeys(counts, 0)
        want.update(wqt_matmul=7 * n_layers * mnt if qt else 0,
                    decode_attn=n_layers * (mnt - 1))
        cpu_params = tree_map_with_path(lambda p, x: x.to("cpu"),
                                        eng.params)
        pg = _prefill_logits(eng.params, cfg, toks, lens, dev)
        pc = _prefill_logits(cpu_params, cfg, toks, lens, "cpu")
        err, scale = float((pg - pc).abs().max()), float(pc.abs().max())
        runs[name] = dict(
            prepare_launches=prep, expected_prepare_launches=want_prep,
            launches=counts, expected_launches=want,
            max_abs_logit_err=err, tol=0.05 * scale,
            tokens_ok=[len(o) for o in outs] == [mnt] * len(prompts)
            and all(0 <= t < cfg.vocab for o in outs for t in o),
            first_tokens=[o[:4] for o in outs[:2]])
        runs[name]["ok"] = (counts == want and prep == want_prep
                            and err <= 0.05 * scale
                            and runs[name]["tokens_ok"])
        del eng, cpu_params
        torch.cuda.empty_cache()
    row = dict(phase="serve_rr", model=cfg.name, n_layers=n_layers,
               dtype=str(cfg.dtype), rr_quantize_launches=prep_counts,
               rr_requantize_identity_bitwise=all(identity.values()),
               rr_identity=identity, **runs)
    emit(row)
    ok = (all(identity.values()) and len(identity) == 7
          and prep_counts == want_prep
          and all(r["ok"] for r in runs.values()))
    if not ok:
        raise AssertionError("serve_rr failed its checks", row)
    return row


# --------------------------------------------------------------------------
# phase 8: checkpoints and self-healing training: the JAX package's
# checkpoint layout at full width, crash-exact auto-resume, the training
# chaos harness through opt_step's skip gate, and EF gradient compression
# through quant's int8 block-256 instance
# --------------------------------------------------------------------------

def _state_leaves(tree):
    """(key, tensor) pairs of a state in the checkpoint's key order."""
    from repro_torch.checkpoint.io import _paths_and_leaves
    return _paths_and_leaves(tree)


def _state_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in _state_leaves(tree))


def _ckpt_dir(need: int):
    """A fresh directory on the local filesystem with the most free space
    (the checkout's or the temp dir's); raises if it has less than
    ``need`` bytes free.  Returns (dir, free bytes)."""
    best = max({ROOT, tempfile.gettempdir()},
               key=lambda d: shutil.disk_usage(d).free)
    free = shutil.disk_usage(best).free
    if free < need:
        raise AssertionError(
            f"a checkpoint of {need} bytes does not fit: {best} has {free} "
            f"bytes free", dict(phase="ckpt_disk", dir=best, free=free,
                                need=need))
    return tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=best), free


def _host_ram_available():
    """MemAvailable of /proc/meminfo in bytes (None where absent)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _bits(x):
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


def _differing(want, got):
    """Keys of the (key, tensor) pairs whose shape, dtype or bits differ
    (``want`` may be on the host)."""
    bad = []
    for (k, a), (k2, b) in zip(want, got):
        if (k != k2 or a.shape != b.shape or a.dtype != b.dtype
                or not torch.equal(_bits(a.to(b.device)), _bits(b))):
            bad.append(k)
    return bad + [k for k, _ in want[len(got):]]


def _counting(train_step):
    """``train_step`` counting its calls (``.calls``)."""
    def step(state, batch):
        step.calls += 1
        return train_step(state, batch)
    step.calls = 0
    step.optimizer = train_step.optimizer
    return step


_QUIET = dict(log_every=0, log=lambda *a, **k: None)


def ckpt_full_width(dev):
    """The 40-layer LOTION state (fp32 params, mu and nu, the step and
    optimizer scalars) saved after step 1 into the JAX package's layout
    (``keep=1``), step 2 taken, the saved step loaded back into the
    state's own tensors (``load(into=state)``) and step 2 taken again:
    the loss and every leaf bitwise equal to the first step 2.  Reports
    the state's bytes, the save and load seconds and rates, the free
    disk and host RAM found, and the peak device memory; removes the
    checkpoint."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.empty_cache()
    cfg, train_step, _, state = granite_trainer(dev)
    pipe, _ = _pipeline(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    try:
        b1, b2 = next(pipe), next(pipe)
    finally:
        pipe.close()
    n_leaves = len(tree_leaves(state["params"]))
    nbytes = _state_bytes(state)
    d, free = _ckpt_dir(int(nbytes * 1.05))
    ram = _host_ram_available()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        state, _ = train_step(state, b1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt_io.save(d, 1, state, keep=1)
        save_s = time.perf_counter() - t0
        files = sorted(os.listdir(os.path.join(d, "step_0000000001")))
        state, m = train_step(state, b2)
        loss_a = float(m["loss"])
        first = [(k, x.to("cpu", copy=True)) for k, x in _state_leaves(state)]
        t0 = time.perf_counter()
        state, _ = ckpt_io.load(d, into=state, step=1)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        restored_step = int(state["step"])
        state, m = train_step(state, b2)
        loss_b = float(m["loss"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = launch_counts()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    differ = _differing(first, _state_leaves(state))
    del first
    want = dict.fromkeys(counts, 0)
    want.update(opt_step=3 * n_leaves)
    checks = {"restored_step": restored_step == 1,
              "loss_bitwise": loss_a == loss_b, "state_bitwise": not differ,
              "counts": counts == want, "removed": not os.path.exists(d)}
    row = dict(phase="ckpt_full_width", model=cfg.name,
               n_layers=cfg.n_layers, dtype=str(cfg.dtype),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               n_state_leaves=len(_state_leaves(state)),
               state_bytes=nbytes, files=files, save_s=save_s,
               save_gb_s=nbytes / save_s / 1e9, load_s=load_s,
               load_gb_s=nbytes / load_s / 1e9,
               ckpt_dir_fs=os.path.dirname(d), free_disk_bytes=free,
               host_ram_available_bytes=ram, losses=[loss_a, loss_b],
               differing_leaves=differ, peak_memory_gib=peak / 2 ** 30,
               launches=counts, expected_launches=want, checks=checks)
    emit(row)
    del state, train_step
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"checkpoint phase failed: {checks}", row)
    return row


def train_resume(dev, n_layers=2, steps=6, crash_after=3):
    """Crash-exact auto-resume on 2 full-width layers (bf16, batch 4 x
    1024): ``steps`` steps straight through ``run_loop``; then the same
    run with checkpoints every 2 steps and a hard kill
    (``InjectedCrash``) after step ``crash_after``, and a fresh state
    auto-resumed to the end.  The final state and every step's loss
    (the replayed ones too) bitwise equal.  Then the newest checkpoint's
    payload is rewritten with one leaf changed (a valid zip whose own
    CRCs are right): ``load`` must refuse it by the manifest's crc32."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import InjectedCrash, run_loop
    torch.cuda.empty_cache()

    def fresh():
        cfg, step, _, state = granite_trainer(dev, n_layers=n_layers)
        pipe, _ = _pipeline(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
        return _counting(step), state, pipe

    def recorder(losses, crash_at=None):
        def hook(st, m):
            losses.append((int(st["step"]), float(m["loss"])))
            if len(losses) == crash_at:
                raise InjectedCrash(f"kill after step {int(st['step'])}")
        return hook

    reset_launch_counts()
    calls, a_losses, b_losses = 0, [], []
    step, state, pipe = fresh()
    try:
        ref = run_loop(step, state, pipe, steps,
                       step_hook=recorder(a_losses), **_QUIET)["state"]
    finally:
        pipe.close()
    calls += step.calls
    nbytes = _state_bytes(ref)
    d, free = _ckpt_dir(4 * nbytes)
    try:
        step, state, pipe = fresh()
        crashed = False
        try:
            run_loop(step, state, pipe, steps, ckpt_dir=d, ckpt_every=2,
                     auto_resume=True,
                     step_hook=recorder(b_losses, crash_after), **_QUIET)
        except InjectedCrash:
            crashed = True
        finally:
            pipe.close()
        calls += step.calls
        del state
        step, state, pipe = fresh()
        t0 = time.perf_counter()
        try:
            out = run_loop(step, state, pipe, steps, ckpt_dir=d,
                           ckpt_every=2, auto_resume=True,
                           step_hook=recorder(b_losses), **_QUIET)
        finally:
            pipe.close()
        resumed_s = time.perf_counter() - t0
        calls += step.calls
        counts = launch_counts()
        differ = _differing(_state_leaves(ref), _state_leaves(out["state"]))
        want_loss = dict(a_losses)
        losses_ok = (len(want_loss) == steps
                     and all(want_loss.get(s) == v for s, v in b_losses))
        # trust: one leaf changed inside a well-formed payload
        newest = ckpt_io.latest_step(d)
        payload = os.path.join(d, f"step_{newest:010d}", ckpt_io.PAYLOAD)
        with np.load(payload) as pz:
            arrays = {k: pz[k] for k in pz.files}
        key = sorted(arrays)[0]
        arrays[key] = arrays[key] + 1
        np.savez(payload, **arrays)
        del arrays
        try:
            ckpt_io.load(d, out["state"], step=newest)
            refused = False
        except ckpt_io.CorruptCheckpointError:
            refused = True
        verify_dir_refused = not ckpt_io.verify_dir(os.path.dirname(payload))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    n_leaves = len(tree_leaves(ref["params"]))
    want = dict.fromkeys(counts, 0)
    want.update(opt_step=n_leaves * calls)
    checks = {"crashed": crashed, "resumed_from": out["resumed_from"] == 2,
              "state_bitwise": not differ, "losses_bitwise": losses_ok,
              "tampered_payload_refused": refused,
              "tampered_verify_dir": verify_dir_refused,
              "counts": counts == want}
    row = dict(phase="train_resume", n_layers=n_layers, dtype="bfloat16",
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=steps,
               crash_after=crash_after, resumed_from=out["resumed_from"],
               state_bytes=nbytes, free_disk_bytes=free,
               resumed_segment_s=resumed_s, losses=a_losses,
               resumed_losses=b_losses, tampered_leaf=key,
               differing_leaves=differ, train_steps_run=calls,
               launches=counts, expected_launches=want, checks=checks)
    emit(row)
    del ref, out, state
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"resume phase failed: {checks}", row)
    return row


# the chaos phase's peak learning rate: at 3e-3 the random 2-layer model's
# own loss jumps by 1.5 nats at the end of warmup (see train_resume's
# losses), which the spike monitor takes for a spike; the injected faults
# alone should decide which recovery tiers fire
CHAOS_LR = 3e-4
# fingerprint (heartbeat) every other step: a full-width 2-layer state is
# 2.67 GB to bring to the host and crc32 per round, and every host-level
# fault of the two plans is still seen (at every third step it is not)
CHAOS_AUDIT_EVERY = 2


def train_chaos(dev, n_layers=2, n_steps=18):
    """The training chaos harness (``train/faults.py``) on 2 full-width
    layers (bf16, batch 4 x 1024, LOTION decoupled, the poison seam in
    the loss).  First the skip gate alone: after a clean step, a
    NaN-poisoned batch goes through loss, backward, clip and
    ``opt_step`` (launched, with its ok operand 0) and leaves every leaf
    of the state bitwise unchanged.  Then ``run_chaos`` on one host
    (``chaos_train_plan(1, 18)`` with the spike burst pinned at fetch 24,
    as the JAX tests pin it) and on two simulated hosts (the launcher's
    two-host plan, 2 payload shards): no audit violation, every tier
    fired (skips through the gate, a rollback, a quarantine, a resume,
    with two hosts a host kill and a straggler timeout), and exactly 11
    ``opt_step`` launches per train step run, skipped steps included.
    Last, the fault-free chaos replay bitwise equal to a plain run."""
    from repro_torch.data import DataPipeline, lm_batch, permutation_table
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import chaos_ok, chaos_plan
    from repro_torch.models.lm import lm_init
    from repro_torch.train import (NonFiniteBudgetError, RollbackBudgetError,
                                   init_state, run_loop)
    from repro_torch.train import faults as tfaults
    torch.cuda.empty_cache()
    cfg, train_step, _, state = granite_trainer(dev, n_layers=n_layers,
                                                chaos=True, lr=CHAOS_LR)
    n_leaves = len(tree_leaves(state["params"]))
    nbytes = _state_bytes(state)
    perm = permutation_table(0, cfg.vocab)

    def batch_fn(s, poison=1.0):
        b = lm_batch(0, s, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, perm)
        b["poison"] = torch.tensor(poison, dtype=torch.float32)
        return b

    def on_card(b):
        return {k: v.to(dev) for k, v in b.items()}

    def make_state():
        return init_state(lm_init(cfg, seed=0, device=dev),
                          train_step.optimizer, lr_scale=True)

    reset_launch_counts()
    state, _ = train_step(state, on_card(batch_fn(0)))
    core = {"params": state["params"], "opt": state["opt"]}
    before = [(k, x.clone()) for k, x in _state_leaves(core)]
    state, m = train_step(state, on_card(batch_fn(1, float("nan"))))
    gate = dict(skipped=bool(m["skipped"]),
                loss_finite=math.isfinite(float(m["loss"])),
                differing_leaves=_differing(before, _state_leaves(
                    {"params": state["params"], "opt": state["opt"]})),
                opt_step_launches=launch_counts()["opt_step"])
    del state, core, before
    torch.cuda.empty_cache()
    checks = {"gate_skipped": gate["skipped"],
              "gate_bitwise": not gate["differing_leaves"],
              "gate_launched": gate["opt_step_launches"] == 2 * n_leaves}

    keys = ("violations", "segments", "crashes", "resumes", "rollbacks",
            "skipped", "replayed_steps", "steps_seen", "saves",
            "corrupted_saves", "quarantined", "host_kills", "straggles",
            "host_kill_timeouts", "straggler_timeouts", "divergence_checks",
            "coord_rounds", "data_windows_skipped", "final_loss")
    runs = {}
    for hosts in (1, 2):
        plan = (tfaults.chaos_train_plan(1, n_steps=n_steps, spike_at=24,
                                         spike_len=3, n_crashes=1)
                if hosts == 1 else chaos_plan(1, n_steps, hosts))
        step = _counting(train_step)
        d, _ = _ckpt_dir(5 * nbytes)
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            s = tfaults.run_chaos(step, make_state, batch_fn, plan, n_steps,
                                  d, n_hosts=hosts, ckpt_shards=hosts,
                                  spike_warmup=4 if hosts == 1 else 6,
                                  audit_every=CHAOS_AUDIT_EVERY, device=dev)
        except (NonFiniteBudgetError, RollbackBudgetError) as e:
            raise AssertionError(
                f"chaos run on {hosts} host(s) aborted: {e}",
                dict(phase="train_chaos", hosts=hosts, error=str(e),
                     gate=gate))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(opt_step=n_leaves * step.calls)
        tiers = {"skip": s["skipped"] >= 1, "rollback": s["rollbacks"] >= 1,
                 "quarantine": s["quarantined"] >= 1,
                 "resume": s["resumes"] >= 1}
        if hosts > 1:
            tiers.update(host_kill=s["host_kill_timeouts"] >= 1,
                         straggler=s["straggler_timeouts"] >= 1)
        runs[hosts] = dict(plan=plan.describe(), seconds=seconds,
                           train_steps_run=step.calls, launches=counts,
                           expected_launches=want, tiers=tiers,
                           **{k: s[k] for k in keys})
        checks[f"{hosts}h_ok"] = chaos_ok(s, hosts)
        checks[f"{hosts}h_tiers"] = all(tiers.values())
        checks[f"{hosts}h_counts"] = counts == want
        del s

    plain_pipe = DataPipeline(batch_fn, device=dev, prefetch=0)
    try:
        plain = run_loop(train_step, make_state(), plain_pipe, 8,
                         **_QUIET)["state"]
    finally:
        plain_pipe.close()
    d, _ = _ckpt_dir(5 * nbytes)
    try:
        s = tfaults.run_chaos(train_step, make_state, batch_fn, None, 8, d,
                              ckpt_every=3, audit_every=CHAOS_AUDIT_EVERY,
                              device=dev)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    replay = dict(segments=s["segments"], violations=s["violations"],
                  differing_leaves=_differing(
                      _state_leaves({k: plain[k] for k in
                                     ("params", "opt", "step")}),
                      _state_leaves({k: s["state"][k] for k in
                                     ("params", "opt", "step")})))
    checks["replay_bitwise"] = (not replay["differing_leaves"]
                                and not replay["violations"]
                                and replay["segments"] == 1)
    row = dict(phase="train_chaos", n_layers=n_layers, dtype="bfloat16",
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, n_steps=n_steps,
               skip_gate=gate, runs=runs, fault_free_replay=replay,
               checks=checks)
    emit(row)
    del plain, s
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"chaos phase failed: {checks}", row)
    return row


def train_ef(dev, n_layers=8, steps=2):
    """EF int8 gradient compression on 8 full-width layers: the unfused
    chain clip -> ef -> lotion_decoupled -> AdamW, with per step one
    ``quant`` launch (int8, block 256) per gradient leaf, ``lotion_reg``
    per eligible leaf and no ``opt_step``.  Then one step's compression
    of real gradients (the next batch's, at the trained weights) with
    the carried error: the compressed gradients and the new error from
    the kernel bitwise equal to the plain version's on the card."""
    from repro_torch.core.modes import QuantConfig
    from repro_torch.core.policy import tree_map
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.quant import rtn_ref
    from repro_torch.train import TrainConfig
    from repro_torch.train.compress import ef_compress, wire_bytes
    from repro_torch.train.loop import make_loss_fn
    torch.cuda.empty_cache()
    cfg, train_step, _, state = granite_trainer(dev, n_layers=n_layers,
                                                ef_compress=True)
    tags = [t.tag for t in train_step.optimizer.links]
    pipe, _ = _pipeline(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    n_leaves = len(tree_leaves(state["params"]))
    n_eligible = len(_eligible(state["params"]))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        state, rows = _train_steps(train_step, state, pipe, steps)
        batch = next(pipe)
    finally:
        pipe.close()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(counts, 0)
    want.update(quant=n_leaves * steps, lotion_reg=n_eligible * steps)

    loss_fn = make_loss_fn(cfg, TrainConfig(quant=QuantConfig(
        method="lotion", fmt_name="int4", lam=1e3)))
    leaves = [x.detach().requires_grad_(True)
              for x in tree_leaves(state["params"])]
    it = iter(leaves)
    params = tree_map(lambda x: next(it), state["params"])
    loss, _ = loss_fn(params, batch, None)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    g = tree_map(lambda x: next(it), state["params"])
    err = state["opt"][tags.index("ef_compress")]["err"]
    q, new_err = ef_compress(g, err, EF_BLOCK)
    pairs = []
    for (k, gk), (_, ek), (_, qk), (_, nk) in zip(
            _state_leaves(g), _state_leaves(err), _state_leaves(q),
            _state_leaves(new_err)):
        corrected = gk + ek
        qp = rtn_ref(corrected, EF_FMT, EF_BLOCK)
        pairs += [(f"{k}:q", qk, qp), (f"{k}:err", nk, corrected - qp)]
    torch.cuda.synchronize()
    err_max, same, bad = _bitwise(pairs)
    checks = {"chain": tags[1:3] == ["ef_compress", "lotion_decoupled"],
              "counts": counts == want, "bitwise": same,
              "err_nonzero": any(float(e.abs().max()) > 0
                                 for e in tree_leaves(err))}
    row = dict(phase="train_ef", n_layers=cfg.n_layers, dtype=str(cfg.dtype),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, chain=tags, steps=rows,
               ef_fmt=EF_FMT, ef_block=EF_BLOCK,
               wire_bytes=wire_bytes(g, EF_BLOCK),
               fp32_grad_bytes=sum(x.numel() * 4 for x in tree_leaves(g)),
               bitwise=same, max_abs_err=err_max, disagreeing=bad,
               peak_memory_gib=peak / 2 ** 30, launches=counts,
               expected_launches=want, checks=checks)
    emit(row)
    del state, train_step, g, q, new_err, pairs, grads, leaves, params
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"EF phase failed: {checks}", row)
    return row


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


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
              "layer": lambda: layer_rows(timer, dev),
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
              "train_card_vs_cpu": lambda: train_card_vs_cpu(dev),
              "ste": lambda: check_ste(dev),
              "train_qat": lambda: train_qat_full_width(dev),
              "train_rat_act": lambda: train_rat_act(dev),
              "train_baselines_card_vs_cpu":
                  lambda: train_baselines_card_vs_cpu(dev),
              "serve_rr": lambda: serve_rr(dev),
              "train_ef": lambda: train_ef(dev),
              "train_resume": lambda: train_resume(dev),
              "train_chaos": lambda: train_chaos(dev),
              "ckpt_full_width": lambda: ckpt_full_width(dev)}
    out = {}
    for name, run in phases.items():
        t0 = time.perf_counter()
        out[name] = run()
        emit(dict(phase="timing", of=name, seconds=time.perf_counter() - t0))
        if name in ("a8", "wq", "layer", "quant", "lotion_reg",
                    "opt_step"):
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
                       and not r.get("adversarial") and pick(r, eligible))
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
    def per_tensor4(m):
        return {(r["N"], r["K"]): r for r in wqt_rows
                if r["M"] == m and r["bits"] == 4 and r["block_k"] == -1
                and r["dtype"] == "bfloat16"
                and (r["N"], r["K"]) in LAYER_MATMULS}

    dec, pre = per_tensor4(8), per_tensor4(1024)
    layer = {r["kernel"]: r for r in out["layer"]}

    b_bytes = sum(
        (8 * s[1] * 2 + s[0] * s[1] // 2 + 4 + 8 * s[0] * 2) * c
        for s, c in LAYER_MATMULS.items())
    b_flops = sum(2.0 * 8 * s[0] * s[1] * c for s, c in LAYER_MATMULS.items())
    wqt_bound, wqt_by = bound(b_bytes, b_flops)
    main_attn = _attn_row(attn_rows, 256)
    long_attn = _attn_row(attn_rows, 4096)
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
             library_ms=_layer_sum(dec, "library_ms"),
             layer_ms=layer["wqt_matmul"]["ms"],
             layer_library_ms=layer["wqt_matmul"]["library_ms"],
             variants=sorted({r["variant"] for r in wqt_rows}),
             prefill_shape="one prefill layer: 7 matmuls, M=1024, int4 "
                           "per-tensor, bf16",
             prefill_ms=_layer_sum(pre, "ms"),
             prefill_bound_ms=_layer_sum(pre, "bound_ms"),
             prefill_library_ms=_layer_sum(pre, "library_ms")),
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
             variant=main_attn["variant"], splits=main_attn["splits"],
             deterministic=all(r["deterministic"] for r in attn_rows),
             ms=main_attn["ms"], plain_ms=main_attn["plain_ms"],
             bound_ms=main_attn["bound_ms"], bound_by=main_attn["bound_by"],
             library_ms=main_attn["library_ms"],
             **_long_fields(long_attn)),
    ]

    def rtn4(r, eligible):
        return (r["cast"] == "rtn" and r["fmt"] == "int4"
                and r["block_size"] == -1)

    def rr4(r, eligible):
        return (r["cast"] == "rr" and r["fmt"] == "int4"
                and r["block_size"] == -1)

    def ef8(r, eligible):
        return (r["cast"] == "rtn" and r["fmt"] == EF_FMT
                and r["block_size"] == EF_BLOCK and r["dtype"] == "float32")

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
    bf16 = {r["fmt"]: r for r in q if r["dtype"] == "bfloat16"
            and not r.get("adversarial")}
    act_run = out["train_rat_act"]["act_int8"]
    lines.append(dict(
        name="quant", route="cuda",
        source="src/repro_torch/kernels/quant/csrc/quant.cu",
        replaces="src/repro/kernels/quant/quant_blockwise.py:113",
        path="train (eval casts)", launches=train["launches"]["quant"],
        qat_launches=out["train_qat"]["qat"]["launches"]["quant"],
        rat_launches=out["train_qat"]["rat"]["launches"]["quant"],
        tol=tol, shape="one RTN cast of Granite-3-2B's 7 eligible leaves, "
        "int4 per-tensor, fp32",
        bf16_shape="the bf16 instance: one RTN cast of a full-width "
        "step's normed block input (4, 1024, 2048), one scale per row",
        bf16_launches=act_run["act_cast_launches"],
        bf16_path="train_rat_act (act_fmt=int8, 8 layers)",
        bf16_int8_ms=bf16["int8"]["ms"], bf16_int4_ms=bf16["int4"]["ms"],
        bf16_plain_ms=bf16["int8"]["plain_ms"],
        bf16_bound_ms=bf16["int8"]["bound_ms"],
        bf16_bound_by=bf16["int8"]["bound_by"],
        library_with_scale_ms=_leaf_sum(q, "library_with_scale_ms", rtn4,
                                        True),
        rr_ms=_leaf_sum(q, "ms", rr4, True),
        rr_bound_ms=_leaf_sum(q, "bound_ms", rr4, True),
        ef_shape="EF gradient compression: one cast of each of "
        "Granite-3-2B's 11 gradient leaves, int8 block 256, fp32",
        ef_path="train_ef (8 layers)",
        ef_launches=out["train_ef"]["launches"]["quant"],
        ef_bitwise=out["train_ef"]["bitwise"],
        ef_ms=_leaf_sum(q, "ms", ef8), ef_plain_ms=_leaf_sum(q, "plain_ms",
                                                             ef8),
        ef_bound_ms=_leaf_sum(q, "bound_ms", ef8),
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
        ckpt_launches=out["ckpt_full_width"]["launches"]["opt_step"],
        resume_launches=out["train_resume"]["launches"]["opt_step"],
        chaos_launches=sum(r["launches"]["opt_step"]
                           for r in out["train_chaos"]["runs"].values()),
        skip_gate_bitwise=not out["train_chaos"]["skip_gate"][
            "differing_leaves"],
        tol=tol + "; penalty within 1e-6 relative",
        shape="one AdamW step over all 11 leaves of Granite-3-2B (7 with "
        "the int4 per-tensor penalty), fp32",
        train_step_device_ms=step_dev,
        **stats(opt, opt4, opt_lib)))
    return lines


def _attn_row(rows, L):
    """The int8, bf16, windowless check row of ``decode_attn`` or
    ``decode_attn_paged`` at ring length L with ragged positions (block
    size 16 for the paged one)."""
    return next(r for r in rows if r["L"] == L and r["bits"] == 8
                and r["window"] is None and r["dtype"] == "bfloat16"
                and r.get("bs", 16) == 16 and max(r["pos"]) > 0)


def _long_fields(r):
    """The L = 4096 row's numbers for a kernels-line entry."""
    return dict(l4096_variant=r["variant"], l4096_splits=r["splits"],
                l4096_ms=r["ms"], l4096_plain_ms=r["plain_ms"],
                l4096_bound_ms=r["bound_ms"],
                l4096_library_ms=r["library_ms"])


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
          if r["kernel"] == "wqt_matmul_a8" and r["M"] == 8
          and r["bits"] == 4 and r["block_k"] == -1}
    a8_x = {(r["N"], r["K"]): r for r in out["a8"]
            if r["kernel"] == "wqt_matmul_a8_x" and not r.get("adversarial")
            and r["M"] == 8 and r["bits"] == 4 and r["block_k"] == -1}
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
    paged = _attn_row(out["paged"], 256)
    long_paged = _attn_row(out["paged"], 4096)
    sched = out["sched"]
    layer = {r["kernel"]: r for r in out["layer"]}
    return [
        dict(name="wqt_matmul_a8", route="cuda",
             source="src/repro_torch/kernels/wq_matmul/csrc/wqt_matmul_a8.cu",
             replaces="src/repro/kernels/wq_matmul/wq_matmul.py:215",
             path="sched", launches=sched["launches"]["wqt_matmul_a8"],
             max_abs_err=max(r["max_abs_err"] for r in out["a8"]),
             tol="bitwise equal to the plain version",
             bitwise=all(r["bitwise"] for r in out["a8"]),
             adversarial_rows=sum(1 for r in out["a8"]
                                  if r.get("adversarial")),
             shape="one decode layer: 7 matmuls, M=8, int4 per-tensor, "
                   "int8 activations",
             ms=_layer_sum(a8, "ms"), plain_ms=_layer_sum(a8, "plain_ms"),
             bound_ms=a8_bound[0], bound_by=a8_bound[1],
             library_ms=_layer_sum(a8, "library_ms"),
             variants=sorted({r["variant"] for r in out["a8"]}),
             fused_shape="the same layer from bf16 activations, the row "
                         "quantizer inside (wqt_matmul_a8_x)",
             fused_ms=_layer_sum(a8_x, "ms"),
             fused_composed_ms=_layer_sum(a8_x, "composed_ms"),
             fused_plain_ms=_layer_sum(a8_x, "plain_ms"),
             fused_bound_ms=_layer_sum(a8_x, "bound_ms"),
             layer_ms=layer["wqt_matmul_a8_x"]["ms"],
             layer_composed_ms=layer["wqt_matmul_a8_x"]["composed_ms"]),
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
             variant=paged["variant"], splits=paged["splits"],
             deterministic=all(r["deterministic"] for r in out["paged"]),
             ms=paged["ms"], plain_ms=paged["plain_ms"],
             bound_ms=paged["bound_ms"], bound_by=paged["bound_by"],
             library_ms=paged["library_ms"], **_long_fields(long_paged)),
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
             library_ms=_layer_sum(wq, "library_ms"),
             layer_ms=layer["wq_matmul"]["ms"],
             layer_library_ms=layer["wq_matmul"]["library_ms"],
             variants=sorted({r["variant"] for r in out["wq"]})),
    ]


if __name__ == "__main__":
    sys.exit(main())
