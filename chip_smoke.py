"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each kernel against its plain PyTorch version on the card at the
shapes its path gives it (and times kernel, plain version, a one-call
PyTorch yardstick where there is one and the least time the card could
take; ``wqt_matmul``, ``wq_matmul``, ``decode_attn`` and
``decode_attn_paged`` rows also name the instance that ran and its
splits, and check that two launches agree bit for bit; ``quant``,
``opt_step`` and ``lotion_reg`` are also held on adversarial leaves for
their in-kernel per-matrix absmax, and ``lotion_reg`` is counted by
``torch.profiler`` as one device kernel per call; the two W4A8 entries,
``wqt_matmul_a8`` from int8 codes and ``wqt_matmul_a8_x`` with the row
quantizer inside, bitwise,
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
  the CPU on a 1-layer cut (fp32); a seeded chaos replay on 2 layers;
* training: full-width 40-layer Granite-3-2B trained 3 LOTION steps
  (fused AdamW, decoupled penalty) then evaluated with fp32, RTN and RR
  weights; 8 layers with the loss-side penalty; and 1 layer trained on
  the card and on the CPU from the same weights and batches (losses,
  per-step penalties and eval CEs compared);
* the paper's baselines: the straight-through estimators on the card
  (forward bitwise equal to the cast, gradient to the upstream one);
  full-width 40-layer QAT and RAT (3 steps each) with exact cast counts;
  RAT on 8 layers with and without int8 activations (the ``quant``
  kernel's bf16 instance, recomputed in backward); QAT and RAT on 1
  layer, card against CPU from the same uniforms, and RAT's two
  microbatches against one (one cast per step);
* serving what they train: RR-cast int4 QTensors (re-quantizing the
  cast is the identity, bitwise) through ``wqt_matmul`` and the dense
  fp4 cast, 4 layers, prefill logits against the CPU's;
* checkpoints and self-healing training: EF int8 gradient compression
  on 8 layers (``quant``'s block-256 instance, one launch per gradient
  leaf, bitwise against the plain version); crash-exact auto-resume on
  1 layer (bitwise) and a tampered payload refused by its crc32; the
  skip gate (a NaN step leaves the state bitwise unchanged) and the
  training chaos harness on 1 layer with one and two simulated hosts;
  the 1-layer state saved in the JAX checkpoint layout and loaded back
  in place (the next step bitwise), with save and load rates;
* the paper's synthetic testbeds at its d = 12000: ``quant`` and
  ``lotion_reg`` checked bitwise and timed at the testbeds' shapes
  (``synth_kernels``); §4.1's linear regression (Figure 2: ptq, qat, rat,
  lotion, 8000 SGD steps at two LRs, RTN / exact E[RR] / fp32 losses)
  and §4.2's two-layer width study (Figure 3: k = 16, 64, 256, 300
  steps, the GT construction, Lemma 4), each with exact launch counts
  and a card-against-CPU cut from the same draws;
* long-context training: 1 full-width layer at batch 1 x 8192 with
  streaming attention and the chunked head (chunks of 1024) against the
  unchunked step from the same weights and batches, from two weight
  seeds, with both peaks of device memory;
* the rest of the model zoo, from random weights: the serving kernels at
  the new configs' shapes (``wqt_matmul`` and ``wqt_matmul_a8_x`` at 15
  new (N, K), ``decode_attn`` and ``decode_attn_paged`` at head_dim 128
  and 256, ``quant`` on a 2.2e9-element Moonlight expert leaf) and the
  3-D QTensor matmul at the experts' shapes; Moonlight-16B-A3B (GShard
  MoE, 12 of its 48 layers) served static and through the scheduler
  (W4A8, paged int8 KV), dead decode rows that take no expert capacity,
  and DBRX-132B at 2 layers; Moonlight at 2 layers on the card against
  the CPU, routing included; CodeQwen1.5-7B at full depth and Gemma3-12B
  at 24 of its 48 layers (its local rings wrapped), each with a
  card-against-CPU cut; MusicGen-medium's 4-codebook decode at full depth against its
  full forward, and a 2-layer cut against the CPU;
* sharded training on a device mesh: ``opt_step``, ``lotion_reg`` and
  ``quant`` on blocks of Granite leaves as a (2, 1) or (1, 2) mesh cuts
  them, each given the whole matrices' absmax, bitwise against their
  plain versions (``mesh_kernels``); the ``train`` run through the
  launcher's mesh path on a one-rank NCCL mesh, its losses and the
  fingerprint of its final state bitwise equal to ``train``'s
  (``train_mesh``); two processes sharing the card over gloo, meshes
  (2, 1) and (1, 2), each step against one rank, a NaN on one rank's
  rows skipping the step on both, and one EF step on each mesh, its int8
  codes and error bitwise with one device's compression of the same
  gradients (``train_mesh_two_ranks``; its processes run beside the
  vision and zoo training phases);
* the mesh chaos tier: ``train_chaos``'s two-host run through the
  launcher's ``mesh_chaos`` on (2, 1) in those two processes, every tier
  fired, the counters equal on both ranks and to the one-device run's,
  the full-state fingerprint equal on both ranks (``train_mesh_chaos``);
* sharded serving: the ``serve`` run through the launcher's mesh path
  (blocks drawn and cast on blocks) on a one-rank NCCL mesh, tokens,
  last logits and launches equal to ``serve``'s, the W4A8 scheduler on 8
  layers against one device's on the chaos replay's fault-free clock,
  and the launcher's ``--chaos`` replay (``serve_mesh``); two processes
  sharing the card over gloo, meshes (2, 1) and (1, 2), static and
  scheduler, per-matrix and blockwise scales, against one rank
  (``serve_mesh_two_ranks``);
* the dry-run (``launch/dryrun.py``) held to live numbers: the ``train``
  phase's cell traced on fake tensors, its FLOPs equal to
  ``FlopCounterMode``'s over one live step and its peak within
  ``DRYRUN_PEAK_RTOL`` of that step's; its collectives on fake (2, 1)
  and (1, 2) worlds equal to those ``train_mesh_two_ranks`` issues a
  step; the roofline rows of Granite-3-2B ``train_4k`` and ``decode_32k``
  on (16, 16) (``dryrun``).

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
import hashlib
import io
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


# the two-rank jobs whose processes are running (start_two_ranks to
# stop_two_ranks); while one is, each phase's row says ranks_beside: in a
# whole run those processes load the host and share the card beside the
# phase, so its times are not comparable with a run without them
_LIVE_RANK_JOBS = set()


def emit(obj) -> None:
    if _LIVE_RANK_JOBS and isinstance(obj, dict) and "phase" in obj:
        obj = dict(obj, ranks_beside=True)
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


def peak_for(dtype: torch.dtype) -> float:
    """The card's peak rate for operations on ``dtype`` inputs: fp32 runs
    outside the tensor cores (the kernels' ``fma`` instances)."""
    return FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS


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
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k, peak_for(dtype))
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
    b_ms, b_by = bound(nbytes, flops, peak_for(dtype))
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
    b_ms, b_by = bound(nbytes, 4.0 * n_valid * g * rep * hd,
                       peak_for(dtype))
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


def _a8_library_ms(timer, row, xq, xs, qt, bits, block_k):
    """(ms, rows) of the yardstick ``_int_mm_epilogue`` on the quantized
    activations ``xq``, ``xs`` (per-tensor weights only; M padded to at
    least 32 rows), or (None, None)."""
    from repro_torch.kernels.decode_attn import unpack_int4_ref
    if block_k != -1:
        return None, None
    m, k = xq.shape
    codes = unpack_int4_ref(qt.codes) if bits == 4 else qt.codes
    w_kn = codes.contiguous().t()          # (K, N), column-major
    lib_m = max(m, 32)
    xq_l = torch.zeros((lib_m, k), dtype=torch.int8, device=xq.device)
    xq_l[:m] = xq
    xs_l = torch.ones((lib_m, 1), device=xq.device)
    xs_l[:m] = xs
    try:
        return timer(lambda: _int_mm_epilogue(xq_l, xs_l, w_kn,
                                              qt.scales)), lib_m
    except RuntimeError as e:          # a build without int8 cuBLASLt
        row["library_error"] = str(e)[:200]
        return None, lib_m


def check_a8_one(timer, gen, dev, *, m, n, k, bits, block_k):
    from repro_torch.core.qtensor import quantize_qtensor
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
    library_ms, lib_m = _a8_library_ms(timer, row, xq, xs, qt, bits, block_k)
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
    from repro_torch.kernels.wq_matmul import (quantize_acts_ref,
                                               wqt_matmul_a8_x,
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
    # the yardstick of row 3 (``_int_mm`` and the scale epilogue) on the
    # activations the plain row quantizer gives
    library_ms, lib_m = _a8_library_ms(timer, row, *quantize_acts_ref(x), qt,
                                       bits, block_k)
    row.update(ms=timer(lambda: wqt_matmul_a8_x(*args, bits)),
               composed_ms=timer(lambda: _composed_a8(x, qt)),
               plain_ms=timer(lambda: wqt_matmul_a8_x_ref(*args, bits == 4),
                              iters=3),
               library_ms=library_ms, library_M=lib_m, bound_ms=b_ms,
               bound_by=b_by)
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


def _adversarial_summary(kernel, rows, failed, **extra):
    """One summary line of a kernel's adversarial rows (and ``extra``
    fields); returned with the rows under "rows", or raised with them."""
    row = dict(phase="check_adversarial", kernel=kernel, n_rows=len(rows),
               failed=failed, bitwise=not failed,
               max_abs_err=max(r["max_abs_err"] for r in rows), **extra)
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


def check_reg_one(timer, gen, dev, shape, fmt, bs, lam=1e3,
                  adversarial=None):
    """``lam`` as the loss-placement phase folds it into the gradient.
    With ``adversarial`` (per-matrix scales) w gets that planted case (at
    the plan's chunk or cluster-block boundary) and the row is checked,
    not timed.  ``bound_ms`` is the 12-byte roofline (w and f read once,
    the gradient written once), ``floor_ms`` the 16-byte floor of a
    per-matrix kernel that reads w twice (blockwise: the roofline)."""
    from repro_torch.kernels.lotion_reg import (lotion_penalty_fused_vg,
                                                 reg_ref)
    from repro_torch.kernels.lotion_reg import ops as reg_ops
    w = torch.randn(shape, generator=gen, device=dev) * 0.02
    f = torch.rand(shape, generator=gen, device=dev) * 1e-6
    plan = reg_ops.launch_plan(w, fmt, bs)
    if adversarial:
        _plant(w, adversarial, plan)
    pen, grad = lotion_penalty_fused_vg(w, f, fmt, bs, lam)
    pen_ref, grad_ref = reg_ref(w, f, fmt, bs, lam)
    torch.cuda.synchronize()
    err, same, _ = _bitwise([("grad", grad, grad_ref)])
    pen_rel = _pen_rel(pen, pen_ref)
    n = w.numel()
    row = dict(phase="check", kernel="lotion_reg", shape=_fmt_shape(shape),
               fmt=fmt, block_size=bs, lam=lam, regime=plan.regime,
               blocks=plan.blocks, adversarial=adversarial, bitwise=same,
               max_abs_err=err, penalty=float(pen), penalty_rel_err=pen_rel)
    ok = same and pen_rel <= PENALTY_RTOL
    if not ok or adversarial:
        emit(row)
    if not ok:
        raise AssertionError("lotion_reg disagrees", row)
    if adversarial:
        return row
    del pen, grad, pen_ref, grad_ref
    b_ms, b_by = _elem_bound("lotion_reg", n, n * 4 * 3)
    row.update(ms=timer(lambda: lotion_penalty_fused_vg(w, f, fmt, bs, lam)),
               plain_ms=timer(lambda: reg_ref(w, f, fmt, bs, lam), iters=3),
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               floor_ms=n * 4 * (4 if bs == -1 else 3) / HBM_BYTES_PER_S
               * 1e3)
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


# lotion_reg's adversarial leaves: the quant/opt_step ones, the testbeds'
# (one-cluster and grid regimes) and a stacked leaf of the cluster regime
# (its blocks walk 3 matrices in turn)
REG_ADVERSARIAL_SHAPES = ADVERSARIAL_SHAPES + [
    (12000,), (16, 12000), (64, 12000), (256, 12000), (1, 16), (1, 64),
    (1, 256), (3, 40, 500)]


def check_reg_adversarial(dev, fmts=("int4", "fp4")):
    """The adversarial per-matrix rows of ``lotion_reg`` (gradient bitwise,
    penalty within 1e-6 or NaN on both); raises AssertionError(message,
    summary) after all of them if any disagrees."""
    gen = torch.Generator(device=dev).manual_seed(21)
    rows, failed = [], []
    for shape in REG_ADVERSARIAL_SHAPES:
        for fmt in fmts:
            for kind in ADVERSARIAL:
                try:
                    rows.append(check_reg_one(None, gen, dev, shape, fmt, -1,
                                              adversarial=kind))
                except AssertionError as e:
                    rows.append(e.args[1])
                    failed.append(f"{fmt} {_fmt_shape(shape)} {kind}")
    torch.cuda.empty_cache()
    return _adversarial_summary(
        "lotion_reg", rows, failed,
        max_penalty_rel_err=max(r["penalty_rel_err"] for r in rows))


# device kernels per lotion_reg call, counted by torch.profiler at one
# Granite leaf (grid regime) and one testbed leaf (cluster regime)
REG_COUNT_SHAPES = [(40, 2048, 8192), (12000,)]


def reg_kernels_per_call(dev, calls=4):
    """Every device activity (kernels, memsets, copies) that ``calls``
    calls of ``lotion_penalty_fused_vg`` record under ``torch.profiler``,
    per call: exactly one kernel, no memset."""
    from torch.profiler import ProfilerActivity, profile
    from scripts.profile_serve_torch import _device_by_name
    from repro_torch.kernels.lotion_reg import lotion_penalty_fused_vg
    from repro_torch.kernels.lotion_reg import ops as reg_ops
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for shape in REG_COUNT_SHAPES:
        w = torch.randn(shape, generator=gen, device=dev) * 0.02
        f = torch.rand(shape, generator=gen, device=dev)
        lotion_penalty_fused_vg(w, f, "int4", -1, 1e3)   # warm, plan cached
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                lotion_penalty_fused_vg(w, f, "int4", -1, 1e3)
            torch.cuda.synchronize()
        by_name = {k: c for k, (_, c) in _device_by_name(prof).items()}
        rows.append(dict(
            shape=_fmt_shape(shape),
            regime=reg_ops.launch_plan(w, "int4", -1).regime,
            device_activities=by_name,
            per_call=sum(by_name.values()) / calls))
        del w, f
    row = dict(phase="lotion_reg_kernels_per_call", calls=calls, rows=rows,
               one_kernel=all(r["per_call"] == 1.0 for r in rows))
    emit(row)
    if not row["one_kernel"]:
        raise AssertionError("lotion_reg is not one device kernel per call",
                             row)
    return row


OPT_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)


def check_opt_one(timer, gen, dev, shape, fmt, bs, *, lam=1e3, core="adamw",
                  momentum=0.0, fisher_decay=None, ok=1.0, adversarial=None,
                  library=False):
    """One check row; with ``adversarial`` (per-matrix scales) w gets that
    planted case and the row is checked, not timed.  ``library`` times
    ``torch._fused_adamw_`` (no penalty) beside an AdamW step with one;
    a step at lam 0 is always timed against it."""
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
    if (lam == 0.0 or library) and core == "adamw":
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

def tensor_sha(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (its bits, on the host)."""
    return hashlib.sha256(t.detach().contiguous().cpu().reshape(-1)
                          .view(torch.uint8).numpy().tobytes()).hexdigest()


def tokens_sha(rows) -> str:
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


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
    logits_sha = tensor_sha(eng.last_logits)

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
               / 2 ** 20, first_tokens=[o[:8] for o in outs[:2]],
               tokens_sha=tokens_sha(outs), last_logits_sha=logits_sha)
    emit(row)
    row["tokens"] = outs
    del eng
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# phase 5: the card against the CPU, 2 layers at full width
# --------------------------------------------------------------------------

# bf16 activations on both sides, rounded at different places (the kernels
# accumulate in fp32 and round once; the CPU rounds bf16 matmul outputs its
# own way): 5% of the largest logit
SERVE_BF16_RTOL = 0.05


def card_vs_cpu(dev):
    """Granite-3-2B at 2 full-width layers in bf16 as served, card against
    CPU (``_cut_vs_cpu``): the prefill's and the first decode step's
    logits within ``SERVE_BF16_RTOL`` of the largest."""
    cfg = granite_cfg(2)
    prompts = _prompts(np.random.default_rng(1), 4, 16, 32, cfg.vocab)
    return _cut_vs_cpu(dev, cfg, seed=1, prompts=prompts, steps=1,
                       why="the CPU side's time",
                       rtol=(SERVE_BF16_RTOL, SERVE_BF16_RTOL),
                       phase="card_vs_cpu")


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


def sched_card_vs_cpu(dev, n_layers=1, n_requests=4):
    """The paged W4A8 scheduler on the card and on the CPU from the same
    weights (fp32, TF32 off; ``n_layers`` cut from 2 to 1 to keep the
    script inside its time limit, the CPU side being most of the phase):
    identical greedy tokens, or partings at near ties; and the two sides'
    prefill logits with dense and with int8 activations within their
    tolerances."""
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


def granite_setup(*, n_layers=None, dtype="bfloat16", placement="decoupled",
                  lam=1e3, seed=0, method="lotion", act_fmt=None,
                  n_microbatches=1, ef_compress=False, lr=3e-3, attn_chunk=0,
                  logit_chunk=0, arch="granite-3-2b"):
    """``granite_trainer``'s (cfg, qcfg, tcfg, optimizer), no state."""
    from repro_torch.configs import get_config
    from repro_torch.core.modes import QuantConfig
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.train import TrainConfig, make_optimizer
    cfg = dataclasses.replace(get_config(arch), dtype=dtype,
                              act_fmt=act_fmt)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    qcfg = QuantConfig(method=method, fmt_name="int4", block_size=-1,
                       lam=lam if method == "lotion" else 0.0,
                       penalty_placement=placement)
    tcfg = TrainConfig(quant=qcfg, clip_norm=1.0,
                       n_microbatches=n_microbatches, seed=seed,
                       ef_compress=ef_compress, attn_chunk=attn_chunk,
                       logit_chunk=logit_chunk)
    opt = make_optimizer(tcfg, adamw(cosine_with_warmup(lr, 5, 100)))
    return cfg, qcfg, tcfg, opt


def granite_trainer(dev, *, n_layers=None, dtype="bfloat16",
                    placement="decoupled", lam=1e3, seed=0, method="lotion",
                    act_fmt=None, n_microbatches=1, rat_uniforms=None,
                    ef_compress=False, chaos=False, lr=3e-3, attn_chunk=0,
                    logit_chunk=0, arch="granite-3-2b"):
    """The training path's workload: Granite-3-2B (or ``arch``) at full
    width (depth ``n_layers`` if given), random fp32 master weights from
    ``seed`` (a vision config's cross-attention gates drawn from it too),
    ``dtype`` activations (fake-quantized under ``act_fmt``); ``method``
    int4 per-tensor (LOTION at ``lam`` with the given penalty placement,
    or the QAT/RAT baselines: RAT from ``rat_uniforms(step)`` or the
    per-step generator of ``seed``); AdamW on a cosine schedule with
    warmup to ``lr``, fused into the opt_step core (with ``ef_compress`` the
    unfused chain with EF int8 gradient compression); with ``chaos`` the
    loss carries the chaos harness's poison seam and the state its
    ``lr_scale`` leaf; ``attn_chunk`` / ``logit_chunk`` stream the
    attention and chunk the head.  Returns (cfg, train_step, eval_fn,
    state)."""
    from repro_torch.models.lm import lm_init
    from repro_torch.train import (init_state, make_eval_fn,
                                   make_train_step)
    cfg, qcfg, tcfg, opt = granite_setup(
        n_layers=n_layers, dtype=dtype, placement=placement, lam=lam,
        seed=seed, method=method, act_fmt=act_fmt,
        n_microbatches=n_microbatches, ef_compress=ef_compress, lr=lr,
        attn_chunk=attn_chunk, logit_chunk=logit_chunk, arch=arch)
    params = lm_init(cfg, seed=seed, device=dev)
    open_gates(params, cfg, seed)
    state = init_state(params, opt, lr_scale=chaos)
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
    t0 = time.perf_counter()
    fingerprint = _state_fingerprint(state)
    fingerprint_s = time.perf_counter() - t0
    ce = {"fp32": float(eval_fn(state["params"], val))}
    ce["rtn"] = float(eval_fn(state["params"], val, "rtn"))
    after_rtn = launch_counts()
    ce["rr"] = float(eval_fn(state["params"], val, "rr",
                             generator=torch.Generator(device=dev)
                             .manual_seed(1)))
    counts = launch_counts()
    # the phase's peak (training and the evals), read before the counted
    # step resets it for its own
    peak = torch.cuda.max_memory_allocated()
    counted = _counted_step(train_step, state, cfg, steps)
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
               expected_launches=want, fingerprint=fingerprint,
               fingerprint_s=fingerprint_s,
               peak_memory_gib_train=train_peak / 2 ** 30,
               peak_memory_gib=peak / 2 ** 30, counted_step=counted,
               checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"train phase failed its checks: {checks}")
    del state, train_step, eval_fn
    torch.cuda.empty_cache()
    return row


def _counted_step(train_step, state, cfg, step):
    """One more step (batch ``step`` of the stream, after everything the
    phase checks) under ``FlopCounterMode``, with its device memory peak
    from ``reset_peak_memory_stats``: what the dry-run's trace of the
    same cell is held to."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data import lm_batch, permutation_table
    batch = {k: v.to(state["step"].device) for k, v in lm_batch(
        0, step, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab,
        permutation_table(0, cfg.vocab)).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        train_step(state, batch)
    torch.cuda.synchronize()
    return dict(flops=fc.get_total_flops(),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                seconds=time.perf_counter() - t0)


def _state_fingerprint(state) -> str:
    """``distributed/audit.py::tree_fingerprint`` of the parameters and
    both moments."""
    from repro_torch.distributed.audit import tree_fingerprint
    return tree_fingerprint({"params": state["params"],
                             "mu": state["opt"]["mu"],
                             "nu": state["opt"]["nu"]})


def _fingerprint_paths_agree(dev) -> bool:
    """``tree_fingerprint`` of a card tree (a leaf of more than one pinned
    run, an int32 leaf, a 0-d leaf) equal to that of its host copy: the
    card path through pinned runs gives the host path's digest."""
    from repro_torch.distributed.audit import FINGERPRINT_RUN, tree_fingerprint
    gen = torch.Generator(device=dev).manual_seed(27)
    tree = {"a": torch.randn(FINGERPRINT_RUN // 4 + 12345, generator=gen,
                             device=dev),
            "b": torch.arange(7, dtype=torch.int32, device=dev),
            "c": torch.full((), 3.0, device=dev)}
    return tree_fingerprint(tree) == tree_fingerprint(
        {k: v.cpu() for k, v in tree.items()})


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


def train_card_vs_cpu(dev, steps=3, n_layers=1):
    """Granite-3-2B on 1 full-width layer (cut from 2 to keep the script
    inside its time limit), fp32, trained 3 LOTION steps on the card and
    on the CPU from the same weights and batches: the losses and the
    fp32 and RTN eval CEs within TRAIN_CPU_RTOL, the per-step penalty
    within TRAIN_CPU_PENALTY_RTOL."""
    from repro_torch.core.policy import tree_map_with_path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for side in ("cpu", "cuda"):
        d = torch.device("cpu") if side == "cpu" else dev
        cfg, train_step, eval_fn, state = granite_trainer(
            dev, n_layers=n_layers, dtype="float32", seed=2)
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
    row = dict(phase="train_card_vs_cpu", n_layers=n_layers,
               dtype="float32",
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


def train_baselines_card_vs_cpu(dev, steps=3, n_layers=1):
    """QAT and RAT on 1 full-width layer (cut from 2 to keep the script
    inside its time limit), fp32, trained on the card and
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
                dev, n_layers=n_layers, dtype="float32", seed=3, method=method,
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
            dev, n_layers=n_layers, dtype="float32", seed=3, method="rat",
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
    row = dict(phase="train_baselines_card_vs_cpu", n_layers=n_layers,
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


# a RAM-backed filesystem for the checkpoints of the phases that check the
# harness's logic (train_resume, train_chaos): their disk I/O was most of
# their time; ckpt_full_width measures the disk and stays on it
RAM_DIR = "/dev/shm"


def _ckpt_dir(need: int, ram: bool = False):
    """A fresh directory with the most free space: with ``ram`` on
    ``RAM_DIR`` where it has ``need`` bytes free, else on the local
    filesystem (the checkout's or the temp dir's); raises if it has less
    than ``need`` bytes free.  Returns (dir, free bytes)."""
    if ram and os.path.isdir(RAM_DIR) and \
            shutil.disk_usage(RAM_DIR).free >= need:
        return (tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=RAM_DIR),
                shutil.disk_usage(RAM_DIR).free)
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
# why the checkpoint phases run below the depth they first ran at: uncut,
# their disk I/O (about 100 s more for the 40-layer checkpoint, 85 s more
# for 2 chaos layers) would take the whole script to about 1,100 s of its
# 1,200 s limit on a card at 700 W, where it should stay near half of it
CUT_FOR_TIME = "cut for the script's time limit"


def ckpt_full_width(dev, n_layers=1):
    """The LOTION state of 1 full-width layer (fp32 params, mu and nu, the
    step and optimizer scalars; the depth is cut from 40 to keep the
    script inside its time limit: the 40-layer state took 138 s of disk
    I/O, the 8-layer one about 38 s, the 4-layer one 24) saved after step 1 into the JAX package's layout
    (``keep=1``), step 2 taken, the saved step loaded back into the
    state's own tensors (``load(into=state)``) and step 2 taken again:
    the loss and every leaf bitwise equal to the first step 2.  Reports
    the state's bytes, the save and load seconds and rates, the free
    disk and host RAM found, and the peak device memory; removes the
    checkpoint."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.empty_cache()
    cfg, train_step, _, state = granite_trainer(dev, n_layers=n_layers)
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
               n_layers=cfg.n_layers, full_n_layers=40,
               depth_reason=CUT_FOR_TIME, dtype=str(cfg.dtype),
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


def train_resume(dev, n_layers=1, steps=6, crash_after=3):
    """Crash-exact auto-resume on 1 full-width layer (bf16, batch 4 x
    1024; cut from 2 to keep the script inside its time limit):
    ``steps`` steps straight through ``run_loop``; then the same run
    with checkpoints every 2 steps and a hard kill
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
    d, free = _ckpt_dir(5 * nbytes, ram=True)
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


class _Split:
    """Seconds spent in named calls (each synchronized with the card at
    its end), the rest of a run's time as ``other``."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                self.seconds[name] = (self.seconds.get(name, 0.0)
                                      + time.perf_counter() - t0)
        for attr in ("calls", "optimizer"):
            if hasattr(fn, attr):
                setattr(timed, attr, getattr(fn, attr))
        return timed

    def split(self, total):
        out = dict(self.seconds)
        out["other"] = total - sum(self.seconds.values())
        return out


@contextlib.contextmanager
def _timed_calls():
    """A chaos run's seconds by what takes them: checkpoint saves, loads
    and the validity scans that pick the one to resume from, the audits'
    fingerprints and replica checks; the caller wraps the steps and the
    state re-inits (``wrap``)."""
    from repro_torch import distributed
    from repro_torch.checkpoint import io as ckpt_io
    split = _Split()
    targets = [(ckpt_io, "save", "saves"), (ckpt_io, "load", "loads"),
               (ckpt_io, "latest_valid", "verifies"),
               (distributed, "tree_fingerprint", "audits"),
               (distributed, "replica_divergence", "audits"),
               (distributed, "BlockDigests", "audits")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in targets]
    try:
        for m, n, key in targets:
            setattr(m, n, split.wrap(key, getattr(m, n)))
        yield split
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


CHAOS_KEYS = ("violations", "segments", "crashes", "resumes", "rollbacks",
              "skipped", "replayed_steps", "steps_seen", "saves",
              "corrupted_saves", "quarantined", "host_kills", "straggles",
              "host_kill_timeouts", "straggler_timeouts",
              "divergence_checks", "coord_rounds", "data_windows_skipped",
              "final_loss")
# train_chaos's two-host run by depth: train_mesh_chaos's reference
_CHAOS_REF = {}


def _chaos_runs(dev, train_step, make_state, batch_fn, n_leaves, nbytes,
                n_steps, hosts_list):
    """``run_chaos`` on each number of simulated hosts: on one,
    ``chaos_train_plan(1, n_steps)`` with the spike burst pinned at fetch
    24, as the JAX tests pin it; on several, the launcher's plan
    (``chaos_plan``) with one payload shard per host.  Per run its
    counters, tiers, launches, seconds by what took them, ``chaos_ok``
    and the final state's fingerprint (params and opt)."""
    from repro_torch.distributed import tree_fingerprint
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import chaos_ok, chaos_plan
    from repro_torch.train import NonFiniteBudgetError, RollbackBudgetError
    from repro_torch.train import faults as tfaults
    runs = {}
    for hosts in hosts_list:
        plan = (tfaults.chaos_train_plan(1, n_steps=n_steps, spike_at=24,
                                         spike_len=3, n_crashes=1)
                if hosts == 1 else chaos_plan(1, n_steps, hosts))
        step = _counting(train_step)
        d, _ = _ckpt_dir(5 * nbytes, ram=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with _timed_calls() as split:
                s = tfaults.run_chaos(
                    split.wrap("steps", step), split.wrap(
                        "reinits", make_state), batch_fn, plan, n_steps, d,
                    n_hosts=hosts, ckpt_shards=hosts,
                    spike_warmup=4 if hosts == 1 else 6,
                    audit_every=CHAOS_AUDIT_EVERY, device=dev)
        except (NonFiniteBudgetError, RollbackBudgetError) as e:
            raise AssertionError(
                f"chaos run on {hosts} host(s) aborted: {e}",
                dict(phase="train_chaos", hosts=hosts, error=str(e)))
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
        fingerprint = tree_fingerprint({"params": s["state"]["params"],
                                        "opt": s["state"]["opt"]})
        runs[hosts] = dict(plan=plan.describe(), seconds=seconds,
                           split_s=split.split(seconds), ckpt_dir_ram=d
                           .startswith(RAM_DIR),
                           train_steps_run=step.calls, launches=counts,
                           expected_launches=want, tiers=tiers,
                           fingerprint=fingerprint, ok=chaos_ok(s, hosts),
                           **{k: s[k] for k in CHAOS_KEYS})
        del s
    return runs


# the chaos phase's peak learning rate: at 3e-3 the random 2-layer model's
# own loss jumps by 1.5 nats at the end of warmup (see train_resume's
# losses), which the spike monitor takes for a spike; the injected faults
# alone should decide which recovery tiers fire
CHAOS_LR = 3e-4
# fingerprint (heartbeat) every other step: a full-width 2-layer state is
# 2.67 GB to bring to the host and crc32 per round, and every host-level
# fault of the two plans is still seen (at every third step it is not)
CHAOS_AUDIT_EVERY = 2


def _chaos_setup(dev, n_layers):
    """train_chaos's (train_step, state, batch_fn, make_state): Granite at
    full width, ``n_layers`` layers, bf16, LOTION decoupled at lam 1e3,
    ``CHAOS_LR``, the poison seam; ``batch_fn(s, poison=1.0)`` of 4 x
    ``TRAIN_SEQ``."""
    from repro_torch.data import lm_batch, permutation_table
    from repro_torch.models.lm import lm_init
    from repro_torch.train import init_state
    torch.cuda.empty_cache()
    cfg, train_step, _, state = granite_trainer(dev, n_layers=n_layers,
                                                chaos=True, lr=CHAOS_LR)
    perm = permutation_table(0, cfg.vocab)

    def batch_fn(s, poison=1.0):
        b = lm_batch(0, s, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, perm)
        b["poison"] = torch.tensor(poison, dtype=torch.float32)
        return b

    def make_state():
        return init_state(lm_init(cfg, seed=0, device=dev),
                          train_step.optimizer, lr_scale=True)

    return train_step, state, batch_fn, make_state


def chaos_reference(dev, n_layers=1, n_steps=18):
    """train_chaos's two-host run (from that phase when it ran in this
    process, else run here)."""
    if n_layers not in _CHAOS_REF:
        train_step, state, batch_fn, make_state = _chaos_setup(dev, n_layers)
        n_leaves = len(tree_leaves(state["params"]))
        nbytes = _state_bytes(state)
        del state
        runs = _chaos_runs(dev, train_step, make_state, batch_fn, n_leaves,
                           nbytes, n_steps, (2,))
        runs[2].pop("ok")
        _CHAOS_REF[n_layers] = runs[2]
    return _CHAOS_REF[n_layers]


def train_chaos(dev, n_layers=1, n_steps=18):
    """The training chaos harness (``train/faults.py``) on 1 full-width
    layer (bf16, batch 4 x 1024, LOTION decoupled, the poison seam in
    the loss; cut from 2 to keep the script inside its time limit: the
    phase is mostly checkpoint I/O: 314-344 s at 2 layers, 231 s at 1).
    First the skip gate alone: after a clean step, a NaN-poisoned batch goes through loss, backward, clip and
    ``opt_step`` (launched, with its ok operand 0) and leaves every leaf
    of the state bitwise unchanged.  Then ``run_chaos`` on one host
    (``chaos_train_plan(1, 18)`` with the spike burst pinned at fetch 24,
    as the JAX tests pin it) and on two simulated hosts (the launcher's
    two-host plan, 2 payload shards): no audit violation, every tier
    fired (skips through the gate, a rollback, a quarantine, a resume,
    with two hosts a host kill and a straggler timeout), and exactly 11
    ``opt_step`` launches per train step run, skipped steps included.
    Last, the fault-free chaos replay bitwise equal to a plain run."""
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import run_loop
    from repro_torch.train import faults as tfaults
    train_step, state, batch_fn, make_state = _chaos_setup(dev, n_layers)
    n_leaves = len(tree_leaves(state["params"]))
    nbytes = _state_bytes(state)

    def on_card(b):
        return {k: v.to(dev) for k, v in b.items()}

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

    runs = _chaos_runs(dev, train_step, make_state, batch_fn, n_leaves,
                       nbytes, n_steps, (1, 2))
    for hosts, r in runs.items():
        checks[f"{hosts}h_ok"] = r.pop("ok")
        checks[f"{hosts}h_tiers"] = all(r["tiers"].values())
        checks[f"{hosts}h_counts"] = r["launches"] == r["expected_launches"]
    _CHAOS_REF[n_layers] = runs[2]

    plain_pipe = DataPipeline(batch_fn, device=dev, prefetch=0)
    try:
        plain = run_loop(train_step, make_state(), plain_pipe, 8,
                         **_QUIET)["state"]
    finally:
        plain_pipe.close()
    d, _ = _ckpt_dir(5 * nbytes, ram=True)
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
    row = dict(phase="train_chaos", n_layers=n_layers, full_n_layers=2,
               depth_reason=CUT_FOR_TIME, dtype="bfloat16",
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


# --------------------------------------------------------------------------
# phase 10: the paper's synthetic testbeds (§4.1, §4.2) at d = 12000, and
# long-context training through streaming attention and the chunked head
# --------------------------------------------------------------------------

# card against CPU: final weights within this of the largest (max |a - b| /
# max |b|); the trainers round float64 gradient sums to fp32 once, so the
# two are expected bitwise equal
SYNTH_CPU_RTOL = 1e-5
SYNTH_CPU_STEPS = 200


def check_synth_kernels(timer, dev):
    """``quant_rtn``, ``quant_rr`` and ``lotion_penalty_fused_vg`` at every
    leaf shape the testbeds train and evaluate (§4.1's w, §4.2's W1 and
    W2 at each width k), INT4 per matrix, bitwise against their plain
    versions and timed beside their bounds."""
    from repro_torch.train.synthetic import PAPER_D, QUAD_LAM, TWO_KS
    shapes = ([(PAPER_D,)] + [(k, PAPER_D) for k in TWO_KS]
              + [(1, k) for k in TWO_KS])
    gen = torch.Generator(device=dev).manual_seed(20)
    rows = []
    for shape in shapes:
        for rr in (False, True):
            rows.append(check_quant_one(timer, gen, dev, shape, "int4", -1,
                                        rr))
        rows.append(check_reg_one(timer, gen, dev, shape, "int4", -1,
                                  lam=QUAD_LAM))
    return rows


def _max_rel(got, want):
    return float((got.cpu() - want.cpu()).abs().max()
                 / want.abs().max().clamp_min(1e-30).cpu())


def synth_quadratic(dev, cpu_steps=SYNTH_CPU_STEPS):
    """§4.1 (Figure 2) at the paper's d = 12000: SGD at batch 32 for 8000
    steps, methods ptq / qat / rat / lotion at lr 0.6 and 1.2, w* ~ N(0,
    1) from a seeded generator, then the RTN, exact E[RR] and fp32 losses
    of each run.  Launch counts exact: QAT one ``quant_rtn`` and RAT one
    ``quant_rr`` per step, LOTION one ``lotion_reg`` per step, and each
    run's eval one ``quant_rtn`` and one ``lotion_reg`` (Eq. 1's variance
    term).  Figure 2's claims are reported, not asserted.  Then the card
    against the CPU: ``cpu_steps`` steps of every method at lr 0.6 from
    the same draws (made on the CPU), final w compared."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import synthetic as syn
    d = syn.PAPER_D
    spec, w_star = syn.problem(d, dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    runs = syn.quadratic_runs(w_star, spec)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    n_lr, steps = len(syn.QUAD_LRS), syn.QUAD_STEPS
    want = dict.fromkeys(counts, 0)
    want.update(quant=2 * n_lr * steps + len(runs),
                lotion_reg=n_lr * steps + len(runs))
    best = syn.best_per_method(runs)
    # card against CPU, from draws made on the CPU
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(11)
    z = torch.randn((cpu_steps, syn.QUAD_BATCH, d), generator=gen)
    u = torch.rand((cpu_steps, d), generator=gen)
    cut = {}
    for method in syn.QUAD_METHODS:
        ws = {}
        for side, where in (("cuda", dev), ("cpu", cpu)):
            ws[side] = syn.quadratic_train(
                w_star.to(where), spec.to(where), syn.QUAD_LRS[0], method,
                steps=cpu_steps, normals=lambda t: z[t].to(where),
                uniforms=lambda t: u[t].to(where))
        cut[method] = dict(max_rel_diff=_max_rel(ws["cuda"], ws["cpu"]),
                           bitwise=bool(torch.equal(ws["cuda"].cpu(),
                                                    ws["cpu"])))
    worst = max(c["max_rel_diff"] for c in cut.values())
    checks = {"counts": counts == want,
              "finite": all(math.isfinite(r[k]) for r in runs
                            for k in ("rtn", "e_rr", "fp32")),
              "card_vs_cpu": worst <= SYNTH_CPU_RTOL}
    row = dict(phase="synth_quadratic", d=d, steps=steps,
               batch=syn.QUAD_BATCH, lrs=list(syn.QUAD_LRS), fmt=syn.FMT,
               lam=syn.QUAD_LAM, runs=runs,
               best={m: dict(rtn=r["rtn"], e_rr=r["e_rr"], fp32=r["fp32"],
                             lr=r["lr"]) for m, r in best.items()},
               fig2_claims=syn.fig2_claims(best), seconds=seconds,
               seconds_per_run=seconds / len(runs), launches=counts,
               expected_launches=want, card_vs_cpu=cut,
               card_vs_cpu_steps=cpu_steps, max_rel_diff=worst,
               rtol=SYNTH_CPU_RTOL, checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError("synth_quadratic failed its checks", row)
    return row


def synth_twolayer(dev, cpu_k=16):
    """§4.2 (Figure 3) at d = 12000 (§4.1's d; the JAX bench's widths k =
    16, 64, 256), 300 steps of ptq / qat / lotion at lr 0.1 and 0.3 from
    the same initial weights, each run's RTN and RR losses and the GT
    construction's; Lemma 4 (GT's loss falls with k) reported.  Launch
    counts exact: QAT 2 ``quant_rtn`` and LOTION 2 ``lotion_reg`` per step
    (W1 and W2), each eval 2 RTN and 2 RR casts.  Then the card against
    the CPU at k = ``cpu_k``, every method at lr 0.3 from the same
    initial weights."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.linear import twolayer_init
    from repro_torch.train import synthetic as syn
    d = syn.PAPER_D
    spec, w_star = syn.problem(d, dev, scale=0.5)
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = syn.twolayer_rows(w_star, spec)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    n_k, n_lr, steps = len(syn.TWO_KS), len(syn.TWO_LRS), syn.TWO_STEPS
    evals = n_k * (len(syn.TWO_METHODS) * n_lr + 1)
    want = dict.fromkeys(counts, 0)
    want.update(quant=n_k * n_lr * steps * 2 + 4 * evals,
                lotion_reg=n_k * n_lr * steps * 2)
    p0 = twolayer_init(torch.Generator(device=dev).manual_seed(0), d, cpu_k)
    cpu = torch.device("cpu")
    cut = {}
    for method in syn.TWO_METHODS:
        ps = {side: syn.twolayer_train(
            w_star.to(where), spec.to(where), cpu_k, syn.TWO_LRS[1], method,
            p0={n: x.to(where) for n, x in p0.items()})
            for side, where in (("cuda", dev), ("cpu", cpu))}
        cut[method] = dict(
            max_rel_diff=max(_max_rel(ps["cuda"][n], ps["cpu"][n])
                             for n in p0),
            bitwise=all(torch.equal(ps["cuda"][n].cpu(), ps["cpu"][n])
                        for n in p0))
    worst = max(c["max_rel_diff"] for c in cut.values())
    lemma4 = [r["lemma4_gt_decreasing"] for r in rows[1:]]
    checks = {"counts": counts == want,
              "finite": all(math.isfinite(r[m]) for r in rows
                            for m in syn.TWO_METHODS + ("gt",)),
              "card_vs_cpu": worst <= SYNTH_CPU_RTOL}
    row = dict(phase="synth_twolayer", d=d, steps=steps,
               ks=list(syn.TWO_KS), lrs=list(syn.TWO_LRS), fmt=syn.FMT,
               lam=syn.TWO_LAM, rows=rows, lemma4_gt_decreasing=lemma4,
               seconds=seconds,
               seconds_per_run=seconds / (n_k * len(syn.TWO_METHODS)
                                          * n_lr),
               launches=counts, expected_launches=want, card_vs_cpu=cut,
               card_vs_cpu_k=cpu_k, max_rel_diff=worst, rtol=SYNTH_CPU_RTOL,
               checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError("synth_twolayer failed its checks", row)
    return row


LONG_SEQ, LONG_CHUNK = 8192, 1024
LONG_SEEDS = (0, 1)     # weight draws; every limit holds at each
# chunked against unchunked, bf16 activations: the losses of each step
# within 2^-13 relative and the gradient norms within 2^-9 (the online
# softmax adds in another order, and its output is rounded to bf16 where
# _sdpa's probabilities are); each leaf's first moment (0.1 of the
# clipped gradient at the first step, then their mean) within 2^-4 of its
# L2 norm, and the parameters' update of the second step (the first has
# LR 0 on the warmup) within 2^-2 of its L2 norm: Adam moves each element
# by about the LR with its gradient's sign, which bf16 rounding flips
# where a gradient is within its noise of 0.  Each limit is about 3-5x
# the larger of two sound readings on an H100 80GB HBM3 at 700 W
# (seeds 0 and 1: loss 2.8e-5 and 2.4e-6, gradient norm 1.6e-4 and
# 4.3e-4, first moments 0.020 and 0.020, update 0.080 and 0.080); with
# the softmax's rescale dropped the same runs read 3.6e-5 and 3.2e-4,
# 0.033 and 0.039, 0.61 and 0.62, 0.93 and 0.94
# (scripts/planted_faults_torch.py --only train_long).
LONG_RTOL, LONG_GNORM_RTOL = 2.0 ** -13, 2.0 ** -9
LONG_MU_RTOL, LONG_UPDATE_RTOL = 2.0 ** -4, 2.0 ** -2


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))


def _long_runs(dev, n_layers, steps, seed):
    """The unchunked and the chunked run of ``train_long`` from the
    weights of ``seed``: per run its step rows, launches, peaks, final
    parameters and first moments; and the initial weights."""
    from repro_torch.core.policy import tree_leaves as leaves
    from repro_torch.kernels import launch_counts, reset_launch_counts
    out = {}
    for chunk in (0, LONG_CHUNK):
        torch.cuda.empty_cache()
        cfg, train_step, _, state = granite_trainer(
            dev, n_layers=n_layers, seed=seed, attn_chunk=chunk,
            logit_chunk=chunk)
        if not out:     # both runs start from these weights
            w0 = [x.detach().cpu() for x in leaves(state["params"])]
        pipe, _ = _pipeline(cfg, dev, 1, LONG_SEQ)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launch_counts()
        try:
            state, rows = _train_steps(train_step, state, pipe, steps)
        finally:
            pipe.close()
        peak = torch.cuda.max_memory_allocated()
        out[chunk] = dict(
            steps=rows, launches=launch_counts(),
            peak_memory_gib=peak / 2 ** 30,
            peak_above_state_gib=(peak - base) / 2 ** 30,
            params=[x.detach().cpu() for x in leaves(state["params"])],
            mu=[x.detach().cpu() for x in leaves(state["opt"]["mu"])])
        del state, train_step
    torch.cuda.empty_cache()
    return out[0], out[LONG_CHUNK], w0


def train_long(dev, n_layers=1, steps=2):
    """Granite-3-2B at full width, ``n_layers`` layers, bf16, LOTION int4
    decoupled, batch 1 x 8192: ``steps`` steps with streaming attention
    and the chunked head (``attn_chunk = logit_chunk = 1024``) against
    the unchunked steps, from the same weights and batches, once from the
    weights of each of ``LONG_SEEDS``.  Compared: each step's loss and
    gradient norm, the first moments and the parameters afterwards; peak
    device memory both ways; ``opt_step`` launches exact (11 per step)."""
    per_seed, counts_ok = {}, True
    for seed in LONG_SEEDS:
        u, c, w0 = _long_runs(dev, n_layers, steps, seed)
        want = dict.fromkeys(u["launches"], 0)
        want.update(opt_step=len(w0) * steps)
        counts_ok &= u["launches"] == want and c["launches"] == want
        per_seed[seed] = dict(
            loss=max(_rel(a["loss"], b["loss"]) for a, b in
                     zip(u["steps"], c["steps"])),
            grad_norm=max(_rel(a["grad_norm"], b["grad_norm"]) for a, b in
                          zip(u["steps"], c["steps"])),
            first_moment=max(_rel_l2(a, b) for a, b in zip(c["mu"],
                                                            u["mu"])),
            update=max(_rel_l2(a - w, b - w) for a, b, w in
                       zip(c["params"], u["params"], w0)
                       if not torch.equal(b, w)),
            unchunked={k: u[k] for k in ("steps", "peak_memory_gib",
                                         "peak_above_state_gib")},
            chunked={k: c[k] for k in ("steps", "peak_memory_gib",
                                       "peak_above_state_gib")})
        if seed == LONG_SEEDS[0]:
            launches, expected = c["launches"], want
        del u, c, w0
    worst = {k: max(r[k] for r in per_seed.values())
             for k in ("loss", "grad_norm", "first_moment", "update")}
    checks = {"loss": worst["loss"] <= LONG_RTOL,
              "grad_norm": worst["grad_norm"] <= LONG_GNORM_RTOL,
              "first_moment": worst["first_moment"] <= LONG_MU_RTOL,
              "update": worst["update"] <= LONG_UPDATE_RTOL,
              "counts": counts_ok}
    first = per_seed[LONG_SEEDS[0]]
    row = dict(phase="train_long", model="granite-3-2b", n_layers=n_layers,
               dtype="bfloat16", batch=1, seq=LONG_SEQ, chunk=LONG_CHUNK,
               method="lotion int4 per-tensor, decoupled, lam=1e3",
               seeds=list(LONG_SEEDS), unchunked=first["unchunked"],
               chunked=first["chunked"], per_seed=per_seed,
               loss_max_rel_diff=worst["loss"],
               grad_norm_max_rel_diff=worst["grad_norm"],
               first_moment_max_rel_l2=worst["first_moment"],
               update_max_rel_l2=worst["update"],
               rtol=LONG_RTOL, grad_norm_rtol=LONG_GNORM_RTOL,
               first_moment_rtol=LONG_MU_RTOL,
               update_rtol=LONG_UPDATE_RTOL, launches=launches,
               expected_launches=expected, checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError("train_long: chunked and unchunked disagree",
                             row)
    return row


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 7: the rest of the model zoo: CodeQwen1.5-7B, Gemma3-12B,
# MusicGen-medium's codebooks and the GShard MoE of DBRX-132B and
# Moonlight-16B-A3B, served from random weights
# --------------------------------------------------------------------------

# the QTensor matmuls (N, K) of the new configs that no Granite row has
ZOO_WQT = {(4096, 4096): "codeqwen", (13440, 4096): "codeqwen",
           (4096, 13440): "codeqwen", (4096, 3840): "gemma3",
           (2048, 3840): "gemma3", (3840, 4096): "gemma3",
           (15360, 3840): "gemma3", (3840, 15360): "gemma3",
           (1536, 1536): "musicgen", (6144, 1536): "musicgen",
           (1536, 6144): "musicgen", (2816, 2048): "moonlight",
           (2048, 2816): "moonlight", (6144, 6144): "dbrx",
           (1024, 6144): "dbrx"}
# decode at batch 8, a prefill-sized M
ZOO_WQT_MS = (8, 256)
# Gemma3 serves fp32 activations (``emb_scale``'s fp32 scalar promotes the
# residual stream, as in JAX), so its matmuls take the fp32 ``fma``
# instance: decode at batch 8 and serve_archs' 8 x 1,536-token prefill
ZOO_WQT_FP32_MS = (8, 8 * 1536)
# Moonlight's scheduler prefills one slot at a time: prompts of 72-128
# tokens through its shared experts under int8 activations
ZOO_A8_PREFILL_MS = (72, 128)
# decode attention of the new configs: (model, L, g, rep, hd, window,
# query dtype); Gemma3's fp32 queries are what its serving path runs, the
# bf16 ones the hd-256 instance beside them
F32, BF16 = torch.float32, torch.bfloat16
ZOO_ATTN = [("codeqwen", 2048, 32, 1, 128, None, BF16),
            ("gemma3 local", 1024, 8, 2, 256, 1024, F32),
            ("gemma3 global", 2048, 8, 2, 256, None, F32),
            ("gemma3 local", 1024, 8, 2, 256, 1024, BF16),
            ("gemma3 global", 2048, 8, 2, 256, None, BF16),
            ("musicgen", 256, 24, 1, 64, None, BF16),
            ("moonlight", 256, 16, 1, 128, None, BF16),
            ("dbrx", 256, 8, 6, 128, None, BF16)]
ZOO_PAGED = [("moonlight", 16, 16, 16, 1, 128, BF16),
             ("gemma3", 16, 16, 8, 2, 256, F32),
             ("gemma3", 16, 16, 8, 2, 256, BF16)]
# one Moonlight expert leaf at the serve_moe depth: 12 x 64 x 2048 x 1408
# = 2.2e9 elements, past 2^31
MOE_LAYERS = 12
MOE_LEAF = (MOE_LAYERS, 64, 2048, 1408)
# the 3-D QTensor matmul at the decode shapes of the MoE configs' experts:
# (model, E, M = capacity at 8 tokens, N, K)
QT3D = [("moonlight", 64, 6, 1408, 2048), ("moonlight", 64, 6, 2048, 1408),
        ("dbrx", 16, 4, 10752, 6144), ("dbrx", 16, 4, 6144, 10752)]
# card against CPU in fp32 (TF32 off): the prefill's logits differ by
# summation order only; a decode step also reads the int8 KV cache, whose
# codes the two sides round from K and V that differ in their last bits,
# so a value on a rounding boundary moves by one code (1/127 of its
# vector's absmax).  Measured on an H100, worst decode step over the
# largest logit: CodeQwen (2 layers) 4.6e-4, Moonlight (2) 2.4e-4,
# MusicGen (2) 7.7e-5, Gemma3 (6) 3.3e-5; the limit is about twice the
# worst.  Attention that leaves out each row's newest slot on the card
# (scripts/planted_faults_torch.py, ``attn_drops_newest``) fails it.
ZOO_CPU_RTOL = 1e-4
ZOO_KV_RTOL = 1e-3
# a router near tie: the k-th and (k+1)-th probabilities closer than this
# fraction of the k-th (fp32 logits of the two sides differ in the last
# bits, about 1e-6 of their size)
ROUTER_TIE_RTOL = 1e-4


def zoo_cfg(arch, n_layers=None, dtype=None):
    """A config of the port at full width, its depth cut to ``n_layers``
    and its activations in ``dtype`` where given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    kw = {k: v for k, v in (("n_layers", n_layers), ("dtype", dtype)) if v}
    return dataclasses.replace(cfg, **kw) if kw else cfg


def check_zoo_kernels(timer, dev):
    """The serving kernels at the new configs' shapes: ``wqt_matmul`` at
    every new (N, K) in bf16, and at Gemma3's in fp32 at its decode and
    prefill M; ``wqt_matmul_a8_x`` at every new (N, K), and at Moonlight's
    shared-expert ones at its per-slot prefill M; ``decode_attn`` at hd
    128 (rep 1, 6) and 256 (rep 2, ``fma``: the ``mma`` instance takes hd
    up to 128; fp32 queries as Gemma3 serves them, and bf16) with Gemma3's
    1024-slot local ring wrapped; ``decode_attn_paged`` at hd 128 and 256;
    and ``quant`` on one Moonlight expert leaf of more than 2^31
    elements."""
    from repro_torch.core.qtensor import quantize_qtensor
    from repro_torch.kernels.wq_matmul import dequant_t_ref
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = []
    for (n, k), model in ZOO_WQT.items():
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        for bits in (4, 8):
            qt = quantize_qtensor(w, f"int{bits}", -1)
            w_lib = dequant_t_ref(qt.codes, qt.scales, -1, bits == 4)
            cases = [(m, BF16) for m in (ZOO_WQT_MS if bits == 4
                                         else ZOO_WQT_MS[:1])]
            if model == "gemma3" and bits == 4:
                cases += [(m, F32) for m in ZOO_WQT_FP32_MS]
            for m, dtype in cases:
                rows.append(dict(check_wqt_one(
                    timer, gen, dev, qt, w_lib, m=m, n=n, k=k, bits=bits,
                    block_k=-1, dtype=dtype), model=model))
            del qt, w_lib
        a8_ms = (8,) + (ZOO_A8_PREFILL_MS if model == "moonlight" else ())
        for m in a8_ms:
            rows.append(dict(check_a8_x_one(timer, gen, dev, m=m, n=n, k=k,
                                            bits=4, block_k=-1),
                             model=model))
        del w
        torch.cuda.empty_cache()
    for model, L, g, rep, hd, window, dtype in ZOO_ATTN:
        pos = torch.tensor([0, 5, L // 3, L - 1, L, L + 7, 2 * L + 3,
                            5 * L - 2], dtype=torch.int32, device=dev)
        rows.append(dict(check_attn_one(
            timer, gen, dev, b=8, L=L, g=g, rep=rep, hd=hd, bits=8,
            window=window, softcap=None, pos=pos, dtype=dtype), model=model))
    for model, bs, bps, g, rep, hd, dtype in ZOO_PAGED:
        L = bs * bps
        pos = torch.tensor([0, 5, L // 3, L - 1, L, L + 7, 2 * L + 3,
                            5 * L - 2], dtype=torch.int32, device=dev)
        rows.append(dict(check_paged_one(
            timer, gen, dev, b=8, bs=bs, bps=bps, g=g, rep=rep, hd=hd,
            bits=8, window=None, softcap=None, pos=pos, dtype=dtype),
            model=model))
    torch.cuda.empty_cache()
    rows.append(dict(check_quant_one(timer, gen, dev, MOE_LEAF, "int4", -1,
                                     False), model="moonlight"))
    torch.cuda.empty_cache()
    return rows


def check_moe_qt3d(timer, dev):
    """The 3-D QTensor matmul (x (E, M, K) against an (E, N, K) expert
    stack, one kernel launch per expert) against its plain version at the
    MoE configs' expert shapes, int4 and int8, per-matrix and block-128
    scales, bf16 activations (``wqt_matmul``, within 2^-7 of the largest
    output) and int8 activations (``wqt_matmul_a8_x``, bitwise)."""
    from repro_torch.core.qtensor import (matmul, qtensor_act_fmt,
                                          quantize_qtensor)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.wq_matmul import (dequant_t_ref,
                                               wqt_matmul_a8_x_ref,
                                               wqt_matmul_ref)
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = []
    for model, e, m, n, k in QT3D:
        w = torch.randn((e, n, k), generator=gen, device=dev) / math.sqrt(k)
        x = torch.randn((e, m, k), generator=gen, device=dev).to(
            torch.bfloat16)
        for bits in (4, 8):
            for bk in (-1, 128):
                qt = quantize_qtensor(w, f"int{bits}", bk)
                w_lib = dequant_t_ref(qt.codes, qt.scales, bk,
                                      bits == 4).to(torch.bfloat16)
                for act in (None, "int8"):
                    kernel = "wqt_matmul_a8" if act else "wqt_matmul"

                    def run():
                        with qtensor_act_fmt(act):
                            return matmul(x, qt)

                    def plain():
                        ref = wqt_matmul_a8_x_ref if act else wqt_matmul_ref
                        return ref(x, qt.codes, qt.scales, bk, bits == 4)

                    reset_launch_counts()
                    got = run()
                    launches = launch_counts()
                    want = plain()
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    tol = 0.0 if act else rel_tol(torch.bfloat16) * float(
                        want.float().abs().max())
                    row = dict(phase="check", kernel="qt3d", model=model,
                               E=e, M=m, N=n, K=k, bits=bits, block_k=bk,
                               act_fmt=act, dtype="bfloat16",
                               launches=launches[kernel],
                               max_abs_err=err, tol=tol,
                               bitwise=_same_bits(got, want))
                    ok = (err <= tol and torch.isfinite(got).all()
                          and launches[kernel] == e
                          and sum(launches.values()) == e
                          and (row["bitwise"] or not act))
                    if not ok:
                        emit(row)
                        raise AssertionError(f"3-D QTensor matmul: {row}")
                    nbytes = x.numel() * 2 + qt.nbytes + e * m * n * 2
                    b_ms, b_by = bound(nbytes, 2.0 * e * m * n * k,
                                       INT8_OPS if act else BF16_FLOPS)
                    row.update(ms=timer(run), plain_ms=timer(plain, iters=3),
                               library_ms=None if act else timer(
                                   lambda: torch.bmm(x, w_lib.transpose(
                                       1, 2))),
                               bound_ms=b_ms, bound_by=b_by)
                    emit(row)
                    rows.append(row)
                del qt, w_lib
        del w, x
        torch.cuda.empty_cache()
    return rows


def _n_qt_matmuls(cfg):
    """QTensor matmuls per layer of a forward under the default serving
    policy: q, k, v, o and the MLP's (shared experts' for MoE; the routed
    experts are dense casts and the router is no matmul leaf)."""
    mlp = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    if cfg.ffn == "moe":
        mlp = mlp if cfg.n_shared_experts else 0
    return 4 + mlp


def _qt_per_forward(cfg, include_embeddings=False):
    """QTensor matmuls of one forward under the default serving policy:
    ``_n_qt_matmuls`` per attention layer, none for a mamba or rwkv block
    (the packer keeps their projections dense), the shared block's
    (Zamba2: q, k, v, o and its MLP) once per unit, and the head where
    the embeddings are quantized."""
    attn = sum(kind in ("attn", "local") for kind in cfg.pattern)
    units = attn + (1 if cfg.shared_attn_every else 0)
    return _n_qt_matmuls(cfg) * units * cfg.n_repeats + int(
        include_embeddings)


def _attn_per_step(cfg):
    """``decode_attn`` launches of one decode step: one per attention
    layer and one per unit's shared block."""
    attn = sum(kind in ("attn", "local") for kind in cfg.pattern)
    return (attn + (1 if cfg.shared_attn_every else 0)) * cfg.n_repeats


# eligible leaves per block kind that the packer keeps dense: Mamba2's
# in_proj, out_proj, conv_w and conv_b (a (repeats, conv_dim) matrix once
# stacked); RWKV6's five time-mix and three channel-mix projections
SSM_DENSE_LEAVES = {"mamba": 4, "rwkv": 8}


def _dense_cast_leaves(cfg):
    """Eligible leaves that the packer cannot make QTensors and casts
    through ``quant`` instead: per block kind of an MoE config, the router
    and the 4-D expert stacks; the SSM blocks' projections."""
    n = sum(SSM_DENSE_LEAVES.get(kind, 0) for kind in cfg.pattern)
    if cfg.ffn != "moe":
        return n
    return n + len(cfg.pattern) * (4 if cfg.mlp_kind in ("swiglu", "geglu")
                                   else 3)


def _step_bytes(cfg, params):
    """Weight bytes of one decode step: each stored matrix read once (the
    function's bound), and as the port moves them: a dense fp32 matrix
    (dense-cast experts, a router, an fp32 head) is read, cast to bf16,
    written and read again on every call.  An untied embedding is only
    gathered; vectors (norm scales) are left out."""
    from repro_torch.core.policy import tree_map_with_path
    from repro_torch.core.qtensor import QTensor
    total = [0, 0]

    def leaf(path, x):
        if isinstance(x, QTensor):
            total[0] += x.nbytes
            total[1] += x.nbytes
        elif x.ndim >= 2 and (path[-1] != "embed" or cfg.tie_embeddings):
            n = x.numel() * x.element_size()
            total[0] += n
            total[1] += n + (4 * x.numel() if cfg.dtype == torch.bfloat16
                             and x.element_size() == 4 else 0)
    tree_map_with_path(leaf, params)
    return tuple(total)


def _serve_static(dev, cfg, *, seed, prompts, mnt, why,
                  include_embeddings=False):
    """Static ``Engine`` serving of ``cfg`` from random weights of
    ``seed``: int4 QTensor weights (MoE expert stacks and routers, and
    the SSM blocks' projections, as the dense RTN cast through ``quant``;
    the embedding and head too with ``include_embeddings``), int8 KV,
    greedy.  Launches are counted over the weight preparation and over
    the generation; returns (row, engine)."""
    from repro_torch.core import param_nbytes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import lm_init
    from repro_torch.serve import Engine, ServeConfig
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_init(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s, fp32_bytes = time.perf_counter() - t0, param_nbytes(params)
    reset_launch_counts()
    t0 = time.perf_counter()
    eng = Engine(cfg, params, ServeConfig(
        weights="rtn:int4", kv_quant="int8", max_new_tokens=mnt,
        include_embeddings=include_embeddings), device=dev)
    torch.cuda.synchronize()
    prepare_s, prep_counts = time.perf_counter() - t0, launch_counts()
    del params
    prepare_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    eng.generate(prompts[:2], max_new_tokens=2)               # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts)
    torch.cuda.synchronize()
    gen_s, counts = time.perf_counter() - t0, launch_counts()
    gen_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=1)                   # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    want = dict.fromkeys(counts, 0)
    want.update(wqt_matmul=_qt_per_forward(cfg, include_embeddings) * mnt,
                decode_attn=_attn_per_step(cfg) * (mnt - 1))
    want_prep = dict.fromkeys(counts, 0)
    want_prep.update(quant=_dense_cast_leaves(cfg))
    stored, moved = _step_bytes(cfg, eng.params)
    checks = {"launches": counts == want, "prepare_launches":
              prep_counts == want_prep,
              "budgets": [len(o) for o in outs] == [mnt] * len(prompts),
              "vocab": all(0 <= t < cfg.vocab for o in outs for t in o)}
    row = dict(model=cfg.name, n_layers=cfg.n_layers,
               full_n_layers=zoo_cfg(cfg.name).n_layers, depth_reason=why,
               d_model=cfg.d_model, dtype=str(cfg.dtype), weights="rtn:int4",
               include_embeddings=include_embeddings,
               kv_quant="int8", batch=len(prompts),
               prompt_lens=sorted({len(p) for p in prompts}),
               max_new_tokens=mnt, fp32_gb=fp32_bytes / 1e9,
               served_gb=param_nbytes(eng.params) / 1e9, init_s=init_s,
               prepare_s=prepare_s, prepare_launches=prep_counts,
               expected_prepare_launches=want_prep,
               prepare_peak_gib=prepare_peak / 2 ** 30,
               generate_s=gen_s, prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=(gen_s - prefill_s) * 1e3 / (mnt - 1),
               tok_per_s=len(prompts) * mnt / gen_s,
               decode_step_weight_gb=stored / 1e9,
               decode_step_bound_ms=stored / HBM_BYTES_PER_S * 1e3,
               decode_step_moved_gb=moved / 1e9,
               decode_step_moved_bound_ms=moved / HBM_BYTES_PER_S * 1e3,
               launches=counts, expected_launches=want,
               generate_peak_gib=gen_peak / 2 ** 30,
               first_tokens=[o[:8] for o in outs[:2]], checks=checks)
    return row, eng


@contextlib.contextmanager
def _recorded_routes():
    """Every ``moe_route`` call's top-k experts, capacity verdicts, queue
    positions and each token's router margin (the k-th probability less
    the (k+1)-th), in call order."""
    from repro_torch.models import layers
    orig, calls = layers.moe_route, []

    def route(router, spec, xt, *args, **kw):
        r = orig(router, spec, xt, *args, **kw)
        top = torch.topk(r["probs"], spec.top_k + 1, dim=-1).values
        calls.append(dict(topi=r["topi"].cpu(), keep=r["keep"].cpu(),
                          pos=r["pos"].cpu(),
                          pk=top[..., -2].cpu(),
                          margin=(top[..., -2] - top[..., -1]).cpu()))
        return r

    layers.moe_route = route
    try:
        yield calls
    finally:
        layers.moe_route = orig


def _compare_routes(card, cpu):
    """The first routing call where the card and the CPU part, and whether
    near ties of the router's top-k explain it: every token whose top-k
    differs has a CPU margin within ``ROUTER_TIE_RTOL`` of its k-th
    probability, and in every group that parts the first token that
    differs is one whose top-k differs (capacity verdicts and queue
    positions follow from the top-k of the tokens before them).  None
    when they never part."""
    if len(card) != len(cpu):
        return dict(call=None, near_tie=False, reason="call counts differ")
    for i, (a, c) in enumerate(zip(card, cpu)):
        topi_diff = (a["topi"] != c["topi"]).any(-1)           # (g, t)
        differ = topi_diff | ((a["keep"] != c["keep"])
                              | (a["pos"] != c["pos"])).any(-1)
        if not differ.any():
            continue
        near = c["margin"] <= ROUTER_TIE_RTOL * c["pk"]
        first = differ.int().argmax(-1)                        # (g,)
        led = all(bool(topi_diff[g, first[g]])
                  for g in range(differ.shape[0]) if differ[g].any())
        explained = led and bool(near[topi_diff].all())
        return dict(call=i, near_tie=explained, groups_led_by_topk=led,
                    tokens_differ=int(differ.sum()),
                    tokens_topi_differ=int(topi_diff.sum()),
                    tokens_topi_differ_near_tie=int((topi_diff & near).sum()),
                    max_margin_over_pk=float(
                        (c["margin"] / c["pk"])[topi_diff].max())
                    if topi_diff.any() else None)
    return None


def _cut_vs_cpu(dev, cfg, *, seed, prompts, steps, why,
                rtol=(ZOO_CPU_RTOL, ZOO_KV_RTOL), phase=None,
                state_rtol=None, images=None, cross_rtol=None):
    """``cfg`` (TF32 off) from the same random weights on the card and on
    the CPU, int4 QTensor weights and int8 KV as served: prefill of the
    left-padded prompts (per-row ``prompt_lens`` where the Engine masks
    pads: attention-only dense-FFN configs) and ``steps`` greedy decode
    steps, both sides fed the CPU's tokens.  The prefill's logits within
    ``rtol[0]`` of the CPU's largest, each decode step's within
    ``rtol[1]``; where the greedy tokens part, the CPU's top two logits
    are closer than twice that.  For MoE configs the routing (top-k,
    capacity verdicts, queue positions) is equal, or parts first at near
    ties shown for every token whose top-k differs; the steps from the
    one that parts are then not held, every step before it is.  With
    ``state_rtol`` the recurrent states after the prefill (each ``ssm``
    and ``wkv`` leaf) are held within that fraction of the CPU's largest
    value of the leaf.  ``images`` (b, n_image_tokens, d_vision), on the
    CPU, feed both sides' prefill (the gates of a vision config are drawn
    from ``seed``), and with ``cross_rtol`` the cross K/V the prefill
    caches are held within that fraction of the CPU's largest value.
    Returns the row (emitted, with ``phase``, where given); raises
    AssertionError(message, row) on a failure."""
    from repro_torch import bridge
    from repro_torch.core.policy import tree_map_with_path
    from repro_torch.models.lm import lm_decode, lm_init, lm_prefill
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.engine import (attn_only, bucket_cache_len,
                                          prepare_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    params = lm_init(cfg, seed=seed, device=dev)
    open_gates(params, cfg, seed)
    cpu_params = tree_map_with_path(lambda p, x: x.cpu(), params)
    scfg = ServeConfig(weights="rtn:int4", kv_quant="int8")
    card_p = prepare_params(params, scfg, dev)
    del params
    cpu_p = prepare_params(cpu_params, scfg, "cpu")
    del cpu_params
    b, width = len(prompts), max(len(p) for p in prompts)
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = np.zeros((b, width) + books, np.int64)
    for i, p in enumerate(prompts):
        toks[i, width - len(p):] = p
    lens = [len(p) for p in prompts]
    masked = attn_only(cfg)
    cache_len = bucket_cache_len(width + steps)

    def run(p, device, feed=None):
        out, fed = [], []
        with torch.inference_mode():
            lg, cache = lm_prefill(
                p, cfg, torch.as_tensor(toks, device=device),
                cache_len=cache_len, kv_quant="int8",
                prompt_lens=torch.tensor(lens, device=device)
                if masked else None,
                image_embeds=None if images is None else images.to(device))
            # copies: decode updates the cache in place
            flat = bridge.flatten(cache)
            states.append({k: v.float().cpu().clone() for k, v in
                           flat.items()
                           if k.rsplit("/", 1)[-1] in ("ssm", "wkv")})
            crosses.append({k: v.float().cpu() for k, v in flat.items()
                            if "_xattn/" in k})
            pos = torch.tensor(lens if masked else [width] * b,
                               device=device) - 1
            for s in range(steps + 1):
                out.append(lg.float().cpu())
                if s == steps:
                    break
                tok = feed[s] if feed is not None else \
                    lg[:, 0].argmax(-1).cpu()
                fed.append(tok)
                pos = pos + 1
                lg, cache = lm_decode(p, cfg, cache,
                                      tok.to(device)[:, None].long(), pos)
        return out, fed

    states, crosses = [], []
    with _recorded_routes() as cpu_routes:
        cpu_out, fed = run(cpu_p, torch.device("cpu"))
    with _recorded_routes() as card_routes:
        card_out, _ = run(card_p, dev, feed=fed)
    scale = max(float(c.abs().max()) for c in cpu_out)
    tols = [rtol[min(s, 1)] * scale for s in range(len(cpu_out))]
    errs = [float((g - c).abs().max()) for g, c in zip(card_out, cpu_out)]
    partings = []
    for s, (g, c) in enumerate(zip(card_out, cpu_out)):
        gt, ct = g[:, 0].argmax(-1), c[:, 0].argmax(-1)
        if not torch.equal(gt, ct):
            top2 = torch.topk(c[:, 0], 2, dim=-1).values
            gap = (top2[..., 0] - top2[..., 1])[gt != ct]
            partings.append(dict(step=s, cpu_top2_gap=float(gap.max()),
                                 tol=tols[s]))
    routes = _compare_routes(card_routes, cpu_routes) if card_routes \
        or cpu_routes else None
    drops = (sum(int((~c["keep"]).sum()) for c in cpu_routes)
             if cpu_routes else None)
    # routing that parts at shown near ties stops the holding at the step
    # of the call that parts (every step makes the same number of routing
    # calls); parting anywhere else fails
    held = len(errs)
    if routes is not None and routes["near_tie"]:
        held = routes["call"] // (len(cpu_routes) // len(errs))
    ok = ((routes is None or routes["near_tie"])
          and all(e <= t for e, t in zip(errs[:held], tols))
          and all(p["cpu_top2_gap"] <= 2 * p["tol"] for p in partings
                  if p["step"] < held))
    if cfg.ffn == "moe":
        ok = ok and drops > 0
    state_err = {k: float((states[1][k] - c).abs().max()
                          / c.abs().max().clamp_min(1e-30))
                 for k, c in states[0].items()}
    if state_rtol is not None:
        ok = ok and bool(state_err) and max(state_err.values()) <= state_rtol
    cross_err = {k: float((crosses[1][k] - c).abs().max()
                          / c.abs().max().clamp_min(1e-30))
                 for k, c in crosses[0].items()}
    if cross_rtol is not None:
        ok = ok and bool(cross_err) and max(cross_err.values()) <= cross_rtol
    row = dict(model=cfg.name, n_layers=cfg.n_layers, depth_reason=why,
               dtype=str(cfg.dtype).replace("torch.", ""), weights="rtn:int4",
               kv_quant="int8", batch=b, prompt_lens=lens, steps=steps,
               max_abs_logit=scale, tol=tols, max_abs_logit_err=max(errs),
               per_step_err=errs, held_steps=held, partings=partings,
               greedy_tokens_identical=not partings,
               routing=None if not cpu_routes else dict(
                   calls=len(cpu_routes), parted=routes,
                   cpu_dropped_choices=drops),
               **({} if state_rtol is None else dict(
                   state_rtol=state_rtol, state_rel_err=state_err)),
               **({} if cross_rtol is None else dict(
                   cross_kv_rtol=cross_rtol, cross_kv_rel_err=cross_err)),
               ok=bool(ok))
    if phase:
        row = dict(phase=phase, **row)
        emit(row)
    if not ok:
        raise AssertionError(f"{cfg.name}: card and CPU disagree", row)
    return row


def _sched_run(dev, cfg, params, *, paged=False, include_embeddings=False):
    """The continuous-batching Scheduler on a prepared tree: int8 KV (a
    ring, or the paged pool in blocks of 16), per-slot prefill, int8
    activations (``wqt_matmul_a8``), 8 slots, the 16 requests of
    ``sched_workload``; launches derived from the schedule.  Returns
    (row, checks)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (COMPLETED, Scheduler, SchedulerConfig,
                                   ServeConfig, check_drained)
    from repro_torch.serve.replay import replay_continuous
    sched = dict(n_slots=8, steps_per_tick=4, cache_len=256, paged=paged,
                 block_size=16)
    sch = Scheduler(cfg, params, ServeConfig(weights="fp32", kv_quant="int8",
                                             act_fmt="int8",
                                             max_new_tokens=32),
                    SchedulerConfig(**sched), device=dev)
    sch.generate(_prompts(np.random.default_rng(5), 2, 20, 40, cfg.vocab),
                 max_new_tokens=5)                           # warm-up
    wl = sched_workload(cfg.vocab)
    before = dict(ticks=sch.n_ticks, prefills=sch.n_prefills,
                  rid=sch._next_rid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rec = replay_continuous(sch, wl)
    torch.cuda.synchronize()
    counts = launch_counts()
    ticks = sch.n_ticks - before["ticks"]
    prefills = sch.n_prefills - before["prefills"]
    k = sch.sched.steps_per_tick
    want = dict.fromkeys(counts, 0)
    want.update({"wqt_matmul_a8": _qt_per_forward(cfg, include_embeddings)
                 * (ticks * k + prefills),
                 "decode_attn_paged" if paged else "decode_attn":
                 _attn_per_step(cfg) * ticks * k})
    rids = range(before["rid"], before["rid"] + len(wl))
    outs = [sch.requests[r].out for r in rids]
    total = sum(len(o) for o in outs)
    lat = np.asarray([rec["latency"][i] for i in sorted(rec["latency"])])
    checks = {
        "completed": all(sch.requests[r].state == COMPLETED for r in rids),
        "budgets": [len(o) for o in outs] == [w.max_new_tokens for w in wl],
        "vocab": all(0 <= t < cfg.vocab for o in outs for t in o),
        "drained": check_drained(sch) == [],
        "launches": counts == want}
    row = dict(requests=len(wl), include_embeddings=include_embeddings,
               kv_quant="int8", act_fmt="int8", sched=sched,
               prompt_lens=[len(w.prompt) for w in wl],
               makespan_s=rec["makespan"], tokens=total,
               tok_per_s=total / rec["makespan"],
               latency_p50_s=float(np.percentile(lat, 50)),
               latency_p95_s=float(np.percentile(lat, 95)),
               ticks=ticks, decode_steps=ticks * k, prefills=prefills,
               launches=counts, expected_launches=want,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               request_tokens=outs)
    del sch
    return row, checks


def serve_moe(dev):
    """Moonlight-16B-A3B as the repo configures it (48 layers; 64 experts
    top-6, d_ff 1408, 2 shared experts, vocab 163,840) at full width, cut
    to 12 layers: its fp32 tree is 2.21 GB of experts a layer and the
    dense cast writes a second copy of them, 57 GB at 12 layers (76 GB at
    16).  Run 1: the static Engine (int4 QTensors for attention and the
    shared experts, the dense RTN cast of the routers and expert stacks
    through ``quant``, int8 KV), batch 8, 32 new tokens.  Run 2: the
    continuous-batching Scheduler on the same prepared tree, paged int8
    KV, per-slot prefill (MoE refuses chunking), int8 activations
    (``wqt_matmul_a8``), 16 requests.  Then dead decode rows: the live
    row's logits are the same whether the masked rows hold zeros or
    copies of the live row (unmasked, the copies would take every slot of
    its experts first).  Last, DBRX-132B at 2 full-width layers (16
    experts top-4, d_ff 10,752: 12.7 GB of fp32 experts a layer), static
    serving only."""
    from repro_torch.models.lm import (cache_insert, init_cache, lm_decode,
                                       lm_prefill)
    cfg = zoo_cfg("moonshot-v1-16b-a3b", MOE_LAYERS)
    prompts = _prompts(np.random.default_rng(7), 8, 64, 128, cfg.vocab)
    static, eng = _serve_static(
        dev, cfg, seed=0, prompts=prompts, mnt=32,
        why="fp32 tree 2.21 GB of experts a layer plus their dense cast: "
            "57 GB at 12 layers, 76 GB at 16")
    checks = {f"static_{k}": v for k, v in static.pop("checks").items()}

    sched, sc = _sched_run(dev, cfg, eng.params, paged=True)
    checks.update({f"sched_{k}": v for k, v in sc.items()})

    # dead rows: the live row in the last of 8 slots, masked rows holding
    # zeros or copies of the live row
    seq = prompts[0][:40]
    n, cl = 8, 64
    with torch.inference_mode():
        _, row = lm_prefill(eng.params, cfg, torch.tensor([seq], device=dev),
                            cache_len=cl, kv_quant="int8")
        mask = torch.tensor([False] * (n - 1) + [True], device=dev)
        live = {}
        for fill in ("zeros", "copies"):
            pool = init_cache(cfg, n, cl, dtype=cfg.dtype, kv_quant="int8",
                              device=dev)
            for s in (range(n) if fill == "copies" else [n - 1]):
                cache_insert(pool, row, s)
            tok = torch.full((n, 1), seq[-1] if fill == "copies" else 0,
                             device=dev)
            tok[-1, 0] = seq[-1]
            pos = torch.full((n,), len(seq) if fill == "copies" else 0,
                             device=dev)
            pos[-1] = len(seq)
            logits, _ = lm_decode(eng.params, cfg, pool, tok, pos,
                                  token_mask=mask)
            live[fill] = logits[-1].float()
    # masked rows meet the live row only through sums of exact zeros, so
    # its logits are held bitwise, as the CPU twin holds them
    dead = dict(max_abs_diff=float((live["zeros"] - live["copies"]).abs()
                                   .max()),
                bitwise=bool(torch.equal(live["zeros"], live["copies"])))
    checks["dead_rows_invariant"] = dead["bitwise"]
    del eng, row, pool
    torch.cuda.empty_cache()

    dcfg = zoo_cfg("dbrx-132b", 2)
    dprompts = _prompts(np.random.default_rng(8), 8, 64, 128, dcfg.vocab)
    dbrx, deng = _serve_static(
        dev, dcfg, seed=0, prompts=dprompts, mnt=32,
        why="12.7 GB of fp32 experts a layer plus their dense cast")
    checks.update({f"dbrx_{k}": v for k, v in dbrx.pop("checks").items()})
    del deng
    torch.cuda.empty_cache()
    out = dict(phase="serve_moe", static=static, sched=sched,
               dead_rows=dead, dbrx=dbrx, checks=checks)
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"serve_moe failed its checks: {checks}", out)
    return out


def serve_moe_card_vs_cpu(dev, n_layers=2):
    """Moonlight at 2 full-width layers, fp32 activations: the same
    left-padded prompts (4 of 48-64 tokens, so that the prefill's groups
    drop choices past their capacity) on the card and on the CPU, prefill
    and 4 greedy decode steps (``_cut_vs_cpu``)."""
    cfg = zoo_cfg("moonshot-v1-16b-a3b", n_layers, "float32")
    prompts = _prompts(np.random.default_rng(9), 4, 48, 64, cfg.vocab)
    row = _cut_vs_cpu(dev, cfg, seed=5, prompts=prompts, steps=4,
                      why="the CPU side: 2.21 GB of fp32 experts a layer, "
                          "read on every step",
                      phase="serve_moe_card_vs_cpu")
    torch.cuda.empty_cache()
    return row


def serve_archs(dev):
    """CodeQwen1.5-7B (32 layers, MHA at head_dim 128, untied 92,416-row
    head; 7.2B parameters, 29 GB fp32) at full width and depth and
    Gemma3-12B (5 local layers of window 1024 per global one, QK-norm,
    two RoPE thetas, head_dim 256, tied 262,144-row embedding) at full
    width and 24 of its 48 layers (4 units; cut in PR 25 for the script's
    time limit: its fp32 prefill took 11.6 s at 48) through the static
    Engine: int4 weights, int8 KV, batch 8, 32 new tokens; Gemma3 with
    1,536-token prompts, so that its local rings wrap."""
    out = dict(phase="serve_archs")
    checks = {}
    for arch, n_layers, lo, hi in (("codeqwen1.5-7b", None, 64, 128),
                                   ("gemma3-12b", 24, 1536, 1536)):
        cfg = zoo_cfg(arch, n_layers)
        prompts = _prompts(np.random.default_rng(10), 8, lo, hi, cfg.vocab)
        row, eng = _serve_static(dev, cfg, seed=0, prompts=prompts, mnt=32,
                                 why="full depth" if n_layers is None
                                 else CUT_FOR_TIME)
        del eng
        checks.update({f"{arch}_{k}": v for k, v in row.pop("checks")
                       .items()})
        out[arch] = row
        torch.cuda.empty_cache()
    out["checks"] = checks
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"serve_archs failed its checks: {checks}", out)
    return out


def serve_archs_card_vs_cpu(dev):
    """CodeQwen1.5-7B at 1 full-width layer (two ragged prompts) and
    Gemma3-12B at 6 (its unit of 5 local and 1 global layer, one prompt
    past the window; two until PR 25, cut for the script's time limit) on
    the card against the CPU (``_cut_vs_cpu``, fp32)."""
    out = dict(phase="serve_archs_card_vs_cpu")
    checks = {}
    cuts = (("codeqwen1.5-7b", 1, 2, (16, 32)),
            ("gemma3-12b", 6, 1, (1030, 1100)))
    for arch, n_layers, n_prompts, (lo, hi) in cuts:
        cfg = zoo_cfg(arch, n_layers, "float32")
        prompts = _prompts(np.random.default_rng(11), n_prompts, lo, hi,
                           cfg.vocab)
        try:
            cut = _cut_vs_cpu(dev, cfg, seed=1, prompts=prompts, steps=3,
                              why="the CPU side's time")
        except AssertionError as e:
            cut = e.args[1]
        checks[arch] = cut["ok"]
        out[arch] = cut
    out["checks"] = checks
    emit(out)
    if not all(checks.values()):
        raise AssertionError(
            f"serve_archs_card_vs_cpu failed its checks: {checks}", out)
    return out


# MusicGen: prefill and decode against the full forward on the same card,
# bf16 across 48 layers: test_archs.py's prefill->decode tolerance (2e-2 of
# the largest logit) with a dense cache; 5e-2 with the int8 cache, whose
# codes add their rounding (the card_vs_cpu tolerance of bf16 serving)
MUSICGEN_DENSE_RTOL = 2e-2
MUSICGEN_INT8_RTOL = 5e-2


def musicgen_decode(dev, b=4, l=64, steps=16):
    """MusicGen-medium at full width and depth (48 layers, 1.5B
    parameters, 4 codebooks summed at the embedding, one head per
    codebook): int4 QTensor attention and MLP, ``lm_prefill`` of (b, l, 4)
    frames then 16 ``lm_decode`` steps of (b, 1, 4) frames, each step's
    (b, 1, 4, 2048) logits against ``lm_forward``'s at that position on the
    same card, with a dense bf16 cache and with the int8 cache
    (``decode_attn``); then 2 layers on the card against the CPU."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import (lm_decode, lm_forward, lm_init,
                                       lm_prefill)
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.engine import prepare_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = zoo_cfg("musicgen-medium")
    C = cfg.n_codebooks
    params = prepare_params(lm_init(cfg, seed=0, device=dev),
                            ServeConfig(weights="rtn:int4"), dev)
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab, (b, l + steps, C)), device=dev)
    with torch.inference_mode():
        full = lm_forward(params, cfg, toks)[:, l - 1:].float()
    checks, runs = {}, {}
    for kv, rtol in ((False, MUSICGEN_DENSE_RTOL),
                     ("int8", MUSICGEN_INT8_RTOL)):
        with torch.inference_mode():                          # warm-up
            lm_prefill(params, cfg, toks[:, :8], cache_len=16, kv_quant=kv)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            lg, cache = lm_prefill(params, cfg, toks[:, :l],
                                   cache_len=l + steps, kv_quant=kv)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            got = [lg.float()]
            t0 = time.perf_counter()
            for s in range(steps):
                lg, cache = lm_decode(params, cfg, cache,
                                      toks[:, l + s:l + s + 1],
                                      torch.full((b,), l + s, device=dev))
                got.append(lg.float())
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        counts = launch_counts()
        got = torch.cat(got, dim=1)                      # (b, 1 + steps, C, V)
        want = dict.fromkeys(counts, 0)
        want.update(wqt_matmul=_n_qt_matmuls(cfg) * cfg.n_layers
                    * (1 + steps),
                    decode_attn=cfg.n_layers * steps if kv else 0)
        scale = float(full.abs().max())
        err = float((got - full).abs().max())
        name = "int8_kv" if kv else "dense_kv"
        runs[name] = dict(
            kv_quant=kv, shape=list(got.shape), max_abs_logit=scale,
            max_abs_err=err, tol=rtol * scale,
            argmax_agreement=float((got.argmax(-1) == full.argmax(-1))
                                   .float().mean()),
            prefill_ms=prefill_s * 1e3, decode_ms_per_step=decode_s * 1e3
            / steps, launches=counts, expected_launches=want)
        checks[f"{name}_logits"] = err <= rtol * scale and bool(
            torch.isfinite(got).all())
        checks[f"{name}_launches"] = counts == want
        checks[f"{name}_shape"] = tuple(got.shape) == (b, 1 + steps, C,
                                                       cfg.vocab)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, full, cache
    torch.cuda.empty_cache()
    cut_cfg = zoo_cfg("musicgen-medium", 2, "float32")
    frames = np.random.default_rng(13).integers(0, cfg.vocab, (2, 24, C))
    try:
        cut = _cut_vs_cpu(dev, cut_cfg, seed=2, prompts=list(frames),
                          steps=3, why="the CPU side's time")
    except AssertionError as e:
        cut = e.args[1]
    checks["card_vs_cpu"] = cut["ok"]
    row = dict(phase="musicgen_decode", model=cfg.name,
               n_layers=cfg.n_layers, depth_reason="full depth",
               d_model=cfg.d_model, n_codebooks=C, dtype=str(cfg.dtype),
               weights="rtn:int4", batch=b, prompt_len=l, steps=steps,
               runs=runs, peak_gib=peak, card_vs_cpu=cut, checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"musicgen_decode failed its checks: {checks}",
                             row)
    return row


# --------------------------------------------------------------------------
# phase 8: the SSM blocks: Zamba2-2.7B (Mamba2 SSD and its shared
# attention block) and RWKV6-1.6B, served from random weights
# --------------------------------------------------------------------------

# the QTensor matmuls (N, K) of the SSM configs: Zamba2's shared block (q,
# k, v, o; the gelu MLP's up and down) and, under include_embeddings, the
# heads.  M: decode at batch 8 and the static prefill of 8 x 128 tokens
# through the shared block; under int8 activations the scheduler's
# per-slot prefill (72-128 tokens); a head reads one row per prompt
SSM_WQT = {(2560, 2560): "zamba2 shared wq wk wv wo",
           (10240, 2560): "zamba2 shared w_up",
           (2560, 10240): "zamba2 shared w_down",
           (32000, 2560): "zamba2 tied head",
           (65536, 2048): "rwkv6 head"}
SSM_HEADS = ((32000, 2560), (65536, 2048))
SSM_WQT_MS = (8, 1024)
SSM_A8_MS = (8, 72, 128)
# Zamba2's shared rings: head_dim 80, 32 kv-heads, rep 1 (the fma
# instance: 80 is no mma head_dim, and an int4 row of 40 bytes no 16-byte
# multiple)
SSM_ATTN = dict(b=8, g=32, rep=1, hd=80)
SSM_ATTN_LS = (256, 2048)
# every leaf the packer casts densely, at its full-depth stacked shape
SSM_QUANT = [("zamba2 in_proj", (9, 2560, 10448)),
             ("zamba2 out_proj", (9, 5120, 2560)),
             ("zamba2 conv_w", (9, 4, 5248)),
             ("zamba2 conv_b", (9, 5248)),
             ("rwkv6 w_r w_k w_v w_g w_o w_r_cm", (24, 2048, 2048)),
             ("rwkv6 w_k_cm", (24, 2048, 7168)),
             ("rwkv6 w_v_cm", (24, 7168, 2048))]
# card against CPU (fp32, TF32 off): the recurrent states after the
# prefill, relative to each leaf's largest value.  Set from the first
# card reading, about three times its worst (measured on an H100: 9.4e-6,
# Zamba2's sixth SSM state; RWKV6's 7.7e-7)
SSM_STATE_RTOL = 3e-5
# chunked against the exact sequential scan on the card (fp32), which sum
# in other orders over 1024 tokens; prefill + one decode step against the
# full forward, as tests/test_torch_archs.py holds them
SSM_EXACT_RTOL = 1e-4
SSM_CONSISTENCY_RTOL = 1e-4
SSM_CUTS = (("zamba2-2.7b", 6), ("rwkv6-1.6b", 2))


def check_ssm_kernels(timer, dev):
    """The serving kernels at the SSM configs' shapes: ``wqt_matmul`` at
    the shared block's three (N, K) (decode and prefill M) and at the two
    heads, int4 (and int8 at decode); ``wqt_matmul_a8_x`` there at decode
    and the scheduler's prefill M (a head at M 1 and 8); the ``fma``
    ``decode_attn`` at Zamba2's head_dim 80, int8 and int4, rings of 256
    and 2048, unwrapped and wrapped; ``quant`` bitwise on every leaf the
    packer casts densely."""
    from repro_torch.core.qtensor import quantize_qtensor
    from repro_torch.kernels.wq_matmul import dequant_t_ref
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = []
    for (n, k), model in SSM_WQT.items():
        head = (n, k) in SSM_HEADS
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        for bits in (4, 8):
            qt = quantize_qtensor(w, f"int{bits}", -1)
            w_lib = dequant_t_ref(qt.codes, qt.scales, -1, bits == 4)
            for m in (SSM_WQT_MS[:1] if head or bits == 8 else SSM_WQT_MS):
                rows.append(dict(check_wqt_one(
                    timer, gen, dev, qt, w_lib, m=m, n=n, k=k, bits=bits,
                    block_k=-1, dtype=BF16), model=model))
            del qt, w_lib
        for m in ((1, 8) if head else SSM_A8_MS):
            rows.append(dict(check_a8_x_one(timer, gen, dev, m=m, n=n, k=k,
                                            bits=4, block_k=-1),
                             model=model))
        del w
        torch.cuda.empty_cache()
    for L in SSM_ATTN_LS:
        rings = {"unwrapped": [0, 5, L // 3, L // 2, L - 9, L - 3, L - 2,
                               L - 1],
                 "wrapped": [0, 5, L // 3, L - 1, L, L + 7, 2 * L + 3,
                             5 * L - 2]}
        for bits in (8, 4):
            for ring, pos in rings.items():
                rows.append(dict(check_attn_one(
                    timer, gen, dev, L=L, bits=bits, window=None,
                    softcap=None, dtype=BF16, pos=torch.tensor(
                        pos, dtype=torch.int32, device=dev), **SSM_ATTN),
                    model="zamba2 shared", ring=ring))
    for model, shape in SSM_QUANT:
        rows.append(dict(check_quant_one(timer, gen, dev, shape, "int4", -1,
                                         False), model=model))
        torch.cuda.empty_cache()
    return rows


def _decode_step_profile(params, cfg, prompts, dev):
    """One decode step of the static workload (left-padded prompts, int8
    KV) under ``torch.profiler``, after the prefill and one unprofiled
    step: the device kernels it launches, their device ms and the
    heaviest by device time."""
    from torch.profiler import ProfilerActivity, profile
    from scripts.profile_serve_torch import _device_by_name
    from repro_torch.models.lm import lm_decode, lm_prefill
    from repro_torch.serve.engine import bucket_cache_len
    b, width = len(prompts), max(len(p) for p in prompts)
    toks = np.zeros((b, width), np.int64)
    for i, p in enumerate(prompts):
        toks[i, width - len(p):] = p
    pos = torch.full((b,), width - 1, device=dev)
    with torch.inference_mode():
        lg, cache = lm_prefill(params, cfg, torch.as_tensor(toks, device=dev),
                               cache_len=bucket_cache_len(width + 3),
                               kv_quant="int8")
        for step in range(2):
            pos = pos + 1
            tok = lg[:, 0].argmax(-1)[:, None]
            torch.cuda.synchronize()
            if step == 0:
                lg, cache = lm_decode(params, cfg, cache, tok, pos)
                continue
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                lm_decode(params, cfg, cache, tok, pos)
                torch.cuda.synchronize()
    by_name = _device_by_name(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return dict(device_kernels=sum(c for _, c in by_name.values()),
                device_ms=sum(ms for ms, _ in by_name.values()),
                top=[dict(kernel=k[:90], ms=ms, launches=c)
                     for k, (ms, c) in top])


def _serve_ssm(dev, arch, *, rng_seed, include_embeddings, n_layers=None):
    """``arch`` at full width and depth (``n_layers``: cut for time): the
    static Engine (int4, int8 KV where there is KV, batch 8, 64-128-token
    prompts, 32 new tokens) with one decode step profiled, then the ring
    Scheduler on the same prepared tree, which must refuse paged KV and
    chunked prefill.  Returns (row, checks, engine)."""
    from repro_torch.serve import Scheduler, SchedulerConfig, ServeConfig
    cfg = zoo_cfg(arch, n_layers)
    prompts = _prompts(np.random.default_rng(rng_seed), 8, 64, 128,
                       cfg.vocab)
    static, eng = _serve_static(dev, cfg, seed=0, prompts=prompts, mnt=32,
                                why="full depth" if n_layers is None
                                else CUT_FOR_TIME,
                                include_embeddings=include_embeddings)
    checks = {f"static_{k}": v for k, v in static.pop("checks").items()}
    static["launches_per_decode_step"] = dict(
        wqt_matmul=_qt_per_forward(cfg, include_embeddings),
        decode_attn=_attn_per_step(cfg))
    prof = _decode_step_profile(eng.params, cfg, prompts, dev)
    prof["busy_share"] = prof["device_ms"] / static["decode_ms_per_step"]
    static["decode_step_profile"] = prof
    sched, sc = _sched_run(dev, cfg, eng.params,
                           include_embeddings=include_embeddings)
    checks.update({f"sched_{k}": v for k, v in sc.items()})
    # recurrent state has no position-keyed ring and is not threaded
    # across prefill chunks: the Scheduler refuses both, as JAX's
    sched["refused"] = {}
    for name, kw in (("paged", dict(paged=True, block_size=16)),
                     ("prefill_chunk", dict(prefill_chunk=16))):
        try:
            Scheduler(cfg, eng.params, ServeConfig(),
                      SchedulerConfig(cache_len=256, **kw), device=dev)
            sched["refused"][name] = None
        except ValueError as e:
            sched["refused"][name] = str(e)
        checks[f"sched_refuses_{name}"] = sched["refused"][name] is not None
    return dict(static=static, sched=sched), checks, eng


def serve_zamba2(dev):
    """Zamba2-2.7B (Mamba2 layers in scan groups of 6, each followed by
    the one shared attention + gelu MLP block; head_dim 80, 32 kv-heads;
    tied 32,000-row embedding) at full width and 18 of its 54 layers (3
    groups; cut in PR 25 for the script's time limit): int4 QTensors for
    the shared block, the dense RTN cast through ``quant`` for every
    Mamba2 projection, int8 KV for the shared rings; static Engine, then
    the W4A8 Scheduler."""
    torch.cuda.empty_cache()
    row, checks, eng = _serve_ssm(dev, "zamba2-2.7b", rng_seed=14,
                                  include_embeddings=False, n_layers=18)
    del eng
    torch.cuda.empty_cache()
    out = dict(phase="serve_zamba2", **row, checks=checks)
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"serve_zamba2 failed its checks: {checks}", out)
    return out


def serve_rwkv6(dev):
    """RWKV6-1.6B as the repo configures it (24 layers, d_model 2048, 32
    heads of 64, untied 65,536-row head) at full width and depth, its
    embedding and head quantized too (``include_embeddings``: the head
    through ``wqt_matmul``, under int8 activations ``wqt_matmul_a8``),
    every time-mix and channel-mix projection as the dense cast; static
    Engine, then the W4A8 Scheduler.  Its cache holds the recurrent
    states only."""
    from repro_torch import bridge
    from repro_torch.models.lm import init_cache
    torch.cuda.empty_cache()
    row, checks, eng = _serve_ssm(dev, "rwkv6-1.6b", rng_seed=15,
                                  include_embeddings=True)
    cfg = eng.cfg
    leaves = sorted(bridge.flatten(init_cache(cfg, 8, 256, kv_quant="int8",
                                              device=dev)))
    checks["cache_states_only"] = leaves == [
        f"unit/b0_rwkv/{k}" for k in ("shift_cm", "shift_tm", "wkv")]
    del eng
    torch.cuda.empty_cache()
    out = dict(phase="serve_rwkv6", **row, cache_leaves=leaves,
               checks=checks)
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"serve_rwkv6 failed its checks: {checks}", out)
    return out


def ssm_card_vs_cpu(dev):
    """Zamba2 cut to one scan group (6 Mamba2 layers and the shared
    block) and RWKV6 to 2 layers, both at full width in fp32 from the
    same weights on the card and on the CPU (``_cut_vs_cpu``: int4
    weights, int8 KV, two left-padded prompts of 80-100 tokens, more
    than one chunk of either scan, and 4 greedy decode steps), the
    recurrent states after the prefill held within ``SSM_STATE_RTOL``."""
    out = dict(phase="ssm_card_vs_cpu")
    checks = {}
    for arch, n_layers in SSM_CUTS:
        cfg = zoo_cfg(arch, n_layers, "float32")
        prompts = _prompts(np.random.default_rng(16), 2, 80, 100, cfg.vocab)
        try:
            cut = _cut_vs_cpu(dev, cfg, seed=4, prompts=prompts, steps=4,
                              why="the CPU side's time",
                              state_rtol=SSM_STATE_RTOL)
        except AssertionError as e:
            cut = e.args[1]
        checks[arch] = cut["ok"]
        out[arch] = cut
        torch.cuda.empty_cache()
    out["checks"] = checks
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"ssm_card_vs_cpu failed its checks: {checks}",
                             out)
    return out


def ssm_chunked_vs_exact(dev, b=2, L=1024):
    """On the card in fp32: one full-width Mamba2 block (Zamba2's) and one
    RWKV6 time-mix, chunked against the exact sequential scan at b 2, L
    1024 (outputs and final states); then on the card-against-CPU cuts,
    prefill of L - 1 tokens plus one decode step against the full
    forward's last two positions."""
    from repro_torch.models import ssm
    from repro_torch.models.lm import (lm_decode, lm_forward, lm_init,
                                       lm_prefill)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(24)
    blocks = {}
    zspec = zoo_cfg("zamba2-2.7b").mamba_spec()
    rspec = zoo_cfg("rwkv6-1.6b").rwkv_spec()
    for name, spec, init, apply, state in (
            ("mamba2", zspec, ssm.mamba2_init, ssm.mamba2_apply, "ssm"),
            ("rwkv6_time_mix", rspec, ssm.rwkv6_time_mix_init,
             ssm.rwkv6_time_mix, "wkv")):
        p = init(gen, spec, dev)
        x = torch.randn((b, L, spec.d_model), generator=gen, device=dev)
        got, ms = {}, {}
        with torch.inference_mode():
            for exact in (False, True):
                apply(p, spec, x[:, :8], exact=exact)         # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[exact] = apply(p, spec, x, exact=exact,
                                   return_state=True)
                torch.cuda.synchronize()
                ms[exact] = (time.perf_counter() - t0) * 1e3
        (oc, sc), (oe, se) = got[False], got[True]
        blocks[name] = dict(
            out_rel_err=_max_rel(oc, oe), state_rel_err=_max_rel(
                sc[state], se[state]),
            chunked_ms=ms[False], exact_ms=ms[True],
            finite=bool(torch.isfinite(oc).all() and torch.isfinite(
                sc[state]).all()))
        del p, x, got
    cuts = {}
    for arch, n_layers in SSM_CUTS:
        cfg = zoo_cfg(arch, n_layers, "float32")
        params = lm_init(cfg, seed=5, device=dev)
        toks = torch.as_tensor(np.random.default_rng(17).integers(
            0, cfg.vocab, (b, L)), device=dev)
        with torch.inference_mode():
            full = lm_forward(params, cfg, toks)[:, -2:].float()
            lp, cache = lm_prefill(params, cfg, toks[:, :-1], cache_len=L)
            ld, _ = lm_decode(params, cfg, cache, toks[:, -1:],
                              torch.full((b,), L - 1, device=dev))
        cuts[arch] = dict(n_layers=n_layers,
                          prefill_rel_err=_max_rel(lp[:, 0], full[:, 0]),
                          decode_rel_err=_max_rel(ld[:, 0], full[:, 1]))
        del params, full, cache
        torch.cuda.empty_cache()
    checks = {f"{k}_{what}": v[f"{what}_rel_err"] <= SSM_EXACT_RTOL
              and v["finite"] for k, v in blocks.items()
              for what in ("out", "state")}
    checks.update({f"{k}_{what}": v[f"{what}_rel_err"]
                   <= SSM_CONSISTENCY_RTOL for k, v in cuts.items()
                   for what in ("prefill", "decode")})
    row = dict(phase="ssm_chunked_vs_exact", b=b, L=L, dtype="float32",
               exact_rtol=SSM_EXACT_RTOL,
               consistency_rtol=SSM_CONSISTENCY_RTOL, blocks=blocks,
               cuts=cuts, checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"ssm_chunked_vs_exact failed its checks: "
                             f"{checks}", row)
    return row


# --------------------------------------------------------------------------
# phase 9: cross-attention (Llama-3.2-Vision-11B) served and trained, and
# the zoo's MoE and SSM configs trained on the card
# --------------------------------------------------------------------------

VISION = "llama3.2-vision-11b"
# the wqt_matmul shapes of its serving path (M, N, K, what): vision_proj
# and the cross layers' wk / wv over the 1,601 image tokens of 8 rows,
# then the decode GEMVs at batch 8
VISION_WQT = [(8 * 1601, 4096, 1280, "vision_proj"),
              (8 * 1601, 1024, 4096, "cross wk wv"),
              (8, 4096, 4096, "wq wo"), (8, 1024, 4096, "wk wv"),
              (8, 14336, 4096, "w_up w_gate"), (8, 4096, 14336, "w_down")]
VISION_ATTN = dict(b=8, g=8, rep=4, hd=128)
VISION_ATTN_LS = (256, 2048)
# one pattern unit: four self-attention layers and one cross layer
VISION_CUT = 5
# the cross K/V of the card's prefill against the CPU's (fp32, TF32 off:
# summation order of the two projections only)
VISION_CROSS_RTOL = 1e-5
# an image that changes nothing on the card would leave the prefill's
# logits as they are; a second image must move them by more than this
# fraction of the largest
VISION_IMAGE_MIN_CHANGE = 1e-3
# one training step, card against the port on the CPU (fp32, TF32 off):
# the losses and every updated parameter within 1e-4 of the CPU's largest
# value of the leaf (tests/test_torch_archs.py holds JAX's step so); the
# state starts with seeded second moments, so the LOTION penalty has a
# Fisher and Adam's first update, lr * g / (sqrt(v) + eps), is a smooth
# function of the gradient: from zero moments it is lr * sign(g) for every
# element above eps, and an element whose gradient is within rounding of
# zero can step the other way on one side
TRAIN_CUT_RTOL = 1e-4
TRAIN_CUT_NU = (0.5e-6, 1.5e-6)
TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 1, 64
# the zoo's training phases: (arch, depth; None = as configured)
ZOO_TRAIN = (("moonshot-v1-16b-a3b", 2), ("zamba2-2.7b", 18),
             ("rwkv6-1.6b", None))
ZOO_TRAIN_CUTS = (("moonshot-v1-16b-a3b", 1), ("rwkv6-1.6b", 1),
                  ("zamba2-2.7b", 6))
# opt_step and lotion_reg on the leaves these configs train: the SSM
# leaves per matrix (int4, lam 1e3) and RWKV6's 4-D mu_lora_b in mode none
ZOO_TRAIN_LEAVES = SSM_QUANT + [("moonlight router", (2, 2048, 64))]
ZOO_MODE_NONE = [("rwkv6 mu_lora_b", (24, 5, 32, 2048))]


def open_gates(params, cfg, seed):
    """Every cross-attention gate of ``params`` (one per repeat) drawn
    uniform in [0.25, 0.75] from ``seed``, in place: ``lm_init`` starts
    them at zero, as JAX's does, where the cross path adds nothing."""
    rng = np.random.default_rng(seed)
    for i, kind in enumerate(cfg.pattern):
        if kind == "xattn":
            g = params["stage"][f"b{i}_{kind}"]["xattn_gate"]
            g.copy_(torch.as_tensor(rng.uniform(0.25, 0.75, g.shape[0])
                                    .astype(np.float32)))
    return params


def _images(dev, cfg, b, seed, dtype=torch.bfloat16):
    """One (n_image_tokens, d_vision) image embedding per row, normal
    draws from ``seed`` on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((b, cfg.n_image_tokens, cfg.d_vision), generator=gen,
                       device=dev).to(dtype)


def _vision_launches(cfg):
    """``wqt_matmul`` launches of a prefill (every layer's 7 matmuls and
    ``vision_proj``) and of a decode step (a cross layer projects no K/V:
    5), and ``decode_attn`` launches of a decode step (self-attention
    only: the cross K/V are dense, read by einsums)."""
    r = cfg.n_repeats
    n_self, n_cross = (sum(k == kind for k in cfg.pattern) * r
                       for kind in ("attn", "xattn"))
    return dict(prefill=7 * (n_self + n_cross) + 1,
                decode_step=7 * n_self + 5 * n_cross,
                decode_attn_step=n_self)


def check_vision_kernels(timer, dev):
    """Llama-3.2-Vision's serving kernels at its shapes: ``wqt_matmul``
    int4 at M = 8 x 1,601 for ``vision_proj`` (K 1280) and the cross K/V
    projections (K 4096, N 1024), and the decode GEMVs at M = 8; the
    ``mma`` ``decode_attn`` at hd 128, g 8, rep 4, b 8, int8, L 256 and
    2048."""
    from repro_torch.core.qtensor import quantize_qtensor
    from repro_torch.kernels.wq_matmul import dequant_t_ref
    gen = torch.Generator(device=dev).manual_seed(24)
    rows = []
    for m, n, k, what in VISION_WQT:
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        qt = quantize_qtensor(w, "int4", -1)
        w_lib = dequant_t_ref(qt.codes, qt.scales, -1, True)
        rows.append(dict(check_wqt_one(
            timer, gen, dev, qt, w_lib, m=m, n=n, k=k, bits=4, block_k=-1,
            dtype=BF16), model=f"vision {what}"))
        del w, qt, w_lib
        torch.cuda.empty_cache()
    for L in VISION_ATTN_LS:
        pos = torch.tensor([0, 5, L // 3, L // 2, L - 9, L - 3, L - 2,
                            L - 1], dtype=torch.int32, device=dev)
        rows.append(dict(check_attn_one(
            timer, gen, dev, L=L, bits=8, window=None, softcap=None,
            dtype=BF16, pos=pos, **VISION_ATTN), model="vision self-attn"))
    return rows


def serve_vision(dev, n_layers=None, mnt=32):
    """Llama-3.2-Vision-11B as the repo configures it (40 layers in 8 units
    of four self-attention layers and one gated cross-attention layer;
    1,601 image tokens of width 1280) at full width and depth, random
    weights and gates from a seed: int4 QTensors (``vision_proj`` among
    them), int8 self-attention KV, bf16 cross K/V; ``prepare_params`` ->
    ``lm_prefill(image_embeds=...)`` of 8 left-padded prompts of 64-128
    tokens, one image per row -> ``mnt`` greedy ``lm_decode`` steps, the
    launches of each counted.  A second image must move the prefill's
    logits.  (``Engine`` and ``Scheduler`` refuse the config, as JAX's
    cannot serve it: they pass no images.)"""
    from repro_torch.core import param_nbytes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import lm_decode, lm_prefill
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import bucket_cache_len, prepare_params
    cfg = zoo_cfg(VISION, n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = open_gates(_lm_init(cfg, 0, dev), cfg, 0)
    torch.cuda.synchronize()
    init_s, fp32_bytes = time.perf_counter() - t0, param_nbytes(params)
    try:
        Engine(cfg, params, ServeConfig(), device=dev)
        refused = None
    except ValueError as e:
        refused = str(e)
    reset_launch_counts()
    t0 = time.perf_counter()
    served = prepare_params(params, ServeConfig(weights="rtn:int4",
                                                kv_quant="int8"), dev)
    torch.cuda.synchronize()
    prepare_s, prep_counts = time.perf_counter() - t0, launch_counts()
    del params
    prepare_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    b = 8
    prompts = _prompts(np.random.default_rng(18), b, 64, 128, cfg.vocab)
    width = max(len(p) for p in prompts)
    toks = np.zeros((b, width), np.int64)
    for i, p in enumerate(prompts):
        toks[i, width - len(p):] = p
    toks = torch.as_tensor(toks, device=dev)
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    cache_len = bucket_cache_len(width + mnt + 1)
    img, img2 = (_images(dev, cfg, b, seed) for seed in (1, 2))

    def prefill(images):
        return lm_prefill(served, cfg, toks, cache_len=cache_len,
                          kv_quant="int8", prompt_lens=lens,
                          image_embeds=images)

    def decode(lg, cache, steps):
        pos, out = lens - 1, []
        for _ in range(steps):
            tok = lg[:, 0].argmax(-1)
            out.append(tok)
            pos = pos + 1
            lg, cache = lm_decode(served, cfg, cache, tok[:, None].long(),
                                  pos)
        return lg, out

    with torch.inference_mode():
        decode(*prefill(img), 2)                             # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill(img)
        torch.cuda.synchronize()
        prefill_s, pre_counts = time.perf_counter() - t0, launch_counts()
        first = lg.float().clone()
        reset_launch_counts()
        t0 = time.perf_counter()
        last, out = decode(lg, cache, mnt)
        torch.cuda.synchronize()
        decode_s, dec_counts = time.perf_counter() - t0, launch_counts()
        serve_peak = torch.cuda.max_memory_allocated()
        xk = next(c["k"] for name, c in cache["unit"].items()
                  if name.endswith("_xattn"))
        cross = dict(dtype=str(xk.dtype).replace("torch.", ""),
                     shape=list(xk.shape),
                     gb=2 * xk.numel() * xk.element_size() / 1e9)
        del cache
        other = prefill(img2)[0].float()
    tokens = torch.stack(out, 1).cpu()
    change = float((other - first).abs().max() / first.abs().max())
    per = _vision_launches(cfg)
    want_pre = dict.fromkeys(pre_counts, 0)
    want_pre.update(wqt_matmul=per["prefill"])
    want_dec = dict.fromkeys(dec_counts, 0)
    want_dec.update(wqt_matmul=per["decode_step"] * mnt,
                    decode_attn=per["decode_attn_step"] * mnt)
    stored, moved = _step_bytes(cfg, served)
    checks = {"prefill_launches": pre_counts == want_pre,
              "decode_launches": dec_counts == want_dec,
              "prepare_launches": not any(prep_counts.values()),
              "vision_proj_qtensor": type(served["vision_proj"]).__name__
              == "QTensor",
              "cross_kv_dense_bf16": cross["dtype"] == "bfloat16"
              and cross["shape"][2] == cfg.n_image_tokens,
              "finite": bool(torch.isfinite(first).all()
                             and torch.isfinite(last).all()),
              "vocab": bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
              "image_matters": change > VISION_IMAGE_MIN_CHANGE,
              "engine_refuses": refused is not None}
    row = dict(phase="serve_vision", model=cfg.name, n_layers=cfg.n_layers,
               d_model=cfg.d_model, dtype=str(cfg.dtype),
               weights="rtn:int4", kv_quant="int8 (self-attention)",
               batch=b, prompt_lens=sorted(len(p) for p in prompts),
               image_tokens=cfg.n_image_tokens, max_new_tokens=mnt,
               fp32_gb=fp32_bytes / 1e9,
               served_gb=param_nbytes(served) / 1e9, init_s=init_s,
               prepare_s=prepare_s, prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=decode_s * 1e3 / mnt,
               prepare_peak_gib=prepare_peak / 2 ** 30,
               serve_peak_gib=serve_peak / 2 ** 30,
               decode_step_weight_gb=stored / 1e9,
               decode_step_bound_ms=stored / HBM_BYTES_PER_S * 1e3,
               decode_step_moved_gb=moved / 1e9,
               decode_step_moved_bound_ms=moved / HBM_BYTES_PER_S * 1e3,
               cross_kv=cross, prefill_launches=pre_counts,
               expected_prefill_launches=want_pre,
               decode_launches=dec_counts,
               expected_decode_launches=want_dec,
               launches_per_decode_step=dict(
                   wqt_matmul=per["decode_step"],
                   decode_attn=per["decode_attn_step"]),
               second_image_logit_change=change,
               first_tokens=tokens[:2, :8].tolist(), engine_refusal=refused,
               checks=checks)
    del served
    torch.cuda.empty_cache()
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"serve_vision failed its checks: {checks}", row)
    return row


def _lm_init(cfg, seed, dev):
    from repro_torch.models.lm import lm_init
    return lm_init(cfg, seed=seed, device=dev)


def vision_card_vs_cpu(dev):
    """One pattern unit of Llama-3.2-Vision (4 self-attention layers and
    the cross layer) at full width in fp32 from the same weights and gates
    on the card and on the CPU (``_cut_vs_cpu``: int4 weights, int8
    self-attention KV, two left-padded prompts of 60-90 tokens, each row
    its own image, 4 greedy decode steps): the prefill within 1e-4 and
    each decode step within 1e-3 of the largest logit, and the cross K/V
    the prefill caches within ``VISION_CROSS_RTOL``."""
    cfg = zoo_cfg(VISION, VISION_CUT, "float32")
    prompts = _prompts(np.random.default_rng(19), 2, 60, 90, cfg.vocab)
    images = _images(dev, cfg, 2, seed=4, dtype=torch.float32).cpu()
    cut = _cut_vs_cpu(dev, cfg, seed=6, prompts=prompts, steps=4,
                      why="one pattern unit: the CPU side's time",
                      images=images, cross_rtol=VISION_CROSS_RTOL,
                      phase="vision_card_vs_cpu")
    torch.cuda.empty_cache()
    return cut


def _train_cut_vs_cpu(dev, arch, n_layers, *, seed):
    """One LOTION step (the train phase's settings: int4 per matrix,
    decoupled, lam 1e3, fused AdamW) of ``arch`` cut to ``n_layers`` at
    full width in fp32 (TF32 off), from the same weights, second moments
    and batch (1 x 64; a vision config's images too) on the card and on
    the port's CPU path.  The loss, CE, gradient norm and penalty within
    ``TRAIN_CUT_RTOL``; every updated parameter within ``TRAIN_CUT_RTOL``
    of the CPU's largest value of the leaf, and every leaf moved: by more
    than half that on the CPU, or by an update that itself agrees within
    ``TRAIN_CUT_RTOL`` of its largest element beyond one unit in the last
    place of the updated value (w + update is rounded to fp32 on both
    sides, and where the update is a few thousand units of w's last
    place, two updates that agree to 1e-6 round one unit apart).  MoE
    routing (every ``moe_route`` call, forward and recomputation) equal
    on both sides.  Returns the row; raises AssertionError(message,
    row) on a failure."""
    from repro_torch import bridge
    from repro_torch.core.policy import tree_map
    from repro_torch.data import lm_batch, permutation_table
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg, train_step, _, state = granite_trainer(
        dev, arch=arch, n_layers=n_layers, dtype="float32", seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for nu in tree_leaves(state["opt"]["nu"]):
        nu.uniform_(*TRAIN_CUT_NU, generator=gen)
    batch = lm_batch(seed, 0, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ, cfg.vocab,
                     permutation_table(seed, cfg.vocab))
    if cfg.n_image_tokens:
        batch["image_embeds"] = _images(dev, cfg, TRAIN_CUT_BATCH, seed + 2,
                                        torch.float32).cpu()
    cpu_state = tree_map(lambda x: x.cpu() if torch.is_tensor(x) else x,
                         state)
    before = {k: v.clone() for k, v in
              bridge.flatten(state["params"]).items()}
    t0 = time.perf_counter()
    with _recorded_routes() as cpu_routes:
        cpu_state, cpu_m = train_step(cpu_state, batch)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with _recorded_routes() as card_routes:
        state, card_m = train_step(state, {k: v.to(dev)
                                           for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    metrics = {k: (float(card_m[k]), float(cpu_m[k]))
               for k in ("loss", "ce", "grad_norm", "penalty")}
    metric_err = {k: _rel(c, g) for k, (g, c) in metrics.items()}
    got = bridge.flatten(state["params"])
    want = bridge.flatten(cpu_state["params"])
    leaf_err, unmoved, via_update = {}, [], []
    for k, w in want.items():
        g, b0 = got[k].cpu(), before[k].cpu()
        scale = float(w.abs().max().clamp_min(1e-30))
        leaf_err[k] = float((g - w).abs().max()) / scale
        if float((w - b0).abs().max()) / scale <= TRAIN_CUT_RTOL / 2:
            # a leaf whose values dwarf one step: hold the update itself
            du_w, du_g = w - b0, g - b0
            ref = float(du_w.abs().max())
            if ref == 0.0:
                unmoved.append(k)
                continue
            top = torch.maximum(w.abs(), g.abs())
            ulp = torch.nextafter(top, torch.tensor(math.inf)) - top
            excess = ((du_g - du_w).abs() - ulp).clamp_min(0.0)
            leaf_err[k] = max(leaf_err[k], float(excess.max()) / ref)
            via_update.append(k)
    routes = _compare_routes(card_routes, cpu_routes) if cpu_routes \
        else None
    gates = {k: [float(before[k][i]), float(got[k][i]), float(want[k][i])]
             for k in want if k.endswith("xattn_gate")
             for i in (0,)}
    checks = {"metrics": max(metric_err.values()) <= TRAIN_CUT_RTOL,
              "params": max(leaf_err.values()) <= TRAIN_CUT_RTOL,
              "every_leaf_moved": not unmoved,
              "penalty_active": metrics["penalty"][1] > 0.0,
              "routing_equal": routes is None,
              "not_skipped": not bool(card_m["skipped"])
              and not bool(cpu_m["skipped"])}
    if cfg.n_image_tokens:
        checks["gates_moved"] = bool(gates) and all(
            v[1] != v[0] and v[2] != v[0] for v in gates.values())
    worst = max(leaf_err, key=leaf_err.get)
    row = dict(model=cfg.name, n_layers=cfg.n_layers, dtype="float32",
               batch=TRAIN_CUT_BATCH, seq=TRAIN_CUT_SEQ, rtol=TRAIN_CUT_RTOL,
               nu_init=TRAIN_CUT_NU, metrics=metrics, metric_rel_err=metric_err,
               max_rel_diff=max(list(metric_err.values())
                                + list(leaf_err.values())),
               worst_leaf=worst, worst_leaf_rel_err=leaf_err[worst],
               leaves=len(leaf_err), held_by_update=len(via_update),
               unmoved=unmoved, gates=gates,
               routing=None if not cpu_routes else dict(
                   calls=len(cpu_routes), parted=routes),
               cpu_step_s=cpu_s, card_step_s=card_s, checks=checks,
               ok=all(checks.values()))
    del state, cpu_state, before, got, want
    torch.cuda.empty_cache()
    if not row["ok"]:
        raise AssertionError(f"{cfg.name}: card and CPU training disagree",
                             row)
    return row


def _zoo_train(dev, arch, n_layers, *, steps=2, images=False,
               eval_rtn=False):
    """``steps`` LOTION steps of ``arch`` at full width (depth ``n_layers``
    where given), bf16 activations, batch 4 x 1024 (with images of the
    batch's rows for a vision config): step ms, peak memory, and the
    launches, exact: ``opt_step`` once per leaf a step, nothing else;
    with ``eval_rtn`` then the fp32 and RTN eval CE, one ``quant`` launch
    per eligible leaf."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, train_step, eval_fn, state = granite_trainer(dev, arch=arch,
                                                      n_layers=n_layers)
    pipe, val = _pipeline(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    img = (_images(dev, cfg, TRAIN_BATCH, seed=3) if images else None)
    batches = (dict(bt, image_embeds=img) if images else bt for bt in pipe)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_leaves = len(tree_leaves(state["params"]))
    n_eligible = len(_eligible(state["params"]))
    gates0 = {k: v.clone() for k, v in _gates(state["params"]).items()}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        state, rows = _train_steps(train_step, state, batches, steps)
    finally:
        pipe.close()
    train_peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(opt_step=n_leaves * steps)
    checks = {"launches": counts == want}
    row = dict(model=cfg.name, n_layers=cfg.n_layers,
               full_n_layers=zoo_cfg(arch).n_layers, d_model=cfg.d_model,
               dtype=str(cfg.dtype), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               method="lotion int4 per-matrix, decoupled, lam=1e3",
               params=sum(t.numel() for t in tree_leaves(state["params"])),
               leaves=n_leaves, eligible=n_eligible, setup_s=setup_s,
               steps=rows, step_ms=[r["step_ms"] for r in rows],
               launches=counts, expected_launches=want,
               launches_per_step=dict(opt_step=n_leaves, quant=0),
               peak_memory_gib_train=train_peak / 2 ** 30)
    if images:
        moved = {k: float((v - gates0[k]).abs().max())
                 for k, v in _gates(state["params"]).items()}
        row["gate_moved"] = moved
        checks["gates_moved"] = bool(moved) and all(moved.values())
    if eval_rtn:
        vb = dict(val, image_embeds=img) if images else val
        reset_launch_counts()
        ce = {"fp32": float(eval_fn(state["params"], vb)),
              "rtn": float(eval_fn(state["params"], vb, "rtn"))}
        ev = launch_counts()
        want_ev = dict.fromkeys(ev, 0)
        want_ev.update(quant=n_eligible)
        row.update(eval_ce=ce, eval_launches=ev,
                   expected_eval_launches=want_ev)
        checks["eval_launches"] = ev == want_ev
        checks["ce_finite"] = all(map(math.isfinite, ce.values()))
    row["checks"] = checks
    del state, train_step, eval_fn
    torch.cuda.empty_cache()
    return row


def _gates(params):
    from repro_torch import bridge
    return {k: v for k, v in bridge.flatten(params).items()
            if k.endswith("xattn_gate")}


def train_vision(dev, n_layers=VISION_CUT, steps=2):
    """Llama-3.2-Vision at full width cut to one pattern unit (its 16-byte
    training state at 40 layers, about 156 GB, does not fit the card):
    ``steps`` LOTION steps at batch 4 x 1024 with one image per row
    (bf16 activations), the gates moved, the fp32 and RTN eval CE; then
    one step on the card against the port's CPU path at batch 1 x 64
    (``_train_cut_vs_cpu``)."""
    row = dict(phase="train_vision", **_zoo_train(
        dev, VISION, n_layers, steps=steps, images=True, eval_rtn=True))
    try:
        cut = _train_cut_vs_cpu(dev, VISION, n_layers, seed=7)
    except AssertionError as e:
        cut = e.args[1]
    row["card_vs_cpu"] = cut
    row["checks"]["card_vs_cpu"] = cut["ok"]
    emit(row)
    if not all(row["checks"].values()):
        raise AssertionError(f"train_vision failed its checks: "
                             f"{row['checks']}", row)
    return row


def check_moe_leaf(dev, clock=None):
    """``opt_step`` (AdamW, int4 per matrix, lam 1e3) and ``lotion_reg``
    (int4 per matrix, lam 1e3) on one Moonlight expert stack at 12 layers,
    (12, 64, 2048, 1408): 2,214,592,512 elements in 768 matrices, past
    2^31.  The leaf does not fit twice with the plain version's
    temporaries, so its layers are drawn one at a time from seeds: the
    kernel runs once on the whole leaf, then the plain version on each
    layer's (64, 2048, 1408) slice (the same 64 matrices, so the same
    per-matrix scales), and each slice is held bitwise, the penalty within
    ``PENALTY_RTOL`` of the slices' sum.  With ``clock`` (a ``Timer``)
    the rows also
    time the kernel, the plain version over the 12 slices, and
    ``torch._fused_adamw_`` on the leaf (lam 0, opt_step's yardstick)."""
    from repro_torch.kernels.lotion_reg import (lotion_penalty_fused_vg,
                                                 reg_ref)
    from repro_torch.kernels.lotion_reg import ops as reg_ops
    from repro_torch.kernels.opt_step import fused_opt_step_leaf, opt_step_ref
    from repro_torch.kernels.opt_step import ops as opt_ops
    torch.cuda.empty_cache()
    n_lay = MOE_LEAF[0]
    t = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    scal = dict(lr=t(3e-4), bc1=t(1 - 0.9 ** 3), bc2=t(1 - 0.95 ** 3),
                clip_scale=t(0.5), ok=t(1.0))
    kw = dict(lam=1e3, fmt_name="int4", block_size=-1, core="adamw",
              **OPT_HYPER)

    def layer(i):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        shape = MOE_LEAF[1:]
        return (torch.randn(shape, generator=gen, device=dev) * 0.02,
                torch.randn(shape, generator=gen, device=dev) * 1e-3,
                torch.randn(shape, generator=gen, device=dev) * 1e-4,
                torch.rand(shape, generator=gen, device=dev) * 1e-6)

    def events(fn):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)

    leaf = [torch.empty(MOE_LEAF, device=dev) for _ in range(4)]
    for i in range(n_lay):
        for dst, src in zip(leaf, layer(i)):
            dst[i].copy_(src)
    w, g, mu, nu = leaf
    n = w.numel()
    rows = []
    # lotion_reg first (it reads w and the Fisher, here nu, and writes a
    # new gradient), then opt_step (in place)
    plan = reg_ops.launch_plan(w, "int4", -1)
    pen, grad = lotion_penalty_fused_vg(w, nu, "int4", -1, 1e3)
    same, err, plain_ms, pen_sum = True, 0.0, 0.0, 0.0
    for i in range(n_lay):
        (p_i, g_i), ms = events(lambda: reg_ref(w[i], nu[i], "int4", -1,
                                                1e3))
        plain_ms += ms
        e, s, _ = _bitwise([("grad", grad[i], g_i)])
        same, err, pen_sum = same and s, max(err, e), pen_sum + float(p_i)
        del p_i, g_i
    pen_rel = abs(float(pen) - pen_sum) / abs(pen_sum)
    b_ms, b_by = _elem_bound("lotion_reg", n, n * 4 * 3)
    row = dict(phase="check", kernel="lotion_reg", model="moonlight",
               shape=_fmt_shape(MOE_LEAF), elements=n, matrices=768,
               fmt="int4", block_size=-1, lam=1e3, regime=plan.regime,
               blocks=plan.blocks, bitwise=same, max_abs_err=err,
               penalty=float(pen), penalty_rel_err=pen_rel,
               compared="every layer's slice, plain version per slice")
    del grad
    if clock is not None:
        row.update(ms=clock(lambda: lotion_penalty_fused_vg(
            w, nu, "int4", -1, 1e3), iters=5), plain_ms=plain_ms,
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
    emit(row)
    rows.append(row)
    torch.cuda.empty_cache()
    plan = opt_ops.launch_plan(w, lam=1e3, fmt_name="int4")
    got = fused_opt_step_leaf(w, g, mu, nu, **scal, **kw)
    in_place = got[0] is w and got[1] is mu and got[2] is nu
    same, err, plain_ms, pen_sum, bad = True, 0.0, 0.0, 0.0, []
    for i in range(n_lay):
        w0, g0, mu0, nu0 = layer(i)
        want, ms = events(lambda: opt_step_ref(w0, g0, mu0, nu0, **scal,
                                               **kw))
        plain_ms += ms
        e, s, b = _bitwise([("w", w[i], want[0]), ("mu", mu[i], want[1]),
                            ("nu", nu[i], want[2])])
        same, err, pen_sum = same and s, max(err, e), pen_sum + float(
            want[3])
        bad += [f"layer {i} {x}" for x in b]
        del w0, g0, mu0, nu0, want
    pen_rel = abs(float(got[3]) - pen_sum) / abs(pen_sum)
    b_ms, b_by = _elem_bound("opt_step", n, n * 4 * 7)
    row2 = dict(phase="check", kernel="opt_step", model="moonlight",
                shape=_fmt_shape(MOE_LEAF), elements=n, matrices=768,
                fmt="int4", block_size=-1, mode="matrix", core="adamw",
                ok=1.0, lam=1e3, blocks=plan.blocks, in_place=in_place,
                bitwise=same, not_bitwise=bad[:8], max_abs_err=err,
                penalty=float(got[3]), penalty_rel_err=pen_rel,
                compared="every layer's slice, plain version per slice from "
                "the same seeded draws")
    if clock is not None:
        # the library call takes the leaf as its 12 layers' views, one
        # call: a list of tensors is its own interface
        views = [list(x.unbind(0)) for x in (w, g, mu, nu)]
        steps = [torch.tensor(3.0, device=dev) for _ in range(n_lay)]
        row2.update(
            ms=clock(lambda: fused_opt_step_leaf(w, g, mu, nu, **scal, **kw),
                     iters=5),
            plain_ms=plain_ms,
            library_ms=clock(lambda: torch._fused_adamw_(
                *views, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
                weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
                iters=5),
            bound_ms=b_ms, bound_by=b_by)
        del views
    emit(row2)
    rows.append(row2)
    del leaf, w, g, mu, nu, got
    torch.cuda.empty_cache()
    failed = [f"{r['kernel']}: bitwise {r['bitwise']}, max_abs_err "
              f"{r['max_abs_err']}, penalty_rel_err {r['penalty_rel_err']}"
              for r in rows if not (r["bitwise"] and r["penalty_rel_err"]
                                    <= PENALTY_RTOL)]
    if not in_place:
        failed.append("opt_step: not in place")
    if failed:
        raise AssertionError("opt_step or lotion_reg disagree on the "
                             "Moonlight expert stack", dict(failed=failed))
    return dict(rows=rows, failed=failed)


def check_zoo_train_kernels(timer, dev):
    """The training kernels on the leaves item 10's configs train:
    ``check_moe_leaf`` (the 2.2e9-element expert stack), then ``opt_step``
    (AdamW, int4 per matrix, lam 1e3, with ``torch._fused_adamw_``'s time)
    and ``lotion_reg`` (int4 per matrix) bitwise on every SSM leaf the
    packer casts and a Moonlight router stack, and ``opt_step`` in mode
    none (lam 0) on RWKV6's 4-D ``mu_lora_b``."""
    rows = check_moe_leaf(dev, clock=timer)["rows"]
    gen = torch.Generator(device=dev).manual_seed(25)
    for model, shape in ZOO_TRAIN_LEAVES:
        rows.append(dict(check_opt_one(timer, gen, dev, shape, "int4", -1,
                                       library=True), model=model))
        rows.append(dict(check_reg_one(timer, gen, dev, shape, "int4", -1),
                         model=model))
        torch.cuda.empty_cache()
    for model, shape in ZOO_MODE_NONE:
        rows.append(dict(check_opt_one(timer, gen, dev, shape, "int4", -1,
                                       lam=0.0), model=model))
    torch.cuda.empty_cache()
    return rows


def train_zoo(dev, steps=2):
    """The zoo's MoE and SSM configs trained on the card at full width:
    Moonlight-16B-A3B at 2 of its 48 layers (its 16-byte state at 48
    layers is about 430 GB; 2 layers and the 671M embedding and head hold
    about 30 GB), Zamba2-2.7B at 18 of its 54 layers (cut in PR 25 for
    the script's time limit; 37 GB of state at 54) and RWKV6-1.6B at full
    depth (26 GB): ``steps`` LOTION steps each at batch 4 x 1024, step ms,
    peak memory and exact launches (``_zoo_train``).  DBRX-132B is left
    out: one layer's state is 66.9 GiB before its activations (PERF.md
    §4)."""
    out = dict(phase="train_zoo")
    checks = {}
    for arch, n_layers in ZOO_TRAIN:
        r = _zoo_train(dev, arch, n_layers, steps=steps)
        out[arch] = r
        checks.update({f"{arch}_{k}": v for k, v in r["checks"].items()})
    out["checks"] = checks
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"train_zoo failed its checks: {checks}", out)
    return out


def train_zoo_card_vs_cpu(dev):
    """One LOTION step of Moonlight (1 layer, routing recorded), RWKV6 (1
    layer) and Zamba2 (6 layers: one scan group and the shared block) at
    full width, card against the port's CPU path (``_train_cut_vs_cpu``;
    Zamba2 is held to the port's CPU run, not JAX's, whose chunked SSD
    has a non-finite gradient at this width)."""
    out = dict(phase="train_zoo_card_vs_cpu")
    checks = {}
    for i, (arch, n_layers) in enumerate(ZOO_TRAIN_CUTS):
        try:
            cut = _train_cut_vs_cpu(dev, arch, n_layers, seed=8 + i)
        except AssertionError as e:
            cut = e.args[1]
        out[arch] = cut
        checks[arch] = cut["ok"]
    out["checks"] = checks
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"train_zoo_card_vs_cpu failed its checks: "
                             f"{checks}", out)
    return out

# --------------------------------------------------------------------------
# the mesh: sharded training (opt_step, lotion_reg and quant on blocks)
# --------------------------------------------------------------------------

# Granite leaves cut as a mesh cuts them: (label, full leaf, cut dim,
# blocks); the block checked is block 0, and every even matrix's largest
# |w| is planted in block 1, so its given absmax is above block 0's own
MESH_LEAVES = [("w_up (2, 1): dim 1 over data", (40, 2048, 8192), 1, 2),
               ("w_up (1, 2): dim 2 over model", (40, 2048, 8192), 2, 2),
               ("wo (1, 2): dim 1 over model", (40, 2048, 2048), 1, 2)]
# bytes per element each kernel must move on a block (read once, written
# once): quant RTN w, out; RR also u; lotion_reg w, f, grad; opt_step
# w, g, mu, nu in, w, mu, nu out
MESH_BYTES = {"quant": 8, "quant_rr": 12, "lotion_reg": 12, "opt_step": 28}
# the two-rank processes: seconds allowed to each rank process, summed
# over the parts it runs (scripts/mesh_ranks_torch.py)
TWO_RANKS_TIMEOUT_S = {"train": 300, "chaos": 420, "serve": 180}
# in a whole run the two-rank processes (train, chaos and serve parts:
# about 250 s, most of it gloo transfers staged through the host) start
# before this phase and run beside it and the vision and zoo training
# phases after it, whose GPU use leaves room; their figures are taken
# with the ranks beside, and their rows say so (ranks_beside)
TWO_RANKS_BESIDE_FROM = "serve_vision"


def check_mesh_one(timer, gen, dev, label, full_shape, dim, n_blocks):
    """``quant`` (RTN, RR), ``lotion_reg`` and ``opt_step`` on block 0 of
    a Granite leaf cut on ``dim``, given the whole matrices' absmax, each
    bitwise against its plain version with the same operand; timed with
    the call on the whole leaf (no absmax given) beside it."""
    from repro_torch.kernels.lotion_reg import lotion_penalty_fused_vg, reg_ref
    from repro_torch.kernels.opt_step import fused_opt_step_leaf, opt_step_ref
    from repro_torch.kernels.quant import quant_rr, quant_rtn
    from repro_torch.kernels.quant.ref import rr_ref, rtn_ref
    w = torch.randn(full_shape, generator=gen, device=dev) * 0.02
    even = torch.arange(0, full_shape[0], 2, device=dev)
    if dim == 1:
        w[even, -1, -1] = 0.5
    else:
        w[even, 0, -1] = 0.5
    absmax = torch.linalg.vector_norm(w, float("inf"), dim=(1, 2))
    cut = [slice(None)] * 3
    cut[dim] = slice(0, full_shape[dim] // n_blocks)
    wb = w[tuple(cut)].contiguous()
    own = torch.linalg.vector_norm(wb, float("inf"), dim=(1, 2))
    above = int((absmax > own).sum())
    n = wb.numel()
    f = torch.rand(wb.shape, generator=gen, device=dev) * 1e-6
    u = torch.rand(wb.shape, generator=gen, device=dev)
    g = torch.randn(wb.shape, generator=gen, device=dev) * 1e-3
    mu = torch.randn(wb.shape, generator=gen, device=dev) * 1e-4
    t = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    scal = dict(lr=t(3e-4), bc1=t(1 - 0.9 ** 3), bc2=t(1 - 0.95 ** 3),
                clip_scale=t(0.5), ok=t(1.0))
    okw = dict(lam=1e3, fmt_name="int4", block_size=-1, **OPT_HYPER)
    rows = []

    def row(kernel, same, err, **extra):
        ms, plain_ms, whole_ms = extra.pop("times")
        b_ms, b_by = _elem_bound(kernel if kernel != "quant_rr" else "quant",
                                 n, n * MESH_BYTES[kernel])
        r = dict(phase="check", kernel=kernel.replace("_rr", ""),
                 cast="rr" if kernel == "quant_rr" else None, leaf=label,
                 shape=_fmt_shape(wb.shape), full=_fmt_shape(full_shape),
                 matrices_given_above_own=above, bitwise=same,
                 max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 unsharded_ms=whole_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=None, **extra)
        emit(r)
        rows.append(r)

    got, want = quant_rtn(wb, "int4", -1, absmax), rtn_ref(wb, "int4", -1,
                                                           absmax)
    err, same, _ = _bitwise([("out", got, want)])
    row("quant", same, err, times=(
        timer(lambda: quant_rtn(wb, "int4", -1, absmax)),
        timer(lambda: rtn_ref(wb, "int4", -1, absmax), iters=3),
        timer(lambda: quant_rtn(w, "int4", -1))))
    got, want = (quant_rr(wb, u, "int4", -1, absmax),
                 rr_ref(wb, u, "int4", -1, absmax))
    err, same, _ = _bitwise([("out", got, want)])
    uw = torch.rand(full_shape, generator=gen, device=dev)
    row("quant_rr", same, err, times=(
        timer(lambda: quant_rr(wb, u, "int4", -1, absmax)),
        timer(lambda: rr_ref(wb, u, "int4", -1, absmax), iters=3),
        timer(lambda: quant_rr(w, uw, "int4", -1))))
    del uw, got, want
    (pen, grad), (pen_r, grad_r) = (
        lotion_penalty_fused_vg(wb, f, "int4", -1, 1e3, absmax),
        reg_ref(wb, f, "int4", -1, 1e3, absmax))
    err, same, _ = _bitwise([("grad", grad, grad_r)])
    fw = torch.rand(full_shape, generator=gen, device=dev) * 1e-6
    row("lotion_reg", same and _pen_rel(pen, pen_r) <= PENALTY_RTOL, err,
        penalty_rel_err=_pen_rel(pen, pen_r), times=(
            timer(lambda: lotion_penalty_fused_vg(wb, f, "int4", -1, 1e3,
                                                  absmax)),
            timer(lambda: reg_ref(wb, f, "int4", -1, 1e3, absmax), iters=3),
            timer(lambda: lotion_penalty_fused_vg(w, fw, "int4", -1, 1e3))))
    del grad, grad_r, fw
    want = opt_step_ref(wb, g, mu, f, **scal, **okw, absmax=absmax)
    wk, muk, nuk = wb.clone(), mu.clone(), f.clone()
    got = fused_opt_step_leaf(wk, g, muk, nuk, **scal, **okw, absmax=absmax)
    err, same, _ = _bitwise([("w", got[0], want[0]), ("mu", got[1], want[1]),
                             ("nu", got[2], want[2])])
    pen_err = _pen_rel(got[3], want[3])
    del got, want
    full = [torch.randn(full_shape, generator=gen, device=dev) * s
            for s in (1e-3, 1e-4)]
    fw = torch.rand(full_shape, generator=gen, device=dev) * 1e-6
    row("opt_step", same and pen_err <= PENALTY_RTOL, err,
        penalty_rel_err=pen_err, times=(
            timer(lambda: fused_opt_step_leaf(wk, g, muk, nuk, **scal, **okw,
                                              absmax=absmax)),
            timer(lambda: opt_step_ref(wb, g, mu, f, **scal, **okw,
                                       absmax=absmax), iters=3),
            timer(lambda: fused_opt_step_leaf(w, full[0], full[1], fw,
                                              **scal, **okw))))
    del full, fw, w
    return rows


def check_mesh_kernels(timer, dev):
    """``check_mesh_one`` on each of ``MESH_LEAVES``; raises unless every
    row is bitwise and every leaf has matrices whose given absmax is above
    the block's own."""
    gen = torch.Generator(device=dev).manual_seed(26)
    rows = []
    for leaf in MESH_LEAVES:
        rows += check_mesh_one(timer, gen, dev, *leaf)
        torch.cuda.empty_cache()
    bad = [(r["leaf"], r["kernel"], r["cast"]) for r in rows
           if not r["bitwise"] or not r["matrices_given_above_own"]]
    if bad:
        raise AssertionError(f"mesh kernels disagree: {bad}", dict(
            failed=bad))
    return rows


def train_mesh(dev, train_row, steps=3):
    """The train phase's run (40 layers at full width, 4 x 1024, 3 steps,
    the same settings, weights and batches) through the launcher's mesh
    path (``launch/train.py::mesh_training``) on a one-rank NCCL mesh:
    losses and the final fingerprint of params, mu and nu bitwise equal
    to the train phase's; ``opt_step`` launched once per leaf a step,
    nothing else."""
    from repro_torch.data import lm_batch, permutation_table
    from repro_torch.distributed import collectives
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import close_mesh, make_mesh
    from repro_torch.launch.train import mesh_training
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    try:
        cfg, _, tcfg, opt = granite_setup()
        perm = permutation_table(0, cfg.vocab)
        state, step, pipe, _ = mesh_training(
            cfg, tcfg, opt, mesh,
            lambda s: lm_batch(0, s, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, perm),
            TRAIN_BATCH, TRAIN_SEQ, prefetch=2)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n_leaves = len(tree_leaves(state["params"]))
        collectives.reset_staged()
        reset_launch_counts()
        try:
            state, rows = _train_steps(step, state, pipe, steps)
        finally:
            pipe.close()
        counts = launch_counts()
        t0 = time.perf_counter()
        fingerprint = _state_fingerprint(state)
        fingerprint_s = time.perf_counter() - t0
    finally:
        close_mesh()
    want = dict(counts, opt_step=n_leaves * steps, lotion_reg=0, quant=0,
                wqt_matmul=0, decode_attn=0)
    losses = [r["loss"] for r in rows]
    train_losses = [r["loss"] for r in train_row["steps"]]
    checks = {"losses_bitwise": losses == train_losses,
              "fingerprint_bitwise": fingerprint == train_row["fingerprint"],
              "fingerprint_card_equals_host": _fingerprint_paths_agree(dev),
              "launches": counts == want,
              "nothing_staged": not any(collectives.STAGED.values())}
    row = dict(phase="train_mesh", model=cfg.name, n_layers=cfg.n_layers,
               mesh="(1, 1)", backend=mesh.backend, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, setup_s=setup_s, steps=rows,
               step_ms=[r["step_ms"] for r in rows],
               train_step_ms=[r["step_ms"] for r in train_row["steps"]],
               losses=losses, train_losses=train_losses,
               fingerprint=fingerprint,
               train_fingerprint=train_row["fingerprint"],
               fingerprint_s=fingerprint_s, launches=counts,
               expected_launches=want, checks=checks)
    emit(row)
    del state, step
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"train_mesh failed its checks: {checks}", row)
    return row


def _compute_mode() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def train_mesh_two_ranks(dev, then_serve=False, then_chaos=False,
                         job=None):
    """Two processes share the card over gloo
    (``scripts/mesh_ranks_torch.py``): Granite at full width, 2 layers,
    fp32, 4 x 1024, one step from seeded second moments on meshes (2, 1)
    and (1, 2) under both penalty placements, each held against the same
    step on one rank; a step whose per-example CE is NaN on rank 1's rows
    only is skipped on both ranks; one EF step on each mesh, its int8
    codes and new error bitwise the one-device compression of the same
    gradients and error and the plain cast, one ``quant`` launch per
    gradient leaf, and a leaf whose cut splits quant blocks through the
    gathered path.  Each process is joined with a timeout, then killed.
    With ``then_chaos`` and ``then_serve`` the same processes then run
    ``train_mesh_chaos``' and ``serve_mesh_two_ranks``' parts (two
    process starts fewer).  ``job`` is those processes, started earlier
    (``start_two_ranks``; a whole run starts them before the phases they
    run beside, ``TWO_RANKS_BESIDE_FROM``)."""
    if job is None:
        parts = (["train"] + (["chaos"] if then_chaos else [])
                 + (["serve"] if then_serve else []))
        job = start_two_ranks("train_mesh_two_ranks", "mesh_ranks_torch.py",
                              parts)
    res, mode = join_two_ranks(job)
    if res is None:
        row = dict(phase="train_mesh_two_ranks", omitted=True,
                   compute_mode=mode)
        emit(row)
        return row
    row = dict(phase="train_mesh_two_ranks", compute_mode=mode,
               **res["train"])
    emit(row)
    if not res["train"]["ok"]:
        raise AssertionError(f"train_mesh_two_ranks failed: "
                             f"{res['train']['failed']}", row)
    # for train_mesh_chaos and serve_mesh_two_ranks, not printed
    row["chaos"], row["served"] = res.get("chaos"), res.get("serve")
    return row


# train_mesh_chaos: the final loss of the two ranks' run against the
# one-device two-host run's (|a - b| / |b|); about five times the card's
# readings (3.17e-5 at 4 x 1024, 4.18e-5 at 4 x 512, the same in five
# runs on an NVIDIA H100 80GB HBM3 at 700 W)
CHAOS_MESH_LOSS_RTOL = 2e-4
CHAOS_MESH_COUNTERS = ("segments", "crashes", "resumes", "rollbacks",
                       "skipped", "saves", "quarantined",
                       "host_kill_timeouts", "straggler_timeouts")


def train_mesh_chaos(dev, chaos=None, ref=None):
    """The mesh chaos tier on the card: ``train_chaos``'s two-host run
    (Granite full width, 1 layer, bf16, 4 x ``TRAIN_SEQ``, ``chaos_plan(1,
    18, 2)``, checkpoints on ``/dev/shm``) through the launcher's
    ``mesh_chaos`` on mesh (2, 1), two gloo processes sharing the card,
    each rank one simulated host (``scripts/mesh_ranks_torch.py``'s chaos
    part; in a whole run ``train_mesh_two_ranks``' processes have run it,
    ``chaos``).  Held to the one-device two-host run (``ref``, from
    ``train_chaos``): ``chaos_ok`` and no violation on every rank; every
    tier fired; the counters equal on both ranks and equal to the
    reference's; exactly one ``opt_step`` launch per leaf per train step
    run on each rank, nothing else; the final loss within
    ``CHAOS_MESH_LOSS_RTOL`` of the reference's; the final state's
    fingerprint equal on both ranks, and equal to the one-device digest
    of the state gathered whole."""
    mode = "as train_mesh_two_ranks"
    if chaos is None:
        res, mode = _two_ranks("train_mesh_chaos", "mesh_ranks_torch.py",
                               ["chaos"])
        chaos = None if res is None else res["chaos"]
    if chaos is None:
        row = dict(phase="train_mesh_chaos", omitted=True, compute_mode=mode)
        emit(row)
        return row
    ref = ref if ref is not None else chaos_reference(dev)
    ranks = chaos["ranks"]
    r0 = ranks[0]
    c = r0["counters"]
    want_counts = [dict(dict.fromkeys(r["launches"], 0),
                        opt_step=r["n_leaves"] * r["train_steps_run"])
                   for r in ranks]
    loss_rel = abs(r0["final_loss"] - ref["final_loss"]) / abs(
        ref["final_loss"])
    tiers = {"skip": c["skipped"] >= 1, "rollback": c["rollbacks"] >= 1,
             "quarantine": c["quarantined"] >= 1,
             "resume": c["resumes"] >= 1,
             "host_kill": c["host_kill_timeouts"] >= 1,
             "straggler": c["straggler_timeouts"] >= 1,
             "divergence_checks": c["divergence_checks"] >= 1}
    checks = {
        "ok_every_rank": all(r["ok"] and not r["violations"] for r in ranks),
        "tiers": all(tiers.values()),
        "counters_equal_across_ranks": all(r["counters"] == c
                                           for r in ranks),
        "counters_equal_one_device": all(
            c[k] == ref[k] for k in CHAOS_MESH_COUNTERS),
        "launches": all(r["launches"] == w
                        for r, w in zip(ranks, want_counts)),
        "final_loss": loss_rel <= CHAOS_MESH_LOSS_RTOL,
        "fingerprint_equal_across_ranks": all(
            r["fingerprint"] == r0["fingerprint"] for r in ranks),
        "fingerprint_is_gathered_state": all(
            r["gathered_fingerprint"] == r0["fingerprint"] for r in ranks)}
    row = dict(phase="train_mesh_chaos", compute_mode=mode,
               mesh=chaos["mesh"], n_layers=chaos["n_layers"],
               n_steps=chaos["n_steps"], dtype=chaos["dtype"],
               batch=chaos["batch"], seq=chaos["seq"], tiers=tiers,
               counters=[r["counters"] for r in ranks],
               one_device_counters={k: ref[k] for k in CHAOS_MESH_COUNTERS},
               final_loss=[r["final_loss"] for r in ranks],
               one_device_final_loss=ref["final_loss"],
               final_loss_rel_err=loss_rel,
               final_loss_rtol=CHAOS_MESH_LOSS_RTOL,
               violations=[r["violations"] for r in ranks],
               train_steps_run=[r["train_steps_run"] for r in ranks],
               launches=[r["launches"] for r in ranks],
               expected_launches=want_counts,
               seconds=[r["seconds"] for r in ranks],
               split_s=[r["split_s"] for r in ranks],
               one_device_seconds=ref["seconds"],
               one_device_split_s=ref["split_s"],
               seconds_in_process=chaos.get("seconds_in_process"),
               fingerprint=[r["fingerprint"] for r in ranks],
               fingerprint_s=[r["fingerprint_s"] for r in ranks],
               gathered_fingerprint=[r["gathered_fingerprint"]
                                     for r in ranks],
               one_device_fingerprint=ref["fingerprint"], checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"train_mesh_chaos failed: "
                             f"{[k for k, v in checks.items() if not v]}",
                             row)
    return row


# the scheduler half of serve_mesh runs at this depth (40 layers would
# take about 50 s of the script's time for the two runs; the static half
# runs all 40)
SERVE_MESH_SCHED_LAYERS = 8
# requests of sched's workload generator (16 take about twice as long)
SERVE_MESH_SCHED_REQUESTS = 8
SERVE_MESH_KERNELS = ("wqt_matmul", "decode_attn", "wqt_matmul_a8",
                      "decode_attn_paged")


def _sched_virtual(dev, cfg, mesh=None, n_requests=16):
    """``sched``'s workload on ``cfg`` through the W4A8 scheduler over the
    paged int8 pool, on the chaos replay's fault-free virtual clock (the
    ticks, and so the launches, are a function of the workload alone):
    (outputs, counters, violations, launches, seconds).  On ``mesh``
    through the launcher's placement."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serving_params
    from repro_torch.serve import Scheduler, SchedulerConfig, ServeConfig
    from repro_torch.serve.replay import replay_chaos
    params, sh, _ = serving_params(cfg, SCHED_SCFG["weights"], dev,
                                   mesh=mesh)
    scfg = dict(SCHED_SCFG, weights="fp32")
    sch = Scheduler(cfg, params, ServeConfig(max_new_tokens=32, **scfg),
                    SchedulerConfig(**SCHED_CFG), device=dev, shardings=sh)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = replay_chaos(sch, sched_workload(cfg.vocab, n_requests), plan=None)
    torch.cuda.synchronize()
    return dict(outputs=res["outputs"], counters=res["counters"],
                ticks=res["ticks"], violations=res["violations"],
                launches=launch_counts(), seconds=time.perf_counter() - t0)


def serve_mesh(dev, serve_row=None):
    """Sharded serving through the launcher's mesh path on a one-rank NCCL
    mesh: the ``serve`` run (40 layers, int4, int8 KV, batch 8) with its
    blocks drawn and cast on blocks, tokens, last logits and launches
    equal to ``serve``'s (run here when ``serve_row`` is not given); the
    W4A8 scheduler over the paged int8 pool on ``SERVE_MESH_SCHED_LAYERS``
    layers against one device's on the same virtual clock (tokens,
    counters and launches equal); the launcher's ``--chaos`` replay on 2
    layers with no violation."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.mesh import close_mesh, make_mesh
    from repro_torch.serve import Engine, ServeConfig
    if serve_row is None:
        serve_row = serve_full_width(dev)
    mnt = 32
    cfg = granite_cfg()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    try:
        t0 = time.perf_counter()
        params, sh, _ = launcher.serving_params(cfg, "rtn:int4", mesh.device,
                                                mesh=mesh)
        eng = Engine(cfg, params, ServeConfig(kv_quant="int8",
                                              max_new_tokens=mnt),
                     device=mesh.device, shardings=sh)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        prompts = _prompts(np.random.default_rng(0), 8, 64, 128, cfg.vocab)
        eng.generate(prompts[:2], max_new_tokens=2)           # warm-up
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.generate(prompts)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        static_launches = launch_counts()
        logits_sha = tensor_sha(eng.last_logits)
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        del eng, params
        torch.cuda.empty_cache()
        sched_cfg = granite_cfg(SERVE_MESH_SCHED_LAYERS)
        sched_mesh = _sched_virtual(mesh.device, sched_cfg, mesh,
                                    SERVE_MESH_SCHED_REQUESTS)
    finally:
        close_mesh()
    torch.cuda.empty_cache()
    sched_one = _sched_virtual(dev, sched_cfg, None,
                               SERVE_MESH_SCHED_REQUESTS)
    torch.cuda.empty_cache()
    chaos_log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(chaos_log):
        chaos = launcher.main([
            "--arch", "granite-3-2b", "--layers", "2", "--mesh", "1x1",
            "--chaos", "--weights", "rtn:int4", "--kv-quant", "int8",
            "--act-fmt", "int8", "--n-requests", "16", "--n-slots", "4",
            "--prompt-len", "48", "--new-tokens", "8"])
    chaos_s = time.perf_counter() - t0
    checks = {
        "tokens_equal_serve": outs == serve_row["tokens"],
        "last_logits_bitwise": logits_sha == serve_row["last_logits_sha"],
        "static_launches_equal": static_launches == serve_row["launches"],
        "sched_tokens_bitwise": sched_mesh["outputs"] == sched_one["outputs"],
        "sched_counters_equal": sched_mesh["counters"]
        == sched_one["counters"],
        "sched_launches_equal": sched_mesh["launches"]
        == sched_one["launches"],
        "sched_no_violations": sched_mesh["violations"]
        == sched_one["violations"] == [],
        "chaos_no_violations": chaos["violations"] == []}
    launches = {k: static_launches[k] + sched_mesh["launches"][k]
                for k in SERVE_MESH_KERNELS}
    row = dict(phase="serve_mesh", model=cfg.name, mesh="(1, 1)",
               backend="nccl", n_layers=cfg.n_layers, weights="rtn:int4",
               kv_quant="int8", batch=len(prompts), max_new_tokens=mnt,
               setup_s=setup_s, generate_s=gen_s, prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=(gen_s - prefill_s) * 1e3 / (mnt - 1),
               serve_decode_ms_per_step=serve_row["decode_ms_per_step"],
               serve_prefill_ms=serve_row["prefill_ms"],
               static_launches=static_launches,
               sched_n_layers=sched_cfg.n_layers,
               sched_ticks=sched_mesh["ticks"],
               sched_launches=sched_mesh["launches"],
               sched_one_device_launches=sched_one["launches"],
               sched_s=sched_mesh["seconds"],
               sched_one_device_s=sched_one["seconds"],
               chaos_by_state=chaos["by_state"], chaos_ticks=chaos["ticks"],
               chaos_s=chaos_s, launches=launches,
               seconds=time.perf_counter() - t_phase, checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"serve_mesh failed its checks: {checks}", row)
    return row


def _mesh_chaos_state_bytes() -> int:
    """Bytes of the mesh chaos run's whole state (the one-device state)."""
    from repro_torch.launch import specs
    cfg, _, tcfg, _ = granite_setup(n_layers=1, lr=CHAOS_LR)
    return _state_bytes(specs.state_specs(cfg, tcfg))


def start_two_ranks(phase, script, parts):
    """Start two processes of ``scripts/<script>`` sharing the card over
    gloo, to run ``parts`` in turn; returns the job for
    ``join_two_ranks``, or None where the card's compute mode refuses a
    second process.  The chaos part checkpoints to a directory on
    ``/dev/shm`` made here and removed at the join."""
    mode = _compute_mode()
    job = dict(phase=phase, parts=list(parts), mode=mode, procs=[])
    if mode.startswith("Exclusive"):
        return job
    tmp = tempfile.mkdtemp(prefix="mesh_ranks_")
    outs = {p: os.path.join(tmp, f"{p}.json") for p in parts}
    args = [f"{p}={path}" for p, path in outs.items()]
    ckpt = None
    if "chaos" in parts:
        ckpt, _ = _ckpt_dir(5 * _mesh_chaos_state_bytes(), ram=True)
        args.append(f"ckpt={ckpt}")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    path = os.path.join(ROOT, "scripts", script)
    job.update(tmp=tmp, outs=outs, ckpt=ckpt, t0=time.perf_counter(),
               timeout=sum(TWO_RANKS_TIMEOUT_S[p] for p in parts))
    job["procs"] = [subprocess.Popen(
        [sys.executable, path, os.path.join(tmp, "store"), str(r), "2"]
        + args, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    _LIVE_RANK_JOBS.add(id(job))
    return job


def join_two_ranks(job):
    """Wait for the job's processes (each within the parts'
    ``TWO_RANKS_TIMEOUT_S`` summed, from their start), then kill any
    left; returns ({part: rank 0's JSON result}, the compute mode), or
    (None, mode) for a job the compute mode refused."""
    if not job["procs"]:
        return None, job["mode"]
    phase, procs, outs = job["phase"], job["procs"], job["outs"]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(
                job["timeout"] - (time.perf_counter() - job["t0"]), 1))[0])
    except subprocess.TimeoutExpired:
        logs.append(f"a rank did not finish in {job['timeout']} s")
    finally:
        stop_two_ranks(job)
    seconds = time.perf_counter() - job["t0"]
    codes = [p.returncode for p in procs]
    try:
        if any(codes) or not all(os.path.exists(o) for o in outs.values()):
            raise AssertionError(f"{phase}: rank processes failed {codes}:\n"
                                 + "\n".join(x[-3000:] for x in logs),
                                 dict(phase=phase, codes=codes,
                                      error=logs[0][-2000:]))
        res = {}
        for p, o in outs.items():
            with open(o) as f:
                res[p] = json.load(f)
    finally:
        shutil.rmtree(job["tmp"], ignore_errors=True)
    res[job["parts"][0]]["seconds"] = seconds
    return res, job["mode"]


def stop_two_ranks(job) -> None:
    """Kill the job's processes that are still running and remove its
    checkpoint directory."""
    for p in job["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    _LIVE_RANK_JOBS.discard(id(job))
    if job.get("ckpt"):
        shutil.rmtree(job["ckpt"], ignore_errors=True)


def _two_ranks(phase, script, parts):
    """``start_two_ranks`` then ``join_two_ranks``."""
    return join_two_ranks(start_two_ranks(phase, script, parts))


def serve_mesh_two_ranks(dev, served=None):
    """Two processes share the card over gloo
    (``scripts/serve_ranks_torch.py``): Granite at full width, 2 layers,
    fp32, int4 weights, int8 KV, on meshes (2, 1) and (1, 2), the static
    engine and the W4A8 scheduler, and on (1, 2) blockwise int4 scales
    (block 128), each against one rank.  In a whole run the processes
    of ``train_mesh_two_ranks`` have run these checks already
    (``served``); alone, this phase starts its own."""
    res, mode = served, "as train_mesh_two_ranks"
    if res is None:
        res, mode = _two_ranks("serve_mesh_two_ranks",
                               "serve_ranks_torch.py", ["serve"])
        res = None if res is None else res["serve"]
    if res is None:
        row = dict(phase="serve_mesh_two_ranks", omitted=True,
                   compute_mode=mode)
        emit(row)
        return row
    row = dict(phase="serve_mesh_two_ranks", compute_mode=mode, **res)
    emit(row)
    if not res["ok"]:
        raise AssertionError(f"serve_mesh_two_ranks failed: "
                             f"{res['failed']}", row)
    return row


# the dry-run's peak against the live step's torch.cuda.max_memory_
# allocated; tightened from readings only
DRYRUN_PEAK_RTOL = 0.15


DRYRUN_CELLS = ("train_phase", "two_ranks", "train_4k", "decode_32k")
DRYRUN_TIMEOUT_S = 900
# the phase before which a whole run starts the dry-run's traces: the
# kernel, serving and scheduler phases before it run on a quiet host, as
# in earlier runs; the traces (a few minutes of one niced core) end
# during the training phases, which are bound by the card
DRYRUN_BESIDE_FROM = "train"


def start_dryrun_cells(cells=DRYRUN_CELLS):
    """``scripts/dryrun_cells_torch.py`` on ``cells``, started now in a
    process of its own: its traces take host time only (fake tensors, no
    kernel; a context on the card and one element, nothing more), so
    they run beside the card's phases.  Returns the job for
    ``dryrun_records``."""
    tmp = tempfile.mkdtemp(prefix="dryrun_cells_")
    out = os.path.join(tmp, "cells.jsonl")
    log = open(os.path.join(tmp, "log.txt"), "w")
    # one thread, at the lowest priority: the traces take the host's idle
    # time and leave its cores to the phases
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "dryrun_cells_torch.py"), out, *cells],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="1"),
        stdout=log, stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))
    return dict(proc=proc, out=out, tmp=tmp, log=log,
                started=time.perf_counter())


def stop_dryrun_cells(job) -> None:
    if job["proc"].poll() is None:
        job["proc"].kill()
        job["proc"].wait()
    job["log"].close()
    shutil.rmtree(job["tmp"], ignore_errors=True)


def dryrun_records(job):
    """The job's records, once it has ended: (records, seconds it ran,
    seconds waited for here)."""
    t0 = time.perf_counter()
    try:
        code = job["proc"].wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        code = None
    waited = time.perf_counter() - t0
    ran = time.perf_counter() - job["started"]
    try:
        if code != 0:
            job["log"].flush()
            with open(job["log"].name) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"dry-run cells failed ({code}):\n{tail}",
                                 dict(phase="dryrun", code=code,
                                      error=tail))
        with open(job["out"]) as f:
            recs = [json.loads(x) for x in f if x.strip()]
    finally:
        stop_dryrun_cells(job)
    return recs, ran, waited


def _collectives_vs_live(recs, two_ranks_row):
    """Each ``two_ranks`` record's traced collectives against the
    collectives that ``train_mesh_two_ranks``' step issued (same mesh and
    placement), op by op."""
    from repro_torch.launch.hlo_analysis import hlo_name
    live = {(r["mesh"], r["placement"]): {hlo_name(k): v for k, v
                                          in r["issued"].items()}
            for r in two_ranks_row["runs"]}
    rows = [dict(mesh=r["mesh"], placement=r["placement"],
                 traced=r["collectives"]["per_op"],
                 live=live.get((r["mesh"], r["placement"])),
                 wire_bytes=r["collectives"]["total_wire_bytes"],
                 trace_s=r["lower_s"], device=r["device"])
            for r in recs if r["cell"] == "two_ranks"]
    return dict(rows=rows, ok=len(rows) == len(live) and all(
        r["traced"] == r["live"] for r in rows))


def dryrun_collectives(dev, two_ranks_row=None):
    """The collectives ``launch/dryrun.py`` traces for the steps of
    ``train_mesh_two_ranks`` (its config) on fake (2, 1) and (1, 2)
    worlds against the collectives that phase's step issued (run here
    when its row is not given), alone: what a fault planted in the
    dry-run must fail."""
    if two_ranks_row is None:
        two_ranks_row = train_mesh_two_ranks(dev)
    if two_ranks_row.get("omitted"):
        return dict(phase="dryrun_collectives", omitted=True)
    recs, ran, _ = dryrun_records(start_dryrun_cells(("two_ranks",)))
    row = dict(phase="dryrun_collectives", seconds=ran,
               collectives=_collectives_vs_live(recs, two_ranks_row),
               cuda_max_reserved=max(r["cuda_max_reserved"] for r in recs))
    emit(row)
    if not row["collectives"]["ok"] or _traces_reach_card(recs):
        raise AssertionError("dryrun_collectives: the traced collectives "
                             "differ from the live step's, or the traces "
                             "reserved memory on the card", row)
    return row


# what the dry-run's process may reserve on the card: the caching
# allocator's smallest segment, which holds the one real element that
# torch's fake CUDA tensors make to start a context
DRYRUN_CARD_BYTES = 2 << 20


def _traces_reach_card(recs) -> bool:
    """Whether the dry-run's process reserved more of the card than the
    context its fake CUDA tensors start."""
    return any(r["cuda_max_reserved"] > DRYRUN_CARD_BYTES for r in recs)


def dryrun(dev, train_row=None, two_ranks_row=None, job=None):
    """The port's dry-run held to live numbers on the card, from the cells
    of ``job`` (``start_dryrun_cells``; started here when not given): the
    ``train`` phase's cell (40 layers, 4 x 1024, (1, 1)) traced on fake
    CUDA tensors, its FLOPs equal to ``FlopCounterMode``'s over one live
    step of that phase (``counted_step``; the step's kernels do no
    matmul) and its peak within ``DRYRUN_PEAK_RTOL`` of that step's
    ``max_memory_allocated``; the collectives of ``train_mesh_two_ranks``'
    steps (``dryrun_collectives``); and the roofline rows of
    Granite-3-2B ``train_4k`` and ``decode_32k`` on (16, 16)."""
    from repro_torch.launch import roofline
    if job is None:
        job = start_dryrun_cells()
    try:
        if train_row is None:
            train_row = train_full_width(dev)
        if two_ranks_row is None:
            two_ranks_row = train_mesh_two_ranks(dev)
    except BaseException:
        stop_dryrun_cells(job)
        raise
    recs, ran, waited = dryrun_records(job)
    rec = next(r for r in recs if r["cell"] == "train_phase")
    live = train_row["counted_step"]
    peak_rel = (abs(rec["mem"]["peak"] - live["max_memory_allocated"])
                / live["max_memory_allocated"])
    coll = (dict(omitted=True) if two_ranks_row.get("omitted")
            else _collectives_vs_live(recs, two_ranks_row))
    cells = {r["cell"]: dict(roofline.row(dict(r)),
                             flops_per_dev=r["flops_per_dev"],
                             hbm_bytes_per_dev=r["hbm_bytes_per_dev"],
                             collectives=r["collectives"]["per_op"],
                             trace_s=r["lower_s"])
             for r in recs if r["cell"] in ("train_4k", "decode_32k")}
    checks = {"flops_equal_live": rec["flops_per_dev"] == live["flops"],
              "peak_within_rtol": peak_rel <= DRYRUN_PEAK_RTOL,
              "collectives_equal_live": bool(coll.get("ok", True)),
              "cells_fit": len(cells) == 2 and all(
                  c["fits"] for c in cells.values()),
              "traces_off_card": not _traces_reach_card(recs)}
    row = dict(phase="dryrun", cell="train 40 layers 4 x 1024 (1, 1)",
               device=rec["device"], trace_s=rec["lower_s"],
               flops=rec["flops_per_dev"], live_flops=live["flops"],
               peak=rec["mem"]["peak"],
               live_peak=live["max_memory_allocated"],
               peak_rel_err=peak_rel, peak_rtol=DRYRUN_PEAK_RTOL,
               hbm_bytes=rec["hbm_bytes_per_dev"], opt_fused=rec["opt_fused"],
               collectives=coll, roofline_16x16=cells,
               cells_process_s=ran, waited_s=waited,
               cells_cuda_max_reserved=max(r["cuda_max_reserved"]
                                           for r in recs),
               cells_cuda_init_at=next((r["cuda_init_at"] for r in recs
                                        if r["cuda_init_at"]), None),
               checks=checks)
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"dryrun failed its checks: {checks}", row)
    return row


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
    dry_job = None
    phases = {"wqt": lambda: check_wqt(timer, dev),
              "attn": lambda: check_attn(timer, dev),
              "paged": lambda: check_paged(timer, dev),
              "a8": lambda: check_a8(timer, dev),
              "wq": lambda: check_wq(timer, dev),
              "wq_path": lambda: wq_path(dev),
              "layer": lambda: layer_rows(timer, dev),
              "quant": lambda: check_quant(timer, dev),
              "lotion_reg": lambda: check_lotion_reg(timer, dev),
              "lotion_reg_adversarial": lambda: check_reg_adversarial(dev),
              "lotion_reg_kernels": lambda: reg_kernels_per_call(dev),
              "opt_step": lambda: check_opt_step(timer, dev),
              "synth_kernels": lambda: check_synth_kernels(timer, dev),
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
              "ckpt_full_width": lambda: ckpt_full_width(dev),
              "synth_quadratic": lambda: synth_quadratic(dev),
              "synth_twolayer": lambda: synth_twolayer(dev),
              "train_long": lambda: train_long(dev),
              "zoo_kernels": lambda: check_zoo_kernels(timer, dev),
              "moe_qt3d": lambda: check_moe_qt3d(timer, dev),
              "serve_moe": lambda: serve_moe(dev),
              "serve_moe_card_vs_cpu": lambda: serve_moe_card_vs_cpu(dev),
              "serve_archs": lambda: serve_archs(dev),
              "serve_archs_card_vs_cpu": lambda: serve_archs_card_vs_cpu(dev),
              "musicgen_decode": lambda: musicgen_decode(dev),
              "ssm_kernels": lambda: check_ssm_kernels(timer, dev),
              "serve_zamba2": lambda: serve_zamba2(dev),
              "serve_rwkv6": lambda: serve_rwkv6(dev),
              "ssm_card_vs_cpu": lambda: ssm_card_vs_cpu(dev),
              "ssm_chunked_vs_exact": lambda: ssm_chunked_vs_exact(dev),
              "vision_kernels": lambda: check_vision_kernels(timer, dev),
              "zoo_train_kernels": lambda: check_zoo_train_kernels(timer,
                                                                   dev),
              "mesh_kernels": lambda: check_mesh_kernels(timer, dev),
              "serve_vision": lambda: serve_vision(dev),
              "vision_card_vs_cpu": lambda: vision_card_vs_cpu(dev),
              "train_vision": lambda: train_vision(dev),
              "train_zoo": lambda: train_zoo(dev),
              "train_zoo_card_vs_cpu": lambda: train_zoo_card_vs_cpu(dev),
              "train_mesh": lambda: train_mesh(dev, out["train"]),
              "train_mesh_two_ranks": lambda: train_mesh_two_ranks(
                  dev, job=ranks_job),
              "train_mesh_chaos": lambda: train_mesh_chaos(
                  dev, out["train_mesh_two_ranks"].get("chaos"),
                  out["train_chaos"]["runs"][2]),
              "serve_mesh": lambda: serve_mesh(dev, out["serve"]),
              "serve_mesh_two_ranks": lambda: serve_mesh_two_ranks(
                  dev, out["train_mesh_two_ranks"].get("served")),
              "dryrun": lambda: dryrun(dev, out["train"],
                                       out["train_mesh_two_ranks"],
                                       dry_job)}
    out = {}
    ranks_job = None
    try:
        for name, run in phases.items():
            if name == DRYRUN_BESIDE_FROM:
                dry_job = start_dryrun_cells()
            if name == TWO_RANKS_BESIDE_FROM:
                ranks_job = start_two_ranks(
                    "train_mesh_two_ranks", "mesh_ranks_torch.py",
                    ["train", "chaos", "serve"])
            t0 = time.perf_counter()
            out[name] = run()
            emit(dict(phase="timing", of=name,
                      seconds=time.perf_counter() - t0))
            if name in ("a8", "wq", "layer", "quant", "lotion_reg",
                        "opt_step", "synth_kernels", "zoo_kernels",
                        "moe_qt3d", "ssm_kernels", "vision_kernels",
                        "zoo_train_kernels", "mesh_kernels"):
                # the timer's flush buffer stays; the checks' inputs go
                torch.cuda.empty_cache()
    finally:
        if dry_job is not None:
            stop_dryrun_cells(dry_job)
        if ranks_job is not None:
            stop_two_ranks(ranks_job)

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
        synth_path="synth_quadratic (QAT, RAT, RTN evals) and "
        "synth_twolayer (QAT, RTN and RR evals), d = 12000",
        synth_quadratic_launches=out["synth_quadratic"]["launches"]["quant"],
        synth_twolayer_launches=out["synth_twolayer"]["launches"]["quant"],
        synth=_synth_summary(out["synth_kernels"], "quant"),
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
        synth_path="synth_quadratic (LOTION, E[RR] evals) and "
        "synth_twolayer (LOTION), d = 12000",
        synth_quadratic_launches=out["synth_quadratic"]["launches"][
            "lotion_reg"],
        synth_twolayer_launches=out["synth_twolayer"]["launches"][
            "lotion_reg"],
        synth=_synth_summary(out["synth_kernels"], "lotion_reg"),
        design="one launch per call, nothing zeroed: per-matrix scales on "
        "a persistent cooperative grid (absmax run slots, fold, gradient, "
        "partials summed by block 0 between grid barriers) or, for leaves "
        "of at most ops.CLUSTER_NUMEL elements, one thread block cluster "
        "(maxima and partials through distributed shared memory); "
        "blockwise a warp per quant block with the sum in the same launch",
        regimes={r["shape"]: r["regime"] for r in reg + out["synth_kernels"]
                 if r["kernel"] == "lotion_reg" and r["block_size"] == -1},
        device_kernels_per_call={
            r["shape"]: r["per_call"]
            for r in out["lotion_reg_kernels"]["rows"]},
        adversarial_rows=out["lotion_reg_adversarial"]["n_rows"],
        adversarial_bitwise=out["lotion_reg_adversarial"]["bitwise"],
        floor_ms=_leaf_sum(reg, "floor_ms", reg4, True),
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
        long_launches=out["train_long"]["launches"]["opt_step"],
        skip_gate_bitwise=not out["train_chaos"]["skip_gate"][
            "differing_leaves"],
        tol=tol + "; penalty within 1e-6 relative",
        shape="one AdamW step over all 11 leaves of Granite-3-2B (7 with "
        "the int4 per-tensor penalty), fp32",
        train_step_device_ms=step_dev,
        **stats(opt, opt4, opt_lib)))
    extra = (zoo_kernel_fields(out), ssm_kernel_fields(out),
             vision_kernel_fields(out), zoo_train_kernel_fields(out),
             mesh_kernel_fields(out), serve_mesh_kernel_fields(out))
    for line in lines:
        for fields in extra:
            line.update(fields.get(line["name"], {}))
    return lines


def mesh_kernel_fields(out):
    """The training kernels on a mesh's blocks: each ``mesh_kernels`` row
    (block of a Granite leaf, given the whole matrices' absmax) with its
    unsharded call's time, and the launches of the mesh paths
    (``train_mesh``: one NCCL rank; ``train_mesh_two_ranks``: two gloo
    ranks on one card, the runs' sum over rank 0, and its EF steps';
    ``train_mesh_chaos``: rank 0's chaos run)."""
    rows, two = out["mesh_kernels"], out["train_mesh_two_ranks"]
    chaos = out["train_mesh_chaos"]

    def runs_sum(kernel, runs="runs"):
        return (None if two.get("omitted") else
                sum(r["launches"][kernel] for r in two[runs]))

    fields = {}
    for kernel in ("quant", "lotion_reg", "opt_step"):
        mine = [r for r in rows if r["kernel"] == kernel]
        fields[kernel] = dict(
            mesh_path="train_mesh (1, 1) NCCL; train_mesh_two_ranks "
                      "(2, 1) and (1, 2) gloo, its EF steps on both; "
                      "train_mesh_chaos (2, 1) gloo",
            mesh_launches=out["train_mesh"]["launches"][kernel],
            mesh_two_ranks_launches=runs_sum(kernel),
            # rank 0's EF steps, one on (2, 1) and one on (1, 2)
            mesh_ef_launches=runs_sum(kernel, "ef"),
            mesh_chaos_launches=(None if chaos.get("omitted") else
                                 chaos["launches"][0][kernel]),
            mesh_rows=[{k: r[k] for k in (
                "leaf", "shape", "cast", "ms", "plain_ms", "unsharded_ms",
                "bound_ms", "bound_by", "bitwise",
                "matrices_given_above_own")} for r in mine],
            mesh_bitwise=all(r["bitwise"] for r in mine))
    return fields


def serve_mesh_kernel_fields(out):
    """The serving kernels' launches on the mesh paths: ``serve_mesh``
    (one NCCL rank: the static run, then the scheduler on 8 layers) and
    ``serve_mesh_two_ranks`` (two gloo ranks on one card, rank 0's runs
    summed)."""
    one, two = out["serve_mesh"], out["serve_mesh_two_ranks"]
    fields = {}
    for kernel in SERVE_MESH_KERNELS:
        fields[kernel] = dict(
            serve_mesh_path="serve_mesh (1, 1) NCCL static 40 layers and "
                            "scheduler 8 layers; serve_mesh_two_ranks "
                            "(2, 1) and (1, 2) gloo, 2 layers",
            serve_mesh_launches=one["launches"][kernel],
            serve_mesh_two_ranks_launches=(
                None if two.get("omitted") else
                sum(r["launches"][kernel] for r in two["runs"])))
    return fields


def _timed(r, *extra):
    return {k: r[k] for k in extra + ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}


def vision_kernel_fields(out):
    """The cross-attention slice's numbers for the kernels line: each
    serving kernel's launches in ``serve_vision``'s prefill and decode
    steps, the ``vision_kernels`` rows at Llama-3.2-Vision's shapes, and
    the eval casts' ``quant`` launches in ``train_vision``."""
    vk, sv = out["vision_kernels"], out["serve_vision"]
    return {
        "wqt_matmul": dict(
            vision_prefill_launches=sv["prefill_launches"]["wqt_matmul"],
            vision_decode_launches=sv["decode_launches"]["wqt_matmul"],
            vision={f"{r['model']}: ({r['M']}, {r['K']}) x ({r['N']}, "
                    f"{r['K']}) int4": _timed(r, "variant")
                    for r in vk if r["kernel"] == "wqt_matmul"}),
        "decode_attn": dict(
            vision_decode_launches=sv["decode_launches"]["decode_attn"],
            vision_hd128={f"b=8 g=8 rep=4 hd=128 L={r['L']} int8":
                          _timed(r, "variant", "splits")
                          for r in vk if r["kernel"] == "decode_attn"}),
        "quant": dict(vision_eval_launches=out["train_vision"][
            "eval_launches"]["quant"]),
    }


def zoo_train_kernel_fields(out):
    """The zoo's training numbers for the kernels line: ``opt_step``
    launches in ``train_vision`` and ``train_zoo``, and the
    ``zoo_train_kernels`` rows of ``opt_step`` and ``lotion_reg``: the
    2.2e9-element Moonlight stack and the SSM leaves."""
    rows = out["zoo_train_kernels"]
    tz = out["train_zoo"]

    def leaves(kernel):
        return {f"{r['model']} {r['shape']} {r.get('mode', 'matrix')}":
                dict(_timed(r), bitwise=r["bitwise"])
                for r in rows if r["kernel"] == kernel
                and r["model"] != "moonlight"}

    def moe(kernel):
        r = next(r for r in rows if r["kernel"] == kernel
                 and r["model"] == "moonlight")
        return dict(moe_leaf_shape=r["shape"], moe_leaf_bitwise=r["bitwise"],
                    moe_leaf_penalty_rel_err=r["penalty_rel_err"],
                    **{f"moe_leaf_{k}": v for k, v in _timed(r).items()})

    return {
        "opt_step": dict(
            vision_train_launches=out["train_vision"]["launches"][
                "opt_step"],
            zoo_train_launches={a: tz[a]["launches"]["opt_step"]
                                for a, _ in ZOO_TRAIN},
            zoo_leaves=leaves("opt_step"), **moe("opt_step")),
        "lotion_reg": dict(zoo_leaves=leaves("lotion_reg"),
                           **moe("lotion_reg")),
    }


def ssm_kernel_fields(out):
    """The SSM phases' numbers for the kernels line: each serving kernel's
    launches on Zamba2's and RWKV6's static and scheduler runs and in
    their ``prepare_params``, and the ``ssm_kernels`` rows (device ms,
    plain ms, bound, library) at their shapes: Zamba2's hd-80 ``fma``
    decode, the shared block's and the heads' matmuls, and the dense
    casts of every SSM leaf."""
    sk = out["ssm_kernels"]
    runs = {"zamba2": out["serve_zamba2"], "rwkv6": out["serve_rwkv6"]}

    def launches(run, kernel):
        return {m: r[run]["launches"][kernel] for m, r in runs.items()}

    def timed(r, *extra):
        return {k: r[k] for k in extra + ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}

    def mm(kernel):
        return {f"{r['model']}: ({r['M']}, {r['K']}) x ({r['N']}, "
                f"{r['K']}) int{r['bits']}": timed(r, "variant")
                for r in sk if r["kernel"] == kernel}

    leaves = [r for r in sk if r["kernel"] == "quant"]
    return {
        "wqt_matmul": dict(ssm_static_launches=launches("static",
                                                        "wqt_matmul"),
                           ssm=mm("wqt_matmul")),
        "decode_attn": dict(
            ssm_static_launches=launches("static", "decode_attn"),
            ssm_sched_launches=launches("sched", "decode_attn"),
            hd80={f"L={r['L']} int{r['bits']} {r['ring']}": timed(
                r, "variant", "splits") for r in sk
                if r["kernel"] == "decode_attn"}),
        "wqt_matmul_a8": dict(ssm_sched_launches=launches(
            "sched", "wqt_matmul_a8"), ssm=mm("wqt_matmul_a8_x")),
        "quant": dict(
            ssm_prepare_launches={m: r["static"]["prepare_launches"]["quant"]
                                  for m, r in runs.items()},
            ssm_leaves={f"{r['model']} {r['shape']}": timed(r)
                        for r in leaves},
            ssm_leaves_bitwise=all(r["bitwise"] for r in leaves)),
    }


def zoo_kernel_fields(out):
    """The zoo phases' numbers for the kernels line: each serving kernel's
    launches on the new paths, the hd-256 decode (``fma``) and the MoE
    expert leaf's cast beside their bounds, and the 3-D QTensor matmul
    (int4 per matrix, one launch per expert) at the experts' shapes."""
    zk, moe = out["zoo_kernels"], out["serve_moe"]
    static = {"moonlight_12_layers": moe["static"], "dbrx_2_layers":
              moe["dbrx"], "codeqwen": out["serve_archs"]["codeqwen1.5-7b"],
              "gemma3": out["serve_archs"]["gemma3-12b"]}
    runs = out["musicgen_decode"]["runs"]

    def launches(kernel):
        d = {k: v["launches"][kernel] for k, v in static.items()}
        d["musicgen"] = sum(r["launches"][kernel] for r in runs.values())
        return d

    def timed(r, prefix):
        return {f"{prefix}_{k}": r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}

    def qt3d(act):
        return {f"{r['model']} ({r['E']}, {r['M']}, {r['K']}) x ({r['E']}, "
                f"{r['N']}, {r['K']})": dict(ms=r["ms"], bound_ms=r["bound_ms"],
                                             library_ms=r["library_ms"],
                                             launches=r["launches"])
                for r in out["moe_qt3d"] if r["act_fmt"] == act
                and r["bits"] == 4 and r["block_k"] == -1}

    def hd256_row(kernel, dtype):
        return next(r for r in zk if r["kernel"] == kernel and r["hd"] == 256
                    and r["dtype"] == dtype and r["model"] != "gemma3 local")

    # Gemma3 serves fp32 queries; the bf16 instance is off its path
    hd256, hd256_bf16 = (hd256_row("decode_attn", d)
                         for d in ("float32", "bfloat16"))
    paged256 = hd256_row("decode_attn_paged", "float32")
    leaf = next(r for r in zk if r["kernel"] == "quant")
    gemma_fp32 = {f"({r['M']}, {r['K']}) x ({r['N']}, {r['K']})": dict(
        variant=r["variant"], **{k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for r in zk if r["kernel"] == "wqt_matmul"
        and r["dtype"] == "float32"}
    return {
        "wqt_matmul": dict(zoo_launches=launches("wqt_matmul"),
                           gemma3_fp32=gemma_fp32,
                           qt3d_path="moe_qt3d (check rows: no model path "
                           "holds 3-D QTensor experts)", qt3d=qt3d(None)),
        "decode_attn": dict(zoo_launches=launches("decode_attn"),
                            hd256_shape="gemma3 global: b=8 L=2048 g=8 "
                            "rep=2 hd=256 int8, fp32 queries",
                            hd256_variant=hd256["variant"],
                            **timed(hd256, "hd256"),
                            hd256_bf16_ms=hd256_bf16["ms"]),
        "wqt_matmul_a8": dict(moe_sched_launches=moe["sched"]["launches"][
            "wqt_matmul_a8"], qt3d=qt3d("int8"), zoo_x={
                f"{r['model']}: ({r['M']}, {r['K']}) x ({r['N']}, "
                f"{r['K']}) int{r['bits']}": {k: r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for r in zk if r["kernel"] == "wqt_matmul_a8_x"}),
        "decode_attn_paged": dict(
            moe_sched_launches=moe["sched"]["launches"]["decode_attn_paged"],
            hd256_variant=paged256["variant"], **timed(paged256, "hd256")),
        "quant": dict(moe_prepare_launches={
            k: v["prepare_launches"]["quant"] for k, v in static.items()},
            moe_leaf_shape=leaf["shape"], **timed(leaf, "moe_leaf")),
    }


def _synth_summary(rows, kernel):
    """Per testbed shape, the check rows' device ms, plain ms and bound
    (``quant``: the RTN and RR casts)."""
    out = {}
    for r in rows:
        if r["kernel"] != kernel:
            continue
        key = r["shape"] + (f" {r['cast']}" if kernel == "quant" else "")
        out[key] = dict(ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bitwise=r["bitwise"],
                        **({"regime": r["regime"]} if "regime" in r else {}))
    return out


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
