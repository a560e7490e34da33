"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each kernel against its plain PyTorch version on the card at the
serving path's shapes (and times kernel, plain version, a one-call PyTorch
yardstick and the least time the card could take), serves full-width
40-layer Granite-3-2B with int4 weights and an int8 KV cache through
``Engine`` with both kernels' launch counts checked, then compares the
card's prefill and first decode-step logits with the CPU's on a 2-layer
cut of the same model.  Each phase prints
one JSON line; a failed check raises and the script exits non-zero.  The
last three lines are the ``kernels`` summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.

Needs one CUDA device; without one it exits with an error and no result.
Imports only torch, numpy, the standard library and the port.
"""

from __future__ import annotations

import dataclasses
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


def bound(nbytes: float, flops: float):
    """Least time in ms: bytes over HBM rate vs operations over bf16 peak."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
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
    want = {"wqt_matmul": per_forward * mnt,
            "decode_attn": cfg.n_layers * (mnt - 1)}
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
    wqt_rows = check_wqt(timer, dev)
    attn_rows = check_attn(timer, dev)
    serve = serve_full_width(dev)
    card_vs_cpu(dev)

    emit({"kernels": kernels_line(wqt_rows, attn_rows, serve)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernels_line(wqt_rows, attn_rows, serve):
    """One entry per ported kernel, timed at the main path's decode shapes
    (one Granite layer's 7 matmuls at M = batch 8, int4 per-tensor, and
    one attention call); ``worst_err_over_tol`` is over every check row."""
    dec = {(r["N"], r["K"]): r for r in wqt_rows
           if r["M"] == 8 and r["bits"] == 4 and r["block_k"] == -1
           and r["dtype"] == "bfloat16" and (r["N"], r["K"]) in LAYER_MATMULS}

    def layer_sum(key):
        return sum(dec[s][key] * c for s, c in LAYER_MATMULS.items())

    b_bytes = sum(
        (8 * s[1] * 2 + s[0] * s[1] // 2 + 4 + 8 * s[0] * 2) * c
        for s, c in LAYER_MATMULS.items())
    b_flops = sum(2.0 * 8 * s[0] * s[1] * c for s, c in LAYER_MATMULS.items())
    wqt_bound, wqt_by = bound(b_bytes, b_flops)
    main_attn = next(r for r in attn_rows if r["L"] == 256 and r["bits"] == 8
                     and r["window"] is None and r["dtype"] == "bfloat16")
    return [
        dict(name="wqt_matmul", route="cuda",
             source="src/repro_torch/kernels/wq_matmul/csrc/wqt_matmul.cu",
             replaces="src/repro/kernels/wq_matmul/wq_matmul.py:279",
             launches=serve["launches"]["wqt_matmul"],
             max_abs_err=max(dec[s]["max_abs_err"] for s in LAYER_MATMULS),
             tol="2^-7 (bf16) or 1e-5 (fp32) of the largest output",
             worst_err_over_tol=max(r["max_abs_err"] / r["tol"]
                                    for r in wqt_rows),
             shape="one decode layer: 7 matmuls, M=8, int4 per-tensor, bf16",
             ms=layer_sum("ms"), plain_ms=layer_sum("plain_ms"),
             bound_ms=wqt_bound, bound_by=wqt_by,
             library_ms=layer_sum("library_ms")),
        dict(name="decode_attn", route="cuda",
             source="src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
             replaces="src/repro/kernels/decode_attn/decode_attn.py:123",
             launches=serve["launches"]["decode_attn"],
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


if __name__ == "__main__":
    sys.exit(main())
