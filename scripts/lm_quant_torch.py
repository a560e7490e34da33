"""The paper's Tables 1/2 through the PyTorch/CUDA port, the twin of
``benchmarks/bench_lm_quant.py``: LM pretraining under PTQ, QAT, RAT and
LOTION on the synthetic Markov data, then the validation CE with fp32,
RTN-cast and RR-cast weights, at INT4 and INT8.  Every method gets the
same token budget, learning rate schedule and seed.

    PYTHONPATH=src python scripts/lm_quant_torch.py               # 4x128
    PYTHONPATH=src python scripts/lm_quant_torch.py --device cpu --steps 20
    PYTHONPATH=src python scripts/lm_quant_torch.py --arch granite-3-2b \\
        --layers 4 --steps 200 --batch 8 --seq 256

The default model and run are the JAX bench's (4 layers, d_model 128,
vocab 256, fp32, batch 16 x 64, 250 steps, LOTION at lam 1e4, seed 0).
``--arch`` trains the published config at full width instead (depth cut
to ``--layers``, bf16 activations, the default eligibility policy);
``--lams`` runs LOTION at each of several lambdas and ``--seeds`` every
method from each of several seeds.  A run whose loss (the CE plus the
decoupled penalty) stops being finite is reported as diverged at that
step, with no eval: decoupled LOTION at lam 1e4 on the bench config can
diverge, in the JAX package too (its penalty gradient feeds Adam's
second moment, which weights the penalty).  Prints one JSON
line per (format, method, lam, seed) with its CEs and mean step ms (host
clock, synchronized), then a summary line: the best quantized CE per
method and the mean eval CEs per (format, method, lam) over the runs that
did not diverge; with ``--out`` also writes them to that file.  On the GPU (the default) every step runs the port's
kernels (``opt_step``; ``quant`` for the QAT/RAT casts and the eval
casts) and the lines carry the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import lm_batch, markov_ce_floor, permutation_table
from repro_torch.models.lm import LMConfig, lm_init
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train import (TrainConfig, init_state, make_eval_fn,
                               make_optimizer, make_train_step)

BENCH_CFG = LMConfig(name="bench-lm", n_layers=4, d_model=128, n_heads=4,
                     n_kv_heads=2, d_ff=256, vocab=256, head_dim=32,
                     dtype="float32", remat=False)
METHODS = ("ptq", "qat", "rat", "lotion")


def train_one(cfg, policy, method, fmt, lam, seed, args, dev):
    """Returns (eval CE by weights, mean step ms, last loss, the step at
    which the loss stopped being finite or None)."""
    qcfg = QuantConfig(method=method, fmt_name=fmt, lam=lam, policy=policy)
    tcfg = TrainConfig(quant=qcfg, seed=seed)
    opt = make_optimizer(tcfg, adamw(cosine_with_warmup(
        3e-3, min(20, max(args.steps // 10, 1)), args.steps),
        weight_decay=0.0))
    state = init_state(lm_init(cfg, seed=seed, device=dev), opt)
    step = make_train_step(cfg, tcfg, opt)
    perm = permutation_table(0, cfg.vocab)
    times = []
    for s in range(args.steps):
        batch = lm_batch(0, s, args.batch, args.seq, cfg.vocab, perm,
                         device=dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])           # synchronizes
        times.append(time.perf_counter() - t0)
        if not math.isfinite(loss):
            return None, 1e3 * sum(times) / len(times), loss, s
    ev = make_eval_fn(cfg, qcfg)
    val = lm_batch(99, 10_000, args.val_batch, args.seq, cfg.vocab, perm,
                   device=dev)
    p = state["params"]
    gen = torch.Generator(device=dev).manual_seed(5)
    ce = {"fp32": float(ev(p, val)), "rtn": float(ev(p, val, "rtn")),
          "rr": float(ev(p, val, "rr", generator=gen))}
    steady = times[1:] or times
    return ce, 1e3 * sum(steady) / len(steady), loss, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="a published config at full width (default: the "
                         "JAX bench's 4x128 model)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--val-batch", type=int, default=64)
    ap.add_argument("--lams", default="1e4",
                    help="LOTION's lambdas, comma-separated")
    ap.add_argument("--fmts", default="int4,int8")
    ap.add_argument("--seeds", default="0", help="comma-separated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if args.arch:
        cfg, policy = get_config(args.arch), QuantPolicy()
    else:
        cfg, policy = BENCH_CFG, QuantPolicy(min_size=256)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    card = None
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    floor = markov_ce_floor(cfg.vocab, 0.2)
    lines = []
    runs = [(fmt, method, lam, int(seed))
            for seed in args.seeds.split(",")
            for fmt in args.fmts.split(",") for method in METHODS
            for lam in ([float(x) for x in args.lams.split(",")]
                        if method == "lotion" else [0.0])]
    for fmt, method, lam, seed in runs:
        ce, step_ms, last, diverged = train_one(cfg, policy, method, fmt,
                                                lam, seed, args, dev)
        row = dict(table="lm_quant", model=cfg.name, n_layers=cfg.n_layers,
                   d_model=cfg.d_model, dtype=str(cfg.dtype), fmt=fmt,
                   method=method, lam=lam, seed=seed, steps=args.steps,
                   batch=args.batch, seq=args.seq, final_train_loss=last,
                   diverged_at_step=diverged, eval_ce=ce,
                   rtn_gap=ce and ce["rtn"] - ce["fp32"],
                   rr_gap=ce and ce["rr"] - ce["fp32"], step_ms=step_ms,
                   floor=floor, device=str(dev), card=card)
        print(json.dumps(row), flush=True)
        lines.append(row)
    best, means = {}, {}
    for r in lines:
        if r["eval_ce"] is not None:
            b = best.setdefault(r["fmt"], {})
            q = min(r["eval_ce"]["rtn"], r["eval_ce"]["rr"])
            b[r["method"]] = min(b.get(r["method"], q), q)
            means.setdefault(f"{r['fmt']} {r['method']} lam={r['lam']:g}",
                             []).append(r["eval_ce"])
    # mean eval CE over the seeds that did not diverge
    means = {k: dict(n=len(v), **{w: sum(c[w] for c in v) / len(v)
                                  for w in ("fp32", "rtn", "rr")})
             for k, v in means.items()}
    summary = dict(table="lm_quant_summary", best_quantized_ce=best,
                   mean_eval_ce=means,
                   diverged=[(r["fmt"], r["method"], r["lam"], r["seed"],
                              r["diverged_at_step"]) for r in lines
                             if r["diverged_at_step"] is not None],
                   card=card)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in lines + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
