"""End-to-end quantized training through the PyTorch/CUDA port: the twin
of ``examples/train_lm.py``, with quantized evaluation at the end.
``--method`` picks LOTION (default), the paper's QAT and RAT baselines
(straight-through RTN / RR fake-quant of the eligible weights in the
forward pass), PTQ or fp32; ``--act-fmt int8`` also fake-quantizes the
normed block inputs (RTN, one scale per batch row).

On the GPU (the default, ``--device cuda``): the full published config
with random weights, trained through the fused ``opt_step`` kernel (and
``lotion_reg`` with ``--placement loss``; the QAT/RAT casts and the
activation casts through ``quant``), evaluated through ``quant``:

    PYTHONPATH=src python examples/train_lm_torch.py --arch granite-3-2b \
        --steps 20 --batch 4 --seq 1024 [--method qat|rat] [--act-fmt int8]

On the CPU, the reduced smoke config through the plain PyTorch paths:

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --smoke \
        --steps 20 --batch 4 --seq 32

Prints per-step loss/gnorm, an RTN eval CE every quarter of the run and
the final fp32 / RTN / RR eval CE.
"""

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy, tree_leaves
from repro_torch.data import DataPipeline, lm_batch, permutation_table
from repro_torch.models.lm import lm_init
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train import (TrainConfig, init_state, make_eval_fn,
                               make_optimizer, make_train_step, run_loop)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--method", default="lotion",
                    choices=["fp32", "ptq", "qat", "rat", "lotion"])
    ap.add_argument("--act-fmt", default=None, choices=["int8", "int4"],
                    help="fake-quantize the normed block inputs (RTN)")
    ap.add_argument("--fmt", default="int4")
    ap.add_argument("--block-size", type=int, default=-1)
    ap.add_argument("--lam", type=float, default=1000.0)
    ap.add_argument("--placement", default=None,
                    choices=["loss", "decoupled"],
                    help="LOTION penalty placement (default: decoupled)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    cfg = dataclasses.replace(cfg, act_fmt=args.act_fmt)
    qcfg = QuantConfig(method=args.method, fmt_name=args.fmt, lam=args.lam,
                       block_size=args.block_size,
                       policy=QuantPolicy(min_size=256 if args.smoke
                                          else 1024))
    tcfg = TrainConfig(quant=qcfg, penalty_placement=args.placement,
                       seed=args.seed)
    opt = make_optimizer(tcfg, adamw(
        cosine_with_warmup(args.lr, max(args.steps // 20, 5), args.steps)))

    params = lm_init(cfg, seed=args.seed, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"# {cfg.name}: {n_params:,} params, {cfg.n_layers} layers, "
          f"method={args.method} placement={tcfg.placement} "
          f"act_fmt={args.act_fmt} device={dev}")
    state = init_state(params, opt)

    perm = permutation_table(args.seed, cfg.vocab)
    pipe = DataPipeline(lambda s: lm_batch(args.seed, s, args.batch, args.seq,
                                           cfg.vocab, perm), device=dev)
    step = make_train_step(cfg, tcfg, opt)
    ev = make_eval_fn(cfg, qcfg)
    val = lm_batch(args.seed + 99, 10 ** 6, args.batch, args.seq, cfg.vocab,
                   perm, device=dev)

    def eval_hook(st):
        rtn = float(ev(st["params"], val, "rtn"))
        print(f"  [eval] step {int(st['step'])} {args.fmt}-rtn CE = {rtn:.4f}")
        return rtn

    out = run_loop(step, state, pipe, args.steps,
                   eval_every=max(args.steps // 4, 1), eval_hook=eval_hook,
                   log_every=max(args.steps // 10, 1))
    pipe.close()
    p = out["state"]["params"]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    final = {"fp32": float(ev(p, val)), "rtn": float(ev(p, val, "rtn")),
             "rr": float(ev(p, val, "rr", generator=gen))}
    print(f"# final: fp32={final['fp32']:.4f} rtn={final['rtn']:.4f} "
          f"rr={final['rr']:.4f} skipped={out['skipped']}")
    return final


if __name__ == "__main__":
    main()
