"""Quickstart through the PyTorch/CUDA port, the twin of
``examples/quickstart.py``: train a small LM with LOTION, QAT and PTQ and
compare the quantized validation loss (the paper's headline metric,
Figure 1).

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 300]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On the GPU (the default) the optimizer steps, the QAT casts and the eval
casts run the port's CUDA kernels; ``--device cpu`` takes their plain
versions.  Prints one line per method: fp32, RTN and RR eval CE.
"""

import argparse

import torch

from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import (DataPipeline, lm_batch, markov_ce_floor,
                              permutation_table)
from repro_torch.models.lm import LMConfig, lm_init
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train import (TrainConfig, init_state, make_eval_fn,
                               make_optimizer, make_train_step, run_loop)

CFG = LMConfig(name="quickstart", n_layers=4, d_model=128, n_heads=4,
               n_kv_heads=2, d_ff=256, vocab=256, head_dim=32,
               dtype="float32", remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fmt", default="int4")
    ap.add_argument("--lam", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    policy = QuantPolicy(min_size=256)
    perm = permutation_table(0, CFG.vocab)
    val = lm_batch(99, 10_000, 64, 64, CFG.vocab, perm, device=dev)
    print(f"# data entropy floor: {markov_ce_floor(CFG.vocab, 0.2):.4f} "
          f"nats/token; device={dev}")
    out = {}
    for method, lam in [("lotion", args.lam), ("qat", 0.0), ("ptq", 0.0)]:
        qcfg = QuantConfig(method=method, fmt_name=args.fmt, lam=lam,
                           policy=policy)
        tcfg = TrainConfig(quant=qcfg)
        # the chain owns clip/penalty state: build once, share with the step
        opt = make_optimizer(tcfg, adamw(cosine_with_warmup(
            3e-3, 20, args.steps)))
        state = init_state(lm_init(CFG, seed=0, device=dev), opt)
        step = make_train_step(CFG, tcfg, opt)
        pipe = DataPipeline(lambda s: lm_batch(0, s, 16, 64, CFG.vocab, perm),
                            device=dev)
        try:
            res = run_loop(step, state, pipe, args.steps, log_every=100)
        finally:
            pipe.close()
        p, ev = res["state"]["params"], make_eval_fn(CFG, qcfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        out[method] = {"fp32": float(ev(p, val)),
                       "rtn": float(ev(p, val, "rtn")),
                       "rr": float(ev(p, val, "rr", generator=gen))}
        print(f"{method:7s} fp32={out[method]['fp32']:.4f} "
              f"{args.fmt}-rtn={out[method]['rtn']:.4f} "
              f"{args.fmt}-rr={out[method]['rr']:.4f}")
    return out


if __name__ == "__main__":
    main()
