"""Serve a (quantized) model with batched requests through the PyTorch/CUDA
port: the twin of ``examples/serve_quantized.py``.

    PYTHONPATH=src python examples/serve_quantized_torch.py \
        --arch granite-3-2b --weights rtn:int4 --kv-quant int8

On the GPU (the default, ``--device cuda``) it serves the full published
config with random weights and the CUDA kernels; ``--device cpu`` serves
the smoke config through the plain PyTorch paths.  Weights are random,
drawn from ``--seed``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import param_nbytes
from repro_torch.models.lm import lm_init
from repro_torch.serve import Engine, ServeConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--weights", default="rtn:int4",
                    help="fp32 | rtn:int8 | rtn:int4")
    ap.add_argument("--kv-quant", default="int8",
                    help="none | int8 | int4")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    full = args.device != "cpu"
    cfg = get_config(args.arch) if full else get_smoke_config(args.arch)
    params = lm_init(cfg, args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(3, 9))).tolist()
               for _ in range(args.prompts)]
    kv = False if args.kv_quant == "none" else args.kv_quant

    for weights in ("fp32", args.weights):
        eng = Engine(cfg, params, ServeConfig(weights=weights, kv_quant=kv,
                                              max_new_tokens=args.max_new),
                     device=args.device)
        eng.generate(prompts[:1], max_new_tokens=2)           # warm-up
        if full:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.generate(prompts)
        if full:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_tok = sum(len(o) for o in outs)
        print(f"[{weights}, kv={args.kv_quant}, {args.device}] {n_tok} tokens "
              f"in {dt:.2f}s ({n_tok / dt:.1f} tok/s, batch={len(prompts)}, "
              f"weight storage {param_nbytes(eng.params) / 2**20:.2f} MiB)")
        for i, o in enumerate(outs[:2]):
            print(f"  prompt{i} -> {o}")
        del eng


if __name__ == "__main__":
    main()
