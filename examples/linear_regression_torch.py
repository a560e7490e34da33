"""The paper's §4.1 synthetic experiment through the PyTorch/CUDA port,
the twin of ``examples/linear_regression.py``: SGD on the power-law
quadratic, all four methods, INT4 quantized loss (Figure 2), at the
paper's d = 12000 unless ``--d`` says otherwise.

    PYTHONPATH=src python examples/linear_regression_torch.py
    PYTHONPATH=src python examples/linear_regression_torch.py --device cpu --d 2000

On the GPU (the default) the casts and penalties run the port's ``quant``
and ``lotion_reg`` kernels; ``--device cpu`` takes their plain versions.
"""

import argparse

import torch

from repro_torch.train import synthetic as syn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=syn.PAPER_D,
                    help="problem dimension (default: the paper's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    spec, w_star = syn.problem(args.d, dev)
    res = syn.best_per_method(syn.quadratic_runs(w_star, spec))
    print(f"# d={args.d} device={dev}")
    print(f"{'method':8s} {'RTN':>10s} {'E[RR]':>10s} {'fp32':>10s}")
    for m, r in res.items():
        print(f"{m:8s} {r['rtn']:10.5f} {r['e_rr']:10.5f} {r['fp32']:10.5f}"
              f"  (lr={r['lr']})")
    best = min(res, key=lambda m: min(res[m]["rtn"], res[m]["e_rr"]))
    print(f"# best quantized: {best} "
          f"(paper Fig.2: LOTION < PTQ < RAT < QAT)")


if __name__ == "__main__":
    main()
