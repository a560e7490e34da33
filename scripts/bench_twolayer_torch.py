"""Paper Figure 3 through the PyTorch/CUDA port, the twin of
``benchmarks/bench_twolayer.py``: the final INT4-quantized loss against
the hidden width k of the two-layer linear network f(x) = W2 W1 x / k,
for PTQ, QAT and LOTION (its Fisher the exact Gauss-Newton diagonal) and
the paper's GT construction (W2 = 1, rows of W1 = w*), whose quantized
loss falls with k (Lemma 4).  Runs at d = 12000 (the paper's §4.1 d; the
JAX bench cuts it to 2000 for its CPU container).

    PYTHONPATH=src python scripts/bench_twolayer_torch.py
    PYTHONPATH=src python scripts/bench_twolayer_torch.py --device cpu --d 2000

Prints the JAX bench's rows (``name,us,derived``; here ``us`` is the mean
microseconds of one training run at that width, its eval included, host
clock, synchronized) and Lemma 4's check from the second width on.  On
the GPU (the default) the casts and penalties run the port's ``quant``
and ``lotion_reg`` kernels and the first line names the card and its
power limit; ``--device cpu`` takes their plain versions.
"""

from __future__ import annotations

import argparse

import torch

# the script's own folder is first on sys.path
from bench_quadratic_torch import device_line, emit
from repro_torch.train import synthetic as syn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d", type=int, default=syn.PAPER_D)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print(device_line(dev), flush=True)
    spec, w_star = syn.problem(args.d, dev, scale=0.5)
    rows = syn.twolayer_rows(w_star, spec)
    for r in rows:
        us = 1e6 * sum(r["seconds"].values()) / len(r["seconds"])
        emit(f"fig3_twolayer_k{r['k']}", us, ";".join(
            f"{m}={r[m]:.5f}" for m in syn.TWO_METHODS + ("gt",)))
        if "lemma4_gt_decreasing" in r:
            emit(f"fig3_lemma4_gt_decreasing_k{r['k']}", 0.0,
                 f"holds={r['lemma4_gt_decreasing']}")
    return rows


if __name__ == "__main__":
    main()
