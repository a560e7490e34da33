"""Paper Figure 2 through the PyTorch/CUDA port, the twin of
``benchmarks/bench_quadratic.py``: INT4-quantized population loss of SGD
on the power-law quadratic (lambda_i ~ i^-1.1), methods PTQ, QAT, RAT and
LOTION, each at its better of two learning rates, under RTN and the exact
E[RR] (Eq. 1).  Runs at the paper's d = 12000 (the JAX bench cuts it to
2000 for its CPU container).

    PYTHONPATH=src python scripts/bench_quadratic_torch.py
    PYTHONPATH=src python scripts/bench_quadratic_torch.py --device cpu --d 2000

Prints the JAX bench's rows (``name,us,derived``; here ``us`` is the mean
microseconds of one of the method's training runs, its eval included,
host clock, synchronized) and its three checks of the paper's claims.  On
the GPU (the default) the casts and penalties run the port's ``quant``
and ``lotion_reg`` kernels and the first line names the card and its
power limit; ``--device cpu`` takes their plain versions.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from repro_torch.train import synthetic as syn


def device_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return f"# device: {dev}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return f"# device: {smi[0]}"


def emit(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d", type=int, default=syn.PAPER_D)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print(device_line(dev), flush=True)
    spec, w_star = syn.problem(args.d, dev)
    runs = syn.quadratic_runs(w_star, spec)
    best = syn.best_per_method(runs)
    for m, r in best.items():
        us = 1e6 * sum(x["seconds"] for x in runs if x["method"] == m) / sum(
            1 for x in runs if x["method"] == m)
        emit(f"fig2_quadratic_int4_{m}", us,
             f"rtn={r['rtn']:.5f};E_rr={r['e_rr']:.5f};fp32={r['fp32']:.5f};"
             f"lr={r['lr']}")
    claims = syn.fig2_claims(best)
    emit("fig2_lotion_best_on_rr", 0.0,
         f"holds={claims['lotion_best_on_rr']}")
    emit("fig2_qat_worst", 0.0, f"holds={claims['qat_worst']}")
    emit("fig2_lemma3_rat_matches_ptq", 0.0,
         f"holds={claims['lemma3_rat_matches_ptq']}")
    return runs


if __name__ == "__main__":
    main()
