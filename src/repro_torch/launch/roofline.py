"""Roofline aggregation over the port's dry-run records (the counterpart
of ``repro.launch.roofline``): per (arch x shape) on one mesh, the three
roofline terms, the dominant one, MODEL_FLOPS / traced FLOPs (the useful
share), the roofline fraction (model-FLOPs time at the H100's bf16 peak
over the dominant term's time) and whether the peak fits the card.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        dryrun.jsonl [--mesh 16x16] [--markdown]

It reads JAX's records as well: the keys are the same.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from repro_torch.launch.mesh import PEAK_FLOPS_BF16


def _norm(arch: str) -> str:
    return (arch or "").replace("-", "_").replace(".", "p")


def load(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    # keep the LAST record per (arch, shape, mesh): later runs supersede
    dedup: Dict[tuple, dict] = {}
    for r in out:
        r["arch"] = _norm(r.get("arch"))
        dedup[(r["arch"], r.get("shape"), r.get("mesh"))] = r
    return list(dedup.values())


def row(r: dict) -> dict:
    roof = r.get("roofline", {})
    tc = roof.get("t_compute_s", 0.0)
    tm = roof.get("t_memory_s", 0.0)
    tl = roof.get("t_collective_s", 0.0)
    dom = roof.get("bottleneck", "?")
    mf = r.get("model_flops", 0.0)
    n = r.get("n_devices", 1)
    t_model = mf / n / PEAK_FLOPS_BF16 if mf else 0.0
    t_dom = max(tc, tm, tl, 1e-12)
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "kind": r.get("kind", "?"),
        "t_compute_ms": tc * 1e3, "t_memory_ms": tm * 1e3,
        "t_collective_ms": tl * 1e3, "bottleneck": dom,
        "useful_ratio": r.get("useful_flops_ratio", 0.0),
        "roofline_frac": t_model / t_dom,
        "peak_gb": r.get("mem", {}).get("peak", 0) / 1e9,
        "fits": r.get("mem", {}).get("fits_hbm", False),
        "error": r.get("error"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)

    rows = [row(r) for r in load(args.jsonl)
            if r.get("mesh") == args.mesh and "error" not in r]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))

    if args.markdown:
        print("| arch | shape | compute ms | memory ms | collective ms | "
              "bottleneck | useful | roofline frac | peak GB | fits |")
        print("|---|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['arch']} | {r['shape']} | {r['t_compute_ms']:.2f} | "
                  f"{r['t_memory_ms']:.2f} | {r['t_collective_ms']:.2f} | "
                  f"{r['bottleneck']} | {r['useful_ratio']:.2f} | "
                  f"{r['roofline_frac']:.3f} | {r['peak_gb']:.2f} | "
                  f"{'Y' if r['fits'] else 'N'} |")
    else:
        for r in rows:
            print(f"{r['arch']:22s} {r['shape']:12s} "
                  f"C {r['t_compute_ms']:9.2f}ms M {r['t_memory_ms']:9.2f}ms "
                  f"L {r['t_collective_ms']:9.2f}ms -> {r['bottleneck']:10s} "
                  f"useful {r['useful_ratio']:.2f} "
                  f"roofline {r['roofline_frac']:.3f} "
                  f"peak {r['peak_gb']:6.2f}GB {'OK' if r['fits'] else 'OVER'}")

    errs = [r for r in (row(x) for x in load(args.jsonl)) if r["error"]]
    if errs:
        print(f"\n{len(errs)} cells FAILED:", file=sys.stderr)
        for r in errs:
            print(f"  {r['arch']} x {r['shape']} x {r['mesh']}: {r['error']}",
                  file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
