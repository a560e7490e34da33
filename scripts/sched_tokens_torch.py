"""The greedy tokens of ``chip_smoke.py``'s scheduler phase, for comparing
two trees of the repository on one card.

    python3 scripts/sched_tokens_torch.py [--root DIR]

Runs ``chip_smoke.sched_full_width`` of the tree at ``--root`` (default:
this one; another tree, such as an unpacked ``git archive`` of an
earlier commit, is imported in its place) and prints one JSON line with
the tokens of every request of the workload, their SHA-256, and the
phase's tokens/s and launch counts.  Needs CUDA.
"""

import argparse
import hashlib
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    root = os.path.abspath(ap.parse_args().root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    if not torch.cuda.is_available():
        print("sched_tokens_torch: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch.serve.replay as replay

    held = []
    orig = replay.replay_continuous

    def keep(sch, wl, *args, **kw):
        held.append((sch, len(wl)))
        return orig(sch, wl, *args, **kw)

    replay.replay_continuous = keep
    row = cs.sched_full_width(torch.device("cuda"))
    sch, n = held[0]
    rids = sorted(sch.requests)[-n:]
    outs = [list(sch.requests[r].out) for r in rids]
    print(json.dumps(dict(
        phase="sched_tokens", root=root,
        sha256=hashlib.sha256(json.dumps(outs).encode()).hexdigest(),
        tokens=outs, tok_per_s=row["tok_per_s"],
        launches=row["launches"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
