"""One of two ranks that share one card over gloo: sharded serving of
Granite-3-2B at full width (2 layers, fp32 activations, int4 QTensor
weights, an int8 KV cache), held against the same serving on one rank.

    PYTHONPATH=src python3 scripts/serve_ranks_torch.py STORE RANK 2 \
        serve=OUT

``chip_smoke.py``'s phase ``serve_mesh_two_ranks`` starts both ranks
(in a whole run, ``scripts/mesh_ranks_torch.py``'s ranks run ``run``
after their training steps, which saves two processes' start).
Each rank places its blocks through the launcher
(``launch/serve.py::serving_params``: drawn on blocks, cast on blocks) on
meshes (2, 1) and (1, 2) and serves: the static engine over 4 ragged
prompts (on (2, 1) each rank decodes its 2 rows) and the W4A8 scheduler
over the paged int8 pool on the chaos replay's fault-free virtual clock;
on (1, 2) also the static engine with blockwise scales (int4, block 128:
cut with their codes, so a fault in the scales' gather shows; per-matrix
scales are (1, 1) on every rank).  Rank 0 serves the same on one device.
Checks: where nothing but the weights is cut (the scheduler, and the
static engine on (1, 2)) tokens and last logits bitwise; on (2, 1) the
static tokens equal, a parting allowed only at a near tie of the
one-device logits (``TIE_RTOL`` of the largest), and with equal tokens
the last logits within ``LOGIT_RTOL`` of the largest (the rank's matmuls
see fewer rows).  Rank 0 writes one JSON object to OUT.
``SERVE_RANKS_FAULT`` (a name in
``scripts/planted_faults_torch.py::SERVE_FAULTS``) plants a fault in both
ranks.  Needs CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

N_LAYERS, MNT, BLOCK = 2, 3, 128
# the rank's matmuls see 2 rows where one rank's see 4: the card's fp32
# matmuls split K by the rows and round their sums in another order, and
# an int8 KV code moves by one where a value sits at a rounding edge;
# about five times the card's reading (4.85e-4, NVIDIA H100 80GB HBM3 at
# 700 W)
LOGIT_RTOL = 2.5e-3
TIE_RTOL = 1e-4
SCHED = dict(n_slots=4, steps_per_tick=2, cache_len=64, prefill_chunk=16,
             prefix_cache=True, paged=True, block_size=16)


def _cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("granite-3-2b"), n_layers=N_LAYERS,
                               dtype="float32")


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=int(rng.integers(8, 24))).tolist()
            for _ in range(4)]


def _workload(vocab):
    from repro_torch.serve.replay import shared_prefix_workload
    return shared_prefix_workload(seed=3, n_requests=3, vocab=vocab,
                                  sys_len=16, tail_lens=(4, 12),
                                  straggler_len=24, budgets=(2, 3))


_PLACED = {}


def _placed(dev, mesh=None, block=-1):
    """The launcher's Granite blocks (or, without a mesh, its whole
    tree), int4 per-matrix or blockwise; made once per (mesh, block)."""
    key = (None if mesh is None else tuple(mesh.shape.items()), block)
    if key not in _PLACED:
        _PLACED[key] = _place(dev, mesh, block)
    return _PLACED[key]


def _place(dev, mesh, block):
    from repro_torch.core import QuantPolicy, quantize_params
    from repro_torch.core.formats import get_format
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.serve import serving_params
    cfg = _cfg()
    if block == -1:
        return serving_params(cfg, "rtn:int4", dev, mesh=mesh)[:2]
    params, sh, _ = serving_params(cfg, "fp32", dev, mesh=mesh)
    if mesh is None:
        return quantize_params(params, get_format("int4"),
                               QuantPolicy(min_size=1024), block), None
    return shd.quantize_params_on_blocks(params, sh, get_format("int4"),
                                         QuantPolicy(min_size=1024), block)


def static(dev, mesh=None, block=-1):
    from repro_torch.serve import Engine, ServeConfig
    cfg = _cfg()
    params, sh = _placed(dev, mesh, block)
    eng = Engine(cfg, params, ServeConfig(kv_quant="int8",
                                          max_new_tokens=MNT),
                 device=dev, shardings=sh)
    t0 = time.perf_counter()
    toks = eng.generate(_prompts(cfg.vocab))
    torch.cuda.synchronize()
    return {"tokens": toks, "logits": eng.last_logits.float().cpu(),
            "s": time.perf_counter() - t0}


def sched(dev, mesh=None):
    from repro_torch.serve import Scheduler, SchedulerConfig, ServeConfig
    from repro_torch.serve.replay import replay_chaos
    cfg = _cfg()
    params, sh = _placed(dev, mesh)
    sch = Scheduler(cfg, params, ServeConfig(kv_quant="int8",
                                             act_fmt="int8",
                                             max_new_tokens=MNT),
                    SchedulerConfig(**SCHED), device=dev, shardings=sh)
    t0 = time.perf_counter()
    res = replay_chaos(sch, _workload(cfg.vocab), plan=None)
    torch.cuda.synchronize()
    return {"outputs": {int(k): v for k, v in res["outputs"].items()},
            "violations": res["violations"], "ticks": res["ticks"],
            "counters": res["counters"], "s": time.perf_counter() - t0}


def _near_tie(dev, prompt, want, got):
    """The step where ``got`` leaves ``want`` is a near tie of the
    one-device logits (decoding ``want``)."""
    from repro_torch.models.lm import lm_decode, lm_prefill
    cfg = _cfg()
    params, _ = _placed(dev)
    step = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    with torch.inference_mode():
        lg, cache = lm_prefill(params, cfg, torch.tensor([prompt],
                                                         device=dev),
                               cache_len=64, kv_quant="int8")
        for i in range(step):
            lg, cache = lm_decode(params, cfg, cache,
                                  torch.tensor([[want[i]]], device=dev),
                                  torch.tensor([len(prompt) + i],
                                               device=dev))
    top2 = torch.sort(lg[0, 0].float()).values[-2:]
    return float(top2[1] - top2[0]) <= TIE_RTOL * float(lg.abs().max())


def _static_checks(dev, got, want, rows_cut):
    """(checks, the last logits' largest difference over their largest
    magnitude)."""
    err = float((got["logits"] - want["logits"]).abs().max()) / float(
        want["logits"].abs().max())
    if not rows_cut:
        return {"tokens_bitwise": got["tokens"] == want["tokens"],
                "logits_bitwise": torch.equal(got["logits"],
                                              want["logits"])}, err
    prompts = _prompts(_cfg().vocab)
    partings = [i for i, (g, w) in enumerate(zip(got["tokens"],
                                                 want["tokens"])) if g != w]
    out = {"partings_near_ties": all(
        _near_tie(dev, prompts[i], want["tokens"][i], got["tokens"][i])
        for i in partings)}
    if not partings:
        out["logits_within_rtol"] = err <= LOGIT_RTOL
    return out, err


def run(dev, rank):
    from repro_torch.distributed import collectives
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh, parse_mesh
    meshes = {m: make_mesh(*parse_mesh(m), dev.type) for m in ("2x1", "1x2")}
    runs = []
    for mesh_name, kind in (("2x1", "static"), ("2x1", "sched"),
                            ("1x2", "static"), ("1x2", "sched"),
                            ("1x2", "static_blockwise")):
        mesh = meshes[mesh_name]
        collectives.reset_staged()
        reset_launch_counts()
        if kind == "sched":
            got = sched(dev, mesh)
        else:
            got = static(dev, mesh, BLOCK if kind == "static_blockwise"
                         else -1)
        counts, staged = launch_counts(), dict(collectives.STAGED)
        if rank != 0:
            continue
        reset_launch_counts()
        if kind == "sched":
            want = sched(dev)
            checks = {"outputs_bitwise": got["outputs"] == want["outputs"],
                      "counters_equal": got["counters"] == want["counters"],
                      "no_violations": got["violations"] == [],
                      "launches_equal": counts == launch_counts()}
        else:
            want = static(dev, None, BLOCK if kind == "static_blockwise"
                          else -1)
            checks, err = _static_checks(dev, got, want, mesh_name == "2x1")
        runs.append(dict(mesh=mesh_name, kind=kind, seconds=got["s"],
                         logit_rel_err=None if kind == "sched" else err,
                         one_rank_seconds=want["s"], launches=counts,
                         staged=staged, checks=checks,
                         tokens=got.get("tokens", got.get("outputs"))))
    if rank == 0:
        failed = [(r["mesh"], r["kind"], [k for k, v in r["checks"].items()
                                          if not v])
                  for r in runs if not all(r["checks"].values())]
        return dict(n_layers=N_LAYERS, dtype="float32", weights="rtn:int4",
                    kv_quant="int8", block=BLOCK, logit_rtol=LOGIT_RTOL,
                    tie_rtol=TIE_RTOL, runs=runs, ok=not failed,
                    failed=failed)
    return None


def fault_ctx():
    """The fault ``SERVE_RANKS_FAULT`` names, planted for a block (none
    where it is unset)."""
    fault = os.environ.get("SERVE_RANKS_FAULT")
    if not fault:
        return contextlib.nullcontext()
    from scripts.planted_faults_torch import SERVE_FAULTS
    return SERVE_FAULTS[fault]()


def main(argv):
    import torch.distributed as dist
    store_path, rank, world = argv[:3]
    out = dict(a.split("=", 1) for a in argv[3:])["serve"]
    rank, world = int(rank), int(world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        with fault_ctx():
            res = run(dev, rank)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
