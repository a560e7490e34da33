"""One rank of the port's CPU sharded-serving tests
(``tests/test_torch_serve_mesh.py``).

    python tests/torch_serve_mesh_worker.py STORE RANK WORLD DxM OUT

Joins a gloo world of WORLD ranks through the FileStore STORE, builds the
mesh DxM on the CPU and serves on it through the launcher's placement
(``launch/serve.py::serving_params``): the block casts of ``CASTS``
(every rank writes its blocks to ``OUT.rank<r>``), the static engine,
the scheduler's offered-load replay and the chaos replay of Granite
smoke, and on (1, 2) Moonlight and Zamba2 smoke and a planted
divergence of one rank's tokens.  Rank 0 writes the results to ``OUT``
(``torch.save``).  The same module runs the one-device reference (the
functions with ``mesh=None``).
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402

# (weights, block size): the casts held block for block
CASTS = [("rtn:int4", -1), ("rr:int4", -1), ("rtn:int8", 32),
         ("rr:int8", 32), ("rtn:int4", 32)]
SCFG = dict(kv_quant="int8", max_new_tokens=6)
SCHED = dict(n_slots=4, steps_per_tick=2, cache_len=64, prefill_chunk=16,
             prefix_cache=True, paged=True, block_size=16)


def prompts(vocab: int, n: int = 8, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 20))).tolist()
            for _ in range(n)]


def placed(arch: str, weights: str, block_size: int = -1, mesh=None):
    """The launcher's parameters (smoke config, seed 0), cast on blocks
    on a mesh; a blockwise cast goes through the block function itself."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.serve import serving_params
    cfg = get_smoke_config(arch)
    if block_size == -1:
        params, sh, _ = serving_params(cfg, weights, "cpu", min_size=256,
                                       mesh=mesh)
        return cfg, params, sh
    from repro_torch.core import QuantPolicy, quantize_params
    from repro_torch.core.formats import get_format
    params, sh, _ = serving_params(cfg, "fp32", "cpu", min_size=256,
                                   mesh=mesh)
    mode, fmt = weights.split(":")
    gen = torch.Generator().manual_seed(1)
    policy = QuantPolicy(min_size=256)
    if mesh is None:
        return cfg, quantize_params(params, get_format(fmt), policy,
                                    block_size, mode=mode,
                                    generator=gen), None
    params, sh = shd.quantize_params_on_blocks(
        params, sh, get_format(fmt), policy, block_size, mode=mode,
        generator=gen)
    return cfg, params, sh


def engine_run(arch: str, weights="rtn:int4", block_size=-1, mesh=None,
               act_fmt=None):
    """The static engine over 8 ragged prompts: tokens and last logits
    (every row)."""
    from repro_torch.serve import Engine, ServeConfig
    cfg, params, sh = placed(arch, weights, block_size, mesh)
    eng = Engine(cfg, params, ServeConfig(act_fmt=act_fmt, **SCFG),
                 device="cpu", shardings=sh)
    outs = eng.generate(prompts(cfg.vocab))
    return {"tokens": outs, "logits": eng.last_logits.clone()}


def sched_run(arch: str, mesh=None, **sched_kw):
    """The W4A8 scheduler's offered-load replay (its clock agreed over
    the ranks): each request's tokens, the counters."""
    from repro_torch.serve import Scheduler, SchedulerConfig, ServeConfig
    from repro_torch.serve.replay import poisson_workload, replay_continuous
    cfg, params, sh = placed(arch, "rtn:int4", mesh=mesh)
    sch = Scheduler(cfg, params, ServeConfig(act_fmt="int8", **SCFG),
                    SchedulerConfig(**dict(SCHED, **sched_kw)),
                    device="cpu", shardings=sh)
    wl = poisson_workload(0, 10, cfg.vocab, rate=200.0, prompt_lens=(2, 40),
                          budgets=(2, 4, 6))
    rec = replay_continuous(sch, wl)
    return {"outputs": rec["outputs"], "counters": dict(sch.counters)}


def chaos_run(mesh=None):
    """The launcher's chaos replay of Granite smoke (seed 13)."""
    from repro_torch.serve import (Scheduler, SchedulerConfig, ServeConfig,
                                   chaos_plan)
    from repro_torch.serve.replay import replay_chaos, sla_workload
    cfg, params, sh = placed("granite-3-2b", "rtn:int4", mesh=mesh)
    sch = Scheduler(cfg, params, ServeConfig(**SCFG), SchedulerConfig(
        n_slots=4, steps_per_tick=2, cache_len=48, max_queue=64,
        est_tok_per_s=200.0), device="cpu", shardings=sh)
    wl = sla_workload(13, 16, cfg.vocab, rate=100.0, prompt_lens=(2, 24),
                      budgets=(3, 6))
    plan = chaos_plan(seed=13, n_ticks=64, vocab=cfg.vocab, cache_len=48)
    res = replay_chaos(sch, wl, plan=plan)
    return {k: res[k] for k in ("outputs", "by_state", "violations",
                                "counters", "ticks")}


def diverge(mesh) -> str:
    """Rank 1's second tick emits another token: every rank's step must
    raise ``RanksDiverged``."""
    from repro_torch.serve import Scheduler, SchedulerConfig, ServeConfig
    from repro_torch.serve.scheduler import RanksDiverged
    cfg, params, sh = placed("granite-3-2b", "rtn:int4", mesh=mesh)
    sch = Scheduler(cfg, params, ServeConfig(**SCFG),
                    SchedulerConfig(n_slots=2, steps_per_tick=2,
                                    cache_len=48), device="cpu",
                    shardings=sh)
    tick = sch._tick

    def planted():
        em, bad = tick()
        if mesh.rank == 1 and sch.n_ticks == 2:
            em = em.copy()
            em[0, 0] = (em[0, 0] + 1) % cfg.vocab
        return em, bad

    sch._tick = planted
    try:
        sch.generate(prompts(cfg.vocab, n=2), max_new_tokens=6)
    except RanksDiverged as e:
        return str(e)
    return ""


def main(argv):
    import torch.distributed as dist

    from repro_torch.core import param_nbytes
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh, parse_mesh
    store_path, rank, world, mesh_arg, out_path = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    shape, axes = parse_mesh(mesh_arg)
    mesh = make_mesh(shape, axes, "cpu")
    res = {"blocks": {}, "nbytes": {}, "gathered_equal": {}}
    mine = {}
    for weights, bs in CASTS:
        key = f"{weights}/{bs}"
        _, blocks, sh = placed("granite-3-2b", weights, bs, mesh)
        mine[key] = blocks
        res["nbytes"][key] = param_nbytes(blocks)
        whole = placed("granite-3-2b", weights, bs)[1]
        same = []

        def visit(path, b, w, s):
            same.append(torch.equal(shd.gather(b, s), w))
        shd.tree_map_with_path(visit, blocks, whole, sh)
        res["gathered_equal"][key] = all(same)
        res["blocks"][key] = {
            "/".join(str(k) for k in p): s.spec
            for p, s in shd.tree_leaves_with_path(sh)}
    torch.save(mine, f"{out_path}.rank{rank}")
    res["engine"] = engine_run("granite-3-2b", mesh=mesh)
    res["engine_a8"] = engine_run("granite-3-2b", mesh=mesh, act_fmt="int8")
    res["sched"] = sched_run("granite-3-2b", mesh=mesh)
    res["chaos"] = chaos_run(mesh)
    if mesh_arg == "1x2":
        res["engine_blockwise"] = engine_run("granite-3-2b", "rtn:int4", 32,
                                             mesh=mesh)
        for arch in ("moonshot-v1-16b-a3b", "zamba2-2.7b"):
            res[f"engine_{arch}"] = engine_run(arch, mesh=mesh)
            res[f"sched_{arch}"] = sched_run(arch, mesh=mesh, paged=False,
                                             prefill_chunk=None,
                                             prefix_cache=False)
        res["diverge"] = diverge(mesh)
    if rank == 0:
        torch.save(res, out_path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
