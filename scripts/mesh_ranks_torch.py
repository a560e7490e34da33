"""One of two ranks that share one card over gloo: the sharded training
step of Granite-3-2B at full width (2 layers, fp32, TF32 off, batch
4 x 1024: 2 rows per data rank), held against the same step on one rank.

    PYTHONPATH=src python3 scripts/mesh_ranks_torch.py STORE RANK 2 OUT \
        [SERVE_OUT]

``chip_smoke.py``'s phase ``train_mesh_two_ranks`` starts both ranks.
Runs: meshes (2, 1) and (1, 2) under the decoupled and the loss-side
penalty, each one LOTION step with the train phase's settings from
seeded second moments; rank 0 then runs the same step on one device.  Checks: every eligible leaf's per-matrix absmax and
the skip flag bitwise; the loss within ``LOSS_RTOL``; every updated
parameter, beyond one unit in the last place of the larger of the two
values, within ``PARAM_RTOL`` of the leaf's largest update.  Then a step
whose per-example CE is NaN on rank 1's rows only (the loss finite) must
be skipped on both ranks, the state bitwise unchanged.  Rank 0 writes one
JSON object to OUT.  ``MESH_RANKS_FAULT`` (a name in
``scripts/planted_faults_torch.py::MESH_FAULTS``) plants a fault in both
ranks.  Each run's row has the collectives its step issued (``issued``,
by op), which ``chip_smoke.py``'s dry-run phase holds its trace to.
With SERVE_OUT the ranks then run ``scripts/serve_ranks_torch.py``'s
checks (``serve_mesh_two_ranks``) and rank 0 writes them there.  Needs
CUDA.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import os
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

N_LAYERS, BATCH, SEQ = 2, 4, 1024
NU_INIT = (0.5e-6, 1.5e-6)
LOSS_RTOL = 1e-6
# |w'_mesh - w'_one| beyond one ulp, over the leaf's largest update: about
# five times the card's readings (4.14e-6 on (2, 1), 1.7e-7 on (1, 2), the
# same in three runs on an NVIDIA H100 80GB HBM3 at 700 W)
PARAM_RTOL = 2e-5
RUNS = [("2x1", "decoupled", "lotion"), ("2x1", "loss", "lotion"),
        ("1x2", "decoupled", "lotion"), ("1x2", "loss", "lotion")]


def _setup(placement, method):
    """The train phase's settings at N_LAYERS, fp32, without per-layer
    recomputation (each gathered leaf is then gathered once a step)."""
    import dataclasses

    import chip_smoke as cs
    cfg, qcfg, tcfg, opt = cs.granite_setup(
        n_layers=N_LAYERS, dtype="float32", placement=placement,
        method=method)
    return dataclasses.replace(cfg, remat=False), qcfg, tcfg, opt


def _seeded_nu(state, shardings, dev):
    """Each nu leaf drawn whole on the card in tree order (the one-device
    state's draws), the block kept."""
    from repro_torch.core.policy import tree_leaves
    from repro_torch.distributed import sharding as shd
    gen = torch.Generator(device=dev).manual_seed(1)
    nus = tree_leaves(state["opt"]["nu"])
    shs = [None] * len(nus) if shardings is None else tree_leaves(shardings)
    for nu, s in zip(nus, shs):
        full = torch.empty(shd.global_shape(s, nu.shape), device=dev)
        full.uniform_(*NU_INIT, generator=gen)
        nu.copy_(shd.shard(full, s))


def _absmax(params, shardings, policy):
    """path -> each eligible leaf's whole-matrix absmax (full, on rank
    0)."""
    from repro_torch.core.policy import path_str, tree_map_multi
    from repro_torch.distributed import sharding as shd
    out = {}

    def visit(path, x, s=None):
        if not policy.eligible(path, shd.full_view(x, s)):
            return
        if s is None:
            out[path_str(path)] = torch.linalg.vector_norm(
                x, float("inf"), dim=(-2, -1)).reshape(-1)
        else:
            lead = x.shape[:-2]
            a = shd.matrix_absmax(x, s).reshape(lead)
            out[path_str(path)] = shd.gather(a, shd.NamedSharding(
                s.mesh, s.spec[:len(lead)])).reshape(-1)
    tree_map_multi(visit, params, *(() if shardings is None
                                    else (shardings,)))
    return out


def one_step(dev, placement, method, mesh=None):
    """(metrics, absmax, params before, params after) of one step, full
    leaves on every rank."""
    from repro_torch.data import lm_batch, permutation_table
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.models.lm import lm_init
    from repro_torch.train import init_state, make_train_step
    cfg, qcfg, tcfg, opt = _setup(placement, method)
    psh = None
    if mesh is not None:
        psh = shd.params_shardings(mesh, specs.params_specs(cfg))
    state = init_state(lm_init(cfg, seed=0, device=dev, shardings=psh), opt)
    _seeded_nu(state, psh, dev)
    batch = lm_batch(0, 0, BATCH, SEQ, cfg.vocab,
                     permutation_table(0, cfg.vocab))
    if mesh is not None:
        batch = shd.sharded_batch(batch, shd.train_batch_shardings(
            mesh, batch, BATCH))
    batch = {k: v.to(dev) for k, v in batch.items()}
    step = make_train_step(cfg, tcfg, opt, grad_shardings=psh)

    def full(tree):
        if psh is None:
            return {k: v.clone() for k, v in _flat(tree).items()}
        # a copy: a leaf that nothing cuts gathers to itself, and the
        # step updates it in place
        return _flat(shd.apply_tree(lambda x, s: shd.gather(x, s).clone(),
                                    tree, psh))
    before = full(state["params"])
    absmax = _absmax(state["params"], psh, qcfg.policy)
    from repro_torch.distributed import collectives
    _sync(dev)
    collectives.reset_issued()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    _sync(dev)
    secs = time.perf_counter() - t0
    issued = collectives.issued()
    metrics = {k: float(v) for k, v in m.items()}
    return metrics, absmax, before, full(state["params"]), secs, issued


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _flat(tree):
    from repro_torch import bridge
    return bridge.flatten(tree)


def _param_err(got, want, before):
    """Largest excess over one ulp of |got - want|, over the leaf's
    largest update, for the worst leaf."""
    worst, worst_leaf = 0.0, None
    for k, w in want.items():
        g, b0 = got[k], before[k]
        top = torch.maximum(w.abs(), g.abs())
        ulp = torch.nextafter(top, torch.full_like(top, math.inf)) - top
        excess = float(((g - w).abs() - ulp).clamp_min(0.0).max())
        ref = float((w - b0).abs().max())
        err = excess / ref if ref > 0 else (0.0 if excess == 0 else math.inf)
        if err >= worst:
            worst, worst_leaf = err, k
    return worst, worst_leaf


def nan_step(dev, mesh):
    """Per rank: [skipped, state bitwise unchanged] of a step whose
    per-example CE is NaN on rank 1's rows."""
    import torch.distributed as dist
    from repro_torch.core.policy import tree_leaves
    from repro_torch.data import lm_batch, permutation_table
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.models.lm import lm_init
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.loop import make_loss_fn
    cfg, _, tcfg, opt = _setup("decoupled", "lotion")
    psh = shd.params_shardings(mesh, specs.params_specs(cfg))
    base = make_loss_fn(cfg, tcfg, psh)

    def loss_fn(p, batch, fisher, **kw):
        loss, aux = base(p, batch, fisher, **kw)
        aux = dict(aux)
        aux["ce_ex"] = aux["ce_ex"] * batch["poison_ex"]
        return loss, aux

    step = make_train_step(cfg, tcfg, opt, loss_fn=loss_fn,
                           grad_shardings=psh)
    state = init_state(lm_init(cfg, seed=0, device=dev, shardings=psh), opt)
    full = lm_batch(0, 0, BATCH, SEQ, cfg.vocab,
                    permutation_table(0, cfg.vocab))
    poison = torch.ones(BATCH)
    poison[2:] = float("nan")          # the rows of data rank 1
    b = dict(full, poison_ex=poison)
    b = shd.sharded_batch(b, shd.train_batch_shardings(mesh, b, BATCH))
    before = [x.clone() for x in tree_leaves(state["params"])
              + tree_leaves(state["opt"]["mu"])
              + tree_leaves(state["opt"]["nu"])]
    state, m = step(state, {k: v.to(dev) for k, v in b.items()})
    after = (tree_leaves(state["params"]) + tree_leaves(state["opt"]["mu"])
             + tree_leaves(state["opt"]["nu"]))
    mine = torch.tensor([int(bool(m["skipped"])), int(all(
        torch.equal(x, y) for x, y in zip(before, after)))])
    every = [torch.zeros_like(mine) for _ in range(mesh.size)]
    dist.all_gather(every, mine)
    return [e.tolist() for e in every]


def run(dev, rank):
    from repro_torch.distributed import collectives
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh, parse_mesh
    meshes = {m: make_mesh(*parse_mesh(m), dev.type) for m in ("2x1", "1x2")}
    rows, failed, refs = [], [], {}
    for mesh_name, placement, method in RUNS:
        mesh = meshes[mesh_name]
        collectives.reset_staged()
        reset_launch_counts()
        m, amax, before, after, secs, issued = one_step(dev, placement,
                                                        method, mesh)
        counts, staged = launch_counts(), dict(collectives.STAGED)
        if rank != 0:
            continue
        key = (placement, method)
        if key not in refs:
            reset_launch_counts()
            refs[key] = one_step(dev, placement, method)
            refs[key] = refs[key] + (launch_counts(),)
        rm, ramax, rbefore, rafter, rsecs, _, rcounts = refs[key]
        perr, pleaf = _param_err(after, rafter, rbefore)
        loss_rel = abs(m["loss"] - rm["loss"]) / abs(rm["loss"])
        checks = {
            "init_bitwise": all(torch.equal(before[k], rbefore[k])
                                for k in rbefore),
            "scales_bitwise": amax.keys() == ramax.keys() and all(
                torch.equal(amax[k], ramax[k]) for k in ramax),
            "skip_flags_equal": m["skipped"] == rm["skipped"] == 0.0,
            "loss": loss_rel <= LOSS_RTOL,
            "params": perr <= PARAM_RTOL,
            "launches": counts == rcounts}
        row = dict(mesh=mesh_name, placement=placement, method=method,
                   loss=m["loss"], one_rank_loss=rm["loss"],
                   loss_rel_err=loss_rel,
                   grad_norm=m["grad_norm"], one_rank_grad_norm=rm["grad_norm"],
                   penalty=m.get("penalty"),
                   one_rank_penalty=rm.get("penalty"),
                   param_err=perr, param_err_leaf=pleaf,
                   step_s=secs, one_rank_step_s=rsecs, launches=counts,
                   staged=staged, issued=issued, checks=checks)
        rows.append(row)
        if not all(checks.values()):
            failed.append((mesh_name, placement, method,
                           [k for k, v in checks.items() if not v]))
        del before, after
    gate = nan_step(dev, meshes["2x1"])
    if rank == 0:
        gate_ok = gate == [[1, 1]] * 2
        if not gate_ok:
            failed.append(("2x1", "nan_gate", gate))
        return dict(n_layers=N_LAYERS, batch=BATCH, seq=SEQ, dtype="float32",
                    loss_rtol=LOSS_RTOL, param_rtol=PARAM_RTOL, runs=rows,
                    nan_gate=gate, ok=not failed, failed=failed)
    return None


def main(argv):
    import torch.distributed as dist
    store_path, rank, world, out = argv[:4]
    serve_out = argv[4] if len(argv) > 4 else None
    rank, world = int(rank), int(world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    fault = os.environ.get("MESH_RANKS_FAULT")
    ctx = contextlib.nullcontext()
    if fault:
        from scripts.planted_faults_torch import MESH_FAULTS
        ctx = MESH_FAULTS[fault]()
    try:
        with ctx:
            res = run(dev, rank)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        dist.barrier()
        if serve_out:
            import scripts.serve_ranks_torch as serving
            t0 = time.perf_counter()
            with serving.fault_ctx():
                sres = serving.run(dev, rank)
            if rank == 0:
                sres["seconds_in_process"] = time.perf_counter() - t0
                with open(serve_out, "w") as f:
                    json.dump(sres, f)
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
