"""One of two ranks that share one card over gloo: the sharded training
step of Granite-3-2B at full width (2 layers, fp32, TF32 off, batch
4 x 1024: 2 rows per data rank), held against the same step on one rank;
EF compression on the mesh; the mesh chaos tier.

    PYTHONPATH=src python3 scripts/mesh_ranks_torch.py STORE RANK 2 \
        [train=OUT] [chaos=OUT ckpt=DIR] [serve=OUT]

``chip_smoke.py``'s phases ``train_mesh_two_ranks`` and
``train_mesh_chaos`` start both ranks; each part named runs, in the order
train, chaos, serve, and rank 0 writes its JSON object to its OUT.

``train``: meshes (2, 1) and (1, 2) under the decoupled and the
loss-side penalty, each one LOTION step with the train phase's settings
from seeded second moments; rank 0 then runs the same step on one
device.  Checks: every eligible leaf's per-matrix absmax and the skip
flag bitwise; the loss within ``LOSS_RTOL``; every updated parameter,
beyond one unit in the last place of the larger of the two values,
within ``PARAM_RTOL`` of the leaf's largest update.  Then a step whose
per-example CE is NaN on rank 1's rows only (the loss finite) must be
skipped on both ranks, the state bitwise unchanged.  Then one EF step
(clip -> ef -> lotion_decoupled -> AdamW) on each mesh (``ef_rows``):
the int8 codes and the new error bitwise the one-device compression of
the same gradients and error and the plain cast, one ``quant`` launch
per gradient leaf, the parameters and loss against one rank as above;
and a leaf whose cut splits quant blocks (``SPLIT_LEAF``) through the
gathered path, bitwise.  Each run's row has the collectives its step
issued (``issued``, by op), which ``chip_smoke.py``'s dry-run phase
holds its trace to.

``chaos``: ``chip_smoke.train_chaos``'s two-host run through the
launcher's ``mesh_chaos`` on (2, 1), checkpoints in DIR (``chaos``).

``serve``: ``scripts/serve_ranks_torch.py``'s checks
(``serve_mesh_two_ranks``).

``MESH_RANKS_FAULT`` (a name in
``scripts/planted_faults_torch.py::MESH_FAULTS``) plants a fault in both
ranks for the train and chaos parts.  Needs CUDA.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import json
import math
import os
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

N_LAYERS, BATCH, SEQ = 2, 4, 1024
EF_FMT, EF_BLOCK = "int8", 256
NU_INIT = (0.5e-6, 1.5e-6)
LOSS_RTOL = 1e-6
# |w'_mesh - w'_one| beyond one ulp, over the leaf's largest update: about
# five times the card's readings (4.14e-6 on (2, 1), 1.7e-7 on (1, 2), the
# same in three runs on an NVIDIA H100 80GB HBM3 at 700 W)
PARAM_RTOL = 2e-5
RUNS = [("2x1", "decoupled", "lotion"), ("2x1", "loss", "lotion"),
        ("1x2", "decoupled", "lotion"), ("1x2", "loss", "lotion")]


def _setup(placement, method, **kw):
    """The train phase's settings at N_LAYERS, fp32, without per-layer
    recomputation (each gathered leaf is then gathered once a step)."""
    import dataclasses

    import chip_smoke as cs
    cfg, qcfg, tcfg, opt = cs.granite_setup(
        n_layers=N_LAYERS, dtype="float32", placement=placement,
        method=method, **kw)
    return dataclasses.replace(cfg, remat=False), qcfg, tcfg, opt


def _seeded_nu(nu_tree, shardings, dev):
    """Each nu leaf drawn whole on the card in tree order (the one-device
    state's draws), the block kept."""
    from repro_torch.core.policy import tree_leaves
    from repro_torch.distributed import sharding as shd
    gen = torch.Generator(device=dev).manual_seed(1)
    nus = tree_leaves(nu_tree)
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
    _seeded_nu(state["opt"]["nu"], psh, dev)
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


@contextlib.contextmanager
def _recorded_compressions(calls):
    """``train.compress.ef_compress`` recording each call's inputs and
    outputs (the chain's EF link looks it up at call time); yields the
    function itself."""
    from repro_torch.train import compress
    orig = compress.ef_compress

    def rec(grads, err, block_size=256, shardings=None):
        out = orig(grads, err, block_size, shardings)
        calls.append((grads, err, block_size, shardings, out))
        return out
    compress.ef_compress = rec
    try:
        yield orig
    finally:
        compress.ef_compress = orig


def _bits_differ(a, b) -> float:
    """0.0 where ``a`` and ``b`` hold the same bits, else their largest
    |difference| (inf where a NaN or a shape parts them)."""
    import chip_smoke as cs
    if a.shape != b.shape or a.dtype != b.dtype:
        return math.inf
    if torch.equal(cs._bits(a), cs._bits(b)):
        return 0.0
    return float((a - b).abs().nan_to_num(math.inf).max())


def _ef_blocks_vs(calls, one_device):
    """For each recorded compression on blocks: the worst bit difference
    of its codes and new error from (a) the one-device compression of
    the gathered gradients and error (the kernel on whole leaves), (b)
    the plain cast of the same operand (the block, or the gathered leaf
    where the cut splits quant blocks)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.quant import rtn_ref
    vs_one, vs_plain = 0.0, 0.0
    for g, e, bs, sh, (q, ne) in calls:
        def full(tree):
            return shd.apply_tree(lambda x, s: shd.gather(x, s), tree, sh)
        want_q, want_e = one_device(full(g), full(e), bs)
        for (path, qb), eb, wq, we, gb, errb, s in zip(
                shd.tree_leaves_with_path(q), _leaves(ne), _leaves(want_q),
                _leaves(want_e), _leaves(g), _leaves(e), _leaves(sh)):
            vs_one = max(vs_one, _bits_differ(qb, shd.shard(wq, s)),
                         _bits_differ(eb, shd.shard(we, s)))
            corrected = gb + errb
            if shd.whole_blocks(shd.global_shape(s, gb.shape), s, bs):
                plain = rtn_ref(corrected, EF_FMT, bs)
            else:
                plain = shd.shard(rtn_ref(shd.gather(corrected, s), EF_FMT,
                                          bs), s)
            vs_plain = max(vs_plain, _bits_differ(qb, plain))
    return vs_one, vs_plain


def _leaves(tree):
    from repro_torch.core.policy import tree_leaves
    return tree_leaves(tree)


def _chain_after_clip(state, grads, tx):
    """The parameters after the chain's links past the clip (ef ->
    lotion_decoupled -> AdamW) take ``grads`` (clipped already) on one
    rank."""
    from repro_torch.optim import apply_updates
    fisher = tx.fisher(state["opt"])
    ok = torch.ones((), dtype=torch.bool, device=_leaves(fisher)[0].device)
    u = grads
    for link, st in zip(tx.links[1:], state["opt"][1:]):
        u, _ = link.update(u, st, state["params"], fisher=fisher, step_ok=ok)
    return apply_updates(state["params"], u)


def ef_step(dev, mesh):
    """One EF step (clip -> ef -> lotion_decoupled -> AdamW, from seeded
    second moments) on ``mesh``: (metrics, params before and after, the
    one-rank chain's params after from the same clipped gradients (rank
    0), seconds, launches, gathered leaves, every rank's worst bit
    difference of the compression from the one-device compression and
    from the plain cast, the number of leaves and of eligible ones)."""
    from repro_torch.data import lm_batch, permutation_table
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import specs
    from repro_torch.models.lm import lm_init
    from repro_torch.train import compress, init_state, make_train_step
    cfg, qcfg, tcfg, opt = _setup("decoupled", "lotion", ef_compress=True)
    psh = shd.params_shardings(mesh, specs.params_specs(cfg))
    state = init_state(lm_init(cfg, seed=0, device=dev, shardings=psh), opt)
    _seeded_nu(state["opt"][-1]["nu"], psh, dev)
    batch = lm_batch(0, 0, BATCH, SEQ, cfg.vocab,
                     permutation_table(0, cfg.vocab))
    batch = shd.sharded_batch(batch, shd.train_batch_shardings(
        mesh, batch, BATCH))
    batch = {k: v.to(dev) for k, v in batch.items()}
    step = make_train_step(cfg, tcfg, opt, grad_shardings=psh)

    def full(tree):
        return shd.apply_tree(lambda x, s: shd.gather(x, s).clone(), tree,
                              psh)
    before = _flat(full(state["params"]))
    calls = []
    compress.reset_gathered()
    _sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with _recorded_compressions(calls) as one_device:
        state, m = step(state, batch)
    _sync(dev)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    gathered = sorted(compress.GATHERED)
    n_leaves = len(_leaves(state["params"]))
    n_eligible = sum(qcfg.policy.eligible(p, shd.full_view(x, s))
                     for (p, x), s in zip(
                         shd.tree_leaves_with_path(state["params"]),
                         _leaves(psh)))
    diffs = collectives.gather_objects(_ef_blocks_vs(calls, one_device))
    clipped = full(calls[0][0])
    after = _flat(full(state["params"]))
    ref_after = None
    if mesh.rank == 0:
        ref = init_state(lm_init(cfg, seed=0, device=dev), opt)
        _seeded_nu(ref["opt"][-1]["nu"], None, dev)
        ref_after = _flat(_chain_after_clip(ref, clipped, step.optimizer))
        del ref
    del clipped, calls
    metrics = {k: float(v) for k, v in m.items()}
    return (metrics, before, after, ref_after, secs, counts, gathered,
            diffs, n_leaves, n_eligible)


# Granite's leaves all hold whole int8 blocks of 256 on (2, 1) and (1, 2)
# at full width, so one more EF row takes the gathered path: a leaf whose
# rows of 1,000 the mesh cuts in halves of 500
SPLIT_LEAF = (64, 1000)


def ef_split_leaf(dev, mesh):
    """The EF compression of a SPLIT_LEAF gradient and error on ``mesh``:
    its gathered leaves, the ``quant`` launches, and every rank's worst
    bit difference from the one-device compression and the plain cast."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import compress
    axis = "data" if mesh.shape["data"] > 1 else "model"
    sh = {"split": shd.NamedSharding(mesh, shd.P(None, axis))}
    gen = torch.Generator(device=dev).manual_seed(27)
    g = {"split": torch.randn(SPLIT_LEAF, generator=gen, device=dev) * 1e-3}
    e = {"split": torch.randn(SPLIT_LEAF, generator=gen, device=dev) * 1e-5}
    blocks = [shd.apply_tree(lambda x, s: shd.shard(x, s), t, sh)
              for t in (g, e)]
    calls = []
    compress.reset_gathered()
    reset_launch_counts()
    with _recorded_compressions(calls) as one_device:
        compress.ef_compress(*blocks, EF_BLOCK, sh)
    launches = launch_counts()["quant"]
    gathered = sorted(compress.GATHERED)
    diffs = collectives.gather_objects(_ef_blocks_vs(calls, one_device))
    return dict(leaf=list(SPLIT_LEAF), spec=str(sh["split"].spec),
                gathered=gathered, quant_launches=launches,
                diffs=diffs)


def ef_rows(dev, rank, meshes, failed):
    """One EF step on each mesh (rank 0 checks): the compression's codes
    and new error bitwise the one-device compression of the same
    gradients and error and the plain cast; the parameters, beyond one
    ulp, within PARAM_RTOL of the same chain past the clip on one rank
    fed the same clipped gradients (gathered); exactly one ``quant``
    launch per gradient leaf (a block cast, or a gathered leaf's) and one
    ``lotion_reg`` per eligible leaf; then SPLIT_LEAF's compression on
    each mesh through the gathered path."""
    rows = []
    for name in ("2x1", "1x2"):
        (m, before, after, ref_after, secs, counts, gathered, diffs,
         n_leaves, n_eligible) = ef_step(dev, meshes[name])
        split = ef_split_leaf(dev, meshes[name])
        if rank != 0:
            continue
        perr, pleaf = _param_err(after, ref_after, before)
        want = dict.fromkeys(counts, 0)
        want.update(quant=n_leaves, lotion_reg=n_eligible)
        checks = {
            "codes_err_vs_one_device_bitwise": all(d[0] == 0.0
                                                   for d in diffs),
            "codes_vs_plain_bitwise": all(d[1] == 0.0 for d in diffs),
            "not_skipped": m["skipped"] == 0.0,
            "params": perr <= PARAM_RTOL,
            "launches": counts == want,
            "split_leaf_gathered": split["gathered"] == ["split"],
            "split_leaf_bitwise": all(d == [0.0, 0.0] or d == (0.0, 0.0)
                                      for d in split["diffs"]),
            "split_leaf_launches": split["quant_launches"] == 1}
        row = dict(mesh=name, chain="clip -> ef -> lotion_decoupled -> "
                   "adamw", ef_fmt=EF_FMT, ef_block=EF_BLOCK,
                   loss=m["loss"], grad_norm=m["grad_norm"],
                   penalty=m.get("penalty"), param_err=perr,
                   param_err_leaf=pleaf, step_s=secs,
                   gathered_leaves=gathered, diffs_per_rank=diffs,
                   launches=counts, expected_launches=want,
                   split_leaf=split, checks=checks)
        rows.append(row)
        if not all(checks.values()):
            failed.append((name, "ef", [k for k, v in checks.items()
                                        if not v]))
    return rows


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
    ef = ef_rows(dev, rank, meshes, failed)
    if rank == 0:
        gate_ok = gate == [[1, 1]] * 2
        if not gate_ok:
            failed.append(("2x1", "nan_gate", gate))
        return dict(n_layers=N_LAYERS, batch=BATCH, seq=SEQ, dtype="float32",
                    loss_rtol=LOSS_RTOL, param_rtol=PARAM_RTOL, runs=rows,
                    nan_gate=gate, ef=ef, ok=not failed, failed=failed)
    return None


# the mesh chaos run: train_chaos's two-host configuration (chip_smoke.py)
CHAOS_LAYERS, CHAOS_STEPS = 1, 18


def chaos(dev, rank, ckpt_dir):
    """``chip_smoke.train_chaos``'s two-host run (Granite at full width,
    CHAOS_LAYERS layer, bf16, 4 x ``TRAIN_SEQ``, LOTION decoupled,
    ``CHAOS_LR``, ``chaos_plan(1, 18, 2)``, an audit every
    ``CHAOS_AUDIT_EVERY`` steps, checkpoints in ``ckpt_dir``, on
    ``/dev/shm``) through ``launch/train.py::mesh_chaos`` on mesh (2, 1),
    each rank one simulated host.  Every rank's counters, violations,
    ``chaos_ok``, final loss, train steps run, launches, the seconds by
    what took them, and the final state's fingerprint (of the blocks, and
    of the state gathered whole); rank 0 returns the list."""
    import chip_smoke as cs
    from repro_torch.data import lm_batch, permutation_table
    from repro_torch.distributed import collectives, tree_fingerprint
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import CHAOS_COUNTERS, chaos_ok, mesh_chaos
    cfg, _, tcfg, opt = cs.granite_setup(n_layers=CHAOS_LAYERS,
                                         lr=cs.CHAOS_LR)
    mesh = make_mesh((2, 1), ("data", "model"), dev.type)
    ssh = shd.state_shardings(mesh, specs.state_specs(cfg, tcfg))
    perm = permutation_table(0, cfg.vocab)
    counted = {}

    def batch_fn(st):
        return lm_batch(0, st, cs.TRAIN_BATCH, cs.TRAIN_SEQ, cfg.vocab, perm)

    torch.cuda.empty_cache()
    reset_launch_counts()
    t0 = time.perf_counter()
    with cs._timed_calls() as split:
        def wrap(name, fn):
            if name == "steps":
                fn = counted[name] = cs._counting(fn)
            return split.wrap(name, fn)
        s, n_hosts = mesh_chaos(
            cfg, tcfg, opt, mesh, batch_fn, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
            n_steps=CHAOS_STEPS, ckpt_dir=ckpt_dir,
            audit_every=cs.CHAOS_AUDIT_EVERY, wrap=wrap,
            log=lambda *a, **k: None)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    core = {"params": s["state"]["params"], "opt": s["state"]["opt"]}
    sh = {"params": ssh["params"], "opt": ssh["opt"]}
    t1 = time.perf_counter()
    fingerprint = tree_fingerprint(core, shardings=sh)
    fingerprint_s = time.perf_counter() - t1
    whole = shd.apply_tree(lambda x, s_: shd.gather(x, s_), core, sh)
    gathered_fingerprint = tree_fingerprint(whole)
    del whole, core
    mine = dict(counters={k: s[k] for k in CHAOS_COUNTERS},
                violations=s["violations"], ok=chaos_ok(s, n_hosts),
                n_hosts=n_hosts, final_loss=s["final_loss"],
                steps_seen=s["steps_seen"],
                train_steps_run=counted["steps"].calls,
                n_leaves=len(_leaves(s["state"]["params"])),
                launches=counts, seconds=seconds,
                split_s=split.split(seconds), fingerprint=fingerprint,
                fingerprint_s=fingerprint_s,
                gathered_fingerprint=gathered_fingerprint)
    every = collectives.gather_objects(mine)
    del s
    torch.cuda.empty_cache()
    return dict(mesh="(2, 1)", n_layers=CHAOS_LAYERS, n_steps=CHAOS_STEPS,
                dtype="bfloat16", batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ,
                ranks=every) if rank == 0 else None


def main(argv):
    import torch.distributed as dist
    store_path, rank, world = argv[:3]
    outs = dict(a.split("=", 1) for a in argv[3:])
    rank, world = int(rank), int(world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    fault = os.environ.get("MESH_RANKS_FAULT")
    ctx = contextlib.nullcontext
    if fault:
        from scripts.planted_faults_torch import MESH_FAULTS
        ctx = MESH_FAULTS[fault]
    parts = (("train", run),
             ("chaos", functools.partial(chaos, ckpt_dir=outs.get("ckpt"))))
    try:
        for part, fn in parts:
            if part not in outs:
                continue
            t0 = time.perf_counter()
            with ctx():
                res = fn(dev, rank)
            if rank == 0:
                res["seconds_in_process"] = time.perf_counter() - t0
                with open(outs[part], "w") as f:
                    json.dump(res, f)
            dist.barrier()
        if "serve" in outs:
            import scripts.serve_ranks_torch as serving
            t0 = time.perf_counter()
            with serving.fault_ctx():
                sres = serving.run(dev, rank)
            if rank == 0:
                sres["seconds_in_process"] = time.perf_counter() - t0
                with open(outs["serve"], "w") as f:
                    json.dump(sres, f)
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
