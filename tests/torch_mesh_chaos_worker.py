"""One rank of the port's CPU tests of the mesh chaos tier and of EF
compression on a mesh (``tests/test_torch_mesh_chaos.py``).

    python tests/torch_mesh_chaos_worker.py STORE RANK WORLD DxM INPUTS \
        OUT SCRATCH

Joins a gloo world of WORLD ranks through the FileStore STORE, builds the
mesh DxM on the CPU and runs the parts ``PARTS`` names for it: three EF
steps from the inputs the test wrote (``INPUTS``: JAX's initial Granite
smoke parameters and batches), each compression held bitwise against the
one-device compression of the gathered gradients and error; a NaN step
on data rank 1's rows; the fingerprint and the replica audit; a mid-write
kill and a corrupted save; the EF checkpoint saved on (2, 1) and loaded on
(1, 2); and the launcher's chaos run (``launch/train.py``: ``main`` on
(2, 1), ``mesh_chaos`` on (2, 2)); on (2, 2) and (4, 1) the gloo
all-gather and SUM all-reduce against every rank's tensor, made here
from its seed.  Each rank writes
what it found to ``OUT.<rank>`` (``torch.save``), every tensor a full
leaf.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.modes import QuantConfig  # noqa: E402
from repro_torch.core.policy import QuantPolicy, tree_leaves  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.optim import adamw, cosine_with_warmup  # noqa: E402
from repro_torch.train import (TrainConfig, init_state,  # noqa: E402
                               make_optimizer, make_train_step)

BATCH, SEQ, EF_STEPS = 4, 32, 3
NAN_ROWS = (2, 3)      # the rows of data rank 1 of 2
# the launcher's chaos flags (its two-host plan on the smoke config)
CHAOS_ARGV = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
              "--steps", "18", "--batch", "4", "--seq", "32", "--chaos"]
PARTS = {"2x1": ("ef", "nan", "audit", "write_kill", "ef_save", "main"),
         "1x2": ("ef", "ef_load"),
         "2x2": ("ef", "nan", "write_kill", "mesh_chaos", "collectives"),
         "4x1": ("collectives",)}
# the one leaf every mesh holds whole on every rank (the replica audit's
# target)
REPLICATED = "final_norm_scale"
EF_SAVED = "ef_saved"          # marker file of the (2, 1) EF save
WAIT_S = 180


def ef_setup():
    """The EF configuration: Granite smoke, LOTION decoupled at lam 1e3,
    the unfused chain clip -> ef -> lotion -> AdamW; the hyperparameters
    of ``test_torch_mesh_train.py``'s JAX comparison."""
    cfg = get_smoke_config("granite-3-2b")
    qcfg = QuantConfig(method="lotion", fmt_name="int4", lam=1000.0,
                       penalty_placement="decoupled",
                       policy=QuantPolicy(min_size=256))
    tcfg = TrainConfig(quant=qcfg, clip_norm=1.0, ef_compress=True)
    opt = make_optimizer(tcfg, adamw(cosine_with_warmup(3e-3, 2, 10)))
    return cfg, tcfg, opt


def _full(tree, shardings):
    return shd.apply_tree(lambda x, s: shd.gather(x.detach(), s).clone(),
                          tree, shardings)


def _blocks(full_tree, shardings):
    return shd.apply_tree(lambda x, s: shd.shard(x.clone(), s), full_tree,
                          shardings)


def _rows(batch, mesh):
    return shd.sharded_batch(batch, shd.train_batch_shardings(
        mesh, batch, batch["tokens"].shape[0]))


def _every_rank(value) -> list:
    from repro_torch.distributed import collectives
    return collectives.gather_objects(value)


@contextlib.contextmanager
def _recorded_compressions(calls):
    """``train.compress.ef_compress`` recording each call's inputs and
    outputs (the chain's link looks it up at call time)."""
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


def _same_bits(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


def ef_steps(inputs, mesh):
    """EF_STEPS steps from the inputs' parameters (zero moments and
    error): each step's metrics, whether every compression's blocks and
    new error are bitwise the one-device compression of the gathered
    gradients and error, the leaves that took the gathered path, and the
    state after the steps (blocks) with its shardings."""
    from repro_torch.train import compress
    cfg, tcfg, opt = ef_setup()
    ssh = shd.state_shardings(mesh, specs.state_specs(cfg, tcfg))
    psh = ssh["params"]
    step = make_train_step(cfg, tcfg, opt, grad_shardings=psh)
    state = init_state(_blocks(inputs["params"], psh), opt)
    calls, metrics = [], []
    compress.reset_gathered()
    with _recorded_compressions(calls) as one_device:
        for b in inputs["batches"][:EF_STEPS]:
            state, m = step(state, _rows(b, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
    gathered = dict(compress.GATHERED)
    bad = []
    for i, (g, e, bs, sh, (q, ne)) in enumerate(calls):
        want_q, want_e = one_device(_full(g, sh), _full(e, sh), bs)
        for (path, got), want in zip(
                shd.tree_leaves_with_path(q),
                tree_leaves(_blocks(want_q, sh))):
            if not _same_bits(got, want):
                bad.append((i, "q", path))
        for (path, got), want in zip(
                shd.tree_leaves_with_path(ne),
                tree_leaves(_blocks(want_e, sh))):
            if not _same_bits(got, want):
                bad.append((i, "err", path))
    return {"metrics": metrics, "calls": len(calls),
            "bitwise": _every_rank(not bad), "disagreeing": bad,
            "gathered": gathered}, state, ssh


def nan_step(inputs, mesh) -> list:
    """Per rank: [skipped, err bitwise unchanged, params bitwise
    unchanged] of an EF step whose per-example CE is NaN on data rank 1's
    rows only (the loss finite)."""
    from repro_torch.train.loop import make_loss_fn
    cfg, tcfg, opt = ef_setup()
    psh = shd.params_shardings(mesh, specs.params_specs(cfg))
    base = make_loss_fn(cfg, tcfg, psh)

    def loss_fn(p, batch, fisher, **kw):
        loss, aux = base(p, batch, fisher, **kw)
        return loss, dict(aux, ce_ex=aux["ce_ex"] * batch["poison_ex"])

    step = make_train_step(cfg, tcfg, opt, loss_fn=loss_fn,
                           grad_shardings=psh)
    state = init_state(_blocks(inputs["params"], psh), opt)
    # a carried error that is not zero: one clean step first
    b0 = dict(inputs["batches"][0], poison_ex=torch.ones(BATCH))
    state, _ = step(state, _rows(b0, mesh))
    poison = torch.ones(BATCH)
    poison[list(NAN_ROWS)] = float("nan")
    err = state["opt"][1]["err"]
    before = ([x.clone() for x in tree_leaves(err)],
              [x.clone() for x in tree_leaves(state["params"])])
    state, m = step(state, _rows(dict(inputs["batches"][1],
                                      poison_ex=poison), mesh))
    after = (tree_leaves(state["opt"][1]["err"]),
             tree_leaves(state["params"]))
    return _every_rank([
        int(bool(m["skipped"])),
        int(all(_same_bits(a, b) for a, b in zip(before[0], after[0]))),
        int(all(_same_bits(a, b) for a, b in zip(before[1], after[1])))])


def audit(state, ssh, mesh) -> dict:
    """The fingerprint of the (blocks of the) EF state against the
    one-device digest of the gathered state; the replica audit before
    and after one bit of rank 1's copy of ``REPLICATED`` is flipped."""
    from repro_torch.distributed import replica_divergence, tree_fingerprint
    core = {"params": state["params"], "opt": state["opt"]}
    sh = {"params": ssh["params"], "opt": ssh["opt"]}
    out = {"fingerprint": _every_rank(tree_fingerprint(core, shardings=sh)),
           "one_device": tree_fingerprint(_full(core, sh)),
           "sound": replica_divergence(state["params"],
                                       shardings=ssh["params"])}
    leaf = state["params"][REPLICATED]
    if mesh.rank == 1:
        leaf.view(torch.int32).view(-1)[0] ^= 1
    out["flipped"] = replica_divergence(state["params"],
                                        shardings=ssh["params"])
    out["flipped_fingerprints"] = _every_rank(
        tree_fingerprint(core, shardings=sh))
    return out


def write_kill(inputs, mesh, scratch) -> dict:
    """A save killed mid-write at its manifest, then a save whose payload
    shard 1 is bit-flipped after publishing, each through every rank's
    injector on one plan: the exception each rank ended with, and the
    injector's counters."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.train import faults as tfaults
    from repro_torch.train.guard import InjectedCrash
    cfg, tcfg, opt = ef_setup()
    ssh = shd.state_shardings(mesh, specs.state_specs(cfg, tcfg))
    state = init_state(_blocks(inputs["params"], ssh["params"]), opt)
    plan = tfaults.TrainFaultPlan(seed=0, ckpt_crashes={0: "manifest"},
                                  corrupt_saves={1: ("bitflip", 1)})
    inj = tfaults.ChaosInjector(plan, writes=mesh.rank == 0)
    d = os.path.join(scratch, f"write_kill_{'x'.join(map(str, mesh.shape.values()))}")
    ended = []
    with ckpt_io.write_fault_hook(inj.write_hook()):
        for step in (1, 2):
            try:
                ckpt_io.save(d, step, state, n_shards=2, shardings=ssh)
                ended.append(None)
            except InjectedCrash:
                ended.append("InjectedCrash")
            except BaseException as e:   # noqa: BLE001 - recorded
                ended.append(type(e).__name__)
    _every_rank(None)       # rank 0 has published and damaged step 2
    return {"ended": _every_rank(ended),
            "counters": _every_rank((inj.saves, inj.crashes,
                                     len(inj.corrupted))),
            "step2_valid": ckpt_io.verify_dir(
                os.path.join(d, "step_0000000002")),
            "tmp_left": sorted(os.listdir(d))}


def ef_save(state, ssh, ckpt) -> dict:
    from repro_torch.checkpoint import io as ckpt_io
    ckpt_io.save(ckpt, EF_STEPS, state, n_shards=2, shardings=ssh)
    full = _full(state, ssh)
    if shd.mesh_of(ssh).rank == 0:
        open(os.path.join(ckpt, EF_SAVED), "w").close()
    return full


def ef_load(inputs, mesh, ckpt) -> dict:
    from repro_torch.checkpoint import io as ckpt_io
    cfg, tcfg, opt = ef_setup()
    ssh = shd.state_shardings(mesh, specs.state_specs(cfg, tcfg))
    state = init_state(shd.apply_tree(
        lambda x, s: torch.zeros_like(shd.shard(x, s)), inputs["params"],
        ssh["params"]), opt)
    t0 = time.time()
    while not os.path.exists(os.path.join(ckpt, EF_SAVED)):
        if time.time() - t0 > WAIT_S:
            raise TimeoutError("the (2, 1) EF checkpoint never appeared")
        time.sleep(0.2)
    state, step = ckpt_io.load(ckpt, into=state, step=EF_STEPS,
                               shardings=ssh)
    return {"step": step, "state": _full(state, ssh)}


def chaos_main(mesh_arg, scratch) -> dict:
    """The launcher's ``main`` with ``--mesh --chaos``: its exit code and
    rank 0's printed report (``main`` closes the process group)."""
    from repro_torch.launch import train as launch
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            launch.main(CHAOS_ARGV + ["--mesh", mesh_arg, "--ckpt-dir",
                                      os.path.join(scratch, "chaos_main")])
            code = None
        except SystemExit as e:
            code = e.code
    return {"code": code, "stdout": out.getvalue()}


def chaos_mesh(mesh, scratch) -> dict:
    """``launch/train.py::mesh_chaos`` on the mesh: the summary's counters
    on every rank, ``chaos_ok``, and the final state's fingerprint on
    every rank against the one-device digest of the gathered state."""
    from repro_torch.distributed import tree_fingerprint
    from repro_torch.launch import train as launch
    args = launch.parser().parse_args(CHAOS_ARGV)
    cfg, tcfg, opt, batch_fn = launch.configure(args)
    s, n_hosts = launch.mesh_chaos(
        cfg, tcfg, opt, mesh, batch_fn, args.batch, args.seq,
        n_steps=args.steps, ckpt_dir=os.path.join(scratch, "chaos_mesh"),
        chaos_seed=args.chaos_seed, log=lambda *a, **k: None)
    ssh = shd.state_shardings(mesh, specs.state_specs(cfg, tcfg))
    sh = {"params": ssh["params"], "opt": ssh["opt"]}
    core = {"params": s["state"]["params"], "opt": s["state"]["opt"]}
    return {"summary": _every_rank(
                {k: s[k] for k in launch.CHAOS_COUNTERS + (
                    "violations", "final_loss")}),
            "ok": _every_rank(launch.chaos_ok(s, n_hosts)),
            "n_hosts": n_hosts,
            "fingerprint": _every_rank(tree_fingerprint(core,
                                                        shardings=sh)),
            "one_device": tree_fingerprint(_full(core, sh))}


def _ints(rank: int) -> torch.Tensor:
    """Rank ``rank``'s operand: small integers in fp32, so that a sum in
    any order is exact."""
    g = torch.Generator().manual_seed(rank)
    return torch.randint(-1000, 1000, (3, 5), generator=g).float()


def gloo_collectives(mesh) -> dict:
    """``collectives.all_gather`` and SUM ``all_reduce`` on each axis of
    more than one rank against the plain concatenation and sum of the
    axis's ranks' operands, each made here from that rank's seed:
    bitwise, on every rank."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    out = {}
    for axis, n in mesh.shape.items():
        if n == 1:
            continue
        peers = [_ints(r) for r in
                 dist.get_process_group_ranks(mesh.group(axis))]
        x = _ints(mesh.rank)
        got = collectives.all_gather(x, mesh, axis, 1)
        summed = collectives.all_reduce(x.clone(), "sum", mesh, (axis,))
        out[axis] = {"gather": _same_bits(got, torch.cat(peers, dim=1)),
                     "sum": _same_bits(summed, sum(peers[1:], peers[0]))}
    return out


def main(argv):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, parse_mesh
    store, rank, world, mesh_arg, inputs_path, out, scratch = argv[:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh(*parse_mesh(mesh_arg), "cpu")
    parts = PARTS[mesh_arg]
    inputs = torch.load(inputs_path)
    ckpt = os.path.join(scratch, "ef_ckpt")
    res = {}
    try:
        if "ef" in parts:
            res["ef"], state, ssh = ef_steps(inputs, mesh)
        if "nan" in parts:
            res["nan"] = nan_step(inputs, mesh)
        if "ef_save" in parts:
            res["ef_saved"] = ef_save(state, ssh, ckpt)
        if "audit" in parts:
            res["audit"] = audit(state, ssh, mesh)
        if "write_kill" in parts:
            res["write_kill"] = write_kill(inputs, mesh, scratch)
        if "ef_load" in parts:
            res["ef_loaded"] = ef_load(inputs, mesh, ckpt)
        if "mesh_chaos" in parts:
            res["chaos"] = chaos_mesh(mesh, scratch)
        if "collectives" in parts:
            res["collectives"] = gloo_collectives(mesh)
        if "main" in parts:
            # last: the launcher destroys the process group
            res["main"] = chaos_main(mesh_arg, scratch)
    finally:
        torch.save(res, f"{out}.{rank}")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
