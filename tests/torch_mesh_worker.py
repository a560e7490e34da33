"""One rank of the port's CPU mesh tests (``tests/test_torch_mesh_train.py``).

    python tests/torch_mesh_worker.py STORE RANK WORLD DxM INPUTS OUT [CKPT]

Joins a gloo world of WORLD ranks through the FileStore STORE, builds the
mesh DxM on the CPU, and runs every case of ``CASES`` on it from the
inputs the test wrote (``INPUTS``: full parameters, seeded moments and
batches), then the skip gate, the sharded init, the kernels' plain
versions with a given absmax and the checkpoint round trip.  Rank 0
writes what it gathered to ``OUT`` (``torch.save``); every tensor there
is a full leaf, so the test holds it against the one-device run.  The
same module runs the one-device reference (``run_case`` with no mesh).
"""

from __future__ import annotations

import datetime
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.modes import QuantConfig  # noqa: E402
from repro_torch.core.policy import QuantPolicy, tree_map  # noqa: E402
from repro_torch.optim import adamw, cosine_with_warmup  # noqa: E402
from repro_torch.train import (TrainConfig, init_state,  # noqa: E402
                               make_optimizer, make_train_step)

# one LOTION / QAT run each on the meshes ``meshes`` names (all where
# absent); batches are (BATCH, SEQ) unless the case says otherwise: MoE's
# data ranks must see whole dispatch groups of 2048 tokens, so its case
# with a data split runs at 4 x 1024, the others at 4 x 32
CASES = {
    "granite_decoupled": dict(arch="granite-3-2b", method="lotion",
                              placement="decoupled"),
    "granite_loss": dict(arch="granite-3-2b", method="lotion",
                         placement="loss"),
    "granite_qat": dict(arch="granite-3-2b", method="qat",
                        placement="decoupled"),
    "moe_decoupled": dict(arch="moonshot-v1-16b-a3b", method="lotion",
                          placement="decoupled", meshes=("1x1", "1x2")),
    "moe_data_split": dict(arch="moonshot-v1-16b-a3b", method="lotion",
                           placement="decoupled", seq=1024,
                           meshes=("2x1",)),
}


def runs_on(case: str, mesh: str) -> bool:
    return mesh in CASES[case].get("meshes", (mesh,))


def moe_group_refusal(inputs: dict, mesh) -> str:
    """The MoE loss on a data split whose ranks hold less than a dispatch
    group: the refusal's message."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.train.loop import make_loss_fn
    cfg, tcfg, _ = configs("moe_decoupled")
    psh = shd.params_shardings(mesh, specs.params_specs(cfg))
    batch = shd.sharded_batch(inputs["batches"][0], shd.train_batch_shardings(
        mesh, inputs["batches"][0], BATCH))
    try:
        make_loss_fn(cfg, tcfg, psh)(None, batch, None)
    except ValueError as e:
        return str(e)
    return ""
BATCH, SEQ = 4, 32
JAX_STEPS = 3
NAN_ROWS = (2, 3)      # the rows of data rank 1 of 2


def configs(case: str):
    c = CASES[case]
    cfg = get_smoke_config(c["arch"])
    lotion = c["method"] == "lotion"
    qcfg = QuantConfig(method=c["method"], fmt_name="int4",
                       lam=1000.0 if lotion else 0.0,
                       penalty_placement=c["placement"],
                       policy=QuantPolicy(min_size=256))
    tcfg = TrainConfig(quant=qcfg, clip_norm=1.0)
    opt = make_optimizer(tcfg, adamw(cosine_with_warmup(3e-3, 2, 10)))
    return cfg, tcfg, opt


def run_case(case: str, inputs: dict, mesh=None) -> dict:
    """One step from the inputs' parameters and seeded moments: metrics,
    gradients, each eligible leaf's per-matrix absmax, and the state
    after the step, all as full leaves (gathered on a mesh); for
    ``granite_decoupled`` also JAX_STEPS steps from zero moments (the
    metrics, against JAX's)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    cfg, tcfg, opt = configs(case)
    psh = bsh = None
    if mesh is not None:
        psh = shd.params_shardings(mesh, specs.params_specs(cfg))
        bsh = shd.train_batch_shardings(
            mesh, {k: v for k, v in inputs["batches"][0].items()},
            inputs["batches"][0]["tokens"].shape[0])

    def leaves_to_full(tree, sh):
        if sh is None:
            return tree_map(lambda x: x.detach().clone(), tree)
        return shd.apply_tree(lambda x, s: shd.gather(x.detach(), s),
                              tree, sh)

    def blocks(full_tree):
        if psh is None:
            return tree_map(lambda x: x.clone(), full_tree)
        return shd.apply_tree(lambda x, s: shd.shard(x.clone(), s),
                              full_tree, psh)

    def rows(batch):
        return batch if bsh is None else shd.sharded_batch(batch, bsh)

    step = make_train_step(cfg, tcfg, opt, grad_shardings=psh)
    state = init_state(blocks(inputs["params"]), opt)
    state["opt"]["mu"] = blocks(inputs["mu"])
    state["opt"]["nu"] = blocks(inputs["nu"])
    batch = rows(inputs["batches"][0])

    out = {}
    loss, aux, grads = step.grads_of(state["params"], batch,
                                     state["opt"]["nu"], None)
    out["grads"] = leaves_to_full(grads, psh)
    absmax = {}

    def visit(path, x, s=None):
        from repro_torch.core.policy import path_str
        if tcfg.quant.policy.eligible(path, shd.full_view(x, s)):
            if s is None:
                dims = tuple(range(max(x.ndim - 2, 0), x.ndim))
                absmax[path_str(path)] = torch.linalg.vector_norm(
                    x, float("inf"), dim=dims).reshape(-1)
            else:
                a = shd.matrix_absmax(x, s)
                lead = x.shape[:-2]
                a = shd.gather(a.reshape(lead), shd.NamedSharding(
                    s.mesh, s.spec[:len(lead)]))
                absmax[path_str(path)] = a.reshape(-1)
    from repro_torch.core.policy import tree_map_multi
    tree_map_multi(visit, state["params"],
                   *(() if psh is None else (psh,)))
    out["absmax"] = absmax
    state, m = step(state, batch)
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["params"] = leaves_to_full(state["params"], psh)
    out["mu"] = leaves_to_full(state["opt"]["mu"], psh)
    out["nu"] = leaves_to_full(state["opt"]["nu"], psh)
    if case == "granite_decoupled":
        st = init_state(blocks(inputs["params"]), opt)
        steps = []
        for b in inputs["batches"][:JAX_STEPS]:
            st, m = step(st, rows(b))
            steps.append({k: float(v) for k, v in m.items()})
        out["jax_steps"] = steps
    return out


def nan_gate(inputs: dict, mesh) -> dict:
    """A step whose per-example CE is NaN on data rank 1's rows only (the
    loss itself finite): skipped on every rank, the state bitwise
    unchanged; then a clean step is taken."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.train.loop import make_loss_fn
    cfg, tcfg, opt = configs("granite_decoupled")
    psh = shd.params_shardings(mesh, specs.params_specs(cfg))
    base = make_loss_fn(cfg, tcfg, psh)

    def loss_fn(p, batch, fisher, **kw):
        loss, aux = base(p, batch, fisher, **kw)
        aux = dict(aux)
        aux["ce_ex"] = aux["ce_ex"] * batch["poison_ex"]
        return loss, aux

    step = make_train_step(cfg, tcfg, opt, loss_fn=loss_fn,
                           grad_shardings=psh)
    full = dict(inputs["batches"][0])
    poison = torch.ones(full["tokens"].shape[0])
    poison[list(NAN_ROWS)] = float("nan")
    bsh = shd.train_batch_shardings(mesh, dict(full, poison_ex=poison),
                                    full["tokens"].shape[0])
    state = init_state(shd.apply_tree(lambda x, s: shd.shard(x.clone(), s),
                                      inputs["params"], psh), opt)
    before = {k: [x.clone() for x in _leaves(state[k] if k == "params"
                                             else state["opt"][k])]
              for k in ("params", "mu", "nu")}
    state, m = step(state, shd.sharded_batch(dict(full, poison_ex=poison),
                                             bsh))
    after = {k: _leaves(state[k] if k == "params" else state["opt"][k])
             for k in ("params", "mu", "nu")}
    unchanged = all(torch.equal(a, b) for k in before
                    for a, b in zip(before[k], after[k]))
    skipped = bool(m["skipped"])
    state, m2 = step(state, shd.sharded_batch(
        dict(full, poison_ex=torch.ones_like(poison)), bsh))
    flags = torch.tensor([int(skipped), int(unchanged), int(bool(m2["skipped"]))])
    everyone = [torch.zeros_like(flags) for _ in range(mesh.size)]
    import torch.distributed as dist
    dist.all_gather(everyone, flags)
    return {"per_rank": [f.tolist() for f in everyone],
            "grad_norm": float(m["grad_norm"])}


def _leaves(tree):
    from repro_torch.core.policy import tree_leaves
    return tree_leaves(tree)


def sharded_init(mesh) -> dict:
    """``lm_init(shardings=)`` blocks against blocks of the one-device
    init, per config."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.models.lm import lm_init
    out = {}
    for case in ("granite_decoupled", "moe_decoupled"):
        cfg = configs(case)[0]
        psh = shd.params_shardings(mesh, specs.params_specs(cfg))
        got = lm_init(cfg, seed=0, device="cpu", shardings=psh)
        want = lm_init(cfg, seed=0, device="cpu")
        ok = []
        shd.tree_map_with_path(
            lambda p, g, w, s: ok.append(torch.equal(g, shd.shard(w, s))),
            got, want, psh)
        out[CASES[case]["arch"]] = all(ok)
    return out


def given_absmax(mesh) -> dict:
    """The kernels' plain versions on a block with the whole matrices'
    absmax against the block of the one-device call on the full leaf
    (matrix 0's largest |w| planted in the last block)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.lotion_reg import reg_ref
    from repro_torch.kernels.opt_step import opt_step_ref
    from repro_torch.kernels.quant.ref import rr_ref, rtn_ref
    g = torch.Generator().manual_seed(3)
    shape = (3, 64, 96)
    w = torch.randn(shape, generator=g) * 0.02
    w[0, -1, -1] = 0.5
    f = torch.rand(shape, generator=g) * 1e-6
    u = torch.rand(shape, generator=g)
    gr = torch.randn(shape, generator=g) * 1e-3
    mu = torch.randn(shape, generator=g) * 1e-4
    rows = {}
    for spec in ((None, "data", "model"), (None, "model", "data")):
        sh = shd.NamedSharding(mesh, shd.fix_divisibility(mesh, spec, shape))
        wb = shd.shard(w, sh)
        a = shd.matrix_absmax(wb, sh)
        own = torch.linalg.vector_norm(wb, float("inf"), dim=(1, 2))
        cut = {}
        cut["rtn"] = torch.equal(rtn_ref(wb, "int4", -1, a),
                                 shd.shard(rtn_ref(w, "int4", -1), sh))
        cut["rr"] = torch.equal(
            rr_ref(wb, shd.shard(u, sh), "int4", -1, a),
            shd.shard(rr_ref(w, u, "int4", -1), sh))
        pen_b, grad_b = reg_ref(wb, shd.shard(f, sh), "int4", -1, 1e3, a)
        pen, grad = reg_ref(w, f, "int4", -1, 1e3)
        cut["reg_grad"] = torch.equal(grad_b, shd.shard(grad, sh))
        total = shd.sum_all(pen_b if shd.owns(sh) else torch.zeros_like(pen_b),
                            mesh)
        cut["reg_pen_rel"] = abs(float(total) - float(pen)) / float(pen)
        kw = dict(lr=3e-4, bc1=0.271, bc2=0.1426, clip_scale=0.5, lam=1e3,
                  fmt_name="int4", block_size=-1, b1=0.9, b2=0.95, eps=1e-8,
                  weight_decay=0.01)
        got = opt_step_ref(wb, shd.shard(gr, sh), shd.shard(mu, sh),
                           shd.shard(f, sh), absmax=a, **kw)
        want = opt_step_ref(w, gr, mu, f, **kw)
        cut["opt"] = all(torch.equal(x, shd.shard(y, sh))
                         for x, y in zip(got[:3], want[:3]))
        cut["given_above_own"] = bool((a > own).any())
        rows[str(sh.spec)] = cut
    return rows


def checkpoint_save(inputs: dict, mesh, ckpt_dir: str) -> dict:
    """The state after one step saved at steps 7 and 9 (n_shards = the
    mesh's hosts); returns step 7's full leaves."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    cfg, tcfg, opt = configs("granite_decoupled")
    ssh = shd.state_shardings(mesh, specs.state_specs(cfg, tcfg))
    state = init_state(shd.apply_tree(lambda x, s: shd.shard(x.clone(), s),
                                      inputs["params"], ssh["params"]), opt)
    step = make_train_step(cfg, tcfg, opt, grad_shardings=ssh["params"])
    bsh = shd.train_batch_shardings(mesh, inputs["batches"][0], BATCH)
    state, _ = step(state, shd.sharded_batch(inputs["batches"][0], bsh))
    n_hosts = mesh.shape["data"]
    ckpt_io.save(ckpt_dir, 7, state, n_shards=n_hosts, shardings=ssh)
    want = shd.apply_tree(lambda x, s: shd.gather(x, s), state, ssh)
    state, _ = step(state, shd.sharded_batch(inputs["batches"][1], bsh))
    ckpt_io.save(ckpt_dir, 9, state, n_shards=n_hosts, shardings=ssh)
    return want


def checkpoint_load(inputs: dict, mesh, ckpt_dir: str) -> dict:
    """The newest valid step (decided on rank 0, quarantining) loaded into
    this mesh's blocks; returns its step and full leaves."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.train.loop import newest_valid_step
    cfg, tcfg, opt = configs("granite_decoupled")
    ssh = shd.state_shardings(mesh, specs.state_specs(cfg, tcfg))
    state = init_state(shd.apply_tree(
        lambda x, s: torch.zeros_like(shd.shard(x, s)), inputs["params"],
        ssh["params"]), opt)
    best = newest_valid_step(ckpt_dir, mesh, quarantine_corrupt=True)
    state, s = ckpt_io.load(ckpt_dir, into=state, step=best, shardings=ssh)
    return {"step": s, "state": shd.apply_tree(lambda x, sh: shd.gather(x, sh),
                                               state, ssh)}


def main(argv):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, parse_mesh
    store_path, rank, world, mesh_arg, inputs_path, out_path = argv[:6]
    ckpt = argv[6] if len(argv) > 6 else None
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    shape, axes = parse_mesh(mesh_arg)
    mesh = make_mesh(shape, axes, "cpu")
    inputs = torch.load(inputs_path)
    res = {"cases": {}}
    for case in CASES:
        if runs_on(case, mesh_arg):
            res["cases"][case] = run_case(case, inputs[case], mesh)
    if mesh.shape["data"] > 1:
        res["nan_gate"] = nan_gate(inputs["granite_decoupled"], mesh)
        res["moe_group_refusal"] = moe_group_refusal(inputs["moe_decoupled"],
                                                     mesh)
    res["sharded_init"] = sharded_init(mesh)
    res["given_absmax"] = given_absmax(mesh)
    if ckpt is not None:
        if mesh_arg == "2x1":
            res["ckpt_saved"] = checkpoint_save(inputs["granite_decoupled"],
                                                mesh, ckpt)
        else:
            res["ckpt_loaded"] = checkpoint_load(inputs["granite_decoupled"],
                                                 mesh, ckpt)
    if rank == 0:
        torch.save(res, out_path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
