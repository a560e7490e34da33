"""The port's sharded training step on CPU meshes (gloo), against the
port's one-device step and the JAX package's.

Worlds of 1, 2 and 4 processes (``tests/torch_mesh_worker.py``, one per
rank, rendezvous through a FileStore in the test's directory, every
process group with a timeout, every process joined with a timeout and
then killed) run meshes (1, 1), (2, 1), (1, 2) and (2, 2) from the same
full parameters, seeded moments and batches as the one-device run:
Granite smoke with the decoupled and the loss-side penalty and QAT, and
Moonlight smoke (MoE: the expert rules) on (1, 1) and (1, 2) at 4 x 32
and on (2, 1) at 4 x 1024, so that each data rank holds whole dispatch
groups (a split of partial groups is refused).

Tolerances, against the one-device step: every per-matrix absmax (the
scales) and the skip flag bitwise; the loss within 1e-6 relative; each
gradient within 1e-5 of its leaf's largest; parameters and moments after
one step (from seeded second moments: from zero moments Adam's first
update is lr * sign(g), which flips where g is within rounding of zero)
within 1e-6.  A sum over ranks adds in another order than one device, by
the rounding of fp32 only.  A mesh of one rank is bitwise the one-device
step.  Granite decoupled on each mesh is also held, over 3 steps from
zero moments, to JAX's one-device step at ``test_torch_train.py``'s
tolerances (loss and gradient norm 1e-5 relative, penalty 1e-4).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantPolicy as JPolicy
from repro.data import lm_batch as j_lm_batch
from repro.data import permutation_table as j_perm
from repro.models import lm as jlm
from repro.optim import adamw as j_adamw
from repro.optim import cosine_with_warmup as j_cosine
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_state as j_init_state
from repro.train import make_optimizer as j_make_optimizer
from repro.train import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.data import lm_batch, permutation_table
from repro_torch.models.lm import lm_init
from repro_torch.train import faults as tfaults

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_mesh_worker.py"
MESHES = ["1x1", "2x1", "1x2", "2x2"]
RTOL, PENALTY_RTOL = 1e-5, 1e-4
JOIN_S = 240


def _seeded(tree, seed, scale, positive):
    rng = np.random.default_rng(seed)

    def one(x):
        a = rng.random(x.shape) if positive else rng.standard_normal(x.shape)
        return torch.from_numpy((a * scale).astype(np.float32))
    from repro_torch.core.policy import tree_map
    return tree_map(one, tree)


def _jax_params():
    return jlm.lm_init(jax.random.PRNGKey(0), j_smoke("granite-3-2b"))


def _inputs():
    out = {}
    jcfg = j_smoke("granite-3-2b")
    perm = j_perm(0, jcfg.vocab)
    granite = bridge.to_torch(jax.tree.map(np.asarray, _jax_params()))
    batches = [{k: torch.from_numpy(np.array(v)).long() for k, v in
                j_lm_batch(0, s, W.BATCH, W.SEQ, jcfg.vocab, perm).items()}
               for s in range(W.JAX_STEPS)]
    for case, c in W.CASES.items():
        if c["arch"] == "granite-3-2b":
            params, bs = granite, batches
        else:
            cfg = get_smoke_config(c["arch"])
            params = lm_init(cfg, seed=0, device="cpu")
            tperm = permutation_table(0, cfg.vocab)
            bs = [lm_batch(0, s, W.BATCH, c.get("seq", W.SEQ), cfg.vocab,
                           tperm) for s in range(2)]
        out[case] = {"params": params, "batches": bs,
                     "mu": _seeded(params, 1, 1e-4, False),
                     "nu": _seeded(params, 2, 1e-6, True)}
    return out


def _world(tmp, mesh, inputs_path, ckpt=None):
    """Run one world to its end; returns rank 0's results."""
    world = int(np.prod([int(x) for x in mesh.split("x")]))
    store = tmp / f"store_{mesh}"
    out = tmp / f"out_{mesh}.pt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(store), str(r), str(world), mesh,
         str(inputs_path), str(out)] + ([str(ckpt)] if ckpt else []),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return procs, out


def _join(procs, out):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=JOIN_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"a rank did not finish in {JOIN_S} s")
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs)[-6000:]
    return torch.load(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = _inputs()
    path = tmp / "inputs.pt"
    torch.save(inputs, path)
    ckpt = tmp / "ckpt"
    res = {"2x1": _join(*_world(tmp, "2x1", path, ckpt))}
    # the newest step loses a payload shard: the whole step is untrusted
    tfaults.corrupt_checkpoint(str(ckpt / "step_0000000009"), "delete",
                               shard=0)
    started = {}
    for mesh in ("1x1", "1x2", "2x2"):
        copy = None
        if mesh != "2x2":
            copy = tmp / f"ckpt_{mesh}"
            shutil.copytree(ckpt, copy)
        started[mesh] = (_world(tmp, mesh, path, copy), copy)
    for mesh, ((procs, out), copy) in started.items():
        res[mesh] = _join(procs, out)
        res[mesh]["ckpt_dir"] = copy
    # the ranks run one thread each; so does the reference (the CPU's
    # embedding backward adds repeated tokens in a thread-dependent order)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {case: W.run_case(case, inputs[case]) for case in W.CASES}
    finally:
        torch.set_num_threads(threads)
    return {"mesh": res, "ref": ref}


PAIRS = [(m, c) for m in MESHES for c in W.CASES if W.runs_on(c, m)]


def _max_abs(a, b):
    return float(torch.max(torch.abs(a - b))) if a.numel() else 0.0


def _leaves(tree):
    from repro_torch.core.policy import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("mesh,case", PAIRS)
def test_sharded_step_matches_one_device(runs, mesh, case):
    got, want = runs["mesh"][mesh]["cases"][case], runs["ref"][case]
    # the per-matrix absmax (the scales) and the skip flag: exact
    assert got["absmax"].keys() == want["absmax"].keys()
    for k in want["absmax"]:
        assert torch.equal(got["absmax"][k], want["absmax"][k]), k
    assert got["metrics"]["skipped"] == want["metrics"]["skipped"] == 0.0
    gl, wl = got["metrics"]["loss"], want["metrics"]["loss"]
    assert abs(gl - wl) <= 1e-6 * abs(wl), (gl, wl)
    for g, w in zip(_leaves(got["grads"]), _leaves(want["grads"])):
        assert _max_abs(g, w) <= 1e-5 * float(torch.max(torch.abs(w))), \
            (g.shape, _max_abs(g, w))
    for key in ("params", "mu", "nu"):
        for g, w in zip(_leaves(got[key]), _leaves(want[key])):
            assert g.shape == w.shape
            assert _max_abs(g, w) <= 1e-6, (key, g.shape, _max_abs(g, w))


@pytest.mark.parametrize("case", [c for c in W.CASES if W.runs_on(c, "1x1")])
def test_one_rank_mesh_is_bitwise(runs, case):
    got, want = runs["mesh"]["1x1"]["cases"][case], runs["ref"][case]
    assert got["metrics"] == want["metrics"]
    for key in ("grads", "params", "mu", "nu"):
        for g, w in zip(_leaves(got[key]), _leaves(want[key])):
            assert torch.equal(g, w), key


@pytest.fixture(scope="module")
def jax_steps():
    jcfg = j_smoke("granite-3-2b")
    kw = dict(method="lotion", fmt_name="int4", lam=1000.0,
              penalty_placement="decoupled")
    jt = JTrainConfig(quant=JQuantConfig(policy=JPolicy(min_size=256), **kw),
                      clip_norm=1.0)
    tx = j_make_optimizer(jt, j_adamw(j_cosine(3e-3, 2, 10)))
    step = jax.jit(j_make_train_step(jcfg, jt, tx))
    st = j_init_state(_jax_params(), tx)
    perm = j_perm(0, jcfg.vocab)
    out = []
    for s in range(W.JAX_STEPS):
        st, m = step(st, j_lm_batch(0, s, W.BATCH, W.SEQ, jcfg.vocab, perm))
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_step_matches_jax(runs, jax_steps, mesh):
    got = runs["mesh"][mesh]["cases"]["granite_decoupled"]["jax_steps"]
    for g, j in zip(got, jax_steps):
        for k, tol in (("loss", RTOL), ("grad_norm", RTOL),
                       ("penalty", PENALTY_RTOL)):
            assert abs(g[k] - j[k]) <= tol * abs(j[k]), (k, g[k], j[k])
        assert g["skipped"] == float(j["skipped"]) == 0.0


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_nan_on_one_data_rank_skips_every_rank(runs, mesh):
    gate = runs["mesh"][mesh]["nan_gate"]
    # per rank: [skipped, state bitwise unchanged, next clean step skipped]
    assert gate["per_rank"] == [[1, 1, 0]] * len(gate["per_rank"])


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_moe_refuses_a_data_split_of_partial_groups(runs, mesh):
    # 4 x 32 tokens cut over two data ranks: 64 a rank, not whole groups
    # of the global batch's 128
    msg = runs["mesh"][mesh]["moe_group_refusal"]
    assert "not whole MoE dispatch groups" in msg, msg


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_init_is_the_one_device_init(runs, mesh):
    got = runs["mesh"][mesh]["sharded_init"]
    assert got == {"granite-3-2b": True, "moonshot-v1-16b-a3b": True}


@pytest.mark.parametrize("mesh", MESHES)
def test_plain_versions_take_the_given_absmax(runs, mesh):
    for spec, row in runs["mesh"][mesh]["given_absmax"].items():
        assert row["rtn"] and row["rr"] and row["reg_grad"] and row["opt"], \
            (spec, row)
        assert row["reg_pen_rel"] <= 1e-6, (spec, row)
        # where the matrix is cut, rank 0's block lacks matrix 0's max
        cut = mesh != "1x1"
        assert row["given_above_own"] == cut, (spec, row)


@pytest.mark.parametrize("mesh", ["1x2", "1x1"])
def test_checkpoint_restores_across_mesh_shapes(runs, mesh):
    saved = runs["mesh"]["2x1"]["ckpt_saved"]
    loaded = runs["mesh"][mesh]["ckpt_loaded"]
    assert loaded["step"] == 7
    for a, b in zip(_leaves(saved), _leaves(loaded["state"])):
        assert torch.equal(a, b)
    names = os.listdir(runs["mesh"][mesh]["ckpt_dir"])
    assert "step_0000000009.corrupt" in names and "step_0000000009" \
        not in names


def test_launcher_one_rank_mesh_needs_no_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-3-2b", "--smoke", "--device", "cpu", "--mesh", "1x1",
         "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
         str(tmp_path / "c")], env=env, capture_output=True, text=True,
        timeout=JOIN_S)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done: 2 steps on mesh {'data': 1, 'model': 1}" in r.stdout
    assert sorted(os.listdir(tmp_path / "c")) == ["step_0000000000",
                                                  "step_0000000001",
                                                  "step_0000000002"]
