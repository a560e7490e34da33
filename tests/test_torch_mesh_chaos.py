"""The mesh chaos tier and EF gradient compression on a mesh, on CPU
meshes (gloo), against the port's one-device runs and the JAX package's.

Worlds of 2, 2, 4 and 4 processes (``tests/torch_mesh_chaos_worker.py``,
one per rank, started together, rendezvous through a FileStore, every
process joined with a timeout and then killed) run meshes (2, 1), (1, 2),
(2, 2) and (4, 1) on Granite smoke:

* the launcher's chaos run with its two-host plan (18 steps, 4 x 32):
  ``main --mesh 2x1 --chaos`` exits 0 on both ranks, ``mesh_chaos`` on
  (2, 2) passes ``chaos_ok`` on every rank with every tier fired, and the
  counters equal the port's one-device ``run_chaos(n_hosts=2)`` and JAX's
  ``repro.train.faults.run_chaos`` on the same plan (JAX's own
  simulation on one CPU device; its launcher on a forced mesh fails under
  this jax, ROADMAP Queue 3);
* the fingerprint of a sharded state equals the one-device digest of the
  gathered state, on every rank; the replica audit is empty on a sound
  state and names the leaf and window of one flipped bit on rank 1;
* a save killed mid-write ends with ``InjectedCrash`` on every rank, a
  post-publish bitflip is written once (by rank 0), and the injector's
  counters are equal on every rank;
* three EF steps on each mesh: every compression's blocks and new error
  bitwise the one-device compression of the same gradients and error
  (the gathered path named), the metrics within ``RTOL`` of JAX's jitted
  one-device EF step (penalty ``PENALTY_RTOL``); the EF state saved on
  (2, 1) restores on (1, 2) and on one device bitwise; a NaN on data rank
  1's rows leaves the error unchanged on every rank;
* the gloo all-gather and SUM all-reduce on axes of 2 and 4 ranks
  bitwise the plain concatenation and sum of the ranks' operands.
"""

import ast
import os
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
from repro.train import faults as jfaults
from repro.train import init_state as j_init_state
from repro.train import make_optimizer as j_make_optimizer
from repro.train import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.launch import train as launch
from repro_torch.models.lm import lm_init
from repro_torch.train import init_state, make_train_step
from repro_torch.train import faults as tfaults

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_chaos_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_mesh_chaos_worker.py"
MESHES = ["2x1", "1x2", "2x2", "4x1"]
EF_MESHES = ["2x1", "1x2", "2x2"]
RTOL, PENALTY_RTOL = 1e-5, 1e-4
JOIN_S = 300
# the leaves whose cut splits int8 blocks of 256 at the smoke widths
# (the rest are cast on their blocks)
GATHERED = {
    "2x1": {"embed", "stage/b0_attn/attn/wo", "stage/b0_attn/mlp/w_down"},
    "1x2": {"stage/b0_attn/attn/wq", "stage/b0_attn/attn/wk",
            "stage/b0_attn/attn/wv", "stage/b0_attn/mlp/w_up",
            "stage/b0_attn/mlp/w_gate"},
    "2x2": {"embed", "stage/b0_attn/attn/wq", "stage/b0_attn/attn/wk",
            "stage/b0_attn/attn/wv", "stage/b0_attn/attn/wo",
            "stage/b0_attn/mlp/w_up", "stage/b0_attn/mlp/w_down",
            "stage/b0_attn/mlp/w_gate"},
}


def _jax_params():
    return jlm.lm_init(jax.random.PRNGKey(0), j_smoke("granite-3-2b"))


def _inputs():
    jcfg = j_smoke("granite-3-2b")
    perm = j_perm(0, jcfg.vocab)
    return {"params": bridge.to_torch(jax.tree.map(np.asarray,
                                                   _jax_params())),
            "batches": [{k: torch.from_numpy(np.array(v)).long() for k, v in
                         j_lm_batch(0, s, W.BATCH, W.SEQ, jcfg.vocab,
                                    perm).items()}
                        for s in range(W.EF_STEPS)]}


def _world(tmp, mesh, inputs_path, scratch):
    world = int(np.prod([int(x) for x in mesh.split("x")]))
    out = tmp / f"out_{mesh}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(tmp / f"store_{mesh}"), str(r),
         str(world), mesh, str(inputs_path), str(out), str(scratch)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return procs, out, world


def _join(procs, out, world):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a rank did not finish in {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs)[-6000:]
    return [torch.load(f"{out}.{r}") for r in range(world)]


def _chaos_setup():
    args = launch.parser().parse_args(W.CHAOS_ARGV)
    return args, launch.configure(args)


def _one_device_chaos(tmp):
    """The port's one-device run_chaos with the launcher's two-host plan
    on the launcher's smoke setup."""
    args, (cfg, tcfg, opt, batch_fn) = _chaos_setup()
    step = make_train_step(cfg, tcfg, opt,
                           loss_fn=tfaults.chaos_loss_fn(cfg, tcfg))
    return tfaults.run_chaos(
        step, lambda: init_state(lm_init(cfg, seed=0, device="cpu"), opt,
                                 lr_scale=True),
        batch_fn, launch.chaos_plan(args.chaos_seed, args.steps, 2),
        args.steps, str(tmp / "one_device_chaos"), n_hosts=2,
        ckpt_shards=2, device=torch.device("cpu"))


def _jax_chaos(tmp):
    """JAX's run_chaos with the same plan on the smoke config, one CPU
    device (the JAX launcher's chaos branch without its mesh)."""
    from repro.configs import get_smoke_config
    from repro.core import QuantConfig, QuantPolicy
    args, _ = _chaos_setup()
    cfg = get_smoke_config("granite-3-2b")
    tcfg = JTrainConfig(quant=QuantConfig(
        method="lotion", fmt_name="int4", lam=args.lam,
        policy=QuantPolicy(min_size=256)))
    opt = j_make_optimizer(tcfg, j_adamw(j_cosine(args.lr, 5, args.steps)))
    step = j_make_train_step(cfg, tcfg, opt,
                             loss_fn=jfaults.chaos_loss_fn(cfg, tcfg))
    perm = j_perm(0, cfg.vocab)

    def make_state():
        return jax.jit(lambda k: j_init_state(jlm.lm_init(k, cfg), opt,
                                              lr_scale=True))(
            jax.random.PRNGKey(0))

    return jfaults.run_chaos(
        step, make_state,
        lambda s: j_lm_batch(0, s, args.batch, args.seq, cfg.vocab, perm),
        launch.chaos_plan(args.chaos_seed, args.steps, 2), args.steps,
        str(tmp / "jax_chaos"), n_hosts=2, ckpt_shards=2)


def _counters(summary):
    return {k: summary[k] for k in launch.CHAOS_COUNTERS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_chaos")
    scratch = {m: tmp / f"scratch_{m}" for m in MESHES}
    for d in scratch.values():
        d.mkdir()
    # (1, 2) loads the EF checkpoint (2, 1) saves
    scratch["1x2"] = scratch["2x1"]
    path = tmp / "inputs.pt"
    inputs = _inputs()
    torch.save(inputs, path)
    started = {m: _world(tmp, m, path, scratch[m]) for m in MESHES}
    # the references run while the worlds do
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = _counters(_one_device_chaos(tmp))
    finally:
        torch.set_num_threads(threads)
    jax_counters = _counters(_jax_chaos(tmp))
    res = {m: _join(*started[m]) for m in MESHES}
    return {"mesh": res, "one_device": one, "jax": jax_counters,
            "inputs": inputs, "ckpt": scratch["2x1"] / "ef_ckpt"}


def _main_counters(runs):
    rank0 = runs["mesh"]["2x1"][0]["main"]["stdout"]
    line = next(x for x in rank0.splitlines()
                if x.startswith("chaos done:"))
    return ast.literal_eval(line[line.index("{"):line.rindex("}") + 1])


# ---------------------------------------------------------------- chaos

def test_launcher_mesh_chaos_exits_zero_on_every_rank(runs):
    """``main --mesh 2x1 --chaos`` (the torchrun command's code path)."""
    codes = [r["main"]["code"] for r in runs["mesh"]["2x1"]]
    assert codes == [0, 0], runs["mesh"]["2x1"][0]["main"]["stdout"]
    assert "violations=0" in runs["mesh"]["2x1"][0]["main"]["stdout"]


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_mesh_chaos_fires_every_tier(runs, mesh):
    if mesh == "2x1":
        summaries = [_main_counters(runs)]
    else:
        chaos = runs["mesh"]["2x2"][0]["chaos"]
        assert chaos["ok"] == [True] * 4 and chaos["n_hosts"] == 2
        assert all(s["violations"] == [] for s in chaos["summary"])
        summaries = chaos["summary"]
    for s in summaries:
        assert s["skipped"] >= 1 and s["rollbacks"] >= 1
        assert s["quarantined"] >= 1 and s["resumes"] >= 1
        assert s["host_kill_timeouts"] >= 1 and s["straggler_timeouts"] >= 1
        assert s["divergence_checks"] >= 1


@pytest.mark.parametrize("ref", ["one_device", "jax"])
@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_mesh_chaos_counters_match(runs, mesh, ref):
    if mesh == "2x1":
        got = [_main_counters(runs)]
    else:
        got = [_counters(s) for s in runs["mesh"]["2x2"][0]["chaos"][
            "summary"]]
    for g in got:
        assert g == runs[ref], (g, runs[ref])


def test_mesh_chaos_final_fingerprint_is_the_gathered_state(runs):
    chaos = runs["mesh"]["2x2"][0]["chaos"]
    assert chaos["fingerprint"] == [chaos["one_device"]] * 4


# ---------------------------------------------------------------- audits

def test_fingerprint_of_blocks_is_the_one_device_digest(runs):
    a = runs["mesh"]["2x1"][0]["audit"]
    assert a["fingerprint"] == [a["one_device"]] * 2


def test_replica_audit_names_a_flipped_window(runs):
    a = runs["mesh"]["2x1"][0]["audit"]
    assert a["sound"] == []
    assert a["flipped"] == [
        f"replica divergence in '{W.REPLICATED}' window ((0, 64),): rank 1 "
        f"disagrees with rank 0"]
    # each rank's view of the state: its own copy of the flipped window
    fp = a["flipped_fingerprints"]
    assert fp[0] == a["one_device"] != fp[1]


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_mid_write_kill_ends_every_rank_alike(runs, mesh):
    w = runs["mesh"][mesh][0]["write_kill"]
    n = len(runs["mesh"][mesh])
    assert w["ended"] == [["InjectedCrash", None]] * n
    assert w["counters"] == [(2, 1, 1)] * n     # saves, crashes, corrupted
    # the killed save published nothing (the next save swept its tmp);
    # the bitflip was written once: the step is untrusted
    assert w["tmp_left"] == ["step_0000000002"]
    assert w["step2_valid"] is False


# ---------------------------------------------------------------- EF

@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_gloo_collectives_match_plain(runs, mesh):
    for r in runs["mesh"][mesh]:
        assert r["collectives"], mesh
        for axis, got in r["collectives"].items():
            assert got == {"gather": True, "sum": True}, (mesh, axis)


@pytest.mark.parametrize("mesh", EF_MESHES)
def test_ef_compression_on_blocks_is_bitwise(runs, mesh):
    ef = [r["ef"] for r in runs["mesh"][mesh]]
    assert all(e["calls"] == W.EF_STEPS for e in ef)
    assert ef[0]["bitwise"] == [True] * len(ef), ef[0]["disagreeing"]
    for e in ef:
        assert e["gathered"] == dict.fromkeys(GATHERED[mesh], W.EF_STEPS)


@pytest.fixture(scope="module")
def jax_ef_steps():
    jcfg = j_smoke("granite-3-2b")
    jt = JTrainConfig(quant=JQuantConfig(
        method="lotion", fmt_name="int4", lam=1000.0,
        penalty_placement="decoupled", policy=JPolicy(min_size=256)),
        clip_norm=1.0, ef_compress=True)
    tx = j_make_optimizer(jt, j_adamw(j_cosine(3e-3, 2, 10)))
    step = jax.jit(j_make_train_step(jcfg, jt, tx))
    st = j_init_state(_jax_params(), tx)
    perm = j_perm(0, jcfg.vocab)
    out = []
    for s in range(W.EF_STEPS):
        st, m = step(st, j_lm_batch(0, s, W.BATCH, W.SEQ, jcfg.vocab, perm))
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("mesh", EF_MESHES)
def test_ef_steps_match_jax(runs, jax_ef_steps, mesh):
    got = runs["mesh"][mesh][0]["ef"]["metrics"]
    for g, j in zip(got, jax_ef_steps):
        for k, tol in (("loss", RTOL), ("grad_norm", RTOL),
                       ("penalty", PENALTY_RTOL)):
            assert abs(g[k] - j[k]) <= tol * abs(j[k]), (k, g[k], j[k])
        assert g["skipped"] == float(j["skipped"]) == 0.0


def _flat(tree):
    return [(k, v) for k, v in ckpt_io._paths_and_leaves(tree)]


@pytest.mark.parametrize("where", ["1x2", "one_device"])
def test_ef_state_restores_across_meshes(runs, where):
    saved = runs["mesh"]["2x1"][0]["ef_saved"]
    if where == "1x2":
        loaded = runs["mesh"]["1x2"][0]["ef_loaded"]
        assert loaded["step"] == W.EF_STEPS
        state = loaded["state"]
    else:
        cfg, _, opt = W.ef_setup()
        state = init_state(lm_init(cfg, seed=1, device="cpu"), opt)
        state, step = ckpt_io.load(str(runs["ckpt"]), into=state,
                                   step=W.EF_STEPS)
    pairs = list(zip(_flat(saved), _flat(state)))
    assert [k for (k, _), _ in pairs] == [k for _, (k, _) in pairs]
    assert any("err" in k for (k, _), _ in pairs)
    for (k, a), (_, b) in pairs:
        assert a.numpy().tobytes() == b.numpy().tobytes(), k


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_nan_on_one_data_rank_keeps_err_on_every_rank(runs, mesh):
    got = runs["mesh"][mesh][0]["nan"]
    # per rank: [skipped, err unchanged, params unchanged]
    assert got == [[1, 1, 1]] * len(runs["mesh"][mesh])


def test_whole_blocks_predicate():
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((2, 1), ("data", "model"))
    sh = shd.NamedSharding(mesh, shd.P(None, "data", "model"))
    # the model axis has one rank: dim 1 is the innermost cut
    assert shd.whole_blocks((2, 64, 64), sh, 256)
    assert not shd.whole_blocks((2, 64, 6), sh, 256)
    assert shd.whole_blocks((7,), shd.NamedSharding(mesh, shd.P()), 256)
    with pytest.raises(ValueError, match="split quant blocks"):
        shd.check_whole_blocks("x", (2, 64, 6), sh, 256)
