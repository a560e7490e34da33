"""Sharded serving of the port on CPU meshes (gloo), against the port's
one-device serving (which ``test_torch_serve.py``,
``test_torch_scheduler.py`` and the zoo's tests hold to JAX's), and the
roles of the model's prefill against JAX's.

Worlds of 1, 2 and 4 processes (``tests/torch_serve_mesh_worker.py``,
one per rank, FileStore rendezvous, every process group with a timeout,
every process joined with a timeout and then killed) serve meshes
(1, 1), (2, 1), (1, 2) and (2, 2) through the launcher's placement: each
rank draws its blocks of Granite smoke and casts them on their blocks.
The one-device reference runs in this process with one thread, as the
ranks do.

Bars: each rank's blocks of every cast (RTN and RR, int4 and int8,
per-matrix and blockwise scales) are bitwise the one-device tree's
leaves cut by JAX's own specs for the QTensor tree, and gather back to
them bitwise.  Where nothing is cut but the weights (data = 1: the
static engine, and the scheduler's and the chaos replay's whole batch on
every mesh) tokens and last logits are bitwise one device's.  Where the
static batch is cut over data the tokens are equal, a token parting only
at a near tie of the one-device logits (the top two within ``TIE_RTOL``
of the largest), and the last logits within ``LOGIT_RTOL`` of the
largest: the rank's matmuls see fewer rows, which may change the fp32
order of a sum.  Moonlight (MoE) and Zamba2 (SSM) smoke on (1, 2).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_smoke_config as j_smoke
from repro.core import QuantPolicy as JPolicy
from repro.core.qtensor import quantize_params as j_quantize_params
from repro.distributed import sharding as jsh
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import context
from repro_torch.models import lm as tlm

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_serve_mesh_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_serve_mesh_worker.py"
MESHES = {"1x1": 1, "2x1": 2, "1x2": 2, "2x2": 4}
JOIN_S = 240
LOGIT_RTOL = 1e-5
TIE_RTOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for mesh, world in MESHES.items():
        procs[mesh] = [subprocess.Popen(
            [sys.executable, str(WORKER), str(tmp / f"store_{mesh}"), str(r),
             str(world), mesh, str(tmp / f"out_{mesh}.pt")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    out, logs = {}, []
    try:
        for mesh, ps in procs.items():
            for p in ps:
                logs.append(p.communicate(timeout=JOIN_S)[0])
            bad = [(i, p.returncode) for i, p in enumerate(ps) if p.returncode]
            assert not bad, f"{mesh}: ranks failed {bad}:\n" + \
                "\n".join(logs)[-6000:]
            res = torch.load(tmp / f"out_{mesh}.pt", weights_only=False)
            res["rank_blocks"] = [torch.load(tmp / f"out_{mesh}.pt.rank{r}",
                                             weights_only=False)
                                  for r in range(len(ps))]
            out[mesh] = res
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


@pytest.fixture(scope="module")
def ref():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = {"casts": {f"{w}/{bs}": W.placed("granite-3-2b", w, bs)[1]
                         for w, bs in W.CASTS},
               "engine": W.engine_run("granite-3-2b"),
               "engine_a8": W.engine_run("granite-3-2b", act_fmt="int8"),
               "engine_blockwise": W.engine_run("granite-3-2b", "rtn:int4",
                                                32),
               "sched": W.sched_run("granite-3-2b"),
               "chaos": W.chaos_run()}
        for arch in ("moonshot-v1-16b-a3b", "zamba2-2.7b"):
            res[f"engine_{arch}"] = W.engine_run(arch)
            res[f"sched_{arch}"] = W.sched_run(arch, paged=False,
                                               prefill_chunk=None,
                                               prefix_cache=False)
    finally:
        torch.set_num_threads(threads)
    return res


# --------------------------------------------------------------------------
# Part 0: the model's roles in prefill, chunked prefill and decode
# --------------------------------------------------------------------------

@pytest.fixture
def role_calls(monkeypatch):
    """Every ``constrain`` / ``constrain_tree`` the port's model makes,
    counted by role (roles installed for all of them)."""
    calls = {}
    real_tree = context.constrain_tree

    def count_tree(tree, role):
        calls[role] = calls.get(role, 0) + 1
        return real_tree(tree, role)

    def count(x, role):
        calls[role] = calls.get(role, 0) + 1
        return x

    monkeypatch.setattr(tlm, "constrain", count)
    monkeypatch.setattr(tlm, "constrain_tree", count_tree)
    return calls


def _jax_prefill_roles(arch):
    """The roles JAX's ``lm_prefill`` applies (its scan body traced once:
    each role once)."""
    calls = {}

    def count(x, role):
        calls[role] = calls.get(role, 0) + 1
        return x

    cfg = j_smoke(arch)
    params = jlm.lm_init(jax.random.PRNGKey(0), cfg)
    toks = jax.numpy.zeros((2, 8), jax.numpy.int32)
    real = (jlm.constrain, jlm.constrain_tree)
    jlm.constrain, jlm.constrain_tree = count, count
    try:
        jlm.lm_prefill(params, cfg, toks, cache_len=16)
    finally:
        jlm.constrain, jlm.constrain_tree = real
    return calls


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b"])
def test_prefill_applies_the_roles_jax_applies(arch, role_calls):
    """Every role JAX's prefill applies, the port's applies too; the unit
    body's ``residual`` and ``stage_params`` once per unit (JAX's scan
    applies them once per trip), the shared block's leaves once per
    unit."""
    want = _jax_prefill_roles(arch)
    assert {"residual", "stage_params"} <= set(want)
    cfg = get_smoke_config(arch)
    params = tlm.lm_init(cfg, seed=0, device="cpu")
    with torch.no_grad():
        tlm.lm_prefill(params, cfg, torch.zeros((2, 8), dtype=torch.long),
                       cache_len=16)
    assert set(want) <= set(role_calls), (want, role_calls)
    assert role_calls["residual"] == cfg.n_repeats
    assert role_calls["stage_params"] == cfg.n_repeats
    assert role_calls.get("shared", 0) == (cfg.n_repeats
                                           if cfg.shared_attn_every else 0)


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b"])
def test_decode_and_chunk_gather_where_they_read(arch, role_calls):
    """``lm_decode`` and ``lm_prefill_chunk`` read every stage leaf and
    the shared block's through their roles, once per unit."""
    cfg = get_smoke_config(arch)
    params = tlm.lm_init(cfg, seed=0, device="cpu")
    cache = tlm.init_cache(cfg, 2, 16, device="cpu")
    with torch.no_grad():
        tlm.lm_decode(params, cfg, cache, torch.zeros((2, 1),
                                                      dtype=torch.long),
                      torch.zeros(2, dtype=torch.long))
        assert role_calls["stage_params"] == cfg.n_repeats
        assert role_calls.get("shared", 0) == (
            cfg.n_repeats if cfg.shared_attn_every else 0)
        if arch == "granite-3-2b":
            role_calls.clear()
            tlm.lm_prefill_chunk(params, cfg, cache,
                                 torch.zeros((2, 4), dtype=torch.long),
                                 torch.zeros(2, dtype=torch.long))
            assert role_calls["stage_params"] == cfg.n_repeats


def test_roles_with_nothing_installed_are_bitwise_no_ops():
    """With roles installed that return their input, prefill, a chunk and
    a decode step are bitwise the calls with nothing installed."""
    cfg = get_smoke_config("granite-3-2b")
    params = tlm.lm_init(cfg, seed=0, device="cpu")
    toks = torch.tensor(W.prompts(cfg.vocab, n=2, seed=3)[0][:3] * 2
                        ).reshape(2, 3)

    def run():
        lg, cache = tlm.lm_prefill(params, cfg, toks, cache_len=16)
        lg2, _ = tlm.lm_decode(params, cfg, cache, toks[:, :1],
                               torch.full((2,), 3))
        return lg, lg2
    with torch.no_grad():
        want = run()
        ident = lambda x: x  # noqa: E731
        unit = tlm.layer_params(params["stage"], 0)
        from repro_torch.core.policy import tree_map
        with context.constraints(residual=ident,
                                 stage_params=tree_map(lambda x: ident,
                                                       unit)):
            got = run()
    assert all(torch.equal(a, b) for a, b in zip(want, got))


# --------------------------------------------------------------------------
# Part A: the blocks of the casts, the engine, the scheduler, the chaos
# --------------------------------------------------------------------------

def _norm(spec):
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else (tuple(e) if e else None)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _jax_qtree_specs(weights, block_size, mesh_shape):
    """JAX's specs of each leaf of its cast tree (QTensor children by
    their "codes" / "scales" keys) on an AbstractMesh."""
    mode, fmt = weights.split(":")
    cfg = j_smoke("granite-3-2b")
    params = jlm.lm_init(jax.random.PRNGKey(0), cfg)
    shapes = jax.eval_shape(lambda p: j_quantize_params(
        p, fmt, JPolicy(min_size=256), block_size), params)
    sh = jsh.params_shardings(AbstractMesh(mesh_shape, ("data", "model")),
                              shapes)
    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): _norm(s.spec) for p, s in flat}


def _cut(x, spec, coords, mesh_shape):
    idx = []
    for d, e in enumerate(spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        if not axes:
            idx.append(slice(None))
            continue
        n = int(np.prod([mesh_shape[a] for a in axes]))
        i = 0
        for a in axes:
            i = i * mesh_shape[a] + coords[a]
        m = x.shape[d] // n
        idx.append(slice(i * m, (i + 1) * m))
    return x[tuple(idx)]


def _flat(tree):
    from repro_torch.distributed.sharding import tree_leaves_with_path
    return {"/".join(str(k) for k in p): x
            for p, x in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_blocks_are_the_whole_cast_cut_by_jax_specs(mesh, runs, ref):
    d, m = (int(v) for v in mesh.split("x"))
    res = runs[mesh]
    for weights, bs in W.CASTS:
        key = f"{weights}/{bs}"
        jspecs = _jax_qtree_specs(weights, bs, (d, m))
        assert {k: _norm(v) for k, v in res["blocks"][key].items()} == \
            jspecs, key
        whole = _flat(ref["casts"][key])
        assert res["gathered_equal"][key], key
        for r in range(d * m):
            coords = {"data": r // m, "model": r % m}
            mine = _flat(res["rank_blocks"][r][key])
            assert mine.keys() == whole.keys()
            for path, x in whole.items():
                assert torch.equal(mine[path], _cut(x, jspecs[path], coords,
                                                    {"data": d,
                                                     "model": m})), \
                    (key, r, path)
        n_whole = sum(x.numel() * x.element_size() for x in whole.values())
        if d * m == 1:
            assert res["nbytes"][key] == n_whole
        else:
            assert res["nbytes"][key] < n_whole


def _near_tie_parting(arch, prompt, want, got, act_fmt=None):
    """The step where ``got`` leaves ``want`` is a near tie of the
    one-device logits (decoding ``want``)."""
    from repro_torch.core.qtensor import qtensor_act_fmt
    cfg, params, _ = W.placed(arch, "rtn:int4")
    step = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    with torch.no_grad(), qtensor_act_fmt(act_fmt):
        lg, cache = tlm.lm_prefill(params, cfg, torch.tensor([prompt]),
                                   cache_len=64, kv_quant="int8")
        for i in range(step):
            lg, cache = tlm.lm_decode(params, cfg, cache,
                                      torch.tensor([[want[i]]]),
                                      torch.tensor([len(prompt) + i]))
    top2 = torch.sort(lg[0, 0]).values[-2:]
    return float(top2[1] - top2[0]) <= TIE_RTOL * float(lg.abs().max())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("run", ["engine", "engine_a8"])
def test_static_engine_matches_one_device(mesh, run, runs, ref):
    got, want = runs[mesh][run], ref[run]
    cut = int(mesh.split("x")[0]) > 1
    if not cut:
        assert got["tokens"] == want["tokens"]
        assert torch.equal(got["logits"], want["logits"])
        return
    cfg = get_smoke_config("granite-3-2b")
    for i, (g, w) in enumerate(zip(got["tokens"], want["tokens"])):
        if g != w:
            assert _near_tie_parting(
                "granite-3-2b", W.prompts(cfg.vocab)[i], w, g,
                "int8" if run == "engine_a8" else None), i
    if got["tokens"] == want["tokens"]:
        scale = float(want["logits"].abs().max())
        assert float((got["logits"] - want["logits"]).abs().max()) <= \
            LOGIT_RTOL * scale


@pytest.mark.parametrize("mesh", list(MESHES))
def test_scheduler_matches_one_device(mesh, runs, ref):
    got, want = runs[mesh]["sched"], ref["sched"]
    assert got["outputs"] == want["outputs"]
    assert got["counters"] == want["counters"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_chaos_replay_matches_one_device(mesh, runs, ref):
    got, want = runs[mesh]["chaos"], ref["chaos"]
    assert got["violations"] == want["violations"] == []
    for key in ("outputs", "by_state", "counters", "ticks"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("case", [
    "engine_blockwise", "engine_moonshot-v1-16b-a3b", "engine_zamba2-2.7b",
    "sched_moonshot-v1-16b-a3b", "sched_zamba2-2.7b"])
def test_blockwise_moe_and_ssm_on_1x2(case, runs, ref):
    """int4 blockwise scales (cut with their codes), MoE and SSM configs
    on (1, 2): bitwise one device."""
    got, want = runs["1x2"][case], ref[case]
    if case.startswith("engine"):
        assert got["tokens"] == want["tokens"]
        assert torch.equal(got["logits"], want["logits"])
    else:
        assert got["outputs"] == want["outputs"]
        assert got["counters"] == want["counters"]


def test_divergence_of_one_rank_fails_every_rank(runs):
    msg = runs["1x2"]["diverge"]
    assert "diverged at tick 2" in msg and "ranks [1]" in msg, msg


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------

def _serve(argv, capsys):
    from repro_torch.launch import serve
    serve.main(argv)
    return capsys.readouterr().out


def test_launcher_mesh_1x1_needs_no_torchrun(capsys):
    base = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
            "--weights", "rtn:int4", "--kv-quant", "int8", "--new-tokens",
            "4"]
    one = _serve(base, capsys)
    mesh = _serve(base + ["--mesh", "1x1"], capsys)
    assert "mesh {'data': 1, 'model': 1} (gloo, cpu)" in mesh
    # the same weight bytes: a one-rank mesh's blocks are the leaves
    assert one.splitlines()[0].split("weight_bytes=")[1].split()[0] == \
        mesh.splitlines()[1].split("weight_bytes=")[1].split()[0]
    out = _serve(base + ["--mesh", "1x1", "--chaos", "--n-requests", "8"],
                 capsys)
    assert "0 violations" in out
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("argv", [
    ["--arch", "moonshot-v1-16b-a3b", "--scheduler", "--prefill-chunk", "8"],
    ["--arch", "zamba2-2.7b", "--scheduler", "--paged"]])
def test_launcher_mesh_refuses_what_one_device_refuses(argv):
    from repro_torch.launch import serve
    base = argv + ["--smoke", "--device", "cpu", "--n-requests", "2"]
    msgs = []
    for extra in ([], ["--mesh", "1x1"]):
        with pytest.raises(ValueError) as e:
            serve.main(base + extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert not torch.distributed.is_initialized()


def test_launcher_mesh_1x2_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--arch", "granite-3-2b", "--smoke", "--device", "cpu", "--mesh",
         "1x2", "--scheduler", "--paged", "--prefill-chunk", "16",
         "--prefix-cache", "--kv-quant", "int8", "--weights", "rtn:int4",
         "--act-fmt", "int8", "--n-requests", "8"],
        env=env, capture_output=True, text=True, timeout=JOIN_S,
        cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    # only rank 0 prints
    assert sum("offered load" in x for x in lines) == 1, out.stdout
    assert "outputs identical: True" in out.stdout
