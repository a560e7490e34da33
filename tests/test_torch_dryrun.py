"""The port's dry-run tools (``launch/dryrun.py``, ``launch/hlo_analysis.py``,
``launch/roofline.py``, ``configs.cells``, ``make_production_mesh``) on
the CPU.

Bitwise with JAX: the cell list, ``active_param_count`` and
``model_flops`` for every config at full size (meta tensors, nothing
allocated), ``roofline_terms`` and ``roofline.row`` on the same inputs
(JAX's modules patched to the H100's constants here; their files stay as
they are), and the wire bytes of the same collectives as JAX's
``analyze_collectives`` reads them from a handwritten HLO text.

Against the live runs: the collectives the dry-run traces for one train
step and one decode step of Granite smoke on fake worlds of 2 and 4
equal, op by op, the collectives that gloo worlds of 2 and 4 processes
(``tests/torch_dryrun_worker.py``) issue for the same steps; its FLOPs
on (1, 1) equal ``FlopCounterMode`` over the live one-device steps.

JAX's own dry-run as the reference: JAX's ``lower_cell`` in a
subprocess on 8 forced host devices, its mesh made with Auto axes (jax
0.9's ``jax.make_mesh`` makes Explicit ones, which ``with_sharding_
constraint`` refuses), Granite smoke train and decode on (2, 4); the
port's records of the same cells carry its keys, ``roofline.py`` reads
both, both count collectives and both fit.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import repro.launch.hlo_analysis as j_hlo
import repro.launch.roofline as j_roof
from repro.configs import cells as j_cells
from repro.launch.dryrun import active_param_count as j_active
from repro.launch.dryrun import model_flops as j_model_flops
from repro.configs import get_config as j_config
from repro_torch.configs import SHAPES, cells, get_config, get_smoke_config
from repro_torch.distributed import context
from repro_torch.launch import dryrun, hlo_analysis, roofline
from repro_torch.launch import mesh as tmesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dryrun_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_dryrun_worker.py"
LIVE_MESHES = {"2x1": 2, "1x2": 2, "2x2": 4}
JOIN_S = 240
ARCH_IDS = ["granite-3-2b", "gemma2-2b", "codeqwen1.5-7b", "gemma3-12b",
            "musicgen-medium", "dbrx-132b", "moonshot-v1-16b-a3b",
            "zamba2-2.7b", "rwkv6-1.6b", "llama3.2-vision-11b"]

JAX_SUBPROC = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import repro.launch.dryrun as dr

    def small_mesh(*, multi_pod=False):
        return jax.make_mesh((2, 4), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

    dr.make_production_mesh = small_mesh
    import repro.launch.specs as sp
    from repro.configs import get_smoke_config
    sp.get_config = get_smoke_config
    import repro.configs as C
    C.SHAPES["t"] = dict(seq_len=64, global_batch=8, kind="train")
    C.SHAPES["d"] = dict(seq_len=64, global_batch=8, kind="decode")
    with open(sys.argv[1], "w") as f:
        for shape in ("t", "d"):
            rec, _ = dr.lower_cell("granite-3-2b", shape, multi_pod=False,
                                   n_microbatches=2, attn_chunk_train=32,
                                   logit_chunk=32)
            rec["mesh"] = "2x4"
            f.write(json.dumps(rec) + "\\n")
""")


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The live gloo worlds and JAX's dry-run, started together; joined
    by ``joined``."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {mesh: [subprocess.Popen(
        [sys.executable, str(WORKER), str(tmp / f"store_{mesh}"), str(r),
         str(world), mesh, str(tmp / f"live_{mesh}.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)] for mesh, world in LIVE_MESHES.items()}
    procs["jax"] = [subprocess.Popen(
        [sys.executable, "-c", JAX_SUBPROC, str(tmp / "jax.jsonl")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    yield tmp, procs
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


def _joined(background, key):
    tmp, procs = background
    logs = []
    for p in procs[key]:
        try:
            logs.append(p.communicate(timeout=JOIN_S)[0] or "")
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{key} did not finish in {JOIN_S} s")
    bad = [(i, p.returncode) for i, p in enumerate(procs[key])
           if p.returncode]
    assert not bad, f"{key} failed {bad}:\n" + "\n".join(logs)[-6000:]
    return tmp


# --------------------------------------------------------------------------
# Bitwise with JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("include_skipped", [False, True])
def test_cells_match_jax(include_skipped):
    assert cells(include_skipped) == j_cells(include_skipped)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    assert dryrun.active_param_count(cfg) == j_active(jcfg)
    for shape in SHAPES.values():
        args = (shape["kind"], shape["global_batch"], shape["seq_len"])
        assert dryrun.model_flops(cfg, *args) == j_model_flops(jcfg, *args)


def _h100(monkeypatch):
    monkeypatch.setattr(j_hlo, "PEAK_FLOPS_BF16", tmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(j_hlo, "HBM_BW", tmesh.HBM_BW)
    monkeypatch.setattr(j_hlo, "ICI_BW", tmesh.NVLINK_BW)
    monkeypatch.setattr(j_roof, "PEAK_FLOPS_BF16", tmesh.PEAK_FLOPS_BF16)


TERMS = [(3.7e15, 2.2e12, 9.1e10, 256), (1.0e9, 7.7e11, 0.0, 4),
         (5.5e12, 1.0e9, 3.3e11, 512), (0.0, 0.0, 0.0, 1)]


@pytest.mark.parametrize("inputs", TERMS)
def test_roofline_terms_and_rows_match_jax(inputs, monkeypatch):
    _h100(monkeypatch)
    got = hlo_analysis.roofline_terms(*inputs)
    assert got == j_hlo.roofline_terms(*inputs, n_links=1)
    rec = {"arch": "granite-3-2b", "shape": "train_4k", "mesh": "16x16",
           "kind": "train", "roofline": got, "model_flops": 2.1e17,
           "n_devices": inputs[3], "useful_flops_ratio": 0.7,
           "mem": {"peak": 3.1e10, "fits_hbm": True}}
    assert roofline.row(dict(rec)) == j_roof.row(dict(rec))


HLO = """
  %all-reduce.1 = f32[256,2048]{1,0} all-reduce(f32[256,2048]{1,0} %p), replica_groups={{0,1,2,3}}, to_apply=%add
  %all-gather.2 = bf16[8,4096,512]{2,1,0} all-gather(bf16[1,4096,512]{2,1,0} %q), replica_groups=[2,8]<=[16], dimensions={0}
  %all-reduce.3 = f32[40]{0} all-reduce(f32[40]{0} %r), replica_groups={{0,1}}, to_apply=%max
  %all-gather.4 = s8[2048,1024]{1,0} all-gather(s8[1024,1024]{1,0} %s), replica_groups={{0,1}}, dimensions={0}
  %all-reduce.5 = f32[7]{0} all-reduce(f32[7]{0} %t), replica_groups={{0}}, to_apply=%add
"""
# the same collectives as (op, result bytes, group size)
RECORDS = [("all_reduce", 256 * 2048 * 4, 4),
           ("all_gather", 8 * 4096 * 512 * 2, 8),
           ("all_reduce", 40 * 4, 2), ("all_gather", 2048 * 1024, 2),
           ("all_reduce", 7 * 4, 1)]


def test_wire_bytes_match_jax_hlo_analysis():
    want = j_hlo.analyze_collectives(HLO, 16)
    got = hlo_analysis.collective_stats(RECORDS)
    assert got.to_json() == want.to_json()
    assert want.per_op == {"all-reduce": 3, "all-gather": 2}


def test_cost_mode_flag_as_jax():
    from repro.distributed import context as jctx
    for on in (True, False):
        context.set_cost_mode(on)
        jctx.set_cost_mode(on)
        assert context.scan_unroll(40) == jctx.scan_unroll(40)
    assert context.scan_unroll(40) == 1


def test_production_meshes():
    for multi_pod, shape, axes in ((False, (16, 16), ("data", "model")),
                                   (True, (2, 16, 16),
                                    ("pod", "data", "model"))):
        m = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert (tuple(m.shape.values()), m.axis_names) == (shape, axes)
        assert not m.live
        live = tmesh.make_production_mesh(multi_pod=multi_pod, live=True,
                                          device="cpu")
        try:
            assert live.backend == "fake" and dist.get_world_size() == \
                live.size and live.rank == 0
            assert all(live.coord(a) == 0 for a in axes)
        finally:
            tmesh.close_mesh()
    assert tmesh.HBM_BYTES == dryrun.HBM_PER_CHIP == 80e9


# --------------------------------------------------------------------------
# Against the live runs
# --------------------------------------------------------------------------

def _traced(kind, mesh_shape):
    cfg, tcfg, opt = W.setup()
    shape = W.TRAIN if kind == "train" else W.DECODE
    rec, _ = dryrun.lower_cell(
        "granite-3-2b", kind, multi_pod=False, config=cfg, shape=shape,
        mesh_shape=(mesh_shape, ("data", "model")), train_config=tcfg,
        optimizer=opt, device="cpu")
    return rec


@pytest.mark.parametrize("mesh", list(LIVE_MESHES))
def test_traced_collectives_equal_the_live_runs(mesh, background):
    shape = tuple(int(x) for x in mesh.split("x"))
    traced = {k: _traced(k, shape) for k in ("train", "decode")}
    tmp = _joined(background, mesh)
    live = json.loads((tmp / f"live_{mesh}.json").read_text())
    for kind, rec in traced.items():
        assert rec["collectives"]["per_op"] == {
            op.replace("_", "-"): n for op, n in live[kind].items()}, kind
        # what the counter saw in the trace is what CommDebugMode saw
        assert rec["issued"] == live[kind], kind
        assert rec["collectives"]["total_wire_bytes"] > 0
    assert live["train"]["all_reduce"] > 0 and live["train"]["all_gather"] > 0


def test_traced_flops_equal_the_live_one_device_steps():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data import lm_batch, permutation_table
    from repro_torch.models.lm import init_cache, lm_decode, lm_init
    from repro_torch.train import init_state, make_train_step
    cfg, tcfg, opt = W.setup()
    state = init_state(lm_init(cfg, seed=0, device="cpu"), opt)
    step = make_train_step(cfg, tcfg, opt)
    b, seq = W.TRAIN["global_batch"], W.TRAIN["seq_len"]
    batch = lm_batch(0, 0, b, seq, cfg.vocab, permutation_table(0, cfg.vocab))
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    assert _traced("train", (1, 1))["flops_per_dev"] == fc.get_total_flops()
    n = W.DECODE["global_batch"]
    cache = init_cache(cfg, n, W.DECODE["seq_len"], device="cpu")
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        lm_decode(state["params"], cfg, cache,
                  torch.zeros((n, 1), dtype=torch.long),
                  torch.zeros(n, dtype=torch.long))
    rec = _traced("decode", (1, 1))
    assert rec["flops_per_dev"] == fc.get_total_flops() > 0
    assert rec["collectives"]["per_op"] == {}


def test_jax_dryrun_reference(background, tmp_path):
    tmp = _joined(background, "jax")
    jrecs = [json.loads(x) for x in
             (tmp / "jax.jsonl").read_text().splitlines()]
    cfg = get_smoke_config("granite-3-2b")
    ours = []
    for jrec, kind in zip(jrecs, ("train", "decode")):
        rec, _ = dryrun.lower_cell(
            "granite-3-2b", jrec["shape"], multi_pod=False, config=cfg,
            shape=dict(seq_len=64, global_batch=8, kind=kind),
            mesh_shape=((2, 4), ("data", "model")), n_microbatches=2,
            attn_chunk_train=32, logit_chunk=32, device="cpu")
        assert set(jrec) - {"cost_method"} <= set(rec), set(jrec) - set(rec)
        assert rec["cost_method"] == "traced"
        for r in (rec, jrec):
            assert sum(r["collectives"]["per_op"].values()) > 0
            assert r["mem"]["fits_hbm"]
        ours.append(rec)
    path = tmp_path / "both.jsonl"
    with open(path, "w") as f:
        for r in jrecs + [dict(r, arch="port-" + r["arch"]) for r in ours]:
            f.write(json.dumps(r) + "\n")
    rows = roofline.main([str(path), "--mesh", "2x4"])
    assert len(rows) == 4 and all(r["error"] is None for r in rows)
    assert all(r["t_compute_ms"] > 0 and r["t_collective_ms"] > 0
               for r in rows)


def test_main_writes_records_roofline_reads(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(dryrun.SHAPES, "t",
                        dict(seq_len=32, global_batch=4, kind="train"))
    out = tmp_path / "d.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "granite-3-2b", "--shape", "t", "--smoke",
                     "--mesh", "2x2", "--device", "cpu", "--out", str(out),
                     "--microbatches", "1"])
    assert e.value.code == 0, capsys.readouterr().out
    rec = json.loads(out.read_text())
    assert rec["mesh"] == "2x2" and rec["n_devices"] == 4
    rows = roofline.main([str(out), "--mesh", "2x2"])
    assert rows[0]["fits"] and rows[0]["bottleneck"] in (
        "compute", "memory", "collective")
