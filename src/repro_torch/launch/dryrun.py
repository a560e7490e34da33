"""Dry-run of the port (the counterpart of ``repro.launch.dryrun``): one
rank's step of every (architecture x input shape) cell on the production
meshes, traced once on fake tensors, with its FLOPs, HBM bytes,
collectives and peak memory recorded.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --multi-pod both --out dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k --smoke --mesh 2x2 --device cpu   # seconds, CPU

The flags are JAX's, plus ``--smoke`` (the smoke configs), ``--mesh``
(a mesh in place of the production ones) and ``--device``.

Where JAX lowers and compiles for 256 or 512 placeholder devices, the
port runs the program a rank runs: a fake mesh of the production shape
in this process (``launch/mesh.py::make_fake_mesh``: torch's fake process
group, this process as rank 0), the rank's blocks of the state and its
rows of the batch as fake tensors (``FakeTensorMode``: shapes, dtypes and
devices, no data), and the port's own sharded train step
(``train.make_train_step(grad_shardings=)``) or sharded ``lm_prefill`` /
``lm_decode`` (under ``sharding.serve_roles``, the launcher's serving
path) called once.  Every layer runs in the trace, so JAX's R1/R2
extrapolation is not needed (``cost_method: "traced"``).  The record
takes:

* ``flops_per_dev``: ``torch.utils.flop_counter.FlopCounterMode``;
* ``hbm_bytes_per_dev``: every op's operand and result bytes (a dispatch
  mode; views move nothing), the analogue of XLA's "bytes accessed";
* ``collectives``: ``torch.distributed.tensor.debug.CommDebugMode``'s
  counts by op, their bytes from ``distributed/collectives.py``'s
  counter through ``hlo_analysis.collective_stats``;
* ``mem.peak``: ``torch.distributed._tools.mem_tracker.MemTracker``'s
  peak over the state, the batch and the step.

The trace runs on the device the cell models: fake CUDA tensors where
there is a card, so device-dependent code takes the card's branch.  The
kernels have no fake implementations: their wrappers take the plain
versions for a fake tensor (``kernels/_build.py::plain``), which do no
matmul, so the FLOPs are the live step's; ``opt_fused`` records whether
the step's optimizer is the fused core, as JAX records it.

The port's activations are not cut over ``model``: a data rank's rows
run whole on each of its model ranks, each leaf gathered where it is
read (``--residual batch``, JAX's ``P(batch, None, None)``); JAX's
default ``dmodel`` and ``seq`` placements are refused.  A decode cell
keeps the rank's rows' cache whole (no length cut over ``model``: ROADMAP
Queue 1 item 8(f)).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, cells, get_config, get_smoke_config
from repro_torch.core.modes import QuantConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import constraints
from repro_torch.launch import specs as sp
from repro_torch.launch.hlo_analysis import (collective_stats, hlo_name,
                                             roofline_terms)
from repro_torch.launch.mesh import (HBM_BYTES, close_mesh, make_fake_mesh,
                                     make_production_mesh, parse_mesh)
from repro_torch.models.lm import init_cache, lm_decode, lm_prefill
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train import (TrainConfig, init_state, make_optimizer,
                               make_train_step)

HBM_PER_CHIP = HBM_BYTES     # NVIDIA H100 80GB HBM3

# per-arch microbatch counts for train_4k, as JAX's (default 4)
TRAIN_MICROBATCHES = {"dbrx-132b": 16, "moonshot-v1-16b-a3b": 8,
                      "gemma3-12b": 8, "llama-3.2-vision-11b": 8}
# per-arch train attention chunk
ATTN_CHUNK_TRAIN = {"dbrx-132b": 512}

# CommDebugMode's op names -> the port's
_C10D = {"allreduce_": "all_reduce", "allgather_": "all_gather",
         "broadcast_": "broadcast", "reduce_scatter_": "reduce_scatter"}


def _leaf_name(path) -> str:
    return "/".join(str(p) for p in path)


def active_param_count(cfg) -> tuple:
    """(total, active) parameter counts from the meta-device tree."""
    total = active = 0
    for path, x in shd.tree_leaves_with_path(sp.params_specs(cfg)):
        name = _leaf_name(path)
        n = int(math.prod(x.shape))
        total += n
        if cfg.ffn == "moe" and ("/moe/w_" in name):
            active += n * cfg.top_k // cfg.n_experts
        else:
            active += n
    return total, active


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    total, active = active_param_count(cfg)
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens


def _check_residual(residual: str) -> None:
    """A cell's rows are the batch over the data axes (``data_batch_spec``;
    a MoE config only in whole dispatch groups, as the live paths demand)
    and its activations whole over ``model``, as the live paths place
    them: ``train.loop.model_constraints``' roles in a train cell,
    ``sharding.serve_roles`` in a serving one."""
    if residual != "batch":
        raise ValueError(
            f"residual={residual!r}: the port's activations are not cut "
            f"over model (each model rank computes its data rank's rows "
            f"whole); only 'batch' is traced")


class BytesMode(TorchDispatchMode):
    """Sums every op's operand and result bytes: the analogue of XLA's
    "bytes accessed".  Views and ops that return no tensor (metadata
    queries such as a tensor's device) move nothing and count nothing.
    The plain versions of the kernels run as their many elementwise ops,
    so the sum over-counts a fused kernel's traffic (``opt_step`` reads
    and writes 28 bytes an element where its plain version moves several
    times that)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            moved = _tensor_bytes(out)
            if moved:
                self.bytes += moved + _tensor_bytes((args, kwargs))
        return out


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(_tensor_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(x) for x in tree.values())
    return 0


def _blocks(tree_abs, shardings, dev):
    """Fake blocks of an abstract tree: each leaf's block shape."""
    return shd.tree_map_with_path(
        lambda p, x, s: torch.zeros(shd.local_shape(s, x.shape),
                                    dtype=x.dtype, device=dev),
        tree_abs, shardings)


def _rows(shape, rows_sh, dtype, dev):
    lead = shape[0]
    if rows_sh is not None:
        lead = shd.local_shape(rows_sh, (lead,))[0]
    return torch.zeros((lead,) + tuple(shape[1:]), dtype=dtype, device=dev)


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _storage_bytes(tensors) -> dict:
    """Each distinct storage's bytes, by its address."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors}


def _program(cfg, kind, shp, mesh, kv_quant, fsdp, attn_chunk_prefill, lam,
             block_size, attn_chunk_train, logit_chunk, n_microbatches,
             residual, train_config, optimizer, dev):
    """(args, run, opt_fused): the cell's inputs as fake blocks and the
    function that runs the rank's program on them."""
    _check_residual(residual)
    batch, seq = shp["global_batch"], shp["seq_len"]
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    if kind == "train":
        tcfg = train_config or TrainConfig(
            quant=QuantConfig(method="lotion", fmt_name="int4", lam=lam,
                              block_size=block_size),
            attn_chunk=attn_chunk_train, logit_chunk=logit_chunk,
            n_microbatches=n_microbatches)
        opt = optimizer or make_optimizer(tcfg, adamw(
            cosine_with_warmup(3e-4, 100, 10000), weight_decay=0.0))
        state_sh = shd.state_shardings(mesh, sp.state_specs(cfg, tcfg),
                                       fsdp=fsdp)
        params_sh = state_sh["params"]
        params = _blocks(sp.params_specs(cfg), params_sh, dev)
        state = init_state(params, opt)
        step = make_train_step(cfg, tcfg, opt, grad_shardings=params_sh)
        bspecs = sp.train_batch_specs(cfg, batch, seq)
        rows = shd.train_batch_shardings(mesh, bspecs, batch)
        b = {k: _rows(x.shape, rows[k], torch.int64 if
                      x.dtype == torch.int32 else x.dtype, dev)
             for k, x in bspecs.items()}
        return (state, b), (lambda: step(state, b)), bool(
            getattr(step.optimizer, "applies_updates", False))
    params_sh = shd.params_shardings(mesh, sp.params_specs(cfg), fsdp=fsdp)
    params = _blocks(sp.params_specs(cfg), params_sh, dev)
    roles = shd.serve_roles(params_sh)
    rows_sh = shd.rows_sharding(mesh, cfg, batch,
                                seq if kind == "prefill" else 1)
    if kind == "prefill":
        toks = _rows((batch, seq) + books, rows_sh, torch.int64, dev)
        img = None
        if cfg.n_image_tokens:
            img = _rows((batch, cfg.n_image_tokens, cfg.d_vision), rows_sh,
                        torch.bfloat16, dev)

        def run():
            with torch.inference_mode(), constraints(**roles):
                return lm_prefill(params, cfg, toks, attn_chunk=
                                  attn_chunk_prefill, kv_quant=kv_quant,
                                  image_embeds=img)
        return (params, toks, img), run, None
    b_rank = batch if rows_sh is None else shd.local_shape(rows_sh,
                                                           (batch,))[0]
    cache = init_cache(cfg, b_rank, seq, kv_quant=kv_quant, device=dev)
    toks = _rows((batch, 1) + books, rows_sh, torch.int64, dev)
    pos = _rows((batch,), rows_sh, torch.int64, dev)

    def run():
        with torch.inference_mode(), constraints(**roles):
            return lm_decode(params, cfg, cache, toks, pos)
    return (params, cache, toks, pos), run, None


def lower_cell(arch: str, shape_id: str, *, multi_pod: bool,
               kv_quant: bool = False, fsdp: bool = True,
               attn_chunk_prefill: int = 2048, lam: float = 1e4,
               block_size: int = -1, donate: bool = True,
               attn_chunk_train: int = 2048, logit_chunk: int = 512,
               n_microbatches: int = 1, residual: str = "batch",
               config=None, shape: Optional[dict] = None,
               mesh_shape=None, train_config=None, optimizer=None,
               device=None):
    """Trace one cell once on its fake mesh; returns the record (JAX's
    keys) and the program's output (fake tensors).

    ``config`` / ``shape`` (a ``SHAPES`` entry) / ``mesh_shape`` (``(shape,
    axes)``) / ``train_config`` and ``optimizer`` replace the cell's own
    (a live run's settings, to hold the trace to it).  ``donate`` is
    accepted for JAX's signature: the port's steps update in place."""
    cfg = config or get_config(arch)
    shp = dict(shape or SHAPES[shape_id])
    kind = shp["kind"]
    if mesh_shape is not None:
        mesh = make_fake_mesh(mesh_shape[0], mesh_shape[1], device)
        mesh_name = "x".join(str(n) for n in mesh_shape[0])
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, live=True,
                                    device=device)
        mesh_name = "2x16x16" if multi_pod else "16x16"
    dev = mesh.device
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed._tools.mem_tracker import MemTracker
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.utils.flop_counter import FlopCounterMode

        t0 = time.time()
        with FakeTensorMode():
            args, run, opt_fused = _program(
                cfg, kind, shp, mesh, kv_quant, fsdp, attn_chunk_prefill,
                lam, block_size, attn_chunk_train, logit_chunk,
                n_microbatches, residual, train_config, optimizer, dev)
            in_storages = _storage_bytes(_tensors(args))
            arg_b = sum(in_storages.values())
            mt = MemTracker()
            mt.track_external(*_tensors(args))
            collectives.reset_issued()
            flops_mode = FlopCounterMode(display=False)
            comm = CommDebugMode()
            nbytes = BytesMode()
            with mt, flops_mode, comm, nbytes:
                out = run()
            peak_snap = mt.get_tracker_snapshot("peak")
        t_trace = time.time() - t0
    finally:
        close_mesh()

    peak = int(sum(v.get("Total", 0) for v in peak_snap.values()))
    out_storages = _storage_bytes(_tensors(out))
    out_b = sum(out_storages.values())
    alias_b = sum(n for k, n in out_storages.items() if k in in_storages)
    counts = {}
    for op, n in comm.get_comm_counts().items():
        name = _C10D.get(str(op).split(".")[-1], str(op))
        counts[name] = counts.get(name, 0) + int(n)
    stats = collective_stats(collectives.issued_records())
    coll = stats.to_json()
    coll["per_op"] = {hlo_name(k): v for k, v in counts.items()}
    flops = float(flops_mode.get_total_flops())
    hbm_bytes = float(nbytes.bytes)
    n_dev = mesh.size
    terms = roofline_terms(flops, hbm_bytes, stats.total_wire_bytes, n_dev)
    mf = model_flops(cfg, kind, shp["global_batch"], shp["seq_len"])
    rec = {
        "arch": arch, "shape": shape_id, "kind": kind, "mesh": mesh_name,
        "n_devices": n_dev, "kv_quant": kv_quant, "fsdp": fsdp,
        "opt_fused": opt_fused,
        "lower_s": round(t_trace, 1), "compile_s": 0.0,
        "flops_per_dev": flops, "hbm_bytes_per_dev": hbm_bytes,
        "collectives": coll,
        "roofline": terms,
        "model_flops": mf, "useful_flops_ratio": mf / max(flops * n_dev,
                                                          1.0),
        "mem": {"argument": arg_b, "temp": max(peak - arg_b - out_b
                                               + alias_b, 0),
                "output": out_b, "alias": alias_b, "peak": peak,
                "fits_hbm": bool(peak <= HBM_PER_CHIP)},
        "cost_method": "traced", "device": dev.type,
        "issued": collectives.issued(),
    }
    return rec, out


class CellTimeout(Exception):
    pass


def run_cell(arch, shape_id, multi_pod, args, out_fh=None):
    mesh_shape = parse_mesh(args.mesh) if args.mesh else None
    mesh_name = args.mesh or ("2x16x16" if multi_pod else "16x16")
    label = f"{arch} x {shape_id} x {mesh_name}"
    import signal

    def _alarm(signum, frame):
        raise CellTimeout(f"cell exceeded {args.cell_timeout}s")

    signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(int(args.cell_timeout))
    try:
        cfg0 = get_smoke_config(arch) if args.smoke else get_config(arch)
        n_mb = (args.microbatches if args.microbatches > 0
                else TRAIN_MICROBATCHES.get(cfg0.name, 4))
        act = ATTN_CHUNK_TRAIN.get(cfg0.name, args.attn_chunk_train)
        rec, _ = lower_cell(
            arch, shape_id, multi_pod=multi_pod, kv_quant=args.kv_quant,
            fsdp=not args.no_fsdp, donate=not args.no_donate,
            attn_chunk_train=act, logit_chunk=args.logit_chunk,
            n_microbatches=n_mb, residual=args.residual, config=cfg0,
            mesh_shape=mesh_shape, device=args.device)
        r = rec["roofline"]
        print(f"== {label}")
        print(f"   trace {rec['lower_s']}s on {rec['device']} | "
              f"peak/dev {rec['mem']['peak']/1e9:.2f} GB "
              f"fits={rec['mem']['fits_hbm']} | "
              f"compute {r['t_compute_s']*1e3:.2f}ms memory "
              f"{r['t_memory_s']*1e3:.2f}ms collective "
              f"{r['t_collective_s']*1e3:.2f}ms -> {r['bottleneck']} | "
              f"{rec['collectives']['per_op']}")
        if out_fh:
            out_fh.write(json.dumps(rec) + "\n")
            out_fh.flush()
        return True
    except Exception as e:
        print(f"!! {label} FAILED: {type(e).__name__}: {e}")
        traceback.print_exc()
        if out_fh:
            out_fh.write(json.dumps(
                {"arch": arch, "shape": shape_id, "mesh": mesh_name,
                 "error": f"{type(e).__name__}: {e}"}) + "\n")
            out_fh.flush()
        return False
    finally:
        signal.alarm(0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"], default="off")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--attn-chunk-train", type=int, default=2048)
    ap.add_argument("--logit-chunk", type=int, default=512)
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = per-arch default (TRAIN_MICROBATCHES)")
    ap.add_argument("--skip-cost", action="store_true",
                    help="accepted for JAX's flags: the one trace counts "
                         "every layer")
    ap.add_argument("--cell-timeout", type=float, default=1200.0)
    ap.add_argument("--residual", default="batch", choices=["batch"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs (a quick run on the CPU)")
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM in place of the production meshes")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors live (default: the card "
                         "where there is one)")
    args = ap.parse_args(argv)
    if args.mesh and args.multi_pod != "off":
        ap.error("--mesh replaces the production meshes: no --multi-pod")

    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]
    todo = []
    if args.all:
        for (a, s) in cells():
            for mp in pods:
                todo.append((a, s, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        for mp in pods:
            todo.append((args.arch, args.shape, mp))

    out_fh = open(args.out, "a") if args.out else None
    ok = 0
    with contextlib.ExitStack() as stack:
        if out_fh:
            stack.enter_context(out_fh)
        for a, s, mp in todo:
            ok += run_cell(a, s, mp, args, out_fh)
    print(f"\n{ok}/{len(todo)} cells passed")
    raise SystemExit(0 if ok == len(todo) else 1)


if __name__ == "__main__":
    main()
