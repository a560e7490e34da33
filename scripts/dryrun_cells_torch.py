"""The dry-run cells that ``chip_smoke.py`` holds to its live runs, traced
by ``launch/dryrun.py`` in a process of their own (fake tensors on the
card's device; a fake process group, so this process needs no other).

    PYTHONPATH=src python3 scripts/dryrun_cells_torch.py OUT CELL [CELL ...]

CELL is one of:

* ``train_phase``: the ``train`` phase's cell (Granite-3-2B, 40 layers,
  bf16, 4 x 1024, its LOTION settings) on (1, 1);
* ``two_ranks``: the steps of ``train_mesh_two_ranks`` (2 layers, fp32,
  no recomputation, 4 x 1024, both placements) on (2, 1) and (1, 2);
* ``train_4k``, ``decode_32k``: Granite-3-2B's cells of ``SHAPES`` on the
  production mesh (16, 16), as ``launch/dryrun.py --arch granite-3-2b``
  traces them.

Writes one JSON record per traced cell to OUT (``lower_cell``'s record
plus ``cell``, for ``two_ranks`` the mesh and placement, where this
process first initialised CUDA and the most device memory it has
reserved), in the order given.  ``DRYRUN_FAULT`` (a name in
``scripts/planted_faults_torch.py::DRYRUN_FAULTS``) plants a fault in
this process.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import traceback

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def cells(name: str):
    """(label, lower_cell kwargs) of one CELL."""
    import chip_smoke as cs
    import scripts.mesh_ranks_torch as ranks
    if name == "train_phase":
        cfg, _, tcfg, opt = cs.granite_setup()
        return [(dict(cell=name), dict(
            shape_id="train", config=cfg, train_config=tcfg, optimizer=opt,
            shape=dict(seq_len=cs.TRAIN_SEQ, global_batch=cs.TRAIN_BATCH,
                       kind="train"),
            mesh_shape=((1, 1), ("data", "model"))))]
    if name == "two_ranks":
        out = []
        for mesh, placement, method in ranks.RUNS:
            cfg, _, tcfg, opt = ranks._setup(placement, method)
            shape = tuple(int(x) for x in mesh.split("x"))
            out.append((dict(cell=name, mesh=mesh, placement=placement), dict(
                shape_id="train", config=cfg, train_config=tcfg,
                optimizer=opt, shape=dict(seq_len=ranks.SEQ,
                                          global_batch=ranks.BATCH,
                                          kind="train"),
                mesh_shape=(shape, ("data", "model")))))
        return out
    from repro_torch.launch import dryrun as dr
    cfg = cs.granite_cfg()
    return [(dict(cell=name), dict(
        shape_id=name, config=cfg,
        n_microbatches=dr.TRAIN_MICROBATCHES.get(cfg.name, 4)))]


def _watch_cuda_init(torch) -> list:
    """The Python stack of the first call that initialises CUDA in this
    process (``torch.cuda._lazy_init``, which torch's C++ calls by name
    too), appended to the list returned."""
    seen, init = [], torch.cuda._lazy_init

    def lazy_init():
        if not seen and not torch.cuda.is_initialized():
            seen.append("".join(traceback.format_stack(limit=12)[:-1]))
        return init()
    torch.cuda._lazy_init = lazy_init
    return seen


def main(argv) -> int:
    import torch

    from repro_torch.launch import dryrun as dr
    cuda_init_at = _watch_cuda_init(torch)
    out_path, names = argv[0], argv[1:]
    fault = os.environ.get("DRYRUN_FAULT")
    ctx = contextlib.nullcontext()
    if fault:
        from scripts.planted_faults_torch import DRYRUN_FAULTS
        ctx = DRYRUN_FAULTS[fault]()
    with ctx, open(out_path, "w") as f:
        for name in names:
            for label, kw in cells(name):
                rec, _ = dr.lower_cell("granite-3-2b", kw.pop("shape_id"),
                                       multi_pod=False, **kw)
                # fake CUDA tensors start a context (torch's
                # fake_tensor.py::init_gpu_context makes one real
                # one-element tensor); nothing else of the traces may
                # reach the card that the phases are timing
                f.write(json.dumps(dict(
                    rec, **label,
                    cuda_init_at=cuda_init_at[0] if cuda_init_at else None,
                    cuda_max_reserved=torch.cuda.max_memory_reserved()
                    if torch.cuda.is_initialized() else 0)) + "\n")
                f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
