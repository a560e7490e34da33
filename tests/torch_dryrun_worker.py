"""One rank of the dry-run's live counterpart (``tests/test_torch_dryrun.py``).

    python tests/torch_dryrun_worker.py STORE RANK WORLD DxM OUT

Joins a gloo world of WORLD ranks through the FileStore STORE, builds the
mesh DxM on the CPU and runs, on Granite smoke, one sharded train step
(``setup()``'s settings) and one sharded decode step (``lm_decode`` under
the serving roles, the rank's rows of the batch), counting the
collectives each issued (``distributed/collectives.py``).  Rank 0 writes
the counts to OUT (JSON).
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

TRAIN = dict(seq_len=32, global_batch=4, kind="train")
DECODE = dict(seq_len=32, global_batch=4, kind="decode")


def setup():
    """(cfg, tcfg, optimizer) of the train cell, live and traced alike."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.modes import QuantConfig
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.train import TrainConfig, make_optimizer
    cfg = get_smoke_config("granite-3-2b")
    tcfg = TrainConfig(quant=QuantConfig(method="lotion", fmt_name="int4",
                                         lam=1e3,
                                         policy=QuantPolicy(min_size=256)))
    return cfg, tcfg, make_optimizer(tcfg, adamw(cosine_with_warmup(
        3e-4, 2, 10)))


def live_counts(mesh) -> dict:
    from repro_torch.data import lm_batch, permutation_table
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import constraints
    from repro_torch.launch import specs
    from repro_torch.models.lm import init_cache, lm_decode, lm_init
    from repro_torch.train import init_state, make_train_step
    cfg, tcfg, opt = setup()
    psh = shd.params_shardings(mesh, specs.params_specs(cfg))
    state = init_state(lm_init(cfg, seed=0, device="cpu", shardings=psh),
                       opt)
    step = make_train_step(cfg, tcfg, opt, grad_shardings=psh)
    b, seq = TRAIN["global_batch"], TRAIN["seq_len"]
    batch = lm_batch(0, 0, b, seq, cfg.vocab,
                     permutation_table(0, cfg.vocab))
    batch = shd.sharded_batch(batch, shd.train_batch_shardings(
        mesh, batch, b))
    collectives.reset_issued()
    step(state, batch)
    out = {"train": collectives.issued()}
    rows = shd.rows_sharding(mesh, cfg, DECODE["global_batch"], 1)
    n = (DECODE["global_batch"] if rows is None
         else shd.local_shape(rows, (DECODE["global_batch"],))[0])
    cache = init_cache(cfg, n, DECODE["seq_len"], device="cpu")
    collectives.reset_issued()
    with torch.inference_mode(), constraints(**shd.serve_roles(psh)):
        lm_decode(state["params"], cfg, cache,
                  torch.zeros((n, 1), dtype=torch.long),
                  torch.zeros(n, dtype=torch.long))
    out["decode"] = collectives.issued()
    return out


def main(argv):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, parse_mesh
    store_path, rank, world, mesh_arg, out_path = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh(*parse_mesh(mesh_arg), "cpu")
    res = live_counts(mesh)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
