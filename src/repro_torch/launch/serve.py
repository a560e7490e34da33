"""Serving launcher of the port (``repro.launch.serve``): random weights
from seed 0, optionally cast RTN or RR (``--weights rtn:int4``,
``rr:int8``, ``rtn:fp4``, ...) and stored as int4/int8 QTensors, or kept
as the dense cast (``--store dense``, and formats without QTensor
storage); RR draws from a generator seeded with 1; then a static prefill
+ decode loop, or an offered-load replay of the continuous-batching
scheduler against the static barrier server (``--scheduler``), or a
seeded chaos replay with the lifecycle audited after every tick
(``--chaos``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --smoke --device cpu --scheduler --paged --prefill-chunk 16 \\
        --prefix-cache --kv-quant int8 --weights rtn:int4 --act-fmt int8

Every config of ``repro_torch.configs.ARCHS`` is served: MoE configs
(``dbrx-132b``, ``moonshot-v1-16b-a3b``) keep their 4-D expert stacks as
the dense cast and refuse ``--prefill-chunk``; ``musicgen-medium``
decodes (b, 1, 4) codebook frames on the static path only; the SSM
configs (``zamba2-2.7b``, ``rwkv6-1.6b``) keep their projections as the
dense cast and refuse ``--paged`` and ``--prefill-chunk`` (``--layers``
must be a multiple of Zamba2's 6-layer unit).

``--mesh DxM`` (or ``PxDxM``) serves on a device mesh of that shape, one
process per rank, by the rules of ``launch/train.py``: under ``torchrun``
the world size must equal the mesh's size, ``--mesh 1x1`` needs no
``torchrun``, NCCL on the card and gloo with ``--device cpu``::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.serve --arch granite-3-2b --smoke \\
        --device cpu --mesh 1x2 --scheduler --paged --prefill-chunk 16 \\
        --prefix-cache --kv-quant int8 --weights rtn:int4 --act-fmt int8

Each rank draws its blocks of the parameters (``lm_init(shardings=)``,
``distributed.sharding.params_shardings``) and casts them on their blocks
(``sharding.quantize_params_on_blocks``: bitwise the blocks of the
one-device cast); the model gathers every leaf where it reads it.  The
static batch is cut over the data axes where it divides (each rank
decodes its rows); the scheduler and the chaos replay run whole on every
rank, which check after every step that they agree.  Only rank 0 prints.

The flags are those of ``repro.launch.serve``, plus ``--layers`` (cut the
depth) and ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions).  There is no ``--use-kernel``: the port always runs its
kernels on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (QuantPolicy, cast_params, get_format,
                              param_nbytes, quantize_params)
from repro_torch.core.formats import IntFormat
from repro_torch.core.qtensor import qtensor_act_fmt
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import constraints
from repro_torch.launch.mesh import close_mesh, make_mesh, parse_mesh
from repro_torch.models.lm import lm_decode, lm_init, lm_prefill


def serving_params(cfg, weights: str, device, *, store: str = "auto",
                   min_size: int = 1024, mesh=None, seed: int = 0):
    """The launcher's parameters: ``lm_init`` from ``seed``, cast as
    ``weights`` says (QTensor storage for int4/int8 unless ``store`` is
    ``"dense"``; RR from a generator seeded with 1).  On ``mesh`` each
    rank draws and casts its blocks.  Returns ``(params, shardings,
    dense_bytes)``: shardings None off a mesh, bytes of the fp32 tree (a
    rank's blocks on a mesh)."""
    shardings = None
    if mesh is None:
        dev = resolve_device(device)
        params = lm_init(cfg, seed=seed, device=dev)
    else:
        from repro_torch.launch import specs
        dev = mesh.device
        shardings = shd.params_shardings(mesh, specs.params_specs(cfg))
        params = lm_init(cfg, seed=seed, device=dev, shardings=shardings)
    dense_bytes = param_nbytes(params)
    if weights == "fp32":
        return params, shardings, dense_bytes
    mode, fmt_name = weights.split(":")
    fmt = get_format(fmt_name)
    policy = QuantPolicy(min_size=min_size)
    store_q = (store == "qtensor"
               or (store == "auto" and isinstance(fmt, IntFormat)
                   and fmt.bits in (4, 8)))
    gen = torch.Generator(device=dev).manual_seed(1)
    if mesh is not None:
        params, shardings = shd.quantize_params_on_blocks(
            params, shardings, fmt, policy, -1, mode=mode, generator=gen,
            store=store_q)
    else:
        convert = quantize_params if store_q else cast_params
        params = convert(params, fmt, policy, -1, mode=mode, generator=gen)
    return params, shardings, dense_bytes


def _cache_len(args) -> int:
    cache_len = args.prompt_len + args.new_tokens
    if args.paged and cache_len % args.block_size:
        # blocks tile the ring axis: round up to a whole block
        cache_len += args.block_size - cache_len % args.block_size
    return cache_len


def _replay(cfg, params, args, dev, kv_quant, stored_bytes, dense_bytes,
            shardings=None, say=print):
    """Offered-load replay: static barrier batching against the
    continuous scheduler at equal slot count (``params`` arrive
    weight-prepared, so the serve configs take them as they are)."""
    from repro_torch.serve import Engine, Scheduler, SchedulerConfig, \
        ServeConfig
    from repro_torch.serve.replay import (compare, poisson_workload,
                                          replay_continuous, replay_static)

    scfg = ServeConfig(weights="fp32", kv_quant=kv_quant,
                       act_fmt=args.act_fmt, max_new_tokens=args.new_tokens)
    engine = Engine(cfg, params, scfg, device=dev, shardings=shardings)
    sch = Scheduler(cfg, params, scfg, SchedulerConfig(
        n_slots=args.n_slots, steps_per_tick=args.steps_per_tick,
        cache_len=_cache_len(args), prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache, paged=args.paged,
        block_size=args.block_size), device=dev, shardings=shardings)
    nt = args.new_tokens
    workload = poisson_workload(
        0, args.n_requests, cfg.vocab, rate=args.arrival_rate,
        prompt_lens=(2, args.prompt_len),
        budgets=tuple(sorted({max(2, nt // 8), max(2, nt // 2), nt})))
    replay_static(engine, workload, args.n_slots)      # warm both
    replay_continuous(sch, workload)
    rec = compare(replay_static(engine, workload, args.n_slots),
                  replay_continuous(sch, workload))
    say(f"offered load: {args.n_requests} reqs @ "
          f"{args.arrival_rate}/s | weights={args.weights} "
          f"kv_quant={kv_quant} act_fmt={args.act_fmt} "
          f"weight_bytes={stored_bytes} "
          f"({stored_bytes / dense_bytes:.2f}x of fp32 dense) | {dev}")
    for name in ("static", "continuous"):
        m = rec[name]
        say(f"{name:>10}: {m['tok_per_s']:8.1f} tok/s | "
              f"p50 {m['latency_p50_s']:.3f}s p95 {m['latency_p95_s']:.3f}s "
              f"| goodput@SLO {m['goodput_tok_per_s']:8.1f} tok/s | "
              f"{m['decode_launches']} launches")
    say(f"continuous/static throughput: {rec['throughput_ratio']:.2f}x "
        f"(outputs identical: {rec['outputs_identical']})")
    live = {k: v for k, v in sch.counters.items() if v}
    say(f"lifecycle counters: {live}")


def _chaos(cfg, params, args, dev, kv_quant, shardings=None, say=print):
    """Seeded chaos replay on a deterministic virtual clock, with the
    lifecycle invariants audited after every tick."""
    from repro_torch.serve import (Scheduler, SchedulerConfig, ServeConfig,
                                   chaos_plan)
    from repro_torch.serve.replay import replay_chaos, sla_workload

    scfg = ServeConfig(weights="fp32", kv_quant=kv_quant,
                       act_fmt=args.act_fmt, max_new_tokens=args.new_tokens)
    cache_len = _cache_len(args)
    sch = Scheduler(cfg, params, scfg, SchedulerConfig(
        n_slots=args.n_slots, steps_per_tick=args.steps_per_tick,
        cache_len=cache_len, prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache, max_queue=4 * args.n_requests,
        est_tok_per_s=200.0, paged=args.paged,
        block_size=args.block_size), device=dev, shardings=shardings)
    wl = sla_workload(args.chaos_seed, args.n_requests, cfg.vocab,
                      rate=args.arrival_rate,
                      prompt_lens=(2, args.prompt_len),
                      budgets=(max(2, args.new_tokens // 2),
                               args.new_tokens))
    plan = chaos_plan(seed=args.chaos_seed, n_ticks=128, vocab=cfg.vocab,
                      cache_len=cache_len)
    say(f"chaos replay: {args.n_requests} reqs + {plan.describe()} | {dev}")
    res = replay_chaos(sch, wl, plan=plan)
    say(f"terminal states: {res['by_state']} in {res['ticks']} ticks")
    say(f"counters: { {k: v for k, v in res['counters'].items() if v} }")
    say(f"deadline hit rate: {res['deadline_hit_rate']:.2f} | "
        f"goodput {res['goodput_tok']} tok | resume splice "
        f"{res['resume_splice_tokens']}/"
        f"{res['resume_splice_tokens'] + res['resume_recompute_tokens']}"
        f" tokens")
    if res["violations"]:
        for v in res["violations"][:20]:
            say(f"  VIOLATION {v}")
        raise SystemExit(f"{len(res['violations'])} invariant violations")
    say("invariants: 0 violations, all requests terminal")
    return res


def _static(cfg, params, args, dev, kv_quant, stored_bytes, dense_bytes,
            shardings=None, say=print):
    """Batched prefill, then ``new_tokens`` greedy decode steps (on a
    mesh: this rank's rows, where the batch is cut)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len) + books,
                         generator=gen, device=dev)
    rows = shd.rows_sharding(shd.mesh_of(shardings), cfg, args.batch,
                             args.prompt_len)
    toks = shd.shard(toks, rows)
    b = toks.shape[0]
    roles = shd.serve_roles(shardings) if shardings is not None else {}
    cache_len = args.prompt_len + args.new_tokens
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with torch.inference_mode(), qtensor_act_fmt(args.act_fmt), \
            constraints(**roles):
        t0 = time.perf_counter()
        logits, cache = lm_prefill(params, cfg, toks, cache_len=cache_len,
                                   kv_quant=kv_quant)
        sync()
        t_prefill = time.perf_counter() - t0
        tok = logits[:, 0].argmax(-1)
        pos = torch.full((b,), args.prompt_len - 1, dtype=torch.int64,
                         device=dev)
        t0 = time.perf_counter()
        for _ in range(args.new_tokens):
            pos = pos + 1
            logits, cache = lm_decode(params, cfg, cache, tok[:, None], pos)
            tok = logits[:, 0].argmax(-1)
        sync()
        t_decode = time.perf_counter() - t0
    n_tok = args.batch * args.new_tokens
    say(f"device={dev} weights={args.weights} kv_quant={kv_quant} "
        f"act_fmt={args.act_fmt} weight_bytes={stored_bytes} "
        f"({stored_bytes / dense_bytes:.2f}x of fp32 dense"
        f"{', per rank' if shardings is not None else ''})")
    say(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill:.3f}s | "
        f"decode: {n_tok} tokens in {t_decode:.3f}s "
        f"({n_tok / t_decode:.1f} tok/s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (a multiple of the "
                         "config's unit), e.g. for MoE configs whose fp32 "
                         "weights do not fit the card")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--mesh", default=None,
                    help="serve on a device mesh, e.g. 1x2 (data x model)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--weights", default="fp32")
    ap.add_argument("--store", choices=("auto", "qtensor", "dense"),
                    default="auto",
                    help="auto: QTensor codes for int formats")
    ap.add_argument("--act-fmt", choices=("int8",), default=None,
                    help="W4A8 serving: row-quantize activations to int8 "
                         "before every quantized weight matmul")
    ap.add_argument("--kv-quant", nargs="?", const="int8", default=None,
                    choices=("int8", "int4"),
                    help="quantized KV cache (bare flag = int8)")
    ap.add_argument("--scheduler", action="store_true",
                    help="continuous-batching offered-load replay "
                         "(vs the static barrier server)")
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--steps-per-tick", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill width: admit long prompts one "
                         "chunk per tick (attention-only patterns)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix KV reuse via the chunk-granular "
                         "radix trie (requires --prefill-chunk)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV: one block pool shared by the decode "
                         "slots and the prefix trie")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per paged-KV pool block (with "
                         "--prefix-cache it must equal --prefill-chunk)")
    ap.add_argument("--n-requests", type=int, default=32)
    ap.add_argument("--arrival-rate", type=float, default=100.0,
                    help="Poisson arrivals per virtual-clock second")
    ap.add_argument("--chaos", action="store_true",
                    help="seeded fault-injection replay with a per-tick "
                         "invariant audit")
    ap.add_argument("--chaos-seed", type=int, default=13)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.n_codebooks > 1 and (args.scheduler or args.chaos):
        ap.error(f"{cfg.name} decodes {cfg.n_codebooks}-codebook frames: "
                 f"the static path only (the request queue holds token "
                 f"lists)")
    mesh = None
    if args.mesh:
        shape, axes = parse_mesh(args.mesh)
        mesh = make_mesh(shape, axes, args.device)
    try:
        return _serve(cfg, args, mesh)
    finally:
        if mesh is not None:
            close_mesh()


def _serve(cfg, args, mesh):
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    params, shardings, dense_bytes = serving_params(
        cfg, args.weights, dev, store=args.store,
        min_size=256 if args.smoke else 1024, mesh=mesh)
    stored_bytes = param_nbytes(params)
    kv_quant = args.kv_quant or False
    if mesh is not None:
        say(f"mesh {mesh.shape} ({mesh.backend}, {dev.type}): each rank "
            f"holds its blocks, {stored_bytes} bytes on rank 0")
    if args.chaos:
        return _chaos(cfg, params, args, dev, kv_quant, shardings, say)
    if args.scheduler:
        return _replay(cfg, params, args, dev, kv_quant, stored_bytes,
                       dense_bytes, shardings, say)
    return _static(cfg, params, args, dev, kv_quant, stored_bytes,
                   dense_bytes, shardings, say)


if __name__ == "__main__":
    main()
