"""The port's continuous-batching ``Scheduler`` against the JAX package's
on the CPU, on the same request streams: ring and paged KV, monolithic
and chunked admission, the prefix trie, dense/int8/int4 KV, dense and
int8 activations.  Greedy tokens, tick and prefill counts, the stall log
and every counter must be identical; so must the preemption re-attach,
the typed pool-exhaustion rejection and a seeded chaos replay (terminal
states, counters, zero invariant violations).

Weights come from the JAX ``lm_init`` through ``bridge``.  The port
retries a quarantined request on its static ``Engine`` where JAX uses an
engine with its jnp path; on the CPU both give the static engine's
greedy tokens.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import lm as jlm
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeConfig as JServeConfig
from repro.serve import chaos_plan as jchaos_plan
from repro.serve.replay import replay_chaos as jreplay_chaos
from repro_torch import bridge
from repro_torch.serve import (REJECTED, Scheduler, SchedulerConfig,
                               ServeConfig, chaos_plan, check_drained)
from repro_torch.serve.replay import (replay_chaos, shared_prefix_workload,
                                      sla_workload)

CFG = jlm.LMConfig(name="sc", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=64, dtype=jnp.float32, remat=False)


@functools.lru_cache(maxsize=None)
def _model():
    jparams = jlm.lm_init(jax.random.PRNGKey(0), CFG)
    return jparams, bridge.to_torch(jax.tree.map(np.asarray, jparams)), \
        bridge.lm_config(CFG)


def _pair(scfg: dict, sched: dict):
    jparams, tparams, tcfg = _model()
    j = JScheduler(CFG, jparams, JServeConfig(**scfg),
                   JSchedulerConfig(**sched))
    t = Scheduler(tcfg, tparams, ServeConfig(**scfg), SchedulerConfig(**sched),
                  device="cpu")
    return j, t


def _record(s, rids):
    return dict(out=[s.requests[r].out for r in rids],
                states=[s.requests[r].state for r in rids],
                reasons=[s.requests[r].finish_reason for r in rids],
                ticks=[s.requests[r].ticks for r in rids],
                n_ticks=s.n_ticks, n_prefills=s.n_prefills,
                stall_log=list(s.stall_log), counters=dict(s.counters),
                computed=s.prefill_tokens_computed,
                skipped=s.prefill_tokens_skipped,
                shared=s.prefix_blocks_shared,
                splices=s.splice_host_transfers,
                resume=(s.resume_splice_tokens, s.resume_recompute_tokens))


def _stream():
    """Chat-shaped: a 12-token system prompt shared by most requests,
    short tails, a long straggler every sixth request, mixed budgets."""
    return shared_prefix_workload(0, 9, CFG.vocab, sys_len=12, tail_lens=(2, 7),
                                  straggler_len=20, budgets=(2, 5, 8))


MODES = {
    "mono": dict(),
    "chunked": dict(prefill_chunk=4),
    "prefix": dict(prefill_chunk=4, prefix_cache=True,
                   prefix_cache_blocks=16),
}
# (paged, admission, kv_quant, act_fmt, weights)
CASES = [
    (False, "mono", False, None, "fp32"),
    (False, "chunked", "int8", "int8", "rtn:int4"),
    (False, "prefix", "int4", None, "rtn:int8"),
    (False, "prefix", False, "int8", "rtn:int4"),
    (True, "mono", "int4", "int8", "rtn:int4"),
    (True, "chunked", False, "int8", "rtn:int8"),
    (True, "prefix", "int8", "int8", "rtn:int4"),
    (True, "prefix", "int4", None, "rtn:int4"),
    (True, "prefix", False, None, "fp32"),
]


@pytest.mark.parametrize("paged,mode,kv_quant,act_fmt,weights", CASES)
def test_scheduler_matches_jax(paged, mode, kv_quant, act_fmt, weights):
    sched = dict(n_slots=3, steps_per_tick=3, cache_len=32, **MODES[mode])
    if paged:
        sched.update(paged=True, block_size=4)
    scfg = dict(weights=weights, kv_quant=kv_quant, act_fmt=act_fmt,
                max_new_tokens=8)
    j, t = _pair(scfg, sched)
    recs = []
    for s in (j, t):
        rids = [s.submit(w.prompt, w.max_new_tokens) for w in _stream()]
        s.run()
        recs.append(_record(s, rids))
    assert recs[1] == recs[0]
    assert check_drained(t) == []
    if paged:
        assert t.splice_host_transfers == 0
        if mode == "prefix":
            assert t.prefix_blocks_shared > 0


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_paged_reattach_after_preemption_matches_jax(kv_quant):
    """A preempted DECODING victim keeps its blocks and resumes by table
    re-attach: its tokens equal the never-preempted run's and JAX's, with
    nothing recomputed."""
    scfg = dict(kv_quant=kv_quant, max_new_tokens=10)
    sched = dict(n_slots=1, steps_per_tick=2, cache_len=32, paged=True,
                 block_size=8, pool_blocks=9)
    rng = np.random.default_rng(7)
    lo = [int(x) for x in rng.integers(1, CFG.vocab, 8)]
    hi = [int(x) for x in rng.integers(1, CFG.vocab, 4)]
    recs = []
    for s in _pair(scfg, sched):
        r1 = s.submit(lo, 10, priority=0)
        for _ in range(2):
            s.step()
        r2 = s.submit(hi, 4, priority=5)
        s.run()
        recs.append(_record(s, [r1, r2]))
        assert s.counters["preempted"] == 1
        assert s.resume_recompute_tokens == 0
        assert s.resume_splice_tokens >= len(lo)
    assert recs[1] == recs[0]
    _, _, tcfg = _model()
    alone = Scheduler(tcfg, _model()[1], ServeConfig(**scfg),
                      SchedulerConfig(**sched), device="cpu")
    assert alone.generate([lo], 10)[0] == recs[1]["out"][0]


@pytest.mark.parametrize("chunked", [False, True])
def test_preemption_resume_by_recompute_matches_jax(chunked):
    """Ring mode: a preempted victim re-prefills ``prompt + out[:-1]``
    (through trie splices when chunked with the prefix cache)."""
    sched = dict(n_slots=1, steps_per_tick=2, cache_len=32)
    if chunked:
        sched.update(prefill_chunk=4, prefix_cache=True)
    recs = []
    for s in _pair(dict(max_new_tokens=8), sched):
        r1 = s.submit(list(range(1, 10)), 8, priority=0)
        for _ in range(4 if chunked else 2):
            s.step()
        r2 = s.submit([5, 6, 7], 3, priority=2)
        s.run()
        recs.append(_record(s, [r1, r2]))
        assert s.counters["preempted"] == s.counters["resumed"] == 1
    assert recs[1] == recs[0]


def test_pool_exhaustion_is_a_typed_rejection_like_jax():
    scfg = dict(max_new_tokens=4)
    sched = dict(n_slots=1, steps_per_tick=2, cache_len=32, paged=True,
                 block_size=8)
    recs = []
    for s in _pair(scfg, sched):
        held = s.block_pool.alloc(s.block_pool.n_free)
        rid = s.submit([1, 2, 3], 4)
        while s.has_work():
            s.step()
        assert s.requests[rid].state == REJECTED
        assert s.requests[rid].finish_reason == "pool_exhausted"
        for bid in held:
            s.block_pool.unref(bid)
        rid2 = s.submit([1, 2, 3], 4)
        s.run()
        recs.append(_record(s, [rid, rid2]))
    assert recs[1] == recs[0]
    assert len(recs[1]["out"][1]) == 4


@pytest.mark.parametrize("est,slack,n,rate,events", [
    (400.0, (0.02, 0.3), 14, 80.0,
     ("deadline_queued", "deadline_decode", "slo_shed", "queue_full")),
    (300.0, (0.05, 0.4), 16, 100.0, ("deadline_prefill", "slo_shed"))])
def test_deadlines_priorities_and_shedding_match_jax(est, slack, n, rate,
                                                     events):
    """Deadlined and prioritized requests on a virtual clock: timeouts in
    the queue, mid-prefill and mid-decode, preemptions, SLO sheds and
    queue-full rejections land on the same requests as in JAX."""
    sched = dict(n_slots=2, steps_per_tick=2, cache_len=32, prefill_chunk=4,
                 prefix_cache=True, paged=True, block_size=4, max_queue=6,
                 est_tok_per_s=est)
    wl = sla_workload(11, n, CFG.vocab, rate=rate, prompt_lens=(2, 12),
                      budgets=(2, 4, 8), deadline_frac=0.6, slack=slack,
                      hi_priority_frac=0.4)
    recs = []
    for s in _pair(dict(max_new_tokens=8, kv_quant="int8"), sched):
        rids, now, i = [], 0.0, 0
        while i < len(wl) or s.has_work():
            while i < len(wl) and wl[i].arrival <= now:
                w = wl[i]
                rids.append(s.submit(w.prompt, w.max_new_tokens,
                                     arrival=w.arrival, deadline=w.deadline,
                                     priority=w.priority, strict=False))
                i += 1
            s.step(now=now)
            now += 0.03
        recs.append(_record(s, rids))
        assert check_drained(s) == []
    assert recs[1] == recs[0]
    assert set(events) <= set(recs[1]["reasons"])


def _parting(scfg: dict, prompt, want, got, cache_len: int):
    """Where the port's tokens ``got`` part from JAX's ``want`` for one
    request, replay it on both sides (prefill, then decode fed JAX's
    tokens) and return (step, JAX's top-2 logit gap there, the largest
    JAX-against-port logit difference up to there)."""
    from repro.core.qtensor import qtensor_act_fmt as jact
    from repro.serve.engine import prepare_params as jprep
    from repro_torch.core.qtensor import qtensor_act_fmt as tact
    from repro_torch.models import lm as tlm
    from repro_torch.serve.engine import prepare_params as tprep
    import torch
    jparams, tparams, tcfg = _model()
    jp = jprep(jparams, JServeConfig(**scfg))
    tp = tprep(tparams, ServeConfig(**scfg), "cpu")
    t = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    kv, act = scfg.get("kv_quant", False), scfg.get("act_fmt")
    with jact(act):
        jl, jc = jlm.lm_prefill(jp, CFG, jnp.asarray([prompt]),
                                cache_len=cache_len, kv_quant=kv)
    with tact(act), torch.no_grad():
        tl, tc = tlm.lm_prefill(tp, tcfg, torch.tensor([prompt]),
                                cache_len=cache_len, kv_quant=kv)
    diff = 0.0
    for step in range(t + 1):
        diff = max(diff, float(np.abs(np.asarray(jl) - tl.numpy()).max()))
        if step == t:
            break
        pos = len(prompt) + step
        with jact(act):
            jl, jc = jlm.lm_decode(jp, CFG, jc, jnp.asarray([[want[step]]]),
                                   jnp.asarray([pos]))
        with tact(act), torch.no_grad():
            tl, tc = tlm.lm_decode(tp, tcfg, tc, torch.tensor([[want[step]]]),
                                   torch.tensor([pos]))
    top2 = np.sort(np.asarray(jl[0, 0]))[-2:]
    return t, float(top2[1] - top2[0]), diff


@pytest.mark.parametrize("paged,kv_quant,act_fmt", [
    (True, False, None), (True, "int8", "int8"), (False, "int4", "int8")])
def test_chaos_replay_matches_jax(paged, kv_quant, act_fmt):
    """Seeded fault replay (NaN slots and their retries, stragglers,
    trie eviction storms, malformed and burst submissions): identical
    terminal states, outputs and counters, no invariant violation."""
    sched = dict(n_slots=2, steps_per_tick=2, cache_len=32, prefill_chunk=8,
                 prefix_cache=True, prefix_cache_blocks=16, max_queue=8,
                 est_tok_per_s=200.0)
    if paged:
        sched.update(paged=True, block_size=8)
    scfg = dict(weights="rtn:int4", kv_quant=kv_quant, act_fmt=act_fmt,
                max_new_tokens=6)
    wl = sla_workload(3, 10, CFG.vocab, rate=60.0, prompt_lens=(2, 12),
                      deadline_frac=0.4, slack=(2.0, 10.0),
                      hi_priority_frac=0.3)
    plan_kw = dict(seed=3, n_ticks=64, vocab=CFG.vocab, cache_len=32,
                   nan_rate=0.2)
    j, t = _pair(scfg, sched)
    want = jreplay_chaos(j, wl, plan=jchaos_plan(**plan_kw), tick_s=0.05)
    got = replay_chaos(t, wl, plan=chaos_plan(**plan_kw), tick_s=0.05)
    assert got["violations"] == want["violations"] == []
    for key in ("by_state", "counters", "ticks", "deadline_hit_rate",
                "goodput_tok", "resume_splice_tokens",
                "resume_recompute_tokens"):
        assert got[key] == want[key], key
    assert [(r.state, r.finish_reason, len(r.out), r.ticks, r.preemptions,
             r.nan_retries) for r in t.requests.values()] == \
        [(r.state, r.finish_reason, len(r.out), r.ticks, r.preemptions,
          r.nan_retries) for r in j.requests.values()]
    assert got["counters"]["nan_retries"] > 0
    # greedy tokens: identical, except where int8 activations and int4 KV
    # turn a last-bit difference into a parting at a near tie of JAX's
    # own logits (checked by replaying the request on both sides)
    assert got["outputs"].keys() == want["outputs"].keys()
    for i, out in got["outputs"].items():
        if out != want["outputs"][i]:
            assert (act_fmt, kv_quant) == ("int8", "int4"), i
            step, gap, diff = _parting(scfg, wl[i].prompt, want["outputs"][i],
                                       out, sched["cache_len"])
            assert gap < diff, (i, step, gap, diff)


def test_scheduler_refuses_what_jax_refuses():
    _, tparams, tcfg = _model()
    bad = [dict(prefill_chunk=0), dict(prefix_cache=True),
           dict(paged=True, block_size=5),
           dict(paged=True, block_size=4, prefill_chunk=8,
                prefix_cache=True),
           dict(paged=True, block_size=8, pool_blocks=3)]
    for kw in bad:
        with pytest.raises(ValueError):
            Scheduler(tcfg, tparams, ServeConfig(),
                      SchedulerConfig(cache_len=32, **kw), device="cpu")
    local = dataclasses.replace(tcfg, pattern=("local",), window=8)
    with pytest.raises(ValueError, match="ring"):
        Scheduler(local, tparams, ServeConfig(), SchedulerConfig(
            cache_len=32, paged=True, block_size=8), device="cpu")
    with pytest.raises(ValueError, match="act_fmt"):
        Scheduler(tcfg, tparams, ServeConfig(act_fmt="fp8"),
                  SchedulerConfig(), device="cpu")
