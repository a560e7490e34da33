"""The port's self-healing training (``repro_torch.train``: guard,
``run_loop``'s checkpoints, auto-resume and spike rollback, EF
compression, the chaos harness) on the CPU.

Twins of ``tests/test_train_robustness.py`` and of the single-device
training cases of ``tests/test_distributed_robustness.py`` (the
per-example skip gate, the eval-CE spike monitor, rollback with and
without data reordering, a killed and a straggling simulated host), on
the same tiny model with the port's own weights.  Across packages:
EF compression bitwise against JAX, the same chaos plans, and the spike
monitor's decisions on the same loss stream.  Bitwise claims are bitwise
(``_bits_equal``): a skipped step, auto-resume and the fault-free chaos
replay.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import INT8 as JINT8
from repro.core import cast_rtn as j_cast_rtn
from repro.train import SpikeMonitor as JSpikeMonitor
from repro.train.compress import ef_compress as j_ef_compress
from repro.train.compress import wire_bytes as j_wire_bytes
from repro.train.faults import chaos_train_plan as j_chaos_train_plan
from repro_torch import bridge
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import DataPipeline, lm_batch, permutation_table
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.lm import LMConfig, lm_init
from repro_torch.optim import adamw, constant
from repro_torch.train import (InjectedCrash, NonFiniteBudgetError,
                               RollbackBudgetError, SpikeMonitor,
                               TrainConfig, init_state, make_optimizer,
                               make_train_step, run_loop)
from repro_torch.train import faults as tfaults
from repro_torch.train.compress import ef_compress, wire_bytes
from repro_torch.train.loop import make_loss_fn

CFG = LMConfig(name="rb", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
               d_ff=64, vocab=32, dtype="float32", remat=False)
PERM = permutation_table(0, CFG.vocab)
_QUIET = {"log_every": 0, "log": lambda *a, **k: None}


def _batch(step, poison=1.0):
    b = dict(lm_batch(0, step, 4, 16, CFG.vocab, PERM))
    b["poison"] = torch.tensor(poison, dtype=torch.float32)
    return b


def _tcfg(ef=False):
    return TrainConfig(
        quant=QuantConfig(method="lotion", fmt_name="int4", lam=1e3,
                          policy=QuantPolicy(min_size=64)),
        clip_norm=1.0, ef_compress=ef)


def _build(fused=True, ef=False, loss_fn=None):
    """(step, state): the fused core, or the unfused chain (with EF
    compression when ``ef``)."""
    tcfg = _tcfg(ef)
    base = adamw(constant(1e-2))
    if not fused and not ef:
        from repro_torch.optim import chain, clip_global_norm, \
            lotion_decoupled
        base = chain(clip_global_norm(1.0),
                     lotion_decoupled("int4", 1e3,
                                      policy=QuantPolicy(min_size=64)),
                     base.transform)
    opt = make_optimizer(tcfg, base)
    assert opt.applies_updates == (fused and not ef)
    step = make_train_step(CFG, tcfg, opt,
                           loss_fn=loss_fn or tfaults.chaos_loss_fn(CFG,
                                                                    tcfg))
    state = init_state(lm_init(CFG, seed=0, device="cpu"), opt)
    return step, state


def _leaves(tree):
    return [v for _, v in ckpt_io._paths_and_leaves(tree)]


def _snapshot(tree):
    return [x.clone() for x in _leaves(tree)]


def _bits_equal(a, b):
    la = a if isinstance(a, list) else _leaves(a)
    lb = b if isinstance(b, list) else _leaves(b)
    assert len(la) == len(lb)
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.numpy().tobytes() == y.numpy().tobytes()
               for x, y in zip(la, lb))


def _core(state):
    return {"params": state["params"], "opt": state["opt"],
            "step": state["step"]}


# ------------------------------------------------------------------ guard

@pytest.mark.parametrize("poison", [float("nan"), float("inf")])
@pytest.mark.parametrize("fused", [False, True])
def test_nonfinite_step_applies_no_update(fused, poison):
    """A poisoned batch advances ``step`` but leaves params and the whole
    optimizer state bitwise unchanged, flags ``skipped``, and the clean
    replay is bitwise the run that never saw it — for the unfused chain
    (``torch.where``) and the fused core (the ``opt_step`` ok gate)."""
    step, st0 = _build(fused=fused)
    ref, _ = step(init_state(lm_init(CFG, seed=0, device="cpu"),
                             step.optimizer), _batch(0))
    ref, m_ref = step(ref, _batch(1))
    assert not bool(m_ref["skipped"])

    st, _ = step(st0, _batch(0))
    frozen = _snapshot({"params": st["params"], "opt": st["opt"]})
    st, m = step(st, _batch(1, poison=poison))
    assert bool(m["skipped"])
    assert not math.isfinite(float(m["loss"]))
    assert _bits_equal(frozen, {"params": st["params"], "opt": st["opt"]})
    assert int(st["step"]) == 2
    st, _ = step(st, _batch(1))
    assert _bits_equal({"params": ref["params"], "opt": ref["opt"]},
                       {"params": st["params"], "opt": st["opt"]})


def test_skip_budget_aborts_with_diagnostics():
    step, st = _build()
    pipe = DataPipeline(lambda s: _batch(s, poison=float("nan")), prefetch=0)
    with pytest.raises(NonFiniteBudgetError) as ei:
        run_loop(step, st, pipe, 10, max_skips=2, **_QUIET)
    assert ei.value.diagnostics["skipped"] == 3
    assert not math.isfinite(ei.value.diagnostics["loss"])
    pipe.close()


def _gate_loss_fn(tcfg):
    """Finite loss, per-example gate poisoned through the batch."""
    base = make_loss_fn(CFG, tcfg)

    def loss_fn(params, batch, fisher, **kw):
        loss, aux = base(params, batch, fisher, **kw)
        aux = dict(aux)
        aux["ce_ex"] = aux["ce_ex"] * batch["gate_poison"]
        return loss, aux

    return loss_fn


@pytest.mark.parametrize("fused", [False, True])
def test_ce_ex_gate_skips_even_when_loss_is_finite(fused):
    step, st0 = _build(fused=fused, loss_fn=_gate_loss_fn(_tcfg()))
    clean = torch.ones(4)
    poisoned = clean.clone()
    poisoned[1] = float("nan")
    b0, b1 = _batch(0), _batch(1)
    b0["gate_poison"] = clean
    st, _ = step(st0, b0)
    frozen = _snapshot({"params": st["params"], "opt": st["opt"]})
    b1["gate_poison"] = poisoned
    st, m = step(st, b1)
    assert bool(m["skipped"]) and math.isfinite(float(m["loss"]))
    assert _bits_equal(frozen, {"params": st["params"], "opt": st["opt"]})
    assert int(st["step"]) == 2
    b1["gate_poison"] = clean
    st, m = step(st, b1)
    assert not bool(m["skipped"])
    assert not _bits_equal(frozen, {"params": st["params"],
                                    "opt": st["opt"]})


def test_custom_loss_without_ce_ex_degrades_to_loss_gate():
    def loss_fn(params, batch, fisher, **kw):
        loss = sum(torch.sum(x * x) for x in _leaves(params)) * 1e-6
        return loss, {"ce": loss.detach()}

    step, st = _build(loss_fn=loss_fn)
    st, m = step(st, _batch(0))
    assert not bool(m["skipped"]) and math.isfinite(float(m["loss"]))


# ---------------------------------------------------------- spike monitor

def test_spike_monitor_detects_sustained_spike_only():
    mon = SpikeMonitor(zscore=6.0, ema=0.9, patience=2, warmup=4)
    for _ in range(6):
        assert not mon.observe(2.0)
    assert not mon.observe(float("nan"))
    assert not mon.observe(200.0)
    assert mon.hot
    assert mon.observe(200.0)
    mon.reset()
    assert not mon.hot
    for _ in range(6):
        mon.observe(2.0)
    assert not mon.observe(200.0)
    assert not mon.observe(2.0)
    assert not mon.hot


def test_spike_monitor_decides_as_jax_does():
    """The same loss stream through both monitors: the same decisions,
    z-values and hot flags at every sample."""
    rng = np.random.default_rng(3)
    xs = list(2.0 + 0.05 * rng.standard_normal(40))
    xs[12:14] = [40.0, 41.0]
    xs[20] = float("inf")
    xs[30:33] = [9.0, 9.5, 3.0]
    a, b = SpikeMonitor(6.0, 0.9, 2, 4), JSpikeMonitor(6.0, 0.9, 2, 4)
    for x in xs:
        assert a.observe(x) == b.observe(x)
        assert a.hot == b.hot and a.zvalue(2.5) == b.zvalue(2.5)


def _run(tmp_path, fn, steps=12, **kw):
    step, st = _build()
    pipe = DataPipeline(fn, prefetch=0)
    try:
        return run_loop(step, st, pipe, steps, ckpt_dir=str(tmp_path),
                        ckpt_every=2, **kw, **_QUIET)
    finally:
        pipe.close()


def _fetch_keyed(bad, scale=1e4):
    fetches = {"n": 0}

    def fn(s):
        i = fetches["n"]
        fetches["n"] += 1
        return _batch(s, poison=scale if i in bad else 1.0)

    return fn


def test_spike_rollback_recovers_and_restores_lr(tmp_path):
    out = _run(tmp_path, _fetch_keyed((6, 7)), spike_zscore=6.0,
               spike_warmup=4, spike_patience=2, backoff_scale=0.5,
               cooldown_steps=3)
    assert out["rollbacks"] == 1
    assert int(out["state"]["step"]) == 12
    assert float(out["state"]["lr_scale"]) == 1.0
    assert all(torch.isfinite(x).all() for x in
               _leaves(out["state"]["params"]))


def test_spike_without_checkpoint_dir_is_rejected():
    step, st = _build()
    pipe = DataPipeline(lambda s: _batch(s), prefetch=0)
    with pytest.raises(ValueError, match="needs ckpt_dir"):
        run_loop(step, st, pipe, 2, spike_zscore=6.0, **_QUIET)
    pipe.close()


def test_rollback_budget_is_enforced(tmp_path):
    """Two of every eight fetches blow the loss up, each pair after a
    calm warmup: the loop rolls back until its budget is spent, then
    raises with the counters."""
    fn = _fetch_keyed({i for i in range(200) if i % 8 in (6, 7)})
    with pytest.raises(RollbackBudgetError) as ei:
        _run(tmp_path, fn, steps=40, spike_zscore=6.0, spike_warmup=4,
             spike_patience=2, max_rollbacks=2)
    assert ei.value.diagnostics["rollbacks"] == 3


def test_eval_ce_spike_triggers_coordinated_rollback(tmp_path):
    calls = {"n": 0}

    def eval_hook(state):
        calls["n"] += 1
        return {"ce": 200.0 if calls["n"] == 6 else 2.0}

    out = _run(tmp_path, lambda s: _batch(s), steps=16, eval_every=2,
               eval_hook=eval_hook, eval_spike_zscore=6.0,
               eval_spike_warmup=4, eval_spike_patience=1, cooldown_steps=3)
    assert out["eval_rollbacks"] == 1 and out["rollbacks"] == 0
    assert out["data_windows_skipped"] == 1
    assert int(out["state"]["step"]) == 16
    assert float(out["state"]["lr_scale"]) == 1.0


def test_eval_monitor_requires_eval_hook(tmp_path):
    step, st = _build()
    pipe = DataPipeline(lambda s: _batch(s), prefetch=0)
    with pytest.raises(ValueError, match="eval_every and eval_hook"):
        run_loop(step, st, pipe, 2, ckpt_dir=str(tmp_path),
                 eval_spike_zscore=6.0, **_QUIET)
    pipe.close()


@pytest.mark.parametrize("reorder", [True, False])
def test_rollback_reorder(tmp_path, reorder):
    """With reordering, step-keyed poison is served once (the rollback
    seeks past the window); without it, a fetch-keyed (transient) spike
    is replayed clean and no window is skipped."""
    served = []

    def step_keyed(s):
        served.append(s)
        return _batch(s, poison=1e4 if s in (6, 7) else 1.0)

    fn = step_keyed if reorder else _fetch_keyed((6, 7))
    out = _run(tmp_path, fn, spike_zscore=6.0, spike_warmup=4,
               spike_patience=2, cooldown_steps=3, rollback_reorder=reorder)
    assert out["rollbacks"] == 1
    assert out["data_windows_skipped"] == (1 if reorder else 0)
    assert int(out["state"]["step"]) == 12
    if reorder:
        assert served.count(6) == 1 and served.count(7) == 1


# ------------------------------------------------------- crash-exact resume

@pytest.mark.parametrize("variant", ["chain", "fused", "ef"])
def test_auto_resume_is_bit_exact(variant, tmp_path):
    """N steps straight ≡ k steps + hard kill + fresh-state auto-resume
    + N-k steps, bit for bit, for the unfused chain, the fused core and
    the EF-compressed chain (the error feedback inside the state)."""
    kw = dict(fused=variant == "fused", ef=variant == "ef")
    step, st = _build(**kw)
    pipe = DataPipeline(lambda s: _batch(s), prefetch=0)
    ref = run_loop(step, st, pipe, 6, **_QUIET)["state"]
    pipe.close()

    calls = {"n": 0}

    def crash_hook(state, metrics):
        i = calls["n"]
        calls["n"] += 1
        if i == 3:                       # after step 4, before its save
            raise InjectedCrash("kill")

    pipe = DataPipeline(lambda s: _batch(s), prefetch=0)
    with pytest.raises(InjectedCrash):
        run_loop(step, _build(**kw)[1], pipe, 6, ckpt_dir=str(tmp_path),
                 ckpt_every=2, auto_resume=True, step_hook=crash_hook,
                 **_QUIET)
    pipe.close()
    pipe = DataPipeline(lambda s: _batch(s), prefetch=0)
    out = run_loop(step, _build(**kw)[1], pipe, 6, ckpt_dir=str(tmp_path),
                   ckpt_every=2, auto_resume=True, **_QUIET)
    pipe.close()
    assert out["resumed_from"] == 2
    assert _bits_equal(_core(ref), _core(out["state"]))


def test_run_loop_reads_the_host_once_per_step(monkeypatch):
    """The loss and the skip flag reach the host in one read: a step
    that hands back device tensors is read through one ``tolist``."""
    step, st = _build()
    reads = {"n": 0}
    real = torch.Tensor.tolist

    def counting(self):
        reads["n"] += 1
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    pipe = DataPipeline(lambda s: _batch(s), prefetch=0)
    run_loop(step, st, pipe, 3, **_QUIET)
    pipe.close()
    assert reads["n"] == 3


# ------------------------------------------------------------ EF compression

def test_ef_compress_matches_jax_bitwise():
    """One compression of a gradient tree with a carried error: the
    compressed gradients and the new error bitwise equal to JAX's, and
    the wire bytes equal (block 256 over leaves that are not multiples
    of it, and block 16)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (40, 24), "b": {"c": (7,), "d": (3, 5, 33)}}

    def tree(scale):
        def make(s):
            return (rng.standard_normal(s) * scale).astype(np.float32)
        return {"a": make(shapes["a"]),
                "b": {"c": make(shapes["b"]["c"]),
                      "d": make(shapes["b"]["d"])}}

    g, e = tree(1.0), tree(0.01)
    for block in (256, 16):
        jq, je = j_ef_compress(jax.tree.map(jnp.asarray, g),
                               jax.tree.map(jnp.asarray, e), block)
        tq, te = ef_compress(bridge.to_torch(g), bridge.to_torch(e), block)
        for jt, tt in ((jq, tq), (je, te)):
            for k, v in bridge.flatten(tt).items():
                want = np.asarray(bridge.flatten(
                    jax.tree.map(np.asarray, jt))[k])
                assert v.numpy().tobytes() == want.tobytes(), (block, k)
        assert wire_bytes(bridge.to_torch(g), block) == j_wire_bytes(
            jax.tree.map(jnp.asarray, g), block)
    # the cast itself is JAX's blockwise int8 RTN
    x = jnp.asarray(g["a"])
    np.testing.assert_array_equal(
        np.asarray(j_cast_rtn(x, JINT8, 256)),
        ef_compress({"x": torch.from_numpy(g["a"])},
                    {"x": torch.zeros(40, 24)}, 256)[0]["x"].numpy())


def test_ef_step_runs_the_unfused_chain_with_one_cast_per_leaf():
    """EF keeps the unfused chain (clip -> ef -> lotion -> AdamW); on the
    CPU the casts take the plain version and count no launch, and a
    pre-built fused core refuses EF."""
    step, st = _build(fused=False, ef=True)
    tags = [t.tag for t in step.optimizer.links]
    assert tags[1:3] == ["ef_compress", "lotion_decoupled"]
    reset_launch_counts()
    st, m = step(st, _batch(0))
    assert not bool(m["skipped"])
    assert set(launch_counts().values()) == {0}
    err = st["opt"][1]["err"]
    assert any(float(x.abs().max()) > 0 for x in _leaves(err))
    fused = make_optimizer(_tcfg(), adamw(constant(1e-2)))
    with pytest.raises(ValueError, match="EF compression cannot be fused"):
        make_optimizer(_tcfg(ef=True), fused)


# --------------------------------------------------------------- chaos

def test_chaos_plans_are_jax_plans():
    for kw in ({}, dict(spike_at=24, spike_len=3, n_crashes=1),
               dict(n_hosts=2, host_kill_at=2, straggle_at=3,
                    corrupt_mode=("bitflip", 1), torn_manifest_save=4)):
        a, b = tfaults.chaos_train_plan(1, n_steps=18, **kw), \
            j_chaos_train_plan(1, n_steps=18, **kw)
        assert {f: getattr(a, f) for f in vars(a)} == \
            {f: getattr(b, f) for f in vars(b)}


def test_chaos_run_passes_all_audits(tmp_path):
    step, _ = _build()
    plan = tfaults.chaos_train_plan(1, n_steps=18, spike_at=24,
                                    spike_len=3, n_crashes=1)
    s = tfaults.run_chaos(step, lambda: _build()[1], _batch, plan, 18,
                          str(tmp_path), spike_warmup=4)
    assert s["violations"] == []
    assert s["result"] is not None and math.isfinite(s["final_loss"])
    assert s["skipped"] >= 1 and s["rollbacks"] >= 1
    assert s["resumes"] >= 1 and s["quarantined"] >= 1
    assert s["crashes"] >= 2


def test_fault_free_chaos_is_bit_identical_to_plain_run(tmp_path):
    step, st = _build()
    pipe = DataPipeline(lambda s: _batch(s), prefetch=0)
    plain = run_loop(step, st, pipe, 8, **_QUIET)["state"]
    pipe.close()
    s = tfaults.run_chaos(step, lambda: _build()[1], _batch, None, 8,
                          str(tmp_path), ckpt_every=3)
    assert s["violations"] == []
    assert s["segments"] == 1 and s["crashes"] == 0
    assert _bits_equal(_core(plain), _core(s["state"]))


def test_chaos_loss_fn_rejects_microbatching():
    with pytest.raises(ValueError, match="n_microbatches=1"):
        tfaults.chaos_loss_fn(CFG, TrainConfig(n_microbatches=2))


def test_poison_one_is_a_bitwise_identity():
    """The chaos loss with poison 1.0 gives the plain loss's bits, and so
    the same gradients."""
    tcfg = _tcfg()
    params = lm_init(CFG, seed=0, device="cpu")
    fisher = {k: v for k, v in params.items()}
    plain, _ = make_loss_fn(CFG, tcfg)(params, _batch(0), fisher)
    chaos, _ = tfaults.chaos_loss_fn(CFG, tcfg)(params, _batch(0), fisher)
    assert plain.numpy().tobytes() == chaos.numpy().tobytes()


@pytest.mark.parametrize("hosts", [2, 3])
def test_host_kill_and_straggler_surface_as_timeouts_and_heal(tmp_path,
                                                              hosts):
    """A killed peer (two hosts) or a straggler past the deadline (three)
    surfaces as a CoordinatorTimeout at the next heartbeat; the
    supervisor restarts with a replacement and the run completes."""
    step, _ = _build()
    kw = (dict(host_kill_at=4) if hosts == 2 else dict(straggle_at=5))
    plan = tfaults.chaos_train_plan(5, n_steps=10, nan_rate=0.0,
                                    stall_rate=0.0, n_crashes=0,
                                    ckpt_crash_save=None,
                                    corrupt_save=None, spike_at=10 ** 6,
                                    n_hosts=hosts, **kw)
    s = tfaults.run_chaos(step, lambda: _build()[1], _batch, plan, 10,
                          str(tmp_path), n_hosts=hosts)
    assert s["violations"] == []
    if hosts == 2:
        assert s["host_kill_timeouts"] == 1 and s["resumes"] >= 1
    else:
        assert s["straggler_timeouts"] == 1
    assert s["divergence_checks"] >= 1
    assert s["result"] is not None and math.isfinite(s["final_loss"])


def test_launcher_chaos_fires_every_tier_with_two_hosts(tmp_path):
    """The launcher's two-host plan on sharded saves: zero violations,
    every tier fired (skip, rollback, quarantine, resume, host kill,
    straggler)."""
    from repro_torch.launch.train import chaos_ok, chaos_plan
    step, _ = _build()
    s = tfaults.run_chaos(step, lambda: _build()[1], _batch,
                          chaos_plan(1, 18, 2), 18, str(tmp_path),
                          n_hosts=2, ckpt_shards=2)
    assert chaos_ok(s, 2), s["violations"]
    assert s["skipped"] >= 1 and s["resumes"] >= 1


# ------------------------------------------------------------- pipeline

def test_prefetch_worker_death_propagates_and_recovers():
    def fn(s):
        if s == 3:
            raise RuntimeError("generator died at step 3")
        return {"x": torch.full((2,), float(s))}

    pipe = DataPipeline(fn, prefetch=2)
    for s in range(3):
        assert float(next(pipe)["x"][0]) == s
    with pytest.raises(RuntimeError, match="step 3"):
        next(pipe)
    pipe.seek(0)
    assert float(next(pipe)["x"][0]) == 0
    pipe.close()


# ------------------------------------------------------------- launchers

def test_launcher_resumes_and_refuses_mesh(tmp_path, capsys):
    from repro_torch.launch import train as launch
    argv = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    first = launch.main(argv)
    assert first["resumed_from"] is None
    again = launch.main(argv[:-4] + ["--steps", "6", "--ckpt-dir",
                                     str(tmp_path)])
    assert again["resumed_from"] == 4 and int(again["state"]["step"]) == 6
    # a mesh of two ranks needs two processes (torchrun): refused in one
    with pytest.raises(ValueError, match="torchrun"):
        launch.main(argv + ["--mesh", "1x2"])
    with pytest.raises(SystemExit) as ei:
        launch.main(argv[:-1] + [str(tmp_path / "chaos"), "--chaos",
                                 "--steps", "12"])
    assert ei.value.code == 0
