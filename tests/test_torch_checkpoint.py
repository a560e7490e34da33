"""The port's checkpoint layer (``repro_torch.checkpoint``), its
coordinator and audit (``repro_torch.distributed``) against the JAX
package on the CPU.

Twins of ``tests/test_checkpoint.py`` and of the single-device cases of
``tests/test_distributed_robustness.py`` (coordinator rounds, sharded
saves, stage order, mid-write crashes, torn manifests), then the
cross-framework cases: for the same state the two packages write equal
manifests and byte-identical payloads (the fused state, the EF chain
state, a QTensor serving tree), each package restores the other's
checkpoint bitwise, and a JAX run's checkpoint resumes in the port: its
next step matches JAX's within the tolerances of
``tests/test_torch_train.py`` (1e-5 relative for the loss, CE and
gradient norm, 1e-4 for the penalty).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantPolicy as JPolicy
from repro.core import INT4 as JINT4
from repro.core.qtensor import quantize_params as j_quantize_params
from repro.data import lm_batch as j_lm_batch
from repro.data import permutation_table as j_perm
from repro.distributed import tree_fingerprint as j_fingerprint
from repro.models.lm import LMConfig as JLMConfig
from repro.models.lm import lm_init as j_lm_init
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_state as j_init_state
from repro.train import make_optimizer as j_make_optimizer
from repro.train import make_train_step as j_make_train_step
from repro.train.faults import corrupt_checkpoint as j_corrupt
from repro_torch import bridge
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qtensor import QTensor
from repro_torch.data import lm_batch, permutation_table
from repro_torch.distributed import (DEAD, AgreementError, Coordinator,
                                     CoordinatorTimeout, InProcessBus,
                                     Straggle, replica_divergence,
                                     tree_fingerprint)
from repro_torch.models.lm import lm_init
from repro_torch.optim import adamw, chain, clip_global_norm, constant, \
    lotion_decoupled
from repro_torch.train import (InjectedCrash, TrainConfig, init_state,
                               make_optimizer, make_train_step)
from repro_torch.train import faults as tfaults

JCFG = JLMConfig(name="r", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                 d_ff=64, vocab=32, dtype=jnp.float32, remat=False)
TCFG = bridge.lm_config(JCFG)
RTOL = 1e-5
PENALTY_RTOL = 1e-4


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((16, 8), generator=g),
                       "b": torch.zeros((8,))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    return [v for _, v in ckpt_io._paths_and_leaves(tree)]


def _bits_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    return all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(map(_np, la), map(_np, lb)))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_torch(tree):
    """A JAX tree (dicts, tuples, lists, QTensors) as the port's."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    if bridge._is_foreign_qtensor(tree):
        return bridge.to_torch({"q": tree})["q"]
    return torch.from_numpy(np.array(tree))


# ------------------------------------------------ twins of test_checkpoint

def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    out, step = ckpt.load(str(tmp_path), t)
    assert step == 7
    assert _bits_equal(t, out)
    assert out["step"].dtype == torch.int32 and out["step"].shape == ()


def test_rotation_keeps_newest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t, keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 2
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_partial_write_invisible(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 3, t)
    d = tmp_path / "step_0000000009"
    os.makedirs(d)
    np.savez(d / ckpt_io.PAYLOAD, x=np.zeros(3))
    assert ckpt.latest_step(str(tmp_path)) == 3
    _, step = ckpt.load(str(tmp_path), t)
    assert step == 3


def test_corruption_detected(tmp_path):
    t = _tree()
    path = ckpt.save(str(tmp_path), 1, t)
    payload = os.path.join(path, ckpt_io.PAYLOAD)
    arrays = dict(np.load(payload))
    key = sorted(arrays)[0]
    arrays[key] = arrays[key] + 1.0
    np.savez(payload, **arrays)
    with pytest.raises(IOError):
        ckpt.load(str(tmp_path), t)


def _tiny_train(n_lotion=False, lam=0.0, fused=True):
    q = QuantConfig(method="lotion" if n_lotion else "fp32",
                    fmt_name="int4", lam=lam,
                    policy=QuantPolicy(min_size=64))
    tc = TrainConfig(quant=q, clip_norm=1.0)
    base = adamw(constant(1e-3))
    if not fused:
        links = [clip_global_norm(1.0)]
        if lam:
            links.append(lotion_decoupled("int4", lam,
                                          policy=QuantPolicy(min_size=64)))
        base = chain(*links, base.transform)
    opt = make_optimizer(tc, base)
    return tc, opt, make_train_step(TCFG, tc, opt)


def _batches(n, seed=0):
    perm = permutation_table(0, TCFG.vocab)
    return [lm_batch(seed, s, 4, 16, TCFG.vocab, perm) for s in range(n)]


def test_resume_is_bit_exact(tmp_path):
    """Train 4 steps; against 2, checkpoint, restore (into a fresh state,
    in place), 2 more."""
    _, opt, step = _tiny_train()
    batches = _batches(4)
    st_a = init_state(lm_init(TCFG, seed=0, device="cpu"), opt)
    for b in batches:
        st_a, _ = step(st_a, b)
    st_b = init_state(lm_init(TCFG, seed=0, device="cpu"), opt)
    for b in batches[:2]:
        st_b, _ = step(st_b, b)
    ckpt.save(str(tmp_path), 2, st_b)
    fresh = init_state(lm_init(TCFG, seed=5, device="cpu"), opt)
    ptrs = [x.data_ptr() for x in _leaves(fresh)]
    st_c, s = ckpt.load(str(tmp_path), into=fresh)
    assert s == 2 and st_c is fresh
    assert [x.data_ptr() for x in _leaves(st_c)] == ptrs
    for b in batches[2:]:
        st_c, _ = step(st_c, b)
    assert _bits_equal(st_a, st_c)


def test_migrate_opt_state_fused_chain_roundtrip(tmp_path):
    """Fused dict -> chain tuple -> fused dict: 2 fused steps, checkpoint,
    migrate into the chain layout, 2 chain steps; params match 4 chain
    steps (the fused and unfused steps are bitwise equal on the CPU)."""
    _, tx_f, step_f = _tiny_train(True, 1e3, fused=True)
    _, tx_c, step_c = _tiny_train(True, 1e3, fused=False)
    batches = _batches(4)
    st = init_state(lm_init(TCFG, seed=0, device="cpu"), tx_f)
    for b in batches[:2]:
        st, _ = step_f(st, b)
    assert ckpt.opt_state_kind(st["opt"]) == "fused"
    ckpt.save(str(tmp_path), 2, st)
    restored, _ = ckpt.load(str(tmp_path), st)
    like = init_state(lm_init(TCFG, seed=0, device="cpu"), tx_c)
    restored["opt"] = ckpt.migrate_opt_state(restored["opt"], like["opt"])
    assert ckpt.opt_state_kind(restored["opt"]) == "chain"
    for b in batches[2:]:
        restored, _ = step_c(restored, b)
    ref = init_state(lm_init(TCFG, seed=0, device="cpu"), tx_c)
    for b in batches:
        ref, _ = step_c(ref, b)
    for a, c in zip(_leaves(restored["params"]), _leaves(ref["params"])):
        np.testing.assert_allclose(_np(a), _np(c), atol=2e-6, rtol=2e-6)
    back = ckpt.migrate_opt_state(
        restored["opt"],
        init_state(lm_init(TCFG, seed=0, device="cpu"), tx_f)["opt"])
    assert ckpt.opt_state_kind(back) == "fused"
    assert torch.equal(back["count"], restored["opt"][-1]["count"])


def test_migrate_rejects_cross_optimizer_state_loss():
    fused = {"mu": {"w": torch.ones(4)}, "nu": {"w": torch.ones(4)},
             "count": torch.ones((), dtype=torch.int32),
             "gnorm": torch.zeros(())}
    sgd_like = ({"gnorm": torch.zeros(())},
                {"count": torch.zeros((), dtype=torch.int32)})
    with pytest.raises(ValueError, match="no slot for load-bearing"):
        ckpt.migrate_opt_state(fused, sgd_like)


def test_migrate_rejects_ef_error_tree():
    src = ({"gnorm": torch.zeros(())}, {"err": {"w": torch.zeros(4)}},
           {"mu": {"w": torch.zeros(4)}, "nu": {"w": torch.zeros(4)},
            "count": torch.zeros((), dtype=torch.int32)})
    fused_like = {"mu": {"w": torch.zeros(4)}, "nu": {"w": torch.zeros(4)},
                  "count": torch.zeros((), dtype=torch.int32),
                  "gnorm": torch.zeros(())}
    with pytest.raises(ValueError, match="EF-compression error tree"):
        ckpt.migrate_opt_state(src, fused_like)


def test_restore_places_on_like_device_or_into(tmp_path):
    """The elastic-restore twin on one device: leaves land on the device
    of the matching ``like`` leaf, numpy templates give numpy leaves,
    ``into`` copies in place, and a dtype mismatch with ``into`` raises
    instead of casting silently."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    out, _ = ckpt.load(str(tmp_path), t)
    assert all(x.device.type == "cpu" for x in _leaves(out))
    np_like = {"params": {"w": np.zeros((16, 8), np.float32),
                          "b": np.zeros(8, np.float32)},
               "step": np.int32(0)}
    as_np, _ = ckpt.load(str(tmp_path), np_like)
    assert isinstance(as_np["params"]["w"], np.ndarray)
    np.testing.assert_array_equal(as_np["params"]["w"], _np(t["params"]["w"]))
    dst = _tree(3)
    out, _ = ckpt.load(str(tmp_path), into=dst)
    assert out is dst and torch.equal(dst["params"]["w"], t["params"]["w"])
    bad = _tree()
    bad["step"] = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="dtype mismatch"):
        ckpt.load(str(tmp_path), into=bad)


@pytest.mark.parametrize("verify", [True, False])
def test_load_verifies_crc_with_opt_out(tmp_path, verify):
    """A bit-flipped payload fails verification with the typed error
    (with verify=False, the zip's own CRC still refuses it); a clean
    checkpoint loads either way."""
    t = _tree()
    path = ckpt.save(str(tmp_path), 1, t)
    out, _ = ckpt.load(str(tmp_path), t, verify=verify)
    assert _bits_equal(t, out)
    tfaults.corrupt_checkpoint(path)
    with pytest.raises(ckpt.CorruptCheckpointError):
        ckpt.load(str(tmp_path), t, verify=verify)
    assert not ckpt.verify_dir(path)


def test_latest_valid_quarantines_corrupt_newest(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    path2 = ckpt.save(str(tmp_path), 2, t)
    tfaults.corrupt_checkpoint(path2)
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert ckpt.latest_valid(str(tmp_path)) == 1
    assert os.path.isdir(path2)
    assert ckpt.latest_valid(str(tmp_path), quarantine_corrupt=True) == 1
    assert not os.path.isdir(path2)
    assert os.path.isdir(path2 + ".corrupt")
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, step = ckpt.load(str(tmp_path), t)
    assert step == 1


def test_truncated_payload_falls_back(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    path2 = ckpt.save(str(tmp_path), 2, t)
    tfaults.corrupt_checkpoint(path2, mode="truncate")
    with pytest.raises(ckpt.CorruptCheckpointError):
        ckpt.load(str(tmp_path), t, step=2)
    assert ckpt.latest_valid(str(tmp_path), quarantine_corrupt=True) == 1


def test_rotation_never_deletes_checkpoint_being_written(tmp_path):
    t = _tree()
    for s in (3, 4, 5):
        ckpt.save(str(tmp_path), s, t, keep=2)
    path = ckpt.save(str(tmp_path), 2, t, keep=2)
    assert os.path.isdir(path)
    assert ckpt.latest_valid(str(tmp_path)) == 5
    _, step = ckpt.load(str(tmp_path), t, step=2)
    assert step == 2


def test_stale_tmp_ignored_by_restore_and_swept_by_save(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    stale = tmp_path / "step_0000000009.tmp"
    os.makedirs(stale)
    (stale / "junk").write_text("x")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_valid(str(tmp_path)) == 1
    ckpt.save(str(tmp_path), 2, t)
    assert not os.path.exists(stale)


def test_mid_write_crash_leaves_previous_step_restorable(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)

    def kill(stage, path):
        if stage == "manifest":
            raise RuntimeError("killed mid-write")

    with ckpt.write_fault_hook(kill):
        with pytest.raises(RuntimeError):
            ckpt.save(str(tmp_path), 2, t)
    assert ckpt.latest_valid(str(tmp_path)) == 1
    assert any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    ckpt.save(str(tmp_path), 2, t)
    assert ckpt.latest_valid(str(tmp_path)) == 2
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_resave_same_step_overwrites_atomically(tmp_path):
    a, b = _tree(seed=0), _tree(seed=1)
    ckpt.save(str(tmp_path), 3, a)
    ckpt.save(str(tmp_path), 3, b)
    out, _ = ckpt.load(str(tmp_path), b, step=3)
    assert torch.equal(out["params"]["w"], b["params"]["w"])
    assert not any(d.endswith(".old") or d.endswith(".tmp")
                   for d in os.listdir(tmp_path))


def test_bfloat16_leaves_are_refused_by_name(tmp_path):
    """JAX writes a bf16 leaf as raw |V2 bytes under a "bfloat16"
    manifest entry, which its own verify_dir rejects; the port refuses
    such a leaf on save and on load, naming it."""
    jt = {"a": jnp.ones((3,), jnp.bfloat16), "b": jnp.zeros((2,))}
    jio.save(str(tmp_path / "j"), 1, jt)
    jd = str(tmp_path / "j" / "step_0000000001")
    assert not jio.verify_dir(jd)
    with np.load(os.path.join(jd, jio.PAYLOAD)) as pz:
        assert pz["a"].dtype == np.dtype("V2")
    assert not ckpt.verify_dir(jd)
    like = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.zeros(2)}
    with pytest.raises(TypeError, match="'a'"):
        ckpt.load(str(tmp_path / "j"), like)
    with pytest.raises(TypeError, match="'a' is bfloat16"):
        ckpt.save(str(tmp_path / "t"), 1, like)


def test_leaf_keys_follow_jax_flattening():
    """Keys as JAX's tree_flatten_with_path spells them: sorted dict keys,
    tuple positions, case kept, no leaf for None or an empty tuple, and a
    QTensor's codes and scales."""
    qt = QTensor(torch.zeros(4, 2, dtype=torch.uint8), torch.ones(()),
                 "int4", 4, -1)
    tree = {"b": (torch.zeros(1), (), {"Zz": torch.zeros(1)}),
            "a": None, "W": qt, "c": [torch.zeros(2)]}
    keys = [k for k, _ in ckpt_io._paths_and_leaves(tree)]
    assert keys == ["W/codes", "W/scales", "b/0", "b/2/Zz", "c/0"]
    jtree = {"b": (jnp.zeros(1), (), {"Zz": jnp.zeros(1)}), "a": None,
             "c": [jnp.zeros(2)]}
    jkeys = [k for k, _ in jio._paths_and_leaves(jtree)[0]]
    assert jkeys == [k for k in keys if not k.startswith("W")]


# --------------------------------------------- coordinator and audit twins

def test_single_host_rounds_are_trivially_unanimous():
    c = Coordinator()
    assert c.n_hosts == 1
    assert c.elect_checkpoint(7) == 7
    assert c.elect_checkpoint(None) is None
    assert c.agree("rollback", (3, 5, "loss")) == (3, 5, "loss")
    c.barrier("x")
    assert c.check_fingerprint(1, "abcd1234") == []
    assert c.rounds == 5


@pytest.mark.parametrize("peer,want", [(lambda h, k, v: 3 if h == 2 else v,
                                        3),
                                       (lambda h, k, v: None, None)])
def test_elect_checkpoint_min_or_none(peer, want):
    assert Coordinator(InProcessBus(3, peer_fn=peer)).elect_checkpoint(9) \
        == want


def test_agree_mismatch_is_typed_error_with_votes():
    bus = InProcessBus(2, peer_fn=lambda h, k, v: ("other",))
    with pytest.raises(AgreementError) as ei:
        Coordinator(bus).agree("seek", ("mine",))
    assert ei.value.votes[1] == ("other",)


def test_dead_host_converts_to_timeout_not_hang():
    bus = InProcessBus(4)
    bus.kill(2)
    with pytest.raises(CoordinatorTimeout) as ei:
        Coordinator(bus).elect_checkpoint(5)
    assert ei.value.missing == (2,)
    bus2 = InProcessBus(2, peer_fn=lambda h, k, v: DEAD)
    with pytest.raises(CoordinatorTimeout):
        Coordinator(bus2).barrier()


def test_straggler_past_deadline_is_dead_under_it_is_fine():
    bus = InProcessBus(2)
    bus.straggle(1, 5.0)
    c = Coordinator(bus, timeout=30.0)
    c.barrier()
    bus.straggle(1, 120.0)
    with pytest.raises(CoordinatorTimeout) as ei:
        c.barrier()
    assert ei.value.missing == (1,)
    bus3 = InProcessBus(2, peer_fn=lambda h, k, v: Straggle(99.0))
    with pytest.raises(CoordinatorTimeout):
        Coordinator(bus3, timeout=30.0).barrier()


def test_heal_all_models_host_replacement():
    bus = InProcessBus(3)
    bus.kill(1)
    bus.straggle(2, 1e9)
    c = Coordinator(bus)
    with pytest.raises(CoordinatorTimeout):
        c.barrier()
    bus.heal_all()
    c.barrier()


def test_fingerprint_divergence_named_per_host():
    bus = InProcessBus(3, peer_fn=lambda h, k, v: "bad0bad0" if h == 2
                       else v)
    out = Coordinator(bus).check_fingerprint(11, "aaaa0000")
    assert len(out) == 1 and "host 2" in out[0] and "step 11" in out[0]


def test_local_host_cannot_be_killed_through_bus():
    bus = InProcessBus(2)
    with pytest.raises(ValueError):
        bus.kill(0)
    with pytest.raises(ValueError):
        bus.straggle(5, 1.0)


def test_tree_fingerprint_is_deterministic_sensitive_and_jax_equal():
    t = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
         "b": {"c": np.ones((4,), np.int32)}}
    tt = {"a": torch.from_numpy(t["a"].copy()),
          "b": {"c": torch.from_numpy(t["b"]["c"].copy())}}
    d1 = tree_fingerprint(tt)
    assert d1 == tree_fingerprint(t) == j_fingerprint(t)
    tt["b"]["c"][1] = 2
    assert tree_fingerprint(tt) != d1
    t3 = {"a": t["a"], "b": {"c": t["b"]["c"].view(np.uint32)}}
    assert tree_fingerprint(t3) != d1
    assert replica_divergence(tt) == []


# ------------------------------------------------ sharded checkpoint twins

def _stree(seed=0):
    r = np.random.default_rng(seed)
    return {"w1": torch.from_numpy(r.normal(size=(16, 8)).astype(np.float32)),
            "w2": torch.from_numpy(r.normal(size=(8, 8)).astype(np.float32)),
            "b": torch.from_numpy(r.normal(size=(8,)).astype(np.float32)),
            "step": torch.zeros((), dtype=torch.int32)}


def test_sharded_save_layout_and_roundtrip(tmp_path):
    tree = _stree()
    ckpt_io.save(str(tmp_path), 5, tree, n_shards=3)
    d = tmp_path / "step_0000000005"
    names = sorted(os.listdir(d))
    assert [n for n in names if n.startswith("arrays_")] == [
        ckpt_io.shard_payload_name(i, 3) for i in range(3)]
    assert ckpt_io.verify_dir(str(d))
    loaded, step = ckpt_io.load(str(tmp_path), tree)
    assert step == 5 and _bits_equal(tree, loaded)


def test_single_shard_save_keeps_legacy_layout(tmp_path):
    ckpt_io.save(str(tmp_path), 1, _stree(), n_shards=1)
    d = tmp_path / "step_0000000001"
    assert (d / ckpt_io.PAYLOAD).exists()
    assert ckpt_io.verify_dir(str(d))


@pytest.mark.parametrize("mode", ["bitflip", "truncate", "delete"])
def test_one_bad_shard_untrusts_the_whole_step(tmp_path, mode):
    ckpt_io.save(str(tmp_path), 3, _stree(3), n_shards=2)
    ckpt_io.save(str(tmp_path), 6, _stree(6), n_shards=2)
    d6 = str(tmp_path / "step_0000000006")
    tfaults.corrupt_checkpoint(d6, mode, shard=1)
    assert not ckpt_io.verify_dir(d6)
    with pytest.raises(ckpt_io.CorruptCheckpointError):
        ckpt_io.load(str(tmp_path), _stree(), step=6)
    assert ckpt_io.latest_valid(str(tmp_path), quarantine_corrupt=True) == 3
    assert any(".corrupt" in n for n in os.listdir(tmp_path))


def test_torn_manifest_quarantines_step(tmp_path):
    ckpt_io.save(str(tmp_path), 2, _stree(2), n_shards=2)
    ckpt_io.save(str(tmp_path), 4, _stree(4), n_shards=2)
    tfaults.corrupt_checkpoint(str(tmp_path / "step_0000000004"), "manifest")
    assert ckpt_io.latest_valid(str(tmp_path), quarantine_corrupt=True) == 2


def test_write_stage_order_includes_shards_and_fsync(tmp_path):
    stages = []
    with ckpt_io.write_fault_hook(lambda st, p: stages.append(st)):
        ckpt_io.save(str(tmp_path), 1, _stree(), n_shards=2)
    assert stages == ["payload", "shard0", "shard1", "manifest", "fsync",
                      "publish", "done"]
    stages.clear()
    with ckpt_io.write_fault_hook(lambda st, p: stages.append(st)):
        ckpt_io.save(str(tmp_path), 2, _stree(), n_shards=1)
    assert stages == ["payload", "manifest", "fsync", "publish", "done"]


@pytest.mark.parametrize("stage", ["payload", "shard1", "manifest", "fsync",
                                   "publish"])
def test_crash_mid_write_never_publishes(tmp_path, stage):
    ckpt_io.save(str(tmp_path), 3, _stree(3), n_shards=2)

    def hook(st, path):
        if st == stage:
            raise InjectedCrash(f"kill at {st}")

    with ckpt_io.write_fault_hook(hook):
        with pytest.raises(InjectedCrash):
            ckpt_io.save(str(tmp_path), 6, _stree(6), n_shards=2)
    assert not (tmp_path / "step_0000000006").exists()
    assert ckpt_io.latest_valid(str(tmp_path)) == 3


# ------------------------------------------------------- across packages

def _jtrain(ef=False, use_kernel=None, steps=1, lam=1e3):
    """A JAX train state after ``steps`` steps on the tiny config (the
    chain, or the fused core with use_kernel=True, interpret mode)."""
    jt = JTrainConfig(quant=JQuantConfig(method="lotion", fmt_name="int4",
                                         lam=lam,
                                         policy=JPolicy(min_size=64),
                                         use_kernel=use_kernel),
                      clip_norm=1.0, ef_compress=ef)
    tx = j_make_optimizer(jt, j_adamw(j_constant(1e-3)))
    st = j_init_state(j_lm_init(jax.random.PRNGKey(0), JCFG), tx)
    step = jax.jit(j_make_train_step(JCFG, jt, tx))
    perm = j_perm(0, JCFG.vocab)
    metrics = []
    for s in range(steps):
        st, m = step(st, j_lm_batch(0, s, 4, 16, JCFG.vocab, perm))
        metrics.append({k: float(v) for k, v in m.items()})
    return st, metrics


def _manifest(root, step):
    with open(os.path.join(root, f"step_{step:010d}", ckpt_io.MANIFEST)) as f:
        return json.load(f)


def _payloads(root, step):
    d = os.path.join(root, f"step_{step:010d}")
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".npz")}


def _jax_qtensor_tree():
    params = j_lm_init(jax.random.PRNGKey(0), JCFG)
    return j_quantize_params(params, JINT4, JPolicy(min_size=64), -1,
                             mode="rtn")


@pytest.mark.parametrize("kind", ["fused", "ef_chain", "qtensor"])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_same_state_same_manifest_and_payload_bytes(tmp_path, kind,
                                                    n_shards):
    """The same state saved by JAX and by the port: equal manifests
    (keys, shapes, dtypes, shards, crc32) and byte-identical npz files.
    The port's own optimizer gives the same structure as JAX's: its
    freshly initialized state saves to the same keys, shapes, dtypes."""
    if kind == "qtensor":
        jtree = jax.tree.map(np.asarray, _jax_qtensor_tree())
    else:
        jst, _ = _jtrain(ef=kind == "ef_chain",
                         use_kernel=True if kind == "fused" else None)
        jtree = jax.tree.map(np.asarray, jst)
    ttree = _to_torch(jtree)
    jio.save(str(tmp_path / "j"), 1, jtree, n_shards=n_shards)
    ckpt.save(str(tmp_path / "t"), 1, ttree, n_shards=n_shards)
    assert _manifest(tmp_path / "j", 1) == _manifest(tmp_path / "t", 1)
    assert _payloads(tmp_path / "j", 1) == _payloads(tmp_path / "t", 1)
    if kind != "qtensor":
        q = QuantConfig(method="lotion", fmt_name="int4", lam=1e3,
                        policy=QuantPolicy(min_size=64))
        tx = make_optimizer(TrainConfig(quant=q, clip_norm=1.0,
                                        ef_compress=kind == "ef_chain"),
                            adamw(constant(1e-3)))
        own = init_state(bridge.to_torch(jax.tree.map(
            np.asarray, j_lm_init(jax.random.PRNGKey(0), JCFG))), tx)
        ckpt.save(str(tmp_path / "o"), 1, own, n_shards=n_shards)
        want = {k: {f: v[f] for f in ("shape", "dtype", "shard")}
                for k, v in _manifest(tmp_path / "j", 1)["leaves"].items()}
        got = {k: {f: v[f] for f in ("shape", "dtype", "shard")}
               for k, v in _manifest(tmp_path / "o", 1)["leaves"].items()}
        assert got == want


@pytest.mark.parametrize("kind", ["fused", "qtensor"])
def test_checkpoints_load_across_packages_bitwise(tmp_path, kind):
    """A JAX checkpoint restores in the port and a port checkpoint in
    JAX, bit for bit, each against the other package's template."""
    if kind == "qtensor":
        jtree = _jax_qtensor_tree()
    else:
        jtree, _ = _jtrain(use_kernel=True, steps=2)
    ttree = _to_torch(jax.tree.map(np.asarray, jtree))
    jio.save(str(tmp_path / "j"), 4, jtree)
    like = _to_torch(jax.tree.map(lambda x: np.zeros_like(np.asarray(x)),
                                  jtree))
    got, s = ckpt.load(str(tmp_path / "j"), like)
    assert s == 4 and _bits_equal(ttree, got)
    into = _to_torch(jax.tree.map(lambda x: np.zeros_like(np.asarray(x)),
                                  jtree))
    ckpt.load(str(tmp_path / "j"), into=into)
    assert _bits_equal(ttree, into)
    ckpt.save(str(tmp_path / "t"), 5, ttree)
    jgot, s = jio.load(str(tmp_path / "t"), jax.eval_shape(lambda: jtree))
    assert s == 5
    assert all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
               for a, b in zip(jax.tree.leaves(jtree),
                               jax.tree.leaves(jgot)))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains 3 steps (its CPU default, the unfused chain) and saves;
    the port restores that checkpoint into its chain layout, migrates it
    into its fused core and takes step 4, which matches JAX's step 4."""
    jst, _ = _jtrain(steps=3)
    jio.save(str(tmp_path), 3, jst)
    j4, jm = _jtrain(steps=4)
    q = QuantConfig(method="lotion", fmt_name="int4", lam=1e3,
                    policy=QuantPolicy(min_size=64))
    tc = TrainConfig(quant=q, clip_norm=1.0)
    params = lm_init(TCFG, seed=9, device="cpu")
    chain_tx = make_optimizer(tc, chain(
        clip_global_norm(1.0),
        lotion_decoupled("int4", 1e3, policy=QuantPolicy(min_size=64)),
        adamw(constant(1e-3)).transform))
    restored, s = ckpt.load(str(tmp_path), init_state(params, chain_tx))
    assert s == 3 and int(restored["step"]) == 3
    fused_tx = make_optimizer(tc, adamw(constant(1e-3)))
    assert fused_tx.applies_updates
    restored["opt"] = ckpt.migrate_opt_state(
        restored["opt"], fused_tx.init(restored["params"]))
    step = make_train_step(TCFG, tc, fused_tx)
    jb = j_lm_batch(0, 3, 4, 16, JCFG.vocab, j_perm(0, JCFG.vocab))
    st, m = step(restored, {k: torch.from_numpy(np.array(v)).long()
                            for k, v in jb.items()})
    want = jm[-1]
    for k in ("loss", "ce", "grad_norm"):
        assert abs(float(m[k]) - want[k]) <= RTOL * abs(want[k]), k
    assert (abs(float(m["penalty"]) - want["penalty"])
            <= PENALTY_RTOL * abs(want["penalty"]))
    for a, b in zip(jax.tree.leaves(j4["params"]),
                    _leaves(st["params"])):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-4,
                                   atol=1e-6)


def test_port_fused_checkpoint_layout_matches_jax_fused_layout(tmp_path):
    """A checkpoint the port writes from its fused core restores into the
    JAX fused core's template (use_kernel=True), and JAX's corrupt_checkpoint
    damage is detected by the port."""
    q = QuantConfig(method="lotion", fmt_name="int4", lam=1e3,
                    policy=QuantPolicy(min_size=64))
    tc = TrainConfig(quant=q, clip_norm=1.0)
    tx = make_optimizer(tc, adamw(constant(1e-3)))
    jinit = j_lm_init(jax.random.PRNGKey(0), JCFG)
    st = init_state(bridge.to_torch(jax.tree.map(np.asarray, jinit)), tx)
    step = make_train_step(TCFG, tc, tx)
    for b in _batches(2):
        st, _ = step(st, b)
    path = ckpt.save(str(tmp_path), 2, st)
    jst, _ = _jtrain(use_kernel=True, steps=0)
    jgot, _ = jio.load(str(tmp_path), jax.eval_shape(lambda: jst))
    assert all(np.asarray(a).tobytes() == _np(b).tobytes()
               for a, b in zip(jax.tree.leaves(jgot), _leaves(st)))
    j_corrupt(path, "bitflip")
    assert not ckpt.verify_dir(path)
    assert ckpt.latest_valid(str(tmp_path), quarantine_corrupt=True) is None
