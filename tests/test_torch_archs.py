"""Every config of the port against the JAX package on the CPU, at the
smoke configs (a twin of ``tests/test_archs.py``).

Weights come from the JAX ``lm_init`` and cross through ``bridge``;
tokens are numpy draws from a seed ((b, l, C) for MusicGen's codebooks).
Tolerances, relative to the largest value compared: forward logits 1e-5
(XLA's and torch's fp32 contractions sum in other orders); one decoupled
LOTION int4 train step, its loss and the updated parameters 1e-4 (as
``test_torch_train.py`` holds the penalty: Adam's first step moves each
element by lr * g / (|g| + eps), so an element whose gradient is far
below eps, as some of a router's are (1e-12 against gradients that
agree to 1e-6 of their largest), moves by a fraction of lr that its
last bits decide; the step runs at lr 1e-4, where a step in the wrong
direction still breaks the tolerance, and every leaf is checked to have
moved: by more than half the tolerance relative to its largest value, or,
for a leaf whose values dwarf one step, by an update that itself agrees
with JAX's within the tolerance); prefill and decode against the full forward 1e-4, and the port's
prefill and decode logits against JAX's 1e-5.

Llama-3.2-Vision's batches carry image embeddings (numpy normal draws,
(b, n_image_tokens, d_vision)), and its JAX tree gets cross-attention gates
drawn uniform in [0.25, 0.75] per repeat before it crosses the bridge:
JAX's init sets them to zero, where the cross path adds nothing.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import QuantConfig as JQuantConfig
from repro.core import QuantPolicy as JPolicy
from repro.models import lm as jlm
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_state as j_init_state
from repro.train import make_optimizer as j_make_optimizer
from repro.train import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw, constant
from repro_torch.train import (TrainConfig, init_state, make_optimizer,
                               make_train_step)

RTOL = 1e-5
STEP_RTOL = 1e-4
CONSISTENCY_RTOL = 1e-4
LR = 1e-4
ARCH_IDS = [a.replace("_", "-") for a in ARCHS]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def open_gates(jparams, jcfg, seed=0):
    """The JAX tree with every ``xattn_gate`` (one per repeat) drawn
    uniform in [0.25, 0.75] from ``seed``."""
    rng = np.random.default_rng(seed)
    for i, kind in enumerate(jcfg.pattern):
        if kind == "xattn":
            jparams["stage"][f"b{i}_{kind}"]["xattn_gate"] = jnp.asarray(
                rng.uniform(0.25, 0.75, jcfg.n_repeats).astype(np.float32))
    return jparams


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = j_smoke(arch)
    jparams = open_gates(jlm.lm_init(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, jparams, bridge.lm_config(jcfg)


def _tparams(arch):
    return bridge.to_torch(jax.tree.map(np.asarray, _setup(arch)[1]))


def _tokens(cfg, b=2, l=12, seed=0):
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, l) + books,
                                                dtype=np.int32)


def _images(cfg, b=2, seed=0):
    """Image embeddings (b, n_image_tokens, d_vision) for a config that
    cross-attends, else None."""
    if not cfg.n_image_tokens:
        return None
    return np.random.default_rng(100 + seed).standard_normal(
        (b, cfg.n_image_tokens, cfg.d_vision)).astype(np.float32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def test_archs_are_the_jax_configs():
    """The port's configs are its own copies of the JAX ones, field for
    field, at full size and at the smoke size."""
    from repro.configs import get_config as j_full
    for arch in ARCH_IDS:
        for mine, theirs in ((get_config(arch), j_full(arch)),
                             (get_smoke_config(arch), j_smoke(arch))):
            assert mine == bridge.lm_config(theirs), arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bridge_round_trips_every_tree(arch):
    """The JAX tree crosses to the port and back unchanged: MoE routers,
    (R, E, d, f) expert stacks and shared MLPs, (C, V, d) codebook embeds
    and (C, d, V) heads, and the int4 serving tree with its QTensors."""
    from repro.core import qtensor as jqt
    from repro.core.policy import QuantPolicy as JQP
    jcfg, jparams, _ = _setup(arch)
    for tree in (jparams, jqt.quantize_params(jparams, "int4",
                                              JQP(min_size=256), -1)):
        want = bridge.flatten(bridge.to_numpy(bridge.to_torch(
            jax.tree.map(np.asarray, tree))))
        src = bridge.flatten(jax.tree.map(np.asarray, tree))
        assert set(want) == set(src)
        for path, leaf in src.items():
            if isinstance(want[path], dict):
                for f in ("codes", "scales"):
                    np.testing.assert_array_equal(want[path][f],
                                                  getattr(leaf, f))
            else:
                np.testing.assert_array_equal(want[path], leaf)
                assert want[path].shape == leaf.shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_jax(arch):
    jcfg, jparams, tcfg = _setup(arch)
    toks = _tokens(jcfg)
    img = _images(jcfg)
    want = np.asarray(jlm.lm_forward(jparams, jcfg, jnp.asarray(toks),
                                     image_embeds=_j(img)))
    with torch.no_grad():
        got = tlm.lm_forward(_tparams(arch), tcfg,
                             torch.from_numpy(toks).long(),
                             image_embeds=_t(img)).numpy()
    b, l = toks.shape[:2]
    books = (jcfg.n_codebooks,) if jcfg.n_codebooks > 1 else ()
    assert got.shape == (b, l) + books + (jcfg.vocab,)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= RTOL, (arch, _rel(got, want))


def _train_configs(lam=100.0):
    kw = dict(method="lotion", fmt_name="int4", lam=lam,
              penalty_placement="decoupled")
    return (JTrainConfig(quant=JQuantConfig(policy=JPolicy(min_size=256),
                                            **kw), clip_norm=1.0),
            TrainConfig(quant=QuantConfig(policy=QuantPolicy(min_size=256),
                                          **kw), clip_norm=1.0))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lotion_train_step_matches_jax(arch):
    """One decoupled-LOTION int4 step (AdamW at 1e-4, clip 1.0) from the
    same weights and batch: loss, CE, gradient norm and every updated
    parameter."""
    jcfg, jparams, tcfg = _setup(arch)
    jt, tt = _train_configs()
    toks = _tokens(jcfg, 2, 16, seed=1)
    img = _images(jcfg, 2, seed=1)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = torch.from_numpy(toks).long()
    tbatch = {"tokens": tb, "labels": tb}
    if img is not None:
        jbatch["image_embeds"], tbatch["image_embeds"] = _j(img), _t(img)
    jtx = j_make_optimizer(jt, j_adamw(j_constant(LR)))
    jst, jm = jax.jit(j_make_train_step(jcfg, jt, jtx))(
        j_init_state(jparams, jtx), jbatch)
    ttx = make_optimizer(tt, adamw(constant(LR)))
    tst, tm = make_train_step(tcfg, tt, ttx)(
        init_state(_tparams(arch), ttx), tbatch)
    for k in ("loss", "ce", "grad_norm", "penalty"):
        assert _rel(float(tm[k]), float(jm[k])) <= STEP_RTOL, (k, tm[k],
                                                              jm[k])
    assert not bool(tm["skipped"])
    want = bridge.flatten(jax.tree.map(np.asarray, jst["params"]))
    before = bridge.flatten(jax.tree.map(np.asarray, jparams))
    got = bridge.flatten(bridge.to_numpy(tst["params"]))
    assert set(got) == set(want)
    for path, t in got.items():
        assert _rel(t, want[path]) <= STEP_RTOL, (arch, path,
                                                  _rel(t, want[path]))
        if _rel(want[path], before[path]) <= STEP_RTOL / 2:
            # a leaf whose values dwarf one step (the SSM configs' a_log,
            # dt_bias, decay_base: up to about 7) moved by less than the
            # tolerance above can see: hold the update itself
            step = want[path] - before[path]
            assert np.abs(step).max() > 0, path
            assert _rel(t - before[path], step) <= STEP_RTOL, (
                arch, path, _rel(t - before[path], step))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_consistency(arch):
    """Prefill of l - 1 tokens and one decode step against the full
    forward (the port with itself), and both against JAX's prefill and
    decode on the same cache length."""
    jcfg, jparams, tcfg = _setup(arch)
    b, l = 2, 12
    toks = _tokens(jcfg, b, l, seed=2)
    img = _images(jcfg, b, seed=2)
    tt = torch.from_numpy(toks).long()
    params = _tparams(arch)
    with torch.no_grad():
        full = tlm.lm_forward(params, tcfg, tt, image_embeds=_t(img)).numpy()
        lp, cache = tlm.lm_prefill(params, tcfg, tt[:, :l - 1], cache_len=l,
                                   image_embeds=_t(img))
        ld, _ = tlm.lm_decode(params, tcfg, cache, tt[:, l - 1:l],
                              torch.full((b,), l - 1, dtype=torch.long))
    assert _rel(lp[:, 0], full[:, l - 2]) <= CONSISTENCY_RTOL
    assert _rel(ld[:, 0], full[:, l - 1]) <= CONSISTENCY_RTOL
    jlp, jcache = jlm.lm_prefill(jparams, jcfg, jnp.asarray(toks[:, :l - 1]),
                                 image_embeds=_j(img), cache_len=l)
    jld, _ = jlm.lm_decode(jparams, jcfg, jcache, jnp.asarray(toks[:, l - 1:l]),
                           jnp.full((b,), l - 1, jnp.int32))
    assert _rel(lp, jlp) <= RTOL and _rel(ld, jld) <= RTOL


def test_emb_scale_is_the_fp32_constant():
    """Gemma3 scales its embeddings by sqrt(d_model) rounded to fp32 once
    (``np.sqrt(d).astype(float32)``), in the fp32 promotion of a bf16
    compute dtype: the port's embeddings are bitwise JAX's."""
    jcfg, jparams, _ = _setup("gemma3-12b")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    toks = _tokens(jcfg, 2, 8, seed=3)
    want = np.asarray(jlm._embed(jparams, jcfg, jnp.asarray(toks)))
    got = tlm._embed(_tparams("gemma3-12b"), bridge.lm_config(jcfg),
                     torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_codebook_embed_sums_every_codebook():
    """MusicGen's embedding is the sum of one row per codebook: bitwise
    JAX's, and moving any one codebook's token moves it."""
    jcfg, jparams, tcfg = _setup("musicgen-medium")
    toks = _tokens(jcfg, 2, 8, seed=4)
    params = _tparams("musicgen-medium")
    got = tlm._embed(params, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jlm._embed(jparams, jcfg, jnp.asarray(toks))))
    for c in range(jcfg.n_codebooks):
        moved = toks.copy()
        moved[..., c] = (moved[..., c] + 1) % jcfg.vocab
        assert not torch.equal(
            tlm._embed(params, tcfg, torch.from_numpy(moved).long()), got), c


def test_codebook_head_quantized_is_refused():
    """With ``include_embeddings=True`` the packer makes the (C, d, V)
    head a 3-D QTensor, which JAX's ``_head`` einsum cannot take either:
    the port says so instead of failing inside the einsum."""
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.engine import prepare_params
    _, _, tcfg = _setup("musicgen-medium")
    q = prepare_params(_tparams("musicgen-medium"),
                       ServeConfig(weights="rtn:int4", include_embeddings=True,
                                   policy=QuantPolicy(min_size=256,
                                                      include_embeddings=True)),
                       "cpu")
    toks = torch.from_numpy(_tokens(tcfg, 1, 4)).long()
    with pytest.raises(ValueError, match="served dense"):
        tlm.lm_prefill(q, tcfg, toks)
