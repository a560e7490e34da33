"""Streaming attention (``attn_apply(chunk=)``, ``_streaming_sdpa``) and
the chunked head (``lm_loss(logit_chunk=)``) of the port against the JAX
package on the CPU.

Inputs come from numpy seeds; model weights from the JAX ``lm_init``
through ``bridge``.  Tolerances, fp32: the online softmax against JAX's
within 1e-5 relative to the largest output (the two add the chunks'
exponentials in another order than one softmax, and XLA and torch sum
the einsums in other orders); the losses, per-example losses, prefill
logits and caches within 1e-5; the chunked loss's gradient against the
unchunked port's within 1e-5 of each leaf's largest gradient.
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
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_state as j_init_state
from repro.train import make_optimizer as j_make_optimizer
from repro.train import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.core.modes import QuantConfig
from repro_torch.core.policy import QuantPolicy, tree_leaves
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw, constant
from repro_torch.train import (TrainConfig, init_state, make_optimizer,
                               make_train_step)

ARCHS = ["granite-3-2b", "gemma2-2b"]
B, L, CHUNK = 2, 32, 8
RTOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


# --- _streaming_sdpa ------------------------------------------------------------

# (name, causal, window, softcap, key length, per-row positions)
SDPA_CASES = [
    ("causal", True, None, None, 32, False),
    ("window", True, 6, None, 32, False),
    ("softcap", True, None, 20.0, 32, False),
    ("padded_last_chunk", True, None, None, 29, False),
    ("noncausal_padded", False, None, None, 29, False),
    ("per_row_positions", True, 12, 30.0, 27, True),
]


@pytest.mark.parametrize("case", SDPA_CASES, ids=[c[0] for c in SDPA_CASES])
def test_streaming_sdpa_matches_jax(case):
    _, causal, window, softcap, kl, per_row = case
    rng = np.random.default_rng(0)
    h, g, d = 4, 2, 16
    q = rng.standard_normal((B, kl, h, d)).astype(np.float32)
    k = rng.standard_normal((B, kl, g, d)).astype(np.float32)
    v = rng.standard_normal((B, kl, g, d)).astype(np.float32)
    pos = np.arange(kl)
    if per_row:             # left-padded ragged rows: pads at negative places
        pos = pos[None, :] - np.array([[0], [5]])
    want = jlayers._streaming_sdpa(q, k, v, jnp.asarray(pos),
                                   jnp.asarray(pos), causal, window, softcap,
                                   CHUNK)
    got = tlayers._streaming_sdpa(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                  causal, window, softcap, CHUNK)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= RTOL


def test_streaming_sdpa_matches_full_softmax_and_keeps_dtype():
    """Within the port: the streamed output equals ``_sdpa``'s on the
    expanded heads (fp32), and a bf16 q gives a bf16 output."""
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((B, 20, 4, 16)).astype(np.float32))
    k = _t(rng.standard_normal((B, 20, 2, 16)).astype(np.float32))
    v = _t(rng.standard_normal((B, 20, 2, 16)).astype(np.float32))
    pos = torch.arange(20)
    full = tlayers._sdpa(q, tlayers._expand_kv(k, 4), tlayers._expand_kv(
        v, 4), tlayers._mask_bias(pos, pos, True, None), None)
    got = tlayers._streaming_sdpa(q, k, v, pos, pos, True, None, None, 6)
    assert _rel(got, full) <= RTOL
    bf = tlayers._streaming_sdpa(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 pos, pos, True, None, None, 6)
    assert bf.dtype == torch.bfloat16


# --- lm_loss / lm_prefill ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = j_smoke(arch)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, (B, L + 1)).astype(np.int32)
    return jcfg, jp, bridge.lm_config(jcfg), toks


def _tparams(jp):
    return bridge.to_torch(jax.tree.map(np.asarray, jp))


@functools.lru_cache(maxsize=None)
def _jax_loss(arch, attn_chunk, logit_chunk, per_example):
    jcfg, jp, _, toks = _setup(arch)
    fn = jax.jit(functools.partial(jlm.lm_loss, cfg=jcfg,
                                   attn_chunk=attn_chunk,
                                   logit_chunk=logit_chunk,
                                   per_example=per_example))
    out = fn(jp, tokens=toks[:, :-1], labels=toks[:, 1:])
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("per_example", [False, True])
@pytest.mark.parametrize("chunks", [(CHUNK, None), (None, CHUNK),
                                    (CHUNK, CHUNK), (CHUNK, L // 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_chunked_matches_jax(arch, chunks, per_example):
    attn_chunk, logit_chunk = chunks
    _, jp, tcfg, toks = _setup(arch)
    want = _jax_loss(arch, attn_chunk, logit_chunk, per_example)
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        got = tlm.lm_loss(_tparams(jp), tcfg, t[:, :-1], t[:, 1:],
                          attn_chunk=attn_chunk, logit_chunk=logit_chunk,
                          per_example=per_example)
    if per_example:
        assert tuple(got[1].shape) == (B,)
        assert _rel(got[1], want[1]) <= RTOL
        got, want = got[0], want[0]
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_loss_gradient_matches_unchunked(arch, remat):
    _, jp, tcfg, toks = _setup(arch)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    t = torch.from_numpy(toks).long()

    def grads(**kw):
        params = _tparams(jp)
        leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
        ce, ce_ex = tlm.lm_loss(params, tcfg, t[:, :-1], t[:, 1:],
                                per_example=True, **kw)
        return ce, ce_ex, torch.autograd.grad(ce, leaves)

    ce0, ex0, g0 = grads()
    ce1, ex1, g1 = grads(attn_chunk=CHUNK, logit_chunk=CHUNK)
    assert _rel(ce1.detach(), ce0.detach()) <= RTOL
    assert _rel(ex1.detach(), ex0.detach()) <= RTOL
    for a, b in zip(g1, g0):
        assert _rel(a, b) <= RTOL


def test_logit_chunk_must_divide_length():
    _, jp, tcfg, toks = _setup(ARCHS[0])
    t = torch.from_numpy(toks).long()
    with pytest.raises(ValueError):
        tlm.lm_loss(_tparams(jp), tcfg, t[:, :-1], t[:, 1:], logit_chunk=5)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_attn_chunk_matches_jax(arch, ragged):
    jcfg, jp, tcfg, toks = _setup(arch)
    toks = toks[:, :L]
    lens = np.array([L, L - 7]) if ragged else None
    jl, jc = jax.jit(functools.partial(
        jlm.lm_prefill, cfg=jcfg, attn_chunk=CHUNK, cache_len=L))(
        jp, tokens=toks, prompt_lens=None if lens is None else
        jnp.asarray(lens))
    with torch.no_grad():
        tl, tc = tlm.lm_prefill(
            _tparams(jp), tcfg, torch.from_numpy(toks).long(),
            attn_chunk=CHUNK, cache_len=L,
            prompt_lens=None if lens is None else torch.from_numpy(lens))
    assert _rel(tl, jl) <= RTOL
    for name, leaf in jc["unit"].items():
        for kv in ("k", "v"):
            assert _rel(tc["unit"][name][kv], leaf[kv]) <= RTOL, (name, kv)


def test_train_config_chunks_train_in_the_port():
    """``TrainConfig(attn_chunk, logit_chunk)``: two LOTION steps of the
    port against JAX's with the same fields, and the port's chunked loss
    against its unchunked one."""
    jcfg, jp, tcfg, toks = _setup(ARCHS[0])
    kw = dict(method="lotion", fmt_name="int4", lam=1000.0)
    jt = JTrainConfig(quant=JQuantConfig(policy=JPolicy(min_size=256), **kw),
                      attn_chunk=CHUNK, logit_chunk=CHUNK)
    tx = j_make_optimizer(jt, j_adamw(j_constant(1e-3)))
    jstep = jax.jit(j_make_train_step(jcfg, jt, tx))
    jst = j_init_state(jp, tx)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tb = {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}
    losses = {}
    for chunk in (CHUNK, 0):
        tt = TrainConfig(quant=QuantConfig(policy=QuantPolicy(min_size=256),
                                           **kw),
                         attn_chunk=chunk, logit_chunk=chunk)
        opt = make_optimizer(tt, adamw(constant(1e-3)))
        step = make_train_step(tcfg, tt, opt)
        st = init_state(_tparams(jp), opt)
        losses[chunk] = []
        for _ in range(2):
            st, m = step(st, tb)
            losses[chunk].append(float(m["loss"]))
    for i in range(2):
        jst, jm = jstep(jst, batch)
        assert abs(losses[CHUNK][i] - float(jm["loss"])) <= RTOL * abs(
            float(jm["loss"]))
        assert abs(losses[CHUNK][i] - losses[0][i]) <= RTOL * abs(
            losses[0][i])
