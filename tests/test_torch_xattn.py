"""Cross-attention (``xattn``, Llama-3.2-Vision) of the port against the
JAX package on the CPU, at the smoke config and on single layers.

Inputs come from numpy seeds: tokens, image embeddings (b,
n_image_tokens, d_vision), activations and contexts.  Weights come from
the JAX ``lm_init`` through ``bridge``, with every ``xattn_gate`` drawn
uniform in [0.25, 0.75] per repeat (JAX initialises the gates to zero,
where the cross path adds nothing to the residual).  Tolerances, fp32,
relative to the largest value compared: layer outputs and cross K/V
1e-5 (XLA's and torch's contractions sum in other orders); model logits
1e-5; the cross K/V of a prefill cache 1e-5; decode and chunked-prefill
logits 1e-5 against JAX's and 1e-4 against the port's own full forward.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import qtensor as jqt
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qtensor import QTensor
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serve import Engine, Scheduler, SchedulerConfig, ServeConfig
from repro_torch.serve.engine import prepare_params

ARCH = "llama3.2-vision-11b"
RTOL = 1e-5
CONSISTENCY_RTOL = 1e-4
B, L = 2, 10


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _open_gates(jparams, jcfg, seed=0):
    rng = np.random.default_rng(seed)
    for i, kind in enumerate(jcfg.pattern):
        if kind == "xattn":
            jparams["stage"][f"b{i}_{kind}"]["xattn_gate"] = jnp.asarray(
                rng.uniform(0.25, 0.75, jcfg.n_repeats).astype(np.float32))
    return jparams


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = j_smoke(ARCH)
    jparams = _open_gates(jlm.lm_init(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, jparams, bridge.lm_config(jcfg)


@functools.lru_cache(maxsize=None)
def _jax_int4():
    """JAX's int4 serving tree of the gated smoke weights."""
    return jqt.quantize_params(_setup()[1], "int4", JPolicy(min_size=256), -1)


def _tparams(jparams=None):
    return bridge.to_torch(jax.tree.map(np.asarray,
                                        jparams or _setup()[1]))


def _tokens(cfg, b=B, l=L, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, l),
                                                dtype=np.int32)


def _images(cfg, b=B, seed=0):
    return np.random.default_rng(100 + seed).standard_normal(
        (b, cfg.n_image_tokens, cfg.d_vision)).astype(np.float32)


# --- one layer ----------------------------------------------------------------

# (qk_norm, softcap): the vision config's plain layer, and the two options
# a cross layer could carry
SPECS = [(False, None), (True, 30.0)]


def _layer(qk_norm, softcap, seed=0):
    """A cross-attention spec, JAX params (with non-unit QK-norm scales)
    and the same params in torch."""
    jspec = jlayers.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2,
                             head_dim=8, softcap=softcap, qk_norm=qk_norm,
                             is_cross=True)
    jp = jlayers.attn_init(jax.random.PRNGKey(seed), jspec)
    if qk_norm:
        rng = np.random.default_rng(seed)
        for k in ("q_norm_scale", "k_norm_scale"):
            jp[k] = jnp.asarray(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    tspec = tlayers.AttnSpec(**dataclasses.asdict(jspec))
    return jspec, jp, tspec, bridge.to_torch(jax.tree.map(np.asarray, jp))


def _acts(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("qk_norm,softcap", SPECS)
def test_attn_apply_cross_branch_matches_jax(qk_norm, softcap, ragged, chunk):
    """q from x, k and v from the context, no RoPE, not causal: the output
    and the returned cross (k, v), with the full score tensor or streamed
    over key chunks of 3 (a ragged last chunk of the 7 context tokens),
    with shared or per-row (left-padded) query positions."""
    jspec, jp, tspec, tp = _layer(qk_norm, softcap)
    x, ctx = _acts((B, 5, 32), 1), _acts((B, 7, 32), 2)
    pos = (np.arange(5)[None, :] - np.array([[0], [2]]) if ragged
           else np.arange(5)).astype(np.int32)
    jo, (jk, jv) = jlayers.attn_apply(jp, jspec, jnp.asarray(x),
                                      jnp.asarray(pos), ctx=jnp.asarray(ctx),
                                      chunk=chunk, return_kv=True)
    to, (tk, tv) = tlayers.attn_apply(tp, tspec, _t(x), _t(pos).long(),
                                      ctx=_t(ctx), chunk=chunk,
                                      return_kv=True)
    assert tk.shape == (B, 7, 2, 8)
    for got, want in ((to, jo), (tk, jk), (tv, jv)):
        assert _rel(got.numpy(), want) <= RTOL


def test_attn_apply_cross_needs_its_context():
    _, _, tspec, tp = _layer(False, None)
    with pytest.raises(ValueError, match="ctx=None"):
        tlayers.attn_apply(tp, tspec, _t(_acts((B, 5, 32), 1)),
                           torch.arange(5))


@pytest.mark.parametrize("qk_norm,softcap", SPECS)
def test_attn_decode_cross_branch_matches_jax(qk_norm, softcap):
    """One token against the cached cross K/V: q only, a softmax over
    every context token; the caches come back as they were."""
    jspec, jp, tspec, tp = _layer(qk_norm, softcap)
    x = _acts((B, 1, 32), 3)
    ck, cv = _acts((B, 7, 2, 8), 4), _acts((B, 7, 2, 8), 5)
    pos = np.array([4, 9], np.int32)
    jo, jck, jcv = jlayers.attn_decode(jp, jspec, jnp.asarray(x),
                                       jnp.asarray(pos), jnp.asarray(ck),
                                       jnp.asarray(cv),
                                       cross_kv=(jnp.asarray(ck),
                                                 jnp.asarray(cv)))
    tck, tcv = _t(ck), _t(cv)
    to, ock, ocv = tlayers.attn_decode(tp, tspec, _t(x), _t(pos).long(),
                                       tck, tcv, cross_kv=(tck, tcv))
    assert ock is tck and ocv is tcv
    np.testing.assert_array_equal(ock.numpy(), ck)
    assert _rel(to.numpy(), jo) <= RTOL


@pytest.mark.parametrize("qk_norm,softcap", SPECS)
def test_attn_chunk_apply_cross_branch_matches_jax(qk_norm, softcap):
    """A prompt chunk (right-padded rows) against the cached cross K/V:
    plain non-causal attention, the cache left as it is."""
    jspec, jp, tspec, tp = _layer(qk_norm, softcap)
    x = _acts((B, 4, 32), 6)
    ck, cv = _acts((B, 7, 2, 8), 7), _acts((B, 7, 2, 8), 8)
    pos = (np.array([[3], [6]]) + np.arange(4)[None, :]).astype(np.int32)
    lens = np.array([4, 2], np.int32)
    jo, _, _ = jlayers.attn_chunk_apply(jp, jspec, jnp.asarray(x),
                                        jnp.asarray(pos), jnp.asarray(lens),
                                        jnp.asarray(ck), jnp.asarray(cv))
    tck = _t(ck)
    to, ock, _ = tlayers.attn_chunk_apply(tp, tspec, _t(x), _t(pos).long(),
                                          _t(lens).long(), tck, _t(cv))
    assert ock is tck
    np.testing.assert_array_equal(ock.numpy(), ck)
    assert _rel(to.numpy(), jo) <= RTOL


# --- the model ------------------------------------------------------------------

def test_config_is_the_jax_config_and_the_tree_its_tree():
    """``get_config`` / ``get_smoke_config`` give JAX's configs, and
    ``lm_init`` the JAX tree's leaves and shapes: ``vision_proj``
    (d_vision, d_model) and one zero ``xattn_gate`` per repeat."""
    from repro.configs import get_config as j_full
    assert get_config(ARCH) == bridge.lm_config(j_full(ARCH))
    jcfg, jparams, tcfg = _setup()
    assert get_smoke_config(ARCH) == tcfg
    mine = bridge.flatten(tlm.lm_init(tcfg, 0, "cpu"))
    theirs = bridge.flatten(jax.tree.map(np.asarray, jparams))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in theirs.items()}
    assert mine["vision_proj"].shape == (tcfg.d_vision, tcfg.d_model)
    assert not mine["stage/b1_xattn/xattn_gate"].any()


@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_prefill_decode_match_jax_with_a_dense_cross_cache(kv):
    """``lm_prefill(image_embeds=...)`` and two ``lm_decode`` steps against
    JAX's on the same cache length: the logits, and a cache whose cross
    K/V stay dense in ``dtype`` (never codes) under every ``kv_quant``
    while the self-attention rings are codes; ``init_cache`` gives the
    same layout; the decode steps against the port's full forward."""
    jcfg, jparams, tcfg = _setup()
    toks, img = _tokens(jcfg, seed=1), _images(jcfg, seed=1)
    params = _tparams()
    tt, ti = _t(toks).long(), _t(img)
    n = L - 2
    with torch.no_grad():
        full = tlm.lm_forward(params, tcfg, tt, image_embeds=ti).numpy()
        lp, cache = tlm.lm_prefill(params, tcfg, tt[:, :n], cache_len=L,
                                   kv_quant=kv, image_embeds=ti)
        steps = [tlm.lm_decode(params, tcfg, cache, tt[:, p:p + 1],
                               torch.full((B,), p))[0] for p in (n, n + 1)]
    jlp, jc = jlm.lm_prefill(jparams, jcfg, jnp.asarray(toks[:, :n]),
                             image_embeds=jnp.asarray(img), cache_len=L,
                             kv_quant=kv)
    jsteps = []
    for p in (n, n + 1):
        lg, jc = jlm.lm_decode(jparams, jcfg, jc, jnp.asarray(toks[:, p:p + 1]),
                               jnp.full((B,), p, jnp.int32))
        jsteps.append(lg)
    assert _rel(lp, jlp) <= RTOL
    for got, want, p in zip(steps, jsteps, (n, n + 1)):
        assert _rel(got, want) <= RTOL
        if not kv:
            assert _rel(got[:, 0], full[:, p]) <= CONSISTENCY_RTOL
    xc, jxc = cache["unit"]["b1_xattn"], jc["unit"]["b1_xattn"]
    for k in ("k", "v"):
        assert isinstance(xc[k], torch.Tensor) and xc[k].dtype == tcfg.dtype
        assert xc[k].shape == (tcfg.n_repeats, B, tcfg.n_image_tokens,
                               tcfg.n_kv_heads, tcfg.hd)
        assert _rel(xc[k].numpy(), jxc[k]) <= RTOL
        assert isinstance(cache["unit"]["b0_attn"][k], dict) == bool(kv)
    empty = tlm.init_cache(tcfg, B, L, dtype=tcfg.dtype, kv_quant=kv,
                           device="cpu")
    jempty = jlm.init_cache(jcfg, B, L, dtype=jnp.float32, kv_quant=kv)
    got = bridge.flatten(bridge.to_numpy(empty))
    want = bridge.flatten(jax.tree.map(np.asarray, jempty))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert {k: v.dtype for k, v in got.items()} == {
        k: v.dtype for k, v in want.items()}


def test_ragged_prefill_matches_jax():
    """Left-padded prompts (``prompt_lens``): per-row query positions
    against the position-free cross keys, then a decode step."""
    jcfg, jparams, tcfg = _setup()
    toks, img = _tokens(jcfg, seed=2), _images(jcfg, seed=2)
    lens = np.array([L, L - 3], np.int32)
    params = _tparams()
    with torch.no_grad():
        lp, cache = tlm.lm_prefill(params, tcfg, _t(toks).long(),
                                   cache_len=16, prompt_lens=_t(lens).long(),
                                   kv_quant="int8", image_embeds=_t(img))
        ld, _ = tlm.lm_decode(params, tcfg, cache, _t(toks[:, :1]).long(),
                              _t(lens).long())
    jlp, jc = jlm.lm_prefill(jparams, jcfg, jnp.asarray(toks),
                             image_embeds=jnp.asarray(img), cache_len=16,
                             kv_quant="int8", prompt_lens=jnp.asarray(lens))
    jld, _ = jlm.lm_decode(jparams, jcfg, jc, jnp.asarray(toks[:, :1]),
                           jnp.asarray(lens))
    assert _rel(lp, jlp) <= RTOL and _rel(ld, jld) <= RTOL


def test_prefill_chunk_reads_the_cross_cache_like_jax():
    """``lm_prefill_chunk`` over a dense cache whose cross K/V a prefill
    wrote: the cross blocks attend it and write nothing; logits against
    JAX's and against the full forward."""
    jcfg, jparams, tcfg = _setup()
    toks, img = _tokens(jcfg, seed=3), _images(jcfg, seed=3)
    params = _tparams()
    n, cw = 4, 6
    with torch.no_grad():
        full = tlm.lm_forward(params, tcfg, _t(toks).long(),
                              image_embeds=_t(img)).numpy()
        _, cache = tlm.lm_prefill(params, tcfg, _t(toks[:, :n]).long(),
                                  cache_len=16, image_embeds=_t(img))
        before = cache["unit"]["b1_xattn"]["k"].clone()
        lg, cache = tlm.lm_prefill_chunk(
            params, tcfg, cache, _t(toks[:, n:n + cw]).long(),
            torch.full((B,), n))
    _, jc = jlm.lm_prefill(jparams, jcfg, jnp.asarray(toks[:, :n]),
                           image_embeds=jnp.asarray(img), cache_len=16)
    jlg, _ = jlm.lm_prefill_chunk(jparams, jcfg, jc,
                                  jnp.asarray(toks[:, n:n + cw]),
                                  jnp.full((B,), n, jnp.int32))
    assert _rel(lg, jlg) <= RTOL
    assert _rel(lg[:, 0], full[:, n + cw - 1]) <= CONSISTENCY_RTOL
    assert torch.equal(cache["unit"]["b1_xattn"]["k"], before)


def test_vision_proj_is_packed_as_jax_packs_it():
    """``prepare_params`` (rtn:int4) makes ``vision_proj`` a QTensor with
    JAX's codes, as it does every other weight matrix JAX packs; the
    gates (one scalar per repeat) stay dense and unchanged."""
    want = bridge.flatten(jax.tree.map(np.asarray, _jax_int4()))
    got = bridge.flatten(prepare_params(
        _tparams(), ServeConfig(weights="rtn:int4",
                                policy=QuantPolicy(min_size=256)), "cpu"))
    assert set(got) == set(want)
    assert {k for k, v in got.items() if isinstance(v, QTensor)} == {
        k for k, v in want.items() if hasattr(v, "codes")}
    vp = got["vision_proj"]
    assert isinstance(vp, QTensor)
    np.testing.assert_array_equal(vp.codes.numpy(),
                                  want["vision_proj"].codes)
    gate = got["stage/b1_xattn/xattn_gate"]
    assert not isinstance(gate, QTensor)
    np.testing.assert_array_equal(gate.numpy(),
                                  want["stage/b1_xattn/xattn_gate"])


def test_packed_vision_proj_serves_like_jax():
    """Prefill through the packed tree (int4 QTensors, ``vision_proj``
    among them) and a decode step: JAX's logits."""
    jcfg, _, tcfg = _setup()
    toks, img = _tokens(jcfg, seed=4), _images(jcfg, seed=4)
    jq = _jax_int4()
    tq = prepare_params(_tparams(), ServeConfig(
        weights="rtn:int4", policy=QuantPolicy(min_size=256)), "cpu")
    with torch.no_grad():
        lp, cache = tlm.lm_prefill(tq, tcfg, _t(toks).long(), cache_len=16,
                                   image_embeds=_t(img))
        ld, _ = tlm.lm_decode(tq, tcfg, cache, _t(toks[:, :1]).long(),
                              torch.full((B,), L))
    jlp, jc = jlm.lm_prefill(jq, jcfg, jnp.asarray(toks),
                             image_embeds=jnp.asarray(img), cache_len=16)
    jld, _ = jlm.lm_decode(jq, jcfg, jc, jnp.asarray(toks[:, :1]),
                           jnp.full((B,), L, jnp.int32))
    assert _rel(lp, jlp) <= RTOL and _rel(ld, jld) <= RTOL


def test_missing_images_raise_a_value_error():
    """Where JAX fails with an AttributeError (``_qkv`` projects
    ``ctx=None``), the port names the missing image embeddings."""
    jcfg, jparams, tcfg = _setup()
    toks = _t(_tokens(jcfg)).long()
    params = _tparams()
    with pytest.raises(AttributeError):
        jlm.lm_forward(jparams, jcfg, jnp.asarray(toks.numpy()))
    for call in (lambda: tlm.lm_forward(params, tcfg, toks),
                 lambda: tlm.lm_prefill(params, tcfg, toks),
                 lambda: tlm.lm_loss(params, tcfg, toks, toks)):
        with pytest.raises(ValueError, match="image_embeds"):
            call()


def test_engine_and_scheduler_refuse_the_vision_config():
    """JAX's ``Engine.generate`` and per-slot admission never pass image
    embeddings (the Engine fails with an AttributeError); the port's
    Engine and Scheduler refuse the config up front and name the path
    that serves it."""
    from repro.serve import Engine as JEngine
    from repro.serve import ServeConfig as JServeConfig
    jcfg, jparams, tcfg = _setup()
    with pytest.raises(AttributeError):
        JEngine(jcfg, jparams, JServeConfig(max_new_tokens=2)).generate(
            [[1, 2, 3]])
    for make in (lambda: Engine(tcfg, _tparams(), ServeConfig(),
                                device="cpu"),
                 lambda: Scheduler(tcfg, _tparams(), ServeConfig(),
                                   SchedulerConfig(cache_len=32),
                                   device="cpu")):
        with pytest.raises(ValueError, match=r"lm_prefill\(image_embeds"):
            make()


def test_zero_gates_shut_the_cross_path():
    """With JAX's initial gates (zero) the image changes nothing: the
    logits of two different images are the same, bitwise, and equal
    JAX's."""
    jcfg, _, tcfg = _setup()
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    params = _tparams(jparams)
    toks = _t(_tokens(jcfg, seed=5)).long()
    with torch.no_grad():
        a = tlm.lm_forward(params, tcfg, toks,
                           image_embeds=_t(_images(jcfg, seed=5)))
        b = tlm.lm_forward(params, tcfg, toks,
                           image_embeds=_t(_images(jcfg, seed=6)))
    assert torch.equal(a, b)
    want = jlm.lm_forward(jparams, jcfg, jnp.asarray(toks.numpy()),
                          image_embeds=jnp.asarray(_images(jcfg, seed=5)))
    assert _rel(a.numpy(), want) <= RTOL


def test_open_gates_make_the_image_matter():
    """With the gates open the logits move with the image (each row with
    its own image), in the port as in JAX."""
    jcfg, jparams, tcfg = _setup()
    toks = _tokens(jcfg, seed=7)
    img_a, img_b = _images(jcfg, seed=7), _images(jcfg, seed=8)
    params = _tparams()
    with torch.no_grad():
        a = tlm.lm_forward(params, tcfg, _t(toks).long(),
                           image_embeds=_t(img_a)).numpy()
        b = tlm.lm_forward(params, tcfg, _t(toks).long(),
                           image_embeds=_t(img_b)).numpy()
    ja = jlm.lm_forward(jparams, jcfg, jnp.asarray(toks),
                        image_embeds=jnp.asarray(img_a))
    jb = jlm.lm_forward(jparams, jcfg, jnp.asarray(toks),
                        image_embeds=jnp.asarray(img_b))
    assert _rel(a, ja) <= RTOL and _rel(b, jb) <= RTOL
    for row in range(B):
        assert _rel(a[row], b[row]) > 1e-3, row
