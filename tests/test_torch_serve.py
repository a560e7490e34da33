"""The port's serving slice against the JAX package on the CPU: prefill
logits and caches, decode steps and whole-engine greedy generations.

Weights come from the JAX ``lm_init`` and cross through ``bridge``.
Tolerances: fp32 logits 1e-5 relative to their max (summation order of
XLA's and torch's fp32 contractions); quantized KV codes may differ by one
step where a value sits on a rounding boundary and the two K projections
differ in the last bit; greedy tokens must be identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import lm as tlm
from repro_torch.serve import Engine, RejectedError, ServeConfig
from repro_torch.serve.engine import bucket_cache_len, prepare_params

# the tests/test_serve.py CFG
SERVE_CFG = jlm.LMConfig(name="s", n_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=2, d_ff=128, vocab=64, dtype=jnp.float32,
                         remat=False)
CONFIGS = {"serve": SERVE_CFG,
           "granite": jax_smoke_config("granite-3-2b"),
           "gemma2": jax_smoke_config("gemma2-2b")}
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]]
# jitted once per config: eager calls would retrace the layer scan each time
JAX_PREFILL = jax.jit(jlm.lm_prefill, static_argnames=(
    "cfg", "cache_len", "kv_quant"))
JAX_DECODE = jax.jit(jlm.lm_decode, static_argnames=("cfg",))


@functools.lru_cache(maxsize=None)
def _setup(name):
    jcfg = CONFIGS[name]
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, bridge.lm_config(jcfg), tparams


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _check_cache(tc, jc):
    """Stacked caches: dense leaves to 1e-5, quantized codes within one
    step (boundary flips from last-bit K differences) and scales 1e-5."""
    for name, leaf in jc["unit"].items():
        for kv in ("k", "v"):
            j, t = leaf[kv], tc["unit"][name][kv]
            if isinstance(j, dict):
                jcodes = np.asarray(j["codes"]).astype(np.int32)
                tcodes = t["codes"].numpy().astype(np.int32)
                if t["codes"].dtype == torch.uint8:    # compare nibbles
                    jcodes = np.stack([jcodes & 15, jcodes >> 4], -1)
                    tcodes = np.stack([tcodes & 15, tcodes >> 4], -1)
                    diff = np.minimum(np.abs(jcodes - tcodes),
                                      16 - np.abs(jcodes - tcodes))
                else:
                    diff = np.abs(jcodes - tcodes)
                assert diff.max() <= 1, (name, kv)
                assert (diff > 0).mean() < 0.01, (name, kv)
                assert _rel(t["scale"].numpy(), j["scale"]) < 1e-5
            else:
                assert _rel(t.numpy(), j) < 1e-5, (name, kv)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
def test_prefill_and_decode_match_jax(name, kv_quant):
    jcfg, jparams, tcfg, tparams = _setup(name)
    b, l, cache_len = 3, 9, 16
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, size=(b, l)).astype(np.int32)
    lens = np.array([9, 4, 1], np.int32)
    jl, jc = JAX_PREFILL(jparams, cfg=jcfg, tokens=jnp.asarray(toks),
                         cache_len=cache_len, kv_quant=kv_quant,
                         prompt_lens=jnp.asarray(lens))
    tl, tc = tlm.lm_prefill(tparams, tcfg, torch.as_tensor(toks).long(),
                            cache_len=cache_len, kv_quant=kv_quant,
                            prompt_lens=torch.as_tensor(lens).long())
    assert tuple(tl.shape) == jl.shape
    assert _rel(tl.numpy(), jl) < 1e-5
    _check_cache(tc, jc)
    # 4 decode steps fed the same tokens (JAX's greedy ones)
    pos = lens.astype(np.int32) - 1
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
        pos = pos + 1
        jl, jc = JAX_DECODE(jparams, cfg=jcfg, cache=jc,
                            tokens=jnp.asarray(nxt), pos=jnp.asarray(pos))
        tl, tc2 = tlm.lm_decode(tparams, tcfg, tc, torch.as_tensor(nxt).long(),
                                torch.as_tensor(pos).long())
        assert tc2 is tc                      # updated in place
        assert _rel(tl.numpy(), jl) < 1e-5
    _check_cache(tc, jc)


@pytest.mark.parametrize("weights", ["fp32", "rtn:int8", "rtn:int4"])
@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
def test_engine_tokens_match_jax(weights, kv_quant):
    jcfg, jparams, tcfg, tparams = _setup("serve")
    jeng = JEngine(jcfg, jparams, JServeConfig(weights=weights,
                                               kv_quant=kv_quant,
                                               max_new_tokens=8))
    teng = Engine(tcfg, tparams, ServeConfig(weights=weights,
                                             kv_quant=kv_quant,
                                             max_new_tokens=8), device="cpu")
    assert teng.generate(PROMPTS) == jeng.generate(PROMPTS)


@pytest.mark.parametrize("name", ["granite", "gemma2"])
def test_engine_tokens_match_jax_smoke_configs(name):
    jcfg, jparams, tcfg, tparams = _setup(name)
    scfg = dict(weights="rtn:int4", kv_quant="int8", max_new_tokens=6)
    jout = JEngine(jcfg, jparams, JServeConfig(**scfg)).generate(PROMPTS)
    tout = Engine(tcfg, tparams, ServeConfig(**scfg),
                  device="cpu").generate(PROMPTS)
    assert tout == jout


def test_engine_per_request_budgets_and_eos():
    """Per-request budgets truncate each row; a row stops at (and
    includes) its EOS.  The EOS is a token that does not occur earlier in
    the row, so the stop position is the one the test intends."""
    _, _, tcfg, tparams = _setup("serve")
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=8), device="cpu")
    prompts = [[1, 2, 3], [9, 8, 7]]
    base = eng.generate(prompts)
    assert eng.generate(prompts, max_new_tokens=[3, 7]) == \
        [base[0][:3], base[1][:7]]
    # the first row holding a token that did not occur earlier in it
    r, stop = next((r, i) for r, row in enumerate(base)
                   for i in range(1, len(row)) if row[i] not in row[:i])
    eos = base[r][stop]
    eos_ids = [eos if i == r else None for i in range(len(prompts))]
    stopped = eng.generate(prompts, max_new_tokens=8, eos_id=eos_ids)
    assert stopped[r] == base[r][:stop + 1] and stopped[r][-1] == eos
    assert all(stopped[i] == base[i] for i in range(len(prompts)) if i != r)
    with pytest.raises(ValueError, match="entries"):
        eng.generate([[1]], max_new_tokens=[1, 2])


@pytest.mark.parametrize("prompt,reason", [([], "empty_prompt"),
                                           ([1, 64], "oov_token"),
                                           ([-1], "oov_token")])
def test_engine_rejects_malformed_prompts(prompt, reason):
    _, _, tcfg, tparams = _setup("serve")
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=2), device="cpu")
    with pytest.raises(RejectedError) as e:
        eng.generate([[1, 2], prompt])
    assert e.value.reason == reason


def test_cpu_runs_leave_launch_counters_at_zero():
    _, _, tcfg, tparams = _setup("serve")
    reset_launch_counts()
    eng = Engine(tcfg, tparams, ServeConfig(weights="rtn:int4",
                                            kv_quant="int4",
                                            max_new_tokens=3), device="cpu")
    eng.generate(PROMPTS)
    counts = launch_counts()
    assert counts["wqt_matmul"] == counts["decode_attn"] == 0
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_serving_gates_match_jax(name):
    from repro.serve.engine import attn_only as jattn_only
    from repro.serve.engine import full_ring as jfull_ring
    from repro_torch.serve.engine import attn_only, full_ring
    jcfg, _, tcfg, _ = _setup(name)
    assert attn_only(tcfg) == jattn_only(jcfg)
    for cache_len in (4, 8, 16, 64):
        assert full_ring(tcfg, cache_len) == jfull_ring(jcfg, cache_len)


def test_bucket_cache_len_matches_jax():
    from repro.serve.engine import bucket_cache_len as jbucket
    for n in list(range(0, 70)) + [1000, 4097]:
        assert bucket_cache_len(n) == jbucket(n)


@pytest.mark.parametrize("scfg,exc", [
    (ServeConfig(use_kernel=True), ValueError),
])
def test_features_outside_the_slice_raise(scfg, exc):
    _, _, tcfg, tparams = _setup("serve")
    with pytest.raises(exc):
        Engine(tcfg, tparams, scfg, device="cpu")


def _jax_serve_draws(jparams, scfg):
    """The uniforms JAX's prepare_params draws for ``scfg`` (key
    PRNGKey(seed), eligible leaf i from fold_in(key, i) in JAX's tree
    order), in the shape each cast sees: the stored orientation for the
    leaves that become QTensors, the leaf's own otherwise."""
    from repro.core import QuantPolicy as JPolicy
    from repro.core.formats import IntFormat as JIntFormat
    from repro.core.formats import get_format as jget_format
    from repro.core.qtensor import _NATURAL_LEAVES, _convertible
    fmt = jget_format(scfg.weights.split(":")[1])
    storage = scfg.quantized_storage
    if storage is None:
        storage = isinstance(fmt, JIntFormat) and fmt.bits in (4, 8)
    policy, key = JPolicy(), jax.random.PRNGKey(scfg.seed)
    out, counter = {}, [0]

    def leaf(path, x):
        if policy.eligible(path, x):
            counter[0] += 1
            last = str(path[-1].key).lower()
            shape = x.shape
            if storage and _convertible(last, x, fmt, -1) \
                    and last not in _NATURAL_LEAVES:
                shape = shape[:-2] + (shape[-1], shape[-2])
            out["/".join(str(p.key) for p in path).lower()] = \
                torch.from_numpy(np.array(jax.random.uniform(
                    jax.random.fold_in(key, counter[0]), shape, x.dtype)))
        return x

    jax.tree_util.tree_map_with_path(leaf, jparams)
    return out


@pytest.mark.parametrize("weights,storage", [
    ("rr:int4", None), ("rtn:fp4", None), ("rtn:int4", False),
    ("rr:int8", None)])
def test_rr_and_dense_cast_serving_match_jax(weights, storage):
    """RR casts into QTensor storage and the dense-cast path (fp4, and
    int4 with ``quantized_storage=False``): the prepared weights bitwise
    (fed JAX's draws for rr:) and the engine's greedy tokens equal."""
    jcfg, jparams, tcfg, tparams = _setup("serve")
    from repro.serve.engine import prepare_params as jprepare
    jscfg = JServeConfig(weights=weights, quantized_storage=storage,
                         max_new_tokens=6, seed=3)
    tscfg = ServeConfig(weights=weights, quantized_storage=storage,
                        max_new_tokens=6, seed=3)
    uniforms = (_jax_serve_draws(jparams, jscfg)
                if weights.startswith("rr") else None)
    got = prepare_params(tparams, tscfg, "cpu", uniforms=uniforms)
    want = bridge.flatten(bridge.to_numpy(bridge.to_torch(jax.tree.map(
        np.asarray, jprepare(jparams, jscfg)))))
    flat = bridge.flatten(bridge.to_numpy(got))
    assert set(flat) == set(want)
    for path, t in flat.items():
        if isinstance(t, dict):
            for f in ("codes", "scales"):
                np.testing.assert_array_equal(t[f], want[path][f])
        else:
            np.testing.assert_array_equal(t, want[path])
    teng = Engine(tcfg, got, ServeConfig(weights="fp32", max_new_tokens=6),
                  device="cpu")
    jeng = JEngine(jcfg, jparams, jscfg)
    assert teng.generate(PROMPTS) == jeng.generate(PROMPTS)
    # without uniforms the engine draws from a generator seeded with seed
    assert Engine(tcfg, tparams, tscfg, device="cpu").generate(PROMPTS)


def test_unported_block_kinds_raise():
    """Every block kind is ported now (MoE: test_torch_moe.py; SSM:
    test_torch_ssm.py; cross-attention: test_torch_xattn.py): the vision
    config initialises, and the static Engine, which takes token prompts
    only as JAX's does, refuses it and names the path that serves it."""
    from repro.configs import get_smoke_config
    for arch in ("llama3.2-vision-11b",):
        cfg = bridge.lm_config(get_smoke_config(arch))
        params = tlm.lm_init(cfg, 0, "cpu")
        assert params["vision_proj"].shape == (cfg.d_vision, cfg.d_model)
        with pytest.raises(ValueError, match=r"lm_prefill\(image_embeds"):
            Engine(cfg, params, ServeConfig(), device="cpu")


def test_paged_decode_raises():
    """Paged decode is ported; it refuses a block size that is not the
    pool's block length."""
    _, _, tcfg, tparams = _setup("serve")
    pool = tlm.init_cache(tcfg, 4, 8, kv_quant="int8", device="cpu")
    tables = torch.zeros(1, 2, dtype=torch.int32)
    for block_size in (0, 4):
        with pytest.raises(ValueError, match="block_size"):
            tlm.lm_decode(tparams, tcfg, pool, torch.zeros(1, 1).long(),
                          torch.zeros(1).long(), block_tables=tables,
                          block_size=block_size)


def test_prepare_params_rtn_int4_stores_qtensors():
    _, _, tcfg, tparams = _setup("serve")
    from repro_torch.core import has_qtensor
    q = prepare_params(tparams, ServeConfig(weights="rtn:int4"), "cpu")
    assert has_qtensor(q)
    assert prepare_params(tparams, ServeConfig(), "cpu")["embed"] is \
        tparams["embed"]
