"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, leaf by leaf, on the CPU.

For every config at full size (the port's specs from
``repro_torch.launch.specs`` on the meta device, JAX's from
``jax.eval_shape``: nothing is allocated) and at smoke size, every leaf's
spec equals JAX's: ``param_spec`` with FSDP on and off,
``params_shardings``, ``state_shardings`` over the fused core's and the
unfused chain's train state, and ``cache_spec`` / ``cache_shardings``
over ``init_cache`` (dense, int8 and int4 KV; SSM and RWKV states), on
meshes (16, 16), (2, 16, 16), (2, 4) and (1, 1) (JAX's side on an
``AbstractMesh``, the port's on an abstract ``Mesh``).  A spec compares
once both are written as tuples with a one-axis tuple entry as its axis
name (``PartitionSpec`` itself normalizes so).  Exact equality: the
rules are pure functions of names and shapes.
"""

import functools

import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core import QuantConfig as JQuantConfig
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.train import TrainConfig as JTrainConfig
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.core.modes import QuantConfig
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import Mesh, dp_axes
from repro_torch.models.lm import init_cache
from repro_torch.train import TrainConfig

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((1, 1), ("data", "model"))]
ARCH_IDS = ["granite-3-2b", "gemma2-2b", "codeqwen1.5-7b", "gemma3-12b",
            "musicgen-medium", "dbrx-132b", "moonshot-v1-16b-a3b",
            "zamba2-2.7b", "rwkv6-1.6b", "llama3.2-vision-11b"]
SIZES = ["full", "smoke"]


def _norm(spec):
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else (tuple(e) if e else None)
        out.append(e)
    return tuple(out)


def _jmesh(shape, axes):
    return AbstractMesh(tuple(shape), tuple(axes))


def _jpath(path):
    return "/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                    for p in path)


def _jflat(tree):
    return {_jpath(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {"/".join(str(k) for k in p): x
            for p, x in tsh.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _cfgs(arch, size):
    j = j_config(arch) if size == "full" else j_smoke(arch)
    t = get_config(arch) if size == "full" else get_smoke_config(arch)
    return j, t


@functools.lru_cache(maxsize=None)
def _params(arch, size):
    j, t = _cfgs(arch, size)
    return (jax.eval_shape(lambda k: jlm.lm_init(k, j), jax.random.PRNGKey(0)),
            tspecs.params_specs(t))


@functools.lru_cache(maxsize=None)
def _states(arch, size, ef):
    """LOTION's train state: the fused core's flat dict (JAX selects it
    with ``use_kernel``, the port always), or with EF compression the
    unfused chain's tuple of link states."""
    j, t = _cfgs(arch, size)
    kw = dict(method="lotion", lam=1000.0)
    return (jspecs.state_specs(j, JTrainConfig(
                quant=JQuantConfig(use_kernel=True, **kw), ef_compress=ef)),
            tspecs.state_specs(t, TrainConfig(quant=QuantConfig(**kw),
                                              ef_compress=ef)))


def test_arch_ids_are_the_jax_packages():
    assert len(ARCH_IDS) == len(ARCHS)
    for a in ARCH_IDS:
        assert j_config(a).name == get_config(a).name


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_every_leaf(arch, size):
    jp, tp = _params(arch, size)
    jf, tf = _jflat(jp), _tflat(tp)
    assert jf.keys() == tf.keys()
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, x in jleaves:
        key = _jpath(path)
        tpath = tuple(key.split("/"))
        assert tuple(tf[key].shape) == tuple(x.shape), key
        for fsdp in (True, False):
            assert _norm(tsh.param_spec(tpath, tf[key], fsdp=fsdp)) == \
                _norm(jsh.param_spec(path, x, fsdp=fsdp)), (key, fsdp)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_and_state_shardings(arch, size, mesh):
    jm, tm = _jmesh(*mesh), Mesh(*mesh)
    jp, tp = _params(arch, size)
    for fsdp in (True, False):
        j = _jflat(jsh.params_shardings(jm, jp, fsdp=fsdp))
        t = _tflat(tsh.params_shardings(tm, tp, fsdp=fsdp))
        assert j.keys() == t.keys()
        for k in j:
            assert _norm(t[k].spec) == _norm(j[k].spec), (k, fsdp)
    for ef in (False, True):      # the fused core's dict, the chain's tuple
        js, ts = _states(arch, size, ef)
        j = _jflat(jsh.state_shardings(jm, js))
        t = _tflat(tsh.state_shardings(tm, ts))
        assert j.keys() == t.keys(), (ef, set(j) ^ set(t))
        for k in j:
            assert _norm(t[k].spec) == _norm(j[k].spec), (k, ef)


KV = [False, "int8", "int4"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs(arch, mesh):
    jm, tm = _jmesh(*mesh), Mesh(*mesh)
    j_cfg, t_cfg = _cfgs(arch, "full")
    for (batch, length), kv in ((
            (SHAPES["decode_32k"]["global_batch"],
             SHAPES["decode_32k"]["seq_len"]), KV[0]),
            ((128, 4096), KV[1]), ((1, 8192), KV[2]), ((4, 1024), KV[1])):
        jc = jax.eval_shape(lambda: jlm.init_cache(j_cfg, batch, length,
                                                   kv_quant=kv))
        tc = init_cache(t_cfg, batch, length, kv_quant=kv, device="meta")
        jf, tf = _jflat(jc), _tflat(tc)
        assert jf.keys() == tf.keys(), (kv, set(jf) ^ set(tf))
        jshs = _jflat(jsh.cache_shardings(jm, jc, batch))
        tshs = _tflat(tsh.cache_shardings(tm, tc, batch))
        for path, x in jax.tree_util.tree_flatten_with_path(jc)[0]:
            k = _jpath(path)
            tpath = tuple(k.split("/"))
            assert tuple(tf[k].shape) == tuple(x.shape), k
            assert _norm(tsh.cache_spec(tpath, tf[k], tm, batch)) == \
                _norm(jsh.cache_spec(path, x, jm, batch)), (k, kv)
            assert _norm(tshs[k].spec) == _norm(jshs[k].spec), (k, kv)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_batch_specs_widen_dp_and_divisibility(mesh):
    jm, tm = _jmesh(*mesh), Mesh(*mesh)
    assert dp_axes(tm) == tuple(a for a in ("pod", "data")
                                if a in mesh[1])
    batches = sorted({s["global_batch"] for s in SHAPES.values()}
                     | {1, 2, 3, 6, 8, 12})
    for b in batches:
        assert _norm(tsh.data_batch_spec(tm, b)) == \
            _norm(jsh.data_batch_spec(jm, b)), b
        # tokens, labels and (b, n_image_tokens, d_vision) image embeddings
        jb = jspecs.train_batch_specs(j_smoke("llama3.2-vision-11b"), b, 7)
        tb = tspecs.train_batch_specs(
            get_smoke_config("llama3.2-vision-11b"), b, 7)
        j = _jflat(jsh.train_batch_shardings(jm, jb, b))
        t = _tflat(tsh.train_batch_shardings(tm, tb, b))
        assert j.keys() == t.keys() == {"tokens", "labels", "image_embeds"}
        for k in t:
            assert _norm(t[k].spec) == _norm(j[k].spec), (k, b)
    specs = [JP(), JP(None), JP("data"), JP("data", "model"),
             JP(None, ("data", "model")), JP(("pod", "data"), None),
             JP("model", "data", None)]
    for spec in specs:
        if any(a not in mesh[1] for e in spec if e is not None
               for a in (e if isinstance(e, tuple) else (e,))):
            continue
        t = tuple(spec)
        assert _norm(tsh.widen_dp(tm, t)) == _norm(jsh.widen_dp(jm, spec))
        for shape in ((49155, 2048), (48, 64), (3, 5), (256, 6144, 16)):
            if len(shape) < len(spec):
                continue
            assert _norm(tsh.fix_divisibility(tm, t, shape)) == \
                _norm(jsh.fix_divisibility(jm, spec, shape)), (spec, shape)


MESH = Mesh((16, 16), ("data", "model"))
MESH3 = Mesh((2, 16, 16), ("pod", "data", "model"))
P = tsh.P


def _spec(path, shape, **kw):
    import torch
    return tsh.param_spec(tuple(path), torch.empty(shape, device="meta"), **kw)


def test_param_spec_rules():
    assert _spec(("stage", "b0_attn", "attn", "wq"), (13, 64, 128)) == \
        P(None, "data", "model")
    assert _spec(("stage", "b0_attn", "attn", "wo"), (13, 128, 64)) == \
        P(None, "model", "data")
    assert _spec(("stage", "b0_attn", "moe", "w_up"), (13, 8, 64, 128)) == \
        P(None, "model", "data", None)
    assert _spec(("embed",), (1000, 64)) == P("model", "data")
    assert _spec(("stage", "b0_attn", "pre_norm_scale"), (13, 64)) == P(None)
    assert _spec(("final_norm_scale",), (64,)) == P()
    # tp-only profile: no data sharding of weights
    assert _spec(("stage", "b0", "attn", "wq"), (13, 64, 128), fsdp=False) \
        == P(None, None, "model")
    # QTensor children: the weight's rule, transposed (out-major storage)
    assert _spec(("stage", "b0_attn", "attn", "wq", "codes"),
                 (13, 128, 64)) == P(None, "model", "data")
    assert _spec(("embed", "codes"), (1000, 64)) == P("model", "data")


def test_batch_spec_divisibility():
    assert tsh.data_batch_spec(MESH, 256) == P(("data",))
    assert tsh.data_batch_spec(MESH3, 256) == P(("pod", "data"))
    assert tsh.data_batch_spec(MESH3, 1) == P(None)
    # batch 2: divisible by pod only
    assert tsh.data_batch_spec(MESH3, 2) == P(("pod",))


def test_cache_spec_rules():
    import torch

    def spec(path, shape, mesh, batch):
        return tsh.cache_spec(tuple(path), torch.empty(shape, device="meta"),
                              mesh, batch)

    # decode_32k: batch 128 shardable, len over model
    assert spec(("unit", "b0_attn", "k"), (32, 128, 32768, 8, 128), MESH,
                128) == P(None, ("data",), ("model",), None, None)
    # long_500k: batch 1 -> len over (data, model)
    assert spec(("unit", "b0_attn", "k"), (8, 1, 524288, 8, 256), MESH,
                1) == P(None, None, ("data", "model"), None, None)
    # quantized cache codes follow the same rule
    assert spec(("unit", "b0_attn", "k", "codes"), (32, 128, 32768, 8, 128),
                MESH, 128) == P(None, ("data",), ("model",), None, None)
    # ssm state: heads over model
    assert spec(("unit", "b0_mamba", "ssm"), (9, 1, 80, 64, 64), MESH,
                1) == P(None, None, "model", None, None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    """``launch/specs.py::input_specs`` for every cell of ``SHAPES``: the
    same leaves, shapes and dtypes as JAX's, on the meta device."""
    for shape_id in SHAPES:
        for kv in (False, "int8"):
            jcfg, jkind, js = jspecs.input_specs(arch, shape_id, kv_quant=kv)
            tcfg, tkind, ts = tspecs.input_specs(arch, shape_id, kv_quant=kv)
            assert (jkind, jcfg.name) == (tkind, tcfg.name)
            jf, tf = _jflat(js), _tflat(ts)
            assert jf.keys() == tf.keys(), (shape_id, set(jf) ^ set(tf))
            for k, x in jf.items():
                assert tuple(tf[k].shape) == tuple(x.shape), (shape_id, k)
                assert str(tf[k].dtype) == f"torch.{x.dtype}", (shape_id, k)
                assert tf[k].device.type == "meta"
