"""The bridge between the JAX package and the port, and the port's
package rules: exact round trips (bf16 and QTensors included), the
LMConfig field set, no JAX or ``repro`` import anywhere in the port or in
``chip_smoke.py``, and entry points that refuse to run without CUDA
unless the caller asks for the CPU.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as jqt
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.core.qtensor import QTensor
from repro_torch.models import lm as tlm

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = jlm.LMConfig(name="b", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=64, dtype=jnp.float32, remat=False)


def _assert_same(a, b):
    fa, fb = bridge.flatten(a), bridge.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(y, dict) or hasattr(y, "codes"):
            y = y if isinstance(y, dict) else vars(y)
            x = x if isinstance(x, dict) else vars(x)
            for f in ("codes", "scales"):
                assert np.asarray(x[f]).dtype == np.asarray(y[f]).dtype
                np.testing.assert_array_equal(np.asarray(x[f]),
                                              np.asarray(y[f]))
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_round_trip_is_exact(dtype):
    params = jax.tree.map(lambda a: np.asarray(a.astype(dtype)),
                          jlm.lm_init(jax.random.PRNGKey(0), CFG))
    tp = bridge.to_torch(params)
    assert tp["stage"]["b0_attn"]["attn"]["wq"].shape == (2, 64, 64)
    want = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    assert tp["embed"].dtype == want
    _assert_same(bridge.to_numpy(tp), params)


def test_qtensor_tree_round_trip():
    jq = jqt.quantize_params(jlm.lm_init(jax.random.PRNGKey(0), CFG), "int4")
    npq = jax.tree.map(np.asarray, jq)
    tq = bridge.to_torch(npq)
    wq = tq["stage"]["b0_attn"]["attn"]["wq"]
    assert isinstance(wq, QTensor) and wq.bits == 4 and wq.block_k == -1
    assert wq.codes.dtype == torch.uint8 and wq.codes.shape == (2, 64, 32)
    back = bridge.to_numpy(tq)
    _assert_same(back, npq)
    assert bridge.to_torch(back)["stage"]["b0_attn"]["attn"]["wq"].bits == 4


def test_flatten_keys_are_path_str():
    keys = bridge.flatten(bridge.to_torch(jax.tree.map(
        np.asarray, jlm.lm_init(jax.random.PRNGKey(0), CFG))))
    assert "stage/b0_attn/attn/wq" in keys and "embed" in keys


def test_lm_config_fields_match_jax():
    jf = [f.name for f in dataclasses.fields(jlm.LMConfig)]
    tf = [f.name for f in dataclasses.fields(tlm.LMConfig)]
    assert tf == jf
    cfg = bridge.lm_config(CFG)
    assert cfg.dtype == torch.float32 and cfg.hd == CFG.hd
    assert tlm.LMConfig(name="x", n_layers=1, d_model=8, n_heads=2,
                        n_kv_heads=1, d_ff=8, vocab=8).dtype == torch.bfloat16


def test_serve_config_fields_match_jax():
    from repro.serve import ServeConfig as JServeConfig
    from repro_torch.serve import ServeConfig
    assert [f.name for f in dataclasses.fields(ServeConfig)] == \
        [f.name for f in dataclasses.fields(JServeConfig)]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted(ROOT.glob("examples/*_torch.py"))
    files += sorted(ROOT.glob("scripts/*_torch.py"))
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, mod)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import prepare_params
    cfg = bridge.lm_config(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.lm_init(cfg, 0)
    params = tlm.lm_init(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_params(params, ServeConfig(weights="rtn:int4"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_cache(cfg, 1, 16)


def test_lm_init_shapes_and_scales_match_jax():
    cfg = bridge.lm_config(CFG)
    tp = bridge.flatten(tlm.lm_init(cfg, 0, device="cpu"))
    jp = bridge.flatten(jax.tree.map(np.asarray,
                                     jlm.lm_init(jax.random.PRNGKey(0), CFG)))
    assert tp.keys() == jp.keys()
    for k, j in jp.items():
        t = tp[k].numpy()
        assert t.shape == j.shape and t.dtype == j.dtype, k
        np.testing.assert_allclose(t.std(), j.std(), rtol=0.15, atol=1e-7)
