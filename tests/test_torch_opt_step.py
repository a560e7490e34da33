"""The ``opt_step`` kernel's plain path (``fused_opt_step_leaf`` on CPU
tensors, i.e. ``opt_step_ref``) against the JAX package on the CPU.

Inputs come from numpy seeds; both sides get the same step scalars
(lr, bias corrections, clip scale), as fp32 values.  Tolerances: w', mu'
and nu' are bitwise equal to ``repro.kernels.opt_step.ref.opt_step_ref``
for AdamW and SGD, every penalty mode, int4 / int8 / fp4, per-matrix and
blockwise scales, stacked leaves; the penalty within 1e-6 relative.  The
Pallas kernel (interpret mode), which XLA compiles with its own rewrites
of divisions, is not bitwise equal to its own oracle: it is held at the
JAX package's kernel-test tolerance (1e-4 relative, 1e-5 absolute) away
from the quantization grid's knife edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.opt_step import fused_opt_step_leaf as j_fused_leaf
from repro.kernels.opt_step import opt_step_ref as j_opt_ref
from repro_torch.core import formats as tformats
from repro_torch.core.quantize import rr_neighbors
from repro_torch.kernels.opt_step import (fused_opt_step_leaf, opt_step_ref,
                                          step_scalars)

HYP = dict(lr=1e-3, bc1=0.1, bc2=0.05, clip_scale=0.7, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.01)
SGD = dict(lr=1e-2, bc1=1.0, bc2=1.0, clip_scale=0.7, b1=0.0, b2=0.0,
           eps=0.0, weight_decay=0.0, core="sgd")


def _rand4(shape, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    mu = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    nu = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
    return w, g, mu, nu


def _both(arrays, fn_j, fn_t, **kw):
    jout = fn_j(*map(jnp.asarray, arrays), **kw)
    tout = fn_t(*(torch.from_numpy(a.copy()) for a in arrays), **kw)
    return jout, tout


def _check(jout, tout, mask=None):
    for a, b, name in zip(tout[:3], jout[:3], ("w", "mu", "nu")):
        a, b = a.numpy(), np.asarray(b)
        if mask is not None:
            a, b = a[mask], b[mask]
        np.testing.assert_array_equal(a, b, err_msg=name)
    jp, tp = float(jout[3]), float(tout[3])
    assert abs(jp - tp) <= 1e-6 * max(abs(jp), 1e-30)


@pytest.mark.parametrize("shape", [(8, 256), (3, 5, 256), (64, 384),
                                   (7, 33)])
@pytest.mark.parametrize("bs", [-1, 128, 100])
@pytest.mark.parametrize("fmt", ["int4", "int8", "fp4"])
def test_adamw_step_bitwise_vs_jax_ref(fmt, bs, shape):
    arrays = _rand4(shape, seed=1)
    for fn in (opt_step_ref, fused_opt_step_leaf):
        jout, tout = _both(arrays, j_opt_ref, fn, lam=3000.0, fmt_name=fmt,
                           block_size=bs, **HYP)
        _check(jout, tout)


@pytest.mark.parametrize("shape", [(8, 256), (130, 96), (2048,)])
def test_lam0_mode_none_bitwise_vs_jax_ref(shape):
    arrays = _rand4(shape, seed=2)
    jout, tout = _both(arrays, j_opt_ref, fused_opt_step_leaf, lam=0.0,
                       fmt_name="int4", block_size=-1, **HYP)
    _check(jout, tout)
    assert float(tout[3]) == 0.0


@pytest.mark.parametrize("momentum,fd,lam", [
    (0.0, None, 0.0), (0.9, None, 0.0), (0.0, 0.99, 100.0),
    (0.9, 0.99, 100.0)])
@pytest.mark.parametrize("bs", [-1, 128])
def test_sgd_step_bitwise_vs_jax_ref(momentum, fd, lam, bs):
    arrays = _rand4((4, 8, 64), seed=3)
    jout, tout = _both(arrays, j_opt_ref, fused_opt_step_leaf, lam=lam,
                       fmt_name="int4", block_size=bs, momentum=momentum,
                       fisher_decay=fd, **SGD)
    _check(jout, tout)


@pytest.mark.parametrize("core", ["adamw", "sgd"])
def test_ok_zero_writes_inputs_back(core):
    arrays = _rand4((3, 16, 128), seed=4)
    kw = dict(HYP) if core == "adamw" else dict(SGD, momentum=0.9,
                                                fisher_decay=0.99)
    jout, tout = _both(arrays, j_opt_ref, fused_opt_step_leaf, lam=1e3,
                       fmt_name="int4", block_size=-1, ok=0.0, **kw)
    _check(jout, tout)
    for got, src in zip(tout[:3], (arrays[0], arrays[2], arrays[3])):
        np.testing.assert_array_equal(got.numpy(), src)


def _grid_mask(w, fmt, bs, tol=1e-3):
    lo, hi = (t.numpy() for t in rr_neighbors(torch.from_numpy(w),
                                             tformats.get_format(fmt), bs))
    gap = np.maximum(hi - lo, 1e-9)
    d = np.minimum(np.abs(w - lo), np.abs(hi - w)) / gap
    return (d > tol) & ((hi - lo) > 1e-6 * (np.abs(w) + 1.0))


@pytest.mark.parametrize("shape", [(8, 256), (3, 5, 256)])
@pytest.mark.parametrize("bs", [-1, 128])
@pytest.mark.parametrize("fmt", ["int4", "fp4"])
def test_adamw_step_matches_pallas_kernel_interpret(fmt, bs, shape):
    arrays = _rand4(shape, seed=5)
    jout, tout = _both(arrays, j_fused_leaf, fused_opt_step_leaf, lam=3000.0,
                       fmt_name=fmt, block_size=bs, **HYP)
    mask = _grid_mask(arrays[0], fmt, bs)
    assert mask.mean() > 0.9
    for a, b in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(a.numpy()[mask], np.asarray(b)[mask],
                                   rtol=1e-4, atol=1e-5)
    jp, tp = float(jout[3]), float(tout[3])
    assert abs(jp - tp) <= 1e-6 * abs(jp)


def test_scalar_tensors_give_the_same_bits_as_floats():
    arrays = _rand4((4, 96), seed=6)
    t = [torch.from_numpy(a.copy()) for a in arrays]
    scal = {k: torch.tensor(HYP[k], dtype=torch.float32)
            for k in ("lr", "bc1", "bc2", "clip_scale")}
    rest = {k: v for k, v in HYP.items() if k not in scal}
    a = fused_opt_step_leaf(*t, lam=500.0, fmt_name="int4", block_size=-1,
                            **HYP)
    b = fused_opt_step_leaf(*t, lam=500.0, fmt_name="int4", block_size=-1,
                            ok=torch.tensor(1.0), **scal, **rest)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    row = step_scalars(1e-3, 0.1, 0.05, 0.7, 1.0, "cpu")
    assert row.dtype == torch.float32 and tuple(row.shape) == (5,)


def test_bad_inputs_raise():
    w = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        fused_opt_step_leaf(w, torch.zeros(4, 9), w, w, lam=0.0,
                            fmt_name="int4", block_size=-1, **HYP)
    with pytest.raises(ValueError, match="core"):
        fused_opt_step_leaf(w, w, w, w, lam=0.0, fmt_name="int4",
                            block_size=-1, **dict(HYP, core="lion"))
    m = w.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_opt_step_leaf(m, m, m, m, lam=0.0, fmt_name="int4",
                            block_size=-1, **HYP)
