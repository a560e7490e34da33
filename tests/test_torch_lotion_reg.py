"""The port's LOTION penalty (``core/lotion.py``) and the ``lotion_reg``
kernel's plain path against the JAX package on the CPU.

Inputs come from numpy seeds.  Tolerances: the closed-form gradient is
bitwise equal to ``repro.core.lotion.lotion_penalty_and_grad`` (and so to
the JAX kernel's oracle ``reg_ref``); penalty values agree within 1e-6
relative (summation order).  The Pallas kernel (interpret mode) writes
the gradient as ``1/2 f (lo + hi - 2w)``, which rounds differently from
the closed form (it cancels where w sits mid-cell): held at the JAX
package's own kernel-test tolerance (1e-4 relative, 1e-5 absolute) away
from the quantization grid's knife edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import lotion as jlotion
from repro.kernels.lotion_reg.ops import _fused as j_reg_fused
from repro.kernels.lotion_reg.ref import reg_ref as j_reg_ref
from repro_torch.core import formats as tformats
from repro_torch.core import lotion as tlotion
from repro_torch.kernels.lotion_reg import (lotion_penalty_fused,
                                            lotion_penalty_fused_vg, reg_ref)

FMTS = ["int4", "int8", "fp4"]


def _wf(shape, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    f = np.abs(rng.standard_normal(shape)).astype(np.float32)
    return w, f


def _rel(a, b):
    a, b = (x.detach() if torch.is_tensor(x) else x for x in (a, b))
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("shape", [(8, 256), (3, 5, 256), (16, 384),
                                   (7, 33)])
@pytest.mark.parametrize("bs", [-1, 128, 100])
@pytest.mark.parametrize("fmt", FMTS)
def test_reg_plain_path_matches_jax_reg_ref(fmt, bs, shape):
    w, f = _wf(shape)
    jv, jg = j_reg_ref(jnp.asarray(w), jnp.asarray(f), fmt, bs)
    for fn in (reg_ref, lotion_penalty_fused_vg):
        tv, tg = fn(torch.from_numpy(w), torch.from_numpy(f), fmt, bs)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        assert _rel(tv, jv) <= 1e-6


@pytest.mark.parametrize("bs", [-1, 128])
@pytest.mark.parametrize("fmt", FMTS)
def test_closed_form_with_lam_matches_jax(fmt, bs):
    """``lam`` folded into the gradient: the closed form and the kernel's
    (value, grad) wrapper are bitwise JAX's closed form at that lam; the
    autograd function passes it through unchanged (cotangent 1) with lam
    times the penalty forward, as autograd of ``lam * lotion_penalty``."""
    w, f = _wf((3, 16, 64), seed=1)
    lam = 3000.0
    jv, jg = jlotion.lotion_penalty_and_grad(
        jnp.asarray(w), jnp.asarray(f), jformats.get_format(fmt), bs,
        lam=lam)
    tv, tg = tlotion.lotion_penalty_and_grad(
        torch.from_numpy(w), torch.from_numpy(f), tformats.get_format(fmt),
        bs, lam=lam)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert _rel(tv, jv) <= 1e-6
    kv, kg = lotion_penalty_fused_vg(torch.from_numpy(w), torch.from_numpy(f),
                                     fmt, bs, lam)
    np.testing.assert_array_equal(kg.numpy(), np.asarray(jg))
    wt = torch.from_numpy(w).requires_grad_(True)
    pen = lotion_penalty_fused(wt, torch.from_numpy(f), fmt, bs, lam)
    pen.backward()
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jg))
    assert float(pen.detach()) == float(lam * kv)
    wp = torch.from_numpy(w).requires_grad_(True)
    (lam * tlotion.lotion_penalty(wp, torch.from_numpy(f),
                                  tformats.get_format(fmt), bs)).backward()
    assert torch.equal(wp.grad, wt.grad)


def _grid_mask(w, fmt, bs, tol=1e-3):
    """Elements safely away from a quantization grid point (where the
    one-sided derivatives differ and an ulp picks either)."""
    from repro_torch.core.quantize import rr_neighbors
    lo, hi = (t.numpy() for t in rr_neighbors(torch.from_numpy(w),
                                             tformats.get_format(fmt), bs))
    gap = np.maximum(hi - lo, 1e-9)
    d = np.minimum(np.abs(w - lo), np.abs(hi - w)) / gap
    return (d > tol) & ((hi - lo) > 1e-6 * (np.abs(w) + 1.0))


@pytest.mark.parametrize("shape", [(8, 256), (4, 8, 128)])
@pytest.mark.parametrize("bs", [-1, 128])
@pytest.mark.parametrize("fmt", FMTS)
def test_reg_matches_pallas_kernel_interpret(fmt, bs, shape):
    w, f = _wf(shape, seed=2)
    jv, jg = j_reg_fused(jnp.asarray(w), jnp.asarray(f), fmt, bs)
    tv, tg = lotion_penalty_fused_vg(torch.from_numpy(w), torch.from_numpy(f),
                                     fmt, bs)
    mask = _grid_mask(w, fmt, bs)
    assert mask.mean() > 0.9
    np.testing.assert_allclose(tg.numpy()[mask], np.asarray(jg)[mask],
                               rtol=1e-4, atol=1e-5)
    assert _rel(tv, jv) <= 1e-6


@pytest.mark.parametrize("bs", [-1, 128])
def test_autograd_function_backward_is_g_times_closed_form(bs):
    w, f = _wf((3, 8, 128), seed=3)
    lam = 700.0
    wt = torch.from_numpy(w).requires_grad_(True)
    pen = lotion_penalty_fused(wt, torch.from_numpy(f), "int4", bs)
    (lam * pen).backward()
    _, grad = reg_ref(torch.from_numpy(w), torch.from_numpy(f), "int4", bs)
    assert torch.equal(wt.grad, lam * grad)
    assert pen.requires_grad and pen.ndim == 0
    # fisher is a constant: no gradient flows into it
    ft = torch.from_numpy(f).requires_grad_(True)
    lotion_penalty_fused(torch.from_numpy(w), ft, "int4", bs).backward()
    assert ft.grad is None


@pytest.mark.parametrize("bs", [-1, 128, 100])
@pytest.mark.parametrize("fmt", FMTS)
def test_autograd_of_plain_penalty_equals_closed_form(fmt, bs):
    """DESIGN.md §2's premise inside the port: autograd of
    ``lam * lotion_penalty`` gives the closed form's gradient bitwise,
    stacked leaves included."""
    w, f = _wf((3, 8, 48), seed=4)
    lam = 3000.0
    tf = tformats.get_format(fmt)
    wt = torch.from_numpy(w).requires_grad_(True)
    (lam * tlotion.lotion_penalty(wt, torch.from_numpy(f), tf, bs)
     ).backward()
    value, grad = tlotion.lotion_penalty_and_grad(
        torch.from_numpy(w), torch.from_numpy(f), tf, bs, lam=lam)
    assert torch.equal(wt.grad, grad)
    ref = float(tlotion.lotion_penalty(torch.from_numpy(w),
                                       torch.from_numpy(f), tf, bs))
    assert _rel(value, ref) <= 1e-6


@pytest.mark.parametrize("fmt", FMTS)
def test_differentiable_scale_matches_jax_autodiff(fmt):
    w, f = _wf((4, 64), seed=5)
    jf, tf = jformats.get_format(fmt), tformats.get_format(fmt)
    jv, jgrad = jax.value_and_grad(lambda x: jlotion.lotion_penalty(
        x, jnp.asarray(f), jf, 32, differentiate_scale=True))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    tv = tlotion.lotion_penalty(wt, torch.from_numpy(f), tf, 32,
                                differentiate_scale=True)
    tv.backward()
    assert _rel(tv, jv) <= 1e-6
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-6)


def test_bad_inputs_raise():
    w = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        lotion_penalty_fused_vg(w, torch.zeros(4, 9), "int4", -1)
    with pytest.raises(ValueError, match="block_size"):
        lotion_penalty_fused_vg(w, w, "int4", 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        lotion_penalty_fused_vg(w.to("meta"), w.to("meta"), "int4", -1)
