"""Sharding rules and placements of the port (``repro.distributed.sharding``).

Strategy (DESIGN.md §4), the JAX package's rules name for name:

* ``model`` axis: the output-feature dim of up/qkv projections, the
  input-feature dim of down/out projections, the expert dim of MoE
  weights, the vocab dim of embeddings;
* ``data`` axis: data parallelism, plus FSDP-style sharding of the
  *other* large dim of each weight (the ZeRO-3 posture: params, grads
  and optimizer moments carry the same 2-D sharding);
* ``pod`` axis: outer data parallelism.

Rules are name and shape driven over the flattened parameter tree;
everything under ``stage/`` is stacked with a leading repeats axis, never
sharded.  A spec is a tuple with one entry per leading dim (trailing dims
unsharded), each entry ``None``, an axis name or a tuple of axis names:
JAX's ``PartitionSpec`` in plain Python (``P``).  A ``NamedSharding`` is a
mesh and a spec.

Where XLA places arrays and inserts every collective, the port does it
explicitly: :func:`shard` turns a full leaf into this rank's block (what
the port stores), :func:`gather` the blocks back into the full leaf, and
:func:`gather_at_use` does so where the model reads a leaf, with the
gradient summed over the data-parallel ranks (which computed different
rows) and cut back to the rank's block (the ``model`` ranks computed the
same rows: no sum over them).  :func:`matrix_absmax` is each matrix's
largest |w| over the whole matrix, however it is cut: the per-matrix
scale LOTION's penalty and casts take.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core.qtensor import _NATURAL_LEAVES as _QT_NATURAL
from ..core.qtensor import MATMUL_LEAVES as _QT_WEIGHT_NAMES
from ..core.qtensor import QTensor
from ..launch.mesh import dp_axes
from . import collectives

# weights whose LAST dim is the model-parallel (output) dim
_COL_PARALLEL = (
    "wq", "wk", "wv", "w_up", "w_gate", "in_proj", "w_r", "w_k", "w_v",
    "w_g", "w_k_cm", "vision_proj",
)
# weights whose FIRST dim is the model-parallel (input) dim
_ROW_PARALLEL = ("wo", "w_down", "out_proj", "w_o", "w_v_cm")
_REPLICATED_HINTS = (
    "norm", "scale", "bias", "a_log", "d_skip", "decay", "bonus", "mu_",
    "gate_", "xattn_gate", "conv_b", "lora", "router", "mu_base",
)


def P(*entries) -> tuple:
    """A partition spec: JAX's ``PartitionSpec(*entries)`` as a tuple."""
    return tuple(entries)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    mesh: Any
    spec: tuple


def _leaf_name(path) -> str:
    return "/".join(str(p) for p in path)


def param_spec(path, x, *, fsdp: bool = True,
               stacked_prefixes=("stage",)) -> tuple:
    """Partition spec of one parameter leaf (``path``: its tuple of keys;
    ``x``: anything with ``ndim``)."""
    name = _leaf_name(path)
    lead: tuple = ()
    ndim = x.ndim
    if any(name.startswith(pfx) for pfx in stacked_prefixes):
        lead = (None,)
        ndim -= 1
    last = name.rsplit("/", 1)[-1]
    dp = "data" if fsdp else None

    # QTensor children: the parent weight's rule (codes and scales
    # congruent); storage is transposed except for the gather tables
    qt_child = False
    parent = name.split("/")[-2] if "/" in name else ""
    if last in ("codes", "scales") and parent in _QT_WEIGHT_NAMES:
        qt_child, last = True, parent

    if any(h in last for h in _REPLICATED_HINTS) or ndim <= 1:
        return P(*lead)

    if last == "embed":
        if ndim == 3:      # (codebooks, vocab, d)
            spec = P(*lead, None, "model", dp)
        else:
            spec = P(*lead, "model", dp)      # (vocab, d)
    elif last == "lm_head":
        if ndim == 3:      # (codebooks, d, vocab)
            spec = P(*lead, None, dp, "model")
        else:
            spec = P(*lead, dp, "model")      # (d, vocab)
    elif last == "conv_w":
        spec = P(*lead, None, "model")        # depthwise channels
    elif last in ("w_up", "w_gate", "w_down") and ndim == 3:
        # MoE expert weights (e, d, f) / (e, f, d): EP over model
        if last == "w_down":
            spec = P(*lead, "model", None, dp)
        else:
            spec = P(*lead, "model", dp, None)
    elif any(last == c for c in _COL_PARALLEL) and ndim == 2:
        spec = P(*lead, dp, "model")
    elif any(last == r for r in _ROW_PARALLEL) and ndim == 2:
        spec = P(*lead, "model", dp)
    elif ndim == 2:
        spec = P(*lead, dp, "model")          # default: 2-D shard
    else:
        spec = P(*lead)

    if qt_child and last not in _QT_NATURAL and len(spec) >= 2:
        entries = list(spec)
        entries[-1], entries[-2] = entries[-2], entries[-1]
        spec = P(*entries)
    return spec


def widen_dp(mesh, spec: tuple) -> tuple:
    """On multi-pod meshes the FSDP shards span the pod axis too: every
    ``data`` entry becomes ``("pod", "data")``."""
    if "pod" not in mesh.axis_names:
        return spec
    out = []
    for entry in spec:
        if entry == "data":
            out.append(("pod", "data"))
        elif isinstance(entry, tuple) and "data" in entry and "pod" not in entry:
            out.append(("pod",) + tuple(entry))
        else:
            out.append(entry)
    return P(*out)


def fix_divisibility(mesh, spec: tuple, shape) -> tuple:
    """Drop mesh axes from dims they do not divide (Granite's vocab of
    49,155 is indivisible by any power-of-two axis: replicated)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        keep = []
        size = 1
        for a in axes:
            if shape[i] % (size * mesh.shape[a]) == 0:
                keep.append(a)
                size *= mesh.shape[a]
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return P(*out)


# --------------------------------------------------------------------------
# Trees: nested dicts, tuples and lists; a QTensor is a node with children
# "codes" and "scales"; None holds no leaf
# --------------------------------------------------------------------------

def tree_map_with_path(fn: Callable, tree, *rest, path=()):
    """``fn(path, x, *ys)`` over the leaves of ``tree`` (and of the trees
    in ``rest``, of its structure); path entries are dict keys and
    tuple/list positions."""
    if isinstance(tree, QTensor):
        kids = {"codes": tree.codes, "scales": tree.scales}
        return tree_map_with_path(
            fn, kids, *({"codes": r.codes, "scales": r.scales}
                        if isinstance(r, QTensor) else r for r in rest),
            path=path)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             path=path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree, *rest)


def tree_leaves_with_path(tree) -> list:
    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


# optimizer-chain state keys holding param-shaped trees (AdamW moments,
# EF-compress carried error): everything after the marker is a param path
_OPT_TREE_KEYS = ("mu", "nu", "err")


def state_shardings(mesh, state_shapes, *, fsdp: bool = True):
    """NamedSharding tree for the train state (``{params, opt, step}``).
    Optimizer moments mirror their parameter's sharding; ``opt`` may be
    the fused core's flat ``{"mu", "nu", "count", "penalty", "gnorm"}`` or
    the unfused chain's tuple of link states (param-shaped trees found by
    the mu/nu/err path marker); everything else replicates."""
    def spec_for(path, x):
        parts = [str(p) for p in path]
        if parts[0] in ("params", "ef_err"):
            sub = path[1:]
        elif parts[0] == "opt":
            sub = None
            for i, seg in enumerate(parts):
                if seg in _OPT_TREE_KEYS:
                    sub = path[i + 1:]
                    break
            if sub is None or x.ndim == 0:
                return NamedSharding(mesh, P())   # count, gnorm, penalty
        else:
            return NamedSharding(mesh, P())       # step, counters
        spec = fix_divisibility(
            mesh, widen_dp(mesh, param_spec(sub, x, fsdp=fsdp)), x.shape)
        return NamedSharding(mesh, spec)

    return tree_map_with_path(spec_for, state_shapes)


def leaf_sharding(mesh, path, x, *, fsdp: bool = True) -> NamedSharding:
    """The NamedSharding of one parameter leaf (a QTensor's child by its
    path ``(..., "codes" | "scales")``): its rule, widened over ``pod``,
    with the axes that do not divide a dim dropped.  int4 codes are cut
    on their packed bytes, so a block along the in-dim starts on an even
    element."""
    return NamedSharding(mesh, fix_divisibility(
        mesh, widen_dp(mesh, param_spec(path, x, fsdp=fsdp)), x.shape))


def params_shardings(mesh, param_shapes, *, fsdp: bool = True):
    return tree_map_with_path(
        lambda p, x: leaf_sharding(mesh, p, x, fsdp=fsdp), param_shapes)


# --------------------------------------------------------------------------
# Activations / inputs
# --------------------------------------------------------------------------

def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axsize(mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def data_batch_spec(mesh, batch_size: int) -> tuple:
    """Shard the batch dim over as many DP axes as divide it."""
    axes = []
    for a in batch_axes(mesh):
        if batch_size % (_axsize(mesh, axes + [a])) == 0:
            axes.append(a)
    return P(tuple(axes) if axes else None)


def train_batch_shardings(mesh, batch_shapes, batch_size: int):
    bspec = data_batch_spec(mesh, batch_size)
    return tree_map_with_path(
        lambda p, x: NamedSharding(mesh, P(*(bspec + (None,) * (x.ndim - 1)))),
        batch_shapes)


def cache_spec(path, x, mesh, batch: int) -> tuple:
    """Decode-cache spec: KV (repeats, batch, len, kv_heads, head_dim)
    shards batch over the DP axes where divisible and the *length* over
    ``model`` (plus leftover DP axes when the batch cannot take them);
    recurrent states shard heads or channels over ``model``; quantized
    caches ride as ``k/v -> codes|scale`` children."""
    name = _leaf_name(path)
    dims = list(x.shape)
    dp = list(batch_axes(mesh))
    used_b = []
    for a in dp:
        if batch % _axsize(mesh, used_b + [a]) == 0 and _axsize(mesh, used_b + [a]) <= batch:
            used_b.append(a)
    rest = [a for a in dp if a not in used_b]
    bspec = tuple(used_b) if used_b else None

    parts = name.split("/")
    is_kv = (parts[-1] in ("k", "v")
             or (len(parts) >= 2 and parts[-2] in ("k", "v")
                 and parts[-1] in ("codes", "scale")))
    if is_kv and x.ndim == 5:
        # (r, b, len, kvh, hd-or-1)
        len_axes = tuple(rest) + ("model",)
        L = dims[2]
        if L % _axsize(mesh, list(len_axes)) != 0:
            len_axes = ("model",) if L % mesh.shape["model"] == 0 else ()
        return P(None, bspec, len_axes if len_axes else None, None, None)
    if name.endswith("ssm") and x.ndim == 5:      # (r, b, h, p, n)
        h = dims[2]
        hax = "model" if h % mesh.shape["model"] == 0 else None
        return P(None, bspec, hax, None, None)
    if name.endswith("wkv") and x.ndim == 5:      # (r, b, h, n, m)
        h = dims[2]
        hax = "model" if h % mesh.shape["model"] == 0 else None
        return P(None, bspec, hax, None, None)
    if name.endswith("conv") and x.ndim == 4:     # (r, b, k-1, conv_dim)
        c = dims[3]
        cax = "model" if c % mesh.shape["model"] == 0 else None
        return P(None, bspec, None, cax)
    if x.ndim >= 2:
        # shift states etc (r, b, d)
        return P(None, bspec)
    return P()


def cache_shardings(mesh, cache_shapes, batch: int):
    return tree_map_with_path(
        lambda p, x: NamedSharding(mesh, fix_divisibility(
            mesh, cache_spec(p, x, mesh, batch), x.shape)), cache_shapes)


def activation_spec(mesh) -> tuple:
    """Residual-stream spec (b, l, d): batch over DP, d over model."""
    return P(batch_axes(mesh), None, "model")


# --------------------------------------------------------------------------
# Placement: what a rank stores, and the way back to the full leaf
# --------------------------------------------------------------------------

def dim_axes(spec: tuple, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """The axes that cut each of ``ndim`` dims (``()`` for none)."""
    out = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        out.append(() if e is None else (tuple(e) if isinstance(e, tuple)
                                         else (e,)))
    return tuple(out)


def local_shape(sh: NamedSharding, shape) -> tuple:
    return tuple(s // math.prod(sh.mesh.shape[a] for a in axes)
                 for s, axes in zip(shape, dim_axes(sh.spec, len(shape))))


def global_shape(sh: Optional[NamedSharding], shape) -> tuple:
    """The full leaf's shape from a block's."""
    if sh is None:
        return tuple(shape)
    return tuple(s * math.prod(sh.mesh.shape[a] for a in axes)
                 for s, axes in zip(shape, dim_axes(sh.spec, len(shape))))


def full_view(x: torch.Tensor, sh: Optional[NamedSharding]) -> torch.Tensor:
    """``x`` itself, or for a block a meta tensor of the full leaf's shape
    (what shape-driven rules such as the quantization policy read)."""
    if sh is None:
        return x
    return torch.empty(global_shape(sh, x.shape), dtype=x.dtype,
                       device="meta")


def leaf_absmax(x: torch.Tensor, sh: Optional[NamedSharding],
                block_size: int, name: str = "leaf"):
    """The absmax operand of a per-matrix kernel call on a block (None on
    one device, and for blockwise scales, which a block holds whole or
    refuses)."""
    if sh is None:
        return None
    if block_size != -1:
        check_whole_blocks(name, global_shape(sh, x.shape), sh, block_size)
        return None
    return matrix_absmax(x, sh)


def shard_slices(sh: NamedSharding, shape) -> tuple:
    """This rank's block of a leaf of ``shape``: one slice per dim (a dim
    cut by axes (a1, a2) takes block c(a1) * n(a2) + c(a2), the first
    axis the major one, as in JAX)."""
    mesh = sh.mesh
    out = []
    for s, axes in zip(shape, dim_axes(sh.spec, len(shape))):
        if not axes:
            out.append(slice(None))
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        if s % n:
            raise ValueError(f"dim of {s} not divisible by the {n} ranks of "
                             f"{axes}: fix_divisibility first")
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coord(a)
        m = s // n
        out.append(slice(idx * m, (idx + 1) * m))
    return tuple(out)


def is_replicated(sh: Optional[NamedSharding]) -> bool:
    return sh is None or all(e is None for e in sh.spec)


def shard(x, sh: Optional[NamedSharding]):
    """This rank's block of the full leaf ``x`` (a tensor, or a numpy
    array from a checkpoint), as its own contiguous copy, so that the
    full leaf can be freed; ``x`` itself where nothing cuts it."""
    if is_replicated(sh):
        return x
    block = x[shard_slices(sh, tuple(x.shape))]
    if torch.is_tensor(block):
        return block.clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(block)


def gather(x: torch.Tensor, sh: Optional[NamedSharding]) -> torch.Tensor:
    """The full leaf from every rank's block (an all-gather along each
    cut dim, the innermost axis first); ``x`` where nothing cuts it."""
    if is_replicated(sh):
        return x
    for d, axes in enumerate(dim_axes(sh.spec, x.ndim)):
        for a in reversed(axes):
            x = collectives.all_gather(x, sh.mesh, a, d)
    return x


def _reduce_dp(g: torch.Tensor, mesh) -> torch.Tensor:
    return collectives.all_reduce(g.contiguous(), "sum", mesh, dp_axes(mesh))


class _GatherAtUse(torch.autograd.Function):
    """Forward: the full leaf.  Backward: the full gradient summed over
    the data-parallel ranks, cut to this rank's block."""

    @staticmethod
    def forward(ctx, x, sh):
        ctx.sh = sh
        full = gather(x, sh)
        return full.clone() if full is x else full

    @staticmethod
    def backward(ctx, g):
        sh = ctx.sh
        g = _reduce_dp(g, sh.mesh)
        if not is_replicated(sh):
            # its own storage: the kernels take contiguous gradients, and
            # the full one is freed
            g = g[shard_slices(sh, tuple(g.shape))].contiguous()
        return g, None


def gather_at_use(x: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """The full leaf where the model reads it (differentiable: see
    :class:`_GatherAtUse`)."""
    return _GatherAtUse.apply(x, sh)


class _SumAll(torch.autograd.Function):
    """Forward: the sum over every rank.  Backward: the identity (each
    rank's own elements' derivative, as every rank's objective holds the
    whole sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return collectives.all_reduce(x.clone(), "sum", mesh,
                                      mesh.axis_names)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_all(x: torch.Tensor, mesh) -> torch.Tensor:
    return _SumAll.apply(x, mesh)


class _CountOnce(torch.autograd.Function):
    """Forward: ``x`` on the owning replica, zero on the others.
    Backward: the identity on every replica."""

    @staticmethod
    def forward(ctx, x, owner: bool):
        return x.clone() if owner else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def count_once(x: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    return _CountOnce.apply(x, owns(sh))


def owns(sh: NamedSharding) -> bool:
    """Whether this rank is the one replica of its block that counts in
    a sum over ranks: coordinate 0 along every axis that does not cut
    the leaf."""
    used = {a for axes in dim_axes(sh.spec, len(sh.spec)) for a in axes}
    return all(sh.mesh.coord(a) == 0 for a in sh.mesh.axis_names
               if a not in used)


def matrix_dim_axes(sh: NamedSharding, ndim: int) -> Tuple[str, ...]:
    """The axes that cut the dims of each matrix (the trailing two, or
    the one dim of a vector)."""
    per = dim_axes(sh.spec, ndim)
    return tuple(a for axes in per[max(ndim - 2, 0):] for a in axes)


def matrix_absmax(x: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """Each of ``x``'s matrices' largest |w| over the WHOLE matrix,
    (n_matrices of the block,) fp32: the block's own maxima, then a MAX
    over the ranks that cut the matrix, on the float bits (a NaN wins, as
    in the kernels' absmax)."""
    from ..core.quantize import matrix_axes
    m = torch.linalg.vector_norm(x.detach(), ord=float("inf"),
                                 dim=matrix_axes(x)).reshape(-1)
    bits = torch.abs(m).view(torch.int32)
    axes = matrix_dim_axes(sh, x.ndim)
    if axes:
        bits = collectives.all_reduce(bits.contiguous(), "max", sh.mesh, axes)
    return bits.view(torch.float32)


def whole_blocks(shape, sh: Optional[NamedSharding], block_size: int) -> bool:
    """True where every quant block of ``block_size`` of the full leaf (a
    run of the flattened leaf) lies whole in one rank's block: the
    innermost dim that is cut (its block smaller than the dim) times the
    elements after it is a multiple of ``block_size``.  A leaf that
    nothing cuts holds its blocks whole."""
    if sh is None:
        return True
    local = local_shape(sh, shape)
    cut = [d for d in range(len(shape)) if local[d] != shape[d]]
    if not cut:
        return True
    d = cut[-1]
    return (local[d] * math.prod(shape[d + 1:])) % block_size == 0


def check_whole_blocks(name: str, shape, sh: NamedSharding,
                       block_size: int) -> None:
    """Blockwise scales are right on a block only where every block of
    the full leaf lies whole in one rank's block (``whole_blocks``)."""
    if not whole_blocks(shape, sh, block_size):
        raise ValueError(
            f"{name}: blockwise scales of {block_size} on a leaf of "
            f"{tuple(shape)} cut by {sh.spec} split quant blocks across "
            f"ranks; use per-matrix scales or a mesh whose cuts hold "
            f"whole blocks")


# --------------------------------------------------------------------------
# Serving on blocks: QTensors, the roles, the quantization
# --------------------------------------------------------------------------

def _is_qt_sharding(node) -> bool:
    """A QTensor's place in a sharding tree: ``{"codes": s, "scales": s}``
    (``tree_map_with_path`` walks a QTensor as those two children)."""
    return (isinstance(node, dict) and set(node) == {"codes", "scales"}
            and all(isinstance(v, NamedSharding) for v in node.values()))


def gather_qtensor(qt: QTensor, sh: dict) -> QTensor:
    """The whole QTensor from every rank's blocks: its codes and its
    scales, each gathered by its own sharding."""
    return dataclasses.replace(qt, codes=gather(qt.codes, sh["codes"]),
                               scales=gather(qt.scales, sh["scales"]))


def _gather_fn(sh):
    if _is_qt_sharding(sh):
        return lambda q: gather_qtensor(q, sh)
    return lambda x: gather(x, sh)


def _role_fns(tree):
    """A tree of gathers (no autograd) congruent with a sharding tree, a
    QTensor's pair of shardings one function."""
    if isinstance(tree, NamedSharding) or _is_qt_sharding(tree):
        return _gather_fn(tree)
    return {k: _role_fns(v) for k, v in tree.items()}


# the unstacked leaves the model reads through a role of their own name
LEAF_ROLES = ("embed", "lm_head", "final_norm_scale", "vision_proj",
              "shared")


def serve_roles(shardings) -> dict:
    """The roles a server installs (``distributed/context.py``) for a
    parameter tree of blocks placed by ``shardings``: every leaf gathered
    whole where the model reads it, one unit's stage leaves at a time."""
    unit = tree_map_with_path(lambda p, s: NamedSharding(s.mesh, s.spec[1:]),
                              shardings["stage"])
    roles = {"stage_params": _role_fns(unit)}
    for key in LEAF_ROLES:
        if key in shardings:
            roles[key] = _role_fns(shardings[key])
    return roles


def quantize_params_on_blocks(params, shardings, fmt, policy=None,
                              block_size: int = -1, mode: str = "rtn",
                              uniforms=None, generator=None,
                              store: bool = True):
    """``core.quantize_params`` (or with ``store=False`` ``cast_params``)
    of a tree of blocks: returns ``(blocks, shardings)``, each rank's
    blocks of the codes and scales the one-device call gives on the whole
    tree, bitwise, and their shardings.

    Each eligible leaf is gathered whole, converted by the one-device
    leaf function, cut by its children's shardings and freed before the
    next, in the one-device order (RR's uniforms are drawn whole, leaf by
    leaf, from ``generator``): a rank holds its blocks and one whole leaf
    at a time."""
    from ..core.policy import QuantPolicy
    from ..core.qtensor import leaf_converter
    policy = policy if policy is not None else QuantPolicy()
    convert = leaf_converter(fmt, block_size, mode, uniforms, generator,
                             store=store)
    mesh = mesh_of(shardings)

    def one(path, x, sh):
        if not policy.eligible(path, full_view(x, sh)):
            return x, sh
        full = gather(x, sh)
        q = convert(path, full)
        del full
        if isinstance(q, QTensor):
            qsh = {"codes": leaf_sharding(mesh, path + ("codes",), q.codes),
                   "scales": leaf_sharding(mesh, path + ("scales",),
                                           q.scales)}
            return dataclasses.replace(
                q, codes=shard(q.codes, qsh["codes"]),
                scales=shard(q.scales, qsh["scales"])), qsh
        return shard(q, sh), sh

    def walk(tree, shs, path=()):
        if isinstance(tree, dict):
            out, osh = {}, {}
            for k, v in tree.items():
                out[k], osh[k] = walk(v, shs[k], path + (k,))
            return out, osh
        return one(path, tree, shs)

    return walk(params, shardings)


def rows_sharding(mesh, cfg, batch: int, seq: int):
    """How a static batch of ``batch`` rows is cut on ``mesh``: the rows
    over the data axes where ``data_batch_spec`` cuts them, else None
    (every rank decodes every row).  A MoE config is cut only where each
    rank's rows are whole dispatch groups of the global batch's, at the
    prefill's ``seq`` and at a decode step's one token."""
    if mesh is None:
        return None
    spec = data_batch_spec(mesh, batch)
    if spec[0] is None:
        return None
    n = _axsize(mesh, spec[0] if isinstance(spec[0], tuple) else (spec[0],))
    if cfg.ffn == "moe":
        from ..models.layers import moe_groups
        ms = cfg.moe_spec()
        for length in (seq, 1):
            if moe_groups(ms, batch // n, length) != moe_groups(
                    ms, batch, length):
                return None
    return NamedSharding(mesh, spec)


def sharded_batch(batch: dict, shardings) -> dict:
    """This rank's rows of a global batch."""
    return {k: shard(v, shardings.get(k)) for k, v in batch.items()}


def mesh_of(shardings) -> Optional[Any]:
    """The mesh of the first sharding in a tree (None for None)."""
    if shardings is None:
        return None
    found = []
    tree_map_with_path(lambda p, s: found.append(s), shardings)
    return found[0].mesh if found else None


def dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def unit_shardings(stage_shardings):
    """The shardings of one unit's slice of the stacked stage leaves (the
    repeats dim dropped: it is never cut)."""
    return tree_map_with_path(
        lambda p, s: NamedSharding(s.mesh, s.spec[1:]), stage_shardings)


def apply_tree(fn: Callable, tree, shardings):
    """``fn(x, sharding)`` over a tree and its sharding tree."""
    return tree_map_with_path(lambda p, x, s: fn(x, s), tree, shardings)


__all__ = ["P", "NamedSharding", "param_spec", "widen_dp", "fix_divisibility",
           "state_shardings", "params_shardings", "batch_axes",
           "data_batch_spec", "train_batch_shardings", "cache_spec",
           "cache_shardings", "activation_spec", "shard", "gather",
           "gather_at_use", "matrix_absmax", "sum_all", "count_once",
           "owns", "local_shape", "shard_slices", "check_whole_blocks",
           "whole_blocks",
           "global_shape", "full_view", "leaf_absmax",
           "sharded_batch", "mesh_of", "dp_size", "unit_shardings",
           "apply_tree", "tree_map_with_path", "tree_leaves_with_path",
           "leaf_sharding", "gather_qtensor", "serve_roles",
           "quantize_params_on_blocks", "rows_sharding", "LEAF_ROLES"]
