"""Fault-tolerant checkpointing (port of ``repro.checkpoint.io``), on the
JAX package's on-disk layout, so that either package restores what the
other saved.

Layout of one step: a directory ``step_XXXXXXXXXX/`` holding one
``arrays.npz`` (or, for ``n_shards > 1``, ``arrays_XXXX_of_YYYY.npz``
shard files, leaves assigned greedily by byte size) and a
``manifest.json`` with the step, the shard count, and per leaf its
shape, numpy dtype name, shard and crc32.  The payloads are the files
``np.savez`` writes (stored zip entries ``<key>.npy``), byte for byte.

Leaf keys are JAX's: a leaf's path through the tree, dict keys in
sorted order, tuple and list positions as their index, joined with
``/``, case kept (``core.policy.path_str`` lowercases and is not this
rule); ``None`` and empty containers hold no leaf; a ``QTensor`` is a
node with children ``codes`` and ``scales``.

The trust rules are the reference's: the manifest is written last,
fsync'd, and the step directory published by an atomic rename (a
re-save of a step displaces the old one through ``step_X.old``);
rotation keeps the newest ``keep`` steps but never the one just
written; ``load`` checks every leaf's crc32 and raises
:class:`CorruptCheckpointError`; :func:`latest_valid` falls back past
corrupt steps and can quarantine them (``step_X.corrupt``); one bad
shard untrusts the whole step.  :func:`write_fault_hook` calls a hook
at the stages ``payload``, ``shard{i}``, ``manifest``, ``fsync``,
``publish`` and ``done``.

Unlike the reference, which turns the whole tree into host arrays
first, ``save`` streams one leaf at a time (device to host, crc32 in a
second thread while the leaf is written), and ``load`` reads one leaf
ahead (crc32 of a leaf in a second thread while the next is read) onto
the device of the matching ``like`` leaf, or with ``into=`` copies it
into the existing tensor in place: host memory holds one or two leaves,
and a restore at full width needs no second copy of the state on the
card.

bfloat16 leaves are refused by name: numpy stores one as raw ``|V2``
bytes, which the reference's own ``verify_dir`` and ``load`` then do not
read back as bfloat16.

On a mesh (``shardings``: the tree's ``NamedSharding``s, the leaves this
rank's blocks) ``save`` gathers each leaf to its full shape, one leaf at
a time in the payload order, and rank 0 alone writes (the other ranks
take part in the gathers and wait for the publish, then pass the write
stages rank 0 passed to their own write hook), so the files are those
of the one-device state; ``load`` reads every leaf on every rank
and keeps the rank's block, so a step saved on one mesh shape loads on
any other.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import math
import os
import re
import shutil
import zipfile
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.qtensor import QTensor

MANIFEST = "manifest.json"
PAYLOAD = "arrays.npz"
_STEP_RE = re.compile(r"^step_(\d+)$")


def shard_payload_name(i: int, n_shards: int) -> str:
    """Payload file for shard ``i`` of an ``n_shards``-way checkpoint."""
    return f"arrays_{i:04d}_of_{n_shards:04d}.npz"


def payload_files(manifest: dict) -> dict:
    """shard index -> payload filename (``arrays.npz`` for one shard and
    for manifests without ``n_shards``)."""
    n = int(manifest.get("n_shards", 1))
    if n <= 1:
        return {0: PAYLOAD}
    return {i: shard_payload_name(i, n) for i in range(n)}


def _assign_shards(nbytes: dict, n_shards: int) -> dict:
    """Leaf -> shard: greedy by byte size (largest first, ties by key)
    onto the lightest shard; each leaf lives wholly in one shard."""
    if n_shards <= 1:
        return {k: 0 for k in nbytes}
    sizes = [0] * n_shards
    assign = {}
    for k in sorted(nbytes, key=lambda k: (-nbytes[k], k)):
        i = min(range(n_shards), key=lambda j: (sizes[j], j))
        assign[k] = i
        sizes[i] += max(int(nbytes[k]), 1)
    return assign


def _fsync_path(path: str) -> None:
    """fsync a file or directory; best effort where directory fds are
    refused (the rename itself is still atomic there)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CorruptCheckpointError(IOError):
    """A checkpoint directory exists but fails verification (crc mismatch,
    truncated or unreadable payload, or a manifest leaf missing from its
    payload)."""


# write-stage fault hook (the chaos harness's seam); None in production
_write_hook: Optional[Callable[[str, str], None]] = None


@contextlib.contextmanager
def write_fault_hook(hook: Callable[[str, str], None]):
    """Install ``hook(stage, path)`` for the duration of the context.
    Stages, in order per save: ``payload`` (path = tmp dir), one
    ``shard{i}`` per shard file when ``n_shards > 1``, ``manifest``,
    ``fsync``, ``publish``, ``done`` (path = the published dir).  The
    hook may raise to emulate a crash at that point."""
    global _write_hook
    prev = _write_hook
    _write_hook = hook
    try:
        yield
    finally:
        _write_hook = prev


# the stages a sharded save's writer passed, for the other ranks to
# replay (None outside the writer's save)
_stage_log: Optional[List[Tuple[str, str]]] = None


def _stage(stage: str, path: str) -> None:
    if _stage_log is not None:
        _stage_log.append((stage, path))
    if _write_hook is not None:
        _write_hook(stage, path)


def _paths_and_leaves(tree) -> List[Tuple[str, object]]:
    """``(key, leaf)`` pairs in the JAX package's flattening order and
    key spelling (module docstring)."""
    out: List[Tuple[str, object]] = []

    def walk(x, path):
        if isinstance(x, QTensor):
            walk({"codes": x.codes, "scales": x.scales}, path)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + (str(k),))
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, path + (str(i),))
        elif x is not None:
            out.append(("/".join(path), x))

    walk(tree, ())
    return out


def _unflatten_like(like, leaves: dict):
    """``like``'s structure with each leaf replaced by ``leaves[key]``."""
    def build(x, path):
        key = "/".join(path)
        if isinstance(x, QTensor):
            return QTensor(leaves[key + "/codes" if path else "codes"],
                           leaves[key + "/scales" if path else "scales"],
                           x.fmt_name, x.bits, x.block_k)
        if isinstance(x, dict):
            return {k: build(v, path + (str(k),)) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(build(v, path + (str(i),))
                           for i, v in enumerate(x))
        if x is None:
            return None
        return leaves[key]

    return build(like, ())


class _Gathered:
    """A block of a sharded leaf, gathered to its full shape when the
    writer reaches it (every rank gathers, in the same order)."""

    __slots__ = ("block", "sharding", "shape", "done")

    def __init__(self, block, sharding):
        from ..distributed.sharding import global_shape
        self.block, self.sharding = block, sharding
        self.shape = global_shape(sharding, tuple(block.shape))
        self.done = False

    def full(self):
        from ..distributed.sharding import gather
        self.done = True
        return gather(self.block, self.sharding)


def _leaf_shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _leaf_nbytes(x) -> int:
    if isinstance(x, _Gathered):
        return math.prod(x.shape) * x.block.element_size()
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _host_array(key: str, x) -> np.ndarray:
    """The leaf as a C-contiguous host numpy array (one device-to-host
    copy for a card tensor)."""
    if isinstance(x, _Gathered):
        x = x.full()
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {key!r} is bfloat16: numpy stores it as "
                f"raw |V2 bytes that the JAX package's verify_dir and load "
                f"do not read back as bfloat16; keep checkpointed leaves "
                f"fp32 (or cast them) before saving")
        if x.is_cuda:
            # through pinned memory (the caching host allocator keeps the
            # buffer for the next leaf): the copy runs at the link's rate
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            x = host.copy_(x.detach())
        x = x.detach().cpu().numpy()
    a = _contiguous(np.asarray(x))
    if a.dtype.name == "bfloat16" or a.dtype.kind == "V":
        raise TypeError(f"checkpoint leaf {key!r} has dtype {a.dtype}: "
                        f"not restorable through the npz layout")
    return a


def _contiguous(a: np.ndarray) -> np.ndarray:
    """``a`` in C order (``np.ascontiguousarray`` would make a 0-d array
    1-d)."""
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


# crc32 of a large leaf: its bytes in runs of CRC_RUN, each run's crc32 on
# a thread of a pool (zlib releases the interpreter lock), the runs' values
# joined as zlib's crc32_combine joins them: the crc32 of the whole
CRC_RUN = 1 << 26
_crc_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _gf2_times(mat, vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat) -> list:
    return [_gf2_times(mat, mat[n]) for n in range(32)]


@functools.lru_cache(maxsize=None)
def _zeros_op(k: int) -> tuple:
    """The crc32 register's GF(2) matrix for ``2 ** k`` zero bytes."""
    if k == 0:
        op = [0xEDB88320] + [1 << i for i in range(31)]    # one zero bit
        for _ in range(3):                                 # eight
            op = _gf2_square(op)
        return tuple(op)
    return tuple(_gf2_square(_zeros_op(k - 1)))


def _advance(crc: int, n: int) -> int:
    """The crc32 register ``crc`` carried over ``n`` zero bytes (zlib's
    ``crc32_combine`` without its second operand): one cached matrix per
    set bit of ``n``."""
    k = 0
    while n:
        if n & 1:
            crc = _gf2_times(_zeros_op(k), crc)
        n >>= 1
        k += 1
    return crc


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32 of A + B from crc32(A), crc32(B) and B's length."""
    return _advance(crc1, len2) ^ crc2


def _crc(a: np.ndarray, value: int = 0) -> int:
    """crc32 of a C-contiguous array's bytes, without copying them,
    continuing from ``value`` (``zlib.crc32(a, value)``); a large array
    in runs on several threads."""
    global _crc_pool
    b = a.reshape(-1).view(np.uint8)
    n = b.shape[0]
    if n <= CRC_RUN:
        return zlib.crc32(b, value)
    if _crc_pool is None:
        _crc_pool = concurrent.futures.ThreadPoolExecutor(
            min(8, os.cpu_count() or 1))
    runs = [b[i:i + CRC_RUN] for i in range(0, n, CRC_RUN)]
    crc = value
    for run, c in zip(runs, _crc_pool.map(zlib.crc32, runs)):
        crc = crc32_combine(crc, c, run.shape[0])
    return crc


def _write_npy(f, a: np.ndarray) -> None:
    """The bytes of ``np.lib.format.write_array(f, a)`` for a C-contiguous
    array whose header fits format 1.0 (any leaf's): the header, then the
    data in one write (``write_array`` copies a non-file stream's data out
    in 16 MiB pieces first)."""
    np.lib.format.write_array_header_1_0(
        f, np.lib.format.header_data_from_array_1_0(a))
    f.write(a.reshape(-1).view(np.uint8))


def _write_payload(fpath: str, keys: List[str], leaf_of: dict,
                   pool: concurrent.futures.Executor) -> dict:
    """Write ``keys``' leaves into the npz at ``fpath`` as ``np.savez``
    does (stored zip64 entries ``<key>.npy``); returns key -> (numpy
    dtype name, crc32).  Each leaf's crc32 runs in ``pool`` while the
    leaf is written (zlib releases the interpreter lock)."""
    meta = {}
    with zipfile.ZipFile(fpath, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key in keys:
            a = _host_array(key, leaf_of[key])
            crc = pool.submit(_crc, a)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                _write_npy(f, a)
            meta[key] = (str(a.dtype), crc.result())
            del a
    return meta


def _writer_order(items, n_shards: int) -> List[str]:
    """The keys in the order ``save`` writes them."""
    assign = _assign_shards({k: _leaf_nbytes(v) for k, v in items},
                            n_shards)
    return [k for i in sorted(payload_files({"n_shards": n_shards}))
            for k, _ in items if assign[k] == i]


def save(ckpt_dir: str, step: int, tree, keep: int = 3,
         n_shards: int = 1, shardings=None) -> str:
    """Atomically write the checkpoint of ``step``; returns its directory.
    ``n_shards > 1`` partitions the leaves over that many payload files
    (all-or-nothing trust on restore).  With ``shardings`` the leaves are
    blocks: gathered leaf by leaf, written by rank 0 (module docstring)."""
    if shardings is not None:
        return _save_sharded(ckpt_dir, step, tree, keep, n_shards,
                             shardings)
    return _save(ckpt_dir, step, tree, keep, n_shards)


def _save(ckpt_dir: str, step: int, tree, keep: int, n_shards: int) -> str:
    """``save`` of full leaves (or ``_Gathered`` blocks, gathered as they
    are written)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    # sweep every stale tmp/displaced dir: neither suffix matches the
    # step regex, so they hold no trusted data
    for d in os.listdir(ckpt_dir):
        if d.endswith(".tmp") or d.endswith(".old"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    os.makedirs(tmp)

    items = _paths_and_leaves(tree)
    leaf_of = dict(items)
    assign = _assign_shards({k: _leaf_nbytes(v) for k, v in items},
                            n_shards)
    files = payload_files({"n_shards": n_shards})
    meta = {}
    _stage("payload", tmp)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        for i, fname in sorted(files.items()):
            if n_shards > 1:
                _stage(f"shard{i}", tmp)
            fpath = os.path.join(tmp, fname)
            meta.update(_write_payload(
                fpath, [k for k, _ in items if assign[k] == i], leaf_of,
                pool))
            _fsync_path(fpath)
    manifest = {
        "step": step,
        "n_shards": int(max(n_shards, 1)),
        "leaves": {k: {"shape": list(_leaf_shape(v)), "dtype": meta[k][0],
                       "shard": assign[k], "crc32": meta[k][1]}
                   for k, v in items},
    }
    _stage("manifest", tmp)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        # durability before visibility: the rename alone orders metadata
        # only
        os.fsync(f.fileno())
    _fsync_path(tmp)
    _stage("fsync", tmp)
    _stage("publish", tmp)
    if os.path.isdir(final):
        # a re-save of an existing step: displace the old one to an
        # untrusted name first, so at any crash point exactly one
        # version is visible as step_X
        trash = final + ".old"
        shutil.rmtree(trash, ignore_errors=True)
        os.rename(final, trash)
        os.replace(tmp, final)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.replace(tmp, final)
    _fsync_path(ckpt_dir)
    _rotate(ckpt_dir, keep, protect=os.path.basename(final))
    _stage("done", final)
    return final


def _gathered_tree(tree, shardings):
    from ..distributed.sharding import tree_map_with_path

    def one(path, x, s):
        return _Gathered(x, s) if torch.is_tensor(x) else x
    return tree_map_with_path(one, tree, shardings)


def _save_sharded(ckpt_dir, step, tree, keep, n_shards, shardings) -> str:
    """Rank 0 writes, every rank gathers (module docstring).  The other
    ranks then replay the write stages rank 0 passed through their own
    write hook, so every rank's hook sees the same stages: a hook that
    raises at a stage on rank 0 raises there on every rank.  A failure of
    rank 0 that no replayed stage raises is an ``IOError`` elsewhere."""
    global _stage_log
    from ..distributed import collectives
    from ..distributed.sharding import mesh_of
    mesh = mesh_of(shardings)
    lazy = _gathered_tree(tree, shardings)
    leaf_of = dict(_paths_and_leaves(lazy))
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    err, stages = None, []
    if mesh.rank == 0:
        _stage_log = stages
        try:
            _save(ckpt_dir, step, lazy, keep, n_shards)
        except BaseException as e:   # the other ranks learn of it below
            err = e
        finally:
            _stage_log = None
    # every gather of the writer's order, on rank 0 those a failed write
    # left undone too, so that the ranks' collectives pair up
    for key in _writer_order(list(leaf_of.items()), n_shards):
        if isinstance(leaf_of[key], _Gathered) and not leaf_of[key].done:
            leaf_of[key].full()
    stages, failed = collectives.broadcast_object(
        (stages, None if err is None else repr(err)))
    if err is not None:
        raise err
    if mesh.rank != 0:
        _replay_stages(stages)
    if failed is not None:
        raise IOError(f"checkpoint save of step {step} failed on rank 0: "
                      f"{failed}")
    return final


def _replay_stages(stages) -> None:
    """The write stages another rank passed, through this rank's hook."""
    if _write_hook is not None:
        for stage, path in stages:
            _write_hook(stage, path)


def _rotate(ckpt_dir: str, keep: int, protect: Optional[str] = None) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if _STEP_RE.match(d))
    for d in steps[:-keep] if keep > 0 else []:
        if d == protect:
            # a crash-recovery save of an old step outranks rotation
            continue
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest published step (manifest present, not verified), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, MANIFEST)):
            best = max(best or 0, int(m.group(1)))
    return best


def _open_payloads(d: str, manifest: dict) -> dict:
    """shard index -> open zip for every payload shard; raises on any
    missing or unreadable shard."""
    handles = {}
    try:
        for i, fname in payload_files(manifest).items():
            handles[i] = zipfile.ZipFile(os.path.join(d, fname))
    except Exception:
        for h in handles.values():
            h.close()
        raise
    return handles


def _member_data(zf: zipfile.ZipFile, name: str):
    """(shape, dtype, fortran order, offset, bytes, crc32 of the npy
    header, the zip's crc32 of the member) of the array data of the
    stored ``.npy`` member ``name``: its local header and its npy header
    read from the payload file itself."""
    info = zf.getinfo(name)
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{name} is compressed")
    fp = zf.fp
    fp.seek(info.header_offset)
    local = fp.read(30)
    if local[:4] != b"PK\x03\x04":
        raise ValueError(f"{name}: no local header")
    start = (info.header_offset + 30
             + int.from_bytes(local[26:28], "little")
             + int.from_bytes(local[28:30], "little"))
    fp.seek(start)
    version = np.lib.format.read_magic(fp)
    shape, fortran, dtype = (np.lib.format.read_array_header_1_0(fp)
                             if version == (1, 0) else
                             np.lib.format.read_array_header_2_0(fp))
    offset = fp.tell()
    fp.seek(start)
    head = zlib.crc32(fp.read(offset - start))
    return (shape, dtype, fortran, offset, info.file_size - (offset - start),
            head, info.CRC)


def _crc_is(a: np.ndarray, value: int, want: int) -> bool:
    return _crc(a, value) == want


def _read_leaf(d: str, payloads: dict, key: str, meta: dict,
               buf: Optional[list] = None):
    """(leaf ``key`` in C order, a function that checks the zip's crc32
    of its member), its data read straight from its payload file: into a
    fresh array, or into ``buf[0]`` (a uint8 array, replaced by a larger
    one when it is too small).  A missing or unreadable entry raises
    :class:`CorruptCheckpointError`."""
    zf = payloads.get(int(meta.get("shard", 0)))
    if zf is None:
        raise CorruptCheckpointError(
            f"leaf {key!r} assigned to unknown shard "
            f"{meta.get('shard')!r} in {d}")
    try:
        shape, dtype, fortran, offset, size, head, member = _member_data(
            zf, key + ".npy")
    except KeyError:
        raise CorruptCheckpointError(
            f"manifest leaf {key!r} missing from its payload shard in {d}")
    except Exception as e:
        raise CorruptCheckpointError(
            f"unreadable leaf {key!r} in {d}: {e}") from e
    n = math.prod(shape) * dtype.itemsize
    if dtype.hasobject or size != n:
        raise CorruptCheckpointError(f"unreadable leaf {key!r} in {d}")
    if buf is None:
        raw = np.empty(n, np.uint8)
    else:
        if buf[0].shape[0] < n:
            buf[0] = np.empty(n, np.uint8)
        raw = buf[0][:n]
    zf.fp.seek(offset)
    if zf.fp.readinto(raw) != n:
        raise CorruptCheckpointError(f"leaf {key!r} cut short in {d}")
    zip_crc = functools.partial(_crc_is, raw, head, member)
    if fortran:
        return (np.ascontiguousarray(raw.view(dtype).reshape(shape[::-1]).T),
                zip_crc)
    return raw.view(dtype).reshape(shape), zip_crc


def _stream(d: str, manifest: dict, payloads: dict, keys: List[str],
            verify: bool, reuse: bool = False):
    """Yield ``(key, meta, array)`` for ``keys`` in order.  The next leaf
    is read while the previous one's crc32 runs in a second thread, and
    a leaf is yielded only after its crc32 matched the manifest's (with
    ``verify``; else the zip's own, over the member's bytes); a mismatch
    raises :class:`CorruptCheckpointError`.  With ``reuse`` the leaves are
    read into two buffers in turn, so an array yielded is valid only until
    the next one is yielded: for leaves that are copied out at once."""
    bufs = ([np.empty(0, np.uint8)], [np.empty(0, np.uint8)]) if reuse \
        else (None, None)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = None
        for i, key in enumerate(list(keys) + [None]):
            nxt = None
            if key is not None:
                if key not in manifest["leaves"]:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                meta = manifest["leaves"][key]
                if meta["dtype"] == "bfloat16":
                    raise TypeError(
                        f"checkpoint leaf {key!r} is bfloat16, stored by "
                        f"numpy as raw |V2 bytes: not restorable")
                a, zip_crc = _read_leaf(d, payloads, key, meta, bufs[i % 2])
                nxt = (key, meta, a, pool.submit(
                    functools.partial(_crc_is, a, 0, meta["crc32"])
                    if verify else zip_crc))
            if pending is not None:
                pkey, pmeta, pa, crc_ok = pending
                if not crc_ok.result():
                    raise CorruptCheckpointError(
                        f"crc mismatch for {pkey!r} — corrupt checkpoint "
                        f"in {d}")
                yield pkey, pmeta, pa
            pending = nxt


def verify_dir(d: str) -> bool:
    """True iff the directory fully verifies: readable manifest, every
    payload shard readable, every manifest leaf in its shard with the
    manifest's shape, dtype and crc32."""
    try:
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        payloads = _open_payloads(d, manifest)
        try:
            for _, meta, a in _stream(d, manifest, payloads,
                                      list(manifest["leaves"]), True,
                                      reuse=True):
                if (list(a.shape) != list(meta["shape"])
                        or str(a.dtype) != meta["dtype"]):
                    return False
        finally:
            for pz in payloads.values():
                pz.close()
        return True
    except Exception:
        # unreadable manifest, missing shard, truncated zip, bad entry,
        # crc mismatch: all untrusted
        return False


def quarantine(path: str) -> str:
    """Rename a corrupt step out of the trusted namespace (``step_X ->
    step_X.corrupt``, or ``.corruptN``); returns the new path."""
    dst = path + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{path}.corrupt{n}"
    os.rename(path, dst)
    return dst


def latest_valid(ckpt_dir: str, quarantine_corrupt: bool = False
                 ) -> Optional[int]:
    """Newest step whose checkpoint fully verifies, or None; corrupt
    candidates are skipped (and quarantined with ``quarantine_corrupt``)."""
    if not os.path.isdir(ckpt_dir):
        return None
    found = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m:
            found.append((int(m.group(1)), d))
    for step, d in sorted(found, reverse=True):
        path = os.path.join(ckpt_dir, d)
        if verify_dir(path):
            return step
        if quarantine_corrupt:
            quarantine(path)
    return None


def _to_like(key: str, a: np.ndarray, ref, dst, sharding=None):
    """The restored leaf (with ``sharding``: this rank's block of it):
    copied into ``dst`` in place, or a tensor on ``ref``'s device (a numpy
    array where ``ref`` is not a tensor)."""
    if sharding is not None:
        from ..distributed.sharding import shard
        a = shard(a, sharding)
    if dst is not None:
        if not torch.is_tensor(dst):
            raise TypeError(f"into leaf {key!r} is not a tensor")
        src = torch.from_numpy(a)
        if src.dtype != dst.dtype:
            raise ValueError(f"dtype mismatch for {key!r}: checkpoint "
                             f"{a.dtype} vs into {dst.dtype}")
        dst.copy_(src)
        return dst
    if torch.is_tensor(ref):
        return torch.from_numpy(a).to(ref.device)
    return a


def load(ckpt_dir: str, like=None, step: Optional[int] = None,
         verify: bool = True, into=None, shardings=None):
    """Restore the tree structured like ``like``; returns ``(tree, step)``.

    Each leaf lands on the device of the matching ``like`` leaf; with
    ``into`` (a tree of tensors, which is also the template when ``like``
    is None) every leaf is copied into ``into``'s tensor in place and
    ``into`` is returned.  With ``verify`` every leaf's crc32 is checked
    against the manifest before the leaf is placed; a mismatch or an
    unreadable payload raises :class:`CorruptCheckpointError` (with
    ``into``, the leaves placed before it stay overwritten).  With
    ``shardings`` the template's leaves are this rank's blocks: every
    rank reads each full leaf and keeps its block.
    """
    like = into if like is None else like
    if like is None:
        raise ValueError("load needs a template: like= or into=")
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    try:
        payloads = _open_payloads(d, manifest)
    except Exception as e:
        raise CorruptCheckpointError(
            f"missing or unreadable checkpoint payload shard in {d}: {e} "
            f"— one bad shard untrusts the whole step") from e

    items = _paths_and_leaves(like)
    refs = dict(items)
    dsts = dict(_paths_and_leaves(into)) if into is not None else {}
    shs = {}
    if shardings is not None:
        lazy = _gathered_tree(like, shardings)
        shs = {k: v.sharding for k, v in _paths_and_leaves(lazy)
               if isinstance(v, _Gathered)}
        refs.update((k, v) for k, v in _paths_and_leaves(lazy)
                    if isinstance(v, _Gathered))
    out = {}
    keys = [k for k, _ in items]
    try:
        # leaves copied into ``into`` at once come through reused buffers
        for key, _, a in _stream(d, manifest, payloads, keys, verify,
                                 reuse=all(k in dsts for k in keys)):
            ref = refs[key]
            if tuple(a.shape) != tuple(_leaf_shape(ref)):
                raise ValueError(f"shape mismatch for {key!r}: "
                                 f"{a.shape} vs {_leaf_shape(ref)}")
            out[key] = _to_like(
                key, a, ref.block if isinstance(ref, _Gathered) else ref,
                dsts.get(key), shs.get(key))
            del a
    finally:
        for pz in payloads.values():
            pz.close()
    if into is not None:
        return into, step
    return _unflatten_like(like, out), step
