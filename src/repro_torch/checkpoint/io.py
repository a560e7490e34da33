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
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
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


def _stage(stage: str, path: str) -> None:
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


def _leaf_shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _leaf_nbytes(x) -> int:
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _host_array(key: str, x) -> np.ndarray:
    """The leaf as a C-contiguous host numpy array (one device-to-host
    copy for a card tensor)."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {key!r} is bfloat16: numpy stores it as "
                f"raw |V2 bytes that the JAX package's verify_dir and load "
                f"do not read back as bfloat16; keep checkpointed leaves "
                f"fp32 (or cast them) before saving")
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


def _crc(a: np.ndarray) -> int:
    """crc32 of a C-contiguous array's bytes, without copying them."""
    return zlib.crc32(a)


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
                np.lib.format.write_array(f, a, allow_pickle=False)
            meta[key] = (str(a.dtype), crc.result())
            del a
    return meta


def save(ckpt_dir: str, step: int, tree, keep: int = 3,
         n_shards: int = 1) -> str:
    """Atomically write the checkpoint of ``step``; returns its directory.
    ``n_shards > 1`` partitions the leaves over that many payload files
    (all-or-nothing trust on restore)."""
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
    """shard index -> open npz for every payload shard; raises on any
    missing or unreadable shard."""
    handles = {}
    try:
        for i, fname in payload_files(manifest).items():
            handles[i] = np.load(os.path.join(d, fname))
    except Exception:
        for h in handles.values():
            h.close()
        raise
    return handles


def _read_leaf(d: str, payloads: dict, key: str, meta: dict) -> np.ndarray:
    """Leaf ``key`` from its payload shard, in C order; a missing or
    unreadable entry raises :class:`CorruptCheckpointError`."""
    payload = payloads.get(int(meta.get("shard", 0)))
    if payload is None:
        raise CorruptCheckpointError(
            f"leaf {key!r} assigned to unknown shard "
            f"{meta.get('shard')!r} in {d}")
    try:
        a = payload[key]
    except KeyError:
        raise CorruptCheckpointError(
            f"manifest leaf {key!r} missing from its payload shard in {d}")
    except Exception as e:
        raise CorruptCheckpointError(
            f"unreadable leaf {key!r} in {d}: {e}") from e
    return _contiguous(a)


def _stream(d: str, manifest: dict, payloads: dict, keys: List[str],
            verify: bool):
    """Yield ``(key, meta, array)`` for ``keys`` in order.  The next leaf
    is read while the previous one's crc32 runs in a second thread, and
    a leaf is yielded only after its crc32 matched the manifest (with
    ``verify``; a mismatch raises :class:`CorruptCheckpointError`)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = None
        for key in list(keys) + [None]:
            nxt = None
            if key is not None:
                if key not in manifest["leaves"]:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                meta = manifest["leaves"][key]
                if meta["dtype"] == "bfloat16":
                    raise TypeError(
                        f"checkpoint leaf {key!r} is bfloat16, stored by "
                        f"numpy as raw |V2 bytes: not restorable")
                a = _read_leaf(d, payloads, key, meta)
                nxt = (key, meta, a, pool.submit(_crc, a) if verify else None)
            if pending is not None:
                pkey, pmeta, pa, crc = pending
                if crc is not None and crc.result() != pmeta["crc32"]:
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
                                      list(manifest["leaves"]), True):
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


def _to_like(key: str, a: np.ndarray, ref, dst):
    """The restored leaf: copied into ``dst`` in place, or a tensor on
    ``ref``'s device (a numpy array where ``ref`` is not a tensor)."""
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
         verify: bool = True, into=None):
    """Restore the tree structured like ``like``; returns ``(tree, step)``.

    Each leaf lands on the device of the matching ``like`` leaf; with
    ``into`` (a tree of tensors, which is also the template when ``like``
    is None) every leaf is copied into ``into``'s tensor in place and
    ``into`` is returned.  With ``verify`` every leaf's crc32 is checked
    against the manifest before the leaf is placed; a mismatch or an
    unreadable payload raises :class:`CorruptCheckpointError` (with
    ``into``, the leaves placed before it stay overwritten).
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
    out = {}
    try:
        for key, _, a in _stream(d, manifest, payloads,
                                 [k for k, _ in items], verify):
            ref = refs[key]
            if tuple(a.shape) != tuple(_leaf_shape(ref)):
                raise ValueError(f"shape mismatch for {key!r}: "
                                 f"{a.shape} vs {_leaf_shape(ref)}")
            out[key] = _to_like(key, a, ref, dsts.get(key))
            del a
    finally:
        for pz in payloads.values():
            pz.close()
    if into is not None:
        return into, step
    return _unflatten_like(like, out), step
