"""What the card's machine offers a checkpointed training run: the
filesystems and their free space, host RAM, the disk's write (with
fsync) and read rates, zlib's crc32 rate on one core, and whether a
training step repeats bitwise (3 steps of 2 full-width Granite-3-2B
layers, run twice from the same seed, then one step under
``torch.use_deterministic_algorithms(True, warn_only=True)``, naming every
op that has no deterministic version).

    python3 scripts/host_probe_torch.py

Writes a 4 GiB file into the checkout and into the temp dir (removed at
once) and prints what it found.  Needs CUDA for the training part.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def _sh(cmd):
    print("$", cmd, flush=True)
    print(subprocess.run(cmd, shell=True, capture_output=True,
                         text=True).stdout, flush=True)


def disk_rates(a: np.ndarray, copies: int = 4) -> None:
    for d in sorted({os.path.abspath(ROOT), tempfile.gettempdir()}):
        fd, p = tempfile.mkstemp(prefix="host_probe_", dir=d)
        os.close(fd)
        try:
            t0 = time.perf_counter()
            with open(p, "wb") as f:
                for _ in range(copies):
                    f.write(memoryview(a))
                f.flush()
                os.fsync(f.fileno())
            w = time.perf_counter() - t0
            t0 = time.perf_counter()
            with open(p, "rb") as f:
                while f.read(1 << 26):
                    pass
            r = time.perf_counter() - t0
            n = copies * a.nbytes
            print(f"disk {d}: free {shutil.disk_usage(d).free / 1e9:.1f} "
                  f"GB; write+fsync {n / w / 1e9:.3f} GB/s; read "
                  f"{n / r / 1e9:.3f} GB/s", flush=True)
        finally:
            os.remove(p)


def repeatability(dev) -> None:
    import chip_smoke as cs

    def run(n):
        cfg, step, _, st = cs.granite_trainer(dev, n_layers=2)
        pipe, _ = cs._pipeline(cfg, dev, cs.TRAIN_BATCH, cs.TRAIN_SEQ)
        losses = []
        try:
            for _ in range(n):
                st, m = step(st, next(pipe))
                losses.append(float(m["loss"]))
        finally:
            pipe.close()
        return losses, [x.cpu() for _, x in cs._state_leaves(st)]

    l1, s1 = run(3)
    l2, s2 = run(3)
    differ = [i for i, (a, b) in enumerate(zip(s1, s2))
              if not torch.equal(cs._bits(a), cs._bits(b))]
    print(f"3 steps twice: losses {l1} vs {l2}, equal {l1 == l2}; "
          f"state leaves differing: {differ}", flush=True)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run(1)
    finally:
        torch.use_deterministic_algorithms(False)
    print("ops without a deterministic version:",
          sorted({str(w.message)[:300] for w in caught}), flush=True)


def main() -> int:
    _sh("df -h; free -g; nproc; nvidia-smi --query-gpu=name,power.limit "
        "--format=csv,noheader")
    a = np.random.default_rng(0).standard_normal(1 << 28, dtype=np.float32)
    t0 = time.perf_counter()
    zlib.crc32(a)
    print(f"crc32 of 1 GiB: {a.nbytes / (time.perf_counter() - t0) / 1e9:.2f}"
          f" GB/s on one core", flush=True)
    disk_rates(a)
    del a
    if not torch.cuda.is_available():
        print("host_probe_torch: no CUDA device, no training check",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    _build.lib()
    repeatability(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
