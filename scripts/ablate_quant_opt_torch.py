"""What holds the per-matrix launches of ``quant.cu`` and ``opt_step.cu``:
each source is rebuilt with one part changed at a time and each variant's
kernel device time is read from a ``torch.profiler`` trace (cold L2; the
wrapper's buffer zeroing is not in it).

    python3 scripts/ablate_quant_opt_torch.py

Variants of ``quant.cu`` (RTN and RR casts, int4, per-matrix scales):

* ``base``       — the source as it is (16-byte vector streams);
* ``noscan``     — no absmax phase (the grid barrier stays; every scale is
  1, so the outputs are wrong by design): phase 2 alone;
* ``scalar``     — 4-byte accesses everywhere (the alignment flag off);
* ``big``        — the base source on a plan of 16-tile chunks (the grid
  follows): each block streams a region of its own, where one-tile
  chunks keep all blocks in one window of consecutive chunks;
* ``u2`` / ``u8`` — 2 or 8 vectors a thread per stream in flight in
  phase 2 (the source has 4);
* ``lb4``        — ``__launch_bounds__(256, 4)``: at most 64 registers;
* ``tma`` / ``tma_noscan`` — phase 2 through a ring of 1-D TMA bulk
  copies (``cp.async.bulk`` + ``mbarrier``, 4 stages, 32 KB a block) into
  shared memory, with and without the absmax phase.  It assumes every
  matrix is a whole number of 16-byte pieces, true of the shapes here.

Variants of ``opt_step.cu`` (AdamW, lam 1e3, int4 per-matrix; and mode
none, lam 0): ``base``, ``noscan``, ``scalar``, ``big``, ``u1`` / ``u4``
(the source has 2), ``lb3`` (``__launch_bounds__(256, 3)``).

For Granite-3-2B's four eligible leaf shapes it prints one JSON line per
(kernel, cast or mode, shape) with each variant's device ms (and, for
quant, its grid), then one line per (kernel, cast or mode) summed over
the 7 eligible leaves, with the rate of the bytes the call must move (w
read twice under per-matrix scales); then the card's name and power
limit.
Needs CUDA and ``nvcc``; builds into a temporary directory.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

KERNELS = os.path.join(ROOT, "src/repro_torch/kernels")
QUANT = os.path.join(KERNELS, "quant/csrc/quant.cu")
OPT = os.path.join(KERNELS, "opt_step/csrc/opt_step.cu")
HEADER = os.path.join(KERNELS, "quant/csrc/quant_math.cuh")

NOSCAN_Q = ("  qm::scan_absmax(w, a.amax, a.wk, a.off, a.vec);\n"
            "  cooperative_groups::this_grid().sync();\n",
            "  cooperative_groups::this_grid().sync();\n")
NOSCAN_O = ("    qm::scan_absmax(w, a.amax, a.wk, a.off, a.vec);\n"
            "    cooperative_groups::this_grid().sync();\n",
            "    cooperative_groups::this_grid().sync();\n")
SCALAR = ("  Args a{", "  const uintptr_t no_vec = 1;\n  Args a{")
SCALAR_Q = ("(reinterpret_cast<uintptr_t>(out) & vb) == al &&",
            "!no_vec && (reinterpret_cast<uintptr_t>(out) & vb) == al &&")
# the TMA ring streams fp32 only: leave the bf16 instance out of its build
NOBF16 = ("  if (bf16) return (const void*)quant_matrix_kernel<false, false, "
          "__nv_bfloat16>;\n", "")
SCALAR_O = ("same(g) && same(mu) && same(nu)",
            "!no_vec && same(g) && same(mu) && same(nu)")

# Phase 2 of quant_matrix_kernel through a TMA bulk-copy ring: thread 0
# keeps kStages - 1 pieces in flight, every thread casts a landed piece
# from shared memory, a block barrier frees its stage.
TMA_PHASE2 = r'''
  constexpr int kPiece = RR ? 1024 : 2048;     // elements a stream a stage
  constexpr int kStages = 4;
  constexpr int kStreams = RR ? 2 : 1;
  __shared__ __align__(128) float ring[kStages][kStreams * kPiece];
  __shared__ __align__(8) unsigned long long full[kStages];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(&full[i]))));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  struct Piece { qm::ChunkIter it; int64_t p, e; };
  auto start = [&](Piece& q) {
    if (q.it.left > 0) { int64_t s0; qm::chunk_range(a.wk, q.it.m, q.it.j, s0, q.e); q.p = s0; }
  };
  auto advance = [&](Piece& q) {
    q.p += kPiece;
    if (q.p >= q.e) { q.it.next(); start(q); }
  };
  Piece prod{qm::ChunkIter(a.wk, a.wk.chunks), 0, 0};
  start(prod);
  Piece cons = prod;
  auto issue = [&](int64_t t) {
    const int st = static_cast<int>(t % kStages);
    const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(&full[st]));
    const int64_t left = prod.e - prod.p;
    const unsigned bytes = static_cast<unsigned>(left < kPiece ? left : kPiece) * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                 "r"(bar), "r"(bytes * kStreams) : "memory");
    for (int k = 0; k < kStreams; ++k)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::
          "r"(static_cast<unsigned>(__cvta_generic_to_shared(&ring[st][k * kPiece]))),
          "l"((k ? u : w) + prod.p), "r"(bytes), "r"(bar) : "memory");
    advance(prod);
  };
  int64_t issued = 0;
  if (threadIdx.x == 0)
    for (; issued < kStages - 1 && prod.it.left > 0; ++issued) issue(issued);
  int64_t cur = -1;
  float s = 1.f;
  for (int64_t t = 0; cons.it.left > 0; ++t) {
    if (threadIdx.x == 0 && prod.it.left > 0) issue(issued++);
    if (cons.it.m != cur) {
      cur = cons.it.m;
      s = qm::scale_of(__uint_as_float(__ldcg(a.amax + cur)), a.qmax);
    }
    const int st = static_cast<int>(t % kStages);
    const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(&full[st]));
    const unsigned parity = static_cast<unsigned>((t / kStages) & 1);
    asm volatile(
        "{\n .reg .pred P1;\n LAB_WAIT:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        " @P1 bra DONE;\n bra LAB_WAIT;\n DONE:\n}\n" :: "r"(bar), "r"(parity) : "memory");
    const int64_t left = cons.e - cons.p;
    const int len = static_cast<int>(left < kPiece ? left : kPiece);
    for (int i = 4 * threadIdx.x; i < len; i += qm::kVecStride) {
      const float4 x = *reinterpret_cast<const float4*>(&ring[st][i]);
      const float4 r = RR ? *reinterpret_cast<const float4*>(&ring[st][kPiece + i]) : x;
      qm::st_last4(out + cons.p + i, cast4<FP4, RR>(x, r, s, a.qmax));
    }
    __syncthreads();
    advance(cons);
  }
}
'''
TMA_START = ("  int64_t cur = -1;\n  float s = 1.f;\n"
             "  for (qm::ChunkIter it(a.wk, a.wk.chunks)")
TMA_END = ("template <bool FP4, bool RR>\n"
           "__global__ void __launch_bounds__(kThreads)\nquant_block_kernel")


def _tma(text):
    i, j = text.index(TMA_START), text.index(TMA_END)
    return text[:i] + TMA_PHASE2.lstrip("\n") + "\n" + text[j:]


QUANT_VARIANTS = {
    "base": [], "noscan": [NOSCAN_Q], "scalar": [SCALAR, SCALAR_Q],
    "u2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "u8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "lb4": [("__launch_bounds__(kThreads)\nquant_matrix_kernel",
             "__launch_bounds__(kThreads, 4)\nquant_matrix_kernel")],
    "tma": [NOBF16, _tma], "tma_noscan": [NOBF16, NOSCAN_Q, _tma],
}
OPT_VARIANTS = {
    "base": [], "noscan": [NOSCAN_O], "scalar": [SCALAR, SCALAR_O],
    "u1": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 1;")],
    "u4": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    "lb3": [("__launch_bounds__(kThreads)\nopt_step_kernel(",
             "__launch_bounds__(kThreads, 3)\nopt_step_kernel(")],
}


def _edit(texts, edits, name):
    """Apply each edit to the one text (source or header) that holds it."""
    texts = list(texts)
    for e in edits:
        if callable(e):
            texts[0] = e(texts[0])
            continue
        old, new = e
        hits = [i for i, t in enumerate(texts) if t.count(old) == 1]
        if len(hits) != 1:
            raise RuntimeError(f"{name}: the sources no longer have {old!r}")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    return texts


def build(tmp):
    """One shared library per (source, variant), compiled in parallel, each
    in a directory of its own with its copy of quant_math.cuh."""
    from repro_torch.kernels import _build
    header = open(HEADER).read()
    procs = []
    for src, variants in ((QUANT, QUANT_VARIANTS), (OPT, OPT_VARIANTS)):
        text = open(src).read().replace(
            '#include "../../quant/csrc/quant_math.cuh"',
            '#include "quant_math.cuh"')
        for name, edits in variants.items():
            tag = f"{os.path.basename(src)[:-3]}_{name}"
            d = os.path.join(tmp, tag)
            os.makedirs(d)
            cu_text, h_text = _edit((text, header), edits, tag)
            open(os.path.join(d, "quant_math.cuh"), "w").write(h_text)
            cu, so = os.path.join(d, tag + ".cu"), os.path.join(d, tag + ".so")
            open(cu, "w").write(cu_text)
            procs.append((src, name, so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-shared",
                 "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {QUANT: {}, OPT: {}}
    for src, name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src} {name}:\n{out}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[src][name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_quant_opt_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.opt_step import fused_opt_step_leaf
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.kernels.quant import quant_rr, quant_rtn

    dev = torch.device("cuda")
    flush = torch.ones(512 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)

    def variants(libs):
        """(name, library) in order, with the plan-only ``big`` after
        ``base``; selecting one loads its library and sets the tile."""
        for name, lib in libs.items():
            for v in ((name, "big") if name == "base" else (name,)):
                _build._lib = lib
                _build._blocks_per_sm.cache_clear()
                quant_ops.TILE = 16 * tile if v == "big" else tile
                yield v

    def device_ms(fn, key, n=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        return sum(getattr(ev, "device_time_total", 0)
                   for ev in prof.key_averages() if key in ev.key) / n / 1e3

    eligible = [(s, c) for s, c, e in cs.GRANITE_LEAVES if e]
    tile = quant_ops.TILE
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        sums = {}
        for shape, count in eligible:
            w = torch.randn(shape, generator=gen, device=dev) * 0.02
            u = torch.rand(shape, generator=gen, device=dev)
            n = w.numel()
            for cast in ("rtn", "rr"):
                row = dict(phase="ablation", kernel="quant", cast=cast,
                           shape=cs._fmt_shape(shape))
                for name in variants(libs[QUANT]):
                    fn = ((lambda: quant_rtn(w, "int4", -1)) if cast == "rtn"
                          else (lambda: quant_rr(w, u, "int4", -1)))
                    row[name + "_ms"] = device_ms(fn, "quant_matrix_kernel")
                    row[name + "_blocks"] = quant_ops.launch_plan(
                        w, "int4", cast == "rr").blocks
                    key = ("quant", cast, name)
                    sums[key] = sums.get(key, 0.0) + row[name + "_ms"] * count
                row["bytes_floor"] = n * 4 * (4 if cast == "rr" else 3)
                print(json.dumps(row), flush=True)
            del u
            g = torch.randn(shape, generator=gen, device=dev) * 1e-3
            mu = torch.randn(shape, generator=gen, device=dev) * 1e-4
            nu = torch.rand(shape, generator=gen, device=dev) * 1e-6
            for mode, lam in (("matrix", 1e3), ("none", 0.0)):
                row = dict(phase="ablation", kernel="opt_step", mode=mode,
                           shape=cs._fmt_shape(shape))
                for name in variants(libs[OPT]):
                    if mode == "none" and name == "noscan":
                        continue
                    row[name + "_ms"] = device_ms(
                        lambda: fused_opt_step_leaf(
                            w, g, mu, nu, lr=1e-12, bc1=0.271, bc2=0.143,
                            clip_scale=0.5, lam=lam, fmt_name="int4",
                            block_size=-1, **cs.OPT_HYPER), "opt_step_kernel")
                    key = ("opt_step", mode, name)
                    sums[key] = sums.get(key, 0.0) + row[name + "_ms"] * count
                row["bytes_floor"] = n * 4 * (8 if mode == "matrix" else 7)
                print(json.dumps(row), flush=True)
            del w, g, mu, nu
            torch.cuda.empty_cache()
        n_elig = sum(torch.Size(s).numel() * c for s, c in eligible)
        for (kernel, what), per_elem in (
                (("quant", "rtn"), 12), (("quant", "rr"), 16),
                (("opt_step", "matrix"), 32), (("opt_step", "none"), 28)):
            row = dict(phase="ablation_sum", kernel=kernel, of=what,
                       leaves="the 7 eligible", bytes=n_elig * per_elem)
            for (k, wh, name), ms in sums.items():
                if (k, wh) == (kernel, what):
                    row[name + "_ms"] = ms
                    row[name + "_tb_per_s"] = n_elig * per_elem / ms / 1e9
            print(json.dumps(row), flush=True)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
