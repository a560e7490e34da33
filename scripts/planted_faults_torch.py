"""How much a wrong kernel or a wrong piece of the serving path moves
``chip_smoke.py``'s card-against-CPU and ring-against-paged checks: run
each of those phases once sound and once with each fault planted on the
card side only, by patching a function for the length of the run.

Training (phase ``train_card_vs_cpu``: 1-layer Granite-3-2B at full width,
fp32, 3 LOTION steps, then the fp32 and RTN eval CE and the per-step
penalty):

* ``no_penalty``    — ``opt_step`` with lam = 0 (the decoupled penalty dropped);
* ``no_update``     — ``opt_step`` with ok = 0 (no parameter update);
* ``unrounded_rtn`` — the RTN eval cast returns the weights unrounded.

The W4A8 row quantizer inside ``wqt_matmul_a8.cu`` (phase
``a8_adversarial``: ``chip_smoke.py``'s adversarial rows of both W4A8
entries, among them rows whose absmax sits at K's last element or at the
first of the last K split):

* ``acts_absmax_short`` — the cluster combines the row maxima of all K
  splits but the last (the launch plan's ``amax_ranks`` one short; with
  one split no maxima, so every row scale is 1 and the codes saturate):
  rows whose absmax lies in the last split get too small a scale.  The
  scheduler's card-against-CPU phase, at its 5% logit tolerance for int8
  activations, does not see it; the bitwise check rows do.

The per-matrix absmax phase of ``quant`` and ``opt_step`` (phases
``quant_adversarial`` and ``opt_step_adversarial``: the adversarial check
rows of ``chip_smoke.py``, the largest |w| of each matrix at its first or
last element or on a chunk boundary, an all-zero matrix, a NaN):

* ``absmax_short`` — the launch plan's absmax phase walks one chunk fewer
  per matrix than the cast or step phase.

The one-launch ``lotion_reg`` (phase ``reg_adversarial``:
``chip_smoke.py``'s adversarial ``lotion_reg`` rows on Granite and testbed
leaves in both per-matrix regimes, the largest |w| at a matrix's first or
last element or on a chunk or cluster-block boundary, an all-zero matrix,
a NaN):

* ``reg_absmax_short``      — the plan's absmax walk takes one chunk (grid
  regime) or one cluster block fewer per matrix than the gradient walk;
* ``reg_sum_drops_partial`` — the penalty's sum leaves out the last
  block's partial.

The paper's baselines (phases ``check_ste``: the straight-through
estimators on a stacked leaf, and ``train_baselines_card_vs_cpu``: QAT
and RAT on 1 full-width layer, card against CPU from the same uniforms,
then RAT's two microbatches against one on the card):

* ``ste_drops_grad``            — the STE of one weight leaf (the first
  (..., 2048, 8192) one of each forward: ``w_gate``) passes no gradient;
* ``rat_uniforms_per_microbatch`` — RAT's per-step generator is not
  re-seeded for the second microbatch, which casts against fresh draws.

Checkpoints and self-healing training (phases ``train_chaos``: the skip
gate on a NaN step, then the chaos harness on one and two simulated
hosts; ``train_resume``: crash-exact auto-resume on 1 full-width layer,
then a payload rewritten with one leaf changed):

* ``skip_gate_open``       — ``opt_step``'s ok operand forced to 1, so a
  poisoned step updates w, mu and nu;
* ``resume_drops_moments`` — ``checkpoint.load`` restores the parameters
  but zeroes mu and nu;
* ``load_skips_crc``       — ``checkpoint.load`` ignores ``verify`` (the
  manifest's crc32s are not checked).

Static serving (phase ``serve_card_vs_cpu``: 2-layer Granite-3-2B at full
width, int4 weights, prefill and first decode-step logits):

* ``dropped_k_split`` — ``wqt_matmul``'s launch plan drops its last K
  split (its last K step where there is one split), so every weight
  matmul on the card misses part of its contraction.

Scheduling (phases ``sched_card_vs_cpu`` and ``sched_ring_vs_paged``: the
paged W4A8 scheduler on 1 and 4 full-width layers):

* ``paged_first_block`` — ``decode_attn_paged`` reads every tile through
  each row's first table entry;
* ``shadow_view``       — prefix-trie payloads are views of the partial
  cache buffer instead of copies;
* ``dropped_attn_split`` — ``decode_attn``'s launch plan has one split
  fewer.  The splits end at the ring's end, so the first one is never
  read: at the scheduler's 256-slot ring (4 splits of 64) slots 0-63, the
  64-token system prompt every request of the workload starts with.

The paper's synthetic testbed (phase ``synth_quadratic``: §4.1 at d =
12000, then every method card against CPU from the same draws):

* ``rr_uniforms_ignore_step`` — the testbeds' RR cast on the card reuses
  the first uniforms it was given for a shape, whatever the step.

Long-context training (phase ``train_long``: 1 full-width layer at batch
1 x 8192, streaming attention and the chunked head against the unchunked
step):

* ``softmax_drops_alpha`` — the online softmax on the card adds each key
  chunk without rescaling the running denominator and output by
  ``alpha = exp(m - m_new)``.

The rest of the model zoo (phases ``serve_moe``: Moonlight at 12
full-width layers served static and through the W4A8 scheduler, then a
decode step whose masked rows hold zeros or copies of the live row;
``serve_moe_card_vs_cpu`` and ``serve_archs_card_vs_cpu``: Moonlight at 2
layers, CodeQwen at 2 and Gemma3 at 6, card against CPU in fp32, the
MoE routing recorded; ``musicgen_decode``: MusicGen at full depth
against its own forward, then 2 layers against the CPU):

* ``moe_ignores_token_mask``    — the MoE dispatch on the card drops
  ``token_mask``, so dead decode rows take expert capacity;
* ``moe_capacity_off_by_one``   — the per-group capacity on the card is
  one less than ceil(g * k / E * cf);
* ``attn_drops_newest``         — ``decode_attn`` on the card reads each
  row's ring as of one position earlier, so the slot just written is
  left out (the control of the decode steps' card-against-CPU limit);
* ``codebook_embed_drops_last`` — the codebook embedding on the card sums
  every codebook's rows but the last.

The SSM blocks (phases ``ssm_card_vs_cpu``: Zamba2 cut to one scan
group and RWKV6 to 2 layers, full width, fp32, card against CPU, prefill
logits and recurrent states and 4 decode steps; ``ssm_chunked_vs_exact``:
one full-width block of each kind, chunked against the exact scan, and
prefill + one decode step against the full forward on the same cuts):

* ``rwkv_var_unbiased``       — RWKV6's per-head group norm on the card
  divides by n - 1 (``correction=1``) instead of n;
* ``ssd_drops_carried_state`` — Mamba2's chunked SSD on the card leaves
  out the carried-in state's contribution (``y_off``) for every chunk
  after the first (the final state stays right);
* ``mamba_conv_tail_stale``   — Mamba2's decode step on the card keeps
  the old conv state instead of shifting the new token in.

Cross-attention (phase ``vision_card_vs_cpu``: one pattern unit of
Llama-3.2-Vision at full width, fp32, card against CPU, each row its own
image: prefill and 4 decode steps, the cross K/V the prefill caches):

* ``gate_ignored``  — the cross layers on the card take ``tanh(gate)`` as
  1, so the cross path enters the residual ungated;
* ``cross_kv_row0`` — cross-attention decode on the card reads row 0's
  cached cross K/V for every row (the prefill is right; the decode steps
  of every other row attend the wrong image).

The training kernels on a leaf past 2^31 elements (phase ``moe_leaf``:
``opt_step`` and ``lotion_reg`` on Moonlight's (12, 64, 2048, 1408)
expert stack, every layer's slice against the plain version):

* ``count_wrapped_at_2_31`` — the host wrappers of ``opt_step`` and
  ``lotion_reg`` hand the kernel the leaf's element count held in 31
  bits, so the launch walks the first 23 of its 768 matrices.

Sharded training (phase ``train_mesh_two_ranks``: two processes share the
card over gloo, meshes (2, 1) and (1, 2), each step against one rank; the
fault is planted in both rank processes through ``MESH_RANKS_FAULT``):

* ``own_absmax``                 — each block casts and steps with its own
  per-matrix absmax, not the whole matrix's;
* ``grads_not_summed_over_data`` — a gathered leaf's gradient is cut to the
  rank's block without the sum over the data ranks;
* ``skip_gate_per_rank``         — the skip flag is decided on each rank's
  rows alone;
* ``ef_block_cast_across_ranks`` — EF casts a gradient block whose cut
  splits quant blocks where it lies, without the gather (the EF rows'
  split leaf parts from one rank).

The mesh chaos tier (phase ``train_mesh_chaos``: train_chaos's two-host
run through the launcher's ``mesh_chaos`` on (2, 1), two processes
sharing the card; planted in both rank processes through
``MESH_RANKS_FAULT``):

* ``replica_flipped_on_rank1`` — after its first step, rank 1 flips one
  bit of its copy of a replicated parameter (the replica audit and the
  ranks' fingerprints must report it);
* ``write_kill_only_on_writer`` — a sharded save's write stages are not
  passed to the other rank's hook, so the injected mid-write kill is an
  ``IOError`` on rank 1 (its segment ends apart from rank 0's, and the
  phase fails within its join timeout).

Sharded serving (phase ``serve_mesh_two_ranks``: two processes share the
card over gloo, meshes (2, 1) and (1, 2), each run against one rank; the
fault is planted in both rank processes through ``SERVE_RANKS_FAULT``):

* ``blockwise_scales_not_gathered`` — a QTensor's codes are gathered, its
  blockwise scales stay the rank's own block (the run with int4 block
  128 scales);
* ``int4_codes_gathered_reversed``  — int4 codes cut along their packed
  in-dim are joined in the reverse rank order.

The dry-run (phase ``dryrun_collectives``: the collectives its trace of
``train_mesh_two_ranks``' steps issues, against that phase's live
counts; the fault is planted in the tracing process through
``DRYRUN_FAULT``):

* ``dryrun_backward_skips_dp_sum`` — ``launch/dryrun.py`` alone installs
  roles whose backward does no all-reduce over the data axes (the live
  steps keep theirs; a fault in code both share would move both counts).

    python3 scripts/planted_faults_torch.py [--only PHASE[,PHASE...]]

``--only`` runs just the groups that hold one of the named phases.  Prints one JSON line per run of a phase with its numbers against their
limits and whether the phase failed.  Exits 1 unless every sound run
passes and every planted fault fails a phase it is run against.  The code
in the repository is not changed.  Needs CUDA.
"""

import argparse
import contextlib
import json
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


@contextlib.contextmanager
def _patched(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _step_with(**override):
    def wrap(orig):
        def step(w, *args, **kw):
            if w.is_cuda:
                kw.update(override)
            return orig(w, *args, **kw)
        return step
    return wrap


def _unrounded(orig):
    def rtn(x, fmt_name, block_size=-1):
        return x.clone() if x.is_cuda else orig(x, fmt_name, block_size)
    return rtn


def _drop_grad(orig):
    """fake_quant_rtn whose every other call on a CUDA (..., 2048, 8192)
    tensor (the first such leaf of each forward_params) passes a zero
    gradient to it."""
    calls = [0]

    def fq(x, fmt, block_size=-1):
        if x.is_cuda and tuple(x.shape[-2:]) == (2048, 8192):
            calls[0] += 1
            if calls[0] % 2:
                return orig(x.detach(), fmt, block_size) + 0.0 * x
        return orig(x, fmt, block_size)
    return fq


def _one_generator_per_step(orig):
    """step_generator that hands every microbatch of a step the same
    generator object, so the second one draws on from the first's state."""
    made = {}

    def gen(seed, step, device):
        key = (seed, step, str(device))
        if key not in made:
            made[key] = orig(seed, step, device)
        return made[key]
    return gen


def _drop_moments(orig):
    """checkpoint.load that zeroes the restored fused state's mu and nu
    on the card."""
    def load(*args, **kw):
        tree, step = orig(*args, **kw)
        opt = tree.get("opt") if isinstance(tree, dict) else None
        if isinstance(opt, dict) and "mu" in opt:
            from repro_torch.core.policy import tree_leaves
            for x in tree_leaves(opt["mu"]) + tree_leaves(opt["nu"]):
                if x.is_cuda:
                    x.zero_()
        return tree, step
    return load


def _skip_crc(orig):
    def load(*args, **kw):
        kw["verify"] = False
        return orig(*args, **kw)
    return load


def _first_block(orig):
    def attn(q, kc, ks, vc, vs, block_tables, pos, **kw):
        if q.is_cuda:
            block_tables = block_tables[:, :1].expand_as(
                block_tables).contiguous()
        return orig(q, kc, ks, vc, vs, block_tables, pos, **kw)
    return attn


def _absmax_short(orig):
    def plan(*args, **kw):
        p = orig(*args, **kw)
        return p._replace(amax_ranks=p.splits - 1)
    return plan


def _view(orig):
    def chunk(a, i, c):
        return a[:, :, i * c:(i + 1) * c] if a.is_cuda else orig(a, i, c)
    return chunk


def _drop_last_split(orig):
    def plan(*args, **kw):
        p = orig(*args, **kw)
        if p.splits > 1:
            return p._replace(splits=p.splits - 1)
        return p._replace(k_per_split=p.k_per_split - p.tile_k)
    return plan


def _scan_short(orig):
    def plan(*args, **kw):
        p = orig(*args, **kw)
        return p._replace(scan_chunks=max(p.chunks - 1, 0))
    return plan


def _drop_partial(orig):
    def plan(*args, **kw):
        p = orig(*args, **kw)
        return p._replace(sum_blocks=p.sum_blocks - 1)
    return plan


def _drop_first_split(orig):
    def plan(*args, **kw):
        p = orig(*args, **kw)
        if p.splits == 1:
            return p
        return p._replace(splits=p.splits - 1,
                          blocks=p.blocks // p.splits * (p.splits - 1))
    return plan


def _first_uniforms(orig):
    """quant_rr that, on the card, casts against the first uniforms it
    saw for each shape."""
    seen = {}

    def rr(w, uniforms, *args, **kw):
        if w.is_cuda:
            uniforms = seen.setdefault(tuple(w.shape), uniforms)
        return orig(w, uniforms, *args, **kw)
    return rr


def _no_alpha(orig):
    def step(m, s, o, logits, vc, dtype):
        if not logits.is_cuda:
            return orig(m, s, o, logits, vc, dtype)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        return m_new, s + torch.sum(p, dim=-1), o + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(dtype), vc).to(torch.float32)
    return step


def _one_position_earlier(orig):
    def attn(q, kc, ks, vc, vs, pos, **kw):
        return orig(q, kc, ks, vc, vs, pos - 1 if q.is_cuda else pos, **kw)
    return attn


def _no_token_mask(orig):
    def moe(params, spec, x, token_mask=None):
        return orig(params, spec, x,
                    token_mask=None if x.is_cuda else token_mask)
    return moe


def _capacity_off_by_one(orig):
    def route(router, spec, xt, *args, **kw):
        r = orig(router, spec, xt, *args, **kw)
        if not xt.is_cuda:
            return r
        oh, cap = r["onehot"], r["cap"] - 1
        g, t, k, e = oh.shape
        raw = ((torch.cumsum(oh.reshape(g, t * k, e), 1, dtype=torch.int32)
                .reshape(oh.shape) - oh) * oh).sum(-1)
        keep = raw < cap
        return dict(r, keep=keep, cap=cap,
                    pos=torch.where(keep, raw, 0).to(torch.int32))
    return route


def _drop_last_codebook(orig):
    def embed(params, cfg, tokens):
        if tokens.is_cuda and cfg.n_codebooks > 1:
            import dataclasses
            cfg = dataclasses.replace(cfg, n_codebooks=cfg.n_codebooks - 1)
            params = dict(params, embed=params["embed"][:-1])
            tokens = tokens[..., :-1]
        return orig(params, cfg, tokens)
    return embed


def _unbiased_var(orig):
    def group_norm(y, h):
        if not y.is_cuda:
            return orig(y, h)
        yh = y.reshape(y.shape[:-1] + (h, y.shape[-1] // h))
        mean = yh.mean(-1, keepdim=True)
        var = yh.var(-1, keepdim=True, correction=1)
        return ((yh - mean) * torch.rsqrt(var + 64e-5)).reshape(y.shape)
    return group_norm


def _no_carried_state(orig):
    """_ssd_chunked that, on the card, computes each chunk's output from a
    zero carried-in state (its final state from the whole sequence)."""
    def ssd(x, dt, a_neg, B, C, chunk):
        y, S = orig(x, dt, a_neg, B, C, chunk)
        if not x.is_cuda:
            return y, S
        ys = [orig(x[:, i:i + chunk], dt[:, i:i + chunk], a_neg,
                   B[:, i:i + chunk], C[:, i:i + chunk], chunk)[0]
              for i in range(0, x.shape[1], chunk)]
        return torch.cat(ys, dim=1), S
    return ssd


def _stale_conv(orig):
    def decode(params, spec, x, state):
        out, new = orig(params, spec, x, state)
        if x.is_cuda:
            new = dict(new, conv=state["conv"])
        return out, new
    return decode


def _gate_one(orig):
    def gate(p, dtype):
        g = orig(p, dtype)
        return torch.ones_like(g) if g.is_cuda else g
    return gate


def _cross_row0(orig):
    def cross(params, spec, x, cross_kv):
        if x.is_cuda:
            cross_kv = tuple(c[:1].expand_as(c) for c in cross_kv)
        return orig(params, spec, x, cross_kv)
    return cross


class _Lib31:
    """A kernel library whose ``opt_step`` and ``lotion_reg`` launches get
    their element count modulo 2^31."""
    N_ARG = {"opt_step_launch": 9, "lotion_reg_launch": 5}

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self.N_ARG:
            return fn

        def call(*args):
            args = list(args)
            args[self.N_ARG[name]] %= 2 ** 31
            return fn(*args)
        return call


class _Build31:
    def __init__(self, build):
        self._build = build

    def __getattr__(self, name):
        return getattr(self._build, name)

    def lib(self):
        return _Lib31(self._build.lib())


@contextlib.contextmanager
def _count_wrapped(*modules):
    with contextlib.ExitStack() as stack:
        for m in modules:
            stack.enter_context(_patched(m, "_build", _Build31))
        yield


def _own_absmax(orig):
    """matrix_absmax that returns the block's own maxima (no MAX over the
    ranks that cut the matrix)."""
    def absmax(x, sh):
        return torch.linalg.vector_norm(
            x.detach(), ord=float("inf"),
            dim=tuple(range(max(x.ndim - 2, 0), x.ndim))).reshape(-1)
    return absmax


def _no_dp_sum(orig):
    """The gathered leaves' gradients not summed over the data ranks."""
    return lambda g, mesh: g.contiguous()


def _gate_per_rank(orig):
    """all_reduce that leaves a MIN (the skip gate's) to each rank."""
    def all_reduce(x, op, mesh, axes):
        return x if op == "min" else orig(x, op, mesh, axes)
    return all_reduce


def _sharding_patch(name, wrap):
    def ctx():
        from repro_torch.distributed import sharding
        return _patched(sharding, name, wrap)
    return ctx


def _collectives_patch(name, wrap):
    def ctx():
        from repro_torch.distributed import collectives
        return _patched(collectives, name, wrap)
    return ctx


def _blocks_always_whole(orig):
    """whole_blocks that calls every cut whole: EF casts a block whose
    quant blocks the cut splits where it lies, without the gather."""
    return lambda shape, sh, block_size: True


class _FlipOnRank1:
    """A train step that, on rank 1, flips one bit of its copy of the
    first parameter leaf nothing cuts, once, after its first step."""

    def __init__(self, step, shardings):
        from repro_torch.distributed import sharding
        self.step, self.done = step, False
        self.leaf = next(p for p, s in sharding.tree_leaves_with_path(
            shardings) if sharding.is_replicated(s))
        self.mesh = sharding.mesh_of(shardings)
        for attr in ("optimizer", "grads_of"):
            setattr(self, attr, getattr(step, attr))

    def __call__(self, state, batch):
        state, metrics = self.step(state, batch)
        if not self.done and self.mesh.rank == 1:
            leaf = state["params"]
            for k in self.leaf:
                leaf = leaf[k]
            leaf.view(torch.int32).view(-1)[0] ^= 1
            self.done = True
        return state, metrics


def _flip_on_rank1(orig):
    """launch.train's make_train_step whose sharded step flips a bit of
    rank 1's replica (``_FlipOnRank1``)."""
    def make(*args, grad_shardings=None, **kw):
        step = orig(*args, grad_shardings=grad_shardings, **kw)
        return step if grad_shardings is None else _FlipOnRank1(
            step, grad_shardings)
    return make


def _no_replay(orig):
    """The write stages of a sharded save are not passed to the other
    ranks' hooks: a kill on the writer is an IOError elsewhere."""
    return lambda stages: None


def _launcher_patch(name, wrap):
    def ctx():
        from repro_torch.launch import train
        return _patched(train, name, wrap)
    return ctx


def _ckpt_patch(name, wrap):
    def ctx():
        from repro_torch.checkpoint import io
        return _patched(io, name, wrap)
    return ctx


# the faults of phases train_mesh_two_ranks (the first four) and
# train_mesh_chaos (the last two), applied inside each rank process
# (scripts/mesh_ranks_torch.py reads MESH_RANKS_FAULT)
MESH_FAULTS = {
    "own_absmax": _sharding_patch("matrix_absmax", _own_absmax),
    "grads_not_summed_over_data": _sharding_patch("_reduce_dp", _no_dp_sum),
    "skip_gate_per_rank": _collectives_patch("all_reduce", _gate_per_rank),
    "ef_block_cast_across_ranks": _sharding_patch("whole_blocks",
                                                  _blocks_always_whole),
    "replica_flipped_on_rank1": _launcher_patch("make_train_step",
                                                _flip_on_rank1),
    "write_kill_only_on_writer": _ckpt_patch("_replay_stages", _no_replay),
}
MESH_CHAOS_FAULTS = ("replica_flipped_on_rank1", "write_kill_only_on_writer")


def _codes_only(orig):
    """gather_qtensor that gathers a QTensor's codes and leaves its
    (blockwise) scales the rank's own block."""
    def gather(qt, sh):
        import dataclasses

        from repro_torch.distributed import sharding
        return dataclasses.replace(qt, codes=sharding.gather(qt.codes,
                                                             sh["codes"]))
    return gather


def _codes_reversed(orig):
    """gather_qtensor that joins int4 codes cut along their packed in-dim
    in the reverse rank order."""
    def gather(qt, sh):
        import dataclasses
        import math

        from repro_torch.distributed import sharding
        out = orig(qt, sh)
        axes = sharding.dim_axes(sh["codes"].spec, qt.codes.ndim)[-1]
        n = math.prod(sh["codes"].mesh.shape[a] for a in axes)
        if qt.bits != 4 or n == 1:
            return out
        return dataclasses.replace(out, codes=torch.cat(
            out.codes.chunk(n, dim=-1)[::-1], dim=-1))
    return gather


class _GatherNoDpSum(torch.autograd.Function):
    """The whole leaf forward; backward the gradient cut to the block,
    not summed over the data ranks."""

    @staticmethod
    def forward(ctx, x, sh):
        from repro_torch.distributed import sharding
        ctx.sh = sh
        full = sharding.gather(x, sh)
        return full.clone() if full is x else full

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed import sharding
        if not sharding.is_replicated(ctx.sh):
            g = g[sharding.shard_slices(ctx.sh, tuple(g.shape))].contiguous()
        return g, None


def _roles_without_dp_sum(orig):
    """``train.loop.model_constraints`` with gathers whose backward does no
    all-reduce over the data axes, planted in the dry-run's process only
    (the live steps keep theirs)."""
    def model_constraints(shardings):
        from repro_torch.core.policy import tree_map
        from repro_torch.distributed import sharding

        def fns(tree):
            return tree_map(lambda s: (lambda x: _GatherNoDpSum.apply(x, s)),
                            tree)
        out = {"stage_params": fns(sharding.unit_shardings(
            shardings["stage"]))}
        out.update({k: fns(shardings[k]) for k in orig(shardings)
                    if k != "stage_params"})
        return out
    return model_constraints


def _env_fault(var, name):
    """A fault planted in the processes a phase starts, which read its
    name from the environment variable ``var``."""
    @contextlib.contextmanager
    def ctx():
        prev = os.environ.get(var)
        os.environ[var] = name
        try:
            yield
        finally:
            if prev is None:
                os.environ.pop(var)
            else:
                os.environ[var] = prev
    return ctx


def _loop_patch(name, wrap):
    def ctx():
        from repro_torch.train import loop
        return _patched(loop, name, wrap)
    return ctx


# the faults of phase dryrun_collectives, applied inside the process of
# scripts/dryrun_cells_torch.py, which reads DRYRUN_FAULT
DRYRUN_FAULTS = {
    "dryrun_backward_skips_dp_sum": _loop_patch("model_constraints",
                                                _roles_without_dp_sum),
}

# the faults of phase serve_mesh_two_ranks, applied inside each rank
# process
SERVE_FAULTS = {
    "blockwise_scales_not_gathered": _sharding_patch("gather_qtensor",
                                                     _codes_only),
    "int4_codes_gathered_reversed": _sharding_patch("gather_qtensor",
                                                    _codes_reversed),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases: run only their groups")
    only = set(filter(None, ap.parse_args(argv).only.split(",")))
    if not torch.cuda.is_available():
        print("planted_faults_torch: needs a CUDA device", file=sys.stderr)
        return 1
    import repro_torch.checkpoint.io as ckpt_io
    import repro_torch.core.ste as ste
    import repro_torch.kernels.quant as quant
    import repro_torch.train.loop as loop
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.kernels.decode_attn import ops as attn_ops
    from repro_torch.kernels.lotion_reg import ops as reg_ops
    from repro_torch.kernels.opt_step import ops as opt_ops
    from repro_torch.kernels.wq_matmul import ops as wq_ops
    import repro_torch.models.layers as layers
    import repro_torch.models.lm as lm
    import repro_torch.models.ssm as ssm
    import repro_torch.optim.fused as fused
    import repro_torch.serve.scheduler as scheduler
    import repro_torch.train.synthetic as syn
    import chip_smoke as cs

    dev = torch.device("cuda")
    sound = ("sound", contextlib.nullcontext)
    groups = [
        ([("train_card_vs_cpu", cs.train_card_vs_cpu)], [
            sound,
            ("no_penalty", lambda: _patched(fused, "fused_opt_step_leaf",
                                            _step_with(lam=0.0))),
            ("no_update", lambda: _patched(fused, "fused_opt_step_leaf",
                                           _step_with(ok=0.0))),
            ("unrounded_rtn", lambda: _patched(quant, "quant_rtn",
                                               _unrounded))]),
        ([("check_ste", cs.check_ste),
          ("train_baselines_card_vs_cpu", cs.train_baselines_card_vs_cpu)], [
            sound,
            ("ste_drops_grad", lambda: _patched(ste, "fake_quant_rtn",
                                                _drop_grad)),
            ("rat_uniforms_per_microbatch", lambda: _patched(
                loop, "step_generator", _one_generator_per_step))]),
        ([("train_chaos", cs.train_chaos)], [
            sound,
            ("skip_gate_open", lambda: _patched(fused, "fused_opt_step_leaf",
                                                _step_with(ok=1.0)))]),
        ([("train_resume", cs.train_resume)], [
            sound,
            ("resume_drops_moments", lambda: _patched(ckpt_io, "load",
                                                      _drop_moments)),
            ("load_skips_crc", lambda: _patched(ckpt_io, "load",
                                                _skip_crc))]),
        ([("quant_adversarial", cs.check_quant_adversarial),
          ("opt_step_adversarial", cs.check_opt_adversarial)], [
            sound,
            ("absmax_short", lambda: _patched(quant_ops, "plan",
                                              _scan_short))]),
        ([("reg_adversarial", cs.check_reg_adversarial)], [
            sound,
            ("reg_absmax_short", lambda: _patched(reg_ops, "plan",
                                                  _scan_short)),
            ("reg_sum_drops_partial", lambda: _patched(reg_ops, "plan",
                                                       _drop_partial))]),
        ([("a8_adversarial", cs.check_a8_adversarial)], [
            sound,
            ("acts_absmax_short", lambda: _patched(wq_ops, "a8_plan",
                                                   _absmax_short))]),
        ([("serve_card_vs_cpu", cs.card_vs_cpu)], [
            sound,
            ("dropped_k_split", lambda: _patched(wq_ops, "plan",
                                                 _drop_last_split))]),
        ([("sched_card_vs_cpu", cs.sched_card_vs_cpu),
          ("sched_ring_vs_paged", cs.sched_ring_vs_paged)], [
            sound,
            ("paged_first_block", lambda: _patched(
                layers, "decode_attn_paged", _first_block)),
            ("shadow_view", lambda: _patched(scheduler, "_chunk_copy",
                                             _view)),
            ("dropped_attn_split", lambda: _patched(attn_ops, "plan",
                                                    _drop_first_split))]),
        ([("synth_quadratic", cs.synth_quadratic)], [
            sound,
            ("rr_uniforms_ignore_step", lambda: _patched(syn, "quant_rr",
                                                         _first_uniforms))]),
        ([("train_long", cs.train_long)], [
            sound,
            ("softmax_drops_alpha", lambda: _patched(layers, "_stream_step",
                                                     _no_alpha))]),
        ([("serve_moe", cs.serve_moe)], [
            sound,
            ("moe_ignores_token_mask", lambda: _patched(lm, "moe_apply",
                                                        _no_token_mask))]),
        ([("serve_moe_card_vs_cpu", cs.serve_moe_card_vs_cpu),
          ("serve_archs_card_vs_cpu", cs.serve_archs_card_vs_cpu)], [
            sound,
            ("moe_capacity_off_by_one", lambda: _patched(
                layers, "moe_route", _capacity_off_by_one)),
            ("attn_drops_newest", lambda: _patched(
                layers, "decode_attn", _one_position_earlier))]),
        ([("musicgen_decode", cs.musicgen_decode)], [
            sound,
            ("codebook_embed_drops_last", lambda: _patched(
                lm, "_embed", _drop_last_codebook))]),
        ([("ssm_card_vs_cpu", cs.ssm_card_vs_cpu),
          ("ssm_chunked_vs_exact", cs.ssm_chunked_vs_exact)], [
            sound,
            ("rwkv_var_unbiased", lambda: _patched(ssm, "_group_norm",
                                                   _unbiased_var)),
            ("ssd_drops_carried_state", lambda: _patched(
                ssm, "_ssd_chunked", _no_carried_state)),
            ("mamba_conv_tail_stale", lambda: _patched(
                lm, "mamba2_decode", _stale_conv))]),
        ([("vision_card_vs_cpu", cs.vision_card_vs_cpu)], [
            sound,
            ("gate_ignored", lambda: _patched(lm, "xattn_gate", _gate_one)),
            ("cross_kv_row0", lambda: _patched(layers, "_cross_decode",
                                               _cross_row0))]),
        ([("moe_leaf", cs.check_moe_leaf)], [
            sound,
            ("count_wrapped_at_2_31", lambda: _count_wrapped(opt_ops,
                                                             reg_ops))]),
        ([("train_mesh_two_ranks", cs.train_mesh_two_ranks)], [sound] + [
            (name, _env_fault("MESH_RANKS_FAULT", name))
            for name in MESH_FAULTS if name not in MESH_CHAOS_FAULTS]),
        ([("train_mesh_chaos", cs.train_mesh_chaos)], [sound] + [
            (name, _env_fault("MESH_RANKS_FAULT", name))
            for name in MESH_CHAOS_FAULTS]),
        ([("serve_mesh_two_ranks", cs.serve_mesh_two_ranks)], [sound] + [
            (name, _env_fault("SERVE_RANKS_FAULT", name))
            for name in SERVE_FAULTS]),
        ([("dryrun_collectives", cs.dryrun_collectives)], [sound] + [
            (name, _env_fault("DRYRUN_FAULT", name))
            for name in DRYRUN_FAULTS]),
    ]
    keys = ("max_rel_diff", "rtol", "penalty_max_rel_diff", "penalty_rtol",
            "late_max_rel_diff", "late_rtol", "rat_micro_rel_diff",
            "rat_micro_rtol",
            "max_abs_logit_err", "tol", "partings", "tokens_identical",
            "token_agreement", "attn_launches_equal", "failed",
            "max_abs_err", "max_penalty_rel_err", "checks",
            "differing_leaves", "error", "gate",
            "loss_max_rel_diff", "grad_norm_max_rel_diff",
            "first_moment_max_rel_l2", "update_max_rel_l2",
            "grad_norm_rtol", "first_moment_rtol", "update_rtol",
            "routing", "dead_rows", "card_vs_cpu", "per_step_err",
            "held_steps", "codeqwen1.5-7b", "gemma3-12b", "zamba2-2.7b",
            "rwkv6-1.6b", "blocks", "cuts", "cross_kv_rel_err", "runs",
            "nan_gate", "collectives", "ef", "violations", "codes")
    if only:
        groups = [g for g in groups if only & {name for name, _ in g[0]}]
        if not groups:
            ap.error(f"no group holds the phases {sorted(only)}")
    bad = False
    for phases, faults in groups:
        for name, ctx in faults:
            failed_any = False
            for phase, run in phases:
                with ctx():
                    try:
                        row, failed = run(dev), False
                    except AssertionError as e:
                        row, failed = e.args[1], True
                failed_any |= failed
                print(json.dumps(dict(
                    phase="planted_fault", fault=name, of=phase,
                    phase_failed=failed,
                    **{k: row[k] for k in keys if k in row})), flush=True)
                if name == "sound":
                    bad |= failed
            if name != "sound":
                bad |= not failed_any
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    return int(bad)


if __name__ == "__main__":
    sys.exit(main())
