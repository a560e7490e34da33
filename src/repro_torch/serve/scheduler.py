"""Continuous-batching scheduler of the port (``repro.serve.scheduler``):
a fixed pool of decode slots, per-slot prefill-insert admission, a decode
tick of ``steps_per_tick`` steps, and the fault-tolerant request
lifecycle of ``serve/slots.py``.

What it does, as in JAX:

* **Fixed slot pool**: the decode batch is ``n_slots`` rows; free and
  finished slots ride along masked.
* **Admission**: a queued request prefills alone (batch 1, its own
  length) and its cache row is copied into its slot (``cache_insert``),
  replacing the previous occupant's row.  With ``prefill_chunk`` the
  prompt advances one chunk per tick instead (``lm_prefill_chunk`` over a
  dense partial cache), and with ``prefix_cache`` whole-chunk prefix hits
  of a refcounted LRU radix trie skip their prefill.
* **Paged KV** (``paged``): every slot's KV lives in ``cache_len //
  block_size`` blocks of one shared pool (``serve/block_pool.py``),
  addressed through an int32 block table per slot; prefix hits share the
  producer's pool blocks by table entry, and a preempted DECODING victim
  keeps its blocks for an exact re-attach.  Decode attention runs the
  ``decode_attn_paged`` kernel.
* **Decode tick**: ``steps_per_tick`` decode steps over every slot, with
  sampling, KV writes and the done-masking (token budget, EOS, non-finite
  logits) on the device (``torch.where``).  The port runs the steps as a
  Python loop where JAX runs a ``lax.scan``; the (k, n_slots) emitted
  tokens and poison mask cross to the host once per tick, and nothing
  inside the loop reads a device value on the host.
* **Fault tolerance**: deadlines (at admission, mid-prefill, mid-decode),
  strictly-higher-priority preemption, a bounded queue and SLO shedding
  at submit, and non-finite quarantine.

Departures from JAX:

* Caches and decode state are updated in place (JAX donates and
  replaces them).  A dense partial prefill cache comes from a small free
  list of row buffers and goes back when its job ends, so every prefix
  trie payload is a copy (``_chunk_copy``), never a view of a buffer that
  a later job will zero and refill.
* The quarantine retry: JAX retries a request whose logits went
  non-finite once on an engine with ``use_kernel=False`` (its jnp
  path).  The port keeps no switch that hides a kernel, so it retries on
  its static ``Engine`` over the same prepared parameters on the same
  device: another code path (ring cache, static batch) through the same
  kernels.  The retry is counted in ``counters["nan_retries"]``.
* Temperature sampling draws from ``torch.Generator``s, not
  ``jax.random``: greedy generations are what match JAX.

On a device mesh (``shardings``: the parameters are each rank's blocks,
as ``Engine`` takes them) every rank runs the whole scheduler: the queue,
the slots, the prefix trie and the paged pool are whole and identical on
every rank, and every rank makes the same decisions from the same clock
(the replays agree on it).  The model calls run under
``sharding.serve_roles``.  After every step the ranks exchange a digest
of the tokens emitted so far and of the lifecycle counters, one
collective, and every rank raises ``RanksDiverged`` if two differ.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Set, Union

import numpy as np
import torch

from .. import resolve_device
from ..core.policy import tree_leaves, tree_map_with_path
from ..core.qtensor import qtensor_act_fmt
from ..distributed import collectives
from ..distributed import sharding as shd
from ..distributed.context import constraints
from ..models.lm import (LMConfig, cache_insert, cache_insert_paged,
                         init_cache, lm_decode, lm_prefill,
                         lm_prefill_chunk, quantize_cache)
from .block_pool import BlockPool
from .engine import (Engine, ServeConfig, _check_scfg, _per_request,
                     attn_only, bucket_cache_len, check_placed, full_ring,
                     prepare_params,
                     refuse_images, sample_token)
from .prefix_cache import PrefixCache
from .slots import (COMPLETED, DECODING, FAILED, PREEMPTED, PREFILLING,
                    QUEUED, REJECTED, TIMED_OUT, RejectedError, Request,
                    SlotPool, request_problem)

# host-memory bound on the per-step accounting log of a long-lived server
STALL_LOG_MAXLEN = 4096

COUNTER_KEYS = ("submitted", "admitted", "completed", "timed_out",
                "rejected", "shed", "preempted", "resumed", "failed",
                "nan_events", "nan_retries")


@dataclasses.dataclass
class SchedulerConfig:
    n_slots: int = 8            # decode batch rows
    steps_per_tick: int = 4     # k: decode steps per tick
    cache_len: int = 256        # per-slot KV capacity (prompt + generation)
    # pow2-bucket per-request prefill widths (attention-only patterns,
    # where pad masking makes it output-invariant)
    bucket_prompts: bool = True
    # chunked prefill: admit a prompt one fixed-size chunk per tick;
    # None = monolithic prefill-insert.  Attention-only patterns.
    prefill_chunk: Optional[int] = None
    # shared-prefix KV reuse from a refcounted LRU radix trie (requires
    # prefill_chunk; exact-match, so greedy outputs are unchanged)
    prefix_cache: bool = False
    prefix_cache_blocks: int = 256   # LRU capacity, in prefill_chunk blocks
    # ---- fault tolerance / SLO knobs ----
    max_queue: int = 4096       # a submission past this depth is REJECTED
    preempt: bool = True        # strictly-higher priority may evict
    slo_shed: bool = True       # shed deadlines the backlog makes unmeetable
    # service-rate estimate (tokens per virtual-clock second) for the shed
    # decision; None = learn an EMA from observed step() progress
    est_tok_per_s: Optional[float] = None
    # ---- paged KV ----
    paged: bool = False
    block_size: int = 16        # tokens per pool block (ring-axis granule)
    # pool capacity in blocks; None = n_slots contexts + the prefix-trie
    # capacity (when enabled) + the reserved null block
    pool_blocks: Optional[int] = None


@dataclasses.dataclass
class _PagedBlock:
    """Prefix-trie payload in paged mode: the dense chunk on the device
    (``shadow``, spliced into partial prefill caches) plus, once a
    producer attaches one, the pinned pool block holding the chunk's
    serving-format bytes (``block_id``, shared by table entry)."""

    shadow: Any
    block_id: Optional[int] = None


@dataclasses.dataclass
class _PrefillJob:
    """Host-side progress of one chunked prompt admission."""

    rid: int
    seq: List[int]               # tokens to prefill (resume: prompt+out[:-1])
    cache: Any                   # dense partial cache, batch 1 (device)
    next: int                    # next seq index to prefill
    pinned: list                 # prefix-trie nodes pinned by the lookup


def _chunk_copy(a: torch.Tensor, i: int, c: int) -> torch.Tensor:
    """Chunk i (ring slots [i*c, (i+1)*c)) of a (r, b, L, ...) cache leaf,
    as a COPY: trie payloads outlive the buffer they were cut from, which
    is zeroed and refilled by a later job."""
    return a[:, :, i * c:(i + 1) * c].clone()


class RanksDiverged(RuntimeError):
    """Two ranks of a mesh's scheduler emitted different tokens or reached
    different lifecycle states."""


class Scheduler:
    """Continuous-batching server over a fixed pool of decode slots, on
    ``device`` (default ``"cuda"``)."""

    def __init__(self, cfg: LMConfig, params, scfg: Optional[ServeConfig]
                 = None, sched: Optional[SchedulerConfig] = None,
                 device=None, shardings=None):
        refuse_images(cfg, "Scheduler")
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg = scfg if scfg is not None else ServeConfig()
        self.sched = sched = sched if sched is not None else SchedulerConfig()
        _check_scfg(scfg, dev)
        check_placed(scfg, shardings, "Scheduler")
        self.shardings = shardings
        self.mesh = shd.mesh_of(shardings)
        self._roles = (shd.serve_roles(shardings) if shardings is not None
                       else {})
        # crc32 of every emitted-token block, in tick order (the digest
        # the ranks of a mesh compare)
        self._token_crc = 0
        # the JAX reference contracts in fp32: keep fp32 matmuls out of TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.params = prepare_params(params, scfg, dev)
        self.pool = SlotPool(sched.n_slots)
        self.requests: Dict[int, Request] = {}
        self.queue: collections.deque = collections.deque()
        self._next_rid = 0
        self._admit_seq = 0
        self._mask_pads = attn_only(cfg)
        self._gen = self._tick_gen = None
        if scfg.temperature > 0:
            self._gen = torch.Generator(device=dev).manual_seed(scfg.seed + 1)
            self._tick_gen = torch.Generator(device=dev).manual_seed(
                scfg.seed + 2)
        self.n_ticks = 0
        self.n_prefills = 0
        self.counters: Dict[str, int] = {k: 0 for k in COUNTER_KEYS}
        # fault-injection hooks (serve/faults.py drives these)
        self._inject_bad_slots: Set[int] = set()
        self._fail_fallback_rids: Set[int] = set()
        self._fallback: Optional[Engine] = None
        # learned service-rate EMA for SLO shedding (virtual clock)
        self._ema_tok_per_s: Optional[float] = None
        self._last_now: Optional[float] = None
        self._emitted_tokens = 0
        self._emitted_at_last_now = 0
        # preemption-resume accounting: tokens spliced vs recomputed
        self.resume_splice_tokens = 0
        self.resume_recompute_tokens = 0
        # host<->device transfers spent on prefix splices (ring mode; 0 in
        # paged mode) and pool blocks shared by table entry on prefix hits
        self.splice_host_transfers = 0
        self.prefix_blocks_shared = 0
        # prefill tokens computed per step() (the decode-stall signal) and
        # tokens skipped by prefix-cache splices
        self.stall_log: collections.deque = collections.deque(
            maxlen=STALL_LOG_MAXLEN)
        self.prefill_tokens_computed = 0
        self.prefill_tokens_skipped = 0
        self._stall_tokens = 0

        self._chunked = sched.prefill_chunk is not None
        if self._chunked:
            if sched.prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {sched.prefill_chunk}")
            if not self._mask_pads or "xattn" in cfg.pattern:
                raise ValueError(
                    f"chunked prefill requires a self-attention-only "
                    f"dense-FFN pattern (recurrent blocks do not thread "
                    f"state across chunks; capacity-based MoE routing is "
                    f"chunk-dependent; xattn has no encoder context on "
                    f"the serving path); {cfg.name} has "
                    f"pattern={cfg.pattern}, ffn={cfg.ffn}")
        n, cl = sched.n_slots, sched.cache_len
        dt = cfg.dtype

        self.paged = sched.paged
        self.block_pool: Optional[BlockPool] = None
        if self.paged:
            bs = sched.block_size
            if bs < 1:
                raise ValueError(f"block_size must be >= 1, got {bs}")
            if cl % bs:
                raise ValueError(
                    f"cache_len {cl} must be a multiple of "
                    f"block_size {bs} (blocks tile the ring axis)")
            reason = full_ring(cfg, cl)
            if reason is not None:
                raise ValueError(
                    f"paged KV needs every layer's ring to cover "
                    f"cache_len (slot == position, so one block table "
                    f"addresses every layer's pool); {reason}")
            if sched.prefix_cache and bs != sched.prefill_chunk:
                raise ValueError(
                    f"paged + prefix_cache requires block_size == "
                    f"prefill_chunk (a trie node IS one pool block), "
                    f"got {bs} vs {sched.prefill_chunk}")
            self._bps = cl // bs
            nb = sched.pool_blocks if sched.pool_blocks is not None else (
                n * self._bps
                + (sched.prefix_cache_blocks if sched.prefix_cache else 0)
                + 1)
            if nb < self._bps + 1:
                raise ValueError(
                    f"pool_blocks={nb} cannot hold one context "
                    f"({self._bps} blocks + the null block)")
            self.block_pool = BlockPool(nb)
            self._pool_cache = init_cache(cfg, nb, bs, dtype=dt,
                                          kv_quant=scfg.kv_quant, device=dev)
            # the host mirror is authoritative; the device copy refreshes
            # before a tick when any row changed
            self._tables_host = np.zeros((n, self._bps), np.int32)
            self._tables = torch.as_tensor(self._tables_host, device=dev)
            self._tables_dirty = False
            # chunked paged jobs whose blocks are not allocated yet (alloc
            # happens at the final-chunk insert): admission holds back
            # _bps free blocks for each
            self._paged_reserved: Set[int] = set()

        self.prefix: Optional[PrefixCache] = None
        if sched.prefix_cache:
            if not self._chunked:
                raise ValueError("prefix_cache requires prefill_chunk "
                                 "(blocks are chunk-granular)")
            reason = full_ring(cfg, cl)
            if reason is not None:
                raise ValueError(
                    f"prefix_cache needs every layer's ring to cover "
                    f"cache_len (slot == position, so prefix blocks "
                    f"are extractable); {reason}")
            self.prefix = PrefixCache(
                sched.prefill_chunk, sched.prefix_cache_blocks,
                on_evict=self._on_trie_evict if self.paged else None)
        self._prefills: Dict[int, _PrefillJob] = {}
        self._prefill_q: collections.deque = collections.deque()
        # free list of dense batch-1 partial-cache buffers (chunked mode)
        self._free_rows: List[Any] = []

        self._cache = (None if self.paged else
                       init_cache(cfg, n, cl, dtype=dt,
                                  kv_quant=scfg.kv_quant, device=dev))

        def zeros(dtype=torch.int64, fill=0):
            return torch.full((n,), fill, dtype=dtype, device=dev)

        self._state = {"tok": zeros(), "pos": zeros(), "steps": zeros(),
                       "mnt": zeros(), "eos": zeros(fill=-1),
                       "active": zeros(torch.bool)}

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    def _sample(self, logits: torch.Tensor, gen) -> torch.Tensor:
        return sample_token(logits, gen, self.scfg.temperature).long()

    def _set_state(self, slot: int, tok, pos: int, mnt: int, eos: int,
                   steps: int) -> None:
        """Decode state of one slot; ``steps`` is the tokens already
        emitted (1 on a fresh admission, len(out) on a resume)."""
        st = self._state
        st["tok"][slot] = tok
        st["pos"][slot] = pos
        st["steps"][slot] = steps
        st["mnt"][slot] = mnt
        st["eos"][slot] = eos
        st["active"][slot] = True

    @contextlib.contextmanager
    def _model(self):
        """The model calls' settings: the activation format and, on a
        mesh, the serving roles."""
        with qtensor_act_fmt(self.scfg.act_fmt), constraints(**self._roles):
            yield

    def _prefill(self, toks: torch.Tensor, lens: Optional[torch.Tensor]):
        with self._model():
            logits, row_cache = lm_prefill(
                self.params, self.cfg, toks, cache_len=self.sched.cache_len,
                kv_quant=self.scfg.kv_quant, prompt_lens=lens)
        return self._sample(logits[:, 0], self._gen), row_cache

    def _chunk(self, row_cache, toks, start, lens):
        with self._model():
            logits, row_cache = lm_prefill_chunk(self.params, self.cfg,
                                                 row_cache, toks, start, lens)
        return self._sample(logits[:, 0], self._gen), row_cache

    def _insert(self, row_cache, slot: int, tok, plen: int, mnt: int,
                eos: int, steps: int, dense: bool = False) -> None:
        """Ring mode: copy a batch-1 row into the slot's cache row (a dense
        chunked-prefill row is quantized first)."""
        if dense:
            row_cache = quantize_cache(self.cfg, row_cache,
                                       self.scfg.kv_quant)
        cache_insert(self._cache, row_cache, slot)
        self._set_state(slot, tok, plen - 1, mnt, eos, steps)

    def _insert_paged(self, row_cache, table: np.ndarray, write: np.ndarray,
                      slot: int, tok, plen: int, mnt: int, eos: int,
                      steps: int, dense: bool = False) -> None:
        """Paged mode: scatter a batch-1 row into the slot's pool blocks;
        chunks with write False came from the trie and already hold the
        exact bytes (they go to the never-read null block)."""
        if dense:
            row_cache = quantize_cache(self.cfg, row_cache,
                                       self.scfg.kv_quant)
        cache_insert_paged(self._pool_cache, row_cache,
                           torch.as_tensor(table, device=self.device),
                           torch.as_tensor(write, device=self.device))
        self._set_state(slot, tok, plen - 1, mnt, eos, steps)

    def _tick(self):
        """``steps_per_tick`` decode steps over every slot; returns the
        (k, n_slots) emitted tokens (-1 where a slot emitted nothing) and
        poison mask, on the host, from one transfer."""
        st = self._state
        mnt, eos = st["mnt"], st["eos"]
        tok, pos, steps, active = st["tok"], st["pos"], st["steps"], \
            st["active"]
        paged = dict(block_tables=self._tables,
                     block_size=self.sched.block_size) if self.paged else {}
        cache = self._pool_cache if self.paged else self._cache
        em, bad_all = [], []
        with self._model():
            for _ in range(self.sched.steps_per_tick):
                pos2 = torch.where(active, pos + 1, pos)
                logits, _ = lm_decode(self.params, self.cfg, cache,
                                      tok[:, None], pos2, token_mask=active,
                                      **paged)
                lg = logits[:, 0]
                # non-finite guard: a poisoned slot is done-masked here; it
                # stops sampling and emitting from the bad step on
                ok = torch.isfinite(lg).all(dim=-1)
                bad = active & ~ok
                live = active & ok
                new_tok = torch.where(live, self._sample(lg, self._tick_gen),
                                      tok)
                steps2 = torch.where(live, steps + 1, steps)
                em.append(torch.where(live, new_tok, -1))
                bad_all.append(bad)
                done = (steps2 >= mnt) | (new_tok == eos) | bad
                tok, pos, steps, active = new_tok, pos2, steps2, active & ~done
        st.update(tok=tok, pos=pos, steps=steps, active=active)
        block = torch.stack([torch.stack(em),
                             torch.stack(bad_all).long()]).cpu().numpy()
        return block[0], block[1].astype(bool)     # ONE transfer per tick

    def _take_row(self):
        """A zeroed dense batch-1 partial cache from the free list."""
        if self._free_rows:
            row = self._free_rows.pop()
            for t in tree_leaves(row):
                t.zero_()
            return row
        return init_cache(self.cfg, 1, self.sched.cache_len,
                          dtype=self.cfg.dtype, kv_quant=False,
                          device=self.device)

    def _give_row(self, job: _PrefillJob) -> None:
        if job.cache is not None:
            self._free_rows.append(job.cache)
            job.cache = None

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               arrival: float = 0.0,
               deadline: Optional[float] = None,
               priority: int = 0,
               strict: bool = True) -> int:
        """Queue one request; returns its request id.  Malformed prompts
        raise a typed :class:`RejectedError` (``strict=False`` records a
        REJECTED request instead), a full queue rejects with
        ``"queue_full"`` and an unmeetable deadline is shed with
        ``"slo_shed"``."""
        mnt = (max_new_tokens if max_new_tokens is not None
               else self.scfg.max_new_tokens)
        self.counters["submitted"] += 1
        problem = request_problem(prompt, mnt, self.sched.cache_len,
                                  self.cfg.vocab)
        if problem is not None:
            reason, msg = problem
            if strict:
                self.counters["submitted"] -= 1
                raise RejectedError(reason, msg)
            self.counters["rejected"] += 1
            return self._terminal_submission(prompt, mnt, eos_id, arrival,
                                             REJECTED, reason)
        if len(self.queue) >= self.sched.max_queue:
            if strict:
                self.counters["submitted"] -= 1
                raise RejectedError(
                    "queue_full",
                    f"submit queue at max_queue={self.sched.max_queue}")
            self.counters["rejected"] += 1
            return self._terminal_submission(prompt, mnt, eos_id, arrival,
                                             REJECTED, "queue_full")
        if (deadline is not None and self.sched.slo_shed
                and self._deadline_unmeetable(prompt, mnt, arrival,
                                              deadline)):
            self.counters["shed"] += 1
            return self._terminal_submission(prompt, mnt, eos_id, arrival,
                                             REJECTED, "slo_shed")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=list(prompt), max_new_tokens=mnt,
                      eos_id=eos_id, arrival=arrival, deadline=deadline,
                      priority=priority)
        self.requests[rid] = req
        if mnt <= 0:
            req.transition(COMPLETED, "empty_budget")
            self.counters["completed"] += 1
        else:
            self.queue.append(rid)
        return rid

    def _terminal_submission(self, prompt, mnt, eos_id, arrival,
                             state: str, reason: str) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=list(prompt), max_new_tokens=mnt,
                      eos_id=eos_id, arrival=arrival)
        req.transition(state, reason)
        self.requests[rid] = req
        return rid

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.pool.occupied())

    @torch.no_grad()
    def step(self, now: Optional[float] = None) -> List[Request]:
        """Enforce deadlines (when ``now`` is given), admit what fits,
        advance at most one prefill chunk (chunked mode), run one decode
        tick, retire finished slots.  Returns every request that reached
        a terminal state during this step."""
        self._stall_tokens = 0
        self._update_rate_estimate(now)
        terminal = self._expire(now) if now is not None else []
        terminal += self._admit(now)
        if self._chunked:
            terminal += self._prefill_tick()
        terminal += self._do_tick()
        self.stall_log.append(self._stall_tokens)
        if self.mesh is not None:
            self._check_ranks_agree()
        return terminal

    def _digest(self) -> List[int]:
        """What the ranks of a mesh must agree on after every step: the
        emitted tokens (a crc32 of every tick's block), the lifecycle
        counters, the ticks, the queue and the occupied slots."""
        state = repr((sorted(self.counters.items()), self.n_ticks,
                      self.n_prefills, len(self.queue),
                      self.pool.occupied())).encode()
        return [self._token_crc, zlib.crc32(state), self.n_ticks]

    def _check_ranks_agree(self) -> None:
        mine = torch.tensor(self._digest(), dtype=torch.int64)
        every = collectives.world_gather(mine)
        differ = [r for r in range(every.shape[0])
                  if not torch.equal(every[r], every[0])]
        if differ:
            raise RanksDiverged(
                f"scheduler ranks diverged at tick {self.n_ticks}: ranks "
                f"{differ} differ from rank 0 (tokens crc, state crc, "
                f"ticks: {every.tolist()})")

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue and all active slots; {rid: tokens} of the
        COMPLETED requests."""
        while self.has_work():
            self.step()
        return {rid: r.out for rid, r in self.requests.items() if r.done}

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Union[int, Sequence[int], None] = None,
                 eos_id: Union[int, Sequence[int], None] = None,
                 ) -> List[List[int]]:
        """Engine-compatible: submit a batch, drain, return the outputs in
        submission order."""
        b = len(prompts)
        mnts = _per_request(max_new_tokens, self.scfg.max_new_tokens, b)
        eoss = _per_request(eos_id, None, b)
        rids = [self.submit(p, m, e) for p, m, e in zip(prompts, mnts, eoss)]
        self.run()
        return [self.requests[r].out for r in rids]

    # ------------------------------------------------------------------
    # fault-injection hooks (serve/faults.py drives these)
    # ------------------------------------------------------------------

    def inject_nonfinite(self, slots: Sequence[int],
                         fail_fallback: bool = False) -> None:
        """Treat ``slots`` as if their next tick produced non-finite
        logits; ``fail_fallback`` makes the quarantined requests' one
        retry fault too (-> FAILED)."""
        self._inject_bad_slots.update(int(s) for s in slots)
        if fail_fallback:
            for s in slots:
                rid = dict(self.pool.occupied()).get(int(s))
                if rid is not None:
                    self._fail_fallback_rids.add(rid)

    def _fallback_engine(self) -> Engine:
        """The retry path of quarantined requests: the static ``Engine``
        over the SAME prepared params on the same device (``weights=
        "fp32"`` makes its ``prepare_params`` keep them as they are)."""
        if self._fallback is None:
            fcfg = dataclasses.replace(self.scfg, weights="fp32")
            self._fallback = Engine(self.cfg, self.params, fcfg,
                                    device=self.device,
                                    shardings=self.shardings)
        return self._fallback

    # ------------------------------------------------------------------
    # SLO admission control
    # ------------------------------------------------------------------

    def _update_rate_estimate(self, now: Optional[float]) -> None:
        if now is None:
            return
        if self._last_now is not None and now > self._last_now:
            emitted = self._emitted_tokens - self._emitted_at_last_now
            if emitted > 0:
                inst = emitted / (now - self._last_now)
                ema = self._ema_tok_per_s
                self._ema_tok_per_s = (inst if ema is None
                                       else 0.8 * ema + 0.2 * inst)
        self._last_now = now
        self._emitted_at_last_now = self._emitted_tokens

    def _service_rate(self) -> Optional[float]:
        return self.sched.est_tok_per_s or self._ema_tok_per_s

    def _backlog_tokens(self) -> int:
        """Queued prompts and budgets plus the unfinished remainder of
        every running slot."""
        total = 0
        for rid in self.queue:
            r = self.requests[rid]
            total += len(r.resume_tokens()) + r.max_new_tokens - len(r.out)
        for _, rid in self.pool.occupied():
            r = self.requests[rid]
            if r.state == PREFILLING:
                job = self._prefills.get(rid)
                left = (len(job.seq) - job.next) if job is not None else \
                    len(r.resume_tokens())
                total += left + r.max_new_tokens - len(r.out)
            elif r.state == DECODING:
                total += r.max_new_tokens - len(r.out)
        return total

    def _deadline_unmeetable(self, prompt, mnt: int, arrival: float,
                             deadline: float) -> bool:
        rate = self._service_rate()
        if not rate or rate <= 0:
            return False
        est = (self._backlog_tokens() + len(prompt) + mnt) / rate
        return arrival + est > deadline

    # ------------------------------------------------------------------
    # deadline enforcement (admission, mid-prefill, mid-decode)
    # ------------------------------------------------------------------

    def _expire(self, now: float) -> List[Request]:
        expired = []
        for rid in [r for r in self.queue
                    if self._past_deadline(r, now)]:
            req = self.requests[rid]
            self.queue.remove(rid)
            if self.paged and req.blocks is not None:
                self._free_req_blocks(req)   # preempted victim's table
            req.transition(TIMED_OUT, "deadline_queued")
            self.counters["timed_out"] += 1
            expired.append(req)
        for slot, rid in list(self.pool.occupied()):
            req = self.requests[rid]
            if not self._past_deadline(rid, now):
                continue
            if req.state == PREFILLING:
                self._cancel_prefill_job(rid)     # releases trie pins
            elif req.state == DECODING:
                self._deactivate_slot(slot)       # done-mask out of tick
                self._release_slot_blocks(slot)
            self.pool.release(slot)
            req.slot = None
            req.transition(TIMED_OUT, "deadline_" + (
                "prefill" if req.state == PREFILLING else "decode"))
            self.counters["timed_out"] += 1
            expired.append(req)
        return expired

    def _past_deadline(self, rid: int, now: float) -> bool:
        d = self.requests[rid].deadline
        return d is not None and now >= d

    def _deactivate_slot(self, slot: int) -> None:
        """Done-mask a slot out of the decode tick (its row stops
        advancing; the next insert replaces it)."""
        self._state["active"][slot] = False

    def _cancel_prefill_job(self, rid: int) -> None:
        """Tear down an in-flight chunked prefill, releasing its trie pins
        and its partial-cache buffer."""
        job = self._prefills.pop(rid, None)
        if job is None:
            return
        if self.paged:
            self._paged_reserved.discard(rid)
        self._prefill_q.remove(rid)
        if self.prefix is not None and job.pinned:
            self.prefix.release(job.pinned)
        self._give_row(job)

    # ------------------------------------------------------------------
    # priority preemption
    # ------------------------------------------------------------------

    def _next_admittable(self, now: Optional[float]) -> Optional[int]:
        """Highest-priority arrived request; lowest rid within a class."""
        best = None
        for rid in self.queue:
            req = self.requests[rid]
            if now is not None and req.arrival > now:
                continue
            if best is None or (req.priority, -rid) > \
                    (self.requests[best].priority, -best):
                best = rid
        return best

    def _preempt_for(self, incoming: Request) -> bool:
        """Evict the lowest-priority running slot, strictly lower than
        ``incoming`` (youngest first among equals)."""
        if not self.sched.preempt:
            return False
        victims = []
        for slot, rid in self.pool.occupied():
            req = self.requests[rid]
            if req.state in (PREFILLING, DECODING):
                victims.append((req.priority, -(req.admit_seq or 0),
                                slot, rid))
        if not victims:
            return False
        victims.sort()
        pr, _, slot, rid = victims[0]
        if pr >= incoming.priority:
            return False
        self._evict(self.requests[rid], slot)
        return True

    def _evict(self, req: Request, slot: int) -> None:
        """Preempt one running request back to the queue, publishing its
        computed KV chunks to the prefix trie first (PREFILLING partial
        caches always; DECODING rows when the ring KV is dense; a paged
        DECODING victim keeps its blocks instead)."""
        if req.state == PREFILLING:
            job = self._prefills.get(req.rid)
            if job is not None and self.prefix is not None \
                    and job.cache is not None:
                k_full = job.next // self.sched.prefill_chunk
                if self.paged:
                    self._publish_blocks_paged(job.seq, job.cache, k_full)
                else:
                    self._publish_blocks(job.seq, job.cache, k_full)
            self._cancel_prefill_job(req.rid)
        else:                           # DECODING
            if self.paged:
                # the victim keeps its blocks (the table row moves to the
                # request, refcounts unchanged): resume is an exact
                # zero-recompute re-attach for any KV format
                row = self._tables_host[slot]
                req.blocks = [int(b) for b in row]
                row[:] = 0
                self._tables_dirty = True
            elif self.prefix is not None and not self.scfg.kv_quant:
                self._publish_pool_row(req, slot)
            self._deactivate_slot(slot)
        self.pool.release(slot)
        req.slot = None
        req.transition(PREEMPTED)
        req.transition(QUEUED)
        req.preemptions += 1
        self.counters["preempted"] += 1
        self.queue.append(req.rid)

    def _publish_pool_row(self, req: Request, slot: int) -> None:
        """Publish a preempted DECODING slot's dense ring row (prompt and
        produced tokens) as trie chunks keyed by ``prompt + out[:-1]``."""
        seq = req.resume_tokens()
        k_full = len(seq) // self.sched.prefill_chunk
        if k_full <= 0:
            return
        row = tree_map_with_path(lambda p, a: a[:, slot:slot + 1], self._cache)
        self._publish_blocks(seq, row, k_full)

    # ------------------------------------------------------------------
    # paged block pool
    # ------------------------------------------------------------------

    def _on_trie_evict(self, payload) -> None:
        """Trie eviction drops the trie's reference on the shared pool
        block (shadow-only payloads never took one)."""
        if isinstance(payload, _PagedBlock) and payload.block_id is not None:
            self.block_pool.unref(payload.block_id)

    def _release_slot_blocks(self, slot: int) -> None:
        """Drop this slot's table references; blocks the trie pins stay
        live for later prefix hits."""
        if not self.paged:
            return
        row = self._tables_host[slot]
        for bid in row:
            if bid:
                self.block_pool.unref(int(bid))
        row[:] = 0
        self._tables_dirty = True

    def _free_req_blocks(self, req: Request) -> None:
        """Drop a queued preempted victim's saved table row (it falls back
        to the recompute resume, which stays exact)."""
        if req.blocks:
            for bid in req.blocks:
                if bid:
                    self.block_pool.unref(int(bid))
        req.blocks = None

    def _reclaim_blocks(self, needed: int) -> None:
        """Free pool blocks until ``needed`` are available: unpinned trie
        leaves first, then queued victims' saved tables."""
        while self.block_pool.n_free < needed and self.prefix is not None:
            if not self.prefix.evict_unpinned(1):
                break
        if self.block_pool.n_free >= needed:
            return
        for rid in list(self.queue):
            if self.block_pool.n_free >= needed:
                break
            req = self.requests[rid]
            if req.blocks:
                self._free_req_blocks(req)

    def _paged_room_for(self, req: Request) -> bool:
        """Admission gate: free blocks for this request's table on top of
        every outstanding PREFILLING reservation, reclaiming if short."""
        if req.blocks is not None:
            return True                # a re-attach brings its own blocks
        needed = self._bps * (1 + len(self._paged_reserved))
        if self.block_pool.n_free >= needed:
            return True
        self._reclaim_blocks(needed)
        return self.block_pool.n_free >= needed

    def _pool_starved(self) -> bool:
        """True when no later step can free a block: admission must then
        reject instead of waiting forever."""
        if self._paged_reserved or self.pool.occupied():
            return False
        if any(self.requests[rid].blocks for rid in self.queue):
            return False
        return self.block_pool.n_free < self._bps

    def _paged_insert_row(self, slot: int, row_cache, tok, plen, mnt,
                          eos, steps) -> None:
        """Monolithic admission: a full table for ``slot``, every chunk
        written."""
        bids = np.asarray(self.block_pool.alloc(self._bps), np.int32)
        self._tables_host[slot] = bids
        self._tables_dirty = True
        self._insert_paged(row_cache, bids, np.ones((self._bps,), bool),
                           slot, tok, plen, mnt, eos, steps)

    def _reattach_blocks(self, req: Request) -> None:
        """Zero-recompute preemption resume: the victim's blocks were
        kept, so resuming is a table re-attach and a decode-state
        restore."""
        seq = req.resume_tokens()
        req.slot = self.pool.acquire(req.rid)
        req.transition(DECODING)
        self._tables_host[req.slot] = np.asarray(req.blocks, np.int32)
        self._tables_dirty = True
        req.blocks = None
        eos = -1 if req.eos_id is None else req.eos_id
        self._set_state(req.slot, req.out[-1], len(seq) - 1,
                        req.max_new_tokens, eos, len(req.out))
        req.resume_splice_tokens += len(seq)
        req.resume_total_tokens += len(seq)
        self.resume_splice_tokens += len(seq)
        self.prefill_tokens_skipped += len(seq)

    def _spliced_row_cache_paged(self, pinned):
        """Paged prefix splice: the trie's device shadows copied into a
        zeroed partial cache on the device (no host transfer)."""
        row = self._take_row()
        c = self.sched.prefill_chunk
        for i, node in enumerate(pinned):
            for dst, src in zip(tree_leaves(row),
                                tree_leaves(node.payload.shadow)):
                dst[:, :, i * c:(i + 1) * c].copy_(src)
        return row

    def _publish_blocks_paged(self, seq: Sequence[int], cache,
                              k_full: int, bids=None) -> None:
        """Paged trie publish: payloads are device copies of the chunks.
        With the producer's table ``bids`` (final-chunk insert), shadow-only
        payloads along the path get a pinned block id, so later consumers
        share the pool bytes by table entry."""
        if k_full <= 0 or self.prefix is None:
            return
        c = self.sched.prefill_chunk
        payloads = [_PagedBlock(shadow=tree_map_with_path(
            lambda p, a, i=i: _chunk_copy(a, i, c), cache))
            for i in range(k_full)]
        self.prefix.insert(list(seq), payloads)
        if bids is None:
            return
        for i, node in enumerate(self.prefix.path(list(seq), k_full)):
            pb = node.payload
            if isinstance(pb, _PagedBlock) and pb.block_id is None:
                pb.block_id = int(bids[i])
                self.block_pool.ref(int(bids[i]))

    # ------------------------------------------------------------------
    # admission (per-slot prefill-insert)
    # ------------------------------------------------------------------

    def _admit(self, now: Optional[float] = None) -> List[Request]:
        if self._chunked:
            return self._admit_chunked(now)
        completed = []
        while self.queue:
            rid = self._next_admittable(now)
            if rid is None:
                break                  # offered-load replay: not here yet
            req = self.requests[rid]
            if not self.pool.n_free and not self._preempt_for(req):
                break
            if self.paged and not self._paged_room_for(req):
                if self._pool_starved():
                    self.queue.remove(rid)
                    req.transition(REJECTED, "pool_exhausted")
                    self.counters["rejected"] += 1
                    completed.append(req)
                    continue
                break                  # backpressure: a slot will free
            self.queue.remove(rid)
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            req.t_admit = now
            self.counters["admitted"] += 1
            resumed = bool(req.out)
            if resumed:
                self.counters["resumed"] += 1
            if self.paged and req.blocks is not None:
                self._reattach_blocks(req)
                continue
            seq = req.resume_tokens()
            self._stall_tokens += len(seq)
            self.prefill_tokens_computed += len(seq)

            toks = np.asarray([seq], np.int64)
            lens = None
            if self._mask_pads and self.sched.bucket_prompts:
                w = bucket_cache_len(len(seq), floor=8)
                toks = np.zeros((1, w), np.int64)
                toks[0, w - len(seq):] = seq
                lens = torch.tensor([len(seq)], dtype=torch.int64,
                                    device=self.device)
            self.n_prefills += 1
            tok, row_cache = self._prefill(
                torch.as_tensor(toks, device=self.device), lens)
            eos = -1 if req.eos_id is None else req.eos_id
            if resumed:
                # out[-1] is the in-flight token (not yet in KV); device
                # steps start at len(out) so the budget rule lines up
                req.transition(DECODING)
                req.slot = self.pool.acquire(rid)
                args = (req.out[-1], len(seq), req.max_new_tokens, eos,
                        len(req.out))
                if self.paged:
                    self._paged_insert_row(req.slot, row_cache, *args)
                else:
                    self._insert(row_cache, req.slot, *args)
                continue
            first = int(tok[0])
            req.out.append(first)
            self._emitted_tokens += 1
            if req.finished_by(first, 1):
                req.transition(COMPLETED)   # budget of 1 / instant EOS
                self.counters["completed"] += 1
                completed.append(req)
                continue
            req.slot = self.pool.acquire(rid)
            req.transition(DECODING)
            args = (first, len(seq), req.max_new_tokens, eos, 1)
            if self.paged:
                self._paged_insert_row(req.slot, row_cache, *args)
            else:
                self._insert(row_cache, req.slot, *args)
        return completed

    # ------------------------------------------------------------------
    # chunked admission (one prefill chunk per tick)
    # ------------------------------------------------------------------

    def _admit_chunked(self, now: Optional[float] = None) -> List[Request]:
        """Reserve a slot per queued request (state PREFILLING) and queue
        its prefill job; chunks advance one per tick in
        :meth:`_prefill_tick`.  The prefix lookup happens when the job
        starts, so requests admitted together still hit the chunks the
        first sharer publishes."""
        rejected = []
        while self.queue:
            rid = self._next_admittable(now)
            if rid is None:
                break
            req = self.requests[rid]
            if not self.pool.n_free and not self._preempt_for(req):
                break
            if self.paged and not self._paged_room_for(req):
                if self._pool_starved():
                    self.queue.remove(rid)
                    req.transition(REJECTED, "pool_exhausted")
                    self.counters["rejected"] += 1
                    rejected.append(req)
                    continue
                break                  # backpressure: a slot will free
            self.queue.remove(rid)
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            req.t_admit = now
            self.counters["admitted"] += 1
            if req.preemptions:
                self.counters["resumed"] += 1
            if self.paged and req.blocks is not None:
                self._reattach_blocks(req)
                continue
            req.slot = self.pool.acquire(rid)
            req.transition(PREFILLING)
            if self.paged:
                self._paged_reserved.add(rid)
            self._prefills[rid] = _PrefillJob(rid=rid,
                                              seq=req.resume_tokens(),
                                              cache=None, next=0, pinned=[])
            self._prefill_q.append(rid)
        return rejected

    def _start_prefill(self, req: Request, job: _PrefillJob) -> None:
        """First chunk of a job: prefix lookup and its partial cache
        (zeroed on a miss, with the hit chunks copied in on a hit)."""
        matched, pinned = (self.prefix.lookup(job.seq)
                           if self.prefix is not None else (0, []))
        req.prefix_hit_tokens = matched
        self.prefill_tokens_skipped += matched
        if req.preemptions:
            req.resume_splice_tokens += matched
            req.resume_total_tokens += len(job.seq)
            self.resume_splice_tokens += matched
            self.resume_recompute_tokens += len(job.seq) - matched
        job.pinned = pinned
        job.next = matched
        if pinned:
            job.cache = (self._spliced_row_cache_paged(pinned) if self.paged
                         else self._spliced_row_cache(pinned))
        else:
            job.cache = self._take_row()

    def _spliced_row_cache(self, pinned):
        """Ring mode: the trie's host chunks assembled into a zeroed host
        row at their absolute positions, uploaded once into a partial
        cache."""
        self.splice_host_transfers += 1        # host assembly + upload
        row = self._take_row()
        host = tree_map_with_path(
            lambda p, a: torch.zeros(a.shape, dtype=a.dtype), row)
        c = self.sched.prefill_chunk
        for i, node in enumerate(pinned):
            for dst, src in zip(tree_leaves(host),
                                tree_leaves(node.payload)):
                dst[:, :, i * c:(i + 1) * c] = src
        for dst, src in zip(tree_leaves(row), tree_leaves(host)):
            dst.copy_(src)
        return row

    def _prefill_tick(self) -> List[Request]:
        """Advance the OLDEST prefilling request by one chunk; on its final
        chunk sample the first token (a resume reuses its in-flight token),
        publish the full chunks to the prefix trie and insert the
        kv-quantized row."""
        if not self._prefill_q:
            return []
        rid = self._prefill_q[0]
        job = self._prefills[rid]
        req = self.requests[rid]
        if job.cache is None:
            self._start_prefill(req, job)
        cw = self.sched.prefill_chunk
        n = len(job.seq)
        take = min(cw, n - job.next)
        toks = np.zeros((1, cw), np.int64)
        toks[0, :take] = job.seq[job.next:job.next + take]
        self.n_prefills += 1
        req.prefill_chunks += 1
        dev = self.device
        tok, job.cache = self._chunk(
            job.cache, torch.as_tensor(toks, device=dev),
            torch.tensor([job.next], dtype=torch.int64, device=dev),
            torch.tensor([take], dtype=torch.int64, device=dev))
        job.next += take
        self._stall_tokens += take
        self.prefill_tokens_computed += take
        if job.next < n:
            return []

        # final chunk: the request leaves PREFILLING
        self._prefill_q.popleft()
        del self._prefills[rid]
        try:
            if self.paged:
                return self._finish_prefill_paged(req, job, n, tok)
            return self._finish_prefill(req, job, n, tok)
        finally:
            self._give_row(job)

    def _finish_prefill(self, req: Request, job: _PrefillJob, n: int,
                        tok) -> List[Request]:
        cw = self.sched.prefill_chunk
        if self.prefix is not None:
            self._publish_blocks(job.seq, job.cache, n // cw)
            self.prefix.release(job.pinned)
        eos = -1 if req.eos_id is None else req.eos_id
        if req.out:
            # preemption resume: out[-1] is the in-flight token
            req.transition(DECODING)
            self._insert(job.cache, req.slot, req.out[-1], n,
                         req.max_new_tokens, eos, len(req.out), dense=True)
            return []
        first = int(tok[0])
        req.out.append(first)
        self._emitted_tokens += 1
        if req.finished_by(first, 1):
            req.transition(COMPLETED)   # budget of 1 / instant EOS
            self.counters["completed"] += 1
            self.pool.release(req.slot)
            req.slot = None
            return [req]
        req.transition(DECODING)
        self._insert(job.cache, req.slot, first, n, req.max_new_tokens, eos,
                     1, dense=True)
        return []

    def _finish_prefill_paged(self, req: Request, job: _PrefillJob, n: int,
                              tok) -> List[Request]:
        """Paged final chunk: build the slot's block table (matched trie
        chunks with a block id are shared by table entry, the rest are
        allocated), scatter the quantized row into the owned blocks,
        publish the chunks and attach this producer's block ids."""
        cw = self.sched.prefill_chunk
        k_full = n // cw
        eos = -1 if req.eos_id is None else req.eos_id
        if not req.out:
            first = int(tok[0])
            req.out.append(first)
            self._emitted_tokens += 1
            if req.finished_by(first, 1):
                # no decode slot, no blocks: publish shadow-only chunks so
                # later sharers still hit
                if self.prefix is not None:
                    self._publish_blocks_paged(job.seq, job.cache, k_full)
                    self.prefix.release(job.pinned)
                self._paged_reserved.discard(req.rid)
                req.transition(COMPLETED)
                self.counters["completed"] += 1
                self.pool.release(req.slot)
                req.slot = None
                return [req]
        bids = np.zeros((self._bps,), np.int32)
        write = np.ones((self._bps,), bool)
        shared = 0
        for i, node in enumerate(job.pinned):
            pb = node.payload
            if isinstance(pb, _PagedBlock) and pb.block_id is not None:
                # chunk i's bytes are a function of seq[:(i+1)*cw] alone,
                # so the producer's block is what this insert would write
                bids[i] = pb.block_id
                self.block_pool.ref(pb.block_id)
                write[i] = False
                shared += 1
        own_idx = [i for i in range(self._bps) if write[i]]
        for i, b in zip(own_idx, self.block_pool.alloc(len(own_idx))):
            bids[i] = b
        self._paged_reserved.discard(req.rid)
        self.prefix_blocks_shared += shared
        if self.prefix is not None:
            self._publish_blocks_paged(job.seq, job.cache, k_full, bids)
            self.prefix.release(job.pinned)
        req.transition(DECODING)
        self._tables_host[req.slot] = bids
        self._tables_dirty = True
        self._insert_paged(job.cache, bids, write, req.slot, req.out[-1], n,
                           req.max_new_tokens, eos, len(req.out), dense=True)
        return []

    def _publish_blocks(self, seq: Sequence[int], cache,
                        k_full: int) -> None:
        """Ring-mode trie publish: ``seq``'s first ``k_full`` whole chunks
        of a dense batch-1 cache, downloaded to the host once."""
        if k_full <= 0 or self.prefix is None:
            return
        self.splice_host_transfers += 1        # device -> host download
        c = self.sched.prefill_chunk
        host = tree_map_with_path(lambda p, a: a[:, :, :k_full * c].cpu(),
                                  cache)
        blocks = [tree_map_with_path(lambda p, a, i=i: _chunk_copy(a, i, c),
                                     host) for i in range(k_full)]
        self.prefix.insert(list(seq), blocks)

    # ------------------------------------------------------------------
    # decode tick
    # ------------------------------------------------------------------

    def _do_tick(self) -> List[Request]:
        occupied = [(slot, rid) for slot, rid in self.pool.occupied()
                    if self.requests[rid].state == DECODING]
        if not occupied:               # only PREFILLING slots: no decode
            self._inject_bad_slots.clear()
            return []
        self.n_ticks += 1
        if self.paged and self._tables_dirty:
            self._tables = torch.as_tensor(self._tables_host,
                                           device=self.device)
            self._tables_dirty = False
        em, bad = self._tick()
        self._token_crc = zlib.crc32(np.ascontiguousarray(em).tobytes(),
                                     self._token_crc)
        injected = self._inject_bad_slots
        self._inject_bad_slots = set()
        terminal = []
        for slot, rid in occupied:
            req = self.requests[rid]
            req.ticks += 1
            if bad[:, slot].any() or slot in injected:
                terminal += self._quarantine(req, slot)
                continue
            for s in range(self.sched.steps_per_tick):
                t = int(em[s, slot])
                if t < 0:              # done-masked earlier in this tick
                    break
                req.out.append(t)
                self._emitted_tokens += 1
                if req.finished_by(t, len(req.out)):
                    break              # the device flagged done here
            if req.finished_by(req.out[-1], len(req.out)):
                req.transition(COMPLETED)
                self.counters["completed"] += 1
                self.pool.release(slot)
                self._release_slot_blocks(slot)
                req.slot = None
                terminal.append(req)
        return terminal

    # ------------------------------------------------------------------
    # non-finite quarantine -> one retry on the static engine
    # ------------------------------------------------------------------

    def _quarantine(self, req: Request, slot: int) -> List[Request]:
        """A slot's decode logits went non-finite: free it (everything it
        emitted is suspect) and retry the request ONCE on the static
        ``Engine``.  FAILED if the retry faults too."""
        self._deactivate_slot(slot)
        self.pool.release(slot)
        self._release_slot_blocks(slot)
        req.slot = None
        self.counters["nan_events"] += 1
        if req.nan_retries >= 1:
            req.out = []
            req.transition(FAILED, "nonfinite_twice")
            self.counters["failed"] += 1
            return [req]
        req.nan_retries += 1
        self.counters["nan_retries"] += 1
        try:
            if req.rid in self._fail_fallback_rids:
                self._fail_fallback_rids.discard(req.rid)
                raise FloatingPointError("injected fallback fault")
            out = self._fallback_engine().generate(
                [req.prompt], [req.max_new_tokens], [req.eos_id])[0]
        except Exception:
            req.out = []
            req.transition(FAILED, "nonfinite_fallback")
            self.counters["failed"] += 1
            return [req]
        req.out = out
        self._emitted_tokens += len(out)
        req.transition(COMPLETED, "nan_fallback")
        self.counters["completed"] += 1
        return [req]
