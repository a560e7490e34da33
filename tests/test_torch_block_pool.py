"""The port's block allocator and prefix trie against the JAX package's
on the same seeded operation streams: identical block ids, refcounts,
audits, typed exhaustion, LRU evictions and pins.  Both are plain
Python, so everything is compared exactly."""

import numpy as np
import pytest

from repro.serve import BlockPool as JBlockPool
from repro.serve import PoolExhausted as JPoolExhausted
from repro.serve import PrefixCache as JPrefixCache
from repro_torch.serve import BlockPool, PoolExhausted, PrefixCache
from repro_torch.serve.block_pool import NULL_BLOCK


def _state(p):
    return (p.free_blocks(), p.live_blocks(),
            {b: p.refcount(b) for b in p.live_blocks()}, p.n_free, p.n_live)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_block_pool_storm_matches_jax(seed):
    """A seeded storm of allocs (some past the free count), refs and
    unrefs, with an audit against the externally held references after
    every operation."""
    rng = np.random.default_rng(seed)
    jp, tp = JBlockPool(24), BlockPool(24)
    held = []                                   # one entry per reference
    for _ in range(400):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(0, 8))
            try:
                want = jp.alloc(n)
            except JPoolExhausted as e:
                with pytest.raises(PoolExhausted) as te:
                    tp.alloc(n)
                assert (te.value.requested, te.value.free) == \
                    (e.requested, e.free)
                continue
            assert tp.alloc(n) == want
            held += want
        elif op == 1 and held:
            bid = held[int(rng.integers(0, len(held)))]
            jp.ref(bid)
            tp.ref(bid)
            held.append(bid)
        elif held:
            bid = held.pop(int(rng.integers(0, len(held))))
            jp.unref(bid)
            tp.unref(bid)
        assert _state(tp) == _state(jp)
        expected = {b: held.count(b) for b in set(held)}
        assert tp.audit(expected) == jp.audit(expected) == []
    # an audit against a wrong holder count reports the same violations
    if held:
        wrong = {b: held.count(b) + 1 for b in set(held)}
        assert tp.audit(wrong) == jp.audit(wrong) != []


def test_block_pool_null_block_and_errors_match_jax():
    for Pool in (BlockPool, JBlockPool):
        p = Pool(8)
        assert p.capacity == 7 and NULL_BLOCK not in p.free_blocks()
        with pytest.raises(ValueError):
            p.ref(NULL_BLOCK)
        with pytest.raises(ValueError):
            p.unref(NULL_BLOCK)
        with pytest.raises(ValueError):
            p.unref(3)                           # not live
        with pytest.raises(ValueError):
            p.alloc(-1)
        with pytest.raises(ValueError):
            Pool(1)
    t, j = BlockPool(6), JBlockPool(6)
    assert t.alloc(3) == j.alloc(3) == [1, 2, 3]
    for p in (t, j):
        p.unref(2)
        p.unref(1)
    assert t.alloc(2) == j.alloc(2) == [1, 2]    # lowest first, sorted


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_storm_matches_jax(seed):
    """Inserts, lookups (pinning), releases, flushes and capacity
    evictions on both tries from one seeded stream: the same matches,
    pins, evicted payloads and stats."""
    rng = np.random.default_rng(seed)
    evicted = {"j": [], "t": []}
    jc = JPrefixCache(4, capacity_blocks=12,
                      on_evict=lambda p: evicted["j"].append(p))
    tc = PrefixCache(4, capacity_blocks=12,
                     on_evict=lambda p: evicted["t"].append(p))
    stems = [[int(x) for x in rng.integers(0, 9, 16)] for _ in range(3)]
    pins = []
    for step in range(300):
        op = rng.integers(0, 5)
        stem = stems[int(rng.integers(0, len(stems)))]
        seq = stem[:int(rng.integers(1, 17))] + [int(x) for x in
                                                 rng.integers(0, 9, 3)]
        if op == 0:
            k = len(seq) // 4
            payloads = [f"{step}:{i}" for i in range(k)]
            assert tc.insert(seq, payloads) == jc.insert(seq, payloads)
        elif op == 1:
            jm, jn = jc.lookup(seq)
            tm, tn = tc.lookup(seq)
            assert tm == jm and [n.payload for n in tn] == \
                [n.payload for n in jn]
            pins.append((jn, tn))
        elif op == 2 and pins:
            jn, tn = pins.pop(int(rng.integers(0, len(pins))))
            jc.release(jn)
            tc.release(tn)
        elif op == 3 and rng.random() < 0.2:
            assert tc.flush() == jc.flush()
        else:
            assert tc.evict_unpinned(1) == jc.evict_unpinned(1)
        assert evicted["t"] == evicted["j"]
        assert tc.stats() == jc.stats()
        assert tc.total_refcount() == jc.total_refcount()
        assert tc.refcount_imbalance([t for _, t in pins]) == \
            jc.refcount_imbalance([j for j, _ in pins]) == []
