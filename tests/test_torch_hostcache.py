"""The port's host write-back cache against the JAX reference's.

``WriteCache`` is host bookkeeping with no RNG, so the port's must hold
the reference's state after every call: a hypothesis test drives both
through the same random absorb / touch / pop / drain / ``page_durable``
sequences under fifo and lru and compares their whole state, and the
return value of each call, step by step.  The reference's own unit tests
(``tests/test_closed_loop.py::TestWriteCacheUnit``) run here on the port.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.flashsim.config import HostCacheConfig
from repro_torch.flashsim.hostcache import CacheEntry, WriteCache


def _state(c):
    """Everything a ``WriteCache`` holds, as plain values."""
    return dict(
        dirty=[(eid, e.lpns, e.versions, e.payload)
               for eid, e in c._dirty.items()],
        dirty_eids={k: list(v) for k, v in c._dirty_eids.items()},
        resident=dict(c._resident), latest=dict(c._latest),
        durable=dict(c.durable), next_eid=c._next_eid,
        next_version=c._next_version, dirty_pages=c.dirty_pages,
        flushing_pages=c.flushing_pages, pending=c.pending_pages,
        counters=(c.absorbed_writes, c.absorbed_pages, c.hit_pages,
                  c.flush_pages),
        marks=(c.need_flush(), c.flushed_enough()),
    )


def _entry(e):
    return None if e is None else (e.lpns, e.versions, e.payload)


SPAN = 12

_ops = st.lists(st.one_of(
    st.tuples(st.just("absorb"),
              st.lists(st.integers(0, SPAN - 1), min_size=1, max_size=4)),
    st.tuples(st.just("touch"), st.integers(0, SPAN - 1)),
    st.tuples(st.just("hit"), st.integers(0, SPAN - 1)),
    st.tuples(st.just("pop"), st.just(0)),
    st.tuples(st.just("flush"), st.just(0)),
    st.tuples(st.just("land"), st.integers(0, 1 << 16)),
    st.tuples(st.just("drain"), st.just(0)),
), max_size=60)


@settings(max_examples=150, deadline=None)
@given(ops=_ops, eviction=st.sampled_from(["fifo", "lru"]),
       capacity=st.integers(1, 10))
def test_write_cache_matches_reference(ops, eviction, capacity):
    from repro.flashsim.config import HostCacheConfig as RHostCacheConfig
    from repro.flashsim.hostcache import WriteCache as RWriteCache

    kw = dict(capacity_pages=capacity, flush_high=0.6, flush_low=0.3,
              eviction=eviction)
    port = WriteCache(HostCacheConfig(**kw))
    ref = RWriteCache(RHostCacheConfig(**kw))
    # (lpn, version) of every page popped and not yet durable, in the
    # order they were popped; "land" picks one of them.
    flying = []
    for step, (op, arg) in enumerate(ops):
        outs = []
        for c in (ref, port):
            if op == "absorb":
                if not c.fits(len(arg)):
                    out = ("oversized", c.fits(len(arg)))
                elif not c.can_absorb(len(arg)):
                    with pytest.raises(RuntimeError):
                        c.absorb(arg, payload=step)
                    out = "full"
                else:
                    out = _entry(c.absorb(arg, payload=step))
            elif op == "touch":
                c.touch(arg)
                out = None
            elif op == "hit":
                out = (c.contains(arg), c.version(arg))
                if out[0]:
                    c.note_hit()
            elif op == "pop":
                out = _entry(c.pop_entry())
            elif op == "flush":
                out = []
                if c.need_flush():
                    while not c.flushed_enough():
                        out.append(_entry(c.pop_entry()))
            elif op == "drain":
                out = [_entry(e) for e in c.drain()]
            else:
                if not flying:
                    with pytest.raises(RuntimeError):
                        c.page_durable(0, 0)
                    out = "idle"
                else:
                    lpn, ver = flying[arg % len(flying)]
                    c.page_durable(lpn, ver)
                    out = (lpn, ver)
            outs.append(out)
        assert outs[1] == outs[0], (step, op)
        assert _state(port) == _state(ref), (step, op)
        out = outs[0]
        if op == "pop" and out is not None:
            flying.extend(zip(out[0], out[1]))
        elif op in ("flush", "drain"):
            for e in out:
                if e is not None:
                    flying.extend(zip(e[0], e[1]))
        elif op == "land" and flying:
            flying.pop(arg % len(flying))
        if op == "land" and out == "idle":
            # A failed page_durable leaves the counter at -1 in both;
            # start both over from empty caches.
            port = WriteCache(HostCacheConfig(**kw))
            ref = RWriteCache(RHostCacheConfig(**kw))


def test_cache_entry_is_frozen():
    e = CacheEntry((1, 2), (3, 4), payload="g")
    with pytest.raises(AttributeError):
        e.lpns = ()
    assert e == CacheEntry((1, 2), (3, 4), "g")


class TestWriteCacheUnit:
    def test_absorb_hit_and_versions(self):
        c = WriteCache(HostCacheConfig(capacity_pages=8))
        c.absorb([10, 11])
        assert c.contains(10) and c.contains(11) and not c.contains(12)
        v1 = c.version(10)
        c.absorb([10])                       # rewrite: new version, new slot
        assert c.version(10) > v1
        assert c.pending_pages == 3 and c.dirty_pages == 3

    def test_fifo_flush_and_durable_raw_order(self):
        c = WriteCache(HostCacheConfig(capacity_pages=8))
        e1 = c.absorb([5])
        e2 = c.absorb([5])
        assert c.pop_entry() is e1 and c.pop_entry() is e2
        # Out-of-order landings: the newer version wins regardless.
        c.page_durable(5, e2.versions[0])
        c.page_durable(5, e1.versions[0])
        assert c.durable[5] == e2.versions[0]
        assert not c.contains(5) and c.pending_pages == 0

    def test_watermarks(self):
        c = WriteCache(HostCacheConfig(capacity_pages=10, flush_high=0.5,
                                       flush_low=0.2))
        c.absorb([1, 2, 3, 4, 5, 6])
        assert c.need_flush()
        while not c.flushed_enough():
            c.pop_entry()
        assert c.dirty_pages <= 2
        # Flushing pages still hold capacity until they land.
        assert c.pending_pages == 6 and not c.can_absorb(5)

    def test_capacity_is_honest(self):
        c = WriteCache(HostCacheConfig(capacity_pages=4))
        assert c.fits(4) and not c.fits(5)
        c.absorb([0, 1, 2])
        assert not c.can_absorb(2)
        with pytest.raises(RuntimeError):
            c.absorb([7, 8])

    def test_lru_touch_reorders_flush(self):
        c = WriteCache(HostCacheConfig(capacity_pages=8, eviction="lru"))
        e1, e2, e3 = c.absorb([1]), c.absorb([2]), c.absorb([3])
        c.touch(1)                # read hit refreshes lpn 1's entry
        assert c.pop_entry() is e2
        assert c.pop_entry() is e3
        assert c.pop_entry() is e1
        assert c.pop_entry() is None

    def test_fifo_ignores_touch(self):
        c = WriteCache(HostCacheConfig(capacity_pages=8))
        e1, e2 = c.absorb([1]), c.absorb([2])
        c.touch(1)
        assert c.pop_entry() is e1 and c.pop_entry() is e2

    def test_lru_preserves_per_lpn_order_and_versions(self):
        c = WriteCache(HostCacheConfig(capacity_pages=8, eviction="lru"))
        a, b = c.absorb([7]), c.absorb([7])
        c.touch(7)
        assert c.pop_entry() is a and c.pop_entry() is b
        c.page_durable(7, b.versions[0])
        c.page_durable(7, a.versions[0])
        assert c.durable[7] == b.versions[0]
        assert not c.contains(7) and c.pending_pages == 0

    def test_lru_flushing_lines_are_not_touchable(self):
        c = WriteCache(HostCacheConfig(capacity_pages=8, eviction="lru"))
        e1, e2 = c.absorb([1]), c.absorb([2])
        assert c.pop_entry() is e1          # lpn 1 now flushing-only
        c.touch(1)                          # must not corrupt the ring
        assert c.pop_entry() is e2

    def test_invalid_eviction_policy_rejected(self):
        with pytest.raises(ValueError, match="eviction"):
            HostCacheConfig(eviction="random")
