"""The port's verify engines and compaction (``repro_torch.compute``)
against the JAX package's (``repro.compute``) on the same numpy inputs:
compaction indices exactly equal, the port's host and device engines
byte-identical, and their pair sets equal to the JAX engines'."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import compute as jcompute  # noqa: E402
from repro_torch import compute as tcompute  # noqa: E402
from repro_torch.compute import engine as teng  # noqa: E402
from repro_torch.io import PipelineStats  # noqa: E402

CPU = torch.device("cpu")


def _compact_case(seed, E, M, N, thresh):
    rng = np.random.default_rng(seed)
    d2 = rng.random((E, M, N)).astype(np.float32)
    return d2, d2 <= thresh


def _both_compact(d2, mask, na, nb, intra, k_cap):
    j = [np.asarray(o) for o in jcompute.compact_pairs(
        jnp.asarray(d2), jnp.asarray(mask), jnp.asarray(na),
        jnp.asarray(nb), jnp.asarray(intra), k_cap)]
    t = [o.numpy() for o in tcompute.compact_pairs(
        torch.from_numpy(d2), torch.from_numpy(mask), torch.from_numpy(na),
        torch.from_numpy(nb), torch.from_numpy(intra), k_cap)]
    return j, t


@pytest.mark.parametrize("case", ["intra_and_dead_lane", "k_cap_overflow",
                                  "all_dead", "single_row"])
def test_compact_pairs_matches_jax(case):
    if case == "intra_and_dead_lane":
        d2, mask = _compact_case(0, 3, 24, 17, 0.2)
        na = np.array([24, 19, 0], np.int32)      # lane 2 masked out
        nb = np.array([17, 14, 17], np.int32)
        intra = np.array([False, True, False])
        k_cap = 256
    elif case == "k_cap_overflow":
        d2, mask = _compact_case(1, 2, 16, 16, 0.9)  # dense
        na = np.full(2, 16, np.int32)
        nb = np.full(2, 16, np.int32)
        intra = np.array([True, False])
        k_cap = 8
    elif case == "all_dead":
        d2, mask = _compact_case(2, 4, 8, 8, 0.5)
        na = np.zeros(4, np.int32)
        nb = np.full(4, 8, np.int32)
        intra = np.zeros(4, bool)
        k_cap = 16
    else:
        d2, mask = _compact_case(3, 1, 1, 33, 0.4)
        na = np.ones(1, np.int32)
        nb = np.array([30], np.int32)
        intra = np.zeros(1, bool)
        k_cap = 64
    (jc, jr, jcol, jd), (tc, tr, tcol, td) = _both_compact(
        d2, mask, na, nb, intra, k_cap)
    assert tc.dtype == np.int32 and tr.dtype == np.int32
    assert np.array_equal(tc, jc)        # true counts, even past k_cap
    assert np.array_equal(tr, jr)
    assert np.array_equal(tcol, jcol)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    if case == "k_cap_overflow":
        assert (tc > k_cap).all()
    if case == "all_dead":
        assert not tc.any()


def test_compact_pairs_is_nonzero_order_with_exact_sqrt():
    d2, mask = _compact_case(4, 2, 40, 40, 0.3)
    na = np.array([40, 33], np.int32)
    nb = np.array([40, 40], np.int32)
    intra = np.array([True, False])
    counts, r, c, d = [o.numpy() for o in tcompute.compact_pairs(
        *(torch.from_numpy(a) for a in (d2, mask, na, nb, intra)), 1024)]
    for e in range(2):
        m = mask[e][:na[e], :nb[e]]
        if intra[e]:
            m = np.triu(m, k=1)
        rows, cols = np.nonzero(m)
        k = rows.size
        assert counts[e] == k
        assert np.array_equal(r[e, :k], rows)
        assert np.array_equal(c[e, :k], cols)
        # bitwise: IEEE float32 sqrt on both sides
        assert np.array_equal(d[e, :k], np.sqrt(d2[e][rows, cols]))


def test_query_verify_compact_matches_jax():
    rng = np.random.default_rng(5)
    q_block = rng.normal(size=(12, 24)).astype(np.float32)
    slab = rng.normal(size=(64, 24)).astype(np.float32)
    slab[50:] = 1e15                                  # padded rows
    qidx = np.array([3, 7, 0, 0], np.int64)           # pow2-padded
    nq, eps, k_cap = 2, 6.5, 128
    jc, jr, jcol, jd = [np.asarray(o) for o in jcompute.query_verify_compact(
        jnp.asarray(q_block), jnp.asarray(qidx.astype(np.int32)), nq,
        jnp.asarray(slab), float(eps) * float(eps), k_cap)]
    tc, tr, tcol, td = [o.numpy() for o in tcompute.query_verify_compact(
        torch.from_numpy(q_block), torch.from_numpy(qidx), nq,
        torch.from_numpy(slab), eps, k_cap)]
    # no pair lies within float error of ε² here, so indices agree exactly
    d2 = ((q_block[qidx[:nq], None, :].astype(np.float64)
           - slab[None, :50]) ** 2).sum(-1)
    assert np.abs(d2 - eps * eps).min() > 1e-3
    assert 0 < tc[0] <= k_cap
    assert np.array_equal(tc, jc)
    assert np.array_equal(tr, jr)
    assert np.array_equal(tcol, jcol)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-3)


class _Cache:
    """Minimal checkout/release surface over fixed padded slabs."""

    def __init__(self, slabs, ids, rows):
        self.slabs, self.ids, self.rows = slabs, ids, rows

    def checkout(self, b):
        return (self.slabs[b], self.ids[b], self.rows[b], None)

    def release(self, entry):
        pass


def _edge_stream(seed=9, buckets=6, cap=64, dim=16):
    rng = np.random.default_rng(seed)
    slabs, ids, rows = [], [], []
    for b in range(buckets):
        n = int(rng.integers(cap // 2, cap + 1))
        v = np.full((cap, dim), 1e15, np.float32)   # pad rows far away
        v[:n] = rng.normal(scale=0.5, size=(n, dim)) + b * 0.3
        slabs.append(v)
        ids.append(np.arange(b * cap, b * cap + cap, dtype=np.int64))
        rows.append(n)
    edges = [(b, b, True) for b in range(buckets)]
    edges += [(a, b, False) for a in range(buckets)
              for b in range(a + 1, buckets) if (a + b) % 3]
    return _Cache(slabs, ids, rows), edges, cap, dim


def _run(engine_cls, cache, edges, cap, dim, eps, vb, **kw):
    stats = PipelineStats()
    eng = engine_cls(cache, epsilon=eps, capacity_rows=cap, dim=dim,
                     verify_batch=vb, pstats=stats, **kw)
    for bu, bv, intra in edges:
        eng.enqueue(bu, bv, intra)
    eng.finish()
    pairs, dists = eng.results()
    return (np.concatenate(pairs), np.concatenate(dists), eng.dc,
            stats.snapshot())


@pytest.mark.parametrize("vb", [1, 4, 32])
def test_engines_byte_identical_and_match_jax(vb):
    cache, edges, cap, dim = _edge_stream()
    eps = 2.2
    # no live pair of this stream lies within float error of ε
    live = [cache.slabs[b][:cache.rows[b]].astype(np.float64)
            for b in range(len(cache.slabs))]
    for bu, bv, _ in edges:
        d2 = ((live[bu][:, None] - live[bv][None]) ** 2).sum(-1)
        assert np.abs(d2 - eps * eps).min() > 1e-4
    ph, dh, dch, _ = _run(teng.HostVerifyEngine, cache, edges, cap, dim,
                          eps, vb, device=CPU)
    pd, dd, dcd, sd = _run(teng.DeviceVerifyEngine, cache, edges, cap, dim,
                           eps, vb, device=CPU)
    assert ph.shape[0] > 100
    assert np.array_equal(ph, pd)        # same pairs, same order
    assert np.array_equal(dh, dd)        # byte-identical distances
    assert dch == dcd
    jh, jdh, jdc, _ = _run(jcompute.HostVerifyEngine, cache, edges, cap,
                           dim, eps, vb)
    jd, jdd, _, jsd = _run(jcompute.DeviceVerifyEngine, cache, edges, cap,
                           dim, eps, vb)
    assert dch == jdc
    for jp, jdist in ((jh, jdh), (jd, jdd)):
        port = {tuple(p): d for p, d in zip(ph.tolist(), dh)}
        ref = {tuple(p): d for p, d in zip(jp.tolist(), jdist)}
        assert port.keys() == ref.keys()
        keys = sorted(port)
        np.testing.assert_allclose([port[k] for k in keys],
                                   [ref[k] for k in keys],
                                   rtol=1e-4, atol=1e-3)
    for k in ("h2d_transfers", "h2d_transfers_saved", "device_slab_hits",
              "device_batches", "device_compact_overflows"):
        assert sd[k] == jsd[k], k


def test_device_engine_overflow_recompacts(monkeypatch):
    cache, edges, cap, dim = _edge_stream(seed=3)
    eps = 4.0  # dense: most pairs pass
    monkeypatch.setattr(teng, "PAIR_CAP_INIT", 8)
    ph, dh, _, _ = _run(teng.HostVerifyEngine, cache, edges, cap, dim, eps,
                        8, device=CPU)
    pd, dd, _, sd = _run(teng.DeviceVerifyEngine, cache, edges, cap, dim,
                         eps, 8, device=CPU, pair_cap=8)
    assert sd["device_compact_overflows"] >= 1
    assert np.array_equal(ph, pd)
    assert np.array_equal(dh, dd)


def test_slab_pool_transfers_once_per_residency():
    stats = PipelineStats()
    pool = tcompute.DeviceSlabPool(CPU, stats)
    slab = np.ones((4, 3), np.float32)
    a = pool.operand(7, slab)
    slab[:] = 2.0                       # the pool holds its own copy
    assert torch.equal(pool.operand(7, slab), a) and a[0, 0] == 1.0
    pool.evict(7)
    pool.operand(7, slab)               # a new residency transfers again
    snap = stats.snapshot()
    assert (snap["h2d_transfers"], snap["device_slab_hits"],
            snap["h2d_transfers_saved"]) == (2, 1, 1)
    assert snap["h2d_bytes"] == 2 * slab.nbytes
