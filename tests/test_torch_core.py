"""The port's center index, bucket graph and bucketization
(``repro_torch.core``) against the JAX package's on the same data."""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.bucketize import bucketize as jbucketize  # noqa: E402
from repro.core import center_index as jci  # noqa: E402
from repro.core.bucket_graph import build_bucket_graph as jgraph  # noqa: E402
from repro.core.types import BucketMeta as JBucketMeta  # noqa: E402
from repro.core.types import JoinConfig as JJoinConfig  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.core.bucketize import bucketize as tbucketize  # noqa: E402
from repro_torch.core.bucketize import sample_centers  # noqa: E402
from repro_torch.core import center_index as tci  # noqa: E402
from repro_torch.core.bucket_graph import (  # noqa: E402
    build_bucket_graph as tgraph)
from repro_torch.core.types import JoinConfig  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402

CPU = torch.device("cpu")
# the modules (each package's ``core`` exports a function of the same name)
jbucketize_mod = importlib.import_module("repro.core.bucketize")
tbucketize_mod = importlib.import_module("repro_torch.core.bucketize")


def _points(seed, n, b, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32))


def _min_gap(q, c):
    """Smallest gap between the two nearest centers (f64) over all rows."""
    d2 = ((q[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    part = np.sort(d2, axis=1)[:, :2]
    return (part[:, 1] - part[:, 0]).min()


def test_brute_force_assign_matches_jax():
    q, c = _points(0, 300, 40, 24)
    assert _min_gap(q, c) > 1e-4   # no distance ties in this data
    dt, it = tci.BruteForceCenterIndex(c, CPU).assign(q)
    dj, ij = jci.BruteForceCenterIndex(c).assign(q)
    assert np.array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("k", [1, 7, 40, 64])
def test_brute_force_search_matches_jax(k):
    q, c = _points(1, 120, 40, 16)
    dt, it = tci.BruteForceCenterIndex(c, CPU).search(q, k)
    dj, ij = jci.BruteForceCenterIndex(c).search(q, k)
    assert it.shape == ij.shape == (120, min(k, 40))
    assert np.array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-3)


def test_search_orders_duplicate_centers_by_index():
    _, c = _points(2, 1, 6, 8)
    centers = np.concatenate([c, c])       # split sub-buckets share centers
    _, it = tci.BruteForceCenterIndex(centers, CPU).search(c, 4)
    _, ij = jci.BruteForceCenterIndex(centers).search(c, 4)
    assert np.array_equal(it[:, :2], np.stack([np.arange(6),
                                               np.arange(6) + 6], axis=1))
    assert np.array_equal(it[:, :2], np.asarray(ij)[:, :2])


def test_ivf_index_matches_jax():
    q, c = _points(3, 6, 150, 16)
    t = tci.make_center_index(c, device=CPU, exact_threshold=100)
    j = jci.make_center_index(c, exact_threshold=100)
    assert isinstance(t, tci.IVFCenterIndex)
    assert isinstance(j, jci.IVFCenterIndex)
    assert np.array_equal(t._member_ids, j._member_ids)
    dt, it = t.search(q, 5)
    dj, ij = j.search(q, 5)
    assert np.array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-3)
    assert np.array_equal(t.assign(q)[1], j.assign(q)[1])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bucketize_matches_jax(small_dataset, tmp_path, use_pallas):
    x, eps = small_dataset
    kw = dict(epsilon=eps, pad_align=64, num_buckets=24,
              memory_budget_bytes=1 << 20, use_pallas=use_pallas)
    jstore = JFlat.from_array(str(tmp_path / "j.bin"), x)
    tstore = FlatVectorStore.from_array(str(tmp_path / "t.bin"), x)
    jb, jm, _ = jbucketize(jstore, str(tmp_path / "jb"),
                                     JJoinConfig(**kw))
    tb, tm, timings = tbucketize(tstore, str(tmp_path / "tb"),
                                           JoinConfig(**kw), device=CPU)
    assert set(timings) == {"sample", "assign", "write"}
    # use_pallas picks the JAX side's assign path (Pallas kernel or center
    # index); the port ignores it. Same sampled centers (numpy-seeded), and
    # no distance ties in this data, so the assignment — and everything
    # after it — is exact
    centers = sample_centers(tstore, 24, 0, 8192)
    assert _min_gap(x, centers) > 1e-5
    assert np.array_equal(tm.centers, jm.centers)
    assert np.array_equal(tm.sizes, jm.sizes)
    np.testing.assert_allclose(tm.radii, jm.radii, rtol=1e-4, atol=1e-3)
    # the bucket store's files, byte for byte (radii: allclose above)
    for suffix in ("", ".ids", ".meta", ".centers.npy"):
        with open(str(tmp_path / "tb") + suffix, "rb") as f, \
                open(str(tmp_path / "jb") + suffix, "rb") as g:
            assert f.read() == g.read(), suffix


@pytest.mark.parametrize("n_centers,ivf", [(150, True), (80, False)])
def test_assign_scan_follows_center_index_crossover(
        tmp_path, monkeypatch, n_centers, ivf):
    """Scan 2 takes the center index the reference takes: with the
    crossover lowered to 100 centers in both packages, 150 centers go
    through the (approximate) IVF index in both, 80 through the exact
    path; the assignments are equal either way. (Unclustered data, so that
    the IVF index's probes miss some rows' nearest center.)"""
    x, _ = _points(4, 1500, 1, 32)
    for mod, ci in ((jbucketize_mod, jci), (tbucketize_mod, tci)):
        monkeypatch.setattr(mod, "make_center_index", functools.partial(
            ci.make_center_index, exact_threshold=100))
    jstore = JFlat.from_array(str(tmp_path / "j.bin"), x)
    tstore = FlatVectorStore.from_array(str(tmp_path / "t.bin"), x)
    centers = sample_centers(tstore, n_centers, 0, 512)
    ja, jd = jbucketize_mod.assign_blocks(jstore, centers, 512)
    ta, td = tbucketize_mod.assign_blocks(tstore, centers, 512, CPU)
    assert np.array_equal(ta, ja)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-3)
    _, nearest = tci.BruteForceCenterIndex(centers, CPU).assign(x)
    # the IVF index probes 8 of its 12 cells: some rows miss their nearest
    assert (ta != nearest).any() if ivf else np.array_equal(ta, nearest)


def test_bucket_graph_matches_jax(small_dataset, tmp_path):
    x, eps = small_dataset
    kw = dict(epsilon=eps, pad_align=64, num_buckets=24,
              memory_budget_bytes=1 << 20)
    tstore = FlatVectorStore.from_array(str(tmp_path / "t.bin"), x)
    _, meta, _ = tbucketize(tstore, str(tmp_path / "tb"),
                                      JoinConfig(**kw), device=CPU)
    jmeta = JBucketMeta(centers=meta.centers, radii=meta.radii,
                        sizes=meta.sizes)
    for prune in (True, False):
        gt = tgraph(meta, JoinConfig(prune=prune, **kw), device=CPU)
        gj = jgraph(jmeta, JJoinConfig(prune=prune, **kw))
        assert gt.num_nodes == gj.num_nodes
        assert np.array_equal(gt.edges, gj.edges)
        assert gt.num_edges > 0


def test_bucketize_rejects_striping(tmp_path):
    x = np.zeros((64, 8), np.float32)
    store = FlatVectorStore.from_array(str(tmp_path / "s.bin"), x)
    with pytest.raises(NotImplementedError, match="striping"):
        tbucketize(store, str(tmp_path / "b"),
                             JoinConfig(epsilon=0.1, io_devices=2),
                             device=CPU)

