"""The port's striped store (``repro_torch.store.striped_store``) and
striped builds: round trips like the plain store, the JAX package's files
byte for byte, coalescing that cuts read ops, striped joins equal to
unstriped ones, and striped indexes that open across the two packages."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import DiskJoinIndex as JIndex  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.store.striped_store import (  # noqa: E402
    StripedBucketedVectorStore as JStriped)
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.store import StripedBucketedVectorStore  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402
from torch_parity import (assert_identical, assert_same_file,  # noqa: E402
                          assert_same_pairs)

BASE = dict(pad_align=64, num_buckets=24, memory_budget_bytes=1 << 20,
            io_lookahead=12)
STRIPED = dict(io_devices=4, io_batch_reads=True, io_coalesce=True)


def _fill(writer, sizes, dim, seed=0):
    rng = np.random.default_rng(seed)
    vid = 0
    data = {}
    for b, n in enumerate(sizes):
        rows = rng.normal(size=(int(n), dim)).astype(np.float32)
        data[b] = (rows, np.arange(vid, vid + int(n)))
        for i in range(int(n)):
            writer.append(b, rows[i], vid)
            vid += 1
    return data


def _files(prefix):
    d, base = os.path.split(str(prefix))
    return sorted(f for f in os.listdir(d) if f.startswith(base))


@pytest.mark.parametrize("stripe_by", ["phase", "hash"])
def test_roundtrip_matches_plain_store(tmp_path, stripe_by):
    rng = np.random.default_rng(1)
    sizes = rng.integers(1, 6, size=10)
    centers = rng.normal(size=(10, 4)).astype(np.float32)
    w = StripedBucketedVectorStore.create(
        str(tmp_path / "st"), 4, np.float32, sizes, centers,
        np.ones(10, np.float32), num_devices=4, stripe_by=stripe_by)
    data = _fill(w, sizes, 4)
    store = w.finalize()
    assert store.num_devices == 4
    assert store.num_vectors == int(sizes.sum())
    for b in range(10):
        vecs, ids = store.read_bucket(b)
        np.testing.assert_array_equal(vecs, data[b][0])
        np.testing.assert_array_equal(ids, data[b][1])
    devs = [store.device_of(b) for b in range(10)]
    assert set(devs) == {0, 1, 2, 3}
    if stripe_by == "phase":   # round-robin in (identity) layout order
        assert devs == [b % 4 for b in range(10)]
    assert store.device_loads_balanced().sum() == store.nbytes
    reopened = StripedBucketedVectorStore(str(tmp_path / "st"))
    np.testing.assert_array_equal(reopened.read_bucket(3)[0], data[3][0])
    reopened.close()
    store.close()


@pytest.mark.parametrize("stripe_by,chunk", [("phase", 1), ("phase", 4),
                                             ("hash", 1)])
def test_files_equal_jax(tmp_path, stripe_by, chunk):
    """Same inputs and layout order → the JAX package's striped files,
    byte for byte."""
    rng = np.random.default_rng(2)
    sizes = rng.integers(1, 9, size=13)
    centers = rng.normal(size=(13, 4)).astype(np.float32)
    radii = rng.random(13).astype(np.float32)
    order = rng.permutation(13)
    stores = []
    for cls, name in ((StripedBucketedVectorStore, "t"), (JStriped, "j")):
        w = cls.create(str(tmp_path / name), 4, np.float32, sizes, centers,
                       radii, num_devices=3, stripe_by=stripe_by,
                       layout_order=order, stripe_chunk=chunk)
        _fill(w, sizes, 4, seed=5)
        stores.append(w.finalize())
    files = _files(tmp_path / "t")
    assert [f.replace("t", "j", 1) for f in files] == _files(tmp_path / "j")
    assert len(files) > 5
    for f in files:
        with open(tmp_path / f, "rb") as a, \
                open(tmp_path / f.replace("t", "j", 1), "rb") as b:
            assert a.read() == b.read(), f
    for b in range(13):
        assert stores[0].device_of(b) == stores[1].device_of(b)
        assert np.array_equal(stores[0].layout_keys([b]),
                              stores[1].layout_keys([b]))


@pytest.fixture(scope="module")
def striped(small_dataset, tmp_path_factory):
    """One dataset: a plain port index, a striped port index and a
    striped JAX index."""
    x, eps = small_dataset
    tmp = tmp_path_factory.mktemp("striped")
    cfg = dict(epsilon=eps, **BASE)
    plain = DiskJoinIndex.build(
        FlatVectorStore.from_array(str(tmp / "p.bin"), x),
        JoinConfig(**cfg), str(tmp / "p"), device="cpu")
    port = DiskJoinIndex.build(
        FlatVectorStore.from_array(str(tmp / "t.bin"), x),
        JoinConfig(**cfg, **STRIPED), str(tmp / "t"), device="cpu")
    ref = JIndex.build(JFlat.from_array(str(tmp / "j.bin"), x),
                       JJoinConfig(**cfg, **STRIPED), str(tmp / "j"))
    yield x, eps, plain, port, ref, tmp
    for i in (plain, port, ref):
        i.close()


def test_striped_build_files_equal_jax(striped):
    x, eps, _, port, ref, tmp = striped
    assert port.store.num_devices == ref.store.num_devices > 1
    files = _files(tmp / "t" / "buckets")
    assert files == _files(tmp / "j" / "buckets")
    for f in files:
        assert_same_file(tmp / "t" / f, tmp / "j" / f)


@pytest.mark.parametrize("io_mode", ["sync", "prefetch"])
def test_striped_join_matches_unstriped_and_jax(striped, io_mode):
    x, eps, plain, port, ref, _ = striped
    base = plain.self_join()
    r = port.self_join(io_mode=io_mode)
    assert_identical(base, r)
    assert_same_pairs(x, eps, r, ref.self_join(io_mode=io_mode))
    if io_mode == "prefetch":
        p = r.io_stats["pipeline"]
        assert p["num_devices"] == port.store.num_devices
        assert sum(p["device_loads"]) == r.bucket_loads


def test_coalescing_reduces_read_ops(striped):
    """Schedule-order layout + coalescing merge adjacent misses: fewer read
    ops for the same useful bytes."""
    x, eps, plain, port, _, _ = striped
    r_plain = plain.self_join(io_mode="prefetch")
    r_co = port.self_join(io_mode="prefetch")
    assert_identical(r_plain, r_co)
    p = r_co.io_stats["pipeline"]
    assert p["batched_submissions"] > 0
    assert p["coalesced_reads"] > 0
    assert p["coalesced_buckets"] > p["coalesced_reads"]
    assert r_co.io_stats["read_ops"] < r_plain.io_stats["read_ops"]
    assert (r_co.io_stats["bytes_read_useful"]
            == r_plain.io_stats["bytes_read_useful"])


def test_striped_index_opens_across_packages(striped):
    x, eps, _, port, ref, tmp = striped
    in_port = DiskJoinIndex.open(str(tmp / "j"), device="cpu")
    in_jax = JIndex.open(str(tmp / "t"))
    try:
        assert isinstance(in_port.store, StripedBucketedVectorStore)
        assert isinstance(in_jax.store, JStriped)
        assert_same_pairs(x, eps, in_port.self_join(io_mode="prefetch"),
                          ref.self_join())
        assert_same_pairs(x, eps, port.self_join(compute_mode="device"),
                          in_jax.self_join(io_mode="prefetch"))
    finally:
        in_port.close()
        in_jax.close()
