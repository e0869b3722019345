"""The port's cross-join (``repro_torch.core.bipartite``,
``DiskJoinIndex.cross_join`` and the one-shot ``similarity_cross_join``)
against the JAX package's on the same data: both ``reorder_larger``
values, an attribute mask over the combined id space, sync and prefetch
I/O, a striped side, and host and device compute modes (the port's own
variants byte-identical)."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import DiskJoinIndex as JIndex  # noqa: E402
from repro.core import JoinConfig as JJoinConfig  # noqa: E402
from repro.core.join import similarity_cross_join as jcross  # noqa: E402
from repro.data import clustered_vectors  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.core import DiskJoinIndex, JoinConfig  # noqa: E402
from repro_torch.core.join import (  # noqa: E402
    _CombinedBipartiteStore, _CrossJoinExecutor, similarity_cross_join)
from repro_torch.core.bipartite import (  # noqa: E402
    CombinedBipartiteStore, CrossJoinExecutor)
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402
from torch_parity import assert_identical, assert_same_pairs  # noqa: E402

EPS = 0.3
BASE = dict(epsilon=EPS, pad_align=64, num_buckets=16,
            memory_budget_bytes=1 << 20, io_lookahead=8)
STRIPED = dict(io_devices=4, io_batch_reads=True, io_coalesce=True)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """X (2,500 rows) and a near-duplicate Y (1,500 rows): a port and a
    JAX index of each, Y's also striped."""
    tmp = tmp_path_factory.mktemp("cross")
    rng = np.random.default_rng(3)
    x = clustered_vectors(2500, 32, seed=5)
    y = (x[:1500] + rng.normal(scale=0.05, size=(1500, 32))
         ).astype(np.float32)
    out = {"x": x, "y": y}
    for name, data in (("x", x), ("y", y)):
        out[f"t{name}"] = DiskJoinIndex.build(
            FlatVectorStore.from_array(str(tmp / f"t{name}.bin"), data),
            JoinConfig(**BASE), str(tmp / f"t{name}"), device="cpu")
        out[f"j{name}"] = JIndex.build(
            JFlat.from_array(str(tmp / f"j{name}.bin"), data),
            JJoinConfig(**BASE), str(tmp / f"j{name}"))
    out["tys"] = DiskJoinIndex.build(
        FlatVectorStore.from_array(str(tmp / "tys.bin"), y),
        JoinConfig(**BASE, **STRIPED), str(tmp / "tys"), layout="spatial",
        device="cpu")
    out["jys"] = JIndex.build(
        JFlat.from_array(str(tmp / "jys.bin"), y),
        JJoinConfig(**BASE, **STRIPED), str(tmp / "jys"), layout="spatial")
    yield out
    for k, v in out.items():
        if k not in ("x", "y"):
            v.close()


def _check(sides, t, j):
    assert_same_pairs(sides["x"], EPS, t, j, y=sides["y"])
    n_x = sides["x"].shape[0]
    # one id from each side, X's first
    assert (t.pairs[:, 0] < n_x).all() and (t.pairs[:, 1] >= n_x).all()


@pytest.mark.parametrize("reorder_larger", [True, False])
@pytest.mark.parametrize("io_mode", ["sync", "prefetch"])
def test_cross_join_matches_jax(sides, reorder_larger, io_mode):
    t = sides["tx"].cross_join(sides["ty"], reorder_larger=reorder_larger,
                               io_mode=io_mode)
    j = sides["jx"].cross_join(sides["jy"], reorder_larger=reorder_larger,
                               io_mode=io_mode)
    assert t.pairs.shape[0] > 100
    _check(sides, t, j)
    assert t.bucket_loads == j.bucket_loads
    assert t.num_distance_computations == j.num_distance_computations
    assert_identical(t, sides["tx"].cross_join(
        sides["ty"], reorder_larger=reorder_larger))


def test_cross_join_attribute_mask_matches_jax(sides):
    n = sides["x"].shape[0] + sides["y"].shape[0]
    mask = np.arange(n) % 4 != 1
    t = sides["tx"].cross_join(sides["ty"], attribute_mask=mask)
    j = sides["jx"].cross_join(sides["jy"], attribute_mask=mask)
    assert mask[t.pairs].all()
    _check(sides, t, j)
    with pytest.raises(ValueError, match="combined id space"):
        sides["tx"].cross_join(sides["ty"], attribute_mask=mask[:-1])


@pytest.mark.parametrize("io_mode", ["sync", "prefetch"])
def test_cross_join_striped_side(sides, io_mode):
    """A striped side gives the unstriped side's bytes, and the JAX
    package's pairs; the prefetcher reads both sides' devices."""
    t = sides["tx"].cross_join(sides["tys"], io_mode=io_mode,
                               compute_mode="device")
    assert_identical(t, sides["tx"].cross_join(sides["ty"]))
    _check(sides, t, sides["jx"].cross_join(sides["jys"], io_mode=io_mode))
    if io_mode == "prefetch":
        p = t.io_stats["pipeline"]
        assert p["num_devices"] == 1 + sides["tys"].store.num_devices
        assert sum(p["device_loads"]) == t.bucket_loads


def test_cross_join_plan_and_compute_modes(sides):
    base = sides["tx"].cross_join(sides["ty"])
    for kw in (dict(compute_mode="device"), dict(plan_mode="on"),
               dict(plan_mode="on", compute_mode="auto",
                    emulate_xfer_gb_s=50.0, io_mode="prefetch")):
        assert_identical(base, sides["tx"].cross_join(sides["ty"], **kw))


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("reorder_larger", [True, False])
def test_one_shot_cross_join_matches_jax(tmp_path, sides, reorder_larger):
    x, y = sides["x"], sides["y"]
    cfg = dict(BASE, **STRIPED)
    t = similarity_cross_join(
        FlatVectorStore.from_array(str(tmp_path / "x.bin"), x),
        FlatVectorStore.from_array(str(tmp_path / "y.bin"), y),
        JoinConfig(**cfg), str(tmp_path / "t"),
        reorder_larger=reorder_larger, io_mode="prefetch", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jcross(JFlat.from_array(str(tmp_path / "jx.bin"), x),
                   JFlat.from_array(str(tmp_path / "jy.bin"), y),
                   JJoinConfig(**cfg), str(tmp_path / "j"),
                   reorder_larger=reorder_larger, io_mode="prefetch")
    _check(sides, t, j)
    assert t.timings["bucketing"] > 0
    assert _CombinedBipartiteStore is CombinedBipartiteStore
    assert _CrossJoinExecutor is CrossJoinExecutor
