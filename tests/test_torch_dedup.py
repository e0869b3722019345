"""The port's semantic dedup (``repro_torch.data.dedup``) and baselines
(``repro_torch.baselines``) against the JAX package's, on the CPU: the
same survivors and drops, and the baselines' pairs and distance counts
exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.baselines as jbase  # noqa: E402
import repro_torch.baselines as tbase  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro.baselines.diskann_join import build_index as jbuild  # noqa: E402
from repro.data import dedup as jdedup  # noqa: E402
from repro.data import clustered_vectors as jclustered  # noqa: E402
from repro.store.vector_store import FlatVectorStore as JFlat  # noqa: E402
from repro_torch.baselines.diskann_join import build_index  # noqa: E402
from repro_torch.data import clustered_vectors  # noqa: E402
from repro_torch.data import dedup as tdedup  # noqa: E402
from repro_torch.data.synthetic import brute_force_pairs  # noqa: E402
from repro_torch.store.vector_store import FlatVectorStore  # noqa: E402

EPS = 0.05


@pytest.fixture(scope="module")
def planted():
    """tests/test_substrate.py's data: 600 rows and 200 near duplicates."""
    rng = np.random.default_rng(0)
    base = clustered_vectors(600, 24, seed=9)
    dups = base[:200] + rng.normal(scale=1e-3,
                                   size=(200, 24)).astype(np.float32)
    return np.concatenate([base, dups])


def test_union_find():
    uf = tdedup.UnionFind(5)
    uf.union(0, 1)
    uf.union(1, 2)
    uf.union(4, 3)
    assert [uf.find(i) for i in range(5)] == [0, 0, 0, 3, 3]


def test_data_exports_the_reference_names():
    import repro.data as jdata
    assert tdata.__all__ == jdata.__all__


def test_planted_data_has_no_boundary_pair(planted):
    """No pair's float64 d² lies within 1% of ε², so the two packages'
    float32 verify cannot disagree on a pair and the equality below
    cannot hide a boundary case."""
    x = planted.astype(np.float64)
    sq = (x * x).sum(1)
    d2 = sq[:, None] - 2.0 * x @ x.T + sq[None, :]
    iu = np.triu_indices(len(x), k=1)
    rel = np.abs(d2[iu] / (EPS * EPS) - 1.0)
    assert rel.min() > 1e-2


def test_semantic_dedup_matches_jax(planted, tmp_path):
    mine = tdedup.semantic_dedup(planted, epsilon=EPS,
                                 workdir=str(tmp_path / "t"),
                                 recall_target=0.95, device="cpu")
    ref = jdedup.semantic_dedup(planted, epsilon=EPS,
                                workdir=str(tmp_path / "j"),
                                recall_target=0.95)
    np.testing.assert_array_equal(mine.keep_ids, ref.keep_ids)
    np.testing.assert_array_equal(mine.drop_ids, ref.drop_ids)
    assert (mine.num_docs, mine.num_pairs, mine.num_dropped) == \
        (ref.num_docs, ref.num_pairs, ref.num_dropped)
    assert mine.dedup_rate == ref.dedup_rate
    assert mine.num_dropped >= 180
    assert mine.join_stats["distance_computations"] == \
        ref.join_stats["distance_computations"]
    assert mine.join_stats["read_amplification"] <= 1.2


def test_semantic_dedup_needs_a_device_or_cpu(planted, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdedup.semantic_dedup(planted, epsilon=EPS, workdir=str(tmp_path))


# ---------------------------------------------------------------------------
# baselines: numpy copies, so the JAX package's outputs exactly
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    x = jclustered(400, 16, seed=3)
    np.testing.assert_array_equal(x, clustered_vectors(400, 16, seed=3))
    return x, 0.35


def test_baselines_export_the_reference_names():
    assert tbase.__all__ == jbase.__all__


@pytest.mark.parametrize("kw", [{}, {"num_pivots": 5, "seed": 1}])
def test_cluster_join_matches_jax(small, kw):
    x, eps = small
    mine, dc = tbase.cluster_join(x, eps, **kw)
    ref, jdc = jbase.cluster_join(x, eps, **kw)
    np.testing.assert_array_equal(mine, ref)
    assert dc == jdc and mine.shape[0] > 0
    # exact: every ε-pair
    truth = brute_force_pairs(x, eps)
    assert {tuple(p) for p in mine.tolist()} == \
        {tuple(p) for p in truth.tolist()}


@pytest.mark.parametrize("kw", [{}, {"tables": 4, "k": 2, "seed": 7}])
def test_rshj_join_matches_jax(small, kw):
    x, eps = small
    mine, dc = tbase.rshj_join(x, eps, **kw)
    ref, jdc = jbase.rshj_join(x, eps, **kw)
    np.testing.assert_array_equal(mine, ref)
    assert dc == jdc and mine.shape[0] > 0


def test_rshj_join_blow_up_raises(small):
    x, eps = small
    with pytest.raises(MemoryError):
        tbase.rshj_join(x, 10 * eps, max_candidates=100)


def test_diskann_join_matches_jax(small, tmp_path):
    x, eps = small
    store = FlatVectorStore.from_array(str(tmp_path / "t.bin"), x)
    jstore = JFlat.from_array(str(tmp_path / "j.bin"), x)
    mine, dc = tbase.diskann_join(store, x, eps)
    ref, jdc = jbase.diskann_join(jstore, x, eps)
    np.testing.assert_array_equal(mine, ref)
    assert dc == jdc and mine.shape[0] > 0
    index, jindex = build_index(x), jbuild(x)
    np.testing.assert_array_equal(index.graph, jindex.graph)
    np.testing.assert_array_equal(index.compressed, jindex.compressed)
    assert index.medoid == jindex.medoid
