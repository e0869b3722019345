"""The port-against-reference join tolerance, shared by the
``test_torch_*`` files: the same pair set apart from pairs on the ε
boundary, and the distances of common pairs allclose (ROADMAP.md rules)."""
import numpy as np


def boundary_pairs(x, pairs, eps, tol=1e-4, y=None):
    """Pairs whose float64 d² lies within ``tol`` of ε². ``y`` (a
    cross-join's second side, its ids offset by ``len(x)``) joins ``x``
    into one id space."""
    if not pairs:
        return set()
    if y is not None:
        x = np.concatenate([x, y])
    p = np.asarray(sorted(pairs))
    d2 = ((x[p[:, 0]].astype(np.float64) - x[p[:, 1]]) ** 2).sum(1)
    return {tuple(q) for q in p[np.abs(d2 - eps * eps) <= tol].tolist()}


def assert_same_pairs(x, eps, port, ref, y=None):
    """Pair sets equal except ε-boundary pairs; distances of common pairs
    allclose."""
    a = {tuple(p): d for p, d in zip(port.pairs.tolist(), port.distances)}
    b = {tuple(p): d for p, d in zip(ref.pairs.tolist(), ref.distances)}
    assert set(a) ^ set(b) <= boundary_pairs(x, set(a) ^ set(b), eps, y=y)
    common = sorted(set(a) & set(b))
    assert len(common) > 0
    np.testing.assert_allclose([a[k] for k in common], [b[k] for k in common],
                               rtol=1e-4, atol=1e-3)


def assert_identical(r1, r2):
    """Port against port: byte-exact pairs and distances."""
    assert np.array_equal(r1.pairs, r2.pairs)
    assert np.array_equal(r1.distances, r2.distances)


def assert_same_file(port_path, ref_path):
    """A store file of the port against the JAX package's: byte for byte,
    except a radii file, whose radii are square roots of each package's own
    assign d²: their squares are held to the d² tolerance."""
    port_path, ref_path = str(port_path), str(ref_path)
    if port_path.endswith("radii.npy"):
        a = np.load(port_path).astype(np.float64)
        b = np.load(ref_path).astype(np.float64)
        np.testing.assert_allclose(a * a, b * b, rtol=1e-4, atol=1e-3)
        return
    with open(port_path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read(), port_path


def assert_same_answers(x, Q, port, ref, eps, tol=1e-4):
    """Point-query answers, one (ids, distances) pair per query: the same
    members except ε-boundary rows (float64 d² within ``tol`` of ε²), and
    the distances of common members allclose. Returns the members held in
    common."""
    assert len(port) == len(ref) == len(Q)
    total = 0
    for q, (pi, pd), (ri, rd) in zip(Q, port, ref):
        a = dict(zip(np.asarray(pi).tolist(), np.asarray(pd).tolist()))
        b = dict(zip(np.asarray(ri).tolist(), np.asarray(rd).tolist()))
        q64 = np.asarray(q, np.float64)
        for v in set(a) ^ set(b):
            d2 = ((x[v].astype(np.float64) - q64) ** 2).sum()
            assert abs(d2 - eps * eps) <= tol, (v, d2)
        common = sorted(set(a) & set(b))
        total += len(common)
        np.testing.assert_allclose([a[k] for k in common],
                                   [b[k] for k in common],
                                   rtol=1e-4, atol=1e-3)
    return total


def assert_identical_answers(a, b):
    """Port against port: the same ids and distances, byte for byte, in
    the same order."""
    assert len(a) == len(b)
    for (ai, ad), (bi, bd) in zip(a, b):
        assert np.array_equal(ai, bi)
        assert np.array_equal(ad, bd)
