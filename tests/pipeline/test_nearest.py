"""Nearest-neighbour queries of the text-region stages: scipy's cKDTree,
queried with a list of ranks, against sklearn's KDTree as the oracle."""
import numpy as np
import pytest
from scipy.spatial import cKDTree


@pytest.mark.parametrize('ranks', ['nearest', 'all'])
@pytest.mark.parametrize('integer_points', [False, True])
def test_ckdtree_matches_sklearn_kdtree(ranks, integer_points):
    neighbors = pytest.importorskip('sklearn.neighbors')
    rng = np.random.default_rng(7)
    points = rng.uniform(0, 1000, (120, 2))
    queries = rng.uniform(0, 1000, (40, 2))
    if integer_points:
        # Region centers are int32 pixel positions, so distance ties occur.
        points = np.round(points / 50).astype(np.int32) * 50
        queries = np.round(queries / 50).astype(np.int32) * 50
    k = 1 if ranks == 'nearest' else len(points)

    dist_ref, idx_ref = neighbors.KDTree(points).query(queries, k=k)
    dist, idx = cKDTree(points).query(queries, k=list(range(1, k + 1)))

    assert idx.shape == idx_ref.shape == (len(queries), k)
    np.testing.assert_allclose(dist, dist_ref, rtol=1e-12, atol=1e-9)
    if not integer_points:
        assert np.array_equal(idx, idx_ref)
    else:
        # Ties may order differently; each index must still sit at its
        # reported distance.
        np.testing.assert_allclose(
            np.linalg.norm(points[idx] - queries[:, None], axis=-1),
            dist_ref, rtol=1e-12, atol=1e-9,
        )
