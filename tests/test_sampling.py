"""Invariants of the parallel sampling and clustering algorithms.

The parallel substitutions (Luby MIS, Bellman-Ford label propagation) must
honor the same contracts as the reference's sequential algorithms
(SURVEY.md §7.3: parity = same invariants + convergence, not bitwise)."""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra

from gravo_mg.hierarchy.cluster import cluster_labels
from gravo_mg.hierarchy.sampling import (
    parallel_disk_sample,
    poisson_disk_sample,
    random_sample,
)
from gravo_mg.utils.neighbors import neighbors_to_edges


def _graph_csr(pos, neigh):
    ii, jj = neighbors_to_edges(neigh)
    w = np.linalg.norm(pos[ii] - pos[jj], axis=1)
    n = pos.shape[0]
    return sp.coo_matrix((w, (ii, jj)), shape=(n, n)).tocsr()


def _pairwise_graph_dist(pos, neigh, sources):
    return dijkstra(_graph_csr(pos, neigh), indices=sources)


def _conflict_ball(neigh, dist, s, r, two_ring):
    """Independent numpy reference for the sampling conflict ball of s."""
    ball = set()
    for k, j in enumerate(neigh[s]):
        if j < 0 or dist[s, k] >= r:
            continue
        ball.add(int(j))
        if two_ring:
            for k2, m in enumerate(neigh[j]):
                if m < 0 or m == s:
                    continue
                if dist[s, k] + dist[j, k2] < r:
                    ball.add(int(m))
    return ball


@pytest.mark.parametrize("two_ring", [True, False])
def test_disk_sample_separation_and_coverage(sphere_mesh, two_ring):
    V, neigh = sphere_mesh["V"], sphere_mesh["neigh"]
    ii, jj = neighbors_to_edges(neigh)
    # radius as in the hierarchy: cbrt(8) * avg edge length
    r = 2.0 * np.linalg.norm(V[ii] - V[jj], axis=1).mean()
    samples, status = parallel_disk_sample(V, neigh, r, two_ring=two_ring, seed=3)
    assert len(samples) > 10
    assert (status != 0).all()  # every vertex decided

    safe = np.maximum(neigh, 0)
    dist = np.linalg.norm(V[safe] - V[:, None, :], axis=-1)
    dist[neigh < 0] = np.inf
    sample_set = set(samples.tolist())
    covered = set(samples.tolist())
    for s in samples:
        ball = _conflict_ball(neigh, dist, int(s), r, two_ring)
        # Separation: no other sample inside any sample's conflict ball.
        assert not (ball & sample_set), f"samples too close around {s}"
        covered |= ball
    # Maximality: every vertex is a sample or inside some sample's ball.
    assert covered == set(range(V.shape[0]))


def test_cluster_labels_match_scipy_dijkstra(sphere_mesh):
    V, neigh = sphere_mesh["V"], sphere_mesh["neigh"]
    rng = np.random.default_rng(0)
    samples = np.sort(rng.permutation(V.shape[0])[:40]).astype(np.int32)
    labels, D = cluster_labels(V, samples, neigh)
    ref = _pairwise_graph_dist(V, neigh, samples)
    ref_min = ref.min(axis=0)
    assert np.allclose(D, ref_min, atol=1e-4)
    # label's distance equals the min distance (ties can differ in owner)
    owner_d = ref[labels, np.arange(V.shape[0])]
    assert np.allclose(owner_d, ref_min, atol=1e-4)
    # samples own themselves
    assert (labels[samples] == np.arange(len(samples))).all()


def test_random_sample_deterministic():
    s1 = random_sample(1000, 125, seed=5)
    s2 = random_sample(1000, 125, seed=5)
    assert (s1 == s2).all() and len(s1) == 125 and len(np.unique(s1)) == 125


def test_poisson_disk_separation():
    rng = np.random.default_rng(1)
    P = rng.random((2000, 3))
    r = 0.08
    s = poisson_disk_sample(P, r, seed=2)
    from scipy.spatial import KDTree

    d, _ = KDTree(P[s]).query(P[s], k=2)
    assert d[:, 1].min() >= r  # pairwise separation
    dcov, _ = KDTree(P[s]).query(P)
    assert dcov.max() < 2 * r  # maximality -> coverage
