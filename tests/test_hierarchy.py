"""Hierarchy construction property tests (SURVEY.md §7.2 step 2:
row-sums = 1, bounded nnz/row, DoF ratios ~ 1/ratio)."""

import numpy as np
import pytest

from gravo_mg import Sampling, Weighting, build_hierarchy
from gravo_mg.hierarchy.variants import (
    build_hierarchy_ablation,
    build_hierarchy_sig06,
)
from gravo_mg.utils.io import load_hierarchy, save_hierarchy


def _check_hierarchy(h, nnz_max=3, rowsum=True):
    assert h.num_levels >= 1
    for k, lvl in enumerate(h.levels):
        U = lvl.U.to_scipy()
        assert U.shape == (h.dof[k], h.dof[k + 1])
        if rowsum:
            rs = np.asarray(U.sum(axis=1)).ravel()
            assert np.allclose(rs, 1.0, atol=1e-5), f"level {k} row sums"
        if nnz_max is not None:
            assert np.diff(U.indptr).max() <= nnz_max
        # weights nonnegative (barycentric hits are inside triangles,
        # fallbacks are convex/inverse-distance)
        assert U.data.min() >= -1e-6


def test_build_hierarchy_default(medium_mesh):
    h = build_hierarchy(medium_mesh["V"], medium_mesh["neigh"], lower_bound=100)
    _check_hierarchy(h)
    # coarsening rate: between 4x and 16x per level for ratio 8
    for k in range(len(h.dof) - 1):
        rate = h.dof[k] / h.dof[k + 1]
        assert 3.0 < rate < 20.0, h.dof
    # clusters: every label valid, samples own their cluster
    for lvl in h.levels:
        assert lvl.labels.min() >= 0
        assert lvl.labels.max() < len(lvl.samples)
        assert (
            lvl.labels[lvl.samples] == np.arange(len(lvl.samples))
        ).all()


def test_build_hierarchy_deterministic(sphere_mesh):
    h1 = build_hierarchy(sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=80, seed=7)
    h2 = build_hierarchy(sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=80, seed=7)
    assert h1.dof == h2.dof
    for l1, l2 in zip(h1.levels, h2.levels):
        assert (l1.samples == l2.samples).all()
        assert np.allclose(np.asarray(l1.U.weights), np.asarray(l2.U.weights))


def test_build_hierarchy_nested(sphere_mesh):
    h = build_hierarchy(
        sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=80, nested=True
    )
    _check_hierarchy(h)
    # nested: coarse points are the sampled fine points; samples map to
    # themselves with weight 1
    lvl = h.levels[0]
    assert np.allclose(lvl.coarse_points, sphere_mesh["V"][lvl.samples])
    U = lvl.U.to_scipy()
    for c, s in enumerate(lvl.samples[:50]):
        row = U.getrow(s)
        assert row.nnz >= 1
        assert abs(row[0, c] - 1.0) < 1e-6


@pytest.mark.parametrize("weighting", [Weighting.UNIFORM, Weighting.INVDIST])
def test_build_hierarchy_weightings(sphere_mesh, weighting):
    h = build_hierarchy(
        sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=80,
        weighting=weighting,
    )
    _check_hierarchy(h)


@pytest.mark.parametrize(
    "strategy", [Sampling.MIS, Sampling.RANDOM, Sampling.POISSONDISK]
)
def test_build_hierarchy_samplings(sphere_mesh, strategy):
    h = build_hierarchy(
        sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=80,
        sampling_strategy=strategy,
    )
    _check_hierarchy(h)


def test_build_hierarchy_all_triangles(sphere_mesh):
    h = build_hierarchy(
        sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=80,
        check_voronoi=False,
    )
    _check_hierarchy(h)


def test_build_hierarchy_sig06(medium_mesh):
    h = build_hierarchy_sig06(
        medium_mesh["V"], medium_mesh["neigh"], lower_bound=100
    )
    _check_hierarchy(h, nnz_max=None)


def test_build_hierarchy_ablation(sphere_mesh):
    h = build_hierarchy_ablation(
        sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=80, num_points=4
    )
    _check_hierarchy(h, nnz_max=4)


def test_build_hierarchy_ablation_random(sphere_mesh):
    h = build_hierarchy_ablation(
        sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=80,
        num_points=3, random_points=True,
    )
    _check_hierarchy(h, nnz_max=3)


def test_hierarchy_save_load(sphere_mesh, tmp_path):
    h = build_hierarchy(sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=80)
    f = tmp_path / "hier.npz"
    save_hierarchy(f, h)
    h2 = load_hierarchy(f)
    assert h2.dof == h.dof
    for l1, l2 in zip(h.levels, h2.levels):
        assert np.allclose(np.asarray(l1.U.weights), np.asarray(l2.U.weights))
        assert (np.asarray(l1.U.cols) == np.asarray(l2.U.cols)).all()


def test_normals_propagate_through_hierarchy():
    """Ctor normals are carried per level as cluster-averaged unit vectors
    (exceeds the reference, whose coarse_normals getter is never filled)."""
    from gravo_mg import MultigridSolver
    from gravo_mg.utils.laplacian import (
        cotan_laplacian, mass_voronoi, per_vertex_normals,
    )
    from gravo_mg.utils.meshgen import icosphere
    from gravo_mg.utils.neighbors import neighbors_from_faces

    V, F = icosphere(4)
    N = per_vertex_normals(V, F)
    M = mass_voronoi(V, F)
    solver = MultigridSolver(
        V, neighbors_from_faces(F), M, normals=N, lower_bound=100
    )
    cn = solver.coarse_normals
    assert len(cn) == solver.hierarchy.num_levels
    for lvl, nrm in zip(solver.hierarchy.levels, cn):
        assert nrm.shape == (lvl.coarse_points.shape[0], 3)
        np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-9)
    # A unit sphere's averaged normals stay outward: dot(normal, pos) > 0.
    p = solver.hierarchy.levels[0].coarse_points
    p = p / np.linalg.norm(p, axis=1, keepdims=True)
    assert (np.sum(cn[0] * p, axis=1) > 0.5).all()
