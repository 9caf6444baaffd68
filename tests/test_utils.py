"""Unit tests for graph/mesh utilities (SURVEY.md §4: kernel-level tests
against scipy/dense references)."""

import numpy as np
import pytest
import scipy.sparse as sp

from gravo_mg.utils.laplacian import (
    cotan_laplacian,
    mass_barycentric,
    mass_voronoi,
    point_cloud_laplacian,
)
from gravo_mg.utils.meshgen import grid_mesh, icosphere, point_cloud, torus_mesh
from gravo_mg.utils.neighbors import (
    homogenize_edges,
    knn_undirected,
    neighbors_from_faces,
    neighbors_from_stiffness,
    neighbors_to_edges,
)
from gravo_mg.utils.normalize import (
    normalize_area,
    normalize_bounding_box,
)


def test_homogenize_roundtrip():
    ii = np.array([0, 0, 1, 2, 2, 2])
    jj = np.array([1, 2, 0, 0, 1, 3])
    neigh = homogenize_edges(ii, jj, num_nodes=4)
    assert neigh.shape == (4, 3)
    ri, rj = neighbors_to_edges(neigh)
    got = set(zip(ri.tolist(), rj.tolist()))
    assert got == set(zip(ii.tolist(), jj.tolist()))


def test_neighbors_from_faces_symmetric():
    V, F = icosphere(2)
    neigh = neighbors_from_faces(F)
    ii, jj = neighbors_to_edges(neigh)
    edges = set(zip(ii.tolist(), jj.tolist()))
    assert all((j, i) in edges for i, j in edges)
    # icosphere: all vertices have degree 5 or 6
    deg = (neigh >= 0).sum(axis=1)
    assert set(deg.tolist()) <= {5, 6}


def test_neighbors_from_stiffness_matches_faces():
    V, F = icosphere(2)
    S = cotan_laplacian(V, F)
    n1 = neighbors_from_faces(F)
    n2 = neighbors_from_stiffness(S)
    e1 = set(zip(*[a.tolist() for a in neighbors_to_edges(n1)]))
    e2 = set(zip(*[a.tolist() for a in neighbors_to_edges(n2)]))
    assert e1 == e2


def test_cotan_laplacian_properties():
    V, F = icosphere(3)
    S = cotan_laplacian(V, F)
    # symmetric, zero row sums (constants in kernel), PSD
    assert abs(S - S.T).max() < 1e-10
    assert np.abs(S @ np.ones(S.shape[0])).max() < 1e-10
    x = np.random.default_rng(0).standard_normal(S.shape[0])
    assert x @ (S @ x) >= -1e-8


def test_cotan_laplacian_sphere_eigenvalue():
    # On the unit sphere, -Δ (coords) = 2 * coords; with lumped mass:
    # S V ≈ 2 M V.
    V, F = icosphere(4)
    S = cotan_laplacian(V, F)
    M = mass_voronoi(V, F)
    lhs = S @ V
    rhs = 2.0 * (M @ V)
    rel = np.linalg.norm(lhs - rhs) / np.linalg.norm(rhs)
    assert rel < 0.05


def test_mass_matrices_positive_and_total_area():
    V, F = icosphere(3)
    area = 0.5 * np.linalg.norm(
        np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]]), axis=1
    ).sum()
    for mass_fn in (mass_barycentric, mass_voronoi):
        M = mass_fn(V, F)
        d = M.diagonal()
        assert (d > 0).all()
        assert abs(d.sum() - area) / area < 1e-6


def test_point_cloud_laplacian():
    P = point_cloud(500, seed=1)
    S, M = point_cloud_laplacian(P, k=8)
    assert abs(S - S.T).max() < 1e-10
    assert np.abs(S @ np.ones(S.shape[0])).max() < 1e-8
    assert (M.diagonal() > 0).all()


def test_knn_undirected():
    P = point_cloud(200, seed=2)
    neigh = knn_undirected(P, 6)
    ii, jj = neighbors_to_edges(neigh)
    edges = set(zip(ii.tolist(), jj.tolist()))
    assert all((j, i) in edges for i, j in edges)
    assert (neigh >= 0).sum(axis=1).min() >= 6


def test_meshgen_shapes():
    V, F = grid_mesh(10, 12)
    assert V.shape == (120, 3) and F.shape == (2 * 9 * 11, 3)
    V, F = torus_mesh(16, 8)
    assert V.shape == (128, 3) and F.shape == (256, 3)
    assert F.max() < V.shape[0]


def test_normalizers():
    V, F = icosphere(2)
    Vn = normalize_area(2.5 * V + 1.0, F)
    from gravo_mg.utils.normalize import face_area

    assert abs(face_area(Vn, F).sum() - 1.0) < 1e-8
    assert np.abs(Vn.mean(axis=0)).max() < 1e-8
    Vb = normalize_bounding_box(V * 3)
    assert abs(np.abs(Vb).max() - 0.5) < 1e-8


def _nonmanifold_mesh():
    """Icosphere with a non-manifold fin (an edge with 3 incident faces),
    a T-junction vertex, a degenerate sliver face, and a duplicate face."""
    from gravo_mg.utils.meshgen import icosphere

    V, F = icosphere(3, bump=0.1)
    n = V.shape[0]
    # fin: new vertex glued onto an existing edge of face 0
    a, b, _ = F[0]
    fin_v = V.shape[0]
    V = np.vstack([V, [2.0, 0.0, 0.0]])
    F = np.vstack([F, [a, b, fin_v]])          # edge (a,b) now has 3 faces
    # sliver: nearly-collinear triangle
    sl = V.shape[0]
    V = np.vstack([V, V[a] + 1e-12 * (V[b] - V[a])])
    F = np.vstack([F, [a, sl, b]])
    # duplicate face
    F = np.vstack([F, F[1]])
    return V, F, n


def test_robust_laplacian_nonmanifold():
    """mesh_laplacian_robust handles fins/slivers/duplicates: finite PSD
    stiffness, positive mass (reference comparisons.py --robust via
    robust_laplacian.mesh_laplacian)."""
    from gravo_mg.utils.laplacian import mesh_laplacian_robust

    V, F, _ = _nonmanifold_mesh()
    S, M = mesh_laplacian_robust(V, F)
    assert np.isfinite(S.data).all()
    assert (M.diagonal() > 0).all()
    # PSD: smallest eigenvalue >= -tol (constant in nullspace)
    from scipy.sparse.linalg import eigsh

    lam = eigsh(S.astype(np.float64), k=1, which="SA",
                return_eigenvectors=False, tol=1e-6)
    assert lam[0] > -1e-8 * abs(S.diagonal()).max()
    # rows sum to ~0 (Laplacian property survives mollification)
    assert np.abs(np.asarray(S.sum(axis=1))).max() < 1e-9 * abs(S.data).max()


def test_robust_laplacian_solver_end_to_end():
    """A multigrid solve on the non-manifold mesh converges using the
    robust operators (the plain cotan path may produce invalid weights)."""
    from gravo_mg import MultigridSolver
    from gravo_mg.utils.laplacian import mesh_laplacian_robust
    from gravo_mg.utils.neighbors import neighbors_from_stiffness

    V, F, _ = _nonmanifold_mesh()
    S, M = mesh_laplacian_robust(V, F)
    neigh = neighbors_from_stiffness(S)
    solver = MultigridSolver(V, neigh, M, lower_bound=80)
    lhs = (M + 1e-3 * S).tocsr()
    rng = np.random.default_rng(0)
    rhs = M @ rng.standard_normal(V.shape[0])
    x = solver.solve(lhs, rhs)
    assert solver.residual(lhs, rhs, x) <= 1e-4


def test_robust_matches_cotan_on_clean_mesh():
    """On a clean manifold mesh the mollified operator reduces to the
    standard cotan Laplacian (delta -> 0)."""
    from gravo_mg.utils.laplacian import (
        cotan_laplacian, mesh_laplacian_robust,
    )
    from gravo_mg.utils.meshgen import icosphere

    V, F = icosphere(3)
    S0 = cotan_laplacian(V, F)
    S1, _ = mesh_laplacian_robust(V, F)
    diff = abs(S0 - S1).max()
    assert diff < 1e-6 * abs(S0.data).max()


def test_ply_roundtrip(tmp_path):
    """Binary PLY write -> read recovers vertices and faces; ascii and
    variable-count faces also parse (reference harness reads .ply via
    plyfile, experiments/python/util.py:5-27)."""
    from gravo_mg.utils.io import read_ply, read_pointcloud, write_ply
    from gravo_mg.utils.meshgen import icosphere

    V, F = icosphere(2)
    p = tmp_path / "mesh.ply"
    write_ply(V, p, faces=F)
    V2, F2 = read_ply(p)
    assert np.allclose(V2, V, atol=1e-6)
    assert (F2 == F).all()

    # point cloud (no faces)
    pc = tmp_path / "cloud.ply"
    write_ply(V, pc)
    assert np.allclose(read_pointcloud(pc), V, atol=1e-6)

    # ascii with extra vertex properties and a quad face
    pa = tmp_path / "ascii.ply"
    with open(pa, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment test\n")
        f.write("element vertex 4\n")
        f.write("property float x\nproperty float nx\nproperty float y\n"
                "property float z\n")
        f.write("element face 1\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        f.write("0 9 0 0\n1 9 0 0\n1 9 1 0\n0 9 1 0\n")
        f.write("4 0 1 2 3\n")
    Va, Fa = read_ply(pa)
    assert np.allclose(Va, [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    assert (Fa == [[0, 1, 2, 3]]).all()
