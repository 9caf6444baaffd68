"""SIG21-style decimation hierarchy tests."""

import numpy as np
import pytest

from gravo_mg import Hierarchy, MultigridSolver
from gravo_mg.hierarchy.sig21 import build_sig21_hierarchy


def test_sig21_build(sphere_mesh):
    h = build_sig21_hierarchy(
        sphere_mesh["V"], sphere_mesh["F"], min_coarsest=100
    )
    assert h.num_levels >= 1
    # coarsening close to the 0.25 ratio (the last level may stop early
    # at the min_coarsest floor)
    for k in range(h.num_levels):
        rate = h.dof[k + 1] / h.dof[k]
        floor = max(100 / h.dof[k], 0.2)
        assert 0.2 < rate <= max(0.6, floor * 1.1), h.dof
    for lvl in h.levels:
        U = lvl.U.to_scipy()
        rs = np.asarray(U.sum(axis=1)).ravel()
        assert np.allclose(rs, 1.0, atol=1e-6)
        assert U.data.min() >= -1e-9
        assert np.diff(U.indptr).max() <= 3


def test_sig21_through_solver(sphere_mesh):
    V, F, S, M = (
        sphere_mesh["V"], sphere_mesh["F"], sphere_mesh["S"], sphere_mesh["M"]
    )
    neigh = sphere_mesh["neigh"]
    lhs = (M + 1e-3 * S).tocsr()
    rng = np.random.default_rng(0)
    rhs = M @ rng.standard_normal((V.shape[0], 1))
    solver = MultigridSolver(V, neigh, M, lower_bound=100)
    solver.construct_sig21_hierarchy(F)
    solver.toggle_hierarchy(Hierarchy.SIG21)
    x = solver.solve(lhs, rhs)
    assert solver.residual(lhs, rhs, x) <= 1e-4
    # and back to ours
    solver.toggle_hierarchy(Hierarchy.OURS)
    x2 = solver.solve(lhs, rhs)
    assert solver.residual(lhs, rhs, x2) <= 1e-4


@pytest.mark.parametrize("dec_type", [0, 2])  # qslim, vertex removal
def test_sig21_decimation_strategies(sphere_mesh, dec_type):
    h = build_sig21_hierarchy(
        sphere_mesh["V"], sphere_mesh["F"], min_coarsest=100,
        dec_type=dec_type,
    )
    assert h.num_levels >= 1
    assert h.dof[-1] < h.dof[0]
    for lvl in h.levels:
        U = lvl.U.to_scipy()
        rs = np.asarray(U.sum(axis=1)).ravel()
        assert np.allclose(rs, 1.0, atol=1e-6)
        assert np.diff(U.indptr).max() <= 3
    # vertex removal keeps surviving vertices in place
    if dec_type == 2:
        Vc = h.levels[0].coarse_points
        keep = h.levels[0].samples
        assert np.allclose(Vc, np.asarray(sphere_mesh["V"])[keep])


def test_sig21_block_prolongations(sphere_mesh):
    from gravo_mg.hierarchy.sig21 import block_prolongations

    h = build_sig21_hierarchy(
        sphere_mesh["V"], sphere_mesh["F"], min_coarsest=100
    )
    blocks = block_prolongations(h, dim=3)
    for lvl, B in zip(h.levels, blocks):
        U = lvl.U.to_scipy()
        assert B.shape == (3 * U.shape[0], 3 * U.shape[1])
        # interleaved structure: B[3i+c, 3j+c] == U[i, j]
        i = U.shape[0] // 2
        j = U.indices[U.indptr[i]]
        for c in range(3):
            assert abs(B[3 * i + c, 3 * j + c] - U[i, j]) < 1e-12


def test_sig21_iters_close_to_ours(medium_mesh):
    """The intrinsic-prolongation hierarchy should converge at a rate
    comparable to OURS (the paper's qualitative relationship): iteration
    counts within 1.5x at tol 1e-6."""
    V, F, S, M = (
        medium_mesh["V"], medium_mesh["F"], medium_mesh["S"], medium_mesh["M"]
    )
    neigh = medium_mesh["neigh"]
    lhs = (M + 1e-3 * S).tocsr()
    rng = np.random.default_rng(0)
    rhs = M @ rng.standard_normal(V.shape[0])
    solver = MultigridSolver(
        V, neigh, M, lower_bound=500, tolerance=1e-6, max_iter=60
    )
    solver.solve(lhs, rhs)
    it_ours = solver.solver_timing["iterations"]
    solver.construct_sig21_hierarchy(F)
    solver.toggle_hierarchy(Hierarchy.SIG21)
    solver.solve(lhs, rhs)
    it_sig21 = solver.solver_timing["iterations"]
    assert it_sig21 <= 1.5 * it_ours + 1, (it_sig21, it_ours)


def test_sig21_identity_rows_for_survivors(sphere_mesh):
    """Surviving vertices prolong as exact delta rows (reference
    get_prolong.cpp: replayed points that never leave their vertex)."""
    h = build_sig21_hierarchy(
        sphere_mesh["V"], sphere_mesh["F"], min_coarsest=100
    )
    lvl = h.levels[0]
    U = lvl.U.to_scipy().tocsr()
    keep = lvl.samples
    remap = -np.ones(h.dof[0], dtype=np.int64)
    remap[keep] = np.arange(len(keep))
    for i in keep[:50]:
        row = U.getrow(int(i))
        nz = row.data[np.abs(row.data) > 1e-12]
        assert len(nz) == 1 and abs(nz[0] - 1.0) < 1e-12
        assert row.indices[np.abs(row.data) > 1e-12][0] == remap[i]


def test_sig21_qslim_beats_midpoint_geometry(sphere_mesh):
    """QSLIM's optimal placement should reconstruct the fine geometry at
    least as well as midpoint collapse (quality ordering sanity)."""
    V = np.asarray(sphere_mesh["V"])
    errs = {}
    for dec in (0, 1):
        h = build_sig21_hierarchy(
            V, sphere_mesh["F"], min_coarsest=300, max_levels=1, dec_type=dec
        )
        lvl = h.levels[0]
        U = lvl.U.to_scipy()
        recon = U @ lvl.coarse_points
        errs[dec] = float(np.linalg.norm(recon - V, axis=1).mean())
    assert errs[0] <= errs[1] * 1.05, errs
