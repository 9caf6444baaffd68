"""Near-singular handling: detection, deflation, coarse nullspace fix.

Regression tests for the f32-viability machinery (see
solver/multigrid.py SolverConfig.precise_galerkin and solve() docs): the
paper's Poisson config (eta*M + S, eta=1e-6) has solutions with O(1/eta)
constant components that naive f32 cycles cannot even evaluate residuals
for."""

import numpy as np
import pytest

from gravo_mg import MultigridSolver
from gravo_mg.solver.multigrid import MultigridSolveContext, SolverConfig


def _ctx(mesh, lhs):
    solver = MultigridSolver(
        mesh["V"], mesh["neigh"], mesh["M"], lower_bound=80
    )
    return solver, solver._context(lhs)


def test_near_singular_detection(sphere_mesh):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    _, ctx_p = _ctx(sphere_mesh, (1e-6 * M + S).tocsr())
    assert ctx_p.near_singular
    _, ctx_s = _ctx(sphere_mesh, (M + 1e-3 * S).tocsr())
    assert not ctx_s.near_singular


def test_poisson_solution_mean_is_exact(sphere_mesh):
    """The deflated constant component alpha = sum(b)/sum(A@1) must appear
    exactly in the returned solution."""
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    lhs = (1e-6 * M + S).tocsr()
    rng = np.random.default_rng(1)
    rhs = (M @ rng.standard_normal((S.shape[0], 1)))[:, 0]
    solver, ctx = _ctx(sphere_mesh, lhs)
    x, iters, res, _ = ctx.solve(rhs, tol=1e-4)
    assert res <= 1e-4
    # residual verified in f64 on the host against the raw system
    assert solver.residual(lhs, rhs, x) <= 2e-4
    # solution magnitude is O(1/eta): the f32 cycle alone could not
    # produce this; the deflation must have
    assert np.abs(x).max() > 1e2


def test_poisson_multi_rhs_deflation(sphere_mesh):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    lhs = (1e-6 * M + S).tocsr()
    rng = np.random.default_rng(2)
    rhs = M @ rng.standard_normal((S.shape[0], 3))
    solver, ctx = _ctx(sphere_mesh, lhs)
    x, iters, res, _ = ctx.solve(rhs, tol=1e-4)
    assert res <= 1e-4
    assert solver.residual(lhs, rhs, x) <= 2e-4


def test_poisson_warm_start(sphere_mesh):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    lhs = (1e-6 * M + S).tocsr()
    rng = np.random.default_rng(3)
    rhs = (M @ rng.standard_normal((S.shape[0], 1)))[:, 0]
    solver, ctx = _ctx(sphere_mesh, lhs)
    x1, _, _, _ = ctx.solve(rhs, tol=1e-4)
    x2, iters2, res2, _ = ctx.solve(rhs, x0=x1, tol=1e-4)
    assert iters2 <= 2
    assert res2 <= 1e-4


def test_fused_matches_traced_poisson(sphere_mesh):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    lhs = (1e-6 * M + S).tocsr()
    rng = np.random.default_rng(4)
    rhs = (M @ rng.standard_normal((S.shape[0], 1)))[:, 0]
    solver, ctx = _ctx(sphere_mesh, lhs)
    x_t, it_t, res_t, _ = ctx.solve(rhs, tol=1e-4, mode="traced")
    x_f, it_f, res_f, _ = ctx.solve(rhs, tol=1e-4, mode="fused")
    assert it_t == it_f
    assert abs(res_t - res_f) < 1e-6
    assert np.allclose(x_t, x_f, rtol=1e-4, atol=1e-4 * np.abs(x_t).max())


def test_deflation_survives_mesh_rescaling(sphere_mesh):
    """Regression (round-5 comparison suite): on area-normalized / tiny
    meshes, ``denom = eta * total_area`` fell below the old absolute
    deflation gate, silently disabling deflation while the coarse
    nullspace projection stayed on — the constant solution component
    became unreachable and every hierarchy stalled at ~1e-3.  The gate
    is now scale-free (sign-coherence of the row sums), so a mesh scaled
    by 1e-3 must converge identically."""
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    # s chosen so denom = eta*area*s^2 falls below the OLD absolute gate
    # (1e-12 * mean|diag| * n ~ 1.3e-8 here) while the deflated system
    # stays within f32's intrinsic accuracy (alpha grows 1/s^2; far
    # smaller scales need the dtype=f64 path).
    s = 0.03
    V2 = sphere_mesh["V"] * s
    S2 = S.copy()                 # cotan Laplacian is scale-invariant
    M2 = (M * (s * s)).tocsr()    # mass scales with area
    lhs = (1e-6 * M2 + S2).tocsr()
    rng = np.random.default_rng(5)
    rhs = (M2 @ rng.standard_normal((S.shape[0], 1)))[:, 0]
    solver = MultigridSolver(
        V2, sphere_mesh["neigh"], M2, lower_bound=150, max_iter=30,
    )
    x = solver.solve(lhs, rhs)
    assert solver.solver_timing["iterations"] < 25
    assert solver.residual(lhs, rhs, x) <= 1e-4


def test_deflation_alpha_rejects_roundoff_rowsums():
    """Sign-incoherent (roundoff-noise) row sums must NOT deflate —
    dividing by their near-cancelling sum would produce huge alphas."""
    from gravo_mg.solver.multigrid import deflation_alpha

    rng = np.random.default_rng(0)
    noise = rng.standard_normal(10000) * 1e-16
    b = rng.standard_normal((10000, 2))
    assert np.all(deflation_alpha(noise, b) == 0.0)
    genuine = np.full(10000, 1e-12)   # tiny but sign-coherent
    a = deflation_alpha(genuine, b)
    np.testing.assert_allclose(a, b.sum(axis=0) / genuine.sum())
