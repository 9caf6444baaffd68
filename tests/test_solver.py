"""Solver tests: smoothers, cycles, residual norms, end-to-end parity with
direct solves (SURVEY.md §4: cross-solver comparison as oracle)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from gravo_mg import CycleType, MultigridSolver, Smoother
from gravo_mg.solver.residual import residual_norm
from gravo_mg.solver.smoothers import chebyshev, estimate_lambda_max, jacobi
from gravo_mg.sparse import ell_from_scipy, spmv


def _system(mesh, tau=1e-3, poisson=False):
    S, M = mesh["S"], mesh["M"]
    if poisson:
        lhs = (1e-6 * M + S).tocsr()
    else:
        lhs = (M + tau * S).tocsr()
    rng = np.random.default_rng(42)
    rhs = M @ rng.standard_normal((S.shape[0], 1))
    return lhs, rhs


def test_jacobi_reduces_residual(sphere_mesh):
    lhs, rhs = _system(sphere_mesh)
    A = ell_from_scipy(lhs, dtype=jnp.float32)
    dinv = jnp.asarray(1.0 / lhs.diagonal(), dtype=jnp.float32)
    b = jnp.asarray(rhs[:, 0], dtype=jnp.float32)
    x0 = jnp.zeros_like(b)
    r0 = float(jnp.linalg.norm(b))
    x = jacobi(A, dinv, b, x0, 5)
    r = float(jnp.linalg.norm(b - spmv(A, x)))
    assert r < 0.5 * r0


def test_chebyshev_uniform_band_damping():
    """On a diagonal spectrum the smoothed error is p(lambda) * e0; the
    Chebyshev polynomial must damp the whole smoothing band uniformly,
    which fixed-omega Jacobi cannot (it leaves the band's lower edge
    undamped)."""
    from gravo_mg.solver.multigrid import SolverConfig

    ratio = SolverConfig().cheb_ratio
    lmax = 2.0
    lams = np.linspace(lmax / ratio, lmax, 200)
    A = sp.diags(lams).tocsr()
    E = ell_from_scipy(A, dtype=jnp.float64)
    ones = jnp.ones(len(lams), dtype=jnp.float64)
    b = jnp.zeros_like(ones)
    # Margin factors per degree: on the retuned ratio-12 band (r4) the
    # degree-2 polynomial's edge is only ~25% better than Jacobi's
    # (measured 0.585 vs 0.790); the advantage compounds with degree
    # (the default smoother runs degree 4, where it is >2x).
    for degree, factor in ((2, 0.8), (3, 0.65), (4, 0.5)):
        ec = chebyshev(E, ones, b, ones, degree, lmax / ratio, 1.1 * lmax)
        ej = jacobi(E, ones, b, ones, degree)
        worst_c = float(jnp.max(jnp.abs(ec)))
        worst_j = float(jnp.max(jnp.abs(ej)))
        assert worst_c < factor * worst_j, (degree, worst_c, worst_j)
    # Absolute bound at the default degree (4): the Chebyshev minimax
    # value on [lam/12, 1.1 lam] is 1/T4(1.164) ~= 0.206.
    assert worst_c < 0.25, worst_c


def test_lambda_max_estimate(sphere_mesh):
    lhs, _ = _system(sphere_mesh)
    A = ell_from_scipy(lhs, dtype=jnp.float64)
    dinv_np = 1.0 / lhs.diagonal()
    dinv = jnp.asarray(dinv_np)
    lam = float(estimate_lambda_max(A, dinv, iters=50))
    from scipy.sparse.linalg import eigs

    DinvA = sp.diags(dinv_np) @ lhs
    lam_ref = float(np.real(eigs(DinvA, k=1, which="LM", return_eigenvectors=False)[0]))
    assert abs(lam - lam_ref) / lam_ref < 0.05


def test_residual_norms_match_numpy(sphere_mesh):
    lhs, rhs = _system(sphere_mesh)
    M = sphere_mesh["M"]
    n = lhs.shape[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 2))
    b = rng.standard_normal((n, 2))
    A = ell_from_scipy(lhs, dtype=jnp.float64)
    Me = ell_from_scipy(M, dtype=jnp.float64)
    minv = jnp.asarray(1.0 / M.diagonal())
    r = lhs @ x - b
    refs = {
        0: max(
            np.linalg.norm(r[:, i]) / np.linalg.norm(b[:, i]) for i in range(2)
        ),
        1: max(
            np.sqrt(
                (r[:, i] * (1 / M.diagonal()) * r[:, i]).sum()
                / (b[:, i] * (1 / M.diagonal()) * b[:, i]).sum()
            )
            for i in range(2)
        ),
        2: max(
            np.sqrt(
                (r[:, i] @ (M @ r[:, i])) / (b[:, i] @ (M @ b[:, i]))
            )
            for i in range(2)
        ),
        3: np.linalg.norm(r),
    }
    for c, ref in refs.items():
        got = float(
            residual_norm(A, Me, minv, jnp.asarray(b), jnp.asarray(x), criteria=c)
        )
        assert abs(got - ref) / ref < 1e-8, c


@pytest.mark.parametrize("cycle", [CycleType.V, CycleType.F, CycleType.W])
def test_solve_smoothing_system(medium_mesh, cycle):
    lhs, rhs = _system(medium_mesh)
    solver = MultigridSolver(
        medium_mesh["V"], medium_mesh["neigh"], medium_mesh["M"],
        lower_bound=200, cycle_type=int(cycle),
    )
    x = solver.solve(lhs, rhs)
    assert solver.residual(lhs, rhs, x) <= 1e-4
    assert solver.solver_timing["iterations"] <= 40


def test_solve_poisson_system(medium_mesh):
    lhs, rhs = _system(medium_mesh, poisson=True)
    rhs = rhs - rhs.mean()  # compatible RHS for the near-singular system
    solver = MultigridSolver(
        medium_mesh["V"], medium_mesh["neigh"], medium_mesh["M"],
        lower_bound=200,
    )
    x = solver.solve(lhs, rhs)
    assert solver.residual(lhs, rhs, x) <= 1e-4


def test_solve_matches_direct(medium_mesh):
    lhs, rhs = _system(medium_mesh)
    solver = MultigridSolver(
        medium_mesh["V"], medium_mesh["neigh"], medium_mesh["M"],
        lower_bound=200, tolerance=1e-6,
    )
    x = solver.solve(lhs, rhs)
    xd = solver.direct_solve(lhs, rhs)
    rel = np.linalg.norm(x - xd) / np.linalg.norm(xd)
    assert rel < 1e-3


def test_solve_multi_rhs(medium_mesh):
    lhs, _ = _system(medium_mesh)
    rng = np.random.default_rng(1)
    rhs = medium_mesh["M"] @ rng.standard_normal((lhs.shape[0], 3))
    solver = MultigridSolver(
        medium_mesh["V"], medium_mesh["neigh"], medium_mesh["M"],
        lower_bound=200,
    )
    x = solver.solve(lhs, rhs)
    assert x.shape == rhs.shape
    assert solver.residual(lhs, rhs, x) <= 1e-4


def test_solve_fused_mode(medium_mesh):
    lhs, rhs = _system(medium_mesh)
    solver = MultigridSolver(
        medium_mesh["V"], medium_mesh["neigh"], medium_mesh["M"],
        lower_bound=200,
    )
    x = solver.solve(lhs, rhs, mode="fused")
    assert solver.residual(lhs, rhs, x) <= 1e-4
    assert len(solver.convergence) == int(solver.solver_timing["iterations"])


def test_solve_jacobi_smoother(medium_mesh):
    lhs, rhs = _system(medium_mesh)
    solver = MultigridSolver(
        medium_mesh["V"], medium_mesh["neigh"], medium_mesh["M"],
        lower_bound=200, smoother=Smoother.JACOBI,
    )
    x = solver.solve(lhs, rhs)
    assert solver.residual(lhs, rhs, x) <= 1e-4


def test_hierarchy_reuse_across_lhs(medium_mesh):
    """Same pattern, new values: reduction is redone, plans are reused."""
    solver = MultigridSolver(
        medium_mesh["V"], medium_mesh["neigh"], medium_mesh["M"],
        lower_bound=200,
    )
    for tau in (1e-3, 1e-2):
        lhs, rhs = _system(medium_mesh, tau=tau)
        x = solver.solve(lhs, rhs)
        assert solver.residual(lhs, rhs, x) <= 1e-4


def test_solve_sig06_hierarchy(medium_mesh):
    lhs, rhs = _system(medium_mesh)
    solver = MultigridSolver(
        medium_mesh["V"], medium_mesh["neigh"], medium_mesh["M"],
        lower_bound=200, sig06=True,
    )
    x = solver.solve(lhs, rhs)
    assert solver.residual(lhs, rhs, x) <= 1e-4


def test_solve_ablation_hierarchy(medium_mesh):
    lhs, rhs = _system(medium_mesh)
    solver = MultigridSolver(
        medium_mesh["V"], medium_mesh["neigh"], medium_mesh["M"],
        lower_bound=200, ablation=True, ablation_num_points=3,
    )
    x = solver.solve(lhs, rhs)
    assert solver.residual(lhs, rhs, x) <= 1e-4


def test_cg_solve(sphere_mesh):
    lhs, rhs = _system(sphere_mesh)
    solver = MultigridSolver(
        sphere_mesh["V"], sphere_mesh["neigh"], sphere_mesh["M"],
        lower_bound=80, tolerance=1e-6,
    )
    x = solver.cg_solve(lhs, rhs[:, 0])
    xd = solver.direct_solve(lhs, rhs[:, 0])
    assert np.linalg.norm(x - xd) / np.linalg.norm(xd) < 1e-2


def test_set_prolongation_matrices(sphere_mesh):
    lhs, rhs = _system(sphere_mesh)
    solver = MultigridSolver(
        sphere_mesh["V"], sphere_mesh["neigh"], sphere_mesh["M"],
        lower_bound=80,
    )
    Us = solver.prolongation_matrices
    solver.set_prolongation_matrices(Us)
    x = solver.solve(lhs, rhs)
    assert solver.residual(lhs, rhs, x) <= 1e-4


def test_timing_and_convergence_io(sphere_mesh, tmp_path):
    lhs, rhs = _system(sphere_mesh)
    solver = MultigridSolver(
        sphere_mesh["V"], sphere_mesh["neigh"], sphere_mesh["M"],
        lower_bound=80,
    )
    solver.solve(lhs, rhs)
    f1 = tmp_path / "hier.csv"
    f2 = tmp_path / "solver.csv"
    f3 = tmp_path / "conv.csv"
    solver.write_hierarchy_timing("exp", f1, write_headers=True)
    solver.write_solver_timing("exp", f2, write_headers=True)
    solver.write_convergence(f3)
    assert f1.read_text().startswith("experiment,")
    assert "iterations" in f2.read_text().splitlines()[0]
    lines = f3.read_text().splitlines()
    assert lines[0] == "time,residue"
    assert len(lines) == len(solver.convergence) + 1


def test_update_lhs_value_only_reuse(medium_mesh):
    """Same-pattern LHS refresh (the conformal-flow per-step workload,
    update_lhs must reuse every pattern artifact — device ELL index
    arrays and transfer operators — and only refill values; the
    refreshed context must solve the new system correctly."""
    import time as _time

    from gravo_mg import MultigridSolver

    V, M, S, neigh = (
        medium_mesh["V"], medium_mesh["M"], medium_mesh["S"],
        medium_mesh["neigh"],
    )
    rng = np.random.default_rng(3)
    rhs = M @ rng.standard_normal(V.shape[0])
    solver = MultigridSolver(V, neigh, M, lower_bound=200)
    lhs1 = (M + 1e-3 * S).tocsr()
    t0 = _time.perf_counter()
    ctx = solver._context(lhs1)
    t_setup = _time.perf_counter() - t0
    transfers_before = ctx.transfers
    idx_before = ctx._level_idx
    idx0_before = ctx.levels[0].A.indices
    x1, _, _, _ = ctx.solve(rhs, tol=1e-5, max_iter=50)

    lhs2 = (M + 2e-3 * S).tocsr()   # same sparsity, new values
    t0 = _time.perf_counter()
    ctx.update_lhs(lhs2)
    t_update = _time.perf_counter() - t0
    # pattern artifacts are reused by identity, not rebuilt
    assert ctx.transfers is transfers_before
    assert ctx._level_idx is idx_before
    assert ctx.levels[0].A.indices is idx0_before
    x2, _, res2, _ = ctx.solve(rhs, tol=1e-5, max_iter=50)
    assert ctx.residual(rhs, x2) <= 2e-5
    assert not np.allclose(x1, x2)  # genuinely a different system
    # The reuse guarantee is the identity asserts above (patterns,
    # layouts, transfers are the SAME objects).  At this mesh size the
    # value-dependent phase (Galerkin chain, spectral bounds, coarse
    # inverse, uploads) dominates both paths, so wall-clock comparison
    # is noise; just sanity-bound that update is not pathologically
    # slower than a fresh build.  (At 1M the skipped pattern work is
    # ~6 s — see bench.py's setup breakdown.)
    t0 = _time.perf_counter()
    solver._contexts.clear()
    solver._context(lhs2)
    t_fresh = _time.perf_counter() - t0
    # 2x: pure sanity — on the 2-core host a concurrent process can skew
    # either side by ~50%.
    assert t_update < 2.0 * max(t_fresh, t_setup), (t_update, t_fresh)


def test_prepare_async_dummy_call(medium_mesh, monkeypatch):
    """The background program preparation (dummy zero-solve that warms
    the pjit executable cache) must leave solve() results untouched and
    record no prepare errors."""
    monkeypatch.setenv("GRAVO_MG_FORCE_WARMUP", "1")
    lhs, rhs = _system(medium_mesh)
    solver = MultigridSolver(
        medium_mesh["V"], medium_mesh["neigh"], medium_mesh["M"],
        lower_bound=200,
    )
    x = solver.solve(lhs, rhs)            # traced path joins its prepare
    assert solver.residual(lhs, rhs, x) <= 1e-4
    x2 = solver.solve(lhs, rhs, mode="fused")
    assert solver.residual(lhs, rhs, x2) <= 1e-4
    ctx = next(iter(solver._contexts.values()))
    assert ctx._prepare_threads, "prepare threads never started"
    errs = [k for k in ctx.timing if k.startswith("prepare_error")]
    assert not errs, {k: ctx.timing[k] for k in errs}
