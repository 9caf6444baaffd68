"""Constrained quadratic MG solve (min_quad_with_fixed parity).

Oracle: scipy spsolve of the reduced system — the same check the
reference's sig21 subsystem admits (min_quad_with_fixed_mg.cpp solves
A_uu x_u = B_u - A_uk Y and stops on absolute l2 residual).
"""

import numpy as np
import scipy.sparse.linalg as spla

from gravo_mg import MinQuadWithFixedMG, MultigridSolver
from gravo_mg.utils.laplacian import cotan_laplacian, mass_voronoi
from gravo_mg.utils.meshgen import icosphere
from gravo_mg.utils.neighbors import neighbors_from_faces


def _setup(subdiv=4, lower_bound=120, **kw):
    V, F = icosphere(subdiv, bump=0.15)
    S = cotan_laplacian(V, F)
    M = mass_voronoi(V, F)
    neigh = neighbors_from_faces(F)
    solver = MultigridSolver(V, neigh, M, lower_bound=lower_bound, **kw)
    return V, S, M, solver


def test_min_quad_matches_direct():
    # f64 compute to support the 5e-6 absolute tolerance — the reference
    # subsystem is double-precision throughout (min_quad_with_fixed_mg.cpp);
    # f32 smoother noise floors out around ~5e-6 on this problem.
    import jax.numpy as jnp

    V, S, M, solver = _setup(dtype=jnp.float64)
    n = V.shape[0]
    rng = np.random.default_rng(3)
    known = rng.choice(n, size=n // 20, replace=False)
    Y = rng.standard_normal(known.size)
    lhs = (S + 1e-3 * M).tocsr()  # SPD, nonsingular after pinning
    B = M @ rng.standard_normal(n)

    mq = MinQuadWithFixedMG(solver, lhs, known, tol=5e-6, max_iter=60)
    x, iters, res, conv = mq.solve(B, Y)

    assert np.allclose(x[known], Y)
    # Oracle: direct solve of the reduced system.
    unknown = mq.unknown
    A_uu = lhs[unknown][:, unknown]
    rhs_u = B[unknown] - lhs[unknown][:, known] @ Y
    x_ref = spla.spsolve(A_uu.tocsc(), rhs_u)
    err = np.linalg.norm(x[unknown] - x_ref) / np.linalg.norm(x_ref)
    assert err < 1e-4, f"relative error {err:.2e} after {iters} cycles"
    assert res <= 5e-6


def test_min_quad_default_tolerance_and_trace():
    V, S, M, solver = _setup(subdiv=3, lower_bound=80)
    n = V.shape[0]
    rng = np.random.default_rng(7)
    known = np.arange(0, n, 37)
    Y = np.sin(V[known, 0] * 3.0)
    lhs = (S + 1e-2 * M).tocsr()
    B = np.zeros(n)

    mq = MinQuadWithFixedMG(solver, lhs, known)  # tol 1e-3, 20 iters
    x, iters, res, conv = mq.solve(B, Y)
    assert iters <= 20
    assert res <= 1e-3
    assert len(conv) == iters
    # Laplace interpolation stays within the data range (maximum principle,
    # loose check).
    assert x.min() >= Y.min() - 0.2 and x.max() <= Y.max() + 0.2


def test_min_quad_multi_rhs():
    import jax.numpy as jnp

    V, S, M, solver = _setup(subdiv=3, lower_bound=80, dtype=jnp.float64)
    n = V.shape[0]
    rng = np.random.default_rng(11)
    known = rng.choice(n, size=25, replace=False)
    Y = rng.standard_normal((known.size, 3))
    lhs = (S + 1e-3 * M).tocsr()
    B = M @ rng.standard_normal((n, 3))

    mq = MinQuadWithFixedMG(solver, lhs, known, tol=5e-6, max_iter=60)
    x, iters, res, _ = mq.solve(B, Y)
    assert x.shape == (n, 3)
    assert np.allclose(x[known], Y)
    unknown = mq.unknown
    x_ref = spla.spsolve(
        lhs[unknown][:, unknown].tocsc(),
        B[unknown] - lhs[unknown][:, known] @ Y,
    )
    err = np.linalg.norm(x[unknown] - x_ref) / np.linalg.norm(x_ref)
    assert err < 1e-4
