"""End-to-end float64 solve path: the reference convergence-plot protocol
iterates to tol 1e-12 (experiments/table_scripts/convergence_plots.sh),
which is far below the f32 residual floor — dtype=float64 runs smoother,
transfers and residual in f64 (scoped to small/medium meshes)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gravo_mg import MultigridSolver
from gravo_mg.utils.laplacian import cotan_laplacian, mass_barycentric
from gravo_mg.utils.meshgen import torus_mesh
from gravo_mg.utils.neighbors import neighbors_from_faces


@pytest.fixture(scope="module")
def torus_50k():
    V, F = torus_mesh(224, 224)  # 50176 vertices
    S = cotan_laplacian(V, F)
    M = mass_barycentric(V, F)
    neigh = neighbors_from_faces(F)
    return V, F, S, M, neigh


def test_f64_smoothing_converges_to_1e12(torus_50k):
    V, F, S, M, neigh = torus_50k
    n = V.shape[0]
    solver = MultigridSolver(
        V, neigh, M, lower_bound=500, tolerance=1e-12, dtype=jnp.float64
    )
    lhs = (M + 1e-3 * S).tocsr()
    rng = np.random.default_rng(0)
    rhs = M @ rng.standard_normal(n)
    x = solver.solve(lhs, rhs)
    iters = solver.solver_timing["iterations"]
    # Host-side f64 residual of the original system confirms the device
    # criterion wasn't flattering itself.
    res = solver.residual(lhs, rhs, x)
    assert res < 1e-12
    assert iters <= 40, f"1e-12 took {iters} cycles (expected <= 40)"


def test_f64_near_singular_poisson(torus_50k):
    """Deflation + f64 + coarse null-projection handle the near-singular
    Poisson system (eta*M + S, eta=1e-6) at tight tolerance.

    The device criterion runs on the exactly-deflated system and reaches
    1e-10.  The ORIGINAL system's residual cannot be evaluated much below
    ~1e-8 in f64 at all: the solution carries an O(1/eta)-magnitude
    constant component, so computing ``A @ x - b`` cancels ~1e4-sized
    terms to ~1e-12 absolute — an evaluation floor, not a solver stall.
    """
    V, F, S, M, neigh = torus_50k
    n = V.shape[0]
    solver = MultigridSolver(
        V, neigh, M, lower_bound=500, tolerance=1e-10, dtype=jnp.float64
    )
    lhs = (1e-6 * M + S).tocsr()
    rng = np.random.default_rng(1)
    rhs = M @ rng.standard_normal(n)
    ctx = solver._context(lhs)
    x, iters, res, _ = ctx.solve(rhs, tol=1e-10, max_iter=60)
    assert res < 1e-10            # deflated-system residual (device, f64)
    assert iters <= 50
    assert solver.residual(lhs, rhs, x) < 5e-8  # original: f64 eval floor
