"""Tests that need an NVIDIA GPU.  Run on the card with

    python -m pytest -m gpu

Elsewhere each test skips through the ``gpu_device`` fixture (conftest.py).
They check what only the card can show: the compiled SpMV and transfer
formats against scipy, and that the coarse solve's f32 products keep full
f32 accuracy (no TF32) on the device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gravo_mg import MultigridSolver
from gravo_mg.solver.multigrid import _coarse_solve
from gravo_mg.sparse import ell_from_scipy, spmv

pytestmark = pytest.mark.gpu


def _torus(nu):
    from gravo_mg.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg.utils.meshgen import torus_mesh
    from gravo_mg.utils.neighbors import neighbors_from_faces

    V, F = torus_mesh(nu, nu)
    return V, cotan_laplacian(V, F), mass_barycentric(V, F), \
        neighbors_from_faces(F)


def test_ell_spmv_on_card(gpu_device):
    V, S, M, _ = _torus(512)
    A = (1e-6 * M + S).tocsr()
    x = np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32)
    y = np.asarray(jax.jit(spmv)(ell_from_scipy(A), jnp.asarray(x)))
    x64 = x.astype(np.float64)
    assert np.all(np.abs(y - A @ x64) <= 1e-5 * (abs(A) @ np.abs(x64)))


def test_coarse_solve_full_f32_on_card(gpu_device):
    """A 300-row SPD inverse apply must match the f64 evaluation of the
    same formula to 1e-5 of |Ainv| |rhs|, which TF32 products miss."""
    rng = np.random.default_rng(1)
    B = rng.standard_normal((300, 300))
    Ad = B @ B.T / 300 + np.eye(300)
    Ainv = np.linalg.inv(Ad)
    A32, D32 = Ainv.astype(np.float32), Ad.astype(np.float32)
    rc = rng.standard_normal((300, 3)).astype(np.float32)
    got = np.asarray(jax.jit(_coarse_solve, static_argnums=2)(
        (jnp.asarray(A32), jnp.asarray(D32)), jnp.asarray(rc), False))
    A, D, r = (a.astype(np.float64) for a in (A32, D32, rc))
    e = A @ r
    e = e + A @ (r - D @ e)
    assert np.all(np.abs(got - e) <= 1e-5 * (np.abs(A) @ np.abs(r)))


def test_poisson_solve_on_card(gpu_device):
    V, S, M, neigh = _torus(256)
    lhs = (1e-6 * M + S).tocsr()
    rhs = M @ np.random.default_rng(2).standard_normal(V.shape[0])
    solver = MultigridSolver(V, neigh, M, lower_bound=1000)
    for mode in ("traced", "fused"):
        x = solver.solve(lhs, rhs, mode=mode)
        assert solver.residual(lhs, rhs, x) <= 1e-4
