"""Direct and Krylov comparison solvers.

Capability parity with the reference's solverType 0/1 (Eigen/Pardiso
sparse factorizations, multigrid_solver.cpp:1287-1366) and solverType 4
(Eigen CG, :1453-1477).  The sparse factorization runs on host via
scipy/SuperLU (as the reference's ran on CPU via Eigen); CG runs on device
over the ELL SpMV.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse import ell_from_scipy, spmv


def _cholmod_factor():
    """CHOLMOD (scikit-sparse) if importable, else None.

    CHOLMOD's supernodal Cholesky with AMD/METIS ordering is the honest
    direct baseline for SPD mesh systems (SuperLU's ordering is ~5-10x
    slower at 1M vertices); it is optional in this image, so the import is
    gated and SuperLU remains the fallback.
    """
    try:
        from sksparse.cholmod import cholesky  # type: ignore

        return cholesky
    except Exception:  # noqa: BLE001 — any import/runtime failure -> fallback
        return None


def direct_solve(lhs_csr, rhs: np.ndarray, timing: Optional[dict] = None):
    """Host sparse direct factor+solve (CHOLMOD when available, SuperLU
    otherwise) — the reference's solverType 0/1 comparison column."""
    cholesky = _cholmod_factor()
    t0 = time.perf_counter()
    if cholesky is not None:
        try:
            factor = cholesky(lhs_csr.tocsc())
            solve_fn = factor
            backend = "cholmod"
        except Exception:  # not SPD — SuperLU handles indefinite systems
            cholesky = None
    if cholesky is None:
        from scipy.sparse.linalg import splu

        lu = splu(lhs_csr.tocsc())
        solve_fn = lu.solve
        backend = "superlu"
    t_factor = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    rhs = np.asarray(rhs)
    x = np.asarray(solve_fn(rhs))
    t_solve = (time.perf_counter() - t0) * 1000
    if timing is not None:
        timing["direct_factor"] = t_factor
        timing["direct_solve"] = t_solve
        timing["direct_backend"] = backend
    return x


def cg_solve(
    lhs_csr,
    rhs: np.ndarray,
    tol: float = 1e-4,
    max_iter: int = 10000,
    dtype=jnp.float32,
    jacobi_precond: bool = True,
):
    """Device-side (diagonally preconditioned) conjugate gradients: one
    ``jax.scipy.sparse.linalg.cg`` loop of up to ``max_iter`` iterations
    over the same ELL operator format the multigrid levels use."""
    A = ell_from_scipy(lhs_csr, dtype=dtype)
    b = jnp.asarray(rhs, dtype=dtype)
    dinv = 1.0 / np.maximum(np.asarray(lhs_csr.diagonal()), 1e-30)
    dinv = jnp.asarray(dinv, dtype=dtype)
    if b.ndim == 2:
        dinv_m = dinv[:, None]
    else:
        dinv_m = dinv
    Mop = (lambda v: dinv_m * v) if jacobi_precond else None
    x, _ = jax.scipy.sparse.linalg.cg(
        lambda v: spmv(A, v), b, tol=tol, maxiter=max_iter, M=Mop
    )
    return np.asarray(x)
