"""Parallel smoothers.

The reference smooths with serial forward Gauss-Seidel
(`GaussSeidelSmoother`, gravomg/src/multigrid_solver.cpp:1194-1226), which
is inherently sequential (each row update reads the rows before it).  On
an accelerator the same role — cheap damping of high-frequency error between grid
transfers — is filled by damped Jacobi and Chebyshev-accelerated Jacobi,
the standard parallel-MG substitution (see PAPERS.md polynomial-smoother
references).  Both are a handful of ELL SpMVs: fully vectorized, fully
jittable, multi-RHS for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..sparse import EllMatrix, spmv


def jacobi(A: EllMatrix, diag_inv, b, x, iters: int, omega: float = 2.0 / 3.0):
    """Damped Jacobi: x += omega * D^-1 (b - A x), ``iters`` times."""
    dinv = diag_inv[:, None] if b.ndim == 2 else diag_inv
    for _ in range(iters):
        x = x + omega * dinv * (b - spmv(A, x))
    return x


def chebyshev(A, diag_inv, b, x, degree: int, lam_min, lam_max):
    """Chebyshev polynomial smoother on D^-1 A over [lam_min, lam_max].

    Standard three-term recurrence (Saad, Iterative Methods, alg. 12.1);
    equivalent to ``degree`` optimally-weighted Jacobi sweeps targeting the
    high-frequency band.  lam_min/lam_max may be traced scalars.

    ``A`` may be any container ``spmv`` dispatches on, or a callable
    ``v -> A @ v`` (used by the distributed halo-exchange path, where the
    operator application includes a ppermute boundary exchange).
    """
    apply_A = A if callable(A) else (lambda v: spmv(A, v))
    dinv = diag_inv[:, None] if b.ndim == 2 else diag_inv
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    d = (1.0 / theta) * dinv * (b - apply_A(x))
    x = x + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = b - apply_A(x)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * dinv * r
        x = x + d
        rho = rho_new
    return x


def estimate_lambda_max(A, diag_inv, iters: int = 15, seed: int = 0):
    """Spectral radius of D^-1 A by power iteration (device-side).

    Replaces the role of knowing Gauss-Seidel needs no tuning: Chebyshev
    needs the smoothing interval.  Deterministic given ``seed``.
    Accepts any container ``spmv`` dispatches on (EllMatrix/ShuffleEll).
    """
    n = A.shape[0]
    dtype = diag_inv.dtype
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=dtype)

    def body(_, carry):
        v, _ = carry
        w = diag_inv * spmv(A, v)
        nrm = jnp.linalg.norm(w)
        return w / jnp.maximum(nrm, 1e-30), nrm

    init = (v / jnp.linalg.norm(v), jnp.ones((), dtype=dtype))
    v, lam = jax.lax.fori_loop(0, iters, body, init)
    return lam
