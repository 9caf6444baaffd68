"""gravo_mg — geometric multigrid on JAX/XLA (Gravo MG capabilities).

A from-scratch JAX/XLA reimplementation of the capabilities of
Gravo MG ("A Fast Geometric Multigrid Method for Curved Surfaces",
SIGGRAPH 2023; reference C++ at rubenwiersma/gravo_mg): fast solvers for
sparse SPD systems on triangle meshes and point clouds via graph-Voronoi
coarsening hierarchies and smoothed multigrid cycles.

Public API parity with the reference package::

    from gravo_mg import MultigridSolver, Hierarchy, Sampling, Weighting
    solver = MultigridSolver(pos, neigh, mass)
    x = solver.solve(lhs, rhs)
"""

import os

import jax as _jax

# Persistent XLA compilation cache.  Where JAX_COMPILATION_CACHE_DIR is set,
# jax reads it and nothing is set here; otherwise the cache lives at a fixed
# path inside the checkout, so every process of the checkout shares it.
if not _jax.config.jax_compilation_cache_dir:
    _jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".jax_cache"),
    )

# x64 mode: the compute path stays f32 (explicit dtypes everywhere), but the
# Galerkin chain / coarse factor run in f64 to keep near-singular systems
# (Poisson eta=1e-6) solvable — the reference is all-f64 Eigen.
_jax.config.update("jax_enable_x64", True)

from .enums import CycleType, Hierarchy, Sampling, Smoother, Weighting  # noqa: E402
from .core import MultigridSolver  # noqa: E402
from .sparse import EllMatrix, Prolongation, ell_from_scipy, spmv  # noqa: E402
from .hierarchy.builder import build_hierarchy  # noqa: E402
from .solver.min_quad import MinQuadWithFixedMG  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "MultigridSolver",
    "Hierarchy",
    "Sampling",
    "Weighting",
    "CycleType",
    "Smoother",
    "EllMatrix",
    "Prolongation",
    "ell_from_scipy",
    "spmv",
    "build_hierarchy",
    "MinQuadWithFixedMG",
    "__version__",
]
