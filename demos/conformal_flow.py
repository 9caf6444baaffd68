#!/usr/bin/env python
"""Conformal / mean-curvature flow demo (reference: demos/conformal_flow.py).

Iterates ``(M_t + tau*S) V_{t+1} = M_t V_t`` with the mass matrix rebuilt
every step and the surface renormalized to unit area (Kazhdan et al.'s
conformalized MCF uses the *initial* stiffness throughout, which is what
the reference does too).  The multigrid hierarchy is reused across steps;
only the Galerkin reduction reruns per step (same sparsity).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", type=str, default=None)
    ap.add_argument("--tau", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", type=str, default="/tmp/flow")
    ap.add_argument("--robust", action="store_true",
                    help="non-manifold input: mollified robust Laplacian "
                         "(reference demos/conformal_flow.py:18-30 uses "
                         "robust_laplacian.mesh_laplacian here)")
    args = ap.parse_args()

    from demos.smoothing import load_or_generate, save_obj

    from gravo_mg import MultigridSolver
    from gravo_mg.utils.laplacian import (
        cotan_laplacian,
        mass_voronoi,
        mesh_laplacian_robust,
    )
    from gravo_mg.utils.neighbors import neighbors_from_faces
    from gravo_mg.utils.normalize import normalize_area

    V, F = load_or_generate(args.input)
    V = normalize_area(V, F)

    def operators(V):
        if args.robust:
            return mesh_laplacian_robust(V, F)
        return cotan_laplacian(V, F), mass_voronoi(V, F)

    S, M = operators(V)  # initial stiffness, kept fixed (cMCF)
    neigh = neighbors_from_faces(F)
    solver = MultigridSolver(V, neigh, M)

    for step in range(args.steps):
        M = operators(V)[1]
        solver._contexts.clear()
        solver.mass = M.tocsr()
        lhs = (M + args.tau * S).tocsr()
        V = solver.solve(lhs, M @ V)
        V = normalize_area(V, F)
        print(
            f"step {step}: {solver.solver_timing['iterations']:.0f} cycles, "
            f"residual {solver.solver_timing['residue']:.2e}"
        )
        save_obj(f"{args.out}_{step:03d}.obj", V, F)
    print(f"wrote {args.out}_*.obj")


if __name__ == "__main__":
    main()
