#!/usr/bin/env python
"""Point-cloud flow demo (reference: demos/conformal_flow_pointcloud.py).

Same implicit flow but on a raw point cloud: the Laplacian comes from
``point_cloud_laplacian`` (kNN graph) and the solver's neighborhoods from
the stiffness sparsity — no faces anywhere.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--tau", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", type=str, default="/tmp/pc_flow")
    args = ap.parse_args()

    from gravo_mg import MultigridSolver
    from gravo_mg.utils.laplacian import point_cloud_laplacian
    from gravo_mg.utils.meshgen import point_cloud
    from gravo_mg.utils.neighbors import neighbors_from_stiffness
    from gravo_mg.utils.normalize import normalize_bounding_box

    P = normalize_bounding_box(point_cloud(args.n, seed=3))
    print(f"point cloud: {P.shape[0]} points")

    for step in range(args.steps):
        S, M = point_cloud_laplacian(P)
        neigh = neighbors_from_stiffness(S)
        solver = MultigridSolver(P, neigh, M)
        lhs = (M + args.tau * S).tocsr()
        P = solver.solve(lhs, M @ P)
        P = normalize_bounding_box(P)
        print(
            f"step {step}: dof={solver.hierarchy.dof} "
            f"{solver.solver_timing['iterations']:.0f} cycles, "
            f"residual {solver.solver_timing['residue']:.2e}"
        )
        np.save(f"{args.out}_{step:03d}.npy", P)
    print(f"wrote {args.out}_*.npy")


if __name__ == "__main__":
    main()
