#!/usr/bin/env python
"""Chebyshev band / degree sweep for the V-cycle smoother.

Sweeps (cheb_ratio, pre/post degree) over the bench Poisson problem at a
configurable mesh size and reports cycles-to-tolerance plus a cost proxy
(cycles * fine-level A-applies per cycle), which is what actually
predicts wall-clock: a deeper smoother that saves too few cycles loses.

With --cpu it runs on the host, so it can execute alongside device
work; iteration counts are device-independent.

Usage: python experiments/tune_smoother.py [--nu 512 --nv 512] [--cpu]
"""

import argparse
import dataclasses
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nu", type=int, default=512)
    ap.add_argument("--nv", type=int, default=512)
    ap.add_argument("--cpu", action="store_true", default=True)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--ratios", type=float, nargs="+",
                    default=[2.5, 3.0, 4.0, 5.0, 6.0, 8.0])
    ap.add_argument("--degrees", type=int, nargs="+", default=[2, 3])
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from gravo_mg import MultigridSolver
    from gravo_mg.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg.utils.meshgen import torus_mesh
    from gravo_mg.utils.neighbors import neighbors_from_faces

    V, F = torus_mesh(args.nu, args.nv)
    n = V.shape[0]
    S = cotan_laplacian(V, F)
    M = mass_barycentric(V, F)
    neigh = neighbors_from_faces(F)
    lhs = (1e-6 * M + S).tocsr()
    rng = np.random.default_rng(42)
    rhs = (M @ rng.standard_normal((n, 1)))[:, 0]

    solver = MultigridSolver(V, neigh, M, lower_bound=1000)
    ctx = solver._context(lhs)
    log(f"n={n} dof={solver.hierarchy.dof}")

    base_cfg = ctx.cfg
    results = []
    for degree in args.degrees:
        for ratio in args.ratios:
            ctx.cfg = dataclasses.replace(
                base_cfg, cheb_ratio=ratio, pre_iters=degree,
                post_iters=degree,
            )
            t0 = time.perf_counter()
            _, iters, res, _ = ctx.solve(
                rhs, tol=args.tol, criteria=2, max_iter=60, mode="fused"
            )
            dt = time.perf_counter() - t0
            # cost proxy: fine A-applies per cycle = pre + post + 1
            # (in-cycle residual) + ~1.1 (criteria-2 check + transfers),
            # times the ~1.16 geometric factor for coarser levels.
            cost = iters * (2 * degree + 2.1)
            results.append((ratio, degree, iters, res, cost, dt))
            log(
                f"ratio={ratio:4.1f} degree={degree} -> iters={iters:3d} "
                f"res={res:.2e} cost={cost:6.1f} ({dt:.1f}s)"
            )
    ctx.cfg = base_cfg
    best = min(results, key=lambda r: r[4])
    log(f"best: ratio={best[0]} degree={best[1]} iters={best[2]} "
        f"cost={best[4]:.1f}")


if __name__ == "__main__":
    main()
