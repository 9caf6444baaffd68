#!/usr/bin/env python
"""Validate smoother retuning + upload-excluded timing at 1M on the device.

Solves the bench Poisson system with several (degree, cheb_ratio)
configs and reports warm fused solve time, iterations, and the verified
host residual.  Each config is its own fused compile (persistent-cached
across runs).
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
    ap.add_argument("--nu", type=int, default=1024)
    ap.add_argument("--nv", type=int, default=1024)
    ap.add_argument("--configs", type=str,
                    default="2:4,2:12,3:12,4:12,4:16")
    args = ap.parse_args()

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
    log(f"dof: {solver.hierarchy.dof}")
    base = ctx.cfg

    for spec in args.configs.split(","):
        deg, ratio = spec.split(":")
        ctx.cfg = dataclasses.replace(
            base, pre_iters=int(deg), post_iters=int(deg),
            cheb_ratio=float(ratio),
        )
        t0 = time.perf_counter()
        ctx.solve(rhs, tol=1e-4, criteria=2, max_iter=100, mode="fused")
        cold = time.perf_counter() - t0
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            x, iters, res, _ = ctx.solve(
                rhs, tol=1e-4, criteria=2, max_iter=100, mode="fused"
            )
            dt = time.perf_counter() - t0
            if best is None or dt < best[0]:
                best = (dt, iters, res, x)
        dt, iters, res, x = best
        true_res = ctx.residual(rhs, x, criteria=2)
        log(
            f"deg={deg} ratio={ratio:>4}: warm {dt*1e3:7.1f} ms "
            f"(cycles {ctx.timing['cycles']:7.1f} ms, "
            f"upload {ctx.timing['solve_upload']:6.1f} ms) "
            f"iters={iters:3d} res={res:.2e} host_res={true_res:.2e} "
            f"[cold {cold:.1f}s]"
        )
    ctx.cfg = base


if __name__ == "__main__":
    main()
