#!/usr/bin/env python
"""On-card smoke test of the multigrid solve path (NVIDIA GPU).

Run from the repository root:

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the row-partitioned halo solver

One card: the 1,048,576-vertex Poisson torus (``lhs = 1e-6 M + S``,
tolerance 1e-4 in the M-norm, ``lower_bound=1000``) through the public
``MultigridSolver.solve`` in both modes, every level operator, transfer and
the coarse solve compared on the device against scipy/numpy in f64, a
3-right-hand-side smoothing solve on the same pattern, and a 65k-vertex
solve compared with a sparse direct solve.

Four cards: a 4,194,304-vertex Poisson torus solved by ``HaloContext`` on a
4-device ``rows`` mesh, compared with the one-card solve on device 0.

Every phase raises on failure; nothing is caught.  The last line of
standard output is one JSON object, ``{"ok": true, "device": {...}}``,
printed only when every phase passed.  Without a GPU the script exits
non-zero before doing any work.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def _torus_problem(nu: int, seed: int = 0):
    """(V, M, S, neigh, rhs) of an nu x nu torus, rhs = M @ randn."""
    import numpy as np

    from gravo_mg.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg.utils.meshgen import torus_mesh
    from gravo_mg.utils.neighbors import neighbors_from_faces

    V, F = torus_mesh(nu, nu)
    S = cotan_laplacian(V, F)
    M = mass_barycentric(V, F)
    neigh = neighbors_from_faces(F)
    rhs = M @ np.random.default_rng(seed).standard_normal(V.shape[0])
    return V, M, S, neigh, rhs


def _check(name: str, y, y_ref, bound) -> None:
    """Elementwise ``|y - y_ref| <= bound``; logs the worst ratio."""
    import numpy as np

    err = np.abs(np.asarray(y, np.float64) - y_ref)
    worst = float(np.max(err / np.maximum(bound, np.finfo(np.float64).tiny)))
    log(f"  parity {name}: max |err|/bound = {worst:.3e}")
    if not np.all(err <= bound):
        raise AssertionError(f"{name}: error exceeds its bound ({worst:.3e})")


def check_parity(ctx, seed: int = 1) -> None:
    """Each level operator, each transfer (U and U^T) and the coarse solve,
    applied on the device in f32, against f64 host references.

    Operators: ``|y - A x| <= 1e-5 (|A| |x|)`` elementwise — f32
    accumulation over at most K terms (and an unordered atomic sum where a
    transfer uses a segment-sum) stays orders of magnitude inside it.

    Coarse solve: the same two-product formula (``multigrid.
    refined_inverse_apply``) evaluated by numpy in f64 on the device's own
    f32 ``Ainv``/``Ad`` upcast, to ``1e-5 (|Ainv| |rhs|)``.  That isolates
    the products' precision from the coarse matrix's conditioning: f32
    accumulation over a few hundred terms passes, TF32 (about 1e-3) fails.
    """
    import jax
    import numpy as np

    from gravo_mg.solver.multigrid import _coarse_solve
    from gravo_mg.sparse import spmv

    rng = np.random.default_rng(seed)
    apply = jax.jit(spmv)
    prolong = jax.jit(lambda T, e: T.prolong(e))
    restrict = jax.jit(lambda T, r: T.restrict(r))
    f32 = np.float32
    for k, ops in enumerate(ctx.levels):
        A = ctx.chain_csr[k]
        x = rng.standard_normal(A.shape[1]).astype(f32)
        x64 = x.astype(np.float64)
        _check(f"level {k} A ({type(ops.A).__name__}, n={A.shape[0]}, "
               f"nnz={A.nnz})", apply(ops.A, x), A @ x64,
               1e-5 * (abs(A) @ np.abs(x64)))
        U = ctx.U_csr[k]
        e = rng.standard_normal(U.shape[1]).astype(f32)
        r = rng.standard_normal(U.shape[0]).astype(f32)
        _check(f"level {k} U ({type(ops.U).__name__}, {U.shape[0]}x"
               f"{U.shape[1]})", prolong(ops.U, e), U @ e.astype(np.float64),
               1e-5 * (abs(U) @ np.abs(e.astype(np.float64))))
        _check(f"level {k} U^T", restrict(ops.U, r),
               U.T @ r.astype(np.float64),
               1e-5 * (abs(U).T @ np.abs(r.astype(np.float64))))
    Ainv32, Ad32 = ctx.coarse_op
    Ainv, Ad = np.asarray(Ainv32, np.float64), np.asarray(Ad32, np.float64)
    null = ctx.cfg.coarse_null_project
    solve = jax.jit(_coarse_solve, static_argnums=2)
    for cols in (None, 3):
        shape = (Ainv.shape[0],) if cols is None else (Ainv.shape[0], cols)
        rc = rng.standard_normal(shape).astype(f32)
        r2 = rc.astype(np.float64).reshape(Ainv.shape[0], -1)
        e = Ainv @ r2
        e = e + Ainv @ (r2 - Ad @ e)
        if null:
            e = e - e.mean(axis=0, keepdims=True)
        bound = 1e-5 * (np.abs(Ainv) @ np.abs(r2))
        got = np.asarray(solve(ctx.coarse_op, rc, null), np.float64)
        _check(f"coarse solve ({Ainv.shape[0]} rows, "
               f"{'1' if cols is None else cols} rhs)",
               got.reshape(e.shape), e, bound)


def _card_line() -> str:
    from gravo_mg.utils.device import nvidia_smi

    return " | ".join(nvidia_smi().splitlines())


def one_card(nu: int = 1024, ref_nu: int = 256) -> None:
    """The single-card phases (see the module docstring)."""
    import jax
    import numpy as np
    import scipy.sparse.linalg as spla

    from gravo_mg import MultigridSolver
    from gravo_mg.solver.multigrid import fused_solve

    card = _card_line()

    # --- main path: Poisson, both public modes -----------------------------
    t0 = time.perf_counter()
    V, M, S, neigh, rhs = _torus_problem(nu)
    n = V.shape[0]
    log(f"mesh: torus {nu}x{nu}, {n} vertices "
        f"({time.perf_counter() - t0:.2f} s host)")
    t0 = time.perf_counter()
    solver = MultigridSolver(V, neigh, M, lower_bound=1000)
    log(f"hierarchy build: {time.perf_counter() - t0:.3f} s, "
        f"dof {solver.hierarchy.dof} [{card}]")
    lhs = (1e-6 * M + S).tocsr()
    for mode in ("traced", "fused"):
        t0 = time.perf_counter()
        x = solver.solve(lhs, rhs, mode=mode)
        wall = time.perf_counter() - t0
        tm = solver.solver_timing
        res = solver.residual(lhs, rhs, x, type=2)
        setup = (f"context setup {tm['setup'] / 1e3:.3f} s, "
                 if mode == "traced" else "")
        log(f"poisson {mode} (first call, compile included): {wall:.3f} s "
            f"wall, {setup}{int(tm['iterations'])} cycles, host M-norm "
            f"residual {res:.3e} [{card}]")
        if not res <= 1e-4:
            raise AssertionError(f"poisson {mode}: residual {res:.3e}")
        t0 = time.perf_counter()
        x = solver.solve(lhs, rhs, mode=mode)
        wall = time.perf_counter() - t0
        res = solver.residual(lhs, rhs, x, type=2)
        log(f"poisson {mode} (warm): {wall:.4f} s wall, device cycles "
            f"{solver.solver_timing['cycles'] / 1e3:.4f} s, "
            f"{int(solver.solver_timing['iterations'])} cycles, residual "
            f"{res:.3e} [{card}]")
        if not res <= 1e-4:
            raise AssertionError(f"poisson {mode} warm: residual {res:.3e}")

    # --- parity at real width ----------------------------------------------
    ctx = solver._context(lhs)
    log(f"setup phases (ms): " + ", ".join(
        f"{k}={v:.0f}" for k, v in sorted(ctx.timing.items())
        if k.startswith("setup")))
    check_parity(ctx)

    # --- memory --------------------------------------------------------------
    b = jax.numpy.zeros((n,), ctx.dtype)
    compiled = fused_solve.lower(
        ctx.cfg, ctx.levels, ctx.coarse_op, ctx.M, ctx.Minv_diag, b, b,
        jax.numpy.ones((1,), ctx.dtype), jax.numpy.asarray(1e-4, ctx.dtype),
        2, 100,
    ).compile()
    ma = compiled.memory_analysis()
    if ma is not None:
        log(f"fused_solve memory_analysis: arguments "
            f"{ma.argument_size_in_bytes} B, outputs "
            f"{ma.output_size_in_bytes} B, temporaries "
            f"{ma.temp_size_in_bytes} B, code "
            f"{ma.generated_code_size_in_bytes} B [{card}]")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')} [{card}]")

    # --- smoothing, 3 right-hand sides, same pattern (update_lhs) -----------
    lhs_s = (M + 1e-3 * S).tocsr()
    B = M @ V
    for label in ("first", "warm"):
        t0 = time.perf_counter()
        X = solver.solve(lhs_s, B, mode="fused")
        wall = time.perf_counter() - t0
        res = solver.residual(lhs_s, B, X, type=2)
        log(f"smoothing 3 rhs ({label}): {wall:.4f} s wall, "
            f"{int(solver.solver_timing['iterations'])} cycles, residual "
            f"{res:.3e} [{card}]")
        if X.shape != B.shape or not res <= 1e-4:
            raise AssertionError(f"smoothing: residual {res:.3e}")
    del solver, ctx

    # --- plain reference at 65k ----------------------------------------------
    # The multigrid solution must match a sparse direct f64 solve.  The
    # error is bounded by the condition number times the residual, and
    # M + 1e-3 S is well conditioned, so a 1e-5 residual (which f32
    # reaches without stalling) gives max-relative agreement far inside
    # 1e-3.
    V2, M2, S2, neigh2, _ = _torus_problem(ref_nu)
    lhs2 = (M2 + 1e-3 * S2).tocsr()
    B2 = M2 @ V2
    solver2 = MultigridSolver(V2, neigh2, M2, lower_bound=1000,
                              tolerance=1e-5)
    X2 = solver2.solve(lhs2, B2, mode="fused")
    X_ref = spla.spsolve(lhs2.tocsc(), B2)
    err = max(np.abs(X2[:, c] - X_ref[:, c]).max() / np.abs(X_ref[:, c]).max()
              for c in range(B2.shape[1]))
    log(f"reference {V2.shape[0]} vertices: "
        f"{int(solver2.solver_timing['iterations'])} cycles, max-relative "
        f"error vs spsolve {err:.3e}")
    if not err <= 1e-3:
        raise AssertionError(f"65k direct comparison: {err:.3e}")
    xc = solver2.cg_solve(lhs2, B2[:, 0])
    res_cg = solver2.residual(lhs2, B2[:, 0], xc, type=0)
    log(f"cg_solve {V2.shape[0]} vertices: relative l2 residual "
        f"{res_cg:.3e}")
    if not res_cg <= 1e-4:
        raise AssertionError(f"cg_solve residual {res_cg:.3e}")


def four_cards(nu: int = 2048, ndev: int = 4) -> None:
    """Halo solver on ``ndev`` cards against the one-card solve."""
    import numpy as np

    from gravo_mg import MultigridSolver
    from gravo_mg.parallel.dist import make_solver_mesh
    from gravo_mg.parallel.halo import HaloContext

    card = _card_line()
    t0 = time.perf_counter()
    V, M, S, neigh, rhs = _torus_problem(nu)
    solver = MultigridSolver(V, neigh, M, lower_bound=1000)
    lhs = (1e-6 * M + S).tocsr()
    log(f"mesh + hierarchy: {V.shape[0]} vertices, dof "
        f"{solver.hierarchy.dof}, {time.perf_counter() - t0:.2f} s")
    ctx = solver._context(lhs)
    x1, it1, r1, _ = ctx.solve(rhs, tol=1e-4, max_iter=100, mode="fused")
    log(f"one card: {it1} cycles, device residual {r1:.3e}, device cycles "
        f"{ctx.timing['cycles'] / 1e3:.4f} s [{card}]")
    t0 = time.perf_counter()
    hctx = HaloContext(ctx, make_solver_mesh(ndev))
    log(f"halo partition ({ndev} devices): {time.perf_counter() - t0:.2f} s, "
        f"level-0 halo {hctx.levels[0].A.halo} of {hctx.nloc[0]} rows")
    for label in ("first", "warm"):
        t0 = time.perf_counter()
        x4, it4, r4 = hctx.solve(rhs, tol=1e-4, max_iter=100)
        log(f"halo solve ({label}): {time.perf_counter() - t0:.4f} s wall, "
            f"{it4} cycles, device residual {r4:.3e} [{card}]")
    err = float(np.abs(x4 - x1).max() / max(np.abs(x1).max(), 1e-30))
    res = solver.residual(lhs, rhs, x4, type=2)
    log(f"halo vs one card: max-relative difference {err:.3e}; host "
        f"M-norm residual {res:.3e}; cycles {it4} vs {it1}")
    if not (r4 <= 1e-4 and err <= 1e-4):
        raise AssertionError(f"halo solve: residual {r4:.3e}, diff {err:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card halo solve and its comparison")
    args = ap.parse_args()
    if not os.path.isfile(os.path.join(HERE, "gravo_mg", "__init__.py")):
        print("chip_smoke: the gravo_mg package is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gravo_mg.utils.device import require_gpus

    ndev = 4 if args.four_cards else 1
    dev = require_gpus(ndev, "chip_smoke")

    import jax

    from gravo_mg import native

    log(f"card: {_card_line()}")
    log(f"jax {jax.__version__}, device_kind {dev['kind']}, "
        f"{dev['count']} device(s)")
    log(f"hierarchy engine: {native.status()}")
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards()
    else:
        one_card()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
