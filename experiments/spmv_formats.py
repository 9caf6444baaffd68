#!/usr/bin/env python
"""Time the sparse formats the solve path can use, on the card.

At the 1,048,576-vertex Poisson torus (``1e-6 M + S``, the flagship
problem of ``bench.py``) this times, each inside one jitted dependent
chain of ``--reps`` applies synced by ``block_until_ready``:

* the finest level operator as (a) transposed ELL (``EllMatrix``) and
  (b) ``ShuffleEll``;
* the finest transfer pair, prolong and restrict separately, as (c1) the
  hierarchy's ``Prolongation`` (gather, sorted segment-sum), (c2) ELL of U
  and of U^T, (c3) ShuffleEll of U and of U^T;
* a chain of elementwise passes over a 1 GiB array, as the achievable
  bandwidth reference;

then the warm end-to-end fused solve with each level/transfer choice.
Per apply it prints the time, the bytes the format must stream (indices,
values, the input once, the output), the implied bandwidth and its share
of the copy's.  A JSON summary goes to ``chiprun_out/spmv_formats.json``.

Needs a GPU; ``--rehearse`` runs a small size on any backend and labels
the output as a rehearsal, not a device measurement.

    python experiments/spmv_formats.py [--nu 1024] [--reps 50]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def log(msg):
    print(msg, flush=True)


def best_time(fn, *args, repeats: int = 5) -> float:
    """Best wall time of fn(*args) over ``repeats`` calls (after one
    warm-up/compile call), each synced with block_until_ready."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def ell_bytes(idx_shape, n_in, n_out, val_bytes=4):
    k, n = idx_shape
    return k * n * (4 + val_bytes) + 4 * n_in + 4 * n_out


def shuffle_bytes(S, n_in, n_out):
    kp, s = S.q.shape
    return kp * s * 4 + kp * s * 128 * (1 + 4) + 4 * n_in + 4 * n_out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nu", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rehearse", action="store_true",
                    help="allow a non-GPU backend (labelled rehearsal)")
    args = ap.parse_args()

    from gravo_mg import MultigridSolver
    from gravo_mg.sparse import (
        Prolongation,
        TransferPair,
        ell_from_scipy,
        shuffle_from_scipy,
        spmv,
    )
    from gravo_mg.utils.device import device_record, nvidia_smi, require_gpus
    from gravo_mg.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg.utils.meshgen import torus_mesh
    from gravo_mg.utils.neighbors import neighbors_from_faces

    if args.rehearse:
        dev = device_record()
        card = "rehearsal, not a device measurement"
    else:
        dev = require_gpus(1, "spmv_formats")
        card = " | ".join(nvidia_smi().splitlines())
    log(f"device: {dev} [{card}]")

    V, F = torus_mesh(args.nu, args.nu)
    S = cotan_laplacian(V, F)
    M = mass_barycentric(V, F)
    lhs = (1e-6 * M + S).tocsr()
    n = V.shape[0]
    rhs = M @ np.random.default_rng(42).standard_normal(n)
    solver = MultigridSolver(V, neighbors_from_faces(F), M, lower_bound=1000)
    ctx = solver._context(lhs)
    A0 = ctx.chain_csr[0]
    U0 = ctx.U_csr[0]
    nf, nc = U0.shape
    UT0 = U0.T.tocsr()
    log(f"n={n} nnz(A0)={A0.nnz} U0 {nf}x{nc} nnz={U0.nnz} "
        f"max U^T row degree={int(np.diff(UT0.indptr).max())}")

    R = args.reps
    # Each chain applies an operator scaled by 1/(its largest absolute row
    # sum), so values neither overflow nor decay over R applies: A0 and
    # U^T are scaled; U's rows already sum to 1.
    A0 = A0 / abs(A0).sum(axis=1).max()
    u_scale = float(abs(U0).sum(axis=0).max())
    UT0 = (U0.T / u_scale).tocsr()
    out = {"device": dev, "card": card, "n": n, "nnz_A0": int(A0.nnz),
           "reps": R, "ops": {}, "solve": {}}

    # --- copy reference -------------------------------------------------
    big = jnp.ones((256 << 20,), jnp.float32)   # 1 GiB
    passes = 10

    @jax.jit
    def _copy_chain(v):
        for _ in range(passes):
            # the barrier keeps the passes from fusing into one
            v = jax.lax.optimization_barrier(v * 1.0001)
        return v

    t = best_time(_copy_chain, big) / passes
    copy_bw = 2 * big.size * 4 / t
    out["copy_GBps"] = copy_bw / 1e9
    log(f"copy 1 GiB: {t * 1e6:.1f} us/pass, {copy_bw / 1e9:.0f} GB/s "
        f"[{card}]")
    del big

    def record(name, t, nbytes):
        bw = nbytes / t
        out["ops"][name] = {"us": t * 1e6, "bytes": int(nbytes),
                            "GBps": bw / 1e9, "share_of_copy": bw / copy_bw}
        log(f"{name:<34s} {t * 1e6:9.1f} us  {nbytes / 1e6:8.1f} MB  "
            f"{bw / 1e9:7.0f} GB/s  {bw / copy_bw:6.1%} of copy [{card}]")

    # --- finest level operator --------------------------------------------
    @jax.jit
    def _spmv_chain(A, v):
        for _ in range(R):
            v = spmv(A, v)
        return v

    x = jnp.asarray(np.random.default_rng(0).standard_normal(n), jnp.float32)
    A_ell = ell_from_scipy(A0)
    A_sh = shuffle_from_scipy(A0)
    record("(a) A0 EllMatrix", best_time(_spmv_chain, A_ell, x) / R,
           ell_bytes(A_ell.indices.shape, n, n))
    record("(b) A0 ShuffleEll", best_time(_spmv_chain, A_sh, x) / R,
           shuffle_bytes(A_sh, n, n))
    out["K_A0"] = int(A_ell.indices.shape[0])
    out["KP_A0"] = int(A_sh.kp)

    # --- finest transfer pair ---------------------------------------------
    # The prolong chain folds the fine output back to coarse length with a
    # sum over groups of ``m`` rows, so every fine row is computed (a plain
    # slice would let XLA compute only the rows it keeps); the fold's
    # extra read of the fine vector is included in the prolong time.
    m = -(-nf // nc)

    @jax.jit
    def _prolong_chain(T, e):
        for _ in range(R):
            y = jnp.pad(T.prolong(e), (0, m * nc - nf))
            e = y.reshape(nc, m).sum(axis=1) / m
        return e

    @jax.jit
    def _restrict_chain(T, r):
        for _ in range(R):
            r = jnp.zeros((nf,), r.dtype).at[:nc].set(T.restrict(r))
        return r

    P = ctx.hierarchy.levels[0].U

    def prol(scale):
        return Prolongation(jnp.asarray(P.cols), jnp.asarray(
            np.asarray(P.weights) / scale, jnp.float32), jnp.asarray(P.perm),
            jnp.asarray(P.seg_ids), P.ncoarse)

    T_prol, T_prol_r = prol(1.0), prol(u_scale)
    T_ell = TransferPair(ell_from_scipy(U0), ell_from_scipy(UT0))
    T_sh = TransferPair(shuffle_from_scipy(U0), shuffle_from_scipy(UT0))
    e = jnp.asarray(np.random.default_rng(1).standard_normal(nc), jnp.float32)
    r = jnp.asarray(np.random.default_rng(2).standard_normal(nf), jnp.float32)
    w = P.cols.shape[0]
    prol_bytes = ell_bytes((w, nf), nc, nf) + 4 * nf  # + the fold's read
    record("(c1) U Prolongation gather",
           best_time(_prolong_chain, T_prol, e) / R, prol_bytes)
    record("(c1) U^T Prolongation segment-sum",
           best_time(_restrict_chain, T_prol_r, r) / R,
           w * nf * (4 + 4 + 4) + 4 * nf + 4 * nc)
    record("(c2) U ELL", best_time(_prolong_chain, T_ell, e) / R,
           ell_bytes(T_ell.U.indices.shape, nc, nf) + 4 * nf)
    record("(c2) U^T ELL", best_time(_restrict_chain, T_ell, r) / R,
           ell_bytes(T_ell.UT.indices.shape, nf, nc))
    record("(c3) U ShuffleEll", best_time(_prolong_chain, T_sh, e) / R,
           shuffle_bytes(T_sh.U, nc, nf) + 4 * nf)
    record("(c3) U^T ShuffleEll", best_time(_restrict_chain, T_sh, r) / R,
           shuffle_bytes(T_sh.UT, nf, nc))
    out["K_UT0"] = int(T_ell.UT.indices.shape[0])
    out["KP_UT0"] = int(T_sh.UT.kp)

    # --- warm end-to-end solve with each choice ---------------------------
    def prolongation_of(k):
        Pk = ctx.hierarchy.levels[k].U
        return Prolongation(jnp.asarray(Pk.cols),
                            jnp.asarray(Pk.weights, jnp.float32),
                            jnp.asarray(Pk.perm), jnp.asarray(Pk.seg_ids),
                            Pk.ncoarse)

    planned = ctx.levels
    variants = {
        "planner (" + "/".join(sorted({type(l.U).__name__
                                       for l in planned})) + ")": planned,
        "ELL levels + ELL transfer pairs": tuple(
            dataclasses.replace(l, U=TransferPair(
                ell_from_scipy(ctx.U_csr[k]),
                ell_from_scipy(ctx.U_csr[k].T.tocsr())))
            for k, l in enumerate(planned)),
        "ELL levels + Prolongation": tuple(
            dataclasses.replace(l, U=prolongation_of(k))
            for k, l in enumerate(planned)),
        "ShuffleEll levels + ShuffleEll pairs": tuple(
            dataclasses.replace(
                l, A=shuffle_from_scipy(ctx.chain_csr[k]),
                U=TransferPair(shuffle_from_scipy(ctx.U_csr[k]),
                               shuffle_from_scipy(ctx.U_csr[k].T.tocsr())))
            for k, l in enumerate(planned)),
    }
    for name, levels in variants.items():
        ctx.levels = levels
        t0 = time.perf_counter()
        _, iters, res, _ = ctx.solve(rhs, tol=1e-4, mode="fused")
        first = time.perf_counter() - t0
        cycles, walls = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            x_s, iters, res, _ = ctx.solve(rhs, tol=1e-4, mode="fused")
            walls.append(time.perf_counter() - t0)
            cycles.append(ctx.timing["cycles"] / 1e3)
        host_res = ctx.residual(rhs, x_s)
        out["solve"][name] = {"first_s": first, "warm_cycles_s": min(cycles),
                              "warm_wall_s": min(walls), "iters": int(iters),
                              "host_residual": host_res}
        log(f"solve [{name}]: first {first:.2f} s, warm device cycles "
            f"{min(cycles) * 1e3:.2f} ms, warm wall {min(walls) * 1e3:.2f} "
            f"ms, {iters} cycles, residual {host_res:.2e} [{card}]")
    ctx.levels = planned

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "spmv_formats.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
