"""GSPMD row-sharded multigrid — the distribution CORRECTNESS ORACLE.

Status: :mod:`gravo_mg.parallel.halo` is the distribution layer with
explicit communication — per-device shuffle-ELL blocks, static
ring-ppermute halo exchange overlapped with the interior FMA.  This module
keeps the compiler-scheduled formulation of the same math: operators are
**row-partitioned** over a 1-D ``rows`` mesh axis via
`jax.sharding.NamedSharding` and the single-device jitted cycle runs
unchanged under GSPMD, XLA inserting all-gathers/reduce-scatters.  It
exists because an independently-derived distributed result that must
agree with the halo solver to float accuracy is the cheapest possible
cross-check of the hand-written exchange plans (tests/test_dist.py,
__graft_entry__.dryrun_multichip runs both).

The reference is strictly single-threaded (SURVEY.md §2.5); scaling the
vertex dimension across devices is a new capability of this library
(BASELINE.json north star).

Layout note: device arrays are slot-major transposed — EllMatrix (K, N),
Prolongation (W, Nf) — so the partitioned (row/vertex) dimension is the
MINOR axis and specs are ``P(None, "rows")``.  Every sharded vertex
dimension is padded to a multiple of the mesh size with inert entries
(index 0 / weight 0), so partitions are even and shapes static.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solver.multigrid import LevelOps, MultigridSolveContext
from ..sparse import EllMatrix, Prolongation


def make_solver_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D device mesh with a ``rows`` axis (vertex-dimension partitioning,
    the domain-decomposition analog of data parallelism)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("rows",))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_axis(arr: jnp.ndarray, axis: int, target: int, fill=0):
    n = arr.shape[axis]
    if n == target:
        return arr
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return jnp.pad(arr, pad_width, constant_values=fill)


def _shard_ell(A: EllMatrix, mesh: Mesh, ndev: int) -> EllMatrix:
    npad = _round_up(A.indices.shape[1], ndev)
    sh = NamedSharding(mesh, P(None, "rows"))
    return EllMatrix(
        jax.device_put(_pad_axis(A.indices, 1, npad), sh),
        jax.device_put(_pad_axis(A.values, 1, npad), sh),
        A.ncols,
    )


def _shard_prolongation(
    U: Prolongation, mesh: Mesh, nf_pad: int, nc_pad: int
) -> Prolongation:
    """Shard U with padded fine AND coarse dimensions.

    Padded fine slots point at coarse row 0 with weight 0 (inert); the
    restriction's ``num_segments`` becomes the padded coarse size so its
    output feeds the next level's padded operators directly.  The
    perm/seg_ids plan is rebuilt over the padded layout.
    """
    cols = np.asarray(U.cols)       # (W, Nf)
    w = np.asarray(U.weights)
    width, nf = cols.shape
    if nf_pad != nf:
        cols = np.concatenate(
            [cols, np.zeros((width, nf_pad - nf), cols.dtype)], axis=1
        )
        w = np.concatenate(
            [w, np.zeros((width, nf_pad - nf), w.dtype)], axis=1
        )
    flat = cols.reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    seg = flat[perm].astype(np.int32)
    sh2 = NamedSharding(mesh, P(None, "rows"))
    sh1 = NamedSharding(mesh, P("rows"))
    return Prolongation(
        jax.device_put(jnp.asarray(cols), sh2),
        jax.device_put(jnp.asarray(w), sh2),
        jax.device_put(jnp.asarray(perm), sh1),
        jax.device_put(jnp.asarray(seg), sh1),
        nc_pad,
    )


@dataclasses.dataclass
class ShardedContext:
    """Row-partitioned view of a MultigridSolveContext."""

    mesh: Mesh
    levels: tuple
    coarse_op: tuple     # (Ainv, Ad) replicated, identity-padded
    M: EllMatrix
    Minv_diag: jnp.ndarray
    cfg: object
    n_rows: int       # unpadded fine size
    n_rows_pad: int
    # Deflation data (host, f64): A @ 1 per row and the diagonal scale —
    # near-singular systems get the same exact rank-1 constant-mode
    # removal as MultigridSolveContext.solve.
    row_sums: np.ndarray = None
    lhs_scale: float = 1.0


def shard_context(ctx: MultigridSolveContext, mesh: Mesh) -> ShardedContext:
    """Distribute a solve context's per-level operators over the mesh.

    Only the vertex dimension of each level is sharded; the dense coarse
    factor is replicated (tiny by construction — SURVEY.md §5: all-gather
    onto the coarsest level) with an identity pad block so the padded
    restriction feeds it directly.
    """
    ndev = mesh.devices.size
    rep = NamedSharding(mesh, P())
    ell_levels = ctx.ell_levels
    sizes = [ops.A.indices.shape[1] for ops in ell_levels]
    sizes.append(ell_levels[-1].U.ncoarse)
    pads = [_round_up(n, ndev) for n in sizes]
    levels = []
    for k, ops in enumerate(ell_levels):
        A = _shard_ell(ops.A, mesh, ndev)
        # Padded slots: diag_inv 0 -> smoother updates are no-ops there.
        diag_inv = jax.device_put(
            _pad_axis(ops.diag_inv, 0, pads[k]), NamedSharding(mesh, P("rows"))
        )
        U = _shard_prolongation(ops.U, mesh, pads[k], pads[k + 1])
        levels.append(
            LevelOps(A, diag_inv, jax.device_put(ops.lam_max, rep), U)
        )
    nc, nc_pad = sizes[-1], pads[-1]

    def _pad_eye(m):
        m = np.asarray(m, dtype=np.float64)
        if nc_pad != nc:
            mp = np.zeros((nc_pad, nc_pad), dtype=m.dtype)
            mp[:nc, :nc] = m
            mp[nc:, nc:] = np.eye(nc_pad - nc, dtype=m.dtype)
            m = mp
        return jax.device_put(jnp.asarray(m, dtype=ctx.dtype), rep)

    Ainv, Ad = ctx._host_coarse_inv
    return ShardedContext(
        mesh=mesh,
        levels=tuple(levels),
        coarse_op=(_pad_eye(Ainv), _pad_eye(Ad)),
        M=_shard_ell(ctx.M, mesh, ndev),
        Minv_diag=jax.device_put(
            _pad_axis(ctx.Minv_diag, 0, pads[0]), NamedSharding(mesh, P("rows"))
        ),
        cfg=ctx.cfg,
        n_rows=sizes[0],
        n_rows_pad=pads[0],
        row_sums=np.asarray(ctx.row_sums, dtype=np.float64),
        lhs_scale=float(np.abs(ctx.lhs_csr.diagonal()).mean()),
    )


def _vec_sharding(sctx, ndim):
    return NamedSharding(
        sctx.mesh, P("rows") if ndim == 1 else P("rows", None)
    )


def sharded_cycle_step(sctx: ShardedContext, b: jnp.ndarray, x: jnp.ndarray):
    """One V/F/W cycle with row-sharded inputs (GSPMD partitions it)."""
    from ..solver.multigrid import cycle_step

    sh = _vec_sharding(sctx, np.ndim(b))
    b = jax.device_put(
        _pad_axis(jnp.asarray(b), 0, sctx.n_rows_pad), sh
    )
    x = jax.device_put(
        _pad_axis(jnp.asarray(x), 0, sctx.n_rows_pad), sh
    )
    out = cycle_step(sctx.cfg, sctx.levels, sctx.coarse_op, b, x)
    return out[: sctx.n_rows]


def sharded_solve(
    sctx: ShardedContext,
    rhs: np.ndarray,
    *,
    tol: float = 1e-4,
    criteria: int = 2,
    max_iter: int = 100,
    dtype=jnp.float32,
):
    """Iterate-to-tolerance on the sharded operators (fused on device).

    Near-singular systems are deflated exactly like the single-device
    solve (constant mode removed in f64 on the host, re-added to the
    output); the residual denominator uses the ORIGINAL rhs.
    """
    from ..solver.multigrid import fused_solve
    from ..solver.residual import residual_denominator

    rhs = np.asarray(rhs, dtype=np.float64)
    rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs
    n = sctx.n_rows
    alpha = np.zeros(rhs2.shape[1])
    if sctx.row_sums is not None:
        from ..solver.multigrid import deflation_alpha

        alpha = deflation_alpha(sctx.row_sums, rhs2)
        b_eff = rhs2 - alpha[None, :] * sctx.row_sums[:, None]
    else:
        b_eff = rhs2
    b_eff = b_eff[:, 0] if rhs.ndim == 1 else b_eff

    sh = _vec_sharding(sctx, np.ndim(rhs))
    b_orig = jax.device_put(
        _pad_axis(jnp.asarray(rhs, dtype=dtype), 0, sctx.n_rows_pad), sh
    )
    b = jax.device_put(
        _pad_axis(jnp.asarray(b_eff, dtype=dtype), 0, sctx.n_rows_pad), sh
    )
    x0 = jax.device_put(jnp.zeros_like(b), sh)
    den = residual_denominator(sctx.M, sctx.Minv_diag, b_orig, criteria)
    x, iters, res, trace = fused_solve(
        sctx.cfg, sctx.levels, sctx.coarse_op, sctx.M, sctx.Minv_diag,
        b, x0, den, jnp.asarray(tol, dtype), criteria, max_iter,
    )
    out = np.asarray(x, dtype=np.float64)[:n]
    out = out + (alpha[0] if rhs.ndim == 1 else alpha[None, :])
    return out, int(iters), float(res)
