"""Distributed multigrid with static halo exchange (`shard_map` + ppermute).

This is the distribution layer with explicit communication (SURVEY.md
§2.5 items (a)-(d); BASELINE config 5).  The GSPMD row-sharding in
:mod:`gravo_mg.parallel.dist` leaves the communication to the compiler.
Here every device holds a **local shuffle-ELL block** of each level
operator (``sparse.ShuffleEll``), and the only communication is a
*static halo exchange*:

* Host partitioner (once per context): rows of every level operator are
  block-partitioned over the 1-D ``rows`` mesh.  For each device the
  off-partition columns it touches form its **halo set** — a static,
  sorted index list.  Column indices are remapped into the device-local
  extended space ``[local | halo]``, and the local block is laid out in
  shuffle-ELL form.
* Exchange (per operator application): for each ring shift ``s`` with
  traffic, every device gathers the values its ``(d+s) % D`` neighbor
  requested (static send-index table) and ships them with a single
  ``jax.lax.ppermute``; received values land at static positions
  in the halo buffer.  Shifts with zero traffic across all device pairs
  are skipped at trace time — for locality-ordered meshes only the
  adjacent shifts survive, so the exchange cost is O(boundary), not
  O(n/D).
* The full iterate-to-tolerance loop (Chebyshev/Jacobi smoothing, V/F/W
  cycle, replicated dense coarse solve, residual criterion with psum)
  runs inside ONE ``shard_map``-wrapped ``lax.while_loop`` — a single
  compiled SPMD program per solve.

The restriction is formulated as a gather-SpMV with U^T (coarse-local
rows, fine columns + fine halo), so no scatter-exchange is ever needed:
both transfer directions and all smoothing SpMVs use the same halo
machinery.

Near-singular systems get the same exact rank-1 constant-mode deflation
as the single-device path (host-side, f64) plus the coarse null-space
projection — the GSPMD path's missing piece.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..enums import CycleType, Smoother
from ..solver.multigrid import refined_inverse_apply
from ..solver.smoothers import chebyshev, jacobi
from ..sparse import ShuffleEll, _shuffle_layout


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass
class DistOp:
    """One row-partitioned sparse operator in per-device shuffle-ELL form.

    All arrays are stacked over a leading device axis ``D`` and sharded
    ``P('rows')`` into the shard_map, where each device sees its own
    ``[0]`` slice.  The operator is split BY SLOT into an **interior
    part** (``q/r/v`` — slots whose source block is device-local, so its
    FMA has no data dependence on any communication) and a **halo part**
    (``qh/rh/vh`` — slots sourcing the received halo buffer only).  The
    per-device apply is

        send ppermutes  ->  y = interior FMA (overlaps the ppermutes)
                        ->  y += halo FMA (consumes the received buffer)

    — the SURVEY §2.5(b) exchange-overlapped-with-interior-smoothing
    contract, structural rather than scheduled: XLA's latency-hiding
    scheduler is free to run the collective during the interior compute
    because nothing in it reads the permuted values.

    ``steps`` holds the halo-exchange plan: one entry per ring shift with
    nonzero traffic, ``(shift, send_idx (D, Hs), recv_pos (D, Hs))`` —
    sender ``d`` gathers ``x_local[send_idx[d]]`` for receiver
    ``(d+s) % D``; the receiver scatters the ppermuted buffer to
    ``halo[recv_pos[d]]`` (padding routed to a dump slot).
    """

    q: jnp.ndarray          # (D, KP, S) int32 — interior slots
    r: jnp.ndarray          # (D, KP, S, 128) int8 — lanes 0..127
    v: jnp.ndarray          # (D, KP, S, 128)
    qh: jnp.ndarray         # (D, KPH, S) int32 — halo slots (may be empty)
    rh: jnp.ndarray         # (D, KPH, S, 128) int8
    vh: jnp.ndarray         # (D, KPH, S, 128)
    steps: Tuple            # ((shift, send_idx, recv_pos), ...)
    rows_local: int         # output length per device
    cols_local: int         # owned input length per device (mult of 128)
    halo: int               # real halo entries (uniform over devices)
    halo_pad: int           # halo buffer length, mult of 128, > halo


def _build_dist_op(A_csr, D: int, rl: int, cl: int, dtype,
                   put=None, local_devices: int = 0) -> DistOp:
    """Partition a global csr operator into per-device halo-remapped
    shuffle-ELL blocks (host-side, once per context).

    ``put`` materializes each host array on device(s); the default is
    ``jnp.asarray`` (single-process).  Multi-host contexts pass a
    sharding-aware put (see parallel/multihost.py host_to_global).
    ``local_devices`` (devices per process) drives the DCN-first ordering
    of the exchange steps; 0 means single-host (order by |shift|)."""
    if put is None:
        put = jnp.asarray
    assert cl % 128 == 0, "per-device column block must be 128-aligned"
    A = A_csr.tocsr()
    A.sum_duplicates()
    nr, nc = A.shape
    halo_cols: List[np.ndarray] = []
    blocks = []
    for d in range(D):
        r0, r1 = d * rl, min((d + 1) * rl, nr)
        blk = A[r0:r1].tocoo() if r1 > r0 else None
        if blk is None or blk.nnz == 0:
            blocks.append((np.zeros(0, np.int64),) * 2 + (np.zeros(0),))
            halo_cols.append(np.zeros(0, np.int64))
            continue
        rows = blk.row.astype(np.int64)
        cols = blk.col.astype(np.int64)
        local = (cols >= d * cl) & (cols < (d + 1) * cl)
        hc = np.unique(cols[~local])
        halo_cols.append(hc)
        blocks.append((rows, cols, blk.data))
    H = max((len(h) for h in halo_cols), default=0)
    # Halo buffer: 128-aligned with at least one spare slot for the
    # exchange's padding dump.
    H_pad = _round_up(H + 1, 128) if H else 0

    # Per-device split layouts (interior / halo); pad each to uniform KP.
    layouts = []
    kp_max, kph_max, s_uniform = 1, 0, None
    for d in range(D):
        rows, cols, data = blocks[d]
        local = (cols >= d * cl) & (cols < (d + 1) * cl)
        hc = halo_cols[d]
        kp, s, q, pos = _shuffle_layout(
            rows[local], cols[local] - d * cl, rl, cl
        )
        if s_uniform is None:
            s_uniform = s
        assert s == s_uniform
        kp_max = max(kp_max, kp)
        if H:
            hmap = np.searchsorted(hc, cols[~local])
            kph, s2, qh, posh = _shuffle_layout(rows[~local], hmap, rl, H_pad)
            assert s2 == s
            kph_max = max(kph_max, kph if len(hmap) else 0)
        else:
            kph, qh, posh, hmap = 0, None, None, None
        layouts.append((kp, q, pos, cols[local] - d * cl, data[local],
                        kph, qh, posh, hmap, data[~local]))
    kp_max = _round_up(kp_max, 4)
    kph_max = _round_up(kph_max, 4) if kph_max else 0

    S = s_uniform if s_uniform is not None else _round_up(max(-(-rl // 128), 1), 8)
    q_all = np.zeros((D, kp_max, S), np.int32)
    r_all = np.zeros((D, kp_max, S, 128), np.int8)   # lanes 0..127
    v_all = np.zeros((D, kp_max, S, 128), np.float64)
    qh_all = np.zeros((D, kph_max, S), np.int32)
    rh_all = np.zeros((D, kph_max, S, 128), np.int8)
    vh_all = np.zeros((D, kph_max, S, 128), np.float64)
    for d, (kp, q, pos, lc, ld, kph, qh, posh, hmap, hd) in enumerate(layouts):
        if len(pos):
            q_all[d, :kp] = q
            rf = np.zeros((kp * S * 128,), np.int8)
            vf = np.zeros((kp * S * 128,), np.float64)
            rf[pos] = lc & 127
            vf[pos] = ld
            r_all[d, :kp] = rf.reshape(kp, S, 128)
            v_all[d, :kp] = vf.reshape(kp, S, 128)
        if kph and len(posh):
            qh_all[d, :kph] = qh
            rf = np.zeros((kph * S * 128,), np.int8)
            vf = np.zeros((kph * S * 128,), np.float64)
            rf[posh] = hmap & 127
            vf[posh] = hd
            rh_all[d, :kph] = rf.reshape(kph, S, 128)
            vh_all[d, :kph] = vf.reshape(kph, S, 128)

    # Halo exchange plan: group each device's (sorted) halo set by owner.
    send: dict = {}
    recv: dict = {}
    for d in range(D):
        hc = halo_cols[d]
        owners = hc // cl
        for o in np.unique(owners):
            o = int(o)
            s = (d - o) % D
            sel = owners == o
            send.setdefault(s, {})[o] = (hc[sel] - o * cl).astype(np.int32)
            recv.setdefault(s, {})[d] = np.flatnonzero(sel).astype(np.int32)
    steps = []
    for s in sorted(send):
        hs = max(len(v) for v in send[s].values())
        si = np.zeros((D, hs), np.int32)
        rp = np.full((D, hs), H, np.int32)  # pad -> dump slot H (< H_pad)
        for o, idx in send[s].items():
            si[o, : len(idx)] = idx
        for d, posn in recv[s].items():
            rp[d, : len(posn)] = posn
        steps.append((int(s), si, rp))
    # DCN-crossing shifts first so the slow inter-host transfer overlaps
    # the most interior compute (multihost.py; no-op cost single-host).
    from .multihost import order_steps_dcn_first

    steps = order_steps_dcn_first(steps, D, local_devices or D)
    steps = tuple((s, put(si), put(rp)) for (s, si, rp) in steps)

    np_dtype = np.dtype(dtype)
    return DistOp(
        q=put(q_all),
        r=put(r_all),
        v=put(v_all.astype(np_dtype)),
        qh=put(qh_all),
        rh=put(rh_all),
        vh=put(vh_all.astype(np_dtype)),
        steps=steps,
        rows_local=rl,
        cols_local=cl,
        halo=H,
        halo_pad=H_pad,
    )


def _local_view(op_arrays, meta: DistOp):
    """Per-device (A_interior, A_halo, steps) from the shard_map slices."""
    q, r, v, qh, rh, vh, step_arrays = op_arrays
    A = ShuffleEll(q[0], r[0], v[0], meta.rows_local, meta.cols_local)
    Ah = (
        ShuffleEll(qh[0], rh[0], vh[0], meta.rows_local, meta.halo_pad)
        if meta.halo_pad and qh.shape[1] else None
    )
    steps = [
        (shift, si[0], rp[0])
        for (shift, _, _), (si, rp) in zip(meta.steps, step_arrays)
    ]
    return A, Ah, steps


def _op_leaves(op: DistOp):
    """The traced-array pytree for one DistOp (statics live on the meta)."""
    return (op.q, op.r, op.v, op.qh, op.rh, op.vh,
            tuple((si, rp) for (_, si, rp) in op.steps))


def _exchange(x_loc, steps, halo: int, halo_pad: int, axis: str, ndev: int):
    """Receive the halo buffer (halo_pad rows) via ring ppermutes.

    ``x_loc`` may be (n,) or (n, d); the buffer matches.
    """
    shape = (halo_pad,) + x_loc.shape[1:]
    buf_h = jnp.zeros(shape, x_loc.dtype)
    for shift, si, rp in steps:
        buf = jnp.take(x_loc, si, axis=0)
        buf = jax.lax.ppermute(
            buf, axis, [(i, (i + shift) % ndev) for i in range(ndev)]
        )
        buf_h = buf_h.at[rp].set(buf)
    return buf_h


def _dist_spmv(A: ShuffleEll, Ah, steps, meta: DistOp, axis, ndev, x_loc):
    """y = A_device_block @ x, interior FMA overlapping the halo exchange.

    The interior ShuffleEll's q table only indexes blocks of ``x_loc``
    (structural no-halo-dependency guarantee, asserted in tests); the
    halo part gathers exclusively from the ppermuted buffer.
    """
    from ..sparse import shuffle_spmv

    if Ah is None or meta.halo == 0:
        return shuffle_spmv(A, x_loc)
    halo_buf = _exchange(x_loc, steps, meta.halo, meta.halo_pad, axis, ndev)
    y = shuffle_spmv(A, x_loc)          # interior: independent of halo_buf
    return y + shuffle_spmv(Ah, halo_buf)


@dataclasses.dataclass
class _LevelMeta:
    A: DistOp
    U: DistOp
    UT: DistOp


class HaloContext:
    """Distributed view of a MultigridSolveContext over a 1-D device mesh.

    Host-builds (once) the per-device operator blocks and exchange plans
    for every level of the Galerkin chain, the transfers, the mass matrix
    and the replicated coarse factor; ``solve`` then runs the fused SPMD
    iterate-to-tolerance program.
    """

    AXIS = "rows"

    def __init__(self, ctx, mesh: Mesh):
        assert mesh.axis_names == (self.AXIS,), "expect 1-D ('rows',) mesh"
        self.mesh = mesh
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.dtype = ctx.dtype
        D = int(mesh.devices.size)
        self.ndev = D
        # Multi-controller mode: every process runs this same (replicated)
        # host partitioner but materializes only its addressable shards.
        self.nproc = int(jax.process_count())
        self._local_devices = int(jax.local_device_count())
        if self.nproc > 1:
            from .multihost import host_to_global

            put = lambda a: host_to_global(      # noqa: E731
                mesh, P(self.AXIS), np.asarray(a))
            put_rep = lambda a: host_to_global(  # noqa: E731
                mesh, P(), np.asarray(a))
        else:
            put = put_rep = jnp.asarray
        self._put, self._put_rep = put, put_rep

        chain = ctx.chain_csr
        sizes = [A.shape[0] for A in chain]           # n per level (+coarse)
        self.n = sizes[0]
        # Per-device blocks are 128-aligned so the interior/halo slot split
        # can gather straight from the x_local block space.
        self.nloc = [_round_up(n, 128 * D) // D for n in sizes]

        self.levels: List[_LevelMeta] = []
        diag_inv, lam = [], []
        ld = self._local_devices if self.nproc > 1 else 0
        np_dtype = np.dtype(self.dtype)
        for k in range(ctx.cfg.num_levels):
            nl, nlc = self.nloc[k], self.nloc[k + 1]
            A = _build_dist_op(chain[k], D, nl, nl, self.dtype, put, ld)
            U = _build_dist_op(ctx.U_csr[k], D, nl, nlc, self.dtype, put, ld)
            UT = _build_dist_op(
                ctx.U_csr[k].T.tocsr(), D, nlc, nl, self.dtype, put, ld
            )
            self.levels.append(_LevelMeta(A, U, UT))
            di = np.zeros((D * nl,), np.float64)
            di[: sizes[k]] = ctx._host_diag_inv[k]
            diag_inv.append(put(di.reshape(D, nl).astype(np_dtype)))
            lam.append(float(ctx.host_lam[k]))
        self.lam = tuple(lam)

        self.M = _build_dist_op(ctx.mass_csr, D, self.nloc[0], self.nloc[0],
                                self.dtype, put, ld)
        minv = np.zeros((D * self.nloc[0],), np.float64)
        minv[: self.n] = np.asarray(ctx.Minv_diag, dtype=np.float64)
        self._minv = put(minv.reshape(D, self.nloc[0]).astype(np_dtype))
        self._diag_inv = tuple(diag_inv)

        # Replicated coarse inverse + operator (multigrid._coarse_solve's
        # two-matmul scheme), identity-padded to the sharded size — the
        # padded block is its own inverse, so padded rows of a zero-padded
        # rc produce exact zeros through apply and refinement alike.
        def _pad_identity(mat):
            m = np.asarray(mat, dtype=np.float64)
            nc_ = m.shape[0]
            nc_pad = D * self.nloc[-1]
            if nc_pad != nc_:
                mp = np.zeros((nc_pad, nc_pad), m.dtype)
                mp[:nc_, :nc_] = m
                mp[nc_:, nc_:] = np.eye(nc_pad - nc_, dtype=m.dtype)
                m = mp
            return m.astype(np_dtype)

        Ainv, Ad = ctx._host_coarse_inv
        self.nc = Ainv.shape[0]
        self._coarse_op = (put_rep(_pad_identity(Ainv)),
                           put_rep(_pad_identity(Ad)))

        self._arrays = (
            tuple(
                (_op_leaves(m.A), _op_leaves(m.U), _op_leaves(m.UT))
                for m in self.levels
            ),
            _op_leaves(self.M),
            self._diag_inv,
            self._minv,
        )
        self._fused = None

    # ---- device code --------------------------------------------------------

    def _smooth(self, dspmv_A, diag_inv, lam_max, b, x, iters):
        cfg = self.cfg
        if iters <= 0:
            return x
        if cfg.smoother == int(Smoother.JACOBI):
            return jacobi(dspmv_A, diag_inv, b, x, iters, cfg.jacobi_omega)
        return chebyshev(
            dspmv_A, diag_inv, b, x, iters,
            lam_max / cfg.cheb_ratio, cfg.cheb_safety * lam_max,
        )

    def _coarse(self, coarse, rc_loc):
        rc = jax.lax.all_gather(rc_loc, self.AXIS, tiled=True)
        one_d = rc.ndim == 1
        rc2 = rc[:, None] if one_d else rc
        Ainv, Ad = coarse
        e = refined_inverse_apply(Ainv, Ad, rc2.astype(Ainv.dtype))
        if self.cfg.coarse_null_project:
            # Padded rows solve an identity block against zero RHS, so the
            # column sums over the real nc rows equal full-vector sums.
            e = e - jnp.sum(e, axis=0, keepdims=True) / self.nc
        e = e.astype(rc_loc.dtype)
        if one_d:
            e = e[:, 0]
        d = jax.lax.axis_index(self.AXIS)
        start = (d * self.nloc[-1],) + (jnp.int32(0),) * (e.ndim - 1)
        size = (self.nloc[-1],) + e.shape[1:]
        return jax.lax.dynamic_slice(e, start, size)

    def _cycle(self, ops, coarse, b, x, k: int, kind: int):
        cfg = self.cfg
        lvl_arrays, spmvs = ops
        dspmv_A, dspmv_U, dspmv_UT, diag_inv = spmvs[k]
        x = self._smooth(dspmv_A, diag_inv, self.lam[k], b, x, cfg.pre_iters)
        r = b - dspmv_A(x)
        rc = dspmv_UT(r)
        if k == cfg.num_levels - 1:
            e = self._coarse(coarse, rc)
        else:
            e = self._cycle(ops, coarse, rc, jnp.zeros_like(rc),
                            k + 1, kind)
        x = x + dspmv_U(e)
        x = self._smooth(dspmv_A, diag_inv, self.lam[k], b, x, cfg.post_iters)
        if kind != int(CycleType.V):
            r = b - dspmv_A(x)
            rc = dspmv_UT(r)
            if k == cfg.num_levels - 1:
                e = self._coarse(coarse, rc)
            else:
                kind2 = int(CycleType.V) if kind == int(CycleType.F) else kind
                e = self._cycle(ops, coarse, rc, jnp.zeros_like(rc),
                                k + 1, kind2)
            x = x + dspmv_U(e)
            x = self._smooth(dspmv_A, diag_inv, self.lam[k], b, x,
                             cfg.post_iters)
        return x

    def _residual_num_sq(self, dspmv_A, dspmv_M, minv, b, x, criteria: int):
        """Per-column squared numerators, psum'd over the mesh."""
        r = dspmv_A(x) - b
        if criteria == 0 or criteria == 3:
            loc = jnp.sum(r * r, axis=0)
        elif criteria == 1:
            mv = minv[:, None] if r.ndim == 2 else minv
            loc = jnp.sum(r * (mv * r), axis=0)
        elif criteria == 2:
            loc = jnp.sum(r * dspmv_M(r), axis=0)
        else:
            raise ValueError(f"unknown stopping criteria {criteria}")
        return jax.lax.psum(loc, self.AXIS)

    def _make_fused(self, criteria: int, max_iter: int):
        axis, D = self.AXIS, self.ndev
        mesh = self.mesh

        def body(arrays, coarse, b_loc, x_loc, den, tol):
            lvl_arrays, M_arrays, diag_inv, minv = arrays
            spmvs = []
            for k, m in enumerate(self.levels):
                A, Ah, sA = _local_view(lvl_arrays[k][0], m.A)
                U, Uh, sU = _local_view(lvl_arrays[k][1], m.U)
                UT, UTh, sUT = _local_view(lvl_arrays[k][2], m.UT)
                spmvs.append((
                    partial(_dist_spmv, A, Ah, sA, m.A, axis, D),
                    partial(_dist_spmv, U, Uh, sU, m.U, axis, D),
                    partial(_dist_spmv, UT, UTh, sUT, m.UT, axis, D),
                    diag_inv[k][0],
                ))
            Mop, Mh, sM = _local_view(M_arrays, self.M)
            dspmv_M = partial(_dist_spmv, Mop, Mh, sM, self.M, axis, D)
            dspmv_A0 = spmvs[0][0]
            ops = (lvl_arrays, spmvs)

            def cond(carry):
                _, it, res = carry
                return (res > tol) & (it < max_iter)

            def step(carry):
                x, it, _ = carry
                x = self._cycle(ops, coarse, b_loc, x, 0,
                                self.cfg.cycle_type)
                num_sq = self._residual_num_sq(
                    dspmv_A0, dspmv_M, minv[0], b_loc, x, criteria
                )
                res = jnp.max(jnp.sqrt(num_sq) / den)
                return x, it + 1, res

            x, iters, res = jax.lax.while_loop(
                cond, step,
                (x_loc, jnp.int32(0), jnp.asarray(jnp.inf, x_loc.dtype)),
            )
            # Replicate the solution so every process can read it host-side
            # (multi-controller processes only address their own shards).
            return jax.lax.all_gather(x, axis, tiled=True), iters, res

        shard_body = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis), P(), P(axis), P(axis), P(), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(shard_body)

    # ---- host API ------------------------------------------------------------

    def solve(
        self,
        rhs: np.ndarray,
        *,
        tol: float = 1e-4,
        criteria: int = 2,
        max_iter: int = 100,
    ):
        """Deflate (host, f64), run the fused SPMD loop, un-deflate.

        ``rhs`` may be (n,) or (n, d) — multi-column systems (e.g. the
        conformal flow's (N, 3) position solves) run through ONE fused
        SPMD program; the stopping criterion is the max over columns like
        the reference (multigrid_solver.cpp:1228-1277)."""
        ctx = self.ctx
        rhs = np.asarray(rhs, dtype=np.float64)
        squeeze = rhs.ndim == 1
        rhs2 = rhs[:, None] if squeeze else rhs
        n, pad0 = self.n, self.ndev * self.nloc[0]
        d = rhs2.shape[1]

        from ..solver.multigrid import deflation_alpha

        alpha = deflation_alpha(ctx.row_sums, rhs2)   # (d,)
        b_eff = rhs2 - alpha[None, :] * ctx.row_sums[:, None]

        # Residual denominators from the ORIGINAL rhs, host-side f64
        # (reference residualCheck denominators, multigrid_solver.cpp:1247).
        M = ctx.mass_csr
        if criteria == 0:
            den = np.linalg.norm(rhs2, axis=0)
        elif criteria == 1:
            minv = 1.0 / np.maximum(M.diagonal(), 1e-300)
            den = np.sqrt((rhs2 * (minv[:, None] * rhs2)).sum(axis=0))
        elif criteria == 2:
            den = np.sqrt((rhs2 * (M @ rhs2)).sum(axis=0))
        elif criteria == 3:
            den = np.ones(d)
        else:
            raise ValueError(f"unknown stopping criteria {criteria}")
        den = np.maximum(den, 1e-30)

        b = np.zeros((pad0, d), np.float64)
        b[:n] = b_eff
        np_dtype = np.dtype(self.dtype)
        b = self._put((b[:, 0] if squeeze else b).astype(np_dtype))
        x0 = jnp.zeros_like(b)

        key = (criteria, max_iter, None if squeeze else d)
        if self._fused is None or self._fused[0] != key:
            self._fused = (key, self._make_fused(criteria, max_iter))
        fused = self._fused[1]
        x, iters, res = fused(
            self._arrays, self._coarse_op, b, x0,
            self._put_rep(np.asarray(
                den[0] if squeeze else den, dtype=np_dtype)),
            self._put_rep(np.asarray(tol, dtype=np_dtype)),
        )
        y = np.asarray(x, dtype=np.float64)[:n]
        y = (y + alpha[0]) if squeeze else (y + alpha[None, :])
        return y, int(iters), float(res)
