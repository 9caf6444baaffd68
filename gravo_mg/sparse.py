"""Static-shape sparse containers for the device solve.

Design rationale (vs the reference's Eigen CSC matrices,
`gravomg/include/gravomg/utility.h:13`): XLA requires static shapes, so
every sparse operator on the device is an **ELL (padded-row) matrix**
stored TRANSPOSED: ``indices (K, N) int32``, ``values (K, N)``, slots
padded with index 0 / value 0.  SpMV is one gather of ``x`` per slot and a
reduction over the slot axis, which XLA fuses into a single pass that
streams ``indices``/``values`` once.  With the row dimension minor, every
slot's index and value loads are contiguous across rows.  Vectors are kept
1-D; multi-RHS batching uses vmap so batch dims stay major.

Irregular, data-dependent work (deduplication, pattern discovery) happens
once on the host at setup time; the per-solve device code is pure
static-shape gathers and reductions.  This replaces the reference's
per-solve Eigen SpGEMM (`gravomg/src/multigrid_solver.cpp:1387-1392`).

``ShuffleEll`` is a second, block-structured layout that the row-
partitioned halo solver (:mod:`gravo_mg.parallel.halo`) still uses for its
per-device blocks; the single-device solve does not use it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class EllMatrix:
    """Padded-row sparse matrix, transposed layout: (K, N) slot-major."""

    indices: jnp.ndarray   # (K, N) int32, padding = 0
    values: jnp.ndarray    # (K, N), padding = 0
    ncols: int             # static

    def tree_flatten(self):
        return (self.indices, self.values), (self.ncols,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])

    @property
    def shape(self):
        return (self.indices.shape[1], self.ncols)

    @property
    def nnz_padded(self):
        return self.indices.shape[0] * self.indices.shape[1]

    def diagonal(self):
        """Extract the diagonal (each row's entry with col == row)."""
        k, n = self.indices.shape
        rows = jax.lax.broadcasted_iota(self.indices.dtype, (k, n), 1)
        return jnp.sum(jnp.where(self.indices == rows, self.values, 0), axis=0)

    def to_scipy(self) -> sp.csr_matrix:
        k, n = self.indices.shape
        rows = np.tile(np.arange(n), k)
        cols = np.asarray(self.indices).reshape(-1)
        vals = np.asarray(self.values).reshape(-1)
        keep = vals != 0
        m = sp.coo_matrix(
            (vals[keep], (rows[keep], cols[keep])), shape=(n, self.ncols)
        )
        return m.tocsr()


def ell_pattern(A_csr) -> np.ndarray:
    """(K, N) int32 transposed-ELL column indices of a csr matrix (host).

    K is the largest row degree (at least 1); padding slots hold index 0.
    Values for the same pattern come from :func:`ell_values`.
    """
    degree = np.diff(A_csr.indptr)
    n = A_csr.shape[0]
    k = max(int(degree.max()) if n else 1, 1)
    idx = np.zeros((k, n), dtype=np.int32)
    slot = np.arange(A_csr.indices.shape[0]) - np.repeat(A_csr.indptr[:-1], degree)
    idx[slot, np.repeat(np.arange(n), degree)] = A_csr.indices
    return idx


def ell_values(A_csr, k: int, dtype=np.float64) -> np.ndarray:
    """(K, N) transposed-ELL values of a csr matrix (host), padding 0."""
    degree = np.diff(A_csr.indptr)
    n = A_csr.shape[0]
    vals = np.zeros((k, n), dtype=dtype)
    slot = np.arange(A_csr.indices.shape[0]) - np.repeat(A_csr.indptr[:-1], degree)
    vals[slot, np.repeat(np.arange(n), degree)] = A_csr.data
    return vals


def ell_from_scipy(A, dtype=jnp.float32, pad_to: int | None = None) -> EllMatrix:
    """Convert any scipy sparse matrix to transposed ELL. Host-side."""
    A = A.tocsr()
    A.sum_duplicates()
    idx = ell_pattern(A)
    k = max(idx.shape[0], pad_to or 1)
    if k > idx.shape[0]:
        idx = np.concatenate(
            [idx, np.zeros((k - idx.shape[0], idx.shape[1]), np.int32)]
        )
    values = ell_values(A, k, dtype=np.dtype(dtype))
    return EllMatrix(jnp.asarray(idx), jnp.asarray(values), A.shape[1])


def spmv_1d(A: EllMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x for 1-D x: gather + slot-axis reduction, all (K, N)."""
    g = jnp.take(x, A.indices, axis=0)  # (K, N)
    return jnp.sum(A.values * g, axis=0)


def spmv(A, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x for x of shape (N,) or (N, d).

    Dispatches on the container: EllMatrix (the solve path) or ShuffleEll
    (the halo solver's per-device blocks).
    """
    if isinstance(A, ShuffleEll):
        return shuffle_spmv(A, x)
    if x.ndim == 1:
        return spmv_1d(A, x)
    return jax.vmap(lambda c: spmv_1d(A, c), in_axes=1, out_axes=1)(x)


# ---------------------------------------------------------------------------
# Shuffle-ELL: the halo solver's block layout
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShuffleEll:
    """Sparse matrix laid out as 128-row groups that each read one
    128-aligned block of ``x`` per slot.

    Every nnz (i, j) is assigned a slot k such that, within each group of
    128 consecutive output rows, slot k sources from a SINGLE block of x:
    ``q[k, i//128] = j//128`` uniformly over the group, and
    ``r[k, s, i%128] = j%128`` selects the lane.  SpMV is then

        z = xb[q]                                   # block gather
        y = sum_k v[k] * take_along_axis(z[k], r[k])

    The slot count KP is data-dependent (sum over source blocks of the
    max per-lane multiplicity, maximized over groups) — small for
    index-localized matrices, which mesh Laplacians and Galerkin-reduced
    operators are after the hierarchy's index-ordered sampling.  The halo
    solver splits each device's block by slot into an interior part (local
    source blocks) and a halo part (received blocks), which this layout
    makes a per-slot decision.
    """

    q: jnp.ndarray   # (KP, S) int32 — source block per (slot, row group)
    r: jnp.ndarray   # (KP, S, 128) int8 — lane within block (0..127)
    v: jnp.ndarray   # (KP, S, 128) — values (0 = padding)
    nrows: int
    ncols: int

    def tree_flatten(self):
        return (self.q, self.r, self.v), (self.nrows, self.ncols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0], aux[1])

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def kp(self):
        return self.q.shape[0]

    def to_scipy(self) -> sp.csr_matrix:
        kp, s = self.q.shape
        qn = np.asarray(self.q)
        rn = np.asarray(self.r)
        vn = np.asarray(self.v)
        cols = (qn[:, :, None] * 128 + rn).reshape(-1)
        rows = np.tile(
            np.arange(s * 128, dtype=np.int64).reshape(1, s, 128), (kp, 1, 1)
        ).reshape(-1)
        vals = vn.reshape(-1)
        keep = (vals != 0) & (rows < self.nrows) & (cols < self.ncols)
        m = sp.coo_matrix(
            (vals[keep], (rows[keep], cols[keep])),
            shape=(self.nrows, self.ncols),
        )
        m.sum_duplicates()
        return m.tocsr()


def _shuffle_layout(rows: np.ndarray, cols: np.ndarray, nr: int, nc: int,
                    kc: int = 4):
    """Host-side slot assignment for shuffle-ELL (see ShuffleEll).

    Returns (KP, S, q, flat_pos): ``q`` the (KP, S) block table and
    ``flat_pos[p]`` the destination of input nnz p inside the flattened
    (KP, S, 128) value/lane arrays.  Duplicate (row, col) pairs get
    distinct slots (COO summation semantics).  KP is padded to a multiple
    of ``kc`` and S to a multiple of 8; the halo solver's per-device
    blocks share one such shape.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    nnz = rows.size
    S = max(-(-nr // 128), 1)
    S += (-S) % 8
    if nnz == 0:
        q = np.zeros((kc, S), np.int32)
        return kc, S, q, np.zeros((0,), np.int64)
    from .native import shuffle_layout as native_layout

    kp_cap = int(np.bincount(rows >> 7).max())  # kp <= max nnz per group
    res = native_layout(rows, cols, S, kc, kp_cap)
    if res is not None:
        kp, q, flat_pos = res
        return kp, S, q, flat_pos
    grp = rows >> 7
    lane = rows & 127
    blk = cols >> 7
    nblk = int(blk.max()) + 1
    # one composite radix sort by (group, block, lane); everything below
    # is O(nnz) segment arithmetic on the sorted order.
    comp = (grp * nblk + blk) * 128 + lane
    from .native import argsort_i64

    res = argsort_i64(comp)
    if res is not None:
        comp_s, order = res
    else:
        order = np.argsort(comp, kind="stable")
        comp_s = comp[order]
    # t: occurrence rank within each (group, block, lane) run
    new = np.ones(nnz, dtype=bool)
    new[1:] = comp_s[1:] != comp_s[:-1]
    run_start = np.flatnonzero(new)
    run_id = np.cumsum(new) - 1
    t = np.arange(nnz, dtype=np.int64) - run_start[run_id]
    # (group, block) segments; a segment occupies m = max_lane(count)
    # consecutive slots within its group
    gb_s = comp_s >> 7
    new2 = np.ones(nnz, dtype=bool)
    new2[1:] = gb_s[1:] != gb_s[:-1]
    seg_start = np.flatnonzero(new2)
    seg_id = np.cumsum(new2) - 1
    m = np.maximum.reduceat(t, seg_start) + 1
    g_seg = gb_s[seg_start] // nblk
    b_seg = gb_s[seg_start] % nblk
    base_global = np.cumsum(m) - m
    first_seg = np.searchsorted(g_seg, g_seg)   # first segment of own group
    base_in_group = base_global - base_global[first_seg]
    kp = int((base_in_group + m).max())
    kp += (-kp) % kc
    slot_nnz = base_in_group[seg_id] + t
    flat_pos = np.empty(nnz, dtype=np.int64)
    flat_pos[order] = (slot_nnz * S + (gb_s // nblk)) * 128 + (comp_s & 127)
    # q table: segment (g, b) fills rows [base, base+m) of column g with b
    total = int(m.sum())
    ksl = np.repeat(base_in_group, m) + (
        np.arange(total, dtype=np.int64) - np.repeat(base_global, m)
    )
    q = np.zeros((kp, S), np.int32)
    q[ksl, np.repeat(g_seg, m)] = np.repeat(b_seg, m)
    return kp, S, q, flat_pos


def shuffle_from_scipy(A, dtype=jnp.float32) -> ShuffleEll:
    """Convert any scipy sparse matrix to shuffle-ELL (host-side)."""
    A = A.tocoo()
    A.sum_duplicates()
    nr, nc = A.shape
    kp, s, q, pos = _shuffle_layout(A.row, A.col, nr, nc)
    padded = kp * s * 128
    # Lanes 0..127 fit int8 (a quarter of int32's index traffic).
    r = np.zeros((padded,), np.int8)
    v = np.zeros((padded,), np.dtype(dtype))
    r[pos] = (np.asarray(A.col, np.int64) & 127).astype(np.int8)
    v[pos] = A.data
    return ShuffleEll(
        jnp.asarray(q),
        jnp.asarray(r.reshape(kp, s, 128)),
        jnp.asarray(v.reshape(kp, s, 128)),
        nr, nc,
    )


def shuffle_spmv_1d(A: ShuffleEll, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x via block gather + per-lane gather and FMA (see ShuffleEll)."""
    kp, s = A.q.shape
    nc_pad = -(-A.ncols // 128) * 128
    if nc_pad != A.ncols:
        xb = jnp.concatenate(
            [x, jnp.zeros((nc_pad - A.ncols,), x.dtype)]
        ).reshape(-1, 128)
    else:
        xb = x.reshape(-1, 128)
    z = jnp.take(xb, A.q.reshape(-1), axis=0).reshape(kp, s, 128)
    v = A.v if A.v.dtype == x.dtype else A.v.astype(x.dtype)
    g = jnp.take_along_axis(z, A.r.astype(jnp.int32), axis=2)
    y = jnp.sum(v * g, axis=0)
    return y.reshape(-1)[: A.nrows]


def shuffle_spmv(A: ShuffleEll, x: jnp.ndarray) -> jnp.ndarray:
    if x.ndim == 1:
        return shuffle_spmv_1d(A, x)
    cols = [shuffle_spmv_1d(A, x[:, d]) for d in range(x.shape[1])]
    return jnp.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# Grid transfers
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TransferPair:
    """Grid-transfer pair as two stored matrices, U (prolong) and U^T
    (restrict), each applied as a gather SpMV (no scatter).  Duck-types
    the Prolongation interface used by the cycle."""

    U: object    # EllMatrix or ShuffleEll, (Nf, Nc)
    UT: object   # same container type, (Nc, Nf)

    def tree_flatten(self):
        return (self.U, self.UT), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def ncoarse(self):
        return self.U.shape[1]

    def prolong(self, e):
        return spmv(self.U, e)

    def restrict(self, r):
        return spmv(self.UT, r)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Prolongation:
    """Sparse prolongation U, fixed row width W, transposed (W, Nf) layout.

    W = 3 for the main Gravo-MG hierarchy (triangle barycentric weights,
    rows sum to 1; `multigrid_solver.cpp:287-457`); alternative hierarchies
    (SIG06 1-ring inverse-distance, ablation closest-n) use wider rows.

      prolong(e):  x = sum_w weights[w] * e[cols[w]]      (gather)
      restrict(r): segment-sum of w * r into coarse rows (pre-sorted plan)

    ``perm``/``seg_ids`` are a host-precomputed sorted scatter plan so the
    restriction lowers to `segment_sum(..., indices_are_sorted=True)`.
    """

    cols: jnp.ndarray      # (W, Nf) int32
    weights: jnp.ndarray   # (W, Nf)
    perm: jnp.ndarray      # (W*Nf,) int32 — argsort of cols.flatten()
    seg_ids: jnp.ndarray   # (W*Nf,) int32 — cols.flatten()[perm]
    ncoarse: int           # static

    def tree_flatten(self):
        return (self.cols, self.weights, self.perm, self.seg_ids), (self.ncoarse,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])

    @property
    def shape(self):
        return (self.cols.shape[1], self.ncoarse)

    def prolong(self, e: jnp.ndarray) -> jnp.ndarray:
        """U @ e: coarse -> fine (1-D or (Nc, d))."""
        if e.ndim == 1:
            g = jnp.take(e, self.cols, axis=0)      # (W, Nf)
            return jnp.sum(self.weights * g, axis=0)
        return jax.vmap(
            lambda c: self.prolong(c), in_axes=1, out_axes=1
        )(e)

    def restrict(self, r: jnp.ndarray) -> jnp.ndarray:
        """U.T @ r: fine -> coarse, via sorted segment-sum."""
        if r.ndim == 1:
            contrib = (self.weights * r[None, :]).reshape(-1)
            contrib = jnp.take(contrib, self.perm)
            return jax.ops.segment_sum(
                contrib, self.seg_ids, num_segments=self.ncoarse,
                indices_are_sorted=True,
            )
        return jax.vmap(
            lambda c: self.restrict(c), in_axes=1, out_axes=1
        )(r)

    def to_scipy(self) -> sp.csr_matrix:
        # Prefer the host-side mirror kept by make_prolongation, so setup
        # never reads device arrays back.
        cols = getattr(self, "host_cols", None)
        wts = getattr(self, "host_weights", None)
        if cols is None or wts is None:
            cols = np.asarray(self.cols)
            wts = np.asarray(self.weights)
        w, nf = cols.shape
        rows = np.tile(np.arange(nf), w)
        m = sp.coo_matrix(
            (wts.reshape(-1).astype(np.float64), (rows, cols.reshape(-1))),
            shape=(nf, self.ncoarse),
        )
        m.sum_duplicates()
        return m.tocsr()


def make_prolongation(cols: np.ndarray, weights: np.ndarray, ncoarse: int,
                      dtype=jnp.float32) -> Prolongation:
    """Build a Prolongation + its restriction plan on the host.

    ``cols``/``weights`` arrive row-major (Nf, W) from the hierarchy
    builders and are transposed into the device layout here.
    """
    cols_t = np.ascontiguousarray(np.asarray(cols, dtype=np.int32).T)
    w_t = np.ascontiguousarray(np.asarray(weights).T)
    flat = cols_t.reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    seg = flat[perm].astype(np.int32)
    # Leaves stay HOST numpy: hierarchy construction never touches the
    # device.  The solve path builds its own device transfer operators
    # (MultigridSolveContext._build_transfer); these leaves reach the
    # device only through the GSPMD path or direct eager use, where jax
    # converts them at dispatch.
    P = Prolongation(
        cols_t,
        w_t.astype(np.dtype(dtype)),
        perm,
        seg,
        int(ncoarse),
    )
    # Host mirror so setup-time to_scipy() never round-trips the device
    # even for instances whose leaves were later device-committed.
    P.host_cols = cols_t
    P.host_weights = w_t
    return P


def ell_to_dense(A: EllMatrix) -> jnp.ndarray:
    """Densify a (small) ELL matrix on device — used for the coarsest level."""
    k, n = A.indices.shape
    rows = jnp.broadcast_to(jnp.arange(n)[None, :], (k, n))
    dense = jnp.zeros((n, A.ncols), dtype=A.values.dtype)
    return dense.at[rows.reshape(-1), A.indices.reshape(-1)].add(
        A.values.reshape(-1)
    )
