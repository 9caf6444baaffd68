"""Multigrid solve path: Galerkin reduction, cycles, outer iteration.

Layer L3 of the reference (`MultigridSolver::solve`,
gravomg/src/multigrid_solver.cpp:1279-1485) rebuilt for an accelerator:

* the Galerkin chain ``Abar[k+1] = U_k^T Abar[k] U_k`` (reference
  ``:1387-1392``) runs **on the host** in f64 (scipy SpGEMM) — setup is
  irregular pattern discovery, which is host work in this architecture;
  the device sees only the static-shape ELL operators that come out of
  it.  Setup issues ZERO device compiles: every per-level artifact
  (patterns, diagonals, spectral bounds, the coarse inverse) is computed
  host-side and uploaded, so first-solve latency is the cycle compile
  alone;
* V/F/W cycles (reference ``:1059-1192``) are Python-unrolled over the
  <=10 levels inside a single jitted function — no data-dependent control
  flow, so XLA fuses smoother sweeps, transfers and residuals;
* the coarsest level (<= lower_bound rows) is densified and inverted
  through its Cholesky factor (host LAPACK, f64) once per LHS (reference
  ``coarsestSolver``, ``:1401``);
* the outer iterate-to-tolerance loop offers a host-stepped mode that
  records the reference's per-cycle ``(elapsed_ms, residual)`` convergence
  trace (``:1414``) and a fused ``lax.while_loop`` mode for benchmarking.
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..enums import CycleType, Smoother
from ..hierarchy.builder import Hierarchy
from ..sparse import (
    EllMatrix,
    Prolongation,
    TransferPair,
    ell_from_scipy,
    ell_pattern,
    ell_values,
    spmv,
)
from .residual import residual_denominator, residual_norm, residual_numerator
from .smoothers import chebyshev, jacobi


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class LevelOps:
    """Per-level operator bundle used inside the jitted cycle."""

    A: EllMatrix
    diag_inv: jnp.ndarray
    lam_max: jnp.ndarray
    U: TransferPair | Prolongation

    def tree_flatten(self):
        return (self.A, self.diag_inv, self.lam_max, self.U), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static cycle configuration (hashable; jit static argument)."""

    cycle_type: int = int(CycleType.V)
    pre_iters: int = 4
    post_iters: int = 4
    smoother: int = int(Smoother.CHEBYSHEV)
    jacobi_omega: float = 2.0 / 3.0
    # Smoothing band [lam_max/cheb_ratio, cheb_safety*lam_max], chosen
    # by experiments/tune_smoother.py (validated at 1M by
    # experiments/tune_1m.py): cycles-to-1e-4 on the 1M Poisson torus by
    # (degree, ratio) — (2,4): 15, (2,12): 11, (3,12): 7, (4,12): 5.
    # Cycle counts do not depend on the device; the cost per cycle does,
    # so the degree/ratio trade-off is to be re-measured on the GPU.  The
    # knee is flat in [8, 16]; beyond ~24 the band is too wide for these
    # degrees and counts rise again.  The reference's
    # default of TWO Gauss-Seidel sweeps (multigrid_solver.cpp:1194-1226)
    # maps to a comparable per-cycle contraction; parity is convergence
    # at tolerance, not sweep-for-sweep equivalence (SURVEY §7.3).
    cheb_ratio: float = 12.0
    cheb_safety: float = 1.1
    num_levels: int = 0
    # Mixed precision.  The Galerkin chain is always computed in f64 on the
    # host (galerkin_chain_scipy) and cast to the compute dtype at upload;
    # the exact constant-mode deflation (solve()) plus the rank-1 nullspace
    # regularization of the coarse factor make f32 compute safe even for
    # regularized Poisson systems (eta*M + S, eta=1e-6).  The (small)
    # coarse dense factor always runs in f64.  ``precise_galerkin`` is kept
    # for API compatibility; the chain is f64 regardless.
    precise_galerkin: bool = False
    # Near-singular systems only: project the constant mode out of each
    # coarse correction.  The rank-1 regularization sigma*(1 1^T)/n makes
    # the factor SPD but leaks an exact (1^T rc)/sigma constant into the
    # correction; since the symmetric coarse operator block-diagonalizes
    # over span{1} (+) 1-perp, subtracting the mean removes that leak
    # exactly — without it, tight-tolerance (f64, <=1e-10) Poisson solves
    # stall around 1e-8.
    coarse_null_project: bool = False


def _smooth(cfg: SolverConfig, ops: LevelOps, b, x, iters: int):
    if iters <= 0:
        return x
    if cfg.smoother == int(Smoother.JACOBI):
        return jacobi(ops.A, ops.diag_inv, b, x, iters, cfg.jacobi_omega)
    lam_max = cfg.cheb_safety * ops.lam_max
    lam_min = ops.lam_max / cfg.cheb_ratio
    return chebyshev(ops.A, ops.diag_inv, b, x, iters, lam_min, lam_max)


def refined_inverse_apply(Ainv, Ad, rhs):
    """``e = Ainv rhs`` plus one refinement step ``e += Ainv (rhs - Ad e)``.

    Every product states ``Precision.HIGHEST``: without it a GPU may run
    these f32 products in TF32, which keeps about 3 decimal digits, and
    one refinement step cannot recover from that.  Shared by the
    single-device and halo coarse solves.
    """
    hi = jax.lax.Precision.HIGHEST
    e = jnp.matmul(Ainv, rhs, precision=hi)
    return e + jnp.matmul(
        Ainv, rhs - jnp.matmul(Ad, e, precision=hi), precision=hi
    )


def _coarse_solve(coarse, rc, null_project: bool = False):
    """Coarsest-level solve as two dense matrix products: apply the
    host-precomputed (regularized) inverse, then one iterative-refinement
    step.

    Rationale: the inverse apply is two small dense products, where a
    triangular solve of the Cholesky factor is a chain of dependent
    row updates.  The refinement step ``e += Ainv (rc - Ad e)`` squares
    the effective accuracy, so even in f32 the coarse correction is exact
    to well below smoother noise; in f64 contexts it is LU-quality
    (tests/test_f64.py solves to 1e-10).  ``coarse = (Ainv, Ad)``, both
    in compute dtype, Ad regularized identically to the inverse (see
    coarse_inverse_host).
    """
    Ainv, Ad = coarse
    one_d = rc.ndim == 1
    rhs = (rc[:, None] if one_d else rc).astype(Ainv.dtype)
    e = refined_inverse_apply(Ainv, Ad, rhs)
    if null_project:
        e = e - jnp.mean(e, axis=0, keepdims=True)
    e = e.astype(rc.dtype)
    return e[:, 0] if one_d else e


def _cycle(cfg: SolverConfig, levels, coarse, b, x, k: int, kind: int):
    """Recursive cycle, unrolled at trace time (kind: 0=V, 1=F, 2=W)."""
    ops = levels[k]
    x = _smooth(cfg, ops, b, x, cfg.pre_iters)
    r = b - spmv(ops.A, x)
    rc = ops.U.restrict(r)
    if k == cfg.num_levels - 1:
        e = _coarse_solve(coarse, rc, cfg.coarse_null_project)
    else:
        e = _cycle(cfg, levels, coarse, rc, jnp.zeros_like(rc), k + 1, kind)
    x = x + ops.U.prolong(e)
    x = _smooth(cfg, ops, b, x, cfg.post_iters)
    if kind != int(CycleType.V):
        # F- and W-cycles run a second correction pass
        # (multigrid_solver.cpp:1091-1192); F recurses into V, W into W.
        r = b - spmv(ops.A, x)
        rc = ops.U.restrict(r)
        if k == cfg.num_levels - 1:
            e = _coarse_solve(coarse, rc, cfg.coarse_null_project)
        else:
            kind2 = int(CycleType.V) if kind == int(CycleType.F) else kind
            e = _cycle(
                cfg, levels, coarse, rc, jnp.zeros_like(rc), k + 1, kind2
            )
        x = x + ops.U.prolong(e)
        x = _smooth(cfg, ops, b, x, cfg.post_iters)
    return x


@partial(jax.jit, static_argnames=("cfg",))
def cycle_step(cfg: SolverConfig, levels, coarse, b, x):
    return _cycle(cfg, levels, coarse, b, x, 0, cfg.cycle_type)


@partial(jax.jit, static_argnames=("cfg", "criteria", "max_iter"))
def fused_solve(
    cfg: SolverConfig, levels, coarse, M, Minv_diag, b, x0, den,
    tol, criteria: int, max_iter: int,
):
    """Entire iterate-to-tolerance loop on device; returns the residual
    trace in a fixed (max_iter,) buffer (inf where unused).

    ``den`` is the per-column residual denominator, precomputed from the
    *original* (pre-deflation) RHS.
    """
    A = levels[0].A

    def cond(carry):
        _, it, res, _ = carry
        return (res > tol) & (it < max_iter)

    def body(carry):
        x, it, _, trace = carry
        x = _cycle(cfg, levels, coarse, b, x, 0, cfg.cycle_type)
        num = residual_numerator(A, M, Minv_diag, b, x, criteria)
        res = jnp.max(num / den)
        trace = trace.at[it].set(res)
        return x, it + 1, res, trace

    trace0 = jnp.full((max_iter,), jnp.inf, dtype=x0.dtype)
    x, iters, res, trace = jax.lax.while_loop(
        cond, body, (x0, jnp.int32(0), jnp.asarray(jnp.inf, x0.dtype), trace0)
    )
    return x, iters, res, trace


def deflation_alpha(row_sums: np.ndarray, rhs2: np.ndarray) -> np.ndarray:
    """Exact rank-1 constant-mode deflation coefficients (f64, (d,)).

    Deflate iff the row-sum vector is SIGN-COHERENT: ``|sum(row_sums)| >
    0.1 * sum(|row_sums|)``.  A genuine near-null regularization
    (``eta * M @ 1``, all-positive entries) passes with ratio ~1 at ANY
    mesh scale, while pure assembly roundoff (random signs, ratio
    ~1/sqrt(n)) is rejected — dividing by it would produce astronomically
    wrong alphas.

    History: the previous gate compared |denom| against an absolute
    ``1e-12 * mean|diag| * n`` cutoff, which silently DISABLED deflation
    on area-normalized meshes (denom = eta * total_area shrinks with the
    normalization while the matrix scale does not).  With deflation off
    but the near-singular coarse handling on, the constant component of
    the solution is unreachable — the Chebyshev smoother preserves it
    (p(0) = 1) and the coarse nullspace projection actively removes it —
    so every hierarchy stalled at ~1e-3 relative residual on the
    comparison suite's normalized >=262k tori (round-5 tables, first
    run).  tests/test_deflation.py covers the scaled-mesh regression.
    """
    denom = float(row_sums.sum())
    abs_sum = float(np.abs(row_sums).sum())
    if abs_sum > 0.0 and abs(denom) > 0.1 * abs_sum:
        return np.asarray(rhs2.sum(axis=0) / denom, dtype=np.float64)
    return np.zeros(rhs2.shape[1])


def galerkin_chain_scipy(lhs_csr, U_csr_list) -> list:
    """Host Galerkin chain ``Abar[k+1] = U_k^T Abar[k] U_k`` in f64.

    Replaces the reference's per-solve Eigen SpGEMM
    (multigrid_solver.cpp:1387-1392) with scipy's SpGEMM.  The output
    *pattern* is structural (independent of values), so same-pattern LHS
    updates reuse every downstream layout.  Returns ``[A0, Abar1, ..., Abar_L]`` csr.
    """
    A = lhs_csr.tocsr().astype(np.float64)
    A.sum_duplicates()
    A.sort_indices()
    chain = [A]
    for U in U_csr_list:
        A = (U.T.tocsr() @ (A @ U)).tocsr()
        A.sum_duplicates()
        A.sort_indices()
        chain.append(A)
    return chain


def lambda_max_host(A_csr, diag_inv: np.ndarray, iters: int = 15,
                    seed: int = 0) -> float:
    """Spectral radius of D^-1 A by host power iteration (setup-time
    analog of smoothers.estimate_lambda_max — scipy SpMVs are cheap and
    avoid per-level device compiles)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A_csr.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = diag_inv * (A_csr @ v)
        lam = np.linalg.norm(w)
        v = w / max(lam, 1e-30)
    return float(lam)


def coarse_inverse_host(A_coarse_csr, null_fix: bool):
    """(Ainv, Ad) f64 numpy: explicit inverse of the regularized coarse
    operator plus the regularized dense operator itself (for the device
    refinement step in _coarse_solve).  Built from the Cholesky factor
    (coarse_factor_host) rather than np.linalg.inv for stability."""
    import scipy.linalg

    cho = coarse_factor_host(A_coarse_csr, null_fix)
    nc = cho.shape[0]
    Ainv = scipy.linalg.cho_solve((cho, True), np.eye(nc))
    Ad = np.asarray(A_coarse_csr.todense(), dtype=np.float64)
    diag_scale = float(np.mean(np.abs(np.diag(Ad))))
    Ad[np.diag_indices(nc)] += 1e-12 * diag_scale
    if null_fix:
        Ad += diag_scale / nc
    return Ainv, Ad


def coarse_factor_host(A_coarse_csr, null_fix: bool) -> np.ndarray:
    """Dense f64 Cholesky of the coarsest operator (host LAPACK).

    ``null_fix`` enables the rank-1 nullspace regularization: for
    near-singular systems (Poisson eta*M + S) the coarse matrix has a
    near-null constant mode (~1e-9 of its norm) whose Cholesky cannot be
    computed stably.  Since the outer solve deflates the constant
    component from the RHS exactly, the coarse correction never needs to
    produce constants, so adding sigma * (1 1^T)/n — which only moves the
    near-null eigenvalue — leaves the effective correction unchanged while
    making the factorization solidly SPD.  A tiny relative diagonal shift
    plays the role of the reference's LDLT robustness
    (min_quad_with_fixed_mg.cpp:31-36).
    """
    Ad = np.asarray(A_coarse_csr.todense(), dtype=np.float64)
    nc = Ad.shape[0]
    diag_scale = float(np.mean(np.abs(np.diag(Ad))))
    Ad[np.diag_indices(nc)] += 1e-12 * diag_scale
    if null_fix:
        Ad += diag_scale / nc
    return np.linalg.cholesky(Ad)


def _prepare_enabled() -> bool:
    """Whether ``prepare_async`` compiles in the background: on device
    backends yes (the compile overlaps the host's remaining setup work),
    on the CPU backend no.  ``GRAVO_MG_NO_WARMUP=1`` turns it off and
    ``GRAVO_MG_FORCE_WARMUP=1`` turns it on for the CPU (tests)."""
    if os.environ.get("GRAVO_MG_NO_WARMUP") == "1":
        return False
    if os.environ.get("GRAVO_MG_FORCE_WARMUP") == "1":
        return True
    return jax.default_backend() != "cpu"


class MultigridSolveContext:
    """Caches everything reusable across solves for one (hierarchy, LHS
    pattern): chain patterns, device ELL index arrays, transfer
    operators, coarse inverse.  All setup is host-side — no device
    compiles."""

    def __init__(
        self,
        hierarchy: Hierarchy,
        lhs_csr,
        mass_csr,
        cfg: SolverConfig,
        dtype=jnp.float32,
    ):
        self.hierarchy = hierarchy
        self.cfg = dataclasses.replace(cfg, num_levels=hierarchy.num_levels)
        self.dtype = dtype
        self.timing: dict = {}

        t_setup = t0 = time.perf_counter()
        self.lhs_csr = lhs_csr.tocsr()
        self._analyze_lhs()
        self.cfg = dataclasses.replace(
            self.cfg, coarse_null_project=self.near_singular
        )
        self.timing["setup_analyze"] = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        self.mass_csr = mass_csr.tocsr()
        self.M = ell_from_scipy(self.mass_csr, dtype=dtype)
        minv = 1.0 / np.maximum(np.asarray(mass_csr.diagonal()), 1e-30)
        self.Minv_diag = jnp.asarray(minv, dtype=dtype)
        self.timing["setup_mass"] = (time.perf_counter() - t0) * 1000

        # --- pattern discovery: f64 scipy Galerkin chain ------------------
        # Sub-phase timings land in self.timing as setup_* keys;
        # plan_build keeps its aggregate meaning.  All of this is pure
        # host work: U csr matrices come from the Prolongation host
        # mirrors, never from device reads.
        t0 = time.perf_counter()
        self.U_csr = [lvl.U.to_scipy() for lvl in hierarchy.levels]
        self.timing["setup_u_host"] = (time.perf_counter() - t0) * 1000
        t1 = time.perf_counter()
        chain = galerkin_chain_scipy(self.lhs_csr, self.U_csr)
        self.chain_csr = chain   # kept for the distributed partitioner
        self.timing["setup_chain"] = (time.perf_counter() - t1) * 1000
        t1 = time.perf_counter()
        # Pattern artifacts, reused across same-pattern LHS updates: the
        # (K, N) ELL index array of every level, uploaded once.
        self._level_idx = [jnp.asarray(ell_pattern(A)) for A in chain[:-1]]
        self.timing["setup_patterns"] = (time.perf_counter() - t1) * 1000
        self.timing["plan_build"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        self.transfers = tuple(
            self._build_transfer(kU) for kU in enumerate(self.U_csr)
        )
        self.timing["setup_transfers"] = (time.perf_counter() - t0) * 1000

        # --- values: fill layouts, spectral bounds, coarse factor, upload -
        self._reduce_and_upload(chain)
        self._prepare_threads: dict = {}
        self.timing["setup"] = (time.perf_counter() - t_setup) * 1000

    def _plan_level(self, k: int, A_csr) -> EllMatrix:
        """Level k's device operator: transposed ELL over the cached index
        array, with values refilled from ``A_csr`` (same pattern).

        ELL was chosen over the block-shuffled ShuffleEll layout by
        measurement on an H100 (PERF.md, "Bring-up on the H100"): a
        gather of ``x`` per slot is a plain vectorised load there, and
        ELL moves the fewest bytes.  Its padding is bounded by the row
        degree: K * N slots for nnz entries.
        """
        idx = self._level_idx[k]
        vals = ell_values(A_csr, idx.shape[0], dtype=np.dtype(self.dtype))
        return EllMatrix(idx, jnp.asarray(vals), A_csr.shape[1])

    def _build_transfer(self, k_and_Ucsr):
        """Device transfer pair for level k: ELL U (fixed width W) and ELL
        U^T, both gathers, chosen by measurement on an H100 (PERF.md).

        Pathology guard: U^T's ELL width is the largest number of fine
        rows one coarse vertex feeds.  Where that pads beyond 8x nnz
        (wide-row sig06/ablation prolongations with a few hub vertices),
        fall back to the hierarchy's Prolongation (gather + sorted
        segment-sum, footprint W x Nf) — same duck-typed interface."""
        k, Ucsr = k_and_Ucsr
        UT = Ucsr.T.tocsr()
        width = int(np.diff(UT.indptr).max()) if UT.nnz else 1
        if width * UT.shape[0] > max(8 * UT.nnz, 1 << 20):
            P = self.hierarchy.levels[k].U
            # Device copy: the hierarchy keeps host-numpy leaves (setup
            # must not touch the device); as a cycle operand they must be
            # device arrays or every dispatch re-uploads them.
            return Prolongation(
                jnp.asarray(P.cols),
                jnp.asarray(np.asarray(P.weights), dtype=self.dtype),
                jnp.asarray(P.perm),
                jnp.asarray(P.seg_ids),
                P.ncoarse,
            )
        return TransferPair(
            ell_from_scipy(Ucsr, dtype=self.dtype),
            ell_from_scipy(UT, dtype=self.dtype),
        )

    def _reduce_and_upload(self, chain):
        """Value-dependent half of setup: per-level ELL values,
        diagonals, lambda_max, coarse inverse — host-computed, uploaded."""
        t0 = time.perf_counter()
        levels = []
        self._host_diag_inv = []   # f64 numpy, for the halo partitioner
        self.host_lam = []
        t_values = t_spec = 0.0
        for k in range(self.cfg.num_levels):
            A = chain[k]
            t1 = time.perf_counter()
            diag = A.diagonal()
            diag_inv_np = 1.0 / np.where(np.abs(diag) > 1e-30, diag, 1.0)
            t2 = time.perf_counter()
            lam = lambda_max_host(A, diag_inv_np)
            t3 = time.perf_counter()
            diag_inv = jnp.asarray(diag_inv_np, dtype=self.dtype)
            lam_j = jnp.asarray(lam, dtype=self.dtype)
            levels.append(LevelOps(
                self._plan_level(k, A), diag_inv, lam_j, self.transfers[k]
            ))
            self._host_diag_inv.append(diag_inv_np)
            self.host_lam.append(lam)
            t_values += (t2 - t1) + (time.perf_counter() - t3)
            t_spec += t3 - t2
        self.levels = tuple(levels)
        t1 = time.perf_counter()
        Ainv, Ad = coarse_inverse_host(chain[-1], self.near_singular)
        self._host_coarse_inv = (Ainv, Ad)   # f64, for the halo partitioner
        self.coarse_op = (
            jnp.asarray(Ainv, dtype=self.dtype),
            jnp.asarray(Ad, dtype=self.dtype),
        )
        # No block_until_ready here: uploads complete on the backend's
        # transfer streams while the host finishes setup and the
        # background program compile runs (prepare_async).
        self.timing["setup_values"] = t_values * 1000
        self.timing["setup_spectral"] = t_spec * 1000
        self.timing["setup_coarse_factor"] = (time.perf_counter() - t1) * 1000
        self.timing["reduction"] = (time.perf_counter() - t0) * 1000

    @property
    def Us(self):
        return tuple(lvl.U for lvl in self.hierarchy.levels)

    @property
    def ell_levels(self):
        """The level operators with the hierarchy's Prolongation objects as
        transfers — the form the GSPMD `parallel.dist` path shards."""
        return tuple(
            dataclasses.replace(ops, U=U) for ops, U in zip(self.levels, self.Us)
        )

    def _analyze_lhs(self):
        """f64 row sums (= A @ 1) and near-singularity detection, used for
        the exact rank-1 deflation of the constant near-null mode (see
        solve()) and the coarse nullspace fix (see coarse_factor_host)."""
        self.row_sums = np.asarray(
            self.lhs_csr.sum(axis=1), dtype=np.float64
        ).ravel()
        n = self.lhs_csr.shape[0]
        scale = float(np.abs(self.lhs_csr.diagonal()).mean())
        self.near_singular = (
            abs(float(self.row_sums.sum())) < 1e-6 * scale * n
        )
        # Device copy (f64) so solve() can deflate on device: per-solve
        # host->device traffic is then ONE rhs upload instead of rhs +
        # deflated-rhs + x0.  Uploaded lazily at the first solve.
        self._row_sums_cache = None

    def update_lhs(self, lhs_csr):
        """Re-run the value-only reduction for a new LHS with the same
        sparsity pattern (hierarchy reuse across systems).  Patterns,
        device index arrays and transfers are reused; only the scipy
        chain, value fills and the coarse inverse recompute."""
        t0 = time.perf_counter()
        self.lhs_csr = lhs_csr.tocsr()
        self._analyze_lhs()
        self.cfg = dataclasses.replace(
            self.cfg, coarse_null_project=self.near_singular
        )
        chain = galerkin_chain_scipy(self.lhs_csr, self.U_csr)
        self.chain_csr = chain
        self.timing["plan_build"] = (time.perf_counter() - t0) * 1000
        self._reduce_and_upload(chain)

    # ---- program preparation (async compile) --------------------------------

    def prepare_async(self, *, cols: Optional[int] = None, criteria: int = 2,
                      max_iter: int = 100, mode: str = "fused"):
        """Compile the solve program for one signature on a daemon thread.

        The first compile of the fused loop is the largest one-time cost
        of a first solve; starting it here overlaps it with whatever host
        work follows context setup (IO, baselines, other systems).
        ``solve()`` joins a matching in-flight preparation before
        dispatch, so work is never duplicated — the per-call jit then
        resolves via the in-process executable cache.

        ``cols=None`` prepares the 1-D rhs signature, an int the (n, cols)
        one.  Gated by ``_prepare_enabled`` (off on the CPU backend).
        """
        if not self.levels or not _prepare_enabled():
            return None
        key = (mode, cols, criteria, max_iter)
        if key in self._prepare_threads:
            return self._prepare_threads[key]
        import threading

        n = self.levels[0].A.shape[0]
        shape = (n,) if cols is None else (n, cols)
        cfg = self.cfg

        def _work():
            # REAL dummy calls (zeros; tol chosen so the fused loop exits
            # after one body evaluation), not .lower().compile(): only an
            # actual call populates pjit's executable cache, so the first
            # user solve dispatches without paying retrace + persistent-
            # cache fetch.
            try:
                b0 = jnp.zeros(shape, self.dtype)
                den0 = jnp.ones((1 if cols is None else cols,), self.dtype)
                if mode == "fused":
                    out = fused_solve(
                        cfg, self.levels, self.coarse_op, self.M,
                        self.Minv_diag, b0, b0, den0,
                        jnp.asarray(1e30, self.dtype), criteria, max_iter,
                    )
                else:
                    out = (
                        cycle_step(
                            cfg, self.levels, self.coarse_op, b0, b0
                        ),
                        residual_numerator(
                            self.levels[0].A, self.M, self.Minv_diag,
                            b0, b0, criteria,
                        ),
                    )
                out = out + (residual_denominator(
                    self.M, self.Minv_diag, b0, criteria
                ),)
                jax.block_until_ready(out)
            except Exception as e:  # noqa: BLE001 — solve() recompiles/raises
                self.timing[f"prepare_error_{mode}"] = repr(e)

        t = threading.Thread(target=_work, daemon=True,
                             name=f"gravo-prepare-{mode}")
        t.start()
        self._prepare_threads[key] = t
        return t

    def _join_prepare(self, mode: str, cols: Optional[int], criteria: int,
                      max_iter: int):
        t = self._prepare_threads.get((mode, cols, criteria, max_iter))
        if t is not None and t.is_alive():
            t0 = time.perf_counter()
            t.join()
            self.timing["compile_wait"] = (time.perf_counter() - t0) * 1000

    # ---- solving -----------------------------------------------------------

    def solve(
        self,
        rhs: np.ndarray,
        x0: Optional[np.ndarray] = None,
        *,
        tol: float = 1e-4,
        criteria: int = 2,
        max_iter: int = 100,
        mode: str = "traced",
    ):
        """Iterate cycles until the residual criterion drops below tol.

        mode="traced": host-stepped, records (elapsed_ms, residual) per
        cycle like the reference (multigrid_solver.cpp:1408-1443).
        mode="fused": single device while_loop (fastest; trace has
        residuals only).

        Before iterating, the constant near-null component is removed
        exactly: substituting ``x = y + alpha*1`` with ``alpha = sum(b) /
        sum(A @ 1)`` (computed in f64) makes the transformed RHS
        mean-free, so ``y`` stays small and f32 SpMV cancellation noise
        stays far below the 1e-4 target even for near-singular systems
        (Poisson eta*M + S — whose raw solutions have O(1/eta) constant
        components the f32 residual could not even evaluate).  This is
        exact algebra, not an approximation; residual denominators use the
        original RHS, matching the reference's criteria.
        """
        t_up = time.perf_counter()
        rhs = np.asarray(rhs, dtype=np.float64)
        squeeze = rhs.ndim == 1
        rhs2 = rhs[:, None] if squeeze else rhs
        alpha = deflation_alpha(self.row_sums, rhs2)  # (d,) f64
        # ONE compute-dtype upload of the raw rhs; the exact f64 deflation
        # ``b = rhs - alpha * (A @ 1)`` runs on device against the f64
        # row_sums copy made at setup.  Precision note: the
        # rhs is quantized to compute dtype BEFORE the subtract, so for an
        # RHS dominated by the constant mode ``b`` carries ~eps_f32*|rhs|
        # absolute error — bounded relative to the den-normalized stopping
        # criteria (den uses the original rhs), i.e. ~1.2e-7 relative,
        # far below the f32 path's 1e-4..1e-6 targets.  Tight-tolerance
        # work uses dtype=f64 contexts, where the upload is f64 and the
        # subtract is exact; alpha itself is exact f64 host algebra in
        # both cases.
        rhs_dev = jnp.asarray(
            rhs2[:, 0] if squeeze else rhs2, dtype=self.dtype
        )
        alpha_dev = jnp.asarray(alpha[0] if squeeze else alpha[None, :])
        if self._row_sums_cache is None:
            self._row_sums_cache = jnp.asarray(self.row_sums)
        rs_dev = (
            self._row_sums_cache if squeeze else self._row_sums_cache[:, None]
        )
        b = (rhs_dev.astype(jnp.float64) - alpha_dev * rs_dev).astype(
            self.dtype
        )
        den = residual_denominator(
            self.M, self.Minv_diag, rhs_dev, criteria
        )
        if x0 is not None:
            # x0 deflation stays host-side f64: for near-singular systems
            # a warm start sits at O(alpha) magnitude and y0 = x0 - alpha
            # is a genuine cancellation — it must happen before the
            # compute-dtype rounding, unlike the rhs deflation above.
            x0 = np.asarray(x0, dtype=np.float64)
            x0_2 = x0[:, None] if x0.ndim == 1 else x0
            y0 = x0_2 - alpha[None, :]
            x = jnp.asarray(y0[:, 0] if squeeze else y0, dtype=self.dtype)
        else:
            x = jnp.zeros_like(b)
        cfg = self.cfg
        A = self.levels[0].A if self.levels else None
        convergence: list = []
        # The upload (and the device deflation riding on it) is per-solve
        # I/O, not iteration work: 'cycles' starts once operands are
        # resident, matching the reference's timing of its iteration loop
        # only (multigrid_solver.cpp:1279-1485 — the RHS already sits in
        # process memory there).
        jax.block_until_ready((b, den, x))
        self.timing["solve_upload"] = (time.perf_counter() - t_up) * 1000
        cols = None if squeeze else rhs2.shape[1]
        self._join_prepare(mode, cols, criteria, max_iter)
        if cfg.num_levels == 0:
            # Mesh already at/below lower_bound: the hierarchy has no
            # levels and the "coarsest" operator IS the full system
            # (galerkin_chain_scipy([]) == [A0]), so one refined inverse
            # apply solves it directly — the reference's depth-0 case
            # goes straight to its coarsest solver the same way
            # (multigrid_solver.cpp:1401).  Exercised by
            # tests/test_comparisons_smoke.py (642-vertex shape,
            # default lower_bound=1000).
            t0 = time.perf_counter()
            x = _coarse_solve(self.coarse_op, b, cfg.coarse_null_project)
            y64 = np.asarray(x, dtype=np.float64)
            y2_ = y64[:, None] if squeeze else y64
            out_ = y2_ + alpha[None, :]
            res = self.residual(
                rhs2[:, 0] if squeeze else rhs2,
                out_[:, 0] if squeeze else out_, criteria=criteria,
            )
            elapsed = (time.perf_counter() - t0) * 1000
            iters = 1
            convergence = [(elapsed, res)]
        elif mode == "fused":
            t0 = time.perf_counter()
            x, iters, res, trace = fused_solve(
                cfg, self.levels, self.coarse_op, self.M, self.Minv_diag,
                b, x, den, jnp.asarray(tol, self.dtype), criteria, max_iter,
            )
            # 'cycles' is the device loop alone: stamped when the program
            # finishes, before the solution is copied to the host.
            jax.block_until_ready((x, iters, res, trace))
            elapsed = (time.perf_counter() - t0) * 1000
            x, iters, res, trace = jax.device_get((x, iters, res, trace))
            iters = int(iters)
            res = float(res)
            trace = trace[:iters]
            # Residuals are exact per-cycle values from the device loop,
            # but timestamps are SYNTHETIC (total elapsed spread uniformly
            # — the fused while_loop has no host clock).  Flagged in the
            # timing dict; use mode="traced" for honest time-vs-residual
            # convergence plots.
            convergence = [
                (elapsed * (i + 1) / max(iters, 1), float(t))
                for i, t in enumerate(trace)
            ]
            self.timing["trace_timestamps_synthetic"] = 1.0
        else:
            # Host-stepped mode with the reference's per-cycle residual
            # check and HONEST per-cycle timestamps.  Dispatches run one
            # cycle ahead of the residual fetch so the device->host round
            # trip overlaps the next cycle's compute; at most one speculative cycle is discarded
            # once the tolerance is met (stopping semantics unchanged:
            # the returned iterate is the FIRST one meeting tol).
            from collections import deque

            t0 = time.perf_counter()
            iters = 0
            res = float("inf")
            inflight: deque = deque()
            x_next = x
            dispatched = 0
            stop = False
            while True:
                while (not stop and dispatched < max_iter
                       and len(inflight) < 2):
                    x_next = cycle_step(
                        cfg, self.levels, self.coarse_op, b, x_next
                    )
                    num = residual_numerator(
                        A, self.M, self.Minv_diag, b, x_next, criteria
                    )
                    inflight.append((x_next, jnp.max(num / den)))
                    dispatched += 1
                if not inflight:
                    break
                xq, rq = inflight.popleft()
                res = float(jax.device_get(rq))
                iters += 1
                convergence.append(
                    ((time.perf_counter() - t0) * 1000, res)
                )
                x = xq
                if res <= tol:
                    stop = True
                    inflight.clear()
            elapsed = (time.perf_counter() - t0) * 1000
        self.timing["cycles"] = elapsed
        self.timing["iterations"] = float(iters)
        self.timing["residue"] = res
        self.timing["solver_total"] = elapsed + self.timing.get("reduction", 0)
        y = np.asarray(x, dtype=np.float64)
        y2 = y[:, None] if squeeze else y
        out = y2 + alpha[None, :]
        return (out[:, 0] if squeeze else out), iters, res, convergence

    def residual(self, rhs, x, criteria: int = 2) -> float:
        """Exact residual of the *original* system, evaluated host-side in
        f64 (reporting path; solutions of near-singular systems are too
        large for f32 cancellation)."""
        rhs = np.asarray(rhs, dtype=np.float64)
        x = np.asarray(x, dtype=np.float64)
        rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs
        x2 = x[:, None] if x.ndim == 1 else x
        r = self.lhs_csr @ x2 - rhs2
        M = self.mass_csr
        if criteria == 0:
            vals = np.linalg.norm(r, axis=0) / np.maximum(
                np.linalg.norm(rhs2, axis=0), 1e-30
            )
        elif criteria == 1:
            minv = 1.0 / np.maximum(M.diagonal(), 1e-300)
            vals = np.sqrt(
                (r * (minv[:, None] * r)).sum(axis=0)
                / np.maximum((rhs2 * (minv[:, None] * rhs2)).sum(axis=0), 1e-300)
            )
        elif criteria == 2:
            vals = np.sqrt(
                (r * (M @ r)).sum(axis=0)
                / np.maximum((rhs2 * (M @ rhs2)).sum(axis=0), 1e-300)
            )
        elif criteria == 3:
            vals = [np.linalg.norm(r)]
        else:
            raise ValueError(f"unknown stopping criteria {criteria}")
        return float(np.max(vals))
