"""The solve path's sparse formats: transposed ELL SpMV and transfers
against scipy, the planner's choice, and the coarse solve's precision.

ELL (``EllMatrix``) and ELL transfer pairs were chosen for every level
by measurement on an H100 (PERF.md, "Bring-up on the H100"); these tests
pin down the format on the matrix families the solver meets and that the
planner never returns a removed format.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from gravo_mg import MultigridSolver
from gravo_mg.solver.multigrid import _coarse_solve
from gravo_mg.sparse import (
    EllMatrix,
    Prolongation,
    ShuffleEll,
    TransferPair,
    ell_from_scipy,
    make_prolongation,
    spmv,
)


def _rand_banded(n, m, bw, density, seed):
    rng = np.random.default_rng(seed)
    nnz = int(n * density)
    rows = rng.integers(0, n, nnz)
    cols = np.clip(rows * m // n + rng.integers(-bw, bw + 1, nnz), 0, m - 1)
    return sp.coo_matrix(
        (rng.standard_normal(nnz), (rows, cols)), shape=(n, m)
    ).tocsr()


def _duplicates():
    rows = np.array([0, 0, 0, 5, 5, 200])
    cols = np.array([3, 3, 3, 7, 7, 199])
    vals = np.array([1.0, 2.0, 4.0, 1.5, 2.5, -3.0])
    return sp.coo_matrix((vals, (rows, cols)), shape=(256, 256))


FAMILIES = {
    "banded": lambda: _rand_banded(1000, 1000, 30, 7, 0),
    "wide_band": lambda: _rand_banded(5000, 5000, 400, 9, 1),
    "dense_band": lambda: _rand_banded(257, 257, 256, 5, 2),
    "narrow_band": lambda: _rand_banded(4096, 4096, 5, 4, 3),
    "tiny": lambda: _rand_banded(130, 130, 129, 3, 4),
    "fully_random": lambda: sp.random(3000, 3000, density=0.002,
                                      random_state=7, format="csr"),
    "duplicates": _duplicates,
    "restriction_shaped": lambda: sp.random(250, 1000, density=0.02,
                                            random_state=8, format="csr"),
    "prolongation_shaped": lambda: sp.random(1000, 250, density=0.012,
                                             random_state=9, format="csr"),
    "empty_rows": lambda: sp.csr_matrix(
        (np.ones(3), (np.array([0, 0, 7]), np.array([1, 4, 2]))),
        shape=(9, 5)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ell_spmv_matches_scipy(family):
    A = FAMILIES[family]().tocsr()
    E = ell_from_scipy(A, dtype=jnp.float64)
    assert isinstance(E, EllMatrix) and E.shape == A.shape
    x = np.random.default_rng(10).standard_normal(A.shape[1])
    y = np.asarray(jax.jit(spmv)(E, jnp.asarray(x)))
    np.testing.assert_allclose(y, A @ x, rtol=1e-10, atol=1e-10)


def test_ell_spmv_multi_rhs():
    A = _rand_banded(1024, 1024, 40, 5, 31)
    X = np.random.default_rng(6).standard_normal((1024, 3))
    Y = np.asarray(spmv(ell_from_scipy(A, dtype=jnp.float64), jnp.asarray(X)))
    np.testing.assert_allclose(Y, A @ X, rtol=1e-10, atol=1e-10)


def test_ell_spmv_f32_within_device_bound():
    """The bound chip_smoke.py holds the device to: |y - A x| <= 1e-5
    (|A| |x|) elementwise for an f32 apply of f64 data."""
    from gravo_mg.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg.utils.meshgen import torus_mesh

    V, F = torus_mesh(64, 64)
    A = (1e-6 * mass_barycentric(V, F) + cotan_laplacian(V, F)).tocsr()
    x = np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32)
    y = np.asarray(spmv(ell_from_scipy(A), jnp.asarray(x)), np.float64)
    x64 = x.astype(np.float64)
    assert np.all(np.abs(y - A @ x64) <= 1e-5 * (abs(A) @ np.abs(x64)))


def _random_u(nf, nc, seed):
    rng = np.random.default_rng(seed)
    cols = np.stack([rng.choice(nc, 3, replace=False) for _ in range(nf)])
    w = rng.random((nf, 3))
    return cols.astype(np.int32), w / w.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("kind", ["ell_pair", "prolongation"])
def test_transfer_matches_scipy(kind):
    nf, nc = 900, 130
    cols, w = _random_u(nf, nc, 3)
    P = make_prolongation(cols, w, nc, dtype=jnp.float64)
    U = P.to_scipy()
    if kind == "ell_pair":
        T = TransferPair(ell_from_scipy(U, dtype=jnp.float64),
                         ell_from_scipy(U.T.tocsr(), dtype=jnp.float64))
    else:
        T = P
    assert T.ncoarse == nc
    rng = np.random.default_rng(4)
    e, r = rng.standard_normal(nc), rng.standard_normal((nf, 3))
    np.testing.assert_allclose(np.asarray(T.prolong(jnp.asarray(e))), U @ e,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(T.restrict(jnp.asarray(r))),
                               U.T @ r, rtol=1e-10, atol=1e-12)


def _smoothing_ctx(mesh):
    solver = MultigridSolver(mesh["V"], mesh["neigh"], mesh["M"],
                             lower_bound=80)
    return solver._context((mesh["M"] + 1e-3 * mesh["S"]).tocsr())


def test_planner_chooses_ell(sphere_mesh):
    ctx = _smoothing_ctx(sphere_mesh)
    assert ctx.levels
    assert isinstance(ctx.M, EllMatrix)
    for k, ops in enumerate(ctx.levels):
        assert isinstance(ops.A, EllMatrix)
        assert ops.A.indices is ctx._level_idx[k]
        assert isinstance(ops.U, TransferPair)
        assert isinstance(ops.U.U, EllMatrix)
        assert isinstance(ops.U.UT, EllMatrix)
        assert not isinstance(ops.A, ShuffleEll)
    T = ctx._build_transfer((0, ctx.U_csr[0]))
    assert isinstance(T, TransferPair)


def test_planner_transfer_fallback_for_hub_columns(sphere_mesh):
    """A coarse vertex fed by most fine rows would pad U^T's ELL far past
    8x its nnz; the planner falls back to the gather/segment-sum
    Prolongation instead."""
    ctx = _smoothing_ctx(sphere_mesh)
    nf, nc = 20000, 2000
    rng = np.random.default_rng(5)
    cols = np.concatenate([np.zeros((nf, 1), np.int64),
                           rng.integers(1, nc, (nf, 2))], axis=1)
    U = sp.csr_matrix((np.full(3 * nf, 1 / 3), (np.repeat(np.arange(nf), 3),
                       cols.ravel())), shape=(nf, nc))
    T = ctx._build_transfer((0, U))
    assert isinstance(T, Prolongation)
    assert not isinstance(T, TransferPair)


def _dot_precisions(jaxpr):
    """Precision params of every dot_general, recursing into sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns"):
                out += _dot_precisions(sub)
    return out


def _coarse_jaxpr(which, mesh, cols):
    if which == "single":
        ctx = _smoothing_ctx(mesh)
        nc = ctx.coarse_op[0].shape[0]
        rc = jnp.zeros((nc,) if cols is None else (nc, cols), jnp.float32)
        return jax.make_jaxpr(lambda c, r: _coarse_solve(c, r, True))(
            ctx.coarse_op, rc)
    from jax.sharding import PartitionSpec as P

    from gravo_mg.parallel.dist import make_solver_mesh
    from gravo_mg.parallel.halo import HaloContext

    hctx = HaloContext(_smoothing_ctx(mesh), make_solver_mesh(2))
    nloc = hctx.nloc[-1]
    rc = jnp.zeros((2 * nloc,) if cols is None else (2 * nloc, cols),
                   jnp.float32)
    fn = jax.shard_map(
        lambda c, r: hctx._coarse(c, r), mesh=hctx.mesh,
        in_specs=(P(), P(hctx.AXIS)), out_specs=P(hctx.AXIS),
        check_vma=False,
    )
    return jax.make_jaxpr(fn)(hctx._coarse_op, rc)


@pytest.mark.parametrize("cols", [None, 3], ids=["1d", "3rhs"])
@pytest.mark.parametrize("which", ["single", "halo"])
def test_coarse_solve_products_highest(sphere_mesh, which, cols):
    """Both coarse solves state Precision.HIGHEST on all three products,
    so a GPU cannot run them in TF32."""
    precs = _dot_precisions(_coarse_jaxpr(which, sphere_mesh, cols).jaxpr)
    hi = jax.lax.Precision.HIGHEST
    assert len(precs) == 3
    assert all(p == (hi, hi) for p in precs), precs
