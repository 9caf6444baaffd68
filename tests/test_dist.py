"""Distributed (row-partitioned) solver tests on the virtual 8-device CPU
mesh (SURVEY.md §4: multi-host tests on simulated devices)."""

import jax
import numpy as np
import pytest

from gravo_mg import MultigridSolver
from gravo_mg.parallel.dist import (
    make_solver_mesh,
    shard_context,
    sharded_cycle_step,
    sharded_solve,
)


@pytest.fixture(scope="module")
def setup(request):
    mesh_data = request.getfixturevalue("medium_mesh")
    V, M, S, neigh = (
        mesh_data["V"], mesh_data["M"], mesh_data["S"], mesh_data["neigh"]
    )
    lhs = (M + 1e-3 * S).tocsr()
    rng = np.random.default_rng(0)
    rhs = M @ rng.standard_normal((V.shape[0], 1))
    solver = MultigridSolver(V, neigh, M, lower_bound=200)
    ctx = solver._context(lhs)
    return solver, ctx, lhs, rhs


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_cycle_matches_single_device(setup):
    solver, ctx, lhs, rhs = setup
    mesh = make_solver_mesh(8)
    sctx = shard_context(ctx, mesh)
    import jax.numpy as jnp

    b = jnp.asarray(rhs[:, 0], jnp.float32)
    x0 = jnp.zeros_like(b)
    from gravo_mg.solver.multigrid import cycle_step

    x_single = np.asarray(cycle_step(ctx.cfg, ctx.levels, ctx.coarse_op, b, x0))
    x_dist = np.asarray(sharded_cycle_step(sctx, rhs[:, 0], np.zeros(len(rhs))))
    scale = np.abs(x_single).max()
    assert np.abs(x_dist - x_single).max() < 1e-5 * max(scale, 1.0)


def test_sharded_solve_converges(setup):
    solver, ctx, lhs, rhs = setup
    mesh = make_solver_mesh(8)
    sctx = shard_context(ctx, mesh)
    x, iters, res = sharded_solve(sctx, rhs[:, 0], tol=1e-4)
    assert res <= 1e-4
    assert iters <= 20
    # matches the reference-of-record residual on the original system
    assert solver.residual(lhs, rhs[:, 0], x) <= 2e-4


def test_sharded_solve_multi_rhs(setup):
    solver, ctx, lhs, rhs = setup
    mesh = make_solver_mesh(8)
    sctx = shard_context(ctx, mesh)
    rhs3 = np.concatenate([rhs, 2 * rhs, -rhs], axis=1)
    x, iters, res = sharded_solve(sctx, rhs3, tol=1e-4)
    assert x.shape == rhs3.shape
    assert res <= 1e-4


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_solve_smaller_meshes(setup, ndev):
    solver, ctx, lhs, rhs = setup
    mesh = make_solver_mesh(ndev)
    sctx = shard_context(ctx, mesh)
    x, iters, res = sharded_solve(sctx, rhs[:, 0], tol=1e-4)
    assert res <= 1e-4
