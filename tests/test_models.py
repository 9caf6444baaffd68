"""Model-problem workloads (smoothing / Poisson / conformal flow)."""

import numpy as np

from gravo_mg import MultigridSolver
from gravo_mg.models import (
    ConformalFlow,
    poisson_problem,
    smoothing_problem,
)
from gravo_mg.utils.meshgen import icosphere


def test_smoothing_problem_solves():
    V, F = icosphere(4, bump=0.2)
    prob = smoothing_problem(V, F, tau=1e-3)
    solver = MultigridSolver(prob.pos, prob.neigh, prob.mass, lower_bound=120)
    rhs = prob.make_rhs(prob.pos)
    x = solver.solve(prob.lhs, rhs)
    assert solver.residual(prob.lhs, rhs, x) <= 1e-4


def test_poisson_problem_solves():
    V, F = icosphere(4, bump=0.2)
    prob = poisson_problem(V, F, eta=1e-6)
    rng = np.random.default_rng(0)
    solver = MultigridSolver(prob.pos, prob.neigh, prob.mass, lower_bound=120)
    rhs = prob.make_rhs(rng.standard_normal((prob.pos.shape[0], 1)))
    x = solver.solve(prob.lhs, rhs)
    assert solver.residual(prob.lhs, rhs, x) <= 1e-4


def test_conformal_flow_converges_toward_sphere():
    V, F = icosphere(3, bump=0.35)
    flow = ConformalFlow(V, F, tau=5e-3, lower_bound=80)

    def roundness(P):
        r = np.linalg.norm(P - P.mean(axis=0), axis=1)
        return r.std() / r.mean()

    r0 = roundness(flow.V)
    Vout = flow.run(4)
    assert np.isfinite(Vout).all()
    assert roundness(Vout) < r0  # flow smooths toward a sphere
