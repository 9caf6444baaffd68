"""Worker for the 2-process multi-host test (spawned by test_multihost.py).

Each process: initialize jax.distributed on CPU (4 virtual devices), build
the identical host-side solver context, solve via HaloContext on the
8-device global mesh, and assert the answer matches the single-device
solve computed locally.  argv: <process_id> <num_processes> <port>.
"""
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=4 "
    + os.environ.get("XLA_FLAGS", "")
)
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from gravo_mg.parallel import multihost

multihost.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
    process_id=pid,
)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc

import numpy as np

from gravo_mg import MultigridSolver
from gravo_mg.parallel.halo import HaloContext
from gravo_mg.utils.laplacian import cotan_laplacian, mass_barycentric
from gravo_mg.utils.meshgen import torus_mesh
from gravo_mg.utils.neighbors import neighbors_from_faces

V, F = torus_mesh(48, 48)
n = V.shape[0]
S = cotan_laplacian(V, F)
M = mass_barycentric(V, F)
lhs = (M + 1e-3 * S).tocsr()
rng = np.random.default_rng(7)
rhs = M @ rng.standard_normal(n)

solver = MultigridSolver(V, neighbors_from_faces(F), M, lower_bound=200)
ctx = solver._context(lhs)

mesh = multihost.global_row_mesh()
hctx = HaloContext(ctx, mesh)
assert hctx.nproc == nproc
x, iters, res = hctx.solve(rhs, tol=1e-6, criteria=2)
print(f"p{pid}: iters={iters} res={res:.3e}", flush=True)
assert res < 1e-6

# reference: single-device (process-local) solve of the same system
x_ref, it_ref, res_ref, _ = ctx.solve(rhs, tol=1e-6, criteria=2)
rel = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
print(f"p{pid}: rel-vs-single={rel:.3e} (iters {iters} vs {it_ref})",
      flush=True)
assert rel < 1e-4, rel
assert iters == it_ref, (iters, it_ref)
print(f"p{pid}: MULTIHOST_OK", flush=True)
