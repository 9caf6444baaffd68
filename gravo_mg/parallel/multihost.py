"""Multi-host (multi-process) support for the halo-exchange solver.

SURVEY.md §2.5 / BASELINE config 5 ask for a row-partitioned V-cycle that
spans N >= 2 hosts, with collectives riding the intra-host interconnect
(NVLink) inside a host and the data-center network (DCN) between hosts.
The reference has no counterpart (it is single-threaded —
multigrid_solver.cpp:86-87); this is a new capability of this library.

Design
------
* **Process bring-up** (`initialize`): a thin wrapper over
  ``jax.distributed.initialize``.  After it returns, ``jax.devices()`` is
  the *global* device list and every jitted computation is a
  multi-controller SPMD program — each process executes the same Python,
  addressing only its local shards.
* **Mesh** (`global_row_mesh`): a 1-D ``('rows',)`` mesh over the global
  device list in process-major order, so consecutive row blocks live on
  the same host and the halo exchange's adjacent ring shifts stay inside it;
  only the process-boundary pairs of each shift cross DCN.
* **Array distribution** (`host_to_global`): every process runs the same
  host-side partitioner (the plans are deterministic), then materializes
  only its addressable shards via ``jax.make_array_from_callback``.  The
  redundant host plan build is deliberate: plan construction is seconds
  of CPU work and keeping it replicated avoids a host-side metadata
  exchange entirely.
* **DCN-first exchange ordering** (`order_steps_dcn_first`): within one
  halo exchange, ring shifts that cross a process boundary are issued
  before intra-host shifts so the slower DCN transfer overlaps the most
  interior compute (the ppermutes carry no data dependence on the interior
  FMA — see parallel/halo.py DistOp).

Runbook (N processes, one per host)
-----------------------------------
On every host, before importing gravo_mg computations::

    from gravo_mg.parallel import multihost
    multihost.initialize(coordinator_address="host0:9876",
                         num_processes=N, process_id=i)
    mesh = multihost.global_row_mesh()
    ... build MultigridSolver / MultigridSolveContext (host-side,
        identical on every process) ...
    hctx = HaloContext(ctx, mesh)       # detects multi-process itself
    x, iters, res = hctx.solve(rhs)     # rhs: full global array on
                                        # every process (f64, host)

Each process passes the SAME full ``rhs``; ``HaloContext`` shards it.
The returned solution is the full global vector on every process
(all-gathered through the jit output sharding).

Tested 2-process on CPU devices in ``tests/test_multihost.py`` (spawned
subprocesses, ``--xla_force_host_platform_device_count``); multi-host GPU
clusters follow the same code path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               **kwargs) -> None:
    """Bring up the multi-controller runtime (idempotent).

    Thin wrapper over ``jax.distributed.initialize`` so callers do not
    import jax internals.  Where no cluster environment is detected, pass
    all three arguments explicitly.
    """
    # Idempotence check must not touch jax.process_count()/jax.devices():
    # those would initialize the XLA backend, after which
    # jax.distributed.initialize refuses to run.
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def global_row_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D ('rows',) mesh over all global devices, process-major.

    ``jax.devices()`` already orders devices by process index; keeping
    that order makes row blocks contiguous per host, so of each ring
    shift's D point-to-point transfers only the process-boundary ones
    cross DCN.
    """
    if devices is None:
        devices = jax.devices()
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devices), ("rows",))


def host_to_global(mesh: Mesh, spec: P, arr: np.ndarray) -> jax.Array:
    """Materialize a host numpy array as a mesh-sharded global jax.Array.

    Works in single- and multi-process: each process only fills the
    shards it addresses.  ``arr`` must be the full global array (every
    process holds the same plan output).
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )


def order_steps_dcn_first(steps, ndev: int, local_device_count: int):
    """Reorder halo-exchange steps so DCN-crossing shifts are issued first.

    ``steps`` are ``(shift, send_idx, recv_pos)`` ring shifts (see
    parallel/halo.py).  A shift ``s`` crosses a process boundary iff any
    device d has ``(d + s) // P != d // P`` with P devices per process —
    for a contiguous process-major ring that is every ``s % P != 0`` shift
    at SOME boundary pair, so we rank by how many of the D transfers cross:
    ``D - count(d: same host)``, descending, largest |shift| first as a
    tiebreak.  Issuing DCN traffic first lets it overlap the interior FMA
    longest (the SURVEY §2.5(b) overlap contract).
    """
    P_ = max(int(local_device_count), 1)

    def dcn_transfers(step):
        s = step[0]
        return sum(
            1 for d in range(ndev) if (d + s) % ndev // P_ != d // P_
        )

    return tuple(sorted(
        steps, key=lambda st: (-dcn_transfers(st), -abs(st[0]))
    ))
