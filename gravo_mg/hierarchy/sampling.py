"""Coarse-point sampling: native greedy sweep + Luby-round fallback.

The reference's samplers are sequential greedy sweeps in vertex order
(`fastDiskSample`, `gravomg/src/multigrid_solver.cpp:975-1013`;
`maximumDeltaIndependentSet`, `:930-973`): visit vertices 0..N-1, keep a
vertex if not yet covered, and mark every vertex within graph distance
``radius`` (1 hop for MIS, <=2 hops for fastdisk) as covered.

Two engines provide that contract (a maximal set of samples pairwise at
least ``radius`` apart, covering all vertices):

* **native greedy** (default): the one-pass sweep in C++
  (native/gravomg_native.cpp `disk_sample`).  Sampling is a once-per-build
  host-side *plan construction* step, inherently memory-bound and
  sequential; a serial C++ pass is deterministic independent of the seed,
  like the reference.
* **Luby-style rounds** (fallback / opt-in via ``engine="luby"``): every
  vertex draws a random priority; each round all undecided vertices that
  hold the minimum priority within their conflict ball join the sample set
  simultaneously.  O(log N) jittable rounds — retained as the fully
  vectorized formulation (it is the one that would scale past host memory).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

UNDECIDED, SAMPLE, DOMINATED = 0, 1, 2
_IMAX = np.iinfo(np.int32).max


def _conflict_min(q, neigh, dist, radius, two_ring, block):
    """s[i] = min of q over the conflict ball of i (excluding i itself).

    q is an int32 priority vector with _IMAX marking inert vertices.
    The conflict ball is {j : d(i,j) < r} plus, when ``two_ring``,
    {m : d(i,j) + d(j,m) < r for some neighbor j}.
    """
    n, k = neigh.shape

    def body(carry, idx):
        rows = idx  # (block,) row indices
        nb = neigh[rows]          # (B, K)
        db = dist[rows]           # (B, K)
        safe_nb = jnp.maximum(nb, 0)
        ok1 = (nb >= 0) & (db < radius)
        m1 = jnp.min(jnp.where(ok1, q[safe_nb], _IMAX), axis=1)
        if two_ring:
            nb2 = neigh[safe_nb]      # (B, K, K)
            db2 = dist[safe_nb]       # (B, K, K)
            safe_nb2 = jnp.maximum(nb2, 0)
            path = db[:, :, None] + db2
            ok2 = (
                ok1[:, :, None]
                & (nb2 >= 0)
                & (path < radius)
                & (nb2 != rows[:, None, None])
            )
            m2 = jnp.min(
                jnp.where(ok2, q[safe_nb2], _IMAX), axis=(1, 2)
            )
            m1 = jnp.minimum(m1, m2)
        return carry, m1

    nblocks = -(-n // block)
    pad = nblocks * block - n
    idx = jnp.arange(nblocks * block, dtype=jnp.int32).reshape(nblocks, block)
    idx = jnp.minimum(idx, n - 1)  # clamp pad rows; results discarded
    _, out = jax.lax.scan(body, None, idx)
    return out.reshape(-1)[: n] if pad else out.reshape(-1)


@partial(jax.jit, static_argnames=("two_ring", "block"))
def _luby_round(status, rank, neigh, dist, radius, *, two_ring, block):
    """One Luby round: select local-min-priority vertices, dominate balls."""
    q = jnp.where(status == UNDECIDED, rank, _IMAX)
    s = _conflict_min(q, neigh, dist, radius, two_ring, block)
    new_sample = (status == UNDECIDED) & (rank < s)
    # Domination sweep: an undecided vertex is dominated if a new sample
    # lies in its conflict ball.
    ns_rank = jnp.where(new_sample, 0, _IMAX).astype(jnp.int32)
    t = _conflict_min(ns_rank, neigh, dist, radius, two_ring, block)
    dominated = (status == UNDECIDED) & (~new_sample) & (t == 0)
    status = jnp.where(
        new_sample, SAMPLE, jnp.where(dominated, DOMINATED, status)
    )
    return status, jnp.sum(status == UNDECIDED)


def edge_lengths_np(pos: np.ndarray, neigh: np.ndarray) -> np.ndarray:
    """(N, K) float32 edge lengths, inf at padding — host-side.

    Kept in numpy deliberately: eager jnp glue here would compile one
    program per level shape for a once-per-build host step.
    """
    safe = np.maximum(neigh, 0)
    d = np.linalg.norm(
        pos[safe] - pos[:, None, :], axis=-1
    ).astype(np.float32)
    d[neigh < 0] = np.inf
    return d


def parallel_disk_sample(
    pos: np.ndarray,
    neigh: np.ndarray,
    radius: float,
    *,
    two_ring: bool = True,
    seed: int = 0,
    block: int = 65536,
    max_rounds: int = 200,
    dist: Optional[np.ndarray] = None,
    engine: str = "auto",
    order: Optional[np.ndarray] = None,
):
    """Sample coarse points: fastDiskSample / MIS contract.

    Returns ``(samples, status)``: sample vertex indices in ascending order
    and the per-vertex status array.  ``dist`` lets the caller share one
    precomputed edge-length table across phases.  ``engine``: "auto" uses
    the native greedy sweep when available, "luby" forces the vectorized
    rounds (see module docstring).  ``order`` sets the greedy visit order
    (default: index order like the reference's fastDiskSample sweep;
    the hierarchy builder passes a seeded permutation — raster-ordered
    meshes otherwise pack samples at minimal spacing and under-coarsen).
    """
    n, k = neigh.shape
    block = min(block, max(256, n))
    if dist is None:
        dist = edge_lengths_np(np.asarray(pos, np.float64), neigh)
    if engine != "luby":
        from ..native import disk_sample_native

        status_np = np.zeros(n, dtype=np.int8)
        if disk_sample_native(neigh, dist, radius, two_ring, status_np,
                              order=order):
            samples = np.nonzero(status_np == SAMPLE)[0].astype(np.int32)
            return samples, status_np
    neigh = jnp.asarray(neigh, dtype=jnp.int32)
    dist = jnp.asarray(dist, dtype=jnp.float32)

    rng = np.random.default_rng(seed)
    rank = jnp.asarray(rng.permutation(n).astype(np.int32))
    status = jnp.zeros(n, dtype=jnp.int8)
    for _ in range(max_rounds):
        status, undecided = _luby_round(
            status, rank, neigh, dist, jnp.float32(radius),
            two_ring=two_ring, block=block,
        )
        if int(undecided) == 0:
            break
    samples = np.nonzero(np.asarray(status) == SAMPLE)[0].astype(np.int32)
    return samples, np.asarray(status)


def random_sample(n: int, target: int, seed: int = 0) -> np.ndarray:
    """Uniform random subset (reference RANDOM case,
    multigrid_solver.cpp:143-149)."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.permutation(n)[:target]).astype(np.int32)


def poisson_disk_sample(pos: np.ndarray, radius: float, seed: int = 0) -> np.ndarray:
    """Euclidean Poisson-disk sampling via Luby rounds on the radius graph.

    Parallel replacement for the reference's box dart-throwing sampler
    (`constructPoissonDiskSample`, multigrid_solver.cpp:714-928): same
    contract (maximal set with pairwise Euclidean distance >= radius),
    order-free.  Conflict pairs come from a KD-tree radius query.
    """
    from scipy.spatial import KDTree

    n = pos.shape[0]
    tree = KDTree(pos)
    pairs = tree.query_pairs(radius, output_type="ndarray")
    rng = np.random.default_rng(seed)
    rank = rng.permutation(n)
    status = np.zeros(n, dtype=np.int8)
    ii = np.concatenate([pairs[:, 0], pairs[:, 1]])
    jj = np.concatenate([pairs[:, 1], pairs[:, 0]])
    for _ in range(200):
        q = np.where(status == UNDECIDED, rank, _IMAX)
        s = np.full(n, _IMAX, dtype=np.int64)
        np.minimum.at(s, ii, q[jj])
        new_sample = (status == UNDECIDED) & (rank < s)
        dom = np.zeros(n, dtype=bool)
        dom[ii[new_sample[jj]]] = True
        status[new_sample] = SAMPLE
        status[(status == UNDECIDED) & ~new_sample & dom] = DOMINATED
        if not (status == UNDECIDED).any():
            break
    return np.nonzero(status == SAMPLE)[0].astype(np.int32)


def farthest_point_sample(pos: np.ndarray, neigh: np.ndarray, target: int,
                          dist: Optional[np.ndarray] = None) -> np.ndarray:
    """Graph farthest-point sampling (reference `constructFarthestPointSample`,
    gravomg/src/sampling.cpp:6-66): repeatedly add the vertex farthest (in
    graph distance) from the current sample set.

    Native path: incremental Dijkstra in C++ (adding a sample relaxes only
    vertices whose distance improves — O(E log E) amortized over all rounds,
    usable at every hierarchy level).  Fallback: scipy repeated full
    Dijkstra, same semantics, for small inputs.
    """
    from ..native import fps_graph_native

    if dist is None:
        dist = edge_lengths_np(np.asarray(pos, np.float64), neigh)
    native = fps_graph_native(neigh, dist, int(target))
    if native is not None:
        return np.sort(native).astype(np.int32)

    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    from ..utils.neighbors import neighbors_to_edges

    n = pos.shape[0]
    ii, jj = neighbors_to_edges(neigh)
    w = np.linalg.norm(pos[ii] - pos[jj], axis=1)
    g = sp.coo_matrix((w, (ii, jj)), shape=(n, n)).tocsr()
    samples = [0]
    D = dijkstra(g, indices=0)
    for _ in range(target - 1):
        nxt = int(np.argmax(np.where(np.isfinite(D), D, -1)))
        samples.append(nxt)
        D = np.minimum(D, dijkstra(g, indices=nxt))
    return np.sort(np.asarray(samples, dtype=np.int32))
