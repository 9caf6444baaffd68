"""Spatial (Morton / Z-order) vertex reordering.

Motivation: the halo row partition and the ShuffleEll block layout key
their communication volume and padding to INDEX locality, and the ELL
SpMV's gathers of ``x`` hit cache better when consecutive vertex indices
are spatially near.  Mesh generators and scan pipelines often emit raster
or random orders (a 1024x1024 torus's vertex i has neighbor i+1024).

``morton_order`` quantizes positions to a 21-bit lattice per axis and
sorts by interleaved bits — a cache-oblivious space-filling curve that
restores locality for ANY input order in O(n log n) host time.  The
reference (CPU, pointer-chasing Eigen) has no analog.

Not wired into ``MultigridSolver`` yet (ROADMAP D8): a caller permutes
positions, operators and right-hand sides with ``morton_order`` itself.
"""

from __future__ import annotations

import numpy as np


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are 2 zero bits between each
    (classic Morton bit-smear, vectorized on uint64)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_key(pos: np.ndarray) -> np.ndarray:
    """(n,) uint64 Morton keys of (n, 3) positions (21 bits/axis)."""
    p = np.asarray(pos, dtype=np.float64)
    lo = p.min(axis=0)
    span = p.max(axis=0) - lo
    span[span <= 0] = 1.0
    q = ((p - lo) / span * ((1 << 21) - 1)).astype(np.uint64)
    return (
        _part1by2(q[:, 0])
        | (_part1by2(q[:, 1]) << np.uint64(1))
        | (_part1by2(q[:, 2]) << np.uint64(2))
    )


def morton_order(pos: np.ndarray) -> np.ndarray:
    """Permutation ``perm`` sorting vertices along the Z-curve:
    ``pos[perm]`` is spatially coherent.  Stable, deterministic."""
    return np.argsort(morton_key(pos), kind="stable")


def relabel_neighbors(neigh: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Re-index a padded (n, maxdeg) neighbor array (pad = -1) so row j
    of the result lists the NEW ids of vertex perm[j]'s neighbors."""
    neigh = np.asarray(neigh)
    n = neigh.shape[0]
    inv = np.empty(n, dtype=neigh.dtype)
    inv[perm] = np.arange(n, dtype=neigh.dtype)
    out = neigh[perm]
    valid = out >= 0
    out = np.where(valid, inv[np.where(valid, out, 0)], out)
    return np.ascontiguousarray(out)
