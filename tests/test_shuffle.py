"""Shuffle-ELL: layout invariants, SpMV correctness, round-trips.

The shuffle format is the halo solver's per-device block layout
(sparse.ShuffleEll, parallel/halo.py); its SpMV is plain jnp (block
gather + take_along_axis), the same code on every backend.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from gravo_mg.sparse import (
    TransferPair,
    ell_from_scipy,
    shuffle_from_scipy,
    shuffle_spmv,
    spmv,
)


def _random_csr(nr, nc, density, seed, struct_diag=False):
    rng = np.random.default_rng(seed)
    A = sp.random(nr, nc, density=density, random_state=rng, format="csr")
    if struct_diag:
        A = (A + sp.identity(nr, format="csr")).tocsr()
    A.sum_duplicates()
    return A


@pytest.mark.parametrize("nr,nc,density,seed", [
    (300, 300, 0.02, 0),
    (1000, 250, 0.01, 1),     # rectangular (restriction-shaped)
    (250, 1000, 0.012, 2),    # rectangular (prolongation-shaped)
    (129, 129, 0.1, 3),       # just over one lane group
    (64, 64, 0.2, 4),         # under one group
])
def test_shuffle_spmv_matches_scipy(nr, nc, density, seed):
    A = _random_csr(nr, nc, density, seed)
    S = shuffle_from_scipy(A, dtype=jnp.float64)
    x = np.random.default_rng(seed + 10).standard_normal(nc)
    y = np.asarray(shuffle_spmv(S, jnp.asarray(x)))
    np.testing.assert_allclose(y, A @ x, rtol=1e-10, atol=1e-12)


def test_shuffle_roundtrip_and_padding_invariants():
    A = _random_csr(500, 500, 0.02, 5)
    S = shuffle_from_scipy(A, dtype=jnp.float64)
    # round-trip preserves the matrix exactly
    d = (S.to_scipy() - A).tocoo()
    assert abs(d.data).max() if d.nnz else 0 == 0
    # device arrays keep the layout's alignment contract
    kp, s = S.q.shape
    assert kp % 4 == 0 and s % 8 == 0
    assert S.r.shape == (kp, s, 128) and S.v.shape == (kp, s, 128)
    # padded slots are inert: v == 0 wherever no nnz landed
    mask = np.asarray(S.v) != 0
    assert mask.sum() == A.nnz


def test_shuffle_spmv_multirhs():
    A = _random_csr(400, 400, 0.03, 6)
    S = shuffle_from_scipy(A, dtype=jnp.float64)
    X = np.random.default_rng(7).standard_normal((400, 3))
    Y = np.asarray(shuffle_spmv(S, jnp.asarray(X)))
    np.testing.assert_allclose(Y, A @ X, rtol=1e-10, atol=1e-12)


def test_shuffle_transfer_prolong_restrict():
    U = _random_csr(800, 120, 0.02, 10)
    T = TransferPair(
        shuffle_from_scipy(U, dtype=jnp.float64),
        shuffle_from_scipy(U.T.tocsr(), dtype=jnp.float64),
    )
    e = np.random.default_rng(11).standard_normal(120)
    rr = np.random.default_rng(12).standard_normal(800)
    np.testing.assert_allclose(
        np.asarray(T.prolong(jnp.asarray(e))), U @ e, rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(T.restrict(jnp.asarray(rr))), U.T @ rr,
        rtol=1e-10, atol=1e-12,
    )
    assert T.ncoarse == 120


def test_spmv_dispatch():
    A = _random_csr(200, 200, 0.05, 13)
    x = np.random.default_rng(14).standard_normal(200)
    y_ell = np.asarray(spmv(ell_from_scipy(A, dtype=jnp.float64), jnp.asarray(x)))
    y_shuf = np.asarray(spmv(shuffle_from_scipy(A, dtype=jnp.float64), jnp.asarray(x)))
    np.testing.assert_allclose(y_ell, y_shuf, rtol=1e-12)


def test_mesh_laplacian_slot_count_stays_small():
    """Index-localized matrices (mesh Laplacians) must pack into few
    slots — the property that keeps the halo blocks' padding small."""
    from gravo_mg.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg.utils.meshgen import torus_mesh

    V, F = torus_mesh(64, 64)
    L = (1e-6 * mass_barycentric(V, F) + cotan_laplacian(V, F)).tocsr()
    S = shuffle_from_scipy(L)
    assert S.kp <= 24, f"slot blow-up: KP={S.kp}"
    x = np.random.default_rng(0).standard_normal(L.shape[0]).astype(np.float32)
    y = np.asarray(shuffle_spmv(S, jnp.asarray(x)))
    np.testing.assert_allclose(y, (L @ x).astype(np.float32), rtol=2e-4, atol=2e-4)
