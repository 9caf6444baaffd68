"""Sparse containers and plans vs scipy references."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from gravo_mg.sparse import (
    ell_from_scipy,
    ell_to_dense,
    make_prolongation,
    spmv,
)


def _random_spd(n, density=0.05, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csr")
    A = A + A.T + sp.diags(np.full(n, n * density + 1.0))
    return A.tocsr()


def test_ell_roundtrip_and_spmv():
    A = _random_spd(300)
    E = ell_from_scipy(A, dtype=jnp.float64)
    assert abs(E.to_scipy() - A).max() < 1e-12
    x = np.random.default_rng(1).standard_normal(300)
    assert np.allclose(np.asarray(spmv(E, jnp.asarray(x))), A @ x, atol=1e-10)


def test_spmv_multi_rhs():
    A = _random_spd(200, seed=2)
    E = ell_from_scipy(A, dtype=jnp.float64)
    X = np.random.default_rng(3).standard_normal((200, 3))
    assert np.allclose(np.asarray(spmv(E, jnp.asarray(X))), A @ X, atol=1e-10)


def test_ell_diagonal():
    A = _random_spd(150, seed=4)
    E = ell_from_scipy(A, dtype=jnp.float64)
    assert np.allclose(np.asarray(E.diagonal()), A.diagonal(), atol=1e-12)


def test_ell_to_dense():
    A = _random_spd(80, seed=5)
    E = ell_from_scipy(A, dtype=jnp.float64)
    assert np.allclose(np.asarray(ell_to_dense(E)), A.toarray(), atol=1e-12)


def _random_prolongation(nf, nc, seed=0):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, nc, size=(nf, 3)).astype(np.int32)
    w = rng.random((nf, 3))
    w /= w.sum(axis=1, keepdims=True)
    return cols, w


def test_prolongation_against_scipy():
    nf, nc = 400, 60
    cols, w = _random_prolongation(nf, nc, seed=6)
    U = make_prolongation(cols, w, nc, dtype=jnp.float64)
    Us = U.to_scipy()
    e = np.random.default_rng(7).standard_normal(nc)
    r = np.random.default_rng(8).standard_normal(nf)
    assert np.allclose(np.asarray(U.prolong(jnp.asarray(e))), Us @ e, atol=1e-10)
    assert np.allclose(np.asarray(U.restrict(jnp.asarray(r))), Us.T @ r, atol=1e-10)
    R = np.random.default_rng(9).standard_normal((nf, 3))
    assert np.allclose(np.asarray(U.restrict(jnp.asarray(R))), Us.T @ R, atol=1e-10)
