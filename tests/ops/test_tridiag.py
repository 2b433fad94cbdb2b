"""Tridiagonal scan solver and CG unit tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mac_tpu.ops.cg import pcg, pcg_fixed
from mac_tpu.ops.tridiag import tridiag_ldl, tridiag_solve, tridiag_solve_factored


@pytest.mark.parametrize("n", [2, 3, 17, 256, 1000])
def test_tridiag_solve_random_spd(n):
    rng = np.random.RandomState(n)
    e = -rng.rand(n - 1)
    d = 2.05 * np.abs(np.concatenate([[0], e])) + 2.05 * np.abs(np.concatenate([e, [0]])) + 0.1
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    B = rng.randn(n, 3)
    X = np.asarray(tridiag_solve(jnp.asarray(d), jnp.asarray(e), jnp.asarray(B)))
    np.testing.assert_allclose(T @ X, B, atol=1e-9)


def test_tridiag_ldl_matches_numpy_cholesky():
    rng = np.random.RandomState(0)
    n = 64
    e = -(0.5 + rng.rand(n - 1))
    d = np.abs(np.concatenate([[0], e])) + np.abs(np.concatenate([e, [0]])) + 1.0
    fac = tridiag_ldl(jnp.asarray(d), jnp.asarray(e))
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    # Reconstruct T = L diag(dp) L^T.
    L = np.eye(n)
    for i in range(1, n):
        L[i, i - 1] = float(fac.l[i])
    np.testing.assert_allclose(L @ np.diag(np.asarray(fac.dp)) @ L.T, T, atol=1e-10)


def test_tridiag_near_singular_path_laplacian():
    # The tridiagonal part of a pure path graph Laplacian is singular; with
    # a small diagonal shift the scan solve must stay finite and accurate.
    n = 200
    w = 0.5 + np.random.RandomState(1).rand(n - 1)
    d = np.concatenate([[0], w]) + np.concatenate([w, [0]])
    e = -w
    eps = 1e-10 * d.max()
    b = np.random.RandomState(2).randn(n, 2)
    b -= b.mean(axis=0, keepdims=True)
    X = np.asarray(tridiag_solve(jnp.asarray(d + eps), jnp.asarray(e), jnp.asarray(b)))
    assert np.isfinite(X).all()
    T = np.diag(d + eps) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(T @ X, b, atol=1e-5)


def test_pcg_solves_spd_system():
    rng = np.random.RandomState(3)
    n = 80
    A = rng.randn(n, n)
    A = A @ A.T + n * np.eye(n)
    B = rng.randn(n, 5)
    apply_A = lambda V: jnp.asarray(A) @ V
    res = pcg(apply_A, jnp.asarray(B), tol=1e-12, maxiter=500)
    np.testing.assert_allclose(A @ np.asarray(res.X), B, atol=1e-7)
    assert np.all(np.asarray(res.resnorm) <= 1e-10 * np.linalg.norm(B, axis=0) + 1e-12)


def test_pcg_fixed_monotone_improvement():
    rng = np.random.RandomState(4)
    n = 60
    A = rng.randn(n, n)
    A = A @ A.T + n * np.eye(n)
    B = rng.randn(n, 2)
    apply_A = lambda V: jnp.asarray(A) @ V
    X8 = np.asarray(pcg_fixed(apply_A, jnp.asarray(B), iters=8))
    X32 = np.asarray(pcg_fixed(apply_A, jnp.asarray(B), iters=32))
    r8 = np.linalg.norm(A @ X8 - B)
    r32 = np.linalg.norm(A @ X32 - B)
    assert r32 < r8 < np.linalg.norm(B)


def test_tridiag_ldl_blocked_preconditioner_quality():
    """The blocked factorization (compile-light path for n > 32768) must
    match tridiag_ldl away from segment boundaries and still act as an
    effective approximate solve."""
    import numpy as np
    import jax.numpy as jnp
    from mac_tpu.ops.tridiag import (
        tridiag_ldl,
        tridiag_ldl_blocked,
        tridiag_solve_factored,
    )

    rng = np.random.RandomState(0)
    n = 3000
    e = -(0.5 + rng.rand(n - 1))
    d = 0.1 + rng.rand(n) - np.concatenate([[0], e]) - np.concatenate([e, [0]])
    f_full = tridiag_ldl(jnp.asarray(d), jnp.asarray(e))
    f_blk = tridiag_ldl_blocked(jnp.asarray(d), jnp.asarray(e), block=1024)
    dp_f = np.asarray(f_full.dp)
    dp_b = np.asarray(f_blk.dp)
    # Interior of each segment converges to the full pivots.
    interior = np.ones(n, bool)
    for b in range(0, n, 1024):
        interior[b:b + 64] = False
    np.testing.assert_allclose(dp_b[interior], dp_f[interior], rtol=1e-6)
    # Approximate-solve quality: residual reduction on a random system.
    x = rng.normal(size=(n, 2))
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    b_rhs = T @ x
    x_blk = np.asarray(tridiag_solve_factored(f_blk, jnp.asarray(b_rhs)))
    rel = np.linalg.norm(T @ x_blk - b_rhs) / np.linalg.norm(b_rhs)
    assert rel < 0.2, rel


def test_tridiag_factor_segment_metadata():
    """Factors record how they were produced (seg = None for exact,
    the block size for segment-decoupled), the metadata survives pytree
    flattening and jit, and the solve is the same under jit as eagerly
    for both factor kinds."""
    import jax
    import jax.numpy as jnp
    from mac_tpu.ops import tridiag as td

    rng = np.random.RandomState(0)
    n = 3000
    e = -(0.5 + rng.rand(n - 1))
    d = 0.1 + rng.rand(n) - np.concatenate([[0], e]) - np.concatenate([e, [0]])
    f_exact = td.tridiag_ldl(jnp.asarray(d), jnp.asarray(e))
    f_blk = td.tridiag_ldl_blocked(jnp.asarray(d), jnp.asarray(e), block=1024)
    assert f_exact.seg is None
    assert f_blk.seg == 1024

    leaves, treedef = jax.tree_util.tree_flatten(f_blk)
    f_rt = jax.tree_util.tree_unflatten(treedef, leaves)
    assert f_rt.seg == 1024
    # seg participates in the treedef (static aux data), so jit re-traces
    # rather than reusing a cached program for a differently-built factor.
    _, treedef_exact = jax.tree_util.tree_flatten(f_exact)
    assert treedef != treedef_exact

    # The factor (with its static seg) passes through jit unchanged.
    B = jnp.asarray(rng.normal(size=(n, 3)))
    for f in (f_exact, f_blk):
        ref = td.tridiag_solve_factored(f, B)
        got = jax.jit(td.tridiag_solve_factored)(f, B)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n,q,block", [
    (3000, 4, None),      # exact factor
    (10000, 1, None),     # exact factor, single right-hand side
    (5000, 4, 128),       # blocked factor at the chain smoother's segment
    (20000, 8, 1024),     # blocked factor, wide block
])
def test_scan_chain_solve_matches_scipy_banded_f64(n, q, block):
    """The float32 scan solve against scipy.linalg.solve_banded in float64
    on the matrix the factor represents — the check the chip smoke test
    runs at city10000 widths (mac_tpu.ops.parity)."""
    from mac_tpu.ops import parity

    err = parity.check_chain_solve(n, q=q, block=block, seed=n % 7)
    assert err <= parity.TOL["chain_solve"], err
