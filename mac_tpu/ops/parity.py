"""Device-versus-float64 parity checks for the operator layer.

Each check builds its inputs from a seed, runs the device code (jitted, in
float32 as the solver does on an accelerator) and an independent float64
NumPy/SciPy reference on the host, and returns the error. The same
functions serve the CPU tests (small widths), the `gpu`-marked tests and
`chip_smoke.py` (city10000 widths on the card), so all three measure the
same thing the same way.

TOL holds each check's bound and why it is that large.
"""

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mac_tpu.ops import banded as _banded
from mac_tpu.ops import tridiag as _tridiag

TOL = {
    # Exact float32 products (no reduced-precision matmul pass): rounding
    # of a locally centered f32 apply, ~1e-7 relative in practice.
    "banded_apply_highest": 1e-5,
    # The backend's fast matmul mode (TF32 on tensor-core GPUs, exact f32
    # on CPU). Only preconditioner-internal residuals use it; the coarse
    # operator's 1% diagonal jitter was sized for a bf16 pass of 2.9e-3.
    "banded_apply_default": 5e-3,
    # Scan solve in float32 against a float64 direct solve.
    "chain_solve": 2e-4,
    # Assembly copies f32 weights into place and sums the degrees in f32:
    # the error, taken relative to the largest degree (not absolute, so
    # that it does not scale with the weights), is summation-order
    # rounding.
    "assembly": 1e-6,
}


def chain_pose_graph(n: int, n_loops: int, span: int,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Odometry chain plus `n_loops` short loop closures (|i - j| <= span):
    a band-narrow pose graph. Returns (idx (m, 2) int64, w (m,) float64)."""
    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    lo = rng.randint(0, n - 2, size=n_loops)
    hi = np.minimum(n - 1, lo + 2 + rng.randint(span, size=n_loops))
    loops = np.unique(np.stack([lo, hi], 1)[hi - lo > 1], axis=0)
    idx = np.concatenate([chain, loops]).astype(np.int64)
    return idx, 0.5 + rng.rand(len(idx))


def seeded_weights(m: int, seed: int = 0) -> np.ndarray:
    """m edge weights in [0.5, 1.5) from `seed`. Unlike a dataset whose
    weights are all equal (city10000's are all 100), their float32 sums
    depend on the summation order."""
    return 0.5 + np.random.RandomState(seed).rand(m)


def _relabeled(idx, n):
    bop, ridx = _banded.build_banded_rcm(idx, n, dtype=jnp.float32)
    if bop is None:
        raise ValueError("graph admits no narrow RCM band")
    return bop, np.asarray(ridx, np.int64)


def _laplacian64(ridx, w64, n):
    import scipy.sparse as sp

    A = sp.coo_matrix((w64, (ridx[:, 0], ridx[:, 1])), shape=(n, n))
    A = (A + A.T).tocsr()
    return sp.diags(np.asarray(A.sum(axis=1)).ravel()) - A


def check_banded_apply(idx, w, n, q: int = 4,
                       precision=jax.lax.Precision.HIGHEST,
                       seed: int = 0) -> float:
    """max |L(w) V - ref| / max |ref| for the float32 banded apply at
    `precision`, against a float64 sparse product with the same (f32)
    weights."""
    bop, ridx = _relabeled(idx, n)
    w32 = jnp.asarray(w, jnp.float32)
    V = np.random.RandomState(seed).normal(size=(n, q)).astype(np.float32)
    apply = jax.jit(lambda w_, V_: _banded.banded_apply(
        bop, _banded.assemble_bd(bop, w_), V_, precision=precision))
    got = np.asarray(apply(w32, jnp.asarray(V)), np.float64)
    ref = _laplacian64(ridx, np.asarray(w32, np.float64), n) @ V.astype(
        np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def check_assembly(idx, w, n) -> float:
    """max absolute error of the sheared assembly (transposed upper block
    diagonals + degrees) against blocks scattered in float64 from the edge
    list, relative to the largest degree (the scale of ||L||)."""
    bop, ridx = _relabeled(idx, n)
    BS, nb, half = _banded.BS, bop.nb, bop.half
    w32 = jnp.asarray(w, jnp.float32)
    BD = jax.jit(lambda w_: _banded.assemble_bd(bop, w_))(w32)
    w64 = np.asarray(w32, np.float64)
    i = ridx.min(axis=1)
    j = ridx.max(axis=1)
    t = j // BS - i // BS
    ut = np.zeros((half + 1, nb, BS, BS))
    np.add.at(ut, (t, i // BS, j % BS, i % BS), -w64)
    deg = np.zeros(nb * BS)
    np.add.at(deg, i, w64)
    np.add.at(deg, j, w64)
    err = max(np.abs(np.asarray(BD.ut, np.float64) - ut).max(),
              np.abs(np.asarray(BD.deg, np.float64).ravel() - deg).max())
    return float(err / np.abs(deg).max())


def _spd_chain(n: int, seed: int):
    """A diagonally dominant SPD tridiagonal system shaped like the chain
    smoother's (negative chain weights off the diagonal)."""
    rng = np.random.RandomState(seed)
    e = -(0.5 + rng.rand(n - 1))
    d = 0.1 + rng.rand(n) - np.concatenate([[0], e]) - np.concatenate([e, [0]])
    return d, e


def check_chain_solve(n: int, q: int = 4, block=None, seed: int = 0) -> float:
    """||X - X_ref|| / ||X_ref|| for the float32 scan solve with an exact
    (`block=None`) or segment-decoupled (`block=b`, tridiag_ldl_blocked)
    factor, against scipy.linalg.solve_banded in float64 on the matrix the
    factor represents (couplings at segment boundaries dropped)."""
    from scipy.linalg import solve_banded

    d, e = _spd_chain(n, seed)
    B = np.random.RandomState(seed + 1).normal(size=(n, q))
    d32, e32 = jnp.asarray(d, jnp.float32), jnp.asarray(e, jnp.float32)

    def solve(d_, e_, B_):
        f = (_tridiag.tridiag_ldl(d_, e_) if block is None
             else _tridiag.tridiag_ldl_blocked(d_, e_, block=block))
        return _tridiag.tridiag_solve_factored(f, B_)

    got = np.asarray(jax.jit(solve)(d32, e32, jnp.asarray(B, jnp.float32)),
                     np.float64)
    d64 = np.asarray(d32, np.float64)
    e64 = np.asarray(e32, np.float64).copy()
    if block is not None:
        e64[(np.arange(1, n) % block) == 0] = 0.0
    ab = np.zeros((3, n))
    ab[0, 1:] = e64
    ab[1] = d64
    ab[2, :-1] = e64
    ref = solve_banded((1, 1), ab, B)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
