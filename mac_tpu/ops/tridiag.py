"""Parallel symmetric tridiagonal solver via associative scans.

This is the accelerator stand-in for a sparse direct factorization: the
tridiagonal part of a pose-graph Laplacian (full diagonal + the odometry
chain's off-diagonals) captures most of its ill-conditioning, and an SPD
tridiagonal system solves in O(log n) depth with three
`jax.lax.associative_scan` passes:

  1. LDL^T pivots d'_i = d_i - e_{i-1}^2 / d'_{i-1}: a continued-fraction
     (Moebius) recurrence, composed projectively as normalized 2x2 matrix
     products.
  2. Unit-lower forward substitution y_i = b_i - l_i y_{i-1}: an affine
     recurrence scan.
  3. Backward substitution on L^T: the same scan reversed.

Replaces the role of CHOLMOD/SuperLU factorizations in the reference
(mac/utils/cholesky.py:107-134; SuperLU inside NetworkX tracemin at
mac/utils/fiedler.py:42) as the preconditioner backbone for the eigensolver
and CG (see mac_tpu.ops.lobpcg / mac_tpu.ops.cg).
"""

from typing import Optional

import jax
import jax.numpy as jnp


class TridiagFactor:
    """LDL^T factor of an SPD tridiagonal matrix: T = L diag(dp) L^T with
    unit-lower-bidiagonal L, subdiagonal l.

    `seg` records how the factor was produced: None = exact factorization
    (tridiag_ldl); an integer = segment-decoupled approximate factor with
    couplings zeroed at every `seg` boundary (tridiag_ldl_blocked). `seg`
    is pytree aux data (static), so it participates in jit cache keys, not
    tracing."""

    __slots__ = ("dp", "l", "seg")

    def __init__(self, dp: jax.Array, l: jax.Array,
                 seg: Optional[int] = None):
        self.dp = dp  # (n,) pivots
        self.l = l    # (n,) subdiagonal of L; l[0] = 0
        self.seg = seg

    def __repr__(self):
        return f"TridiagFactor(dp={self.dp!r}, l={self.l!r}, seg={self.seg})"


jax.tree_util.register_pytree_node(
    TridiagFactor,
    lambda f: ((f.dp, f.l), f.seg),
    lambda seg, children: TridiagFactor(*children, seg=seg),
)


def _mobius_combine(a, b):
    """Compose projective 2x2 maps (normalized to avoid over/underflow).

    Operands are (..., 2, 2); `b` follows `a` in sequence order, i.e. the
    composite is b @ a.
    """
    m = jnp.einsum("...ij,...jk->...ik", b, a)
    scale = jnp.max(jnp.abs(m), axis=(-2, -1), keepdims=True)
    scale = jnp.where(scale == 0, 1.0, scale)
    return m / scale


def _affine_combine(a, b):
    """Compose affine recurrences y -> coef*y + off; b follows a."""
    ca, oa = a
    cb, ob = b
    return (cb * ca, cb * oa + ob)


def tridiag_ldl(d: jax.Array, e: jax.Array) -> TridiagFactor:
    """LDL^T pivots of the SPD tridiagonal matrix with diagonal d (n,) and
    off-diagonal e (n-1,). O(log n) depth via a projective scan.

    The scan always runs in float64 and the factor is returned in the input
    dtype: the projective (Moebius) composition spans a wide dynamic range,
    and a float32 scan (especially with denormals flushed to zero) can
    produce non-finite pivots on real pose-graph weight scales. The
    factorization runs once per weight vector — the float64 cost is
    negligible next to the solves.
    """
    out_dtype = d.dtype
    d = d.astype(jnp.float64)
    e = e.astype(jnp.float64)
    n = d.shape[0]
    e2 = jnp.concatenate([jnp.zeros((1,), d.dtype), e * e])  # e2[i] = e_{i-1}^2
    # x_i = d_i - e2_i / x_{i-1}  as  [[d_i, -e2_i], [1, 0]] acting projectively.
    M = jnp.stack(
        [
            jnp.stack([d, -e2], axis=-1),
            jnp.stack([jnp.ones_like(d), jnp.zeros_like(d)], axis=-1),
        ],
        axis=-2,
    )  # (n, 2, 2)
    P = jax.lax.associative_scan(_mobius_combine, M, axis=0)
    # Applied to [1, 0]: x_i = P[i,0,0] / P[i,1,0].
    dp = P[:, 0, 0] / P[:, 1, 0]
    # Pivot clamp: for a near-singular tridiagonal (a pure odometry chain's
    # Laplacian regularized by a tiny shift) the float32 scan can round
    # pivots to ~0 or below, which poisons the solve with inf/NaN. The
    # factor is a preconditioner, so flooring pivots at a small positive
    # multiple of the diagonal scale is safe and keeps it SPD.
    floor = 8 * jnp.finfo(out_dtype).eps * jnp.max(d)
    dp = jnp.maximum(dp, floor)
    l = jnp.concatenate([jnp.zeros((1,), d.dtype), e / dp[:-1]])
    return TridiagFactor(dp=dp.astype(out_dtype), l=l.astype(out_dtype))


def tridiag_ldl_blocked(d: jax.Array, e: jax.Array,
                        block: int = 1024) -> TridiagFactor:
    """Blocked LDL^T: factor `block`-sized chain segments independently
    (couplings across segment boundaries dropped — the factor is a
    *preconditioner*, and a two-grid coarse level owns the global modes).

    Why this exists: `tridiag_ldl`'s associative scan unrolls log2(n)
    stages of large slices, so its compile time grows with n. Here the
    recurrence runs as ONE rolled `lax.scan` of length `block`, vectorized
    across the n/block segments — compile size is independent of n. Runs
    in float64 like tridiag_ldl (same dynamic-range rationale; the scan
    state is tiny).
    """
    out_dtype = d.dtype
    n = d.shape[0]
    nb = -(-n // block)
    n_pad = nb * block
    d64 = jnp.concatenate(
        [d, jnp.ones((n_pad - n,), d.dtype)]).astype(jnp.float64)
    # e2[i] couples i to i-1; zero at segment starts (and padding).
    e2 = jnp.concatenate(
        [jnp.zeros((1,), jnp.float64),
         (e * e).astype(jnp.float64),
         jnp.zeros((n_pad - n,), jnp.float64)])
    pos = jnp.arange(n_pad) % block
    e2 = jnp.where(pos == 0, 0.0, e2)
    dB = d64.reshape(nb, block)
    eB = e2.reshape(nb, block)

    def step(prev_dp, de):
        di, e2i = de
        dp = di - e2i / prev_dp
        return dp, dp

    _, dpB = jax.lax.scan(
        step, jnp.ones((nb,), jnp.float64), (dB.T, eB.T))
    dp = dpB.T.reshape(n_pad)[:n]
    floor = 8 * jnp.finfo(out_dtype).eps * jnp.max(d.astype(jnp.float64))
    dp = jnp.maximum(dp, floor)
    e_eff = jnp.where((jnp.arange(1, n) % block) == 0, 0.0,
                      e.astype(jnp.float64)) if n > 1 else e.astype(jnp.float64)
    l = jnp.concatenate([jnp.zeros((1,), jnp.float64), e_eff / dp[:-1]])
    return TridiagFactor(dp=dp.astype(out_dtype), l=l.astype(out_dtype),
                         seg=int(block))


# Beyond this size the associative-scan factorization's unrolled stages
# make compiles slow; use the blocked variant.
TRIDIAG_SCAN_MAX_N = 32768


def tridiag_ldl_auto(d: jax.Array, e: jax.Array) -> TridiagFactor:
    """tridiag_ldl for sizes the scan compiles comfortably; the blocked
    segment factorization beyond (preconditioner-grade)."""
    if d.shape[0] <= TRIDIAG_SCAN_MAX_N:
        return tridiag_ldl(d, e)
    return tridiag_ldl_blocked(d, e)


def tridiag_solve_factored(f: TridiagFactor, B: jax.Array) -> jax.Array:
    """Solve T X = B given the LDL^T factor; B is (n, q).

    Two affine associative scans (forward on L, backward on L^T): O(log n)
    depth, vmaps natively, any dtype. This sits in the eigensolver's
    innermost loop (the chain smoother of every preconditioned CG step);
    its device time is read from profiler traces under the "chain_solve"
    scope."""
    with jax.named_scope("chain_solve"):
        l = f.l[:, None]
        # Forward: y_i = b_i - l_i y_{i-1}.
        coef = jnp.broadcast_to(-l, B.shape)
        _, y = jax.lax.associative_scan(_affine_combine, (coef, B), axis=0)
        z = y / f.dp[:, None]
        # Backward: x_i = z_i - l_{i+1} x_{i+1}: reverse affine scan.
        lr = jnp.concatenate([-f.l[1:], jnp.zeros((1,), f.l.dtype)])[:, None]
        coef_r = jnp.broadcast_to(lr, B.shape)[::-1]
        _, xr = jax.lax.associative_scan(
            _affine_combine, (coef_r, z[::-1]), axis=0)
        return xr[::-1]


def tridiag_solve(d: jax.Array, e: jax.Array, B: jax.Array) -> jax.Array:
    """Solve the SPD tridiagonal system (diag d, off-diag e) against (n, q)."""
    return tridiag_solve_factored(tridiag_ldl(d, e), B)
