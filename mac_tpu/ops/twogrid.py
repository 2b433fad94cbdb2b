"""Two-grid preconditioner for graph Laplacians: exact-chain smoother +
dense coarse-grid correction.

The tridiagonal-part solve (mac_tpu.ops.tridiag) is an excellent smoother —
it solves the odometry chain *exactly* — but it is local: the globally-
smooth modes (precisely the Fiedler-adjacent ones) converge slowly through
it, which is the measured float32 accuracy/time floor of the inexact
inverse iteration. The classic remedy is a coarse-grid correction:

  * Aggregate `s` consecutive nodes (pose graphs are chain-ordered, so
    contiguous aggregation is natural) into nc = ceil(n/s) supernodes with
    piecewise-constant prolongation P (restriction = reshape + sum: free).
  * The coarse operator Lc = P^T L(w) P is an (nc, nc) *dense* Laplacian —
    assembled by chunked one-hot matmuls over coarse edge endpoints and
    inverted once per weight vector (regularized by the same rank-one
    constant-mode shift used in the eigensolver).
  * One V-cycle: pre-smooth (tridiag), coarse-correct, post-smooth.

Every piece is jit-friendly, static-shape, and batched over the (n, q)
block. The coarse inverse is computed in float64 (coefficient-level
algebra — see mac_tpu.ops.lobpcg._hi) and applied in the compute dtype.

This plays the role of the reference's sparse direct factorizations
(CHOLMOD/SuperLU, reference mac/utils/cholesky.py) at preconditioner
accuracy: global information travels through a dense matmul solve instead
of a sparse triangular solve.
"""

from typing import Callable

import jax
import jax.numpy as jnp

from mac_tpu.ops.laplacian import GraphOperator, lap_tridiagonal_part
from mac_tpu.ops.tridiag import tridiag_ldl_auto, tridiag_solve_factored


def make_twogrid_precond(
    op: GraphOperator,
    w: jax.Array,
    apply_L: Callable[[jax.Array], jax.Array],
) -> Callable[[jax.Array], jax.Array]:
    """Build the V-cycle preconditioner for L(w) restricted to 1^perp.

    Aggregation data lives statically on the GraphOperator (coarse_idx,
    coarse_s, coarse_nc — built host-side in build_operator). Returns a
    pure function (n, q) -> (n, q); rebuild when w changes (cheap: one
    tridiagonal LDL^T + one (nc, nc) inverse).
    """
    n, s, nc = op.n, op.coarse_s, op.coarse_nc
    dtype = w.dtype
    eps = jnp.finfo(dtype).eps

    # Smoother: exact solve of the tridiagonal part (diag + chain band).
    d, e = lap_tridiagonal_part(op, w)
    fac = tridiag_ldl_auto(d + 100 * eps * jnp.max(d), e)

    # Coarse operator: Lc = sum_e w_e (p_i - p_j)(p_i - p_j)^T over coarse
    # endpoints; edges interior to an aggregate vanish (p_i == p_j).
    # Assembled as Ec^T diag(w) Ec via a lax.scan of chunked one-hot
    # matmuls rather than a 4m-element scatter-add (rebuilt every FW step).
    # The chunked incidence is built by iota-compare (no gather/scatter at
    # all); f32 HIGHEST accumulation, escalated to f64 only for the
    # factorization.
    ci, cj = op.coarse_idx[:, 0], op.coarse_idx[:, 1]
    m = w.shape[0]
    CH = 4096
    mp = -(-m // CH) * CH
    # Pad with an out-of-range aggregate id (nc): its one-hot row is all
    # zero, so padded edges contribute nothing.
    ci_p = jnp.concatenate([ci, jnp.full((mp - m,), nc, jnp.int32)])
    cj_p = jnp.concatenate([cj, jnp.full((mp - m,), nc, jnp.int32)])
    w_p = jnp.concatenate([w, jnp.zeros((mp - m,), w.dtype)]).astype(
        jnp.float32)
    cols_iota = jax.lax.broadcasted_iota(jnp.int32, (CH, nc), 1)

    def _chunk(Lc32, args):
        ci_c, cj_c, w_c = args
        E = ((cols_iota == ci_c[:, None]).astype(jnp.float32)
             - (cols_iota == cj_c[:, None]).astype(jnp.float32))
        Lc32 = Lc32 + jnp.matmul(
            E.T * w_c[None, :], E,
            precision=jax.lax.Precision.HIGHEST)
        return Lc32, None

    Lc32, _ = jax.lax.scan(
        _chunk, jnp.zeros((nc, nc), jnp.float32),
        (ci_p.reshape(-1, CH), cj_p.reshape(-1, CH), w_p.reshape(-1, CH)))
    # In float64, rebuild the diagonal as minus the off-diagonal row sums:
    # Lc is then exactly (up to f64 rounding) the Laplacian of its
    # f32-rounded coarse weights, so it is positive semidefinite; the f32
    # diagonal sums could leave it indefinite by ~eps_f32 * ||Lc||.
    eye = jnp.eye(nc, dtype=jnp.float64)
    off = Lc32.astype(jnp.float64) * (1.0 - eye)
    Lc = off - jnp.diag(jnp.sum(off, axis=1))
    # Rank-one constant-mode shift (same trick as the eigensolver) removes
    # the zero eigenvalue of the constant vector. A graph with several
    # connected components keeps one more zero eigenvalue per extra
    # component; the diagonal term, far below any nonzero coarse
    # eigenvalue of a connected graph, keeps the Cholesky defined there.
    cshift = 2.0 * jnp.max(jnp.diag(Lc)) + 1.0
    Lc_reg = (Lc + (cshift / nc) * jnp.ones((nc, nc), dtype=jnp.float64)
              + (1e-10 * cshift) * eye)
    # Inverse computed once, in float64, applied in dtype.
    Rc = jnp.linalg.cholesky(Lc_reg, upper=True)
    Rc_inv = jax.scipy.linalg.solve_triangular(Rc, eye, lower=False)
    Lc_inv = (Rc_inv @ Rc_inv.T).astype(dtype)

    pad = nc * s - n

    def center(B):
        return B - jnp.mean(B, axis=0, keepdims=True)

    def smooth(B):
        return tridiag_solve_factored(fac, B)

    def restrict(R):  # (n, q) -> (nc, q): sum within aggregates
        if pad:
            R = jnp.concatenate(
                [R, jnp.zeros((pad, R.shape[1]), R.dtype)], axis=0
            )
        return R.reshape(nc, s, -1).sum(axis=1)

    def prolong(Xc):  # (nc, q) -> (n, q): piecewise-constant
        X = jnp.repeat(Xc, s, axis=0)
        return X[:n]

    def precond(B: jax.Array) -> jax.Array:
        B = center(B)
        # Pre-smooth.
        x = smooth(B)
        # Coarse correction on the smoothed residual.
        r = B - apply_L(x)
        xc = jnp.dot(Lc_inv, restrict(r), preferred_element_type=dtype)
        x = x + prolong(xc)
        # Post-smooth (symmetrizes the cycle, required for CG).
        r2 = B - apply_L(x)
        x = x + smooth(r2)
        return center(x)

    return precond
