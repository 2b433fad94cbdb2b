"""Preconditioned block eigensolver for the Fiedler pair (lambda_2, v_2).

This owns the role the reference delegates to NetworkX's private
`_tracemin_fiedler` with SuperLU/CHOLMOD inner solves (reference:
mac/utils/fiedler.py:42, mac/utils/cholesky.py:137-240). The device
design differs structurally:

  * Nullspace handling: rather than repeatedly projecting onto 1^perp (the
    reference's deflation, fragile when a jitted QR basis degenerates), we
    solve for the *smallest* eigenpairs of the rank-one-corrected operator

        A' = L + (c / n) * 1 1^T,   c = ||L||_inf >= lambda_max(L),

    which moves the constant mode's eigenvalue from 0 to c. Every Ritz value
    of A' is then >= lambda_2(L) by Courant-Fischer, so spurious directions
    introduced by QR on a near-degenerate basis can never masquerade as the
    Fiedler value. The correction applies in O(nq) (a column-mean broadcast).

  * Inner solves are replaced by a preconditioner application (exact
    path-graph solve via prefix sums, or Jacobi — see mac_tpu.ops.precond),
    inside a single `lax.while_loop`: static shapes, no host round-trips.

  * Warm starting: the previous eigenvector block X is threaded in/out so
    Frank-Wolfe iterations reuse spectral information (the reference's
    Cache, implemented so it actually engages — see SURVEY.md §3.1).

Convergence criterion matches the reference tracemin:
    ||A x_1 - lambda_1 x_1||_1 / ||L||_inf < tol
(reference: mac/utils/cholesky.py:228-230).
"""

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from mac_tpu.ops.cg import pcg_fixed


class FiedlerResult(NamedTuple):
    lam: jax.Array      # (q,) Ritz values, lam[0] = lambda_2(L)
    X: jax.Array        # (n, q) Ritz vectors, X[:, 0] = Fiedler vector
    iters: jax.Array    # () int32 outer iterations used
    res: jax.Array      # () final residual (reference criterion)


def _colnorm(S: jax.Array) -> jax.Array:
    """Scale columns to unit norm (guards CholQR against the wild column-
    scale disparity of an LOBPCG basis, where the preconditioned residual
    block can be orders of magnitude smaller than the orthonormal X block —
    essential in float32, where kappa(S)^2 otherwise swamps the Gram
    Cholesky).

    The norm floor is *relative* to the largest column: a fully-converged
    correction block is pure rounding noise with norms near the underflow
    threshold, and dividing by `tiny` would overflow to inf and poison the
    Gram Cholesky with NaNs. Columns at the floor stay ~0 and are absorbed
    by CholQR's jitter."""
    nrm = jnp.linalg.norm(S, axis=0, keepdims=True)
    floor = jnp.finfo(S.dtype).eps * jnp.maximum(jnp.max(nrm), 1.0)
    return S / jnp.maximum(nrm, floor)


def _hi(x: jax.Array) -> jax.Array:
    """Upcast to float64 for coefficient-level algebra.

    Mixed-precision policy: all O(n)-sized blocks stay in the compute dtype
    (float32 on accelerators — memory bandwidth), but the small Gram /
    Cholesky / eigh coefficient problems run in float64. In float32 these
    coefficient problems carry absolute noise at eps * ||Gram|| which rivals
    eigenvalue gaps and floors eigensolver convergence around 1e-2 (measured
    on city10000); the f64 contractions are O(n q^2) emulated MACs — noise
    there is what's eliminated, at negligible cost next to the O(n dmax q)
    operator applies."""
    return x.astype(jnp.float64)


def _gram(A: jax.Array, B: jax.Array, coeff_dtype) -> jax.Array:
    """A^T B at coefficient precision: emulated float64 matmuls when
    coeff_dtype is float64 (the safe default — see _hi), else the compute
    dtype with exact-f32 (HIGHEST precision) accumulation. The f32 option
    is the cheaper one at ~sqrt(n)*eps_f32 Gram accumulation noise — acceptable for
    TRACEMIN, whose basis spans only low eigenmodes (||H|| ~ lambda_{3q})."""
    if coeff_dtype == jnp.float64:
        return _hi(A).T @ _hi(B)
    return jnp.matmul(A.T, B, precision=jax.lax.Precision.HIGHEST)


def _cholqr(S: jax.Array, coeff_dtype=jnp.float64) -> jax.Array:
    """One CholeskyQR pass: Q = S @ chol(S^T S + jitter)^-1.

    Matmul-shaped (one Gram matmul + tiny Cholesky + triangular solve)
    and far cheaper to compile and run than Householder QR. The Gram and
    the inverse-factor coefficients are computed at coeff_dtype (see
    _gram); only the final (n, k) @ (k, k) application runs in the compute
    dtype. The jitter keeps the Cholesky finite on rank-deficient bases
    (which LOBPCG produces at convergence); the resulting extra directions
    are harmless because the shifted operator bounds every Ritz value below
    by lambda_2 (see module docstring)."""
    G = _gram(S, S, coeff_dtype)
    k = G.shape[0]
    jitter = k * jnp.finfo(S.dtype).eps * (jnp.trace(G) + 1.0)
    R = jnp.linalg.cholesky(G + jitter * jnp.eye(k, dtype=G.dtype), upper=True)
    Rinv = jax.scipy.linalg.solve_triangular(
        R, jnp.eye(k, dtype=G.dtype), lower=False
    )
    return S @ Rinv.astype(S.dtype)


def _orth(S: jax.Array, coeff_dtype=jnp.float64) -> jax.Array:
    """Orthonormalize columns: column scaling, then CholeskyQR2 (two passes
    restore full orthogonality — the standard remedy for CholQR's squared
    conditioning)."""
    return _cholqr(_cholqr(_colnorm(S), coeff_dtype), coeff_dtype)


def _ortho_against(X: jax.Array, Y: jax.Array) -> jax.Array:
    """Project the columns of Y orthogonal to the orthonormal block X with
    two classical Gram-Schmidt passes (CGS2).

    This must happen in the *vector* space before any Gram-based
    orthonormalization: near convergence Y is nearly parallel to X (angle
    ~ current eigenvector error), and a Gram matrix squares that angle —
    in float32 an angle below sqrt(eps) ~ 3e-4 becomes invisible to
    CholQR, which silently replaces the correction direction with jitter
    noise and floors convergence. CGS2 extracts the perpendicular
    component to ~eps accuracy regardless of how small the angle is."""
    Y = Y - X @ (X.T @ Y)
    Y = Y - X @ (X.T @ Y)
    return Y


def _shift_term(V: jax.Array, c) -> jax.Array:
    """(c / n) * 1 1^T V with the column means accumulated in float64.

    The shift constant c = ||L||_inf can exceed lambda_2 by 8+ orders of
    magnitude on large chain-dominated pose graphs (ais2klinik); a float32
    mean of an approximately-centered block carries ~eps error which the
    multiplication by c amplifies to noise *above the eigen-signal*.
    Accumulating the mean in float64 makes the rank-one correction
    exact at float32 storage precision."""
    m64 = jnp.mean(V.astype(jnp.float64), axis=0, keepdims=True)
    return (jnp.asarray(c, jnp.float64) * m64).astype(V.dtype)


def lobpcg_fiedler(
    apply_L: Callable[[jax.Array], jax.Array],
    X0: jax.Array,
    lnorm: jax.Array,
    *,
    precond: Optional[Callable[[jax.Array], jax.Array]] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
) -> FiedlerResult:
    """Compute the q smallest nonzero eigenpairs of a graph Laplacian.

    apply_L: (n, k) -> (n, k) matrix-free Laplacian product (any k).
    X0:      (n, q) initial block (warm start welcome; q >= 1).
    lnorm:   scalar ||L||_inf (see lap_inf_norm); also the nullspace shift c.
    precond: approximate inverse of L restricted to 1^perp; identity if None.
    """
    n, q = X0.shape
    dtype = X0.dtype
    # An 1e-8 residual is unreachable in f32; clamp so the loop terminates
    # on convergence rather than maxiter. (documented f32 tolerance)
    eps = jnp.finfo(dtype).eps
    eff_tol = jnp.maximum(jnp.asarray(tol, dtype), 32 * eps)
    c = lnorm.astype(dtype)

    def apply_shifted(V):
        # A'V = LV + (c/n) * 1 (1^T V), f64-accumulated (see _shift_term).
        return apply_L(V) + _shift_term(V, c)

    if precond is None:
        precond = lambda B: B

    def project(V):
        # Remove the constant-mode component (keeps the search in 1^perp;
        # the shift makes this a performance nicety, not a correctness need).
        return V - jnp.mean(V, axis=0, keepdims=True)

    # --- init: Rayleigh-Ritz within the (projected, orthonormalized) X0.
    X = _orth(project(X0))
    AX = apply_shifted(X)
    H = _hi(X).T @ _hi(AX)
    lam, Y = jnp.linalg.eigh((H + H.T) / 2)
    lam = lam.astype(dtype)
    Y = Y.astype(dtype)
    X = X @ Y
    AX = AX @ Y
    # Previous-iterate block (plays the role of LOBPCG's P direction:
    # span{X_new, W, X_old} == span{X_new, W, P}). Seed with a deterministic
    # pseudo-random block so the first basis is full rank.
    key = jax.random.PRNGKey(7)
    Xprev = project(jax.random.normal(key, (n, q), dtype=dtype))

    def residual(lam, X, AX):
        r = AX[:, 0] - lam[0] * X[:, 0]
        return jnp.sum(jnp.abs(r)) / lnorm.astype(dtype)

    # Stall detection: in low precision (f32) the residual hits a
    # rounding floor above any fixed tolerance; stop when it hasn't
    # improved for STALL_PATIENCE iterations instead of burning maxiter.
    STALL_PATIENCE = 8

    def cond(carry):
        X, AX, lam, Xprev, it, res, best, since = carry
        return jnp.logical_and(
            jnp.logical_and(it < maxiter, res > eff_tol),
            since < STALL_PATIENCE,
        )

    def body(carry):
        X, AX, lam, Xprev, it, res, best, since = carry
        R = AX - X * lam[None, :]
        W = project(precond(R))
        # Classical LOBPCG hygiene: pre-orthogonalize the search block
        # against X (CGS2 — see _ortho_against) so the combined basis
        # enters CholQR well-conditioned.
        W = _ortho_against(X, W)
        P = _ortho_against(X, Xprev)
        S = jnp.concatenate([X, _colnorm(W), _colnorm(P)], axis=1)  # (n, 3q)
        Q = _orth(S)
        AQ = apply_shifted(Q)
        H = _hi(Q).T @ _hi(AQ)
        H = (H + H.T) / 2
        evals, Y = jnp.linalg.eigh(H)
        Cmat = Y[:, :q].astype(dtype)
        lam_new = evals[:q].astype(dtype)
        X_new = Q @ Cmat
        AX_new = AQ @ Cmat
        res_new = residual(lam_new, X_new, AX_new)
        near_floor = res_new < 4 * eff_tol  # see tracemin_fiedler's note
        improved = res_new < 0.97 * best
        best_new = jnp.minimum(best, res_new)
        since_new = jnp.where(
            jnp.logical_and(near_floor, ~improved), since + 1, 0
        )
        return (X_new, AX_new, lam_new, X, it + 1, res_new, best_new, since_new)

    it0 = jnp.asarray(0, jnp.int32)
    res0 = residual(lam, X, AX)
    zero = jnp.asarray(0, jnp.int32)
    X, AX, lam, Xprev, it, res, best, since = jax.lax.while_loop(
        cond, body, (X, AX, lam, Xprev, it0, res0, res0, zero)
    )
    return FiedlerResult(lam=lam, X=X, iters=it, res=res)


def tracemin_fiedler(
    apply_L: Callable[[jax.Array], jax.Array],
    X0: jax.Array,
    lnorm: jax.Array,
    Minv: Callable[[jax.Array], jax.Array],
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
    inner_iters: int = 16,
    stall_patience: int = 5,
    stall_factor: float = 0.99,
    rel_tol: Optional[float] = None,
    coeff_dtype=None,
    lam0: Optional[jax.Array] = None,
    warm_init=None,
    min_iters: int = 0,
    nullvec: Optional[jax.Array] = None,
) -> FiedlerResult:
    """Block inverse (subspace) iteration with Rayleigh-Ritz — TRACEMIN.

    nullvec: optional unit (n,) vector spanning the operator's nullspace
    when it is NOT the constant vector — e.g. D^{1/2}1/||D^{1/2}1|| for the
    normalized Laplacian N = D^{-1/2} L D^{-1/2}. Default None keeps the
    constant-vector handling (mean projection + (c/n)*1 1^T shift, which is
    the nullvec = 1/sqrt(n) special case).

    lam0 / warm_init: warm-entry protocol. When lam0 (a (q,) Ritz-value
    vector matching X0) is provided, the traced boolean `warm_init`
    selects between the full cold entry (orthonormalize X0 + initial
    Rayleigh-Ritz, a chain of latency-bound small ops) and the
    warm entry that TRUSTS X0 to be the Ritz-ordered orthonormal block a
    previous call returned — one operator apply replaces the whole init.
    Frank-Wolfe threads (X, lam) across steps so every warm step takes
    the cheap entry.

    Per outer iteration: approximately solve A' Y = X with `inner_iters`
    preconditioned CG steps (warm-started at X/lambda), then Rayleigh-Ritz
    on span[X, Y].

    Why this exists alongside lobpcg_fiedler: in float32 LOBPCG stalls at
    ~1e-2 relative error because its search basis necessarily contains
    high-eigenvalue components, so ||H|| ~ lambda_max and the 3q x 3q eigh
    injects eps*lambda_max of absolute noise into lambda_2 every iteration.
    Inverse iteration keeps the basis inside the *low* eigenspace, so
    ||H|| ~ lambda_{2q} and Rayleigh-Ritz noise scales with the eigenvalues
    being computed — float32-stable. This is also the role the reference's
    SuperLU/CHOLMOD TRACEMIN plays (mac/utils/cholesky.py:137-240), with
    the exact factorization solve replaced by tridiagonal-preconditioned CG.
    """
    n, q = X0.shape
    dtype = X0.dtype
    eps = jnp.finfo(dtype).eps
    # Coefficient-algebra dtype for the Gram/CholQR/Ritz problems (the
    # O(n)-block work always stays in `dtype`): float64 by default — the
    # measured-safe choice — float32 as the fast option (see _gram).
    if coeff_dtype is None:
        coeff_dtype = jnp.float64
    # Requested tolerances below the precision floor are clamped so the
    # loop exits on convergence instead of burning maxiter: ~2.4e-4 in
    # float32 (slightly below the two-grid iteration's typical residual
    # floor; the stall detector covers the gap), ~4.5e-13 in float64.
    # Looser clamps (1e-3) were measured to leave ~1% eigenvalue error on
    # kitti_05, enough for reported objectives to cross the dual bound.
    eff_tol = jnp.maximum(jnp.asarray(tol, dtype), 2048 * eps)
    c = lnorm.astype(dtype)
    # Tiny shift keeps the inner solves bounded when lambda_2 = 0
    # (disconnected graphs); Ritz values are computed against A' itself,
    # so the shift does not bias the reported eigenvalues.
    sigma = 32 * eps * c

    if nullvec is None:
        def _shift(V):
            return _shift_term(V, c)

        def project(V):
            m64 = jnp.mean(V.astype(jnp.float64), axis=0, keepdims=True)
            return V - m64.astype(V.dtype)
    else:
        # General unit nullspace vector u: shift c*u(u^T V), projection
        # V - u(u^T V). Coefficients accumulate in float64 for the same
        # reason as _shift_term (c can dwarf the eigen-signal).
        u64 = nullvec.astype(jnp.float64)

        def _shift(V):
            coef = u64[None, :] @ V.astype(jnp.float64)  # (1, k)
            return (jnp.asarray(c, jnp.float64)
                    * (u64[:, None] * coef)).astype(V.dtype)

        def project(V):
            coef = u64[None, :] @ V.astype(jnp.float64)
            return V - (u64[:, None] * coef).astype(V.dtype)

    def apply_shifted(V):
        return apply_L(V) + _shift(V)

    def apply_inner(V):
        return apply_shifted(V) + sigma * V

    def _cold_entry(Xin):
        X = _orth(project(Xin), coeff_dtype)
        AX = apply_shifted(X)
        H = _gram(X, AX, coeff_dtype)
        lam, Y0 = jnp.linalg.eigh((H + H.T) / 2)
        Y0 = Y0.astype(dtype)
        return X @ Y0, AX @ Y0, lam[:q].astype(dtype)

    if lam0 is None:
        X, AX, lam = _cold_entry(X0)
    else:
        def _warm_entry(Xin):
            # Trust Xin to be the orthonormal block a previous call's
            # Rayleigh-Ritz returned (orthonormal to ~eps, so skipping the
            # CholQR2 orthonormalization costs ~1e-6 eigenvalue error) but
            # still ROTATE it against the CURRENT operator: the entry RR
            # re-sorts the subspace for the new weights — dropping it was
            # measured to cost ~8e-4 of relaxed-objective quality on
            # city10000 (the entry RR acts as a free half-iteration).
            AX = apply_shifted(Xin)
            H = _gram(Xin, AX, coeff_dtype)
            lam, Y = jnp.linalg.eigh((H + H.T) / 2)
            Y = Y.astype(dtype)
            return Xin @ Y, AX @ Y, lam[:q].astype(dtype)

        X, AX, lam = jax.lax.cond(warm_init, _warm_entry, _cold_entry, X0)
    # Previous-iterate memory block (LOBPCG's P term): span[X_new, Y, X_old]
    # accumulates Krylov progress across restarts, which matters when the
    # fixed-budget inner CG can only partially resolve the preconditioner's
    # blind spots (global modes a local tridiagonal solve can't see).
    Xprev = project(jax.random.normal(jax.random.PRNGKey(7), (n, q), dtype=dtype))

    def residual(lam, X, AX):
        r = AX[:, 0] - lam[0] * X[:, 0]
        return jnp.sum(jnp.abs(r)) / lnorm.astype(dtype)

    # Eigenvalue-relative residual stopping: the legacy criterion
    # ||r||_1/||L||_inf cannot certify convergence when lambda_2/||L|| is
    # below the compute-dtype epsilon (ais2klinik: ~1e-8; kitti_02: ~2e-6)
    # — the solve would "converge" by that test with the eigenvalue off by
    # 2-3x. ||A x - lambda x||_2 / lambda is the standard scale-invariant
    # certificate: lambda's error is quadratic in it. (Plateau-based tests
    # — "lambda stopped changing" — are unsafe: Rayleigh quotients are
    # stationary and plateau mid-convergence.)
    if rel_tol is None:
        rel_tol_v = jnp.asarray(1e-3 if dtype == jnp.float32 else 1e-7, dtype)
    else:
        rel_tol_v = jnp.asarray(rel_tol, dtype)

    def rel_residual(lam, X, AX):
        r = AX[:, 0] - lam[0] * X[:, 0]
        return jnp.linalg.norm(r) / jnp.maximum(lam[0], sigma)

    def cond(carry):
        X, AX, lam, Xprev, it, res, best, since, rres = carry
        # The legacy (reference-criterion) stop only counts when the
        # relative residual is also sane: on tiny-lambda graphs
        # ||r||_1/||L||_inf is below any tolerance from the first
        # iteration while the eigenpair is still garbage. Measured scales:
        # a catastrophically-wrong f32 solve (kitti_02) sits at rres ~ 400,
        # a healthy converged f32 solve (city10000) at ~0.3-0.5 in-loop
        # (f32 measurement inflates the true 0.15 residual) — the 2.0 gate
        # separates them with two orders of magnitude of margin.
        legacy_done = jnp.logical_and(res <= eff_tol, rres < 2.0)
        keep = jnp.logical_and(~legacy_done, rres > rel_tol_v)
        go = jnp.logical_and(
            jnp.logical_and(it < maxiter, keep), since < stall_patience
        )
        # min_iters forces at least that many outers regardless of the
        # entry residual — a warm entry (lam0/warm_init) whose carried
        # block already sits inside rel_tol would otherwise run ZERO
        # iterations and return the PREVIOUS operator's eigenvectors
        # verbatim, silently freezing the caller's gradient direction.
        if min_iters > 0:
            go = jnp.logical_or(go, it < min_iters)
        return go

    def body(carry):
        X, AX, lam, Xprev, it, res, best, since, rres = carry
        # Inverse-iteration step: Y ~= A'^-1 X, warm-started at X / lam.
        inv_lam = 1.0 / jnp.maximum(lam, sigma)
        Y = pcg_fixed(apply_inner, X, Minv, iters=inner_iters, X0=X * inv_lam[None, :])
        Y = project(Y)
        # Extract the correction components perpendicular to X in the
        # vector space (CGS2) — see _ortho_against for why this cannot be
        # left to the Gram-based orthonormalization in float32.
        Yp = _colnorm(_ortho_against(X, Y))
        Pp = _colnorm(_ortho_against(X, Xprev))
        S = jnp.concatenate([X, Yp, Pp], axis=1)  # (n, 3q)
        Q = _orth(S, coeff_dtype)
        AQ = apply_shifted(Q)
        H = _gram(Q, AQ, coeff_dtype)
        H = (H + H.T) / 2
        evals, C = jnp.linalg.eigh(H)
        Cq = C[:, :q].astype(dtype)
        lam_new = evals[:q].astype(dtype)
        X_new = Q @ Cq
        AX_new = AQ @ Cq
        res_new = residual(lam_new, X_new, AX_new)
        # Stall detection exists to catch the *precision floor* (residual
        # plateaus just above the clamped tolerance, common in float32) —
        # it must NOT fire during a merely-slow convergence phase far from
        # tolerance, which produces silently-unconverged (overestimated)
        # eigenvalues. Only count non-improving iterations near the floor.
        near_floor = res_new < 4 * eff_tol
        improved = res_new < stall_factor * best
        best_new = jnp.minimum(best, res_new)
        since_new = jnp.where(
            jnp.logical_and(near_floor, ~improved), since + 1, 0
        )
        rres_new = rel_residual(lam_new, X_new, AX_new)
        return (X_new, AX_new, lam_new, X, it + 1, res_new, best_new,
                since_new, rres_new)

    it0 = jnp.asarray(0, jnp.int32)
    res0 = residual(lam, X, AX)
    rres0 = rel_residual(lam, X, AX)
    zero = jnp.asarray(0, jnp.int32)
    X, AX, lam, Xprev, it, res, best, since, rres = jax.lax.while_loop(
        cond, body, (X, AX, lam, Xprev, it0, res0, res0, zero, rres0)
    )
    return FiedlerResult(lam=lam, X=X, iters=it, res=res)


def dense_fiedler(L_dense: jax.Array, q: int) -> FiedlerResult:
    """Exact Fiedler pair via dense eigh — used for tiny graphs (n <= ~256)
    and as a test oracle. Returns eigenpairs 2..q+1 (skipping the constant
    mode), matching the block shape of lobpcg_fiedler."""
    n = L_dense.shape[0]
    evals, V = jnp.linalg.eigh((L_dense + L_dense.T) / 2)
    # For connected graphs eigenvalue 0 (constant mode) is evals[0]; for
    # disconnected graphs lambda_2 = 0 as well. Either way the Fiedler
    # value is evals[1] and the block is columns 1..q.
    hi = min(1 + q, n)
    lam = evals[1:hi]
    X = V[:, 1:hi]
    pad = q - lam.shape[0]
    if pad > 0:
        lam = jnp.concatenate([lam, jnp.full((pad,), evals[-1], lam.dtype)])
        X = jnp.concatenate([X, jnp.tile(V[:, -1:], (1, pad))], axis=1)
    return FiedlerResult(
        lam=lam, X=X, iters=jnp.asarray(0, jnp.int32), res=jnp.asarray(0.0, L_dense.dtype)
    )
