"""Fiedler-pair front-end: (lambda_2, v_2, X-block) of a graph Laplacian.

Parity surface (reference: mac/utils/fiedler.py:9-44): accepts a host
(scipy-sparse or dense) Laplacian, a warm-start block X, a method name and a
tolerance, and returns the 3-tuple (sigma[0], X[:, 0], X) so callers can
warm-start subsequent solves.

Reference method names 'tracemin_lu' / 'tracemin_cholesky' are accepted and
dispatch to the device engine ('tracemin': preconditioned block inverse
iteration — see mac_tpu.ops.lobpcg; instead of a sparse LU/Cholesky, inner
CG with a tridiagonal-part solve owns their role). 'lobpcg' selects the
LOBPCG variant; 'dense' forces the exact dense-eigh oracle.

Unlike the reference (which delegates to NetworkX private internals at
fiedler.py:42), the solver is owned by this repo and fully jitted. It also
supports disconnected graphs (lambda_2 = 0), the reference's known
unsupported case (reference tests/utils/test_fiedler.py:43-50).
"""

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from mac_tpu.ops.laplacian import (
    GraphOperator,
    build_operator,
    lap_apply,
    lap_dense,
    lap_inf_norm,
    lap_tridiagonal_part,
)
from mac_tpu.ops.lobpcg import (
    FiedlerResult,
    dense_fiedler,
    lobpcg_fiedler,
    tracemin_fiedler,
)
from mac_tpu.ops.cg import pcg_fixed
from mac_tpu.ops.tridiag import tridiag_ldl_auto, tridiag_solve_factored
from mac_tpu.ops import precond as _precond
from mac_tpu.ops import twogrid as _twogrid

# Graphs at or below this size are solved exactly with dense eigh.
DENSE_EIGH_MAX_N = 256

_DEFAULT_SEED = 7  # reference quirk preserved: np.random.RandomState(7)


def scipy_lam2(L) -> float:
    """Float64 lambda_2 via shift-invert Lanczos on the host — the
    impartial quality referee used by the benchmark/probe scripts;
    independent of mac_tpu's own eigensolver. WARNING: shift-invert
    factorizes L; on large graphs with heavy loop-closure fill the splu
    can take minutes — bench scripts only call this on the bundled
    datasets where it is known cheap."""
    import scipy.sparse.linalg as spla

    vals = spla.eigsh(L.astype(np.float64), k=2, sigma=-1e-9, which="LM",
                      return_eigenvectors=False)
    return float(np.sort(vals)[-1])


def default_dtype():
    """Backend-aware compute dtype: float32 on accelerators (half the bytes
    of the memory-bound applies; the spectral probe in MAC escalates
    instances float32 cannot resolve), float64 on CPU (numerical-parity
    mode). x64 is always enabled (mac_tpu/__init__.py) so the choice is
    explicit, not implicit."""
    return jnp.float64 if jax.default_backend() == "cpu" else jnp.float32


def default_block(n: int, q: Optional[int] = None, seed: Optional[int] = None,
                  dtype=None) -> np.ndarray:
    """Deterministic initial eigenvector block: q = min(4, n-1) columns of
    N(0,1), matching the reference's RandomState(7) init
    (reference: fiedler.py:27-32)."""
    if q is None:
        q = min(4, n - 1)
    rs = np.random.RandomState(_DEFAULT_SEED if seed is None else seed)
    X = np.asarray(rs.normal(size=(q, n))).T
    if dtype is not None:
        X = X.astype(dtype)
    return X


def fiedler_pair_op(
    op: GraphOperator,
    w: jax.Array,
    X: jax.Array,
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
    inner_iters: int = 16,
    rel_tol: Optional[float] = None,
    chain_w: Optional[jax.Array] = None,
    method: str = "tracemin",
    precond: str = "twogrid",
    apply_override=None,
    banded=None,
    coeff_dtype=None,
    banded_pstate=None,
    banded_use_prev=None,
    banded_rebuild=None,
    return_banded_pstate: bool = False,
    lam0=None,
    warm_init=None,
    banded_shardings=None,
) -> FiedlerResult:
    """Device-side Fiedler solve on a GraphOperator with weights w.

    Traceable: usable inside jit / vmap / while_loop.

    The default method is TRACEMIN: block inverse iteration whose inner
    solves are `inner_iters` CG steps preconditioned by an exact solve of
    the tridiagonal part of L(w) (diagonal + odometry-chain band — see
    mac_tpu.ops.tridiag). This inexact shift-invert replaces the
    reference's SuperLU/CHOLMOD inner solves. `inner_iters` is the
    float32 accuracy lever: the achievable eigenvector error tracks the
    inner-solve accuracy in the low (global) modes. `chain_w` is accepted for
    API compatibility but the tridiagonal part is extracted from (op, w)
    directly, which also covers non-chain graphs (falls back to diagonal
    scaling naturally).

    banded_pstate / banded_use_prev / banded_rebuild /
    return_banded_pstate: warm-rebuild
    protocol for the banded preconditioner's carryable coarse-inverse
    state (mac_tpu.ops.banded.PrecondState) — lets Frank-Wolfe refresh it
    with Newton-Schulz matmuls instead of a cold Cholesky build each step.
    With return_banded_pstate=True the call returns
    (FiedlerResult, PrecondState-or-None).
    """
    n = op.n
    q = X.shape[1]

    def _ret(res, pstate=None):
        return (res, pstate) if return_banded_pstate else res

    if apply_override is None and (
        method == "dense" or (op.mode == "dense" and n <= DENSE_EIGH_MAX_N)
    ):
        # Thread any incoming PrecondState through unchanged: callers that
        # carry pstate in a while_loop (MAC._fw_impl with use_banded) need
        # the carry pytree structure preserved even when the fiedler path
        # routes dense.
        return _ret(dense_fiedler(lap_dense(op, w), q), banded_pstate)

    BD = None
    if apply_override is not None:
        apply_L = lambda V: apply_override(w, V)
    elif banded is not None:
        # Block-banded matmul apply (RCM-ordered operators; see
        # mac_tpu.ops.banded). Exact f32 semantics via precision=HIGHEST.
        from mac_tpu.ops import banded as _banded

        BD = _banded.assemble_bd(banded, w)
        if banded_shardings is not None:
            # Multi-chip: constrain the block-row tensors 'graph'-sharded;
            # XLA partitions the batched-matmul apply across devices.
            up_s, deg_s = banded_shardings
            BD = BD._replace(
                ut=jax.lax.with_sharding_constraint(BD.ut, up_s),
                deg=jax.lax.with_sharding_constraint(BD.deg, deg_s))
        apply_L = lambda V: _banded.banded_apply(banded, BD, V)
    elif op.mode == "dense":
        Ld = lap_dense(op, w)
        apply_L = lambda V: jnp.dot(Ld, V, preferred_element_type=V.dtype)
    else:
        apply_L = lambda V: lap_apply(op, w, V)

    if BD is not None:
        # ||L||_inf = 2 max degree, read off BD's diagonal — the ELL-table
        # route costs an (n, dmax) gather per weight update.
        lnorm = 2.0 * jnp.max(BD.deg)
    else:
        lnorm = lap_inf_norm(op, w)
    c = lnorm

    def apply_shifted(V):
        from mac_tpu.ops.lobpcg import _shift_term

        return apply_L(V) + _shift_term(V, c)

    pstate_out = None
    if BD is not None:
        from mac_tpu.ops import banded as _banded

        if banded_pstate is not None or return_banded_pstate:
            Minv, pstate_out = _banded.make_banded_precond(
                banded, BD, w=w, prev_state=banded_pstate,
                use_prev=banded_use_prev, rebuild=banded_rebuild,
                return_state=True)
        else:
            Minv = _banded.make_banded_precond(banded, BD, w=w)
    elif precond == "twogrid":
        Minv = _twogrid.make_twogrid_precond(op, w, apply_L)
    else:
        d, e = lap_tridiagonal_part(op, w)
        eps = 100 * jnp.finfo(w.dtype).eps
        fac = tridiag_ldl_auto(d + eps * jnp.max(d), e)

        def center(B):
            return B - jnp.mean(B, axis=0, keepdims=True)

        def Minv(B):
            # Restrict the tridiagonal solve to 1^perp so the shifted
            # constant mode is never amplified.
            return center(tridiag_solve_factored(fac, center(B)))

    if method == "lobpcg":
        pc = lambda R: pcg_fixed(apply_shifted, R, Minv, iters=inner_iters)
        return _ret(lobpcg_fiedler(apply_L, X, lnorm, precond=pc, tol=tol,
                                   maxiter=maxiter), pstate_out)
    # Default: TRACEMIN (block inverse iteration) — float32-stable; see
    # mac_tpu.ops.lobpcg.tracemin_fiedler.
    return _ret(tracemin_fiedler(
        apply_L, X, lnorm, Minv, tol=tol, maxiter=maxiter,
        inner_iters=inner_iters, rel_tol=rel_tol, coeff_dtype=coeff_dtype,
        lam0=lam0, warm_init=warm_init,
        min_iters=1 if lam0 is not None else 0,
    ), pstate_out)


def _op_from_matrix(L) -> Tuple[GraphOperator, np.ndarray, Optional[np.ndarray]]:
    """Extract (operator, edge weights, chain weights or None) from a host
    Laplacian matrix. Chain weights are returned when the graph contains the
    full path 0-1-...-(n-1) (enables the exact chain preconditioner)."""
    if sp.issparse(L):
        coo = sp.triu(L, k=1).tocoo()
        idx = np.stack([coo.row, coo.col], axis=1).astype(np.int32)
        w = -np.asarray(coo.data)
    else:
        L = np.asarray(L)
        iu, ju = np.triu_indices(L.shape[0], k=1)
        vals = L[iu, ju]
        nz = vals != 0
        idx = np.stack([iu[nz], ju[nz]], axis=1).astype(np.int32)
        w = -vals[nz]
    n = L.shape[0]
    chain_w = _precond.extract_chain_weights(idx, w, n)
    return build_operator(idx, n), w, chain_w


def _normalized_fiedler(L, X, tol: float, maxiter: int):
    """Fiedler pair of the NORMALIZED Laplacian N = D^{-1/2} L D^{-1/2}.

    The reference's normalized branch is broken (undefined `L`,
    mac/utils/cholesky.py:316); this is a working matrix-free version.
    Approach: apply N matrix-free through the similarity transform
    (never materializing it), run the same TRACEMIN engine with the
    nullspace generalized to u = D^{1/2}1/||D^{1/2}1||, and precondition
    with the two-grid V-cycle of L conjugated back through D^{1/2}
    (M_N^{-1} = D^{1/2} M_L^{-1} D^{1/2}, exact if M_L were L).
    Eigenvalues of N lie in [0, 2], so the nullspace shift is the
    constant 2.
    """
    n = L.shape[0]
    dtype = X.dtype
    d = np.asarray(L.diagonal() if sp.issparse(L) else np.diag(np.asarray(L)),
                   dtype=np.float64)
    if np.any(d <= 0):
        raise ValueError(
            "normalized Laplacian needs strictly positive degrees; "
            f"min diagonal = {d.min()} (isolated node?)")
    s_host = 1.0 / np.sqrt(d)
    if n <= DENSE_EIGH_MAX_N:
        Ld = np.asarray(L.todense() if sp.issparse(L) else L, dtype=np.float64)
        N = s_host[:, None] * Ld * s_host[None, :]
        evals, vecs = np.linalg.eigh((N + N.T) / 2)
        q = X.shape[1]
        Xb = jnp.asarray(vecs[:, 1:q + 1], dtype)
        return (jnp.asarray(evals[1], dtype), Xb[:, 0], Xb)

    op, w, _ = _op_from_matrix(L)
    w = jnp.asarray(w, dtype=dtype)
    s = jnp.asarray(s_host, dtype)
    sqd = jnp.asarray(np.sqrt(d), dtype)
    u = jnp.asarray(np.sqrt(d) / np.linalg.norm(np.sqrt(d)), dtype)

    def apply_N(V):
        return s[:, None] * lap_apply(op, w, s[:, None] * V)

    Minv_L = _twogrid.make_twogrid_precond(
        op, w, lambda V: lap_apply(op, w, V))

    def Minv_N(B):
        return sqd[:, None] * Minv_L(sqd[:, None] * B)

    res = tracemin_fiedler(apply_N, jnp.asarray(X, dtype), jnp.asarray(2.0, dtype),
                           Minv_N, tol=tol, maxiter=maxiter, nullvec=u)
    return res.lam[0], res.X[:, 0], res.X


def find_fiedler_pair(
    L,
    X=None,
    method: str = "tracemin",
    tol: float = 1e-8,
    seed=None,
    maxiter: int = 1000,
    normalized: bool = False,
):
    """Compute (lambda_2(L), v_2(L), X-block) from a host Laplacian.

    L: scipy sparse or dense (n, n) Laplacian.
    X: optional (n, q) warm-start block. Any width 1 <= q < n is accepted
       (e.g. a warm block produced by MAC with a non-default
       `fiedler_block_q`); when None, q = min(4, n-1) columns are seeded
       deterministically like the reference.
    method: 'tracemin' (default), 'lobpcg', 'dense', or the reference
       names 'tracemin_lu' / 'tracemin_cholesky' (mapped to 'tracemin').
    seed: optional numpy RandomState for the initial block.
    normalized: solve on the normalized Laplacian D^{-1/2} L D^{-1/2}
       instead (a capability the reference advertises but whose
       implementation is broken — see _normalized_fiedler).

    Returns (sigma_0, X[:, 0], X) — reference: fiedler.py:44.
    """
    n = L.shape[0]
    dtype = default_dtype()
    if X is None:
        q = min(4, n - 1)
        if isinstance(seed, np.random.RandomState):
            X = np.asarray(seed.normal(size=(q, n))).T
        else:
            X = default_block(n, q, seed=seed)
    X = jnp.asarray(X, dtype=dtype)
    assert X.shape[0] == n
    assert 1 <= X.shape[1] < max(n, 2)

    if method in ("tracemin_lu", "tracemin_cholesky"):
        method = "tracemin"

    if normalized:
        return _normalized_fiedler(L, X, tol, maxiter)

    op, w, chain_w = _op_from_matrix(L)
    w = jnp.asarray(w, dtype=dtype)
    if chain_w is not None:
        chain_w = jnp.asarray(chain_w, dtype=dtype)
    res = fiedler_pair_op(op, w, X, tol=tol, maxiter=maxiter, method=method,
                          chain_w=chain_w)
    return res.lam[0], res.X[:, 0], res.X


def tracemin_fiedler_cholesky(L, X=None, normalized=False, tol=1e-8):
    """Reference-name parity wrapper (mac/utils/cholesky.py:137-240): the
    reference's 'tracemin_cholesky' solver is a TRACEMIN iteration with
    CHOLMOD inner solves; here every tracemin path runs the device
    preconditioned engine. `normalized=True` WORKS here (the reference's
    own normalized branch is broken — undefined `L`, cholesky.py:316):
    it solves on D^{-1/2} L D^{-1/2} via the similarity-transformed
    matrix-free apply (see _normalized_fiedler)."""
    lam, v, X = find_fiedler_pair(L, X=X, method="tracemin_cholesky", tol=tol,
                                  normalized=normalized)
    import numpy as _np

    return _np.array([float(lam)]), _np.asarray(X).T


def find_fiedler_pair_cholesky(L, x=None, normalized=False, tol=1e-8,
                               seed=None):
    """Reference-name parity wrapper (mac/utils/cholesky.py:243-247):
    returns (lambda_2, fiedler_vector)."""
    sigma, X = tracemin_fiedler_cholesky(L, X=x, normalized=normalized, tol=tol)
    return sigma[0], X[0]
