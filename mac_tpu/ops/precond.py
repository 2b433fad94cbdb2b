"""Preconditioners for Laplacian eigensolves and CG.

The reference library accelerates its inner solves with exact sparse
factorizations (SuperLU via NetworkX, CHOLMOD via scikit-sparse —
reference: mac/utils/fiedler.py:42, mac/utils/cholesky.py:107-134). Sparse
direct factorization does not map to a jitted device loop; instead we
exploit problem structure:

  * ``chain``: in pose-graph SLAM the fixed subgraph is the odometry chain —
    a path graph, whose Laplacian is tridiagonal and whose (pseudo-)inverse
    applies in O(n) via two parallel prefix sums (log-depth scans).
    This is an exact solve on the spanning-tree part of L(x) — a
    Vaidya-style spanning-tree preconditioner that removes the O(n^2)
    condition number of the chain.

  * ``jacobi``: diagonal scaling, the generic fallback.

All preconditioners are pure functions (n, q) -> (n, q) suitable for use
inside `jit`/`lax.while_loop`.
"""

from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np


def extract_chain_weights(
    fixed_idx: np.ndarray, fixed_w: np.ndarray, num_nodes: int
) -> Optional[np.ndarray]:
    """If the fixed edges contain the full path 0-1-...-(n-1) (the odometry
    chain of a pose graph), return the (n-1,) per-slot chain weights
    (parallel chain edges merged by summation), else None.
    """
    fixed_idx = np.asarray(fixed_idx)
    fixed_w = np.asarray(fixed_w)
    if num_nodes < 2 or fixed_idx.shape[0] == 0:
        return None
    lo = fixed_idx.min(axis=1)
    hi = fixed_idx.max(axis=1)
    is_chain_edge = hi - lo == 1
    slot_w = np.zeros(num_nodes - 1, dtype=np.float64)
    np.add.at(slot_w, lo[is_chain_edge], fixed_w[is_chain_edge])
    if (slot_w <= 0.0).any():
        return None
    return slot_w


def make_chain_precond(chain_w: jnp.ndarray) -> Callable:
    """Exact pseudo-inverse apply for a path-graph Laplacian.

    chain_w: (n-1,) positive weights of edges (i, i+1).

    Solves L_chain y = P b (P = projection onto 1^perp) via:
      flows   phi_i = -cumsum(Pb)_i          (flow on edge i -> i+1)
      pots    y_{i+1} = y_i + phi_i / w_i    (second cumsum)
    then re-centers y ⊥ 1. Two log-depth scans; no factorization.
    """
    inv_w = 1.0 / chain_w  # (n-1,)

    def apply(B: jnp.ndarray) -> jnp.ndarray:  # B: (n, q)
        Bp = B - B.mean(axis=0, keepdims=True)
        phi = -jnp.cumsum(Bp[:-1, :], axis=0)  # (n-1, q)
        incr = phi * inv_w[:, None]
        y = jnp.concatenate([jnp.zeros((1, B.shape[1]), B.dtype),
                             jnp.cumsum(incr, axis=0)], axis=0)
        return y - y.mean(axis=0, keepdims=True)

    return apply


def make_chain_precond_pinned(chain_w: jnp.ndarray) -> Callable:
    """Exact solve of the node-0-pinned path-graph Laplacian (for reduced
    systems, used by GreedyESP effective-resistance solves).

    With y_0 = 0 fixed and rows 1..n-1 active: phi_i = sum_{j>i} b_j
    (reverse cumulative sum), then y_{i+1} = y_i + phi_i / w_i.
    Row 0 of the input is ignored and row 0 of the output is zero.
    """
    inv_w = 1.0 / chain_w

    def apply(B: jnp.ndarray) -> jnp.ndarray:  # B: (n, q), row 0 ignored
        b = B.at[0, :].set(0.0)
        # phi_i = sum_{j >= i+1} b_j for i = 0..n-2
        rev = jnp.cumsum(b[::-1, :], axis=0)[::-1, :]  # rev[i] = sum_{j>=i} b_j
        phi = rev[1:, :]  # (n-1, q)
        incr = phi * inv_w[:, None]
        y = jnp.concatenate([jnp.zeros((1, B.shape[1]), B.dtype),
                             jnp.cumsum(incr, axis=0)], axis=0)
        return y

    return apply


def make_jacobi_precond(deg: jnp.ndarray, eps: float = 1e-12) -> Callable:
    """Diagonal (weighted-degree) scaling."""
    inv = 1.0 / jnp.maximum(deg, eps)

    def apply(B: jnp.ndarray) -> jnp.ndarray:
        return inv[:, None] * B

    return apply


def identity_precond(B: jnp.ndarray) -> jnp.ndarray:
    return B
