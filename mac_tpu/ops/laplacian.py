"""Matrix-free weighted-Laplacian operators for the accelerator.

The graph Laplacian L(w) = sum_e w_e (e_i - e_j)(e_i - e_j)^T is never
materialized as a sparse matrix on device. Two apply paths:

  * ``dense``: materialize L(w) as an (n, n) dense array (one cheap
    scatter-add per weight update) and apply it with matmuls. Chosen for
    small graphs where (n, n) fits comfortably in device memory.

  * ``ell``: a padded-adjacency (ELLPACK) gather formulation. For each node
    we store a fixed-width table of (neighbor, edge-id); then

        (L(w) V)_i = (sum_k w_ik) V_i - sum_k w_ik V_{nbr_ik}

    which is pure gathers + reductions — no scatter in the hot loop
    (scatter-adds serialize on colliding indices; gathers along the
    leading axis vectorize well). The tables are static per graph topology; only the
    weight vector changes across Frank-Wolfe iterations.

This replaces the reference's per-iteration scipy COO->CSR assembly
(reference: mac/utils/graphs.py:58-98 rebuilt every iteration at
mac/solvers/mac.py:74-89).
"""

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# Graphs with n <= DENSE_MAX_N use the dense path (exact eigh for the
# Fiedler solve). Larger graphs use the ELL gather path: beyond bandwidth,
# the dense matmul apply L @ V also suffers catastrophic float32
# cancellation on smooth eigenvectors (rows of L sum to zero), whereas the
# ELL difference-form apply is backward-stable — see _ell_apply.
DENSE_MAX_N = 256


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GraphOperator:
    """Static per-topology data for matrix-free L(w) products.

    Fields:
      idx:      (m, 2) int32 edge endpoints.
      nbr_tbl:  (n, dmax) int32 neighbor node per adjacency slot (ELL), or
                a (1, 1) placeholder on the dense path.
      eid_tbl:  (n, dmax) int32 edge id per adjacency slot; padding slots
                point at the sentinel id `m` (weight 0).
      n, mode:  static metadata.
    """

    idx: jax.Array
    nbr_tbl: jax.Array
    eid_tbl: jax.Array
    chain_slot: jax.Array  # (m,) int32: lo endpoint if |i-j| == 1 else sentinel n-1
    chain_mask: jax.Array  # (m,) bool: edge connects consecutive nodes
    coarse_idx: jax.Array  # (m, 2) int32: edge endpoints // coarse_s
    n: int = dataclasses.field(metadata=dict(static=True))
    mode: str = dataclasses.field(metadata=dict(static=True))
    coarse_s: int = dataclasses.field(metadata=dict(static=True))
    coarse_nc: int = dataclasses.field(metadata=dict(static=True))

    @property
    def m(self) -> int:
        return self.idx.shape[0]


def build_operator(idx: np.ndarray, num_nodes: int, mode: Optional[str] = None,
                   target_nc: int = 512) -> GraphOperator:
    """Build a GraphOperator from an (m, 2) edge-index array (host side).

    mode: 'dense', 'ell', or None (auto: dense iff n <= DENSE_MAX_N).
    target_nc: approximate coarse-grid size for the two-grid preconditioner
        (contiguous aggregates of s = ceil(n / target_nc) nodes).
    """
    idx = np.asarray(idx, dtype=np.int32).reshape(-1, 2)
    n = int(num_nodes)
    m = idx.shape[0]
    if mode is None:
        mode = "dense" if n <= DENSE_MAX_N else "ell"

    if mode == "dense":
        nbr = np.zeros((1, 1), dtype=np.int32)
        eid = np.zeros((1, 1), dtype=np.int32)
    else:
        # Build padded adjacency (ELL) tables.
        counts = np.zeros(n, dtype=np.int64)
        np.add.at(counts, idx[:, 0], 1)
        np.add.at(counts, idx[:, 1], 1)
        dmax = max(int(counts.max(initial=0)), 1)
        nbr = np.zeros((n, dmax), dtype=np.int32)
        eid = np.full((n, dmax), m, dtype=np.int32)  # sentinel -> weight 0
        cursor = np.zeros(n, dtype=np.int64)
        for t in range(m):
            i, j = int(idx[t, 0]), int(idx[t, 1])
            nbr[i, cursor[i]] = j
            eid[i, cursor[i]] = t
            cursor[i] += 1
            nbr[j, cursor[j]] = i
            eid[j, cursor[j]] = t
            cursor[j] += 1

    # Chain (tridiagonal-part) bookkeeping for the preconditioner: edges
    # between consecutive nodes contribute the off-diagonal band of L(w).
    lo = idx.min(axis=1)
    hi = idx.max(axis=1)
    is_chain = (hi - lo) == 1
    slot = np.where(is_chain, lo, max(n - 1, 0)).astype(np.int32)

    # Coarse aggregation (two-grid preconditioner): node i -> i // s.
    s = max(1, int(np.ceil(n / target_nc)))
    nc = int(np.ceil(n / s))
    coarse_idx = (idx // s).astype(np.int32)

    return GraphOperator(
        idx=jnp.asarray(idx),
        nbr_tbl=jnp.asarray(nbr),
        eid_tbl=jnp.asarray(eid),
        chain_slot=jnp.asarray(slot),
        chain_mask=jnp.asarray(is_chain),
        coarse_idx=jnp.asarray(coarse_idx),
        n=n,
        mode=mode,
        coarse_s=s,
        coarse_nc=nc,
    )


def lap_dense(op: GraphOperator, w: jax.Array) -> jax.Array:
    """Materialize L(w) as a dense (n, n) array (one scatter-add; used once
    per weight update on the dense path and for small-graph exact eigh)."""
    n = op.n
    i, j = op.idx[:, 0], op.idx[:, 1]
    rows = jnp.concatenate([i, j, i, j])
    cols = jnp.concatenate([j, i, i, j])
    vals = jnp.concatenate([-w, -w, w, w])
    L = jnp.zeros((n, n), dtype=w.dtype)
    return L.at[rows, cols].add(vals)


def lap_degrees(op: GraphOperator, w: jax.Array) -> jax.Array:
    """Weighted degree vector deg_i = sum_{e ni i} w_e (= diag of L(w))."""
    if op.mode == "ell":
        w_pad = jnp.concatenate([w, jnp.zeros((1,), dtype=w.dtype)])
        return w_pad[op.eid_tbl].sum(axis=1)
    i, j = op.idx[:, 0], op.idx[:, 1]
    deg = jnp.zeros((op.n,), dtype=w.dtype)
    return deg.at[i].add(w).at[j].add(w)


def lap_inf_norm(op: GraphOperator, w: jax.Array) -> jax.Array:
    """||L(w)||_inf = 2 * max weighted degree (row abs sums of a Laplacian)."""
    return 2.0 * jnp.max(lap_degrees(op, w))


def lap_tridiagonal_part(op: GraphOperator, w: jax.Array):
    """(d, e): the diagonal (weighted degrees) and the first off-diagonal
    band (sum of weights between consecutive nodes) of L(w). Feeds the
    tridiagonal preconditioner (mac_tpu.ops.tridiag)."""
    d = lap_degrees(op, w)
    wc = jnp.where(op.chain_mask, w, 0.0)
    e_full = jnp.zeros((max(op.n - 1, 1),), dtype=w.dtype)
    e = e_full.at[op.chain_slot].add(-wc) if op.n > 1 else e_full
    return d, e


def _ell_apply(op: GraphOperator, w: jax.Array, V: jax.Array) -> jax.Array:
    # Difference form (L V)_i = sum_k w_ik (V_i - V_nbr_ik), NOT the
    # algebraically equivalent deg_i V_i - sum_k w_ik V_nbr_ik: eigenvectors
    # of near-chain Laplacians vary smoothly, so the latter cancels two
    # O(deg*|V|) terms down to O(lambda*|V|) — a ~1e4x amplification of
    # float32 rounding that floors eigensolver accuracy at ~1e-3. Taking
    # the neighbor differences first is exact for close values (Sterbenz)
    # and keeps the apply backward-stable in the quantity that matters.
    w_pad = jnp.concatenate([w, jnp.zeros((1,), dtype=w.dtype)])
    w_tbl = w_pad[op.eid_tbl]  # (n, dmax)
    Vn = V[op.nbr_tbl]  # (n, dmax, q) gather
    Vd = V[:, None, :] - Vn  # (n, dmax, q) neighbor differences
    return jnp.einsum("nd,ndq->nq", w_tbl, Vd)


def lap_apply(op: GraphOperator, w: jax.Array, V: jax.Array, L_dense: Optional[jax.Array] = None) -> jax.Array:
    """Compute L(w) @ V for V of shape (n, q).

    On the dense path, pass a pre-materialized ``L_dense`` to amortize the
    build across eigensolver iterations.
    """
    if op.mode == "dense":
        if L_dense is None:
            L_dense = lap_dense(op, w)
        return jnp.dot(L_dense, V, preferred_element_type=V.dtype)
    return _ell_apply(op, w, V)


def lap_apply_reduced(op: GraphOperator, w: jax.Array, V: jax.Array,
                      L_dense: Optional[jax.Array] = None) -> jax.Array:
    """Apply the node-0-pinned (reduced) Laplacian on full-length vectors:
    row 0 of the output and of V are forced to zero, which makes CG on
    full-length vectors equivalent to solving the (n-1)-dim reduced system.
    """
    V0 = V.at[0, :].set(0.0)
    out = lap_apply(op, w, V0, L_dense)
    return out.at[0, :].set(0.0)
