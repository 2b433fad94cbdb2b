"""Multi-chip sharded Laplacian products and solver steps.

Sharding design (SURVEY.md §5 'distributed communication backend'):

  * The ELL adjacency tables are sharded by node-row blocks over the
    'graph' mesh axis; the eigenvector block V (n, q) stays replicated
    (it is tiny relative to the tables for large n). Each device computes
    the output rows of L(w) @ V for its block — pure local gathers — and
    an `all_gather` across devices re-replicates the result. No scatter, no
    psum on the hot path.
  * Weight vectors are replicated (m is modest); the per-candidate
    gradient is computed replicated.
  * Budget sweeps / rounding trials shard over the 'sweep' axis as plain
    data parallelism (see mac_tpu.parallel.mesh).

This module provides a drop-in `apply_L` for the eigensolver
(mac_tpu.ops.lobpcg) so the full Frank-Wolfe solve jits across a
`jax.sharding.Mesh` unchanged.
"""

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mac_tpu.ops.laplacian import GraphOperator
from mac_tpu.parallel.mesh import pad_to_multiple


class ShardedLaplacian:
    """Node-row-sharded ELL apply over the 'graph' axis of a mesh.

    Built host-side from a GraphOperator; usable inside jit under the mesh.
    """

    def __init__(self, op: GraphOperator, mesh: Mesh):
        assert op.mode == "ell", "sharded apply uses the ELL (gather) path"
        self.mesh = mesh
        self.n = op.n
        g = mesh.shape["graph"]
        nbr = np.asarray(op.nbr_tbl)
        eid = np.asarray(op.eid_tbl)
        # Pad rows so each device gets an equal block; padded rows point at
        # the sentinel edge (weight 0) and node 0, producing zero rows.
        nbr_p, _ = pad_to_multiple(nbr, g, axis=0, fill=0)
        eid_p, _ = pad_to_multiple(eid, g, axis=0, fill=op.m)
        self.n_pad = nbr_p.shape[0]
        graph_sharded = NamedSharding(mesh, P("graph", None))
        self.nbr_tbl = jax.device_put(jnp.asarray(nbr_p), graph_sharded)
        self.eid_tbl = jax.device_put(jnp.asarray(eid_p), graph_sharded)
        self.blk = self.n_pad // g

        def _local(w, V, nbr_blk, eid_blk):
            # w, V replicated; tables are the local row block. The output is
            # left row-sharded over 'graph' — GSPMD inserts the all-gather
            # exactly where a consumer needs replication (e.g. the next
            # gather of V), instead of forcing one here.
            w_pad = jnp.concatenate([w, jnp.zeros((1,), dtype=w.dtype)])
            w_tbl = w_pad[eid_blk]  # (blk, dmax)
            Vn = V[nbr_blk]  # (blk, dmax, q): gather from replicated V
            r = jax.lax.axis_index("graph")
            V_blk = jax.lax.dynamic_slice_in_dim(V, r * self.blk, self.blk, axis=0)
            # Difference form for float32 stability (see laplacian._ell_apply).
            Vd = V_blk[:, None, :] - Vn
            return jnp.einsum("nd,ndq->nq", w_tbl, Vd)

        self._shard_apply = jax.shard_map(
            _local,
            mesh=mesh,
            in_specs=(P(), P(), P("graph", None), P("graph", None)),
            out_specs=P("graph", None),
        )

    def apply(self, w: jax.Array, V: jax.Array) -> jax.Array:
        """L(w) @ V with V of shape (n, q); returns (n, q), replicated."""
        n, q = V.shape
        if self.n_pad != n:
            V = jnp.concatenate(
                [V, jnp.zeros((self.n_pad - n, q), dtype=V.dtype)], axis=0
            )
        out = self._shard_apply(w, V, self.nbr_tbl, self.eid_tbl)
        return out[: self.n]


class EdgeShardedLaplacian:
    """Edge-sharded L(w) products combined with `psum` across devices — the
    SURVEY §5 'distributed communication backend' design (the row-sharded
    ShardedLaplacian above all-gathers its output instead).

    Edges are dealt round-robin to the 'graph' axis; each device applies
    its OWN edge subset's Laplacian (a partial (n, q) product via its local
    ELL tables, difference form) and the full product is one
    `lax.psum("graph")`. The weight vector and V stay replicated. Scales
    the edge dimension: per-device gather work is m/g edges; the collective
    moves (n, q) floats between devices.
    """

    def __init__(self, op: GraphOperator, mesh: Mesh):
        assert op.mode == "ell", "edge-sharded apply needs ELL mode"
        self.mesh = mesh
        self.n = op.n
        g = mesh.shape["graph"]
        idx = np.asarray(op.idx)
        m = idx.shape[0]
        owner = np.arange(m) % g  # round-robin for load balance
        # Per-shard ELL tables over the full node set, padded to the max
        # shard degree; eid points into the GLOBAL weight vector.
        dmax = 1
        per_shard = []
        for s in range(g):
            eids = np.flatnonzero(owner == s)
            counts = np.zeros(op.n, dtype=np.int64)
            np.add.at(counts, idx[eids, 0], 1)
            np.add.at(counts, idx[eids, 1], 1)
            dmax = max(dmax, int(counts.max(initial=0)))
            per_shard.append(eids)
        nbr = np.zeros((g, op.n, dmax), dtype=np.int32)
        eid = np.full((g, op.n, dmax), m, dtype=np.int32)
        for s, eids in enumerate(per_shard):
            cursor = np.zeros(op.n, dtype=np.int64)
            for t in eids:
                i, j = int(idx[t, 0]), int(idx[t, 1])
                nbr[s, i, cursor[i]] = j
                eid[s, i, cursor[i]] = t
                cursor[i] += 1
                nbr[s, j, cursor[j]] = i
                eid[s, j, cursor[j]] = t
                cursor[j] += 1
        shard = NamedSharding(mesh, P("graph", None, None))
        self.nbr_tbl = jax.device_put(jnp.asarray(nbr), shard)
        self.eid_tbl = jax.device_put(jnp.asarray(eid), shard)

        def _local(w, V, nbr_s, eid_s):
            # nbr_s/eid_s: (1, n, dmax) local shard; w, V replicated.
            w_pad = jnp.concatenate([w, jnp.zeros((1,), dtype=w.dtype)])
            w_tbl = w_pad[eid_s[0]]           # (n, dmax)
            Vn = V[nbr_s[0]]                  # (n, dmax, q)
            part = jnp.einsum("nd,ndq->nq", w_tbl, V[:, None, :] - Vn)
            return jax.lax.psum(part, "graph")

        self._shard_apply = jax.shard_map(
            _local,
            mesh=mesh,
            in_specs=(P(), P(), P("graph", None, None), P("graph", None, None)),
            out_specs=P(),
        )

    def apply(self, w: jax.Array, V: jax.Array) -> jax.Array:
        """L(w) @ V, psum-combined; V (n, q) replicated -> (n, q) replicated."""
        return self._shard_apply(w, V, self.nbr_tbl, self.eid_tbl)


def sharded_candidate_gradient(mesh: Mesh, cand_idx, w_cand, v):
    """Per-candidate supergradient grad_e = w_e (v_i - v_j)^2 computed
    shard-locally from the replicated Fiedler vector (SURVEY §5): the
    candidate edge arrays are sharded over 'graph', each device gathers
    only its slice of v-differences, and the (m,) gradient is re-replicated
    by the all-gather GSPMD inserts at the output.
    """
    m = cand_idx.shape[0]
    g = mesh.shape["graph"]
    m_pad = -(-m // g) * g
    idx_p, _ = pad_to_multiple(np.asarray(cand_idx), g, axis=0, fill=0)
    w_p = jnp.concatenate(
        [jnp.asarray(w_cand), jnp.zeros((m_pad - m,), dtype=w_cand.dtype)])
    shard = NamedSharding(mesh, P("graph"))
    idx_d = jax.device_put(jnp.asarray(idx_p), NamedSharding(mesh, P("graph", None)))
    w_d = jax.device_put(w_p, shard)

    def _local(idx_s, w_s, v):
        d = v[idx_s[:, 0]] - v[idx_s[:, 1]]
        return w_s * d * d

    grad = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P("graph", None), P("graph"), P()),
        out_specs=P("graph"),
    )(idx_d, w_d, v)
    return grad[:m]


def sharded_top_k_indicator(mesh: Mesh, scores: jax.Array, k: int) -> jax.Array:
    """0/1 indicator of the k largest scores, computed distributed: each
    'graph' shard takes its local top-k, the g*k survivors are gathered,
    and the global top-k is selected among them (the standard two-stage
    distributed top-k; exact because the global top-k is contained in the
    union of local top-ks). Output is the (m,) replicated indicator —
    the LP oracle of SURVEY §5's sharded design."""
    m = scores.shape[0]
    g = mesh.shape["graph"]
    m_pad = -(-m // g) * g
    pad_val = jnp.asarray(-jnp.inf, scores.dtype)
    s_p = jnp.concatenate(
        [scores, jnp.full((m_pad - m,), pad_val, dtype=scores.dtype)])
    s_d = jax.device_put(s_p, NamedSharding(mesh, P("graph")))
    kk = min(k, m_pad // g)

    def _local(s_s):
        # Local top-k with global ids, then gather all survivors.
        base = jax.lax.axis_index("graph") * s_s.shape[0]
        vals, loc = jax.lax.top_k(s_s, kk)
        ids = loc + base
        vals_all = jax.lax.all_gather(vals, "graph").reshape(-1)
        ids_all = jax.lax.all_gather(ids, "graph").reshape(-1)
        topv, sel = jax.lax.top_k(vals_all, k)
        chosen = ids_all[sel]
        out = jnp.zeros((m_pad,), scores.dtype).at[chosen].set(1.0)
        return out

    # The output is replicated by construction (every device ranks the same
    # all-gathered survivor set), which the static replication checker
    # cannot infer through the gather -> disable it for this map.
    ind = jax.shard_map(
        _local, mesh=mesh, in_specs=(P("graph"),), out_specs=P(),
        check_vma=False,
    )(s_d)
    return ind[:m]
