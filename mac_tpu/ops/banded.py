"""Block-banded matmul formulation of the graph Laplacian (RCM-ordered).

Motivation: the ELL apply (mac_tpu.ops.laplacian) is a gather of an
(n, dmax, q) intermediate. Pose graphs are spatially local, so a
reverse-Cuthill-McKee relabeling gives a small matrix bandwidth
(city10000: 182). Within 128-aligned node blocks the Laplacian is then
**block-banded with a handful of 128x128 dense block diagonals** — which
turns L(w) @ V into a few batched matmuls with zero gathers in the hot
loop, at a cost independent of q.

Float32 stability: a plain dense matmul of a Laplacian catastrophically
cancels on smooth eigenvectors (rows sum to zero; see
mac_tpu.ops.laplacian._ell_apply). Here each block-row output is computed
against **locally centered** inputs,

    out_b = sum_o  BD[o, b] @ (V_{b+o-half} - c_b),

with c_b the mean of V over block b's block-diagonal neighborhood. This is
exact in exact arithmetic for any c_b (every entry of a band row lies
inside the window, and Laplacian rows sum to zero), and in float32 it
scales the rounding to the *local variation* |V - c_b| — the same
backward-stability the ELL difference form achieves (verified ~6e-7
against an f64 oracle, identical to ELL f32).

Assembly avoids device scatters and large gathers (BD has 26M slots on
city10000): the band data accumulates into a pre-SHEARED layout with a
handful of iota-compare broadcasts, every block diagonal is then a
contiguous column slice, lower diagonals follow by symmetry, and the
degree diagonal is one reduction (see assemble_bd).

The companion preconditioner is a symmetric two-level cycle: exact
odometry-chain tridiagonal smoothing applied through the RCM permutation
(the measured-essential strong smoother; a block-Jacobi variant exists as
an option) plus a dense coarse-grid correction over original-order
(trajectory-contiguous) aggregates, the coarse operator assembled
scatter-free as R^T (L R) via one banded apply (see make_banded_precond).

Reference role: this replaces the sparse-direct inner solves of the
reference's TRACEMIN (mac/utils/cholesky.py:220-238, SuperLU at
mac/utils/fiedler.py:42) with a matmul-shaped operator + preconditioner pair.
"""

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class BDRep(NamedTuple):
    """Assembled weight-dependent operator data (see assemble_bd): the
    upper block diagonals (stored TRANSPOSED — see ut) and the degree
    vector — the lower diagonals are implied by symmetry and consumed via
    transposed contractions."""

    ut: jax.Array   # (half+1, nb, BS, BS): ut[t][b] = L[block b, block
                    # b+t]^T, i.e. ut[t][b][c, r] = L[b*BS+r, (b+t)*BS+c]
                    # (t=0 holds the strict upper triangle, transposed).
                    # The transposed orientation keeps n_pad on the minor
                    # axis of the (du, n_pad) weight gather; the apply
                    # consumes either orientation by swapping einsum
                    # subscripts.
    deg: jax.Array  # (nb, BS) weighted degrees (the diagonal of L)

BS = 128  # node-block size (matmul tile)

# Enable the banded path only when the RCM bandwidth keeps the block-band
# narrow: ndiag = 2*ceil-ish(bw/128)+1 block diagonals cost
# ndiag * n_pad * 128 * 4 bytes each for BD and the slot table.
MAX_BANDWIDTH = 640
# Target coarse-grid size for the two-level preconditioner (matches the
# round-1 two-grid default; see mac_tpu.ops.twogrid).
COARSE_NC = 512
# Segment length of the chain smoother's blocked LDL^T refactorization
# (cost is CHAIN_LDL_BLOCK sequential f64 scan steps per weight update;
# couplings dropped at segment boundaries are coarse-grid-scale structure).
CHAIN_LDL_BLOCK = 128
# Two-level cycle form: "mult" (symmetric V-cycle: smooth, coarse-correct
# on the residual, smooth) or "additive" (M^-1 = S + P Lc^-1 R — see
# make_banded_precond.precond_additive: ~2x cheaper per application at
# eigensolver block sizes, slightly weaker per iteration).
PRECOND_KIND = "mult"


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedOperator:
    """Static (per-topology) tables for block-banded L(w) products.

    ueid_tbl: (du, n_pad) int32 — upper-neighbor edge ids per node (edge
        (i, j > i) listed at column i), sentinel m (weight 0) in padding.
        Stored TRANSPOSED (nodes on the minor axis), so the per-FW-step
        weight gather w_pad[ueid_tbl] is du contiguous rows of n_pad.
    dcol_tbl: (du, n_pad) int32 — the SHEARED column each slot's -w lands
        in: BS + (j - i) + (i mod BS) (0 for padding slots — never read).
        assemble_bd materializes the sheared band rows by du iota-compare
        accumulations, so the only gather is the small (du, n_pad) weight
        lookup.
    agg: (n_pad,) int32 — coarse-aggregate id of each RCM row (nc for
        padding rows); the 0/1 restriction indicator is built on the fly
        inside the coarse assembly Lc = R^T (L R).
    perm / iperm: (n,) int32 RCM permutation: perm[k] = original id of
        RCM node k; iperm[orig] = RCM id. Identity when the caller built
        from already-relabeled indices.
    chain_eid: (n-1,) int32 — edge id connecting original-order nodes
        (k, k+1), sentinel m if absent. Lets the preconditioner smooth
        with the exact odometry-chain tridiagonal solve in the original
        ordering (the strong smoother; RCM's own band-1 is weak because
        the chain scatters across RCM offsets).
    n, nb, ndiag, coarse_s, coarse_nc: static metadata.
    """

    ueid_tbl: jax.Array
    dcol_tbl: jax.Array
    agg: jax.Array
    perm: jax.Array
    iperm: jax.Array
    chain_eid: jax.Array
    n: int = dataclasses.field(metadata=dict(static=True))
    nb: int = dataclasses.field(metadata=dict(static=True))
    ndiag: int = dataclasses.field(metadata=dict(static=True))
    coarse_s: int = dataclasses.field(metadata=dict(static=True))
    coarse_nc: int = dataclasses.field(metadata=dict(static=True))

    @property
    def half(self) -> int:
        return self.ndiag // 2

    @property
    def n_pad(self) -> int:
        return self.nb * BS


def rcm_order(idx: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Reverse-Cuthill-McKee node permutation for an edge list.

    Returns (perm, inv, bandwidth): perm[k] = original id of new node k,
    inv[orig] = new id, bandwidth = max |i' - j'| over relabeled edges.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    idx = np.asarray(idx).reshape(-1, 2)
    m = idx.shape[0]
    A = sp.coo_matrix(
        (np.ones(m), (idx[:, 0], idx[:, 1])), shape=(n, n)
    )
    perm = np.asarray(reverse_cuthill_mckee(sp.csr_matrix(A + A.T),
                                            symmetric_mode=True))
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    r = inv[idx]
    bw = int(np.abs(r[:, 0] - r[:, 1]).max(initial=0))
    return perm, inv, bw


def build_banded_rcm(idx: np.ndarray, num_nodes: int, dtype=jnp.float32,
                     target_nc: int = COARSE_NC):
    """RCM-relabel an edge list and build the banded tables.

    Returns (bop, relabeled_idx) or (None, None) when the graph admits no
    narrow band. The permutation and the original-order chain table are
    recorded on the operator so the preconditioner can smooth in the
    original (odometry-chain) ordering.
    """
    idx = np.asarray(idx, dtype=np.int64).reshape(-1, 2)
    n = int(num_nodes)
    if idx.shape[0] == 0 or n < 4 * BS:
        return None, None
    perm, inv, bw = rcm_order(idx, n)
    if bw == 0 or bw > MAX_BANDWIDTH:
        return None, None
    ridx = inv[idx]
    bop = build_banded(ridx, n, dtype=dtype, target_nc=target_nc,
                       perm=perm, iperm=inv, orig_idx=idx)
    return bop, (None if bop is None else ridx.astype(np.int32))


def build_banded(idx: np.ndarray, num_nodes: int, dtype=jnp.float32,
                 target_nc: int = COARSE_NC, perm=None, iperm=None,
                 orig_idx=None) -> Optional[BandedOperator]:
    """Build the block-banded tables for an (already relabeled) edge list.

    Host-side. Returns None when the formulation does not apply: bandwidth
    above MAX_BANDWIDTH (no narrow band exists — e.g. expander-like random
    loop closures). Duplicate (i, j) edges are fine (they occupy separate
    accumulation slots and sum).

    perm/iperm/orig_idx: see build_banded_rcm — identity when omitted.
    """
    idx = np.asarray(idx, dtype=np.int64).reshape(-1, 2)
    n = int(num_nodes)
    m = idx.shape[0]
    if m == 0 or n < 4 * BS:
        return None
    lo = idx.min(axis=1)
    hi = idx.max(axis=1)
    bw = int((hi - lo).max(initial=0))
    if bw == 0 or bw > MAX_BANDWIDTH:
        return None
    # Max block-diagonal offset: (i % BS + bw) // BS <= (BS - 1 + bw) // BS.
    half = (BS - 1 + bw) // BS
    ndiag = 2 * half + 1
    nb = -(-n // BS)
    n_pad = nb * BS

    # Upper-neighbor tables in the SHEARED band layout (see assemble_bd):
    # edge (i, j) contributes -w at sheared column BS + (j - i) + (i % BS).
    counts = np.zeros(n_pad, dtype=np.int64)
    np.add.at(counts, lo, 1)
    du = max(int(counts.max(initial=0)), 1)
    ueid = np.full((n_pad, du), m, dtype=np.int32)
    dcol = np.zeros((n_pad, du), dtype=np.int32)
    # Vectorized slot assignment (the per-edge Python loop dominated the
    # constructor at n >= 3e5): stable sort by row, then each edge's slot
    # is its rank within its row = position minus the row's first
    # position in the sorted order.
    order = np.argsort(lo, kind="stable")
    lo_s = lo[order]
    slot = np.arange(m) - np.searchsorted(lo_s, lo_s, side="left")
    ueid[lo_s, slot] = order.astype(np.int32)
    dcol[lo_s, slot] = (BS + (hi[order] - lo_s) + (lo_s % BS)).astype(
        np.int32)

    if perm is None:
        perm = np.arange(n, dtype=np.int64)
        iperm = perm
    if orig_idx is None:
        orig_idx = idx

    # Coarse aggregates: s consecutive ORIGINAL-order nodes per aggregate
    # (trajectory-contiguous — measured 9 vs 16 outer iterations against
    # RCM-contiguous aggregates on city10000; the original ordering is the
    # physically meaningful locality). R rows live in RCM order so the
    # coarse operator assembles as one banded apply: Lc = R^T (L R).
    # Sized by the REAL node count n: aggregates made purely of padding
    # would be zero rows of Lc, which the rank-one constant shift turns
    # into identical rows — a singular coarse matrix.
    s = max(1, -(-n // target_nc))
    nc = -(-n // s)
    # Aggregate id per RCM row (padding rows get the out-of-range id nc,
    # so the on-the-fly indicator has zero rows there). The dense (n, nc)
    # 0/1 restriction matrix is materialized only transiently inside the
    # coarse assembly — storing it was 614 MB at n = 3e5.
    agg = np.concatenate([np.asarray(perm) // s,
                          np.full(n_pad - n, nc, dtype=np.int64)])
    orig_idx = np.asarray(orig_idx, dtype=np.int64).reshape(-1, 2)
    olo = orig_idx.min(axis=1)
    ohi = orig_idx.max(axis=1)
    chain_eid = np.full(max(n - 1, 1), m, dtype=np.int32)
    is_chain = (ohi - olo) == 1
    chain_eid[olo[is_chain]] = np.arange(m, dtype=np.int32)[is_chain]

    return BandedOperator(
        ueid_tbl=jnp.asarray(np.ascontiguousarray(ueid.T)),
        dcol_tbl=jnp.asarray(np.ascontiguousarray(dcol.T)),
        agg=jnp.asarray(agg, dtype=jnp.int32),
        perm=jnp.asarray(perm, dtype=jnp.int32),
        iperm=jnp.asarray(iperm, dtype=jnp.int32),
        chain_eid=jnp.asarray(chain_eid),
        n=n,
        nb=nb,
        ndiag=ndiag,
        coarse_s=s,
        coarse_nc=nc,
    )


def assemble_bd(bop: BandedOperator, w: jax.Array) -> jax.Array:
    """Assemble BD(w): the UPPER block diagonals of L(w) + the degree
    vector — a BDRep(up (half+1, nb, BS, BS), deg (nb, BS)).

    Scatter- and gather-light: the SHEARED band matrix

        Sh[i, BS + d + (i mod BS)] = -w of edge (i, i+d)

    is accumulated with du iota-compare broadcasts (du = max upper degree,
    ~10 on pose graphs; the shear offset i mod BS is folded into the static
    column targets). Every upper block diagonal is then a contiguous
    column slice,

        up[t][b, r, c] = Sh[b*BS + r, BS*(t+1) + c]  = L[i, (b+t)*BS + c],

    and the degrees = -(row + column sums of the uppers). The LOWER
    diagonals are never materialized — banded_apply consumes them via
    transposed einsum contractions (symmetry), which cuts both assembly
    work and ~40% of the apply's memory traffic. Device time is read from
    profiler traces under the "assemble_bd" scope."""
    with jax.named_scope("assemble_bd"):
        w_pad = jnp.concatenate([-w, jnp.zeros((1,), w.dtype)])
        ut = _assemble_ut_xla(bop, w_pad[bop.ueid_tbl])
        return BDRep(ut=ut, deg=_deg_from_ut(ut))


def _assemble_ut_xla(bop: BandedOperator, wu: jax.Array) -> jax.Array:
    """XLA sheared accumulation (see assemble_bd docstring), transposed
    orientation throughout: materialize Sh^T (W, n_pad) with du
    iota-compare passes — wu/dcol rows broadcast along the major axis with
    no relayout — then slice/stack the transposed upper block diagonals."""
    dtype = wu.dtype
    n_pad, half, nb = bop.n_pad, bop.half, bop.nb
    W = BS * (half + 2)
    rows = jax.lax.broadcasted_iota(jnp.int32, (W, n_pad), 0)
    ShT = jnp.zeros((W, n_pad), dtype)
    for kslot in range(wu.shape[0]):
        ShT = ShT + wu[kslot:kslot + 1, :] * (
            rows == bop.dcol_tbl[kslot:kslot + 1, :])
    # ut[t][b][c, r] = ShT[BS*(t+1) + c, b*BS + r]
    return jnp.stack(
        [ShT[BS * (t + 1): BS * (t + 2), :]
         .reshape(BS, nb, BS).swapaxes(0, 1)
         for t in range(half + 1)], axis=0)


def _deg_from_ut(ut: jax.Array) -> jax.Array:
    """deg_i = -(row sums + column sums over the uppers); the column-sum
    contribution of block t lands t blocks BELOW (lower-diagonal
    symmetry). ut[t][b][c, r] = up[t][b][r, c], so the ROW sum over the
    upper block is axis 2 of ut and the COLUMN sum is axis 3."""
    dtype = ut.dtype
    half = ut.shape[0] - 1
    nb = ut.shape[1]
    rowsum = jnp.sum(ut, axis=2)          # (half+1, nb, BS)
    colsum = jnp.sum(ut, axis=3)          # (half+1, nb, BS)
    deg = -rowsum[0] - colsum[0]
    for t in range(1, half + 1):
        deg = deg - rowsum[t]
        deg = deg - jnp.concatenate(
            [jnp.zeros((t, BS), dtype), colsum[t][: nb - t]], axis=0)
    return deg


def banded_apply(bop: BandedOperator, BD: "BDRep", V: jax.Array,
                 precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """L(w) @ V for V of shape (n, q) (returns (n, q)).

    precision=HIGHEST reproduces exact f32 semantics; pass DEFAULT (the
    backend's fast matmul mode — TF32 on tensor-core GPUs) for
    preconditioner-internal residuals where ~1e-3 operator error is
    harmless. Lower block diagonals are applied as transposed contractions
    of the stored uppers.
    """
    n, q = V.shape
    nb, half, ndiag = bop.nb, bop.half, bop.ndiag
    n_pad = bop.n_pad
    ut, deg = BD.ut, BD.deg
    if n_pad != n:
        V = jnp.concatenate(
            [V, jnp.zeros((n_pad - n, q), V.dtype)], axis=0)
    Vb = V.reshape(nb, BS, q)
    Vp = jnp.pad(Vb, ((half, half), (0, 0), (0, 0)))
    # Local centering constant per block row (exactness holds for any c_b —
    # Laplacian rows sum to zero within the window; see module docstring).
    if ndiag * nb * BS * q > 64 * 1024 * 1024:
        # Huge block windows (the nc-column coarse assembly at large n —
        # 6.8 GB transient at n = 3e5): sliding-window mean via a cumsum
        # difference instead of materializing the (ndiag, nb, BS, q)
        # stack. Gated by SIZE, not width, so every small/medium shape
        # keeps the legacy stacked mean bit-for-bit (cb's f32 rounding
        # profile is part of the measured solve-quality operating point).
        S = jnp.sum(Vp, axis=1)  # (nb + 2*half, q) per-block column sums
        C = jnp.concatenate(
            [jnp.zeros((1, q), S.dtype), jnp.cumsum(S, axis=0)], axis=0)
        cb = ((C[ndiag:] - C[:-ndiag]) / (ndiag * BS))[:, None, :]
    else:
        win = jnp.stack([Vp[o:o + nb] for o in range(ndiag)], 0)
        cb = jnp.mean(win, axis=(0, 2))[:, None, :]
    # Diagonal degrees + strict-upper of the diagonal block (direct and
    # transposed) + off block diagonals (direct at +t, transposed shifted
    # down t blocks at -t). ut holds the TRANSPOSED uppers, so the direct
    # contraction reads "bcr,..." and the transposed one "brc,...".
    Vc0 = Vp[half: half + nb] - cb
    out = deg[:, :, None] * Vc0
    out = out + jnp.einsum("bcr,bcq->brq", ut[0], Vc0,
                           preferred_element_type=V.dtype, precision=precision)
    out = out + jnp.einsum("brc,bcq->brq", ut[0], Vc0,
                           preferred_element_type=V.dtype, precision=precision)
    for t in range(1, half + 1):
        out = out + jnp.einsum(
            "bcr,bcq->brq", ut[t], Vp[half + t: half + t + nb] - cb,
            preferred_element_type=V.dtype, precision=precision)
        utsh = jnp.concatenate(
            [jnp.zeros((t, BS, BS), ut.dtype), ut[t][: nb - t]], axis=0)
        out = out + jnp.einsum(
            "brc,bcq->brq", utsh, Vp[half - t: half - t + nb] - cb,
            preferred_element_type=V.dtype, precision=precision)
    return out.reshape(n_pad, q)[:n]


class PrecondState(NamedTuple):
    """Carryable preconditioner state for warm rebuilds across Frank-Wolfe
    steps: the explicit coarse inverse plus the chain smoother's LDL^T
    factor. A fresh (cold) build computes the inverse by Cholesky (a
    latency-bound small-matrix factorization); warm rebuilds refine the
    PREVIOUS step's inverse with a few Newton-Schulz iterations
    X <- X(2I - Lc X) — pure matmuls — which converge quadratically
    because consecutive FW iterates change the coarse operator by at most
    the step size gamma. The chain factor (dp, l of
    mac_tpu.ops.tridiag.TridiagFactor) is carried for the same reason: a
    rebuild=False step reuses it outright, so the whole preconditioner
    build is skipped.
    chain_dp/chain_l are None on the block-Jacobi smoother path."""

    Lc_inv: jax.Array  # (nc, nc)
    chain_dp: Optional[jax.Array] = None  # (n,) LDL pivots, original order
    chain_l: Optional[jax.Array] = None   # (n,) unit-L subdiagonal


NS_COARSE_STEPS = 3  # Newton-Schulz refinement steps per warm rebuild


def make_banded_precond(bop: BandedOperator, BD: "BDRep", w=None,
                        smoother: str = "chain", prev_state=None,
                        use_prev=None, return_state: bool = False,
                        kind: Optional[str] = None, rebuild=None):
    """Two-level symmetric preconditioner for L(w) restricted to 1^perp.

    kind: 'mult' (multiplicative V-cycle, the measured default) or
    'additive' (M^-1 = S + P Lc^-1 R — ~2x cheaper per application, two
    permutation gathers instead of six, but measured too weak in MAC's
    loop: 145 vs 92 outer iterations on city10000); None defers to the
    module default PRECOND_KIND.

    prev_state / use_prev / return_state: warm-rebuild protocol. When
    `prev_state` (a PrecondState) is given, the coarse inverse is chosen by
    the traced boolean `use_prev`: False -> cold Cholesky build, True ->
    Newton-Schulz refinement of prev_state.Lc_inv (see PrecondState). With
    `return_state=True` the call returns (precond_fn, PrecondState).

    rebuild: optional traced boolean (requires prev_state). False skips
    the preconditioner build ENTIRELY for this step — no Lc = R^T(L R)
    assembly, no Newton-Schulz, and (when prev_state carries chain_dp)
    no chain LDL^T refactorization — reusing prev_state as-is. The whole
    preconditioner then lags the operator by the Frank-Wolfe step size —
    a preconditioner-grade perturbation on late warm steps. None
    (default) = always rebuild (the pre-round-3 behavior).

    Smoothers:
      * 'chain' (default; requires `w`): exact tridiagonal solve of the
        odometry-chain part **in the original node ordering** — the chain
        scatters across RCM offsets, so this is implemented as
        permute -> tridiagonal solve -> permute back. This is the
        round-1-proven strong smoother (global information propagates the
        whole chain in one solve); block-Jacobi alone was measured to leave
        the eigensolver unconverged at maxiter on city10000.
      * 'bjacobi': exact solves of the 128x128 RCM diagonal blocks
        (batched matmuls, no permutes) — cheaper per application,
        weaker: all inter-block coupling is left to the coarse grid.

    Coarse level: dense (nc, nc) inverse over ORIGINAL-order (trajectory-
    contiguous) aggregates — measured 9 vs 16 outer iterations against
    RCM-contiguous aggregates — assembled scatter-free as R^T (L R), with
    restriction/prolongation routed through the permutation.

    Rebuild per weight vector; returns a pure (n, q) -> (n, q) function.
    """
    assert rebuild is None or prev_state is not None, (
        "rebuild cadence requires a carried PrecondState (prev_state); "
        "without it every step silently cold-builds")
    dtype = BD.ut.dtype
    nb, half, s, nc = bop.nb, bop.half, bop.coarse_s, bop.coarse_nc
    n, n_pad = bop.n, bop.n_pad
    eps = jnp.finfo(dtype).eps

    if smoother == "chain":
        assert w is not None, "'chain' smoother needs the weight vector"
        from mac_tpu.ops.tridiag import (TridiagFactor, tridiag_ldl_auto,
                                         tridiag_solve_factored)

        def _chain_factor_arrays(_):
            # Tridiagonal part of L(w) in ORIGINAL ordering: diagonal =
            # weighted degrees (gathered through the permutation),
            # off-diagonal = chain edge weights (gather via the static
            # chain_eid table, no scatter).
            deg_rcm = BD.deg.reshape(n_pad)[:n]
            d_nat = deg_rcm[bop.iperm]
            w_pad = jnp.concatenate([w, jnp.zeros((1,), w.dtype)])
            e_nat = -w_pad[bop.chain_eid][: max(n - 1, 1)].astype(dtype)
            dd = d_nat + 100 * eps * jnp.max(d_nat)
            if n > 4096:
                # Segment factorization: far cheaper to (re)build per
                # weight update (the rolled f64 scan runs CHAIN_LDL_BLOCK
                # sequential steps) at the cost of dropping one chain coupling
                # every `block` nodes — structure above the coarse
                # aggregate size (~20 nodes) that the coarse level owns
                # anyway.
                from mac_tpu.ops.tridiag import tridiag_ldl_blocked

                f = tridiag_ldl_blocked(dd, e_nat, block=CHAIN_LDL_BLOCK)
            else:
                f = tridiag_ldl_auto(dd, e_nat)
            return f.dp, f.l

        # Segment length is static aux data and must be identical across
        # the rebuild/reuse cond branches below (n <= 4096 routes through
        # tridiag_ldl_auto -> exact tridiag_ldl, seg=None).
        chain_seg = CHAIN_LDL_BLOCK if n > 4096 else None

        can_reuse_chain = (prev_state is not None and rebuild is not None
                          and prev_state.chain_dp is not None)
        if can_reuse_chain:
            # The chain refactorization rides the same `rebuild` gate as
            # the coarse level: a skipped step reuses the carried factor
            # (stale by one gamma-sized weight perturbation — the factor
            # is a smoother inside a preconditioner, exactness is not
            # load-bearing).
            chain_dp, chain_l = jax.lax.cond(
                rebuild, _chain_factor_arrays,
                lambda _: (prev_state.chain_dp, prev_state.chain_l), None)
        else:
            chain_dp, chain_l = _chain_factor_arrays(None)
        fac = TridiagFactor(dp=chain_dp, l=chain_l, seg=chain_seg)

        def smooth(B):  # B in RCM order, (n, q)
            Xn = tridiag_solve_factored(fac, B[bop.iperm])
            return Xn[bop.perm]
    else:
        # --- block-Jacobi: batched Cholesky inverses of the diagonal blocks.
        eyeD = jnp.eye(BS, dtype=dtype)
        Dblk = (BD.ut[0] + jnp.swapaxes(BD.ut[0], 1, 2)
                + BD.deg[:, :, None] * eyeD[None])
        reg = 100 * eps * jnp.max(jnp.abs(Dblk))
        Dreg = Dblk + reg * jnp.eye(BS, dtype=dtype)[None]
        Rchol = jax.vmap(lambda A: jnp.linalg.cholesky(A, upper=True))(Dreg)
        eyeB = jnp.broadcast_to(jnp.eye(BS, dtype=dtype), (nb, BS, BS))
        Rinv = jax.vmap(
            lambda Rm, I: jax.scipy.linalg.solve_triangular(Rm, I, lower=False)
        )(Rchol, eyeB)
        Dinv = jnp.einsum("bij,bkj->bik", Rinv, Rinv,
                          preferred_element_type=dtype)  # (nb, BS, BS)

    def _assemble_Lc_reg():
        # --- coarse operator Lc = R^T (L R): one banded apply on nc
        # columns. DEFAULT precision: Lc is preconditioner-internal; ~1e-3
        # relative error on the coarse operator is invisible to convergence
        # and the fast matmul mode is cheaper on the nc-column apply.
        Rmat = (bop.agg[:n, None]
                == jnp.arange(nc, dtype=jnp.int32)[None, :]).astype(dtype)
        LR = banded_apply(bop, BD, Rmat,
                          precision=jax.lax.Precision.DEFAULT)
        # Restrict rows through the permutation: aggregates live in the
        # original ordering (R's columns), rows of LR in RCM order.
        LRn = LR[bop.iperm]
        LRp = jnp.concatenate(
            [LRn, jnp.zeros((nc * s - n, nc), dtype)], axis=0)
        Lc = LRp.reshape(nc, s, nc).sum(axis=1)
        Lc = (Lc + Lc.T) / 2
        # Rank-one constant-mode shift makes Lc SPD (same trick as the
        # eigensolver); the inverse is a *preconditioner* component, f32 is
        # fine.
        cshift = 2.0 * jnp.max(jnp.diag(Lc)) + 1.0
        # The diagonal jitter must dominate the ASSEMBLY error, not machine
        # eps: Lc comes from a DEFAULT-precision (bf16/TF32-grade) product,
        # whose ~1e-3-relative asymmetric error can push the
        # exact-arithmetic-PSD matrix indefinite — observed as a NaN
        # Cholesky -> NaN eigensolve on sphere2500's rounded selection. 1%
        # diagonal inflation is invisible to a preconditioner.
        jit_c = 1e-2 * (jnp.trace(Lc) / nc) + 100 * eps
        return (Lc + (cshift / nc) * jnp.ones((nc, nc), dtype)
                + jit_c * jnp.eye(nc, dtype=dtype))

    def _chol_from(Lc_reg):
        Rc = jnp.linalg.cholesky(Lc_reg, upper=True)
        Rc_inv = jax.scipy.linalg.solve_triangular(
            Rc, jnp.eye(nc, dtype=dtype), lower=False)
        return Rc_inv @ Rc_inv.T

    def _refresh(Xp):
        """Assemble Lc_reg and produce this step's coarse inverse (cold
        Cholesky or Newton-Schulz refinement of Xp, by `use_prev`). The
        assembly lives INSIDE this function so a rebuild=False step skips
        it entirely (it is the dominant coarse cost: the nc-column apply)."""
        Lc_reg = _assemble_Lc_reg()

        def _chol_inverse(_):
            return _chol_from(Lc_reg)

        def _ns_refine(Xp):
            # Newton-Schulz from the previous FW step's inverse (exact-f32
            # accumulation — the iteration is itself error-correcting, so a
            # reduced-precision pass would just waste a refinement step).
            # Two safeguards make it robust to large weight swings:
            # (1) trace damping — scale Xp so the mean eigenvalue of
            # Lc_reg @ Xp is 1, pulling the spectrum toward NS's (0, 2)
            # convergence basin; (2) a residual check — if the refined
            # iterate is worse than the damped start (NS diverges
            # quadratically when an eigenvalue still falls outside the
            # basin), fall back to the damped start, which is always an
            # SPD preconditioner-grade inverse. Callers additionally gate
            # use_prev to steps where the operator change is bounded.
            HI = jax.lax.Precision.HIGHEST
            tr = jnp.sum(Lc_reg.T * Xp)  # trace(Lc_reg @ Xp)
            X0 = Xp * (nc / jnp.maximum(tr, jnp.finfo(dtype).tiny))
            eye = jnp.eye(nc, dtype=dtype)
            X = X0
            for _ in range(NS_COARSE_STEPS):
                X = jnp.matmul(X, 2.0 * eye - jnp.matmul(Lc_reg, X,
                                                         precision=HI),
                               precision=HI)

            def resid(Y):
                R = eye - jnp.matmul(Lc_reg, Y, precision=HI)
                return jnp.sum(R * R)

            ok = jnp.logical_and(jnp.all(jnp.isfinite(X)),
                                 resid(X) < resid(X0))
            refined = jnp.where(ok, X, X0)
            # (3) poisoned-carry escape: if the damped START is already
            # non-finite (a previous step NaN'd the carried inverse),
            # neither X nor X0 can recover — rebuild cold from the current
            # (finite) Lc_reg instead of propagating NaN for the rest of
            # the Frank-Wolfe run. lax.cond executes only the taken
            # branch, so the Cholesky cost is paid only when poisoned.
            return jax.lax.cond(
                jnp.all(jnp.isfinite(X0)),
                lambda _: refined, lambda _: _chol_from(Lc_reg), None)

        if use_prev is None:
            return _chol_inverse(Xp)
        return jax.lax.cond(use_prev, _ns_refine, _chol_inverse, Xp)

    if prev_state is None:
        Lc_inv = _chol_from(_assemble_Lc_reg())
    elif rebuild is None:
        Lc_inv = _refresh(prev_state.Lc_inv)
    else:
        Lc_inv = jax.lax.cond(
            rebuild, _refresh, lambda Xp: Xp, prev_state.Lc_inv)

    # Fast-matmul operator copy for preconditioner-internal residuals.
    def apply_fast(V):
        return banded_apply(bop, BD, V, precision=jax.lax.Precision.DEFAULT)

    def center(B):
        return B - jnp.mean(B, axis=0, keepdims=True)

    def pad(B):
        return jnp.concatenate(
            [B, jnp.zeros((n_pad - n, B.shape[1]), B.dtype)], axis=0)

    if smoother != "chain":
        def smooth(B):  # noqa: F811 — block-Jacobi variant
            Bb = pad(B).reshape(nb, BS, -1)
            X = jnp.einsum("brc,bcq->brq", Dinv, Bb,
                           preferred_element_type=dtype)
            return X.reshape(n_pad, -1)[:n]

    def restrict(Rv):  # (n, q) RCM -> (nc, q), original-order aggregates
        Rn = Rv[bop.iperm]
        Rp = jnp.concatenate(
            [Rn, jnp.zeros((nc * s - n, Rv.shape[1]), Rv.dtype)], axis=0)
        return Rp.reshape(nc, s, -1).sum(axis=1)

    def prolong(Xc):  # (nc, q) -> (n, q) RCM
        return jnp.repeat(Xc, s, axis=0)[:n][bop.perm]

    def precond(B: jax.Array) -> jax.Array:
        B = center(B)
        x = smooth(B)
        r = B - apply_fast(x)
        xc = jnp.dot(Lc_inv, restrict(r), preferred_element_type=dtype)
        x = x + prolong(xc)
        r2 = B - apply_fast(x)
        x = x + smooth(r2)
        return center(x)

    def precond_additive(B: jax.Array) -> jax.Array:
        # Additive two-level M^-1 = S + P Lc^-1 R: both corrections read B
        # directly (no residual operator applies), and the whole cycle runs
        # in the ORIGINAL ordering so only TWO permutation gathers remain
        # (in and out) versus six in the multiplicative V-cycle — the
        # gathers and residual applies are the latency bound at (n, q)
        # eigensolver block sizes.
        # Weaker per application than the V-cycle; the intended use is
        # latency-bound inner CG where 1-2 extra iterations cost less than
        # the removed ops.
        B = center(B)
        if smoother == "chain":
            from mac_tpu.ops.tridiag import tridiag_solve_factored

            Bn = B[bop.iperm]  # gather 1: RCM -> original order
            xn = tridiag_solve_factored(fac, Bn)
            Bp = jnp.concatenate(
                [Bn, jnp.zeros((nc * s - n, B.shape[1]), B.dtype)], axis=0)
            rc = Bp.reshape(nc, s, -1).sum(axis=1)
            xc = jnp.dot(Lc_inv, rc, preferred_element_type=dtype)
            xn = xn + jnp.repeat(xc, s, axis=0)[:n]
            return center(xn[bop.perm])  # gather 2: back to RCM
        x = smooth(B)
        xc = jnp.dot(Lc_inv, restrict(B), preferred_element_type=dtype)
        return center(x + prolong(xc))

    if kind is None:
        kind = PRECOND_KIND
    chosen = precond_additive if kind == "additive" else precond
    if return_state:
        if smoother == "chain":
            return chosen, PrecondState(Lc_inv=Lc_inv, chain_dp=fac.dp,
                                        chain_l=fac.l)
        return chosen, PrecondState(Lc_inv=Lc_inv)
    return chosen
