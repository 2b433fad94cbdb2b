"""Tests for the block-banded Laplacian formulation (mac_tpu.ops.banded).

Oracle strategy: the ELL difference-form apply (itself validated against
networkx/scipy in tests/utils) and dense eigh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mac_tpu.ops.banded import (
    BS,
    assemble_bd,
    banded_apply,
    build_banded,
    build_banded_rcm,
    make_banded_precond,
    rcm_order,
)
from mac_tpu.ops.laplacian import build_operator, lap_apply
from mac_tpu.utils.graphs import weight_graph_lap_from_edges


def _pose_graph(n=700, n_loops=260, span=40, seed=3):
    """Chain + short-range loop closures: banded after RCM."""
    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    loops = set()
    while len(loops) < n_loops:
        i = rng.randint(0, n - 2)
        j = min(n - 1, i + 2 + rng.randint(span))
        if j - i > 1:
            loops.add((i, j))
    idx = np.concatenate([chain, np.array(sorted(loops))]).astype(np.int64)
    w = 0.5 + rng.rand(len(idx))
    return idx, w, n


def test_rcm_order_is_permutation():
    idx, w, n = _pose_graph()
    perm, inv, bw = rcm_order(idx, n)
    assert sorted(perm) == list(range(n))
    assert np.array_equal(perm[inv], np.arange(n))
    assert 0 < bw <= 2 * 42


def test_build_banded_rejects_expanders():
    rng = np.random.RandomState(0)
    n = 600
    idx = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    rand = rng.randint(0, n, size=(800, 2))
    rand = rand[np.abs(rand[:, 0] - rand[:, 1]) > 1]
    idx = np.concatenate([idx, np.sort(rand, axis=1)])
    perm, inv, bw = rcm_order(idx, n)
    # Random long-range edges destroy bandedness.
    assert build_banded(inv[idx], n) is None or bw <= 640


@pytest.mark.parametrize("n,n_loops,span,seed", [
    (700, 260, 40, 3),     # base pose graph
    (560, 80, 6, 11),      # half = 1 (single upper diagonal), tiny du
    (700, 420, 70, 11),    # wider band, larger du
    (1100, 250, 120, 11),  # n not a multiple of BS, half >= 3
    (1500, 1200, 25, 3),   # heavy-tailed upper degrees (city10000-like)
])
def test_assemble_matches_dense_blocks(n, n_loops, span, seed):
    """The sheared assembly reproduces the dense Laplacian blocks across
    unroll regimes: number of upper block diagonals (half) and of
    compare-accumulate passes (du)."""
    idx, w, n = _pose_graph(n=n, n_loops=n_loops, span=span, seed=seed)
    perm, inv, bw = rcm_order(idx, n)
    ridx = inv[idx]
    bop = build_banded(ridx, n, dtype=jnp.float64)
    assert bop is not None
    rep = assemble_bd(bop, jnp.asarray(w, jnp.float64))
    # BDRep stores the uppers TRANSPOSED (ut[t][b] = up-block^T); undo it
    # here so the expectations below stay in natural L-block orientation.
    up = np.swapaxes(np.asarray(rep.ut), -1, -2)
    deg = np.asarray(rep.deg)
    L = weight_graph_lap_from_edges(ridx, w, n).toarray()
    Lp = np.zeros((bop.n_pad, bop.n_pad))
    Lp[:n, :n] = L
    half = bop.half
    for b in range(bop.nb):
        for t in range(half + 1):
            bc = b + t
            expect = np.zeros((BS, BS))
            if bc < bop.nb:
                expect = Lp[b * BS:(b + 1) * BS, bc * BS:(bc + 1) * BS].copy()
            if t == 0:
                # up[0] stores the STRICT upper triangle; degrees separate.
                np.testing.assert_allclose(
                    deg[b], np.diag(Lp[b * BS:(b + 1) * BS,
                                       b * BS:(b + 1) * BS]), atol=1e-12)
                expect = np.triu(expect, k=1)
            np.testing.assert_allclose(up[t, b], expect, atol=1e-12)


def test_banded_apply_matches_ell_f64():
    idx, w, n = _pose_graph()
    perm, inv, bw = rcm_order(idx, n)
    ridx = inv[idx].astype(np.int32)
    bop = build_banded(ridx, n, dtype=jnp.float64)
    BD = assemble_bd(bop, jnp.asarray(w, jnp.float64))
    rng = np.random.RandomState(1)
    V = jnp.asarray(rng.normal(size=(n, 4)))
    op = build_operator(ridx, n, mode="ell")
    ref = lap_apply(op, jnp.asarray(w), V)
    got = banded_apply(bop, BD, V)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-10, atol=1e-10)


def test_banded_apply_f32_stable_on_smooth_vectors():
    """The local-centering trick must keep f32 error at the difference-form
    level (~1e-6 of max|LV|), far below naive dense-matmul cancellation."""
    idx, w, n = _pose_graph(n=900, n_loops=400)
    perm, inv, bw = rcm_order(idx, n)
    ridx = inv[idx].astype(np.int32)
    bop = build_banded(ridx, n, dtype=jnp.float32)
    t = np.linspace(0, 1, n)
    V = np.stack([np.sin((k + 1) * np.pi * t) for k in range(4)], 1)
    op = build_operator(ridx, n, mode="ell")
    ref = np.asarray(lap_apply(op, jnp.asarray(w, jnp.float64),
                               jnp.asarray(V, jnp.float64)))
    BD = assemble_bd(bop, jnp.asarray(w, jnp.float32))
    got = np.asarray(banded_apply(bop, BD, jnp.asarray(V, jnp.float32)))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 5e-6, rel


def test_assemble_bd_vmaps_per_lane():
    """Budget sweeps vmap the assembly over weight vectors: each lane must
    equal its own unbatched assembly."""
    idx, w, n = _pose_graph(n=700, n_loops=120)
    perm, inv, bw = rcm_order(idx, n)
    bop = build_banded(inv[idx].astype(np.int32), n, dtype=jnp.float32)
    assert bop is not None
    rng = np.random.RandomState(5)
    ws = jnp.asarray(0.5 + rng.rand(3, len(w)), jnp.float32)
    got = jax.vmap(lambda w_: assemble_bd(bop, w_))(ws)
    for i in range(3):
        ref = assemble_bd(bop, ws[i])
        np.testing.assert_array_equal(np.asarray(got.ut[i]),
                                      np.asarray(ref.ut))
        np.testing.assert_array_equal(np.asarray(got.deg[i]),
                                      np.asarray(ref.deg))


@pytest.mark.parametrize("precision,tol_key", [
    (jax.lax.Precision.HIGHEST, "banded_apply_highest"),
    (jax.lax.Precision.DEFAULT, "banded_apply_default"),
])
def test_banded_apply_f32_parity_vs_f64_reference(precision, tol_key):
    """The float32 apply (the solver's accelerator dtype) at both matmul
    precisions against a float64 sparse product — the same check the chip
    smoke test runs at city10000 widths (mac_tpu.ops.parity)."""
    from mac_tpu.ops import parity

    idx, w = parity.chain_pose_graph(1500, 700, 40, seed=1)
    err = parity.check_banded_apply(idx, w, 1500, q=4, precision=precision)
    assert err <= parity.TOL[tol_key], err


def test_assembly_parity_seeded_weights_vs_f64_reference():
    """The float32 sheared assembly against blocks scattered in float64,
    on weights whose sums are inexact in float32 (chip smoke phase 5)."""
    from mac_tpu.ops import parity

    idx, _ = parity.chain_pose_graph(1500, 700, 40, seed=2)
    w = parity.seeded_weights(len(idx), seed=3)
    err = parity.check_assembly(idx, w, 1500)
    assert 0.0 < err <= parity.TOL["assembly"], err


@pytest.mark.parametrize("smoother,kind", [
    ("chain", "mult"), ("bjacobi", "mult"), ("chain", "additive"),
])
def test_banded_precond_symmetric_and_effective(smoother, kind):
    idx, w, n = _pose_graph()
    bop, ridx = build_banded_rcm(idx, n, dtype=jnp.float64)
    assert bop is not None
    wj = jnp.asarray(w, jnp.float64)
    BD = assemble_bd(bop, wj)
    M = make_banded_precond(bop, BD, w=wj, smoother=smoother, kind=kind)
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.normal(size=(n, 1)))
    y = jnp.asarray(rng.normal(size=(n, 1)))
    mx, my = M(x), M(y)
    ip1 = float(jnp.sum(mx * y))
    ip2 = float(jnp.sum(x * my))
    assert abs(ip1 - ip2) < 1e-8 * max(abs(ip1), 1.0)

    if kind == "additive":
        # M^-1 = S + P Lc^-1 R double-counts smooth components, so a raw
        # Richardson step is not a contraction — additive is a CG/Krylov
        # preconditioner only. Assert positive definiteness on probes.
        for _ in range(4):
            z = jnp.asarray(rng.normal(size=(n, 1)))
            assert float(jnp.sum(z * M(z))) > 0.0
        return

    # Effectiveness: one preconditioned Richardson step on L u = b (with b
    # centered) must beat plain diagonal scaling by a wide margin.
    u = rng.normal(size=(n, 1))
    u -= u.mean()
    b = np.asarray(banded_apply(bop, BD, jnp.asarray(u)))
    err0 = np.linalg.norm(u)
    e_pc = u - np.asarray(M(jnp.asarray(b)))
    e_pc -= e_pc.mean()
    assert np.linalg.norm(e_pc) < 0.7 * err0


def test_precond_rebuild_skip_reuses_coarse_inverse():
    """rebuild=False must reuse the carried coarse inverse verbatim (no
    assembly, no Newton-Schulz); rebuild=True must match the
    always-rebuild (rebuild=None) path."""
    from mac_tpu.ops.banded import PrecondState

    idx, w, n = _pose_graph()
    bop, ridx = build_banded_rcm(idx, n, dtype=jnp.float64)
    wj = jnp.asarray(w, jnp.float64)
    BD = assemble_bd(bop, wj)
    _, st0 = make_banded_precond(bop, BD, w=wj, return_state=True)

    # Perturb the weights; carry st0 forward under each protocol.
    w2 = wj * 1.05
    BD2 = assemble_bd(bop, w2)
    _, st_ref = make_banded_precond(
        bop, BD2, w=w2, prev_state=st0, use_prev=jnp.asarray(True),
        return_state=True)
    _, st_rb = make_banded_precond(
        bop, BD2, w=w2, prev_state=st0, use_prev=jnp.asarray(True),
        rebuild=jnp.asarray(True), return_state=True)
    M_skip, st_skip = make_banded_precond(
        bop, BD2, w=w2, prev_state=st0, use_prev=jnp.asarray(True),
        rebuild=jnp.asarray(False), return_state=True)

    # rebuild=True differs from rebuild=None only by lax.cond nesting
    # (different XLA fusion, same math).
    np.testing.assert_allclose(np.asarray(st_rb.Lc_inv),
                               np.asarray(st_ref.Lc_inv),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(st_skip.Lc_inv),
                                  np.asarray(st0.Lc_inv))
    assert isinstance(st_skip, PrecondState)

    # The chain LDL factor rides the same gate: skipped steps carry the
    # previous factor verbatim; rebuild=True refactors against w2.
    np.testing.assert_array_equal(np.asarray(st_skip.chain_dp),
                                  np.asarray(st0.chain_dp))
    np.testing.assert_array_equal(np.asarray(st_skip.chain_l),
                                  np.asarray(st0.chain_l))
    np.testing.assert_allclose(np.asarray(st_rb.chain_dp),
                               np.asarray(st_ref.chain_dp),
                               rtol=1e-8, atol=1e-12)
    assert float(jnp.max(jnp.abs(st_rb.chain_dp - st0.chain_dp))) > 0.0

    # The skip-step preconditioner (stale factor + stale coarse inverse —
    # a gamma-sized perturbation) remains symmetric positive definite.
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.normal(size=(n, 1)))
    y = jnp.asarray(rng.normal(size=(n, 1)))
    ip1 = float(jnp.sum(M_skip(x) * y))
    ip2 = float(jnp.sum(x * M_skip(y)))
    assert abs(ip1 - ip2) < 1e-8 * max(abs(ip1), 1.0)
    assert float(jnp.sum(x * M_skip(x))) > 0.0


def test_fiedler_pair_with_banded_matches_dense():
    from mac_tpu.ops.lobpcg import dense_fiedler
    from mac_tpu.ops.laplacian import lap_dense
    from mac_tpu.utils.fiedler import fiedler_pair_op

    idx, w, n = _pose_graph(n=640, n_loops=200)
    bop, ridx = build_banded_rcm(idx, n, dtype=jnp.float64)
    assert bop is not None
    op = build_operator(ridx, n, mode="ell")
    wj = jnp.asarray(w, jnp.float64)
    rng = np.random.RandomState(7)
    X0 = jnp.asarray(rng.normal(size=(n, 4)))
    res = fiedler_pair_op(op, wj, X0, tol=1e-10, maxiter=300,
                          inner_iters=16, banded=bop)
    exact = dense_fiedler(lap_dense(build_operator(ridx, n, mode="dense"), wj), 4)
    assert abs(float(res.lam[0]) - float(exact.lam[0])) < 1e-8 * float(exact.lam[0]) + 1e-12
