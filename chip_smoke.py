#!/usr/bin/env python3
"""On-chip smoke test: MAC's main path, end to end, on one NVIDIA GPU.

    python chip_smoke.py            # one card: phases 1-6 below
    python chip_smoke.py --multi    # four cards: the mesh paths only
    python chip_smoke.py --spread R # one card: float32 reordering spread

Phases (each prints its own line; the last stdout line is one JSON object):

  1. device: JAX's devices, the card's name and power limit (nvidia-smi,
     read by a child process that does not import JAX), the compile cache;
  2. headline: city10000, K = 50% of loop closures, NaiveGreedy x_init,
     nearest rounding, cache on, default MAC(...) configuration — cold and
     warm times, the route (banded float32 on the device is required) and
     the relaxed lambda_2 from the scipy float64 referee against the
     reference optimum;
  3. the same instance on the ELL + two-grid operator (use_banded=False);
  4. sphere2500 (3D, banded device route), intel (host route), and a
     disconnected graph (lambda_2 = 0, device route);
  5. kernel-layer parity at city10000 widths against float64 references
     (mac_tpu.ops.parity);
  6. peak device memory after phase 2.

--multi runs only the multi-device API on a 4-card mesh: the ELL
row-sharded solve, the banded x mesh solve and solve_sweep over the 'sweep'
axis, each compared with the single-device result in the same process.
--spread measures, on one card, how far the float32 ELL route's results
move when only the summation order changes; that sets the bounds of
--multi's float32 comparisons.

The script refuses to run anywhere but a GPU: there is no CPU fallback. A
failed phase makes it exit nonzero without the JSON line.
"""

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Relaxed lambda_2 of the reference implementation's canonical protocol
# (K = 50%, NaiveGreedy init, 20 Frank-Wolfe steps, nearest rounding):
# scripts/baseline_reference.json.
REFERENCE_LAM2 = {
    "city10000": 0.06944591018149751,
    "sphere2500": 0.23430047503258467,
    "intel": 0.05372595512017725,
}
QUALITY_SLACK = 1e-3        # relaxed lambda_2 >= reference * (1 - slack)
MULTI_REL_TOL = 1e-4        # mesh vs single-device relaxed lambda_2
# Float32 mesh vs single-device: twice the largest change that a candidate
# permutation alone made on one H100 80GB HBM3 at 700 W (--spread 4,
# city10000): first Fiedler solve at x_init 1.764e-5 in lambda_2 and
# 1.322e-3 in the gradient; relaxed lambda_2 after the 5-step solve and
# the 16 sweep lanes (the same quantity, pooled) 1.793e-3.
MULTI_F32_BOUND = dict(lam0=3.6e-5, grad=2.7e-3, lam2=3.6e-3, sweep=3.6e-3)


def card_line() -> str:
    """`name, power.limit` of every card, from nvidia-smi (no JAX here)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def require_gpu(count: int):
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: JAX backend is {backend!r}, not 'gpu'; "
                 "this check runs only on an NVIDIA GPU")
    devs = jax.devices()
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX sees {len(devs)}")
    return devs


def say(msg: str):
    print(msg, flush=True)


def load(name: str):
    from mac_tpu.slam.pose_graph import read_g2o_file, rpm_to_mac, split_edges

    measurements, n = read_g2o_file(str(REPO / "data" / f"{name}.g2o"))
    fixed, cands = split_edges(rpm_to_mac(measurements))
    return fixed, cands, n


def relaxed_lam2(mac, unrounded) -> float:
    import numpy as np

    from mac_tpu.utils.fiedler import scipy_lam2

    return scipy_lam2(mac.laplacian(np.asarray(unrounded)))


def timed_solves(mac, k, x_init, n_warm: int = 3, **kw):
    """Cold solve (compile included) then `n_warm` warm ones. solve()
    returns host arrays, so every time ends in a device-to-host fetch."""
    times = []
    for _ in range(1 + n_warm):
        t0 = time.perf_counter()
        out = mac.solve(k, x_init, rounding="nearest", use_cache=True, **kw)
        times.append(time.perf_counter() - t0)
    return out, times[0], times[1:]


def quality_gate(name, mac, k, out):
    rounded, unrounded, upper = out
    lam2 = relaxed_lam2(mac, unrounded)
    ref = REFERENCE_LAM2[name]
    gap = (lam2 - ref) / ref
    assert lam2 >= ref * (1 - QUALITY_SLACK), (
        f"{name}: relaxed lambda_2 {lam2!r} below reference {ref!r} "
        f"(gap {gap:+.3e})")
    assert int(round(float(rounded.sum()))) == k, (
        f"{name}: rounded selection has {rounded.sum()} edges, want {k}")
    return lam2, gap


def route(mac) -> dict:
    import numpy as np

    return dict(banded=mac._banded is not None,
                dtype=str(np.dtype(mac.dtype)),
                fiedler_backend=mac.fiedler_backend)


# ---------------------------------------------------------------- phases


def phase_device(devs):
    import jax

    cache = (jax.config.jax_compilation_cache_dir
             or "(persistent compile cache off)")
    say(f"phase 1 device: platform={devs[0].platform} "
        f"kind={devs[0].device_kind!r} count={len(devs)} "
        f"devices={[str(d) for d in devs]}")
    say(f"phase 1 card: {card_line()}")
    say(f"phase 1 compile cache: {cache}")


def phase_headline(state):
    import numpy as np

    from mac_tpu.solvers import MAC, NaiveGreedy

    fixed, cands, n = load("city10000")
    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)
    t0 = time.perf_counter()
    mac = MAC(fixed, cands, n)
    ctor_s = time.perf_counter() - t0
    r = route(mac)
    assert r == dict(banded=True, dtype="float32",
                     fiedler_backend="device"), f"headline route {r}"
    out, cold, warm = timed_solves(mac, k, x_init)
    lam2, gap = quality_gate("city10000", mac, k, out)
    state["peak_after_headline"] = peak_bytes()
    say(f"phase 2 headline city10000 n={n} m_cand={len(cands)} k={k}: "
        f"route={r} ctor_s={ctor_s:.4f} cold_s={cold:.4f} "
        f"warm_s={[round(t, 4) for t in warm]} "
        f"warm_median_s={float(np.median(warm)):.4f} relaxed_lam2={lam2!r} "
        f"gap_vs_ref={gap:+.3e} rounded_sum={int(out[0].sum())} "
        f"stats={mac.last_solve_stats}")


def phase_ell():
    import numpy as np

    from mac_tpu.solvers import MAC, NaiveGreedy

    fixed, cands, n = load("city10000")
    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)
    mac = MAC(fixed, cands, n, use_banded=False)
    r = route(mac)
    assert r == dict(banded=False, dtype="float32",
                     fiedler_backend="device"), f"ELL route {r}"
    # The ELL path keeps reference-style exact steps; run the reference's
    # own 20-step experiment protocol.
    out, cold, warm = timed_solves(mac, k, x_init, max_iters=20)
    lam2, gap = quality_gate("city10000", mac, k, out)
    say(f"phase 3 ell+twogrid city10000 k={k} max_iters=20: route={r} "
        f"cold_s={cold:.4f} warm_s={[round(t, 4) for t in warm]} "
        f"warm_median_s={float(np.median(warm)):.4f} relaxed_lam2={lam2!r} "
        f"gap_vs_ref={gap:+.3e} stats={mac.last_solve_stats}")


def phase_routes():
    import numpy as np

    from mac_tpu.solvers import MAC, NaiveGreedy
    from mac_tpu.utils.graphs import Edge

    for name, want in (
            ("sphere2500", dict(banded=True, dtype="float32",
                                fiedler_backend="device")),
            ("intel", dict(banded=False, dtype="float64",
                           fiedler_backend="host"))):
        fixed, cands, n = load(name)
        k = len(cands) // 2
        x_init = NaiveGreedy(cands).subset(k)
        mac = MAC(fixed, cands, n)
        r = route(mac)
        assert r == want, f"{name} route {r}, want {want}"
        out, cold, warm = timed_solves(mac, k, x_init)
        if name == "intel":
            assert mac.last_solve_stats["backend"] == "host"
        lam2, gap = quality_gate(name, mac, k, out)
        say(f"phase 4 {name} n={n} k={k}: route={r} cold_s={cold:.4f} "
            f"warm_median_s={float(np.median(warm)):.4f} "
            f"relaxed_lam2={lam2!r} gap_vs_ref={gap:+.3e} "
            f"stats={mac.last_solve_stats}")

    # Disconnected even with every candidate: lambda_2 = 0 everywhere; the
    # router keeps it on the device engine.
    n = 1200
    half = n // 2
    fixed = ([Edge(i, i + 1, 1.0) for i in range(half - 1)]
             + [Edge(i, i + 1, 1.0) for i in range(half, n - 1)])
    cands = [Edge(0, 5, 1.0), Edge(half, half + 9, 1.0), Edge(2, 30, 1.0)]
    mac = MAC(fixed, cands, n)
    assert mac.fiedler_backend == "device", route(mac)
    rounded, unrounded, upper = mac.solve(2)
    obj = mac.evaluate_objective(unrounded)
    assert np.isfinite(upper) and np.isfinite(obj) and abs(obj) < 1e-8, (
        obj, upper)
    assert rounded.sum() == 2 and obj <= upper
    say(f"phase 4 disconnected n={n}: route={route(mac)} lambda2={obj!r} "
        f"upper={upper!r}")


def phase_parity():
    import jax
    import numpy as np

    from mac_tpu.ops import banded, parity
    from mac_tpu.utils.graphs import edges_to_arrays

    fixed, cands, n = load("city10000")
    idx, w = edges_to_arrays(fixed + cands)
    bop, _ = banded.build_banded_rcm(idx, n)
    checks = [
        ("banded_apply HIGHEST q=4", "banded_apply_highest",
         lambda: parity.check_banded_apply(idx, w, n, q=4)),
        ("banded_apply DEFAULT q=4", "banded_apply_default",
         lambda: parity.check_banded_apply(
             idx, w, n, q=4, precision=jax.lax.Precision.DEFAULT)),
        ("chain solve exact n=10000 q=4", "chain_solve",
         lambda: parity.check_chain_solve(10_000, q=4)),
        (f"chain solve blocked({banded.CHAIN_LDL_BLOCK}) n=100000 q=4",
         "chain_solve",
         lambda: parity.check_chain_solve(
             100_000, q=4, block=banded.CHAIN_LDL_BLOCK)),
        ("assembly, seeded weights (rel. to max degree)", "assembly",
         lambda: parity.check_assembly(
             idx, parity.seeded_weights(len(idx)), n)),
    ]
    bad = []
    for label, tol_key, fn in checks:
        err = fn()
        tol = parity.TOL[tol_key]
        ok = bool(np.isfinite(err) and err <= tol)
        say(f"phase 5 parity {label} (n_pad={bop.n_pad}): err={err!r} "
            f"tol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(label)
    assert not bad, f"parity failures: {bad}"


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_memory(state):
    peak = state.get("peak_after_headline")
    assert peak is not None, "no memory_stats from the device"
    say(f"phase 6 peak_bytes_in_use after phase 2: {peak} "
        f"({peak / 2**30:.3f} GiB)")


# --------------------------------------------------- --multi, --spread


def rel_diff(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - a) / np.linalg.norm(a))


def permute_candidates(cands, r: int):
    """The candidates in the order of a permutation seeded by r. ELL table
    slots follow the edge order, so the float32 sums of every Laplacian
    product row and of the coarse assembly run in another order; the
    problem is the same. (Reordering only the fixed edges changes nothing:
    each node has at most two odometry edges, and a + b == b + a.)"""
    import numpy as np

    perm = np.random.RandomState(r).permutation(len(cands))
    return [cands[i] for i in perm], perm


def sweep_budgets(m: int):
    return [int(m * f) for f in (0.1, 0.3, 0.5, 0.7)]


def f32_readings(mac, k, x_init, ks=(), perm=None):
    """What the float32 ELL route computes on city10000: the first Fiedler
    solve at x_init (its lambda_2 and candidate gradient, before any top-k
    step), the relaxed lambda_2 of a full solve and, for budgets `ks`, of
    each lane of a budget sweep. `perm`: the candidate permutation `mac`
    was built with (permute_candidates); x_init is given and the gradient
    returned in the original candidate order."""
    import numpy as np

    if perm is not None:
        x_init = x_init[perm]
    lam0, grad = mac.problem(x_init)
    grad = np.asarray(grad, np.float64)
    if perm is not None:
        grad = grad[np.argsort(perm)]
    r, u, _ = mac.solve(k, x_init, rounding="nearest", use_cache=True)
    out = dict(lam0=float(lam0), grad=grad,
               lam2=relaxed_lam2(mac, u), rsum=int(round(float(r.sum()))))
    if len(ks):
        _, us, _ = mac.solve_sweep(ks)
        out["sweep"] = [relaxed_lam2(mac, us[i]) for i in range(len(ks))]
    return out


def f32_diffs(a, b, k) -> dict:
    """Relative differences of two f32_readings, and how many of the k
    largest gradient entries differ (the first top-k step's flips)."""
    import numpy as np

    top = lambda g: set(np.argsort(-g, kind="stable")[:k].tolist())
    d = dict(
        lam0=rel_diff(a["lam0"], b["lam0"]),
        grad=rel_diff(a["grad"], b["grad"]),
        topk_flips=k - len(top(a["grad"]) & top(b["grad"])),
        lam2=rel_diff(a["lam2"], b["lam2"]))
    if "sweep" in a and "sweep" in b:
        d["sweep"] = max(rel_diff(x, y) for x, y in zip(a["sweep"], b["sweep"]))
    return d


def fmt_diffs(d) -> str:
    return " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in d.items())


def run_spread(fixed, cands, n, n_perms: int):
    """One card: how far the float32 ELL route's results move when only
    the summation order changes (permute_candidates), which sets the
    bounds of the float32 mesh comparisons in --multi (MULTI_F32_BOUND)."""
    from mac_tpu.solvers import MAC, NaiveGreedy

    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)
    ks = sweep_budgets(len(cands))
    base = f32_readings(MAC(fixed, cands, n, use_banded=False), k, x_init, ks)
    say(f"spread base: lam0={base['lam0']!r} lam2={base['lam2']!r} "
        f"sweep={base['sweep']}")
    worst = {}
    for r in range(1, n_perms + 1):
        t0 = time.perf_counter()
        pc, perm = permute_candidates(cands, r)
        got = f32_readings(MAC(fixed, pc, n, use_banded=False), k, x_init,
                           ks, perm)
        d = f32_diffs(base, got, k)
        lanes = [f"{rel_diff(x, y):.3e}"
                 for x, y in zip(base["sweep"], got["sweep"])]
        say(f"spread permutation {r}: {fmt_diffs(d)} sweep_lanes={lanes} "
            f"({time.perf_counter() - t0:.1f} s)")
        worst = {key: max(worst.get(key, 0), v) for key, v in d.items()}
    say(f"spread max over {n_perms} permutations: {fmt_diffs(worst)}")


def multi_compare(label, lam_single, lam_mesh, sum_single, sum_mesh,
                  tol=MULTI_REL_TOL):
    rel = abs(lam_mesh - lam_single) / abs(lam_single)
    ok = rel <= tol and sum_single == sum_mesh
    say(f"multi {label}: relaxed_lam2 single={lam_single!r} "
        f"mesh={lam_mesh!r} rel_diff={rel:.3e} tol={tol:.1e} rounded_sum "
        f"single={sum_single} mesh={sum_mesh} {'ok' if ok else 'FAIL'}")
    return ok


def run_multi(fixed, cands, n, n_dev: int = 4):
    """Mesh paths on `n_dev` devices, each against the single-device
    result. Returns the list of failed comparisons.

    The ELL row-sharded solve and the sweep are compared twice. In float64
    (exactness witness) the sharded program must give the single-device
    result to MULTI_REL_TOL. In float32 (the default route on a GPU) the
    sharded reductions round differently, so each reading must stay within
    MULTI_F32_BOUND of the single-device one: twice the spread that a
    changed summation order alone makes on one card (--spread). The banded
    comparison runs the default float32 route."""
    import jax.numpy as jnp

    from mac_tpu.parallel.mesh import make_mesh
    from mac_tpu.solvers import MAC, NaiveGreedy

    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)
    ks = sweep_budgets(len(cands))
    graph_mesh = make_mesh(n_graph=n_dev)
    sweep_mesh = make_mesh(n_graph=1, n_sweep=n_dev)
    failed = []

    def solve(mac, **kw):
        t0 = time.perf_counter()
        r, u, _ = mac.solve(k, x_init, rounding="nearest", use_cache=True,
                            **kw)
        return relaxed_lam2(mac, u), int(round(float(r.sum()))), \
            time.perf_counter() - t0

    def sweep(single, mesh, label, tol):
        t0 = time.perf_counter()
        r1, u1, _ = single.solve_sweep(ks)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        r2, u2, _ = mesh.solve_sweep(ks)
        t2 = time.perf_counter() - t0
        say(f"multi {label} ks={ks} times: single_s={t1:.4f} "
            f"mesh_s={t2:.4f} (cold)")
        for i, kk in enumerate(ks):
            if not multi_compare(
                    f"{label} lane k={kk}", relaxed_lam2(single, u1[i]),
                    relaxed_lam2(mesh, u2[i]), int(round(r1[i].sum())),
                    int(round(r2[i].sum())), tol):
                failed.append(f"{label} lane {kk}")

    # ELL row-sharded solve, float32: the route MAC(..., mesh=...) takes.
    single = MAC(fixed, cands, n, use_banded=False)
    mesh_ell = MAC(fixed, cands, n, mesh=graph_mesh)
    dts = {str(jnp.dtype(m.dtype)) for m in (single, mesh_ell)}
    if dts != {"float32"}:
        failed.append(f"float32 route not taken: {dts}")
    devsets = [len(t.sharding.device_set) for t in
               (mesh_ell._sharded.nbr_tbl, mesh_ell._sharded.eid_tbl)]
    say(f"multi ell tables sit on {devsets} devices")
    if min(devsets) < n_dev:
        failed.append("ell tables not sharded")
    t0 = time.perf_counter()
    a = f32_readings(single, k, x_init)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = f32_readings(mesh_ell, k, x_init)
    t2 = time.perf_counter() - t0
    d = f32_diffs(a, b, k)
    bad = [key for key, v in d.items()
           if key in MULTI_F32_BOUND and v > MULTI_F32_BOUND[key]]
    if a["rsum"] != b["rsum"]:
        bad.append("rounded_sum")
    say(f"multi ell row-sharded f32 (single vs mesh): lam0 single="
        f"{a['lam0']!r} mesh={b['lam0']!r}; relaxed_lam2 single="
        f"{a['lam2']!r} mesh={b['lam2']!r}; {fmt_diffs(d)} "
        f"bounds={MULTI_F32_BOUND} times: single_s={t1:.4f} "
        f"mesh_s={t2:.4f} (cold) {'FAIL ' + str(bad) if bad else 'ok'}")
    if bad:
        failed.append("ell row-sharded f32")

    # ELL row-sharded solve, float64.
    f64 = jnp.float64
    l1, s1, t1 = solve(MAC(fixed, cands, n, use_banded=False, dtype=f64))
    l2, s2, t2 = solve(MAC(fixed, cands, n, mesh=graph_mesh, dtype=f64))
    say(f"multi ell f64 times: single_s={t1:.4f} mesh_s={t2:.4f} (cold)")
    if not multi_compare("ell row-sharded f64", l1, l2, s1, s2):
        failed.append("ell row-sharded f64")

    # banded x mesh (float32, the default dtype).
    single_b = MAC(fixed, cands, n)
    mesh_b = MAC(fixed, cands, n, mesh=graph_mesh, use_banded=True)
    if mesh_b._banded is None or mesh_b._banded_shardings is None:
        failed.append("banded x mesh not on the banded route")
    l1, s1, t1 = solve(single_b)
    l2, s2, t2 = solve(mesh_b)
    say(f"multi banded times: single_s={t1:.4f} mesh_s={t2:.4f} (cold)")
    if not multi_compare("banded x mesh", l1, l2, s1, s2):
        failed.append("banded x mesh")

    # solve_sweep: budget lanes over the 'sweep' axis, float32 then
    # float64.
    sweep(MAC(fixed, cands, n, use_banded=False),
          MAC(fixed, cands, n, mesh=sweep_mesh),
          "sweep f32", MULTI_F32_BOUND["sweep"])
    sweep(MAC(fixed, cands, n, use_banded=False, dtype=f64),
          MAC(fixed, cands, n, mesh=sweep_mesh, dtype=f64),
          "sweep f64", MULTI_REL_TOL)
    return failed


# ----------------------------------------------------------------- main


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card mesh paths")
    ap.add_argument("--spread", type=int, default=0, metavar="R",
                    help="run only the one-card float32 spread over R "
                         "reorderings of the fixed edges")
    args = ap.parse_args()
    n_dev = 4 if args.multi else 1
    devs = require_gpu(n_dev)
    sys.path.insert(0, str(REPO))
    import mac_tpu  # noqa: F401  (enables x64, sets the compile cache)

    failures = []

    def run(name, fn, *a):
        try:
            fn(*a)
        except Exception:
            traceback.print_exc()
            say(f"{name} FAILED")
            failures.append(name)

    run("phase 1", phase_device, devs)
    if args.multi:
        fixed, cands, n = load("city10000")
        try:
            failures += run_multi(fixed, cands, n, n_dev)
        except Exception:
            traceback.print_exc()
            failures.append("multi")
    elif args.spread:
        run("spread", run_spread, *load("city10000"), args.spread)
    else:
        state = {}
        run("phase 2", phase_headline, state)
        run("phase 3", phase_ell)
        run("phase 4", phase_routes)
        run("phase 5", phase_parity)
        run("phase 6", phase_memory, state)
    if failures:
        say(f"chip_smoke FAILED: {failures}")
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
