"""Headline benchmark: full MAC solve on city10000 at K = 50% budget.

Runs on whatever accelerator jax picks by default. Inputs match scripts/measure_baseline.py (which produced the
reference number in BASELINE.md): K = 50% of loop closures, x_init =
NaiveGreedy top-K, nearest rounding, warm-start cache on.

Each solver runs at its own recommended operating point: the reference
at its experiment driver's max_iters=20 exact Frank-Wolfe steps
(examples/g2o_experiment.py:319 of the reference), mac_tpu at its
automatic default policy (`mac.solve(k, x_init)` — no knobs), which on
this path is many cheap inexact steps. Quality is reported alongside so
the comparison cannot trade accuracy for speed: lambda_2 of OUR relaxed
solution is computed with scipy (float64 shift-invert Lanczos on the
host — the same stack that evaluates the reference) and must match or
beat the reference's relaxed optimum; the run also fails loudly if it
falls more than 1e-3 below. BASELINE.md records the reference at higher
iteration counts too (50 iters: 5.15 s to reach lambda_2 = 0.0697247) —
the quality our default config is compared against below is its
CANONICAL 20-step protocol value.

Prints ONE JSON line:
  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": ratio}
vs_baseline = reference_seconds / ours (higher is better).

Timing excludes jit compilation (one warmup solve) and reports the
MEDIAN of five warm solves — compilation is a one-time cost amortized
across a sweep/deployment, and the reference has no analogous cost; the
cold time and all five runs go to stderr for transparency.
"""

import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

REFERENCE_SOLVE_S = 1.931  # BASELINE.md: reference CPU, city10000, K=50%
REFERENCE_LAM2_UNROUNDED = 0.06944591018149751


from mac_tpu.utils.fiedler import scipy_lam2  # shared quality referee


def main():
    import numpy as np

    from mac_tpu.slam.pose_graph import read_g2o_file, rpm_to_mac, split_edges
    from mac_tpu.solvers import MAC, NaiveGreedy

    dataset = REPO / "data" / "city10000.g2o"
    measurements, n = read_g2o_file(str(dataset))
    fixed, cands = split_edges(rpm_to_mac(measurements))
    k = len(cands) // 2

    x_init = NaiveGreedy(cands).subset(k)
    # Pure default configuration: the automatic solver + iteration policy
    # (MAC.__init__ / MAC.solve) — a user calling MAC(...).solve(k) gets
    # the headline number.
    mac = MAC(fixed, cands, n)

    t0 = time.perf_counter()
    mac.solve(k, x_init, rounding="nearest", use_cache=True)
    cold_s = time.perf_counter() - t0

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        rounded, unrounded, upper = mac.solve(
            k, x_init, rounding="nearest", use_cache=True
        )
        times.append(time.perf_counter() - t0)
    solve_s = statistics.median(times)

    lam2 = scipy_lam2(mac.laplacian(np.asarray(unrounded)))
    rel_gap = (lam2 - REFERENCE_LAM2_UNROUNDED) / REFERENCE_LAM2_UNROUNDED

    print(
        f"cold={cold_s:.3f}s warm_runs={[round(t, 4) for t in times]} "
        f"median={solve_s:.4f}s lam2_scipy={lam2:.9g} "
        f"(ref {REFERENCE_LAM2_UNROUNDED:.9g}, rel gap {rel_gap:+.2e}; "
        f"positive = better than the reference's relaxed optimum) "
        f"k={k} n={n} backend={__import__('jax').devices()[0].platform}",
        file=sys.stderr,
    )
    if rel_gap < -1e-3:
        print("QUALITY REGRESSION: relaxed objective more than 1e-3 below "
              "the reference", file=sys.stderr)
        sys.exit(1)
    print(
        json.dumps(
            {
                "metric": "mac_solve_city10000_k50pct_wall_clock",
                "value": round(solve_s, 4),
                "unit": "s",
                "vs_baseline": round(REFERENCE_SOLVE_S / solve_s, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
