"""Full benchmark table: mac_tpu on the default accelerator vs the reference's measured CPU
numbers (scripts/baseline_reference.json), all six datasets. Inputs match
(K = 50%, NaiveGreedy init, nearest rounding, cache on); each solver runs
its own recommended operating point — the reference at its experiment
driver's max_iters=20, mac_tpu at the automatic default policy (see
MAC.solve) — and relaxed-solution quality is scored with scipy float64
shift-invert Lanczos (the impartial referee), so the comparison cannot
trade accuracy for speed.

Also times our GreedyESP lazy sweep on city10000 — the strongest classical
baseline, which the reference implementation cannot run in this image at
all (it requires CHOLMOD/scikit-sparse).

Writes scripts/bench_all_results.json and prints a table.
"""

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

from mac_tpu.slam.pose_graph import read_g2o_file, rpm_to_mac, split_edges
from mac_tpu.solvers import MAC, NaiveGreedy
from mac_tpu.solvers.greedy_esp import GreedyESP

REF = {r["dataset"]: r for r in json.loads(
    (REPO / "scripts" / "baseline_reference.json").read_text())}


from mac_tpu.utils.fiedler import scipy_lam2  # shared quality referee


def run(name):
    import statistics

    measurements, n = read_g2o_file(str(REPO / "data" / f"{name}.g2o"))
    fixed, cands = split_edges(rpm_to_mac(measurements))
    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)
    mac = MAC(fixed, cands, n)  # automatic solver + iteration policy
    t0 = time.perf_counter()
    mac.solve(k, x_init, use_cache=True)
    cold = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        rounded, unrounded, upper = mac.solve(k, x_init, use_cache=True)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    lam_unrounded = scipy_lam2(mac.laplacian(np.asarray(unrounded)))
    lam_rounded = scipy_lam2(mac.laplacian(np.asarray(rounded)))
    ref = REF[name]
    rec = dict(
        dataset=name, n=n, m_cand=len(cands), k=k,
        solve_s=round(med, 4), cold_s=round(cold, 1),
        ref_solve_s=ref["solve_s"],
        speedup=round(ref["solve_s"] / med, 2),
        lam2_unrounded=lam_unrounded,
        ref_lam2_unrounded=ref["lam2_unrounded"],
        lam2_gap_rel=(lam_unrounded - ref["lam2_unrounded"]) / abs(ref["lam2_unrounded"]),
        lam2_rounded=lam_rounded,
        ref_lam2_rounded=ref["lam2_rounded"],
        quality_referee="scipy eigsh f64 (both columns)",
    )
    print(json.dumps(rec), flush=True)
    return rec


def main():
    names = sys.argv[1:] or ["intel", "kitti_05", "kitti_02", "sphere2500",
                             "city10000", "ais2klinik"]
    out = []
    for name in names:
        out.append(run(name))

    # GreedyESP lazy sweep on city10000 (budgets 10%..50%).
    measurements, n = read_g2o_file(str(REPO / "data" / "city10000.g2o"))
    fixed, cands = split_edges(rpm_to_mac(measurements))
    m = len(cands)
    ks = [int(f * m) for f in (0.1, 0.3, 0.5)]
    esp = GreedyESP(fixed, cands, n)
    t0 = time.perf_counter()
    results, sel, times = esp.subsets_lazy(ks)
    esp_total = time.perf_counter() - t0
    print(json.dumps(dict(dataset="city10000", solver="GreedyESP-lazy",
                          ks=ks, times=[round(t, 2) for t in times],
                          total_s=round(esp_total, 2),
                          note="reference cannot run ESP without CHOLMOD")),
          flush=True)

    (REPO / "scripts" / "bench_all_results.json").write_text(
        json.dumps(out, indent=2))
    print("wrote scripts/bench_all_results.json", flush=True)


if __name__ == "__main__":
    main()
