"""Measure the block-banded matmul path on city10000 (bench protocol).

Reports warm solve time, FW/Fiedler iteration counts, and lambda parity
for a few (inner_iters, maxiter, tol, rel_tol) configs.
"""

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

from mac_tpu.slam.pose_graph import read_g2o_file, rpm_to_mac, split_edges
from mac_tpu.solvers import MAC, NaiveGreedy

REF_LAM2 = 0.06944591018149751

def main():
    measurements, n = read_g2o_file(str(REPO / "data" / "city10000.g2o"))
    fixed, cands = split_edges(rpm_to_mac(measurements))
    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)

    configs = sys.argv[1:] or ["10,40,6e-4,3e-2", "16,40,6e-4,3e-2", "24,30,6e-4,3e-2"]
    for cfg in configs:
        parts = cfg.split(",")
        ii, mi, tol, rtol = parts[:4]
        c32 = "c32" in parts[4:]
        warm = None
        blockq = None
        for p in parts[4:]:
            if p.startswith("w"):
                warm = int(p[1:])
            if p.startswith("q"):
                blockq = int(p[1:])
        import jax.numpy as jnp
        mac = MAC(fixed, cands, n, fiedler_inner_iters=int(ii),
                  fiedler_maxiter=int(mi), fiedler_tol=float(tol),
                  fiedler_rel_tol=float(rtol), use_banded=True,
                  fiedler_coeff_dtype=jnp.float32 if c32 else None,
                  fiedler_warm_maxiter=warm, fiedler_block_q=blockq)
        print(f"cfg inner={ii} maxiter={mi} tol={tol} rel_tol={rtol} "
              f"coeff={'f32' if c32 else 'f64'} warm={warm} q={mac._q} "
              f"banded={'ON' if mac._banded is not None else 'off'}", flush=True)
        t0 = time.perf_counter()
        mac.solve(k, x_init, rounding="nearest", max_iters=20, use_cache=True)
        print(f"  cold {time.perf_counter()-t0:.2f}s", flush=True)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            rounded, unrounded, upper = mac.solve(
                k, x_init, rounding="nearest", max_iters=20, use_cache=True)
            times.append(time.perf_counter() - t0)
        lam2 = mac.evaluate_objective(unrounded)
        rel = (lam2 - REF_LAM2) / REF_LAM2
        st = mac.last_solve_stats
        print(f"  warm {min(times):.3f}s runs={[round(t,3) for t in times]} "
              f"lam2={lam2:.8f} rel={rel:+.2e} fw={st['fw_iterations']} "
              f"fiedler_iters={st['fiedler_iterations']}", flush=True)


if __name__ == "__main__":
    main()
