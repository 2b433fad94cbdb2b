"""Trace one warm city10000 solve on the GPU and reduce it to layer metrics.

    python scripts/profile_trace.py [--out DIR] [--variants scan,gtsv]
                                    [--no-command-buffer]

For each chain-smoother variant it builds the default MAC (banded float32
route), warms it up, times warm solves with the profiler off, then traces
one warm solve with `jax.profiler` and reduces the trace to:

  * wall time of the traced solve and device busy time (union of kernel
    intervals on the GPU planes) -> the device's idle share;
  * device time, kernel count, estimated calls and per-call time of the
    named scopes `chain_solve` (mac_tpu.ops.tridiag) and `assemble_bd`
    (mac_tpu.ops.banded), and their share of device busy time;
  * the top kernels by device time.

Kernels are attributed to scopes through the compiled program's HLO: a
kernel event carries its HLO instruction name, and that instruction's
metadata op_name carries the jax.named_scope path. XLA replays most of the
solve's kernels as CUDA graphs, which the trace shows as opaque
`command_buffer` events; --no-command-buffer turns them off
(XLA_FLAGS=--xla_gpu_enable_command_buffer=) so every kernel, and so every
scope, is visible — at some cost in launch overhead, which the warm wall
times of that run include.

It also times each op per call in isolation (`micro`): R data-dependent
calls in one jitted fori_loop at the solver's city10000 shapes, minus the
same loop without the op, over R.

Variants of the chain smoother's tridiagonal solve:
  scan  the associative-scan solve (mac_tpu.ops.tridiag, the default);
  gtsv  jax.lax.linalg.tridiagonal_solve on the matrix the LDL^T factor
        represents (cuSPARSE gtsv2 on the GPU).
Warm wall times of the variants are taken interleaved in one process.

Writes DIR/summary.json (default chiprun_out/profile; with --keep-raw also
the raw traces and HLO text) and prints the summary.
"""

import argparse
import json
import re
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SCOPES = ("chain_solve", "assemble_bd")


def gtsv_solve_factored(f, B):
    """Chain solve through jax.lax.linalg.tridiagonal_solve: rebuild the
    tridiagonal T = L diag(dp) L^T the factor represents (so segment-
    decoupled factors keep their dropped couplings) and solve it."""
    import jax
    import jax.numpy as jnp

    with jax.named_scope("chain_solve"):
        dprev = jnp.concatenate([jnp.zeros((1,), f.dp.dtype), f.dp[:-1]])
        d = f.dp + f.l * f.l * dprev
        e = f.l * dprev  # e[i] = T[i, i-1]; e[0] = 0
        du = jnp.concatenate([e[1:], jnp.zeros((1,), e.dtype)])
        return jax.lax.linalg.tridiagonal_solve(
            e.astype(B.dtype), d.astype(B.dtype), du.astype(B.dtype), B)


def hlo_scope_map(hlo_text: str) -> dict:
    """HLO instruction name -> metadata op_name, from compiled HLO text."""
    out = {}
    for m in re.finditer(
            r"^\s*(?:ROOT\s+)?(%?[\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"",
            hlo_text, re.M):
        out[m.group(1).lstrip("%")] = m.group(2)
    return out


def reduce_trace(xplane: Path, scope_of: dict) -> dict:
    """Device busy time, per-scope device time and top kernels from one
    .xplane.pb file."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(str(xplane))
    intervals = []
    per_kernel = defaultdict(lambda: [0, 0])  # name -> [ns, count]
    per_scope = defaultdict(lambda: defaultdict(int))  # scope -> name -> n
    scope_ns = defaultdict(int)
    planes = {}
    for plane in pd.planes:
        lines = list(plane.lines)
        planes[plane.name] = [ln.name for ln in lines]
        if "/device:GPU" not in plane.name:
            continue
        # Kernel timelines are the per-stream lines; the module/op summary
        # lines repeat the same time and would double-count it.
        streams = [ln for ln in lines if "stream" in ln.name.lower()]
        for line in streams or lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = str(stats.get("hlo_op", ev.name))
                ns = int(ev.duration_ns)
                intervals.append((int(ev.start_ns), int(ev.start_ns) + ns))
                k = per_kernel[op]
                k[0] += ns
                k[1] += 1
                path = scope_of.get(op, "") + " " + str(
                    stats.get("tf_op", "")) + " " + str(
                    stats.get("long_name", ""))
                for s in SCOPES:
                    if s in path:
                        scope_ns[s] += ns
                        per_scope[s][op] += 1
                        break
    intervals.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (intervals[-1][1] - intervals[0][0]) if intervals else 0
    scopes = {}
    for s in SCOPES:
        counts = per_scope[s]
        scopes[s] = dict(
            device_ns=scope_ns[s], kernels=sum(counts.values()),
            kernel_counts=dict(counts),
            share_of_busy=(scope_ns[s] / busy) if busy else None)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    return dict(planes=planes, device_busy_ns=busy, device_span_ns=span,
                idle_share_of_span=(1 - busy / span) if span else None,
                kernel_events=len(intervals), scopes=scopes,
                top_kernels=[dict(op=o, ns=v[0], count=v[1],
                                  scope=scope_of.get(o, ""))
                             for o, (v) in top])


def build(variant: str):
    """MAC for city10000 compiled with the given chain-solve variant."""
    from mac_tpu.ops import tridiag
    from mac_tpu.slam.pose_graph import read_g2o_file, rpm_to_mac, split_edges
    from mac_tpu.solvers import MAC, NaiveGreedy

    measurements, n = read_g2o_file(str(REPO / "data" / "city10000.g2o"))
    fixed, cands = split_edges(rpm_to_mac(measurements))
    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)
    mac = MAC(fixed, cands, n)
    assert mac._banded is not None, "expected the banded route"
    calls = []
    real = mac._fw_jit

    def recording(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    mac._fw_jit = recording
    scan = tridiag.tridiag_solve_factored
    if variant == "gtsv":
        tridiag.tridiag_solve_factored = gtsv_solve_factored
    try:
        t0 = time.perf_counter()
        mac.solve(k, x_init, use_cache=True)  # compiles under the variant
        cold = time.perf_counter() - t0
        a, kw = calls[0]
        hlo = real.lower(*a, **kw).compile().as_text()
    finally:
        tridiag.tridiag_solve_factored = scan
    mac._fw_jit = real
    return mac, k, x_init, cold, hlo


def _per_call(fn, base, x0, reps: int = 200) -> float:
    """Seconds per call of `fn` in a data-dependent jitted loop, minus the
    same loop running `base` (the loop's own glue), over `reps`."""
    import jax

    def timed(f):
        loop = jax.jit(lambda x: jax.lax.fori_loop(
            0, reps, lambda i, y: f(y), x))
        jax.block_until_ready(loop(x0))
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(loop(x0))
            best = min(best, time.perf_counter() - t0)
        return best

    return (timed(fn) - timed(base)) / reps


def micro(mac) -> dict:
    """Per-call device time of the chain solve (scan and gtsv, on the
    solver's blocked factor at (n, q) = (10000, 4)) and of the banded
    assembly, at the city10000 shapes of `mac`."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mac_tpu.ops import banded, tridiag
    from mac_tpu.ops.parity import _spd_chain

    n, q = mac.num_nodes, mac._q
    d, e = _spd_chain(n, 0)
    f = tridiag.tridiag_ldl_blocked(jnp.asarray(d, jnp.float32),
                                    jnp.asarray(e, jnp.float32),
                                    block=banded.CHAIN_LDL_BLOCK)
    B0 = jnp.asarray(np.random.RandomState(0).normal(size=(n, q)),
                     jnp.float32)
    norm = lambda X: X / jnp.max(jnp.abs(X))
    out = {}
    for name, solve in (("chain_solve_scan", tridiag.tridiag_solve_factored),
                        ("chain_solve_gtsv", gtsv_solve_factored)):
        out[name + "_us"] = 1e6 * _per_call(
            lambda B, s=solve: norm(s(f, B)), norm, B0)
    bop = mac._banded
    w0 = jnp.asarray(mac._w_all(mac._params, jnp.full(
        (len(mac.weights),), 0.5, jnp.float32)))

    def asm(w):
        BD = jax.lax.optimization_barrier(banded.assemble_bd(bop, w))
        return w + 1e-9 * (BD.deg[0, 0] + BD.ut[0, 0, 0, 1])

    out["assemble_bd_us"] = 1e6 * _per_call(
        asm, lambda w: w + 1e-9 * w[0], w0)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "profile"))
    ap.add_argument("--variants", default="scan,gtsv")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--keep-raw", action="store_true",
                    help="keep the raw traces and HLO text under --out")
    ap.add_argument("--no-command-buffer", action="store_true",
                    help="disable XLA's CUDA-graph command buffers so the "
                         "trace shows every kernel")
    args = ap.parse_args()
    if args.no_command_buffer:
        import os

        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax
    import numpy as np

    from mac_tpu.utils.fiedler import scipy_lam2

    if jax.default_backend() != "gpu":
        sys.exit(f"profile_trace: backend {jax.default_backend()!r} is not "
                 "'gpu'; device metrics come only from the card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    variants = args.variants.split(",")
    built = {v: build(v) for v in variants}
    summary = dict(card=card.strip(), device_kind=jax.devices()[0].device_kind,
                   command_buffer=not args.no_command_buffer,
                   micro=micro(built[variants[0]][0]), variants={})
    walls = {v: [] for v in variants}
    for _ in range(args.reps):  # interleaved warm walls, profiler off
        for v in variants:
            mac, k, x_init, _, _ = built[v]
            t0 = time.perf_counter()
            mac.solve(k, x_init, use_cache=True)
            walls[v].append(time.perf_counter() - t0)
    for v in variants:
        mac, k, x_init, cold, hlo = built[v]
        if args.keep_raw:
            (out / f"fw_hlo_{v}.txt").write_text(hlo)
        tdir = out / f"trace_{v}"
        t0 = time.perf_counter()
        rounded, unrounded, _ = mac.solve(k, x_init, use_cache=True,
                                          profile_dir=str(tdir))
        traced_wall = time.perf_counter() - t0
        xplanes = sorted(tdir.glob("plugins/profile/*/*.xplane.pb"))
        red = reduce_trace(xplanes[-1], hlo_scope_map(hlo))
        lam2 = scipy_lam2(mac.laplacian(np.asarray(unrounded)))
        red.update(
            cold_s=cold, warm_s=walls[v],
            warm_median_s=statistics.median(walls[v]),
            traced_wall_s=traced_wall,
            relaxed_lam2=lam2, stats=mac.last_solve_stats)
        summary["variants"][v] = red
        if not args.keep_raw:
            import shutil

            shutil.rmtree(tdir, ignore_errors=True)
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    brief = {v: dict(warm_median_s=r["warm_median_s"],
                     warm_s=[round(t, 4) for t in r["warm_s"]],
                     traced_wall_s=round(r["traced_wall_s"], 4),
                     device_busy_ms=r["device_busy_ns"] / 1e6,
                     device_span_ms=r["device_span_ns"] / 1e6,
                     idle_share_of_span=r["idle_share_of_span"],
                     relaxed_lam2=r["relaxed_lam2"], scopes=r["scopes"],
                     top5=r["top_kernels"][:5])
             for v, r in summary["variants"].items()}
    print(json.dumps(dict(card=summary["card"],
                          command_buffer=summary["command_buffer"],
                          micro=summary["micro"], variants=brief), indent=1))


if __name__ == "__main__":
    main()
