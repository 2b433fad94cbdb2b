"""mac_tpu — accelerator-native algebraic-connectivity graph sparsification.

A from-scratch JAX/XLA re-design of the capabilities of
MarineRoboticsGroup/mac (maximum algebraic connectivity graph augmentation):
select K candidate edges maximizing lambda_2 of the weighted graph Laplacian,
via a Frank-Wolfe relaxation with a Fiedler-pair oracle, plus greedy
baselines (NaiveGreedy, GreedyEig, GreedyESP) and a pose-graph SLAM
evaluation harness.

Design notes (accelerator-first, not a port):
  * The Fiedler-pair oracle is a jitted, warm-started, preconditioned block
    eigensolver (LOBPCG) over matrix-free Laplacian operators — replacing the
    reference's SuperLU/CHOLMOD-backed TRACEMIN (mac/utils/fiedler.py,
    mac/utils/cholesky.py in the reference).
  * Laplacian products use either a dense matmul path for small graphs or a padded-adjacency (ELL) gather path for large graphs;
    no scipy sparse matrices on the compute path.
  * The whole Frank-Wolfe solve is one `lax.while_loop` under `jit` with the
    eigenvector block threaded through the carry (the reference's warm-start
    cache, implemented so it actually engages).
  * GreedyESP's incremental sparse-Cholesky effective resistances are
    re-derived through the Woodbury identity over a candidate Gram matrix:
    one batched multi-RHS CG solve + matmuls instead of factor updates.

Canonical imports mirror the reference (`from mac.solvers import MAC`):

    from mac_tpu.solvers import MAC, NaiveGreedy
"""

import jax as _jax

# Mixed-precision design: bulk O(n) eigensolver work runs in the device
# compute dtype (float32 on accelerators), but the small Rayleigh-Ritz coefficient
# problems (Gram matrices, 2qx2q eigh/cholesky) run in float64 — without
# this, eigenvalue separation at the float32 Gram level floors convergence
# (see mac_tpu.ops.lobpcg). float64 must be *available*, hence x64 is
# enabled at import; default compute dtypes remain backend-aware
# (mac_tpu.utils.fiedler.default_dtype: float32 on accelerators, float64 on CPU).
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: solve programs are large (compiles take
# tens of seconds) and identical across processes, so fresh-process cold
# starts (benchmarks, CLIs, test re-runs) should compile-hit on disk.
# Honors an explicit JAX_COMPILATION_CACHE_DIR (JAX reads it itself);
# otherwise the fixed repo-local .jax_cache/ when writable; never fatal.
import os as _os

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    try:
        _cache_dir = _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache")
        _os.makedirs(_cache_dir, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", _cache_dir)
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass

from mac_tpu.utils.graphs import Edge
from mac_tpu.solvers import MAC, NaiveGreedy

__version__ = "0.1.0"

__all__ = ["Edge", "MAC", "NaiveGreedy", "__version__"]
