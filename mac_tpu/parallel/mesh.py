"""Device-mesh helpers for multi-chip execution.

The reference has no distributed code of any form (SURVEY.md §2.3); the
scale axes for this problem are graph size (nodes n, candidate edges m) and
sweep width (budgets K, rounding trials). The device mapping:

  * 'graph' axis: shard the node dimension of the eigenvector block and the
    row-blocks of the ELL adjacency tables; Laplacian products compute on
    row shards, inner products reduce with `psum` across devices.
  * 'sweep' axis: embarrassingly parallel budget sweeps / Madow rounding
    trials / datasets (data-parallel analogue).

Meshes are standard `jax.sharding.Mesh` objects; everything composes with
`shard_map` / `pjit`.
"""

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_graph: Optional[int] = None,
    n_sweep: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('sweep', 'graph') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_graph is None:
        n_graph = len(devices) // n_sweep
    assert n_sweep * n_graph <= len(devices), (
        f"mesh {n_sweep}x{n_graph} needs {n_sweep * n_graph} devices, "
        f"have {len(devices)}"
    )
    dev = np.array(devices[: n_sweep * n_graph]).reshape(n_sweep, n_graph)
    return Mesh(dev, axis_names=("sweep", "graph"))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad `axis` of x up to a multiple of `multiple` (static host-side)."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x, size
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return np.pad(x, pad, constant_values=fill), size


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("graph"))


def sweep_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("sweep"))
