"""chip_smoke.py's comparison helpers, on the CPU at a small size."""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_permuted_candidates_map_back_to_the_same_readings():
    """A MAC built on permuted candidates, read through f32_readings with
    the permutation, gives the unpermuted MAC's first-solve gradient in the
    original candidate order (float64 here, so only rounding differs)."""
    from mac_tpu.ops import parity
    from mac_tpu.solvers import MAC, NaiveGreedy
    from mac_tpu.utils.graphs import Edge

    n = 300
    idx, w = parity.chain_pose_graph(n, 150, 20, seed=4)
    edges = [Edge(int(i), int(j), float(x)) for (i, j), x in zip(idx, w)]
    fixed, cands = edges[:n - 1], edges[n - 1:]
    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)

    base = chip_smoke.f32_readings(
        MAC(fixed, cands, n, use_banded=False), k, x_init)
    pc, perm = chip_smoke.permute_candidates(cands, 1)
    assert sorted(perm.tolist()) == list(range(len(cands)))
    assert perm.tolist() != list(range(len(cands)))
    got = chip_smoke.f32_readings(
        MAC(fixed, pc, n, use_banded=False), k, x_init, perm=perm)

    d = chip_smoke.f32_diffs(base, got, k)
    assert d["lam0"] < 1e-8 and d["grad"] < 1e-6, d
    assert d["topk_flips"] == 0 and d["lam2"] < 1e-6, d
    assert base["rsum"] == got["rsum"] == k
    # Without the mapping, the gradients would not line up.
    assert chip_smoke.rel_diff(base["grad"], got["grad"][perm]) > 1e-2
