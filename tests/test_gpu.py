"""Card-only checks, marked `gpu`: run on an NVIDIA GPU with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

They call the same parity functions as chip_smoke.py's phase 5, at
city10000 widths, plus the headline route. Elsewhere they skip: the
decision is made in a fixture, never at import."""

from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (backend is "
                    f"{jax.default_backend()!r})")


@pytest.fixture
def city():
    from mac_tpu.slam.pose_graph import read_g2o_file, rpm_to_mac, split_edges

    measurements, n = read_g2o_file(str(REPO / "data" / "city10000.g2o"))
    fixed, cands = split_edges(rpm_to_mac(measurements))
    return fixed, cands, n


def _arrays(city):
    from mac_tpu.utils.graphs import edges_to_arrays

    fixed, cands, n = city
    idx, w = edges_to_arrays(fixed + cands)
    return idx, w, n


@pytest.mark.parametrize("precision,tol_key", [
    ("HIGHEST", "banded_apply_highest"), ("DEFAULT", "banded_apply_default")])
def test_banded_apply_parity_city_width(gpu, city, precision, tol_key):
    import jax

    from mac_tpu.ops import parity

    idx, w, n = _arrays(city)
    err = parity.check_banded_apply(
        idx, w, n, q=4, precision=getattr(jax.lax.Precision, precision))
    assert err <= parity.TOL[tol_key], err


def test_assembly_parity_city_width(gpu, city):
    from mac_tpu.ops import parity

    # city10000's own weights are all equal, so every float32 sum would be
    # exact; seeded weights on its topology exercise the summation order.
    idx, _, n = _arrays(city)
    err = parity.check_assembly(idx, parity.seeded_weights(len(idx)), n)
    assert err <= parity.TOL["assembly"], err


@pytest.mark.parametrize("n,block", [(10_000, None), (100_000, 128)])
def test_chain_solve_parity(gpu, n, block):
    from mac_tpu.ops import parity

    err = parity.check_chain_solve(n, q=4, block=block)
    assert err <= parity.TOL["chain_solve"], err


def test_headline_route_is_banded_f32_on_device(gpu, city):
    import jax.numpy as jnp

    from mac_tpu.solvers import MAC

    fixed, cands, n = city
    mac = MAC(fixed, cands, n)
    assert mac._banded is not None
    assert mac.dtype == jnp.float32
    assert mac.fiedler_backend == "device"
