"""Native (C/C++) component tests: g2o parser parity and the ESP lazy
selection core vs the pure-Python implementations."""

import os

import numpy as np
import pytest

from mac_tpu import native


needs_native = pytest.mark.skipif(
    native.lib() is None, reason="native library not built"
)


@needs_native
def test_native_g2o_parse_matches_python(tmp_path):
    f = tmp_path / "mini.g2o"
    f.write_text(
        "VERTEX_SE2 0 0 0 0\n"
        "EDGE_SE2 0 1 1.0 0.25 0.1 100 0 0 100 0 400\n"
        "EDGE_SE2 1 2 0.5 0.5 0.0 50 0 0 50 0 200\n"
        "# comment line\n"
        "EDGE_SE3:QUAT 0 1 1 2 3 0 0 0 1 "
        + " ".join(["4" if i == j else "0" for i in range(6) for j in range(i, 6)])
        + "\n"
    )
    se2, se3 = native.g2o_parse_arrays(str(f))
    assert se2.shape == (2, 11)
    assert se3.shape == (1, 30)
    np.testing.assert_allclose(se2[0], [0, 1, 1.0, 0.25, 0.1, 100, 0, 0, 100, 0, 400])
    np.testing.assert_allclose(se3[0, :9], [0, 1, 1, 2, 3, 0, 0, 0, 1])


@needs_native
def test_native_parse_real_dataset_matches_python_reader(monkeypatch):
    from mac_tpu.slam.pose_graph import read_g2o_file

    meas_native, n_native = read_g2o_file("data/intel.g2o")
    monkeypatch.setenv("MAC_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    meas_py, n_py = read_g2o_file("data/intel.g2o")
    assert n_native == n_py
    assert len(meas_native) == len(meas_py)
    for a, b in zip(meas_native[:50], meas_py[:50]):
        assert a.i == b.i and a.j == b.j
        np.testing.assert_allclose(a.t, b.t)
        np.testing.assert_allclose(a.R, b.R)
        assert np.isclose(a.kappa, b.kappa)
        assert np.isclose(a.tau, b.tau)


@needs_native
def test_native_esp_core_matches_python():
    rng = np.random.RandomState(0)
    m = 40
    A = rng.randn(m, m + 5)
    G = A @ A.T / (m + 5)  # SPD Gram stand-in
    w = 0.5 + rng.rand(m)
    ks = [3, 7, 12]
    order = native.esp_lazy_select(G, w, ks)
    assert order is not None and len(order) == 12

    # Python oracle: eager greedy on the same Woodbury recursion.
    q = np.diag(G).copy()
    U = np.zeros((12, m))
    chosen = []
    avail = np.ones(m, dtype=bool)
    for t in range(12):
        scores = np.where(avail, w * q, -np.inf)
        p = int(np.argmax(scores))
        chosen.append(p)
        avail[p] = False
        denom = 1.0 / w[p] + q[p]
        row = (G[p, :] - U[:t, p] @ U[:t, :]) / np.sqrt(denom)
        U[t, :] = row
        q = q - row * row
    np.testing.assert_array_equal(np.asarray(order), np.asarray(chosen))


def test_lib_runs_make_on_first_use_even_when_built(monkeypatch):
    """A library left on disk by another machine must not be loaded as is:
    the first lib() call in a process always runs `make -C native` (a
    no-op when up to date), then loads."""
    ran = []
    real_run = native.subprocess.run

    def recording_run(cmd, *a, **kw):
        ran.append(list(cmd))
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native.subprocess, "run", recording_run)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("MAC_TPU_NO_NATIVE", raising=False)
    assert native._SO.exists() or native.build()
    ran.clear()
    lib = native.lib()
    assert ran and ran[0][:2] == ["make", "-C"]
    assert lib is not None
