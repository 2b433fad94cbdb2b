"""ctypes bindings for the native (C/C++) runtime components.

Native pieces (built from native/ with `make -C native`):
  * g2o parser — the data-loader hot path (the reference parses g2o in
    Python line-by-line, examples/pose_graph_utils.py:228-351).
  * lazy-greedy k-ESP+ selection core over the Gram matrix — the
    host-sequential inner loop of GreedyESP (reference equivalent drives
    CHOLMOD updates from Python, mac/solvers/greedy_esp.py:183-268).

`lib()` runs `make -C native` once per process before loading, so the
library is always (re)built from the committed sources on the machine that
loads it; make is a no-op when it is up to date. Everything degrades
gracefully: `lib()` returns None when the build fails and callers fall
back to pure Python/numpy. Set MAC_TPU_NO_NATIVE=1 to force the fallback.
"""

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SO = _NATIVE_DIR / "libmac_native.so"
_lib = None
_tried = False


def build(quiet: bool = True) -> bool:
    """Build (or confirm up to date) the shared library in-tree; returns
    success. Serialized across processes by a file lock, so concurrent
    first uses (parallel test workers) never load a half-linked file."""
    import fcntl

    try:
        with open(_NATIVE_DIR / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=quiet,
            )
        return _SO.exists()
    except Exception:
        return False


def lib() -> Optional[ctypes.CDLL]:
    """Build on first use in this process, then load the native library."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if os.environ.get("MAC_TPU_NO_NATIVE"):
        return None
    if not build():
        return None
    try:
        L = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    L.g2o_count_se2.restype = ctypes.c_long
    L.g2o_count_se2.argtypes = [ctypes.c_char_p]
    L.g2o_count_se3.restype = ctypes.c_long
    L.g2o_count_se3.argtypes = [ctypes.c_char_p]
    L.g2o_parse.restype = ctypes.c_long
    L.g2o_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
    ]
    L.esp_lazy_select.restype = ctypes.c_int
    L.esp_lazy_select.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    fn = getattr(L, "esp_lazy_select_chain", None)
    if fn is not None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
    for name, zptr in (("esp_lazy_select_zd", ctypes.POINTER(ctypes.c_double)),
                       ("esp_lazy_select_zf", ctypes.POINTER(ctypes.c_float))):
        fn = getattr(L, name, None)
        if fn is None:
            continue
        fn.restype = ctypes.c_int
        fn.argtypes = [
            zptr, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
    _lib = L
    return _lib


def g2o_parse_arrays(path: str):
    """Native g2o parse: returns (se2 (n,11) f64, se3 (n,30) f64) or None."""
    L = lib()
    if L is None:
        return None
    p = str(path).encode()
    n2 = L.g2o_count_se2(p)
    n3 = L.g2o_count_se3(p)
    if n2 < 0 or n3 < 0:
        return None
    se2 = np.zeros((max(n2, 1), 11), dtype=np.float64)
    se3 = np.zeros((max(n3, 1), 30), dtype=np.float64)
    rc = L.g2o_parse(
        p,
        se2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n2,
        se3.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n3,
    )
    if rc < 0:
        return None
    return se2[:n2], se3[:n3]


def esp_lazy_select_chain(rcum: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                          w: np.ndarray, ks) -> Optional[np.ndarray]:
    """Native lazy-greedy selection with closed-form chain Gram entries
    (overlap cumulative resistances — see native/esp_lazy.cc). Returns the
    (kmax,) selection order, or None when the library is unavailable."""
    L = lib()
    if L is None or getattr(L, "esp_lazy_select_chain", None) is None:
        return None
    rcum = np.ascontiguousarray(rcum, dtype=np.float64)
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    ks_arr = np.ascontiguousarray(ks, dtype=np.int64)
    order = np.zeros(int(ks_arr[-1]), dtype=np.int64)
    rc = L.esp_lazy_select_chain(
        rcum.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(lo),
        ks_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ks_arr),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return order


def esp_lazy_select_z(Z: np.ndarray, u: np.ndarray, v: np.ndarray,
                      w: np.ndarray, ks) -> Optional[np.ndarray]:
    """Native lazy-greedy selection with on-demand Gram entries from the
    solve matrix Z (n, m): G[p, e] = Z[u_p, e] - Z[v_p, e]. Z may be
    float32 or float64 (score algebra is float64 either way). Returns the
    (kmax,) selection order, or None when the native library is missing."""
    L = lib()
    if L is None:
        return None
    if Z.dtype == np.float32:
        fn = getattr(L, "esp_lazy_select_zf", None)
        cptr = ctypes.POINTER(ctypes.c_float)
        Z = np.ascontiguousarray(Z, dtype=np.float32)
    else:
        fn = getattr(L, "esp_lazy_select_zd", None)
        cptr = ctypes.POINTER(ctypes.c_double)
        Z = np.ascontiguousarray(Z, dtype=np.float64)
    if fn is None:
        return None
    u = np.ascontiguousarray(u, dtype=np.int64)
    v = np.ascontiguousarray(v, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    ks_arr = np.ascontiguousarray(ks, dtype=np.int64)
    m = Z.shape[1]
    order = np.zeros(int(ks_arr[-1]), dtype=np.int64)
    rc = fn(
        Z.ctypes.data_as(cptr),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m,
        ks_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ks_arr),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return order


def esp_lazy_select(G: np.ndarray, w: np.ndarray, ks) -> Optional[np.ndarray]:
    """Native lazy-greedy selection; returns the (kmax,) selection order
    or None when the native library is unavailable."""
    L = lib()
    if L is None:
        return None
    G = np.ascontiguousarray(G, dtype=np.float64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    ks_arr = np.ascontiguousarray(ks, dtype=np.int64)
    m = G.shape[0]
    order = np.zeros(int(ks_arr[-1]), dtype=np.int64)
    rc = L.esp_lazy_select(
        G.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m,
        ks_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ks_arr),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return order
