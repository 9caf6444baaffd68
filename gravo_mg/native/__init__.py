"""ctypes loader for the native host-side setup kernels.

Builds ``libgravomg_native.so`` from the committed ``.cpp`` sources on
first use, into ``_build/<hash of the sources>/`` next to this file (a
directory git ignores), so a changed source always gets a fresh library
and a stale one is never loaded.  Every caller has a numpy fallback, so a
missing toolchain only costs setup-time performance; ``status()`` says
which engine is in use and why.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_SRCS = [_HERE / "gravomg_native.cpp", _HERE / "ssp_native.cpp"]
_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_status = "not loaded"


def _source_key() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    """Where the library for the current sources is (or will be) built."""
    return _HERE / "_build" / _source_key() / "libgravomg_native.so"


def _build(so: pathlib.Path) -> str | None:
    """Compile into ``so`` (atomically); returns an error message or None."""
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    errors = []
    for cxx in ("g++", "c++", "clang++"):
        try:
            subprocess.run(
                [cxx, *_FLAGS, *[str(s) for s in _SRCS], "-o", str(tmp)],
                check=True, capture_output=True, timeout=240,
            )
            os.replace(tmp, so)
            return None
        except subprocess.CalledProcessError as e:
            errors.append(f"{cxx}: {e.stderr.decode(errors='replace')[-300:]}")
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{cxx}: {e}")
    return "; ".join(errors)


def status() -> str:
    """"native" when the library is loaded, else why the numpy/jax
    fallbacks are in use."""
    get_lib()
    return _status


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _status
    if _lib is not None:
        return _lib or None
    if os.environ.get("GRAVO_MG_NO_NATIVE") == "1":
        _lib, _status = False, "disabled by GRAVO_MG_NO_NATIVE=1"
        return None
    so = library_path()
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        # One builder at a time (parallel test workers import together);
        # the others wait on the lock and then load its result.
        with open(so.parent / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            err = None if so.exists() else _build(so)
    except OSError as e:
        err = repr(e)
    if err is not None:
        _lib, _status = False, f"build failed: {err}"
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        _lib, _status = False, f"load failed: {e}"
        return None
    lib.unique_i64.restype = ctypes.c_int64
    lib.unique_i64.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.sort_pairs_i64.restype = None
    lib.sort_pairs_i64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.shuffle_layout.restype = ctypes.c_int64
    lib.shuffle_layout.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.disk_sample.restype = None
    lib.disk_sample.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.disk_sample_ord.restype = None
    lib.disk_sample_ord.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.dijkstra_cluster.restype = None
    lib.dijkstra_cluster.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.fps_graph.restype = ctypes.c_int64
    lib.fps_graph.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.prolongation_weights_native.restype = None
    lib.prolongation_weights_native.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ssp_decimate.restype = ctypes.c_int64
    lib.ssp_decimate.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib, _status = lib, "native"
    return lib


def unique_i64(keys: np.ndarray):
    """Sorted unique values of an int64 array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = keys.shape[0]
    uniq = np.empty(max(n, 1), dtype=np.int64)
    m = lib.unique_i64(keys.ctypes.data, n, uniq.ctypes.data)
    return uniq[:m].copy()


def shuffle_layout(rows: np.ndarray, cols: np.ndarray, S: int, kc: int,
                   kp_cap: int):
    """(kp, q, flat_pos) shuffle-ELL slot assignment, or None.

    ``q`` is returned as (kp, S) int32 (trimmed from the kp_cap
    capacity buffer); ``flat_pos`` as (nnz,) int64.
    """
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = rows.shape[0]
    kp_cap = max(int(kp_cap), int(kc))
    q = np.zeros((kp_cap, int(S)), dtype=np.int32)
    flat_pos = np.empty(nnz, dtype=np.int64)
    kp = lib.shuffle_layout(
        rows.ctypes.data, cols.ctypes.data, nnz, int(S), int(kc), kp_cap,
        q.ctypes.data, flat_pos.ctypes.data,
    )
    if kp < 0:
        return None
    kp = int(kp)
    if kp > kp_cap:
        # The native kernel pads kp up to a multiple of kc, which may
        # exceed the true-slot capacity bound; the extra rows are zeros.
        q = np.concatenate([q, np.zeros((kp - kp_cap, int(S)), np.int32)])
        return kp, q, flat_pos
    return kp, q[:kp].copy(), flat_pos


def disk_sample_native(neigh: np.ndarray, dist: np.ndarray, radius: float,
                       two_ring: bool, status: np.ndarray,
                       order: np.ndarray | None = None):
    """Greedy disk sampling (in-place on ``status``); returns False if the
    native library is unavailable.  ``order`` optionally sets the visit
    order (default: index order, the reference's sweep)."""
    lib = get_lib()
    if lib is None:
        return False
    neigh = np.ascontiguousarray(neigh, dtype=np.int32)
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    n, k = neigh.shape
    assert status.dtype == np.int8 and status.flags.c_contiguous
    if order is None:
        lib.disk_sample(
            neigh.ctypes.data, dist.ctypes.data, n, k,
            ctypes.c_float(float(radius)), int(bool(two_ring)),
            status.ctypes.data,
        )
    else:
        order = np.ascontiguousarray(order, dtype=np.int32)
        assert order.shape[0] == n
        lib.disk_sample_ord(
            neigh.ctypes.data, dist.ctypes.data, n, k,
            ctypes.c_float(float(radius)), int(bool(two_ring)),
            order.ctypes.data, status.ctypes.data,
        )
    return True


def dijkstra_cluster_native(neigh: np.ndarray, dist: np.ndarray,
                            samples: np.ndarray):
    """(labels, D) exact multi-source Dijkstra, or None."""
    lib = get_lib()
    if lib is None:
        return None
    neigh = np.ascontiguousarray(neigh, dtype=np.int32)
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    samples = np.ascontiguousarray(samples, dtype=np.int32)
    n, k = neigh.shape
    label = np.empty(n, dtype=np.int32)
    D = np.empty(n, dtype=np.float32)
    lib.dijkstra_cluster(
        neigh.ctypes.data, dist.ctypes.data, n, k,
        samples.ctypes.data, samples.shape[0],
        label.ctypes.data, D.ctypes.data,
    )
    return label, D


def fps_graph_native(neigh: np.ndarray, dist: np.ndarray, target: int,
                     start: int = 0):
    """Graph farthest-point sample indices (unsorted), or None."""
    lib = get_lib()
    if lib is None:
        return None
    neigh = np.ascontiguousarray(neigh, dtype=np.int32)
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    n, k = neigh.shape
    target = min(int(target), n)
    samples = np.empty(max(target, 1), dtype=np.int32)
    m = lib.fps_graph(
        neigh.ctypes.data, dist.ctypes.data, n, k, target,
        np.int32(start), samples.ctypes.data,
    )
    return samples[:m].copy()


def ssp_decimate_native(V: np.ndarray, F: np.ndarray, target_nv: int,
                        dec_type: int):
    """Intrinsic-prolongation edge-collapse decimation (ssp_native.cpp).

    Returns ``(Vc, Fc, P_cols (nv,3) int64, P_w (nv,3) f64, alive bool)``
    — the coarse mesh plus per-fine-vertex coarse triangle corners and
    barycentric weights from the joint-LSCM collapse replay — or None if
    the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    V = np.ascontiguousarray(V, dtype=np.float64)
    F = np.ascontiguousarray(F, dtype=np.int64)
    nv, nf = V.shape[0], F.shape[0]
    Vc = np.empty((nv, 3), np.float64)
    Fc = np.empty((max(nf, 1), 3), np.int64)
    nfc = np.zeros(1, np.int64)
    P_cols = np.empty((nv, 3), np.int64)
    P_w = np.empty((nv, 3), np.float64)
    alive = np.empty(nv, np.int8)
    nc = lib.ssp_decimate(
        V.ctypes.data, nv, F.ctypes.data, nf, int(target_nv), int(dec_type),
        Vc.ctypes.data, Fc.ctypes.data, nfc.ctypes.data,
        P_cols.ctypes.data, P_w.ctypes.data, alive.ctypes.data,
    )
    if nc <= 0:
        return None
    return (
        Vc[:nc].copy(), Fc[: int(nfc[0])].copy(), P_cols, P_w,
        alive.astype(bool),
    )


def prolongation_weights_cpp(fine_pos, labels, coarse_pos, coarse_neigh,
                             check_voronoi: bool, nested: bool, samples,
                             weighting: int):
    """(cols (n,3) i32, w (n,3) f32, stats (3,) i64) or None.

    OpenMP port of the triangle-selection weight sweep (see
    hierarchy/prolongation.py for the semantics and the reference map)."""
    lib = get_lib()
    if lib is None:
        return None
    fine_pos = np.ascontiguousarray(fine_pos, dtype=np.float64)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    coarse_pos = np.ascontiguousarray(coarse_pos, dtype=np.float64)
    coarse_neigh = np.ascontiguousarray(coarse_neigh, dtype=np.int32)
    n = fine_pos.shape[0]
    nc, kc = coarse_neigh.shape
    if samples is None:
        samples = np.full(nc, -1, dtype=np.int32)
    samples = np.ascontiguousarray(samples, dtype=np.int32)
    member_idx = np.argsort(labels, kind="stable").astype(np.int32)
    counts = np.bincount(labels, minlength=nc)
    member_start = np.zeros(nc + 1, dtype=np.int32)
    member_start[1:] = np.cumsum(counts)
    out_cols = np.empty((n, 3), dtype=np.int32)
    out_w = np.empty((n, 3), dtype=np.float32)
    stats = np.zeros(3, dtype=np.int64)
    lib.prolongation_weights_native(
        fine_pos.ctypes.data, n, labels.ctypes.data,
        coarse_pos.ctypes.data, nc, coarse_neigh.ctypes.data, kc,
        int(bool(check_voronoi)), int(bool(nested)), samples.ctypes.data,
        member_start.ctypes.data, member_idx.ctypes.data,
        int(weighting), out_cols.ctypes.data, out_w.ctypes.data,
        stats.ctypes.data,
    )
    return out_cols, out_w, stats


def argsort_i64(keys: np.ndarray):
    """(sorted, order) by radix sort, or None.  keys must be >= 0."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = keys.shape[0]
    if n == 0:
        return keys.copy(), np.zeros(0, dtype=np.int64)
    sorted_k = np.empty(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    lib.sort_pairs_i64(
        keys.ctypes.data, n, int(keys.max()), sorted_k.ctypes.data,
        order.ctypes.data,
    )
    return sorted_k, order
