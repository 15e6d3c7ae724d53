"""ctypes bindings of the repository's C++ runtime (``native/limo_native.cpp``)
— the counterpart of the reference package's ``limo_tpu/io/native_loader.py``.

The library is built at first use with ``g++`` and the flags of
``native/Makefile`` into ``build/limo_tpu_torch/`` of the checkout, keyed
by the source, the flags and the CPU (``-march=native`` code runs only on
a CPU like the one that built it). The build holds a file lock and writes
to a temporary name before ``os.replace``, so concurrent processes and
threads never load a half-written library. Where ``g++`` is absent the
readers fall back to numpy, as the reference's do; where it is present, a
failed build raises.

``reads`` counts the velodyne scans read through the library and through
numpy.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "limo_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "limo_tpu_torch"
# native/Makefile: CXXFLAGS, then -shared and -lpthread
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared")
LIBS = ("-lpthread",)

reads = {"native": 0, "numpy": 0}

_lib = None                  # the loaded library, or False without g++
_lock = threading.Lock()


def library_path() -> Path:
    """Where the build of this source with these flags for this host's CPU
    lives (the target options ``g++`` resolves ``-march=native`` to are
    part of the key)."""
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True,
                            timeout=60).stdout
    tag = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(CXX_FLAGS + LIBS).encode()
                         + target.encode())
    return _BUILD_DIR / f"liblimo_native-{tag.hexdigest()[:12]}.so"


def _build(so: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "liblimo_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return
        tmp = so.with_name(f"{so.name}.{threading.get_native_id()}.tmp")
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC),
                               *LIBS], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{_SRC}:\n{proc.stdout}{proc.stderr}")
        tmp.replace(so)


def get_lib():
    """The loaded library (built at first use), or None where ``g++`` is
    absent."""
    global _lib
    with _lock:
        if _lib is None:
            if shutil.which("g++") is None:
                _lib = False
            else:
                so = library_path()
                if not so.exists():
                    _build(so)
                _lib = _bind(ctypes.CDLL(str(so)))
        return _lib or None


def _bind(lib):
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_i64_p = ctypes.POINTER(ctypes.c_int64)
    lib.ln_read_velodyne.restype = ctypes.c_int64
    lib.ln_read_velodyne.argtypes = [ctypes.c_char_p, c_float_p,
                                     ctypes.c_int64]
    lib.ln_velodyne_size.restype = ctypes.c_int64
    lib.ln_velodyne_size.argtypes = [ctypes.c_char_p]
    lib.ln_read_velodyne_batch.restype = None
    lib.ln_read_velodyne_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, c_float_p,
        ctypes.c_int64, c_i64_p, ctypes.c_int32]
    lib.ln_tracktable_new.restype = ctypes.c_void_p
    lib.ln_tracktable_new.argtypes = [ctypes.c_int32]
    lib.ln_tracktable_free.restype = None
    lib.ln_tracktable_free.argtypes = [ctypes.c_void_p]
    lib.ln_tracktable_push.restype = None
    lib.ln_tracktable_push.argtypes = [
        ctypes.c_void_p, ctypes.c_double, c_float_p, c_float_p, c_i64_p,
        ctypes.c_int64]
    lib.ln_tracktable_num_tracks.restype = ctypes.c_int64
    lib.ln_tracktable_num_tracks.argtypes = [ctypes.c_void_p]
    lib.ln_tracktable_num_stamps.restype = ctypes.c_int32
    lib.ln_tracktable_num_stamps.argtypes = [ctypes.c_void_p]
    lib.ln_tracktable_export.restype = None
    lib.ln_tracktable_export.argtypes = [
        ctypes.c_void_p, c_float_p, ctypes.POINTER(ctypes.c_uint8), c_i64_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_velodyne(path: str) -> np.ndarray:
    """Velodyne scan: float32 (x, y, z, intensity) quads → [N,4]."""
    lib = get_lib()
    if lib is None:
        reads["numpy"] += 1
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    n = lib.ln_velodyne_size(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    out = np.empty((n, 4), np.float32)
    got = lib.ln_read_velodyne(path.encode(), _ptr(out, ctypes.c_float), n)
    reads["native"] += 1
    return out[:got]


def read_velodyne_batch(paths: List[str], capacity_pts: int,
                        n_threads: int = 0):
    """Threaded batch read → (points [B,capacity,4] zero-padded, counts
    [B])."""
    out = np.zeros((len(paths), capacity_pts, 4), np.float32)
    counts = np.zeros(len(paths), np.int64)
    lib = get_lib()
    if lib is None:
        for i, p in enumerate(paths):
            pts = np.fromfile(p, dtype=np.float32).reshape(-1, 4)
            pts = pts[:capacity_pts]
            out[i, : len(pts)] = pts
            counts[i] = len(pts)
        reads["numpy"] += len(paths)
        return out, counts
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    lib.ln_read_velodyne_batch(arr, len(paths), _ptr(out, ctypes.c_float),
                               capacity_pts, _ptr(counts, ctypes.c_int64),
                               n_threads)
    reads["native"] += len(paths)
    return out, counts


class NativeTrackTable:
    """C++ track table: the fast path of ``pipeline.tracklets.
    TrackletBuilder`` (same pushes, same tracklets)."""

    def __init__(self, max_track_length: int = 100):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable: no g++")
        self._lib = lib
        self._h = lib.ln_tracktable_new(max_track_length)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ln_tracktable_free(self._h)
            self._h = None

    def push_frame(self, stamp: float, uv: np.ndarray,
                   prev_match: Optional[np.ndarray] = None,
                   depth: Optional[np.ndarray] = None) -> None:
        n = uv.shape[0]
        uv32 = np.ascontiguousarray(uv, np.float32)
        if uv32.shape != (n, 2):
            raise ValueError(f"uv must be [N,2], got {uv32.shape}")
        d32 = pm = None
        if depth is not None:
            d32 = np.ascontiguousarray(depth, np.float32)
            if d32.shape != (n,):
                raise ValueError(f"depth must be [{n}], got {d32.shape}")
        if prev_match is not None:
            pm = np.ascontiguousarray(prev_match, np.int64)
            if pm.shape != (n,):
                raise ValueError(f"prev_match must be [{n}], got {pm.shape}")
        self._lib.ln_tracktable_push(
            self._h, float(stamp), _ptr(uv32, ctypes.c_float),
            None if d32 is None else _ptr(d32, ctypes.c_float),
            None if pm is None else _ptr(pm, ctypes.c_int64), n)

    def to_tracklets(self, window: Optional[int] = None):
        from ..pipeline.tracklets import Tracklets

        lib = self._lib
        N = lib.ln_tracktable_num_tracks(self._h)
        S = lib.ln_tracktable_num_stamps(self._h)
        uvd = np.zeros((N, S, 3), np.float32)
        mask = np.zeros((N, S), np.uint8)
        ids = np.zeros(N, np.int64)
        ages = np.zeros(N, np.int32)
        stamps = np.zeros(S, np.float64)
        lib.ln_tracktable_export(
            self._h, _ptr(uvd, ctypes.c_float), _ptr(mask, ctypes.c_uint8),
            _ptr(ids, ctypes.c_int64), _ptr(ages, ctypes.c_int32),
            _ptr(stamps, ctypes.c_double))
        if window is not None and window < S:
            uvd, mask, stamps = uvd[:, :window], mask[:, :window], \
                stamps[:window]
        return Tracklets(stamps=stamps, uvd=uvd.astype(np.float64),
                         mask=mask.astype(bool), ids=ids, age=ages,
                         is_outlier=np.zeros(N, bool),
                         label=np.full(N, -2, np.int32))
