"""Native (C++) host-side components, consumed via ctypes — the port's own
copy of ``sentio_tpu/native``.

``load_bm25()`` returns the ctypes library of the BM25 scoring core
(``bm25.cpp``), building it with ``g++`` on first use, or None when no
toolchain can build it: every caller then scores with numpy, so the package
never requires a compiler. This is host code, not a device kernel.

The library goes into the checkout's ``build/`` directory, named by a hash
of the source and flags (an edited source rebuilds). It is compiled for the
baseline of the host's architecture, without ``-march=native``, so a
library carried to another host never meets an illegal instruction, and
with ``-ffp-contract=off``, so no fused multiply-add changes the last bit
of a score against the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_SRC_DIR = Path(__file__).parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")
_LOCK = threading.Lock()
_CACHE: dict[str, Optional[ctypes.CDLL]] = {}


def _library_path(name: str) -> Path:
    src = _SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build(name: str) -> Optional[Path]:
    out = _library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a per-process temp name and os.replace into place: the
    # in-process _LOCK cannot serialize concurrent *processes* (pytest-xdist
    # workers on a fresh checkout), and dlopen on a half-written .so fails
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.so")
    cmd = ["g++", *GXX_FLAGS, str(_SRC_DIR / f"{name}.cpp"), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            logger.warning("native %s build failed:\n%s", name, proc.stderr[-2000:])
            return None
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired) as exc:
        logger.warning("native %s build skipped: %s", name, exc)
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load(name: str) -> Optional[ctypes.CDLL]:
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        lib: Optional[ctypes.CDLL] = None
        path = _build(name)
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                logger.warning("native %s load failed: %s", name, exc)
        _CACHE[name] = lib
        return lib


def load_bm25() -> Optional[ctypes.CDLL]:
    """The BM25 scoring core (native/bm25.cpp), with argtypes configured."""
    lib = _load("bm25")
    if lib is None or getattr(lib, "_sbm25_configured", False):
        return lib
    c = ctypes
    i32p, i64p, f32p = (c.POINTER(c.c_int32), c.POINTER(c.c_int64), c.POINTER(c.c_float))
    lib.sbm25_create.restype = c.c_void_p
    lib.sbm25_create.argtypes = [c.c_int32, c.c_int32, i64p, i32p, f32p, f32p,
                                 f32p, c.c_float, c.c_float]
    lib.sbm25_destroy.argtypes = [c.c_void_p]
    lib.sbm25_scores.argtypes = [c.c_void_p, i32p, c.c_int32, f32p]
    lib.sbm25_search.restype = c.c_int32
    lib.sbm25_search.argtypes = [c.c_void_p, i32p, c.c_int32, c.c_int32, i32p, f32p]
    lib.sbm25_version.restype = c.c_int32
    lib._sbm25_configured = True
    return lib
