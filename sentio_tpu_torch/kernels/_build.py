"""Build and bind the hand-written CUDA kernels.

Each ``csrc/*.cu`` file exports a plain C launcher. It is compiled with
``nvcc`` for ``sm_90a`` into its own shared library under ``build/`` at the
root of the checkout (named by a hash of the source, the headers it
includes from ``csrc/``, the flags and the kernel's ``-D`` defines, so an
edited source or header rebuilds) and loaded with ``ctypes``. Nothing is built at import:
the first launch builds, or :func:`build_all` builds every kernel with one
``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)
# the calling thread's open launch tally, if any (launch_tally)
_tally = threading.local()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class CudaKernel:
    """One kernel: its source, its C launcher's signature, the ``defines``
    (``NAME=VALUE``) its source is compiled with, and ``launches``, a count
    of successful launches that callers may read and reset. Launches from
    several threads (the services' pumps and their callers) all count:
    :meth:`add_launches` adds under a lock, and also to the calling
    thread's :func:`launch_tally` when one is open."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, defines: Sequence[str] = ()) -> None:
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
        self.launches = 0
        self._count_lock = threading.Lock()
        self.build_log = ""
        self._lib = None
        self._fn = None
        self._err = None

    def sources(self) -> list[Path]:
        """The ``.cu`` file and every header it includes with quotes,
        followed through headers, each once, in the order first met."""
        found, queue = [], [self.source]
        while queue:
            path = queue.pop(0)
            if path in found:
                continue
            found.append(path)
            queue += [path.parent / name
                      for name in _INCLUDE.findall(path.read_text())]
        return found

    @property
    def library(self) -> Path:
        digest = hashlib.sha256()
        for path in self.sources():
            digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
        digest.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.source.stem}-{digest.hexdigest()[:12]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` unless the library is already built."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_name(f"{self.library.stem}.{os.getpid()}.tmp.so")
        return subprocess.Popen(
            [nvcc_path(), *self.flags, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        log, _ = proc.communicate()
        self.build_log = log
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{log}")
        os.replace(tmp, self.library)

    def _load(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.sentio_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn, self._err = lib, fn, err
        return self._fn

    def function(self, symbol: str, argtypes: Sequence):
        """Another C function of the kernel's library (built and loaded on
        first use), returning int."""
        self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def device_launches(self) -> tuple[int, int]:
        """The card's own count of this library's launches since it was
        loaded: (split or flash kernel, paged combine). Each kernel adds one
        from its first thread, so launches from CUDA graph replays count.
        Waits for the device; never reset."""
        counts = (ctypes.c_ulonglong * 2)()
        code = self.function("sentio_device_launches",
                             [ctypes.POINTER(ctypes.c_ulonglong)])(counts)
        if code != 0:
            raise RuntimeError(f"{self.name}: reading the device's launch count failed with "
                               f"error {code} ({self._err(code).decode()})")
        return counts[0], counts[1]

    def launch(self, *args) -> None:
        """Call the C launcher (which launches on the given stream and
        returns ``cudaGetLastError()``); raise on a non-zero code."""
        code = self._load()(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with error {code} "
                f"({self._err(code).decode()})"
            )
        self.add_launches(1)

    def add_launches(self, n: int) -> None:
        with self._count_lock:
            self.launches += n
        tally = getattr(_tally, "counts", None)
        if tally is not None:
            tally[self] = tally.get(self, 0) + n


@contextmanager
def launch_tally():
    """Yield a dict that counts, per kernel, the launches made by THIS
    thread inside the block: what a CUDA graph capture charges to its
    graph while other threads launch on their own streams."""
    outer = getattr(_tally, "counts", None)
    _tally.counts = counts = {}
    try:
        yield counts
    finally:
        _tally.counts = outer


def build_all(kernels: Sequence[CudaKernel]) -> float:
    """Build every kernel in parallel (one nvcc each); returns seconds."""
    t0 = time.perf_counter()
    procs = [(k, k.start_build()) for k in kernels]
    for kernel, proc in procs:
        kernel.finish_build(proc)
    for kernel in kernels:
        kernel._load()
    return time.perf_counter() - t0


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())


def stream_of(tensor) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def refuse_autograd(fn: str, *inputs) -> None:
    """Raise ``RuntimeError`` when autograd would record a kernel call: the
    kernels write into fresh outputs through ctypes, so their result has no
    ``grad_fn`` and a backward pass would silently train nothing upstream
    of them."""
    import torch

    if torch.is_grad_enabled() and any(getattr(x, "requires_grad", False) for x in inputs):
        raise RuntimeError(f"{fn}: the kernel has no backward; call it under torch.no_grad() "
                           "or train through the plain attention (attn_fn=None)")
