"""ctypes binding to the native (C++) async chunk writer.

Builds ``_writer.cpp`` with ``g++`` at first use into
``nutpie_tpu_torch/_build/`` under a name that carries the hash of the
source and the flags (as ``ops/build.py`` does for the kernels), never next
to the source; an unchanged source loads at once.  The native path releases
the GIL for compression and disk IO, the role of the reference's tokio
writer pool.  ``FileTransport`` writes through a Python thread pool instead
when the build or the load fails; that is host IO, not a device path, and
the transport reports which writer it used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "_writer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")
_BUILD_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS + LIBS).encode())
    return BUILD_DIR / f"libwriter-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``_writer.cpp`` unless an up-to-date library exists."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC), *LIBS],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def _load_library():
    global _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.writer_create.restype = ctypes.c_void_p
        lib.writer_create.argtypes = [ctypes.c_int]
        lib.writer_submit.restype = ctypes.c_int
        lib.writer_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int,
        ]
        lib.writer_flush.restype = None
        lib.writer_flush.argtypes = [ctypes.c_void_p]
        lib.writer_errors.restype = ctypes.c_longlong
        lib.writer_errors.argtypes = [ctypes.c_void_p]
        lib.writer_destroy.restype = None
        lib.writer_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class NativeWriter:
    """Async compressing file writer backed by the C++ thread pool."""

    def __init__(self, n_threads: int = 4):
        self._lib = _load_library()
        self._handle = self._lib.writer_create(n_threads)
        if not self._handle:
            raise RuntimeError("failed to create native writer")

    def submit(self, path: str, data: bytes, level: int = 1) -> None:
        rc = self._lib.writer_submit(
            self._handle, path.encode(), data, len(data), level
        )
        if rc != 0:
            raise RuntimeError("native writer rejected job (shut down?)")

    def flush(self) -> None:
        self._lib.writer_flush(self._handle)

    @property
    def errors(self) -> int:
        return int(self._lib.writer_errors(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.writer_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
