"""Byte transports for the streaming Zarr writer.

The reference streams Zarr chunks through the Rust ``object_store`` crate
(Local/S3/GCS/Azure/HTTP, concurrency-capped via ``LimitStore::new(store,
8)``; the reference's ``src/wrapper.rs:1028-1038``).  Here the writer's
physical IO is a small transport interface so the same layout/chunking
code targets the local filesystem (native C++ async pool), an in-memory
mapping (tests, injectable custom transports), or an ``obstore``-backed
object store.

Keys are ``/``-separated paths relative to the store root, e.g.
``posterior/x/0.3``.
"""

from __future__ import annotations

import subprocess
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional


class FileTransport:
    """Local filesystem writes; compression+IO on the native C++ pool
    (GIL-free, ``_writer.cpp``) with a Python thread-pool fallback."""

    def __init__(self, root, max_workers: int = 4):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._dirs: set = set()
        self._native = None
        try:
            from .native import NativeWriter

            self._native = NativeWriter(max_workers)
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            # no compiler, no zlib headers, or a library that does not load
            self._pool = ThreadPoolExecutor(max_workers=max_workers)
            self._futures: list = []
        # which writer this transport uses: "native" or "threads"
        self.writer = "native" if self._native is not None else "threads"

    def _path(self, key: str) -> Path:
        path = self.root / key
        # one mkdir per directory, not per chunk file (a run writes millions)
        if path.parent not in self._dirs:
            path.parent.mkdir(parents=True, exist_ok=True)
            self._dirs.add(path.parent)
        return path

    def put(self, key: str, data: bytes) -> None:
        self._path(key).write_bytes(data)

    def submit_compressed(self, key: str, raw: bytes, level: int) -> None:
        path = self._path(key)
        if self._native is not None:
            self._native.submit(str(path), raw, level)
        else:
            def work():
                path.write_bytes(zlib.compress(raw, level))

            self._futures.append(self._pool.submit(work))

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self.root / key, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def flush(self) -> None:
        if self._native is not None:
            self._native.flush()
        else:
            for fut in self._futures:
                fut.result()
            self._futures = []

    def close(self) -> None:
        self.flush()
        if self._native is not None:
            self._native.close()
        elif hasattr(self, "_pool"):
            self._pool.shutdown(wait=True)


class MemoryTransport:
    """Dict-backed transport (tests; also the template for custom ones)."""

    def __init__(self, mapping: Optional[dict] = None):
        self.mapping = mapping if mapping is not None else {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self.mapping[key] = bytes(data)

    def submit_compressed(self, key: str, raw: bytes, level: int) -> None:
        self.put(key, zlib.compress(raw, level))

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self.mapping.get(key)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class ObstoreTransport:
    """Object-store transport through the optional ``obstore`` package.

    Compression runs on a Python thread pool (zlib releases the GIL) and
    puts are concurrency-capped at 8 in flight, matching the reference's
    ``LimitStore::new(store, 8)``.
    """

    def __init__(self, obstore_store, max_workers: int = 8):
        import obstore  # noqa: F401  (constructor validated by caller)

        self._store = obstore_store
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._futures: list = []
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        import obstore

        obstore.put(self._store, key, bytes(data))

    def submit_compressed(self, key: str, raw: bytes, level: int) -> None:
        def work():
            self.put(key, zlib.compress(raw, level))

        with self._lock:
            # keep the in-flight queue bounded
            self._futures = [f for f in self._futures if not f.done()]
            fut = self._pool.submit(work)
            self._futures.append(fut)

    def get(self, key: str) -> Optional[bytes]:
        import obstore

        try:
            result = obstore.get(self._store, key)
            return bytes(result.bytes())
        except Exception:
            return None

    def flush(self) -> None:
        with self._lock:
            futures, self._futures = self._futures, []
        for fut in futures:
            fut.result()

    def close(self) -> None:
        self.flush()
        self._pool.shutdown(wait=True)
