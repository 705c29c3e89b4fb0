"""Zarr store targets, mirroring ``nutpie.zarr_store`` (reference
``sample.py:472-478`` exposing pyo3-object_store's Local/S3/GCS/Azure/HTTP
stores, concurrency-capped via ``LimitStore::new(store, 8)``,
``src/wrapper.rs:1028-1038``).

Every store builds a byte transport (``transport.py``) that the streaming
Zarr writer targets: ``LocalStore`` writes the filesystem through the
native C++ async pool, ``MemoryStore`` an in-memory mapping, and the
object-store classes go through the optional ``obstore`` package (the
tests exercise only their constructors, which raise without it).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LocalStore:
    """Local filesystem zarr store."""

    path: str

    def writer_root(self) -> Path:
        root = Path(self.path)
        root.mkdir(parents=True, exist_ok=True)
        return root

    def transport(self):
        from .transport import FileTransport

        return FileTransport(self.writer_root())


class MemoryStore:
    """In-memory zarr store (tests; template for custom transports).

    ``mapping`` holds key -> bytes exactly as an object store would; read
    the result back with ``zarr_writer.read_zarr_array(store, key)``.
    """

    def __init__(self, mapping: Optional[dict] = None):
        self.mapping = mapping if mapping is not None else {}

    def transport(self):
        from .transport import MemoryTransport

        return MemoryTransport(self.mapping)


class _ObstoreBacked:
    """Object-store targets through the optional ``obstore`` package.

    Constructor arguments are forwarded verbatim to the matching
    ``obstore.store`` class (S3Store/GCSStore/AzureStore/HTTPStore), so
    bucket/config/credential handling follows obstore's documentation --
    the same object_store semantics the reference binds through
    ``pyo3_object_store``.
    """

    _name = ""

    def __init__(self, *args, **kwargs):
        try:
            import obstore  # noqa: F401
        except ImportError as err:
            raise ImportError(
                f"{self._name} requires the optional 'obstore' package for "
                f"object-store IO"
            ) from err
        self._args = args
        self._kwargs = kwargs

    def _obstore_store(self):
        import obstore.store as os_store

        cls = getattr(os_store, self._name)
        return cls(*self._args, **self._kwargs)

    def transport(self):
        from .transport import ObstoreTransport

        return ObstoreTransport(self._obstore_store(), max_workers=8)


class S3Store(_ObstoreBacked):
    _name = "S3Store"


class GCSStore(_ObstoreBacked):
    _name = "GCSStore"


class AzureStore(_ObstoreBacked):
    _name = "AzureStore"


class HTTPStore(_ObstoreBacked):
    _name = "HTTPStore"
