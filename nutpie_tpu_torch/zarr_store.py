"""Zarr store constructors, mirroring ``nutpie.zarr_store``.

``sample(..., zarr_store=nutpie_tpu_torch.zarr_store.LocalStore(path))``
streams the trace as it is sampled.  ``LocalStore`` writes through the
native writer (``storage/native.py``); the object-store backends need
the optional ``obstore`` package.
"""

from .storage.stores import AzureStore, GCSStore, HTTPStore, LocalStore, S3Store

__all__ = ["LocalStore", "S3Store", "GCSStore", "AzureStore", "HTTPStore"]
