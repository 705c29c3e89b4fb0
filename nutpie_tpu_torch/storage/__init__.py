"""Streaming Zarr storage of traces (the port's own copy of
``nutpie_tpu/storage``: Zarr v2 written by hand, zlib, no ``zarr``
package)."""

from .stores import AzureStore, GCSStore, HTTPStore, LocalStore, S3Store
from .zarr_writer import ZarrTraceWriter

__all__ = [
    "ZarrTraceWriter",
    "LocalStore",
    "S3Store",
    "GCSStore",
    "AzureStore",
    "HTTPStore",
]
