"""Dependency-free streaming Zarr v2 writer for traces.

The reference streams draws into Zarr through the Rust ``zarrs`` crate with
a tokio writer pool over ``object_store`` backends (``wrapper.rs:1028-1038``,
chunk size 16 draws).  This module implements the equivalent natively:
trace groups are laid out as a Zarr v2 hierarchy with xarray
``_ARRAY_DIMENSIONS`` metadata, chunked ``(1 chain, chunk_draws, *shape)``,
zlib-compressed, written incrementally as each device chunk lands.  The
result opens with ``xarray.open_datatree(path, engine="zarr")`` /
``zarr.open_group`` -- no zarr-python needed on the writing side.

Physical IO goes through a byte transport (``transport.py``): local
filesystem via the native C++ async pool, in-memory mapping, or an
``obstore`` object store -- the layout/chunking code is transport-agnostic.
"""

from __future__ import annotations

import json
import math
import threading
import zlib
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from .transport import FileTransport


def _dtype_str(dtype: np.dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return "|b1"
    if dtype.kind == "O":
        raise TypeError("object dtype not supported in zarr storage")
    return dtype.str


def _fill_value(dtype: np.dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return "NaN"
    if dtype.kind == "b":
        return False
    if dtype.kind == "U":
        return ""
    return 0


def _as_transport(target):
    if isinstance(target, (str, Path)):
        return FileTransport(target)
    if hasattr(target, "transport"):
        return target.transport()
    if hasattr(target, "submit_compressed"):
        return target
    raise TypeError(
        f"cannot build a zarr transport from {type(target).__name__}"
    )


class ZarrTraceWriter:
    """Streams one sampling run into a Zarr v2 hierarchy on a transport."""

    def __init__(self, target, *, compress_level: int = 1):
        self._t = _as_transport(target)
        self._level = compress_level
        self._arrays: dict[str, dict] = {}
        self._meta_docs: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._write_json("", ".zgroup", {"zarr_format": 2})

    # kept for LocalStore callers that reopen the directory afterwards
    @property
    def root(self) -> Optional[Path]:
        return getattr(self._t, "root", None)

    @property
    def writer(self) -> str:
        """The transport's writer ("native" or "threads" for a local
        store), else the transport's class name."""
        return getattr(self._t, "writer", type(self._t).__name__)

    # ------------------------------------------------------------------ io

    def _write_json(self, group: str, name: str, data: dict) -> None:
        key = f"{group}/{name}" if group else name
        self._meta_docs[key] = data
        self._t.put(key, json.dumps(data, indent=1).encode())

    # -------------------------------------------------------------- layout

    def create_group(self, name: str, attrs: Optional[dict] = None) -> None:
        self._write_json(name, ".zgroup", {"zarr_format": 2})
        if attrs:
            self._write_json(name, ".zattrs", attrs)

    def create_array(
        self,
        group: str,
        name: str,
        *,
        n_chains: int,
        total_draws: int,
        item_shape: tuple[int, ...],
        dtype: np.dtype,
        dims: tuple[str, ...],
        chunk_draws: int,
        attrs: Optional[dict] = None,
        written_draws: int = 0,
    ) -> None:
        """Declare one array.  ``written_draws > 0`` resumes appending at
        that draw offset (the earlier rows are already durable in the
        store, e.g. from the run a checkpoint restart continues)."""
        key = f"{group}/{name}"
        dtype = np.dtype(dtype)
        shape = [n_chains, total_draws, *item_shape]
        chunks = [1, chunk_draws, *item_shape]
        meta = {
            "zarr_format": 2,
            "shape": shape,
            "chunks": chunks,
            "dtype": _dtype_str(dtype),
            "compressor": {"id": "zlib", "level": self._level},
            "fill_value": _fill_value(dtype),
            "order": "C",
            "filters": None,
            "dimension_separator": ".",
        }
        self._write_json(key, ".zarray", meta)
        zattrs = {"_ARRAY_DIMENSIONS": list(dims)}
        if attrs:
            zattrs.update(attrs)
        self._write_json(key, ".zattrs", zattrs)
        with self._lock:
            self._arrays[key] = {
                "meta": meta, "dtype": dtype, "chunk_draws": chunk_draws,
                "written_draws": written_draws,
            }

    def create_coord(self, group: str, name: str, values: np.ndarray,
                     dim: Optional[str] = None) -> None:
        """A small 1-D coordinate array, written eagerly in one chunk."""
        values = np.asarray(values)
        if values.dtype.kind in ("U", "O"):
            values = values.astype("U")
            dtype_str = values.dtype.str
            fill = ""
        else:
            dtype_str = _dtype_str(values.dtype)
            fill = _fill_value(values.dtype)
        key = f"{group}/{name}"
        meta = {
            "zarr_format": 2,
            "shape": list(values.shape),
            "chunks": list(values.shape) or [1],
            "dtype": dtype_str,
            "compressor": {"id": "zlib", "level": self._level},
            "fill_value": fill,
            "order": "C",
            "filters": None,
            "dimension_separator": ".",
        }
        self._write_json(key, ".zarray", meta)
        self._write_json(
            key, ".zattrs", {"_ARRAY_DIMENSIONS": [dim or name]}
        )
        self._t.put(
            f"{key}/0",
            zlib.compress(np.ascontiguousarray(values).tobytes(), self._level),
        )

    # -------------------------------------------------------------- writes

    def append(self, group: str, name: str, values: np.ndarray) -> None:
        """Append ``values[chain, draws_in_chunk, ...]`` at the current draw
        offset.  Must be called with whole device chunks in order; the chunk
        size must equal ``chunk_draws`` except for the final partial chunk.
        """
        key = f"{group}/{name}"
        info = self._arrays[key]
        values = np.ascontiguousarray(values, info["dtype"])
        n_chains = values.shape[0]
        n_draws = values.shape[1]
        chunk_draws = info["chunk_draws"]
        start = info["written_draws"]
        chunk_idx = start // chunk_draws
        if start % chunk_draws != 0:
            raise ValueError("appends must be aligned to chunk_draws")
        if n_draws < chunk_draws:
            pad_shape = list(values.shape)
            pad_shape[1] = chunk_draws - n_draws
            kind = info["dtype"].kind
            fill = np.nan if kind == "f" else ("" if kind == "U" else 0)
            values = np.concatenate(
                [values, np.full(pad_shape, fill, info["dtype"])], axis=1
            )
        n_item_dims = values.ndim - 2
        suffix = ".".join(["0"] * n_item_dims)
        for chain in range(n_chains):
            fname = f"{chain}.{chunk_idx}" + (f".{suffix}" if suffix else "")
            self._t.submit_compressed(
                f"{key}/{fname}", values[chain].tobytes(), self._level
            )
        info["written_draws"] = start + n_draws

    def read_partial_chunk(self, group: str, name: str,
                           draw_offset: int) -> Optional[np.ndarray]:
        """Rows ``[aligned_floor(draw_offset), draw_offset)`` of an array
        already durable in the store (resume priming).  Returns
        ``[chains, rows, ...]`` or None when the offset is chunk-aligned
        or the transport cannot read."""
        if not hasattr(self._t, "get"):
            return None
        key = f"{group}/{name}"
        info = self._arrays[key]
        chunk_draws = info["chunk_draws"]
        rows = draw_offset % chunk_draws
        if rows == 0:
            return None
        chunk_idx = draw_offset // chunk_draws
        meta = info["meta"]
        n_chains = meta["shape"][0]
        item_shape = tuple(meta["shape"][2:])
        suffix = ".".join(["0"] * len(item_shape))
        kind = info["dtype"].kind
        out = np.full(
            (n_chains, rows, *item_shape),
            np.nan if kind == "f" else ("" if kind == "U" else 0),
            info["dtype"],
        )
        for chain in range(n_chains):
            fname = f"{chain}.{chunk_idx}" + (f".{suffix}" if suffix else "")
            raw = self._t.get(f"{key}/{fname}")
            if raw is None:
                continue
            block = np.frombuffer(zlib.decompress(raw), info["dtype"])
            block = block.reshape((chunk_draws, *item_shape))
            out[chain] = block[:rows]
        return out

    def flush(self) -> None:
        self._t.flush()

    def write_consolidated(self) -> None:
        """Write/refresh the consolidated ``.zmetadata`` document."""
        self._write_json(
            "", ".zmetadata",
            {
                "zarr_consolidated_format": 1,
                "metadata": {
                    k: v for k, v in sorted(self._meta_docs.items())
                    if k.rsplit("/", 1)[-1] in (".zgroup", ".zarray", ".zattrs")
                },
            },
        )

    def finalize(self, actual_draws: Optional[int] = None) -> None:
        """Wait for writes, fix up shapes for aborted runs, consolidate."""
        self.flush()
        for key, info in self._arrays.items():
            if actual_draws is not None and actual_draws != info["meta"]["shape"][1]:
                info["meta"]["shape"][1] = actual_draws
                self._write_json(key, ".zarray", info["meta"])
        self.write_consolidated()

    def close(self) -> None:
        self.flush()
        self._t.close()


def _read_zarr_array_impl(get: Callable[[str], Optional[bytes]],
                          key: str) -> np.ndarray:
    meta = json.loads(get(f"{key}/.zarray"))
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    fill = meta["fill_value"]
    if fill == "NaN":
        fill = np.nan
    out = np.full(shape, fill, dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        fname = ".".join(str(i) for i in idx)
        raw = get(f"{key}/{fname}")
        if raw is None:
            continue
        block = np.frombuffer(zlib.decompress(raw), dtype).reshape(chunks)
        slices = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, shape)
        )
        view = tuple(slice(0, sl.stop - sl.start) for sl in slices)
        out[slices] = block[view]
    return out


def read_zarr_array(root, key: str) -> np.ndarray:
    """Minimal zarr v2 reader (tests and the no-xarray fallback).

    ``root`` is a directory path, a store object, or a transport with
    ``get``.
    """
    if isinstance(root, (str, Path)):
        rootp = Path(root)

        def get(k: str) -> Optional[bytes]:
            try:
                with open(rootp / k, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                return None

        return _read_zarr_array_impl(get, key)
    t = _as_transport(root)
    return _read_zarr_array_impl(t.get, key)
