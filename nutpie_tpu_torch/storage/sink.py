"""Streaming trace sink: device chunks -> Zarr groups as sampling runs.

Mirrors the reference's streaming Zarr storage (``sample(...,
zarr_store=...)``, chunked writes through a writer pool;
``wrapper.rs:1028-1038``): every completed device chunk is split into
warmup/posterior rows, buffered to the Zarr chunk alignment, and handed to
the (native C++) async writer, so a crash or abort preserves all completed
draws on disk.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..trace import _VECTOR_STATS
from .zarr_writer import ZarrTraceWriter

# object/str stats (divergence_message) persist as fixed-width UCS4 --
# zarr v2 has no variable-length string codec without the VLenUTF8 filter,
# and fixed "<U..." arrays open cleanly in zarr-python/xarray.  Longer
# messages truncate (the reference's messages are ~60 chars).
_STRING_WIDTH = 128


def _storable(values: np.ndarray) -> np.ndarray:
    if values.dtype.kind in ("O", "U"):
        return values.astype(f"<U{_STRING_WIDTH}")
    return values


class ZarrTraceSink:
    def __init__(
        self,
        store,
        *,
        n_chains: int,
        num_tune: int,
        num_draws: int,
        save_warmup: bool = True,
        chunk_draws: int = 64,
        attrs: Optional[dict] = None,
        start_offset: int = 0,
    ):
        # any store exposing .transport() works: LocalStore, MemoryStore,
        # the obstore-backed object stores, or a user transport object
        self._writer = ZarrTraceWriter(store)
        self._start_offset = int(start_offset)
        self._n_chains = n_chains
        self._num_tune = num_tune
        self._num_draws = num_draws
        self._save_warmup = save_warmup
        self._chunk_draws = chunk_draws
        self._attrs = dict(attrs or {})
        self._initialized = False
        # pending rows per (group, name): list of [chains, rows, ...] arrays
        self._pending: dict[tuple[str, str], list[np.ndarray]] = {}
        self._written: dict[str, int] = {}

    @property
    def writer(self) -> str:
        """The store's writer ("native" or "threads" for a local store)."""
        return self._writer.writer

    # ------------------------------------------------------------- layout

    def _group_specs(self, chunk: dict, dims_map: dict):
        specs = []  # (group, source, total_draws)
        specs.append(("posterior", "expanded", self._num_draws))
        specs.append(("sample_stats", "stats", self._num_draws))
        if self._save_warmup:
            specs.append(("warmup_posterior", "expanded", self._num_tune))
            specs.append(("warmup_sample_stats", "stats", self._num_tune))
        return specs

    def _init_layout(self, chunk: dict, dims_map: dict, coords: dict):
        w = self._writer
        for group, source, total in self._group_specs(chunk, dims_map):
            attrs = self._attrs if group == "sample_stats" else None
            w.create_group(group, attrs)
            w.create_coord(group, "chain", np.arange(self._n_chains), "chain")
            w.create_coord(group, "draw", np.arange(total), "draw")
            for name, values in chunk[source].items():
                values = _storable(values)
                item_shape = values.shape[2:]
                extra = dims_map.get(name)
                if extra is None:
                    extra = _VECTOR_STATS.get(name)
                if extra is None:
                    extra = tuple(
                        f"{name}_dim_{i}" for i in range(len(item_shape))
                    )
                dims = ("chain", "draw") + tuple(extra)
                chunk_draws = min(self._chunk_draws, max(total, 1))
                # resume: earlier rows of this run are already durable in
                # the store; append from the chunk-aligned offset and prime
                # the pending buffer with the trailing partial chunk
                offset = (
                    min(self._start_offset, self._num_tune)
                    if group.startswith("warmup")
                    else max(0, self._start_offset - self._num_tune)
                )
                offset = min(offset, total)
                aligned = (offset // chunk_draws) * chunk_draws
                w.create_array(
                    group, name,
                    n_chains=self._n_chains,
                    total_draws=total,
                    item_shape=item_shape,
                    dtype=values.dtype,
                    dims=dims,
                    chunk_draws=chunk_draws,
                    written_draws=aligned,
                )
                if offset > aligned:
                    partial = w.read_partial_chunk(group, name, offset)
                    if partial is not None:
                        self._pending[(group, name)] = [partial]
                for dim, size in zip(extra, item_shape):
                    if dim in coords and len(coords[dim]) == size:
                        try:
                            w.create_coord(group, dim, np.asarray(coords[dim]),
                                           dim)
                        except TypeError:
                            pass
                self._written.setdefault(
                    f"{group}/{name}",
                    (min(self._start_offset, self._num_tune)
                     if group.startswith("warmup")
                     else max(0, self._start_offset - self._num_tune))
                    // chunk_draws * chunk_draws,
                )
        # consolidated metadata up front: the layout (shapes, dims, attrs)
        # is fully known here, so live inspect() can open the store-backed
        # trace mid-run (unwritten chunks read back as fill values);
        # finalize() rewrites it with corrected shapes for aborted runs
        self._writer.write_consolidated()
        self._initialized = True

    # ------------------------------------------------------------- writes

    def _push(self, group: str, name: str, rows: np.ndarray, total: int):
        if rows.shape[1] == 0:
            return
        key = (group, name)
        self._pending.setdefault(key, []).append(rows)
        self._flush_key(key, total, force=False)

    def _flush_key(self, key, total: int, force: bool):
        group, name = key
        pending = self._pending.get(key) or []
        if not pending:
            return
        buffered = np.concatenate(pending, axis=1)
        chunk_draws = min(self._chunk_draws, max(total, 1))
        written = self._written[f"{group}/{name}"]
        n = buffered.shape[1]
        n_full = (n // chunk_draws) * chunk_draws
        if force:
            n_full = n
        if n_full == 0:
            self._pending[key] = [buffered]
            return
        for off in range(0, n_full, chunk_draws):
            end = min(off + chunk_draws, n_full)
            self._writer.append(group, name, buffered[:, off:end])
        self._written[f"{group}/{name}"] = written + n_full
        rest = buffered[:, n_full:]
        self._pending[key] = [rest] if rest.shape[1] else []

    def append_chunk(self, chunk: dict, start: int, dims_map: dict,
                     coords: dict) -> None:
        if not self._initialized:
            self._init_layout(chunk, dims_map, coords)
        n = next(iter(chunk["stats"].values())).shape[1]
        end = start + n
        warm_n = max(0, min(end, self._num_tune) - start)
        for source, groups in (
            ("expanded", ("warmup_posterior", "posterior")),
            ("stats", ("warmup_sample_stats", "sample_stats")),
        ):
            warm_group, post_group = groups
            for name, values in chunk[source].items():
                values = _storable(values)
                if self._save_warmup and warm_n > 0:
                    self._push(warm_group, name, values[:, :warm_n],
                               self._num_tune)
                if end > self._num_tune:
                    self._push(post_group, name, values[:, warm_n:],
                               self._num_draws)

    def finalize(self, total_produced: int) -> None:
        for (group, name), _ in list(self._pending.items()):
            total = self._num_tune if group.startswith("warmup") else self._num_draws
            self._flush_key((group, name), total, force=True)
        actual_post = max(0, min(total_produced, self._num_tune + self._num_draws)
                          - self._num_tune)
        # shrink array shapes for aborted runs
        self._writer.flush()
        for key, info in self._writer._arrays.items():
            total = self._num_tune if key.split("/")[0].startswith("warmup") \
                else self._num_draws
            actual = min(total_produced, self._num_tune) if key.split("/")[0].startswith("warmup") else actual_post
            if info["meta"]["shape"][1] != actual:
                info["meta"]["shape"][1] = actual
                self._writer._write_json(key, ".zarray", info["meta"])
        self._writer.finalize()
        self._writer.close()
