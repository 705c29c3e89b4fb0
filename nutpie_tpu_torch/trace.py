"""Trace assembly: device buffers -> ArviZ-compatible output.

The reference converts Arrow RecordBatches to an ArviZ ``InferenceData`` /
xarray ``DataTree`` (``sample.py:62-214``), with groups ``posterior``,
``sample_stats``, ``warmup_posterior``, ``warmup_sample_stats``, and
``unconstrained_posterior`` for reparameterized variables, plus
``inference_library*`` attrs carrying the full settings JSON
(``sample.py:666-686``).

This module reproduces that layout.  xarray/ArviZ are optional here: when
xarray is importable the real ``xr.DataTree`` is returned; otherwise a
minimal self-contained fallback (:class:`DataArray` / :class:`Dataset` /
:class:`DataTree`) with the same access patterns (``trace.posterior.x``,
``.values``, ``.mean(dim=...)``) is used, so the full test suite runs
without any of the reference's heavy dependencies.  ``open_zarr_trace``
opens a trace that ``sample(zarr_store=...)`` streamed, with arrays that
load from the store on first access.
"""

from __future__ import annotations

import importlib.util
from typing import Any, Mapping, Optional

import numpy as np

_HAS_XARRAY = importlib.util.find_spec("xarray") is not None


class DataArray:
    """Minimal xarray.DataArray stand-in (numpy values + named dims)."""

    def __init__(self, values, dims, coords=None, name=None):
        self.values = np.asarray(values)
        self.dims = tuple(dims)
        self.coords = dict(coords or {})
        self.name = name
        assert self.values.ndim == len(self.dims), (name, self.values.shape, dims)

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def dtype(self):
        return self.values.dtype

    def to_numpy(self):
        return self.values

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    def _axis(self, dim):
        if dim is None:
            return None
        if isinstance(dim, str):
            return self.dims.index(dim)
        return tuple(self.dims.index(d) for d in dim)

    def _reduce(self, fn, dim=None, **kw):
        axis = self._axis(dim)
        vals = fn(self.values, axis=axis, **kw)
        if dim is None:
            return vals
        drop = {dim} if isinstance(dim, str) else set(dim)
        new_dims = tuple(d for d in self.dims if d not in drop)
        coords = {k: v for k, v in self.coords.items() if k in new_dims}
        return DataArray(vals, new_dims, coords, self.name)

    def mean(self, dim=None):
        return self._reduce(np.nanmean, dim)

    def std(self, dim=None):
        return self._reduce(np.nanstd, dim)

    def sum(self, dim=None):
        return self._reduce(np.nansum, dim)

    def min(self, dim=None):
        return self._reduce(np.nanmin, dim)

    def max(self, dim=None):
        return self._reduce(np.nanmax, dim)

    def item(self):
        return self.values.item()

    def __getitem__(self, idx):
        return self.values[idx]

    def isel(self, **indexers):
        values = self.values
        dims = list(self.dims)
        for dim, idx in indexers.items():
            ax = dims.index(dim)
            values = np.take(values, idx, axis=ax)
            if np.isscalar(idx) or (isinstance(idx, np.ndarray) and idx.ndim == 0):
                dims.pop(ax)
        coords = {k: v for k, v in self.coords.items() if k in dims}
        return DataArray(values, dims, coords, self.name)

    def __repr__(self):
        return f"<DataArray {self.name!r} {dict(zip(self.dims, self.shape))}>"


class Dataset:
    """Minimal xarray.Dataset stand-in."""

    def __init__(self, data_vars: Mapping[str, DataArray], attrs=None, coords=None):
        self._vars = dict(data_vars)
        self.attrs = dict(attrs or {})
        self.coords = dict(coords or {})

    @property
    def data_vars(self):
        return dict(self._vars)

    def __getitem__(self, name):
        return self._vars[name]

    def __contains__(self, name):
        return name in self._vars

    def __iter__(self):
        return iter(self._vars)

    def keys(self):
        return self._vars.keys()

    def items(self):
        return self._vars.items()

    def __getattr__(self, name):
        try:
            return self.__dict__["_vars"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self):
        lines = [f"<Dataset ({len(self._vars)} variables)>"]
        for k, v in self._vars.items():
            lines.append(f"  {k}: {dict(zip(v.dims, v.shape))}")
        return "\n".join(lines)


class DataTree:
    """Minimal xarray.DataTree stand-in: named groups of Datasets."""

    def __init__(self, groups: Mapping[str, Dataset]):
        self._groups = dict(groups)

    @property
    def groups(self):
        return tuple(self._groups)

    def __getitem__(self, name):
        return self._groups[name]

    def __contains__(self, name):
        return name in self._groups

    def __getattr__(self, name):
        try:
            return self.__dict__["_groups"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self):
        return f"<DataTree groups={list(self._groups)}>"


# stat name -> extra dims beyond (chain, draw)
_VECTOR_STATS = {
    "gradient": ("unconstrained_parameter",),
    "unconstrained_draw": ("unconstrained_parameter",),
    "mass_matrix_inv": ("unconstrained_parameter",),
    "mass_matrix_stds": ("unconstrained_parameter",),
    "divergence_start": ("unconstrained_parameter",),
    "divergence_end": ("unconstrained_parameter",),
    "divergence_momentum": ("unconstrained_parameter",),
    "divergence_start_gradient": ("unconstrained_parameter",),
    "transformed_position": ("unconstrained_parameter",),
    "transformed_gradient": ("unconstrained_parameter",),
    "transformation_mu": ("unconstrained_parameter",),
}


def _build_group(arrays, dims_map, coords, attrs=None):
    data = {}
    for name, values in arrays.items():
        values = np.asarray(values)
        extra_dims = dims_map.get(name)
        if extra_dims is None:
            extra_dims = tuple(
                f"{name}_dim_{i}" for i in range(values.ndim - 2)
            )
        dims = ("chain", "draw") + tuple(extra_dims)
        var_coords = {d: coords[d] for d in dims if d in coords}
        data[name] = DataArray(values, dims, var_coords, name)
    return Dataset(data, attrs=attrs, coords=coords)


def assemble_trace(
    *,
    expanded: dict[str, np.ndarray],        # name -> [chain, total_draws, *shape]
    stats: dict[str, np.ndarray],           # name -> [chain, total_draws, ...]
    unconstrained: Optional[dict[str, np.ndarray]],  # per-param-var views
    num_tune: int,
    save_warmup: bool,
    dims_map: dict[str, tuple[str, ...]],
    coords: dict[str, Any],
    attrs: dict[str, Any],
    reparameterized_names: tuple[str, ...] = (),
    as_xarray: Optional[bool] = None,
):
    """Build the grouped trace from stacked host arrays.

    Splits warmup/posterior at ``num_tune`` (all chains advance in lockstep
    on the device, so no ragged NaN-padding is needed unless the run was
    aborted -- aborted runs simply have fewer total draws, and draws that
    were never produced are NaN from the buffer initialization).
    """
    some = next(iter(stats.values()))
    total = some.shape[1]
    n_tune = min(num_tune, total)

    def split(arrays):
        warm = {k: v[:, :n_tune] for k, v in arrays.items()}
        post = {k: v[:, n_tune:] for k, v in arrays.items()}
        return warm, post

    # move reparameterized variables out of the posterior group
    posterior_arrays = {
        k: v for k, v in expanded.items() if k not in reparameterized_names
    }
    reparam_arrays = {
        k: v for k, v in expanded.items() if k in reparameterized_names
    }
    if unconstrained:
        reparam_arrays.update(
            {k: v for k, v in unconstrained.items() if k not in reparam_arrays}
        )

    n_chains = some.shape[0]
    base_coords = dict(coords)
    base_coords.setdefault("chain", np.arange(n_chains))

    warm_post, post = split(posterior_arrays)
    warm_stats, post_stats = split(stats)
    warm_rep, post_rep = split(reparam_arrays)

    stat_dims = dict(_VECTOR_STATS)
    stat_dims.update(dims_map)

    def coords_for(n_draws):
        # draw coords always start at 0 per ArviZ convention, including for
        # resumed runs (resume slicing happens upstream in sample.py via
        # num_tune - resume_offset; the zarr sink writes absolute offsets)
        c = dict(base_coords)
        c["draw"] = np.arange(n_draws)
        return c

    groups = {}
    groups["posterior"] = _build_group(
        post, dims_map, coords_for(total - n_tune)
    )
    groups["sample_stats"] = _build_group(
        post_stats, stat_dims, coords_for(total - n_tune), attrs=attrs
    )
    if save_warmup:
        groups["warmup_posterior"] = _build_group(
            warm_post, dims_map, coords_for(n_tune)
        )
        groups["warmup_sample_stats"] = _build_group(
            warm_stats, stat_dims, coords_for(n_tune)
        )
    if reparam_arrays:
        groups["unconstrained_posterior"] = _build_group(
            post_rep, dims_map, coords_for(total - n_tune)
        )
        if save_warmup:
            groups["warmup_unconstrained_posterior"] = _build_group(
                warm_rep, dims_map, coords_for(n_tune)
            )

    use_xr = _HAS_XARRAY if as_xarray is None else as_xarray
    if use_xr:
        return _to_xarray(groups)
    return DataTree(groups)


class LazyDataArray(DataArray):
    """DataArray whose values load from a Zarr store on first access.

    Keeps ``sample(zarr_store=...)`` truly streaming: the returned trace
    holds no draw data in host memory until a variable is touched
    (reference parity: the Rust build reopens the store read-only,
    ``python/nutpie/sample.py:615-627``).
    """

    def __init__(self, loader, shape, dtype, dims, coords=None, name=None):
        self._loader = loader
        self._values = None
        self._shape = tuple(shape)
        self._dtype = np.dtype(dtype)
        self.dims = tuple(dims)
        self.coords = dict(coords or {})
        self.name = name

    @property
    def values(self):
        if self._values is None:
            self._values = self._loader()
        return self._values

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dtype(self):
        return self._dtype


def open_zarr_trace(store):
    """Open a finished (or partially written) trace store as a DataTree.

    Uses ``xr.open_datatree(engine="zarr")`` when xarray+zarr are
    importable (reference behavior); otherwise builds the fallback
    DataTree from the store's consolidated metadata with lazily loaded
    arrays.  ``store`` is a LocalStore/MemoryStore/transport or a path.
    """
    import json
    from pathlib import Path

    from .storage.zarr_writer import _as_transport, read_zarr_array

    path = getattr(store, "path", None)
    if path is None and isinstance(store, (str, Path)):
        path = store
    if _HAS_XARRAY and path is not None and (
        importlib.util.find_spec("zarr") is not None
    ):
        import xarray as xr

        return xr.open_datatree(path, engine="zarr")

    t = _as_transport(store)
    raw = t.get(".zmetadata")
    if raw is None:
        raise FileNotFoundError(
            "store has no consolidated .zmetadata; was the run finalized?"
        )
    meta = json.loads(raw)["metadata"]

    groups: dict[str, dict] = {}
    for key, doc in meta.items():
        if not key.endswith("/.zarray"):
            continue
        arr_key = key[: -len("/.zarray")]
        group, name = arr_key.split("/", 1)
        zattrs = meta.get(f"{arr_key}/.zattrs", {})
        dims = tuple(zattrs.get(
            "_ARRAY_DIMENSIONS",
            [f"{name}_dim_{i}" for i in range(len(doc["shape"]))],
        ))
        groups.setdefault(group, {})[name] = (doc, dims, arr_key)

    out = {}
    for group, arrays in groups.items():
        # 1-D arrays indexed by their own name are coordinates
        coord_arrays = {
            name: read_zarr_array(t, arr_key)
            for name, (doc, dims, arr_key) in arrays.items()
            if len(dims) == 1 and dims[0] == name
        }
        data = {}
        for name, (doc, dims, arr_key) in arrays.items():
            if name in coord_arrays:
                continue
            var_coords = {d: coord_arrays[d] for d in dims if d in coord_arrays}
            data[name] = LazyDataArray(
                (lambda k=arr_key: read_zarr_array(t, k)),
                doc["shape"], np.dtype(doc["dtype"]), dims, var_coords, name,
            )
        attrs = meta.get(f"{group}/.zattrs", {})
        out[group] = Dataset(data, attrs=attrs, coords=coord_arrays)
    return DataTree(out)


def _to_xarray(groups: dict[str, Dataset]):
    import xarray as xr

    def conv(ds: Dataset) -> "xr.Dataset":
        data_vars = {}
        for name, da in ds.items():
            data_vars[name] = xr.DataArray(
                da.values, dims=da.dims, coords=da.coords, name=name
            )
        return xr.Dataset(data_vars, attrs=ds.attrs)

    return xr.DataTree.from_dict({k: conv(v) for k, v in groups.items()})
