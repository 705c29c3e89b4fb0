"""Streaming Zarr storage of the port (the cases of ``tests/test_storage.py``
that do not need flow adaptation), and its layout against the JAX
package's.

- The native writer builds into ``nutpie_tpu_torch/_build/``, never next to
  its source, and round-trips a chunk.
- A run streamed to a ``LocalStore`` returns a store-backed trace equal to
  an in-memory run of the same seed; likewise a ``MemoryStore``; the
  object-store classes need ``obstore``.
- A checkpointed run resumed into the same store, mid-way through a Zarr
  chunk, leaves it bitwise equal to an uninterrupted run's store.
- The store passes the independent spec checker (``tests/zarr_spec.py``)
  with string coordinates and the divergence message column; string stats
  truncate at the sink's fixed width; an aborted run's store-backed trace
  holds the draws produced.
- Layout parity: both packages stream the same run into ``MemoryStore``s;
  the keys and every ``.zarray``, ``.zgroup`` and ``.zattrs`` document
  (and the consolidated ``.zmetadata``) match apart from the
  ``inference_library*`` fields, and so does the first chunk's
  ``n_steps``.

CPU, float64; every loop that waits on the sampling thread has a deadline.
"""

import json
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import nutpie_tpu
import nutpie_tpu.models as jm
import nutpie_tpu_torch
import nutpie_tpu_torch.models as tm
from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
from nutpie_tpu.storage.stores import MemoryStore as JMemoryStore
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def, from_pyfunc
from nutpie_tpu_torch.storage import native
from nutpie_tpu_torch.storage.sink import _STRING_WIDTH, ZarrTraceSink
from nutpie_tpu_torch.storage.stores import MemoryStore
from nutpie_tpu_torch.storage.zarr_writer import read_zarr_array
from nutpie_tpu_torch.trace import LazyDataArray, open_zarr_trace
from nutpie_tpu_torch.zarr_store import LocalStore
from zarr_spec import validate_store

torch.set_num_threads(1)

DEADLINE_S = 60


def _sample(model, **kwargs):
    return nutpie_tpu_torch.sample(model, device="cpu", progress_bar=False, **kwargs)


def test_native_writer_builds_into_build_dir(tmp_path):
    storage_dir = native.SRC.parent
    before = sorted(p.name for p in storage_dir.iterdir())
    w = native.NativeWriter(2)
    data = np.arange(1000, dtype=np.float64).tobytes()
    path = tmp_path / "chunk.bin"
    w.submit(str(path), data, 1)
    w.flush()
    assert w.errors == 0
    assert zlib.decompress(path.read_bytes()) == data
    w.close()
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent == storage_dir.parent
    assert sorted(p.name for p in storage_dir.iterdir()) == before


def test_zarr_streaming_roundtrip(tmp_path):
    model = compile_model_def(tm.eight_schools())
    store = LocalStore(str(tmp_path / "trace.zarr"))
    # maxdepth 6 keeps the first warmup draws' trees short on the CPU
    common = dict(chains=2, draws=48, tune=32, seed=7, chunk_size=16, maxdepth=6)
    trace = _sample(model, zarr_store=store, **common)
    root = Path(store.path)
    meta = json.loads((root / ".zmetadata").read_text())
    assert "posterior/mu/.zarray" in meta["metadata"]
    assert isinstance(trace.posterior["mu"], LazyDataArray)
    mem_trace = _sample(model, **common)
    for name, shape in (("mu", (2, 48)), ("theta", (2, 48, 8))):
        disk = read_zarr_array(root, f"posterior/{name}")
        assert disk.shape == shape
        np.testing.assert_array_equal(disk, mem_trace.posterior[name].values)
        np.testing.assert_array_equal(trace.posterior[name].values, disk)
    assert read_zarr_array(root, "warmup_posterior/mu").shape == (2, 32)
    assert read_zarr_array(root, "sample_stats/diverging").dtype == np.bool_
    zattrs = json.loads((root / "posterior/theta/.zattrs").read_text())
    assert zattrs["_ARRAY_DIMENSIONS"] == ["chain", "draw", "school"]
    sattrs = json.loads((root / "sample_stats/.zattrs").read_text())
    assert sattrs["inference_library"] == "nutpie_tpu_torch"


def test_memory_store_roundtrip():
    store = MemoryStore()
    trace = _sample(compile_model_def(tm.std_normal(2)), chains=2, draws=40, tune=20,
                    seed=3, zarr_store=store, chunk_size=20)
    assert ".zmetadata" in store.mapping
    np.testing.assert_array_equal(read_zarr_array(store, "posterior/x"),
                                  trace.posterior["x"].values)


def test_object_store_classes_require_obstore():
    from nutpie_tpu_torch.storage.stores import AzureStore, GCSStore, HTTPStore, S3Store

    try:
        import obstore  # noqa: F401

        pytest.skip("obstore installed; constructor path exercised")
    except ImportError:
        for cls in (S3Store, GCSStore, AzureStore, HTTPStore):
            with pytest.raises(ImportError, match="obstore"):
                cls("bucket")


def test_resume_into_zarr(tmp_path):
    """Resumed at draw 60, posterior draw 20: mid-way through a 16-draw Zarr
    chunk, whose first rows are read back from the store."""
    model = compile_model_def(tm.std_normal(3))
    common = dict(chains=2, tune=40, seed=11, chunk_size=20)
    full = LocalStore(str(tmp_path / "full.zarr"))
    _sample(model, draws=40, zarr_store=full, **common)
    ckpt = tmp_path / "state.npz"
    store = LocalStore(str(tmp_path / "resumed.zarr"))
    _sample(model, draws=20, checkpoint=str(ckpt), zarr_store=store, **common)
    _sample(model, draws=40, resume_from=str(ckpt), zarr_store=store, **common)
    for key in ("posterior/x", "warmup_posterior/x", "sample_stats/n_steps"):
        want = read_zarr_array(Path(full.path), key)
        got = read_zarr_array(Path(store.path), key)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_zarr_spec_conformance_and_string_payloads(tmp_path):
    school_names = np.array(["choate", "deerfield", "phillips", "hotchkiss"], dtype=object)
    model = from_pyfunc(
        ndim=4,
        make_logp_fn=lambda: (lambda x: -0.5 * torch.sum(x * x, dim=1)),
        make_expand_fn=lambda: (lambda x: {"theta": x}),
        expanded_dtypes=[np.float64],
        expanded_shapes=[(4,)],
        expanded_names=["theta"],
        dims={"theta": ("school",)},
        coords={"school": school_names},
    )
    store = LocalStore(str(tmp_path / "s.zarr"))
    _sample(model, chains=2, draws=40, tune=20, seed=5, zarr_store=store, chunk_size=20,
            store_divergences=True)
    arrays = validate_store(store.path)
    assert list(arrays["posterior/school"]) == list(school_names)
    msgs = arrays["sample_stats/divergence_message"]
    assert msgs.dtype.kind == "U" and msgs.shape[:2] == (2, 40)
    tr = open_zarr_trace(store)
    assert list(tr.posterior["theta"].coords["school"]) == list(school_names)


def test_zarr_store_backed_abort_partial(tmp_path):
    store = LocalStore(str(tmp_path / "p.zarr"))
    sampler = _sample(compile_model_def(tm.std_normal(2)), chains=2, draws=100_000,
                      tune=20, seed=9, zarr_store=store, chunk_size=10, blocking=False)
    deadline = time.monotonic() + DEADLINE_S
    while sampler._draws_done < 40:
        assert time.monotonic() < deadline, "timed out waiting for draws"
        time.sleep(0.01)
    trace = sampler.abort()
    x = np.asarray(trace.posterior["x"].values)
    assert 0 < x.shape[1] < 100_000
    assert np.isfinite(x).all()
    assert sampler.zarr_writer in ("native", "threads")


def test_divergence_message_truncation_boundary(tmp_path):
    """127/128-char messages survive exactly, 129-char ones truncate to 128."""
    assert _STRING_WIDTH == 128
    msgs = np.array([["a" * 127, "b" * 128, "c" * 129, ""]], dtype=object)
    chunk = {"expanded": {"x": np.zeros((1, 4, 2))}, "stats": {"divergence_message": msgs}}
    store = LocalStore(str(tmp_path / "m.zarr"))
    sink = ZarrTraceSink(store, n_chains=1, num_tune=0, num_draws=4, save_warmup=False,
                         chunk_draws=3)
    sink.append_chunk(chunk, 0, {}, {})
    sink.finalize(4)
    got = validate_store(store.path)["sample_stats/divergence_message"]
    assert got.dtype == np.dtype("<U128")
    assert list(got[0]) == ["a" * 127, "b" * 128, "c" * 128, ""]


def _strip_library(doc):
    """A metadata document without the ``inference_library*`` fields."""
    if isinstance(doc, dict):
        return {k: _strip_library(v) for k, v in doc.items()
                if not k.startswith("inference_library")}
    return doc


def test_layout_matches_jax():
    common = dict(chains=2, tune=16, draws=16, seed=13, chunk_size=16, progress_bar=False,
                  maxdepth=6)
    ours, ref = MemoryStore(), JMemoryStore()
    nutpie_tpu_torch.sample(compile_model_def(tm.eight_schools()), device="cpu",
                            zarr_store=ours, **common)
    nutpie_tpu.sample(jax_compile(jm.eight_schools()), zarr_store=ref, **common)
    assert sorted(ours.mapping) == sorted(ref.mapping)
    for key in ref.mapping:
        name = key.rsplit("/", 1)[-1]
        if name in (".zarray", ".zgroup", ".zattrs", ".zmetadata"):
            assert _strip_library(json.loads(ours.mapping[key])) == \
                _strip_library(json.loads(ref.mapping[key])), key
    np.testing.assert_array_equal(read_zarr_array(ours, "warmup_sample_stats/n_steps"),
                                  read_zarr_array(ref, "warmup_sample_stats/n_steps"))
