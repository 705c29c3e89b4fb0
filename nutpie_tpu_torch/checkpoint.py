"""Durable checkpoint/resume of sampling runs.

Every piece of sampler state (positions, the adaptation state, the low-rank
metric where there is one, the raw Threefry key data, the draw counters) is
a field of the chains' ``NutsMachineState``, so a checkpoint is one ``.npz``
file: each field under its own name (``key`` as the raw int64 ``[C, 2]``
key data it is), the draws done, and the fleet's tree-depth cap that the
next chunk runs under.  ``sample(..., checkpoint=path)`` saves one at chunk
boundaries and at the end; ``sample(..., resume_from=path)`` continues from
it.

Determinism: resuming at a chunk boundary of the uninterrupted run
reproduces exactly the draws that run would have produced (all randomness
is keyed by absolute draw and step counters).  That needs the depth cap
too: it is measured on warmup chunks and frozen with the mass matrix, so a
run resumed after the freeze could not measure it again.  The JAX
package's checkpoint (``nutpie_tpu/checkpoint.py``) leaves it out and
restarts from the static initial cap, so there a resumed fleet of 64
chains or more runs its trees under another cap.  The format is this
package's own.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .sampler.state import NutsMachineState

_FORMAT_VERSION = 1
_MANIFEST = "__manifest__"


def save_state(path, states: NutsMachineState, draws_done: int, depth_cap,
               meta: dict) -> None:
    """Snapshot ``states`` (and the schedule's ``depth_cap``, an int or a
    0-d tensor) to ``path``, written to a temporary name and renamed."""
    arrays = {name: t.detach().cpu().numpy() for name, t in states.tensors().items()}
    manifest = {
        "format_version": _FORMAT_VERSION,
        "draws_done": int(draws_done),
        "depth_cap": int(depth_cap),
        "fields": sorted(arrays),
        "state_class": type(states).__name__,
        "meta": meta,
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{_MANIFEST: json.dumps(manifest)}, **arrays)
    tmp.replace(path)


def load_state(path, template: NutsMachineState):
    """Restore a snapshot into the fields, dtypes and device of
    ``template`` (a freshly initialized state with the same settings).

    Shapes must match, which refuses a resume with another model, chain
    count or configuration.  Returns ``(states, draws_done, depth_cap,
    meta)``.
    """
    with np.load(Path(path), allow_pickle=False) as data:
        manifest = json.loads(str(data[_MANIFEST]))
        if manifest["format_version"] != _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {manifest['format_version']} not supported"
            )
        fields = template.tensors()
        if sorted(fields) != manifest["fields"]:
            raise ValueError(
                "checkpoint does not match the sampler configuration (fields "
                f"{manifest['fields']} vs {sorted(fields)})"
            )
        restored = {}
        for name, tmpl in fields.items():
            arr = data[name]
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(
                    f"checkpoint field {name} has shape {arr.shape}, expected "
                    f"{tuple(tmpl.shape)} (different model, chain count, or settings?)"
                )
            restored[name] = torch.as_tensor(arr, device=tmpl.device).to(tmpl.dtype)
    return (NutsMachineState(**restored), manifest["draws_done"],
            manifest["depth_cap"], manifest["meta"])
