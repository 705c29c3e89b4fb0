"""Variable metadata and dims/coords plumbing.

Analog of the reference's ``src/common.rs`` (``PyVariable`` with
name/dtype/dims/shape/flat-buffer offsets, dim-size consistency checks, and
auto-generated anonymous dims; see reference ``src/common.rs:283-465``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Variable:
    """Metadata for one output variable of a model's expand function."""

    name: str
    dtype: np.dtype
    shape: tuple[int, ...]
    dims: Optional[tuple[str, ...]] = None
    start_idx: int = 0
    end_idx: int = 0

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1


def resolve_variables(
    specs: Sequence[tuple[str, np.dtype, tuple[int, ...], Optional[Sequence[str]]]],
    dim_sizes: Optional[dict[str, int]] = None,
) -> tuple[list[Variable], dict[str, int]]:
    """Build Variable list with flat offsets and validated/auto-filled dims.

    Mirrors ``new_variables`` semantics (``src/common.rs:383-465``):

    - if dims are given, each dim's size must be consistent with any
      previously registered size for that dim name;
    - missing dims are auto-generated as ``{name}_dim_{i}``;
    - variables are assigned contiguous flat-buffer offsets in order.
    """
    dim_sizes = dict(dim_sizes or {})
    out: list[Variable] = []
    offset = 0
    for name, dtype, shape, dims in specs:
        shape = tuple(int(s) for s in shape)
        if dims is None:
            dims_t = tuple(f"{name}_dim_{i}" for i in range(len(shape)))
        else:
            # None entries are anonymous dims (pymc's dims=("row", None));
            # the reference auto-names them {name}_dim_{i}
            # (src/common.rs:302-379)
            dims_t = tuple(
                d if d is not None else f"{name}_dim_{i}"
                for i, d in enumerate(dims)
            )
            if len(dims_t) != len(shape):
                raise ValueError(
                    f"Variable {name}: dims {dims_t} do not match shape {shape}"
                )
        for dim, size in zip(dims_t, shape):
            if dim in dim_sizes:
                if dim_sizes[dim] != size:
                    raise ValueError(
                        f"Dimension {dim!r} has inconsistent sizes: "
                        f"{dim_sizes[dim]} and {size}"
                    )
            else:
                dim_sizes[dim] = size
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        out.append(
            Variable(
                name=name,
                dtype=np.dtype(dtype),
                shape=shape,
                dims=dims_t,
                start_idx=offset,
                end_idx=offset + n,
            )
        )
        offset += n
    return out, dim_sizes


def unconstrained_coord_labels(variables: Sequence[Variable]) -> list[str]:
    """Flat labels for the ``unconstrained_parameter`` coordinate.

    Mirrors the reference's label scheme (``compile_pymc.py:370-407``):
    scalar vars get their bare name, array vars get ``name_0.1`` style
    index-suffixed labels in C order.
    """
    labels: list[str] = []
    for var in variables:
        if not var.shape:
            labels.append(var.name)
        else:
            for idx in np.ndindex(*var.shape):
                labels.append(var.name + "_" + ".".join(str(i) for i in idx))
    return labels
