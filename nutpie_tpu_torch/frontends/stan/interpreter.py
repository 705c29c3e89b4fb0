"""Tree-walking evaluator turning a Stan AST into torch log densities.

The evaluator runs per chain: ``logp(x)`` and ``expand(x, key)`` take one
unconstrained point, and the model batches them over chains with
``torch.func.vmap`` (``api.py``), on every device, so the CPU and the card
take one path.  Everything derived from ``data`` stays on the host
(numpy values and python numbers): shapes, loop bounds, integer indices
and the conditions of ``if``/``while`` are read there and never from the
device, so a log density makes no host sync and can be captured in a
CUDA graph.  Values that depend on the parameters are tensors (batched
under vmap) and cannot steer control flow.  The math runs in the dtype of
``x`` through ``xp``, which holds each host array on the device once.

Static/traced split: array dimensions, for-loop bounds, and if/while
conditions must be data-dependent only (as in Stan, where they must be
``int`` expressions -- integers cannot be parameters).  ``reject()``
statements map to a ``-inf`` target, which the NUTS kernel treats as a
recoverable divergence, matching the reference's error protocol
(``LogpError::is_recoverable``, ``src/stan.rs:392-396``).
"""

from __future__ import annotations

import math
import threading
from typing import Any

import numpy as np
import torch
from torch.func import vmap

from . import ast_nodes as A
from . import functionals as stan_functionals
from . import rng, xp
from ...ops import threefry
from .errors import StanCompileError, StanRuntimeError
from .stanlib import (
    DISTRIBUTIONS,
    FUNCTIONS,
    LCCDFS,
    LCDFS,
    RNG_FUNCTIONS,
    _divide,
    _dot,
    _transpose,
)
from .transforms import make_transform


class StanComplex:
    """Complex value as an explicit (re, im) pair.

    Carrying the parts as two real tensors keeps the evaluation in the
    sampler's real dtype and under vmap (the reference gets complex support
    for free through BridgeStan's C++, src/stan.rs:92-251; here the algebra
    is explicit).
    """

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

    def __repr__(self):
        return f"StanComplex({self.re!r}, {self.im!r})"


class StanTuple:
    """Tuple value: a trace-time-static sequence of heterogeneous slots."""

    __slots__ = ("slots",)

    def __init__(self, slots):
        self.slots = tuple(slots)

    def __repr__(self):
        return f"StanTuple{self.slots!r}"


def _to_cplx(v) -> StanComplex:
    if isinstance(v, StanComplex):
        return v
    if isinstance(v, complex):
        return StanComplex(v.real, v.imag)
    return StanComplex(v, xp.zeros_like(xp.asarray(v)))


def _cplx_binop(op: str, left, right, node) -> StanComplex:
    a, b = _to_cplx(left), _to_cplx(right)
    if op == "+":
        return StanComplex(a.re + b.re, a.im + b.im)
    if op == "-":
        return StanComplex(a.re - b.re, a.im - b.im)
    if op in ("*", ".*"):
        return StanComplex(
            a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re
        )
    if op in ("/", "./"):
        d = b.re * b.re + b.im * b.im
        return StanComplex(
            (a.re * b.re + a.im * b.im) / d,
            (a.im * b.re - a.re * b.im) / d,
        )
    raise StanCompileError(
        f"operator {op!r} is not supported for complex values",
        node.line, node.col,
    )


class _BreakLoop(Exception):
    pass


class _ContinueLoop(Exception):
    pass


class _ReturnValue(Exception):
    def __init__(self, value):
        self.value = value


# complex containers carry their parts as one StanComplex with array-shaped
# re/im (elementwise complex algebra broadcasts over the parts for free)
_CPLX_CONTAINER_BASES = frozenset(
    {"complex_vector", "complex_row_vector", "complex_matrix"}
)


class Ctx:
    """Mutable evaluation context for one logp/expand call."""

    def __init__(self, mode: str, rng_key=None):
        self.mode = mode  # "logp" | "expand"
        self.target = 0.0
        self.rng_key = rng_key

    def next_key(self, node):
        if self.rng_key is None:
            raise StanCompileError(
                "_rng functions are only available in generated quantities "
                "and transformed data",
                node.line, node.col,
            )
        self.rng_key, sub = rng.split(self.rng_key)
        return sub


class _HostEvaluation(threading.local):
    # True while the interpreter binds data (transformed data, shapes,
    # constraints): tensors then live on the host and may be read
    active = False


_HOST = _HostEvaluation()


def _static_int(value, node, what="expression") -> int:
    try:
        if isinstance(value, (bool, np.bool_)):
            return int(value)
        if isinstance(value, torch.Tensor):
            # a tensor is read only while data are bound on the host; in a
            # log density a read would sync with the device
            if not _HOST.active:
                raise ValueError
            value = value.detach().cpu().numpy()
        arr = np.asarray(value)
        if arr.size != 1:
            raise ValueError
        return int(arr.reshape(()))
    except Exception:
        raise StanCompileError(
            f"{what} must be a data-dependent integer (parameters cannot "
            f"appear in array sizes, loop bounds, or conditions)",
            node.line, node.col,
        ) from None


def _static_bool(value, node) -> bool:
    return bool(_static_int(value, node, "condition"))


def _is_concrete(x) -> bool:
    return isinstance(x, (int, float, bool, np.generic, np.ndarray))


def _operand(v):
    """A value as an operand of torch code: host arrays become tensors of
    the evaluation (held on the device once), numpy scalars python numbers;
    tensors, python numbers and structured values pass through."""
    if isinstance(v, np.ndarray):
        return xp.asarray(v) if v.ndim else v.item()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _index_operand(i):
    """An index part for torch: host index arrays held on the device."""
    return xp.asarray(i) if isinstance(i, np.ndarray) else i


def _index_value(base, idx):
    """``base[idx]``: on the host where base and indices are host values,
    else gathered on the device."""
    traced = any(isinstance(i, torch.Tensor) for i in idx)
    if _is_concrete(base) and not traced:
        return np.asarray(base)[idx]
    return xp.asarray(base)[tuple(_index_operand(i) for i in idx)]


def _set_at(current, idx, value):
    """``current[idx] = value`` out of place (vmap refuses an in-place write
    of a batched value into an unbatched tensor): a scatter of ``value`` to
    the flat positions ``idx`` selects, found on the host where the indices
    are host values."""
    if (_is_concrete(current) and _is_concrete(value)
            and not any(isinstance(i, torch.Tensor) for i in idx)):
        out = np.array(current, copy=True)
        out[idx] = value
        return out
    arr = xp.asarray(current)
    shape = tuple(arr.shape)
    n = math.prod(shape)
    if any(isinstance(i, torch.Tensor) for i in idx):
        pos = torch.arange(n, device=arr.device).reshape(shape)[
            tuple(_index_operand(i) for i in idx)]
    else:
        pos = xp.asarray(np.asarray(np.arange(n).reshape(shape)[idx]).reshape(-1))
    val = xp.asarray(_operand(value)).to(arr.dtype)
    val = torch.broadcast_to(val, tuple(pos.shape)).reshape(-1)
    return arr.reshape(-1).index_put((pos.reshape(-1),), val).reshape(shape)


def _to_host(v):
    """Tensors computed while binding data, as numpy (the host mirror)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, list):
        return [_to_host(u) for u in v]
    if isinstance(v, StanTuple):
        return StanTuple(_to_host(u) for u in v.slots)
    if isinstance(v, StanComplex):
        return StanComplex(_to_host(v.re), _to_host(v.im))
    return v


_VMAP_FALLBACK = "There is a performance drop"


def _is_vmap_fallback(err) -> bool:
    """vmap's per-example loop, raised as an error where its warning is
    turned into one (the tests and chip_smoke do)."""
    return isinstance(err, UserWarning) and _VMAP_FALLBACK in str(err)


class UserFunction:
    def __init__(self, interp: "StanInterpreter", fdef: A.FunctionDef):
        self.interp = interp
        self.fdef = fdef

    def __call__(self, ctx: Ctx, *args):
        env = dict(self.interp.base_env)
        if len(args) != len(self.fdef.params):
            raise StanCompileError(
                f"function {self.fdef.name} expects {len(self.fdef.params)} "
                f"arguments, got {len(args)}",
                self.fdef.line, self.fdef.col,
            )
        for (ptype, pname), val in zip(self.fdef.params, args):
            env[pname] = val
        try:
            self.interp.exec_stmts(self.fdef.body, env, ctx)
        except _ReturnValue as ret:
            return ret.value
        return None


def _host_dot(a, b):
    """Stan's ``*`` of host values (``stanlib._dot`` in numpy)."""
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.ndim == 1 and b.ndim == 2:
        if b.shape[0] == 1:
            return np.outer(a, b.ravel())
        raise StanCompileError("vector * matrix is not defined in Stan")
    if a.ndim == 2 and b.ndim == 1:
        out = a @ b
        return out[0] if a.shape[0] == 1 else out
    return a @ b


def _true_divide(a, b):
    a, b = xp.asarray(a), xp.asarray(b)
    if not (a.is_floating_point() or b.is_floating_point()):
        a = a.to(xp.fdtype())
    return a / b


# binary operators of host values (numpy) and of device values (torch);
# comparisons/logicals stay on the host for host operands so if/while
# conditions on loop counters and data remain static
_HOST_BINOPS = {
    "+": np.add, "-": np.subtract, "*": np.multiply, "/": np.true_divide,
    "%": np.mod, ".*": np.multiply, "./": np.true_divide, "^": np.power,
    ".^": np.power, "==": np.equal, "!=": np.not_equal, "<": np.less,
    "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
    "&&": lambda a, b: np.logical_and(a != 0, b != 0),
    "||": lambda a, b: np.logical_or(a != 0, b != 0),
}
_DEVICE_BINOPS = {
    "+": lambda a, b: xp.asarray(a) + b,
    "-": lambda a, b: xp.asarray(a) - b,
    "%": xp.mod,
    ".*": lambda a, b: xp.asarray(a) * b,
    "./": _true_divide,
    "^": xp.power, ".^": xp.power,
    "==": lambda a, b: xp.asarray(a) == b,
    "!=": lambda a, b: xp.asarray(a) != b,
    "<": lambda a, b: xp.asarray(a) < b,
    "<=": lambda a, b: xp.asarray(a) <= b,
    ">": lambda a, b: xp.asarray(a) > b,
    ">=": lambda a, b: xp.asarray(a) >= b,
    "&&": lambda a, b: xp.logical_and(xp.asarray(a) != 0, xp.asarray(b) != 0),
    "||": lambda a, b: xp.logical_or(xp.asarray(a) != 0, xp.asarray(b) != 0),
}


# library functions that keep host arguments on the host (their results
# may size arrays or steer control flow, as in the JAX package)
_HOST_FUNCTIONS = frozenset({"to_int"})


# minimum trip count before a for loop is run as one batched body (vmap
# over the loop variable) instead of unrolled; below this, unrolling keeps
# integer/constant folding exact
_BATCH_MIN_TRIP = 32


def _analyze_loop_body(stmts):
    """Names written / declared in a loop body, plus whether the body uses
    control flow that cannot cross a scan boundary (break/continue at this
    loop's level, or return anywhere)."""
    import dataclasses as _dc

    written: list[str] = []
    declared: set[str] = set()
    bail = False

    def visit(node, loop_depth):
        nonlocal bail
        if bail:
            return
        if isinstance(node, A.Return):
            bail = True
            return
        if isinstance(node, (A.Break, A.Continue)) and loop_depth == 0:
            bail = True
            return
        if isinstance(node, A.Call) and node.name == "target":
            # target() inside a batched body would read a zeroed local
            # accumulator, not the running total
            bail = True
            return
        if isinstance(node, A.Decl):
            declared.add(node.name)
        if isinstance(node, A.Assign):
            tgt = node.target
            while isinstance(tgt, A.Index):
                tgt = tgt.base
            if isinstance(tgt, A.Var):
                if tgt.name not in written:
                    written.append(tgt.name)
            else:
                bail = True
                return
        child_depth = loop_depth + (1 if isinstance(node, (A.For, A.While))
                                    else 0)
        if _dc.is_dataclass(node):
            for f in _dc.fields(node):
                visit(getattr(node, f.name), child_depth)
        elif isinstance(node, (list, tuple)):
            for item in node:
                visit(item, loop_depth)

    visit(list(stmts), 0)
    return written, declared, bail


def _uses_rng(stmts) -> bool:
    import dataclasses as _dc

    found = False

    def visit(node):
        nonlocal found
        if isinstance(node, A.Call) and node.name.endswith("_rng"):
            found = True
        if _dc.is_dataclass(node):
            for f in _dc.fields(node):
                visit(getattr(node, f.name))
        elif isinstance(node, (list, tuple)):
            for item in node:
                visit(item)

    visit(list(stmts))
    return found


class _on_host:
    """Evaluate on the host in float64, where tensors may be read
    (binding data, the shapes of the outputs)."""

    def __enter__(self):
        self._prev = _HOST.active
        _HOST.active = True
        self._ev = xp.evaluation(torch.float64, "cpu")
        self._ev.__enter__()

    def __exit__(self, *exc):
        self._ev.__exit__(*exc)
        _HOST.active = self._prev


class StanInterpreter:
    """Binds a parsed program to data and produces logp/expand callables."""

    def __init__(self, program: A.Program, data: dict[str, Any],
                 seed: int = 0):
        # per (device, dtype): the host arrays held on that device
        self._device_caches: dict = {}
        # for loops (node id, mode, bounds) that take the unrolled tier
        self._unrolled: set = set()
        with _on_host():
            self._bind(program, data, seed)

    def device_cache(self, device, dtype) -> dict:
        return self._device_caches.setdefault((torch.device(device), dtype), {})

    def _bind(self, program: A.Program, data: dict[str, Any], seed: int):
        self.program = program
        self.seed = seed
        self.functions: dict[str, UserFunction] = {}
        for fdef in program.functions:
            self.functions[fdef.name] = UserFunction(self, fdef)
        self.uses_gq_rng = _uses_rng(program.generated_quantities)

        # ---- data block
        env: dict[str, Any] = {}
        for decl in program.data:
            name = decl.name
            if name not in data:
                raise StanRuntimeError(
                    f"Model data variable {name!r} was not provided"
                )
            if decl.type.base == "tuple":
                # accepted forms: a python tuple/list of slot values, or
                # the stanio JSON convention {"1": ..., "2": ...}
                # (column-wise for arrays of tuples); internally an array
                # of tuples is a python list of StanTuple, matching what
                # ArrayLit builds for tuple literals
                env[name] = self._bind_tuple_data(
                    decl.type, data[name], env, decl
                )
                continue
            value = np.asarray(data[name])
            if decl.type.base == "complex" or (
                decl.type.base in _CPLX_CONTAINER_BASES
            ):
                value = value.astype(np.complex128)
                shape = self._decl_shape(decl, env)
                if tuple(value.shape) != shape:
                    value = value.reshape(shape)
                # np.array (not ascontiguousarray: it promotes 0-d to (1,))
                env[name] = StanComplex(
                    np.array(value.real), np.array(value.imag)
                )
                continue
            if decl.type.base == "int":
                value = value.astype(np.int64)
            else:
                value = value.astype(np.float64)
            shape = self._decl_shape(decl, env)
            if tuple(value.shape) != shape:
                # allow scalars passed as 0-d/1-element
                if math.prod(value.shape, start=1) == math.prod(shape, start=1):
                    value = value.reshape(shape)
                else:
                    raise StanRuntimeError(
                        f"Data variable {name!r} has shape {value.shape}, "
                        f"expected {shape}"
                    )
            if decl.type.base == "row_vector" and value.ndim == 1:
                value = value.reshape(1, -1)
            env[name] = value

        # ---- transformed data (evaluated on the host in float64; _rng uses
        # a data seed); tensors it makes are kept as numpy, so the log
        # density reads them as data
        ctx = Ctx("logp", rng_key=threefry.key(seed ^ 0x5BD1E995))
        self.exec_stmts(program.transformed_data, env, ctx)
        env = {k: _to_host(v) for k, v in env.items()}
        self.base_env = env
        stan_functionals.check_dae_grids(self)

        # ---- parameter layout
        self.params: list[dict] = []
        offset = 0
        for decl in program.parameters:
            base = decl.type.base
            if base in ("tuple", "complex") or base in _CPLX_CONTAINER_BASES:
                # tuple/complex parameters lower to consecutive flat real
                # slots (the reference samples them through BridgeStan's
                # flat name parser, src/stan.rs:92-251): complex = 2 reals
                # per element, tuple = each slot laid out recursively with
                # its own constraint transform
                size, fwd = self._layout_structured(decl.type, env, ctx)
                self.params.append(
                    dict(
                        name=decl.name,
                        base=base,
                        offset=offset,
                        size=size,
                        forward=fwd,
                        constrained_shape=None,
                        row_vector=False,
                        spec=decl.type,
                    )
                )
                offset += size
                continue
            type_dims = tuple(
                _static_int(self.eval_expr(d, env, ctx), d, "dimension")
                for d in decl.type.dims
            )
            array_dims = tuple(
                _static_int(self.eval_expr(d, env, ctx), d, "array dimension")
                for d in decl.type.array_dims
            )
            constraints = {
                key: _to_host(self.eval_expr(expr, env, ctx))
                for key, expr in decl.type.constraints.items()
            }
            if base == "matrix":
                con_shape = array_dims + type_dims
            elif base in ("vector", "row_vector"):
                con_shape = array_dims + type_dims
            elif base in ("real",):
                con_shape = array_dims
            else:  # constrained structured types
                con_shape = array_dims + self._constrained_type_shape(
                    base, type_dims
                )
            size, fwd = make_transform(
                base,
                array_dims + type_dims if base not in (
                    "simplex", "ordered", "positive_ordered", "unit_vector",
                    "sum_to_zero_vector", "cholesky_factor_corr",
                    "cholesky_factor_cov", "corr_matrix", "cov_matrix",
                ) else array_dims + type_dims,
                constraints,
                type_dims,
            )
            self.params.append(
                dict(
                    name=decl.name,
                    base=base,
                    offset=offset,
                    size=size,
                    forward=fwd,
                    constrained_shape=con_shape,
                    row_vector=(base == "row_vector"),
                )
            )
            offset += size
        self.ndim = offset

        # ---- output variable metadata
        self.tp_decls = [s for s in program.transformed_parameters
                         if isinstance(s, A.Decl)]
        self.gq_decls = [s for s in program.generated_quantities
                         if isinstance(s, A.Decl)]

    # ------------------------------------------------------------- shapes

    def _constrained_type_shape(self, base: str, type_dims) -> tuple:
        if base in ("simplex", "ordered", "positive_ordered", "unit_vector",
                    "sum_to_zero_vector"):
            return (type_dims[0],)
        if base in ("cholesky_factor_corr", "corr_matrix", "cov_matrix"):
            return (type_dims[0], type_dims[0])
        if base == "cholesky_factor_cov":
            k = type_dims[0]
            m = type_dims[1] if len(type_dims) > 1 else k
            return (k, m)
        return tuple(type_dims)

    def _bind_tuple_data(self, spec: A.TypeSpec, raw, env, decl):
        """Convert user-provided tuple data to the interpreter's tuple
        representation (StanTuple / nested lists for array dims).

        The reference receives tuple data through stanio's JSON dump
        (``{"1": ..., "2": ...}``, column-wise over array dims) and
        BridgeStan's C++; both that form and plain python tuples/lists of
        slot values are accepted here."""
        ctx = Ctx("logp")
        array_dims = tuple(
            _static_int(self.eval_expr(d, env, ctx), d, "array dimension")
            for d in spec.array_dims
        )

        def convert_slot(slot_spec, value):
            if slot_spec.base == "tuple":
                return convert_tuple(slot_spec, value, ())
            if slot_spec.base == "complex":
                arr = np.asarray(value, np.complex128)
                return StanComplex(np.array(arr.real), np.array(arr.imag))
            if slot_spec.base == "int":
                return np.asarray(value, np.int64)
            arr = np.asarray(value, np.float64)
            if slot_spec.base == "row_vector" and arr.ndim == 1:
                arr = arr.reshape(1, -1)
            return arr

        def convert_tuple(tspec, value, adims):
            if adims:
                n = adims[0]
                if isinstance(value, dict):
                    # column-wise: slice each slot column per element
                    rows = [
                        {k: np.asarray(v)[i] if not isinstance(v, dict)
                         else {kk: np.asarray(vv)[i] for kk, vv in v.items()}
                         for k, v in value.items()}
                        for i in range(n)
                    ]
                else:
                    rows = list(value)
                if len(rows) != n:
                    raise StanRuntimeError(
                        f"Data variable {decl.name!r}: expected {n} "
                        f"tuple elements, got {len(rows)}"
                    )
                return [convert_tuple(tspec, r, adims[1:]) for r in rows]
            if isinstance(value, dict):
                slots = [
                    value[str(i + 1)] for i in range(len(tspec.tuple_slots))
                ]
            elif isinstance(value, (tuple, list)):
                slots = list(value)
                if len(slots) != len(tspec.tuple_slots):
                    raise StanRuntimeError(
                        f"Data variable {decl.name!r}: tuple has "
                        f"{len(tspec.tuple_slots)} slots, got {len(slots)}"
                    )
            else:
                raise StanRuntimeError(
                    f"Data variable {decl.name!r}: tuple data must be a "
                    f"tuple/list of slot values or a "
                    f"{{'1': ..., '2': ...}} dict (stanio convention)"
                )
            return StanTuple(
                [convert_slot(s, v) for s, v in zip(tspec.tuple_slots, slots)]
            )

        return convert_tuple(spec, raw, array_dims)

    def _decl_shape(self, decl: A.Decl, env) -> tuple:
        ctx = Ctx("logp")
        type_dims = tuple(
            _static_int(self.eval_expr(d, env, ctx), d, "dimension")
            for d in decl.type.dims
        )
        array_dims = tuple(
            _static_int(self.eval_expr(d, env, ctx), d, "array dimension")
            for d in decl.type.array_dims
        )
        base = decl.type.base
        if base in ("int", "real", "complex"):
            return array_dims
        if base in ("row_vector", "complex_row_vector"):
            return array_dims + (1,) + type_dims
        if base in ("vector", "matrix", "complex_vector", "complex_matrix"):
            return array_dims + type_dims
        return array_dims + self._constrained_type_shape(base, type_dims)

    # ------------------------------------------------- tuple/complex support

    def _layout_structured(self, spec: A.TypeSpec, env, ctx):
        """(unconstrained size, forward) for a tuple/complex parameter spec.

        Lowers structured parameters to consecutive flat real slots, the
        way BridgeStan lays them out for the reference (its flat name
        parser then reassembles ``pair:1`` / ``z.real`` names,
        ``src/stan.rs:92-251``): a complex element is (real, imag), a tuple
        is each slot laid out recursively with its own constraint
        transform, and array dims iterate row-major OUTSIDE the element
        layout.  ``forward(u) -> (value, log_jacobian)`` where the value
        follows the interpreter's runtime conventions (``StanComplex`` /
        ``StanTuple`` / nested python lists over array dims).
        """
        base = spec.base

        def static_dims(exprs, what):
            return tuple(
                _static_int(self.eval_expr(d, env, ctx), d, what)
                for d in exprs
            )

        if base in _CPLX_CONTAINER_BASES:
            # complex containers: interleaved (re, im) flat reals per
            # element (BridgeStan's layout), reassembled as ONE
            # StanComplex with array-shaped parts
            type_dims = static_dims(spec.dims, "dimension")
            array_dims = static_dims(spec.array_dims, "array dimension")
            shape = array_dims + (
                (1,) + type_dims if base == "complex_row_vector"
                else type_dims
            )
            count = int(np.prod(shape)) if shape else 1

            def fwd_cplx(u):
                q = u.reshape(shape + (2,))
                return StanComplex(q[..., 0], q[..., 1]), xp.zeros(())

            return 2 * count, fwd_cplx

        if base not in ("tuple", "complex"):
            # plain slot inside a tuple: the standard transform machinery
            type_dims = static_dims(spec.dims, "dimension")
            array_dims = static_dims(spec.array_dims, "array dimension")
            constraints = {
                key: _to_host(self.eval_expr(expr, env, ctx))
                for key, expr in spec.constraints.items()
            }
            size, fwd = make_transform(
                base, array_dims + type_dims, constraints, type_dims
            )
            if base == "row_vector":
                def fwd_rv(u, _f=fwd):
                    v, lj = _f(u)
                    if v.ndim == 1:
                        v = v.reshape(1, -1)
                    return v, lj
                return size, fwd_rv
            return size, fwd

        array_dims = static_dims(spec.array_dims, "array dimension")
        if base == "complex":
            elem_size = 2

            def elem_fwd(u):
                return StanComplex(u[0], u[1]), xp.zeros(())
        else:
            subs = [
                self._layout_structured(s, env, ctx)
                for s in spec.tuple_slots
            ]
            elem_size = sum(sz for sz, _ in subs)

            def elem_fwd(u):
                vals, lj, off = [], xp.zeros(()), 0
                for sz, f in subs:
                    v, l_ = f(u[off:off + sz])
                    vals.append(v)
                    lj = lj + l_
                    off += sz
                return StanTuple(vals), lj

        def build(u, dims):
            if not dims:
                return elem_fwd(u)
            stride = u.shape[0] // dims[0]
            vals, lj = [], xp.zeros(())
            for i in range(dims[0]):
                v, l_ = build(u[i * stride:(i + 1) * stride], dims[1:])
                vals.append(v)
                lj = lj + l_
            return vals, lj

        total = elem_size * int(np.prod(array_dims)) if array_dims else (
            elem_size
        )

        def forward(u):
            return build(u, array_dims)

        return total, forward

    def _zero_complex(self, shape):
        if not shape:
            return StanComplex(xp.zeros(()), xp.zeros(()))
        # arrays of complex flatten per element (mirrors the output naming)
        return [self._zero_complex(shape[1:]) for _ in range(shape[0])]

    def _default_tuple_value(self, spec: A.TypeSpec, env, ctx):
        """Zero value for an (array-of-)tuple/complex declaration.

        Plain slot types keep their array dims as array shape; tuple and
        complex bases flatten their array dims into python lists (matching
        the flattened output naming).
        """
        if spec.base not in ("tuple", "complex"):
            decl = A.Decl(type=spec, name="_slot")
            shape = self._decl_shape_dynamic(decl, env, ctx)
            if spec.base == "int":
                return np.zeros(shape, np.int64) if shape else 0
            return xp.zeros(shape)

        array_dims = tuple(
            _static_int(self.eval_expr(d, env, ctx), d, "array dimension")
            for d in spec.array_dims
        )

        def build(dims):
            if dims:
                return [build(dims[1:]) for _ in range(dims[0])]
            if spec.base == "complex":
                return StanComplex(xp.zeros(()), xp.zeros(()))
            return StanTuple(
                self._default_tuple_value(s, env, ctx)
                for s in spec.tuple_slots
            )

        return build(array_dims)

    def _flatten_value(self, name: str, value, out: dict) -> None:
        """Flatten tuple/complex values into scalar-or-array outputs using
        the stanio/CmdStan naming scheme the reference's name parser
        consumes (src/stan.rs:92-251): array element ``.i``, tuple slot
        ``:j``, complex part ``.real``/``.imag``."""
        if isinstance(value, StanTuple):
            for j, v in enumerate(value.slots, 1):
                self._flatten_value(f"{name}:{j}", v, out)
        elif isinstance(value, list):
            for i, v in enumerate(value, 1):
                self._flatten_value(f"{name}.{i}", v, out)
        elif isinstance(value, StanComplex):
            out[f"{name}.real"] = xp.asarray(value.re)
            out[f"{name}.imag"] = xp.asarray(value.im)
        else:
            out[name] = xp.asarray(value)

    def _flatten_decl_meta(self, name: str, spec: A.TypeSpec, env):
        """(name, dtype, shape) rows for one declaration, flattening
        tuples/arrays-of-tuples/complex exactly like ``_flatten_value``."""
        import itertools

        ctx = Ctx("logp")
        rows: list[tuple] = []

        def dims_of(exprs):
            return tuple(
                _static_int(self.eval_expr(d, env, ctx), d, "dimension")
                for d in exprs
            )

        def walk(nm: str, s: A.TypeSpec):
            array_dims = dims_of(s.array_dims)
            if s.base in _CPLX_CONTAINER_BASES:
                type_dims = dims_of(s.dims)
                shape = array_dims + (
                    (1,) + type_dims if s.base == "complex_row_vector"
                    else type_dims
                )
                rows.append((f"{nm}.real", np.dtype(np.float64),
                             tuple(shape)))
                rows.append((f"{nm}.imag", np.dtype(np.float64),
                             tuple(shape)))
                return
            if s.base in ("tuple", "complex"):
                for combo in itertools.product(
                    *(range(1, d + 1) for d in array_dims)
                ):
                    elem = nm + "".join(f".{i}" for i in combo)
                    if s.base == "tuple":
                        for j, slot in enumerate(s.tuple_slots, 1):
                            walk(f"{elem}:{j}", slot)
                    else:
                        rows.append(
                            (f"{elem}.real", np.dtype(np.float64), ())
                        )
                        rows.append(
                            (f"{elem}.imag", np.dtype(np.float64), ())
                        )
                return
            type_dims = dims_of(s.dims)
            if s.base in ("int", "real"):
                shape = array_dims
            elif s.base == "row_vector":
                shape = array_dims + (1,) + type_dims
            elif s.base in ("vector", "matrix"):
                shape = array_dims + type_dims
            else:
                shape = array_dims + self._constrained_type_shape(
                    s.base, type_dims
                )
            dtype = np.int64 if s.base == "int" else np.float64
            rows.append((nm, np.dtype(dtype), tuple(shape)))

        walk(name, spec)
        return rows

    # ---------------------------------------------------------- entry points

    def constrain(self, x, ctx: Ctx, env: dict) -> None:
        """Apply constraint transforms, filling env and adding Jacobians."""
        for p in self.params:
            u = x[p["offset"] : p["offset"] + p["size"]]
            value, logj = p["forward"](u)
            if p["row_vector"] and value.ndim == 1:
                value = value.reshape(1, -1)
            env[p["name"]] = value
            ctx.target = ctx.target + logj

    def logp(self, x) -> torch.Tensor:
        ctx = Ctx("logp")
        env = dict(self.base_env)
        self.constrain(x, ctx, env)
        self.exec_stmts(self.program.transformed_parameters, env, ctx)
        self.exec_stmts(self.program.model, env, ctx)
        return xp.asarray(ctx.target, xp.fdtype())

    def expand(self, x, rng_key=None) -> dict[str, torch.Tensor]:
        ctx = Ctx("expand", rng_key=rng_key)
        env = dict(self.base_env)
        self.constrain(x, ctx, env)
        self.exec_stmts(self.program.transformed_parameters, env, ctx)
        self.exec_stmts(self.program.generated_quantities, env, ctx)
        out = {}
        for p in self.params:
            if p["base"] in ("tuple", "complex") or (
                p["base"] in _CPLX_CONTAINER_BASES
            ):
                self._flatten_value(p["name"], env[p["name"]], out)
            else:
                out[p["name"]] = xp.asarray(env[p["name"]])
        for decl in self.tp_decls + self.gq_decls:
            if decl.name in env:
                value = env[decl.name]
                if isinstance(value, (StanTuple, StanComplex, list)):
                    self._flatten_value(decl.name, value, out)
                else:
                    out[decl.name] = xp.asarray(value)
        return out

    def output_variables(self) -> list[tuple[str, np.dtype, tuple, None]]:
        """Names/dtypes/shapes of everything expand() returns."""
        with _on_host():
            return self._output_variables()

    def _output_variables(self):
        out = []
        for p in self.params:
            if p["base"] in ("tuple", "complex") or (
                p["base"] in _CPLX_CONTAINER_BASES
            ):
                for name, dtype, shape in self._flatten_decl_meta(
                    p["name"], p["spec"], self.base_env
                ):
                    out.append((name, dtype, shape, None))
                continue
            shape = p["constrained_shape"]
            if p["row_vector"]:
                shape = tuple(shape) + ()
            out.append((p["name"], np.dtype(np.float64), tuple(shape), None))
        env = dict(self.base_env)
        for decl in self.tp_decls + self.gq_decls:
            if decl.type.base in ("tuple", "complex"):
                for name, dtype, shape in self._flatten_decl_meta(
                    decl.name, decl.type, env
                ):
                    out.append((name, dtype, shape, None))
                continue
            shape = self._decl_shape(decl, env)
            dtype = np.int64 if decl.type.base == "int" else np.float64
            out.append((decl.name, np.dtype(dtype), tuple(shape), None))
        return out

    def param_variables(self) -> list[tuple[str, np.dtype, tuple, Any]]:
        """Unconstrained-space slices per parameter.

        Dims are named ``{name}_unc_dim_*`` because constraint transforms
        (simplex, cholesky factors, ...) change the size relative to the
        constrained variable of the same name.
        """
        out = []
        for p in self.params:
            if p["size"] != 1:
                shape = (p["size"],)
                dims = (f"{p['name']}_unc_dim_0",)
            else:
                shape, dims = (), ()
            out.append((p["name"], np.dtype(np.float64), shape, dims))
        return out

    # ------------------------------------------------------------ statements

    def exec_stmts(self, stmts, env: dict, ctx: Ctx) -> None:
        for stmt in stmts:
            self.exec_stmt(stmt, env, ctx)

    def exec_stmt(self, stmt, env: dict, ctx: Ctx) -> None:
        if isinstance(stmt, A.Decl):
            if stmt.init is not None:
                value = self.eval_expr(stmt.init, env, ctx)
                if stmt.type.base == "row_vector" and getattr(
                    value, "ndim", 0
                ) == 1:
                    value = value.reshape(1, -1)
                if stmt.type.base == "complex" and not isinstance(
                    value, (StanComplex, list)
                ):
                    value = _to_cplx(value)
                if stmt.type.base in _CPLX_CONTAINER_BASES and not isinstance(
                    value, StanComplex
                ):
                    value = _to_cplx(value)
                env[stmt.name] = value
            elif stmt.type.base == "tuple":
                env[stmt.name] = self._default_tuple_value(stmt.type, env, ctx)
            elif stmt.type.base in _CPLX_CONTAINER_BASES:
                shape = self._decl_shape_dynamic(stmt, env, ctx)
                env[stmt.name] = StanComplex(xp.zeros(shape),
                                             xp.zeros(shape))
            elif stmt.type.base == "complex":
                shape = tuple(
                    _static_int(self.eval_expr(d, env, ctx), d,
                                "array dimension")
                    for d in stmt.type.array_dims
                )
                env[stmt.name] = self._zero_complex(shape)
            else:
                shape = self._decl_shape_dynamic(stmt, env, ctx)
                if stmt.type.base == "int":
                    env[stmt.name] = np.zeros(shape, np.int64) if shape else 0
                else:
                    env[stmt.name] = xp.zeros(shape)
            return
        if isinstance(stmt, A.Assign):
            self.exec_assign(stmt, env, ctx)
            return
        if isinstance(stmt, A.Sampling):
            self.exec_sampling(stmt, env, ctx)
            return
        if isinstance(stmt, A.TargetPlus):
            value = self.eval_expr(stmt.value, env, ctx)
            ctx.target = ctx.target + xp.sum(_operand(value))
            return
        if isinstance(stmt, A.For):
            lo = _static_int(
                self.eval_expr(stmt.lower, env, ctx), stmt, "loop bound"
            )
            hi = _static_int(
                self.eval_expr(stmt.upper, env, ctx), stmt, "loop bound"
            )
            # Big data loops run as one batched body (a vmap over the loop
            # variable) where they can, so the work a call launches is O(1)
            # in N (the reference's C++ handles any N,
            # src/stan.rs:449-463).  Small loops keep unrolling, which keeps
            # constant folding on the host exact.
            # A loop that once failed to batch unrolls from then on, so no
            # later call issues the failed attempt's operations again.
            tier = (id(stmt), ctx.mode, lo, hi)
            if hi + 1 - lo >= _BATCH_MIN_TRIP and tier not in self._unrolled:
                if self._exec_for_batched(stmt, env, ctx, lo, hi):
                    return
                self._unrolled.add(tier)
            for i in range(lo, hi + 1):
                env[stmt.var] = i
                try:
                    self.exec_stmts(stmt.body, env, ctx)
                except _ContinueLoop:
                    continue
                except _BreakLoop:
                    break
            return
        if isinstance(stmt, A.While):
            guard = 0
            while _static_bool(self.eval_expr(stmt.cond, env, ctx), stmt):
                guard += 1
                if guard > 1_000_000:
                    raise StanRuntimeError("while loop exceeded 1e6 iterations")
                try:
                    self.exec_stmts(stmt.body, env, ctx)
                except _ContinueLoop:
                    continue
                except _BreakLoop:
                    break
            return
        if isinstance(stmt, A.If):
            cond = self.eval_expr(stmt.cond, env, ctx)
            if _is_concrete(cond):
                if bool(np.asarray(cond)):
                    self.exec_stmts(stmt.then, env, ctx)
                else:
                    self.exec_stmts(stmt.orelse, env, ctx)
                return
            raise StanCompileError(
                "if conditions depending on parameters are not supported "
                "in statement position (use the ternary operator `? :` for "
                "parameter-dependent selection)",
                stmt.line, stmt.col,
            )
        if isinstance(stmt, A.Break):
            raise _BreakLoop
        if isinstance(stmt, A.Continue):
            raise _ContinueLoop
        if isinstance(stmt, A.Return):
            value = (
                self.eval_expr(stmt.value, env, ctx)
                if stmt.value is not None else None
            )
            raise _ReturnValue(value)
        if isinstance(stmt, A.Print):
            for arg in stmt.args:
                self.eval_expr(arg, env, ctx)  # evaluate for side effects only
            return
        if isinstance(stmt, A.Reject):
            # recoverable model error -> -inf target -> divergence in NUTS
            ctx.target = ctx.target + (-xp.inf)
            return
        raise StanCompileError(
            f"unsupported statement {type(stmt).__name__}", stmt.line, stmt.col
        )

    def _exec_for_batched(self, stmt: A.For, env: dict, ctx: Ctx,
                          lo: int, hi: int) -> bool:
        """Run a big for loop as ONE batched body instead of unrolling.

        When the body only accumulates ``target`` (sampling statements /
        ``target +=``), draws no random numbers and writes no outer
        variable, the loop becomes a ``torch.func.vmap`` over the loop
        variable nested inside the vmap over chains: the idiomatic Stan
        data loop ``for (n in 1:N) y[n] ~ dist(...)`` becomes one batched
        evaluation whose size is independent of N.

        Every other loop (accumulators, ``mu[n] = ...`` writes, ``_rng``
        draws) unrolls, which is where the JAX package runs a ``lax.scan``:
        torch has no scan, and a CUDA graph replays the unrolled operations
        as one launch.  The RNG key chain is the scan's.

        Returns False (caller unrolls) when analysis or evaluation shows
        the body cannot be batched: break/continue/return, ragged slices
        ``x[1:n]``, if/loop bounds depending on the loop variable.  vmap's
        per-example fallback is never taken silently: where its warning is
        an error, the error propagates.
        """
        written, declared, bail = _analyze_loop_body(stmt.body)
        if bail:
            return False
        carried = [nm for nm in written if nm in env and nm not in declared]
        if carried or _uses_rng(stmt.body):
            return False
        ns = xp.arange(lo, hi + 1)

        def body_target(n):
            local_env = dict(env)
            local_env[stmt.var] = n
            local_ctx = Ctx(ctx.mode)
            self.exec_stmts(stmt.body, local_env, local_ctx)
            return xp.asarray(local_ctx.target, xp.fdtype())

        try:
            deltas = vmap(body_target)(ns)
        except (_BreakLoop, _ContinueLoop, _ReturnValue):
            return False
        except (StanCompileError, StanRuntimeError):
            return False
        except Exception as err:
            if _is_vmap_fallback(err):
                raise
            # any failure to batch the body (an index or condition that
            # needs the loop variable's value, a shape that depends on it)
            # -> semantics-preserving unroll; nothing was mutated (the body
            # ran on local copies)
            return False
        ctx.target = ctx.target + xp.sum(deltas)
        return True

    def _decl_shape_dynamic(self, decl: A.Decl, env, ctx) -> tuple:
        type_dims = tuple(
            _static_int(self.eval_expr(d, env, ctx), d, "dimension")
            for d in decl.type.dims
        )
        array_dims = tuple(
            _static_int(self.eval_expr(d, env, ctx), d, "array dimension")
            for d in decl.type.array_dims
        )
        base = decl.type.base
        if base in ("int", "real"):
            return array_dims
        if base in ("row_vector", "complex_row_vector"):
            return array_dims + (1,) + type_dims
        if base in ("vector", "matrix", "complex_vector", "complex_matrix"):
            return array_dims + type_dims
        return array_dims + self._constrained_type_shape(base, type_dims)

    def exec_assign(self, stmt: A.Assign, env: dict, ctx: Ctx) -> None:
        value = self.eval_expr(stmt.value, env, ctx)
        op = stmt.op
        target = stmt.target
        if isinstance(target, A.Var):
            if op != "=":
                base_val = env[target.name]
                value = self._apply_binop(op[:-1], base_val, value, stmt)
            env[target.name] = value
            return
        if isinstance(target, A.Index):
            chain = []
            node = target
            while isinstance(node, A.Index):
                chain.append(node)
                node = node.base
            if not isinstance(node, A.Var):
                raise StanCompileError(
                    "can only assign to variables", stmt.line, stmt.col
                )
            name = node.name
            if name not in env:
                raise StanCompileError(
                    f"assignment to undeclared variable {name!r}",
                    stmt.line, stmt.col,
                )
            chain.reverse()
            idx_tuples = []
            for ix in chain:
                idx_tuples.extend(self._indexers(ix.indices, env, ctx))
            idx = tuple(idx_tuples)
            current = env[name]
            if isinstance(current, StanComplex):
                cval = _to_cplx(value)
                if op != "=":
                    cur = StanComplex(_index_value(current.re, idx),
                                      _index_value(current.im, idx))
                    cval = _to_cplx(
                        self._apply_binop(op[:-1], cur, cval, stmt)
                    )
                env[name] = StanComplex(
                    _set_at(current.re, idx, cval.re),
                    _set_at(current.im, idx, cval.im),
                )
                return
            if op != "=":
                value = self._apply_binop(
                    op[:-1], _index_value(current, idx), value, stmt)
            env[name] = _set_at(current, idx, value)
            return
        raise StanCompileError("invalid assignment target", stmt.line, stmt.col)

    def exec_sampling(self, stmt: A.Sampling, env: dict, ctx: Ctx) -> None:
        y = self.eval_expr(stmt.target, env, ctx)
        args = [self.eval_expr(a, env, ctx) for a in stmt.args]
        name = stmt.dist
        # user-defined distribution: name_lpdf in functions block
        user = self.functions.get(name + "_lpdf") or self.functions.get(
            name + "_lpmf"
        )
        if user is not None:
            lp = user(ctx, y, *args)
            ctx.target = ctx.target + xp.sum(_operand(lp))
            return
        fn = DISTRIBUTIONS.get(name)
        if fn is None:
            raise StanCompileError(
                f"unsupported distribution {name!r}", stmt.line, stmt.col
            )
        y, args = _operand(y), [_operand(a) for a in args]
        lp = fn(y, *args)
        ctx.target = ctx.target + xp.sum(lp)
        if stmt.truncation is not None:
            lo_e, up_e = stmt.truncation
            lcdf = LCDFS.get(name)
            lccdf = LCCDFS.get(name)

            def trunc_sum(lz):
                # One normalization term per (y, args) broadcast element. A
                # scalar lz with vector y contributes len(y)*lz; a vector lz
                # (per-observation args) is summed exactly once per element.
                lz = xp.asarray(lz)
                shape = xp.broadcast_shapes(xp.shape(y), xp.shape(lz))
                return xp.sum(xp.broadcast_to(lz, shape))

            if lo_e is not None and up_e is not None:
                if lcdf is None:
                    raise StanCompileError(
                        f"truncation not supported for {name!r}",
                        stmt.line, stmt.col,
                    )
                lo = _operand(self.eval_expr(lo_e, env, ctx))
                up = _operand(self.eval_expr(up_e, env, ctx))
                lz = xp.log(
                    xp.exp(lcdf(up, *args)) - xp.exp(lcdf(lo, *args))
                )
                ctx.target = ctx.target - trunc_sum(lz)
            elif lo_e is not None:
                if lccdf is None:
                    raise StanCompileError(
                        f"truncation not supported for {name!r}",
                        stmt.line, stmt.col,
                    )
                lo = _operand(self.eval_expr(lo_e, env, ctx))
                ctx.target = ctx.target - trunc_sum(lccdf(lo, *args))
            elif up_e is not None:
                if lcdf is None:
                    raise StanCompileError(
                        f"truncation not supported for {name!r}",
                        stmt.line, stmt.col,
                    )
                up = _operand(self.eval_expr(up_e, env, ctx))
                ctx.target = ctx.target - trunc_sum(lcdf(up, *args))

    # ----------------------------------------------------------- expressions

    def _indexers(self, indices, env, ctx):
        out = []
        for ix in indices:
            if isinstance(ix, A.Colon):
                out.append(slice(None))
            elif isinstance(ix, A.Range):
                lo = (
                    _static_int(self.eval_expr(ix.lower, env, ctx), ix, "index")
                    if ix.lower is not None else 1
                )
                up = (
                    _static_int(self.eval_expr(ix.upper, env, ctx), ix, "index")
                    if ix.upper is not None else None
                )
                out.append(slice(lo - 1, up))
            else:
                val = self.eval_expr(ix, env, ctx)
                if _is_concrete(val):
                    arr = np.asarray(val)
                    if arr.ndim == 0:
                        out.append(int(arr) - 1)
                    else:
                        out.append(arr.astype(np.int64) - 1)
                else:
                    out.append(xp.asarray(val) - 1)
        return out


    def _apply_binop(self, op: str, left, right, node):
        if isinstance(left, StanComplex) or isinstance(right, StanComplex):
            return _cplx_binop(op, left, right, node)
        if isinstance(left, (StanTuple, list)) or isinstance(
            right, (StanTuple, list)
        ):
            raise StanCompileError(
                f"operator {op!r} is not defined for tuple values",
                node.line, node.col,
            )
        concrete = _is_concrete(left) and _is_concrete(right)
        if concrete:
            la, ra = np.asarray(left), np.asarray(right)
            if op == "*" and (la.ndim >= 2 or ra.ndim >= 2):
                return _host_dot(la, ra)
            if op == "/" and la.dtype.kind == "i" and ra.dtype.kind == "i":
                return la // ra  # Stan integer division
            if op in _HOST_BINOPS:
                return _HOST_BINOPS[op](la, ra)
        a, b = xp.promote(_operand(left), _operand(right))
        if op == "*":
            return _dot(a, b)
        if op == "/":
            return _divide(a, b)
        if op in _DEVICE_BINOPS:
            return _DEVICE_BINOPS[op](a, b)
        raise StanCompileError(f"unsupported operator {op!r}", node.line, node.col)

    def eval_expr(self, node, env: dict, ctx: Ctx):
        if isinstance(node, A.Num):
            if node.is_imag:
                return StanComplex(0.0, node.value)
            return node.value
        if isinstance(node, A.StringLit):
            return node.value
        if isinstance(node, A.Var):
            if node.name in env:
                return env[node.name]
            fn = FUNCTIONS.get(node.name)
            if fn is not None:
                try:
                    return fn()
                except TypeError:
                    pass
            raise StanCompileError(
                f"undefined variable {node.name!r}", node.line, node.col
            )
        if isinstance(node, A.BinOp):
            left = self.eval_expr(node.left, env, ctx)
            right = self.eval_expr(node.right, env, ctx)
            return self._apply_binop(node.op, left, right, node)
        if isinstance(node, A.UnaryOp):
            val = self.eval_expr(node.operand, env, ctx)
            if node.op == "-":
                if isinstance(val, StanComplex):
                    return StanComplex(-val.re, -val.im)
                return -val if _is_concrete(val) else -xp.asarray(val)
            if node.op == "+":
                return val
            if node.op == "!":
                if _is_concrete(val):
                    return np.logical_not(np.asarray(val) != 0)
                return xp.logical_not(xp.asarray(val) != 0)
        if isinstance(node, A.Ternary):
            cond = self.eval_expr(node.cond, env, ctx)
            if _is_concrete(cond):
                branch = node.if_true if bool(np.asarray(cond)) else node.if_false
                return self.eval_expr(branch, env, ctx)
            a = self.eval_expr(node.if_true, env, ctx)
            b = self.eval_expr(node.if_false, env, ctx)
            return xp.where(xp.asarray(cond) != 0, _operand(a), _operand(b))
        if isinstance(node, A.Transpose):
            return _transpose(self.eval_expr(node.operand, env, ctx))
        if isinstance(node, A.TupleLit):
            return StanTuple(
                self.eval_expr(e, env, ctx) for e in node.elements
            )
        if isinstance(node, A.Member):
            base = self.eval_expr(node.base, env, ctx)
            field = node.field
            if isinstance(base, StanTuple):
                try:
                    slot = int(field)
                except ValueError:
                    raise StanCompileError(
                        f"tuple member access needs a slot number, got "
                        f".{field}", node.line, node.col,
                    ) from None
                if not 1 <= slot <= len(base.slots):
                    raise StanCompileError(
                        f"tuple slot {slot} out of range (1.."
                        f"{len(base.slots)})", node.line, node.col,
                    )
                return base.slots[slot - 1]
            if field in ("real", "imag"):
                c = _to_cplx(base)
                return c.re if field == "real" else c.im
            raise StanCompileError(
                f"member access .{field} is only defined for tuples "
                f"(.1, .2, ...) and complex values (.real/.imag)",
                node.line, node.col,
            )
        if isinstance(node, A.Index):
            base = self.eval_expr(node.base, env, ctx)
            if isinstance(base, StanComplex):
                idx = tuple(self._indexers(node.indices, env, ctx))
                return StanComplex(
                    _index_value(base.re, idx), _index_value(base.im, idx)
                )
            if isinstance(base, (list, StanTuple)) or (
                isinstance(base, np.ndarray) and base.dtype == object
            ):
                # array-of-tuples (nested python lists): concrete indexing
                seq = base if isinstance(base, list) else list(base)
                for ix in node.indices:
                    val = self.eval_expr(ix, env, ctx)
                    seq = seq[_static_int(val, node, "tuple array index") - 1]
                return seq
            # a batched index (the vmapped loop variable) forces the device
            # gather even for host data arrays
            return _index_value(base, tuple(self._indexers(node.indices, env, ctx)))
        if isinstance(node, A.ArrayLit):
            vals = [self.eval_expr(e, env, ctx) for e in node.elements]
            if any(
                isinstance(v, (StanTuple, StanComplex, list)) for v in vals
            ):
                # arrays of tuples/complex stay python lists: structure is
                # static on the host, leaves are tensors
                return vals
            if all(_is_concrete(v) for v in vals):
                return np.stack([np.asarray(v) for v in vals])
            return xp.stack(vals)
        if isinstance(node, A.RowVectorLit):
            vals = [self.eval_expr(e, env, ctx) for e in node.elements]
            row = xp.stack([xp.asarray(v, xp.fdtype())
                             for v in vals])
            if row.ndim == 1:
                return row.reshape(1, -1)
            # [row_vector, row_vector, ...] -> matrix
            return row.reshape(len(vals), -1)
        if isinstance(node, A.Call):
            return self.eval_call(node, env, ctx)
        raise StanCompileError(
            f"unsupported expression {type(node).__name__}",
            node.line, node.col,
        )

    def eval_call(self, node: A.Call, env: dict, ctx: Ctx):
        name = node.name
        if name == "target":
            return ctx.target
        if name in stan_functionals.FUNCTIONAL_NAMES:
            return stan_functionals.eval_functional(self, name, node, env,
                                                    ctx)
        raw_args = [self.eval_expr(a, env, ctx) for a in node.args]

        # user-defined functions
        if name in self.functions:
            return self.functions[name](ctx, *raw_args)
        if name in _HOST_FUNCTIONS and all(_is_concrete(a) for a in raw_args):
            return FUNCTIONS[name](*raw_args)
        args = [_operand(a) for a in raw_args]

        # distribution-suffixed calls: normal_lpdf(y | mu, sigma)
        for suffix in ("_lpdf", "_lupdf", "_lpmf", "_lupmf"):
            if name.endswith(suffix):
                dist = name[: -len(suffix)]
                fn = DISTRIBUTIONS.get(dist)
                if fn is None:
                    break
                return xp.sum(fn(*args))
        for suffix, table in (("_lcdf", LCDFS), ("_lccdf", LCCDFS)):
            if name.endswith(suffix):
                dist = name[: -len(suffix)]
                fn = table.get(dist)
                if fn is None:
                    raise StanCompileError(
                        f"unsupported function {name!r}", node.line, node.col
                    )
                return xp.sum(fn(*args))
        if name.endswith("_cdf"):
            # Stan cdf semantics: container arguments produce the JOINT
            # probability (product of elementwise cdfs) = exp(sum(lcdf))
            dist = name[: -len("_cdf")]
            fn = LCDFS.get(dist)
            if fn is None:
                raise StanCompileError(
                    f"unsupported function {name!r}", node.line, node.col
                )
            return xp.exp(xp.sum(fn(*args)))
        if name.endswith("_rng"):
            fn = RNG_FUNCTIONS.get(name)
            if fn is None:
                raise StanCompileError(
                    f"unsupported rng function {name!r}", node.line, node.col
                )
            return fn(ctx.next_key(node), *args)

        # shape queries need concrete handling
        if name in ("num_elements", "size"):
            arr = raw_args[0]
            return int(np.prod(np.shape(arr))) if name == "num_elements" else (
                int(np.shape(arr)[0]) if np.ndim(arr) else 1
            )
        if name == "rows":
            shape = np.shape(raw_args[0])
            return int(shape[0]) if len(shape) >= 1 else 1
        if name == "cols":
            shape = np.shape(raw_args[0])
            return int(shape[-1]) if len(shape) >= 2 else (
                int(shape[0]) if len(shape) == 1 else 1
            )
        if name == "dims":
            return np.asarray(np.shape(raw_args[0]), np.int64)

        # complex-aware helpers (args may be StanComplex, which the plain
        # FUNCTIONS table cannot consume)
        if name == "to_complex":
            re = args[0] if args else 0.0
            im = args[1] if len(args) > 1 else 0.0
            return StanComplex(xp.asarray(re), xp.asarray(im))
        if name in ("get_real", "get_imag"):
            z = _to_cplx(args[0])
            return z.re if name == "get_real" else z.im
        if name == "conj":
            z = _to_cplx(args[0])
            return StanComplex(z.re, -xp.asarray(z.im))
        if name == "abs" and isinstance(args[0], StanComplex):
            return xp.hypot(xp.asarray(args[0].re),
                             xp.asarray(args[0].im))
        if name == "norm" and (args and isinstance(args[0], StanComplex)):
            z = args[0]
            re, im = xp.asarray(z.re), xp.asarray(z.im)
            return re * re + im * im
        if name == "arg":
            z = _to_cplx(args[0])
            return xp.arctan2(xp.asarray(z.im), xp.asarray(z.re))
        if name == "polar":
            r, theta = xp.asarray(args[0]), xp.asarray(args[1])
            return StanComplex(r * xp.cos(theta), r * xp.sin(theta))
        if name == "proj":
            # std::proj: the point itself unless infinite, then +inf+0i
            z = _to_cplx(args[0])
            re, im = xp.asarray(z.re), xp.asarray(z.im)
            inf = xp.isinf(re) | xp.isinf(im)
            return StanComplex(
                xp.where(inf, xp.inf, re),
                xp.where(inf, xp.copysign(0.0, im), im),
            )

        fn = FUNCTIONS.get(name)
        if fn is None:
            raise StanCompileError(
                f"unsupported function {name!r}", node.line, node.col
            )
        if name in ("log2", "log10") and not args:
            return xp.log(2.0) if name == "log2" else xp.log(10.0)
        return fn(*args)
