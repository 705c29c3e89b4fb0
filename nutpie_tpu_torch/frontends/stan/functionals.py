"""Stan's higher-order functionals on the card.

``reduce_sum``/``reduce_sum_static`` and ``map_rect`` are plain calls and
are ported from the JAX package:

- ``reduce_sum`` exploits an exact identity: the partial-sum function must
  satisfy ``sum_i f(slice_i, start_i, end_i, ...) == f(x, 1, N, ...)`` for
  any partition (that is what makes Stan's parallelization valid), so the
  whole call evaluates as ONE call on the full slice.  The batched
  evaluation already vectorizes the body; the grainsize hint has no role.
- ``map_rect`` unrolls over the (static) job axis and concatenates the
  results.

The JAX package's other functionals (``integrate_1d``, the ODE and DAE
solvers, the algebraic solvers) loop until the data say stop: an adaptive
ODE step, a Newton iteration to tolerance.  In torch such a stop reads the
device, which a CUDA graph cannot capture, so they wait for a design with
fixed iteration counts and masking.  A program that calls one is refused
when it is compiled, on every device, before anything runs
(``refuse_unported``), naming that ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import ast_nodes as A
from . import xp
from .errors import StanCompileError

# the ROADMAP item that ports the rest
UNPORTED_ITEM = "Stan functionals on the card"

UNPORTED = frozenset({
    "integrate_1d",
    "integrate_ode", "integrate_ode_rk45", "integrate_ode_bdf",
    "integrate_ode_adams",
    "ode_rk45", "ode_rk45_tol", "ode_bdf", "ode_bdf_tol", "ode_adams",
    "ode_adams_tol", "ode_ckrk", "ode_ckrk_tol", "ode_adjoint_tol_ctl",
    "dae", "dae_tol",
    "algebra_solver", "algebra_solver_newton",
    "solve_newton", "solve_newton_tol", "solve_powell", "solve_powell_tol",
})


def _first_dim(x, node, what):
    if isinstance(x, (list, tuple)):
        return len(x)
    shape = xp.shape(x)
    if not shape:
        raise StanCompileError(
            f"{what} must be an array (got a scalar)", node.line, node.col
        )
    return int(shape[0])


def _rows(x, n):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x[j] for j in range(n)]


# --------------------------------------------------------- reduce_sum

def _reduce_sum(f, args, node, ctx):
    if len(args) < 2:
        raise StanCompileError(
            "reduce_sum(f, x, grainsize, ...) needs at least a sliced "
            "argument and a grainsize", node.line, node.col,
        )
    x, _grainsize, *shared = args
    n = _first_dim(x, node, "the sliced argument of reduce_sum")
    # exact semantic identity: one partition = the whole slice
    return f(x, 1, n, *shared)


# ----------------------------------------------------------- map_rect

def _map_rect(f, args, node, ctx):
    if len(args) != 4:
        raise StanCompileError(
            "map_rect(f, phi, thetas, x_rs, x_is) takes exactly 5 "
            "arguments", node.line, node.col,
        )
    phi, thetas, x_rs, x_is = args
    n_jobs = _first_dim(thetas, node, "the job-parameters argument of "
                        "map_rect")
    th = _rows(thetas, n_jobs)
    xr = _rows(x_rs, n_jobs)
    xi = _rows(x_is, n_jobs)
    outs = []
    for j in range(n_jobs):
        out = f(phi, th[j], xr[j], xi[j])
        outs.append(xp.ravel(out if not isinstance(out, np.ndarray) or out.ndim
                             else out.item()))
    return xp.concatenate(outs) if outs else xp.zeros((0,))


# ------------------------------------------------------------- dispatch

IMPLS = {
    "reduce_sum": _reduce_sum,
    "reduce_sum_static": _reduce_sum,
    "map_rect": _map_rect,
}

FUNCTIONAL_NAMES = frozenset(IMPLS)


def refuse_unported(program) -> None:
    """Raise ``StanCompileError`` at the first call of a functional that
    is not ported yet (``UNPORTED``), with its line and column."""

    def visit(node):
        if isinstance(node, A.Call) and node.name in UNPORTED:
            raise StanCompileError(
                f"{node.name!r} is not available in nutpie_tpu_torch yet: "
                f"its solver loops until the data say stop, which a CUDA "
                f"graph cannot capture (ROADMAP queue 1, "
                f"\"{UNPORTED_ITEM}\")",
                node.line, node.col,
            )
        if dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                visit(getattr(node, f.name))
        elif isinstance(node, (list, tuple)):
            for item in node:
                visit(item)

    visit(program)


def eval_functional(interp, name, node, env, ctx):
    """Resolve the function-valued first argument and dispatch.

    Called from the interpreter BEFORE normal argument evaluation (the
    first argument names a function, which is not a value in any
    environment)."""
    if not node.args:
        raise StanCompileError(
            f"{name!r} needs a function as its first argument",
            node.line, node.col,
        )
    fa = node.args[0]
    if not isinstance(fa, A.Var) or fa.name not in interp.functions:
        raise StanCompileError(
            f"the first argument of {name!r} must name a user-defined "
            f"function from the functions block",
            node.line, node.col,
        )
    ufn = interp.functions[fa.name]

    def f(*fargs):
        return ufn(ctx, *fargs)

    args = [interp.eval_expr(a, env, ctx) for a in node.args[1:]]
    return IMPLS[name](f, args, node, ctx)
