"""The port's Stan lexer and parser against the JAX package's.

Every Stan program in the JAX package's Stan tests (``test_stan.py``,
``test_stan_loops.py``, ``test_transforms.py``, ``test_stanlib_breadth.py``:
each string constant that opens a program block) parses to an AST whose
``repr`` is the JAX package's, or fails with the same ``StanCompileError``
message, line and column.  So do malformed programs.  Three constructs
the compiler does not implement (``jacobian +=``, ``profile`` blocks and
foreach loops) raise a ``StanCompileError`` at their location in the port
(the JAX package misreads them: ROADMAP queue 3), and every looping
functional compiles and evaluates as in the JAX package.
"""

import ast
import re
from pathlib import Path

import pytest

from nutpie_tpu.frontends.stan import errors as jerrors
from nutpie_tpu.frontends.stan.parser import parse as jparse
import nutpie_tpu_torch as nt
from nutpie_tpu_torch.frontends.stan import StanCompileError
from nutpie_tpu_torch.frontends.stan.parser import parse as tparse
from torch_stan_programs import FUNCTIONAL_CASES

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

TESTS = Path(__file__).parent
SOURCES = ["test_stan.py", "test_stan_loops.py", "test_transforms.py",
           "test_stanlib_breadth.py"]
_BLOCK = re.compile(r"\b(model|parameters|data|generated quantities|transformed data"
                    r"|functions)\s*\{")


def _programs():
    out = []
    for name in SOURCES:
        tree = ast.parse((TESTS / name).read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and _BLOCK.search(node.value)):
                out.append(pytest.param(node.value, id=f"{name}:{node.lineno}"))
    return out


PROGRAMS = _programs()

MALFORMED = [
    "parameters { real x } model { x ~ normal(0, 1); }",
    "parameters { real x; } model { x ~ normal(0, 1) }",
    "data { int N; } parameters { vector[N x; }",
    "model { target += ; }",
    "parameters { real<lower=0 x; } model { }",
    "parameters { real x; }\nmodel {\n  x ~ normal(0, 1);\n  y = ;\n}",
    "functions { real f(real x) { return x } } model { }",
    "generated quantities { real z = 1 +; }",
    "parameters { real x; } model { for (i in 1:3 { } }",
    "model { real x; x = 1 ? 2; }",
    "paramters { real x; }",
    'model { x ~ normal(0, 1); "unterminated }',
]


def _outcome(parse, errors, code):
    try:
        return ("ok", repr(parse(code)))
    except errors.StanCompileError as err:
        return ("error", str(err), err.line, err.col)


def test_the_sources_hold_programs():
    assert len(PROGRAMS) >= 30


@pytest.mark.parametrize("code", PROGRAMS)
def test_program_parses_as_in_jax(code):
    from nutpie_tpu_torch.frontends.stan import errors as terrors

    assert _outcome(tparse, terrors, code) == _outcome(jparse, jerrors, code)


@pytest.mark.parametrize("code", MALFORMED)
def test_compile_error_reads_as_in_jax(code):
    from nutpie_tpu_torch.frontends.stan import errors as terrors

    want = _outcome(jparse, jerrors, code)
    assert want[0] == "error"
    assert _outcome(tparse, terrors, code) == want


GAPS = {
    "jacobian": ("parameters { real x; }\nmodel {\n  jacobian += x;\n}", 3, 3,
                 "'jacobian +='"),
    "profile": ('parameters { real x; }\nmodel {\n  profile("lik") { x ~ normal(0, 1); }\n}',
                3, 3, "profile blocks"),
    "foreach": ("data { array[3] real xs; } parameters { real m; }\n"
                "model {\n  for (x in xs) x ~ normal(m, 1);\n}", 3, 3, "foreach loops"),
}


@pytest.mark.parametrize("name", sorted(GAPS))
def test_language_gaps_raise_compile_errors(name):
    code, line, col, words = GAPS[name]
    with pytest.raises(StanCompileError, match=re.escape(words)) as err:
        nt.compile_stan_model(code)
    assert (err.value.line, err.value.col) == (line, col)


@pytest.mark.parametrize("name", sorted(FUNCTIONAL_CASES))
def test_functional_compiles_and_evaluates_as_in_jax(name):
    """Every functional the port once refused compiles, and its program's
    log density at two seeded points is the JAX package's (float64, rtol
    1e-9), with a finite gradient (``test_torch_stan_functionals.py``
    holds the gradients to the JAX package's)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import nutpie_tpu as nj

    code, data = FUNCTIONAL_CASES[name]
    assert f"{name}(" in code
    jm = nj.compile_stan_model(code=code).with_data(**data())._make_model(0)
    tm = nt.compile_stan_model(code).with_data(**data())._make_model(0)
    x = np.random.default_rng(5).normal(size=(2, tm.ndim)) * 0.3
    lt, gt = tm.logp_and_grad(torch.as_tensor(x))
    np.testing.assert_allclose(lt.numpy(), np.asarray(jax.vmap(jm.logp_fn)(jnp.asarray(x))),
                               rtol=1e-9, atol=1e-12)
    assert torch.isfinite(gt).all()
