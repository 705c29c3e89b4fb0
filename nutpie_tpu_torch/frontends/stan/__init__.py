"""Stan frontend: a Stan -> torch compiler for the card.

The port of ``nutpie_tpu/frontends/stan``.  The lexer, parser, AST and
errors are copies of the JAX package's, so a program parses to the same
tree and a syntax error reads the same in both.  The interpreter walks the
tree per chain and is batched over chains with ``torch.func.vmap``; its
log density runs inside the step runner's CUDA graphs on the card (K2
around it, ``sampler/run.py``) and through K2's plain version on the CPU.
Data stay on the host for control flow and are held on the device once
per device and dtype for the math.

Supported: the core Stan language (data/transformed data/parameters/
transformed parameters/model/generated quantities blocks, scalar/vector/
matrix/array/tuple/complex types, lower/upper/simplex/ordered/...
constraints, control flow, the distributions and math library of the JAX
package) and every functional of the JAX package: ``reduce_sum``,
``map_rect``, ``integrate_1d``, the ODE solvers with their adjoint, the
DAE solvers and the algebraic solvers (``functionals.py``).  A log
density that calls an ODE, DAE or algebraic solver loops until the data
say stop, so the runners call it eagerly around their kernels instead of
replaying a CUDA graph (the model's ``eager_logp``): the step runner
around K2 under NUTS, the MCLMC runner around K3, with or without flow
adaptation.  Unsupported constructs raise ``StanCompileError`` at
compile time with a source location.

API parity: ``compile_stan_model(code=..., filename=...)`` and
``CompiledStanModel.with_data(...)`` mirror the reference
(``python/nutpie/compile_stan.py:250-386``); ``prune_stan_cache`` exists
for API compatibility.
"""

from .api import CompiledStanModel, compile_stan_model, prune_stan_cache
from .errors import StanCompileError, StanRuntimeError

__all__ = [
    "compile_stan_model",
    "CompiledStanModel",
    "prune_stan_cache",
    "StanCompileError",
    "StanRuntimeError",
]
