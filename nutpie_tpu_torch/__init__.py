"""nutpie_tpu_torch: the nutpie-tpu sampler in PyTorch, with CUDA kernels.

A port of ``nutpie_tpu`` (JAX/XLA, TPU) to PyTorch on NVIDIA Hopper.  The
JAX package stays the reference; this package imports nothing of it.  The
first slice covers the main path: NUTS with the gradient-based diagonal
mass-matrix adaptation over a fleet of chains on the radon model, where
every chunk of draws on the card runs through one hand-written CUDA kernel
(``csrc/megakernel.cu``); every other model, a Stan program compiled by
``compile_stan_model`` or a PyMC model by ``compile_pymc_model`` among
them, runs through the step kernel (``csrc/step_kernel.cu``), and
``sampler="mclmc"`` through the MCLMC kernel (``csrc/mclmc.cu``).  On
the CPU the same paths run the kernels' plain torch versions.  ``sample`` runs in the background with the JAX
package's control surface, progress, checkpoints and Zarr storage.
"""

__version__ = "0.1.0"

from . import models
from .frontends.pyfunc import from_pyfunc
from .frontends.stan import CompiledStanModel, compile_stan_model, prune_stan_cache
from .model import CompiledModel
from .progress import ChainProgress
from .sample import sample
from .settings import MclmcSettings, NutsSettings


def compile_pymc_model(model, **kwargs):
    """Compile a PyMC model (requires pymc and pytensor installed;
    ``frontends/pymc.py``)."""
    from .frontends.pymc import compile_pymc_model as _impl

    return _impl(model, **kwargs)


__all__ = [
    "__version__",
    "sample",
    "from_pyfunc",
    "compile_stan_model",
    "compile_pymc_model",
    "CompiledStanModel",
    "prune_stan_cache",
    "CompiledModel",
    "NutsSettings",
    "MclmcSettings",
    "ChainProgress",
    "models",
    "zarr_store",
]

from . import zarr_store  # noqa: E402  (public submodule, as in nutpie_tpu)
