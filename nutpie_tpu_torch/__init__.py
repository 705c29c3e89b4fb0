"""nutpie_tpu_torch: the nutpie-tpu sampler in PyTorch, with CUDA kernels.

A port of ``nutpie_tpu`` (JAX/XLA, TPU) to PyTorch on NVIDIA Hopper.  The
JAX package stays the reference; this package imports nothing of it.  The
first slice covers the main path: NUTS with the gradient-based diagonal
mass-matrix adaptation over a fleet of chains on the radon model, where
every chunk of draws on the card runs through one hand-written CUDA kernel
(``csrc/megakernel.cu``); every other model runs through the step kernel
(``csrc/step_kernel.cu``), and ``sampler="mclmc"`` through the MCLMC
kernel (``csrc/mclmc.cu``).  On the CPU the same paths run the kernels'
plain torch versions.  ``sample`` runs in the background with the JAX
package's control surface, progress, checkpoints and Zarr storage.
"""

__version__ = "0.1.0"

from . import models
from .frontends.pyfunc import from_pyfunc
from .model import CompiledModel
from .progress import ChainProgress
from .sample import sample
from .settings import MclmcSettings, NutsSettings

__all__ = [
    "__version__",
    "sample",
    "from_pyfunc",
    "CompiledModel",
    "NutsSettings",
    "MclmcSettings",
    "ChainProgress",
    "models",
    "zarr_store",
]

from . import zarr_store  # noqa: E402  (public submodule, as in nutpie_tpu)
