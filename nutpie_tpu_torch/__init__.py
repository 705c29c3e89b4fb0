"""nutpie_tpu_torch: the nutpie-tpu sampler in PyTorch, with CUDA kernels.

A port of ``nutpie_tpu`` (JAX/XLA, TPU) to PyTorch on NVIDIA Hopper.  The
JAX package stays the reference; this package imports nothing of it.  The
first slice covers the main path: NUTS with the gradient-based diagonal
mass-matrix adaptation over a fleet of chains on the radon model, where
every chunk of draws on the card runs through one hand-written CUDA kernel
(``csrc/megakernel.cu``).  On the CPU the same path runs the kernel's plain
torch version.
"""

__version__ = "0.1.0"

from . import models
from .frontends.pyfunc import from_pyfunc
from .model import CompiledModel
from .sample import sample
from .settings import NutsSettings

__all__ = [
    "__version__",
    "sample",
    "from_pyfunc",
    "CompiledModel",
    "NutsSettings",
    "models",
]
