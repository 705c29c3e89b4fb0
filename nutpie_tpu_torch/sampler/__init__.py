from .adapt import AdaptConfig
from .nuts import ChunkBuffers, NutsConfig
from .run import init_chains, resolve_dtype

__all__ = [
    "AdaptConfig",
    "ChunkBuffers",
    "NutsConfig",
    "init_chains",
    "resolve_dtype",
]
