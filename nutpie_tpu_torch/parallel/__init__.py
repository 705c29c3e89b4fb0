from .mesh import (
    ChainMesh,
    broadcast_flag,
    chain_mesh,
    chain_row,
    collectives,
    gather_chains,
    gather_to_root,
    initialize_distributed,
    local_rows,
    shard_chains,
)

__all__ = [
    "ChainMesh",
    "chain_mesh",
    "shard_chains",
    "initialize_distributed",
    "gather_chains",
    "chain_row",
    "gather_to_root",
    "broadcast_flag",
    "local_rows",
    "collectives",
]
