"""Chain-axis sharding over the ranks of a ``torch.distributed`` group.

The port of ``nutpie_tpu/parallel/mesh.py``.  The JAX package shards the
chains axis of every state and buffer over a 1-D device mesh; every
sampler operation is elementwise over chains, and the only cross-chain
traffic is at chunk boundaries: pooled adaptation, the fleet depth cap,
the trapped-chain rescue and the init outlier screen.  Here each rank of
a process group runs its slice of the fleet on its own device (one card a
rank under NCCL; the CPU under gloo, only where the caller asks for it).

Every chunk-boundary operation that reads across chains follows one rule:
gather the whole fleet's input in rank order, which is chain order
(``gather_chains``), apply the function the one-rank path applies to the
same ``[C, ...]`` tensor, and keep this rank's rows.  No partial sum is
reduced across ranks: its order of addition would depend on the world
size, and a split fleet would round differently from one process.  So a
fleet split over any number of ranks samples bit for bit what one process
samples with the whole fleet.  With a group of one rank the collectives
still go through the group.

Several cards: one process a card (``torchrun --nproc-per-node N
script.py``), each calling ``initialize_distributed()`` and then
``sample()`` with the same arguments; see ``sample.py`` for what each
rank returns.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

# the group initialize_distributed made and the device it bound
_BOUND: tuple = (None, None)


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """The ranks a fleet's chains are split over.

    ``size`` ranks, this process's ``rank``, its ``device`` and the
    process ``group`` (None: one rank, no group).  ``whole``: every rank
    holds the whole fleet (a chain count the size does not divide), so the
    collectives over chains have nothing to gather.
    """

    size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Any = None
    whole: bool = False

    @property
    def root(self) -> bool:
        return self.rank == 0

    def for_chains(self, n_chains: int) -> "ChainMesh":
        """The mesh a fleet of ``n_chains`` runs on: this one where the
        size divides the chain count, else a copy with ``whole`` set (every
        rank runs the whole fleet), with a warning."""
        if self.whole or n_chains % self.size == 0:
            return self
        warnings.warn(
            f"{n_chains} chains do not split evenly over {self.size} ranks: every rank "
            "runs the whole fleet (use a multiple of the world size)", stacklevel=3)
        return dataclasses.replace(self, whole=True)


def _split(mesh: Optional[ChainMesh]) -> bool:
    """Whether the chains are split over the mesh's group."""
    return mesh is not None and mesh.group is not None and not mesh.whole


def local_rows(mesh: Optional[ChainMesh], n_chains: int) -> slice:
    """This rank's chains of a fleet of ``n_chains``."""
    if not _split(mesh):
        return slice(None)
    per = n_chains // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def chain_mesh(device=None) -> ChainMesh:
    """The mesh of the initialized process group, on this rank's device
    (the one ``initialize_distributed`` bound; else CUDA's current device
    under NCCL and the CPU under gloo).  Without an initialized group, a
    one-rank mesh on ``device`` (default CUDA)."""
    if not (dist.is_available() and dist.is_initialized()):
        return ChainMesh(device=torch.device("cuda" if device is None else device))
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    if _BOUND[0] is group:
        bound = _BOUND[1]
    elif backend == "nccl":
        bound = torch.device("cuda", torch.cuda.current_device())
    else:
        bound = torch.device("cpu")
    if device is not None:
        asked = torch.device(device)
        if asked.type != bound.type or asked.index not in (None, bound.index):
            raise ValueError(f"this rank's group ({backend}) runs on {bound}, not {asked}")
    return ChainMesh(dist.get_world_size(group), dist.get_rank(group), bound, group)


def shard_chains(tree, mesh: ChainMesh):
    """This rank's slice of each leaf's leading (chains) axis.

    ``tree`` is a tensor, a dict of tensors or a chain state (a
    ``NutsMachineState`` or an ``MclmcState``: anything with
    ``tensors()`` whose fields are its constructor's keywords).  A chain
    count that the size does not divide leaves the tree whole: every rank
    runs the whole fleet (``ChainMesh.for_chains`` warns once).
    """
    if isinstance(tree, torch.Tensor):
        leaves = {"": tree}
    elif isinstance(tree, dict):
        leaves = tree
    else:
        leaves = tree.tensors()
    if not leaves:
        return tree
    n_chains = next(iter(leaves.values())).shape[0]
    mesh = mesh.for_chains(n_chains)
    if not _split(mesh):
        return tree
    rows = local_rows(mesh, n_chains)
    out = {name: t[rows].clone() for name, t in leaves.items()}
    if isinstance(tree, torch.Tensor):
        return out[""]
    if isinstance(tree, dict):
        return out
    return type(tree)(**out)


class CollectiveLog:
    """What the mesh's collectives moved on this rank: ``calls``, ``bytes``
    (the gathered or broadcast tensors' bytes) and, with ``timing`` on
    (``reset(timing=True)``), the seconds between CUDA events recorded on
    the current stream around each call (host seconds on the CPU), read by
    ``seconds()``, which waits for them."""

    def __init__(self):
        self.reset()

    def reset(self, timing: bool = False) -> None:
        self.calls = 0
        self.bytes = 0
        self.timing = timing
        self._events: list = []
        self._host_s = 0.0

    def seconds(self) -> float:
        device_s = sum(a.elapsed_time(b) for a, b in self._events) / 1000.0
        return self._host_s + device_s

    def run(self, nbytes: int, device: torch.device, fn):
        self.calls += 1
        self.bytes += int(nbytes)
        if not self.timing:
            return fn()
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record(stream)
            out = fn()
            b.record(stream)
            self._events.append((a, b))
            return out
        t0 = time.perf_counter()
        out = fn()
        self._host_s += time.perf_counter() - t0
        return out


collectives = CollectiveLog()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _all_gather(out: torch.Tensor, t: torch.Tensor, group) -> None:
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=group)


def gather_chains(t: torch.Tensor, mesh: Optional[ChainMesh]) -> torch.Tensor:
    """The whole fleet's ``[C, ...]`` in chain order, on every rank (``t``
    itself where the chains are not split)."""
    if not _split(mesh):
        return t
    t = t.contiguous()
    out = torch.empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    collectives.run(_nbytes(out), t.device, lambda: _all_gather(out, t, mesh.group))
    return out


def chain_row(t: torch.Tensor, index: torch.Tensor, mesh: Optional[ChainMesh]) -> torch.Tensor:
    """Row ``index`` (a one-element device tensor, a chain of the whole
    fleet) of the fleet's ``t``, ``[1, ...]``, taken from the rank that
    owns it, on every rank.  No host sync: each rank offers the row at the
    index's place in its slice, and the owner's is selected on the device."""
    index = index.reshape(1)
    if not _split(mesh):
        return t.index_select(0, index)
    per = t.shape[0]
    offered = t.index_select(0, torch.clamp(index - mesh.rank * per, 0, per - 1))
    return gather_chains(offered, mesh).index_select(
        0, torch.div(index, per, rounding_mode="floor"))


def gather_to_root(tensors: dict, mesh: Optional[ChainMesh]) -> Optional[dict]:
    """Each tensor's whole fleet ``[C, ...]`` in chain order on rank 0
    (``dist.gather`` into one buffer), by name; None on the other ranks.
    Where the chains are not split, rank 0 gets ``tensors`` as they are."""
    root = mesh is None or mesh.root
    if not _split(mesh):
        return tensors if root else None
    out = {}
    for name, t in tensors.items():
        t = t.contiguous()
        full = None
        if root:
            full = torch.empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]),
                               dtype=t.dtype, device=t.device)
        parts = list(full.chunk(mesh.size)) if root else None
        collectives.run(_nbytes(t) * (mesh.size if root else 1), t.device,
                        lambda: dist.gather(t, parts, dst=0, group=mesh.group))
        out[name] = full
    return out if root else None


def broadcast_flag(x: int, mesh: Optional[ChainMesh]) -> int:
    """Rank 0's integer ``x`` on every rank (control state at a chunk
    boundary); ``x`` itself without a group."""
    if mesh is None or mesh.group is None:
        return int(x)
    t = torch.tensor([int(x)], dtype=torch.int64, device=mesh.device)
    collectives.run(_nbytes(t), mesh.device,
                    lambda: dist.broadcast(t, src=0, group=mesh.group))
    return int(t.item())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None, timeout: float = 600.0) -> ChainMesh:
    """Join the process group (idempotent) and return its mesh.

    The defaults come from torchrun's environment: the coordinator
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` processes, this one
    ``RANK``, and its card ``cuda:LOCAL_RANK`` (made current with
    ``torch.cuda.set_device``) under NCCL.  ``device="cpu"`` joins over
    gloo instead, the only way to run ranks on the CPU; without CUDA any
    other device raises.  ``coordinator_address`` is ``host:port`` or an
    ``init_method`` URL (``tcp://...``, ``file://...``).  A collective
    that waits longer than ``timeout`` seconds for another rank raises, so
    a rank that dies does not hold the others forever.
    """
    global _BOUND
    if dist.is_initialized():
        return chain_mesh()
    env = os.environ
    if coordinator_address is None:
        if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            raise ValueError("no coordinator address: pass coordinator_address or set "
                             "MASTER_ADDR and MASTER_PORT (torchrun sets them)")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_distributed() runs each rank on a CUDA card over NCCL and "
                "found none; pass device='cpu' to run the ranks on the CPU over gloo")
        asked = torch.device("cuda" if device is None else device)
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        bound = asked if asked.index is not None else torch.device("cuda", local)
        torch.cuda.set_device(bound)
        backend = "nccl"
    elif torch.device(device).type == "cpu":
        bound, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"initialize_distributed runs on 'cuda' or 'cpu', not {device!r}")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    # NCCL's communicator starts here (device_id), not inside the first
    # collective of a run, where its start would be timed with the gather
    bind = {"device_id": bound} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=float(timeout)), **bind)
    _BOUND = (dist.group.WORLD, bound)
    return chain_mesh()
