"""The port's chain mesh in one process (the counterpart of
``tests/test_parallel.py``).

- ``chain_mesh`` without a group is one rank; ``shard_chains`` gives rank r
  of n its rows of every leaf (a dict, a ``NutsMachineState``); a chain
  count the size does not divide leaves the tree whole, with one warning,
  and the collectives then gather nothing.
- ``initialize_distributed`` is idempotent; inside a one-rank gloo group
  the collectives go through the group and return the fleet as it is, and
  ``sample()`` there equals ``sample()`` without a group bitwise.
- Without CUDA, ``initialize_distributed()`` raises unless ``device="cpu"``;
  without a coordinator it raises too.
"""

import socket
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import nutpie_tpu_torch as nt
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.parallel import (
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
from nutpie_tpu_torch.sampler.nuts import NutsConfig
from nutpie_tpu_torch.sampler.run import init_chains

torch.set_num_threads(1)

# a stand-in group: shard_chains only reads the layout, it communicates nothing
_LAYOUT_GROUP = object()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group on the CPU, destroyed afterwards."""
    assert not dist.is_initialized()
    mesh = initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu",
                                  timeout=60.0)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_mesh_without_group_is_one_rank():
    assert not dist.is_initialized()
    mesh = chain_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.whole) == (1, 0, None, False)
    assert mesh.device == torch.device("cpu") and mesh.root
    assert chain_mesh().device.type == "cuda"  # the port's default device
    t = torch.arange(6.0).reshape(3, 2)
    assert gather_chains(t, mesh) is t and gather_chains(t, None) is t
    assert shard_chains({"x": t}, mesh)["x"] is t
    assert torch.equal(chain_row(t, torch.tensor([2]), None), t[2:3])
    assert broadcast_flag(7, None) == 7


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_sharding_layout(rank):
    mesh = ChainMesh(size=4, rank=rank, group=_LAYOUT_GROUP)
    tree = {"x": torch.arange(48.0).reshape(16, 3), "y": torch.arange(16)}
    out = shard_chains(tree, mesh)
    assert local_rows(mesh, 16) == slice(4 * rank, 4 * rank + 4)
    assert torch.equal(out["x"], tree["x"][4 * rank:4 * rank + 4])
    assert torch.equal(out["y"], torch.arange(4 * rank, 4 * rank + 4))
    assert torch.equal(shard_chains(tree["x"], mesh), out["x"])


def test_sharding_a_chain_state():
    model = nt.models.std_normal(3)
    states, _ = init_chains(model, NutsConfig(), 4, 8, np.zeros(3), torch.float64)
    part = shard_chains(states, ChainMesh(size=2, rank=1, group=_LAYOUT_GROUP))
    assert type(part) is type(states)
    for name, t in states.tensors().items():
        assert torch.equal(part.tensors()[name], t[4:]), name


def test_indivisible_chain_count_stays_whole():
    mesh = ChainMesh(size=4, rank=2, group=_LAYOUT_GROUP)
    tree = {"x": torch.zeros((10, 3))}
    with pytest.warns(UserWarning, match="whole fleet"):
        out = shard_chains(tree, mesh)
    assert out is tree
    with pytest.warns(UserWarning, match="whole fleet"):
        whole = mesh.for_chains(10)
    assert whole.whole and local_rows(whole, 10) == slice(None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert whole.for_chains(10) is whole  # warned once
        assert shard_chains(tree, whole) is tree
    t = torch.arange(10.0)
    assert gather_chains(t, whole) is t  # nothing to gather
    assert gather_to_root({"t": t}, whole) is None  # rank 2 gets nothing
    assert mesh.for_chains(12) is mesh


def test_initialize_distributed_is_idempotent(one_rank_group):
    mesh = one_rank_group
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    assert mesh.group is not None and dist.get_backend() == "gloo"
    again = initialize_distributed("127.0.0.1:1", 4, 3, device="cpu")
    assert again == mesh == chain_mesh()
    with pytest.raises(ValueError, match="runs on cpu"):
        chain_mesh("cuda")


def test_one_rank_collectives_go_through_the_group(one_rank_group):
    mesh = one_rank_group
    collectives.reset(timing=True)
    t = torch.arange(12.0).reshape(4, 3)
    g = gather_chains(t, mesh)
    assert g is not t and torch.equal(g, t)
    assert torch.equal(chain_row(t, torch.tensor([2]), mesh), t[2:3])
    root = gather_to_root({"t": t, "b": t > 5}, mesh)
    assert torch.equal(root["t"], t) and torch.equal(root["b"], t > 5)
    assert broadcast_flag(2, mesh) == 2
    # gather, chain_row's gather, two gathers to the root, one broadcast
    assert collectives.calls == 5
    assert collectives.bytes == 48 + 12 + 48 + 12 + 8  # float32 rows, bools, an int64
    assert collectives.seconds() > 0.0


def test_sample_in_a_one_rank_group_is_bitwise(one_rank_group):
    model = compile_model_def(nt.models.eight_schools())
    common = dict(chains=8, tune=24, draws=8, chunk_size=8, seed=2, maxdepth=5,
                  device="cpu", progress_bar=False, return_raw_trace=True,
                  pool_mass_matrix=True, pool_step_size=True)
    grouped = nt.sample(model, **common)
    dist.destroy_process_group()
    try:
        alone = nt.sample(model, **common)
    finally:
        initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    np.testing.assert_array_equal(grouped["position"].view(np.int64),
                                  alone["position"].view(np.int64))
    for name, ref in alone["stats"].items():
        np.testing.assert_array_equal(grouped["stats"][name], ref, err_msg=name)


def test_without_cuda_initialize_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            initialize_distributed("127.0.0.1:1", 1, 0, device=device)
    for name in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(device="cpu")
    assert not dist.is_initialized()
