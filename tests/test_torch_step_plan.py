"""The step kernel's launch plans and their C mirrors, on the CPU.

``diag_plan`` picks the diagonal instantiation before anything runs: the
lanes a chain, the coordinates a chunk (16-byte vector loads where ``dim``
allows) and whether a thread's chunks stay in registers; the kernel
refuses a launch that matches none of its forms (``DiagForms`` in
``csrc/step_kernel.cu``, held equal to ``diag_forms`` here).

``low_rank_plan`` decides before anything runs how K2's low-rank
instantiations hold a chain's basis: staged whole in shared memory where it
fits, streamed through a ring of tiles where it does not, by TMA bulk
copies where a chain's basis is 16-byte aligned and by loads where not.
The shared memory it asks for must equal what ``csrc/lowrank.cuh``
(``LrLayout``) lays out, which chip_smoke's build phase checks on the
card; here the plan is held against the layout's arithmetic at the card's
numbers (an H100: 227 KB a block, 228 KB an SM, 1 KB kept per block, 132
SMs), and the ctypes mirrors against the C structs they mirror.
"""

import re
from pathlib import Path

import pytest

from nutpie_tpu_torch.sampler.abi import MkConfig
from nutpie_tpu_torch.sampler.step_kernel import (
    BLOCK_THREADS,
    DEVICE_FIELDS,
    GEOMETRY_FIELDS,
    HELD,
    LR_WARPS,
    StepPtrs,
    diag_forms,
    diag_plan,
    low_rank_plan,
    lr_smem_bytes,
    plan_fields,
)

CSRC = Path(__file__).resolve().parent.parent / "nutpie_tpu_torch" / "csrc"
H100 = {"smem_per_block": 232448, "sm_count": 132, "smem_per_sm": 233472,
        "reserved_per_block": 1024}


@pytest.mark.parametrize("n_chains, dim, rank, itemsize, aligned, form, copy, basis, blocks", [
    # the low-rank path's shapes: a whole basis per block, one block an SM
    (1024, 1000, 32, 4, True, "staged", "tma", 128000, 1),
    # float64 at the same shapes: 256,000 bytes do not fit a block
    (16, 1000, 32, 8, True, "streamed", "tma", 256000, 1),
    (16, 500, 32, 8, True, "staged", "tma", 128000, 1),
    # 33 * 5 * 4 = 660 bytes a chain: the second chain's basis is not 16-byte aligned
    (16, 33, 5, 4, True, "staged", "loads", 660, 8),
    # a tensor that does not start on 16 bytes
    (16, 40, 8, 8, False, "staged", "loads", 2560, 8),
    # float32 fits up to 1,796 coordinates at rank 32, and streams past them
    (1024, 1796, 32, 4, True, "staged", "tma", 229888, 1),
    (1024, 1797, 32, 4, True, "streamed", "tma", 230016, 3),
])
def test_low_rank_plan(n_chains, dim, rank, itemsize, aligned, form, copy, basis, blocks):
    plan = low_rank_plan(n_chains, dim, rank, itemsize, aligned=aligned, **H100)
    assert (plan.form, plan.copy, plan.basis_bytes, plan.blocks_per_sm) == (
        form, copy, basis, blocks)
    # persistent blocks: every resident slot of the card, at most one per chain
    assert plan.warps == LR_WARPS and plan.grid == min(n_chains, blocks * H100["sm_count"])
    assert plan.chains_per_block == -(-n_chains // plan.grid)
    assert plan.smem_bytes <= H100["smem_per_block"]
    assert plan.smem_bytes == lr_smem_bytes(dim, rank, itemsize, form == "streamed")
    assert (plan.stages == 0) == (form == "staged")
    if form == "staged":
        assert plan.smem_bytes >= basis
    else:
        assert plan.smem_bytes < basis and LR_WARPS * plan.stages >= 4


def test_lr_smem_bytes_follows_the_layout():
    # LrLayout at dim 1000, R 32: 32 barriers (256 bytes), the scratch and the
    # coefficients (8 x 32 values each) from byte 256, the tiles from the next
    # 128-byte boundary
    assert lr_smem_bytes(1000, 32, 4, False) == 2304 + 128000
    # streamed: 16 barriers, 16 ring slots of 32 rows
    assert lr_smem_bytes(1000, 32, 8, True) == 4224 + 16 * 32 * 32 * 8
    # 2 barriers, the scratch from byte 16, 660 bytes of basis rounded to 672
    assert lr_smem_bytes(33, 5, 4, False) == 2176 + 672


def test_low_rank_plan_refuses_what_does_not_fit():
    with pytest.raises(RuntimeError, match="does not fit"):
        low_rank_plan(16, 1000, 32, 8, **{**H100, "smem_per_block": 48 * 1024})
    with pytest.raises(RuntimeError, match="does not fit"):
        low_rank_plan(16, 1000, 32, 4, **{**H100, "smem_per_sm": 64 * 1024})
    with pytest.raises(ValueError):
        low_rank_plan(16, 1000, 33, 4, **H100)


def _c_fields(text: str, struct: str) -> list:
    body = re.search(r"struct " + struct + r" \{(.*?)\n\};", text, re.S).group(1)
    names = []
    for line in body.splitlines():
        code = line.split("//")[0].strip()
        if code.endswith(";") and "(" not in code:
            names.append(re.findall(r"(\w+)\s*;$", code)[0])
    return names


def test_ctypes_mirrors_match_the_c_structs():
    step = (CSRC / "step_kernel.cu").read_text()
    layout = (CSRC / "layout.cuh").read_text()
    assert _c_fields(step, "StepPtrs") == [name for name, _ in StepPtrs._fields_]
    assert _c_fields(layout, "MkConfig") == [name for name, _ in MkConfig._fields_]
    # every slot the C geometry and device queries fill has its name
    geometry = step[step.index("int geometry(const MkConfig* cfg"):]
    geometry = geometry[:geometry.index("\n}\n")]
    slots = {int(k) for k in re.findall(r"out\[(\d+)\]", geometry)}
    assert slots == set(range(len(GEOMETRY_FIELDS)))
    device = step[step.index("int nutpie_step_device"):]
    assert int(re.search(r"attrs\[(\d+)\]", device).group(1)) == len(DEVICE_FIELDS)


@pytest.mark.parametrize("n_chains, dim, itemsize, form, lanes, coords, grid, wave", [
    # the GLM's shapes: 16 float4 chunks, two a lane of 8; 640 blocks of 16
    # chains need 5 resident blocks an SM for one wave
    (10240, 64, 4, "held", 8, 8, 640, 5),
    # float64 at the same dim: 32 double2 chunks, two a lane of 16
    (64, 64, 8, "held", 16, 4, 8, 1),
    (100, 40, 4, "held", 8, 8, 7, 1),
    # eight schools in float64: five double2 chunks, one a lane of 16
    (8, 10, 8, "held", 16, 2, 1, 1),
    # past two chunks a lane: 32 lanes striding, one coordinate at a time
    (1024, 68, 4, "strided", 32, 3, 256, 2),
    (16, 1000, 4, "strided", 32, 32, 4, 1),
    (16, 1000, 8, "strided", 32, 32, 4, 1),
    # dim not a multiple of the chunk: strided
    (8, 10, 4, "strided", 32, 1, 2, 1),
    (37, 33, 8, "strided", 32, 2, 10, 1),
])
def test_diag_plan(n_chains, dim, itemsize, form, lanes, coords, grid, wave):
    plan = diag_plan(n_chains, dim, itemsize, H100["sm_count"])
    assert (plan.form, plan.lanes, plan.coords_per_lane, plan.grid,
            plan.one_wave_blocks_per_sm) == (form, lanes, coords, grid, wave)
    held_form, strided_form = diag_forms(itemsize)
    assert (plan.lanes, plan.vec, plan.held) == (held_form if form == "held" else strided_form)
    # the held form's chunks tile a warp's 32 lanes: its sums keep their order
    assert held_form[0] * held_form[1] == 32 and held_form[1] * itemsize == 16
    assert plan.chains_per_block == BLOCK_THREADS // lanes
    # every chain has a group; a held thread owns at most HELD chunks
    assert plan.grid * plan.chains_per_block >= n_chains > (plan.grid - 1) * plan.chains_per_block
    assert dim % plan.vec == 0 and (plan.held == 0 or dim // plan.vec <= plan.held * lanes)
    assert plan_fields(plan) == {"step_lanes": lanes, "step_vec": plan.vec,
                                 "step_held": plan.held, "step_grid": grid}


def test_diag_plan_refuses_what_no_form_takes():
    for args in ((0, 64, 4), (8, 0, 4), (8, 64, 2)):
        with pytest.raises(ValueError):
            diag_plan(*args, H100["sm_count"])
    with pytest.raises(ValueError):
        diag_plan(8, 64, 4, 0)


def test_diag_forms_mirror_the_kernel():
    step = (CSRC / "step_kernel.cu").read_text()
    forms = step[step.index("struct DiagForms"):]
    forms = forms[:forms.index("\n};")]
    table = {name: re.search(name + r"\[kCount\] = \{([^}]*)\}", forms).group(1)
             for name in ("lanes", "vec", "held")}
    for itemsize in (4, 8):
        subst = {"kVec<T>": str(16 // itemsize), "kHeld": str(HELD), "kLanes": "32",
                 "kLanes / kVec<T>": str(32 // (16 // itemsize))}
        cols = [[int(subst.get(x.strip(), x.strip())) for x in table[name].split(",")]
                for name in ("lanes", "vec", "held")]
        assert tuple(zip(*cols)) == diag_forms(itemsize)
    assert f"constexpr int kHeld = {HELD};" in step
    group = (CSRC / "group.cuh").read_text()
    assert f"constexpr int kLaneBlockThreads = {BLOCK_THREADS};" in group
