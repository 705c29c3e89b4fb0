"""The torch port stands alone and never falls back.

- No module of ``nutpie_tpu_torch`` imports ``jax`` or ``nutpie_tpu``
  (AST scan), and a fresh interpreter that imports every module of the
  package and runs a CPU sample in the background with progress, Zarr
  storage and a checkpoint loads neither.
- ``sample(device="cuda")`` without CUDA raises instead of running on the
  CPU; configurations neither CUDA kernel runs raise
  ``NotImplementedError`` before anything runs, and a model without a
  device-side log density takes the step kernel's route.
- The kernel's launch count stays 0 when the runner is given CPU tensors.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nutpie_tpu_torch
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def, from_pyfunc
from nutpie_tpu_torch.models import radon
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.megakernel import (
    chunk_kernel,
    make_megakernel_chunk_runner,
    supports,
)
from nutpie_tpu_torch.sampler.nuts import NutsConfig
from nutpie_tpu_torch.sampler.run import init_chains

torch.set_num_threads(1)

PKG = Path(nutpie_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


def _normal_model():
    return from_pyfunc(
        3, lambda: (lambda x: -0.5 * torch.sum(x * x, dim=1)),
    )


def test_no_jax_or_reference_imports():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "nutpie_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders
    scanned = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"progress.py", "checkpoint.py", "zarr_store.py", "storage/native.py",
            "storage/sink.py", "storage/stores.py", "storage/transport.py",
            "storage/zarr_writer.py", "sampler/mclmc.py",
            "sampler/mclmc_kernel.py", "sampler/isokinetic.py", "parallel/__init__.py",
            "parallel/mesh.py"} <= scanned, scanned
    assert len(scanned) >= 26


def test_cpu_sample_loads_no_jax(tmp_path):
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import nutpie_tpu_torch as nt\n"
        "for mod in pkgutil.walk_packages(nt.__path__, 'nutpie_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "from nutpie_tpu_torch.storage.stores import MemoryStore\n"
        "m = nt.from_pyfunc(2, lambda: (lambda x: -0.5 * torch.sum(x * x, dim=1)))\n"
        "h = nt.sample(m, chains=2, tune=10, draws=10, seed=1, device='cpu', blocking=False,\n"
        "              progress_bar=False, progress_callback=lambda p: None,\n"
        "              zarr_store=MemoryStore(), checkpoint=sys.argv[1])\n"
        "tr = h.wait(timeout=200)\n"
        "assert tr.posterior['x'].shape == (2, 10, 2)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'nutpie_tpu'))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "state.npz")],
                         capture_output=True, text=True, env=env, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        nutpie_tpu_torch.sample(compile_model_def(radon()), chains=2, tune=2, draws=2,
                                device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        nutpie_tpu_torch.sample(compile_model_def(radon()), chains=2, tune=2, draws=2)


# the route each configuration takes on radon, or None where it still
# raises naming its ROADMAP item
_CARD_ROUTES = {"store_divergences": "step", "step_size_adapt_method": "megakernel",
                "target_integration_time": "megakernel", "sampler": "mclmc",
                "adaptation": "step"}


@pytest.mark.parametrize("kwargs", [
    dict(store_divergences=True),
    dict(adaptation="flow"),
    dict(sampler="mclmc"),
    dict(step_size_adapt_method="adam"),
    dict(target_integration_time=2.0),
])
def test_unported_configs_raise_on_card_path(kwargs):
    """Adam and the target time take the chunk kernel on radon, the
    divergence rows and flow adaptation the step kernel (as in the JAX
    package), MCLMC the MCLMC kernel, and then only the missing card stops
    the run."""
    expected = _CARD_ROUTES.get(next(iter(kwargs)))
    if expected is None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            nutpie_tpu_torch.sample(compile_model_def(radon()), chains=2, tune=2, draws=2,
                                    device="cuda", **kwargs)
        return
    from nutpie_tpu_torch.sample import _make_settings, config_from_settings, route

    options = dict(kwargs)
    settings = _make_settings(options.pop("sampler", "nuts"), options.pop("adaptation", "diag"),
                              0)
    settings.update(options)
    assert route(config_from_settings(settings), radon()) == expected
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            nutpie_tpu_torch.sample(compile_model_def(radon()), chains=2, tune=2, draws=2,
                                    device="cuda", **kwargs)


def test_model_without_kernel_raises_on_card_path():
    """A model without a device-side log density takes the step kernel's
    route on the card; without a card, ``sample`` then refuses CUDA."""
    from nutpie_tpu_torch.sample import route

    assert route(NutsConfig(), _normal_model()._make_model(0)) == "step"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            nutpie_tpu_torch.sample(_normal_model(), chains=2, tune=2, draws=2, device="cuda")


def test_unported_options_raise():
    """No refusal remains for flow adaptation or a fixed mass matrix: flow
    (NUTS) and the fixed metric (which only flow reaches through
    ``sample``, so it is asked of the route) take the step kernel, even on
    radon, whose chunk kernel takes neither; MCLMC with flow takes the
    MCLMC kernel; without a card only CUDA is refused."""
    from nutpie_tpu_torch.sample import _make_settings, config_from_settings, route

    m = compile_model_def(radon())
    for sampler, expected in (("mclmc", "mclmc"), ("nuts", "step")):
        cfg = config_from_settings(_make_settings(sampler, "flow", 0), device="cpu")
        assert cfg.flow is not None and not cfg.adapt.update_mass_matrix
        assert route(cfg, radon()) == expected
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                nutpie_tpu_torch.sample(m, sampler=sampler, adaptation="flow", chains=2,
                                        tune=2, draws=2, device="cuda")
    cfg = NutsConfig(adapt=AdaptConfig(num_tune=8, update_mass_matrix=False))
    assert route(cfg, radon()) == "step"


def test_launches_stay_zero_on_cpu_tensors():
    model = radon()
    cfg = NutsConfig(maxdepth=4, adapt=AdaptConfig(num_tune=8))
    assert supports(cfg)
    states, _ = init_chains(model, cfg, 2, 2, np.zeros(model.ndim), torch.float64)
    before = chunk_kernel.launches
    run = make_megakernel_chunk_runner(model, cfg, 4, torch.float64, adapt_frozen=False,
                                       pool_step_size=True, pool_mass_matrix=True)
    states, bufs = run(states, 0, 4, make_schedule(cfg.adapt, 8))
    assert chunk_kernel.launches == before == 0
    assert torch.isfinite(bufs.position).all()
    assert int(states.draw_idx.min()) == 4


def test_precision_and_tf32():
    from nutpie_tpu_torch.sampler.run import resolve_dtype

    assert resolve_dtype("auto", "cpu") == torch.float64
    assert resolve_dtype("auto", "cuda") == torch.float32
    assert resolve_dtype("float32", "cpu") == torch.float32
    tr = nutpie_tpu_torch.sample(_normal_model(), chains=2, tune=4, draws=4, seed=3,
                                 device="cpu", precision="float32")
    assert tr.posterior["x"].dtype == np.float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
