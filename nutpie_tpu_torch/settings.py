"""Typed sampler settings tree.

Mirrors the settings schema of the reference implementation (nutpie's Rust
settings structs, see reference ``src/wrapper.rs:118-451,563-712``): a 3x2
matrix of {Nuts, Mclmc} x {Diag, LowRank, Flow} settings objects, flat
attribute updates with variant validation (unknown keys raise
``AttributeError``, options invalid for the active adaptation variant raise
``ValueError``), and full nested-dict round-trips via ``as_dict`` /
``update_settings``.

This package adds a few settings the reference does not have (``precision``,
``chunk_size``, ``pool_mass_matrix``, ``pool_step_size``) -- these control the
device execution and cross-chain pooling and default to reference-equivalent
behavior.  The settings tree is a copy of ``nutpie_tpu/settings.py``, kept
separate so that this package imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Literal, Optional, Union


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    return obj


def _update_from_nested(obj: Any, data: dict) -> None:
    for key, value in data.items():
        if not hasattr(obj, key):
            raise AttributeError(f"Unknown settings attribute: {key}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _update_from_nested(current, value)
        else:
            object.__setattr__(obj, key, value)


@dataclass
class DualAverageOptions:
    """Nesterov dual-averaging step size adaptation (Hoffman & Gelman 2014)."""

    max_step_size: float = 100.0
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75


@dataclass
class AdamOptions:
    learning_rate: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@dataclass
class StepSizeAdaptOptions:
    # method: "dual_average" | "adam" | a float (fixed step size)
    method: Union[str, float] = "dual_average"
    dual_average: DualAverageOptions = field(default_factory=DualAverageOptions)
    adam: AdamOptions = field(default_factory=AdamOptions)


@dataclass
class StepSizeSettings:
    initial_step: float = 0.1
    target_accept: float = 0.8
    jitter: Optional[float] = None
    adapt_options: StepSizeAdaptOptions = field(default_factory=StepSizeAdaptOptions)


@dataclass
class DiagMassMatrixOptions:
    store_mass_matrix: bool = False
    # nutpie's signature: estimate scale from draw AND gradient variance
    # (sigma_i = sqrt(std(draw_i) / std(grad_i))).
    use_grad_based_estimate: bool = True


@dataclass
class LowRankMassMatrixOptions:
    store_mass_matrix: bool = False
    eigval_cutoff: float = 100.0
    gamma: float = 1e-5


@dataclass
class EuclideanAdaptOptions:
    """Windowed warmup adaptation schedule.

    The mass matrix estimate uses a current+background pair of running
    variance accumulators that swap every ``mass_matrix_switch_freq`` draws
    (every ``early_mass_matrix_switch_freq`` during the first
    ``early_phase_share`` of warmup).  The mass matrix is frozen for the final
    ``freeze_share`` of warmup while only the step size adapts (reference
    behavior documented at ``docs/sample-stats.qmd:86-89``).
    """

    mass_matrix_switch_freq: int = 80
    early_mass_matrix_switch_freq: int = 10
    early_phase_share: float = 0.3
    freeze_share: float = 0.1
    step_size_settings: StepSizeSettings = field(default_factory=StepSizeSettings)
    mass_matrix_options: DiagMassMatrixOptions = field(
        default_factory=DiagMassMatrixOptions
    )


@dataclass
class LowRankAdaptOptions(EuclideanAdaptOptions):
    mass_matrix_options: LowRankMassMatrixOptions = field(
        default_factory=LowRankMassMatrixOptions
    )


@dataclass
class FlowAdaptOptions:
    transform_update_freq: int = 64
    use_orbit_for_training: bool = False
    step_size_settings: StepSizeSettings = field(default_factory=StepSizeSettings)
    # hyperparameters of the flow trainer; populated via with_transform_adapt
    flow: dict = field(default_factory=dict)


_ADAPT_OPTIONS = {
    "diag": EuclideanAdaptOptions,
    "low_rank": LowRankAdaptOptions,
    "flow": FlowAdaptOptions,
}


# Flat-settings-name dispatch table: name -> (dotted path, allowed variants).
# This reproduces the attribute vocabulary of the reference's update macros
# (``src/wrapper.rs:210-451``).
_ALL = ("diag", "low_rank", "flow")
_DIAG_LR = ("diag", "low_rank")
_FLAT_COMMON: dict[str, tuple[str, tuple[str, ...]]] = {
    "num_tune": ("num_tune", _ALL),
    "num_chains": ("num_chains", _ALL),
    "num_draws": ("num_draws", _ALL),
    "store_unconstrained": ("store_unconstrained", _ALL),
    "store_gradient": ("store_gradient", _ALL),
    "store_divergences": ("store_divergences", _ALL),
    "store_transformed": ("store_transformed", _ALL),
    "max_energy_error": ("max_energy_error", _ALL),
    "initial_step": ("adapt_options.step_size_settings.initial_step", _ALL),
    "target_accept": ("adapt_options.step_size_settings.target_accept", _ALL),
    "step_size_jitter": ("adapt_options.step_size_settings.jitter", _ALL),
    "max_step_size": (
        "adapt_options.step_size_settings.adapt_options.dual_average.max_step_size",
        _ALL,
    ),
    "step_size_adapt_method": (
        "adapt_options.step_size_settings.adapt_options.method",
        _ALL,
    ),
    "step_size_adam_learning_rate": (
        "adapt_options.step_size_settings.adapt_options.adam.learning_rate",
        _ALL,
    ),
    "mass_matrix_switch_freq": ("adapt_options.mass_matrix_switch_freq", _DIAG_LR),
    "early_window_switch_freq": (
        "adapt_options.early_mass_matrix_switch_freq",
        _DIAG_LR,
    ),
    "early_mass_matrix_switch_freq": (
        "adapt_options.early_mass_matrix_switch_freq",
        _DIAG_LR,
    ),
    "store_mass_matrix": (
        "adapt_options.mass_matrix_options.store_mass_matrix",
        _DIAG_LR,
    ),
    "use_grad_based_mass_matrix": (
        "adapt_options.mass_matrix_options.use_grad_based_estimate",
        ("diag",),
    ),
    "mass_matrix_eigval_cutoff": (
        "adapt_options.mass_matrix_options.eigval_cutoff",
        ("low_rank",),
    ),
    "mass_matrix_gamma": (
        "adapt_options.mass_matrix_options.gamma",
        ("low_rank",),
    ),
    "transform_update_freq": ("adapt_options.transform_update_freq", ("flow",)),
    "train_on_orbit": ("adapt_options.use_orbit_for_training", ("flow",)),
    # device-build extensions
    "precision": ("precision", _ALL),
    "chunk_size": ("chunk_size", _ALL),
    "pool_mass_matrix": ("pool_mass_matrix", _ALL),
    "pool_step_size": ("pool_step_size", _ALL),
    "num_try_init": ("num_try_init", _ALL),
}

_FLAT_NUTS: dict[str, tuple[str, tuple[str, ...]]] = {
    "maxdepth": ("maxdepth", _ALL),
    "mindepth": ("mindepth", _ALL),
    "check_turning": ("check_turning", _ALL),
    "target_integration_time": ("target_integration_time", _ALL),
    "extra_doublings": ("extra_doublings", _ALL),
}

_FLAT_MCLMC: dict[str, tuple[str, tuple[str, ...]]] = {
    "step_size": ("step_size", _ALL),
    "momentum_decoherence_length": ("momentum_decoherence_length", _ALL),
    "subsample_frequency": ("subsample_frequency", _ALL),
    "dynamic_step_size": ("dynamic_step_size", _ALL),
}


_ADAPT_NAMES = {"diag": "diag", "low_rank": "low-rank", "flow": "flow"}


@dataclass
class _BaseSettings:
    seed: Optional[int] = None
    num_tune: int = 300
    num_chains: int = 6
    num_draws: int = 1000
    store_unconstrained: bool = False
    store_gradient: bool = False
    store_divergences: bool = False
    store_transformed: bool = False
    max_energy_error: float = 1000.0
    num_try_init: int = 100
    # device-build extensions:
    # precision: "auto" resolves to float32 on CUDA and float64 on the CPU
    precision: Literal["auto", "float32", "float64"] = "auto"
    # number of draws the device loop generates between host interactions
    chunk_size: Optional[int] = None
    # pool mass-matrix statistics across chains with a psum collective
    pool_mass_matrix: bool = False
    # geometric-mean the step size across chains at chunk boundaries: on a
    # lockstep fleet per-chain step-size spread directly inflates wall time
    # (everyone waits for the smallest-step chain's deepest tree)
    pool_step_size: bool = False

    _adaptation: str = "diag"
    _sampler: str = "nuts"

    def _flat_table(self) -> dict[str, tuple[str, tuple[str, ...]]]:
        raise NotImplementedError

    def _apply_update(self, name: str, value: Any) -> None:
        if name == "window_switch_freq":
            # alias: maps to mass_matrix_switch_freq (diag/low_rank) or
            # transform_update_freq (flow); see wrapper.rs:218-228
            if self._adaptation == "flow":
                name = "transform_update_freq"
            else:
                name = "mass_matrix_switch_freq"
        table = self._flat_table()
        if name not in table:
            raise AttributeError(f"Unknown settings attribute: {name}")
        path, variants = table[name]
        if self._adaptation not in variants:
            raise ValueError(
                f"Option {name} not available for "
                f"{_ADAPT_NAMES[self._adaptation]} adaptation"
            )
        if name == "step_size_jitter" and value is not None:
            if value < 0:
                raise ValueError("step_size_jitter must be positive")
            if value == 0:
                value = None
        if name == "step_size_adapt_method" and isinstance(value, str):
            if value not in ("dual_average", "adam"):
                try:
                    value = float(value)
                except ValueError:
                    raise ValueError(
                        "step_size_adapt_method must be 'dual_average', 'adam', "
                        "or a positive float for a fixed step size"
                    ) from None
        target = self
        parts = path.split(".")
        for part in parts[:-1]:
            target = getattr(target, part)
        object.__setattr__(target, parts[-1], value)

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_") or name in {
            f.name for f in dataclasses.fields(type(self))
        }:
            object.__setattr__(self, name, value)
        else:
            self._apply_update(name, value)

    def update(self, updates: Optional[dict] = None, **kwargs: Any) -> None:
        """Apply flat-name settings updates (nutpie kwargs vocabulary)."""
        merged = dict(updates or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self._apply_update(key, value)

    def update_settings(self, settings: dict) -> None:
        """Apply a nested settings dict (mirrors serde round trip)."""
        _update_from_nested(self, settings)

    def as_dict(self) -> dict:
        data = _asdict(self)
        data.pop("_adaptation")
        data.pop("_sampler")
        return {
            "adaptation": self._adaptation,
            "sampler": self._sampler,
            "settings": data,
        }

    def as_json(self) -> str:
        return json.dumps(self.as_dict())

    @property
    def adaptation(self) -> str:
        return self._adaptation

    @property
    def sampler_kind(self) -> str:
        return self._sampler


@dataclass
class NutsSettings(_BaseSettings):
    """NUTS sampler settings (reference: DiagNutsSettings & friends)."""

    maxdepth: int = 10
    mindepth: int = 0
    check_turning: bool = True
    target_integration_time: Optional[float] = None
    extra_doublings: int = 0
    # "exact_normal" | "microcanonical" kinetic energy for the trajectory
    trajectory_kind: str = "exact_normal"
    adapt_options: Any = field(default_factory=EuclideanAdaptOptions)

    def _flat_table(self):
        table = dict(_FLAT_COMMON)
        table.update(_FLAT_NUTS)
        return table

    def _apply_update(self, name: str, value: Any) -> None:
        if name == "microcanonical_trajectory":
            if value:
                object.__setattr__(self, "trajectory_kind", "microcanonical")
            return
        if name == "exact_normal_trajectory":
            if value:
                object.__setattr__(self, "trajectory_kind", "exact_normal")
            return
        super()._apply_update(name, value)

    @classmethod
    def Diag(cls, seed: Optional[int] = None) -> "NutsSettings":
        return cls(seed=seed, _adaptation="diag")

    @classmethod
    def LowRank(cls, seed: Optional[int] = None) -> "NutsSettings":
        return cls(
            seed=seed,
            _adaptation="low_rank",
            adapt_options=LowRankAdaptOptions(),
        )

    @classmethod
    def Flow(cls, seed: Optional[int] = None) -> "NutsSettings":
        return cls(seed=seed, _adaptation="flow", adapt_options=FlowAdaptOptions())


@dataclass
class MclmcSettings(_BaseSettings):
    """Microcanonical Langevin Monte Carlo settings."""

    step_size: float = 0.5
    momentum_decoherence_length: float = 2.0
    subsample_frequency: float = 1.0
    dynamic_step_size: bool = True
    trajectory_kind: str = "microcanonical"
    _sampler: str = "mclmc"
    adapt_options: Any = field(default_factory=EuclideanAdaptOptions)

    def _flat_table(self):
        table = dict(_FLAT_COMMON)
        table.update(_FLAT_MCLMC)
        return table

    def _apply_update(self, name: str, value: Any) -> None:
        if name == "trajectory":
            kinds = {
                "microcanonical": "microcanonical",
                "euclidean": "euclidean",
                "euclidean_then_microcanonical": "euclidean_then_microcanonical",
            }
            if value not in kinds:
                raise ValueError(f"Unknown trajectory: {value}")
            object.__setattr__(self, "trajectory_kind", kinds[value])
            return
        super()._apply_update(name, value)

    @classmethod
    def Diag(cls, seed: Optional[int] = None) -> "MclmcSettings":
        return cls(seed=seed, _adaptation="diag")

    @classmethod
    def LowRank(cls, seed: Optional[int] = None) -> "MclmcSettings":
        return cls(
            seed=seed,
            _adaptation="low_rank",
            adapt_options=LowRankAdaptOptions(),
        )

    @classmethod
    def Flow(cls, seed: Optional[int] = None) -> "MclmcSettings":
        return cls(seed=seed, _adaptation="flow", adapt_options=FlowAdaptOptions())
