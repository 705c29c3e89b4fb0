"""Radon hierarchical model -- the headline benchmark model.

Same model, parameterization and simulated data as
``nutpie_tpu/models/radon.py`` (own copies of ``simulate_radon_data`` and
``_zero_sum_basis``, so both packages build identical arrays from the same
seed): intercept + ZeroSumNormal county effects scaled by a HalfNormal sd,
a global floor effect, a ZeroSumNormal county:floor interaction, and a
HalfNormal observation noise, with the scales sampled on the log scale.

The county lookup is an index gather (the one-hot matmul form of the JAX
package existed only for its TPU kernel compiler).  ``RadonKernelData`` is
the data pack the CUDA chunk kernel reads: the observations sorted by
county with CSR offsets and cut into one run per lane of a warp
(``LanePartition``), so per-county gradient sums add contiguous segments
in a fixed order (no float atomics; reruns are bitwise repeatable).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..model import ModelDef, make_model


def _zero_sum_basis(n: int) -> np.ndarray:
    """Orthonormal basis (n x n-1) of the sum-to-zero subspace."""
    # Householder reflection mapping e_1 -> 1/sqrt(n): columns 2..n form the basis
    v = np.full(n, 1.0 / np.sqrt(n))
    v[0] -= 1.0
    v /= np.linalg.norm(v)
    H = np.eye(n) - 2.0 * np.outer(v, v)
    return H[:, 1:]


def simulate_radon_data(seed: int = 42, n_obs: int = 919, n_counties: int = 85):
    rng = np.random.default_rng(seed)
    weights = rng.dirichlet(np.full(n_counties, 0.7))
    county_idx = rng.choice(n_counties, size=n_obs, p=weights)
    # make sure every county appears
    county_idx[:n_counties] = np.arange(n_counties)
    floor = (rng.random(n_obs) < 0.17).astype(np.float64)
    county_eff = 0.35 * rng.standard_normal(n_counties)
    county_eff -= county_eff.mean()
    county_floor_eff = 0.2 * rng.standard_normal(n_counties)
    county_floor_eff -= county_floor_eff.mean()
    mu = (
        1.3
        + county_eff[county_idx]
        - 0.6 * floor
        + county_floor_eff[county_idx] * floor
    )
    log_radon = mu + 0.75 * rng.standard_normal(n_obs)
    counties = [f"county_{i}" for i in range(n_counties)]
    return log_radon, county_idx, floor, counties


LANES = 32  # lanes of the warp that runs one chain in the CUDA kernel


SEG_START = 1 << 16  # flag of an observation that opens a segment (kSegStart)


@dataclasses.dataclass(frozen=True)
class LanePartition:
    """The sorted observations cut into one contiguous run per lane.

    Lane l sums observations ``lane_obs[l]:lane_obs[l+1]`` (the counts
    differ by at most one).  Every county's run of observations is cut at
    the lane boundaries into segments, numbered in observation order:
    segment s starts at observation ``seg_start[s]`` and belongs to county
    ``seg_county[s]``; lane l starts at segment ``lane_seg[l]`` and county
    c owns segments ``county_seg[c]:county_seg[c+1]``.  A lane sums each of
    its segments and each county adds its segments' sums in order.
    """

    lane_obs: np.ndarray
    lane_seg: np.ndarray
    county_seg: np.ndarray
    seg_start: np.ndarray
    seg_county: np.ndarray

    @property
    def n_seg(self) -> int:
        return int(self.seg_start.shape[0])

    @property
    def rows(self) -> int:
        """Rows of the lane-major tables: the longest lane run."""
        return int(np.diff(self.lane_obs).max())

    def obs_info(self) -> np.ndarray:
        """Each observation's county, plus ``SEG_START`` where a segment opens."""
        n_obs = int(self.lane_obs[-1])
        info = np.repeat(self.seg_county, np.diff(np.append(self.seg_start, n_obs)))
        info[self.seg_start] += SEG_START
        return info

    def table(self) -> np.ndarray:
        """The int32 tables in the order of ``PartTables`` in ``csrc/layout.cuh``."""
        return np.concatenate([
            self.lane_obs, self.lane_seg, self.county_seg,
            lane_major(self.obs_info(), self).reshape(-1),
        ]).astype(np.int32)


def lane_partition(offsets, lanes: int = LANES) -> LanePartition:
    """Cut the county-sorted observations (CSR ``offsets``) into lane runs."""
    offsets = np.asarray(offsets, np.int64)
    n_obs = int(offsets[-1])
    lane_obs = (np.arange(lanes + 1) * n_obs) // lanes
    starts = np.union1d(offsets, lane_obs)[:-1]
    return LanePartition(
        lane_obs=lane_obs,
        lane_seg=np.searchsorted(starts, lane_obs[:-1], side="left"),
        # an empty county owns no segment; a segment's county is the last
        # (so the non-empty) one that starts at or before it
        county_seg=np.searchsorted(starts, offsets, side="left"),
        seg_start=starts,
        seg_county=np.searchsorted(offsets, starts, side="right") - 1,
    )


def lane_major(values: np.ndarray, part: LanePartition) -> np.ndarray:
    """``values[lane_obs[l] + t]`` at ``[t, l]``, zero past a lane's run."""
    lanes = part.lane_obs.shape[0] - 1
    counts = np.diff(part.lane_obs)
    out = np.zeros((part.rows, lanes) + values.shape[1:], values.dtype)
    t = np.arange(part.rows)[:, None]
    mask = t < counts[None, :]
    out[mask] = values[(part.lane_obs[:-1][None, :] + t)[mask]]
    return out


@dataclasses.dataclass(frozen=True)
class RadonKernelData:
    """Radon data in the layout of ``csrc/radon.cuh``.

    ``y``/``floor`` are sorted by county (stable, so each county keeps its
    observations in data order); ``offsets[c]:offsets[c+1]`` is county c's
    run.  ``basis`` is the ``[n_counties, n_counties - 1]`` zero-sum basis,
    row-major.  The kernel reads the observations as (y, floor) pairs in
    the lane-major order of ``partition`` and the partition's tables.
    """

    y: np.ndarray
    floor: np.ndarray
    basis: np.ndarray
    offsets: np.ndarray
    n_counties: int
    n_obs: int
    partition: LanePartition

    @property
    def obs_rows(self) -> int:
        return self.partition.rows

    def tensors(self, device, dtype) -> dict:
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()
        pairs = np.stack([self.y, self.floor], axis=-1)
        return {
            "obs": f(lane_major(pairs, self.partition)),
            "basis": f(self.basis),
            "part": torch.as_tensor(self.partition.table(), device=device).contiguous(),
        }


def radon_kernel_data(log_radon, county_idx, floor, n_counties) -> RadonKernelData:
    order = np.argsort(county_idx, kind="stable")
    counts = np.bincount(county_idx, minlength=n_counties)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return RadonKernelData(
        y=np.asarray(log_radon, np.float64)[order],
        floor=np.asarray(floor, np.float64)[order],
        basis=_zero_sum_basis(n_counties),
        offsets=offsets,
        n_counties=int(n_counties),
        n_obs=int(len(county_idx)),
        partition=lane_partition(offsets),
    )


def radon(log_radon=None, county_idx=None, floor=None, counties=None,
          seed: int = 42) -> ModelDef:
    """Radon model with a batched torch log density and its kernel data."""
    if log_radon is None:
        log_radon, county_idx, floor, counties = simulate_radon_data(seed)
    log_radon = np.asarray(log_radon, np.float64)
    county_idx = np.asarray(county_idx, np.int64)
    floor = np.asarray(floor, np.float64)
    n_obs = log_radon.shape[0]
    n_c = int(county_idx.max()) + 1
    if counties is None:
        counties = [f"county_{i}" for i in range(n_c)]
    basis_np = _zero_sum_basis(n_c)
    # tensors per (device, dtype), built on first use
    cache: dict = {}
    onehot: dict = {}

    def data(ref: torch.Tensor):
        key = (ref.device, ref.dtype)
        if key not in cache:
            cache[key] = (
                torch.as_tensor(basis_np, dtype=ref.dtype, device=ref.device),
                torch.as_tensor(log_radon, dtype=ref.dtype, device=ref.device),
                torch.as_tensor(county_idx, device=ref.device),
                torch.as_tensor(floor, dtype=ref.dtype, device=ref.device),
            )
            if ref.is_cuda:  # [n_obs, n_c] one-hot map of each observation's county
                onehot[key] = torch.as_tensor(np.eye(n_c)[county_idx], dtype=ref.dtype,
                                              device=ref.device)
        return cache[key]

    def county_sums(x: torch.Tensor, cidx: torch.Tensor) -> torch.Tensor:
        """Per-county sums of ``x [C, n_obs]``.  On CUDA ``index_add_``
        accumulates with atomics, in an order that changes from run to run
        (two runs from one seed would part ways at the step-size search);
        there the product with the one-hot map sums in a fixed order."""
        if x.is_cuda:
            return x @ onehot[(x.device, x.dtype)]
        return torch.zeros((x.shape[0], n_c), dtype=x.dtype, device=x.device).index_add_(
            1, cidx, x)

    # flat layout: intercept | county_raw_z (n_c-1) | log_county_sd |
    #              floor_effect | county_floor_raw_z (n_c-1) | log_cf_sd |
    #              log_sigma
    k = n_c - 1
    ndim = 5 + 2 * k
    s0 = 1
    s1 = s0 + k      # log_county_sd
    s2 = s1 + 1      # floor_effect
    s3 = s2 + 1      # county_floor_raw_z
    s4 = s3 + k      # log_cf_sd
    s5 = s4 + 1      # log_sigma

    def _halfnormal_logp(log_s, sigma):
        s = torch.exp(log_s)
        return -0.5 * (s / sigma) ** 2 + log_s, s

    def _parts(q):
        basis = data(q)[0]
        raw_z = q[:, s0:s1]
        cf_raw_z = q[:, s3:s4]
        return (
            q[:, 0], raw_z, q[:, s1], q[:, s2], cf_raw_z, q[:, s4], q[:, s5],
            raw_z @ basis.T, cf_raw_z @ basis.T,
        )

    def logp(q):
        _, y, cidx, fl = data(q)
        (intercept, raw_z, log_county_sd, floor_effect,
         cf_raw_z, log_cf_sd, log_sigma, county_raw, cf_raw) = _parts(q)
        lp = -0.5 * (intercept / 10.0) ** 2
        lp = lp + -0.5 * torch.sum(raw_z * raw_z, dim=1)
        lp = lp + -0.5 * torch.sum(cf_raw_z * cf_raw_z, dim=1)
        lp_sd, county_sd = _halfnormal_logp(log_county_sd, 1.0)
        lp = lp + lp_sd
        lp_cfsd, cf_sd = _halfnormal_logp(log_cf_sd, 1.0)
        lp = lp + lp_cfsd
        lp = lp + -0.5 * (floor_effect / 2.0) ** 2
        lp_sig, sigma = _halfnormal_logp(log_sigma, 1.5)
        lp = lp + lp_sig
        county_effect = county_raw * county_sd[:, None]
        cf_effect = cf_raw * cf_sd[:, None]
        mu = (
            intercept[:, None]
            + county_effect[:, cidx]
            + floor_effect[:, None] * fl
            + cf_effect[:, cidx] * fl
        )
        resid = (y - mu) / sigma[:, None]
        lp = lp + (-0.5 * torch.sum(resid * resid, dim=1) - n_obs * log_sigma)
        return lp

    def logp_and_grad(q):
        """Log density and its analytic gradient (the kernel's arithmetic)."""
        basis, y, cidx, fl = data(q)
        (intercept, raw_z, log_county_sd, floor_effect,
         cf_raw_z, log_cf_sd, log_sigma, county_raw, cf_raw) = _parts(q)
        county_sd = torch.exp(log_county_sd)
        cf_sd = torch.exp(log_cf_sd)
        sigma = torch.exp(log_sigma)
        mu = (
            intercept[:, None]
            + (county_raw * county_sd[:, None])[:, cidx]
            + floor_effect[:, None] * fl
            + (cf_raw * cf_sd[:, None])[:, cidx] * fl
        )
        resid = (y - mu) / sigma[:, None]
        ss = torch.sum(resid * resid, dim=1)
        # d logp / d county effects: per-county sums of resid / sigma
        A = county_sums(resid, cidx) / sigma[:, None]
        B = county_sums(resid * fl, cidx) / sigma[:, None]
        lp = -0.5 * (intercept / 10.0) ** 2
        lp = lp + -0.5 * torch.sum(raw_z * raw_z, dim=1)
        lp = lp + -0.5 * torch.sum(cf_raw_z * cf_raw_z, dim=1)
        lp = lp + (-0.5 * county_sd ** 2 + log_county_sd)
        lp = lp + (-0.5 * cf_sd ** 2 + log_cf_sd)
        lp = lp + -0.5 * (floor_effect / 2.0) ** 2
        lp = lp + (-0.5 * (sigma / 1.5) ** 2 + log_sigma)
        lp = lp + (-0.5 * ss - n_obs * log_sigma)
        grad = torch.empty_like(q)
        grad[:, 0] = -intercept / 100.0 + A.sum(dim=1)
        grad[:, s0:s1] = -raw_z + (A @ basis) * county_sd[:, None]
        grad[:, s1] = -county_sd ** 2 + 1.0 + county_sd * (A * county_raw).sum(dim=1)
        grad[:, s2] = -floor_effect / 4.0 + B.sum(dim=1)
        grad[:, s3:s4] = -cf_raw_z + (B @ basis) * cf_sd[:, None]
        grad[:, s4] = -cf_sd ** 2 + 1.0 + cf_sd * (B * cf_raw).sum(dim=1)
        grad[:, s5] = -(sigma / 1.5) ** 2 + 1.0 + ss - n_obs
        return lp, grad

    def expand(q):
        (intercept, raw_z, log_county_sd, floor_effect,
         cf_raw_z, log_cf_sd, log_sigma, county_raw, cf_raw) = _parts(q)
        county_sd = torch.exp(log_county_sd)
        cf_sd = torch.exp(log_cf_sd)
        return {
            "intercept": intercept,
            "county_raw": county_raw,
            "county_sd": county_sd,
            "county_effect": county_raw * county_sd[:, None],
            "floor_effect": floor_effect,
            "county_floor_raw": cf_raw,
            "county_floor_sd": cf_sd,
            "county_floor_effect": cf_raw * cf_sd[:, None],
            "sigma": torch.exp(log_sigma),
        }

    f8 = np.float64
    return make_model(
        ndim,
        logp,
        expand_fn=expand,
        expanded_vars=[
            ("intercept", f8, (), None),
            ("county_raw", f8, (n_c,), ("county",)),
            ("county_sd", f8, (), None),
            ("county_effect", f8, (n_c,), ("county",)),
            ("floor_effect", f8, (), None),
            ("county_floor_raw", f8, (n_c,), ("county",)),
            ("county_floor_sd", f8, (), None),
            ("county_floor_effect", f8, (n_c,), ("county",)),
            ("sigma", f8, (), None),
        ],
        param_vars=[
            ("intercept", f8, (), None),
            ("county_raw_z", f8, (k,), ("county_zerosum",)),
            ("log_county_sd", f8, (), None),
            ("floor_effect", f8, (), None),
            ("county_floor_raw_z", f8, (k,), ("county_zerosum",)),
            ("log_county_floor_sd", f8, (), None),
            ("log_sigma", f8, (), None),
        ],
        coords={"county": list(counties)},
        logp_grad_fn=logp_and_grad,
        kernel_model=radon_kernel_data(log_radon, county_idx, floor, n_c),
    )
