"""Typed run configuration: YAML file + dotted CLI overrides (port of
base_tpu.io.settings, which holds the same dataclasses; the port keeps its
own copy, held equal by tests/test_torch_imports.py).

Equivalent of the reference Settings layer [upstream:
base9/Settings.{cpp,hpp} + conf/base9.yaml — SURVEY.md C12]: one config
document shared by every tool, with per-tool sections.  Key names follow
the reference YAML where practical (photFile, modelDirectory, msRgbModel,
stage2IterMax, percentBinary, ...) so configs can be cross-validated.

Overrides: `--set a.b.c=value` on any CLI, applied after the YAML load;
plus a handful of reference-style long options (--photFile=...) mapped
onto the same paths.  The YAML is read by `io.yaml_subset` (the subset
the configs use), not PyYAML.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from base_tpu_torch import constants as C
from base_tpu_torch.io import yaml_subset


@dataclasses.dataclass
class FilesSettings:
    photFile: str = ""
    outputFileBase: str = "base-tpu-run"
    modelDirectory: str = ""
    # Chain-output backing store [upstream: base9/IO BackingStore —
    # SURVEY.md C14]: "file" writes plain-text .res only; "sqlite" also
    # writes <outputFileBase>.db via io.sqlite_store.
    store: str = "file"


@dataclasses.dataclass
class ClusterSettings:
    """Starting values + Gaussian prior means/sigmas (sigma <= 0 = flat).

    Mirrors the reference cluster section: priors on Fe_H, distMod, Av
    with means/sigmas; age/Y bounded by the model-grid hull."""

    starting_logAge: float = 9.0
    starting_Y: float = 0.27
    starting_Fe_H: float = 0.0
    starting_distMod: float = 10.0
    starting_Av: float = 0.1
    starting_carbonicity: float = 0.5
    prior_Fe_H: float = 0.0
    prior_Fe_H_sigma: float = 0.3
    prior_distMod: float = 10.0
    prior_distMod_sigma: float = 1.0
    prior_Av: float = 0.1
    prior_Av_sigma: float = 0.1
    prior_carbonicity: float = 0.5
    prior_carbonicity_sigma: float = -1.0
    prior_ifmrIntercept: float = 0.7
    prior_ifmrIntercept_sigma: float = -1.0
    prior_ifmrSlope: float = 0.08
    prior_ifmrSlope_sigma: float = -1.0
    prior_ifmrQuadCoef: float = 0.0
    prior_ifmrQuadCoef_sigma: float = -1.0
    # Per-band side of the uniform field-star CMD box (the field
    # mixture's density is 1/prod(range_b) over observed bands).  A
    # scalar applies to every band; a list gives per-band widths.  The
    # box should match the survey's actual field span — a
    # mis-normalized field density reweights the membership mixture
    # and biases the cluster parameters (benchmarks/bias_study.out).
    fieldMagRange: float | list = 20.0

    def field_mag_range_array(self, n_bands: int) -> np.ndarray:
        return np.broadcast_to(
            np.asarray(self.fieldMagRange, np.float32), (n_bands,)
        ).copy()

    def start_vector(self) -> np.ndarray:
        v = np.zeros(C.NPARAMS, np.float32)
        v[C.Param.AGE] = self.starting_logAge
        v[C.Param.YYY] = self.starting_Y
        v[C.Param.FEH] = self.starting_Fe_H
        v[C.Param.MOD] = self.starting_distMod
        v[C.Param.ABS] = self.starting_Av
        v[C.Param.CARBONICITY] = self.starting_carbonicity
        v[C.Param.IFMR_INTERCEPT] = self.prior_ifmrIntercept
        v[C.Param.IFMR_SLOPE] = self.prior_ifmrSlope
        v[C.Param.IFMR_QUADCOEF] = self.prior_ifmrQuadCoef
        return v

    def prior_mean_vector(self) -> np.ndarray:
        v = self.start_vector().copy()
        v[C.Param.FEH] = self.prior_Fe_H
        v[C.Param.MOD] = self.prior_distMod
        v[C.Param.ABS] = self.prior_Av
        v[C.Param.CARBONICITY] = self.prior_carbonicity
        return v

    def prior_sigma_vector(self) -> np.ndarray:
        v = np.full(C.NPARAMS, -1.0, np.float32)  # flat by default
        v[C.Param.FEH] = self.prior_Fe_H_sigma
        v[C.Param.MOD] = self.prior_distMod_sigma
        v[C.Param.ABS] = self.prior_Av_sigma
        v[C.Param.CARBONICITY] = self.prior_carbonicity_sigma
        v[C.Param.IFMR_INTERCEPT] = self.prior_ifmrIntercept_sigma
        v[C.Param.IFMR_SLOPE] = self.prior_ifmrSlope_sigma
        v[C.Param.IFMR_QUADCOEF] = self.prior_ifmrQuadCoef_sigma
        return v


@dataclasses.dataclass
class ModelSettings:
    msRgbModel: str = "synthetic"    # girardi | dsed | yale | synthetic
    wdModel: str = "synthetic"       # wood | montgomery | althaus | renedo | synthetic
    wdAtmosphereModel: str = "synthetic-bergeron"
    ifmr: str = "linear"             # weidemann|williams|salaris|linear|quadratic
    bands: list[str] = dataclasses.field(
        default_factory=lambda: list("UBVRIJHK")
    )


@dataclasses.dataclass
class McmcSettings:
    stage1Iter: int = 1000
    stage2IterMax: int = 2000
    runIter: int = 10000
    thin: int = 1
    seed: int = 73
    chains: int = 64
    sampler: str = "hmc"             # hmc | mh (reference-parity)
    # HMC knobs
    warmup: int = 500
    lMax: int = 24
    targetAccept: float = 0.8
    # Full-covariance metric (HMC and NUTS).  On by default since r3:
    # the age-FeH-modulus degeneracy ridge defeats a diagonal metric
    # (6x ESS/s on the r3 TPU sweep, BASELINE.md) and the dense path is
    # validated on-chip.
    denseMass: bool = True
    # quadrature
    nMassRatio: int = 16
    noBinaries: bool = False
    # The kernels (table build and marginal): "auto" (default) = on for a
    # CUDA device, where they are the only path; "true"/"false" force it,
    # and false on a CUDA device is an error (resolve_use_pallas).
    usePallas: str = "auto"
    # Quadrature refinement: insert (upsample - 1) exact piecewise-linear
    # nodes per EEP segment before marginalizing (posterior.SinglePopModel
    # .upsample); the secondary lookup stays on the BASE node set so this
    # refines the quadrature of a fixed continuous model.  Default 4: the
    # r5 MAP bias study (scripts/bias_study.py, benchmarks/bias_study.out)
    # shows the coherent quadrature drift (0.19 mag in modulus at
    # upsample=1 on config 2 — several posterior sd at 200 stars)
    # converged by upsample=4, leaving only per-dataset realization
    # noise.  Cost is linear in upsample through the segment count; set 1
    # for throughput-only runs on single-star-dominated data.
    upsample: int = 4
    # Model-discretization noise floor, added in quadrature to the
    # observational sigmas (stardata.make_ms_stars sigma_model):
    # magnitudes should not be trusted below the quadrature node
    # spacing.  At very large S the statistical error drops BELOW the
    # upsampled piecewise-linear wiggle scale and HMC chains trap in
    # quadrature kinks (measured at 10k stars / upsample=4: R-hat ~460
    # with the floor off — benchmarks/longaxis_10k_converged.py);
    # ~0.01 mag restores clean mixing at survey-realistic budgets.
    # 0 disables (fine through ~1k stars at upsample=4).
    sigmaModel: float = 0.0


@dataclasses.dataclass
class MultiPopSettings:
    """multiPopMcmc section [upstream: Settings multiPop section — YA/YB/
    lambda starts & steps, SURVEY.md C12/E2].

    startY_A/startY_B default to NaN = derive from cluster.starting_Y
    (Y -/+ 0.02); priors are Gaussian with sigma <= 0 meaning flat on
    the grid hull (the ordered transform enforces Y_A < Y_B)."""

    startY_A: float = float("nan")
    startY_B: float = float("nan")
    startLambda: float = 0.5
    priorY_A: float = float("nan")
    priorY_A_sigma: float = -1.0
    priorY_B: float = float("nan")
    priorY_B_sigma: float = -1.0
    priorLambda: float = 0.5
    priorLambda_sigma: float = -1.0
    # MH mode per-parameter initial step sizes (stage-1 adaptive).
    stepY_A: float = 0.005
    stepY_B: float = 0.005
    stepLambda: float = 0.05


@dataclasses.dataclass
class SimClusterSettings:
    nStars: int = 100
    percentBinary: float = 0.3
    percentDB: float = 0.1
    nFieldStars: int = 0
    minMass: float = 0.2


@dataclasses.dataclass
class ScatterClusterSettings:
    limitMag: float = 22.0
    brightLimit: float = -10.0
    faintLimit: float = 30.0
    sigmaFloor: float = 0.01
    relevantFilt: int = 2
    # per-band exposure times (same order as models.bands); empty = use
    # limitMag for every band [SURVEY.md C12 scatterCluster.exposures]
    exposures: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Settings:
    files: FilesSettings = dataclasses.field(default_factory=FilesSettings)
    cluster: ClusterSettings = dataclasses.field(
        default_factory=ClusterSettings
    )
    models: ModelSettings = dataclasses.field(default_factory=ModelSettings)
    mcmc: McmcSettings = dataclasses.field(default_factory=McmcSettings)
    multiPop: MultiPopSettings = dataclasses.field(
        default_factory=MultiPopSettings
    )
    simCluster: SimClusterSettings = dataclasses.field(
        default_factory=SimClusterSettings
    )
    scatterCluster: ScatterClusterSettings = dataclasses.field(
        default_factory=ScatterClusterSettings
    )


def _apply(obj: Any, path: list[str], value: str) -> None:
    head, rest = path[0], path[1:]
    if not hasattr(obj, head):
        raise KeyError(f"unknown settings key: {'.'.join(path)}")
    if rest:
        _apply(getattr(obj, head), rest, value)
        return
    current = getattr(obj, head)
    if isinstance(current, bool):
        parsed: Any = str(value).lower() in ("1", "true", "yes", "on")
    elif isinstance(current, int):
        parsed = int(value)
    elif isinstance(current, float):
        # float-or-list keys (cluster.fieldMagRange): a YAML list or a
        # comma-separated override becomes a per-band list of floats.
        if isinstance(value, (list, tuple)):
            parsed = [float(x) for x in value]
        elif isinstance(value, str) and "," in value:
            parsed = [float(x) for x in value.split(",")]
        else:
            parsed = float(value)
    elif isinstance(current, list):
        parsed = list(value) if isinstance(value, (list, tuple)) else str(
            value
        ).split(",")
    else:
        parsed = value
    setattr(obj, head, parsed)


def _merge_dict(obj: Any, d: dict) -> None:
    for k, v in d.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown settings key: {k}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_dict(cur, v)
        else:
            _apply(obj, [k], v)


def load_settings(
    yaml_path: str | None = None, overrides: list[str] | None = None
) -> Settings:
    """YAML (optional) then `a.b=c` overrides, mirroring the reference's
    YAML-then-CLI precedence [SURVEY.md C12]."""
    s = Settings()
    if yaml_path:
        with open(yaml_path) as f:
            doc = yaml_subset.safe_load(f.read()) or {}
        _merge_dict(s, doc)
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        _apply(s, key.strip().split("."), val.strip())
    return s


def to_yaml(s: Settings) -> str:
    return yaml_subset.safe_dump(dataclasses.asdict(s))


def resolve_use_pallas(value, device: torch.device | str) -> bool:
    """Resolve mcmc.usePallas for a model on `device`: "auto" -> True iff
    the device is CUDA; explicit booleans / strings pass through, except
    that false on a CUDA device raises (the plain path is for CPU tensors;
    the port never switches to it, or to the CPU, silently)."""
    cuda = torch.device(device).type == "cuda"
    if isinstance(value, bool):
        use = value
    else:
        v = str(value).strip().lower()
        if v == "auto":
            return cuda
        if v in ("1", "true", "yes", "on"):
            use = True
        elif v in ("0", "false", "no", "off"):
            use = False
        else:
            # A typo ('ture', 'enable') must not silently pick a path.
            raise ValueError(
                f"mcmc.usePallas: unrecognized value {value!r} "
                f"(expected true/false/auto)"
            )
    if cuda and not use:
        raise ValueError(
            "mcmc.usePallas is false, but the model is on a CUDA device, "
            "where the density runs only through the kernels: set "
            "mcmc.usePallas to true (or auto, where the YAML does not set "
            "it: `--set mcmc.usePallas=auto` over a YAML boolean reads as "
            "false), or run with --device cpu"
        )
    return use
