"""Typed run configuration.

Replaces the reference's ``eval()``-parsed ``SetPMTS.txt`` one-dict-per-line
config files (reference: example/uniformgrid/main_uniform.py:98-105) with a
dataclass parsed via ``json`` — the reference's lines are in fact valid JSON,
so existing files load unchanged. Parameter names are kept identical for
parity (reference: readme.md:126-132).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional, Sequence, Union


@dataclasses.dataclass
class HMCConfig:
    """One HMC inversion run.

    Field names mirror a ``SetPMTS.txt`` line; extra knobs that the reference
    hard-codes in its ``main_*.py`` scripts are exposed here with the same
    defaults (reference: example/uniformgrid/main_uniform.py:52-74).
    """

    # --- SetPMTS.txt parameters -------------------------------------------
    set: str = "run"
    test: str = "T0"
    rhomin: float = 0.0
    rhomax: float = 1.0
    #: (dz, dy, dx) for Cartesian; (dlon, dlat, dr) order in spherical files
    mspacing: Union[Sequence[float], Any] = (100.0, 100.0, 100.0)
    Lrange: Sequence[int] = (10, 50)
    #: leapfrog step size (the reference's ``delta``)
    delta: float = 0.01
    #: momentum scale (the reference draws p ~ N(0, Sigma^2) with an
    #: identity mass matrix, reference: inversion/hmc.py:95,386-389)
    Sigma: float = 0.001
    RegulFactor: float = 1.0
    regularization: str = "Damping"  # MS | Damping | Smoothness | TV
    beta: float = 0.01
    nsamples: int = 500
    mratio: float = 1.0

    # --- main-script parameters -------------------------------------------
    seed: int = 100
    ndraws: int = 0
    constraint: str = "mandatory"  # mandatory | logarithmic
    log_factor: float = 1000.0
    wavelet: Union[bool, str] = False  # False | '1D' | '3D'
    save_folder: str = "result/chain"
    nbest: int = 100

    # --- accelerator knobs --------------------------------------------------
    #: number of parallel chains (replaces ``mpiexec -n``)
    nchains: int = 2
    #: sampler iterations per jitted device chunk
    chunk_size: int = 64
    #: kernel-matrix build: 'f64' (host, exact) or 'f32' (device, fast)
    kernel_precision: str = "f64"
    #: storage dtype of the weighted kernel used in the sampler hot loop
    matvec_dtype: str = "float32"

    extra: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "HMCConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        extra = {k: v for k, v in d.items() if k not in known}
        cfg = cls(**kwargs)
        cfg.extra.update(extra)
        return cfg

    @classmethod
    def from_json_line(cls, line: str) -> "HMCConfig":
        return cls.from_dict(json.loads(line))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d


def load_setpmts(path: str) -> List[HMCConfig]:
    """Load a SetPMTS.txt-style file: one JSON dict per non-empty line."""
    configs = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            configs.append(HMCConfig.from_json_line(line))
    return configs
