"""Typed configuration for ISDF runs (the port's copy of the JAX
package's ``fftisdf_tpu/utils/config.py``, field for field).

The reference's knobs are plain attributes and kwargs scattered over scripts
(``c0``, ``m0``, ``blksize``, ``ke_cutoff``, solver variant...; SURVEY.md
section 5 "Config / flag system").  This consolidates them into one
serializable dataclass used by the examples and the benchmark harness;
``FFTISDF`` accepts its fields directly.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass
class ISDFConfig:
    # compression
    c0: float = 20.0                  # interpolation points per AO (ref default)
    m0: tuple = (15, 15, 15)          # parent (selection) mesh
    select_tol: float | None = None   # pivot threshold (1e-20 = exact regime)
    # fitting solve
    solver: str = "lstsq"             # lstsq | pinv | svd
    rcond: float = 1e-10
    # discretization
    ke_cutoff: float | None = None
    kmesh: tuple = (1, 1, 1)
    blksize: int = 16384
    # accuracy gates (the reference's thresholds, SURVEY.md section 6)
    tol_identity: float = 1e-10
    tol_eri: float = 1e-4
    tol_scf_per_atom: float = 1e-6

    def isdf_kwargs(self) -> dict:
        return dict(c0=self.c0, m0=tuple(self.m0), solver=self.solver,
                    rcond=self.rcond, select_tol=self.select_tol,
                    blksize=self.blksize)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "ISDFConfig":
        data = json.loads(text)
        data["m0"] = tuple(data.get("m0", (15, 15, 15)))
        data["kmesh"] = tuple(data.get("kmesh", (1, 1, 1)))
        return cls(**data)
