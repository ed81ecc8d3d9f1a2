"""What ``prepare`` and ``Plan`` read from the EE-Join cost model.

A copy of the names of ``repro.core.cost_model`` that the operator's
prepare/execute path needs: the algorithm and objective names, the
option space, ``CostParams`` and ``SideCost``. The cost functions and
the plan search come with plan choice (ROADMAP, queue A item 4).
"""
from __future__ import annotations

import dataclasses

OBJ_WORK = "work_done"
OBJ_JOB = "job_completion"
OBJECTIVES = (OBJ_WORK, OBJ_JOB)

ALGO_INDEX = "index"
ALGO_SSJOIN = "ssjoin"

INDEX_KINDS = ("word", "prefix", "variant")
SSJ_SCHEMES = ("word", "prefix", "lsh", "variant")
ALL_OPTIONS: tuple[tuple[str, str], ...] = tuple(
    [(ALGO_INDEX, k) for k in INDEX_KINDS] + [(ALGO_SSJOIN, s) for s in SSJ_SCHEMES]
)


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Hardware + calibrated per-record constants (seconds / bytes).

    The per-record defaults are the reference's TPU-scale estimates; the
    port recalibrates them on the GPU with plan choice. ``prepare`` reads
    only ``hbm_budget_bytes``, the index memory budget per device.
    """

    num_devices: int = 256
    hbm_budget_bytes: float = 4e9
    ici_bytes_per_s: float = 50e9
    c_enum_per_window: float = 2e-10
    c_filter_per_window: float = 5e-10
    c_sig_per_window: dict | None = None
    c_probe: float = 2e-9
    c_verify_pair: float = 6e-9
    c_probe_index: float = 2e-9
    c_verify_index: float = 6e-9
    shuffle_bytes_per_record: float = 4.0 * 8 + 16.0
    dict_prep_per_entity: float = 2e-7
    lane_density: float = 0.0

    def sig_cost(self, scheme: str) -> float:
        d = self.c_sig_per_window or {}
        default = {"word": 2e-9, "prefix": 2e-9, "lsh": 1.2e-8, "variant": 4e-9}
        return d.get(scheme, default[scheme])


@dataclasses.dataclass(frozen=True)
class SideCost:
    """Cost breakdown of one plan side (seconds, job-completion basis)."""

    enum: float
    filter: float
    sig: float
    shuffle: float
    lookup: float
    verify: float
    passes: int
    work_done: float
    job_completion: float

    @property
    def total(self) -> dict:
        return dataclasses.asdict(self)
