"""Execution-plan space for the EE-Join operator (§5.1).

A plan splits the frequency-sorted dictionary at ``split``: entities
``[0, split)`` (the most frequently mentioned) are processed by the
*head* (algorithm, scheme) pair and ``[split, E)`` by the *tail* pair.
``split == 0`` / ``split == E`` degenerate to the pure single-algorithm
plans, so the hybrid space strictly contains the paper's §3.5 options.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cost_model import SideCost


@dataclasses.dataclass(frozen=True)
class PlanSide:
    algo: str  # "index" | "ssjoin"
    scheme: str  # index kind or signature scheme

    def __str__(self) -> str:
        return f"{self.algo}:{self.scheme}"


@dataclasses.dataclass(frozen=True)
class Plan:
    split: int
    head: PlanSide
    tail: PlanSide
    objective: str
    predicted_cost: float
    head_cost: SideCost
    tail_cost: SideCost
    evaluations: int  # cost-model evaluations spent finding this plan

    @property
    def is_pure(self) -> bool:
        return self.split == 0 or self.head == self.tail

    def describe(self, num_entities: int) -> str:
        if self.split == 0:
            return f"pure {self.tail} (cost {self.predicted_cost:.4g}s)"
        if self.split >= num_entities:
            return f"pure {self.head} (cost {self.predicted_cost:.4g}s)"
        return (
            f"hybrid head[0:{self.split}]={self.head} "
            f"tail[{self.split}:{num_entities}]={self.tail} "
            f"(cost {self.predicted_cost:.4g}s)"
        )
