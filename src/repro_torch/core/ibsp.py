"""iBSP accounting shared by the engines (counterpart of
``repro.core.ibsp``; the host iBSP engine itself is not ported yet)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BSPStats:
    supersteps: int = 0
    compute_calls: int = 0
    superstep_messages: int = 0
    timestep_messages: int = 0
    merge_messages: int = 0

    def merge_from(self, other: "BSPStats") -> None:
        self.supersteps += other.supersteps
        self.compute_calls += other.compute_calls
        self.superstep_messages += other.superstep_messages
        self.timestep_messages += other.timestep_messages
        self.merge_messages += other.merge_messages
