"""Target-utilisation autoscaler + warm pool (paper §IV.B / k8s HPA style).

Post-refactor each ReplicaPool owns its own AutoScaler; a CapacityBudget
shared across pools caps the fleet-wide replica count so one pool scaling
up spends headroom the others can no longer claim (heterogeneous pools
compete for the same accelerators).

Budgets nest: a cell-local budget may point at a `parent` budget (the
global fleet cap in a multi-cell federation — see serving/federation.py).
A grant must then clear BOTH levels: a cell can never exceed its own
budget, and the sum of all cells can never exceed the parent's, so cells
stay independent until the global cap actually binds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ScalerConfig:
    min_replicas: int = 1
    max_replicas: int = 32
    target_util: float = 0.6
    scale_up_cooldown_s: float = 2.0
    scale_down_cooldown_s: float = 15.0
    warm_pool_size: int = 2


@dataclasses.dataclass
class CapacityBudget:
    """Replica budget shared by every pool's autoscaler. With a `parent`,
    this is one cell's slice of a global cap: acquire() grants only what
    both this budget AND the parent can cover."""

    total: int
    used: int = 0
    parent: Optional["CapacityBudget"] = None

    def acquire(self, n: int) -> int:
        """Grant up to n replicas' worth of capacity; returns the grant."""
        grant = max(0, min(n, self.total - self.used))
        if grant and self.parent is not None:
            grant = self.parent.acquire(grant)
        self.used += grant
        return grant

    def release(self, n: int) -> None:
        freed = min(n, self.used)
        self.used -= freed
        if freed and self.parent is not None:
            self.parent.release(freed)

    @property
    def available(self) -> int:
        mine = self.total - self.used
        if self.parent is not None:
            return min(mine, self.parent.available)
        return mine


class AutoScaler:
    """Decides the desired replica count from observed utilisation.
    Replicas spawned from the warm pool become ready in warm_start_s,
    beyond-pool spawns pay cold_start_s (the warm pool then replenishes)."""

    def __init__(self, cfg: ScalerConfig):
        self.cfg = cfg
        self.last_up = -1e9
        self.last_down = -1e9
        self.warm_available = cfg.warm_pool_size

    def desired(self, now: float, n_active: int, utilisation: float) -> int:
        want = n_active
        if utilisation > self.cfg.target_util and now - self.last_up >= self.cfg.scale_up_cooldown_s:
            # classic HPA formula: ceil(n * util / target)
            want = min(
                self.cfg.max_replicas,
                max(n_active + 1, int(n_active * utilisation / self.cfg.target_util + 0.999)),
            )
            if want > n_active:
                self.last_up = now
        elif utilisation < 0.3 * self.cfg.target_util and now - self.last_down >= self.cfg.scale_down_cooldown_s:
            want = max(self.cfg.min_replicas, n_active - 1)
            if want < n_active:
                self.last_down = now
        return want

    def take_start_delay(self, warm_start_s: float, cold_start_s: float) -> float:
        """Start latency for one new replica; consumes warm pool if available."""
        if self.warm_available > 0:
            self.warm_available -= 1
            return warm_start_s
        return cold_start_s

    def replenish(self):
        if self.warm_available < self.cfg.warm_pool_size:
            self.warm_available += 1
