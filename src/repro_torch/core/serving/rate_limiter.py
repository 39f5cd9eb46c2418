"""Hybrid token-bucket rate limiter (paper §IV.B): per-tier buckets plus a
load-adaptive shed of the lowest tiers when the SLO is threatened.

Public API
    TierPolicy(rate, burst)      tokens/s refill and bucket cap, in WORK
                                 items (or requests when cost stays 1)
    HybridRateLimiter.admit(now, tier, cost=1)   draw `cost` tokens;
                                 False = shed (tier shed or bucket empty)
    HybridRateLimiter.adapt(p99, slo)   load feedback: shed one more tier
                                 on breach, recover when p99 < 0.6*slo
    shed_order                   explicit shed sequence (first shed
                                 first); default sheds by NUMERIC tier
                                 suffix descending, not lexically

Token draws are cost-weighted: a 512-candidate ranking query drains 512
tokens where a pointwise query drains 1, so a tier's budget bounds admitted
WORK items, not request counts (DeepRecSys-style admission). Callers doing
plain request-count limiting leave cost at its default of 1; callers
admitting ranking traffic by work must size `burst` at least as large as
the biggest single-request cost they want to ever admit.

Invariants: admit() is deterministic given the call sequence (refill is
computed from timestamps, never wall clock); the highest-priority tier is
never shed (shed_level tops out at n_tiers - 1); unknown tier names are
rejected rather than admitted free. Times in seconds, rates per second.

The fleet keeps one limiter at the front door (request-count draws) and
each ReplicaPool may own another (cost-weighted draws, adapted from that
pool's own SLOMonitor) — see pool.py. In a federation, a cell shedding
at either level is what triggers reactive cross-cell spillover — the
request is offered to a remote cell instead of being dropped
(federation.py counts it spilled, not rejected).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple, Union


@dataclasses.dataclass
class TierPolicy:
    rate: float  # tokens/s
    burst: float


def _tier_sort_key(name: str) -> Tuple[str, Union[int, float]]:
    """Priority key: alpha prefix, then NUMERIC suffix — so "tier10" sorts
    after "tier9" (lower priority), not between "tier1" and "tier2" as a
    plain lexical sort would. Names without a numeric suffix keep lexical
    order among themselves and rank above suffixed ones with equal prefix."""
    m = re.match(r"(.*?)(\d+)$", name)
    if m:
        return (m.group(1), int(m.group(2)))
    return (name, -1)


class HybridRateLimiter:
    """`shed_order`, when given, lists tiers in the order they are shed
    (first element shed first); it must name every tier exactly once.
    Otherwise tiers shed from the highest numeric suffix down ("tier11"
    before "tier10" before ... "tier2" — not lexically)."""

    def __init__(
        self,
        tiers: Dict[str, TierPolicy],
        shed_order: Optional[Sequence[str]] = None,
    ):
        self.tiers = tiers
        self.tokens = {t: p.burst for t, p in tiers.items()}
        self.last = 0.0
        self.shed_level = 0  # 0 = admit all; k = shed k lowest tiers
        if shed_order is not None:
            if sorted(shed_order) != sorted(tiers):
                raise ValueError(
                    f"shed_order must name every tier exactly once; "
                    f"got {list(shed_order)!r} for tiers {sorted(tiers)!r}"
                )
            # _order stores best-first; shedding consumes from the end
            self._order = list(reversed(list(shed_order)))
        else:
            self._order = sorted(tiers, key=_tier_sort_key)

    def _refill(self, now: float):
        dt = max(now - self.last, 0.0)
        self.last = now
        for t, p in self.tiers.items():
            self.tokens[t] = min(p.burst, self.tokens[t] + dt * p.rate)

    def admit(self, now: float, tier: str, cost: float = 1.0) -> bool:
        self._refill(now)
        if self.shed_level and tier in self._order[-self.shed_level:]:
            return False
        if self.tokens.get(tier, 0.0) >= cost:
            self.tokens[tier] -= cost
            return True
        return False

    def adapt(self, p99: float, slo: float):
        """Load feedback: shed lowest tier when p99 breaches the SLO,
        recover when comfortably below."""
        if p99 > slo and self.shed_level < len(self._order) - 1:
            self.shed_level += 1
        elif p99 < 0.6 * slo and self.shed_level > 0:
            self.shed_level -= 1
