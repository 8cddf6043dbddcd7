"""Arrival processes for open multi-tenant workflow streams.

The paper (and its companion WaaS-platform paper) evaluates a *continuous*
workload of workflows arriving at runtime; the original grid harness only
ever drew homogeneous-Poisson arrivals fixed at t=0.  This module models
the arrival side of a tenant as a first-class object:

* :class:`Poisson` — homogeneous rate (the legacy behavior as the special
  case every other process generalizes);
* :class:`MarkovModulated` — 2-state MMPP: bursty traffic that dwells in a
  quiet state and a burst state with exponential holding times;
* :class:`Diurnal` — sinusoidal rate (day/night load), sampled by Lewis &
  Shedler thinning of a dominating homogeneous process;
* :class:`TraceReplay` — replays recorded submission timestamps, optionally
  scaled and looped.

Every process is a frozen dataclass and draws exclusively from the
``numpy.random.Generator`` handed to it, so a stream is **deterministic in
(process, seed)** — the property the scenario registry, the parity tests
and the CI floors all rely on.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..core.types import MS


class ArrivalProcess:
    """Base class: generate ``n`` absolute arrival timestamps (ms)."""

    def arrival_times_ms(self, n: int, rng: np.random.Generator) -> List[int]:
        raise NotImplementedError

    def mean_rate_per_min(self) -> float:
        """Nominal long-run rate (reporting only)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Poisson(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate_per_min`` workflows/minute."""

    rate_per_min: float

    def __post_init__(self):
        if self.rate_per_min <= 0:
            raise ValueError(
                f"Poisson rate must be > 0, got {self.rate_per_min}")

    def arrival_times_ms(self, n: int, rng: np.random.Generator) -> List[int]:
        inter_ms = 60.0 * MS / self.rate_per_min
        gaps = rng.exponential(inter_ms, n)
        return np.floor(np.cumsum(gaps) - gaps[0]).astype(np.int64).tolist() \
            if n else []

    def mean_rate_per_min(self) -> float:
        return self.rate_per_min


@dataclasses.dataclass(frozen=True)
class MarkovModulated(ArrivalProcess):
    """2-state Markov-modulated Poisson process (bursty tenants).

    The process dwells in state 0 (``quiet_rate_per_min``) and state 1
    (``burst_rate_per_min``) with exponential holding times of mean
    ``mean_dwell_s`` each, emitting Poisson arrivals at the state's rate.
    A zero-rate state emits nothing for its whole dwell (the interrupted-
    Poisson silent/burst special case).
    """

    quiet_rate_per_min: float
    burst_rate_per_min: float
    mean_dwell_s: float = 60.0

    def __post_init__(self):
        if self.quiet_rate_per_min < 0 or self.burst_rate_per_min < 0:
            raise ValueError("MMPP rates must be >= 0")
        if self.quiet_rate_per_min == 0 and self.burst_rate_per_min == 0:
            raise ValueError("MMPP needs at least one state rate > 0")
        if self.mean_dwell_s <= 0:
            raise ValueError(
                f"MMPP mean_dwell_s must be > 0, got {self.mean_dwell_s}")

    def arrival_times_ms(self, n: int, rng: np.random.Generator) -> List[int]:
        rates = (self.quiet_rate_per_min, self.burst_rate_per_min)
        out: List[int] = []
        t = 0.0
        state = 0
        state_end = rng.exponential(self.mean_dwell_s * MS)
        while len(out) < n:
            if rates[state] == 0.0:
                # Silent state: no arrivals until the dwell expires.
                t = state_end
                state = 1 - state
                state_end = t + rng.exponential(self.mean_dwell_s * MS)
                continue
            gap = rng.exponential(60.0 * MS / rates[state])
            if t + gap >= state_end:
                # Jump to the state boundary and flip; the memorylessness
                # of the exponential makes discarding the partial gap
                # exact for an MMPP.
                t = state_end
                state = 1 - state
                state_end = t + rng.exponential(self.mean_dwell_s * MS)
                continue
            t += gap
            out.append(int(t))
        base = out[0] if out else 0
        return [x - base for x in out]

    def mean_rate_per_min(self) -> float:
        return 0.5 * (self.quiet_rate_per_min + self.burst_rate_per_min)


@dataclasses.dataclass(frozen=True)
class Diurnal(ArrivalProcess):
    """Sinusoidal-rate arrivals: rate(t) oscillates between ``base`` and
    ``peak`` workflows/minute with the given period (day/night load),
    sampled by thinning a homogeneous process at the peak rate."""

    base_rate_per_min: float
    peak_rate_per_min: float
    period_s: float = 24 * 3600.0
    phase: float = 0.0            # radians; 0 starts mid-ramp

    def __post_init__(self):
        if not 0 <= self.base_rate_per_min <= self.peak_rate_per_min:
            raise ValueError(
                f"Diurnal needs 0 <= base <= peak, got "
                f"({self.base_rate_per_min}, {self.peak_rate_per_min})")
        if self.peak_rate_per_min <= 0:
            raise ValueError("Diurnal peak rate must be > 0")
        if self.period_s <= 0:
            raise ValueError(f"Diurnal period must be > 0, got "
                             f"{self.period_s}")

    def arrival_times_ms(self, n: int, rng: np.random.Generator) -> List[int]:
        lam_max = self.peak_rate_per_min
        mid = 0.5 * (self.base_rate_per_min + self.peak_rate_per_min)
        amp = 0.5 * (self.peak_rate_per_min - self.base_rate_per_min)
        out: List[int] = []
        t = 0.0
        period_ms = self.period_s * MS
        while len(out) < n:
            t += rng.exponential(60.0 * MS / lam_max)
            lam_t = mid + amp * np.sin(
                2.0 * np.pi * t / period_ms + self.phase)
            if rng.random() * lam_max <= lam_t:
                out.append(int(t))
        base = out[0] if out else 0
        return [x - base for x in out]

    def mean_rate_per_min(self) -> float:
        return 0.5 * (self.base_rate_per_min + self.peak_rate_per_min)


@dataclasses.dataclass(frozen=True)
class TraceReplay(ArrivalProcess):
    """Replay recorded submission times (ms), scaled by ``time_scale``;
    when the trace is shorter than ``n`` the tail loops with the trace's
    own span as the loop period.  Draws nothing from the rng — replay is
    deterministic by construction."""

    times_ms: Tuple[int, ...]
    time_scale: float = 1.0

    def arrival_times_ms(self, n: int, rng: np.random.Generator) -> List[int]:
        if not self.times_ms:
            raise ValueError("TraceReplay needs at least one timestamp")
        base = self.times_ms[0]
        rel = [int((t - base) * self.time_scale) for t in self.times_ms]
        span = max(rel[-1], 1) + (rel[1] - rel[0] if len(rel) > 1 else MS)
        out = [rel[i % len(rel)] + span * (i // len(rel)) for i in range(n)]
        return out

    def mean_rate_per_min(self) -> float:
        if len(self.times_ms) < 2:
            return 0.0
        span_min = (self.times_ms[-1] - self.times_ms[0]) \
            * self.time_scale / (60.0 * MS)
        return (len(self.times_ms) - 1) / span_min if span_min > 0 else 0.0
