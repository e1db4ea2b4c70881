"""Deterministic failure injection for fault-tolerance tests and the
index job, the JAX package's ``distributed/failure.py`` (pure Python).

Grid'5000 gave the paper 1-5 node failures per 60-hour run (§3); we inject
the analogous events deterministically so tests can assert that retry +
checkpoint/resume reproduce the no-failure results bit-for-bit.
"""

from __future__ import annotations

from typing import Iterable


class InjectedFailure(RuntimeError):
    pass


class FailureInjector:
    """Raises on configured (wave, attempt) pairs; callable for WaveScheduler."""

    def __init__(self, fail_at: Iterable[tuple] = ()):
        self.fail_at = set(fail_at)
        self.fired = []

    def __call__(self, wave: int, attempt: int):
        if (wave, attempt) in self.fail_at:
            self.fired.append((wave, attempt))
            raise InjectedFailure(f"injected failure at wave={wave} attempt={attempt}")


class CrashAfter:
    """Simulates a whole-job crash (process death) after N successful waves —
    used to exercise checkpoint/restart."""

    def __init__(self, n_waves: int):
        self.n_waves = n_waves
        self.count = 0

    def __call__(self, wave: int, attempt: int):
        if wave >= self.n_waves:
            raise KeyboardInterrupt(f"simulated crash before wave {wave}")
