"""Host-side wave scheduler: the jobtracker analog (paper §2.2, §5.1.3),
the JAX package's ``distributed/wavescheduler.py`` on this package's
checkpoint format.

The *job* level -- streaming a large descriptor collection through the
index pipeline, or a large query log through search -- is a sequence of
**waves**. This scheduler owns that level and provides what Hadoop's
jobtracker provided in the paper:

  * retry of failed waves (re-execution is deterministic: same inputs ->
    same outputs, so a retried wave is bit-identical);
  * wave statistics (durations, attempts, stragglers) -- the data behind
    the paper's Table 5 and Figs 2/6/8;
  * periodic checkpointing of the wave cursor + reduced state, and resume
    (the 60-hour-run / node-failure story of paper §3);
  * elastic replanning: waves are data-defined (:func:`plan_waves`).

Checkpoints go through :class:`~repro_torch.distributed.checkpoint.
CheckpointManager`, which takes explicit name tables, so ``state_to_tree``
maps a state to a flat ``{name: array}`` dict (``tree_to_state`` maps the
restored ``{name: tensor}`` back). Names are written in sorted order, as
the JAX package flattens a dict, so both packages write the same files
and read each other's checkpoints.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional

from repro_torch.distributed.checkpoint import CheckpointManager


@dataclasses.dataclass
class WaveRecord:
    wave: int
    attempt: int
    duration_s: float
    ok: bool
    error: str = ""


@dataclasses.dataclass
class WaveRunResult:
    state: Any
    records: list
    completed: int

    @property
    def stragglers(self):
        """Waves slower than 2x the median successful duration."""
        ok = sorted(r.duration_s for r in self.records if r.ok)
        if not ok:
            return []
        median = ok[len(ok) // 2]
        return [r for r in self.records if r.ok and r.duration_s > 2 * median]


class WaveScheduler:
    """Runs ``state = fold(state, wave_fn(wave_input))`` over wave inputs."""

    def __init__(
        self,
        wave_fn: Callable[[Any], Any],
        fold: Callable[[Any, Any], Any] = lambda s, r: (s or []) + [r],
        *,
        max_retries: int = 2,
        failure_injector: Optional[Callable[[int, int], None]] = None,
        checkpoint: Optional[CheckpointManager] = None,
        checkpoint_every: int = 0,
        state_to_tree: Callable[[Any], dict] = lambda s: s,
        tree_to_state: Callable[[dict], Any] = lambda t: t,
    ):
        self.wave_fn = wave_fn
        self.fold = fold
        self.max_retries = max_retries
        self.failure_injector = failure_injector
        self.checkpoint = checkpoint
        self.checkpoint_every = checkpoint_every
        self.state_to_tree = state_to_tree
        self.tree_to_state = tree_to_state

    def _maybe_checkpoint(self, wave_idx: int, state):
        if (
            self.checkpoint
            and self.checkpoint_every
            and (wave_idx + 1) % self.checkpoint_every == 0
        ):
            arrays = self.state_to_tree(state)
            self.checkpoint.save(
                wave_idx + 1, {key: arrays[key] for key in sorted(arrays)},
                extra={"cursor": wave_idx + 1},
            )

    def resume_cursor(self) -> int:
        if not self.checkpoint:
            return 0
        step = self.checkpoint.latest_step()
        return step or 0

    def resume_state(self, template):
        """The latest checkpoint's state, restored under the names
        ``state_to_tree(template)`` gives (``None`` without one)."""
        if not self.checkpoint or self.checkpoint.latest_step() is None:
            return None
        arrays, _ = self.checkpoint.restore(sorted(self.state_to_tree(template)))
        return self.tree_to_state(arrays)

    def run(
        self,
        waves: Iterable[Any],
        *,
        init_state: Any = None,
        start_at: int = 0,
    ) -> WaveRunResult:
        state = init_state
        records = []
        completed = start_at
        for i, wave_input in enumerate(waves):
            if i < start_at:
                continue
            for attempt in range(self.max_retries + 1):
                t0 = time.perf_counter()
                try:
                    if self.failure_injector is not None:
                        self.failure_injector(i, attempt)
                    result = self.wave_fn(wave_input)
                    dt = time.perf_counter() - t0
                    records.append(WaveRecord(i, attempt, dt, True))
                    state = self.fold(state, result)
                    completed = i + 1
                    break
                except Exception as e:  # noqa: BLE001 - retry any wave failure
                    dt = time.perf_counter() - t0
                    records.append(WaveRecord(i, attempt, dt, False, repr(e)))
                    if attempt == self.max_retries:
                        raise
            self._maybe_checkpoint(i, state)
        return WaveRunResult(state=state, records=records, completed=completed)


def plan_waves(n_items: int, items_per_wave: int) -> list:
    """Split [0, n_items) into (start, size) waves -- elastic replanning is
    just calling this again with a different ``items_per_wave``."""
    waves = []
    start = 0
    while start < n_items:
        size = min(items_per_wave, n_items - start)
        waves.append((start, size))
        start += size
    return waves
