"""Profiling / tracing helpers.

The reference's observability was an FPS overlay and Debug.Log cadence
(``FPSDisplay.cs``, ``SoftBodyDebugger.cs:118-146``).  Here: ``jax.profiler``
trace capture for TensorBoard, a steps/sec meter, and a timing harness that
is honest about async dispatch (waits with ``jax.block_until_ready``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import jax

from ..core.state import SimState


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (open with TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class StepTimer:
    """Exponentially smoothed steps/sec meter (the FPSDisplay analog,
    ``FPSDisplay.cs:11-16``)."""

    smoothing: float = 0.9
    _rate: float = 0.0
    _last: Optional[float] = None

    def tick(self, n_steps: int = 1) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                inst = n_steps / dt
                self._rate = (self.smoothing * self._rate
                              + (1 - self.smoothing) * inst
                              if self._rate else inst)
        self._last = now
        return self._rate

    @property
    def rate(self) -> float:
        return self._rate


def measure_throughput(step_fn: Callable[[SimState], SimState],
                       state: SimState, particles_per_step: int,
                       target_seconds: float = 3.0,
                       max_calls: int = 10_000) -> dict:
    """Time a jitted step honestly: warm up, then loop, waiting for the
    device with ``jax.block_until_ready``.  Returns a stats dict."""
    state = jax.block_until_ready(step_fn(state))  # compile + warm up

    calls = 0
    t0 = time.perf_counter()
    while True:
        state = step_fn(state)
        calls += 1
        if calls >= max_calls:
            break
        if calls % 8 == 0:
            jax.block_until_ready(state)
            if time.perf_counter() - t0 >= target_seconds:
                break
    jax.block_until_ready(state)  # all work done
    elapsed = time.perf_counter() - t0
    return {
        "calls": calls,
        "elapsed_s": elapsed,
        "steps_per_sec": calls / elapsed,
        "particle_steps_per_sec": calls * particles_per_step / elapsed,
        "final_state": state,
    }
