"""Failure detection and graceful recovery.

The reference detects NaN/Inf at three choke points and degrades gracefully
(GPU-side scrub ``XPBDSoftBody.compute:191-195``; readback scan flipping
``useCPUFallback`` at ``SoftBodySimulator.cs:806-810,841-847``; init
try/catch ``:72-77``; plus ``ResetToInitialPositions`` ``:880-898``).

Our equivalents:
  * ``is_finite`` (core/state) — one device-side reduction;
  * ``scrub`` — replace non-finite entries with safe values (the
    UpdateMesh NaN-scrub analog, but on state instead of render data);
  * ``FailsafeStepper`` — wraps any stepper: periodically snapshots known
    -good state, checks health every ``check_every`` steps, and on failure
    restores the last good snapshot (optionally with damped velocities) —
    the functional analog of the auto-CPU-fallback + reset path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.state import SimState, is_finite, restore, snapshot


@jax.jit
def scrub(state: SimState, default_position=(0.0, 1.0, 0.0)) -> SimState:
    """Replace non-finite entries with safe defaults (position -> the safe
    point, velocity/force/lambda -> 0); the ValidatePosition analog
    (``XPBDSimulatorCS.compute:55-66``)."""
    safe_pos = jnp.asarray(default_position, state.positions.dtype)

    def fix(x, default):
        return jnp.where(jnp.isfinite(x), x, default)

    return state.replace(
        positions=fix(state.positions, safe_pos[None, :]),
        velocities=fix(state.velocities, 0.0),
        ext_force=fix(state.ext_force, 0.0),
        lambda_dist=fix(state.lambda_dist, 0.0),
        lambda_bend=fix(state.lambda_bend, 0.0),
        lambda_volume=fix(state.lambda_volume, 0.0),
        lambda_tet=(None if state.lambda_tet is None
                    else fix(state.lambda_tet, 0.0)),
    )


@dataclasses.dataclass
class FailsafeStepper:
    """step() with automatic snapshot/restore on non-finite state.

    check_every    — health-check cadence in steps.  Each check is a device
                     reduction plus ONE scalar device->host fetch, which
                     waits for the step, so size check_every to your step
                     cost (or fold an ``is_finite`` output into your own
                     compiled step and check that instead).
    A non-finite INITIAL state is scrubbed before first use so the recovery
    point is always finite.
    snapshot_every — known-good snapshot cadence in steps.
    on_failure     — optional callback(step_index) fired at each recovery.
    damp_on_restore— velocity scale applied to the restored state (shed the
                     energy that likely caused the blow-up).
    """

    step_fn: Callable[[SimState], SimState]
    check_every: int = 10
    snapshot_every: int = 50
    on_failure: Optional[Callable[[int], None]] = None
    damp_on_restore: float = 0.5

    _good: Optional[SimState] = None
    _step_count: int = 0
    recoveries: int = 0

    def __call__(self, state: SimState) -> SimState:
        if self._good is None:
            # never store a non-finite recovery point: restoring it would
            # loop forever without making progress
            if not bool(is_finite(state)):
                state = scrub(state)
            self._good = snapshot(state)
        out = self.step_fn(state)
        self._step_count += 1
        failed = False
        if self._step_count % self.check_every == 0:
            if not bool(is_finite(out)):
                failed = True
                self.recoveries += 1
                if self.on_failure is not None:
                    self.on_failure(self._step_count)
                restored = restore(self._good)
                out = restored.replace(
                    velocities=restored.velocities * self.damp_on_restore)
        # snapshot cadence is independent of the check cadence (but a
        # snapshot is only taken from a state verified finite right now)
        if (not failed and self._step_count % self.snapshot_every == 0
                and bool(is_finite(out))):
            self._good = snapshot(out)
        return out
