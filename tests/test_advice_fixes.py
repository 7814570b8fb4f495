"""Regression tests for the round-1 review findings:

1. Chebyshev acceleration must not re-penetrate contacts it just resolved;
2. omega has the SAME meaning in every engine (scale on the
   1/max-conflict-degree-averaged Jacobi update, default 1.0);
3. native weld must not alias far-apart vertices (21-bit overflow);
4. FailsafeStepper must never store a non-finite recovery point.
"""

import numpy as np
import pytest

from softbodysimulation_tpu import (
    FloorMode,
    LambdaMode,
    SolveMode,
    SolverConfig,
    is_finite,
    state_from_topology,
)
from softbodysimulation_tpu.diag.health import FailsafeStepper
from softbodysimulation_tpu.solvers import general
from softbodysimulation_tpu.solvers import lattice as lat_engine
from softbodysimulation_tpu.topology import build, lattice, native

DT = 0.02


# ------------------------------------------------ 1. Chebyshev vs contacts
def test_chebyshev_final_iterate_respects_floor():
    """The accelerated substep's output must be as contact-feasible as the
    unaccelerated one: the momentum extrapolation is re-projected against
    the floor (accelerated-PBD excludes contact from the momentum term)."""
    pos = lattice.lattice_points(4, center=(0, 0.3, 0))
    edges, comp = lattice.lattice_edges(4)
    topo = build.build_topology(pos, edges, comp)

    def run(rho):
        cfg = SolverConfig(substeps=2, iterations=8,
                           solve_mode=SolveMode.JACOBI, jacobi_rho=rho,
                           ground_height=0.0,
                           floor_mode=FloorMode.XPBD_INEQUALITY)
        st = state_from_topology(topo, pos)
        step = general.make_step(topo, cfg, DT, n_steps=40)
        out = step(st)
        return float(np.asarray(out.positions)[:, 1].min())

    pen_plain = run(rho=0.0)
    pen_accel = run(rho=0.9)
    # both settle on the floor; the accelerated run may not penetrate
    # (materially) deeper than the plain Jacobi run
    assert pen_accel >= pen_plain - 1e-4
    assert pen_accel >= -1e-3


# ------------------------------------------------------- 2. omega semantics
def _one_iter_correction_general(omega):
    """Correction applied by ONE Jacobi iteration of the general engine on a
    stretched lattice (no gravity, zero velocity => predict == positions)."""
    pos = lattice.lattice_points(3, center=(0, 1.0, 0)) * 1.1
    edges, comp = lattice.lattice_edges(3)
    rest = np.linalg.norm(
        (pos[edges[:, 0]] - pos[edges[:, 1]]) / 1.1, axis=1)
    topo = build.build_topology(pos, edges, comp, rest_lengths=rest)
    cfg = SolverConfig(substeps=1, iterations=1, gravity=(0, 0, 0),
                       solve_mode=SolveMode.JACOBI, omega=omega,
                       lambda_mode=LambdaMode.RESET)
    st = state_from_topology(topo, pos)
    out = general.step(st, topo, cfg, DT)
    return np.asarray(out.positions) - pos


def _one_iter_correction_lattice(omega):
    spec = lattice.lattice_spec(3)
    cfg = SolverConfig(substeps=1, iterations=1, gravity=(0, 0, 0),
                       solve_mode=SolveMode.JACOBI, omega=omega,
                       lambda_mode=LambdaMode.RESET)
    st = lat_engine.make_lattice_state(spec, center=(0.0, 1.0, 0.0))
    stretched = st.replace(positions=st.positions * 1.1)
    out = lat_engine.make_step(spec, cfg, DT)(stretched)
    return np.asarray(out.positions) - np.asarray(stretched.positions)


@pytest.mark.parametrize("correction",
                         [_one_iter_correction_general,
                          _one_iter_correction_lattice],
                         ids=["general", "lattice"])
def test_omega_semantics_agree_across_engines(correction):
    base = correction(0.0)       # default => omega = 1.0 in every engine
    explicit = correction(1.0)   # explicit 1.0 must equal the default
    half = correction(0.5)
    np.testing.assert_allclose(explicit, base, rtol=0, atol=0)
    assert np.abs(base).max() > 1e-4  # the sweep actually did something
    # omega scales the per-pass update down.  The general engine's single
    # simultaneous sweep is exactly linear in omega; the stencil engine
    # composes sequential family passes (GS across families) so the
    # composition is only approximately linear — assert the shared
    # semantic: half omega => materially smaller correction, same shape.
    nb, nh = np.linalg.norm(base), np.linalg.norm(half)
    assert 0.3 < nh / nb < 0.9
    cos = float((base * half).sum()) / (nb * nh)
    assert cos > 0.95


def test_omega_linear_in_general_engine():
    base = _one_iter_correction_general(0.0)
    half = _one_iter_correction_general(0.5)
    # one simultaneous sweep is linear in omega (lambda starts at 0);
    # tolerance covers f32 cancellation when extracting ~1e-3 corrections
    # off ~1.1-magnitude positions
    np.testing.assert_allclose(half, base * 0.5, rtol=2e-3, atol=1e-6)


# ------------------------------------------------------------ 3. weld range
needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable")


@needs_native
def test_native_weld_no_21bit_aliasing():
    """x=5.0 and x=5.0 - 2^21*eps quantise to keys exactly 2^21 apart; the
    old 21-bit packed key aliased them into one vertex."""
    eps = 1e-6
    verts = np.array([[5.0, 0.0, 0.0],
                      [5.0 - (2 ** 21) * eps, 0.0, 0.0],
                      [5.0, 0.0, 0.0]], dtype=np.float32)
    mapping, count = native.weld_map(verts, eps)
    assert count == 2
    assert mapping[0] == mapping[2]
    assert mapping[0] != mapping[1]


# ------------------------------------- 4. failsafe non-finite initial state
def test_failsafe_recovers_from_nonfinite_initial_state():
    spec = lattice.lattice_spec(3, braced=True)
    cfg = SolverConfig(substeps=1, iterations=2, solve_mode=SolveMode.JACOBI,
                       ground_height=0.0)
    st = lat_engine.make_lattice_state(spec, center=(0, 1, 0))
    bad = st.replace(positions=st.positions * np.nan)
    assert not bool(is_finite(bad))

    inner = lat_engine.make_step(spec, cfg, DT)
    stepper = FailsafeStepper(inner, check_every=2, snapshot_every=100)
    out = bad
    for _ in range(4):
        out = stepper(out)
    # the recovery point is scrubbed-finite, so the run self-heals (the
    # first call steps the scrubbed state) instead of restoring NaNs forever
    assert bool(is_finite(out))
    assert stepper._good is not None and bool(is_finite(stepper._good))
