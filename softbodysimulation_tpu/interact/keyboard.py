"""Non-blocking keyboard input for the live ``run --watch`` loop.

The headless answer to the reference's human-in-the-loop interaction
(``SoftBodyInteractor.cs:37-67``: Space = upward impulse, P/U = pin/unpin,
held-key drag; ``SoftBodyController.cs:56-80``: R = reset) minus the mouse
ray — headless terminals have no cursor-to-world ray, so directional pokes
ride WASD instead.  stdin is switched to raw/no-echo mode for the duration
of the watch loop and polled with ``select`` between frames: the
simulation never blocks on input, and every key maps to a device-side
``Session`` verb (impulses ride into the jitted step as state — zero extra
host round-trips, unlike the reference's full-buffer re-upload on every
poke, ``SoftBodySimulator.cs:940``).

Keys (see ``legend()``):
  space   impulse up at the COM          (AddForce(up*50, com, r=2))
  w/s     poke -z / +z                   a/d   poke -x / +x
  j/k     poke down / up
  p       pin around the COM             u     unpin around the COM
  1/2/3   hot-swap jelly/firm/bouncy preset
          (``SoftBodyController.cs:56-62``; needs a session rebuild hook)
  enter   play the curve-shaped ForceAnimation at the cursor
          (``SoftBodyController.cs:64-66`` -> PlayForceAnimation)
  Q       squeeze (``SoftBodyController.cs:67-68`` -> animator.Squeeze;
          capital — lowercase q stays quit)
  g       drag toward the cursor; hold for a continuous pull via key
          autorepeat (the LMB-hold drag, ``SoftBodyInteractor.cs:61-66``)
  r       restart from the initial snapshot
  q       quit the watch loop
"""

from __future__ import annotations

import contextlib
import os
import select
import sys
from typing import Callable, Iterator, List, Optional


@contextlib.contextmanager
def raw_stdin() -> Iterator[Callable[[], List[str]]]:
    """Context manager yielding a non-blocking ``poll() -> [keys]``.

    Falls back to a no-op poller when stdin is not a TTY (piped runs, CI,
    tests) so the watch loop degrades gracefully."""
    interactive = False
    fd = -1
    old = None
    try:
        fd = sys.stdin.fileno()
        interactive = fd >= 0 and os.isatty(fd)
    except Exception:  # noqa: BLE001 — pseudofiles (pytest), closed stdin
        interactive = False
    if interactive:
        import termios
        import tty

        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)

    def poll() -> List[str]:
        if not interactive:
            return []
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if not ch:
                break
            keys.append(ch)
        return keys

    try:
        yield poll
    finally:
        if interactive and old is not None:
            import termios

            termios.tcsetattr(fd, termios.TCSADRAIN, old)


def legend() -> str:
    return ("keys: hjkl/arrows+,.=move cursor  space=impulse@cursor  "
            "wasd=poke@cursor  g=drag  p=pin  u=unpin  1/2/3=preset  "
            "enter=play  Q=squeeze  c=recenter  r=restart  q=quit")


# live preset hot-swap trio (SoftBodyController.cs:19-23 + :56-62).  Only
# the FEEL fields are merged onto the scene's active config — structural
# fields (topology flags, self-collision backend/knobs, ground height,
# engine-shape choices) stay the scene's, so the rebuilt step keeps working
# on the same state/topology.
PRESET_KEYS = {"1": "jelly", "2": "firm", "3": "bouncy"}
_FEEL_FIELDS = ("substeps", "iterations", "damping", "damping_mode",
                "friction", "floor_mode", "restitution", "penetration_kick",
                "lambda_mode", "lambda_decay")


def preset_feel(base_cfg, name: str):
    """Merge preset ``name``'s feel fields onto ``base_cfg`` (the live
    hot-swap semantics: the reference preset overwrites the simulator's
    settings in place, ``SoftBodyPreset.ApplyToSoftBody``)."""
    from ..core.presets import get_preset

    p = get_preset(name)
    return base_cfg.replace(**{f: getattr(p, f) for f in _FEEL_FIELDS})


class Cursor:
    """Movable 3D world-space cursor — the headless replacement for the
    reference's mouse-ray world-position picking
    (``SoftBodyInteractor.GetMouseWorldPosition``,
    ``SoftBodyInteractor.cs:69-80``): instead of casting a camera ray, the
    user steers an explicit world point with vi keys / arrows and every
    interaction verb (poke, impulse, pin) lands AT that point.  The step
    size is a fraction of the body's bounding span so one keypress is a
    visible move at any scene scale."""

    def __init__(self, positions, step_frac: float = 0.06):
        import numpy as np

        p = np.asarray(positions)
        self.pos = p.mean(axis=0).astype(float)
        span = float((p.max(axis=0) - p.min(axis=0)).max())
        self.step = max(step_frac * span, 1e-3)

    def move(self, axis: int, sign: float) -> None:
        self.pos = self.pos.copy()
        self.pos[axis] += sign * self.step

    def recenter(self, positions) -> None:
        import numpy as np

        self.pos = np.asarray(positions).mean(axis=0).astype(float)

    def tuple(self):
        return (float(self.pos[0]), float(self.pos[1]), float(self.pos[2]))


def tokenize(chars: List[str]) -> List[str]:
    """Collapse raw stdin chars into key tokens: ANSI arrow escape
    sequences (ESC [ A..D) become 'up'/'down'/'right'/'left'; everything
    else passes through as single characters."""
    arrows = {"A": "up", "B": "down", "C": "right", "D": "left"}
    out: List[str] = []
    i = 0
    while i < len(chars):
        if (chars[i] == "\x1b" and i + 2 < len(chars)
                and chars[i + 1] == "[" and chars[i + 2] in arrows):
            out.append(arrows[chars[i + 2]])
            i += 3
        else:
            out.append(chars[i])
            i += 1
    return out


def apply_keys(session, keys, center=None, cursor: "Cursor" = None,
               impulse: float = 50.0, poke: float = 20.0,
               radius: float = 2.0, pin_radius: float = 0.5) -> dict:
    """Apply a batch of pressed keys to a ``Session``.  With a ``cursor``
    every verb targets the cursor's world position (and hjkl / arrow keys
    / ',' '.' steer it); otherwise ``center`` (default: the body's current
    centre of mass) is the target — the pre-cursor behaviour.  Returns a
    report dict with ``quit``/``acted`` flags and the actions taken (for
    the status line)."""
    import numpy as np

    report = {"quit": False, "acted": [], "restarted": False}
    keys = tokenize(list(keys))
    if not keys:
        return report
    if cursor is not None:
        center = cursor.tuple()
    elif center is None:
        center = tuple(np.asarray(session.state.positions).mean(axis=0))
    dirs = {
        " ": ("impulse", (0.0, impulse, 0.0)),
        "w": ("poke -z", (0.0, 0.0, -poke)),
        "s": ("poke +z", (0.0, 0.0, poke)),
        "a": ("poke -x", (-poke, 0.0, 0.0)),
        "d": ("poke +x", (poke, 0.0, 0.0)),
    }
    if cursor is None:
        # pre-cursor vertical pokes (j/k steer the cursor when one exists)
        dirs["j"] = ("poke -y", (0.0, -poke, 0.0))
        dirs["k"] = ("poke +y", (0.0, poke, 0.0))
    moves = {
        "h": (0, -1.0), "left": (0, -1.0),
        "l": (0, +1.0), "right": (0, +1.0),
        "j": (1, -1.0), "down": (1, -1.0),
        "k": (1, +1.0), "up": (1, +1.0),
        ",": (2, -1.0), ".": (2, +1.0),
    }
    for ch in keys:
        if ch == "Q":
            # capital Q = squeeze (SoftBodyController.cs:67-68); lowercase
            # q below stays quit
            session.squeeze()
            report["acted"].append("squeeze")
            continue
        c = ch.lower() if len(ch) == 1 else ch
        if c == "q":
            report["quit"] = True
        elif c in ("\r", "\n"):
            # Enter = PlayForceAnimation (SoftBodyController.cs:64-66):
            # schedule the curve-shaped upward force at the aim point
            from .animator import ForceAnimation

            session.play(ForceAnimation(radius=radius), center=center)
            report["acted"].append("play")
        elif c == "g":
            # held-key drag toward the cursor (the LMB-hold drag,
            # SoftBodyInteractor.cs:61-66; holding g autorepeats)
            session.drag_toward(center, radius=radius)
            report["acted"].append("drag")
        elif c in PRESET_KEYS:
            name = PRESET_KEYS[c]
            if session.config is None or getattr(session, "_rebuild",
                                                 None) is None:
                report["acted"].append(f"preset:{name}?no-rebuild-hook")
            else:
                try:
                    session.apply_preset(preset_feel(session.config, name))
                    report["acted"].append(f"preset:{name}")
                except Exception as e:  # noqa: BLE001 — engine envelope
                    report["acted"].append(f"preset:{name}!{e}")
        elif c in dirs:
            name, force = dirs[c]
            session.poke(force, center, radius)
            report["acted"].append(name)
        elif cursor is not None and c in moves:
            ax, sgn = moves[c]
            cursor.move(ax, sgn)
            center = cursor.tuple()
            report["acted"].append(f"cursor {'xyz'[ax]}"
                                   f"{'+' if sgn > 0 else '-'}")
        elif cursor is not None and c == "c":
            cursor.recenter(session.state.positions)
            center = cursor.tuple()
            report["acted"].append("recenter")
        elif c == "p":
            session.pin(center, pin_radius)
            report["acted"].append("pin")
        elif c == "u":
            session.unpin(center, max(radius, pin_radius))
            report["acted"].append("unpin")
        elif c == "r":
            session.restart()
            report["acted"].append("restart")
            report["restarted"] = True
    return report
