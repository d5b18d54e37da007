"""Module-level API facade mirroring the reference's public C++ surface.

Functions map 1:1 onto /root/reference ProjectPlaneverb/include/Planeverb.h:
Init/Exit/ChangeSettings/Emit/UpdateEmission/EndEmission/GetOutput/
AddGeometry/UpdateGeometry/RemoveGeometry/SetListenerPosition/
GetImpulseResponse — as snake_case functions on a module singleton, the same
lifecycle contract as the reference's g_context (PvContext.cpp:15-49).

Most Python users should prefer constructing :class:`planeverb.Context`
directly; this facade exists for API parity and for the sandbox/front-ends.
"""

from __future__ import annotations

import numpy as np

from planeverb.config import PlaneverbConfig
from planeverb.core.context import Context
from planeverb.scene import AABB
from planeverb.types import PlaneverbOutput, invalid_output

__all__ = [
    "init", "exit", "change_settings", "get_context",
    "emit", "update_emission", "end_emission", "get_output", "get_emission",
    "add_geometry", "update_geometry", "remove_geometry",
    "set_listener_position", "get_impulse_response",
]

_context: Context | None = None


def init(config: PlaneverbConfig | None = None, scene=None,
         background: bool = True) -> Context:
    """Initialize the acoustics module (Planeverb::Init analog).

    ``background=True`` starts the continuous background loop; pass False to
    drive iterations manually with ``get_context().step()``.
    """
    global _context
    if _context is not None:
        exit()
    _context = Context(config or PlaneverbConfig(), scene=scene)
    if background:
        _context.start()
    return _context


def exit() -> None:
    """Shut down the module (Planeverb::Exit analog)."""
    global _context
    if _context is not None:
        _context.stop()
        _context = None


def change_settings(config: PlaneverbConfig) -> Context:
    """Full teardown + re-init (Planeverb::ChangeSettings, PvContext.cpp:45-49)."""
    background = _context is not None and _context._thread is not None
    exit()
    return init(config, background=background)


def get_context() -> Context | None:
    return _context


def emit(x: float, y: float, z: float, *,
         forward=(1.0, 0.0, 0.0), volume_db: float = 0.0,
         pattern: int = 0) -> int:
    """Start an emission with its emit-time attributes: facing vector,
    volume in dB (-> gain 10^(dB/20)) and directivity pattern index
    (PlaneverbEmitter.cs:21-24,89-96)."""
    return _context.emissions.emit(x, y, z, forward=forward,
                                   volume_db=volume_db, pattern=pattern)


def update_emission(eid: int, x: float, y: float, z: float, *,
                    forward=None, volume_db: float | None = None,
                    pattern: int | None = None) -> None:
    _context.emissions.update(eid, x, y, z, forward=forward,
                              volume_db=volume_db, pattern=pattern)


def get_emission(eid: int):
    """The live :class:`~planeverb.core.emissions.Emission` record
    (position + forward + volume_db/volume_gain + pattern), or None."""
    return _context.emissions.get_emission(eid)


def end_emission(eid: int) -> None:
    _context.emissions.end(eid)


def get_output(eid: int) -> PlaneverbOutput:
    if _context is None:
        return invalid_output()
    return _context.get_output(eid)


def add_geometry(box: AABB) -> int:
    return _context.geometry.add(box)


def update_geometry(gid: int, box: AABB) -> None:
    _context.geometry.update(gid, box)


def remove_geometry(gid: int) -> None:
    _context.geometry.remove(gid)


def set_listener_position(x: float, y: float, z: float) -> None:
    _context.set_listener_position(x, y, z)


def get_impulse_response(x: float, z: float) -> np.ndarray:
    return _context.get_impulse_response(x, z)
