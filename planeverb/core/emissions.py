"""Emission registry: tracks playing sounds and their emit-time attributes.

Analog of /root/reference ProjectPlaneverb/src/Emissions/EmissionManager.cpp:
a vector of emissions with free-list id reuse (EmissionManager.cpp:37-67).
Beyond the position the reference's engine tracks, each emission carries the
emit-time attributes the reference keeps on the Unity component
(PlaneverbUnityPluginAPI/PlaneverbEmitter.cs:21-24,39-47,89-96):

  - ``volume_db`` in [-48, +12] dB -> ``volume_gain`` = 10^(dB/20)
    (PlaneverbEmitter.cs:46 ``volumeGain = Mathf.Pow(10f, Volume / 20f)``);
  - ``pattern`` — source directivity pattern index (Omni=0, Cardioid=1,
    PlaneverbEmitter.cs:5-11), forwarded to the DSP side at emit time
    (PlaneverbEmitter.cs:93 ``SetEmitterDirectivityPattern``);
  - ``forward`` — the emitter's facing vector, forwarded each frame
    (PlaneverbEmitter.cs:58 ``UpateEmitter(id, position, forward)``).

Thread-safe by a single lock (the reference reads these unguarded from the
sim thread; we snapshot instead — SURVEY.md §5 race notes).
"""

from __future__ import annotations

import dataclasses
import threading

__all__ = ["Emission", "EmissionRegistry"]


@dataclasses.dataclass(frozen=True)
class Emission:
    """One playing sound: position plus emit-time attributes."""

    position: tuple[float, float, float]
    forward: tuple[float, float, float] = (1.0, 0.0, 0.0)
    volume_db: float = 0.0
    pattern: int = 0  # DirectivityPattern.OMNI (PlaneverbEmitter.cs:5-11)

    @property
    def volume_gain(self) -> float:
        """dB -> linear gain (PlaneverbEmitter.cs:46)."""
        return float(10.0 ** (self.volume_db / 20.0))


class EmissionRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._emissions: list[Emission | None] = []
        self._free: list[int] = []

    def emit(self, x: float, y: float, z: float, *,
             forward: tuple[float, float, float] = (1.0, 0.0, 0.0),
             volume_db: float = 0.0, pattern: int = 0) -> int:
        em = Emission((x, y, z), tuple(forward), float(volume_db),
                      int(pattern))
        with self._lock:
            if self._free:
                eid = self._free.pop()
                self._emissions[eid] = em
            else:
                eid = len(self._emissions)
                self._emissions.append(em)
            return eid

    def update(self, eid: int, x: float, y: float, z: float, *,
               forward: tuple[float, float, float] | None = None,
               volume_db: float | None = None,
               pattern: int | None = None) -> None:
        """Move an emission (UpdateEmission analog); attribute kwargs left
        as None keep their emit-time values."""
        with self._lock:
            old = self._emissions[eid] if 0 <= eid < len(self._emissions) \
                else None
            if old is None:
                return
            self._emissions[eid] = Emission(
                (x, y, z),
                tuple(forward) if forward is not None else old.forward,
                float(volume_db) if volume_db is not None else old.volume_db,
                int(pattern) if pattern is not None else old.pattern)

    def end(self, eid: int) -> None:
        with self._lock:
            if 0 <= eid < len(self._emissions) \
                    and self._emissions[eid] is not None:
                self._emissions[eid] = None
                self._free.append(eid)

    def get(self, eid: int) -> tuple[float, float, float] | None:
        """Position only (historical accessor; attrs via get_emission)."""
        em = self.get_emission(eid)
        return None if em is None else em.position

    def get_emission(self, eid: int) -> Emission | None:
        with self._lock:
            if 0 <= eid < len(self._emissions):
                return self._emissions[eid]
            return None

    def snapshot(self) -> dict[int, tuple[float, float, float]]:
        """id -> position map (historical accessor)."""
        return {i: em.position
                for i, em in self.snapshot_emissions().items()}

    def snapshot_emissions(self) -> dict[int, Emission]:
        with self._lock:
            return {i: em for i, em in enumerate(self._emissions)
                    if em is not None}

    def free_ids(self) -> list[int]:
        """The free-list stack, oldest-freed first (top = last element)."""
        with self._lock:
            return list(self._free)

    def restore(self, items, free: list[int] | None = None) -> None:
        """Replace contents with explicit (eid, emission) pairs, preserving
        ids (session checkpoint/resume, planeverb.session). Each pair's
        second element may be a bare position tuple (pre-attribute
        checkpoints) or an :class:`Emission`. ``free`` restores the
        free-list stack order so id reuse after resume matches the
        uncheckpointed session."""
        with self._lock:
            n = max((eid for eid, _ in items), default=-1) + 1
            self._emissions = [None] * n
            for eid, em in items:
                if not isinstance(em, Emission):
                    em = Emission(tuple(em))
                self._emissions[eid] = em
            holes = {i for i in range(n) if self._emissions[i] is None}
            if free is not None and set(free) == holes:
                self._free = list(free)
            else:
                self._free = sorted(holes)
