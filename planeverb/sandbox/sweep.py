"""Scripted measurement sweeps (WetDryDoorPlot analog).

The reference's only automated measurement harness sweeps a door AABB across
an opening in 101 steps and logs dry/wet gain to CSV
(/root/reference UnityDemo/.../WetDryDoorPlot.cs:29-102), reproducing the
paper's smooth-obstruction figure. This module is that harness as a library
function plus the generic position sweep used by the regression tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from planeverb.config import PlaneverbConfig
from planeverb.core.context import Context
from planeverb.scene import AABB, Scene

__all__ = ["door_sweep", "SweepResult"]


@dataclasses.dataclass
class SweepResult:
    positions: np.ndarray   # [N] door x positions
    dry_gain: np.ndarray    # [N] occlusion at the probe point
    wet_gain: np.ndarray    # [N]

    def to_csv(self, path_or_file) -> None:
        rows = "\n".join(
            f"{p:.6g},{d:.6g},{w:.6g}" for p, d, w in
            zip(self.positions, self.dry_gain, self.wet_gain))
        data = "door_pos,dry_gain,wet_gain\n" + rows + "\n"
        if hasattr(path_or_file, "write"):
            path_or_file.write(data)
        else:
            with open(path_or_file, "w") as f:
                f.write(data)


def door_sweep(config: PlaneverbConfig | None = None,
               steps: int = 101,
               listener=(5.0, 2.5),
               source=(5.0, 7.5)) -> SweepResult:
    """Slide a door across a wall opening; measure dry/wet gain per position.

    Scene: a wall with a 2 m opening separating listener from source; a 2 m
    door AABB slides from fully closed to fully open in ``steps`` increments
    (WetDryDoorPlot.cs:50-101 procedure, geometry adapted to a 10 m grid).
    """
    config = config or PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0)
    wall_y, door_w = 5.0, 2.0
    # wall with a [4,6] m opening
    base = [
        AABB(2.0, wall_y, 4.0, 0.5, 0.95),
        AABB(8.0, wall_y, 4.0, 0.5, 0.95),
    ]
    ctx = Context(config, scene=Scene(boxes=base))
    ctx.set_listener_position(listener[0], 0.0, listener[1])
    eid = ctx.emissions.emit(source[0], 0.0, source[1])

    door_id = ctx.geometry.add(AABB(5.0, wall_y, door_w, 0.5, 0.95))
    positions = np.linspace(5.0, 5.0 + door_w, steps)  # closed -> open
    dry = np.zeros(steps, np.float32)
    wet = np.zeros(steps, np.float32)
    for i, x in enumerate(positions):
        ctx.geometry.update(door_id, AABB(float(x), wall_y, door_w, 0.5, 0.95))
        ctx.step()
        out = ctx.get_output(eid)
        dry[i] = out.occlusion
        wet[i] = out.wet_gain
    return SweepResult(positions=positions, dry_gain=dry, wet_gain=wet)
