"""An interactive demo game: walk a listener through a live scene.

The reference ships a Unity demo game (UnityDemo/PlaneverbTest — a walkable
scene with singing emitters and a sliding door); this is that experience as
a terminal game against the acoustics engine:

  - WASD / arrow keys walk the listener through a 10x10 m room with a
    doorway wall; the engine re-simulates as you move.
  - `D` (shift-d) slides the door shut / open (a moving 3D object resynced
    into the solver per frame, core/objects.py — PlaneverbObject.cs
    analog).
  - Two emitters (one behind the wall) show live occlusion / wet gain /
    RT60 / direction arrows, the readouts PlaneverbAudioSource polls per
    frame (PlaneverbAudioSource.cs:171-183).

Run interactively:   PYTHONPATH=. python examples/explore_demo.py
Scripted (CI/tests): PYTHONPATH=. python examples/explore_demo.py --script wwDq
"""

from __future__ import annotations

import sys

import numpy as np


ARROWS = "→↗↑↖←↙↓↘"  # direction glyph by angle octant


def _arrow(dx: float, dy: float) -> str:
    if dx == 0.0 and dy == 0.0:
        return "·"
    octant = int(round(np.arctan2(dy, dx) / (np.pi / 4))) % 8
    return ARROWS[octant]


class ExploreGame:
    """Engine + scene state for the walkthrough (UI-agnostic)."""

    DOOR_OPEN_Z = 9.6
    DOOR_SHUT_Z = 7.2

    def __init__(self):
        import planeverb as pv

        self.pv = pv
        self.ctx = pv.Context(pv.PlaneverbConfig(
            grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275))
        self.objects = pv.ObjectManager(self.ctx)
        for cx, cz, w, d in [(5.0, 0.6, 9.0, 0.4), (5.0, 9.4, 9.0, 0.4),
                             (0.6, 5.0, 0.4, 9.0), (9.4, 5.0, 0.4, 9.0)]:
            self.objects.add(pv.AABB3D(x=cx, y=1.5, z=cz, width=w,
                                       height=3.0, depth=d, absorption=0.95))
        # dividing wall with a doorway at z in [7.0, 9.2]
        self.objects.add(pv.AABB3D(x=5.0, y=1.5, z=3.6, width=0.4,
                                   height=3.0, depth=5.6, absorption=0.95))
        self.door = self.objects.add(pv.AABB3D(
            x=5.0, y=1.5, z=self.DOOR_OPEN_Z, width=0.35, height=2.2,
            depth=2.4, absorption=0.98))
        self.door_shut = False
        self.pos = [2.5, 6.5]          # listener x, z
        self.emitters = {
            "songbird": self.ctx.emissions.emit(7.5, 1.5, 8.0),
            "radio": self.ctx.emissions.emit(2.0, 1.5, 2.0),
        }
        self.step()

    # ------------------------------------------------------------- actions
    def move(self, dx: float, dz: float) -> None:
        nx = min(max(self.pos[0] + dx, 1.0), 9.0)
        nz = min(max(self.pos[1] + dz, 1.0), 9.0)
        self.pos = [nx, nz]

    def toggle_door(self) -> None:
        self.door_shut = not self.door_shut
        z = self.DOOR_SHUT_Z if self.door_shut else self.DOOR_OPEN_Z
        b = self.objects.get_bounds(self.door)
        self.objects.update(self.door, self.pv.AABB3D(
            x=b.x, y=b.y, z=z, width=b.width, height=b.height,
            depth=b.depth, absorption=b.absorption))

    def step(self) -> None:
        """One game frame: sync objects to the head slice, re-simulate."""
        self.ctx.set_listener_position(self.pos[0], 1.6, self.pos[1])
        self.objects.sync()
        self.ctx.step()

    # -------------------------------------------------------------- render
    def _occupancy(self):
        """Voxelized beta grid memoized per geometry version: most frames
        only move the listener, and re-voxelizing the whole grid on the
        host per keypress is O(nx*ny) for an unchanged map."""
        from planeverb.ops import voxelize

        version, boxes = self.ctx.geometry.snapshot()
        cached = getattr(self, "_occupancy_cache", None)
        if cached is None or cached[0] != version:
            beta, _ = voxelize.voxelize_np(self.ctx.params, boxes)
            cached = (version, beta)
            self._occupancy_cache = cached
        return cached[1]

    def frame(self) -> str:
        p = self.ctx.params
        beta = self._occupancy()
        marks = {p.world_to_cell(*self.pos): "@"}
        for name, eid in self.emitters.items():
            epos = self.ctx.emissions.get(eid)
            marks[p.world_to_cell(epos[0], epos[2])] = name[0].upper()
        rows = []
        for i in range(p.nx):
            rows.append("".join(
                marks.get((i, j), "." if beta[i, j] > 0 else "#")
                for j in range(p.ny)))
        lines = ["  " + r for r in rows]
        lines.append(f"  @ listener ({self.pos[0]:.1f}, {self.pos[1]:.1f})"
                     f"   door: {'SHUT' if self.door_shut else 'open'}"
                     "   [wasd/arrows move, D door, q quit]")
        for name, eid in sorted(self.emitters.items()):
            out = self.ctx.get_output(eid)
            if not out.valid:
                lines.append(f"  {name:9s} (silent)")
                continue
            db = 20 * np.log10(max(out.occlusion, 1e-10))
            lines.append(
                f"  {name:9s} dry {db:+6.1f} dB  wet {out.wet_gain:5.2f}  "
                f"rt60 {out.rt60:4.2f} s  lp {out.lowpass:7.0f} Hz  "
                f"from {_arrow(out.direction.x, out.direction.y)}")
        return "\n".join(lines)

    def handle(self, key: str) -> bool:
        """Apply one key; returns False when the game should quit."""
        step = 0.5
        if key in ("q", "Q"):
            return False
        if key in ("w", "KEY_UP"):
            self.move(-step, 0.0)
        elif key in ("s", "KEY_DOWN"):
            self.move(step, 0.0)
        elif key in ("a", "KEY_LEFT"):
            self.move(0.0, -step)
        elif key in ("d", "KEY_RIGHT"):
            self.move(0.0, step)
        elif key in ("D",):
            self.toggle_door()
        else:
            return True                # unknown key: no re-sim
        self.step()
        return True


def run_scripted(keys: str) -> int:
    game = ExploreGame()
    print(game.frame())
    for key in keys:
        if not game.handle(key):
            break
        print()
        print(game.frame())
    return 0


def run_curses() -> int:
    import curses

    game = ExploreGame()

    def loop(scr):
        curses.curs_set(0)
        while True:
            scr.erase()
            for i, line in enumerate(game.frame().splitlines()):
                try:
                    scr.addstr(i, 0, line)
                except curses.error:
                    pass               # terminal smaller than the frame
            scr.refresh()
            key = scr.getkey()
            if not game.handle(key):
                return

    curses.wrapper(loop)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--script":
        return run_scripted(argv[1] if len(argv) > 1 else "wDq")
    if not sys.stdout.isatty():
        print("not a tty; running scripted demo (--script wDq)")
        return run_scripted("wDq")
    return run_curses()


if __name__ == "__main__":
    sys.exit(main())
