"""Engine context: owns all subsystems and the simulation loop.

Analog of the reference's ProjectPlaneverb/src/Context/PvContext.cpp, rebuilt
around a device execution model:

  - The reference's background thread mutates shared state with one mutex and
    several tolerated races (PvContext.cpp:63-94). Here each iteration takes
    an explicit *snapshot* of (listener, geometry version) on the host,
    dispatches one fused device computation, and atomically publishes the
    host-side results dict — races disappear by design (SURVEY.md §5).
  - Geometry changes re-rasterize the whole field set on device
    (ops/voxelize.py) instead of imperative paint/unpaint.
  - ``Context.step()`` runs one sim+analyze iteration synchronously (tests,
    benchmarks); ``Context.start()`` runs the same loop on a background
    thread like the reference's BackgroundProcessor (PvContext.cpp:160).
"""

from __future__ import annotations

import functools
import threading

import numpy as np

import jax
import jax.numpy as jnp

from planeverb.config import (GridParams, PlaneverbConfig,
                              compute_grid_params, gaussian_pulse)
from planeverb.core.emissions import EmissionRegistry
from planeverb.core.free_grid import calibrate_free_field
from planeverb.core.geometry import GeometryRegistry
from planeverb.ops import voxelize
from planeverb.ops.pipeline import (pipeline_auto, pipeline_auto_batch,
                                    solver_path)
from planeverb.scene import Scene
from planeverb.types import PlaneverbOutput, invalid_output, vec2
from planeverb.utils.profiling import StageTimer

__all__ = ["Context"]


def _pack(out) -> jax.Array:
    """Analyzer grids -> the ONE packed [gx, gy, 9] publish array.

    The column layout — occlusion, wet_gain, rt60, lowpass, direction xy,
    source_directivity xy, delay_samples — is load-bearing: _output_from_row,
    the cells-mode row slicing, and the server/C-ABI "rows" wire format all
    index it positionally, so the single-device and sharded pipelines must
    share this one definition.
    """
    return jnp.concatenate([
        out.occlusion[..., None], out.wet_gain[..., None],
        out.rt60[..., None], out.lowpass[..., None],
        out.direction, out.source_directivity,
        out.delay_samples[..., None],
    ], axis=-1)


@functools.partial(jax.jit,
                   static_argnames=("params", "compute_directions"))
def _pipeline_packed(params, beta, refl, pulse, cix, ciy, efree, lx, lz,
                     compute_directions: bool = True):
    """pipeline_auto + all analyzer grids packed into ONE [gx, gy, 9] array,
    so publishing is one device-to-host fetch (layout: :func:`_pack`)."""
    res, out = pipeline_auto(params, beta, refl, pulse, cix, ciy, efree,
                             lx, lz, compute_directions=compute_directions)
    return res.pressure, _pack(out)


@functools.partial(jax.jit,
                   static_argnames=("params", "compute_directions"))
def _pipeline_cells(params, beta, refl, pulse, cix, ciy, efree, lx, lz,
                    cells, compute_directions: bool = True):
    """_pipeline_packed + an on-device gather of the query cells' rows.

    ``cells`` is [Q, 2] int32 (pow2-padded). Returns (pressure, packed
    [gx, gy, 9], rows [Q, 9]), all on device: callers fetch only ``rows``
    (a few hundred bytes); the full packed grid stays on device for
    on-demand probe queries.
    """
    pressure, packed = _pipeline_packed(
        params, beta, refl, pulse, cix, ciy, efree, lx, lz,
        compute_directions=compute_directions)
    rows = packed[cells[:, 0], cells[:, 1]]
    return pressure, packed, rows


@functools.partial(jax.jit,
                   static_argnames=("params", "mesh", "nx_pad", "ny_pad",
                                    "halo", "compute_directions"))
def _pipeline_packed_sharded(params, beta, refl, pulse, cix, ciy, efree,
                             lx, lz, mesh, nx_pad, ny_pad, halo,
                             compute_directions: bool = True):
    """Multi-device analog of :func:`_pipeline_packed`.

    Routes the step through ``parallel.pipeline_sharded`` (the k-step
    wide-halo ``shard_map`` solver with ``ppermute`` exchanges, per-shard
    moments) instead of the single-device ``pipeline_auto``; the whole pass
    still compiles as ONE XLA program, so the engine pays one dispatch and
    one packed fetch per iteration regardless of mesh size.
    ``beta``/``refl`` arrive padded to [nx_pad, ny_pad] and sharded
    P("x", "y"); the packed result is the usual [gx, gy, 9].
    """
    from planeverb.parallel import pipeline_sharded

    res, out = pipeline_sharded(
        params, beta, refl, pulse, cix, ciy, mesh, nx_pad, ny_pad,
        efree, lx, lz, halo=halo, compute_directions=compute_directions)
    return res.pressure, _pack(out)


@functools.partial(jax.jit,
                   static_argnames=("params", "mesh", "nx_pad", "ny_pad",
                                    "halo", "compute_directions"))
def _pipeline_cells_sharded(params, beta, refl, pulse, cix, ciy, efree,
                            lx, lz, cells, mesh, nx_pad, ny_pad, halo,
                            compute_directions: bool = True):
    """Sharded counterpart of :func:`_pipeline_cells` (per-emitter rows)."""
    pressure, packed = _pipeline_packed_sharded(
        params, beta, refl, pulse, cix, ciy, efree, lx, lz,
        mesh, nx_pad, ny_pad, halo, compute_directions=compute_directions)
    rows = packed[cells[:, 0], cells[:, 1]]
    return pressure, packed, rows


@functools.partial(jax.jit,
                   static_argnames=("params", "compute_directions"))
def _pipeline_packed_multi(params, beta, refl, pulse, cells, efree, lpos,
                           compute_directions: bool = True):
    """B-listener batch of :func:`_pipeline_packed` -> [B, gx, gy, 9].

    Split-screen / multiplayer on the engine's product surface (the
    reference is strictly one listener per context, PvContext.cpp:63-94).
    The B listeners run as one batch on the path ops/pipeline.py picks
    (one kernel launch sequence for all B on a GPU, a vmapped scan
    elsewhere), and all B parameter grids pack into ONE fetched array. The
    per-listener recordings are dropped (B of them would multiply the
    recording memory; ``get_impulse_response`` stays single-listener).
    """
    _, out = pipeline_auto_batch(params, beta, refl, pulse, cells, efree,
                                 lpos, compute_directions=compute_directions)
    return _pack(out)        # _pack maps over the leading [B] axis


@functools.partial(jax.jit,
                   static_argnames=("params", "compute_directions"))
def _pipeline_cells_multi(params, beta, refl, pulse, lcells, efree, lpos,
                          cells, compute_directions: bool = True):
    """Multi-listener counterpart of :func:`_pipeline_cells`: B pipelines,
    the query cells' rows gathered per view on device. Returns
    (packed [B, gx, gy, 9] device, rows [B, Q, 9]) — callers fetch only
    ``rows`` (the per-emitter game pattern, one small transfer for ALL
    views)."""
    packed = _pipeline_packed_multi(
        params, beta, refl, pulse, lcells, efree, lpos,
        compute_directions=compute_directions)
    rows = packed[:, cells[:, 0], cells[:, 1]]
    return packed, rows


@functools.partial(jax.jit,
                   static_argnames=("params", "mesh", "nx_pad", "ny_pad",
                                    "halo", "compute_directions"))
def _pipeline_packed_multi_sharded(params, beta, refl, pulse, lcells, efree,
                                   lpos, mesh, nx_pad, ny_pad, halo,
                                   compute_directions: bool = True):
    """Multi-device counterpart of :func:`_pipeline_packed_multi`: B sharded
    pipelines composed in ONE jitted program -> [B, gx, gy, 9].

    The B axis is a Python-unrolled loop (B is small and static;
    ``shard_map`` mesh axes don't batch under ``lax.map``), so every view
    rides the same sharded solver and the engine still pays one dispatch
    and one packed fetch per iteration."""
    from planeverb.parallel import pipeline_sharded

    packs = []
    for i in range(lcells.shape[0]):
        _, out = pipeline_sharded(
            params, beta, refl, pulse, lcells[i, 0], lcells[i, 1],
            mesh, nx_pad, ny_pad, efree, lpos[i, 0], lpos[i, 1],
            halo=halo, compute_directions=compute_directions)
        packs.append(_pack(out))
    return jnp.stack(packs)


@functools.partial(jax.jit,
                   static_argnames=("params", "mesh", "nx_pad", "ny_pad",
                                    "halo", "compute_directions"))
def _pipeline_cells_multi_sharded(params, beta, refl, pulse, lcells, efree,
                                  lpos, cells, mesh, nx_pad, ny_pad, halo,
                                  compute_directions: bool = True):
    """Sharded multi-listener cells publish: (packed [B, gx, gy, 9] device,
    rows [B, Q, 9]) — one small fetch for all views."""
    packed = _pipeline_packed_multi_sharded(
        params, beta, refl, pulse, lcells, efree, lpos,
        mesh, nx_pad, ny_pad, halo, compute_directions=compute_directions)
    rows = packed[:, cells[:, 0], cells[:, 1]]
    return packed, rows


def _grids_dict(grids) -> dict:
    """Fetched packed array -> named grids. The one place the
    :func:`_pack` column layout is unpacked for publishing (grids may
    carry a leading [B] listener axis)."""
    return {
        "occlusion": grids[..., 0],
        "wet_gain": grids[..., 1],
        "rt60": grids[..., 2],
        "lowpass": grids[..., 3],
        "direction": grids[..., 4:6],
        "source_directivity": grids[..., 6:8],
        "delay_samples": grids[..., 8],
    }


def _output_from_row(row) -> PlaneverbOutput:
    """One packed [9] row -> PlaneverbOutput (layout per _pipeline_packed)."""
    return PlaneverbOutput(
        occlusion=float(row[0]), wet_gain=float(row[1]), rt60=float(row[2]),
        lowpass=float(row[3]),
        direction=vec2(float(row[4]), float(row[5])),
        source_directivity=vec2(float(row[6]), float(row[7])),
    )


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# grids above this cell count compute DOA lazily per query (host walk)
# instead of the full-grid device pass — see ops/doa.py::walk_direction.
# The device pass is gather-free shift-selects, cheap next to the sim, so
# full direction grids publish by default up to ~1M cells.
LAZY_DOA_CELLS = 1 << 20


class Context:
    def __init__(self, config: PlaneverbConfig, scene: Scene | None = None,
                 lazy_directions: bool | None = None,
                 publish: str = "grids", mesh=None, halo: int | None = None):
        """``publish`` picks the per-iteration result transfer:

        - "grids" (default): fetch all analyzer grids to the host in one
          packed transfer — every probe position answers instantly.
        - "cells": fetch only the live emitters' cells (the reference's
          per-emitter GetOutput access pattern); the packed grid stays on
          device and arbitrary probes fetch their row on demand.

        ``mesh`` (a 2D ``jax.sharding.Mesh`` with axes "x", "y", e.g. from
        ``parallel.grid_mesh``) runs the whole engine on several devices:
        fields are sharded spatially over the mesh and every ``step()``
        routes through ``parallel.pipeline_sharded`` (the k-step wide-halo
        solver with ``ppermute`` exchanges). The published results are
        identical (within f32 reduction order) to the single-device engine;
        the reference's loop this replaces is single-threaded shared memory
        (PvContext.cpp:63-94). ``halo`` is the exchange period in steps
        (default: largest power-of-two round that fits the per-shard block,
        capped at 16).
        """
        config.validate()
        self.config = config
        self.params: GridParams = compute_grid_params(config)
        self.mesh = mesh
        # the four compiled pipelines every step dispatches to: one or B
        # listeners, grids or cells publish, on the path solver_path picks
        self._run_packed, self._run_cells = _pipeline_packed, _pipeline_cells
        self._run_multi = _pipeline_packed_multi
        self._run_cells_multi = _pipeline_cells_multi
        self._sharding = None
        if solver_path(mesh) == "sharded":
            from jax.sharding import NamedSharding, PartitionSpec

            from planeverb.parallel import pad_to_mesh

            if tuple(sorted(mesh.axis_names)) != ("x", "y"):
                raise ValueError(
                    f"mesh must have axes ('x', 'y'), got {mesh.axis_names}")
            # padding is beta=0 solid, semantically inert
            self._nx_pad, self._ny_pad = pad_to_mesh(
                self.params.nx, self.params.ny, mesh)
            bx = self._nx_pad // mesh.shape["x"]
            by = self._ny_pad // mesh.shape["y"]
            if halo is None:
                halo = 16
                while halo > min(bx, by):
                    halo //= 2
            if not (1 <= halo <= min(bx, by)):
                raise ValueError(f"halo {halo} exceeds per-shard block "
                                 f"({bx}, {by})")
            self._halo = halo
            self._sharding = NamedSharding(mesh, PartitionSpec("x", "y"))
            shard = dict(mesh=mesh, nx_pad=self._nx_pad,
                         ny_pad=self._ny_pad, halo=halo)
            self._run_packed = functools.partial(_pipeline_packed_sharded,
                                                 **shard)
            self._run_cells = functools.partial(_pipeline_cells_sharded,
                                                **shard)
            self._run_multi = functools.partial(
                _pipeline_packed_multi_sharded, **shard)
            self._run_cells_multi = functools.partial(
                _pipeline_cells_multi_sharded, **shard)
        if publish not in ("grids", "cells"):
            raise ValueError(f"unknown publish mode {publish!r}")
        self._publish_cells = publish == "cells"
        if lazy_directions is None:
            lazy_directions = (not self._publish_cells
                               and self.params.grid_x * self.params.grid_y
                               > LAZY_DOA_CELLS)
        if lazy_directions and self._publish_cells:
            raise ValueError("publish='cells' computes directions on device; "
                             "lazy_directions needs host-side grids")
        self._lazy_doa = lazy_directions
        self._probe_lock = threading.Lock()   # guards cells-cache fills
        self.geometry = GeometryRegistry()
        self.emissions = EmissionRegistry()
        self.timer = StageTimer()

        self._pulse = jnp.asarray(gaussian_pulse(self.params))
        self._listener = (0.0, 0.0, 0.0)
        self._listeners_multi: list | None = None
        self._listener_lock = threading.Lock()
        self._coverage_warned = False
        self._coverage_checked = False   # first-step check done?

        # calibration (FreeGrid analog) — one empty-grid sim at init
        with self.timer.stage("calibration"):
            self.efree = calibrate_free_field(self.params)

        self._fields_version = -1
        self._beta = None
        self._refl = None

        # one snapshot object published per iteration: a single attribute
        # assignment is atomic, so readers never pair new results with an
        # old listener position (or vice versa)
        self._published: dict | None = None
        self._iteration = 0
        self._iter_cond = threading.Condition()

        self._thread: threading.Thread | None = None
        self._running = False
        # serializes whole iterations: the server exposes a manual `step`
        # command alongside the background loop, and _sync_fields / the
        # timer / _published are written for one stepper at a time. The
        # reference tolerates the equivalent race (PvContext.cpp:63-94
        # reads listener/emitters unguarded); here concurrent steppers
        # simply queue.
        self._step_lock = threading.Lock()
        self.error: BaseException | None = None  # set if the loop dies

        if scene is not None:
            self.geometry.load_scene(scene)

    # ------------------------------------------------------------- listener
    def _warn_if_uncovered(self, x: float, z: float) -> None:
        """Warn (once per context) when the IR length cannot cover the whole
        grid from this listener position.

        The IR law (config.py::compute_grid_params) reserves travel for the
        grid HALF-diagonal — a centered listener. A listener far off-center
        can be farther than that from the opposite corner, and cells beyond
        ``covered_travel_m`` never record an onset (they publish the
        never-found sentinels). The reference silently truncates in this
        case (its constant assumes a centered 25 m listener, PvTypes.h:101).
        """
        if self._coverage_warned:
            return
        p = self.params
        gx_m = p.grid_x * p.dx
        gy_m = p.grid_y * p.dx
        wx = x + p.grid_offset_x
        wz = z + p.grid_offset_y
        far = max(np.hypot(wx - cx, wz - cy)
                  for cx in (0.0, gx_m) for cy in (0.0, gy_m))
        # slack for the response-length truncation (<= 1 sample of travel)
        # and cell quantization — a centered listener on any grid size must
        # never warn (the IR law covers exactly its half-diagonal)
        slack = 2.0 * p.constants.c / p.fs + 2.0 * p.dx
        if far > p.covered_travel_m + slack:
            import warnings

            self._coverage_warned = True
            warnings.warn(
                f"listener at ({x:.1f}, {z:.1f}) is {far:.1f} m from the "
                f"farthest grid corner but the impulse response only covers "
                f"{p.covered_travel_m:.1f} m of travel; cells beyond that "
                f"distance will publish never-found sentinel values "
                f"(center the listener or enlarge the grid/IR length)",
                RuntimeWarning, stacklevel=3)

    def set_listener_position(self, x: float, y: float, z: float) -> None:
        self._warn_if_uncovered(x, z)
        with self._listener_lock:
            self._listener = (x, y, z)
            self._listeners_multi = None

    def get_listener_position(self):
        with self._listener_lock:
            return self._listener

    def set_listener_positions(self, positions) -> None:
        """B listeners at once — split-screen / multiplayer.

        ``step()`` then batches one simulation per listener (the
        ops/batch.py data-parallel axis surfaced on the engine runtime;
        the reference runs exactly one listener per context,
        PvContext.cpp:63-94) and publishes every view's results in one
        fetch — full [B, ...] grids in grids mode, the live emitters'
        [B, Q, 9] rows in cells mode; query per view with
        ``result_at(x, z, listener=i)`` / ``get_output(eid, listener=i)``.
        Works on mesh-sharded contexts too (every view rides the sharded
        pipeline); a 1-element list (or ``set_listener_position``) returns
        to the single-listener path.
        """
        positions = [tuple(float(v) for v in p) for p in positions]
        if not positions:
            raise ValueError("need at least one listener position")
        if any(len(p) != 3 for p in positions):
            raise ValueError("listener positions are (x, y, z) triples")
        for px, _, pz in positions:
            self._warn_if_uncovered(px, pz)
        with self._listener_lock:
            self._listener = positions[0]
            self._listeners_multi = (positions if len(positions) > 1
                                     else None)

    def get_listener_positions(self) -> list:
        with self._listener_lock:
            if self._listeners_multi is not None:
                return list(self._listeners_multi)
            return [self._listener]

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Spawn the background processing loop (PvContext.cpp:160 analog)."""
        if self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="planeverb-background")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        import traceback

        while self._running:
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — loop must not die silently
                self.error = e
                traceback.print_exc()
                self._running = False
                with self._iter_cond:
                    self._iter_cond.notify_all()
                return

    # ------------------------------------------------------------ iteration
    def _sync_fields(self) -> None:
        version, boxes = self.geometry.snapshot()
        if version == self._fields_version:
            return
        with self.timer.stage("voxelize"):
            if boxes:
                arr = voxelize.boxes_to_array(boxes, _next_pow2(len(boxes)))
                beta, refl = voxelize.voxelize(self.params, jnp.asarray(arr))
            else:
                b, r = voxelize.base_fields(self.params)
                beta, refl = jnp.asarray(b), jnp.asarray(r)
            if self._sharding is not None:
                # pad to the mesh-divisible field shape (padding is beta=0
                # solid, provably silent) and lay the fields out spatially
                # over the mesh so the sharded pipeline's shard_map sees
                # its expected P("x", "y") placement without a reshard
                pad = ((0, self._nx_pad - self.params.nx),
                       (0, self._ny_pad - self.params.ny))
                beta = jax.device_put(jnp.pad(beta, pad), self._sharding)
                refl = jax.device_put(jnp.pad(refl, pad), self._sharding)
            self._beta, self._refl = beta, refl
            self._fields_version = version

    @property
    def background_running(self) -> bool:
        """True while the background loop thread owns the iteration cadence."""
        return self._thread is not None and self._running

    def step(self) -> None:
        """One background-loop iteration: sim -> analyze -> publish.

        Thread-safe: concurrent callers serialize on a step lock, so a
        manual step can never interleave with the background loop's.
        """
        with self._step_lock:
            self._step_locked()

    def _step_locked(self) -> None:
        with self._listener_lock:
            lx, ly, lz = self._listener
            multi = self._listeners_multi
        if not self._coverage_checked:
            # a Context stepped with the never-set default listener
            # ((0,0,0) — a grid corner, the coverage worst case) would
            # otherwise skip the warning set_listener_position gives
            # (ADVICE r4): evaluate once for the active listener(s)
            self._coverage_checked = True
            for px, _, pz in (multi or [(lx, ly, lz)]):
                self._warn_if_uncovered(px, pz)
        self._sync_fields()
        if multi is not None:
            self._step_multi(multi)
            return

        cix, ciy = self.params.world_to_cell(lx, lz)
        if self._publish_cells:
            self._step_cells(lx, lz, cix, ciy)
            return
        with self.timer.stage("simulate+analyze"):
            pressure, packed = self._run_packed(
                self.params, self._beta, self._refl, self._pulse,
                jnp.int32(cix), jnp.int32(ciy), np.float32(self.efree),
                np.float32(lx), np.float32(lz),
                compute_directions=not self._lazy_doa)
        with self.timer.stage("publish"):
            # single host fetch of the packed result grids; the recording
            # stays on device
            published = {
                **_grids_dict(np.asarray(packed)),
                "listener": (lx, lz),
                "pressure": pressure,  # device, [T, nx, ny]
            }
        self._published = published            # single atomic assignment
        with self._iter_cond:
            self._iteration += 1
            self._iter_cond.notify_all()

    def _step_multi(self, listeners) -> None:
        """Multi-listener iteration: B sims in one program, one fetch.

        grids publish: the packed [B, gx, gy, 9] grids
        (:func:`_pipeline_packed_multi`); cells publish: only the live
        emitters' rows for ALL views, [B, Q, 9]
        (:func:`_pipeline_cells_multi` — the split-screen game pattern).
        """
        p = self.params
        lcells = np.array([list(p.world_to_cell(lx, lz))
                           for lx, _, lz in listeners], np.int32)
        lpos = np.array([[lx, lz] for lx, _, lz in listeners], np.float32)
        views = [(lx, lz) for lx, _, lz in listeners]
        if self._publish_cells:
            wanted, cells = self._wanted_cells()
            with self.timer.stage("simulate+analyze"):
                packed, rows = self._run_cells_multi(
                    p, self._beta, self._refl, self._pulse,
                    jnp.asarray(lcells), np.float32(self.efree),
                    jnp.asarray(lpos), jnp.asarray(cells),
                    compute_directions=True)
            with self.timer.stage("publish"):
                fetched = np.asarray(rows)     # ONE [B, Q, 9] fetch
                cache = {cell: fetched[:, i]   # [B, 9] per emitter cell
                         for i, cell in enumerate(wanted)}
                published = {
                    "cells": cache,
                    "packed_device": packed,   # device [B, gx, gy, 9]
                    "listener": views[0],
                    "listeners": views,
                }
        else:
            with self.timer.stage("simulate+analyze"):
                packed = self._run_multi(
                    p, self._beta, self._refl, self._pulse,
                    jnp.asarray(lcells), np.float32(self.efree),
                    jnp.asarray(lpos),
                    compute_directions=not self._lazy_doa)
            with self.timer.stage("publish"):
                # ONE [B, gx, gy, 9] fetch
                published = {
                    **_grids_dict(np.asarray(packed)),
                    "listener": views[0],
                    "listeners": views,
                }
        self._published = published
        with self._iter_cond:
            self._iteration += 1
            self._iter_cond.notify_all()

    def _wanted_cells(self):
        """Live emitters' in-grid cells, deduplicated (the set the cells
        publish fetches each iteration), plus the pow2-padded [Q, 2]
        query array (stable jit shapes)."""
        p = self.params
        wanted = []
        for em in self.emissions.snapshot_emissions().values():
            cx, cy = p.world_to_cell(em.position[0], em.position[2])
            if 0 <= cx < p.grid_x and 0 <= cy < p.grid_y:
                wanted.append((cx, cy))
        wanted = sorted(set(wanted))
        q = max(1, _next_pow2(len(wanted)))
        cells = np.zeros((q, 2), np.int32)
        if wanted:
            cells[:len(wanted)] = wanted
        return wanted, cells

    def _step_cells(self, lx, lz, cix, ciy) -> None:
        """publish='cells' iteration: per-emitter rows fetched, grid kept
        on device (the reference's per-emitter GetOutput access pattern)."""
        p = self.params
        wanted, cells = self._wanted_cells()
        with self.timer.stage("simulate+analyze"):
            pressure, packed, rows = self._run_cells(
                p, self._beta, self._refl, self._pulse, jnp.int32(cix),
                jnp.int32(ciy), np.float32(self.efree), np.float32(lx),
                np.float32(lz), jnp.asarray(cells), compute_directions=True)
        with self.timer.stage("publish"):
            fetched = np.asarray(rows)         # the one small transfer
            cache = {cell: fetched[i] for i, cell in enumerate(wanted)}
            published = {
                "cells": cache,
                "packed_device": packed,       # device [gx, gy, 9]
                "listener": (lx, lz),
                "pressure": pressure,  # device, [T, nx, ny]
            }
        self._published = published
        with self._iter_cond:
            self._iteration += 1
            self._iter_cond.notify_all()

    @property
    def iteration(self) -> int:
        return self._iteration

    def wait_for_iteration(self, n: int, timeout: float = 60.0) -> bool:
        with self._iter_cond:
            return self._iter_cond.wait_for(
                lambda: self._iteration >= n, timeout=timeout)

    # -------------------------------------------------------------- queries
    def result_at(self, x: float, z: float,
                  listener: int = 0) -> PlaneverbOutput:
        """World position -> acoustic output (GetResponseResult analog,
        Analyzer.cpp:106-116 + FDTD.cpp:16-58).

        ``listener`` selects the view in multi-listener mode
        (:meth:`set_listener_positions`); out-of-range indices return the
        invalid sentinel, and single-listener snapshots only answer
        ``listener=0``.
        """
        results = self._published              # one consistent snapshot
        if results is None:
            return invalid_output()
        p = self.params
        cx, cy = p.world_to_cell(x, z)
        if not (0 <= cx < p.grid_x and 0 <= cy < p.grid_y):
            return invalid_output()
        views = results.get("listeners")
        if views is not None:
            if not (0 <= listener < len(views)):
                return invalid_output()
            llx, llz = views[listener]

            def sel(key):
                return results[key][listener]
        else:
            if listener != 0:
                return invalid_output()
            llx, llz = results["listener"]

            def sel(key):
                return results[key]
        if "cells" in results:
            row = results["cells"].get((cx, cy))
            if row is None:
                # probe outside the published emitter set: fetch this one
                # row on demand and memoize it in the snapshot's cache
                with self._probe_lock:
                    row = results["cells"].get((cx, cy))
                    if row is None:
                        dev = results["packed_device"]
                        row = np.asarray(dev[:, cx, cy] if views is not None
                                         else dev[cx, cy])
                        results["cells"][(cx, cy)] = row
            if views is not None:
                row = row[listener]    # cache rows are [B, 9] per cell
            return _output_from_row(row)
        if self._lazy_doa:
            from planeverb.ops.doa import walk_direction

            d = walk_direction(
                self.params, sel("occlusion"), sel("delay_samples"),
                cx, cy, llx + self.params.grid_offset_x,
                llz + self.params.grid_offset_y)
        else:
            d = sel("direction")[cx, cy]
        s = sel("source_directivity")[cx, cy]
        return PlaneverbOutput(
            occlusion=float(sel("occlusion")[cx, cy]),
            wet_gain=float(sel("wet_gain")[cx, cy]),
            rt60=float(sel("rt60")[cx, cy]),
            lowpass=float(sel("lowpass")[cx, cy]),
            direction=vec2(float(d[0]), float(d[1])),
            source_directivity=vec2(float(s[0]), float(s[1])),
        )

    def get_output(self, emission_id: int,
                   listener: int = 0) -> PlaneverbOutput:
        pos = self.emissions.get(emission_id)
        if pos is None:
            return invalid_output()
        return self.result_at(pos[0], pos[2], listener=listener)

    def sync_dsp(self, dsp,
                 listener: int = 0) -> dict[int, tuple[PlaneverbOutput,
                                                       float]]:
        """Push every live emission's state into a DSP context and return
        ``{eid: (acoustic output, emit-time volume gain)}``. In
        multi-listener mode pass one DSP context per view with its
        ``listener`` index (each split-screen player mixes against their
        own parameters).

        This is the per-frame engine->DSP handoff the reference spreads over
        its Unity components (PlaneverbEmitter.cs:52-60 UpdateEmission/
        UpateEmitter/GetOutput each frame, :93 SetEmitterDirectivityPattern
        at emit): position+forward and the directivity pattern go to the DSP
        side; the caller scales the source audio by the returned volume gain
        before ``submit_source`` (PlaneverbAudioSource applies
        GetVolumeGain() to its samples).
        """
        results: dict[int, tuple[PlaneverbOutput, float]] = {}
        live = self.emissions.snapshot_emissions()
        for eid, em in sorted(live.items()):
            dsp.update_emitter(eid, em.position, em.forward)
            dsp.set_emitter_directivity_pattern(eid, em.pattern)
            results[eid] = (self.result_at(em.position[0], em.position[2],
                                           listener=listener),
                            em.volume_gain)
        # drop DSP-side state for emitters that ended since the last sync:
        # emission ids are free-list-reused (EmissionManager.cpp:37-67), and
        # a reused id must not inherit the dead sound's interpolation state
        # (current gains/pan, lowpass filter memory, directivity pattern)
        prev = getattr(dsp, "_pv_synced_ids", ())
        for eid in prev:
            if eid not in live:
                dsp.remove_emitter(eid)
        dsp._pv_synced_ids = frozenset(live)
        return results

    def get_impulse_response(self, x: float, z: float) -> np.ndarray:
        """Debug IR accessor (Planeverb::GetImpulseResponse analog).

        Out-of-grid probes return an empty array — the reference returns
        null for positions outside the grid (FDTD.cpp:60-70) rather than
        clamping to the nearest edge cell.
        """
        published = self._published
        if published is None:
            return np.zeros(self.params.response_length, np.float32)
        if published.get("pressure") is None:
            # multi-listener snapshots drop the recordings (B of them
            # would multiply recording memory); IR debugging is a
            # single-listener workflow
            return np.zeros(0, np.float32)
        p = self.params
        cx, cy = p.world_to_cell(x, z)
        if not (0 <= cx < p.nx and 0 <= cy < p.ny):
            return np.zeros(0, np.float32)
        return np.asarray(published["pressure"][:, cx, cy])

    # --------------------------------------------------------------- admin
    def profile_summary(self) -> dict:
        summary = self.timer.stats.summary()
        pipe = summary.get("simulate+analyze")
        if pipe:
            from planeverb.utils.profiling import throughput

            # the stage times the WHOLE iteration: B pipelines in
            # multi-listener mode, so per-listener wall is mean/B (the
            # historical mean mixes modes only if the caller switched
            # listener counts mid-run)
            b = len(self.get_listener_positions())
            summary["throughput"] = throughput(self.params,
                                               pipe["mean_s"] / max(b, 1))
            if b > 1:
                summary["throughput"]["listeners"] = b
        return summary
