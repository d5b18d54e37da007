"""Engine server — the binding layer for game-engine integration.

The reference integrates with engines through flat C ABI exports marshalled
over P/Invoke (/root/reference ProjectPlaneverb/PlaneverbUnityPluginAPI/
PlaneverbUnity.cpp:25-136, PlaneverbDSP/PlaneverbDSPUnityPluginAPI/
PlaneverbDSPUnity.cpp). Here the acoustics engine is a Python/JAX host
process driving an accelerator, so the equivalent boundary is a socket: a newline-
delimited JSON protocol exposing the same command surface, usable from any
engine or language (C#, C++, etc.) with a TCP client.

Protocol: one JSON object per line in, one per line out.

  -> {"cmd": "emit", "x": 1.0, "y": 0.0, "z": 2.0}
  <- {"ok": true, "id": 0}
  -> {"cmd": "get_output", "id": 0}
  <- {"ok": true, "occlusion": 0.8, "wet_gain": ..., "direction": [x, y], ...}

Commands mirror the C ABI exports 1:1 (see _HANDLERS). Invalid commands
return {"ok": false, "error": ...} without killing the connection.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading

import numpy as np

from planeverb.config import PlaneverbConfig, Resolution, material_r
from planeverb.core.context import Context
from planeverb.scene import AABB

__all__ = ["EngineServer", "EngineClient"]


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                resp = self.server.engine.dispatch(req)
            except Exception as e:  # noqa: BLE001 — protocol boundary
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()
            if resp.get("bye"):
                break


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class EngineServer:
    """Hosts one acoustics Context behind a TCP JSON protocol."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 mesh_devices: int = 0):
        """``mesh_devices`` > 0 runs every Context created by ``init`` on an
        N-device 2D mesh (parallel.grid_mesh) unless the init request
        overrides it with its own ``mesh`` count."""
        self._ctx: Context | None = None
        self._mesh_devices = mesh_devices
        self._lock = threading.Lock()
        self._srv = _Server((host, port), _Handler)
        self._srv.engine = self
        self.address = self._srv.server_address

    # ------------------------------------------------------------ lifecycle
    def serve_forever(self) -> None:
        self._srv.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name="planeverb-server")
        t.start()
        return t

    def shutdown(self) -> None:
        with self._lock:
            if self._ctx is not None:
                self._ctx.stop()
                self._ctx = None
        self._srv.shutdown()
        self._srv.server_close()

    # ------------------------------------------------------------- dispatch
    def dispatch(self, req: dict) -> dict:
        cmd = req.get("cmd")
        fn = _HANDLERS.get(cmd)
        if fn is None:
            return {"ok": False,
                    "error": f"unknown cmd {cmd!r}; valid: {sorted(_HANDLERS)}"}
        with self._lock:
            if cmd != "init" and self._ctx is None and cmd not in ("bye",):
                return {"ok": False, "error": "not initialized; send init first"}
            return fn(self, req)

    # -------------------------------------------------------------- handlers
    def _init(self, req):
        if self._ctx is not None:
            self._ctx.stop()
        cfg = PlaneverbConfig(
            grid_size_x=float(req.get("grid_size_x", 10.0)),
            grid_size_y=float(req.get("grid_size_y", 10.0)),
            grid_resolution=int(req.get("grid_resolution",
                                        int(Resolution.DEFAULT))),
            grid_offset_x=float(req.get("grid_offset_x", 0.0)),
            grid_offset_y=float(req.get("grid_offset_y", 0.0)))
        # game-engine clients query per emitter (GetOutput), so the
        # cells-publish mode (fetch only the live emitters' rows) is the
        # natural server default
        n_mesh = int(req.get("mesh", self._mesh_devices))
        mesh = None
        if n_mesh > 0:
            from planeverb.parallel import mesh_from_count

            try:
                mesh = mesh_from_count(n_mesh)
            except ValueError as e:
                return {"ok": False, "error": str(e)}
        try:
            self._ctx = Context(cfg, publish=req.get("publish", "cells"),
                                mesh=mesh)
        except ValueError as e:
            return {"ok": False, "error": str(e)}
        if req.get("background", True):
            self._ctx.start()
        resp = {"ok": True, "fs": self._ctx.params.fs,
                "grid": [self._ctx.params.grid_x, self._ctx.params.grid_y],
                "dx": self._ctx.params.dx}
        if mesh is not None:
            resp["mesh"] = dict(mesh.shape)
        return resp

    def _exit(self, req):
        if self._ctx is not None:
            self._ctx.stop()
            self._ctx = None
        return {"ok": True}

    def _bye(self, req):
        return {"ok": True, "bye": True}

    def _emit(self, req):
        eid = self._ctx.emissions.emit(
            float(req["x"]), float(req.get("y", 0)), float(req["z"]),
            forward=tuple(req.get("forward", (1.0, 0.0, 0.0))),
            volume_db=float(req.get("volume_db", 0.0)),
            pattern=int(req.get("pattern", 0)))
        return {"ok": True, "id": eid}

    def _update_emission(self, req):
        fwd = req.get("forward")
        self._ctx.emissions.update(
            int(req["id"]), float(req["x"]), float(req.get("y", 0)),
            float(req["z"]),
            forward=tuple(fwd) if fwd is not None else None,
            volume_db=(float(req["volume_db"]) if "volume_db" in req
                       else None),
            pattern=int(req["pattern"]) if "pattern" in req else None)
        return {"ok": True}

    def _end_emission(self, req):
        self._ctx.emissions.end(int(req["id"]))
        return {"ok": True}

    @staticmethod
    def _output_vals(out):
        """PlaneverbOutput -> (8 floats, valid) with NaN/Inf validation
        before handing params to an audio engine (PlaneverbDSPUnity.cpp:
        102-110 analog): invalid => occlusion sentinel −1, zero-fill. The
        single source of truth for both the per-id and batched queries."""
        vals = [out.occlusion, out.wet_gain, out.rt60, out.lowpass,
                out.direction.x, out.direction.y,
                out.source_directivity.x, out.source_directivity.y]
        valid = out.valid and all(np.isfinite(v) for v in vals)
        if not valid:
            vals = [-1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
        return [float(v) for v in vals], valid

    def _get_output(self, req):
        vals, valid = self._output_vals(self._ctx.get_output(
            int(req["id"]), listener=int(req.get("listener", 0))))
        return {"ok": True, "valid": valid,
                "occlusion": vals[0], "wet_gain": vals[1],
                "rt60": vals[2], "lowpass": vals[3],
                "direction": vals[4:6],
                "source_directivity": vals[6:8]}

    def _get_outputs(self, req):
        """Batched per-frame query: every requested (default: every live)
        emitter's params in ONE round-trip.

        The reference polls every emitter every frame through per-id
        GetOutput calls (PlaneverbAudioSource.cs:171-183) — in-process that
        is free, but over a socket each id costs a round-trip. Returns a
        flat ``rows`` array of 9 floats per id (occlusion, wet_gain, rt60,
        lowpass, direction xy, source_directivity xy, valid-flag) so
        minimal C parsers need no nested JSON.
        """
        ids = req.get("ids")
        if ids is None:
            ids = sorted(self._ctx.emissions.snapshot_emissions())
        ids = [int(i) for i in ids]
        listener = int(req.get("listener", 0))
        rows: list[float] = []
        for eid in ids:
            vals, valid = self._output_vals(
                self._ctx.get_output(eid, listener=listener))
            rows.extend(vals + [1.0 if valid else 0.0])
        return {"ok": True, "count": len(ids), "ids": ids, "rows": rows}

    def _add_geometry(self, req):
        # "absorption" accepts an R float OR a material name (e.g.
        # "CONCRETE_ROUGH") resolved against the 38-entry table — the
        # reference's material enum plumbing (PlaneverbObject.cs:203-244)
        gid = self._ctx.geometry.add(AABB(
            float(req["x"]), float(req["y"]), float(req["width"]),
            float(req["height"]),
            material_r(req.get("absorption", 0.989949494))))
        return {"ok": True, "id": gid}

    def _update_geometry(self, req):
        self._ctx.geometry.update(int(req["id"]), AABB(
            float(req["x"]), float(req["y"]), float(req["width"]),
            float(req["height"]),
            material_r(req.get("absorption", 0.989949494))))
        return {"ok": True}

    def _remove_geometry(self, req):
        self._ctx.geometry.remove(int(req["id"]))
        return {"ok": True}

    def _set_listener_position(self, req):
        self._ctx.set_listener_position(float(req["x"]),
                                        float(req.get("y", 0)),
                                        float(req["z"]))
        return {"ok": True}

    def _set_listener_positions(self, req):
        """Multi-listener (split-screen) mode: {"positions": [[x,y,z],...]}.

        Subsequent get_output/get_outputs accept "listener": i to select
        the view; works in both publish modes (the cells publish fetches
        every view's emitter rows in one [B, Q, 9] transfer).
        """
        try:
            self._ctx.set_listener_positions(
                [tuple(float(v) for v in p) for p in req["positions"]])
        except (ValueError, TypeError) as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True, "count": len(req["positions"])}

    def _step(self, req):
        # Manual stepping and the background loop are mutually exclusive:
        # Context.step() itself is lock-serialized, but a client mixing the
        # two cadences almost certainly wants wait_iteration — reject rather
        # than silently queue behind the loop.
        if self._ctx.background_running:
            return {"ok": False,
                    "error": "background loop running; use wait_iteration "
                             "(or init with background=false to step "
                             "manually)"}
        self._ctx.step()
        return {"ok": True, "iteration": self._ctx.iteration}

    def _wait_iteration(self, req):
        ok = self._ctx.wait_for_iteration(int(req["n"]),
                                          float(req.get("timeout", 60.0)))
        return {"ok": ok, "iteration": self._ctx.iteration}

    def _get_impulse_response(self, req):
        ir = self._ctx.get_impulse_response(float(req["x"]), float(req["z"]))
        return {"ok": True, "fs": self._ctx.params.fs,
                "ir": np.asarray(ir, np.float32).tolist()}

    def _profile(self, req):
        return {"ok": True, "stages": self._ctx.profile_summary()}


_HANDLERS = {
    "init": EngineServer._init,
    "exit": EngineServer._exit,
    "bye": EngineServer._bye,
    "emit": EngineServer._emit,
    "update_emission": EngineServer._update_emission,
    "end_emission": EngineServer._end_emission,
    "get_output": EngineServer._get_output,
    "get_outputs": EngineServer._get_outputs,
    "add_geometry": EngineServer._add_geometry,
    "update_geometry": EngineServer._update_geometry,
    "remove_geometry": EngineServer._remove_geometry,
    "set_listener_position": EngineServer._set_listener_position,
    "set_listener_positions": EngineServer._set_listener_positions,
    "step": EngineServer._step,
    "wait_iteration": EngineServer._wait_iteration,
    "get_impulse_response": EngineServer._get_impulse_response,
    "profile": EngineServer._profile,
}


class EngineClient:
    """Minimal blocking client (reference P/Invoke facade analog)."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._file = self._sock.makefile("rwb")

    def call(self, cmd: str, **kwargs) -> dict:
        req = {"cmd": cmd, **kwargs}
        self._file.write((json.dumps(req) + "\n").encode())
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError("server closed connection")
        return json.loads(line)

    def close(self) -> None:
        try:
            self.call("bye")
        except Exception:
            pass
        self._file.close()
        self._sock.close()
