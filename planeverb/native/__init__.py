"""Native runtime: C++ real-time DSP renderer with ctypes bindings.

The reference's audio-thread pipeline is C++ (PvDSPContext.cpp); so is ours.
:class:`NativeDSPContext` mirrors :class:`planeverb.dsp.DSPContext`'s
Python interface 1:1 but runs the per-callback hot loop in compiled C++ with
no Python between ``submit_source`` and the output buses — suitable for real
audio callbacks. Semantics parity is pinned by tests/test_native_dsp.py.

The shared library is built on first import with g++ (no external build
system needed); the artifact is cached next to the source and rebuilt when
pv_dsp.cpp changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from planeverb.config import PlaneverbDSPConfig

__all__ = ["NativeDSPContext", "NativeReverb", "NativeEngineClient",
           "load_library", "build_library", "load_engine_client_library",
           "build_engine_client_library"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "pv_dsp.cpp")
_ENGINE_SRC = os.path.join(_DIR, "src", "pv_engine_client.cpp")
_BUILD = os.path.join(_DIR, "build")
_LIB: ctypes.CDLL | None = None
_ENGINE_LIB: ctypes.CDLL | None = None


def _src_tag(src: str = _SRC) -> str:
    with open(src, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _compile(src: str, stem: str, force: bool = False) -> str:
    os.makedirs(_BUILD, exist_ok=True)
    lib_path = os.path.join(_BUILD, f"{stem}-{_src_tag(src)}.so")
    if force or not os.path.exists(lib_path):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-o", lib_path, src],
            check=True, capture_output=True)
    return lib_path


def build_library(force: bool = False) -> str:
    """Compile pv_dsp.cpp into a shared library; returns its path."""
    return _compile(_SRC, "libpvdsp", force)


def build_engine_client_library(force: bool = False) -> str:
    """Compile pv_engine_client.cpp (the C ABI acoustics binding)."""
    return _compile(_ENGINE_SRC, "libpvengine", force)


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_library())
    f32 = ctypes.c_float
    pf32 = ctypes.POINTER(ctypes.c_float)
    lib.pvdsp_init.restype = ctypes.c_void_p
    lib.pvdsp_init.argtypes = [ctypes.c_int, f32, f32, ctypes.c_int, f32]
    lib.pvdsp_exit.argtypes = [ctypes.c_void_p]
    lib.pvdsp_set_listener_transform.argtypes = [ctypes.c_void_p] + [f32] * 6
    lib.pvdsp_update_emitter.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64] + [f32] * 6)
    lib.pvdsp_set_emitter_directivity_pattern.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.pvdsp_remove_emitter.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.pvdsp_submit_source.restype = ctypes.c_int
    lib.pvdsp_submit_source.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64] + [f32] * 8
        + [pf32, ctypes.c_int, ctypes.c_int])
    lib.pvdsp_get_output.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(pf32)] * 4
    lib.pvrev_init.restype = ctypes.c_void_p
    lib.pvrev_init.argtypes = [f32, f32, ctypes.c_int]
    lib.pvrev_exit.argtypes = [ctypes.c_void_p]
    lib.pvrev_process_add.argtypes = [ctypes.c_void_p, pf32, pf32,
                                      ctypes.c_int]
    _LIB = lib
    return lib


class _OutputC(ctypes.Structure):
    _fields_ = [("occlusion", ctypes.c_float), ("wetGain", ctypes.c_float),
                ("rt60", ctypes.c_float), ("lowpass", ctypes.c_float),
                ("directionX", ctypes.c_float),
                ("directionY", ctypes.c_float),
                ("sourceDirectivityX", ctypes.c_float),
                ("sourceDirectivityY", ctypes.c_float)]


def load_engine_client_library() -> ctypes.CDLL:
    global _ENGINE_LIB
    if _ENGINE_LIB is not None:
        return _ENGINE_LIB
    lib = ctypes.CDLL(build_engine_client_library())
    f32, i32, void_p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    lib.PlaneverbConnect.restype = void_p
    lib.PlaneverbConnect.argtypes = [ctypes.c_char_p, i32]
    lib.PlaneverbDisconnect.argtypes = [void_p]
    lib.PlaneverbInit.restype = i32
    lib.PlaneverbInit.argtypes = [void_p, f32, f32, i32, f32, f32, i32]
    lib.PlaneverbExit.argtypes = [void_p]
    lib.PlaneverbEmit.restype = i32
    lib.PlaneverbEmit.argtypes = [void_p, f32, f32, f32]
    lib.PlaneverbEmitEx.restype = i32
    lib.PlaneverbEmitEx.argtypes = [void_p, f32, f32, f32, f32, f32, f32,
                                    f32, i32]
    lib.PlaneverbUpdateEmission.argtypes = [void_p, i32, f32, f32, f32]
    lib.PlaneverbEndEmission.argtypes = [void_p, i32]
    lib.PlaneverbAddGeometry.restype = i32
    lib.PlaneverbAddGeometry.argtypes = [void_p, f32, f32, f32, f32, f32]
    lib.PlaneverbUpdateGeometry.argtypes = [void_p, i32, f32, f32, f32,
                                            f32, f32]
    lib.PlaneverbRemoveGeometry.argtypes = [void_p, i32]
    lib.PlaneverbSetListenerPosition.argtypes = [void_p, f32, f32, f32]
    lib.PlaneverbStep.restype = i32
    lib.PlaneverbStep.argtypes = [void_p]
    lib.PlaneverbWaitIteration.restype = i32
    lib.PlaneverbWaitIteration.argtypes = [void_p, i32, f32]
    lib.PlaneverbGetOutput.restype = i32
    lib.PlaneverbGetOutput.argtypes = [void_p, i32, ctypes.POINTER(_OutputC)]
    lib.PlaneverbGetOutputs.restype = i32
    lib.PlaneverbGetOutputs.argtypes = [void_p, ctypes.POINTER(i32), i32,
                                        ctypes.POINTER(_OutputC)]
    lib.PlaneverbGetOutputsEx.restype = i32
    lib.PlaneverbGetOutputsEx.argtypes = [void_p, ctypes.POINTER(i32), i32,
                                          i32, ctypes.POINTER(_OutputC)]
    lib.PlaneverbSetListenerPositions.restype = i32
    lib.PlaneverbSetListenerPositions.argtypes = [void_p,
                                                  ctypes.POINTER(f32), i32]
    lib.PlaneverbAddGeometryMaterial.restype = i32
    lib.PlaneverbAddGeometryMaterial.argtypes = [void_p, f32, f32, f32, f32,
                                                 ctypes.c_char_p]
    lib.PlaneverbUpdateGeometryMaterial.argtypes = [void_p, i32, f32, f32,
                                                    f32, f32,
                                                    ctypes.c_char_p]
    _ENGINE_LIB = lib
    return lib


class NativeEngineClient:
    """The C ABI acoustics binding driven from Python (test/demo harness).

    Game engines load libpvengine*.so directly and call the flat exports
    (PlaneverbUnity.cpp analog, see src/pv_engine_client.cpp); this class
    exercises exactly that path — every call below crosses the C ABI."""

    def __init__(self, host: str, port: int):
        self._lib = load_engine_client_library()
        self._h = self._lib.PlaneverbConnect(host.encode(), port)
        if not self._h:
            raise ConnectionError(f"connect to {host}:{port} failed")

    def close(self) -> None:
        if self._h:
            self._lib.PlaneverbDisconnect(self._h)
            self._h = None

    def init(self, size_x: float, size_y: float, resolution: int = 275,
             offset_x: float = 0.0, offset_y: float = 0.0,
             background: bool = True) -> int:
        return self._lib.PlaneverbInit(self._h, size_x, size_y, resolution,
                                       offset_x, offset_y, int(background))

    def exit(self) -> None:
        self._lib.PlaneverbExit(self._h)

    def emit(self, x, y, z) -> int:
        return self._lib.PlaneverbEmit(self._h, x, y, z)

    def emit_ex(self, x, y, z, forward=(1.0, 0.0, 0.0),
                volume_db: float = 0.0, pattern: int = 0) -> int:
        """Emit with emit-time attributes (PlaneverbEmitter.cs:21-24)."""
        return self._lib.PlaneverbEmitEx(self._h, x, y, z, *forward,
                                         volume_db, pattern)

    def update_emission(self, eid, x, y, z) -> None:
        self._lib.PlaneverbUpdateEmission(self._h, eid, x, y, z)

    def end_emission(self, eid) -> None:
        self._lib.PlaneverbEndEmission(self._h, eid)

    def add_geometry(self, x, y, width, height, absorption) -> int:
        """``absorption`` may be an R float or a material name (the name
        form crosses PlaneverbAddGeometryMaterial; resolution happens
        server-side against the 38-entry table)."""
        if isinstance(absorption, str):
            return self._lib.PlaneverbAddGeometryMaterial(
                self._h, x, y, width, height, absorption.encode())
        return self._lib.PlaneverbAddGeometry(self._h, x, y, width, height,
                                              absorption)

    def update_geometry(self, gid, x, y, width, height, absorption) -> None:
        """``absorption``: R float or material name, as in add_geometry."""
        if isinstance(absorption, str):
            self._lib.PlaneverbUpdateGeometryMaterial(
                self._h, gid, x, y, width, height, absorption.encode())
            return
        self._lib.PlaneverbUpdateGeometry(self._h, gid, x, y, width, height,
                                          absorption)

    def remove_geometry(self, gid) -> None:
        self._lib.PlaneverbRemoveGeometry(self._h, gid)

    def set_listener_position(self, x, y, z) -> None:
        self._lib.PlaneverbSetListenerPosition(self._h, x, y, z)

    def set_listener_positions(self, positions) -> bool:
        """Multi-listener (split-screen) mode: [(x, y, z), ...]; works in
        both publish modes. Poll per view with
        get_outputs(ids, listener=i). Returns False when the server
        rejects (bad positions, or a mesh-sharded engine)."""
        positions = [tuple(float(v) for v in p) for p in positions]
        if any(len(p) != 3 for p in positions):
            # the C side reads xyz[3i..3i+2] unconditionally; a short
            # tuple would read out of bounds and send garbage coordinates
            raise ValueError("listener positions are (x, y, z) triples")
        flat = [v for p in positions for v in p]
        arr = (ctypes.c_float * len(flat))(*flat)
        return bool(self._lib.PlaneverbSetListenerPositions(
            self._h, arr, len(positions)))

    def step(self) -> int:
        return self._lib.PlaneverbStep(self._h)

    def wait_iteration(self, n: int, timeout_s: float = 60.0) -> bool:
        return bool(self._lib.PlaneverbWaitIteration(self._h, n, timeout_s))

    def get_output(self, eid: int):
        """Returns a dict of params, or None when invalid (occlusion -1
        sentinel)."""
        out = _OutputC()
        if not self._lib.PlaneverbGetOutput(self._h, eid, ctypes.byref(out)):
            return None
        return {"occlusion": out.occlusion, "wet_gain": out.wetGain,
                "rt60": out.rt60, "lowpass": out.lowpass,
                "direction": (out.directionX, out.directionY),
                "source_directivity": (out.sourceDirectivityX,
                                       out.sourceDirectivityY)}

    def get_outputs(self, ids, listener: int = 0):
        """Batched per-frame poll (PlaneverbGetOutputs): all ids' params in
        ONE server round-trip. Returns a list aligned with ``ids`` of
        param dicts (None for invalid emitters). ``listener`` selects the
        view in multi-listener mode (PlaneverbGetOutputsEx)."""
        n = len(ids)
        arr = (ctypes.c_int * n)(*ids)
        outs = (_OutputC * n)()
        got = self._lib.PlaneverbGetOutputsEx(self._h, arr, n, listener,
                                              outs)
        if got < 0:
            raise ConnectionError("get_outputs protocol failure")
        result = []
        for o in outs:
            if o.occlusion == -1.0:
                result.append(None)
            else:
                result.append({
                    "occlusion": o.occlusion, "wet_gain": o.wetGain,
                    "rt60": o.rt60, "lowpass": o.lowpass,
                    "direction": (o.directionX, o.directionY),
                    "source_directivity": (o.sourceDirectivityX,
                                           o.sourceDirectivityY)})
        return result


class NativeReverb:
    """Streaming Schroeder reverb (C++), one of the three canonical decays.

    ``process_add(x, out)`` adds the reverberated ``x`` into ``out`` in
    place — matching the mixer-line accumulation of the reference's Unity
    graph (PlaneverbReverb.cs:92-101).
    """

    def __init__(self, rt60: float, sample_rate: int, channels: int = 2):
        self._lib = load_library()
        self.channels = channels
        self._h = self._lib.pvrev_init(float(rt60), float(sample_rate),
                                       channels)

    def close(self) -> None:
        if self._h is not None:
            self._lib.pvrev_exit(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def process_add(self, x: np.ndarray, out: np.ndarray) -> None:
        x = np.ascontiguousarray(x, np.float32)
        assert out.dtype == np.float32 and out.flags.c_contiguous
        assert x.shape == out.shape
        frames = x.shape[0]
        pf32 = ctypes.POINTER(ctypes.c_float)
        self._lib.pvrev_process_add(self._h, x.ctypes.data_as(pf32),
                                    out.ctypes.data_as(pf32), frames)


class NativeDSPContext:
    """Drop-in native replacement for planeverb.dsp.DSPContext."""

    def __init__(self, config: PlaneverbDSPConfig | None = None):
        self.config = config or PlaneverbDSPConfig()
        self.config.validate()
        self._lib = load_library()
        self._h = self._lib.pvdsp_init(
            self.config.max_callback_length,
            float(self.config.dsp_smoothing_factor),
            float(self.config.sampling_rate),
            int(self.config.use_spatialization),
            float(self.config.wet_gain_ratio))

    def close(self) -> None:
        if self._h is not None:
            self._lib.pvdsp_exit(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def set_listener_transform(self, position, forward) -> None:
        self._lib.pvdsp_set_listener_transform(self._h, *map(float, position),
                                               *map(float, forward))

    def update_emitter(self, eid: int, position, forward) -> None:
        p = list(map(float, position))
        f = list(map(float, forward))
        if len(p) == 2:
            p = [p[0], 0.0, p[1]]
        if len(f) == 2:
            f = [f[0], 0.0, f[1]]
        self._lib.pvdsp_update_emitter(self._h, eid, *p, *f)

    def set_emitter_directivity_pattern(self, eid: int, pattern: int) -> None:
        self._lib.pvdsp_set_emitter_directivity_pattern(self._h, eid, pattern)

    def remove_emitter(self, eid: int) -> None:
        self._lib.pvdsp_remove_emitter(self._h, eid)

    def submit_source(self, eid: int, dsp_input, audio: np.ndarray) -> None:
        audio = np.ascontiguousarray(audio, dtype=np.float32)
        channels = 1 if audio.ndim == 1 else audio.shape[1]
        frames = audio.shape[0]
        self._lib.pvdsp_submit_source(
            self._h, eid,
            float(dsp_input.occlusion), float(dsp_input.wet_gain),
            float(dsp_input.rt60), float(dsp_input.lowpass),
            float(dsp_input.direction.x), float(dsp_input.direction.y),
            float(dsp_input.source_directivity.x),
            float(dsp_input.source_directivity.y),
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames, channels)

    def get_output(self):
        """Returns (dry, wetA, wetB, wetC) as [max_callback, 2] float32
        copies; swaps and zeroes the native back buffers."""
        ptrs = [ctypes.POINTER(ctypes.c_float)() for _ in range(4)]
        self._lib.pvdsp_get_output(self._h, *[ctypes.byref(p) for p in ptrs])
        n = self.config.max_callback_length
        out = []
        for p in ptrs:
            buf = np.ctypeslib.as_array(p, shape=(n, 2))
            out.append(buf.copy())
        return tuple(out)
