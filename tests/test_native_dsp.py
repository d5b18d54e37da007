"""Native C++ DSP renderer parity vs the Python streaming renderer."""

import numpy as np
import pytest

from planeverb.config import PlaneverbDSPConfig
from planeverb.dsp import DSPContext
from planeverb.native import NativeDSPContext
from planeverb.types import PlaneverbOutput, vec2

f32 = np.float32


def _inputs(rng, s):
    dirs = rng.standard_normal((s, 2)).astype(f32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    sdirs = rng.standard_normal((s, 2)).astype(f32)
    sdirs /= np.linalg.norm(sdirs, axis=1, keepdims=True)
    return [PlaneverbOutput(
        occlusion=float(rng.uniform(0.1, 1.0)),
        wet_gain=float(rng.uniform(0.1, 1.0)),
        rt60=float(rng.uniform(0.2, 3.5)),
        lowpass=float(rng.uniform(500, 18000)),
        direction=vec2(float(dirs[i, 0]), float(dirs[i, 1])),
        source_directivity=vec2(float(sdirs[i, 0]), float(sdirs[i, 1])))
        for i in range(s)]


def test_native_matches_python_block_for_block():
    cfg = PlaneverbDSPConfig(max_callback_length=128)
    rng = np.random.default_rng(11)
    s, n, blocks = 3, 128, 5

    py = DSPContext(cfg)
    nat = NativeDSPContext(cfg)
    listener_pos = (1.0, 0.0, -2.0)
    listener_fwd = (0.6, 0.0, 0.8)
    py.set_listener_transform(listener_pos, listener_fwd)
    nat.set_listener_transform(listener_pos, listener_fwd)
    for i in range(s):
        pos = tuple(rng.uniform(-5, 5, 3))
        fwd = tuple(rng.standard_normal(3))
        py.update_emitter(i, pos, fwd)
        nat.update_emitter(i, pos, fwd)
        py.set_emitter_directivity_pattern(i, i % 2)
        nat.set_emitter_directivity_pattern(i, i % 2)

    for blk in range(blocks):
        inputs = _inputs(rng, s)
        audio = rng.standard_normal((s, n, 2)).astype(f32) * 0.5
        for i in range(s):
            py.submit_source(i, inputs[i], audio[i])
            nat.submit_source(i, inputs[i], audio[i])
        p_buses = py.get_output()
        n_buses = nat.get_output()
        for name, pb, nb in zip("dry a b c".split(), p_buses, n_buses):
            np.testing.assert_allclose(
                nb, pb, atol=2e-4,
                err_msg=f"bus {name} mismatch at block {blk}")


def test_native_rejects_invalid_inputs():
    cfg = PlaneverbDSPConfig(max_callback_length=64)
    nat = NativeDSPContext(cfg)
    audio = np.ones((64, 2), f32)
    bad = PlaneverbOutput(occlusion=-1.0, wet_gain=0.5, rt60=1.0,
                          lowpass=8000.0, direction=vec2(1.0, 0.0),
                          source_directivity=vec2(1.0, 0.0))
    nat.submit_source(0, bad, audio)
    nat.submit_source(1, PlaneverbOutput(
        occlusion=0.5, wet_gain=0.5, rt60=1.0, lowpass=5.0,
        direction=vec2(1.0, 0.0), source_directivity=vec2(1.0, 0.0)), audio)
    nat.submit_source(2, PlaneverbOutput(
        occlusion=0.5, wet_gain=0.5, rt60=1.0, lowpass=8000.0,
        direction=vec2(0.0, 0.0), source_directivity=vec2(1.0, 0.0)), audio)
    # oversized block
    nat.submit_source(3, _inputs(np.random.default_rng(0), 1)[0],
                      np.ones((4096 * 2, 2), f32))
    for bus in nat.get_output():
        assert np.abs(bus).max() == 0.0


def test_native_mono_input_and_double_buffering():
    cfg = PlaneverbDSPConfig(max_callback_length=64, use_spatialization=False)
    nat = NativeDSPContext(cfg)
    nat.update_emitter(0, (0.5, 0.0, 0.0), (1.0, 0.0, 0.0))
    good = PlaneverbOutput(occlusion=0.8, wet_gain=0.5, rt60=0.9,
                           lowpass=8000.0, direction=vec2(1.0, 0.0),
                           source_directivity=vec2(1.0, 0.0))
    nat.submit_source(0, good, np.ones(64, f32))
    dry, a, b, c = nat.get_output()
    assert np.abs(dry).max() > 0
    assert np.abs(a).max() > 0 and np.abs(b).max() > 0
    assert np.abs(c).max() == 0  # rt60 < 3 s band
    dry2, *_ = nat.get_output()
    assert np.abs(dry2).max() == 0  # back buffer was zeroed


def test_native_render_meets_audio_callback_budget():
    """Reference audio contract: 44.1 kHz stereo, 512-frame blocks
    (Util.h:6-10) => 11.6 ms per callback. The native path must render many
    concurrent sources well inside it; assert a generous 8 ms for one block
    of 8 sources + reverbs so the test stays robust on loaded CI boxes."""
    import time

    from planeverb.native import NativeReverb

    cfg = PlaneverbDSPConfig(max_callback_length=512)
    nat = NativeDSPContext(cfg)
    nat.set_listener_transform((0.0, 0.0, 0.0), (1.0, 0.0, 0.0))
    good = PlaneverbOutput(occlusion=0.8, wet_gain=0.5, rt60=0.9,
                           lowpass=8000.0, direction=vec2(1.0, 0.0),
                           source_directivity=vec2(1.0, 0.0))
    for eid in range(8):
        nat.update_emitter(eid, (1.0 + eid, 0.0, 0.0), (1.0, 0.0, 0.0))
    block = np.ones((512, 2), f32) * 0.25
    reverbs = [NativeReverb(rt, cfg.sampling_rate) for rt in (0.5, 1.0, 3.0)]
    mix = np.zeros((512, 2), f32)

    def one_callback():
        for eid in range(8):
            nat.submit_source(eid, good, block)
        dry, a, b, c = nat.get_output()
        out = dry[:512].copy()
        for rev, bus in zip(reverbs, (a, b, c)):
            rev.process_add(np.ascontiguousarray(bus[:512]), out)
        return out

    one_callback()  # warm
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        one_callback()
        times.append(time.perf_counter() - t0)
    best = min(times)
    budget = 512 / cfg.sampling_rate  # 11.6 ms
    assert best < 0.7 * budget, (best, budget)
