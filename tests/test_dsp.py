"""DSP module tests: gain math properties, lowpass recursions, and a
block-for-block cross-check of the streaming (NumPy) renderer against the
batched JAX renderer.

Reference semantics: /root/reference PlaneverbDSP/src/PvDSPContext.cpp.
"""

import numpy as np
import pytest

from planeverb.config import PlaneverbDSPConfig
from planeverb.dsp import (DirectivityPattern, DSPContext, SourceParams,
                           init_state, render_block)
from planeverb.dsp import gains
from planeverb.dsp.lowpass import (LowpassState, coefficients, process,
                                   process_scan)
from planeverb.types import PlaneverbOutput, vec2

f32 = np.float32


# --------------------------------------------------------------------- gains
class TestWetGains:
    def test_below_first_reverb_all_in_bus_a(self):
        a, b, c = gains.find_wet_gains(0.3, 0.7)
        assert a == pytest.approx(1.0)
        assert b == pytest.approx(0.0)
        assert c == pytest.approx(0.0)

    def test_above_last_reverb_all_in_bus_c(self):
        a, b, c = gains.find_wet_gains(5.0, 0.7)
        assert a == pytest.approx(0.0)
        assert c == pytest.approx(1.0)
        # Reference quirk preserved faithfully: FindGainB has no rt60 >
        # T_ER_3 clamp (PvDSPContext.cpp:184-209), so bus B goes slightly
        # *negative* beyond the last canonical reverb.
        t1 = 10.0 ** (-3 * gains.TSTAR / gains.T_ER_3)
        t2 = 10.0 ** (-3 * gains.TSTAR / 5.0)
        t3 = 10.0 ** (-3 * gains.TSTAR / gains.T_ER_2)
        assert b == pytest.approx(0.7 * (t1 - t2) / (t1 - t3), rel=1e-5)

    def test_mid_band_splits_sum_to_dry_gain(self):
        # For T_ER_1 <= rt60 <= T_ER_3 the A/B (or B/C) splits sum to the
        # submitted gain (PvDSPContext.cpp:165-228 construction).
        for rt60 in (0.5, 0.6, 0.8, 1.0, 1.5, 2.0, 2.9):
            g = 0.7
            a, b, c = gains.find_wet_gains(rt60, g)
            assert a >= -1e-6 and b >= -1e-6 and c >= -1e-6, rt60
            assert a + b + c == pytest.approx(g, abs=1e-5), rt60

    def test_energy_envelope_matches_target_at_tstar(self):
        # The split is built so sum_i g_i * 10^(-3 T*/T_i) equals
        # g * 10^(-3 T*/rt60) — equivalent energy at T* = 0.1 s.
        for rt60 in (0.6, 1.0, 1.7, 2.5):
            g = 1.0
            a, b, c = gains.find_wet_gains(rt60, g)
            envelope = (a * 10.0 ** (-3 * gains.TSTAR / gains.T_ER_1)
                        + b * 10.0 ** (-3 * gains.TSTAR / gains.T_ER_2)
                        + c * 10.0 ** (-3 * gains.TSTAR / gains.T_ER_3))
            target = g * 10.0 ** (-3 * gains.TSTAR / rt60)
            assert envelope == pytest.approx(target, rel=1e-4), rt60

    def test_jnp_matches_numpy(self):
        import jax.numpy as jnp
        rt = np.linspace(0.1, 4.0, 17, dtype=f32)
        for a_np, a_jnp in zip(gains.find_wet_gains(rt, 0.5, xp=np),
                               gains.find_wet_gains(jnp.asarray(rt), 0.5, xp=jnp)):
            np.testing.assert_allclose(a_np, np.asarray(a_jnp),
                                       rtol=1e-4, atol=1e-6)


class TestPanGains:
    def test_constant_power(self):
        for phi in np.linspace(-np.pi, np.pi, 13):
            l, r = gains.pan_gains(np.cos(phi), np.sin(phi), 1.0, 0.0)
            assert l * l + r * r == pytest.approx(1.0, abs=1e-6)

    def test_source_on_forward_axis_is_centered(self):
        l, r = gains.pan_gains(1.0, 0.0, 1.0, 0.0)
        assert l == pytest.approx(r)
        assert l == pytest.approx(gains.INV_SQRT_2)


class TestDirectivity:
    def test_cardioid_front_back(self):
        assert gains.cardioid(1.0, 0.0, 1.0, 0.0) == pytest.approx(1.0)
        back = gains.cardioid(-1.0, 0.0, 1.0, 0.0)
        assert back == pytest.approx(gains.MIN_DRY_GAIN)  # floored null

    def test_omni_is_unity(self):
        assert gains.omni(0.3, -0.4, 1.0, 0.0) == pytest.approx(1.0)


class TestLerpRamp:
    def test_matches_per_sample_recursion(self):
        # Closed form vs the reference's LERP_FLOAT loop
        # (PvDSPDefinitions.h:41-51).
        cur, tgt, factor, n = f32(0.2), f32(0.9), 1.0 / (128 * 2), 128
        ramp, final = gains.lerp_ramp(cur, tgt, factor, n)
        g = cur
        for j in range(n):
            assert ramp[..., j] == pytest.approx(float(g), rel=1e-4)
            g = g * (1.0 - factor) + tgt * factor
        assert final == pytest.approx(float(g), rel=1e-4)


# ------------------------------------------------------------------- lowpass
class TestLowpass:
    def test_dc_gain_near_unity(self):
        # Butterworth LPF: steady-state gain at DC = cx / (1 - cy1 - cy2).
        cx, cy1, cy2 = coefficients(f32(1000.0), f32(44100.0))
        assert cx / (1.0 - cy1 - cy2) == pytest.approx(1.0, rel=1e-5)

    def test_streaming_attenuates_high_freq(self):
        fs = 44100.0
        t = np.arange(2048) / fs
        lo = np.sin(2 * np.pi * 220.0 * t).astype(f32)
        hi = np.sin(2 * np.pi * 12000.0 * t).astype(f32)
        out_lo = process(lo, LowpassState(), 1000.0, fs)
        out_hi = process(hi, LowpassState(), 1000.0, fs)
        tail = slice(1024, None)  # skip transient
        assert np.abs(out_hi[tail]).max() < 0.1 * np.abs(out_lo[tail]).max()

    def test_scan_matches_streaming(self):
        import jax.numpy as jnp
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 256)).astype(f32)
        cut = np.array([500.0, 2000.0, 15000.0], f32)
        # streaming path per source
        expected = np.stack([
            process(x[i], LowpassState(), float(cut[i]), 44100.0)
            for i in range(3)])
        got, y1, y2 = process_scan(jnp.asarray(x), jnp.zeros(3), jnp.zeros(3),
                                   jnp.asarray(cut), 44100.0)
        np.testing.assert_allclose(np.asarray(got), expected, atol=1e-5)

    def test_scan_state_carries_across_blocks(self):
        import jax.numpy as jnp
        rng = np.random.default_rng(1)
        x = rng.standard_normal(512).astype(f32)
        cut = np.array([3000.0], f32)
        whole, _, _ = process_scan(jnp.asarray(x[None]), jnp.zeros(1),
                                   jnp.zeros(1), jnp.asarray(cut), 44100.0)
        a, y1, y2 = process_scan(jnp.asarray(x[None, :256]), jnp.zeros(1),
                                 jnp.zeros(1), jnp.asarray(cut), 44100.0)
        b, _, _ = process_scan(jnp.asarray(x[None, 256:]), y1, y2,
                               jnp.asarray(cut), 44100.0)
        np.testing.assert_allclose(
            np.asarray(whole), np.concatenate(
                [np.asarray(a), np.asarray(b)], axis=1), atol=1e-5)


# ----------------------------------------------------------- streaming context
def _dsp_input(occlusion=0.8, wet_gain=0.5, rt60=0.9, lowpass=8000.0,
               direction=(1.0, 0.0), source_directivity=(0.0, 0.0)):
    return PlaneverbOutput(
        occlusion=occlusion, wet_gain=wet_gain, rt60=rt60, lowpass=lowpass,
        direction=vec2(*direction), source_directivity=vec2(*source_directivity))


class TestDSPContext:
    def test_basic_render_and_swap(self):
        ctx = DSPContext(PlaneverbDSPConfig(max_callback_length=256))
        ctx.set_listener_transform((0.0, 0.0, 0.0), (1.0, 0.0, 0.0))
        ctx.update_emitter(0, (2.0, 0.0, 0.0), (1.0, 0.0, 0.0))
        audio = np.ones((256, 2), f32)
        ctx.submit_source(0, _dsp_input(), audio)
        dry, a, b, c = ctx.get_output()
        assert np.abs(dry).max() > 0
        # rt60 = 0.9 lands in the A/B interpolation band: bus C silent
        assert np.abs(a).max() > 0 and np.abs(b).max() > 0
        assert np.abs(c).max() == 0
        # after swap, next output with no submissions is silence
        dry2, *_ = ctx.get_output()
        assert np.abs(dry2).max() == 0

    def test_input_rejection(self):
        ctx = DSPContext(PlaneverbDSPConfig(max_callback_length=64))
        audio = np.ones((64, 2), f32)
        # invalid occlusion (<= 0, the PV_INVALID_DRY_GAIN path)
        ctx.submit_source(0, _dsp_input(occlusion=-1.0), audio)
        # out-of-range lowpass
        ctx.submit_source(1, _dsp_input(lowpass=5.0), audio)
        # zero direction vector
        ctx.submit_source(2, _dsp_input(direction=(0.0, 0.0)), audio)
        dry, a, b, c = ctx.get_output()
        for bus in (dry, a, b, c):
            assert np.abs(bus).max() == 0

    def test_sources_accumulate(self):
        ctx = DSPContext(PlaneverbDSPConfig(max_callback_length=64,
                                            use_spatialization=False))
        audio = np.ones((64, 2), f32)
        ctx.submit_source(0, _dsp_input(), audio)
        one, *_ = ctx.get_output()
        ctx.submit_source(0, _dsp_input(), audio)
        ctx.submit_source(1, _dsp_input(), audio)
        two, *_ = ctx.get_output()
        assert np.abs(two).sum() > 1.5 * np.abs(one).sum()

    def test_smoothing_converges_to_target(self):
        ctx = DSPContext(PlaneverbDSPConfig(max_callback_length=512))
        audio = np.ones((512, 2), f32)
        inp = _dsp_input(occlusion=0.25, rt60=2.0)
        for _ in range(50):
            ctx.submit_source(0, inp, audio)
            ctx.get_output()
        cur = ctx._current[0]
        assert cur.occlusion == pytest.approx(0.25, rel=1e-3)
        assert cur.rt60 == pytest.approx(2.0, rel=1e-3)


# ------------------------------------------------- streaming vs batched parity
class TestBatchedRendererParity:
    def test_matches_streaming_block_for_block(self):
        import jax.numpy as jnp
        cfg = PlaneverbDSPConfig(max_callback_length=128)
        n, s, blocks = 128, 3, 4
        rng = np.random.default_rng(7)

        listener_pos = (1.0, 0.0, -2.0)
        listener_fwd = (0.6, 0.0, 0.8)
        positions = rng.uniform(-5, 5, (s, 2)).astype(f32)
        forwards = rng.standard_normal((s, 2)).astype(f32)
        forwards /= np.linalg.norm(forwards, axis=1, keepdims=True)
        patterns = np.array([0, 1, 1], np.int32)

        stream = DSPContext(cfg)
        stream.set_listener_transform(listener_pos, listener_fwd)
        for i in range(s):
            stream.update_emitter(i, (positions[i, 0], 0.0, positions[i, 1]),
                                  (forwards[i, 0], 0.0, forwards[i, 1]))
            stream.set_emitter_directivity_pattern(i, int(patterns[i]))

        # init_state defaults match the streaming EmissionParams defaults
        # (position/forward at origin, cardioid pattern), so both renderers
        # start from identical smoothing state.
        state = init_state(s)

        for blk in range(blocks):
            audio = rng.standard_normal((s, n, 2)).astype(f32) * 0.5
            params = dict(
                occlusion=rng.uniform(0.1, 1.0, s).astype(f32),
                wet_gain=rng.uniform(0.1, 1.0, s).astype(f32),
                rt60=rng.uniform(0.2, 3.5, s).astype(f32),
                lowpass=rng.uniform(500, 18000, s).astype(f32),
            )
            dirs = rng.standard_normal((s, 2)).astype(f32)
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            sdirs = rng.standard_normal((s, 2)).astype(f32)
            sdirs /= np.linalg.norm(sdirs, axis=1, keepdims=True)

            for i in range(s):
                stream.submit_source(i, PlaneverbOutput(
                    occlusion=float(params["occlusion"][i]),
                    wet_gain=float(params["wet_gain"][i]),
                    rt60=float(params["rt60"][i]),
                    lowpass=float(params["lowpass"][i]),
                    direction=vec2(float(dirs[i, 0]), float(dirs[i, 1])),
                    source_directivity=vec2(float(sdirs[i, 0]),
                                            float(sdirs[i, 1]))), audio[i])
            s_dry, s_a, s_b, s_c = stream.get_output()

            target = SourceParams(
                occlusion=jnp.asarray(params["occlusion"]),
                wet_gain=jnp.asarray(params["wet_gain"]),
                rt60=jnp.asarray(params["rt60"]),
                lowpass=jnp.asarray(params["lowpass"]),
                direction=jnp.asarray(dirs),
                position=jnp.asarray(positions),
                forward=jnp.asarray(forwards),
                directivity=jnp.asarray(sdirs),
                pattern=jnp.asarray(patterns))
            (b_dry, b_a, b_b, b_c), state = render_block(
                cfg, jnp.asarray(audio), target, state,
                jnp.asarray(listener_pos, jnp.float32),
                jnp.asarray(listener_fwd, jnp.float32))

            for name, sv, bv in (("dry", s_dry, b_dry), ("a", s_a, b_a),
                                 ("b", s_b, b_b), ("c", s_c, b_c)):
                np.testing.assert_allclose(
                    np.asarray(bv), sv[:n], atol=2e-4,
                    err_msg=f"bus {name} mismatch at block {blk}")

    def test_nan_params_in_rejected_source_do_not_poison_buses(self):
        """Regression: NaN/Inf params of an invalid source must not leak
        into other sources' output through the cross-source bus sums."""
        import jax.numpy as jnp
        cfg = PlaneverbDSPConfig(max_callback_length=64)
        s, n = 2, 64
        state = init_state(s)
        audio = jnp.ones((s, n, 2), jnp.float32)
        target = SourceParams(
            occlusion=jnp.array([0.8, np.nan], jnp.float32),
            wet_gain=jnp.array([0.5, np.inf], jnp.float32),
            rt60=jnp.array([0.9, np.nan], jnp.float32),
            lowpass=jnp.array([8000.0, 1e30], jnp.float32),
            direction=jnp.tile(jnp.array([[1.0, 0.0]]), (s, 1)),
            position=jnp.zeros((s, 2)), forward=jnp.zeros((s, 2)),
            directivity=jnp.zeros((s, 2)), pattern=jnp.zeros(s, jnp.int32))
        (dry, a, b, c), new_state = render_block(
            cfg, audio, target, state, jnp.zeros(3),
            jnp.array([1.0, 0.0, 0.0]))
        for name, bus in (("dry", dry), ("a", a), ("b", b), ("c", c)):
            assert np.isfinite(np.asarray(bus)).all(), name
        assert np.abs(np.asarray(dry)).max() > 0  # valid source still renders
        assert np.isfinite(np.asarray(
            jnp.concatenate([new_state.lpf_y1, new_state.lpf_y2]))).all()

    def test_rejected_source_is_silent_and_frozen(self):
        import jax.numpy as jnp
        cfg = PlaneverbDSPConfig(max_callback_length=64)
        s, n = 2, 64
        state = init_state(s)
        audio = jnp.ones((s, n, 2), jnp.float32)
        target = SourceParams(
            occlusion=jnp.array([0.8, -1.0], jnp.float32),  # src 1 invalid
            wet_gain=jnp.full(s, 0.5), rt60=jnp.full(s, 0.9),
            lowpass=jnp.full(s, 8000.0),
            direction=jnp.tile(jnp.array([[1.0, 0.0]]), (s, 1)),
            position=jnp.zeros((s, 2)), forward=jnp.zeros((s, 2)),
            directivity=jnp.zeros((s, 2)), pattern=jnp.zeros(s, jnp.int32))
        (dry, *_), new_state = render_block(
            cfg, audio, target, state, jnp.zeros(3), jnp.array([1.0, 0.0, 0.0]))
        # invalid source contributes nothing and keeps default current state
        assert float(new_state.current.occlusion[1]) == 1.0
        assert float(new_state.current.rt60[1]) == 0.0
        assert float(new_state.lpf_y1[1]) == 0.0
