"""Reverb tests: JAX-vs-native parity, decay-time behavior, streaming."""

import numpy as np
import pytest

from planeverb.dsp.reverb import (init_reverb_state, mix_output,
                                  reverb_params, reverb_scan)
from planeverb.native import NativeReverb

FS = 22050  # halves buffer sizes vs 44.1k; same math


def _impulse(n, amp=1.0):
    x = np.zeros(n, np.float32)
    x[0] = amp
    return x


class TestReverbScan:
    def test_impulse_decays_at_target_rt60(self):
        import jax.numpy as jnp

        rt60 = 0.5
        n = int(FS * 1.2)
        params = reverb_params(rt60, FS)
        state = init_reverb_state(params, batch=1)
        y, _ = reverb_scan(jnp.asarray(_impulse(n))[None], state, params)
        y = np.asarray(y)[0]
        # energy in [0.1, 0.2]s vs [0.6, 0.7]s: expect ~ -60 dB/rt60 decay
        e1 = np.sum(y[int(0.1 * FS):int(0.2 * FS)] ** 2)
        e2 = np.sum(y[int(0.6 * FS):int(0.7 * FS)] ** 2)
        drop_db = 10 * np.log10(e2 / e1)
        expected = -60.0 / rt60 * 0.5  # -60 dB over 0.5 s
        assert expected - 15 < drop_db < expected + 15

    def test_streaming_equals_one_shot(self):
        import jax.numpy as jnp

        rng = np.random.default_rng(3)
        x = rng.standard_normal(1024).astype(np.float32)
        params = reverb_params(1.0, FS)
        whole, _ = reverb_scan(jnp.asarray(x)[None],
                               init_reverb_state(params), params)
        st = init_reverb_state(params)
        parts = []
        for i in range(0, 1024, 256):
            y, st = reverb_scan(jnp.asarray(x[i:i + 256])[None], st, params)
            parts.append(np.asarray(y))
        np.testing.assert_allclose(np.concatenate(parts, axis=1),
                                   np.asarray(whole), atol=1e-6)


class TestNativeReverbParity:
    @pytest.mark.parametrize("rt60", [0.5, 1.0, 3.0])
    def test_matches_jax(self, rt60):
        import jax.numpy as jnp

        rng = np.random.default_rng(7)
        n = 2048
        x = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
        params = reverb_params(rt60, FS)
        ref, _ = reverb_scan(jnp.asarray(x.T), init_reverb_state(params, 2),
                             params)
        out = np.zeros((n, 2), np.float32)
        NativeReverb(rt60, FS).process_add(x, out)
        np.testing.assert_allclose(out, np.asarray(ref).T, atol=2e-5)

    def test_process_add_accumulates(self):
        n = 4096
        x = _impulse(n).reshape(-1, 1)
        base = np.full((n, 1), 0.25, np.float32)
        out = base.copy()
        rev = NativeReverb(1.0, FS, channels=1)
        rev.process_add(x, out)
        delta = out - base
        assert np.abs(delta).max() > 0  # reverb added something
        # a tail exists well past the longest comb delay (~0.0437 s)
        assert np.abs(delta[int(0.1 * FS):]).max() > 0


def test_mix_output_shapes_and_state_carry():
    rng = np.random.default_rng(1)
    n = 512
    buses = [rng.standard_normal((n, 2)).astype(np.float32) * 0.1
             for _ in range(4)]
    mix, states = mix_output(*buses, FS)
    assert np.asarray(mix).shape == (n, 2)
    assert set(states) == {(0.5, FS), (1.0, FS), (3.0, FS)}
    mix2, states = mix_output(*buses, FS, states)
    assert np.asarray(mix2).shape == (n, 2)
