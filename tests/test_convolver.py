"""Convolution engine tests."""

import numpy as np
import pytest

from planeverb.dsp.convolver import (PartitionedConvolver,
                                     convolve_offline, resample_ir,
                                     synthetic_ir)


def test_convolve_offline_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(500).astype(np.float32)
    h = rng.standard_normal(64).astype(np.float32)
    got = convolve_offline(a, h)
    ref = np.convolve(a, h).astype(np.float32)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_convolve_offline_jax_and_multichannel():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    a = rng.standard_normal((300, 2)).astype(np.float32)
    h = rng.standard_normal(50).astype(np.float32)
    got = np.asarray(convolve_offline(jnp.asarray(a), jnp.asarray(h), xp=jnp))
    for c in range(2):
        ref = np.convolve(a[:, c], h)
        np.testing.assert_allclose(got[:, c], ref, atol=1e-4)


@pytest.mark.parametrize("n_blocks,block,ir_len", [(8, 64, 200), (5, 128, 100),
                                                   (6, 32, 33)])
def test_partitioned_streaming_equals_offline(n_blocks, block, ir_len):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n_blocks * block).astype(np.float32)
    h = rng.standard_normal(ir_len).astype(np.float32)
    conv = PartitionedConvolver(h, block)
    ys = np.concatenate([conv.process(x[i * block:(i + 1) * block])
                         for i in range(n_blocks)])
    ref = np.convolve(x, h)[:len(ys)]
    np.testing.assert_allclose(ys, ref, atol=2e-4)


def test_synthetic_ir_decay():
    fs = 8000
    ir = synthetic_ir(rt60=0.5, fs=fs)
    # envelope at rt60 should be ~ -60 dB relative to the start
    e0 = np.abs(ir[:100]).max()
    e1 = np.abs(ir[int(0.5 * fs) - 100:int(0.5 * fs)]).max()
    drop = 20 * np.log10(e1 / e0)
    assert -75 < drop < -45


def test_resample_ir_preserves_duration():
    ir = np.sin(np.linspace(0, 20, 700)).astype(np.float32)
    out = resample_ir(ir, 1443, 44100)
    assert abs(len(out) - 700 * 44100 / 1443) < 2
    # peak scaled by sqrt(fs_in/fs_out) < original
    assert np.abs(out).max() < np.abs(ir).max()
