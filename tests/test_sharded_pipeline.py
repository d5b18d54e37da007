"""The engine's sharded path (parallel.pipeline_sharded and Context(mesh=))
against the one-device pipeline, over mesh shapes and halo widths on the
8-device virtual CPU platform (tests/conftest.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
import planeverb as pv
from planeverb.config import PlaneverbConfig, compute_grid_params
from planeverb.core.free_grid import calibrate_free_field
from planeverb.ops import voxelize
from planeverb.ops.pipeline import pipeline_auto
from planeverb.parallel import grid_mesh, pad_to_mesh, pipeline_sharded
from planeverb.scene import demo_scene

CFG = PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275)
LISTENER = (5.0, 6.0)
KEYS = ("occlusion", "wet_gain", "rt60", "lowpass", "direction",
        "source_directivity", "delay_samples")
SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (4, 2), (2, 4),
          (8, 1)]


@pytest.fixture(scope="module")
def one_device():
    """Single-device results: the pipeline on a short recording, and the
    published grids of a Context."""
    p = dataclasses.replace(compute_grid_params(CFG), response_length=96)
    beta, refl = voxelize.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = oracle.gaussian_pulse(p)[:96]
    lix, liy = p.world_to_cell(*LISTENER)
    efree = calibrate_free_field(p)
    res, out = pipeline_auto(p, jnp.asarray(beta), jnp.asarray(refl),
                             jnp.asarray(pulse), lix, liy,
                             jnp.float32(efree), jnp.float32(LISTENER[0]),
                             jnp.float32(LISTENER[1]))
    ctx = pv.Context(CFG, scene=demo_scene("SmallRoom"))
    ctx.set_listener_position(LISTENER[0], 0.0, LISTENER[1])
    ctx.step()
    ir = ctx.get_impulse_response(6.5, 6.0)
    return (p, beta, refl, pulse, efree, res, out, ctx._published, ir)


@pytest.mark.parametrize("halo", [1, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
def test_sharded_matches_one_device(one_device, shape, halo):
    p, beta, refl, pulse, efree, res1, out1, pub1, ir1 = one_device
    mesh = grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)

    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh)
    pad = ((0, nx_pad - p.nx), (0, ny_pad - p.ny))
    lix, liy = p.world_to_cell(*LISTENER)
    res, out = pipeline_sharded(
        p, jnp.asarray(np.pad(beta, pad)), jnp.asarray(np.pad(refl, pad)),
        jnp.asarray(pulse), jnp.int32(lix), jnp.int32(liy), mesh, nx_pad,
        ny_pad, jnp.float32(efree), jnp.float32(LISTENER[0]),
        jnp.float32(LISTENER[1]), halo=halo)
    np.testing.assert_allclose(np.asarray(res.pressure),
                               np.asarray(res1.pressure), atol=1e-6)
    for key in KEYS:
        np.testing.assert_allclose(np.asarray(getattr(out, key)),
                                   np.asarray(getattr(out1, key)),
                                   rtol=2e-4, atol=1e-5, err_msg=key)

    ctx = pv.Context(CFG, scene=demo_scene("SmallRoom"), mesh=mesh,
                     halo=halo)
    ctx.set_listener_position(LISTENER[0], 0.0, LISTENER[1])
    ctx.step()
    for key in KEYS:
        np.testing.assert_allclose(ctx._published[key], pub1[key],
                                   rtol=2e-4, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(ctx.get_impulse_response(6.5, 6.0), ir1,
                               atol=1e-6)
