"""Batched-axis tests: vmapped listeners/scenes equal individual runs."""

import dataclasses

import jax.numpy as jnp
import numpy as np

import oracle
from planeverb.config import PlaneverbConfig, compute_grid_params
from planeverb.ops import analyzer, batch, fdtd, voxelize
from planeverb.scene import demo_scene

CFG = PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275)


def _setup(T=80):
    p = compute_grid_params(CFG)
    p = dataclasses.replace(p, response_length=T)
    beta, refl = voxelize.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = oracle.gaussian_pulse(p)[:T]
    return p, jnp.asarray(beta), jnp.asarray(refl), jnp.asarray(pulse)


def test_batched_listeners_match_individual_runs():
    p, beta, refl, pulse = _setup()
    listeners = [(5.0, 5.0), (4.0, 6.0), (6.2, 3.8)]
    cells = [p.world_to_cell(x, z) for x, z in listeners]
    ixs = jnp.asarray([c[0] for c in cells], jnp.int32)
    iys = jnp.asarray([c[1] for c in cells], jnp.int32)

    res = batch.simulate_listeners(p, beta, refl, pulse, ixs, iys)
    assert res.pressure.shape[0] == 3

    out = batch.analyze_listeners(
        p, res, jnp.float32(0.01),
        jnp.asarray([l[0] for l in listeners], jnp.float32),
        jnp.asarray([l[1] for l in listeners], jnp.float32))

    for i, (lx, lz) in enumerate(listeners):
        ref = fdtd.simulate(p, beta, refl, pulse, cells[i][0], cells[i][1])
        np.testing.assert_allclose(np.asarray(res.pressure[i]),
                                   np.asarray(ref.pressure), atol=1e-6)
        ref_out = analyzer.analyze(p, ref.pressure, ref.onset, ref.flux_x,
                                   ref.flux_y, np.float32(0.01),
                                   np.float32(lx), np.float32(lz))
        np.testing.assert_allclose(np.asarray(out.occlusion[i]),
                                   np.asarray(ref_out.occlusion), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(out.direction[i]),
                                   np.asarray(ref_out.direction), atol=1e-5)


def test_batched_scenes_match_individual_runs():
    p, beta_a, refl_a, pulse = _setup(T=48)
    beta_b, refl_b = voxelize.voxelize_np(p, demo_scene("BigRoom").boxes)
    betas = jnp.stack([beta_a, jnp.asarray(beta_b)])
    refls = jnp.stack([refl_a, jnp.asarray(refl_b)])
    lix, liy = p.world_to_cell(5.0, 5.0)

    res = batch.simulate_scenes(p, betas, refls, pulse, lix, liy)
    for i, (b, r) in enumerate([(beta_a, refl_a),
                                (jnp.asarray(beta_b), jnp.asarray(refl_b))]):
        ref = fdtd.simulate(p, b, r, pulse, lix, liy)
        np.testing.assert_allclose(np.asarray(res.pressure[i]),
                                   np.asarray(ref.pressure), atol=1e-6)


def test_slice_stack():
    """Per-height slices see different geometry (wall only at low heights)."""
    from planeverb.ops.batch import simulate_slices
    from planeverb.scene import AABB3D

    p, _, _, pulse = _setup(T=60)
    boxes3d = [AABB3D(6.0, 1.0, 5.0, 0.5, 2.0, 8.0, 0.97)]  # wall 0..2 m
    lix, liy = p.world_to_cell(4.0, 5.0)
    res = simulate_slices(p, boxes3d, [1.0, 5.0], pulse, lix, liy)
    assert res.pressure.shape[0] == 2
    # probe beyond the wall: low slice is blocked, high slice is free field
    px, py = p.world_to_cell(8.0, 5.0)
    e_low = float(np.sum(np.asarray(res.pressure[0, :, px, py]) ** 2))
    e_high = float(np.sum(np.asarray(res.pressure[1, :, px, py]) ** 2))
    assert e_high > 2.0 * e_low


def test_listeners_auto_on_cpu_matches_vmap():
    p, beta, refl, pulse = _setup()
    cells = [p.world_to_cell(5.0, 5.0), p.world_to_cell(4.0, 6.0)]
    ixs = jnp.asarray([c[0] for c in cells], jnp.int32)
    iys = jnp.asarray([c[1] for c in cells], jnp.int32)
    auto = batch.simulate_listeners_auto(p, beta, refl, pulse, ixs, iys)
    ref = batch.simulate_listeners(p, beta, refl, pulse, ixs, iys)
    np.testing.assert_array_equal(np.asarray(auto.pressure),
                                  np.asarray(ref.pressure))
