"""JAX FDTD solver parity vs the literal-semantics NumPy oracle."""

import numpy as np
import pytest

import oracle
from planeverb.config import CONSTANTS, PlaneverbConfig, compute_grid_params
from planeverb.ops import fdtd, voxelize
from planeverb.scene import demo_scene


CFG = PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275)


def _run_both(cfg, scene, listener_xz):
    p = compute_grid_params(cfg)
    og = oracle.build_scene(cfg, scene)
    o_pr, o_vx, o_vy = oracle.generate_response(og, *listener_xz)

    beta, refl = voxelize.voxelize_np(p, scene.boxes if scene else [])
    # oracle agreement on the voxelized fields is a precondition
    np.testing.assert_array_equal(beta.ravel(), og.b.astype(np.float32))
    np.testing.assert_array_equal(refl.ravel(), og.absorption)

    lx, ly = p.world_to_cell(*listener_xz)
    res = fdtd.simulate(p, beta, refl, og.pulse, lx, ly)
    return p, (o_pr, o_vx, o_vy), res


@pytest.mark.parametrize("scene_name", [None, "SmallRoom", "ExampleProject"])
def test_pressure_parity(scene_name):
    scene = demo_scene(scene_name) if scene_name else None
    p, (o_pr, _, _), res = _run_both(CFG, scene, (5.0, 5.0))
    jax_pr = np.asarray(res.pressure).reshape(p.response_length, -1)
    peak = np.abs(o_pr).max()
    err = np.abs(jax_pr - o_pr).max()
    assert err <= 1e-6 * max(peak, 1.0), (err, peak)


def test_onset_parity():
    p, (o_pr, _, _), res = _run_both(CFG, demo_scene("SmallRoom"), (5.0, 5.0))
    thr = np.float32(CONSTANTS.audible_threshold_gain)
    above = np.abs(o_pr) > thr
    any_onset = above.any(axis=0)
    o_onset = np.where(any_onset, np.argmax(above, axis=0), np.inf)
    j_onset = np.asarray(res.onset).ravel()
    np.testing.assert_array_equal(j_onset, o_onset.astype(np.float32))


def test_flux_parity():
    p, (o_pr, o_vx, o_vy), res = _run_both(CFG, demo_scene("SmallRoom"),
                                           (5.0, 5.0))
    thr = np.float32(CONSTANTS.audible_threshold_gain)
    T = p.response_length
    above = np.abs(o_pr) > thr
    any_onset = above.any(axis=0)
    onset = np.where(any_onset, np.argmax(above, axis=0), np.inf)
    src_n = p.source_dir_samples
    t_idx = np.arange(T)[:, None]
    m = (t_idx < onset[None, :] + src_n)
    o_fx = np.sum(m * o_pr * o_vx, axis=0, dtype=np.float32)
    o_fy = np.sum(m * o_pr * o_vy, axis=0, dtype=np.float32)
    j_fx = np.asarray(res.flux_x).ravel()
    j_fy = np.asarray(res.flux_y).ravel()
    scale = max(np.abs(o_fx).max(), np.abs(o_fy).max(), 1e-12)
    assert np.abs(j_fx - o_fx).max() <= 1e-5 * scale
    assert np.abs(j_fy - o_fy).max() <= 1e-5 * scale


def test_velocity_fields_parity():
    """Check vx/vy agreement via a modified sim that also records them."""
    import jax
    import jax.numpy as jnp

    cfg = CFG
    scene = demo_scene("SmallRoom")
    p = compute_grid_params(cfg)
    og = oracle.build_scene(cfg, scene)
    o_pr, o_vx, o_vy = oracle.generate_response(og, 5.0, 5.0)

    beta, refl = voxelize.voxelize_np(p, scene.boxes)
    Y = fdtd.admittance(jnp.asarray(refl))
    lx, ly = p.world_to_cell(5.0, 5.0)

    def step(carry, pulse_t):
        pr, vx, vy = carry
        pr, vx, vy = fdtd.fdtd_step(pr, vx, vy, jnp.asarray(beta), Y,
                                    p.courant, p.grid_x, p.grid_y)
        rec = (pr, vx, vy)
        pr = pr.at[lx, ly].add(pulse_t)
        return (pr, vx, vy), rec

    z = jnp.zeros((p.nx, p.ny), jnp.float32)
    T = 120  # prefix of the response is enough for velocity parity
    _, (jpr, jvx, jvy) = jax.lax.scan(step, (z, z, z),
                                      jnp.asarray(og.pulse[:T]))
    for j_arr, o_arr in ((jvx, o_vx), (jvy, o_vy)):
        j = np.asarray(j_arr).reshape(T, -1)
        o = o_arr[:T]
        scale = max(np.abs(o).max(), 1e-12)
        assert np.abs(j - o).max() <= 1e-6 * scale


def test_reflecting_boundary_conserves_energy():
    """Rigid outer walls (our implementation of the reference's declared-but-
    unimplemented pv_ReflectingBoundary) keep energy in the domain."""
    from planeverb.config import BoundaryType
    import dataclasses

    cfg_r = dataclasses.replace(CFG, grid_boundary_type=BoundaryType.REFLECTING)
    p_r = compute_grid_params(cfg_r)
    beta, refl = voxelize.voxelize_np(p_r, [])
    pulse = oracle.gaussian_pulse(p_r)
    lx, ly = p_r.world_to_cell(5.0, 5.0)
    res_r = fdtd.simulate(p_r, beta, refl, pulse, lx, ly)

    p_a = compute_grid_params(CFG)
    res_a = fdtd.simulate(p_a, beta, refl, pulse, lx, ly)

    tail = slice(-50, None)
    e_r = float(np.sum(np.asarray(res_r.pressure)[tail] ** 2))
    e_a = float(np.sum(np.asarray(res_a.pressure)[tail] ** 2))
    assert e_r > 10.0 * e_a, (e_r, e_a)


def test_far_corner_onset_on_large_grid():
    """The diagonal-scaled IR law (config.py::compute_grid_params) must give
    far cells of a large grid a finite onset. This exact case silently
    published never-found sentinels under the reference's fixed
    sqrt(2)*12.5/c + 0.25 s constant (PvTypes.h:101): an 80 m grid with an
    off-center listener puts the far corner ~107 m away, beyond the old
    435-step (~103 m) onset coverage at 275 Hz."""
    from planeverb.config import gaussian_pulse

    cfg = PlaneverbConfig(grid_size_x=80.0, grid_size_y=80.0,
                          grid_resolution=275)
    p = compute_grid_params(cfg)
    assert p.response_length > 435            # the law actually extended T
    beta, refl = voxelize.voxelize_np(p, [])
    pulse = gaussian_pulse(p)
    lx, ly = p.world_to_cell(2.0, 2.0)
    res = fdtd.simulate(p, beta, refl, pulse, lx, ly)
    far = np.asarray(res.onset)[p.grid_x - 2, p.grid_y - 2]
    dist_m = np.hypot((p.grid_x - 2 - lx) * p.dx, (p.grid_y - 2 - ly) * p.dx)
    assert dist_m > 435 * p.dt * CONSTANTS.c  # old law could not cover it
    assert np.isfinite(far), (far, dist_m)
    # and the onset lands near the physical travel time
    assert far * p.dt == pytest.approx(dist_m / CONSTANTS.c, rel=0.1)
