"""Sharded-solver tests on the 8-device virtual CPU mesh (SURVEY.md §4.4).

Golden check: the spatially sharded solver must reproduce the single-chip
solver's fields bit-for-bit-modulo-f32-reduction on every mesh shape,
including shapes that require padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from planeverb.config import PlaneverbConfig, compute_grid_params
from planeverb.ops import analyzer, fdtd, voxelize
from planeverb.parallel import grid_mesh, pad_to_mesh, simulate_sharded
from planeverb.parallel.mesh import factor_mesh
from planeverb.scene import demo_scene

CFG = PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275)
LISTENER = (5.0, 5.0)


def _setup(scene):
    p = compute_grid_params(CFG)
    boxes = scene.boxes if scene else []
    beta, refl = voxelize.voxelize_np(p, boxes)
    pulse = oracle.gaussian_pulse(p)
    lix, liy = p.world_to_cell(*LISTENER)
    return p, beta, refl, pulse, lix, liy


def _pad(arr, nx_pad, ny_pad):
    out = np.zeros((nx_pad, ny_pad), np.float32)
    out[:arr.shape[0], :arr.shape[1]] = arr
    return out


def test_virtual_device_count():
    assert len(jax.devices()) == 8, \
        "conftest must provide 8 virtual CPU devices"


def test_factor_mesh():
    assert factor_mesh(8) == (2, 4)
    assert factor_mesh(4) == (2, 2)
    assert factor_mesh(16) == (4, 4)
    assert factor_mesh(7) == (1, 7)


@pytest.mark.parametrize("shape", [(1, 1), (1, 8), (2, 4), (8, 1)])
def test_sharded_matches_single_chip(shape):
    p, beta, refl, pulse, lix, liy = _setup(demo_scene("SmallRoom"))
    ref = fdtd.simulate(p, beta, refl, pulse, lix, liy)

    n = shape[0] * shape[1]
    mesh = grid_mesh(jax.devices()[:n], shape)
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh)
    res = simulate_sharded(p, _pad(beta, nx_pad, ny_pad),
                           _pad(refl, nx_pad, ny_pad), pulse,
                           jnp.int32(lix), jnp.int32(liy), mesh,
                           nx_pad, ny_pad)

    np.testing.assert_allclose(
        np.asarray(res.pressure)[:, :p.nx, :p.ny],
        np.asarray(ref.pressure), atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(res.onset)[:p.nx, :p.ny], np.asarray(ref.onset))
    np.testing.assert_allclose(
        np.asarray(res.flux_x)[:p.nx, :p.ny], np.asarray(ref.flux_x),
        atol=1e-6)


def test_padding_stays_silent():
    """Padded cells (beta=0) must never develop pressure or velocity."""
    p, beta, refl, pulse, lix, liy = _setup(None)
    mesh = grid_mesh(jax.devices(), (2, 4))
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh)
    assert (nx_pad, ny_pad) != (p.nx, p.ny)  # padding actually exercised
    res = simulate_sharded(p, _pad(beta, nx_pad, ny_pad),
                           _pad(refl, nx_pad, ny_pad), pulse,
                           jnp.int32(lix), jnp.int32(liy), mesh,
                           nx_pad, ny_pad)
    pr = np.asarray(res.pressure)
    assert np.abs(pr[:, p.nx:, :]).max() == 0.0
    assert np.abs(pr[:, :, p.ny:]).max() == 0.0


def test_end_to_end_sharded_analysis():
    """simulate_sharded -> analyzer.analyze equals the single-chip pipeline."""
    from planeverb.core.free_grid import calibrate_free_field

    p, beta, refl, pulse, lix, liy = _setup(demo_scene("SmallRoom"))
    efree = calibrate_free_field(p)

    ref = fdtd.simulate(p, beta, refl, pulse, lix, liy)
    out_ref = analyzer.analyze(p, ref.pressure, ref.onset, ref.flux_x,
                               ref.flux_y, np.float32(efree),
                               np.float32(LISTENER[0]), np.float32(LISTENER[1]))

    mesh = grid_mesh(jax.devices(), (2, 4))
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh)
    res = simulate_sharded(p, _pad(beta, nx_pad, ny_pad),
                           _pad(refl, nx_pad, ny_pad), pulse,
                           jnp.int32(lix), jnp.int32(liy), mesh,
                           nx_pad, ny_pad)
    out = analyzer.analyze(p, res.pressure[:, :p.nx, :p.ny],
                           res.onset[:p.nx, :p.ny],
                           res.flux_x[:p.nx, :p.ny],
                           res.flux_y[:p.nx, :p.ny], np.float32(efree),
                           np.float32(LISTENER[0]), np.float32(LISTENER[1]))

    np.testing.assert_allclose(np.asarray(out.occlusion),
                               np.asarray(out_ref.occlusion), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out.rt60),
                               np.asarray(out_ref.rt60), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(out.direction),
                               np.asarray(out_ref.direction), atol=1e-4)


@pytest.mark.parametrize("shape,halo", [((2, 4), 4), ((2, 4), 7), ((1, 8), 3)])
def test_wide_halo_matches_single_chip(shape, halo):
    """Multi-step halo widening: k-wide ghosts exchanged every k steps must
    reproduce the per-step-exchange solver exactly (incl. T % halo != 0)."""
    from planeverb.parallel.solver import simulate_sharded_wide

    p, beta, refl, pulse, lix, liy = _setup(demo_scene("SmallRoom"))
    ref = fdtd.simulate(p, beta, refl, pulse, lix, liy)

    n = shape[0] * shape[1]
    mesh = grid_mesh(jax.devices()[:n], shape)
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh)
    res = simulate_sharded_wide(p, _pad(beta, nx_pad, ny_pad),
                                _pad(refl, nx_pad, ny_pad), pulse,
                                jnp.int32(lix), jnp.int32(liy), mesh,
                                nx_pad, ny_pad, halo=halo)
    np.testing.assert_allclose(
        np.asarray(res.pressure)[:, :p.nx, :p.ny],
        np.asarray(ref.pressure), atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(res.onset)[:p.nx, :p.ny], np.asarray(ref.onset))
    np.testing.assert_allclose(
        np.asarray(res.flux_x)[:p.nx, :p.ny], np.asarray(ref.flux_x),
        atol=1e-6)


def test_wide_halo_rejects_oversized_halo():
    from planeverb.parallel.solver import simulate_sharded_wide

    p, beta, refl, pulse, lix, liy = _setup(None)
    mesh = grid_mesh(jax.devices(), (2, 4))
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh)
    with pytest.raises(ValueError, match="halo"):
        simulate_sharded_wide(p, _pad(beta, nx_pad, ny_pad),
                              _pad(refl, nx_pad, ny_pad), pulse,
                              jnp.int32(lix), jnp.int32(liy), mesh,
                              nx_pad, ny_pad, halo=50)


class _FakeDev:
    def __init__(self, pid, i):
        self.process_index = pid
        self.id = i

    def __repr__(self):
        return f"d{self.process_index}.{self.id}"


class TestMultihost:
    def test_layout_single_process_matches_factorization(self):
        from planeverb.parallel.multihost import layout_by_process

        arr = layout_by_process(jax.devices())
        assert arr.shape == factor_mesh(8)

    def test_layout_groups_process_rows_contiguously(self):
        from planeverb.parallel.multihost import layout_by_process

        # 4 hosts x 4 devices: y-neighbors must be same-process
        devs = [_FakeDev(p, i) for p in range(4) for i in range(4)]
        arr = layout_by_process(devs)
        assert arr.shape == (8, 2)
        for row in arr:
            assert len({d.process_index for d in row}) == 1
        # x rows grouped: process changes at most once between adjacent rows
        pids = [row[0].process_index for row in arr]
        assert pids == sorted(pids)

    def test_layout_rejects_dcn_crossing_y(self):
        from planeverb.parallel.multihost import layout_by_process

        devs = [_FakeDev(p, i) for p in range(2) for i in range(2)]
        with pytest.raises(ValueError, match="host boundaries"):
            layout_by_process(devs, shape=(1, 4))

    def test_layout_rejects_uneven_processes(self):
        from planeverb.parallel.multihost import layout_by_process

        devs = [_FakeDev(0, 0), _FakeDev(0, 1), _FakeDev(1, 2)]
        with pytest.raises(ValueError, match="uneven"):
            layout_by_process(devs)

    def test_multihost_mesh_runs_sharded_solver(self):
        from planeverb.parallel.multihost import multihost_grid_mesh

        mesh = multihost_grid_mesh()
        p, beta, refl, pulse, lix, liy = _setup(demo_scene("SmallRoom"))
        nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh)
        res = simulate_sharded(
            p, jnp.asarray(_pad(beta, nx_pad, ny_pad)),
            jnp.asarray(_pad(refl, nx_pad, ny_pad)),
            jnp.asarray(pulse), jnp.int32(lix), jnp.int32(liy),
            mesh, nx_pad, ny_pad)
        ref = fdtd.simulate(p, jnp.asarray(beta), jnp.asarray(refl),
                            jnp.asarray(pulse), jnp.int32(lix),
                            jnp.int32(liy))
        np.testing.assert_allclose(
            np.asarray(res.pressure)[:, :p.nx, :p.ny],
            np.asarray(ref.pressure), atol=1e-6)

    def test_init_distributed_single_process_noop(self):
        from planeverb.parallel.multihost import init_distributed

        init_distributed(num_processes=1)  # must not raise or init anything

    def test_scaling_harness_rows(self):
        from planeverb.parallel.scaling import measure_scaling

        cfg = PlaneverbConfig(grid_size_x=6.0, grid_size_y=6.0,
                              grid_resolution=275)
        p = compute_grid_params(cfg)
        beta, refl = voxelize.voxelize_np(p, [])
        pulse = oracle.gaussian_pulse(p)
        lix, liy = p.world_to_cell(3.0, 3.0)
        rows = measure_scaling(p, beta, refl, pulse, lix, liy,
                               device_counts=[1, 2], halo=4, reps=1)
        assert [r["devices"] for r in rows] == [1, 2]
        assert rows[0]["efficiency_vs_1"] == 1.0
        assert all(r["wall_s"] > 0 and r["cell_updates_per_s"] > 0
                   for r in rows)


def test_multihost_two_processes_end_to_end():
    """Real multi-process bring-up: two OS processes join a jax.distributed
    runtime (2 virtual CPU devices each), build multihost_grid_mesh, and run
    simulate_sharded_wide on global arrays — parity asserted against a
    single-device solve inside each worker (tests/multihost_worker.py)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:  # free localhost port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(sys.path[:2])  # tests + repo root
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)  # worker sets its own 2-device flag
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(pid), "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(2)]
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out
    assert any("RESULT pid=0" in out for out in outs)


def test_pipeline_sharded_matches_single_chip():
    """Full multi-device pipeline (wide-halo sharded sim + per-shard moments
    + assembly) against the single-device pipeline on all six parameters."""
    from planeverb.core.free_grid import calibrate_free_field
    from planeverb.ops.pipeline import pipeline_auto
    from planeverb.parallel import pipeline_sharded

    p, beta, refl, pulse, lix, liy = _setup(demo_scene("SmallRoom"))
    efree = calibrate_free_field(p)
    _, out_ref = pipeline_auto(
        p, jnp.asarray(beta), jnp.asarray(refl), jnp.asarray(pulse),
        lix, liy, jnp.float32(efree), jnp.float32(LISTENER[0]),
        jnp.float32(LISTENER[1]))

    mesh = grid_mesh(jax.devices(), (2, 4))
    nx_pad, ny_pad = pad_to_mesh(p.nx, p.ny, mesh)
    _, out = pipeline_sharded(
        p, _pad(beta, nx_pad, ny_pad), _pad(refl, nx_pad, ny_pad), pulse,
        jnp.int32(lix), jnp.int32(liy), mesh, nx_pad, ny_pad,
        jnp.float32(efree), jnp.float32(LISTENER[0]),
        jnp.float32(LISTENER[1]), halo=8)
    np.testing.assert_allclose(np.asarray(out.occlusion),
                               np.asarray(out_ref.occlusion), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out.wet_gain),
                               np.asarray(out_ref.wet_gain), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out.rt60),
                               np.asarray(out_ref.rt60), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(out.lowpass),
                               np.asarray(out_ref.lowpass), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(out.direction),
                               np.asarray(out_ref.direction), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.source_directivity),
                               np.asarray(out_ref.source_directivity),
                               atol=1e-4)


def test_measure_scaling_weak_mode():
    """measure_scaling(mode='weak') grows the world with the device count,
    holding the per-device block and T fixed (plumbing check on the CPU
    mesh)."""
    from planeverb.parallel.scaling import measure_scaling

    cfg = PlaneverbConfig(grid_size_x=6.0, grid_size_y=6.0,
                          grid_resolution=275)
    p = compute_grid_params(cfg)
    beta, refl = voxelize.voxelize_np(p, [])
    pulse = oracle.gaussian_pulse(p)
    lix, liy = p.world_to_cell(3.0, 3.0)
    rows = measure_scaling(p, beta, refl, pulse, lix, liy,
                           device_counts=[1, 4], halo=2, reps=1,
                           mode="weak")
    assert rows[0]["mode"] == "weak"
    assert rows[0]["grid"] == [p.nx, p.ny]
    g1 = rows[1]["grid"]
    m1 = rows[1]["mesh"]
    # the grid grew with the mesh (per-chip block ~ the base grid)
    assert g1[0] >= p.nx * m1[0] - 2 and g1[1] >= p.ny * m1[1] - 2
    assert rows[1]["efficiency_vs_1"] > 0
    with pytest.raises(ValueError, match="mode"):
        measure_scaling(p, beta, refl, pulse, lix, liy, device_counts=[1],
                        mode="nope")
