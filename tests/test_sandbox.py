"""Sandbox front-end tests: WAV I/O, CLI commands, door-sweep harness."""

import io
import os

import numpy as np
import pytest

from planeverb.config import PlaneverbConfig
from planeverb.sandbox.cli import main
from planeverb.sandbox.sweep import door_sweep
from planeverb.sandbox.wav import read_wav, write_wav


class TestWav:
    def test_roundtrip_pcm16_stereo(self, tmp_path):
        rng = np.random.default_rng(0)
        x = (rng.uniform(-0.9, 0.9, (1000, 2))).astype(np.float32)
        p = str(tmp_path / "t.wav")
        write_wav(p, x, 22050)
        y, rate = read_wav(p)
        assert rate == 22050
        assert y.shape == (1000, 2)
        # write scales by 32767, read divides by 32768: quantization plus a
        # 32767/32768 scale factor bounds the roundtrip error at ~1e-4
        np.testing.assert_allclose(y, x, atol=1e-4)

    def test_roundtrip_float32_mono(self, tmp_path):
        x = np.sin(np.linspace(0, 40, 500)).astype(np.float32)
        p = str(tmp_path / "t.wav")
        write_wav(p, x, 44100, float32=True)
        y, rate = read_wav(p)
        assert rate == 44100
        np.testing.assert_array_equal(y, x)

    def test_rejects_garbage(self, tmp_path):
        p = str(tmp_path / "bad.wav")
        with open(p, "wb") as f:
            f.write(b"not a wav file at all")
        with pytest.raises(ValueError):
            read_wav(p)


class TestCli:
    def test_scenes(self, capsys):
        assert main(["scenes"]) == 0
        out = capsys.readouterr().out
        assert "SmallRoom" in out and "FloorPlanScene" in out

    def test_analyze(self, capsys):
        rc = main(["analyze", "SmallRoom", "--listener", "5,5",
                   "--source", "6.5,5", "--resolution", "275"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "occlusion" in out and "rt60" in out and "dB" in out

    def test_analyze_unknown_scene(self):
        with pytest.raises(SystemExit):
            main(["analyze", "NoSuchScene", "--source", "1,1"])

    def test_batch_multi_listener(self, capsys):
        """batch = one batched device call over B listeners (ops/batch.py);
        each listener's readout must match the single-listener analyze
        path at the same position."""
        rc = main(["batch", "SmallRoom", "--listener", "5,5",
                   "--listener", "3,3", "--source", "6.5,5",
                   "--resolution", "275"])
        assert rc == 0
        out = capsys.readouterr().out
        assert out.count("listener (") == 2
        assert out.count("occlusion") == 2
        # first listener's block equals the single-listener analyze output
        assert main(["analyze", "SmallRoom", "--listener", "5,5",
                     "--source", "6.5,5", "--resolution", "275"]) == 0
        single = capsys.readouterr().out
        batch_first = out.split("listener (3, 3)")[0]
        for line in single.splitlines():
            if "occlusion" in line or "rt60" in line:
                assert line in batch_first, line

    def test_batch_requires_listener_in_grid(self):
        with pytest.raises(SystemExit, match="outside grid"):
            main(["batch", "SmallRoom", "--listener", "500,5",
                  "--source", "6,5"])

    def test_grid(self, capsys):
        rc = main(["grid", "SmallRoom", "--resolution", "275"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "#" in out and "." in out

    def test_ir_csv(self, tmp_path, capsys):
        out_path = str(tmp_path / "ir.csv")
        rc = main(["ir", "SmallRoom", "--listener", "5,5",
                   "--source", "6.5,5", "--resolution", "275",
                   "-o", out_path, "--plot"])
        assert rc == 0
        lines = open(out_path).read().strip().splitlines()
        assert lines[0] == "sample,pressure"
        assert len(lines) > 100
        out = capsys.readouterr().out
        assert "linear" in out and "dB [-120, 0]" in out and "*" in out

    def test_ascii_plot_shape(self):
        from planeverb.sandbox.cli import ascii_plot

        y = np.sin(np.linspace(0, 6.28, 1000))
        s = ascii_plot(y, -1.0, 1.0, width=40, height=8)
        rows = s.splitlines()
        assert len(rows) == 8 and all(len(r) == 40 for r in rows)
        assert sum(r.count("*") for r in rows) == 40

    def test_render_native_and_python_agree(self, tmp_path, capsys):
        t = np.arange(4410) / 44100.0
        tone = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
        src = str(tmp_path / "in.wav")
        write_wav(src, tone, 44100)
        outs = {}
        for flavor, extra in (("py", []), ("nat", ["--native"])):
            out_dir = str(tmp_path / flavor)
            rc = main(["render", "SmallRoom", "--listener", "5,5",
                       "--source", "6.5,5", "--resolution", "275",
                       "--in", src, "--out-dir", out_dir] + extra)
            assert rc == 0
            outs[flavor] = {
                n: read_wav(os.path.join(out_dir, f"{n}.wav"))[0]
                for n in ("dry", "wet_a_0.5s", "wet_b_1.0s", "wet_c_3.0s")}
        for name in outs["py"]:
            assert np.abs(outs["py"][name]).max() > 0 or "c_3" in name
            np.testing.assert_allclose(
                outs["nat"][name], outs["py"][name], atol=5e-4,
                err_msg=f"native/python render mismatch on {name}")


class TestSweep:
    def test_door_sweep_smooth_and_monotonicish(self):
        cfg = PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                              grid_resolution=275)
        res = door_sweep(cfg, steps=11)
        assert res.dry_gain.shape == (11,)
        # opening the door must raise the dry gain end-to-end
        assert res.dry_gain[-1] > res.dry_gain[0]
        # smoothness: no step larger than half the total range
        steps = np.abs(np.diff(res.dry_gain))
        rng = res.dry_gain.max() - res.dry_gain.min()
        assert steps.max() <= 0.5 * rng + 1e-6
        buf = io.StringIO()
        res.to_csv(buf)
        assert buf.getvalue().startswith("door_pos,dry_gain,wet_gain")

    def test_ascii_plot_envelope_tracks_decay(self):
        from planeverb.sandbox.cli import ascii_plot

        # decaying dB trace with near-floor samples interleaved: the
        # envelope plot must follow the decay, not the floor
        t = np.arange(400, dtype=np.float64)
        db = -t * 0.25
        db[1::2] = -120.0
        s = ascii_plot(db, -120.0, 0.0, width=40, height=10, envelope=True)
        rows = s.splitlines()
        col_height = [10 - next(r for r in range(10) if rows[r][c] == "*")
                      for c in range(40)]
        assert col_height[0] == 10 and col_height[-1] <= 3
        assert all(a >= b for a, b in zip(col_height, col_height[1:]))


def test_explore_demo_scripted():
    """The interactive demo game's engine loop (examples/explore_demo.py)
    in scripted mode: move, shut the door, verify the far emitter's dry
    gain drops and the map renders both emitters."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "examples", "explore_demo.py")
    spec = importlib.util.spec_from_file_location("explore_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    game = mod.ExploreGame()
    frame = game.frame()
    assert "@" in frame and "S" in frame and "R" in frame
    open_dry = game.ctx.get_output(game.emitters["songbird"]).occlusion
    assert game.handle("D")           # shut the door
    shut_dry = game.ctx.get_output(game.emitters["songbird"]).occlusion
    assert shut_dry < open_dry, (shut_dry, open_dry)
    assert game.handle("w")           # movement re-steps the engine
    assert not game.handle("q")       # quit


def test_cli_scale_sweep(capsys):
    """`scale` measures the sharded solver over growing device counts on
    the virtual CPU mesh and prints one JSON row per count."""
    import json

    from planeverb.sandbox.cli import main

    assert main(["scale", "SmallRoom", "--grid-size", "6",
                 "--listener", "3,3", "--halo", "2", "--reps", "1"]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert rows[0]["efficiency_vs_1"] == 1.0
    assert all(r["wall_s"] > 0 and r["mode"] == "strong" for r in rows)


def test_cli_play_device_flag_guarded(tmp_path):
    """`play --device` routes through AudioDeviceSink, which fails loudly
    with install guidance when sounddevice is absent (this CI image)."""
    import importlib.util

    import numpy as np

    from planeverb.sandbox.cli import main
    from planeverb.sandbox.wav import write_wav

    if importlib.util.find_spec("sounddevice") is not None:
        pytest.skip("sounddevice installed; no audio hardware in CI")
    wav = tmp_path / "in.wav"
    write_wav(str(wav), np.zeros((512, 2), np.float32), 44100)
    with pytest.raises(RuntimeError, match="sounddevice"):
        main(["play", "SmallRoom", "--source", "6,5", "--in", str(wav),
              "--device", "--no-pace", "-o", ""])


def test_former_package_name_aliases_planeverb():
    """The package's former name (an alias package beside ``planeverb``)
    gives the planeverb modules themselves, and ``python -m`` with it finds
    the CLI's entry point."""
    import importlib
    import runpy

    import planeverb
    import planeverb.core.context
    import planeverb.sandbox.cli

    root = os.path.dirname(os.path.dirname(os.path.abspath(planeverb.__file__)))
    former = [d for d in os.listdir(root) if d.startswith("planeverb_")
              and os.path.isfile(os.path.join(root, d, "__init__.py"))]
    assert len(former) == 1
    old = former[0]
    assert importlib.import_module(old) is planeverb
    alias = importlib.import_module(old + ".core.context")
    assert alias is planeverb.core.context
    assert alias.__spec__.name == "planeverb.core.context"
    assert alias.Context is planeverb.Context
    ran = runpy.run_module(old, run_name="alias_check")
    assert ran["main"] is planeverb.sandbox.cli.main
