"""End-to-end demo: a dynamic scene, a moving listener, and rendered audio.

The reference ships a Unity demo game (UnityDemo/PlaneverbTest: desert scene,
grabbable sound cues, a door). This script is that demo as a headless
walkthrough — run it to exercise every part of the framework and leave
listenable artifacts in ./demo_out:

  1. builds the FloorPlanScene (18 boxes) with a door AABB
  2. walks the listener through the floor plan while the door opens,
     logging the acoustic parameters per step (CSV)
  3. renders a tone through the DSP chain at three checkpoints
     (dry + wet buses + reverb mix WAVs)
  4. auralizes the simulated IR at the final position (convolution WAV)

Usage: PYTHONPATH=. python examples/demo_walkthrough.py [outdir]
"""

import os
import sys

import numpy as np

import planeverb as pv
from planeverb.dsp import DSPContext
from planeverb.dsp.convolver import convolve_offline, resample_ir
from planeverb.dsp.reverb import mix_output
from planeverb.sandbox.wav import write_wav
from planeverb.scene import AABB


def main(out_dir: str = "demo_out") -> None:
    os.makedirs(out_dir, exist_ok=True)
    rate = 44100

    ctx = pv.Context(pv.PlaneverbConfig(grid_size_x=25.0, grid_size_y=25.0,
                                        grid_resolution=pv.Resolution.LOW),
                     scene=pv.demo_scene("FloorPlanScene"))
    src = (20.0, 0.0, 18.0)          # a sound source in a far room
    eid = ctx.emissions.emit(*src)
    door = ctx.geometry.add(AABB(18.0, 12.0, 1.0, 3.0, 0.9))

    # --- the walkthrough: listener path + door opening
    path = [(3.0, 3.0), (8.0, 5.0), (13.0, 8.0), (16.0, 12.0), (20.0, 15.0)]
    rows = ["step,lx,lz,door_open,occlusion,wet_gain,rt60,lowpass,dir_x,dir_z"]
    checkpoints = {}
    for i, (lx, lz) in enumerate(path):
        ctx.set_listener_position(lx, 0.0, lz)
        open_frac = i / (len(path) - 1)
        ctx.geometry.update(door, AABB(18.0, 12.0 + 3.0 * open_frac,
                                       1.0, 3.0, 0.9))
        ctx.step()
        out = ctx.get_output(eid)
        rows.append(f"{i},{lx},{lz},{open_frac:.2f},{out.occlusion:.5f},"
                    f"{out.wet_gain:.5f},{out.rt60:.5f},{out.lowpass:.1f},"
                    f"{out.direction.x:.4f},{out.direction.y:.4f}")
        if i in (0, len(path) // 2, len(path) - 1):
            checkpoints[i] = ((lx, lz), out)
    with open(os.path.join(out_dir, "walkthrough.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"walkthrough: {len(path)} steps -> {out_dir}/walkthrough.csv")

    # --- render audio at the checkpoints
    t = np.arange(rate) / rate
    tone = (0.4 * np.sin(2 * np.pi * 392.0 * t)
            * np.minimum(1.0, 10 * (1 - t))).astype(np.float32)
    stereo = np.stack([tone, tone], axis=-1)
    for i, ((lx, lz), out) in checkpoints.items():
        dsp = DSPContext(pv.PlaneverbDSPConfig(max_callback_length=1024,
                                               sampling_rate=rate))
        dsp.set_listener_transform((lx, 0.0, lz), (1.0, 0.0, 0.0))
        dsp.update_emitter(eid, src, (-1.0, 0.0, 0.0))
        buses = [np.zeros((rate, 2), np.float32) for _ in range(4)]
        for s in range(0, rate, 1024):
            blk = stereo[s:s + 1024]
            dsp.submit_source(eid, out, blk)
            for bus, ren in zip(buses, dsp.get_output()):
                bus[s:s + len(blk)] = ren[:len(blk)]
        mix, _ = mix_output(buses[0], buses[1], buses[2], buses[3], rate)
        write_wav(os.path.join(out_dir, f"checkpoint_{i}_mix.wav"),
                  np.asarray(mix), rate)
    print(f"rendered {len(checkpoints)} checkpoint mixes")

    # --- auralize the real IR at the final position
    ir = ctx.get_impulse_response(*src[::2])
    if np.abs(ir).max() > 0:
        y = convolve_offline(tone, resample_ir(ir, ctx.params.fs, rate))
        peak = np.abs(y).max() or 1.0
        write_wav(os.path.join(out_dir, "auralized_ir.wav"),
                  y * (0.5 / peak), rate)
        print("auralized the simulated IR -> auralized_ir.wav")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "demo_out")
