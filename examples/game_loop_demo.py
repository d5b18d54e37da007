"""A complete game-loop integration: objects, emitters, listener, audio.

This is the reference's Unity demo scene reduced to a host-side loop — every
component a game would touch, wired together the way the C# components wire
them (/root/reference UnityDemo/.../PlaneverbObject.cs, PlaneverbEmitter.cs,
PlaneverbListener.cs, PlaneverbAudioSource.cs):

  - an :class:`ObjectManager` tracks 3D scene objects (a door!) and syncs
    the listener's head slice into the solver every frame;
  - emitters carry emit-time volume/directivity; the per-frame
    ``Context.sync_dsp`` handoff pushes transforms + patterns to the DSP;
  - an :class:`AudioSourceManager` plays clips bound to emitters and mixes
    dry + the three canonical reverbs per audio block;
  - the "game" slides the door across the opening and walks the listener,
    re-stepping the engine and re-rendering audio as it goes.

Run: PYTHONPATH=. python examples/game_loop_demo.py
(CPU is fine: JAX_PLATFORMS=cpu runs it without a GPU.)
"""

import numpy as np

import planeverb as pv
from planeverb.config import PlaneverbDSPConfig
from planeverb.dsp import DSPContext, DirectivityPattern
from planeverb.sandbox.audio_manager import AudioSourceManager


def main() -> None:
    # --- engine bring-up: a 10x10 m room with a doorway wall
    ctx = pv.Context(pv.PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                                        grid_resolution=275))
    objects = pv.ObjectManager(ctx)
    # room walls as 3D objects (full height -> always in the head slice)
    for cx, cz, w, d in [(5.0, 0.6, 9.0, 0.4), (5.0, 9.4, 9.0, 0.4),
                         (0.6, 5.0, 0.4, 9.0)]:
        objects.add(pv.AABB3D(x=cx, y=1.5, z=cz, width=w, height=3.0,
                              depth=d, absorption=0.95))
    # a wall with an opening, and a sliding door that will close it
    objects.add(pv.AABB3D(x=5.0, y=1.5, z=3.0, width=0.4, height=3.0,
                          depth=4.4, absorption=0.95))
    objects.add(pv.AABB3D(x=5.0, y=1.5, z=8.2, width=0.4, height=3.0,
                          depth=2.0, absorption=0.95))
    door = objects.add(pv.AABB3D(x=5.0, y=1.5, z=9.6, width=0.35, height=2.2,
                                 depth=2.4, absorption=0.98))

    ctx.set_listener_position(2.5, 1.6, 6.5)

    # --- an emitter on the far side of the wall, quieter and directional
    eid = ctx.emissions.emit(7.5, 1.6, 6.5, forward=(-1.0, 0.0, 0.0),
                             volume_db=-3.0,
                             pattern=DirectivityPattern.CARDIOID)

    # --- audio: a looping tone through the DSP + reverbs
    rate = 44100
    dsp = DSPContext(PlaneverbDSPConfig(max_callback_length=512,
                                        sampling_rate=rate))
    dsp.set_listener_transform((2.5, 0.0, 6.5), (1.0, 0.0, 0.0))
    audio = AudioSourceManager(ctx, dsp)
    t = np.arange(rate) / rate
    clip = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    audio.play(eid, clip, loop=True)

    # --- the game loop: slide the door closed across the opening
    print(f"{'door z':>7} {'occlusion':>10} {'wet gain':>9} {'rt60':>6} "
          f"{'mix rms':>8}")
    for step in range(6):
        door_z = 9.6 - step * 0.9          # slides toward the jamb at 5.2
        objects.update(door, pv.AABB3D(x=5.0, y=1.5, z=door_z, width=0.35,
                                       height=2.2, depth=2.4,
                                       absorption=0.98))
        ctx.step()                          # one engine iteration
        out = ctx.get_output(eid)
        mix = audio.process_block(512)      # one audio callback
        rms = float(np.sqrt((mix ** 2).mean()))
        print(f"{door_z:7.2f} {out.occlusion:10.4f} {out.wet_gain:9.4f} "
              f"{out.rt60:6.3f} {rms:8.5f}")

    # crouch under the door: head-slice culling drops it from the sim
    ctx.set_listener_position(2.5, 0.2, 6.5)
    objects.sync()
    ctx.step()
    out = ctx.get_output(eid)
    print(f"crouched under the door -> occlusion {out.occlusion:.4f}")


if __name__ == "__main__":
    main()
