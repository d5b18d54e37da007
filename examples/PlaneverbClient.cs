// PlaneverbClient.cs — drop-in C# binding + component layer for the
// planeverb engine's C ABI (native/src/pv_engine_client.cpp).
//
// This is the counterpart of the reference's Unity plugin API
// (/root/reference UnityDemo/.../PlaneverbContext.cs:25-83 P/Invoke facade,
// PlaneverbObject.cs:203-244 material table, PlaneverbEmitter.cs:52-60
// per-frame update, PlaneverbAudioSource.cs:171-183 per-frame output poll),
// rebuilt for the out-of-process JAX engine: the DLL talks newline-delimited
// JSON over TCP to `python -m planeverb serve`, so the game process
// never links Python or JAX. Differences from the reference facade:
//
//   * handle-based, not singleton: PlaneverbConnect returns a context handle
//     every call takes (multiple engines per process are fine);
//   * batched polling: PlaneverbGetOutputs fetches EVERY live emitter's
//     parameters in ONE round-trip per frame (the reference polls one
//     emitter per call, fine in-process but 1 RTT each over TCP);
//   * material names: AddGeometryMaterial accepts the 38-entry table
//     (config.py MATERIALS) by name, e.g. "CONCRETE_ROUGH".
//
// Build (no Unity required):   csc PlaneverbClient.cs
// Unity: drop this file into Assets/, see the PlaneverbUnityAdapter note at
// the bottom. The native library `libpvengine.so` must be on the library
// path (build: cc -shared -fPIC -O2 planeverb/native/src/
// pv_engine_client.cpp -o libpvengine.so).

using System;
using System.Collections.Generic;
using System.Runtime.InteropServices;

namespace Planeverb
{
    [StructLayout(LayoutKind.Sequential)]
    public struct PlaneverbOutput
    {
        // mirrors PlaneverbOutputC (pv_engine_client.cpp) — occlusion is the
        // dry gain; -1 = invalid sentinel (emitter dead or out of grid)
        public float occlusion;
        public float wetGain;
        public float rt60;
        public float lowpass;
        public float directionX;
        public float directionY;
        public float sourceDirectivityX;
        public float sourceDirectivityY;
        public bool IsValid => occlusion >= 0.0f;
    }

    internal static class Native
    {
        private const string DLL = "pvengine"; // libpvengine.so

        [DllImport(DLL)] public static extern IntPtr PlaneverbConnect(
            string host, int port);
        [DllImport(DLL)] public static extern void PlaneverbDisconnect(
            IntPtr ctx);
        [DllImport(DLL)] public static extern int PlaneverbInit(IntPtr ctx,
            float sizeX, float sizeY, int resolution,
            float offsetX, float offsetY, int background);
        [DllImport(DLL)] public static extern void PlaneverbExit(IntPtr ctx);
        [DllImport(DLL)] public static extern int PlaneverbEmit(IntPtr ctx,
            float x, float y, float z);
        [DllImport(DLL)] public static extern int PlaneverbEmitEx(IntPtr ctx,
            float x, float y, float z,
            float forwardX, float forwardY, float forwardZ,
            float volumeDb, int pattern);
        [DllImport(DLL)] public static extern void PlaneverbUpdateEmission(
            IntPtr ctx, int id, float x, float y, float z);
        [DllImport(DLL)] public static extern void PlaneverbEndEmission(
            IntPtr ctx, int id);
        [DllImport(DLL)] public static extern int PlaneverbAddGeometry(
            IntPtr ctx, float x, float y, float width, float height,
            float absorption);
        [DllImport(DLL)] public static extern int
            PlaneverbAddGeometryMaterial(IntPtr ctx, float x, float y,
                float width, float height, string material);
        [DllImport(DLL)] public static extern void PlaneverbUpdateGeometry(
            IntPtr ctx, int id, float x, float y, float width, float height,
            float absorption);
        [DllImport(DLL)] public static extern void
            PlaneverbUpdateGeometryMaterial(IntPtr ctx, int id, float x,
                float y, float width, float height, string material);
        [DllImport(DLL)] public static extern void PlaneverbRemoveGeometry(
            IntPtr ctx, int id);
        [DllImport(DLL)] public static extern void
            PlaneverbSetListenerPosition(IntPtr ctx, float x, float y,
                float z);
        [DllImport(DLL)] public static extern int PlaneverbStep(IntPtr ctx);
        [DllImport(DLL)] public static extern int PlaneverbWaitIteration(
            IntPtr ctx, int n, float timeoutS);
        [DllImport(DLL)] public static extern int PlaneverbGetOutput(
            IntPtr ctx, int id, out PlaneverbOutput output);
        [DllImport(DLL)] public static extern int PlaneverbGetOutputs(
            IntPtr ctx, int[] ids, int count,
            [Out] PlaneverbOutput[] outputs);
        // split-screen: B listeners ([x0,y0,z0, x1,y1,z1, ...]) and a
        // per-view batched poll
        [DllImport(DLL)] public static extern int
            PlaneverbSetListenerPositions(IntPtr ctx, float[] xyz,
                int count);
        [DllImport(DLL)] public static extern int PlaneverbGetOutputsEx(
            IntPtr ctx, int[] ids, int count, int listener,
            [Out] PlaneverbOutput[] outputs);
    }

    /// One engine connection + lifetime. The reference equivalent is the
    /// PlaneverbContext MonoBehaviour (Awake -> PlaneverbInit, OnApplicationQuit
    /// -> PlaneverbExit); here the engine lives in a separate process
    /// (`python -m planeverb serve [--mesh N]`), so a game restart never
    /// recompiles the device pipeline.
    public sealed class PlaneverbContext : IDisposable
    {
        private IntPtr _ctx;
        private readonly List<PlaneverbEmitter> _emitters = new();

        public PlaneverbContext(string host = "127.0.0.1", int port = 8471,
                                float gridSizeX = 25f, float gridSizeY = 25f,
                                int resolution = 275,
                                float offsetX = 0f, float offsetY = 0f)
        {
            _ctx = Native.PlaneverbConnect(host, port);
            if (_ctx == IntPtr.Zero)
                throw new InvalidOperationException(
                    $"planeverb engine not reachable at {host}:{port} — " +
                    "start it with: python -m planeverb serve");
            // background=1: the engine iterates continuously like the
            // reference BackgroundProcessor (PvContext.cpp:160).
            // PlaneverbInit returns the simulation sampling rate, -1 on error
            if (Native.PlaneverbInit(_ctx, gridSizeX, gridSizeY, resolution,
                                     offsetX, offsetY, 1) <= 0)
                throw new InvalidOperationException("PlaneverbInit failed");
        }

        public PlaneverbEmitter CreateEmitter(float x, float y, float z,
            float volumeDb = 0f, int pattern = 0,
            float forwardX = 1f, float forwardZ = 0f)
        {
            int id = Native.PlaneverbEmitEx(_ctx, x, y, z,
                                            forwardX, 0f, forwardZ,
                                            volumeDb, pattern);
            var e = new PlaneverbEmitter(this, id, x, y, z);
            _emitters.Add(e);
            return e;
        }

        public PlaneverbObject CreateObject(float x, float z, float width,
                                            float height, string material)
        {
            int id = Native.PlaneverbAddGeometryMaterial(
                _ctx, x, z, width, height, material);
            return new PlaneverbObject(this, id, x, z, width, height,
                                       material);
        }

        public void SetListenerPosition(float x, float y, float z)
            => Native.PlaneverbSetListenerPosition(_ctx, x, y, z);

        /// Call once per game frame AFTER moving emitters/listener/objects:
        /// one TCP round-trip refreshes every live emitter's acoustics
        /// (the reference polls per emitter, PlaneverbAudioSource.cs:171-183).
        public void UpdateOutputs()
        {
            _emitters.RemoveAll(e => e.Ended);
            int n = _emitters.Count;
            if (n == 0) return;
            var ids = new int[n];
            for (int i = 0; i < n; i++) ids[i] = _emitters[i].Id;
            var outs = new PlaneverbOutput[n];
            // returns the number of VALID rows (dead/out-of-grid emitters
            // come back with the -1 occlusion sentinel), -1 on protocol error
            if (Native.PlaneverbGetOutputs(_ctx, ids, n, outs) < 0) return;
            for (int i = 0; i < n; i++) _emitters[i].Output = outs[i];
        }

        public bool WaitIteration(int n, float timeoutS = 10f)
            => Native.PlaneverbWaitIteration(_ctx, n, timeoutS) != 0;

        internal IntPtr Handle => _ctx;

        public void Dispose()
        {
            if (_ctx == IntPtr.Zero) return;
            Native.PlaneverbExit(_ctx);
            Native.PlaneverbDisconnect(_ctx);
            _ctx = IntPtr.Zero;
        }
    }

    /// A sound source: keeps its engine emission id alive while it moves
    /// (reference PlaneverbEmitter.cs:52-60 — Emit on enable, UpdateEmission
    /// per frame, EndEmission on disable).
    public sealed class PlaneverbEmitter
    {
        private readonly PlaneverbContext _owner;
        public int Id { get; }
        public bool Ended { get; private set; }
        public PlaneverbOutput Output { get; internal set; }

        internal PlaneverbEmitter(PlaneverbContext owner, int id,
                                  float x, float y, float z)
        { _owner = owner; Id = id; }

        public void Move(float x, float y, float z)
            => Native.PlaneverbUpdateEmission(_owner.Handle, Id, x, y, z);

        public void End()
        {
            if (Ended) return;
            Native.PlaneverbEndEmission(_owner.Handle, Id);
            Ended = true;
        }

        /// Apply to the dry source signal (PlaneverbAudioSource applies
        /// GetVolumeGain() x occlusion to its samples).
        public float DryGain => Output.IsValid ? Output.occlusion : 0f;
    }

    /// A static or movable occluder (reference PlaneverbObject.cs: bounds
    /// tracked per frame; material enum -> absorption row). Move and
    /// Resize re-send the AABB with the creation material preserved;
    /// Remove frees the engine id.
    public sealed class PlaneverbObject
    {
        private readonly PlaneverbContext _owner;
        private readonly string _material;
        public int Id { get; }

        internal PlaneverbObject(PlaneverbContext owner, int id,
                                 float x, float z, float w, float h,
                                 string material)
        {
            _owner = owner; Id = id; X = x; Z = z; Width = w; Height = h;
            _material = material;
        }

        public float X { get; private set; }
        public float Z { get; private set; }
        public float Width { get; private set; }
        public float Height { get; private set; }

        public void Move(float x, float z)
        {
            X = x; Z = z;
            Native.PlaneverbUpdateGeometryMaterial(
                _owner.Handle, Id, X, Z, Width, Height, _material);
        }

        public void Resize(float width, float height)
        {
            Width = width; Height = height;
            Native.PlaneverbUpdateGeometryMaterial(
                _owner.Handle, Id, X, Z, Width, Height, _material);
        }

        public void Remove()
            => Native.PlaneverbRemoveGeometry(_owner.Handle, Id);
    }

    // ----------------------------------------------------------------------
    // Unity adapter sketch (not compiled here — Unity types unavailable):
    //
    //   public class PlaneverbUnityContext : MonoBehaviour {
    //       public string host = "127.0.0.1"; public int port = 8471;
    //       public float gridSize = 25f; public int resolution = 275;
    //       public static PlaneverbContext Engine { get; private set; }
    //       void Awake()  { Engine = new PlaneverbContext(host, port,
    //                           gridSize, gridSize, resolution); }
    //       void Update() {
    //           var l = Camera.main.transform.position;
    //           Engine.SetListenerPosition(l.x, l.y, l.z);
    //           Engine.UpdateOutputs();          // one RTT for all emitters
    //       }
    //       void OnApplicationQuit() { Engine.Dispose(); }
    //   }
    //
    //   A PlaneverbObject component mirrors the reference's
    //   IsWithinPlayerHeadSlice culling (PlaneverbObject.cs:194-200) by
    //   calling CreateObject when the collider's bounds straddle the
    //   listener's ear height and Remove when it leaves the slice; see
    //   planeverb/core/objects.py for the engine-side equivalent.
    // ----------------------------------------------------------------------

    /// Minimal standalone smoke test: connect, build a room, poll params.
    public static class Demo
    {
        public static void Main(string[] args)
        {
            using var pv = new PlaneverbContext(
                args.Length > 0 ? args[0] : "127.0.0.1",
                args.Length > 1 ? int.Parse(args[1]) : 8471,
                gridSizeX: 10f, gridSizeY: 10f);
            pv.CreateObject(5f, 5f, 1f, 1f, "CONCRETE_ROUGH");
            pv.SetListenerPosition(3f, 0f, 5f);
            var emitter = pv.CreateEmitter(7f, 0f, 5f);
            pv.WaitIteration(2);
            pv.UpdateOutputs();
            var o = emitter.Output;
            Console.WriteLine(
                $"occlusion={o.occlusion:F4} wet={o.wetGain:F4} " +
                $"rt60={o.rt60:F3}s lowpass={o.lowpass:F0}Hz " +
                $"dir=({o.directionX:F3},{o.directionY:F3})");
            emitter.End();
        }
    }
}
