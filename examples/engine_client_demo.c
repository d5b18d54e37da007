/* Game-engine integration example: the flat C ABI, no Python required.
 *
 * Build the binding once (also happens automatically on first Python use):
 *   python -c "from planeverb.native import build_engine_client_library;\
 *              print(build_engine_client_library())"
 * Start the engine server (hosts the JAX acoustics context):
 *   python -m planeverb serve --port 8471
 * Compile and run this demo:
 *   gcc examples/engine_client_demo.c -o /tmp/pv_demo \
 *       -L planeverb/native/build -l:$(basename \
 *       planeverb/native/build/libpvengine-*.so) \
 *       -Wl,-rpath,$PWD/planeverb/native/build
 *   /tmp/pv_demo 127.0.0.1 8471
 *
 * The exports mirror the reference's Unity plugin surface
 * (PlaneverbUnity.cpp): geometry CRUD, emitter lifecycle, listener
 * updates, and per-emitter acoustic parameter queries.
 */

#include <stdio.h>
#include <stdlib.h>

typedef struct {
    float occlusion, wetGain, rt60, lowpass;
    float directionX, directionY;
    float sourceDirectivityX, sourceDirectivityY;
} PlaneverbOutputC;

extern void* PlaneverbConnect(const char* host, int port);
extern void PlaneverbDisconnect(void* c);
extern int PlaneverbInit(void* c, float sizeX, float sizeY, int resolution,
                         float offsetX, float offsetY, int background);
extern void PlaneverbExit(void* c);
extern int PlaneverbEmit(void* c, float x, float y, float z);
extern int PlaneverbAddGeometry(void* c, float x, float y, float w, float h,
                                float absorption);
extern void PlaneverbSetListenerPosition(void* c, float x, float y, float z);
extern int PlaneverbStep(void* c);
extern int PlaneverbGetOutput(void* c, int id, PlaneverbOutputC* out);
extern int PlaneverbGetOutputs(void* c, const int* ids, int count,
                               PlaneverbOutputC* outs);

int main(int argc, char** argv) {
    const char* host = argc > 1 ? argv[1] : "127.0.0.1";
    int port = argc > 2 ? atoi(argv[2]) : 8471;

    void* pv = PlaneverbConnect(host, port);
    if (!pv) {
        fprintf(stderr, "connect to %s:%d failed (is the server up?)\n",
                host, port);
        return 1;
    }

    int fs = PlaneverbInit(pv, 10.0f, 10.0f, 275, 0.0f, 0.0f,
                           /*background=*/0);
    printf("engine up, sim fs = %d Hz\n", fs);

    /* a 10x10 room (SmallRoom.pv geometry) */
    PlaneverbAddGeometry(pv, 5.0f, 2.5f, 10.0f, 1.0f, 0.969536f);
    PlaneverbAddGeometry(pv, 5.0f, 7.5f, 10.0f, 1.0f, 0.969536f);
    PlaneverbAddGeometry(pv, 2.5f, 5.0f, 1.0f, 10.0f, 0.969536f);
    PlaneverbAddGeometry(pv, 7.5f, 5.0f, 1.0f, 10.0f, 0.969536f);

    PlaneverbSetListenerPosition(pv, 5.0f, 0.0f, 5.0f);
    int source = PlaneverbEmit(pv, 6.5f, 0.0f, 5.0f);

    PlaneverbStep(pv); /* one sim+analyze iteration */

    PlaneverbOutputC out;
    if (PlaneverbGetOutput(pv, source, &out)) {
        printf("occlusion %.4f  wet %.4f  rt60 %.3fs  lowpass %.0f Hz\n",
               out.occlusion, out.wetGain, out.rt60, out.lowpass);
        printf("direction (%.3f, %.3f)  source directivity (%.3f, %.3f)\n",
               out.directionX, out.directionY,
               out.sourceDirectivityX, out.sourceDirectivityY);
    } else {
        printf("no valid output for emitter %d\n", source);
    }

    /* game-scale per-frame polling: 50 emitters, ONE round-trip per frame
     * (the reference polls each emitter per frame through GetOutput,
     * PlaneverbAudioSource.cs:171-183 — fine in-process, 50 round-trips
     * over a socket; PlaneverbGetOutputs batches them) */
    {
        enum { N = 50 };
        int ids[N];
        PlaneverbOutputC outs[N];
        for (int i = 0; i < N; i++) {
            float x = 3.5f + 3.0f * (float)(i % 10) / 9.0f;
            float z = 3.5f + 3.0f * (float)(i / 10) / 4.0f;
            ids[i] = PlaneverbEmit(pv, x, 0.0f, z);
        }
        PlaneverbStep(pv);
        int valid = PlaneverbGetOutputs(pv, ids, N, outs);
        printf("batched poll: %d/%d emitters valid in one call; "
               "emitter 0 occlusion %.4f\n", valid, N, outs[0].occlusion);
    }

    PlaneverbExit(pv);
    PlaneverbDisconnect(pv);
    return 0;
}
