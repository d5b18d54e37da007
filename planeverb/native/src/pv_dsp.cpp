// Native real-time DSP renderer — C ABI, no Python in the audio callback.
//
// Re-implementation of the PlaneverbDSP render pipeline (reference
// /root/reference PlaneverbDSP/src/PvDSPContext.cpp:250-452,
// EmissionManager.h:10-77, DSP/Lowpass.h) with the same semantics as the
// Python streaming renderer (planeverb/dsp/context.py) — the two are
// cross-checked block-for-block in tests/test_native_dsp.py.
//
// Deviations from the reference, matching dsp/context.py (documented there):
//   - wet buses accumulate across sources (the reference overwrites);
//   - loop lengths use the submitted frame count, not a running max.
//
// Exposed via ctypes (planeverb/native/__init__.py). All functions are
// lock-free single-threaded per context handle: the host guarantees the
// audio-callback threading contract, as in the reference.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kPi = 3.141593f;
constexpr float kSqrt2 = 1.4142136f;
constexpr float kInvSqrt2 = 0.70710678f;
constexpr float kTER1 = 0.5f;   // PV_DSP_T_ER_1..3 (PvDSPTypes.h:13-15)
constexpr float kTER2 = 1.0f;
constexpr float kTER3 = 3.0f;
constexpr float kTStar = 0.1f;
constexpr float kMinDryGain = 0.01f;
constexpr float kMaxFreq = 20000.0f;
constexpr float kMinFreq = 20.0f;

struct EmissionParams {  // EmissionData defaults (EmissionManager.h:20-31)
  float occlusion = 1.0f;
  float wet_gain = 1.0f;
  float rt60 = 0.0f;
  float lowpass = 20000.0f;
  float dir[2] = {0.0f, 0.0f};
  float pos[2] = {0.0f, 0.0f};
  float fwd[2] = {0.0f, 0.0f};
  float sdir[2] = {0.0f, 0.0f};
  int pattern = 1;  // cardioid
};

struct LowpassState {
  float y1 = 0.0f;
  float y2 = 0.0f;
};

// FindGainA/B/C (PvDSPContext.cpp:165-228), incl. the faithful absence of an
// rt60 > T_ER_3 clamp in FindGainB.
float FindGainA(float rt60, float gain) {
  if (rt60 > kTER2) return 0.0f;
  if (rt60 < kTER1) return 1.0f;
  float t1 = std::pow(10.0f, -3.0f * kTStar / kTER2);
  float t2 = std::pow(10.0f, -3.0f * kTStar / rt60);
  float t3 = std::pow(10.0f, -3.0f * kTStar / kTER1);
  return gain * (t1 - t2) / (t1 - t3);
}

float FindGainB(float rt60, float gain) {
  if (rt60 < kTER1) return 0.0f;
  float t2 = std::pow(10.0f, -3.0f * kTStar / rt60);
  if (rt60 > kTER2) {
    float t1 = std::pow(10.0f, -3.0f * kTStar / kTER3);
    float t3 = std::pow(10.0f, -3.0f * kTStar / kTER2);
    return gain * (t1 - t2) / (t1 - t3);
  }
  float t1 = std::pow(10.0f, -3.0f * kTStar / kTER2);
  float t3 = std::pow(10.0f, -3.0f * kTStar / kTER1);
  return gain - gain * (t1 - t2) / (t1 - t3);
}

float FindGainC(float rt60, float gain) {
  if (rt60 > kTER3) return 1.0f;
  if (rt60 < kTER2) return 0.0f;
  float t1 = std::pow(10.0f, -3.0f * kTStar / kTER3);
  float t2 = std::pow(10.0f, -3.0f * kTStar / rt60);
  float t3 = std::pow(10.0f, -3.0f * kTStar / kTER2);
  return gain - gain * (t1 - t2) / (t1 - t3);
}

float DirectivityGain(int pattern, const float d[2], const float f[2]) {
  if (pattern != 1) return 1.0f;  // omni
  float card = (1.0f + d[0] * f[0] + d[1] * f[1]) * 0.5f;
  return card > kMinDryGain ? card : kMinDryGain;  // PvDSPContext.cpp:236-242
}

struct Context {
  int max_frames;
  float smoothing;
  float fs;
  int spatialize;
  float wet_ratio;
  // buses[front][bus][frame][ch]
  std::vector<float> buses[2];
  int front = 0;
  float listener_pos[3] = {0, 0, 0};
  float listener_fwd[3] = {1, 0, 0};
  std::unordered_map<int64_t, EmissionParams> current, target;
  std::unordered_map<int64_t, LowpassState> lpf;
  std::vector<float> mono;

  float* bus(int which) { return buses[front].data() + which * max_frames * 2; }
};

}  // namespace

extern "C" {

void* pvdsp_init(int max_callback_length, float dsp_smoothing_factor,
                 float sampling_rate, int use_spatialization,
                 float wet_gain_ratio) {
  auto* c = new Context();
  c->max_frames = max_callback_length;
  c->smoothing = dsp_smoothing_factor;
  c->fs = sampling_rate;
  c->spatialize = use_spatialization;
  c->wet_ratio = wet_gain_ratio;
  c->buses[0].assign(4 * max_callback_length * 2, 0.0f);
  c->buses[1].assign(4 * max_callback_length * 2, 0.0f);
  c->mono.assign(max_callback_length, 0.0f);
  return c;
}

void pvdsp_exit(void* h) { delete static_cast<Context*>(h); }

void pvdsp_set_listener_transform(void* h, float px, float py, float pz,
                                  float fx, float fy, float fz) {
  auto* c = static_cast<Context*>(h);
  c->listener_pos[0] = px; c->listener_pos[1] = py; c->listener_pos[2] = pz;
  c->listener_fwd[0] = fx; c->listener_fwd[1] = fy; c->listener_fwd[2] = fz;
}

void pvdsp_update_emitter(void* h, int64_t id, float px, float py, float pz,
                          float fx, float fy, float fz) {
  auto* c = static_cast<Context*>(h);
  auto& t = c->target[id];
  t.pos[0] = px; t.pos[1] = pz;  // 2D slice: (x, z), dsp/context.py:85-88
  t.fwd[0] = fx; t.fwd[1] = fz;
  (void)py; (void)fy;
}

void pvdsp_set_emitter_directivity_pattern(void* h, int64_t id, int pattern) {
  static_cast<Context*>(h)->target[id].pattern = pattern;
}

void pvdsp_remove_emitter(void* h, int64_t id) {
  auto* c = static_cast<Context*>(h);
  c->current.erase(id);
  c->target.erase(id);
  c->lpf.erase(id);
}

// Returns 0 if processed, 1 if rejected/ignored.
int pvdsp_submit_source(void* h, int64_t id, float occlusion, float wet_gain,
                        float rt60, float lowpass, float dirx, float diry,
                        float sdirx, float sdiry, const float* audio,
                        int frames, int channels) {
  auto* c = static_cast<Context*>(h);
  if (frames <= 0 || frames > c->max_frames) return 1;
  // input rejection (PvDSPContext.cpp:258-263), extended with finiteness:
  // NaN passes every range comparison and would poison the shared buses
  if (lowpass < kMinFreq || lowpass > kMaxFreq || occlusion <= 0.0f ||
      (dirx == 0.0f && diry == 0.0f)) {
    return 1;
  }
  if (!(std::isfinite(occlusion) && std::isfinite(wet_gain) &&
        std::isfinite(rt60) && std::isfinite(lowpass) &&
        std::isfinite(dirx) && std::isfinite(diry) &&
        std::isfinite(sdirx) && std::isfinite(sdiry))) {
    return 1;
  }
  const int n = frames;
  auto& cur = c->current[id];
  auto& tgt = c->target[id];
  auto& lp = c->lpf[id];

  // update targets from this submission (PvDSPContext.cpp:277-287)
  tgt.occlusion = occlusion;
  tgt.wet_gain = wet_gain;
  tgt.rt60 = rt60;
  tgt.lowpass = lowpass;
  tgt.dir[0] = dirx; tgt.dir[1] = diry;
  tgt.sdir[0] = sdirx; tgt.sdir[1] = sdiry;

  const float factor = 1.0f / (n * c->smoothing);

  // wet-bus gains from current & target (PvDSPContext.cpp:268-296)
  const float tg[3] = {FindGainA(tgt.rt60, tgt.wet_gain),
                       FindGainB(tgt.rt60, tgt.wet_gain),
                       FindGainC(tgt.rt60, tgt.wet_gain)};
  const float cg[3] = {FindGainA(cur.rt60, cur.wet_gain),
                       FindGainB(cur.rt60, cur.wet_gain),
                       FindGainC(cur.rt60, cur.wet_gain)};

  // pan gains (PvDSPContext.cpp:294-318)
  float t_l = 1.0f, t_r = 1.0f, c_l = 1.0f, c_r = 1.0f;
  if (c->spatialize) {
    const float angle = std::atan2(c->listener_fwd[2], c->listener_fwd[0]);
    float theta = (angle - std::atan2(tgt.dir[1], tgt.dir[0])) * 0.5f;
    t_l = kInvSqrt2 * (std::cos(theta) - std::sin(theta));
    t_r = kInvSqrt2 * (std::cos(theta) + std::sin(theta));
    theta = (angle - std::atan2(cur.dir[1], cur.dir[0])) * 0.5f;
    c_l = kInvSqrt2 * (std::cos(theta) - std::sin(theta));
    c_r = kInvSqrt2 * (std::cos(theta) + std::sin(theta));
  }

  // directivity: current map's pattern, target forward (dsp/context.py:153-160)
  const float t_dir = DirectivityGain(cur.pattern, tgt.sdir, tgt.fwd);
  const float c_dir = DirectivityGain(cur.pattern, cur.sdir, tgt.fwd);

  // 1/r distance attenuation, 1 m floor (PvDSPContext.cpp:321-337)
  const float lx = c->listener_pos[0], lz = c->listener_pos[2];
  auto dist_gain = [&](const float p[2]) {
    float dx = lx - p[0], dz = lz - p[1];
    float d = std::sqrt(dx * dx + dz * dz);
    return 1.0f / (d > 1.0f ? d : 1.0f);
  };
  const float t_dist = dist_gain(tgt.pos);
  const float c_dist = dist_gain(cur.pos);

  const float t_dry = tgt.occlusion > kMinDryGain ? tgt.occlusion : kMinDryGain;
  const float c_dry = cur.occlusion;

  // mono mixdown (PvDSPContext.cpp:343-350)
  float* mono = c->mono.data();
  if (channels == 1) {
    std::memcpy(mono, audio, n * sizeof(float));
  } else {
    for (int i = 0; i < n; ++i)
      mono[i] = (audio[i * channels] + audio[i * channels + 1]) * 0.5f;
  }

  // Butterworth LPF in place, coefficients from target cutoff (Lowpass.h:14-26)
  {
    const float t = 2.0f * kPi * tgt.lowpass / c->fs;
    const float y = 1.0f / (1.0f + kSqrt2 * t + t * t);
    const float cx = t * t * y;
    const float cy1 = (2.0f + kSqrt2 * t) * y;
    const float cy2 = -1.0f * y;
    float y1 = lp.y1, y2 = lp.y2;
    for (int i = 0; i < n; ++i) {
      const float v = cx * mono[i] + cy1 * y1 + cy2 * y2;
      mono[i] = v;
      y2 = y1;
      y1 = v;
    }
    lp.y1 = y1; lp.y2 = y2;
  }

  // per-sample lerped gain ramps (LERP_FLOAT recursion, PvDSPDefinitions.h)
  auto lerp = [factor](float& g, float target) {
    const float used = g;
    g = g * (1.0f - factor) + target * factor;
    return used;
  };

  float* dry_bus = c->bus(0);
  float* wetA = c->bus(1);
  float* wetB = c->bus(2);
  float* wetC = c->bus(3);
  float ga = cg[0], gb = cg[1], gc = cg[2];
  float dry = c_dry, dgain = c_dir, dist = c_dist, gl = c_l, gr = c_r;
  const float ratio = c->wet_ratio;
  for (int i = 0; i < n; ++i) {
    const float m = mono[i];
    wetA[i * 2] += m * ga * ratio;
    wetA[i * 2 + 1] += m * ga * ratio;
    wetB[i * 2] += m * gb * ratio;
    wetB[i * 2 + 1] += m * gb * ratio;
    wetC[i * 2] += m * gc * ratio;
    wetC[i * 2 + 1] += m * gc * ratio;
    const float d = m * lerp(dry, t_dry) * lerp(dgain, t_dir) *
                    lerp(dist, t_dist);
    dry_bus[i * 2] += d * lerp(gl, t_l);
    dry_bus[i * 2 + 1] += d * lerp(gr, t_r);
    lerp(ga, tg[0]);
    lerp(gb, tg[1]);
    lerp(gc, tg[2]);
  }

  // settle current params toward targets (PvDSPContext.cpp:407-424)
  const float decay = std::pow(1.0f - factor, static_cast<float>(n));
  auto settle = [decay](float cv, float tv) { return tv + (cv - tv) * decay; };
  cur.occlusion = dry;  // post-loop ramp state
  cur.wet_gain = settle(cur.wet_gain, tgt.wet_gain);
  cur.rt60 = settle(cur.rt60, tgt.rt60);
  for (int k = 0; k < 2; ++k) {
    cur.dir[k] = settle(cur.dir[k], tgt.dir[k]);
    cur.fwd[k] = settle(cur.fwd[k], tgt.fwd[k]);
    cur.sdir[k] = settle(cur.sdir[k], tgt.sdir[k]);
    cur.pos[k] = settle(cur.pos[k], tgt.pos[k]);
  }
  cur.lowpass = tgt.lowpass;
  cur.pattern = tgt.pattern;
  return 0;
}

// Returns pointers to the four rendered buses ([max_frames][2] interleaved)
// and swaps/zeroes the back buffers (PvDSPContext.cpp:427-452).
void pvdsp_get_output(void* h, const float** dry, const float** wet_a,
                      const float** wet_b, const float** wet_c) {
  auto* c = static_cast<Context*>(h);
  *dry = c->bus(0);
  *wet_a = c->bus(1);
  *wet_b = c->bus(2);
  *wet_c = c->bus(3);
  c->front ^= 1;
  std::memset(c->buses[c->front].data(), 0,
              c->buses[c->front].size() * sizeof(float));
}

int pvdsp_version() { return 1; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Schroeder reverberator — completes the reference's unshipped Reverb.h
// design (4 parallel lowpass-comb at 29.7/37.1/41.1/43.7 ms + 2 series
// allpass at 5.0/1.7 ms, Reverb.h:16-24); comb feedback derived from the
// target RT60 (g = 10^(-3 D / rt60)). Math is identical to the JAX batch
// implementation in planeverb/dsp/reverb.py (cross-checked in tests).

namespace {

constexpr float kCombDelaysS[4] = {0.0297f, 0.0371f, 0.0411f, 0.0437f};
constexpr float kAllpassDelaysS[2] = {0.005f, 0.0017f};
constexpr float kAllpassG = 0.5f;
constexpr float kDamping = 0.2f;

struct ReverbChannel {
  std::vector<float> comb_buf[4];
  float comb_lp[4] = {0, 0, 0, 0};
  std::vector<float> ap_buf[2];
};

struct Reverb {
  int comb_delay[4];
  float comb_fb[4];
  int ap_delay[2];
  int lc;  // shared comb buffer length (max delay)
  int la;
  int64_t pos = 0;
  std::vector<ReverbChannel> ch;
};

}  // namespace

extern "C" {

void* pvrev_init(float rt60, float sample_rate, int channels) {
  auto* r = new Reverb();
  r->lc = 1;
  for (int k = 0; k < 4; ++k) {
    r->comb_delay[k] = static_cast<int>(kCombDelaysS[k] * sample_rate);
    if (r->comb_delay[k] < 1) r->comb_delay[k] = 1;
    if (r->comb_delay[k] > r->lc) r->lc = r->comb_delay[k];
    float d = static_cast<float>(r->comb_delay[k]) / sample_rate;
    float rt = rt60 > 1e-3f ? rt60 : 1e-3f;
    r->comb_fb[k] = std::pow(10.0f, -3.0f * d / rt);
  }
  r->la = 1;
  for (int k = 0; k < 2; ++k) {
    r->ap_delay[k] = static_cast<int>(kAllpassDelaysS[k] * sample_rate);
    if (r->ap_delay[k] < 1) r->ap_delay[k] = 1;
    if (r->ap_delay[k] > r->la) r->la = r->ap_delay[k];
  }
  r->ch.resize(channels);
  for (auto& c : r->ch) {
    for (int k = 0; k < 4; ++k) c.comb_buf[k].assign(r->lc, 0.0f);
    for (int k = 0; k < 2; ++k) c.ap_buf[k].assign(r->la, 0.0f);
  }
  return r;
}

void pvrev_exit(void* h) { delete static_cast<Reverb*>(h); }

// in/out: interleaved [frames][channels]; out is *added to* (mix-in).
void pvrev_process_add(void* h, const float* in, float* out, int frames) {
  auto* r = static_cast<Reverb*>(h);
  const int nch = static_cast<int>(r->ch.size());
  for (int i = 0; i < frames; ++i) {
    const int64_t pos = r->pos + i;
    const int wr_c = static_cast<int>(pos % r->lc);
    const int wr_a = static_cast<int>(pos % r->la);
    for (int c = 0; c < nch; ++c) {
      auto& st = r->ch[c];
      const float x = in[i * nch + c];
      float comb_out = 0.0f;
      for (int k = 0; k < 4; ++k) {
        const int rd =
            static_cast<int>(((pos - r->comb_delay[k]) % r->lc + r->lc) %
                             r->lc);
        const float y = st.comb_buf[k][rd];
        st.comb_lp[k] = y * (1.0f - kDamping) + st.comb_lp[k] * kDamping;
        st.comb_buf[k][wr_c] = x + st.comb_lp[k] * r->comb_fb[k];
        comb_out += y;
      }
      float s = comb_out * 0.25f;
      for (int k = 0; k < 2; ++k) {
        const int rd =
            static_cast<int>(((pos - r->ap_delay[k]) % r->la + r->la) %
                             r->la);
        const float buf_out = st.ap_buf[k][rd];
        st.ap_buf[k][wr_a] = s + buf_out * kAllpassG;
        s = buf_out - kAllpassG * s;
      }
      out[i * nch + c] += s;
    }
  }
  r->pos += frames;
}

}  // extern "C"
