// Per-example GLM loss families shared by the glm_stats (K1) and
// alpha_search (K4) kernels.
//
// The formulas follow the Pallas bodies of src/repro/kernels/glm_stats.py
// (_logistic, _squared, _probit, _poisson): the probit log-CDF goes through
// erfc with an asymptotic tail for t < -12, and the poisson curvature is
// clipped at 1e6 (POISSON_W_CLIP).  The logistic forms are the stable ones:
// log(1 + e^-t) = max(-t, 0) + log1p(e^-|t|), and sigma(-t) is formed from
// e^-|t| <= 1 so it never overflows.
#pragma once

#include <cuda_runtime.h>

namespace repro {

enum Family : int { kLogistic = 0, kSquared = 1, kProbit = 2, kPoisson = 3 };

constexpr float kPoissonWClip = 1e6f;
constexpr float kSqrt2 = 1.4142135623730951f;
constexpr float kLogSqrt2Pi = 0.9189385332046727f;

template <int F>
struct Stats;

template <>
struct Stats<kLogistic> {
  __device__ static float loss(float y, float m) {
    float t = y * m;
    return fmaxf(-t, 0.f) + log1pf(expf(-fabsf(t)));
  }
  __device__ static void all(float y, float m, float& l, float& s, float& w) {
    float t = y * m;
    float e = expf(-fabsf(t));
    l = fmaxf(-t, 0.f) + log1pf(e);
    float sig = t >= 0.f ? e / (1.f + e) : 1.f / (1.f + e);  // sigma(-t)
    s = y * sig;
    w = sig * (1.f - sig);
  }
};

template <>
struct Stats<kSquared> {
  __device__ static float loss(float y, float m) {
    float r = y - m;
    return 0.5f * r * r;
  }
  __device__ static void all(float y, float m, float& l, float& s, float& w) {
    float r = y - m;
    l = 0.5f * r * r;
    s = r;
    w = 1.f;
  }
};

template <>
struct Stats<kProbit> {
  __device__ static float log_cdf(float t) {
    // the Pallas body floors Phi at 1e-300, which is 0 in float32; the tail
    // branch replaces every value where erfc underflows
    float lc = logf(fmaxf(0.5f * erfcf(-t / kSqrt2), 0.f));
    float tail = -0.5f * t * t - kLogSqrt2Pi - logf(fmaxf(-t, 1.f));
    return t < -12.f ? tail : lc;
  }
  __device__ static float loss(float y, float m) { return -log_cdf(y * m); }
  __device__ static void all(float y, float m, float& l, float& s, float& w) {
    float t = y * m;
    float lc = log_cdf(t);
    float log_pdf = -0.5f * t * t - kLogSqrt2Pi;
    float ratio = expf(log_pdf - lc);
    l = -lc;
    s = y * ratio;
    w = fmaxf(ratio * (ratio + t), 0.f);
  }
};

template <>
struct Stats<kPoisson> {
  __device__ static float loss(float y, float m) { return expf(m) - y * m; }
  __device__ static void all(float y, float m, float& l, float& s, float& w) {
    float mu = expf(m);
    l = mu - y * m;
    s = y - mu;
    w = fminf(mu, kPoissonWClip);
  }
};

}  // namespace repro
