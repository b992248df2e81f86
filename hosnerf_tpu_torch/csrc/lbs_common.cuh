// Trilinear tap helpers shared by the LBS kernels (lbs_inverse.cu,
// lbs_forward.cu).
//
// A tap is one of the two grid lines around a fractional grid coordinate
// f: i = floor(f) + d, d in {0, 1}, with hat weight h = max(0, 1 - |f - i|)
// and derivative dh = -1 (d = 0) or +1 (d = 1), the reference's floor-based
// derivative. Taps outside [0, G-1] do not exist (zeros padding). Every sum
// and product uses explicit round-to-nearest intrinsics (no FMA
// contraction), in the order of the plain versions in
// hosnerf_tpu_torch/ops/cuda/lbs.py.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace hosnerf {

constexpr int kMaxBones = 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_vol(const float* v, int i) {
  return __ldg(v + i);
}

__device__ __forceinline__ float load_vol(const __nv_bfloat16* v, int i) {
  return __bfloat162float(v[i]);
}

// A volume element as f32, and an f32 as an image element (bf16 rounds to
// nearest even, as torch's cast).
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// bf16 rounding of a tap product when the volume is bf16 (the TPU kernels'
// bf16 matmul operand cast); identity in f32.
__device__ __forceinline__ float round_tap(float w, const float*) {
  return w;
}

__device__ __forceinline__ float round_tap(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

struct Taps {
  float h[2];   // hat weights
  int i[2];     // grid index (valid only where v)
  bool v[2];    // tap inside [0, G-1]
};

__device__ __forceinline__ Taps make_taps(float f, int G) {
  Taps t;
  const float f0 = floorf(f), gmax = (float)(G - 1);
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float c = __fadd_rn(f0, (float)d);
    t.h[d] = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(f, c))));
    t.v[d] = c >= 0.f && c <= gmax;
    t.i[d] = t.v[d] ? (int)c : 0;
  }
  return t;
}

// k0 (a device int, in blocks of `tile` rows) clamped to [0, n_blocks - 1];
// the first row a live-suffix launch computes.
__device__ __forceinline__ int first_live_row(const int* k0_p, int n,
                                              int tile) {
  const int n_blocks = (n + tile - 1) / tile;
  int k0 = *k0_p;
  k0 = k0 > n_blocks - 1 ? n_blocks - 1 : k0;
  k0 = k0 < 0 ? 0 : k0;
  return k0 * tile;
}

}  // namespace hosnerf
