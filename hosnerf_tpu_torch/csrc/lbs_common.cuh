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

// bf16 rounding of a tap product when the volume is bf16 (the TPU kernels'
// bf16 matmul operand cast); identity in f32.
__device__ __forceinline__ float round_tap(float w, const float*) {
  return w;
}

__device__ __forceinline__ float round_tap(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// f_c = ((x r0 + y r1) + z r2) + t, without contraction.
__device__ __forceinline__ float affine(float x, float y, float z,
                                        const float* r, float t) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, r[0]), __fmul_rn(y, r[1])),
                             __fmul_rn(z, r[2])), t);
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
