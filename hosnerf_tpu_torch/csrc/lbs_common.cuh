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
#include <math.h>

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

// The same rounding of a value computed in f64, done once: to f32 (round to
// nearest), or to bf16 straight from f64 (keep the 8 leading significand
// bits, round to nearest, ties to even; rounding through f32 first could
// round twice). A result no summation order can move.
__device__ __forceinline__ float round_exact(double x, const float*) {
  return __double2float_rn(x);
}

__device__ __forceinline__ float round_exact(double x,
                                             const __nv_bfloat16*) {
  unsigned long long b = static_cast<unsigned long long>(
      __double_as_longlong(x));
  b = (b + 0x0FFFFFFFFFFFull + ((b >> 45) & 1ull)) & ~0x1FFFFFFFFFFFull;
  return __double2float_rn(__longlong_as_double(static_cast<long long>(b)));
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

// ---------------------------------------------------------------------------
// Sums over samples whose order does not depend on the schedule.
// ---------------------------------------------------------------------------
//
// Fixed point (dvol of the LBS backwards). Each f32 share v is added to an
// int64 accumulator as round(v 2^e); integer addition is exact, so the
// total is the same in any order, and it is converted to f32 once:
// float(total 2^-e). e comes from a bound computed on the device: every
// share satisfies |v| <= M * factor (M the largest |input gradient| entry
// of the call, read as the bits of a non-negative float, so an integer
// atomicMax finds it in any order; factor from the kernel's arithmetic),
// and an accumulator takes at most `count` shares. e is the largest
// integer with count M factor 2^e < 2^62 (at most 126, so that 2^e is an
// f32 and v 2^e an exact f32 product), so the sum of the rounded shares
// stays below count (M factor 2^e + 1/2) < 2^62 + 2^31 < 2^63: no
// overflow whatever the order. Each share is rounded to within 2^-e-1,
// 2^-62 of the accumulator's range; ops/cuda/lbs.py::fixed_point_exponent
// is the same choice in Python (tests/test_torch_lbs_inverse.py). A
// non-finite M gives NaN outputs, as an f32 sum of such shares would.
struct FixedScale {
  float scale;   // 2^e
  double inv;    // 2^-e
  bool ok;       // M finite
};

__device__ __forceinline__ FixedScale fixed_scale(unsigned m_bits,
                                                  double factor,
                                                  double count) {
  FixedScale f;
  f.ok = m_bits < 0x7f800000u;
  const double t = (double)__uint_as_float(f.ok ? m_bits : 0u) * factor *
                   count;
  int ex = 0;
  frexp(t, &ex);   // t < 2^ex (ex = 0 for t = 0)
  const int e = 62 - ex < 126 ? 62 - ex : 126;
  f.scale = ldexpf(1.f, e);
  f.inv = ldexp(1.0, -e);
  return f;
}

// round(v 2^e) as an int64 (two's complement bits)
__device__ __forceinline__ unsigned long long fixed_of(float v, float scale) {
  return static_cast<unsigned long long>(__float2ll_rn(v * scale));
}

// q into a shared-memory accumulator held as two 32-bit words (lo, hi) =
// acc[0], acc[1]: the low word takes a native 32-bit atomic, whose old
// value gives the carry, and the high word its part and the carry when
// they do not cancel (a small q of either sign: one atomic). Each call
// adds exactly q mod 2^64, so the pair ends at the exact total in any
// order.
__device__ __forceinline__ void fixed_add_shared(unsigned* acc,
                                                 unsigned long long q) {
  const unsigned lo = static_cast<unsigned>(q);
  const unsigned old = atomicAdd(acc, lo);
  const unsigned hi = static_cast<unsigned>(q >> 32) + (old + lo < old);
  if (hi) atomicAdd(acc + 1, hi);
}

__device__ __forceinline__ unsigned long long fixed_pair(const unsigned* acc) {
  return (static_cast<unsigned long long>(acc[1]) << 32) | acc[0];
}

__device__ __forceinline__ float fixed_value(unsigned long long acc,
                                             const FixedScale& f) {
  return f.ok ? __double2float_rn(
                    static_cast<double>(static_cast<long long>(acc)) * f.inv)
              : __int_as_float(0x7fc00000);
}

// |v| as the bits of a non-negative float: their integer order is the
// order of the values, NaN above inf above every finite value.
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// The largest of a full warp's bits into *m (atomicMax: any order).
__device__ __forceinline__ void warp_max_bits(unsigned* m, unsigned b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) b = max(b, __shfl_xor_sync(kFullMask, b, o));
  if ((threadIdx.x & 31) == 0 && b) atomicMax(m, b);
}

// A window of 8 per-corner fixed-point sums moved by d along the axis of
// bit S (4: x, 2: y, 1: z): new corner j takes old corner j + d; corners
// with no old one are 0 (corner k = 4 dx + 2 dy + dz of a grid cell). The
// LBS backwards keep each lane's shares of its current cell's corners in
// such a window, each share rounded on its own (`fixed_of`) and summed
// exactly, and add a corner to memory when the cell moves off it: the
// totals are the exact sums of the rounded shares whatever the rows'
// order or grouping.
template <int S>
__device__ __forceinline__ void shift_corners(unsigned long long (&v)[8],
                                              int d) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j & S) continue;
    const unsigned long long lo = v[j], hi = v[j | S];
    v[j] = d == 0 ? lo : d == 1 ? hi : 0ull;
    v[j | S] = d == 0 ? hi : d == -1 ? lo : 0ull;
  }
}

// Whether old corner k lies outside the cell moved by (dx, dy, dz), i.e.
// its sum must be added before the window shifts.
__device__ __forceinline__ bool corner_leaves(int k, int dx, int dy, int dz) {
  const unsigned ax = (k >> 2) - dx, ay = ((k >> 1) & 1) - dy,
                 az = (k & 1) - dz;
  return (ax | ay | az) > 1u;
}

// Per-CTA slots (dRg/dTg of B4, drmat of B5): CTA s of the backward stores
// entry i of its sums to slots[i nslots_max + s] (each entry's slots
// contiguous). One fold CTA of kFoldThreads per entry, given that entry's
// slots `col`: thread t sums col[t], col[t + kFoldThreads], ... in slot
// order, then the threads' sums meet in a fixed tree (t + h into t, h
// halving). The order depends on nslots alone: every run adds the same
// partials in the same order. Returns the sum in every thread.
constexpr int kFoldThreads = 256;

__device__ __forceinline__ float fold_slot(const float* col, int nslots) {
  __shared__ float s_part[kFoldThreads];
  float s = 0.f;
#pragma unroll 4
  for (int k = threadIdx.x; k < nslots; k += kFoldThreads)
    s = __fadd_rn(s, col[k]);
  s_part[threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int h = kFoldThreads / 2; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h)
      s_part[threadIdx.x] =
          __fadd_rn(s_part[threadIdx.x], s_part[threadIdx.x + h]);
    __syncthreads();
  }
  return s_part[0];
}

}  // namespace hosnerf
