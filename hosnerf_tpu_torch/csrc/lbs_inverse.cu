// Inverse linear blend skinning over liveness-sorted samples, forward and
// backward, for Hopper.
//
// Replaces: hosnerf_tpu/ops/pallas/lbs.py::inverse_core_pg_s, forward (the
// Pallas kernel _pg_fwd_kernel, launched from _pg_s_fwd) and backward
// (_pg_bwd_kernel, launched from _pg_bwd_kernel_run).
//
//   acc[n] = (sum_b w_b(f_b) * f_b, sum_b w_b(f_b)),  f_b = Rg_b p_n + Tg_b
//
// where w_b is the trilinear sample of bone b's G^3 weight volume at grid
// coordinate f_b (zeros padding, align_corners), all in grid coordinates.
//
// Design. The TPU kernels build one-hot tap rows and contract them on the
// MXU, pack 128/G bones on the vector lanes and walk a compacted
// (tile, bone-quad) pair table so dead pairs cost nothing. None of that
// feeds Hopper: here one thread owns one sample, the B affines sit in
// shared memory, and for each bone the thread tests the support
// f in (-1-eps, G+eps)^3 and skips the bone when it fails (the per-(sample,
// bone) early-out that takes the place of the pair table; the liveness sort
// keeps neighbouring threads on the same bones, so warps diverge little).
// A live bone costs one 8-tap gather. Dead samples skip every bone: the
// forward writes exact zeros, the backward adds nothing (as the skipped
// TPU pairs, whose gradients are exactly zero).
//
// Backward. The per-sample outputs (dpts) are plain stores. The sums over
// samples go two ways: dvol [B, G*G, G] (3.4 MB f32) is far too large for
// shared memory and its taps scatter, so each nonzero tap contribution is
// one atomicAdd into device memory (L2-resident); dRg/dTg (B x 12 values,
// hit by every live sample) are reduced first across the warp with
// shuffles (a warp skips a bone no lane supports), then per CTA in shared
// memory, and land with one atomicAdd per CTA and entry.
//
// Bound. ~0.5 KFLOP per sample is nothing for the card; the cost is the
// dependent gathers: 8 scattered 2- or 4-byte loads per live (sample, bone)
// from a volume of 1.7 MB (bf16) or 3.4 MB (f32) that stays resident in the
// 50 MB L2, and in the backward as many atomics. So both kernels are bound
// by L2 latency and throughput; the design keeps every gather and atomic on
// the L2-resident volume and touches each sample's row once.
//
// Numerics. Every sum and product uses explicit round-to-nearest
// intrinsics (no FMA contraction), in the order of the plain versions
// hosnerf_tpu_torch/ops/cuda/lbs.py::inverse_core_plain and
// inverse_core_bwd_plain. vol_bf16 = 1 reproduces the TPU kernels' bf16
// matmul semantics: the xy tap products hx*hy, dhat(fx)*hy, hx*dhat(fy),
// the volume and the dvol factor gw*hz are rounded to bf16; every sum is
// f32. vol_bf16 = 0 is f32 throughout. The forward agrees with its plain
// version bit for bit; the backward's sums over samples differ in order.

#include "lbs_common.cuh"

namespace {

using namespace hosnerf;

constexpr int kThreads = 256;

template <typename VT>
__global__ void __launch_bounds__(kThreads)
inverse_lbs_kernel(const float* __restrict__ pts, const float* __restrict__ rg,
                   const float* __restrict__ tg, const VT* __restrict__ vol,
                   float4* __restrict__ out, int n, int B, int G, float eps) {
  __shared__ float s_r[kMaxBones * 9];
  __shared__ float s_t[kMaxBones * 3];
  for (int i = threadIdx.x; i < B * 9; i += blockDim.x) s_r[i] = rg[i];
  for (int i = threadIdx.x; i < B * 3; i += blockDim.x) s_t[i] = tg[i];
  __syncthreads();

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float x = pts[3 * row], y = pts[3 * row + 1], z = pts[3 * row + 2];
  const float lo = -1.0f - eps, hi = (float)G + eps;
  float ax = 0.f, ay = 0.f, az = 0.f, aw = 0.f;

  for (int b = 0; b < B; ++b) {
    const float fx = affine(x, y, z, s_r + 9 * b, s_t[3 * b]);
    const float fy = affine(x, y, z, s_r + 9 * b + 3, s_t[3 * b + 1]);
    const float fz = affine(x, y, z, s_r + 9 * b + 6, s_t[3 * b + 2]);
    if (!(fx > lo && fx < hi && fy > lo && fy < hi && fz > lo && fz < hi))
      continue;
    const Taps tx = make_taps(fx, G), ty = make_taps(fy, G),
               tz = make_taps(fz, G);
    const VT* vb = vol + (size_t)b * G * G * G;
    float zc0 = 0.f, zc1 = 0.f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        if (!(tx.v[dx] && ty.v[dy])) continue;
        const float w = round_tap(__fmul_rn(tx.h[dx], ty.h[dy]), vol);
        const int base = (tx.i[dx] * G + ty.i[dy]) * G;
        if (tz.v[0]) zc0 = __fadd_rn(zc0, __fmul_rn(w, load_vol(vb, base + tz.i[0])));
        if (tz.v[1]) zc1 = __fadd_rn(zc1, __fmul_rn(w, load_vol(vb, base + tz.i[1])));
      }
    }
    const float wb = __fadd_rn(__fmul_rn(tz.h[0], zc0), __fmul_rn(tz.h[1], zc1));
    ax = __fadd_rn(ax, __fmul_rn(wb, fx));
    ay = __fadd_rn(ay, __fmul_rn(wb, fy));
    az = __fadd_rn(az, __fmul_rn(wb, fz));
    aw = __fadd_rn(aw, wb);
  }
  out[row] = make_float4(ax, ay, az, aw);
}

// Backward. drt [B, 12] = (dRg[b] row-major [c][k], dTg[b][c]); drt and dvol
// must be zeroed by the caller. dpts is written for every row < n.
template <typename VT>
__global__ void __launch_bounds__(kThreads)
inverse_lbs_bwd_kernel(const float* __restrict__ pts,
                       const float* __restrict__ rg,
                       const float* __restrict__ tg,
                       const VT* __restrict__ vol,
                       const float4* __restrict__ gacc,
                       float* __restrict__ dpts, float* __restrict__ drt,
                       float* __restrict__ dvol, int n, int B, int G,
                       float eps) {
  __shared__ float s_r[kMaxBones * 9];
  __shared__ float s_t[kMaxBones * 3];
  __shared__ float s_d[kMaxBones * 12];
  for (int i = threadIdx.x; i < B * 9; i += blockDim.x) s_r[i] = rg[i];
  for (int i = threadIdx.x; i < B * 3; i += blockDim.x) s_t[i] = tg[i];
  for (int i = threadIdx.x; i < B * 12; i += blockDim.x) s_d[i] = 0.f;
  __syncthreads();

  // every lane of every warp runs the bone loop (the warp reductions need
  // them all); rows past n are never live
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = row < n;
  float x = 0.f, y = 0.f, z = 0.f;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (in) {
    x = pts[3 * row];
    y = pts[3 * row + 1];
    z = pts[3 * row + 2];
    g = gacc[row];
  }
  const float lo = -1.0f - eps, hi = (float)G + eps;
  const int lane = threadIdx.x & 31;
  const size_t G3 = (size_t)G * G * G;
  float dpx = 0.f, dpy = 0.f, dpz = 0.f;

  for (int b = 0; b < B; ++b) {
    const float* r = s_r + 9 * b;
    const float fx = affine(x, y, z, r, s_t[3 * b]);
    const float fy = affine(x, y, z, r + 3, s_t[3 * b + 1]);
    const float fz = affine(x, y, z, r + 6, s_t[3 * b + 2]);
    const bool live = in && fx > lo && fx < hi && fy > lo && fy < hi &&
                      fz > lo && fz < hi;
    if (!__any_sync(kFullMask, live)) continue;
    float d[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) d[j] = 0.f;
    if (live) {
      const Taps tx = make_taps(fx, G), ty = make_taps(fy, G),
                 tz = make_taps(fz, G);
      const float dh[2] = {-1.f, 1.f};
      const float gw = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(g.x, fx), __fmul_rn(g.y, fy)),
                    __fmul_rn(g.z, fz)), g.w);
      const float gz0 = round_tap(__fmul_rn(gw, tz.h[0]), vol);
      const float gz1 = round_tap(__fmul_rn(gw, tz.h[1]), vol);
      const VT* vb = vol + b * G3;
      float* db = dvol + b * G3;
      float zc0 = 0.f, zc1 = 0.f, m20 = 0.f, m21 = 0.f, m30 = 0.f, m31 = 0.f;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          if (!(tx.v[dx] && ty.v[dy])) continue;
          const float w = round_tap(__fmul_rn(tx.h[dx], ty.h[dy]), vol);
          const float wdx = round_tap(__fmul_rn(dh[dx], ty.h[dy]), vol);
          const float wdy = round_tap(__fmul_rn(tx.h[dx], dh[dy]), vol);
          const int base = (tx.i[dx] * G + ty.i[dy]) * G;
          if (tz.v[0]) {
            const float v = load_vol(vb, base + tz.i[0]);
            zc0 = __fadd_rn(zc0, __fmul_rn(w, v));
            m20 = __fadd_rn(m20, __fmul_rn(wdx, v));
            m30 = __fadd_rn(m30, __fmul_rn(wdy, v));
            const float dv = __fmul_rn(w, gz0);
            if (dv != 0.f) atomicAdd(db + base + tz.i[0], dv);
          }
          if (tz.v[1]) {
            const float v = load_vol(vb, base + tz.i[1]);
            zc1 = __fadd_rn(zc1, __fmul_rn(w, v));
            m21 = __fadd_rn(m21, __fmul_rn(wdx, v));
            m31 = __fadd_rn(m31, __fmul_rn(wdy, v));
            const float dv = __fmul_rn(w, gz1);
            if (dv != 0.f) atomicAdd(db + base + tz.i[1], dv);
          }
        }
      }
      const float hz0 = tz.h[0], hz1 = tz.h[1];
      const float wb = __fadd_rn(__fmul_rn(hz0, zc0), __fmul_rn(hz1, zc1));
      const float df[3] = {
          __fadd_rn(__fmul_rn(g.x, wb),
                    __fmul_rn(gw, __fadd_rn(__fmul_rn(m20, hz0),
                                            __fmul_rn(m21, hz1)))),
          __fadd_rn(__fmul_rn(g.y, wb),
                    __fmul_rn(gw, __fadd_rn(__fmul_rn(m30, hz0),
                                            __fmul_rn(m31, hz1)))),
          __fadd_rn(__fmul_rn(g.z, wb),
                    __fmul_rn(gw, __fadd_rn(__fmul_rn(-1.f, zc0), zc1)))};
      const float p[3] = {x, y, z};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int k = 0; k < 3; ++k) d[3 * c + k] = __fmul_rn(df[c], p[k]);
        d[9 + c] = df[c];
      }
      dpx = __fadd_rn(dpx, __fadd_rn(__fadd_rn(__fmul_rn(df[0], r[0]),
                                               __fmul_rn(df[1], r[3])),
                                     __fmul_rn(df[2], r[6])));
      dpy = __fadd_rn(dpy, __fadd_rn(__fadd_rn(__fmul_rn(df[0], r[1]),
                                               __fmul_rn(df[1], r[4])),
                                     __fmul_rn(df[2], r[7])));
      dpz = __fadd_rn(dpz, __fadd_rn(__fadd_rn(__fmul_rn(df[0], r[2]),
                                               __fmul_rn(df[1], r[5])),
                                     __fmul_rn(df[2], r[8])));
    }
#pragma unroll
    for (int j = 0; j < 12; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d[j] += __shfl_xor_sync(kFullMask, d[j], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < 12; ++j) atomicAdd(s_d + 12 * b + j, d[j]);
    }
  }
  if (in) {
    dpts[3 * row] = dpx;
    dpts[3 * row + 1] = dpy;
    dpts[3 * row + 2] = dpz;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B * 12; i += blockDim.x)
    if (s_d[i] != 0.f) atomicAdd(drt + i, s_d[i]);
}

}  // namespace

extern "C" {

const char* hosnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pts [n, 3] f32; rg [B, 9] f32; tg [B, 3] f32; vol [B, G*G, G] (bf16 when
// vol_bf16, else f32); out [n, 4] f32. Launches on `stream`, returns
// cudaGetLastError().
int hosnerf_inverse_lbs(const float* pts, const float* rg, const float* tg,
                        const void* vol, float* out, int n, int B, int G,
                        int vol_bf16, float eps, void* stream) {
  if (n <= 0) return 0;
  if (B < 1 || B > kMaxBones) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vol_bf16) {
    inverse_lbs_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        pts, rg, tg, static_cast<const __nv_bfloat16*>(vol),
        reinterpret_cast<float4*>(out), n, B, G, eps);
  } else {
    inverse_lbs_kernel<float><<<grid, kThreads, 0, s>>>(
        pts, rg, tg, static_cast<const float*>(vol),
        reinterpret_cast<float4*>(out), n, B, G, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: gacc [n, 4] f32 in; dpts [n, 3] f32 out (every row written);
// drt [B, 12] f32 (dRg row-major, then dTg) and dvol [B, G*G, G] f32
// accumulated, zeroed by the caller. Returns cudaGetLastError().
int hosnerf_inverse_lbs_bwd(const float* pts, const float* rg,
                            const float* tg, const void* vol,
                            const float* gacc, float* dpts, float* drt,
                            float* dvol, int n, int B, int G, int vol_bf16,
                            float eps, void* stream) {
  if (n <= 0) return 0;
  if (B < 1 || B > kMaxBones) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* g = reinterpret_cast<const float4*>(gacc);
  if (vol_bf16) {
    inverse_lbs_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        pts, rg, tg, static_cast<const __nv_bfloat16*>(vol), g, dpts, drt,
        dvol, n, B, G, eps);
  } else {
    inverse_lbs_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        pts, rg, tg, static_cast<const float*>(vol), g, dpts, drt, dvol, n,
        B, G, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
