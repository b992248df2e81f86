// Shared-tap LBS for Hopper: the all-bone weights at shared points (forward
// and backward), and the fused forward linear blend skinning (those weights
// blended against K transform sets), forward and backward.
//
// Replaces: hosnerf_tpu/ops/pallas/lbs.py::shared_core (the Pallas kernels
// _shared_fwd_kernel, launched from _shared_fwd, and _shared_bwd_kernel,
// from _shared_bwd) and shared_blend_core, forward (_shared_blend_fwd_kernel,
// launched from _shared_blend_fwd) and backward (_shared_blend_bwd_kernel,
// launched from _shared_blend_bwd).
//
//   w_b(p) = trilinear sample of bone b's weight volume at grid point p
//            (all B bones share the point, hence its taps);
//   shared_core: out[n] = (w_0, .., w_{B-1});
//   shared_blend: A = w rmat [12K];
//            acc_kc = P0 A[12k+4c] + P1 A[+1] + P2 A[+2] + A[+3];
//            out[n] = (acc_0 [3], .., acc_{K-1} [3], sum_b w_b).
//
// Design. The TPU kernels contract [T, G^2] one-hot tap rows with the whole
// [G^2, B*G] volume on the MXU: ~850 k MACs per sample for 208 true taps
// (lbs.py:1775-1778). On Hopper a tap is a gather. The weights kernel runs
// one thread per (sample, bone), so its [n, B] rows are stored coalesced;
// each thread recomputes its sample's 4 xy taps (a few FLOPs) and gathers
// its bone's 8 corners from a copy of the volume relaid [G*G, G, B], where
// the threads of one sample read adjacent bytes. The blend kernel runs one
// thread per sample: it computes the 4 xy taps once and gathers the 2 z taps
// of every bone (8 x 26 loads from a 1.7 MB bf16 volume that stays in L2).
// rmat [B, 12K] sits in shared memory; A and the output stay in registers.
// The backwards run one thread per sample, recompute the taps, then:
//   * drmat = w^T q [B, 12K] (blend) is a sum over samples hit by every
//     sample, so each CTA stages w [T, B] and q [T, 12K] in shared memory,
//     reduces the block's product there and adds it with one atomicAdd per
//     entry;
//   * dvol [G^2, B*G] (3.4 MB f32) cannot live on chip and its taps
//     scatter: each nonzero tap contribution is one atomicAdd into device
//     memory (L2-resident);
//   * dpts is a per-sample store.
// Live suffix (blend only): k0 (a device int, in 512-row blocks) is clamped
// to [0, n_blocks - 1]; rows below k0 * 512 are skipped forward and backward
// and their output rows left unwritten, as the TPU kernel does.
//
// Bound. ~1.5 KFLOP per sample forward, ~4 backward: nothing for the card.
// The cost is 208 dependent L2 gathers per sample (and in the backward 208
// more plus up to 208 atomics), so the kernels are bound by L2 latency and
// throughput and, in the backwards, by the atomics, not by device memory
// (pts in, B or 7 floats out per sample).
//
// Numerics (bf16, `_mm` of the TPU kernels): xy tap products hx*hy and the
// volume rounded to bf16; zc = sum_xy in f32; w_b = sum_z bf16(zc hz);
// A in f32. Backward: gw = bf16(dw) (the `expand` matmul), dvol and U take
// bf16(gw hz); every sum f32. vol_bf16 = 0 is f32 throughout. The order of
// every per-sample sum is the plain versions'
// (hosnerf_tpu_torch/ops/cuda/lbs.py::shared_core_plain,
// shared_core_bwd_plain, shared_blend_plain and shared_blend_bwd_plain),
// without FMA contraction.

#include "lbs_common.cuh"

namespace {

using namespace hosnerf;

constexpr int kTile = 512;        // k0 counts blocks of this many rows
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;

// The 4 shared xy taps of one sample: bf16-rounded weight, volume row
// offset q * B*G, and validity.
struct XYTaps {
  float w[4];
  int qoff[4];
  bool v[4];
};

template <typename VT>
__device__ __forceinline__ XYTaps make_xy(const Taps& tx, const Taps& ty,
                                          int G, int BG, const VT* vol) {
  XYTaps s;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int t = 2 * dx + dy;
      s.v[t] = tx.v[dx] && ty.v[dy];
      s.w[t] = s.v[t] ? round_tap(__fmul_rn(tx.h[dx], ty.h[dy]), vol) : 0.f;
      s.qoff[t] = (ty.i[dy] * G + tx.i[dx]) * BG;
    }
  }
  return s;
}

// zc[dz] = sum_xy w_xy vol[q, b*G + z] for bone b (0 where z is off-grid).
template <typename VT>
__device__ __forceinline__ void bone_zc(const XYTaps& s, const Taps& tz,
                                        const VT* vol, int col0, float* zc,
                                        float v[4][2]) {
  zc[0] = zc[1] = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v[t][0] = v[t][1] = 0.f;
    if (!s.v[t]) continue;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      if (!tz.v[dz]) continue;
      v[t][dz] = load_vol(vol, s.qoff[t] + col0 + tz.i[dz]);
      zc[dz] = __fadd_rn(zc[dz], __fmul_rn(s.w[t], v[t][dz]));
    }
  }
}

// Gradients of one sample's shared-tap weights through their taps: for
// each bone gw_b = bf16(dw_of(b)) (the TPU kernels' `expand` matmul),
// dvol[q_xy, b*G+z] += bf16(hx hy) bf16(gw_b hz) by atomics, and df =
// (dfx, dfy, dfz) with U_xy = sum_{b,z} bf16(gw_b hz) vol,
// dfx = sum_xy dhat(fx) hy U, dfy = sum_xy hx dhat(fy) U,
// dfz = sum_b gw_b sum_z dhat(fz) zc.
template <typename VT, typename DW>
__device__ __forceinline__ void tap_grads(const XYTaps& s, const Taps& tx,
                                          const Taps& ty, const Taps& tz,
                                          const VT* vol, int B, int G,
                                          float* dvol, float* df, DW dw_of) {
  float U[4] = {0.f, 0.f, 0.f, 0.f};
  float dfz = 0.f;
  const float dh[2] = {-1.f, 1.f};
  for (int b = 0; b < B; ++b) {
    const float gw = round_tap(dw_of(b), vol);
    float zc[2], v[4][2];
    bone_zc(s, tz, vol, b * G, zc, v);
    float* dvb = dvol + b * G;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      if (!tz.v[dz]) continue;
      const float d = round_tap(__fmul_rn(gw, tz.h[dz]), vol);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (!s.v[t]) continue;
        const float dv = __fmul_rn(s.w[t], d);
        if (dv != 0.f) atomicAdd(dvb + s.qoff[t] + tz.i[dz], dv);
        U[t] = __fadd_rn(U[t], __fmul_rn(d, v[t][dz]));
      }
      dfz = __fadd_rn(dfz, __fmul_rn(gw, __fmul_rn(dh[dz], zc[dz])));
    }
  }
  float dfx = 0.f, dfy = 0.f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int t = 2 * dx + dy;
      if (!s.v[t]) continue;
      dfx = __fadd_rn(dfx, __fmul_rn(__fmul_rn(dh[dx], ty.h[dy]), U[t]));
      dfy = __fadd_rn(dfy, __fmul_rn(__fmul_rn(tx.h[dx], dh[dy]), U[t]));
    }
  }
  df[0] = dfx;
  df[1] = dfy;
  df[2] = dfz;
}

// Row 7 forward: w [n, B], one thread per (sample, bone). vol_r is the
// volume relaid [G*G, G, B] (bones innermost): tap (q, z) of bone b at
// (q * G + z) * B + b.
template <typename VT>
__global__ void __launch_bounds__(kFwdThreads)
shared_weights_fwd_kernel(const float* __restrict__ pts,
                          const VT* __restrict__ vol_r,
                          float* __restrict__ w, int n, int B, int G) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * B) return;
  const int row = idx / B, b = idx - row * B;
  const float* p = pts + 3 * row;
  const Taps tx = make_taps(p[0], G), ty = make_taps(p[1], G),
             tz = make_taps(p[2], G);
  const XYTaps s = make_xy(tx, ty, G, G * B, vol_r);
  float zc[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!s.v[t]) continue;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      if (!tz.v[dz]) continue;
      const float v = load_vol(vol_r, s.qoff[t] + tz.i[dz] * B + b);
      zc[dz] = __fadd_rn(zc[dz], __fmul_rn(s.w[t], v));
    }
  }
  w[idx] = __fadd_rn(round_tap(__fmul_rn(zc[0], tz.h[0]), vol_r),
                     round_tap(__fmul_rn(zc[1], tz.h[1]), vol_r));
}

// Row 7 backward: dpts [n, 3] stored, dvol [G*G, B*G] accumulated; one
// thread per sample over the volume in its [G*G, B*G] layout.
template <typename VT>
__global__ void __launch_bounds__(kBwdThreads)
shared_weights_bwd_kernel(const float* __restrict__ pts,
                          const VT* __restrict__ vol,
                          const float* __restrict__ gw,
                          float* __restrict__ dpts, float* __restrict__ dvol,
                          int n, int B, int G) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float* p = pts + 3 * row;
  const Taps tx = make_taps(p[0], G), ty = make_taps(p[1], G),
             tz = make_taps(p[2], G);
  const XYTaps s = make_xy(tx, ty, G, B * G, vol);
  const float* g = gw + (size_t)row * B;
  float df[3];
  tap_grads(s, tx, ty, tz, vol, B, G, dvol, df, [&](int b) { return g[b]; });
  dpts[3 * row] = df[0];
  dpts[3 * row + 1] = df[1];
  dpts[3 * row + 2] = df[2];
}

template <typename VT, int K>
__global__ void __launch_bounds__(kFwdThreads)
shared_blend_fwd_kernel(const float* __restrict__ pts,
                        const VT* __restrict__ vol,
                        const float* __restrict__ rmat,
                        const int* __restrict__ k0_p, float* __restrict__ out,
                        int n, int B, int G) {
  constexpr int J = 12 * K;
  __shared__ float s_rm[kMaxBones * J];
  const int first = first_live_row(k0_p, n, kTile);
  if ((int)(blockIdx.x * blockDim.x + blockDim.x) <= first) return;
  for (int i = threadIdx.x; i < B * J; i += blockDim.x) s_rm[i] = rmat[i];
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < first || row >= n) return;

  const float P[3] = {pts[3 * row], pts[3 * row + 1], pts[3 * row + 2]};
  const Taps tx = make_taps(P[0], G), ty = make_taps(P[1], G),
             tz = make_taps(P[2], G);
  const int BG = B * G;
  const XYTaps s = make_xy(tx, ty, G, BG, vol);
  float A[J];
#pragma unroll
  for (int j = 0; j < J; ++j) A[j] = 0.f;
  float wsum = 0.f;
  for (int b = 0; b < B; ++b) {
    float zc[2], v[4][2];
    bone_zc(s, tz, vol, b * G, zc, v);
    const float wb =
        __fadd_rn(round_tap(__fmul_rn(zc[0], tz.h[0]), vol),
                  round_tap(__fmul_rn(zc[1], tz.h[1]), vol));
    wsum = __fadd_rn(wsum, wb);
    const float* rb = s_rm + b * J;
#pragma unroll
    for (int j = 0; j < J; ++j) A[j] = __fadd_rn(A[j], __fmul_rn(wb, rb[j]));
  }
  float* o = out + (size_t)row * (3 * K + 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int j = 12 * k + 4 * c;
      o[3 * k + c] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(P[0], A[j]), __fmul_rn(P[1], A[j + 1])),
                    __fmul_rn(P[2], A[j + 2])),
          A[j + 3]);
    }
  }
  o[3 * K] = wsum;
}

template <typename VT, int K>
__global__ void __launch_bounds__(kBwdThreads)
shared_blend_bwd_kernel(const float* __restrict__ pts,
                        const VT* __restrict__ vol,
                        const float* __restrict__ rmat,
                        const int* __restrict__ k0_p,
                        const float* __restrict__ gout,
                        float* __restrict__ dpts, float* __restrict__ dvol,
                        float* __restrict__ drmat, int n, int B, int G) {
  constexpr int J = 12 * K;
  __shared__ float s_rm[kMaxBones * J];
  __shared__ float s_w[kBwdThreads][kMaxBones + 1];
  __shared__ float s_q[kBwdThreads][J + 1];
  const int first = first_live_row(k0_p, n, kTile);
  if ((int)(blockIdx.x * blockDim.x + blockDim.x) <= first) return;
  for (int i = threadIdx.x; i < B * J; i += blockDim.x) s_rm[i] = rmat[i];
  const int tid = threadIdx.x;
  for (int b = 0; b < B; ++b) s_w[tid][b] = 0.f;
  for (int j = 0; j < J; ++j) s_q[tid][j] = 0.f;
  __syncthreads();

  const int row = blockIdx.x * blockDim.x + tid;
  if (row >= first && row < n) {
    const float P[3] = {pts[3 * row], pts[3 * row + 1], pts[3 * row + 2]};
    const Taps tx = make_taps(P[0], G), ty = make_taps(P[1], G),
               tz = make_taps(P[2], G);
    const int BG = B * G;
    const XYTaps s = make_xy(tx, ty, G, BG, vol);

    // recompute w and A
    float A[J];
#pragma unroll
    for (int j = 0; j < J; ++j) A[j] = 0.f;
    for (int b = 0; b < B; ++b) {
      float zc[2], v[4][2];
      bone_zc(s, tz, vol, b * G, zc, v);
      const float wb =
          __fadd_rn(round_tap(__fmul_rn(zc[0], tz.h[0]), vol),
                    round_tap(__fmul_rn(zc[1], tz.h[1]), vol));
      s_w[tid][b] = wb;
      const float* rb = s_rm + b * J;
#pragma unroll
      for (int j = 0; j < J; ++j) A[j] = __fadd_rn(A[j], __fmul_rn(wb, rb[j]));
    }

    const float* g = gout + (size_t)row * (3 * K + 1);
    const float gws = g[3 * K];
    float q[J];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gc = g[3 * k + c];
        const int j = 12 * k + 4 * c;
        q[j] = __fmul_rn(gc, P[0]);
        q[j + 1] = __fmul_rn(gc, P[1]);
        q[j + 2] = __fmul_rn(gc, P[2]);
        q[j + 3] = gc;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) s_q[tid][j] = q[j];
    float direct[3];
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc = __fadd_rn(acc, __fmul_rn(g[3 * k + c], A[12 * k + 4 * c + jj]));
      direct[jj] = acc;
    }

    // sampling gradients with gw_b = bf16(dw_b)
    float df[3];
    tap_grads(s, tx, ty, tz, vol, B, G, dvol, df, [&](int b) {
      const float* rb = s_rm + b * J;
      float dw = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) dw = __fadd_rn(dw, __fmul_rn(q[j], rb[j]));
      return __fadd_rn(dw, gws);
    });
    dpts[3 * row] = __fadd_rn(df[0], direct[0]);
    dpts[3 * row + 1] = __fadd_rn(df[1], direct[1]);
    dpts[3 * row + 2] = __fadd_rn(df[2], direct[2]);
  }
  __syncthreads();
  // this block's drmat = w^T q, one atomic per entry
  for (int i = tid; i < B * J; i += blockDim.x) {
    const int b = i / J, j = i - b * J;
    float acc = 0.f;
    for (int t = 0; t < kBwdThreads; ++t)
      acc = __fadd_rn(acc, __fmul_rn(s_w[t][b], s_q[t][j]));
    if (acc != 0.f) atomicAdd(drmat + i, acc);
  }
}

template <int K>
int launch(const float* pts, const void* vol, const float* rmat,
           const int* k0, const float* gout, float* out, float* dpts,
           float* dvol, float* drmat, int n, int B, int G, int bf16,
           cudaStream_t s) {
  if (gout == nullptr) {
    const dim3 grid((n + kFwdThreads - 1) / kFwdThreads);
    if (bf16)
      shared_blend_fwd_kernel<__nv_bfloat16, K><<<grid, kFwdThreads, 0, s>>>(
          pts, static_cast<const __nv_bfloat16*>(vol), rmat, k0, out, n, B, G);
    else
      shared_blend_fwd_kernel<float, K><<<grid, kFwdThreads, 0, s>>>(
          pts, static_cast<const float*>(vol), rmat, k0, out, n, B, G);
  } else {
    const dim3 grid((n + kBwdThreads - 1) / kBwdThreads);
    if (bf16)
      shared_blend_bwd_kernel<__nv_bfloat16, K><<<grid, kBwdThreads, 0, s>>>(
          pts, static_cast<const __nv_bfloat16*>(vol), rmat, k0, gout, dpts,
          dvol, drmat, n, B, G);
    else
      shared_blend_bwd_kernel<float, K><<<grid, kBwdThreads, 0, s>>>(
          pts, static_cast<const float*>(vol), rmat, k0, gout, dpts, dvol,
          drmat, n, B, G);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* pts, const void* vol, const float* rmat,
             const int* k0, const float* gout, float* out, float* dpts,
             float* dvol, float* drmat, int n, int B, int G, int K, int bf16,
             void* stream) {
  if (n <= 0) return 0;
  if (B < 1 || B > kMaxBones) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(pts, vol, rmat, k0, gout, out, dpts, dvol, drmat, n, B, G, bf16, s);
    case 2: return launch<2>(pts, vol, rmat, k0, gout, out, dpts, dvol, drmat, n, B, G, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int shared_weights(const float* pts, const void* vol, const float* gw,
                   float* w, float* dpts, float* dvol, int n, int B, int G,
                   int bf16, void* stream) {
  if (n <= 0) return 0;
  if (B < 1 || B > kMaxBones || (long long)n * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gw == nullptr) {
    const dim3 grid((n * B + kFwdThreads - 1) / kFwdThreads);
    if (bf16)
      shared_weights_fwd_kernel<__nv_bfloat16><<<grid, kFwdThreads, 0, st>>>(
          pts, static_cast<const __nv_bfloat16*>(vol), w, n, B, G);
    else
      shared_weights_fwd_kernel<float><<<grid, kFwdThreads, 0, st>>>(
          pts, static_cast<const float*>(vol), w, n, B, G);
  } else {
    const dim3 grid((n + kBwdThreads - 1) / kBwdThreads);
    if (bf16)
      shared_weights_bwd_kernel<__nv_bfloat16><<<grid, kBwdThreads, 0, st>>>(
          pts, static_cast<const __nv_bfloat16*>(vol), gw, dpts, dvol, n, B,
          G);
    else
      shared_weights_bwd_kernel<float><<<grid, kBwdThreads, 0, st>>>(
          pts, static_cast<const float*>(vol), gw, dpts, dvol, n, B, G);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hosnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pts [n, 3] f32 grid coordinates; vol [G*G, B*G] (bf16 when bf16, else
// f32); rmat [B, 12K] f32; k0 [1] int32 on the device; out [n, 3K+1] f32
// (rows below the clamped k0 * 512 unwritten). Returns cudaGetLastError().
int hosnerf_shared_blend_fwd(const float* pts, const void* vol,
                             const float* rmat, const int* k0, float* out,
                             int n, int B, int G, int K, int bf16,
                             void* stream) {
  return dispatch(pts, vol, rmat, k0, nullptr, out, nullptr, nullptr,
                  nullptr, n, B, G, K, bf16, stream);
}

// Backward: gout [n, 3K+1] f32 in; dpts [n, 3] out (rows below the clamped
// k0 * 512 unwritten); dvol [G*G, B*G] and drmat [B, 12K] f32 accumulated,
// zeroed by the caller. Returns cudaGetLastError().
int hosnerf_shared_blend_bwd(const float* pts, const void* vol,
                             const float* rmat, const int* k0,
                             const float* gout, float* dpts, float* dvol,
                             float* drmat, int n, int B, int G, int K,
                             int bf16, void* stream) {
  return dispatch(pts, vol, rmat, k0, gout, nullptr, dpts, dvol, drmat, n,
                  B, G, K, bf16, stream);
}

// Row 7: pts [n, 3] f32 grid coordinates; vol_r [G*G, G, B] (bf16 when
// bf16, else f32); w [n, B] f32. Returns cudaGetLastError().
int hosnerf_shared_weights_fwd(const float* pts, const void* vol_r, float* w,
                               int n, int B, int G, int bf16, void* stream) {
  return shared_weights(pts, vol_r, nullptr, w, nullptr, nullptr, n, B, G,
                        bf16, stream);
}

// Row 7 backward: vol [G*G, B*G]; gw [n, B] f32 in; dpts [n, 3] out; dvol
// [G*G, B*G] f32 accumulated, zeroed by the caller.
int hosnerf_shared_weights_bwd(const float* pts, const void* vol,
                               const float* gw, float* dpts, float* dvol,
                               int n, int B, int G, int bf16, void* stream) {
  return shared_weights(pts, vol, gw, nullptr, dpts, dvol, n, B, G, bf16,
                        stream);
}

}  // extern "C"
