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
// The TPU kernels contract [T, G^2] one-hot tap rows with the whole
// [G^2, B*G] volume on the MXU: ~850 k MACs per sample for 208 true taps
// (lbs.py:1775-1778). On Hopper a tap is a gather: ~4 KFLOP and a few
// dozen bytes per sample are nothing for the card (bounds of 0.007-0.017 ms
// at the training shapes). What holds these kernels is how the gathers and,
// in the backwards, the scattered dvol sums reach memory, and then latency:
// each warp of a backward walks a chain of dependent loads, sums and
// shuffles per sample (in variant builds at the training shapes, B5's
// dw/drmat block took half of the backward's time, the image loads 17%,
// the shared-memory atomics 9%).
//
// The image. Every kernel reads the volume from one relaid copy, [G*G, G,
// 32]: the 32 bone slots of a voxel (bones innermost, zero past B) are one
// 64-byte (bf16) or 128-byte (f32) row. `build_image_kernel` makes it from
// the caller's [G*G, B*G] volume in one launch (cast, relayout, pad; the
// forward saves it for the backward).
//
// Forwards: one thread per sample. It computes its taps once and loads each
// of its 8 taps' bone rows with 16-byte loads, so zc[z][b] for all bones
// sits in registers; the weights kernel stages its [T, B] rows in shared
// memory and stores them as 16-byte vectors, the blend kernel folds the
// bones in order into A (rmat in shared memory) and stores 3K + 1 floats.
// A sample without an in-grid tap (off the grid, or NaN) stores zeros.
//
// Backwards. dvol [G^2, B*G] (3.4 MB f32) sums over all samples: one
// device-memory atomic per (sample, bone, tap) is 208 per sample, 54 M per
// call at the training shapes, contended because neighbouring samples of a
// ray share voxels. Here the live samples are binned by brick (4x4x4 grid
// cells, whose taps touch 5^3 voxels) by a counting sort in three launches
// (a shared-memory histogram, one scan, one scatter of row ids); samples
// without an in-grid tap, whose every share is 0, get dpts 0 and no bin,
// so samples far off the grid cost nothing. Each
// CTA of `tap_bwd_kernel` takes up to kChunk samples of one brick (a hot
// brick is split over as many CTAs as it needs). The CTA sums the brick's
// dvol in shared memory, [125 voxels][33] f32 with bones innermost, then
// adds it to dvol with one atomic per nonzero entry, in the caller's
// layout: ~3,250 atomics per CTA at most. A warp walks its samples one
// after another with lane b on bone b: the shared-memory atomics of one
// sample hit 26 distinct addresses and banks; each lane computes its
// bone's gw (B5: J = 12K MACs), its share of U, dfz and the blend's direct
// term, and folds them into its sample's (dfx, dfy, dfz) contribution,
// summed over bones by shuffles. B5's drmat = w^T q accumulates per lane
// in registers over the warp's samples and is added once per CTA.
// Live suffix: k0 (a device int, in 512-row blocks) is clamped to
// [0, n_blocks - 1]; rows below k0 * 512 are neither computed forward (their
// output rows stay unwritten, as the TPU kernel leaves them) nor binned
// backward (their dpts rows are stored as 0).
//
// Numerics (bf16, `_mm` of the TPU kernels): xy tap products hx*hy and the
// volume rounded to bf16; zc = sum_xy in f32; w_b = sum_z bf16(zc hz);
// A in f32. Backward: gw = bf16(dw) (the `expand` matmul), dvol and U take
// bf16(gw hz); every sum f32. vol_bf16 = 0 is f32 throughout. Every
// per-(sample, bone) sum keeps the order of the plain versions
// (hosnerf_tpu_torch/ops/cuda/lbs.py::shared_core_plain,
// shared_core_bwd_plain, shared_blend_plain and shared_blend_bwd_plain),
// without FMA contraction, and so does the forward blend over bones; B5's
// dw = q rmat^T, a matmul there, fuses its multiply-adds in j order as a
// GEMM accumulates. The backward sums over bones (by shuffles) and over
// samples (in shared memory, then atomics) in another order, and B5's
// drmat and direct term, f32 sums with no rounding point after them, fuse
// their multiply-adds.

#include "lbs_common.cuh"

namespace {

using namespace hosnerf;

constexpr int kTile = 512;          // k0 counts blocks of this many rows
constexpr int kSlots = kMaxBones;   // bone slots per voxel row of the image
constexpr int kFwdThreads = 128;
constexpr int kImageThreads = 256;
// Backward schedule (emulated in plain torch by
// tests/test_torch_lbs_scatter.py).
constexpr int kBrick = 4;                       // cells per brick edge
constexpr int kSpan = kBrick + 1;               // voxels its taps touch
constexpr int kVox = kSpan * kSpan * kSpan;     // 125
constexpr int kTileRow = kMaxBones + 1;         // floats per voxel row
constexpr int kChunk = 512;                     // samples per CTA at most
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBinThreads = 256;
constexpr int kBinRows = 8;                     // rows per binning thread
constexpr int kScanThreads = 1024;
// more bricks than this (G > 72): the binning histogram goes to device
// memory, as the scatter pass's shared copy (2 ints a brick) would pass
// the 48 KB a CTA gets without an opt-in
constexpr int kMaxSmemBins = 6144;

// 8 bone slots of an image row, as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// img[(q*G + z)*32 + b] = vol[q, b*G + z] (0 for b >= B), in the image's
// type: one CTA per voxel column q, through shared memory so that both
// sides are read and written in order.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kImageThreads)
build_image_kernel(const TI* __restrict__ vol, TO* __restrict__ img, int B,
                   int G) {
  extern __shared__ float s_col[];  // [B][G + 1]
  const int q = blockIdx.x, BG = B * G;
  const TI* src = vol + (size_t)q * BG;
  for (int i = threadIdx.x; i < BG; i += blockDim.x)
    s_col[(i / G) * (G + 1) + i % G] = to_f(src[i]);
  __syncthreads();
  TO* dst = img + (size_t)q * G * kSlots;
  for (int i = threadIdx.x; i < G * kSlots; i += blockDim.x) {
    const int z = i / kSlots, b = i % kSlots;
    dst[i] = from_f<TO>(b < B ? s_col[b * (G + 1) + z] : 0.f);
  }
}

// The 4 shared xy taps of one sample: bf16-rounded weight, voxel column
// q = y*G + x, validity.
struct XYTaps {
  float w[4];
  int q[4];
  bool v[4];
};

template <typename VT>
__device__ __forceinline__ XYTaps make_xy(const Taps& tx, const Taps& ty,
                                          int G, const VT* img) {
  XYTaps s;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int t = 2 * dx + dy;
      s.v[t] = tx.v[dx] && ty.v[dy];
      s.w[t] = s.v[t] ? round_tap(__fmul_rn(tx.h[dx], ty.h[dy]), img) : 0.f;
      s.q[t] = ty.i[dy] * G + tx.i[dx];
    }
  }
  return s;
}

// zc[dz][b] = sum_xy w_xy vol_b(xy, z) for every bone slot, in xy order
// (0 where z is off-grid); rows of the image read 8 slots per load.
template <typename VT>
__device__ __forceinline__ void all_zc(const XYTaps& s, const Taps& tz,
                                       const VT* img, int G, int nch,
                                       float (&zc)[2][kSlots]) {
#pragma unroll
  for (int b = 0; b < kSlots; ++b) zc[0][b] = zc[1][b] = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!s.v[t]) continue;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      if (!tz.v[dz]) continue;
      const VT* r = img + ((size_t)s.q[t] * G + tz.i[dz]) * kSlots;
#pragma unroll
      for (int c = 0; c < kSlots / 8; ++c) {
        if (c < nch) {
          float v[8];
          load8(r + 8 * c, v);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            zc[dz][8 * c + k] =
                __fadd_rn(zc[dz][8 * c + k], __fmul_rn(s.w[t], v[k]));
        }
      }
    }
  }
}

template <typename VT>
__device__ __forceinline__ float bone_weight(float zc0, float zc1,
                                             const Taps& tz, const VT* img) {
  return __fadd_rn(round_tap(__fmul_rn(zc0, tz.h[0]), img),
                   round_tap(__fmul_rn(zc1, tz.h[1]), img));
}

// Whether a sample has any in-grid tap: floor(f) in [-1, G-1] on every axis
// (false for NaN). A sample without one has weights, dvol shares and dpts
// all exactly 0, so it is not binned: its dpts row is stored as 0.
__device__ __forceinline__ bool has_taps(const float* p, int G) {
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float c = floorf(p[a]);
    ok = ok && c >= -1.f && c <= (float)(G - 1);
  }
  return ok;
}

// Row 7 forward: w [n, B], one thread per sample.
template <typename VT>
__global__ void __launch_bounds__(kFwdThreads)
shared_weights_fwd_kernel(const float* __restrict__ pts,
                          const VT* __restrict__ img,
                          float* __restrict__ w, int n, int B, int G) {
  __shared__ __align__(16) float s_w[kFwdThreads * kMaxBones];
  const int row0 = blockIdx.x * kFwdThreads, row = row0 + threadIdx.x;
  if (row < n) {
    const float* p = pts + 3 * (size_t)row;
    float* o = s_w + threadIdx.x * B;
    if (has_taps(p, G)) {
      const Taps tx = make_taps(p[0], G), ty = make_taps(p[1], G),
                 tz = make_taps(p[2], G);
      float zc[2][kSlots];
      all_zc(make_xy(tx, ty, G, img), tz, img, G, (B + 7) / 8, zc);
#pragma unroll
      for (int b = 0; b < kSlots; ++b)
        if (b < B) o[b] = bone_weight(zc[0][b], zc[1][b], tz, img);
    } else {
      for (int b = 0; b < B; ++b) o[b] = 0.f;
    }
  }
  __syncthreads();
  // the CTA's rows are one contiguous run of w (16-byte aligned)
  const int total = min(kFwdThreads, n - row0) * B;
  float* out = w + (size_t)row0 * B;
  for (int i = threadIdx.x; i < total / 4; i += kFwdThreads)
    reinterpret_cast<float4*>(out)[i] = reinterpret_cast<const float4*>(s_w)[i];
  for (int i = (total & ~3) + threadIdx.x; i < total; i += kFwdThreads)
    out[i] = s_w[i];
}

// B5 forward: out [n, 3K+1], one thread per sample, bones folded in order.
template <typename VT, int K>
__global__ void __launch_bounds__(kFwdThreads)
shared_blend_fwd_kernel(const float* __restrict__ pts,
                        const VT* __restrict__ img,
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
  float* o = out + (size_t)row * (3 * K + 1);
  if (!has_taps(P, G)) {  // every weight 0
    for (int j = 0; j <= 3 * K; ++j) o[j] = 0.f;
    return;
  }
  const Taps tx = make_taps(P[0], G), ty = make_taps(P[1], G),
             tz = make_taps(P[2], G);
  float zc[2][kSlots];
  all_zc(make_xy(tx, ty, G, img), tz, img, G, (B + 7) / 8, zc);
  float A[J];
#pragma unroll
  for (int j = 0; j < J; ++j) A[j] = 0.f;
  float wsum = 0.f;
#pragma unroll
  for (int b = 0; b < kSlots; ++b) {
    if (b < B) {
      const float wb = bone_weight(zc[0][b], zc[1][b], tz, img);
      wsum = __fadd_rn(wsum, wb);
      const float* rb = s_rm + b * J;
#pragma unroll
      for (int j = 0; j < J; ++j) A[j] = __fadd_rn(A[j], __fmul_rn(wb, rb[j]));
    }
  }
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

// ---------------------------------------------------------------------------
// backward: binning by brick, then per-brick accumulation
// ---------------------------------------------------------------------------

// Brick coordinate of one axis of a sample with taps (`has_taps`): the cell
// of its lower tap, clamped into the grid (floor(f) = -1 -> 0), in bricks.
// Every in-grid tap of the sample then lies 0..4 voxels past the brick's
// origin.
__device__ __forceinline__ int brick_axis(float f, int G) {
  return (int)fminf(fmaxf(floorf(f), 0.f), (float)(G - 1)) / kBrick;
}

__device__ __forceinline__ int brick_of(const float* p, int G, int nb) {
  return (brick_axis(p[2], G) * nb + brick_axis(p[1], G)) * nb +
         brick_axis(p[0], G);
}

// Pass 1: counts[brick] += live samples in it (a histogram in shared memory
// unless there are more than kMaxSmemBins bricks). Rows below the clamped
// k0 * 512 and samples without an in-grid tap are not counted; their dpts
// rows are stored as 0 here.
__global__ void __launch_bounds__(kBinThreads)
bin_count_kernel(const float* __restrict__ pts, const int* __restrict__ k0_p,
                 float* __restrict__ dpts, int* __restrict__ counts, int n,
                 int G, int nb, int nbricks, int smem_bins) {
  extern __shared__ int s_hist[];
  const int first = k0_p ? first_live_row(k0_p, n, kTile) : 0;
  for (int i = threadIdx.x; i < smem_bins; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const int base = blockIdx.x * kBinThreads * kBinRows + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kBinRows; ++r) {
    const int row = base + r * kBinThreads;
    if (row >= n) break;
    const float* p = pts + 3 * (size_t)row;
    if (row < first || !has_taps(p, G)) {
      dpts[3 * row] = dpts[3 * row + 1] = dpts[3 * row + 2] = 0.f;
      continue;
    }
    const int br = brick_of(p, G, nb);
    atomicAdd(smem_bins ? s_hist + br : counts + br, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < smem_bins; i += blockDim.x)
    if (s_hist[i]) atomicAdd(counts + i, s_hist[i]);
}

// Pass 2, one CTA: offs = exclusive scan of counts (fill starts as a copy),
// cstart = exclusive scan of each brick's chunk count, cstart[nbricks] =
// all chunks.
__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(const int* __restrict__ counts, int* __restrict__ offs,
                int* __restrict__ fill, int* __restrict__ cstart,
                int nbricks) {
  __shared__ int s_warp[2][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (nbricks + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, nbricks), hi = min(lo + per, nbricks);
  int sc = 0, sk = 0;
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    sc += c;
    sk += (c + kChunk - 1) / kChunk;
  }
  int ic = sc, ik = sk;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFullMask, ic, o);
    const int b = __shfl_up_sync(kFullMask, ik, o);
    if (lane >= o) {
      ic += a;
      ik += b;
    }
  }
  if (lane == 31) {
    s_warp[0][warp] = ic;
    s_warp[1][warp] = ik;
  }
  __syncthreads();
  if (warp == 0) {
    int wc = s_warp[0][lane], wk = s_warp[1][lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(kFullMask, wc, o);
      const int b = __shfl_up_sync(kFullMask, wk, o);
      if (lane >= o) {
        wc += a;
        wk += b;
      }
    }
    s_warp[0][lane] = wc;
    s_warp[1][lane] = wk;
  }
  __syncthreads();
  int ec = ic - sc + (warp ? s_warp[0][warp - 1] : 0);
  int ek = ik - sk + (warp ? s_warp[1][warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    offs[i] = fill[i] = ec;
    cstart[i] = ek;
    ec += c;
    ek += (c + kChunk - 1) / kChunk;
  }
  if (tid == kScanThreads - 1) cstart[nbricks] = ek;
}

// Pass 3: order[offs[brick] + k] = the brick's live rows (in no set order):
// ranks within the CTA from the shared histogram, one atomic on fill per
// (CTA, brick).
__global__ void __launch_bounds__(kBinThreads)
bin_scatter_kernel(const float* __restrict__ pts, const int* __restrict__ k0_p,
                   int* __restrict__ fill, int* __restrict__ order, int n,
                   int G, int nb, int smem_bins) {
  extern __shared__ int s_hist[];  // [smem_bins] counts, then bases
  int* s_base = s_hist + smem_bins;
  const int first = k0_p ? first_live_row(k0_p, n, kTile) : 0;
  for (int i = threadIdx.x; i < smem_bins; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const int base = blockIdx.x * kBinThreads * kBinRows + threadIdx.x;
  int br[kBinRows], rank[kBinRows];
#pragma unroll
  for (int r = 0; r < kBinRows; ++r) {
    const int row = base + r * kBinThreads;
    br[r] = -1;
    if (row < first || row >= n || !has_taps(pts + 3 * (size_t)row, G))
      continue;
    br[r] = brick_of(pts + 3 * (size_t)row, G, nb);
    rank[r] = smem_bins ? atomicAdd(s_hist + br[r], 1)
                        : atomicAdd(fill + br[r], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < smem_bins; i += blockDim.x)
    if (s_hist[i]) s_base[i] = atomicAdd(fill + i, s_hist[i]);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kBinRows; ++r)
    if (br[r] >= 0)
      order[(smem_bins ? s_base[br[r]] : 0) + rank[r]] =
          base + r * kBinThreads;
}

// Pass 4: one CTA per chunk of one brick's samples. K = 0: row 7 (grad is
// gw [n, B]); K = 1, 2: B5 (grad is gout [n, 3K+1], rmat [B, 12K], drmat
// accumulated).
template <typename VT, int K>
__global__ void __launch_bounds__(kBwdThreads, 2)
tap_bwd_kernel(const float* __restrict__ pts, const VT* __restrict__ img,
               const float* __restrict__ grad, const float* __restrict__ rmat,
               const int* __restrict__ counts, const int* __restrict__ offs,
               const int* __restrict__ cstart, const int* __restrict__ order,
               float* __restrict__ dpts, float* __restrict__ dvol,
               float* __restrict__ drmat, int B, int G, int nb, int nbricks) {
  constexpr int J = 12 * K;
  constexpr int JA = J > 0 ? J : 1;
  constexpr int JR = J + 1;
  extern __shared__ __align__(16) float s_mem[];
  float* s_tile = s_mem;                  // [kVox][kTileRow]
  float* s_drm = s_mem + kVox * kTileRow;  // [kMaxBones][JR] (K > 0)
  __shared__ int s_info[3];
  const int tid = threadIdx.x, b = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x;
  if (chunk >= cstart[nbricks]) return;
  if (tid == 0) {
    int lo = 0, hi = nbricks;  // cstart[lo] <= chunk < cstart[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (cstart[mid] <= chunk) lo = mid; else hi = mid;
    }
    const int s0 = offs[lo] + (chunk - cstart[lo]) * kChunk;
    s_info[0] = lo;
    s_info[1] = s0;
    s_info[2] = min(s0 + kChunk, offs[lo] + counts[lo]);
  }
  for (int i = tid; i < kVox * kTileRow; i += kBwdThreads) s_tile[i] = 0.f;
  if constexpr (K > 0)
    for (int i = tid; i < kMaxBones * JR; i += kBwdThreads) s_drm[i] = 0.f;
  __syncthreads();
  const int brick = s_info[0], s_lo = s_info[1], s_hi = s_info[2];
  const int ox = kBrick * (brick % nb), oy = kBrick * (brick / nb % nb),
            oz = kBrick * (brick / (nb * nb));
  const bool live = b < B;

  float r[JA], drm[JA];
#pragma unroll
  for (int j = 0; j < JA; ++j) {
    r[j] = (K > 0 && live) ? rmat[b * J + j] : 0.f;
    drm[j] = 0.f;
  }
  const float dh[2] = {-1.f, 1.f};

  for (int g0 = s_lo + 32 * warp; g0 < s_hi; g0 += 32 * kBwdWarps) {
    const int m = min(32, s_hi - g0);
    int my_row = 0;
    float mp[3] = {0.f, 0.f, 0.f};
    if (b < m) {
      my_row = order[g0 + b];
      mp[0] = pts[3 * (size_t)my_row];
      mp[1] = pts[3 * (size_t)my_row + 1];
      mp[2] = pts[3 * (size_t)my_row + 2];
    }
    for (int smp = 0; smp < m; ++smp) {
      const int row = __shfl_sync(kFullMask, my_row, smp);
      const float P[3] = {__shfl_sync(kFullMask, mp[0], smp),
                          __shfl_sync(kFullMask, mp[1], smp),
                          __shfl_sync(kFullMask, mp[2], smp)};
      const Taps tx = make_taps(P[0], G), ty = make_taps(P[1], G),
                 tz = make_taps(P[2], G);
      const XYTaps s = make_xy(tx, ty, G, img);
      // this bone's 8 taps and zc
      float v[4][2], zc[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          v[t][dz] = 0.f;
          if (s.v[t] && tz.v[dz]) {
            v[t][dz] = load_vol(img, (s.q[t] * G + tz.i[dz]) * kSlots + b);
            zc[dz] = __fadd_rn(zc[dz], __fmul_rn(s.w[t], v[t][dz]));
          }
        }
      }
      // gw_b = bf16(dw_b): row 7 takes it, B5 computes dw = q rmat_b + g_w
      // and folds w_b q into drmat. q rmat_b is the plain version's matmul:
      // one fused multiply-add per j, in j order, as a GEMM's inner loop
      // accumulates (one f32 ulp of dw can flip gw's bf16 rounding); e = this bone's share of the direct term
      // sum_kc g_kc A[12k+4c+j] = w_b sum_kc g_kc rmat_b[12k+4c+j]. drmat
      // and e are f32 sums that no rounding point follows, so they fuse
      // their multiply-adds (half of this kernel's time went to this
      // block before).
      float gw = 0.f, e[3] = {0.f, 0.f, 0.f};
      if constexpr (K == 0) {
        if (live) gw = grad[(size_t)row * B + b];
      } else {
        const float* g = grad + (size_t)row * (3 * K + 1);
        const float wb = bone_weight(zc[0], zc[1], tz, img);
        float dw = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float gc = g[3 * k + c];
            const float wg = __fmul_rn(wb, gc);
            const int j = 12 * k + 4 * c;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float q = jj < 3 ? __fmul_rn(gc, P[jj]) : gc;
              dw = __fmaf_rn(q, r[j + jj], dw);
              if (jj < 3) {
                drm[j + jj] = __fmaf_rn(wg, P[jj], drm[j + jj]);
                e[jj] = __fmaf_rn(gc, r[j + jj], e[jj]);
              } else {
                drm[j + jj] = __fadd_rn(drm[j + jj], wg);
              }
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) e[jj] = __fmul_rn(wb, e[jj]);
        if (live) gw = __fadd_rn(dw, g[3 * K]);
      }
      gw = round_tap(gw, img);
      float d[2];
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
        d[dz] = tz.v[dz] ? round_tap(__fmul_rn(gw, tz.h[dz]), img) : 0.f;
      // dvol into the brick's tile; this bone's (dfx, dfy, dfz) share
      float c3[3] = {e[0], e[1], e[2]};
      float dfz = 0.f;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
        if (tz.v[dz])
          dfz = __fadd_rn(dfz, __fmul_rn(gw, __fmul_rn(dh[dz], zc[dz])));
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int t = 2 * dx + dy;
          if (!s.v[t]) continue;
          const int vxy = ((ty.i[dy] - oy) * kSpan + (tx.i[dx] - ox)) * kSpan;
          float U = 0.f;
#pragma unroll
          for (int dz = 0; dz < 2; ++dz) {
            if (!tz.v[dz]) continue;
            const float dv = __fmul_rn(s.w[t], d[dz]);
            if (dv != 0.f)
              atomicAdd(s_tile + (vxy + tz.i[dz] - oz) * kTileRow + b, dv);
            U = __fadd_rn(U, __fmul_rn(d[dz], v[t][dz]));
          }
          c3[0] = __fadd_rn(c3[0], __fmul_rn(__fmul_rn(dh[dx], ty.h[dy]), U));
          c3[1] = __fadd_rn(c3[1], __fmul_rn(__fmul_rn(tx.h[dx], dh[dy]), U));
        }
      }
      c3[2] = __fadd_rn(c3[2], dfz);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          c3[k] = __fadd_rn(c3[k], __shfl_xor_sync(kFullMask, c3[k], o));
      }
      if (b == 0) {
        dpts[3 * (size_t)row] = c3[0];
        dpts[3 * (size_t)row + 1] = c3[1];
        dpts[3 * (size_t)row + 2] = c3[2];
      }
    }
  }
  if (K > 0 && live) {  // this lane's drmat row into the CTA's
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (drm[j] != 0.f) atomicAdd(s_drm + b * JR + j, drm[j]);
  }
  __syncthreads();
  // the brick's dvol, one atomic per nonzero entry, in [G*G, B*G]
  for (int i = tid; i < kSpan * kSpan * B * kSpan; i += kBwdThreads) {
    const int rz = i % kSpan, t = i / kSpan, bb = t % B, rxy = t / B;
    const int rx = rxy % kSpan, ry = rxy / kSpan;
    const int x = ox + rx, y = oy + ry, z = oz + rz;
    if (x >= G || y >= G || z >= G) continue;
    const float val = s_tile[((ry * kSpan + rx) * kSpan + rz) * kTileRow + bb];
    if (val != 0.f) atomicAdd(dvol + ((size_t)(y * G + x) * B + bb) * G + z, val);
  }
  if constexpr (K > 0) {
    for (int i = tid; i < B * J; i += kBwdThreads) {
      const float val = s_drm[(i / J) * JR + i % J];
      if (val != 0.f) atomicAdd(drmat + i, val);
    }
  }
}

constexpr int scatter_smem(int K) {
  return (kVox * kTileRow + (K > 0 ? kMaxBones * (12 * K + 1) : 0)) *
         (int)sizeof(float);
}
static_assert(scatter_smem(2) <= 48 * 1024 &&
                  2 * kMaxSmemBins * (int)sizeof(int) <= 48 * 1024,
              "the backward's shared memory needs no opt-in");

template <typename VT>
int launch_bwd(const float* pts, const VT* img, const float* grad,
               const float* rmat, const int* k0, int* scratch, float* dpts,
               float* dvol, float* drmat, int n, int B, int G, int K,
               cudaStream_t s) {
  const int nb = (G + kBrick - 1) / kBrick, nbricks = nb * nb * nb;
  const int smem_bins = nbricks <= kMaxSmemBins ? nbricks : 0;
  const int bin_smem = 2 * smem_bins * (int)sizeof(int);
  const int smem = scatter_smem(K);
  // at most one partial chunk per brick beyond the full ones; the CTAs
  // past the real count exit
  const int grid = (n + kChunk - 1) / kChunk + nbricks;
  int* counts = scratch;
  cudaMemsetAsync(counts, 0, nbricks * sizeof(int), s);
  int* offs = counts + nbricks;
  int* fill = offs + nbricks;
  int* cstart = fill + nbricks;
  int* order = cstart + nbricks + 1;
  const int bin_grid = (n + kBinThreads * kBinRows - 1) / (kBinThreads * kBinRows);
  bin_count_kernel<<<bin_grid, kBinThreads, bin_smem / 2, s>>>(
      pts, k0, dpts, counts, n, G, nb, nbricks, smem_bins);
  bin_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, offs, fill, cstart,
                                             nbricks);
  bin_scatter_kernel<<<bin_grid, kBinThreads, bin_smem, s>>>(
      pts, k0, fill, order, n, G, nb, smem_bins);
  switch (K) {
    case 0:
      tap_bwd_kernel<VT, 0><<<grid, kBwdThreads, smem, s>>>(
          pts, img, grad, rmat, counts, offs, cstart, order, dpts, dvol,
          drmat, B, G, nb, nbricks);
      break;
    case 1:
      tap_bwd_kernel<VT, 1><<<grid, kBwdThreads, smem, s>>>(
          pts, img, grad, rmat, counts, offs, cstart, order, dpts, dvol,
          drmat, B, G, nb, nbricks);
      break;
    case 2:
      tap_bwd_kernel<VT, 2><<<grid, kBwdThreads, smem, s>>>(
          pts, img, grad, rmat, counts, offs, cstart, order, dpts, dvol,
          drmat, B, G, nb, nbricks);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_dims(int n, int B, int G) {
  return B < 1 || B > kMaxBones || G < 1 ||
         (long long)n * B > 0x7fffffffLL ||
         (long long)G * G * G * kSlots > 0x7fffffffLL;
}

}  // namespace

extern "C" {

const char* hosnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The image [G*G, G, 32] of vol [G*G, B*G] (vol_bf16: bf16, else f32),
// stored bf16 (img_bf16, round to nearest) or f32, bone slots past B zero.
int hosnerf_lbs_image(const void* vol, int vol_bf16, void* img, int img_bf16,
                      int B, int G, void* stream) {
  if (bad_dims(1, B, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = B * (G + 1) * (int)sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(G * G);
  if (vol_bf16 && img_bf16)
    build_image_kernel<<<grid, kImageThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(vol),
        static_cast<__nv_bfloat16*>(img), B, G);
  else if (vol_bf16)
    build_image_kernel<<<grid, kImageThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(vol), static_cast<float*>(img), B,
        G);
  else if (img_bf16)
    build_image_kernel<<<grid, kImageThreads, smem, s>>>(
        static_cast<const float*>(vol), static_cast<__nv_bfloat16*>(img), B,
        G);
  else
    build_image_kernel<<<grid, kImageThreads, smem, s>>>(
        static_cast<const float*>(vol), static_cast<float*>(img), B, G);
  return static_cast<int>(cudaGetLastError());
}

// Row 7: pts [n, 3] f32 grid coordinates; img from hosnerf_lbs_image (bf16
// when bf16); w [n, B] f32. Returns cudaGetLastError().
int hosnerf_shared_weights_fwd(const float* pts, const void* img, float* w,
                               int n, int B, int G, int bf16, void* stream) {
  if (n <= 0) return 0;
  if (bad_dims(n, B, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kFwdThreads - 1) / kFwdThreads);
  if (bf16)
    shared_weights_fwd_kernel<<<grid, kFwdThreads, 0, s>>>(
        pts, static_cast<const __nv_bfloat16*>(img), w, n, B, G);
  else
    shared_weights_fwd_kernel<<<grid, kFwdThreads, 0, s>>>(
        pts, static_cast<const float*>(img), w, n, B, G);
  return static_cast<int>(cudaGetLastError());
}

// B5: pts [n, 3] f32 grid coordinates; img as above; rmat [B, 12K] f32; k0
// [1] int32 on the device; out [n, 3K+1] f32 (rows below the clamped
// k0 * 512 unwritten). Returns cudaGetLastError().
int hosnerf_shared_blend_fwd(const float* pts, const void* img,
                             const float* rmat, const int* k0, float* out,
                             int n, int B, int G, int K, int bf16,
                             void* stream) {
  if (n <= 0) return 0;
  if (bad_dims(n, B, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kFwdThreads - 1) / kFwdThreads);
  const __nv_bfloat16* ib = static_cast<const __nv_bfloat16*>(img);
  const float* iff = static_cast<const float*>(img);
  if (K == 1 && bf16)
    shared_blend_fwd_kernel<__nv_bfloat16, 1><<<grid, kFwdThreads, 0, s>>>(
        pts, ib, rmat, k0, out, n, B, G);
  else if (K == 1)
    shared_blend_fwd_kernel<float, 1><<<grid, kFwdThreads, 0, s>>>(
        pts, iff, rmat, k0, out, n, B, G);
  else if (K == 2 && bf16)
    shared_blend_fwd_kernel<__nv_bfloat16, 2><<<grid, kFwdThreads, 0, s>>>(
        pts, ib, rmat, k0, out, n, B, G);
  else if (K == 2)
    shared_blend_fwd_kernel<float, 2><<<grid, kFwdThreads, 0, s>>>(
        pts, iff, rmat, k0, out, n, B, G);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// int32 scratch of hosnerf_shared_tap_bwd: counts | offs | fill | cstart
// (nbricks + 1) | order (n).
int hosnerf_shared_tap_scratch(int n, int G) {
  const int nb = (G + kBrick - 1) / kBrick;
  return 4 * nb * nb * nb + 1 + n;
}

// Both backwards. K = 0, row 7: grad = gw [n, B]; rmat, k0, drmat null.
// K = 1, 2, B5: grad = gout [n, 3K+1], rmat [B, 12K], k0 [1] int32 on the
// device, drmat [B, 12K] accumulated. dpts [n, 3] stored (rows below the
// clamped k0 * 512 as 0); dvol [G*G, B*G] accumulated; both sums zeroed by
// the caller. scratch: int32 [hosnerf_shared_tap_scratch(n, G)]. Returns
// cudaGetLastError().
int hosnerf_shared_tap_bwd(const float* pts, const void* img,
                           const float* grad, const float* rmat,
                           const int* k0, int* scratch, float* dpts,
                           float* dvol, float* drmat, int n, int B, int G,
                           int K, int bf16, void* stream) {
  if (n <= 0) return 0;
  if (bad_dims(n, B, G) || K < 0 || K > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd(pts, static_cast<const __nv_bfloat16*>(img), grad,
                      rmat, k0, scratch, dpts, dvol, drmat, n, B, G, K, s);
  return launch_bwd(pts, static_cast<const float*>(img), grad, rmat, k0,
                    scratch, dpts, dvol, drmat, n, B, G, K, s);
}

}  // extern "C"
