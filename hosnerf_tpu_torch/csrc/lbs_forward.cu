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
// cells, whose taps touch 5^3 voxels) by a stable counting sort in four
// launches (per-CTA histograms, a scan over the CTAs and one over the
// bricks, one scatter of row ids that keeps each brick's rows in row
// order); samples without an in-grid tap,
// whose every share is 0, get dpts 0 and no bin, so samples far off the
// grid cost nothing. Each CTA of `tap_bwd_kernel` takes up to kChunk
// samples of one brick (a hot brick is split over as many CTAs as it
// needs). The CTA sums the brick's dvol in shared memory, [125 voxels][33]
// with bones innermost, then adds it to dvol with one atomic per nonzero
// entry, in the caller's layout: ~3,250 atomics per CTA at most. A warp
// walks its samples one after another with lane b on bone b, summing each
// bone's shares of the current cell's 8 corners in registers (fixed point)
// until the cell changes (the corners shared with the next cell carry
// over), so the
// shared-memory atomics of one flush hit 26 distinct addresses; each
// lane computes its bone's gw (B5: J = 12K MACs), its share of U, dfz and
// the blend's direct term, and folds them into its sample's (dfx, dfy,
// dfz) contribution, summed over bones by shuffles. B5's drmat = w^T q
// accumulates per lane in registers over the warp's samples.
//
// Sums over samples, in an order no schedule moves (the TPU kernels carry
// them across their sequential grids in one order). dvol: fixed point
// (lbs_common.cuh): every share is rounded once to an int64 multiple of
// 2^-e and summed exactly, in registers, with integer atomics in shared
// memory and then to the [G*G, B*G] accumulators, so neither the order of
// the samples nor the warps' or the CTAs' interleaving changes the total
// (the sorted and the dense paths give the same bits);
// `tap_finish_kernel` converts it to f32. e comes
// from the largest |grad| entry M of the binned samples (pass 1) and, for
// B5, the largest |rmat| entry R (pass 2): |share| <= M (3K (3G + 1) R +
// 1) (row 7: M), at most n shares per accumulator. drmat: fixed-order
// partial sums. The binning keeps each brick's rows in row order and the
// chunks fixed, so a lane sums the same samples in the same order every
// run; the CTA adds its warps in warp order into its own slot, and
// `tap_finish_kernel` sums the slots in a fixed order (`fold_slot`).
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
// without FMA contraction, and so does the forward blend over bones. B5's
// dw = q rmat^T + g_w, the one input of a rounding point that the plain
// version computes in another order (a matmul there), is computed exactly
// on both sides (f64 products and sums of the f32 inputs) and rounded
// once, so no order moves gw. The backward sums over bones (by shuffles)
// and over samples (dvol in fixed point, exact but for each share's
// rounding to 2^-e; drmat by slots) in another order than the plain
// version's, the same one on every run, and B5's drmat and direct term,
// f32 sums with no rounding point after them, fuse their multiply-adds.

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
// the backward's control words (zeroed by the launcher): the largest
// |grad| and |rmat| entries (bits)
constexpr int kGradMax = 0, kRmatMax = 1, kCtlWords = 4;

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

// Pass 1: this CTA's histogram of live samples by brick into its row of
// hist [bin CTAs][nbricks] (counted in shared memory and stored whole
// unless there are more than kMaxSmemBins bricks; then counted into the
// row, zeroed by the launcher), and the largest |grad| entry of the
// binned samples (bits, into ctl[kGradMax]). Rows below the clamped k0 * 512 and
// samples without an in-grid tap are not counted; their dpts rows are
// stored as 0 here. Integer counts: exact in any order.
__global__ void __launch_bounds__(kBinThreads)
bin_count_kernel(const float* __restrict__ pts, const int* __restrict__ k0_p,
                 const float* __restrict__ grad, int gcols,
                 float* __restrict__ dpts, int* __restrict__ hist,
                 unsigned* __restrict__ ctl, int n, int G, int nb,
                 int nbricks, int smem_bins) {
  extern __shared__ int s_hist[];
  const int first = k0_p ? first_live_row(k0_p, n, kTile) : 0;
  int* row_hist = hist + (size_t)blockIdx.x * nbricks;
  for (int i = threadIdx.x; i < smem_bins; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const int base = blockIdx.x * kBinThreads * kBinRows + threadIdx.x;
  unsigned gm = 0;
#pragma unroll
  for (int r = 0; r < kBinRows; ++r) {
    const int row = base + r * kBinThreads;
    if (row >= n) break;
    const float* p = pts + 3 * (size_t)row;
    if (row < first || !has_taps(p, G)) {
      dpts[3 * row] = dpts[3 * row + 1] = dpts[3 * row + 2] = 0.f;
      continue;
    }
    atomicAdd(smem_bins ? s_hist + brick_of(p, G, nb)
                        : row_hist + brick_of(p, G, nb), 1);
    for (int c = 0; c < gcols; ++c)
      gm = max(gm, abs_bits(grad[(size_t)row * gcols + c]));
  }
  warp_max_bits(ctl + kGradMax, gm);
  __syncthreads();
  for (int i = threadIdx.x; i < smem_bins; i += blockDim.x)
    row_hist[i] = s_hist[i];
}

// Pass 2a, a CTA per 32 bricks: per brick, hist's column becomes the
// exclusive scan over the bin CTAs (where in the brick each CTA's samples
// start), and counts its total. Lane = brick; warp w takes a run of bin
// CTAs, the warps' sums meet in shared memory in warp order.
constexpr int kColWarps = 8;

__global__ void __launch_bounds__(32 * kColWarps)
bin_colscan_kernel(int* __restrict__ hist, int nbin,
                   int* __restrict__ counts, int nbricks) {
  __shared__ int s_sum[kColWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const int per = (nbin + kColWarps - 1) / kColWarps;
  const int c0 = min(warp * per, nbin), c1 = min(c0 + per, nbin);
  int sum = 0;
  if (i < nbricks)
    for (int c = c0; c < c1; ++c) sum += hist[(size_t)c * nbricks + i];
  s_sum[warp][lane] = sum;
  __syncthreads();
  int run = 0;
  for (int w = 0; w < warp; ++w) run += s_sum[w][lane];
  if (i >= nbricks) return;
  for (int c = c0; c < c1; ++c) {
    const int v = hist[(size_t)c * nbricks + i];
    hist[(size_t)c * nbricks + i] = run;
    run += v;
  }
  if (warp == kColWarps - 1) counts[i] = run;
}

// Pass 2b, one CTA: offs = exclusive scan of counts, cstart = exclusive
// scan of each brick's chunk count, cstart[nbricks] = all chunks; the
// largest |rmat| entry (bits, into ctl[kRmatMax]).
__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(const int* __restrict__ counts, int* __restrict__ offs,
                int* __restrict__ cstart, const float* __restrict__ rmat,
                int nrmat, unsigned* __restrict__ ctl, int nbricks) {
  __shared__ int s_warp[2][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (nbricks + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, nbricks), hi = min(lo + per, nbricks);
  unsigned rm = 0;
  for (int i = tid; i < nrmat; i += kScanThreads)
    rm = max(rm, abs_bits(rmat[i]));
  warp_max_bits(ctl + kRmatMax, rm);
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
    offs[i] = ec;
    cstart[i] = ek;
    ec += c;
    ek += (c + kChunk - 1) / kChunk;
  }
  if (tid == kScanThreads - 1) cstart[nbricks] = ek;
}

// Pass 3: order[offs[brick] + k] = the brick's live rows in row order.
// Each warp of the CTA takes kBinRows x 32 consecutive rows, in rounds of
// 32; it counts its rows per brick (warp-private counters, wc[warp]
// [nbricks]: in shared memory for at most kMaxWarpBins bricks, else this
// CTA's region of `wcg`, zeroed by the launcher), the CTA turns the counts
// into each warp's start per brick (offs + the CTA's base from pass 2 +
// the warps before it), and each warp walks its rows again, ranking the
// lanes of one brick by __match_any_sync. No atomics: the same rows give
// the same order.
constexpr int kBinWarps = kBinThreads / 32;
constexpr int kMaxWarpBins = 1536;   // 48 KB of warp counters

__device__ __forceinline__ int bin_row(const float* pts, int row, int first,
                                       int n, int G, int nb) {
  return row >= first && row < n && has_taps(pts + 3 * (size_t)row, G)
             ? brick_of(pts + 3 * (size_t)row, G, nb)
             : -1;
}

__global__ void __launch_bounds__(kBinThreads)
bin_scatter_kernel(const float* __restrict__ pts, const int* __restrict__ k0_p,
                   const int* __restrict__ hist, const int* __restrict__ offs,
                   int* __restrict__ wcg, int* __restrict__ order, int n,
                   int G, int nb, int nbricks, int smem_warp_bins) {
  extern __shared__ int s_wc[];
  const int first = k0_p ? first_live_row(k0_p, n, kTile) : 0;
  int* wc = smem_warp_bins
                ? s_wc
                : wcg + (size_t)blockIdx.x * kBinWarps * nbricks;
  if (smem_warp_bins)
    for (int i = threadIdx.x; i < kBinWarps * nbricks; i += kBinThreads)
      s_wc[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* mine = wc + warp * nbricks;
  const int base = (blockIdx.x * kBinWarps + warp) * 32 * kBinRows + lane;
  for (int r = 0; r < kBinRows; ++r) {
    const int br = bin_row(pts, base + 32 * r, first, n, G, nb);
    const unsigned peers = __match_any_sync(kFullMask, br);
    if (br >= 0 && !(peers & below)) mine[br] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const int* cta_base = hist + (size_t)blockIdx.x * nbricks;
  for (int b = threadIdx.x; b < nbricks; b += kBinThreads) {
    int run = offs[b] + cta_base[b];
    for (int w = 0; w < kBinWarps; ++w) {
      const int c = wc[w * nbricks + b];
      wc[w * nbricks + b] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int r = 0; r < kBinRows; ++r) {
    const int row = base + 32 * r;
    const int br = bin_row(pts, row, first, n, G, nb);
    const unsigned peers = __match_any_sync(kFullMask, br);
    if (br >= 0) {
      const int at = mine[br];
      __syncwarp(peers);
      order[at + __popc(peers & below)] = row;
      if (!(peers & below)) mine[br] = at + __popc(peers);
    }
    __syncwarp();
  }
}

// Pass 4: one CTA per chunk of one brick's samples. K = 0: row 7 (grad is
// gw [n, B]); K = 1, 2: B5 (grad is gout [n, 3K+1], rmat [B, 12K], drmat
// accumulated).
// The bound of one dvol share over the largest |grad| entry M: row 7's
// share is at most |gw| <= M; B5's |dw| <= M (3K (3G + 1) R + 1), R the
// largest |rmat| entry (|P| <= G for a binned sample); 2% for the bf16
// roundings of gw and gw hz (the tap weight is at most 1).
__device__ __forceinline__ FixedScale tap_scale(const unsigned* ctl, int K,
                                                int G, int n) {
  const unsigned r = ctl[kRmatMax];
  FixedScale f = fixed_scale(
      ctl[kGradMax],
      1.02 * (K ? 3.0 * K * (3.0 * G + 1.0) *
                      (double)__uint_as_float(r < 0x7f800000u ? r : 0u) +
                  1.0
                : 1.0),
      (double)n);
  f.ok = f.ok && r < 0x7f800000u;
  return f;
}

template <typename VT, int K>
__global__ void __launch_bounds__(kBwdThreads, K == 0 ? 4 : 2)   // row 7: 32 warps an SM
tap_bwd_kernel(const float* __restrict__ pts, const VT* __restrict__ img,
               const float* __restrict__ grad, const float* __restrict__ rmat,
               const int* __restrict__ counts, const int* __restrict__ offs,
               const int* __restrict__ cstart, const int* __restrict__ order,
               const unsigned* __restrict__ ctl, float* __restrict__ dpts,
               unsigned long long* __restrict__ acc,
               float* __restrict__ drm_slots, int n, int B, int G, int nb,
               int nbricks) {
  constexpr int J = 12 * K;
  constexpr int JA = J > 0 ? J : 1;
  extern __shared__ __align__(16) unsigned s_mem[];
  unsigned* s_tile = s_mem;   // [kVox][kTileRow] fixed point, (lo, hi) words
  float* s_drw = reinterpret_cast<float*>(s_mem);  // later [warps][B][J]
  __shared__ int s_info[3];
  __shared__ float s_scale;
  const int tid = threadIdx.x, b = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x;
  if (chunk >= cstart[nbricks]) return;
  if (tid == 0) {
    s_scale = tap_scale(ctl, K, G, n).scale;
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
  for (int i = tid; i < 2 * kVox * kTileRow; i += kBwdThreads) s_tile[i] = 0u;
  __syncthreads();
  const int brick = s_info[0], s_lo = s_info[1], s_hi = s_info[2];
  const float scale = s_scale;
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
  // dvol: the warp's samples come in row order and share their cell (the
  // same for every bone), often with the next sample, or a face. Lane b
  // keeps bone b's fixed-point sums for the 8 corners of the current cell
  // (wx, wy, wz = floor of the sample; each share rounded on its own);
  // when the cell changes, the corners the new one shares keep their sums
  // and the others are added to the tile (`leave`), the window shifting
  // axis by axis; the rest at the end.
  int wx = 0, wy = 0, wz = 0;
  bool have = false;
  unsigned long long win[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) win[k] = 0ull;
  auto leave = [&](int k) {   // corner k's sum into the tile, if on the grid
    const int x = wx + (k >> 2), y = wy + ((k >> 1) & 1), z = wz + (k & 1);
    if (win[k] && (unsigned)x < (unsigned)G && (unsigned)y < (unsigned)G &&
        (unsigned)z < (unsigned)G)
      fixed_add_shared(
          s_tile +
              2 * ((((y - oy) * kSpan + (x - ox)) * kSpan + z - oz) *
                       kTileRow + b),
          win[k]);
  };

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
      {  // the window to this sample's cell (warp-uniform)
        const int cx = (int)floorf(P[0]), cy = (int)floorf(P[1]),
                  cz = (int)floorf(P[2]);
        if (have && (cx != wx || cy != wy || cz != wz)) {
          const int dx = cx - wx, dy = cy - wy, dz = cz - wz;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (corner_leaves(k, dx, dy, dz)) leave(k);
          shift_corners<4>(win, dx);
          shift_corners<2>(win, dy);
          shift_corners<1>(win, dz);
        }
        have = true;
        wx = cx;
        wy = cy;
        wz = cz;
      }
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
      // and folds w_b q into drmat. dw is exact: q = g_kc P_j (a product
      // of two f32, exact in f64) times rmat_b, summed in f64 (error
      // ~1e-16 of dw), then rounded once (`round_exact`), as the plain
      // version does; an f32 sum in any order can land one ulp across a
      // bf16 rounding boundary and move gw by a bf16 ulp. e = this bone's
      // share of the direct term sum_kc g_kc A[12k+4c+j] = w_b sum_kc g_kc
      // rmat_b[12k+4c+j]. drmat and e are f32 sums that no rounding point
      // follows, so they fuse their multiply-adds (half of this kernel's
      // time went to this block before).
      float gw = 0.f, e[3] = {0.f, 0.f, 0.f};
      if constexpr (K == 0) {
        if (live) gw = grad[(size_t)row * B + b];
      } else {
        const float* g = grad + (size_t)row * (3 * K + 1);
        const float wb = bone_weight(zc[0], zc[1], tz, img);
        double dw = 0.0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float gc = g[3 * k + c];
            const float wg = __fmul_rn(wb, gc);
            const int j = 12 * k + 4 * c;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const double q = jj < 3 ? static_cast<double>(gc) * P[jj]
                                      : static_cast<double>(gc);
              dw = fma(q, static_cast<double>(r[j + jj]), dw);
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
        if (live) gw = round_exact(dw + g[3 * K], img);
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
          float U = 0.f;
#pragma unroll
          for (int dz = 0; dz < 2; ++dz) {
            if (!tz.v[dz]) continue;
            win[4 * dx + 2 * dy + dz] += fixed_of(__fmul_rn(s.w[t], d[dz]),
                                                  scale);
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
  if (have)
#pragma unroll
    for (int k = 0; k < 8; ++k) leave(k);
  __syncthreads();
  // the brick's dvol, one integer atomic per nonzero entry, in [G*G, B*G]
  for (int i = tid; i < kSpan * kSpan * B * kSpan; i += kBwdThreads) {
    const int rz = i % kSpan, t = i / kSpan, bb = t % B, rxy = t / B;
    const int rx = rxy % kSpan, ry = rxy / kSpan;
    const int x = ox + rx, y = oy + ry, z = oz + rz;
    if (x >= G || y >= G || z >= G) continue;
    const unsigned long long val = fixed_pair(
        s_tile + 2 * (((ry * kSpan + rx) * kSpan + rz) * kTileRow + bb));
    if (val) atomicAdd(acc + ((size_t)(y * G + x) * B + bb) * G + z, val);
  }
  if constexpr (K > 0) {
    // drmat: each lane's row (its warp's samples in order), the warps in
    // order, into this CTA's slot
    __syncthreads();   // s_tile is read: its memory takes the warps' rows
    if (live)
#pragma unroll
      for (int j = 0; j < J; ++j) s_drw[(warp * B + b) * J + j] = drm[j];
    __syncthreads();
    for (int i = tid; i < B * J; i += kBwdThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w)
        sum = __fadd_rn(sum, s_drw[w * B * J + i]);
      drm_slots[(size_t)i * gridDim.x + chunk] = sum;   // entry-major
    }
  }
}

// dvol [G*G, B*G] f32 from the fixed-point accumulators (blocks [0,
// nconv)); with K > 0, block nconv + i: drmat entry i, the slots of the
// tap CTAs that ran (cstart[nbricks] of them) folded in a fixed order
// (`fold_slot`).
__global__ void __launch_bounds__(kFoldThreads)
tap_finish_kernel(const unsigned long long* __restrict__ acc,
                  const unsigned* __restrict__ ctl,
                  const int* __restrict__ cstart,
                  const float* __restrict__ drm_slots,
                  float* __restrict__ dvol, float* __restrict__ drmat, int n,
                  int B, int G, int K, int nbricks, int slot_stride,
                  int nconv) {
  if ((int)blockIdx.x < nconv) {
    __shared__ FixedScale s_fs;
    if (threadIdx.x == 0) s_fs = tap_scale(ctl, K, G, n);
    __syncthreads();
    const int i = blockIdx.x * kFoldThreads + threadIdx.x;
    if (i < G * G * B * G) dvol[i] = fixed_value(acc[i], s_fs);
    return;
  }
  const int i = blockIdx.x - nconv;
  const float sum = fold_slot(drm_slots + (size_t)i * slot_stride,
                              cstart[nbricks]);
  if (threadIdx.x == 0) drmat[i] = sum;
}

constexpr int scatter_smem(int K) {
  return 2 * kVox * kTileRow * (int)sizeof(unsigned) >
                 kBwdWarps * kMaxBones * 12 * K * (int)sizeof(float)
             ? 2 * kVox * kTileRow * (int)sizeof(unsigned)
             : kBwdWarps * kMaxBones * 12 * K * (int)sizeof(float);
}
static_assert(scatter_smem(2) <= 48 * 1024 &&
                  kMaxSmemBins * (int)sizeof(int) <= 48 * 1024 &&
                  kMaxWarpBins * kBinWarps * (int)sizeof(int) <= 48 * 1024,
              "the backward's shared memory needs no opt-in");

// The backward's scratch: [int64 accumulators G*G*B*G | kCtlWords control
// words], zeroed together, then int32 counts | offs | cstart (nbricks + 1)
// | order (n) | hist (bin CTAs x nbricks) | the scatter's warp counters
// past kMaxWarpBins bricks (bin CTAs x 8 x nbricks, zeroed), then f32
// drmat slots (tap CTAs x B*12K); offsets in 4-byte words.
struct TapScratch {
  int nb, nbricks, smem_bins, warp_bins, nbin, grid;
  size_t ctl, counts, offs, cstart, order, hist, wcg, slots, total;
};

inline TapScratch tap_scratch(int n, int B, int G, int K) {
  TapScratch t;
  t.nb = (G + kBrick - 1) / kBrick;
  t.nbricks = t.nb * t.nb * t.nb;
  t.smem_bins = t.nbricks <= kMaxSmemBins ? t.nbricks : 0;
  t.warp_bins = t.nbricks <= kMaxWarpBins ? t.nbricks : 0;
  t.nbin = (n + kBinThreads * kBinRows - 1) / (kBinThreads * kBinRows);
  // at most one partial chunk per brick beyond the full ones; the CTAs
  // past the real count exit
  t.grid = (n + kChunk - 1) / kChunk + t.nbricks;
  t.ctl = 2 * (size_t)G * G * B * G;
  t.counts = t.ctl + kCtlWords;
  t.offs = t.counts + t.nbricks;
  t.cstart = t.offs + t.nbricks;
  t.order = t.cstart + t.nbricks + 1;
  t.hist = t.order + n;
  t.wcg = t.hist + (size_t)t.nbin * t.nbricks;
  t.slots = t.wcg + (t.warp_bins ? 0 : (size_t)t.nbin * kBinWarps * t.nbricks);
  t.total = t.slots + (size_t)t.grid * B * 12 * K;
  return t;
}

template <typename VT>
int launch_bwd(const float* pts, const VT* img, const float* grad,
               const float* rmat, const int* k0, int* scratch, float* dpts,
               float* dvol, float* drmat, int n, int B, int G, int K,
               cudaStream_t s) {
  const TapScratch t = tap_scratch(n, B, G, K);
  const int bin_smem = t.smem_bins * (int)sizeof(int);
  const int smem = scatter_smem(K);
  auto* acc = reinterpret_cast<unsigned long long*>(scratch);
  auto* ctl = reinterpret_cast<unsigned*>(scratch + t.ctl);
  int* counts = scratch + t.counts;
  int* offs = scratch + t.offs;
  int* cstart = scratch + t.cstart;
  int* order = scratch + t.order;
  int* hist = scratch + t.hist;
  int* wcg = scratch + t.wcg;
  float* slots = reinterpret_cast<float*>(scratch + t.slots);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (t.ctl + kCtlWords) * 4, s);
  if (e == cudaSuccess && !t.smem_bins)
    e = cudaMemsetAsync(hist, 0, (size_t)t.nbin * t.nbricks * 4, s);
  if (e == cudaSuccess && !t.warp_bins)
    e = cudaMemsetAsync(wcg, 0, (size_t)t.nbin * kBinWarps * t.nbricks * 4,
                        s);
  if (e != cudaSuccess) return static_cast<int>(e);
  bin_count_kernel<<<t.nbin, kBinThreads, bin_smem, s>>>(
      pts, k0, grad, K ? 3 * K + 1 : B, dpts, hist, ctl, n, G, t.nb,
      t.nbricks, t.smem_bins);
  bin_colscan_kernel<<<(t.nbricks + 31) / 32, 32 * kColWarps, 0, s>>>(
      hist, t.nbin, counts, t.nbricks);
  bin_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, offs, cstart, rmat,
                                             K ? B * 12 * K : 0, ctl,
                                             t.nbricks);
  bin_scatter_kernel<<<t.nbin, kBinThreads,
                       t.warp_bins * kBinWarps * (int)sizeof(int), s>>>(
      pts, k0, hist, offs, wcg, order, n, G, t.nb, t.nbricks, t.warp_bins);
  switch (K) {
    case 0:
      tap_bwd_kernel<VT, 0><<<t.grid, kBwdThreads, smem, s>>>(
          pts, img, grad, rmat, counts, offs, cstart, order, ctl, dpts, acc,
          slots, n, B, G, t.nb, t.nbricks);
      break;
    case 1:
      tap_bwd_kernel<VT, 1><<<t.grid, kBwdThreads, smem, s>>>(
          pts, img, grad, rmat, counts, offs, cstart, order, ctl, dpts, acc,
          slots, n, B, G, t.nb, t.nbricks);
      break;
    case 2:
      tap_bwd_kernel<VT, 2><<<t.grid, kBwdThreads, smem, s>>>(
          pts, img, grad, rmat, counts, offs, cstart, order, ctl, dpts, acc,
          slots, n, B, G, t.nb, t.nbricks);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nconv = (G * G * B * G + kFoldThreads - 1) / kFoldThreads;
  tap_finish_kernel<<<nconv + B * 12 * K, kFoldThreads, 0, s>>>(
      acc, ctl, cstart, slots, dvol, drmat, n, B, G, K, t.nbricks, t.grid,
      nconv);
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

// int32 words of hosnerf_shared_tap_bwd's scratch (`tap_scratch`).
int hosnerf_shared_tap_scratch(int n, int B, int G, int K) {
  return static_cast<int>(tap_scratch(n, B, G, K).total);
}

// Both backwards. K = 0, row 7: grad = gw [n, B]; rmat, k0, drmat null.
// K = 1, 2, B5: grad = gout [n, 3K+1], rmat [B, 12K], k0 [1] int32 on the
// device, drmat [B, 12K]. dpts [n, 3] stored (rows below the clamped k0 *
// 512 as 0); dvol [G*G, B*G] and drmat written whole. scratch: int32
// [hosnerf_shared_tap_scratch(n, B, G, K)], 8-byte aligned (what needs
// zeroing is zeroed here). Returns cudaGetLastError().
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
