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
// The TPU kernels build one-hot tap rows and contract them on the MXU, pack
// 128/G bones on the vector lanes and walk a compacted (tile, bone-quad)
// pair table so dead pairs cost nothing. On Hopper a tap is a gather, and a
// (sample, bone) pair's work (~75 flops forward, ~250 backward) is little
// for the card: the bounds at the model's shapes are the bytes of the
// per-sample rows (forward) and the f32 operations (backward), a few
// microseconds each. Both kernels are bound by instruction issue and
// latency instead. The first design of this file (one thread per sample
// over every bone) also ran B affines and support tests for every
// row of the dead prefix, paid up to 8 dependent 2-byte gathers per live
// pair, and in the backward up to 8 device atomics per pair and 60
// shuffles per bone, with a few thousand warps holding live rows.
//
// The corner image. Both kernels read the volume from one relaid copy,
// [B, P, P, P, 8] with P = G + 1: entry (b, cx, cy, cz) holds the 8 corners
// of grid cell floor(f) = (cx, cy, cz) - 1, corner k = 4 dx + 2 dy + dz at
// voxel (cx - 1 + dx, cy - 1 + dy, cz - 1 + dz), zero where a corner lies
// off the grid. A live pair costs one 16-byte load (bf16; two in f32).
// `inv_image_kernel` builds it in one launch (cast and zero padding; the
// autograd forward keeps it for the backward): 15.0 MB in bf16 at B = 26,
// G = 32, resident in the 50 MB L2. A pair is live when floor(f) lies in
// [-1, G-1] on every axis; any other pair has every corner off the grid,
// so its weight, its shares of dvol and its gradients are exactly 0 (the
// plain versions add them as zeros; the JAX kernels' support test widened
// by PG_EPS admits a subset of such pairs too).
//
// Live suffix. k0 (a device int, in blocks of kTile rows; null for 0) is
// clamped to [0, n_blocks - 1]. Rows below k0 * kTile are dead by the
// sorted domain's invariant: the forward stores them as zeros, the backward
// stores their dpts as zeros and adds nothing, neither computes them.
//
// Forward (B1): one thread per sample walks the bones in order (their
// affines as float4 rows in shared memory), one image load per live pair.
// Keeping several bones' loads in flight per thread measured slower: the
// registers it takes cost more warps than the loads gain (PERF.md).
//
// Backward (B4): a warp walks kRowsPerWarp samples with lane = bone, so a
// sample's live pairs run side by side and the lane's dRg/dTg sums stay in
// its registers. Per sample the lanes' shares of dpts are summed by
// shuffles.
//
// Sums over samples, in an order no schedule moves (the TPU kernel carries
// them across its sequential grid in one order). dRg/dTg: fixed-order
// partial sums. A lane's registers sum its warp's rows in row order; the
// CTA sums its warps in warp order in shared memory and stores the result
// to its own slot; `inv_fold_kernel` sums the slots in index order
// (`fold_slot`, lbs_common.cuh). dvol: fixed point. A lane rounds each
// of the 8 tap shares of its cell's corners to an int64 multiple of 2^-e
// and sums them exactly over its rows (a warp's rows are neighbouring
// samples of a ray, which often share a cell or a face); when its cell
// changes it keeps the corners the new cell shares and adds each other
// in-grid corner's sum to an int64 accumulator per voxel [B, G, G, G]
// with one integer atomic: dvol is the exact sum of the rounded shares,
// whatever the rows' order (the sorted and the dense paths give the same
// bits). Its scale comes from
// `inv_gmax_kernel`, the largest |gacc| entry of the live rows, by the
// bound |share| <= |gw| <= M (3G + 1) (|f| <= G for a live pair, the
// weight w <= 1; 1% added for the bf16 roundings), at most n shares per
// voxel. One memset zeroes the accumulators and the max; `inv_fold_kernel`
// converts dvol to f32 and folds the slots.
// These sums are scattered over 852 k voxels, where per-CTA copies would
// not fit; one integer atomic per corner sum keeps the traffic of one add
// per share.
//
// Numerics. Every per-pair sum and product uses explicit round-to-nearest
// intrinsics (no FMA contraction), in the order of the plain versions
// hosnerf_tpu_torch/ops/cuda/lbs.py::inverse_core_plain and
// inverse_core_bwd_plain. bf16 reproduces the TPU kernels' bf16 matmul
// semantics: the xy tap products hx*hy, dhat(fx)*hy, hx*dhat(fy), the
// volume and the dvol factor gw*hz are rounded to bf16; every sum is f32.
// highest is f32 throughout (the same image layout, f32 entries). The
// forward agrees with its plain version bit for bit: its sum over bones is
// the plain version's, and the plain version's off-grid taps add zeros,
// as the image's padding does. The backward's sums over bones (dpts, by
// shuffles) and over samples (dRg, dTg: registers, shared memory, slots,
// their multiply-adds fused; dvol: fixed point, exact but for each
// share's rounding to 2^-e) take another order than the plain version's,
// the same one on every run.

#include "lbs_common.cuh"

namespace {

using namespace hosnerf;

constexpr int kTile = 1024;         // k0 counts blocks of this many rows
constexpr int kFwdThreads = 256;
constexpr int kImageThreads = 256;
constexpr int kBwdWarps = 8;
constexpr int kBwdCtasPerSm = 3;   // 24 warps an SM: at most 85 registers
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kRowsPerWarp = 16;
constexpr int kBwdRows = kBwdWarps * kRowsPerWarp;  // rows per backward CTA
constexpr int kMaxThreads = 256;     // inv_gmax_kernel
constexpr int kMaxRows = 8;
static_assert(kMaxBones <= 32, "the backward puts one bone on each lane");

// The 8 corners of one image entry, loaded whole.
template <typename VT>
struct Corners;

template <>
struct Corners<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* img, int cell) {
    u = __ldg(reinterpret_cast<const uint4*>(img) + cell);
  }
  __device__ __forceinline__ void unpack(float (&v)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

template <>
struct Corners<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* img, int cell) {
    a = __ldg(reinterpret_cast<const float4*>(img) + 2 * cell);
    b = __ldg(reinterpret_cast<const float4*>(img) + 2 * cell + 1);
  }
  __device__ __forceinline__ void unpack(float (&v)[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// f = ((x R0 + y R1) + z R2) + T for one row (R0, R1, R2, T) of a bone's
// grid affine, without contraction, in the plain versions' order.
__device__ __forceinline__ float affine4(float x, float y, float z,
                                         float4 r) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, r.x), __fmul_rn(y, r.y)),
                             __fmul_rn(z, r.z)), r.w);
}

// The image cell of one axis, floor(f) + 1, and whether floor(f) lies in
// [-1, G-1] (false for NaN).
__device__ __forceinline__ bool axis_cell(float f, int G, int& c) {
  const float f0 = floorf(f);
  c = (int)f0 + 1;
  return f0 >= -1.f && f0 <= (float)(G - 1);
}

// Hat weights at floor(f) and floor(f) + 1 (lbs_common.cuh::make_taps).
__device__ __forceinline__ void hats(float f, float (&h)[2]) {
  const float f0 = floorf(f);
  h[0] = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(f, f0))));
  h[1] = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(f, __fadd_rn(f0, 1.f)))));
}

// img[b][cx][cy][cz][k] = vol[b, x*G + y, z] at (x, y, z) = (cx, cy, cz) - 1
// + (dx, dy, dz), k = 4 dx + 2 dy + dz; 0 off the grid. One thread per
// entry.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kImageThreads)
inv_image_kernel(const TI* __restrict__ vol, TO* __restrict__ img, int B,
                 int G) {
  const int P = G + 1;
  const int cell = blockIdx.x * kImageThreads + threadIdx.x;
  if (cell >= B * P * P * P) return;
  const int cz = cell % P, cy = cell / P % P, cx = cell / (P * P) % P;
  const int b = cell / (P * P * P);
  __align__(16) TO v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int x = cx - 1 + (k >> 2), y = cy - 1 + ((k >> 1) & 1),
              z = cz - 1 + (k & 1);
    const bool on = x >= 0 && x < G && y >= 0 && y < G && z >= 0 && z < G;
    v[k] = from_f<TO>(on ? to_f(vol[((size_t)b * G * G + x * G + y) * G + z])
                         : 0.f);
  }
  uint4* dst = reinterpret_cast<uint4*>(img + (size_t)cell * 8);
  const uint4* src = reinterpret_cast<const uint4*>(v);
#pragma unroll
  for (int q = 0; q < (int)(8 * sizeof(TO) / 16); ++q) dst[q] = src[q];
}

// B1: out [n] float4 = (acc_x, acc_y, acc_z, wsum), every row written.
template <typename VT>
__global__ void __launch_bounds__(kFwdThreads)
inv_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ rg,
               const float* __restrict__ tg, const VT* __restrict__ img,
               const int* __restrict__ k0, float4* __restrict__ out, int n,
               int B, int G) {
  __shared__ float4 s_bone[kMaxBones * 3];  // rows (Rc0, Rc1, Rc2, Tc)
  const int row0 = blockIdx.x * kFwdThreads;
  const int row = row0 + threadIdx.x;
  const int first = k0 ? first_live_row(k0, n, kTile) : 0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row0 + kFwdThreads <= first) {  // the whole CTA is dead prefix
    if (row < n) out[row] = zero;
    return;
  }
  for (int i = threadIdx.x; i < B * 3; i += kFwdThreads)
    s_bone[i] = make_float4(rg[3 * i], rg[3 * i + 1], rg[3 * i + 2], tg[i]);
  __syncthreads();
  if (row >= n) return;
  if (row < first) {
    out[row] = zero;
    return;
  }
  const float x = pts[3 * row], y = pts[3 * row + 1], z = pts[3 * row + 2];
  const int P = G + 1;
  float ax = 0.f, ay = 0.f, az = 0.f, aw = 0.f;
  for (int b = 0; b < B; ++b) {
    float f[3];
    int cx, cy, cz;
#pragma unroll
    for (int c = 0; c < 3; ++c) f[c] = affine4(x, y, z, s_bone[3 * b + c]);
    if (!(axis_cell(f[0], G, cx) & axis_cell(f[1], G, cy) &
          axis_cell(f[2], G, cz)))
      continue;
    Corners<VT> e;
    e.load(img, ((b * P + cx) * P + cy) * P + cz);
    float v[8], hx[2], hy[2], hz[2];
    hats(f[0], hx);
    hats(f[1], hy);
    hats(f[2], hz);
    e.unpack(v);
    float zc0 = 0.f, zc1 = 0.f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float w = round_tap(__fmul_rn(hx[dx], hy[dy]), img);
        zc0 = __fadd_rn(zc0, __fmul_rn(w, v[4 * dx + 2 * dy]));
        zc1 = __fadd_rn(zc1, __fmul_rn(w, v[4 * dx + 2 * dy + 1]));
      }
    }
    const float wb = __fadd_rn(__fmul_rn(hz[0], zc0), __fmul_rn(hz[1], zc1));
    ax = __fadd_rn(ax, __fmul_rn(wb, f[0]));
    ay = __fadd_rn(ay, __fmul_rn(wb, f[1]));
    az = __fadd_rn(az, __fmul_rn(wb, f[2]));
    aw = __fadd_rn(aw, wb);
  }
  out[row] = make_float4(ax, ay, az, aw);
}

// The bound of one dvol share over the largest |gacc| entry (see above).
__device__ __forceinline__ double share_factor(int G) {
  return 1.01 * (3.0 * G + 1.0);
}

// The largest |gacc| entry over rows from the clamped k0 * kTile on, as
// bits into *m (zeroed by the launcher).
__global__ void __launch_bounds__(kMaxThreads)
inv_gmax_kernel(const float4* __restrict__ gacc, const int* __restrict__ k0,
                unsigned* __restrict__ m, int n) {
  const int first = k0 ? first_live_row(k0, n, kTile) : 0;
  const int base = blockIdx.x * kMaxThreads * kMaxRows + threadIdx.x;
  unsigned b = 0;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    const int row = base + r * kMaxThreads;
    if (row >= first && row < n) {
      const float4 g = gacc[row];
      b = max(max(b, max(abs_bits(g.x), abs_bits(g.y))),
              max(abs_bits(g.z), abs_bits(g.w)));
    }
  }
  warp_max_bits(m, b);
}

// B4: dpts [n, 3] written for every row; this CTA's dRg/dTg sums stored to
// its slot of `rep` ([B, 12][grid]: entry (b, j) = dRg row-major [c][k],
// then dTg[c], its slots contiguous), zeros for a dead CTA; the dvol shares added in fixed point to `acc`
// [B, G, G, G] (zeroed by the launcher, scaled from *gmax).
template <typename VT>
__global__ void __launch_bounds__(kBwdThreads, kBwdCtasPerSm)
inv_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ rg,
               const float* __restrict__ tg, const VT* __restrict__ img,
               const float4* __restrict__ gacc, const int* __restrict__ k0,
               const unsigned* __restrict__ gmax, float* __restrict__ dpts,
               float* __restrict__ rep, unsigned long long* __restrict__ acc,
               int n, int B, int G) {
  __shared__ float s_d[kBwdWarps][12][32];
  __shared__ float4 s_bone[kMaxBones * 3];  // rows (Rc0, Rc1, Rc2, Tc)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kBwdRows;
  const int first = k0 ? first_live_row(k0, n, kTile) : 0;
  float* slot = rep + blockIdx.x;   // entry i at slot[i * gridDim.x]
  if (row0 + kBwdRows <= first) {  // the whole CTA is dead prefix
    for (int i = threadIdx.x; i < 3 * kBwdRows; i += kBwdThreads)
      if (3 * row0 + i < 3 * n) dpts[3 * row0 + i] = 0.f;
    for (int i = threadIdx.x; i < B * 12; i += kBwdThreads)
      slot[(size_t)i * gridDim.x] = 0.f;
    return;
  }
  __shared__ float s_scale;
  if (threadIdx.x == 0)
    s_scale = fixed_scale(*gmax, share_factor(G), (double)n).scale;
  for (int i = threadIdx.x; i < B * 3; i += kBwdThreads)
    s_bone[i] = make_float4(rg[3 * i], rg[3 * i + 1], rg[3 * i + 2], tg[i]);
  __syncthreads();
  const float scale = s_scale;
  const bool bone = lane < B;
  unsigned long long* lane_acc = acc + (size_t)(bone ? lane : 0) * G * G * G;
  const float4* rt = s_bone + 3 * (bone ? lane : 0);  // the lane's bone
  float d[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) d[j] = 0.f;
  const int P = G + 1;
  const float dh[2] = {-1.f, 1.f};
  // dvol shares of the lane's 8 corner voxels (corner k = 4 dx + 2 dy +
  // dz of its current cell), each rounded to fixed point and summed
  // exactly over its rows (a warp's rows are neighbouring samples of a
  // ray). When the cell changes, the corners the new cell shares with the
  // old one keep their sums (a step to a face neighbour keeps 4), and the
  // others are added to the accumulators (`move`, then `flush` at the
  // end): 3.7 M integer atomics at the training shapes against 6.1 M at
  // one per corner and cell.
  int cell = -1, ox = 0, oy = 0, oz = 0;
  unsigned long long sh[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sh[k] = 0ull;
  auto add = [&](int k) {   // corner k's sum, if it is on the grid
    const int x = ox - 1 + (k >> 2), y = oy - 1 + ((k >> 1) & 1),
              z = oz - 1 + (k & 1);
    if (sh[k] && (unsigned)x < (unsigned)G && (unsigned)y < (unsigned)G &&
        (unsigned)z < (unsigned)G)
      atomicAdd(lane_acc + (x * G + y) * G + z, sh[k]);
  };
  auto flush = [&]() {
    if (cell < 0) return;
#pragma unroll
    for (int k = 0; k < 8; ++k) add(k);
  };
  // to the cell (nx, ny, nz): corner k of the old cell is corner k - d of
  // the new one (d = new - old per axis) where that lies in {0, 1}^3; the
  // other old corners are added, then the window shifts axis by axis
  auto move = [&](int nx, int ny, int nz) {
    const int dx = nx - ox, dy = ny - oy, dz = nz - oz;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (corner_leaves(k, dx, dy, dz)) add(k);
    shift_corners<4>(sh, dx);
    shift_corners<2>(sh, dy);
    shift_corners<1>(sh, dz);
  };

  for (int s = 0; s < kRowsPerWarp; ++s) {
    const int row = row0 + warp * kRowsPerWarp + s;
    if (row >= n) break;
    if (row < first) {
      if (lane < 3) dpts[3 * row + lane] = 0.f;
      continue;
    }
    const float p[3] = {pts[3 * row], pts[3 * row + 1], pts[3 * row + 2]};
    const float4 g = gacc[row];
    const float fx = affine4(p[0], p[1], p[2], rt[0]);
    const float fy = affine4(p[0], p[1], p[2], rt[1]);
    const float fz = affine4(p[0], p[1], p[2], rt[2]);
    int cx, cy, cz;
    const bool live = bone & axis_cell(fx, G, cx) & axis_cell(fy, G, cy) &
                      axis_cell(fz, G, cz);
    float dp[3] = {0.f, 0.f, 0.f};
    if (live) {
      const int here = ((lane * P + cx) * P + cy) * P + cz;
      Corners<VT> e;
      e.load(img, here);
      if (here != cell) {
        if (cell >= 0) move(cx, cy, cz);
        cell = here;
        ox = cx;
        oy = cy;
        oz = cz;
      }
      float v[8], hx[2], hy[2], hz[2];
      hats(fx, hx);
      hats(fy, hy);
      hats(fz, hz);
      const float gw = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(g.x, fx), __fmul_rn(g.y, fy)),
                    __fmul_rn(g.z, fz)), g.w);
      const float gz0 = round_tap(__fmul_rn(gw, hz[0]), img);
      const float gz1 = round_tap(__fmul_rn(gw, hz[1]), img);
      e.unpack(v);
      float zc0 = 0.f, zc1 = 0.f, m20 = 0.f, m21 = 0.f, m30 = 0.f, m31 = 0.f;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const float w = round_tap(__fmul_rn(hx[dx], hy[dy]), img);
          const float wdx = round_tap(__fmul_rn(dh[dx], hy[dy]), img);
          const float wdy = round_tap(__fmul_rn(hx[dx], dh[dy]), img);
          const float v0 = v[4 * dx + 2 * dy], v1 = v[4 * dx + 2 * dy + 1];
          zc0 = __fadd_rn(zc0, __fmul_rn(w, v0));
          m20 = __fadd_rn(m20, __fmul_rn(wdx, v0));
          m30 = __fadd_rn(m30, __fmul_rn(wdy, v0));
          zc1 = __fadd_rn(zc1, __fmul_rn(w, v1));
          m21 = __fadd_rn(m21, __fmul_rn(wdx, v1));
          m31 = __fadd_rn(m31, __fmul_rn(wdy, v1));
          sh[4 * dx + 2 * dy] += fixed_of(__fmul_rn(w, gz0), scale);
          sh[4 * dx + 2 * dy + 1] += fixed_of(__fmul_rn(w, gz1), scale);
        }
      }
      const float wb = __fadd_rn(__fmul_rn(hz[0], zc0), __fmul_rn(hz[1], zc1));
      const float df[3] = {
          __fadd_rn(__fmul_rn(g.x, wb),
                    __fmul_rn(gw, __fadd_rn(__fmul_rn(m20, hz[0]),
                                            __fmul_rn(m21, hz[1])))),
          __fadd_rn(__fmul_rn(g.y, wb),
                    __fmul_rn(gw, __fadd_rn(__fmul_rn(m30, hz[0]),
                                            __fmul_rn(m31, hz[1])))),
          __fadd_rn(__fmul_rn(g.z, wb),
                    __fmul_rn(gw, __fadd_rn(__fmul_rn(-1.f, zc0), zc1)))};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int k = 0; k < 3; ++k) d[3 * c + k] = fmaf(df[c], p[k], d[3 * c + k]);
        d[9 + c] += df[c];
      }
      const float4 r0 = rt[0], r1 = rt[1], r2 = rt[2];
      dp[0] = __fadd_rn(__fadd_rn(__fmul_rn(df[0], r0.x), __fmul_rn(df[1], r1.x)),
                        __fmul_rn(df[2], r2.x));
      dp[1] = __fadd_rn(__fadd_rn(__fmul_rn(df[0], r0.y), __fmul_rn(df[1], r1.y)),
                        __fmul_rn(df[2], r2.y));
      dp[2] = __fadd_rn(__fadd_rn(__fmul_rn(df[0], r0.z), __fmul_rn(df[1], r1.z)),
                        __fmul_rn(df[2], r2.z));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dp[k] += __shfl_xor_sync(kFullMask, dp[k], off);
    }
    if (lane < 3) dpts[3 * row + lane] = lane == 0 ? dp[0] : lane == 1 ? dp[1] : dp[2];
  }
  flush();
#pragma unroll
  for (int j = 0; j < 12; ++j) s_d[warp][j][lane] = d[j];
  __syncthreads();
  for (int i = threadIdx.x; i < B * 12; i += kBwdThreads) {
    const int b = i / 12, j = i % 12;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) sum += s_d[w][j][b];
    slot[(size_t)i * gridDim.x] = sum;
  }
}

// Blocks [0, nconv): dvol [B, G*G, G] from the fixed-point accumulators;
// block nconv + i: entry i of the backward's dRg/dTg slots folded in a
// fixed order (`fold_slot`).
__global__ void __launch_bounds__(kFoldThreads)
inv_fold_kernel(const unsigned long long* __restrict__ acc,
                const unsigned* __restrict__ gmax,
                const float* __restrict__ rep, float* __restrict__ dvol,
                float* __restrict__ drg, float* __restrict__ dtg, int n,
                int B, int G, int nslots, int nconv) {
  if ((int)blockIdx.x < nconv) {
    __shared__ FixedScale s_fs;
    if (threadIdx.x == 0) s_fs = fixed_scale(*gmax, share_factor(G), (double)n);
    __syncthreads();
    const int i = blockIdx.x * kFoldThreads + threadIdx.x;
    if (i < B * G * G * G) dvol[i] = fixed_value(acc[i], s_fs);
    return;
  }
  const int i = blockIdx.x - nconv, b = i / 12, j = i % 12;
  const float sum = fold_slot(rep + (size_t)i * nslots, nslots);
  if (threadIdx.x == 0) {
    if (j < 9) drg[9 * b + j] = sum;
    else dtg[3 * b + j - 9] = sum;
  }
}

// The backward's scratch, in floats: the dvol accumulators (int64), then
// the max (4 floats; both zeroed by one memset) and the per-CTA dRg/dTg
// slots.
int acc_floats(int B, int G) { return 2 * B * G * G * G; }

int bwd_slots(int n) { return (n + kBwdRows - 1) / kBwdRows; }

}  // namespace

extern "C" {

const char* hosnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// f32 elements of the backward's scratch for n rows, B bones, grid size G.
int hosnerf_inverse_bwd_scratch(int n, int B, int G) {
  return acc_floats(B, G) + 4 + bwd_slots(n) * B * 12;
}

// The corner image: vol [B, G*G, G] (bf16 when vol_bf16, else f32) -> img
// [B, G+1, G+1, G+1, 8] (bf16 when img_bf16, else f32). One launch on
// `stream`; returns cudaGetLastError().
int hosnerf_inverse_image(const void* vol, int vol_bf16, void* img,
                          int img_bf16, int B, int G, void* stream) {
  if (B < 1 || B > kMaxBones || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = G + 1;
  const dim3 grid((B * P * P * P + kImageThreads - 1) / kImageThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (vol_bf16 && img_bf16)
    inv_image_kernel<bf, bf><<<grid, kImageThreads, 0, s>>>(
        static_cast<const bf*>(vol), static_cast<bf*>(img), B, G);
  else if (vol_bf16)
    inv_image_kernel<bf, float><<<grid, kImageThreads, 0, s>>>(
        static_cast<const bf*>(vol), static_cast<float*>(img), B, G);
  else if (img_bf16)
    inv_image_kernel<float, bf><<<grid, kImageThreads, 0, s>>>(
        static_cast<const float*>(vol), static_cast<bf*>(img), B, G);
  else
    inv_image_kernel<float, float><<<grid, kImageThreads, 0, s>>>(
        static_cast<const float*>(vol), static_cast<float*>(img), B, G);
  return static_cast<int>(cudaGetLastError());
}

// Forward: pts [n, 3] f32; rg [B, 9]; tg [B, 3]; img the corner image (bf16
// when img_bf16, else f32); k0 a device int or null; out [n, 4] f32, every
// row written. Returns cudaGetLastError().
int hosnerf_inverse_lbs(const float* pts, const float* rg, const float* tg,
                        const void* img, const int* k0, float* out, int n,
                        int B, int G, int img_bf16, void* stream) {
  if (n <= 0) return 0;
  if (B < 1 || B > kMaxBones) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kFwdThreads - 1) / kFwdThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* o = reinterpret_cast<float4*>(out);
  if (img_bf16)
    inv_fwd_kernel<__nv_bfloat16><<<grid, kFwdThreads, 0, s>>>(
        pts, rg, tg, static_cast<const __nv_bfloat16*>(img), k0, o, n, B, G);
  else
    inv_fwd_kernel<float><<<grid, kFwdThreads, 0, s>>>(
        pts, rg, tg, static_cast<const float*>(img), k0, o, n, B, G);
  return static_cast<int>(cudaGetLastError());
}

// Backward: gacc [n, 4] f32 in; dpts [n, 3] (every row), drg [B, 9], dtg
// [B, 3] and dvol [B, G*G, G] f32 out, all written here; scratch
// (hosnerf_inverse_bwd_scratch(n, B, G) floats; what needs zeroing is
// zeroed here). Four device operations on `stream` (memset, the max,
// kernel, fold); returns the first error.
int hosnerf_inverse_lbs_bwd(const float* pts, const float* rg,
                            const float* tg, const void* img,
                            const float* gacc, const int* k0, float* dpts,
                            float* drg, float* dtg, float* dvol,
                            float* scratch, int n, int B, int G, int img_bf16,
                            void* stream) {
  if (B < 1 || B > kMaxBones || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* acc = reinterpret_cast<unsigned long long*>(scratch);
  auto* gmax = reinterpret_cast<unsigned*>(scratch + acc_floats(B, G));
  float* rep = scratch + acc_floats(B, G) + 4;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(float) * (acc_floats(B, G) + 4), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const float4* g = reinterpret_cast<const float4*>(gacc);
    inv_gmax_kernel<<<(n + kMaxThreads * kMaxRows - 1) /
                          (kMaxThreads * kMaxRows),
                      kMaxThreads, 0, s>>>(g, k0, gmax, n);
    const dim3 grid(bwd_slots(n));
    if (img_bf16)
      inv_bwd_kernel<__nv_bfloat16><<<grid, kBwdThreads, 0, s>>>(
          pts, rg, tg, static_cast<const __nv_bfloat16*>(img), g, k0, gmax,
          dpts, rep, acc, n, B, G);
    else
      inv_bwd_kernel<float><<<grid, kBwdThreads, 0, s>>>(
          pts, rg, tg, static_cast<const float*>(img), g, k0, gmax, dpts,
          rep, acc, n, B, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nconv = (B * G * G * G + kFoldThreads - 1) / kFoldThreads;
  inv_fold_kernel<<<nconv + B * 12, kFoldThreads, 0, s>>>(
      acc, gmax, rep, dvol, drg, dtg, n, B, G, bwd_slots(n), nconv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
