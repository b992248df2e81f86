// Pieces shared by the fused trunk kernels (embed_trunk.cu, the forward;
// embed_trunk_bwd.cu, the backward): the layer metadata the host packs
// (hosnerf_tpu_torch/ops/cuda/mlp.py::_pack_meta), the input stage, the
// Hopper primitives of the bf16 kernels (mbarrier rings fed by
// cp.async.bulk, wgmma on 128-byte-swizzled shared-memory tiles), and the
// forward kernels themselves.
//
// The input stage builds each row's first-layer input in shared memory (Xs)
// in one of three kinds: the fourier PE with the input prepended (kind 0)
// or the hann-windowed PE (kind 1) of x [n, 3], each followed by an aux row
// (B2/B3, replacing mlp.py::fused_embed_trunk); or the raw rows of x
// [n, ex_w] themselves (kind 2, the trunk-only MLP, replacing
// mlp.py::fused_trunk), whose aux columns, if any, hold a copy of the skip
// slice read from x at row stride ex_w.
//
// The forward kernels take STORE = true in the backward's recompute: they
// then write the input row (Xs) and every layer's output (Hs) images to
// device memory for the backward and skip the head.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace trunk {

constexpr int kMaxLayers = 12;
constexpr int kMaxSteps = 320;
constexpr int kMaxOut = 4;
constexpr int kMaxFreq = 32;
constexpr int kSkipTile = 1024;   // k0 counts blocks of this many rows
constexpr float kPi = 3.14159265358979323846f;

struct Layer {     // input = segment 0, then segment 1 if width[1] > 0
  int buf[2];    // 0 = Xs (PE + aux input), 1 = Hs (hidden state)
  int off[2];    // first column in that buffer
  int width[2];  // columns, a multiple of 16
  int kpos[2];   // first packed weight column of the segment
  int K;         // packed weight columns, a multiple of 64
  int w_off;     // element offset of this layer's [HID, K] weights (f32:
                 // its three piece images start at 3 w_off)
  int step0;     // this layer's K-steps are Meta::step[step0 ...]
  int nsteps;
};

struct Meta {
  int L, hid, out_dim;
  int xw;         // Xs columns (multiple of 16): [ex (exp_w) | aux (rest)]
  int exp_w;      // padded PE width
  int ex_w;       // PE width
  int kind;       // 0 fourier (input prepended), 1 hann-windowed, 2 raw
  int F;          // frequencies
  int A;          // aux width
  int aux_stride; // aux row stride in floats (0 broadcasts one row)
  int skip_off;   // kind 2: first x column of the skip slice the aux copies
  int x_stride;   // x row stride in floats: 3, or ex_w for kind 2
  Layer layer[kMaxLayers];
  // K-steps (16 packed columns each), in packed column order: bits
  // 0-15 the byte offset of the A tile in the warpgroup's Xs or Hs image,
  // bit 16 the buffer (1 = Hs), bits 17-18 the step within its 64-column
  // weight chunk, bits 20+ the chunk.
  int n_steps;
  int step[kMaxSteps];
};

// meta: the int32 host array of _pack. Returns false if it is malformed.
inline bool parse_meta(const int* meta, Meta& m) {
  int p = 0;
  m.L = meta[p++];
  m.hid = meta[p++];
  m.out_dim = meta[p++];
  m.xw = meta[p++];
  m.exp_w = meta[p++];
  m.ex_w = meta[p++];
  m.kind = meta[p++];
  m.F = meta[p++];
  m.A = meta[p++];
  m.aux_stride = meta[p++];
  if (m.L < 1 || m.L > kMaxLayers || m.out_dim > kMaxOut || m.F > kMaxFreq)
    return false;
  for (int l = 0; l < m.L; ++l) {
    Layer& ly = m.layer[l];
    for (int s = 0; s < 2; ++s) {
      ly.buf[s] = meta[p++];
      ly.off[s] = meta[p++];
      ly.width[s] = meta[p++];
      ly.kpos[s] = meta[p++];
    }
    ly.K = meta[p++];
    ly.w_off = meta[p++];
    ly.step0 = meta[p++];
    ly.nsteps = meta[p++];
  }
  m.skip_off = meta[p++];
  m.x_stride = m.kind == 2 ? m.ex_w : 3;
  m.n_steps = meta[p++];
  if (m.n_steps < 0 || m.n_steps > kMaxSteps) return false;
  for (int s = 0; s < m.n_steps; ++s) m.step[s] = meta[p++];
  return true;
}

// k0 clamped to [0, n_blocks - 1]; the first row a launch computes.
__device__ __forceinline__ int first_live_row(const int* k0_p, int n) {
  const int n_blocks = (n + kSkipTile - 1) / kSkipTile;
  int k0 = *k0_p;
  k0 = k0 > n_blocks - 1 ? n_blocks - 1 : k0;
  k0 = k0 < 0 ? 0 : k0;
  return k0 * kSkipTile;
}

// The hann window of frequency j ((1 - cos(pi clamp(alpha - j, 0, 1))) / 2),
// or 1 for the plain fourier kind.
__device__ __forceinline__ float pe_window(const Meta& m, float alpha, int j) {
  if (m.kind != 1) return 1.f;
  const float t = fminf(fmaxf(__fsub_rn(alpha, (float)j), 0.f), 1.f);
  return __fdiv_rn(__fsub_rn(1.f, cosf(__fmul_rn(kPi, t))), 2.f);
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernels for Hopper (sm_90a)
// ---------------------------------------------------------------------------
//
// Layouts. Every bf16 tile the tensor cores read is cut into panels of 64
// columns; a panel of a 64-row tile is [64 rows][64 cols] = 8 KB, row r at
// r * 128 bytes, its 16-byte group j stored at group j ^ (r % 8): the
// canonical 128-byte-swizzled layout of wgmma, read K-major along a row or
// MN-major down the rows. The activation tiles in shared memory (Xs, Hs,
// the gradient Gs) are one such image per warpgroup (64 rows, all panels),
// and the backward's device-memory activations (act_x, act_h, gc) are the
// same images, tile after tile, so one bulk copy moves a tile each way. A
// weight chunk is 64 packed columns of one layer, [HID rows][64 cols] in
// the same swizzle (mlp.py::_swizzle128 packs it on the host), so the
// forward reads it K-major (B = W^T) and the backward MN-major (B = W).
//
// Threads. Warpgroups 0 and 1 compute 64 rows each of a 128-row tile;
// warpgroup 2 only issues copies (one thread), with its registers given to
// the others by setmaxnreg. The CTAs are persistent: each walks row tiles
// from the clamped k0 at a stride of the grid, and the producer streams the
// same sequence of weight chunks for every tile through a ring of `stages`
// buffers with full/empty mbarriers, so it fetches the next tile's first
// chunks while the consumers finish the last layer of this one.

constexpr int kTm = 128;             // rows per CTA tile
constexpr int kWgRows = 64;          // rows per consumer warpgroup
constexpr int kPanel = 64 * 64;      // elements of one [64][64] panel
constexpr int kPanelBytes = 2 * kPanel;
constexpr int kWsThreads = 384;      // 2 consumer warpgroups + 1 producer
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;   // opt-in dynamic shared memory per CTA

// Element index of (row r, column c) in a panelled, swizzled 64-row image.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * kPanel + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at p (p's
// 1024-byte atom aligned, or advanced inside it along K by 32-byte steps):
// 8-row groups 1024 bytes apart. Every operand here spans one 64-wide atom
// along its contiguous dimension, so the leading offset is never used.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = (smem_u32(p) & 0x3FFFFu) >> 4;
  return a | (uint64_t)(1024 >> 4) << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// 1-D bulk copy device -> shared memory, completing on an mbarrier.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// 1-D bulk copy shared -> device memory (bulk group of the issuing thread).
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The issuing thread's bulk stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Starts pulling `bytes` at src into L2 (no completion to wait for).
__device__ __forceinline__ void bulk_prefetch_l2(const void* src,
                                                 uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory made visible to wgmma and bulk
// copies (the async proxy).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barrier of `count` threads (one warpgroup: 128).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching accumulators across an async product.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64][N] += A[64][16] B[16][N] with A and B in shared memory (bf16, f32
// accumulate). TA/TB = 1 read the operand MN-major (transposed). The
// accumulator layout: d[4 j + e] is row 16 warp + lane / 4 + 8 (e / 2),
// column 8 j + 2 (lane % 4) + e % 2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 16) wgmma_n16<TA, TB>(d, da, db, 1);
  else if constexpr (N == 32) wgmma_n32<TA, TB>(d, da, db, 1);
  else if constexpr (N == 64) wgmma_n64<TA, TB>(d, da, db, 1);
  else if constexpr (N == 128) wgmma_n128<TA, TB>(d, da, db, 1);
  else wgmma_n256<TA, TB>(d, da, db, 1);
}

// Stage index and phase parity of a walk around the ring.
struct Ring {
  int stage;
  uint32_t phase;
  int n;
  __device__ __forceinline__ void next() {
    if (++stage == n) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

template <int HID>
struct Shape {
  static constexpr int HPn = HID < 64 ? 1 : HID / 64;   // Hs panels
  static constexpr uint32_t kChunk = HID * 128;        // weight chunk bytes
};

__host__ __device__ __forceinline__ int x_panels(const Meta& m) {
  return (m.xw + 63) / 64;
}

// f32 values as three bf16 pieces (the f32 kernels' operands): hi =
// bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), each difference
// exact in f32, so hi + mid + lo holds v's 24 significant bits (|v - hi -
// mid - lo| <= 2^-24 |v|). A tile's pieces are three images of the bf16
// layout, hi first, `ps` elements apart.
__device__ __forceinline__ void split3(float v, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(v);
  const float r = __fsub_rn(v, __bfloat162float(p[0]));
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(p[1])));
}

// Element i of an image as NP pieces: v rounded to bf16 (NP = 1) or split.
template <int NP>
__device__ __forceinline__ void put(__nv_bfloat16* img, int ps, int i,
                                    float v) {
  if constexpr (NP == 1) {
    img[i] = __float2bfloat16_rn(v);
  } else {
    __nv_bfloat16 p[3];
    split3(v, p);
#pragma unroll
    for (int k = 0; k < 3; ++k) img[k * ps + i] = p[k];
  }
}

// Two neighbouring columns (i even) of an image as NP pieces.
template <int NP>
__device__ __forceinline__ void put2(__nv_bfloat16* img, int ps, int i,
                                     float a, float b) {
  if constexpr (NP == 1) {
    *reinterpret_cast<__nv_bfloat162*>(img + i) = __floats2bfloat162_rn(a, b);
  } else {
    __nv_bfloat16 pa[3], pb[3];
    split3(a, pa);
    split3(b, pb);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      __nv_bfloat162 v;
      v.x = pa[k];
      v.y = pb[k];
      *reinterpret_cast<__nv_bfloat162*>(img + k * ps + i) = v;
    }
  }
}

// The f32 value of two neighbouring columns (i even) of a three-piece
// image: (hi + mid) + lo.
__device__ __forceinline__ float2 get2_x3(const __nv_bfloat16* img, int ps,
                                          int i) {
  float2 v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    v[k] = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(img + k * ps + i));
  return make_float2(__fadd_rn(__fadd_rn(v[0].x, v[1].x), v[2].x),
                     __fadd_rn(__fadd_rn(v[0].y, v[1].y), v[2].y));
}

// The first-layer input of 64 rows (from row0) into an Xs image of NP
// pieces (`ps` elements apart), by NT threads (thread wt): one sine and
// one cosine per (row, coordinate, frequency), the windows from the table
// `win` (kind 1), the identity and aux columns copied. Pad columns are
// never written (the image starts zeroed); rows past n hold zeros.
template <int NP, int NT>
__device__ __forceinline__ void input_stage(const Meta& m, __nv_bfloat16* Xs,
                                            int ps, const float* x,
                                            const float* aux, const float* win,
                                            int row0, int n, int wt) {
  if (m.kind == 2) {
    for (int i = wt; i < kWgRows * m.ex_w; i += NT) {
      const int r = i / m.ex_w, c = i - r * m.ex_w, row = row0 + r;
      put<NP>(Xs, ps, swz(r, c), row < n ? x[(size_t)row * m.ex_w + c] : 0.f);
    }
  } else {
    const int idoff = m.kind == 0 ? 3 : 0, per_row = 3 * m.F;
    for (int i = wt; i < kWgRows * per_row; i += NT) {
      const int r = i / per_row, e = i - r * per_row, row = row0 + r;
      const int j = e / 3, cd = e - 3 * j;
      float sv = 0.f, cv = 0.f;
      if (row < n) {
        const float arg = __fmul_rn(x[3 * row + cd], exp2f((float)j));
        sv = sinf(arg);
        cv = cosf(arg);
        if (m.kind == 1) {
          sv = __fmul_rn(sv, win[j]);
          cv = __fmul_rn(cv, win[j]);
        }
      }
      put<NP>(Xs, ps, swz(r, idoff + 6 * j + cd), sv);
      put<NP>(Xs, ps, swz(r, idoff + 6 * j + 3 + cd), cv);
    }
    if (m.kind == 0)
      for (int i = wt; i < kWgRows * 3; i += NT) {
        const int r = i / 3, cd = i - 3 * r, row = row0 + r;
        put<NP>(Xs, ps, swz(r, cd), row < n ? x[3 * row + cd] : 0.f);
      }
  }
  for (int i = wt; i < kWgRows * m.A; i += NT) {
    const int r = i / m.A, a = i - r * m.A, row = row0 + r;
    put<NP>(Xs, ps, swz(r, m.exp_w + a),
            row < n ? aux[(size_t)row * m.aux_stride + a] : 0.f);
  }
}

// Forward. Per tile and warpgroup: the input stage writes Xs; per layer the
// consumers run the layer's K-steps (Meta::step) chunk by chunk as
// wgmma.m64nHIDk16 with A = a 16-column slice of Xs or Hs and B = the
// chunk's [HID][16] slice, then round, add the bias, ReLU and write Hs in
// place (all products that read Hs have completed). The f32 head reduces
// the last layer's values from registers across the four lanes of a row.
template <int HID, bool STORE>
__global__ void __launch_bounds__(kWsThreads, 1)
embed_trunk_bf16(const __grid_constant__ Meta m, const float* __restrict__ x,
                 const float* __restrict__ aux,
                 const float* __restrict__ alpha_p,
                 const int* __restrict__ k0_p,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias,
                 const float* __restrict__ wout,
                 const float* __restrict__ bout, float* __restrict__ out,
                 __nv_bfloat16* __restrict__ act_x,
                 __nv_bfloat16* __restrict__ act_h, int n, int stages) {
  constexpr int HPn = Shape<HID>::HPn;
  constexpr uint32_t kChunk = Shape<HID>::kChunk;
  const int XPn = x_panels(m);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  __nv_bfloat16* Xs0 = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* Hs0 = Xs0 + 2 * XPn * kPanel;
  unsigned char* ring = reinterpret_cast<unsigned char*>(Hs0 + 2 * HPn * kPanel);
  float* Wo = reinterpret_cast<float*>(ring + stages * kChunk);
  float* win = Wo + kMaxOut * HID;                      // hann windows
  uint64_t* full = reinterpret_cast<uint64_t*>(win + kMaxFreq);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  {
    uint4* z = reinterpret_cast<uint4*>(Xs0);
    const int nz = 2 * (XPn + HPn) * kPanelBytes / 16;
    for (int i = tid; i < nz; i += kWsThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (!STORE)
    for (int i = tid; i < m.out_dim * HID; i += kWsThreads) Wo[i] = wout[i];
  if (tid < m.F) win[tid] = pe_window(m, *alpha_p, tid);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n_tiles = (n + kTm - 1) / kTm;
  const int t_first = first_live_row(k0_p, n) / kTm + blockIdx.x;
  const int wg = tid >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (tid == 2 * 128) {
      Ring rp{0, 0u, stages};
      for (int t = t_first; t < n_tiles; t += gridDim.x)
        for (int l = 0; l < m.L; ++l) {
          const Layer& ly = m.layer[l];
          for (int ch = 0; ch < ly.K / 64; ++ch) {
            mbar_wait(empty + rp.stage, rp.phase ^ 1u);
            mbar_expect_tx(full + rp.stage, kChunk);
            bulk_g2s(ring + rp.stage * kChunk,
                     w + ly.w_off + (size_t)ch * HID * 64, kChunk,
                     full + rp.stage);
            rp.next();
          }
        }
    }
  } else {
    reg_alloc<232>();
    const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int bar = 1 + wg;
    __nv_bfloat16* Xs = Xs0 + wg * XPn * kPanel;
    __nv_bfloat16* Hs = Hs0 + wg * HPn * kPanel;
    const size_t T64 = 2 * (size_t)n_tiles;
    Ring rc{0, 0u, stages};
    for (int t = t_first; t < n_tiles; t += gridDim.x) {
      const int row0 = t * kTm + wg * kWgRows;
      const size_t tile64 = 2 * (size_t)t + wg;
      if (STORE && wt == 0) bulk_wait_read();
      named_sync(bar, 128);
      input_stage<1, 128>(m, Xs, 0, x, aux, win, row0, n, wt);
      fence_async();
      named_sync(bar, 128);
      if (STORE && wt == 0)
        bulk_s2g(act_x + tile64 * XPn * kPanel, Xs, XPn * kPanelBytes);

      for (int l = 0; l < m.L; ++l) {
        const Layer& ly = m.layer[l];
        float acc[HID / 2];
#pragma unroll
        for (int i = 0; i < HID / 2; ++i) acc[i] = 0.f;
        int s = ly.step0;
        const int s_end = s + ly.nsteps;
        int prev = -1;
        for (int ch = 0; ch < ly.K / 64; ++ch) {
          mbar_wait(full + rc.stage, rc.phase);
          wgmma_fence();
          const uint64_t bd = sw128_desc(ring + rc.stage * kChunk);
          for (; s < s_end; ++s) {
            const int st = m.step[s];
            if ((st >> 20) != ch) break;
            const unsigned char* a = reinterpret_cast<const unsigned char*>(
                (st >> 16) & 1 ? Hs : Xs);
            wgmma<HID, 0, 0>(acc, sw128_desc(a + (st & 0xffff)),
                             bd + (uint64_t)(((st >> 17) & 3) * 2));
          }
          wgmma_commit();
          if (prev >= 0) {
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(empty + prev);
          }
          prev = rc.stage;
          rc.next();
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + prev);

        // epilogue: round to bf16, add the bf16 bias in bf16, ReLU, into Hs
        if (STORE && wt == 0) bulk_wait_read();
        named_sync(bar, 128);        // every warp's products have read Hs
        const bool head = !STORE && l == m.L - 1;
        float hs[2][kMaxOut] = {};
        const __nv_bfloat162* bl =
            reinterpret_cast<const __nv_bfloat162*>(bias + l * HID);
        const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
#pragma unroll
        for (int nt = 0; nt < HID / 8; ++nt) {
          const int col = nt * 8 + 2 * q;
          const float2 b = __bfloat1622float2(bl[col >> 1]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            // acc -> bf16, + bias in f32 -> bf16, ReLU (pairwise)
            const float2 z = __bfloat1622float2(__floats2bfloat162_rn(
                acc[4 * nt + 2 * half], acc[4 * nt + 2 * half + 1]));
            const __nv_bfloat162 hv = __hmax2(
                __floats2bfloat162_rn(__fadd_rn(z.x, b.x),
                                      __fadd_rn(z.y, b.y)),
                zero2);
            *reinterpret_cast<__nv_bfloat162*>(
                Hs + swz(warp * 16 + g + 8 * half, col)) = hv;
            if (head) {
              const float2 v = __bfloat1622float2(hv);
#pragma unroll
              for (int o = 0; o < kMaxOut; ++o)
                if (o < m.out_dim)
                  hs[half][o] = __fadd_rn(
                      hs[half][o],
                      __fadd_rn(__fmul_rn(v.x, Wo[o * HID + col]),
                                __fmul_rn(v.y, Wo[o * HID + col + 1])));
            }
          }
        }
        if (head) {
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int o = 0; o < kMaxOut; ++o) {
              float v = hs[half][o];
              v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
              v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
              const int row = row0 + warp * 16 + g + 8 * half;
              if (q == 0 && o < m.out_dim && row < n)
                out[(size_t)row * m.out_dim + o] = __fadd_rn(v, bout[o]);
            }
        }
        fence_async();
        named_sync(bar, 128);
        if (STORE && wt == 0)
          bulk_s2g(act_h + ((size_t)l * T64 + tile64) * HPn * kPanel, Hs,
                   HPn * kPanelBytes);
      }
    }
    if (STORE && wt == 0) bulk_wait_all();
  }
}

inline int num_sms() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// Shared memory of the bf16 forward: Xs and Hs images of both warpgroups,
// the weight ring, the head weights, the barriers, 1 KB of alignment slack.
// Canonical (xw 128, HID 256, 3 stages): 32 + 64 + 96 + 4 KB.
inline size_t bf16_fwd_smem(const Meta& m, int hid, int stages) {
  const int hpn = hid < 64 ? 1 : hid / 64;
  return 1024 + (size_t)2 * (x_panels(m) + hpn) * kPanelBytes +
         (size_t)stages * hid * 128 + sizeof(float) * (kMaxOut * hid + kMaxFreq) +
         2 * kMaxStages * sizeof(uint64_t);
}

// The deepest ring (2 to kMaxStages) that fits, or 0.
template <typename F>
inline int ring_depth(F smem_of) {
  for (int s = kMaxStages; s >= 2; --s)
    if (smem_of(s) <= (size_t)kSmemLimit) return s;
  return 0;
}

// ---------------------------------------------------------------------------
// f32 ("highest"): bf16x3 products on wgmma
// ---------------------------------------------------------------------------
//
// Route. An f32 product x y is taken as the six products of bf16 pieces
// (split3) whose size is at least 2^-16 of hi hi: lo hi, hi lo, mid mid,
// mid hi, hi mid and hi hi (piece indices qa + qb <= 2; the dropped terms
// are below 2^-24 of it). Each is exact in the tensor cores' f32 sums, so
// the f32 kernels run the bf16 wgmma machinery above at six products per
// f32 product: 989 / 6 = 165 TFLOP/s of f32 products at the H100's peak,
// 2.5x its 67 TFLOP/s of f32 FMA. This is what the TPU does for
// Precision.HIGHEST.
//
// Accumulation. Tensor cores have been measured to add into their f32
// accumulator with truncation (towards zero, up to an ulp of the running
// sum per product group): a bias that could build up to ~1e-5 of an
// output through eight layers. So the forward sums each 64-column weight
// chunk's 24 products in a fresh accumulator u (pieces in the order lo,
// mid, hi, the hi hi products last) and adds u into the layer's
// accumulator with a rounded FADD: per chunk only the last four wgmmas
// add at u's full size.
//
// Layout. Tiles of 64 rows: the three-piece Xs and Hs images of 128 rows
// would not fit beside the weights. Two consumer warpgroups share the
// tile, each computing half of every layer's output columns (m64n(HID/2));
// the producer streams each weight chunk as three piece images [HID][64],
// lo, mid, hi, through the ring.

constexpr int kTm3 = 64;   // rows per CTA tile of the f32 kernels
constexpr const char* kF32Route = "bf16x3";

template <int HID, bool STORE>
__global__ void __launch_bounds__(kWsThreads, 1)
embed_trunk_x3(const __grid_constant__ Meta m, const float* __restrict__ x,
               const float* __restrict__ aux,
               const float* __restrict__ alpha_p,
               const int* __restrict__ k0_p,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias,
               const float* __restrict__ wout,
               const float* __restrict__ bout, float* __restrict__ out,
               __nv_bfloat16* __restrict__ act_x,
               __nv_bfloat16* __restrict__ act_h, int n, int stages) {
  constexpr int HPn = Shape<HID>::HPn;
  constexpr uint32_t kChunk = Shape<HID>::kChunk;   // one piece of a chunk
  constexpr int NH = HID / 2;                        // columns per warpgroup
  const int XPn = x_panels(m);
  const int XS = XPn * kPanel, HS = HPn * kPanel;   // piece strides
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(base);   // [3] pieces
  __nv_bfloat16* Hs = Xs + 3 * XS;                                // [3] pieces
  unsigned char* ring = reinterpret_cast<unsigned char*>(Hs + 3 * HS);
  float* Wo = reinterpret_cast<float*>(ring + stages * kChunk);
  float* win = Wo + kMaxOut * HID;                 // hann windows
  float* hpart = win + kMaxFreq;                   // [64][kMaxOut] head sums
  uint64_t* full = reinterpret_cast<uint64_t*>(hpart + kTm3 * kMaxOut);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  {
    uint4* z = reinterpret_cast<uint4*>(Xs);
    const int nz = 3 * (XPn + HPn) * kPanelBytes / 16;
    for (int i = tid; i < nz; i += kWsThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (!STORE)
    for (int i = tid; i < m.out_dim * HID; i += kWsThreads) Wo[i] = wout[i];
  if (tid < m.F) win[tid] = pe_window(m, *alpha_p, tid);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n_tiles = (n + kTm3 - 1) / kTm3;
  const int t_first = first_live_row(k0_p, n) / kTm3 + blockIdx.x;
  const int wg = tid >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (tid == 2 * 128) {
      Ring rp{0, 0u, stages};
      for (int t = t_first; t < n_tiles; t += gridDim.x)
        for (int l = 0; l < m.L; ++l) {
          const Layer& ly = m.layer[l];
          const __nv_bfloat16* wl = w + 3 * (size_t)ly.w_off;
          for (int ch = 0; ch < ly.K / 64; ++ch)
            for (int pb = 2; pb >= 0; --pb) {   // lo, mid, hi
              mbar_wait(empty + rp.stage, rp.phase ^ 1u);
              mbar_expect_tx(full + rp.stage, kChunk);
              bulk_g2s(ring + rp.stage * kChunk,
                       wl + (size_t)(3 * ch + pb) * HID * 64, kChunk,
                       full + rp.stage);
              rp.next();
            }
        }
    }
  } else {
    reg_alloc<232>();
    const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const uint32_t bhalf = wg * NH * 128;   // this warpgroup's weight rows
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(Xs);
    const unsigned char* hb = reinterpret_cast<const unsigned char*>(Hs);
    Ring rc{0, 0u, stages};
    for (int t = t_first; t < n_tiles; t += gridDim.x) {
      const int row0 = t * kTm3;
      if (STORE && tid == 0) bulk_wait_read();
      named_sync(1, 256);
      input_stage<3, 256>(m, Xs, XS, x, aux, win, row0, n, tid);
      fence_async();
      named_sync(1, 256);
      if (STORE && tid == 0)
        bulk_s2g(act_x + (size_t)t * 3 * XS, Xs, 3 * XPn * kPanelBytes);

      for (int l = 0; l < m.L; ++l) {
        const Layer& ly = m.layer[l];
        float acc[NH / 2], u[NH / 2];
#pragma unroll
        for (int i = 0; i < NH / 2; ++i) acc[i] = 0.f;
        int s = ly.step0;
        const int s_end = s + ly.nsteps;
        for (int ch = 0; ch < ly.K / 64; ++ch) {
          const int c0 = s;
          while (s < s_end && (m.step[s] >> 20) == ch) ++s;
#pragma unroll
          for (int i = 0; i < NH / 2; ++i) u[i] = 0.f;
          int prev = -1;
          for (int pb = 2; pb >= 0; --pb) {   // weight piece: lo, mid, hi
            mbar_wait(full + rc.stage, rc.phase);
            wgmma_fence();
            const uint64_t bd = sw128_desc(ring + rc.stage * kChunk + bhalf);
            for (int pa = 2 - pb; pa >= 0; --pa)   // hi hi last
              for (int k = c0; k < s; ++k) {
                const int st = m.step[k];
                const unsigned char* a =
                    (st >> 16) & 1 ? hb + pa * 2 * HS : xb + pa * 2 * XS;
                wgmma<NH, 0, 0>(u, sw128_desc(a + (st & 0xffff)),
                                bd + (uint64_t)(((st >> 17) & 3) * 2));
              }
            wgmma_commit();
            if (prev >= 0) {
              wgmma_wait<1>();
              if (lane == 0) mbar_arrive(empty + prev);
            }
            prev = rc.stage;
            rc.next();
          }
          wgmma_wait<0>();
          fence_regs(u);
          if (lane == 0) mbar_arrive(empty + prev);
#pragma unroll
          for (int i = 0; i < NH / 2; ++i) acc[i] = __fadd_rn(acc[i], u[i]);
        }

        // epilogue: bias, ReLU, split into Hs in place (both warpgroups'
        // products have read it); the head from the f32 values
        if (STORE && tid == 0) bulk_wait_read();
        named_sync(1, 256);
        const bool head = !STORE && l == m.L - 1;
        float hs[2][kMaxOut] = {};
        const float* bl = bias + l * HID + wg * NH;
#pragma unroll
        for (int nt = 0; nt < NH / 8; ++nt) {
          const int col = nt * 8 + 2 * q, gcol = wg * NH + col;
          const float2 b = *reinterpret_cast<const float2*>(bl + col);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float v0 = fmaxf(__fadd_rn(acc[4 * nt + 2 * half], b.x), 0.f);
            const float v1 =
                fmaxf(__fadd_rn(acc[4 * nt + 2 * half + 1], b.y), 0.f);
            put2<3>(Hs, HS, swz(warp * 16 + g + 8 * half, gcol), v0, v1);
            if (head) {
#pragma unroll
              for (int o = 0; o < kMaxOut; ++o)
                if (o < m.out_dim)
                  hs[half][o] = __fadd_rn(
                      hs[half][o],
                      __fadd_rn(__fmul_rn(v0, Wo[o * HID + gcol]),
                                __fmul_rn(v1, Wo[o * HID + gcol + 1])));
            }
          }
        }
        if (head) {
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int o = 0; o < kMaxOut; ++o) {
              float v = hs[half][o];
              v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
              v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
              hs[half][o] = v;
              if (wg == 1 && q == 0)
                hpart[(warp * 16 + g + 8 * half) * kMaxOut + o] = v;
            }
          named_sync(1, 256);
          if (wg == 0 && q == 0)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = warp * 16 + g + 8 * half, row = row0 + r;
#pragma unroll
              for (int o = 0; o < kMaxOut; ++o)
                if (o < m.out_dim && row < n)
                  out[(size_t)row * m.out_dim + o] = __fadd_rn(
                      __fadd_rn(hs[half][o], hpart[r * kMaxOut + o]),
                      bout[o]);
            }
        }
        fence_async();
        named_sync(1, 256);
        if (STORE && tid == 0)
          bulk_s2g(act_h + ((size_t)l * n_tiles + t) * 3 * HS, Hs,
                   3 * HPn * kPanelBytes);
      }
    }
    if (STORE && tid == 0) bulk_wait_all();
  }
}

// Shared memory of the f32 forward: the three-piece Xs and Hs images of a
// 64-row tile, the ring of weight pieces, the head weights and sums, the
// barriers, 1 KB of alignment slack. Canonical (xw 128, HID 256, 2
// stages): 48 + 96 + 64 + 5 KB.
inline size_t x3_fwd_smem(const Meta& m, int hid, int stages) {
  const int hpn = hid < 64 ? 1 : hid / 64;
  return 1024 + (size_t)3 * (x_panels(m) + hpn) * kPanelBytes +
         (size_t)stages * hid * 128 +
         sizeof(float) * (kMaxOut * hid + kMaxFreq + kTm3 * kMaxOut) +
         2 * kMaxStages * sizeof(uint64_t);
}

// One forward launch (act_x/act_h null unless STORE): a persistent grid of
// at most one CTA per SM; bf16 weights `w` are chunk images, f32 ones
// (bf16 pieces) three piece images per chunk, with f32 biases `b`.
template <int HID, bool STORE>
int launch_fwd(const Meta& m, int bf16, const float* x, const float* aux,
               const float* alpha, const int* k0, const void* w,
               const void* b, const float* wout, const float* bout,
               float* out, void* act_x, void* act_h, int n, cudaStream_t s) {
  if (bf16) {
    const int stages =
        ring_depth([&](int st) { return bf16_fwd_smem(m, HID, st); });
    if (stages == 0 || m.xw > 256) return (int)cudaErrorInvalidValue;
    const size_t smem = bf16_fwd_smem(m, HID, stages);
    cudaError_t e = cudaFuncSetAttribute(
        embed_trunk_bf16<HID, STORE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int tiles = (n + kTm - 1) / kTm;
    const dim3 grid(tiles < num_sms() ? tiles : num_sms());
    embed_trunk_bf16<HID, STORE><<<grid, kWsThreads, smem, s>>>(
        m, x, aux, alpha, k0, static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), wout, bout, out,
        static_cast<__nv_bfloat16*>(act_x), static_cast<__nv_bfloat16*>(act_h),
        n, stages);
  } else {
    const int stages =
        ring_depth([&](int st) { return x3_fwd_smem(m, HID, st); });
    if (stages == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = x3_fwd_smem(m, HID, stages);
    cudaError_t e = cudaFuncSetAttribute(
        embed_trunk_x3<HID, STORE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int tiles = (n + kTm3 - 1) / kTm3;
    const dim3 grid(tiles < num_sms() ? tiles : num_sms());
    embed_trunk_x3<HID, STORE><<<grid, kWsThreads, smem, s>>>(
        m, x, aux, alpha, k0, static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(b), wout, bout, out,
        static_cast<__nv_bfloat16*>(act_x), static_cast<__nv_bfloat16*>(act_h),
        n, stages);
  }
  return (int)cudaGetLastError();
}

}  // namespace trunk
