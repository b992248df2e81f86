// Pieces shared by the fused trunk kernels (embed_trunk.cu, the forward;
// embed_trunk_bwd.cu, the backward): the layer metadata the host packs
// (hosnerf_tpu_torch/ops/cuda/mlp.py::_pack_meta), cp.async and mma.sync
// helpers, the input stage, and the forward kernels themselves.
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
// then write the bf16/f32 input row (Xs) and every layer's output (Hs) to
// device memory for the backward and skip the head.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace trunk {

constexpr int kMaxLayers = 12;
constexpr int kThreads = 256;
constexpr int kSkipTile = 1024;   // k0 counts blocks of this many rows
constexpr float kPi = 3.14159265358979323846f;

struct Layer {     // input = segment 0, then segment 1 if width[1] > 0
  int buf[2];    // 0 = Xs (PE + aux input), 1 = Hs (hidden state)
  int off[2];    // first column in that buffer
  int width[2];  // columns, a multiple of 16
  int K;         // width[0] + width[1]
  int w_off;     // element offset of this layer's weights
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
  if (m.L < 1 || m.L > kMaxLayers) return false;
  for (int l = 0; l < m.L; ++l) {
    Layer& ly = m.layer[l];
    for (int s = 0; s < 2; ++s) {
      ly.buf[s] = meta[p++];
      ly.off[s] = meta[p++];
      ly.width[s] = meta[p++];
    }
    ly.K = meta[p++];
    ly.w_off = meta[p++];
  }
  m.skip_off = meta[p++];
  m.x_stride = m.kind == 2 ? m.ex_w : 3;
  return true;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// k0 clamped to [0, n_blocks - 1]; the first row a launch computes.
__device__ __forceinline__ int first_live_row(const int* k0_p, int n) {
  const int n_blocks = (n + kSkipTile - 1) / kSkipTile;
  int k0 = *k0_p;
  k0 = k0 > n_blocks - 1 ? n_blocks - 1 : k0;
  k0 = k0 < 0 ? 0 : k0;
  return k0 * kSkipTile;
}

// The PE term of PE column e (< ex_w) without its window: frequency index
// j, coordinate, and whether it is a sine (identity columns: j = -1).
struct PECol {
  int j, coord;
  bool is_sin;
};

__device__ __forceinline__ PECol pe_col(const Meta& m, int e) {
  PECol c;
  if (m.kind == 0) {
    if (e < 3) {
      c.j = -1;
      c.coord = e;
      c.is_sin = false;
      return c;
    }
    e -= 3;
  }
  const int r = e % 6;
  c.j = e / 6;
  c.coord = r % 3;
  c.is_sin = r < 3;
  return c;
}

// The hann window of frequency j ((1 - cos(pi clamp(alpha - j, 0, 1))) / 2),
// or 1 for the plain fourier kind.
__device__ __forceinline__ float pe_window(const Meta& m, float alpha, int j) {
  if (m.kind != 1) return 1.f;
  const float t = fminf(fmaxf(__fsub_rn(alpha, (float)j), 0.f), 1.f);
  return __fdiv_rn(__fsub_rn(1.f, cosf(__fmul_rn(kPi, t))), 2.f);
}

// Value of input column c (Xs layout) for one row, in f32.
__device__ __forceinline__ float input_value(const Meta& m, const float* xr,
                                             const float* auxr, float alpha,
                                             int c) {
  if (c < m.ex_w) {
    if (m.kind == 2) return xr[c];
    const PECol pc = pe_col(m, c);
    if (pc.j < 0) return xr[pc.coord];
    const float arg = __fmul_rn(xr[pc.coord], exp2f((float)pc.j));
    float v = pc.is_sin ? sinf(arg) : cosf(arg);
    if (m.kind == 1) v = __fmul_rn(v, pe_window(m, alpha, pc.j));
    return v;
  }
  const int a = c - m.exp_w;
  if (c >= m.exp_w && a < m.A) return auxr[a];
  return 0.f;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, 128-row tiles
// ---------------------------------------------------------------------------

constexpr int kTmBf16 = 128;
constexpr int kKcBf16 = 64;               // weight K-chunk (columns)
constexpr int kWStrBf16 = kKcBf16 + 8;    // padded row stride (bank spread)

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// rows [0, nrows) x K-columns [kb, kb + min(64, K - kb)) of a [*, K]
// row-major bf16 matrix into a [nrows][kWStrBf16] shared buffer.
__device__ __forceinline__ void load_chunk_bf16(__nv_bfloat16* ws,
                                                const __nv_bfloat16* w,
                                                int nrows, int K, int kb) {
  const int cw = min(kKcBf16, K - kb);
  const int pieces = cw / 8;
  for (int i = threadIdx.x; i < nrows * pieces; i += blockDim.x) {
    const int r = i / pieces, q = i - r * pieces;
    cp_async16(ws + r * kWStrBf16 + q * 8, w + (size_t)r * K + kb + q * 8);
  }
}

template <int HID, bool STORE>
__global__ void __launch_bounds__(kThreads, 1)
embed_trunk_bf16(Meta m, const float* __restrict__ x,
                 const float* __restrict__ aux,
                 const float* __restrict__ alpha_p,
                 const int* __restrict__ k0_p,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias,
                 const float* __restrict__ wout,
                 const float* __restrict__ bout, float* __restrict__ out,
                 __nv_bfloat16* __restrict__ act_x,
                 __nv_bfloat16* __restrict__ act_h, int n) {
  const int row0 = blockIdx.x * kTmBf16;
  if (row0 < first_live_row(k0_p, n)) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const int xstr = m.xw + 8, hstr = HID + 8;
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Hs = Xs + kTmBf16 * xstr;
  __nv_bfloat16* Ws = Hs + kTmBf16 * hstr;                 // [2][HID][WStr]
  float* Wo = reinterpret_cast<float*>(Ws + 2 * HID * kWStrBf16);

  const float alpha = *alpha_p;
  for (int i = threadIdx.x; i < kTmBf16 * m.xw; i += kThreads) {
    const int r = i / m.xw, c = i - r * m.xw, row = row0 + r;
    float v = 0.f;
    if (row < n)
      v = input_value(m, x + (size_t)row * m.x_stride,
                      aux + (size_t)row * m.aux_stride, alpha, c);
    const __nv_bfloat16 vb = __float2bfloat16_rn(v);
    Xs[r * xstr + c] = vb;
    if (STORE && row < n) act_x[(size_t)row * m.xw + c] = vb;
  }
  if (!STORE)
    for (int i = threadIdx.x; i < m.out_dim * HID; i += kThreads)
      Wo[i] = wout[i];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g;                 // this thread's A rows ra, ra+8

  for (int l = 0; l < m.L; ++l) {
    const Layer& ly = m.layer[l];
    float acc[HID / 8][4];
#pragma unroll
    for (int nt = 0; nt < HID / 8; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

    const __nv_bfloat16* wl = w + ly.w_off;
    const int n_chunks = (ly.K + kKcBf16 - 1) / kKcBf16;
    load_chunk_bf16(Ws, wl, HID, ly.K, 0);
    cp_async_commit();
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (ch + 1 < n_chunks) {
        load_chunk_bf16(Ws + ((ch + 1) & 1) * HID * kWStrBf16, wl, HID, ly.K,
                        (ch + 1) * kKcBf16);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* wb = Ws + (ch & 1) * HID * kWStrBf16;
      const int kb = ch * kKcBf16;
      const int cw = min(kKcBf16, ly.K - kb);
      for (int kk = 0; kk < cw; kk += 16) {
        const int kg = kb + kk;
        const int s = kg >= ly.width[0] ? 1 : 0;
        const int col = ly.off[s] + kg - (s ? ly.width[0] : 0);
        const __nv_bfloat16* A = ly.buf[s] == 0 ? Xs : Hs;
        const int astr = ly.buf[s] == 0 ? xstr : hstr;
        const __nv_bfloat16* a_lo = A + ra * astr + col + 2 * t;
        const __nv_bfloat16* a_hi = a_lo + 8 * astr;
        const uint32_t a0 = ld32(a_lo), a1 = ld32(a_hi);
        const uint32_t a2 = ld32(a_lo + 8), a3 = ld32(a_hi + 8);
#pragma unroll
        for (int nt = 0; nt < HID / 8; ++nt) {
          const __nv_bfloat16* bp = wb + (nt * 8 + g) * kWStrBf16 + kk + 2 * t;
          mma_bf16(acc[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
        }
      }
      __syncthreads();
    }

    // epilogue: round to bf16, add the bf16 bias in bf16, ReLU, into Hs
    const __nv_bfloat16* bl = bias + l * HID;
#pragma unroll
    for (int nt = 0; nt < HID / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float b0 = __bfloat162float(bl[col]);
      const float b1 = __bfloat162float(bl[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v0 = bf16_round(__fadd_rn(bf16_round(acc[nt][2 * half]), b0));
        float v1 = bf16_round(__fadd_rn(bf16_round(acc[nt][2 * half + 1]), b1));
        __nv_bfloat162 hv;
        hv.x = __float2bfloat16_rn(fmaxf(v0, 0.f));
        hv.y = __float2bfloat16_rn(fmaxf(v1, 0.f));
        const int r = ra + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(Hs + r * hstr + col) = hv;
        if (STORE && row0 + r < n)
          *reinterpret_cast<__nv_bfloat162*>(
              act_h + ((size_t)l * n + row0 + r) * HID + col) = hv;
      }
    }
  }
  if (STORE) return;
  __syncthreads();

  // f32 head on the bf16 hidden state
  for (int i = threadIdx.x; i < kTmBf16 * m.out_dim; i += kThreads) {
    const int r = i / m.out_dim, o = i - r * m.out_dim, row = row0 + r;
    if (row >= n) continue;
    const __nv_bfloat16* h = Hs + r * hstr;
    const float* wo = Wo + o * HID;
    float s = 0.f;
    for (int k = 0; k < HID; ++k)
      s = __fadd_rn(s, __fmul_rn(__bfloat162float(h[k]), wo[k]));
    out[(size_t)row * m.out_dim + o] = __fadd_rn(s, bout[o]);
  }
}

// ---------------------------------------------------------------------------
// f32 ("highest"): FMA register tiles, 64-row tiles
// ---------------------------------------------------------------------------

constexpr int kTmF32 = 64;
constexpr int kKcF32 = 16;

template <int HID>
__device__ __forceinline__ void load_chunk_f32(float* ws, const float* w,
                                               const Layer& ly, int kb) {
  // f32 weights are packed K-major ([K][HID]): a chunk is contiguous.
  const float* src = w + ly.w_off + (size_t)kb * HID;
  for (int i = threadIdx.x; i < kKcF32 * HID / 4; i += kThreads)
    cp_async16(ws + 4 * i, src + 4 * i);
}

template <int HID, bool STORE>
__global__ void __launch_bounds__(kThreads)
embed_trunk_f32(Meta m, const float* __restrict__ x,
                const float* __restrict__ aux,
                const float* __restrict__ alpha_p,
                const int* __restrict__ k0_p, const float* __restrict__ w,
                const float* __restrict__ bias,
                const float* __restrict__ wout,
                const float* __restrict__ bout, float* __restrict__ out,
                float* __restrict__ act_x, float* __restrict__ act_h, int n) {
  constexpr int CPT = HID / 16;   // output columns per thread
  const int row0 = blockIdx.x * kTmF32;
  if (row0 < first_live_row(k0_p, n)) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const int xstr = m.xw + 4, hstr = HID + 4;
  float* Xs = reinterpret_cast<float*>(smem);
  float* Hs = Xs + kTmF32 * xstr;
  float* Ws = Hs + kTmF32 * hstr;                 // [2][KC][HID]
  float* Wo = Ws + 2 * kKcF32 * HID;

  const float alpha = *alpha_p;
  for (int i = threadIdx.x; i < kTmF32 * m.xw; i += kThreads) {
    const int r = i / m.xw, c = i - r * m.xw, row = row0 + r;
    float v = 0.f;
    if (row < n)
      v = input_value(m, x + (size_t)row * m.x_stride,
                      aux + (size_t)row * m.aux_stride, alpha, c);
    Xs[r * xstr + c] = v;
    if (STORE && row < n) act_x[(size_t)row * m.xw + c] = v;
  }
  if (!STORE)
    for (int i = threadIdx.x; i < m.out_dim * HID; i += kThreads)
      Wo[i] = wout[i];

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  for (int l = 0; l < m.L; ++l) {
    const Layer& ly = m.layer[l];
    float acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

    const int n_chunks = ly.K / kKcF32;
    load_chunk_f32<HID>(Ws, w, ly, 0);
    cp_async_commit();
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (ch + 1 < n_chunks) {
        load_chunk_f32<HID>(Ws + ((ch + 1) & 1) * kKcF32 * HID, w, ly,
                            (ch + 1) * kKcF32);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* wb = Ws + (ch & 1) * kKcF32 * HID;
      const int kg = ch * kKcF32;           // segments are 16-aligned
      const int s = kg >= ly.width[0] ? 1 : 0;
      const int col = ly.off[s] + kg - (s ? ly.width[0] : 0);
      const float* A = (ly.buf[s] == 0 ? Xs : Hs) + col;
      const int astr = ly.buf[s] == 0 ? xstr : hstr;
#pragma unroll 4
      for (int kk = 0; kk < kKcF32; ++kk) {
        float a[4], b[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * astr + kk];
#pragma unroll
        for (int j = 0; j < CPT; ++j) b[j] = wb[kk * HID + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    const float* bl = bias + l * HID;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j, r = ty * 4 + i;
        const float v = fmaxf(__fadd_rn(acc[i][j], bl[c]), 0.f);
        Hs[r * hstr + c] = v;
        if (STORE && row0 + r < n)
          act_h[((size_t)l * n + row0 + r) * HID + c] = v;
      }
    __syncthreads();
  }
  if (STORE) return;

  for (int i = threadIdx.x; i < kTmF32 * m.out_dim; i += kThreads) {
    const int r = i / m.out_dim, o = i - r * m.out_dim, row = row0 + r;
    if (row >= n) continue;
    const float* h = Hs + r * hstr;
    const float* wo = Wo + o * HID;
    float s = 0.f;
    for (int k = 0; k < HID; ++k) s = fmaf(h[k], wo[k], s);
    out[(size_t)row * m.out_dim + o] = __fadd_rn(s, bout[o]);
  }
}

inline size_t fwd_smem_bytes(const Meta& m, int hid, int bf16) {
  if (bf16)
    return sizeof(__nv_bfloat16) * (kTmBf16 * (m.xw + 8) +
                                    kTmBf16 * (hid + 8) +
                                    2 * hid * kWStrBf16) +
           sizeof(float) * m.out_dim * hid;
  return sizeof(float) * (kTmF32 * (m.xw + 4) + kTmF32 * (hid + 4) +
                          2 * kKcF32 * hid + m.out_dim * hid);
}

// One forward launch (act_x/act_h null unless STORE).
template <int HID, bool STORE>
int launch_fwd(const Meta& m, int bf16, const float* x, const float* aux,
               const float* alpha, const int* k0, const void* w,
               const void* b, const float* wout, const float* bout,
               float* out, void* act_x, void* act_h, int n, cudaStream_t s) {
  const size_t smem = fwd_smem_bytes(m, HID, bf16);
  if (bf16) {
    cudaError_t e = cudaFuncSetAttribute(
        embed_trunk_bf16<HID, STORE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((n + kTmBf16 - 1) / kTmBf16);
    embed_trunk_bf16<HID, STORE><<<grid, kThreads, smem, s>>>(
        m, x, aux, alpha, k0, static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), wout, bout, out,
        static_cast<__nv_bfloat16*>(act_x), static_cast<__nv_bfloat16*>(act_h),
        n);
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        embed_trunk_f32<HID, STORE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((n + kTmF32 - 1) / kTmF32);
    embed_trunk_f32<HID, STORE><<<grid, kThreads, smem, s>>>(
        m, x, aux, alpha, k0, static_cast<const float*>(w),
        static_cast<const float*>(b), wout, bout, out,
        static_cast<float*>(act_x), static_cast<float*>(act_h), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace trunk
