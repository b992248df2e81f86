// Backward of the fused MLP trunks (positional embedding + trunk + f32 head,
// or the trunk alone on raw input rows), for Hopper.
//
// Replaces: hosnerf_tpu/ops/pallas/mlp.py::fused_embed_trunk backward (the
// Pallas kernel _ebwd_kernel with _trunk_bwd_tile and _embed_bwd, launched
// from _make_embed_fused.run_bwd) and fused_trunk backward (_bwd_kernel
// with _trunk_bwd_tile, launched from _make_fused.run_bwd).
//
// Given gout [n, out_dim] it returns dx ([n, 3] through the PE, or the full
// [n, Din] input row of the raw kind, the skip slice's part included), daux
// (per row, or summed over rows for a broadcast aux row; none for the raw
// kind), and dW/db of every layer and of the head, all f32; d(alpha) = 0.
//
// Design. The TPU kernel recomputes each row tile's forward and keeps every
// dW accumulator resident in VMEM across its sequential grid. A Hopper CTA
// can hold neither the canonical trunk's 2.1 MB of f32 dW nor its
// activations for all eight layers, and CTAs run in no order. So the work
// is split in three launches, one call:
//   1. the forward kernel of trunk_common.cuh in STORE mode recomputes the
//      trunk and writes the bf16 (or f32) input row and every layer's
//      output to device memory;
//   2. `rows`: one CTA per row tile (as the forward) walks the layers in
//      reverse with the gradient in registers: ReLU mask from the stored
//      output, db partial sums (warp shuffles, then shared memory, then one
//      atomicAdd per CTA and column), gc = bf16(g) written to device memory
//      and to shared memory, and g = gc W_i on the tensor cores with the
//      transposed weights streamed through the same shared-memory ring as
//      the forward; the skip layer's and layer 0's input gradients
//      accumulate in shared memory, and the PE chain and daux finish the
//      tile. The head (f32) and its weight gradients are done here too;
//   3. `dw`: dW_i = A_i^T gc_i, a product whose depth is the row count
//      (262,144 at the training shapes): a tiled tensor-core GEMM
//      (ldmatrix.trans feeds both operands from row-major tiles) split over
//      row ranges, each CTA adding its 64 x 64 tile with atomics.
// Atomics make the sums over rows come in a different order on each run;
// the caller compares relative to the output's scale.
//
// Bound. Canonical 8 x 256 at 262,144 rows: ~0.28 TFLOP for each of the
// recompute, the input-gradient products and the dW products, all on the
// tensor cores in bf16, against ~3 GB of activation traffic: bound by the
// tensor cores' issue rate as fed by mma.sync from shared memory.
//
// Numerics (bf16) follow mlp.py::_trunk_bwd_tile: head in f32; per layer,
// mask g by h_out > 0, gc = bf16(g), dW += A^T gc (bf16 operands, f32
// accumulation), db += sum of the unrounded g, g = gc W (bf16 operands);
// the PE chain in f32: dx_c = sum_j (g_sin c_j - g_cos s_j) 2^j over the
// windowed sin/cos, plus the identity columns for the fourier kind.
//
// Live suffix: k0 (a device int, in 1024-row blocks) is clamped to
// [0, n_blocks - 1]; rows below k0 * 1024 are skipped by all three launches
// (dx and per-row daux rows there are left unwritten; the caller zeroes
// them) and add nothing to any sum.

#include "trunk_common.cuh"

namespace {

using namespace trunk;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxOut = 4;

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

// dx and daux of one row tile from dXs (the gradient over the Xs layout).
// Raw input rows (kind 2): dx [n, ex_w] is dXs itself, plus the skip
// slice's copy in the aux columns.
__device__ __forceinline__ void embed_aux_bwd(
    const Meta& m, const float* dXs, int dstr, const float* x, float alpha,
    int row0, int nrows, int aux_stream, float* dx, float* daux) {
  if (m.kind == 2) {
    for (int i = threadIdx.x; i < nrows * m.ex_w; i += blockDim.x) {
      const int r = i / m.ex_w, c = i - r * m.ex_w;
      float v = dXs[r * dstr + c];
      const int a = c - m.skip_off;
      if (a >= 0 && a < m.A) v = __fadd_rn(v, dXs[r * dstr + m.exp_w + a]);
      dx[(size_t)(row0 + r) * m.ex_w + c] = v;
    }
    return;
  }
  const int idoff = m.kind == 0 ? 3 : 0;
  for (int i = threadIdx.x; i < nrows * 3; i += blockDim.x) {
    const int r = i / 3, cd = i - 3 * r, row = row0 + r;
    const float xv = x[3 * row + cd];
    const float* dr = dXs + r * dstr;
    float acc = 0.f;
    for (int j = 0; j < m.F; ++j) {
      const float fj = exp2f((float)j);
      const float arg = __fmul_rn(xv, fj);
      const float w = pe_window(m, alpha, j);
      const float sv = __fmul_rn(sinf(arg), w), cv = __fmul_rn(cosf(arg), w);
      const float gs = dr[idoff + 6 * j + cd], gcos = dr[idoff + 6 * j + 3 + cd];
      acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(__fmul_rn(gs, cv),
                                               __fmul_rn(gcos, sv)), fj));
    }
    if (m.kind == 0) acc = __fadd_rn(acc, dr[cd]);
    dx[3 * row + cd] = acc;
  }
  if (aux_stream) {
    for (int i = threadIdx.x; i < nrows * m.A; i += blockDim.x) {
      const int r = i / m.A, a = i - r * m.A;
      daux[(size_t)(row0 + r) * m.A + a] = dXs[r * dstr + m.exp_w + a];
    }
  } else {
    for (int a = threadIdx.x; a < m.A; a += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < nrows; ++r) s = __fadd_rn(s, dXs[r * dstr + m.exp_w + a]);
      if (s != 0.f) atomicAdd(daux + a, s);
    }
  }
}

// Head: dWout [O][HID] += hf^T Go, dbout += column sums of Go (one atomic
// per CTA and entry). hl: the tile's rows of the last layer's output.
template <typename T, int HID>
__device__ __forceinline__ void head_bwd(const T* hl, const float* Go, int O,
                                         int nrows, float* dwout,
                                         float* dbout) {
  for (int k = threadIdx.x; k < HID; k += blockDim.x) {
    float s[kMaxOut] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < nrows; ++r) {
      const float h = static_cast<float>(hl[(size_t)r * HID + k]);
      for (int o = 0; o < O; ++o)
        s[o] = __fadd_rn(s[o], __fmul_rn(h, Go[r * O + o]));
    }
    for (int o = 0; o < O; ++o)
      if (s[o] != 0.f) atomicAdd(dwout + o * HID + k, s[o]);
  }
  if ((int)threadIdx.x < O) {
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s = __fadd_rn(s, Go[r * O + threadIdx.x]);
    if (s != 0.f) atomicAdd(dbout + threadIdx.x, s);
  }
}

// ---------------------------------------------------------------------------
// bf16 rows kernel: 128-row tiles, 8 warps x 16 rows, mma.sync
// ---------------------------------------------------------------------------

// acc [16 rows per warp][ncols] = Gs [rows][HID] . WT[cols][HID]^T, with
// WT's rows (= output columns) streamed through the ring in 64-wide
// K-chunks.
template <int HID>
__device__ __forceinline__ void pass_bf16(float (&acc)[HID / 8][4],
                                          const __nv_bfloat16* Gs, int gstr,
                                          const __nv_bfloat16* wt, int ncols,
                                          __nv_bfloat16* Ws, int ra, int g,
                                          int t) {
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int n_chunks = (HID + kKcBf16 - 1) / kKcBf16;
  load_chunk_bf16(Ws, wt, ncols, HID, 0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load_chunk_bf16(Ws + ((ch + 1) & 1) * HID * kWStrBf16, wt, ncols, HID,
                      (ch + 1) * kKcBf16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* wb = Ws + (ch & 1) * HID * kWStrBf16;
    const int kb = ch * kKcBf16;
    const int cw = min(kKcBf16, HID - kb);
    for (int kk = 0; kk < cw; kk += 16) {
      const __nv_bfloat16* a_lo = Gs + ra * gstr + kb + kk + 2 * t;
      const __nv_bfloat16* a_hi = a_lo + 8 * gstr;
      const uint32_t a0 = ld32(a_lo), a1 = ld32(a_hi);
      const uint32_t a2 = ld32(a_lo + 8), a3 = ld32(a_hi + 8);
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt) {
        if (nt * 8 >= ncols) break;
        const __nv_bfloat16* bp = wb + (nt * 8 + g) * kWStrBf16 + kk + 2 * t;
        mma_bf16(acc[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
      }
    }
    __syncthreads();
  }
}

template <int HID>
__global__ void __launch_bounds__(kThreads, 1)
rows_bwd_bf16(Meta m, int aux_stream, const float* __restrict__ x,
              const float* __restrict__ alpha_p, const int* __restrict__ k0_p,
              const float* __restrict__ gout,
              const __nv_bfloat16* __restrict__ act_h,
              const __nv_bfloat16* __restrict__ wt,
              const float* __restrict__ wout, float* __restrict__ dx,
              float* __restrict__ daux, __nv_bfloat16* __restrict__ gc,
              float* __restrict__ db, float* __restrict__ dwout,
              float* __restrict__ dbout, int n) {
  const int row0 = blockIdx.x * kTmBf16;
  if (row0 < first_live_row(k0_p, n)) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const int gstr = HID + 8, dstr = m.xw + 4, O = m.out_dim;
  __nv_bfloat16* Gs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* dXs = reinterpret_cast<float*>(Gs + kTmBf16 * gstr);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(dXs + kTmBf16 * dstr);
  float* Wo = reinterpret_cast<float*>(Ws + 2 * HID * kWStrBf16);
  float* Go = Wo + O * HID;
  float* sdb = Go + kTmBf16 * O;
  const int nrows = min(kTmBf16, n - row0);
  const int tid = threadIdx.x;

  for (int i = tid; i < O * HID; i += kThreads) Wo[i] = wout[i];
  for (int i = tid; i < kTmBf16 * O; i += kThreads)
    Go[i] = i / O < nrows ? gout[(size_t)row0 * O + i] : 0.f;
  for (int i = tid; i < kTmBf16 * dstr; i += kThreads) dXs[i] = 0.f;
  for (int i = tid; i < HID; i += kThreads) sdb[i] = 0.f;
  __syncthreads();

  head_bwd<__nv_bfloat16, HID>(act_h + ((size_t)(m.L - 1) * n + row0) * HID,
                               Go, O, nrows, dwout, dbout);

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g;

  // g = gout Wout (f32), in the mma accumulator layout
  float acc[HID / 8][4];
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ra + 8 * (e >> 1), c = nt * 8 + 2 * t + (e & 1);
      float s = 0.f;
      for (int o = 0; o < O; ++o)
        s = __fadd_rn(s, __fmul_rn(Go[r * O + o], Wo[o * HID + c]));
      acc[nt][e] = s;
    }

  for (int l = m.L - 1; l >= 0; --l) {
    const Layer& ly = m.layer[l];
    const __nv_bfloat16* hl = act_h + ((size_t)l * n + row0) * HID;
    __nv_bfloat16* gl = gc + ((size_t)l * n + row0) * HID;
    // ReLU mask, db partials, gc = bf16(g)
#pragma unroll
    for (int nt = 0; nt < HID / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ra + 8 * half;
        float v0 = 0.f, v1 = 0.f;
        if (r < nrows) {
          const __nv_bfloat162 h =
              *reinterpret_cast<const __nv_bfloat162*>(hl + (size_t)r * HID + c);
          if (__bfloat162float(h.x) > 0.f) v0 = acc[nt][2 * half];
          if (__bfloat162float(h.y) > 0.f) v1 = acc[nt][2 * half + 1];
        }
        acc[nt][2 * half] = v0;
        acc[nt][2 * half + 1] = v1;
        __nv_bfloat162 gv;
        gv.x = __float2bfloat16_rn(v0);
        gv.y = __float2bfloat16_rn(v1);
        *reinterpret_cast<__nv_bfloat162*>(Gs + r * gstr + c) = gv;
        if (r < nrows)
          *reinterpret_cast<__nv_bfloat162*>(gl + (size_t)r * HID + c) = gv;
      }
      float s0 = __fadd_rn(acc[nt][0], acc[nt][2]);
      float s1 = __fadd_rn(acc[nt][1], acc[nt][3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(kFull, s0, off);
        s1 += __shfl_xor_sync(kFull, s1, off);
      }
      if (g == 0) {
        atomicAdd(sdb + c, s0);
        atomicAdd(sdb + c + 1, s1);
      }
    }
    __syncthreads();
    for (int i = tid; i < HID; i += kThreads) {
      if (sdb[i] != 0.f) atomicAdd(db + l * HID + i, sdb[i]);
      sdb[i] = 0.f;
    }

    // input gradients: Xs segments into dXs, then the Hs segment into g
    int seg_row = 0, h_row = -1;
    for (int s = 0; s < 2; ++s) {
      const int width = ly.width[s];
      if (width == 0) continue;
      if (ly.buf[s] == 1) {
        h_row = seg_row;
      } else {
        for (int cb = 0; cb < width; cb += HID) {
          const int ncols = min(HID, width - cb);
          pass_bf16<HID>(acc, Gs, gstr,
                         wt + ly.w_off + (size_t)(seg_row + cb) * HID, ncols,
                         Ws, ra, g, t);
#pragma unroll
          for (int nt = 0; nt < HID / 8; ++nt) {
            if (nt * 8 >= ncols) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = ra + 8 * (e >> 1);
              const int c = ly.off[s] + cb + nt * 8 + 2 * t + (e & 1);
              dXs[r * dstr + c] += acc[nt][e];
            }
          }
        }
      }
      seg_row += width;
    }
    if (h_row >= 0)
      pass_bf16<HID>(acc, Gs, gstr, wt + ly.w_off + (size_t)h_row * HID, HID,
                     Ws, ra, g, t);
  }
  __syncthreads();
  embed_aux_bwd(m, dXs, dstr, x, *alpha_p, row0, nrows, aux_stream, dx, daux);
}

// ---------------------------------------------------------------------------
// f32 rows kernel: 64-row tiles, 256 threads, 4 x (HID/16) FMA tiles
// ---------------------------------------------------------------------------

// acc [4 rows][HID/16 cols] per thread = Gs [rows][HID] . Wf[:, cols]; Wf
// rows (= the HID outputs of the forward layer, row stride K) streamed in
// 16-row chunks.
template <int HID>
__device__ __forceinline__ void pass_f32(float (&acc)[4][HID / 16],
                                         const float* Gs, int gstr,
                                         const float* wf, int K, int ncols,
                                         float* Ws, int ty, int tx) {
  constexpr int CPT = HID / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  const int q4 = ncols / 4;
  auto load = [&](float* dst, int kb) {
    for (int i = threadIdx.x; i < kKcF32 * q4; i += blockDim.x) {
      const int r = i / q4, q = i - r * q4;
      cp_async16(dst + r * HID + 4 * q, wf + (size_t)(kb + r) * K + 4 * q);
    }
  };
  const int n_chunks = HID / kKcF32;
  load(Ws, 0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load(Ws + ((ch + 1) & 1) * kKcF32 * HID, (ch + 1) * kKcF32);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wb = Ws + (ch & 1) * kKcF32 * HID;
    const int kb = ch * kKcF32;
#pragma unroll 4
    for (int kk = 0; kk < kKcF32; ++kk) {
      float a[4], b[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Gs[(ty * 4 + i) * gstr + kb + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        b[j] = c < ncols ? wb[kk * HID + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int HID>
__global__ void __launch_bounds__(kThreads)
rows_bwd_f32(Meta m, int aux_stream, const float* __restrict__ x,
             const float* __restrict__ alpha_p, const int* __restrict__ k0_p,
             const float* __restrict__ gout, const float* __restrict__ act_h,
             const float* __restrict__ wf, const float* __restrict__ wout,
             float* __restrict__ dx, float* __restrict__ daux,
             float* __restrict__ gc, float* __restrict__ db,
             float* __restrict__ dwout, float* __restrict__ dbout, int n) {
  constexpr int CPT = HID / 16;
  const int row0 = blockIdx.x * kTmF32;
  if (row0 < first_live_row(k0_p, n)) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const int gstr = HID + 4, dstr = m.xw + 4, O = m.out_dim;
  float* Gs = reinterpret_cast<float*>(smem);
  float* dXs = Gs + kTmF32 * gstr;
  float* Ws = dXs + kTmF32 * dstr;                  // [2][KC][HID]
  float* Wo = Ws + 2 * kKcF32 * HID;
  float* Go = Wo + O * HID;
  float* sdb = Go + kTmF32 * O;
  const int nrows = min(kTmF32, n - row0);
  const int tid = threadIdx.x;

  for (int i = tid; i < O * HID; i += kThreads) Wo[i] = wout[i];
  for (int i = tid; i < kTmF32 * O; i += kThreads)
    Go[i] = i / O < nrows ? gout[(size_t)row0 * O + i] : 0.f;
  for (int i = tid; i < kTmF32 * dstr; i += kThreads) dXs[i] = 0.f;
  for (int i = tid; i < HID; i += kThreads) sdb[i] = 0.f;
  __syncthreads();

  head_bwd<float, HID>(act_h + ((size_t)(m.L - 1) * n + row0) * HID, Go, O,
                       nrows, dwout, dbout);

  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int r = ty * 4 + i, c = tx + 16 * j;
      float s = 0.f;
      for (int o = 0; o < O; ++o)
        s = __fadd_rn(s, __fmul_rn(Go[r * O + o], Wo[o * HID + c]));
      acc[i][j] = s;
    }

  for (int l = m.L - 1; l >= 0; --l) {
    const Layer& ly = m.layer[l];
    const float* hl = act_h + ((size_t)l * n + row0) * HID;
    float* gl = gc + ((size_t)l * n + row0) * HID;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float v = 0.f;
        if (r < nrows && hl[(size_t)r * HID + c] > 0.f) v = acc[i][j];
        acc[i][j] = v;
        Gs[r * gstr + c] = v;
        if (r < nrows) gl[(size_t)r * HID + c] = v;
        s = __fadd_rn(s, v);
      }
      if (s != 0.f) atomicAdd(sdb + c, s);
    }
    __syncthreads();
    for (int i = tid; i < HID; i += kThreads) {
      if (sdb[i] != 0.f) atomicAdd(db + l * HID + i, sdb[i]);
      sdb[i] = 0.f;
    }

    int seg_row = 0, h_row = -1;
    for (int s = 0; s < 2; ++s) {
      const int width = ly.width[s];
      if (width == 0) continue;
      if (ly.buf[s] == 1) {
        h_row = seg_row;
      } else {
        for (int cb = 0; cb < width; cb += HID) {
          const int ncols = min(HID, width - cb);
          pass_f32<HID>(acc, Gs, gstr, wf + ly.w_off + seg_row + cb, ly.K,
                        ncols, Ws, ty, tx);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
              const int c = tx + 16 * j;
              if (c < ncols)
                dXs[(ty * 4 + i) * dstr + ly.off[s] + cb + c] += acc[i][j];
            }
        }
      }
      seg_row += width;
    }
    if (h_row >= 0)
      pass_f32<HID>(acc, Gs, gstr, wf + ly.w_off + h_row, ly.K, HID, Ws, ty,
                    tx);
  }
  __syncthreads();
  embed_aux_bwd(m, dXs, dstr, x, *alpha_p, row0, nrows, aux_stream, dx, daux);
}

// ---------------------------------------------------------------------------
// dW_i = A_i^T gc_i: split over row ranges, one 64 x 64 tile per CTA
// ---------------------------------------------------------------------------

constexpr int kDwTile = 64;
constexpr int kDwBk = 32;
constexpr int kDwThreads = 128;
constexpr int kDwStr = kDwTile + 8;   // bf16 row stride: 144 bytes

struct RowRange {
  int begin, end;
};

__device__ __forceinline__ RowRange split_rows(const int* k0_p, int n,
                                               int splits, int align) {
  const int first = first_live_row(k0_p, n);
  const int total = n - first;
  const int per = ((total + splits - 1) / splits + align - 1) / align * align;
  RowRange rr;
  rr.begin = first + blockIdx.z * per;
  rr.end = min(n, rr.begin + per);
  return rr;
}

// Source of input column k (a multiple of 4) of layer l at one row.
template <typename T>
__device__ __forceinline__ const T* a_src(const Meta& m, const Layer& ly,
                                          const T* act_x, const T* hprev,
                                          int hid, int row, int k) {
  const int s = k >= ly.width[0] ? 1 : 0;
  const int c = ly.off[s] + k - (s ? ly.width[0] : 0);
  return ly.buf[s] == 0 ? act_x + (size_t)row * m.xw + c
                        : hprev + (size_t)row * hid + c;
}

template <int HID>
__global__ void __launch_bounds__(kDwThreads)
dw_bf16(Meta m, const int* __restrict__ k0_p,
        const __nv_bfloat16* __restrict__ act_x,
        const __nv_bfloat16* __restrict__ act_h,
        const __nv_bfloat16* __restrict__ gc, float* __restrict__ dw, int n,
        int splits) {
  const int l = blockIdx.y;
  const Layer& ly = m.layer[l];
  const int tiles_n = (ly.K + kDwTile - 1) / kDwTile;
  const int tiles_m = (HID + kDwTile - 1) / kDwTile;
  if ((int)blockIdx.x >= tiles_m * tiles_n) return;
  const int o0 = (blockIdx.x / tiles_n) * kDwTile;
  const int kc0 = (blockIdx.x % tiles_n) * kDwTile;
  const RowRange rr = split_rows(k0_p, n, splits, kDwBk);
  if (rr.begin >= rr.end) return;

  __shared__ __align__(16) __nv_bfloat16 Gt[2][kDwBk][kDwStr];
  __shared__ __align__(16) __nv_bfloat16 At[2][kDwBk][kDwStr];
  const __nv_bfloat16* gl = gc + (size_t)l * n * HID;
  const __nv_bfloat16* hprev = act_h + (size_t)(l > 0 ? l - 1 : 0) * n * HID;

  auto load = [&](int st, int r0) {
    for (int i = threadIdx.x; i < kDwBk * 8; i += kDwThreads) {
      const int r = i >> 3, q = i & 7, row = r0 + r;
      __nv_bfloat16* dg = &Gt[st][r][q * 8];
      const int o = o0 + q * 8;
      if (row < rr.end && o < HID)
        cp_async16(dg, gl + (size_t)row * HID + o);
      else
        *reinterpret_cast<uint4*>(dg) = make_uint4(0u, 0u, 0u, 0u);
      __nv_bfloat16* da = &At[st][r][q * 8];
      const int k = kc0 + q * 8;
      if (row < rr.end && k < ly.K)
        cp_async16(da, a_src(m, ly, act_x, hprev, HID, row, k));
      else
        *reinterpret_cast<uint4*>(da) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int j8 = lane >> 3, r8 = lane & 7;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int steps = (rr.end - rr.begin + kDwBk - 1) / kDwBk;
  load(0, rr.begin);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      load((step + 1) & 1, rr.begin + (step + 1) * kDwBk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = step & 1;
#pragma unroll
    for (int kk = 0; kk < kDwBk; kk += 16) {
      // A = gc^T (rows o, depth = rows of the batch): stored [row][o]
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_trans(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                      &Gt[st][kk + (j8 >> 1) * 8 + r8]
                         [wm * 32 + mi * 16 + (j8 & 1) * 8]);
      // B = the layer input (depth = rows, cols k): stored [row][k]
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_trans(b[2 * np][0], b[2 * np][1], b[2 * np + 1][0],
                      b[2 * np + 1][1],
                      &At[st][kk + (j8 & 1) * 8 + r8]
                         [wn * 32 + np * 16 + (j8 >> 1) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                   b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }
  float* dwl = dw + ly.w_off;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
        const int k = kc0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        const float v = acc[mi][ni][e];
        if (o < HID && k < ly.K && v != 0.f)
          atomicAdd(dwl + (size_t)o * ly.K + k, v);
      }
}

template <int HID>
__global__ void __launch_bounds__(256)
dw_f32(Meta m, const int* __restrict__ k0_p, const float* __restrict__ act_x,
       const float* __restrict__ act_h, const float* __restrict__ gc,
       float* __restrict__ dw, int n, int splits) {
  constexpr int BK = 16;
  const int l = blockIdx.y;
  const Layer& ly = m.layer[l];
  const int tiles_n = (ly.K + kDwTile - 1) / kDwTile;
  const int tiles_m = (HID + kDwTile - 1) / kDwTile;
  if ((int)blockIdx.x >= tiles_m * tiles_n) return;
  const int o0 = (blockIdx.x / tiles_n) * kDwTile;
  const int kc0 = (blockIdx.x % tiles_n) * kDwTile;
  const RowRange rr = split_rows(k0_p, n, splits, BK);
  if (rr.begin >= rr.end) return;

  __shared__ __align__(16) float Gt[BK][kDwTile];
  __shared__ __align__(16) float At[BK][kDwTile];
  const float* gl = gc + (size_t)l * n * HID;
  const float* hprev = act_h + (size_t)(l > 0 ? l - 1 : 0) * n * HID;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = rr.begin; r0 < rr.end; r0 += BK) {
    {
      const int r = tid >> 4, q = tid & 15, row = r0 + r;
      float4 gv = make_float4(0.f, 0.f, 0.f, 0.f), av = gv;
      const int o = o0 + 4 * q, k = kc0 + 4 * q;
      if (row < rr.end && o < HID)
        gv = *reinterpret_cast<const float4*>(gl + (size_t)row * HID + o);
      if (row < rr.end && k < ly.K)
        av = *reinterpret_cast<const float4*>(
            a_src(m, ly, act_x, hprev, HID, row, k));
      *reinterpret_cast<float4*>(&Gt[r][4 * q]) = gv;
      *reinterpret_cast<float4*>(&At[r][4 * q]) = av;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Gt[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = At[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dwl = dw + ly.w_off;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + ty + 16 * i, k = kc0 + tx + 16 * j;
      if (o < HID && k < ly.K && acc[i][j] != 0.f)
        atomicAdd(dwl + (size_t)o * ly.K + k, acc[i][j]);
    }
}

size_t rows_smem_bytes(const Meta& m, int hid, int bf16) {
  const int O = m.out_dim;
  if (bf16)
    return sizeof(__nv_bfloat16) * (kTmBf16 * (hid + 8) + 2 * hid * kWStrBf16) +
           sizeof(float) * (kTmBf16 * (m.xw + 4) + O * hid + kTmBf16 * O + hid);
  return sizeof(float) * (kTmF32 * (hid + 4) + kTmF32 * (m.xw + 4) +
                          2 * kKcF32 * hid + O * hid + kTmF32 * O + hid);
}

template <int HID>
int launch_bwd(const Meta& m, int bf16, int aux_stream, const float* x,
               const float* aux, const float* alpha, const int* k0,
               const void* w, const void* b, const void* wt,
               const float* wout, const float* gout, void* act_x,
               void* act_h, void* gc, float* dx, float* daux, float* db,
               float* dwout, float* dbout, float* dw, int n, int splits,
               cudaStream_t s) {
  int rc = launch_fwd<HID, true>(m, bf16, x, aux, alpha, k0, w, b, wout,
                                 nullptr, nullptr, act_x, act_h, n, s);
  if (rc != 0) return rc;
  const size_t smem = rows_smem_bytes(m, HID, bf16);
  int max_tiles = 0;
  for (int l = 0; l < m.L; ++l) {
    const int tiles = ((HID + kDwTile - 1) / kDwTile) *
                      ((m.layer[l].K + kDwTile - 1) / kDwTile);
    max_tiles = tiles > max_tiles ? tiles : max_tiles;
  }
  const dim3 dw_grid(max_tiles, m.L, splits);
  if (bf16) {
    cudaError_t e = cudaFuncSetAttribute(
        rows_bwd_bf16<HID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    rows_bwd_bf16<HID><<<(n + kTmBf16 - 1) / kTmBf16, kThreads, smem, s>>>(
        m, aux_stream, x, alpha, k0, gout,
        static_cast<const __nv_bfloat16*>(act_h),
        static_cast<const __nv_bfloat16*>(wt), wout, dx, daux,
        static_cast<__nv_bfloat16*>(gc), db, dwout, dbout, n);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    dw_bf16<HID><<<dw_grid, kDwThreads, 0, s>>>(
        m, k0, static_cast<const __nv_bfloat16*>(act_x),
        static_cast<const __nv_bfloat16*>(act_h),
        static_cast<const __nv_bfloat16*>(gc), dw, n, splits);
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        rows_bwd_f32<HID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    rows_bwd_f32<HID><<<(n + kTmF32 - 1) / kTmF32, kThreads, smem, s>>>(
        m, aux_stream, x, alpha, k0, gout, static_cast<const float*>(act_h),
        static_cast<const float*>(wt), wout, dx, daux,
        static_cast<float*>(gc), db, dwout, dbout, n);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    dw_f32<HID><<<dw_grid, 256, 0, s>>>(
        m, k0, static_cast<const float*>(act_x),
        static_cast<const float*>(act_h), static_cast<const float*>(gc), dw,
        n, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hosnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// meta: as hosnerf_embed_trunk. w/b: the forward's packed weights and
// biases; wt: the same weights packed for the backward (bf16 [K][HID] per
// layer, f32 [HID][K]); wout [out_dim, HID] f32; gout [n, out_dim] f32.
// Scratch: act_x [n, xw], act_h [L, n, HID], gc [L, n, HID] (bf16 when bf16,
// else f32). Outputs: dx [n, 3] and, when aux_stream, daux [n, A] (rows
// below the clamped k0 * 1024 unwritten); accumulated (zeroed by the
// caller): daux [A] when broadcast, db [L, HID], dwout [out_dim, HID],
// dbout [out_dim], dw (packed [HID][K] per layer at the weights' offsets).
// splits: row ranges of the dW products. Returns cudaGetLastError().
int hosnerf_embed_trunk_bwd(const int* meta, int bf16, int aux_stream,
                            const float* x, const float* aux,
                            const float* alpha, const int* k0, const void* w,
                            const void* b, const void* wt, const float* wout,
                            const float* gout, void* act_x, void* act_h,
                            void* gc, float* dx, float* daux, float* db,
                            float* dwout, float* dbout, float* dw, int n,
                            int splits, void* stream) {
  trunk::Meta m;
  if (!trunk::parse_meta(meta, m) || m.out_dim > kMaxOut || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m.hid) {
    case 32: return launch_bwd<32>(m, bf16, aux_stream, x, aux, alpha, k0, w, b, wt, wout, gout, act_x, act_h, gc, dx, daux, db, dwout, dbout, dw, n, splits, s);
    case 128: return launch_bwd<128>(m, bf16, aux_stream, x, aux, alpha, k0, w, b, wt, wout, gout, act_x, act_h, gc, dx, daux, db, dwout, dbout, dw, n, splits, s);
    case 256: return launch_bwd<256>(m, bf16, aux_stream, x, aux, alpha, k0, w, b, wt, wout, gout, act_x, act_h, gc, dx, daux, db, dwout, dbout, dw, n, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
