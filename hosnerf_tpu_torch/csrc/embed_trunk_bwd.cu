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
//      trunk and writes the input row and every layer's output to device
//      memory (bf16: one bulk copy per 64-row tile of each swizzled image);
//   2. `rows` walks the layers in reverse with the gradient g in wgmma
//      accumulator registers. bf16: the warp-specialised, persistent layout
//      of the forward (trunk_common.cuh). Per layer: the stored output tile
//      (the ReLU mask) is bulk-copied into the warpgroup's Gs image (and
//      prefetched into L2 one layer ahead), masked in place into gc =
//      bf16(g), and gc goes to device memory in one bulk store; db and,
//      at the last layer, the head's dWout are summed over rows by
//      halving shuffles (fold_rows), staged per warp, and added once per
//      column into per-CTA shared sums (one atomic per CTA and entry at
//      the end); then the input gradients gc W, one 64-column weight chunk
//      at a time as wgmma.m64n64k16 on the same chunk images the forward
//      streams, read MN-major (no transposed copy), two chunks in flight
//      below HID 256. A chunk of an Hs segment becomes the next g; one of
//      an Xs segment adds into dXs (f32), which the PE chain and daux
//      finish;
//   3. `dw`: dW_i = gc_i^T A_i, a product whose depth is the row count
//      (262,144 at the training shapes). bf16: per CTA a [128 o][<= 256
//      columns] tile of one segment's input panels, both operands read
//      MN-major from 64-row tiles of the stored images that the producer
//      bulk-copies through a 4-stage ring; the row range is split over
//      CTAs, which add their tile with one red.global per entry.
// f32 ("highest") runs the same three launches on bf16x3 pieces
// (trunk_common.cuh): every stored image (act_x, act_h, gc) holds each
// 64-row tile as three piece images, hi first, and every product is six
// piece products on the tensor cores. Its tiles are 64 rows (one consumer
// warpgroup per chunk in `rows`) and its dW items take at most 2 input
// panels.
// Atomics make the sums over rows come in a different order on each run;
// the caller compares relative to the output's scale.
//
// Bound. Canonical 8 x 256 at 262,144 rows: ~0.28 TFLOP for each of the
// recompute, the input-gradient products and the dW products, all on the
// tensor cores in bf16 (0.85 ms at 989 TFLOP/s), which bounds the function
// (its inputs and outputs are a few MB). The three-launch split adds its
// own traffic: the stored images are written once (1.1 GB), the output
// tiles read back by `rows` (1.1 GB), gc written (1.1 GB) and both read by
// `dw` (2.2 GB): ~5.4 GB, 1.6 ms at 3.35 TB/s, the floor of this design.
// f32: six products per f32 product (5.0 ms at 165 TFLOP/s of f32-grade
// products) and three pieces per stored value: ~14 GB of scratch traffic
// (the mask reads only the hi piece), ~4.2 ms, the floor there.
//
// Numerics (bf16) follow mlp.py::_trunk_bwd_tile: head in f32; per layer,
// mask g by h_out > 0, gc = bf16(g), dW += A^T gc (bf16 operands, f32
// accumulation), db += sum of the unrounded g, g = gc W (bf16 operands);
// the PE chain in f32: dx_c = sum_j (g_sin c_j - g_cos s_j) 2^j over the
// windowed sin/cos, plus the identity columns for the fourier kind. f32:
// the same with gc = g and every product in f32 (bf16x3).
//
// Live suffix: k0 (a device int, in 1024-row blocks) is clamped to
// [0, n_blocks - 1]; rows below k0 * 1024 are skipped by all three launches
// (dx and per-row daux rows there are left unwritten; the caller zeroes
// them) and add nothing to any sum.

#include "trunk_common.cuh"

namespace {

using namespace trunk;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxAux = 128;   // bf16 rows kernel: broadcast aux sums

// dx and daux of one row tile from dXs (the gradient over the Xs layout),
// by threads tid, tid + nth, ... Raw input rows (kind 2): dx [n, ex_w] is
// dXs itself, plus the skip slice's copy in the aux columns.
__device__ __forceinline__ void embed_aux_bwd(
    const Meta& m, const float* dXs, int dstr, const float* x, float alpha,
    int row0, int nrows, int aux_stream, float* dx, float* daux, int tid,
    int nth) {
  if (m.kind == 2) {
    for (int i = tid; i < nrows * m.ex_w; i += nth) {
      const int r = i / m.ex_w, c = i - r * m.ex_w;
      float v = dXs[r * dstr + c];
      const int a = c - m.skip_off;
      if (a >= 0 && a < m.A) v = __fadd_rn(v, dXs[r * dstr + m.exp_w + a]);
      dx[(size_t)(row0 + r) * m.ex_w + c] = v;
    }
    return;
  }
  const int idoff = m.kind == 0 ? 3 : 0;
  for (int i = tid; i < nrows * 3; i += nth) {
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
    for (int i = tid; i < nrows * m.A; i += nth) {
      const int r = i / m.A, a = i - r * m.A;
      daux[(size_t)(row0 + r) * m.A + a] = dXs[r * dstr + m.exp_w + a];
    }
  } else {
    for (int a = tid; a < m.A; a += nth) {
      float s = 0.f;
      for (int r = 0; r < nrows; ++r) s = __fadd_rn(s, dXs[r * dstr + m.exp_w + a]);
      if (s != 0.f) atomicAdd(daux + a, s);
    }
  }
}

// Column c summed over the four warps' staged sums ([4][HID]).
template <int HID>
__device__ __forceinline__ float warps_sum(const float* wp, int c) {
  return __fadd_rn(__fadd_rn(wp[c], wp[HID + c]),
                   __fadd_rn(wp[2 * HID + c], wp[3 * HID + c]));
}

// One halving step of fold_rows: the lanes with `upper` keep v[H, 2H) and
// send v[0, H) to their partner across lane bit `off`, the others the
// reverse; each adds what it receives into v[0, H).
template <int H, int N>
__device__ __forceinline__ void fold_half(float (&v)[N], bool upper, int off) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? v[k] : v[k + H];
    const float keep = upper ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

// v[N] (N a multiple of 8) summed over the 8 lanes of a warp that share
// lane % 4 (the 16 rows of an accumulator fragment) in 7N/8 shuffles:
// afterwards lane 4 g + q holds in v[0, N/8) the sums of entries
// [g N/8, (g + 1) N/8).
template <int N>
__device__ __forceinline__ void fold_rows(float (&v)[N], int lane) {
  fold_half<N / 2>(v, lane & 16, 16);
  fold_half<N / 4>(v, lane & 8, 8);
  fold_half<N / 8>(v, lane & 4, 4);
}

// Stages the folded column sums of one warp (fold_rows of v[2 nt + c] =
// column 8 nt + 2 q + c) in wp[warp][HID].
template <int HID>
__device__ __forceinline__ void stage_cols(float* wp, const float (&v)[HID / 4],
                                           int warp, int g, int q) {
  constexpr int P = HID / 32;   // entries per lane after the fold
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int e = g * P + k;    // = 2 nt + c
    wp[warp * HID + (e >> 1) * 8 + 2 * q + (e & 1)] = v[k];
  }
}

// ---------------------------------------------------------------------------
// bf16 rows kernel: warp-specialised, persistent, wgmma
// ---------------------------------------------------------------------------

template <int HID>
struct RowsShape {
  static constexpr int HPn = Shape<HID>::HPn;
  static constexpr int PR = HID < 128 ? HID : 128;   // weight rows per stage
  static constexpr int NP = HID / PR;                // stages per chunk
  static constexpr uint32_t kStage = PR * 128;
};

template <int HID>
__global__ void __launch_bounds__(kWsThreads, 1)
rows_bwd_bf16(const __grid_constant__ Meta m, int aux_stream,
              const float* __restrict__ x, const float* __restrict__ alpha_p,
              const int* __restrict__ k0_p, const float* __restrict__ gout,
              const __nv_bfloat16* __restrict__ act_h,
              const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ wout, float* __restrict__ dx,
              float* __restrict__ daux, __nv_bfloat16* __restrict__ gc,
              float* __restrict__ db, float* __restrict__ dwout,
              float* __restrict__ dbout, int n, int stages) {
  using S = RowsShape<HID>;
  constexpr int HPn = S::HPn, PR = S::PR, NP = S::NP;
  constexpr uint32_t kStage = S::kStage;
  const int O = m.out_dim, dstr = m.xw + 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  __nv_bfloat16* Gs0 = reinterpret_cast<__nv_bfloat16*>(base);
  unsigned char* ring = reinterpret_cast<unsigned char*>(Gs0 + 2 * HPn * kPanel);
  float* dXs = reinterpret_cast<float*>(ring + stages * kStage);  // [128][dstr]
  float* Wo = dXs + kTm * dstr;
  float* sWo = Wo + kMaxOut * HID;
  float* sdb = sWo + kMaxOut * HID;
  float* wpart = sdb + m.L * HID;                   // [2][4 warps][HID]
  float* Go = wpart + 8 * HID;                                   // [128][O]
  float* sdbo = Go + kTm * kMaxOut;
  float* sdaux = sdbo + kMaxOut;
  uint64_t* full = reinterpret_cast<uint64_t*>(sdaux + kMaxAux);
  uint64_t* empty = full + kMaxStages;
  uint64_t* hbar = empty + kMaxStages;   // act_h tile -> Gs, per warpgroup

  const int tid = threadIdx.x;
  {
    uint4* z = reinterpret_cast<uint4*>(Gs0);
    for (int i = tid; i < 2 * HPn * kPanelBytes / 16; i += kWsThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kTm * dstr; i += kWsThreads) dXs[i] = 0.f;
    for (int i = tid; i < kMaxOut * HID; i += kWsThreads)
      Wo[i] = i < O * HID ? wout[i] : 0.f;
    for (int i = tid; i < kMaxOut * HID + m.L * HID; i += kWsThreads)
      sWo[i] = 0.f;                                   // sWo, then sdb
    for (int i = tid; i < kMaxOut + kMaxAux; i += kWsThreads) sdbo[i] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_init(hbar, 1);
    mbar_init(hbar + 1, 1);
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
        for (int l = m.L - 1; l >= 0; --l) {
          const Layer& ly = m.layer[l];
          for (int ch = 0; ch < ly.K / 64; ++ch)
            for (int p = 0; p < NP; ++p) {
              mbar_wait(empty + rp.stage, rp.phase ^ 1u);
              mbar_expect_tx(full + rp.stage, kStage);
              bulk_g2s(ring + rp.stage * kStage,
                       w + ly.w_off + ((size_t)ch * HID + p * PR) * 64,
                       kStage, full + rp.stage);
              rp.next();
            }
        }
    }
  } else {
    reg_alloc<232>();
    const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int bar = 1 + wg;
    __nv_bfloat16* Gs = Gs0 + wg * HPn * kPanel;
    float* dX = dXs + wg * kWgRows * dstr;
    float* Gw = Go + wg * kWgRows * kMaxOut;
    float* wp = wpart + wg * 4 * HID;
    const size_t T64 = 2 * (size_t)n_tiles;
    const uint32_t tile_bytes = HPn * kPanelBytes;
    const float alpha = *alpha_p;
    Ring rc{0, 0u, stages};
    uint32_t hphase = 0;
    if (wt == 0 && t_first < n_tiles)
      bulk_prefetch_l2(act_h + ((size_t)(m.L - 1) * T64 + 2 * t_first + wg) *
                                   HPn * kPanel,
                       tile_bytes);
    for (int t = t_first; t < n_tiles; t += gridDim.x) {
      const int row0 = t * kTm + wg * kWgRows;
      const int nrows = max(0, min(kWgRows, n - row0));
      const size_t tile64 = 2 * (size_t)t + wg;
      for (int i = wt; i < kWgRows * O; i += 128)
        Gw[i] = i / O < nrows ? gout[(size_t)row0 * O + i] : 0.f;
      named_sync(bar, 128);
      if (wt < O) {
        float s = 0.f;
        for (int r = 0; r < nrows; ++r) s = __fadd_rn(s, Gw[r * O + wt]);
        if (s != 0.f) atomicAdd(sdbo + wt, s);
      }
      // g = gout Wout (f32), in the accumulator layout; Wo's rows past
      // out_dim are zeros, so every output adds exactly 0 there (a loop of
      // fixed length keeps this unrolled code small)
      float go[2][kMaxOut];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o)
          go[half][o] = o < O ? Gw[(warp * 16 + g + 8 * half) * O + o] : 0.f;
      float gr[HID / 2];
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt) {
        float2 wo[kMaxOut];
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o)
          wo[o] = *reinterpret_cast<const float2*>(Wo + o * HID + nt * 8 +
                                                   2 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = 0.f;
#pragma unroll
          for (int o = 0; o < kMaxOut; ++o)
            s = __fadd_rn(s, __fmul_rn(go[e >> 1][o],
                                       (e & 1) ? wo[o].y : wo[o].x));
          gr[4 * nt + e] = s;
        }
      }

      for (int l = m.L - 1; l >= 0; --l) {
        const Layer& ly = m.layer[l];
        // this layer's output tile (the ReLU mask) into Gs, once every
        // product and the last gc store have read it
        named_sync(bar, 128);
        if (wt == 0) {
          bulk_wait_read();
          mbar_expect_tx(hbar + wg, tile_bytes);
          bulk_g2s(Gs, act_h + ((size_t)l * T64 + tile64) * HPn * kPanel,
                   tile_bytes, hbar + wg);
        }
        mbar_wait(hbar + wg, hphase);
        hphase ^= 1u;
        if (l == m.L - 1) {
          // head: dWout[o] += h^T Go[:, o] over the tile's rows, one output
          // at a time (per-warp sums staged in wp, then one add per column)
          for (int o = 0; o < O; ++o) {
            float a[HID / 4];
#pragma unroll
            for (int nt = 0; nt < HID / 8; ++nt) {
              const int col = nt * 8 + 2 * q;
              a[2 * nt] = a[2 * nt + 1] = 0.f;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int r = warp * 16 + g + 8 * half;
                if (r < nrows) {
                  const float2 h = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(Gs +
                                                               swz(r, col)));
                  const float go = Gw[r * O + o];
                  a[2 * nt] = __fadd_rn(a[2 * nt], __fmul_rn(h.x, go));
                  a[2 * nt + 1] = __fadd_rn(a[2 * nt + 1], __fmul_rn(h.y, go));
                }
              }
            }
            fold_rows(a, lane);
            stage_cols<HID>(wp, a, warp, g, q);
            named_sync(bar, 128);
            for (int c = wt; c < HID; c += 128)
              atomicAdd(sWo + o * HID + c, warps_sum<HID>(wp, c));
            named_sync(bar, 128);
          }
        }
        // ReLU mask, gc = bf16(g) in place, then db's column sums
#pragma unroll
        for (int nt = 0; nt < HID / 8; ++nt) {
          const int col = nt * 8 + 2 * q;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + g + 8 * half;
            float h0 = 0.f, h1 = 0.f;
            if (r < nrows) {
              const __nv_bfloat162 h =
                  *reinterpret_cast<const __nv_bfloat162*>(Gs + swz(r, col));
              h0 = __bfloat162float(h.x);
              h1 = __bfloat162float(h.y);
            }
            float& v0 = gr[4 * nt + 2 * half];
            float& v1 = gr[4 * nt + 2 * half + 1];
            v0 = h0 > 0.f ? v0 : 0.f;
            v1 = h1 > 0.f ? v1 : 0.f;
            __nv_bfloat162 gv;
            gv.x = __float2bfloat16_rn(v0);
            gv.y = __float2bfloat16_rn(v1);
            *reinterpret_cast<__nv_bfloat162*>(Gs + swz(r, col)) = gv;
          }
        }
        {
          float v[HID / 4];   // the thread's two rows of each column
#pragma unroll
          for (int nt = 0; nt < HID / 8; ++nt) {
            v[2 * nt] = __fadd_rn(gr[4 * nt], gr[4 * nt + 2]);
            v[2 * nt + 1] = __fadd_rn(gr[4 * nt + 1], gr[4 * nt + 3]);
          }
          fold_rows(v, lane);
          stage_cols<HID>(wp, v, warp, g, q);
        }
        fence_async();
        named_sync(bar, 128);
        // db: the four warps' sums, one add per column (the other
        // warpgroup adds to the same entries)
        for (int c = wt; c < HID; c += 128)
          atomicAdd(sdb + l * HID + c, warps_sum<HID>(wp, c));
        if (wt == 0) {
          bulk_s2g(gc + ((size_t)l * T64 + tile64) * HPn * kPanel, Gs,
                   tile_bytes);
          // the next mask tile: this tile's layer below, or the next
          // tile's last layer
          const int tn = l > 0 ? t : t + (int)gridDim.x;
          if (tn < n_tiles)
            bulk_prefetch_l2(
                act_h + ((size_t)(l > 0 ? l - 1 : m.L - 1) * T64 + 2 * tn +
                         wg) * HPn * kPanel,
                tile_bytes);
        }

        // input gradients gc W, one 64-column weight chunk at a time;
        // below HID 256, two in flight: chunk j + 1's products run while
        // chunk j is routed (at 256 the second accumulator would spill)
        const int nch = ly.K / 64;
        float ta[32], tb[32];
        int ua[NP], ub[NP];
        auto issue = [&](float (&t)[32], int (&used)[NP]) {
          // every stage of the chunk first: no wait between the products
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            mbar_wait(full + rc.stage, rc.phase);
            used[p] = rc.stage;
            rc.next();
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) t[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const unsigned char* stg = ring + used[p] * kStage;
#pragma unroll
            for (int i = 0; i < PR / 16; ++i) {
              const int k = p * PR + 16 * i;
              wgmma<64, 0, 1>(
                  t,
                  sw128_desc(reinterpret_cast<const unsigned char*>(Gs) +
                             (k >> 6) * kPanelBytes + (k & 63) * 2),
                  sw128_desc(stg + i * 16 * 128));
            }
          }
          wgmma_commit();
        };
        // chunk j's products are complete: free its stages, then send its
        // columns to the next g (an Hs segment) or into dXs (Xs)
        auto route = [&](float (&t)[32], const int (&used)[NP], int j) {
          fence_regs(t);
          if (lane == 0)
#pragma unroll
            for (int p = 0; p < NP; ++p) mbar_arrive(empty + used[p]);
          const int sg = ly.width[1] > 0 && j * 64 >= ly.kpos[1] ? 1 : 0;
          const int cj = j - ly.kpos[sg] / 64, width = ly.width[sg];
          if (ly.buf[sg]) {
#pragma unroll
            for (int sl = 0; sl < HPn; ++sl)
              if (sl == cj) {
#pragma unroll
                for (int e = 0; e < 32; ++e)
                  if (sl * 32 + e < HID / 2) gr[sl * 32 + e] = t[e];
              }
          } else {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int r = warp * 16 + g + 8 * ((e >> 1) & 1);
              const int c = cj * 64 + 8 * (e >> 2) + 2 * q + (e & 1);
              if (c < width) dX[r * dstr + ly.off[sg] + c] += t[e];
            }
          }
        };
        if constexpr (HID > 128) {
          for (int j = 0; j < nch; ++j) {
            issue(ta, ua);
            wgmma_wait<0>();
            route(ta, ua, j);
          }
        } else {
          issue(ta, ua);
          for (int j = 0; j < nch; j += 2) {
            if (j + 1 < nch) {
              issue(tb, ub);
              wgmma_wait<1>();
            } else {
              wgmma_wait<0>();
            }
            route(ta, ua, j);
            if (j + 1 == nch) break;
            if (j + 2 < nch) {
              issue(ta, ua);
              wgmma_wait<1>();
            } else {
              wgmma_wait<0>();
            }
            route(tb, ub, j + 1);
          }
        }
      }
      named_sync(bar, 128);
      embed_aux_bwd(m, dX, dstr, x, alpha, row0, nrows, aux_stream, dx,
                    aux_stream ? daux : sdaux, wt, 128);
      named_sync(bar, 128);
      for (int i = wt; i < kWgRows * dstr; i += 128) dX[i] = 0.f;
    }
    if (wt == 0) bulk_wait_all();
    named_sync(3, 256);   // both warpgroups' shared sums are complete
    const int ct = tid;
    for (int i = ct; i < m.L * HID; i += 256)
      if (sdb[i] != 0.f) atomicAdd(db + i, sdb[i]);
    for (int i = ct; i < O * HID; i += 256)
      if (sWo[i] != 0.f) atomicAdd(dwout + i, sWo[i]);
    if (ct < O && sdbo[ct] != 0.f) atomicAdd(dbout + ct, sdbo[ct]);
    if (!aux_stream && m.kind != 2)
      for (int a = ct; a < m.A; a += 256)
        if (sdaux[a] != 0.f) atomicAdd(daux + a, sdaux[a]);
  }
}

// Shared memory of the bf16 rows kernel: the Gs images, the weight ring,
// dXs (f32), the head weights, the per-CTA sums, the barriers. Canonical
// (HID 256, xw 128, 4 stages of [128][64]): 64 + 64 + 66 + 18.5 KB.
inline size_t bf16_rows_smem(const Meta& m, int hid, int stages) {
  const int hpn = hid < 64 ? 1 : hid / 64;
  const int pr = hid < 128 ? hid : 128;
  return 1024 + (size_t)2 * hpn * kPanelBytes + (size_t)stages * pr * 128 +
         sizeof(float) * ((size_t)kTm * (m.xw + 4) + 2 * kMaxOut * hid +
                          m.L * hid + 8 * hid + kTm * kMaxOut + kMaxOut +
                          kMaxAux) +
         (2 * kMaxStages + 2) * sizeof(uint64_t);
}

// ---------------------------------------------------------------------------
// bf16 dW: gc^T A over row ranges, wgmma on MN-major tiles of the stored
// images
// ---------------------------------------------------------------------------

struct DwItem {
  int ls;   // layer * 2 + segment
  int p0;   // first input panel (64 columns of the segment's buffer)
  int np;   // panels, <= 4
  int o0;   // first output row (128 per CTA, 64 per consumer warpgroup)
};
constexpr int kMaxDwItems = 64;
struct DwPlan {
  int count;
  DwItem item[kMaxDwItems];
};
constexpr int kDwStage = 6 * kPanelBytes;   // 2 gc panels + 4 input panels
constexpr int kDwStages = 4;

// Every (layer, segment, group of <= max_np input panels, 128 output rows).
inline bool dw_plan(const Meta& m, int hid, int max_np, DwPlan& plan) {
  const int hp = hid < 64 ? 64 : hid;
  plan.count = 0;
  for (int l = 0; l < m.L; ++l)
    for (int s = 0; s < 2; ++s) {
      const Layer& ly = m.layer[l];
      if (ly.width[s] == 0) continue;
      const int pa = ly.off[s] / 64, pb = (ly.off[s] + ly.width[s] - 1) / 64;
      for (int p0 = pa; p0 <= pb; p0 += max_np)
        for (int o0 = 0; o0 < hp; o0 += 128) {
          if (plan.count == kMaxDwItems) return false;
          DwItem& it = plan.item[plan.count++];
          it.ls = 2 * l + s;
          it.p0 = p0;
          it.np = pb - p0 + 1 < max_np ? pb - p0 + 1 : max_np;
          it.o0 = o0;
        }
    }
  return true;
}

// The consumer side of dw_bf16 for NPN input panels (0: a warpgroup past
// the last output row only keeps the ring turning): per 64-row tile, 4
// K-steps of NPN m64n64k16 products, both operands MN-major.
template <int NPN>
__device__ __forceinline__ void dw_products(float (&acc)[4][32],
                                            const unsigned char* ring,
                                            uint64_t* full, uint64_t* empty,
                                            int r0, int r1, int wg,
                                            int lane) {
  Ring rc{0, 0u, kDwStages};
  int prev = -1;
  for (int rt = r0; rt < r1; ++rt) {
    mbar_wait(full + rc.stage, rc.phase);
    const unsigned char* stg = ring + rc.stage * kDwStage;
    if (NPN > 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t ad = sw128_desc(stg + wg * kPanelBytes + kk * 2048);
#pragma unroll
        for (int j = 0; j < NPN; ++j)
          wgmma<64, 1, 1>(acc[j], ad,
                          sw128_desc(stg + (2 + j) * kPanelBytes + kk * 2048));
      }
      wgmma_commit();
    }
    if (prev >= 0) {
      if (NPN > 0) wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty + prev);
    }
    prev = rc.stage;
    rc.next();
  }
  if (NPN > 0) wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 4; ++j) fence_regs(acc[j]);
  if (lane == 0 && prev >= 0) mbar_arrive(empty + prev);
}

template <int HID>
__global__ void __launch_bounds__(kWsThreads, 1)
dw_bf16(const __grid_constant__ Meta m, const __grid_constant__ DwPlan plan,
        const int* __restrict__ k0_p,
        const __nv_bfloat16* __restrict__ act_x,
        const __nv_bfloat16* __restrict__ act_h,
        const __nv_bfloat16* __restrict__ gc, float* __restrict__ dw, int n) {
  constexpr int HPn = Shape<HID>::HPn;
  const DwItem& it = plan.item[blockIdx.x];
  const int l = it.ls >> 1, sg = it.ls & 1;
  const Layer& ly = m.layer[l];
  const int n_tiles = (n + kTm - 1) / kTm;
  const size_t T64 = 2 * (size_t)n_tiles;
  const int nt64 = (n + kWgRows - 1) / kWgRows;
  const int ft = first_live_row(k0_p, n) / kWgRows;
  const int per = (nt64 - ft + gridDim.y - 1) / gridDim.y;
  const int r0 = ft + blockIdx.y * per;
  const int r1 = min(nt64, r0 + per);
  if (r0 >= r1) return;
  const int nop = min(2, HPn - it.o0 / 64);
  const int np = it.np;
  const int src_pn = ly.buf[sg] == 0 ? x_panels(m) : HPn;
  const __nv_bfloat16* gsrc =
      gc + (size_t)l * T64 * HPn * kPanel + (it.o0 / 64) * kPanel;
  const __nv_bfloat16* asrc =
      (ly.buf[sg] == 0 ? act_x : act_h + (size_t)(l - 1) * T64 * HPn * kPanel) +
      it.p0 * kPanel;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDwStages * kDwStage);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (tid == 2 * 128) {
      Ring rp{0, 0u, kDwStages};
      for (int rt = r0; rt < r1; ++rt) {
        mbar_wait(empty + rp.stage, rp.phase ^ 1u);
        mbar_expect_tx(full + rp.stage, (nop + np) * kPanelBytes);
        unsigned char* stg = ring + rp.stage * kDwStage;
        bulk_g2s(stg, gsrc + (size_t)rt * HPn * kPanel, nop * kPanelBytes,
                 full + rp.stage);
        bulk_g2s(stg + 2 * kPanelBytes, asrc + (size_t)rt * src_pn * kPanel,
                 np * kPanelBytes, full + rp.stage);
        rp.next();
      }
    }
  } else {
    reg_alloc<232>();
    const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const bool active = wg < nop;
    float acc[4][32];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    // one fully unrolled loop per panel count, so that no product sits in
    // a branch of the loop
    switch (active ? np : 0) {
      case 1: dw_products<1>(acc, ring, full, empty, r0, r1, wg, lane); break;
      case 2: dw_products<2>(acc, ring, full, empty, r0, r1, wg, lane); break;
      case 3: dw_products<3>(acc, ring, full, empty, r0, r1, wg, lane); break;
      case 4: dw_products<4>(acc, ring, full, empty, r0, r1, wg, lane); break;
      default: dw_products<0>(acc, ring, full, empty, r0, r1, wg, lane);
    }
    if (!active) return;
    float* dwl = dw + ly.w_off;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= np) continue;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int o = it.o0 + wg * 64 + warp * 16 + g + 8 * ((e >> 1) & 1);
        const int c = (it.p0 + j) * 64 + 8 * (e >> 2) + 2 * q + (e & 1) -
                      ly.off[sg];
        const float v = acc[j][e];
        if (o < HID && c >= 0 && c < ly.width[sg] && v != 0.f)
          atomicAdd(dwl + (size_t)o * ly.K + ly.kpos[sg] + c, v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 ("highest"): the rows and dW kernels on bf16x3 pieces
// ---------------------------------------------------------------------------
//
// The f32 backward runs the bf16 schedule on three-piece images (split3,
// trunk_common.cuh): the recompute stores each 64-row tile's Xs and Hs as
// [hi | mid | lo] images, the rows kernel stores gc the same way, and every
// product is the six piece products with qa + qb <= 2, hi hi last. Tiles
// are 64 rows: three pieces of a 128-row gradient image would not fit
// beside the weights.

// rows, f32: per 64-row tile, two consumer warpgroups share the work by
// 64-column chunks: warpgroup w owns every chunk whose index within its
// segment is w mod 2, so it keeps g for its own hidden columns (HID / 4
// registers), writes their mask, gc pieces and db, and computes the input
// gradients of its own weight chunks; the producer streams each layer's
// chunks in pairs, piece by piece (lo, mid, hi; NP stages of PR <= 64 rows
// each, through a ring of up to 8), alternating owners, so both
// warpgroups issue products at once. A warpgroup frees each stage once the
// next one's products are issued, so it holds at most two.
// The mask comes from the stored hi piece (h > 0 iff its bf16 rounding
// is), the head from the three pieces' f32 sum; a chunk's input gradient
// sums the piece products with qa + qb <= 2 (hi hi last) over K = HID.

// The owner of weight chunk j of a layer (0 or 1), and j's chunk index
// within its segment.
__device__ __forceinline__ int chunk_in_seg(const Layer& ly, int j) {
  const int sg = ly.width[1] > 0 && j * 64 >= ly.kpos[1] ? 1 : 0;
  return j - ly.kpos[sg] / 64;
}

// The stream position of (chunk j, piece pb, stage p) in a layer of nch
// chunks: chunks in pairs (2i, 2i + 1), each pair piece by piece, the
// pair's two chunks alternating.
template <int NP>
__device__ __forceinline__ int stream_pos(int j, int pb, int p, int nch) {
  const int j0 = j & ~1, pair = (j0 + 1 < nch) ? 2 : 1;
  return j0 * 3 * NP + ((2 - pb) * NP + p) * pair + (j - j0);
}

// Sums over the 16 rows of each warp of v [NS * 16] (per owned chunk s,
// v[16 s + 2 k + c] = column 64 (2 s + wg) + 8 k + 2 q + c), staged per
// warp in wp[warp][HID].
template <int HID, int NS>
__device__ __forceinline__ void stage_own(float* wp, float (&v)[NS * 16],
                                          int warp, int lane, int wg) {
  fold_rows(v, lane);
  const int g = lane >> 2, q = lane & 3;
  constexpr int P = NS * 2;   // entries per lane after the fold
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int e = g * P + k, sl = e >> 4, r = e & 15;
    const int col = 64 * (2 * sl + wg) + (r >> 1) * 8 + 2 * q + (r & 1);
    if (col < HID) wp[warp * HID + col] = v[k];
  }
}

constexpr int kMaxStages3 = 8;   // ring of the f32 rows kernel

template <int HID>
struct Rows3Shape {
  static constexpr int HPn = Shape<HID>::HPn;
  static constexpr int PR = HID < 64 ? HID : 64;    // weight rows per stage
  static constexpr int NP = HID / PR;               // stages per piece
  static constexpr uint32_t kStage = PR * 128;
};

// Shared memory of the f32 rows kernel, as the kernel lays it out.
struct Rows3Smem {
  __nv_bfloat16* Gs;     // [3] pieces of the gradient image
  unsigned char* ring;
  float *dX, *Wo, *sWo, *sdb, *wp, *Gw, *sdbo, *sdaux;
  uint64_t *full, *empty, *hbar;
};

// The consumer side of rows_bwd_x3 for warpgroup WG: a template, so that
// which weight chunks a warpgroup takes depends on no thread index (a
// branch on one around the products makes ptxas serialise them).
template <int HID, int WG>
__device__ __forceinline__ void rows_x3_consumer(
    const Meta& m, int aux_stream, const float* __restrict__ x,
    const float* __restrict__ alpha_p, const float* __restrict__ gout,
    const __nv_bfloat16* __restrict__ act_h, float* __restrict__ dx,
    float* __restrict__ daux, __nv_bfloat16* __restrict__ gc,
    float* __restrict__ db, float* __restrict__ dwout,
    float* __restrict__ dbout, int n, int stages, int n_tiles, int t_first,
    const Rows3Smem& sm) {
  using S = Rows3Shape<HID>;
  constexpr int HPn = S::HPn, PR = S::PR, NP = S::NP;
  constexpr uint32_t kStage = S::kStage;
  constexpr int HS = HPn * kPanel;               // piece stride
  constexpr int NS = HPn > 1 ? HPn / 2 : 1;      // g chunks per warpgroup
  const int O = m.out_dim, dstr = m.xw + 4;
  __nv_bfloat16* Gs = sm.Gs;
  const unsigned char* ring = sm.ring;
  float *dX = sm.dX, *Wo = sm.Wo, *sWo = sm.sWo, *sdb = sm.sdb, *wp = sm.wp,
        *Gw = sm.Gw, *sdbo = sm.sdbo, *sdaux = sm.sdaux;
  uint64_t *full = sm.full, *empty = sm.empty, *hbar = sm.hbar;
  const int tid = threadIdx.x;
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bar = 2 + WG;   // this warpgroup; 1: both
  const unsigned char* gb = reinterpret_cast<const unsigned char*>(Gs);
  const float alpha = *alpha_p;
  Ring rc{0, 0u, stages};
  uint32_t hphase = 0;
  const uint32_t hi_bytes = HPn * kPanelBytes;
  if (tid == 0 && t_first < n_tiles)
    bulk_prefetch_l2(
        act_h + ((size_t)(m.L - 1) * n_tiles + t_first) * 3 * HS,
        3 * hi_bytes);
  for (int t = t_first; t < n_tiles; t += gridDim.x) {
    const int row0 = t * kTm3;
    const int nrows = max(0, min(kTm3, n - row0));
    for (int i = tid; i < kTm3 * O; i += 256)
      Gw[i] = i / O < nrows ? gout[(size_t)row0 * O + i] : 0.f;
    named_sync(1, 256);
    if (tid < O) {
      float s = 0.f;
      for (int r = 0; r < nrows; ++r) s = __fadd_rn(s, Gw[r * O + tid]);
      sdbo[tid] = __fadd_rn(sdbo[tid], s);
    }
    // g = gout Wout (f32) on this warpgroup's chunks, in the accumulator
    // layout (gs[s] holds chunk 2 s + WG)
    float go[2][kMaxOut];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o)
        go[half][o] = o < O ? Gw[(warp * 16 + g + 8 * half) * O + o] : 0.f;
    float gs[NS][32];
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = 64 * (2 * sl + WG) + 8 * k + 2 * q;
        float2 wo[kMaxOut];
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o)
          wo[o] = col < HID
                      ? *reinterpret_cast<const float2*>(Wo + o * HID + col)
                      : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = 0.f;
#pragma unroll
          for (int o = 0; o < kMaxOut; ++o)
            v = __fadd_rn(v, __fmul_rn(go[e >> 1][o],
                                       (e & 1) ? wo[o].y : wo[o].x));
          gs[sl][4 * k + e] = v;
        }
      }

    for (int l = m.L - 1; l >= 0; --l) {
      const Layer& ly = m.layer[l];
      const bool last = l == m.L - 1;
      // this layer's output tile into Gs (all three pieces for the head,
      // else the hi piece, the mask), once both warpgroups' products and
      // the last gc store have read Gs
      named_sync(1, 256);
      if (tid == 0) {
        bulk_wait_read();
        const uint32_t bytes = last ? 3 * hi_bytes : hi_bytes;
        mbar_expect_tx(hbar, bytes);
        bulk_g2s(Gs, act_h + ((size_t)l * n_tiles + t) * 3 * HS, bytes,
                 hbar);
      }
      mbar_wait(hbar, hphase);
      hphase ^= 1u;
      if (last) {
        // head: dWout[o] += h^T Go[:, o] over the tile's rows, on this
        // warpgroup's columns
        for (int o = 0; o < O; ++o) {
          float a[NS * 16];
#pragma unroll
          for (int sl = 0; sl < NS; ++sl)
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int col = 64 * (2 * sl + WG) + 8 * k + 2 * q;
              float a0 = 0.f, a1 = 0.f;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int r = warp * 16 + g + 8 * half;
                if (r < nrows && col < HID) {
                  const float2 h = get2_x3(Gs, HS, swz(r, col));
                  const float gv = Gw[r * O + o];
                  a0 = __fadd_rn(a0, __fmul_rn(h.x, gv));
                  a1 = __fadd_rn(a1, __fmul_rn(h.y, gv));
                }
              }
              a[16 * sl + 2 * k] = a0;
              a[16 * sl + 2 * k + 1] = a1;
            }
          stage_own<HID, NS>(wp, a, warp, lane, WG);
          named_sync(bar, 128);
          for (int i = wt; i < NS * 64; i += 128) {
            const int c = 64 * (2 * (i >> 6) + WG) + (i & 63);
            if (c < HID)
              sWo[o * HID + c] =
                  __fadd_rn(sWo[o * HID + c], warps_sum<HID>(wp, c));
          }
          named_sync(bar, 128);
        }
      }
      // ReLU mask from the hi piece, gc = g split into Gs in place, then
      // db's column sums, on this warpgroup's columns
      float v[NS * 16];
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int col = 64 * (2 * sl + WG) + 8 * k + 2 * q;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + g + 8 * half;
            float& v0 = gs[sl][4 * k + 2 * half];
            float& v1 = gs[sl][4 * k + 2 * half + 1];
            if (col < HID) {
              float h0 = 0.f, h1 = 0.f;
              if (r < nrows) {
                const float2 h = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(Gs +
                                                             swz(r, col)));
                h0 = h.x;
                h1 = h.y;
              }
              v0 = h0 > 0.f ? v0 : 0.f;
              v1 = h1 > 0.f ? v1 : 0.f;
              put2<3>(Gs, HS, swz(r, col), v0, v1);
            }
          }
          v[16 * sl + 2 * k] = __fadd_rn(gs[sl][4 * k], gs[sl][4 * k + 2]);
          v[16 * sl + 2 * k + 1] =
              __fadd_rn(gs[sl][4 * k + 1], gs[sl][4 * k + 3]);
        }
      stage_own<HID, NS>(wp, v, warp, lane, WG);
      fence_async();
      named_sync(bar, 128);
      for (int i = wt; i < NS * 64; i += 128) {
        const int c = 64 * (2 * (i >> 6) + WG) + (i & 63);
        if (c < HID)
          sdb[l * HID + c] = __fadd_rn(sdb[l * HID + c], warps_sum<HID>(wp, c));
      }
      named_sync(1, 256);   // both warpgroups' gc pieces are in Gs
      if (tid == 0) {
        bulk_s2g(gc + ((size_t)l * n_tiles + t) * 3 * HS, Gs, 3 * hi_bytes);
        const int tn = l > 0 ? t : t + (int)gridDim.x;
        if (tn < n_tiles)
          bulk_prefetch_l2(
              act_h + ((size_t)(l > 0 ? l - 1 : m.L - 1) * n_tiles + tn) *
                          3 * HS,
              l > 0 ? hi_bytes : 3 * hi_bytes);
      }

      // input gradients gc W of this warpgroup's weight chunks; the
      // ring walks every stage of the layer, waiting only for its own
      const int nch = ly.K / 64;
      const Ring r0 = rc;
      for (int j = 0; j < nch; ++j) {
        const int cj = chunk_in_seg(ly, j);
        if ((cj & 1) != WG) continue;
        float u[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) u[i] = 0.f;
        int prev = -1;
#pragma unroll
        for (int pb = 2; pb >= 0; --pb)
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const int at = r0.stage + stream_pos<NP>(j, pb, p, nch);
            const int stage = at % stages;
            mbar_wait(full + stage,
                      r0.phase ^ (uint32_t)((at / stages) & 1));
            wgmma_fence();
            const unsigned char* stg = ring + stage * kStage;
#pragma unroll
            for (int pa = 2 - pb; pa >= 0; --pa)
#pragma unroll
              for (int i = 0; i < PR / 16; ++i) {
                const int k = p * PR + 16 * i;
                wgmma<64, 0, 1>(u,
                                sw128_desc(gb + pa * 2 * HS +
                                           (k >> 6) * kPanelBytes +
                                           (k & 63) * 2),
                                sw128_desc(stg + i * 16 * 128));
              }
            wgmma_commit();
            if (prev >= 0) {
              wgmma_wait<1>();
              if (lane == 0) mbar_arrive(empty + prev);
            }
            prev = stage;
          }
        wgmma_wait<0>();
        fence_regs(u);
        if (lane == 0) mbar_arrive(empty + prev);
        // the chunk's columns: this warpgroup's next g (an Hs segment)
        // or into dX (Xs)
        const int sg = ly.width[1] > 0 && j * 64 >= ly.kpos[1] ? 1 : 0;
        const int width = ly.width[sg];
        if (ly.buf[sg]) {
#pragma unroll
          for (int sl = 0; sl < NS; ++sl)
            if (2 * sl + WG == cj) {
#pragma unroll
              for (int e = 0; e < 32; ++e) gs[sl][e] = u[e];
            }
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int r = warp * 16 + g + 8 * ((e >> 1) & 1);
            const int c = cj * 64 + 8 * (e >> 2) + 2 * q + (e & 1);
            if (c < width) dX[r * dstr + ly.off[sg] + c] += u[e];
          }
        }
      }
      // the ring after the layer's 3 NP nch stages
      {
        const int adv = 3 * NP * nch;
        rc.stage = (r0.stage + adv) % stages;
        rc.phase = r0.phase ^ (uint32_t)(((r0.stage + adv) / stages) & 1);
      }
    }
    named_sync(1, 256);
    embed_aux_bwd(m, dX, dstr, x, alpha, row0, nrows, aux_stream, dx,
                  aux_stream ? daux : sdaux, tid, 256);
    named_sync(1, 256);
    for (int i = tid; i < kTm3 * dstr; i += 256) dX[i] = 0.f;
  }
  if (tid == 0) bulk_wait_all();
  named_sync(1, 256);   // the shared sums are complete
  for (int i = tid; i < m.L * HID; i += 256)
    if (sdb[i] != 0.f) atomicAdd(db + i, sdb[i]);
  for (int i = tid; i < O * HID; i += 256)
    if (sWo[i] != 0.f) atomicAdd(dwout + i, sWo[i]);
  if (tid < O && sdbo[tid] != 0.f) atomicAdd(dbout + tid, sdbo[tid]);
  if (!aux_stream && m.kind != 2)
    for (int a = tid; a < m.A; a += 256)
      if (sdaux[a] != 0.f) atomicAdd(daux + a, sdaux[a]);
}

template <int HID>
__global__ void __launch_bounds__(kWsThreads, 1)
rows_bwd_x3(const __grid_constant__ Meta m, int aux_stream,
            const float* __restrict__ x, const float* __restrict__ alpha_p,
            const int* __restrict__ k0_p, const float* __restrict__ gout,
            const __nv_bfloat16* __restrict__ act_h,
            const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ wout, float* __restrict__ dx,
            float* __restrict__ daux, __nv_bfloat16* __restrict__ gc,
            float* __restrict__ db, float* __restrict__ dwout,
            float* __restrict__ dbout, int n, int stages) {
  using S = Rows3Shape<HID>;
  constexpr int HPn = S::HPn, PR = S::PR, NP = S::NP;
  constexpr uint32_t kStage = S::kStage;
  constexpr int HS = HPn * kPanel;               // piece stride
  constexpr int NS = HPn > 1 ? HPn / 2 : 1;      // g chunks per warpgroup
  const int O = m.out_dim, dstr = m.xw + 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  __nv_bfloat16* Gs = reinterpret_cast<__nv_bfloat16*>(base);   // [3] pieces
  unsigned char* ring = reinterpret_cast<unsigned char*>(Gs + 3 * HS);
  float* dX = reinterpret_cast<float*>(ring + stages * kStage);  // [64][dstr]
  float* Wo = dX + kTm3 * dstr;
  float* sWo = Wo + kMaxOut * HID;
  float* sdb = sWo + kMaxOut * HID;
  float* wp = sdb + m.L * HID;                        // [4 warps][HID]
  float* Gw = wp + 4 * HID;                           // [64][O]
  float* sdbo = Gw + kTm3 * kMaxOut;
  float* sdaux = sdbo + kMaxOut;
  uint64_t* full = reinterpret_cast<uint64_t*>(sdaux + kMaxAux);
  uint64_t* empty = full + kMaxStages3;
  uint64_t* hbar = empty + kMaxStages3;   // act_h tile -> Gs

  const int tid = threadIdx.x;
  {
    uint4* z = reinterpret_cast<uint4*>(Gs);
    for (int i = tid; i < 3 * HPn * kPanelBytes / 16; i += kWsThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kTm3 * dstr; i += kWsThreads) dX[i] = 0.f;
    for (int i = tid; i < kMaxOut * HID; i += kWsThreads)
      Wo[i] = i < O * HID ? wout[i] : 0.f;
    for (int i = tid; i < kMaxOut * HID + m.L * HID; i += kWsThreads)
      sWo[i] = 0.f;                                   // sWo, then sdb
    for (int i = tid; i < kMaxOut + kMaxAux; i += kWsThreads) sdbo[i] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);   // the owning warpgroup's four warps
    }
    mbar_init(hbar, 1);
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
        for (int l = m.L - 1; l >= 0; --l) {
          const Layer& ly = m.layer[l];
          const __nv_bfloat16* wl = w + 3 * (size_t)ly.w_off;
          const int nch = ly.K / 64;
          for (int j0 = 0; j0 < nch; j0 += 2)
            for (int pb = 2; pb >= 0; --pb)   // lo, mid, hi
              for (int p = 0; p < NP; ++p)
                for (int j = j0; j < j0 + 2 && j < nch; ++j) {
                  mbar_wait(empty + rp.stage, rp.phase ^ 1u);
                  mbar_expect_tx(full + rp.stage, kStage);
                  bulk_g2s(ring + rp.stage * kStage,
                           wl + ((size_t)(3 * j + pb) * HID + p * PR) * 64,
                           kStage, full + rp.stage);
                  rp.next();
                }
        }
    }
  } else {
    reg_alloc<232>();
    const Rows3Smem sm{Gs, ring, dX, Wo, sWo, sdb, wp, Gw, sdbo, sdaux,
                       full, empty, hbar};
    if (wg == 0)
      rows_x3_consumer<HID, 0>(m, aux_stream, x, alpha_p, gout, act_h, dx,
                               daux, gc, db, dwout, dbout, n, stages,
                               n_tiles, t_first, sm);
    else
      rows_x3_consumer<HID, 1>(m, aux_stream, x, alpha_p, gout, act_h, dx,
                               daux, gc, db, dwout, dbout, n, stages,
                               n_tiles, t_first, sm);
  }
}

// Shared memory of the f32 rows kernel: the three-piece Gs image, the
// weight ring, dX (f32), the head weights, the per-CTA sums, the barriers.
// Canonical (HID 256, xw 128, 8 stages of [64][64]): 96 + 64 + 33 + 22 KB.
inline size_t x3_rows_smem(const Meta& m, int hid, int stages) {
  const int hpn = hid < 64 ? 1 : hid / 64;
  const int pr = hid < 64 ? hid : 64;
  return 1024 + (size_t)3 * hpn * kPanelBytes + (size_t)stages * pr * 128 +
         sizeof(float) * ((size_t)kTm3 * (m.xw + 4) + 2 * kMaxOut * hid +
                          m.L * hid + 4 * hid + kTm3 * kMaxOut + kMaxOut +
                          kMaxAux) +
         (2 * kMaxStages3 + 1) * sizeof(uint64_t);
}

// dW, f32: the bf16 dW kernel's items on three-piece tiles, at most 2
// input panels per item (a stage holds each operand's three pieces).
constexpr int kDw3Panels = 2;
constexpr int kDw3Stage = 3 * (2 + kDw3Panels) * kPanelBytes;   // 96 KB
constexpr int kDw3Stages = 2;

// Per stage (one 64-row tile): 4 K-steps of NPN panels, six piece
// products each (qg + qa <= 2, hi hi last), both operands MN-major.
template <int NPN>
__device__ __forceinline__ void dw_products_x3(float (&acc)[kDw3Panels][32],
                                               const unsigned char* ring,
                                               uint64_t* full,
                                               uint64_t* empty, int r0,
                                               int r1, int wg, int lane) {
  Ring rc{0, 0u, kDw3Stages};
  int prev = -1;
  for (int rt = r0; rt < r1; ++rt) {
    mbar_wait(full + rc.stage, rc.phase);
    const unsigned char* stg = ring + rc.stage * kDw3Stage;
    if (NPN > 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < NPN; ++j) {
          // gc piece qg of this warpgroup's 64 outputs, input piece qa
          auto prod = [&](int qg, int qa) {
            wgmma<64, 1, 1>(
                acc[j],
                sw128_desc(stg + (qg * 2 + wg) * kPanelBytes + kk * 2048),
                sw128_desc(stg + (6 + qa * kDw3Panels + j) * kPanelBytes +
                           kk * 2048));
          };
          prod(2, 0);
          prod(0, 2);
          prod(1, 1);
          prod(1, 0);
          prod(0, 1);
          prod(0, 0);
        }
      wgmma_commit();
    }
    if (prev >= 0) {
      if (NPN > 0) wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty + prev);
    }
    prev = rc.stage;
    rc.next();
  }
  if (NPN > 0) wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < kDw3Panels; ++j) fence_regs(acc[j]);
  if (lane == 0 && prev >= 0) mbar_arrive(empty + prev);
}

template <int HID>
__global__ void __launch_bounds__(kWsThreads, 1)
dw_x3(const __grid_constant__ Meta m, const __grid_constant__ DwPlan plan,
      const int* __restrict__ k0_p, const __nv_bfloat16* __restrict__ act_x,
      const __nv_bfloat16* __restrict__ act_h,
      const __nv_bfloat16* __restrict__ gc, float* __restrict__ dw, int n) {
  constexpr int HPn = Shape<HID>::HPn;
  constexpr int HS = HPn * kPanel;
  const DwItem& it = plan.item[blockIdx.x];
  const int l = it.ls >> 1, sg = it.ls & 1;
  const Layer& ly = m.layer[l];
  const int n_tiles = (n + kTm3 - 1) / kTm3;
  const int ft = first_live_row(k0_p, n) / kTm3;
  const int per = (n_tiles - ft + gridDim.y - 1) / gridDim.y;
  const int r0 = ft + blockIdx.y * per;
  const int r1 = min(n_tiles, r0 + per);
  if (r0 >= r1) return;
  const int nop = min(2, HPn - it.o0 / 64);
  const int np = it.np;
  const int src_pn = ly.buf[sg] == 0 ? x_panels(m) : HPn;
  // tile rt, piece k: gsrc + (3 rt + k) HS, asrc + (3 rt + k) src_pn panels
  const __nv_bfloat16* gsrc =
      gc + (size_t)l * n_tiles * 3 * HS + (it.o0 / 64) * kPanel;
  const __nv_bfloat16* asrc =
      (ly.buf[sg] == 0 ? act_x : act_h + (size_t)(l - 1) * n_tiles * 3 * HS) +
      it.p0 * kPanel;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDw3Stages * kDw3Stage);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kDw3Stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (tid == 2 * 128) {
      Ring rp{0, 0u, kDw3Stages};
      for (int rt = r0; rt < r1; ++rt) {
        mbar_wait(empty + rp.stage, rp.phase ^ 1u);
        mbar_expect_tx(full + rp.stage, 3 * (nop + np) * kPanelBytes);
        unsigned char* stg = ring + rp.stage * kDw3Stage;
        for (int k = 0; k < 3; ++k) {
          bulk_g2s(stg + 2 * k * kPanelBytes, gsrc + (size_t)(3 * rt + k) * HS,
                   nop * kPanelBytes, full + rp.stage);
          bulk_g2s(stg + (6 + k * kDw3Panels) * kPanelBytes,
                   asrc + (size_t)(3 * rt + k) * src_pn * kPanel,
                   np * kPanelBytes, full + rp.stage);
        }
        rp.next();
      }
    }
  } else {
    reg_alloc<232>();
    const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const bool active = wg < nop;
    float acc[kDw3Panels][32];
#pragma unroll
    for (int j = 0; j < kDw3Panels; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    switch (active ? np : 0) {
      case 1: dw_products_x3<1>(acc, ring, full, empty, r0, r1, wg, lane); break;
      case 2: dw_products_x3<2>(acc, ring, full, empty, r0, r1, wg, lane); break;
      default: dw_products_x3<0>(acc, ring, full, empty, r0, r1, wg, lane);
    }
    if (!active) return;
    float* dwl = dw + ly.w_off;
#pragma unroll
    for (int j = 0; j < kDw3Panels; ++j) {
      if (j >= np) continue;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int o = it.o0 + wg * 64 + warp * 16 + g + 8 * ((e >> 1) & 1);
        const int c = (it.p0 + j) * 64 + 8 * (e >> 2) + 2 * q + (e & 1) -
                      ly.off[sg];
        const float v = acc[j][e];
        if (o < HID && c >= 0 && c < ly.width[sg] && v != 0.f)
          atomicAdd(dwl + (size_t)o * ly.K + ly.kpos[sg] + c, v);
      }
    }
  }
}

template <int HID>
int launch_bwd(const Meta& m, int bf16, int aux_stream, const float* x,
               const float* aux, const float* alpha, const int* k0,
               const void* w, const void* b, const float* wout,
               const float* gout, void* act_x,
               void* act_h, void* gc, float* dx, float* daux, float* db,
               float* dwout, float* dbout, float* dw, int n, int splits,
               cudaStream_t s) {
  int rc = launch_fwd<HID, true>(m, bf16, x, aux, alpha, k0, w, b, wout,
                                 nullptr, nullptr, act_x, act_h, n, s);
  if (rc != 0) return rc;
  if (bf16) {
    const int stages =
        ring_depth([&](int st) { return bf16_rows_smem(m, HID, st); });
    DwPlan plan;
    if (stages == 0 || (!aux_stream && m.A > kMaxAux) || !dw_plan(m, HID, 4, plan))
      return (int)cudaErrorInvalidValue;
    const size_t smem = bf16_rows_smem(m, HID, stages);
    cudaError_t e = cudaFuncSetAttribute(
        rows_bwd_bf16<HID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int tiles = (n + kTm - 1) / kTm;
    rows_bwd_bf16<HID><<<tiles < num_sms() ? tiles : num_sms(), kWsThreads,
                         smem, s>>>(
        m, aux_stream, x, alpha, k0, gout,
        static_cast<const __nv_bfloat16*>(act_h),
        static_cast<const __nv_bfloat16*>(w), wout, dx, daux,
        static_cast<__nv_bfloat16*>(gc), db, dwout, dbout, n, stages);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const size_t dw_smem =
        1024 + (size_t)kDwStages * kDwStage + 2 * kMaxStages * sizeof(uint64_t);
    e = cudaFuncSetAttribute(dw_bf16<HID>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dw_smem);
    if (e != cudaSuccess) return (int)e;
    dw_bf16<HID><<<dim3(plan.count, splits), kWsThreads, dw_smem, s>>>(
        m, plan, k0, static_cast<const __nv_bfloat16*>(act_x),
        static_cast<const __nv_bfloat16*>(act_h),
        static_cast<const __nv_bfloat16*>(gc), dw, n);
  } else {
    // at least 3 stages: a warpgroup waits for its next stage (two stream
    // positions on) while it holds its last one
    int stages = kMaxStages3;
    while (stages >= 3 && x3_rows_smem(m, HID, stages) > (size_t)kSmemLimit)
      --stages;
    if (stages < 3) stages = 0;
    DwPlan plan;
    if (stages == 0 || (!aux_stream && m.A > kMaxAux) ||
        !dw_plan(m, HID, kDw3Panels, plan))
      return (int)cudaErrorInvalidValue;
    const size_t smem = x3_rows_smem(m, HID, stages);
    cudaError_t e = cudaFuncSetAttribute(
        rows_bwd_x3<HID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int tiles = (n + kTm3 - 1) / kTm3;
    rows_bwd_x3<HID><<<tiles < num_sms() ? tiles : num_sms(), kWsThreads,
                       smem, s>>>(
        m, aux_stream, x, alpha, k0, gout,
        static_cast<const __nv_bfloat16*>(act_h),
        static_cast<const __nv_bfloat16*>(w), wout, dx, daux,
        static_cast<__nv_bfloat16*>(gc), db, dwout, dbout, n, stages);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const size_t dw_smem = 1024 + (size_t)kDw3Stages * kDw3Stage +
                           2 * kMaxStages * sizeof(uint64_t);
    e = cudaFuncSetAttribute(dw_x3<HID>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dw_smem);
    if (e != cudaSuccess) return (int)e;
    dw_x3<HID><<<dim3(plan.count, splits), kWsThreads, dw_smem, s>>>(
        m, plan, k0, static_cast<const __nv_bfloat16*>(act_x),
        static_cast<const __nv_bfloat16*>(act_h),
        static_cast<const __nv_bfloat16*>(gc), dw, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hosnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// meta: as hosnerf_embed_trunk. w/b: the forward's packed weights and
// biases (every kernel reads the chunk images, the backward's transposed);
// wout [out_dim, HID] f32; gout [n, out_dim] f32. Scratch, bf16: act_x,
// act_h [L], gc [L], the swizzled 64-row tile images of
// mlp.py::_act_buffers (f32: three pieces per tile). Outputs: dx [n, 3] and, when aux_stream, daux
// [n, A] (rows below the clamped k0 * 1024 unwritten); accumulated (zeroed
// by the caller): daux [A] when broadcast, db [L, HID], dwout [out_dim,
// HID], dbout [out_dim], dw (packed [HID][K] per layer at the weights'
// offsets). splits: row ranges of the dW products. Returns
// cudaGetLastError().
int hosnerf_embed_trunk_bwd(const int* meta, int bf16, int aux_stream,
                            const float* x, const float* aux,
                            const float* alpha, const int* k0, const void* w,
                            const void* b, const float* wout,
                            const float* gout, void* act_x, void* act_h,
                            void* gc, float* dx, float* daux, float* db,
                            float* dwout, float* dbout, float* dw, int n,
                            int splits, void* stream) {
  trunk::Meta m;
  if (!trunk::parse_meta(meta, m) || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m.hid) {
    case 32: return launch_bwd<32>(m, bf16, aux_stream, x, aux, alpha, k0, w, b, wout, gout, act_x, act_h, gc, dx, daux, db, dwout, dbout, dw, n, splits, s);
    case 128: return launch_bwd<128>(m, bf16, aux_stream, x, aux, alpha, k0, w, b, wout, gout, act_x, act_h, gc, dx, daux, db, dwout, dbout, dw, n, splits, s);
    case 256: return launch_bwd<256>(m, bf16, aux_stream, x, aux, alpha, k0, w, b, wout, gout, act_x, act_h, gc, dx, daux, db, dwout, dbout, dw, n, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
