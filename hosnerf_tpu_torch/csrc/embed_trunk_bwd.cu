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

// Every (layer, segment, group of <= 4 input panels, 128 output rows).
inline bool dw_plan(const Meta& m, int hid, DwPlan& plan) {
  const int hp = hid < 64 ? 64 : hid;
  plan.count = 0;
  for (int l = 0; l < m.L; ++l)
    for (int s = 0; s < 2; ++s) {
      const Layer& ly = m.layer[l];
      if (ly.width[s] == 0) continue;
      const int pa = ly.off[s] / 64, pb = (ly.off[s] + ly.width[s] - 1) / 64;
      for (int p0 = pa; p0 <= pb; p0 += 4)
        for (int o0 = 0; o0 < hp; o0 += 128) {
          if (plan.count == kMaxDwItems) return false;
          DwItem& it = plan.item[plan.count++];
          it.ls = 2 * l + s;
          it.p0 = p0;
          it.np = pb - p0 + 1 < 4 ? pb - p0 + 1 : 4;
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
  embed_aux_bwd(m, dXs, dstr, x, *alpha_p, row0, nrows, aux_stream, dx, daux,
                threadIdx.x, blockDim.x);
}

// ---------------------------------------------------------------------------
// f32 dW_i = A_i^T gc_i: split over row ranges, one 64 x 64 tile per CTA
// ---------------------------------------------------------------------------

constexpr int kDwTile = 64;

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

size_t f32_rows_smem(const Meta& m, int hid) {
  const int O = m.out_dim;
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
  if (bf16) {
    const int stages =
        ring_depth([&](int st) { return bf16_rows_smem(m, HID, st); });
    DwPlan plan;
    if (stages == 0 || (!aux_stream && m.A > kMaxAux) || !dw_plan(m, HID, plan))
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
    const size_t smem = f32_rows_smem(m, HID);
    int max_tiles = 0;
    for (int l = 0; l < m.L; ++l) {
      const int tiles = ((HID + kDwTile - 1) / kDwTile) *
                        ((m.layer[l].K + kDwTile - 1) / kDwTile);
      max_tiles = tiles > max_tiles ? tiles : max_tiles;
    }
    const dim3 dw_grid(max_tiles, m.L, splits);
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
// biases; wt: f32 only, the same weights packed [HID][K] per layer for the
// rows kernel (null for bf16, whose kernels read the forward's chunk
// images transposed); wout [out_dim, HID] f32; gout [n, out_dim] f32.
// Scratch (bf16 when bf16, else f32): act_x, act_h [L], gc [L]; bf16: the
// swizzled 64-row tile images of mlp.py::_act_buffers, f32: [n, xw] and
// [L, n, HID] row-major. Outputs: dx [n, 3] and, when aux_stream, daux
// [n, A] (rows below the clamped k0 * 1024 unwritten); accumulated (zeroed
// by the caller): daux [A] when broadcast, db [L, HID], dwout [out_dim,
// HID], dbout [out_dim], dw (packed [HID][K] per layer at the weights'
// offsets). splits: row ranges of the dW products. Returns
// cudaGetLastError().
int hosnerf_embed_trunk_bwd(const int* meta, int bf16, int aux_stream,
                            const float* x, const float* aux,
                            const float* alpha, const int* k0, const void* w,
                            const void* b, const void* wt, const float* wout,
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
    case 32: return launch_bwd<32>(m, bf16, aux_stream, x, aux, alpha, k0, w, b, wt, wout, gout, act_x, act_h, gc, dx, daux, db, dwout, dbout, dw, n, splits, s);
    case 128: return launch_bwd<128>(m, bf16, aux_stream, x, aux, alpha, k0, w, b, wt, wout, gout, act_x, act_h, gc, dx, daux, db, dwout, dbout, dw, n, splits, s);
    case 256: return launch_bwd<256>(m, bf16, aux_stream, x, aux, alpha, k0, w, b, wt, wout, gout, act_x, act_h, gc, dx, daux, db, dwout, dbout, dw, n, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
