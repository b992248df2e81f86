// Fused MLP trunk + f32 head, for Hopper, on a positional embedding or on
// raw input rows.
//
// Replaces: hosnerf_tpu/ops/pallas/mlp.py::fused_embed_trunk (the Pallas
// kernel _efwd_kernel, launched from _make_embed_fused.run_fwd) and
// fused_trunk (the Pallas kernel _fwd_kernel, launched from
// _make_fused.run_fwd).
//
// Per row: build the PE of x [3] (fourier with the input prepended, or
// hann-windowed) and concat it with the aux row (a 75-d condition code or a
// 64-d state embedding; row stride 0 broadcasts one row), or take the raw
// row x [Din] (trunk_common.cuh, kind 2); run L ReLU layers of width HID
// with one skip layer whose input re-concatenates part of the first input,
// then an f32 linear head.
//
// Design. The TPU kernel keeps every layer's weights resident in a 100 MB
// VMEM budget and streams row tiles through. An SM has 227 KB, and the
// canonical trunk's bf16 weights are ~1 MB (its skip layer alone is
// 383 x 256 x 2 = 196 KB), so this kernel inverts that: a CTA keeps its
// row tile's activations on chip for the whole trunk (the PE/aux input in
// Xs, the hidden state in Hs, updated in place) and streams each layer's
// weights through a double-buffered shared-memory ring in K-chunks with
// cp.async. Nothing but x, aux and the output touches device memory per
// row; the weights (< 1.1 MB) are re-read by every CTA from L2.
//   bf16: 128-row tiles, 8 warps, each warp owns 16 rows and all HID
//         output columns as m16n8k16 mma.sync accumulators (f32).
//   f32:  64-row tiles, 256 threads, 4x(HID/16) FMA register tiles.
// The layer inputs are up to two segments of Xs/Hs, each a multiple of 16
// columns; the host scatters the weight columns to match (csrc layout
// documented in hosnerf_tpu_torch/ops/cuda/mlp.py::_pack). The kernels
// themselves live in trunk_common.cuh, which the backward
// (embed_trunk_bwd.cu) shares for its recomputation.
//
// Bound. Canonical: ~1.05 MFLOP per row against ~0.3 KB of row traffic,
// so the kernel is bound by the tensor cores' issue rate (bf16) or FP32
// FMA throughput (f32), and by the shared-memory bandwidth that feeds
// them: with mma.sync the B fragments come from shared memory once per
// 16x8x16 product. A wgmma version would lift that; this one is the
// simple, correct first kernel.
//
// Numerics (bf16) reproduce mlp.py::_forward_tile: the whole input row is
// rounded to bf16, each layer accumulates bf16 x bf16 products in f32,
// rounds to bf16, adds the bf16 bias in bf16 (one more rounding), then
// ReLU. The head reads the bf16 hidden state as f32 and runs in f32.
//
// Live suffix: k0 (a device int, in 1024-row blocks) is clamped to
// [0, n_blocks - 1]; CTAs whose rows lie below k0 * 1024 exit at once and
// leave those output rows unwritten, as the TPU kernel does.

#include "trunk_common.cuh"

extern "C" {

const char* hosnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// meta: int32 host array, see hosnerf_tpu_torch/ops/cuda/mlp.py::_pack_meta.
// x [n, 3] f32 ([n, Din] for the raw kind); aux rows of A floats at stride
// meta.aux_stride; alpha [1] f32 and k0 [1] int32 on the device; w/b packed
// weights and biases (bf16 when bf16, else f32); wout [out_dim, HID] f32;
// bout [out_dim] f32; out [n, out_dim] f32. Returns cudaGetLastError()
// after the launch.
int hosnerf_embed_trunk(const int* meta, int bf16, const float* x,
                        const float* aux, const float* alpha, const int* k0,
                        const void* w, const void* b, const float* wout,
                        const float* bout, float* out, int n, void* stream) {
  trunk::Meta m;
  if (!trunk::parse_meta(meta, m)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m.hid) {
    case 32: return trunk::launch_fwd<32, false>(m, bf16, x, aux, alpha, k0, w, b, wout, bout, out, nullptr, nullptr, n, s);
    case 128: return trunk::launch_fwd<128, false>(m, bf16, x, aux, alpha, k0, w, b, wout, bout, out, nullptr, nullptr, n, s);
    case 256: return trunk::launch_fwd<256, false>(m, bf16, x, aux, alpha, k0, w, b, wout, bout, out, nullptr, nullptr, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
