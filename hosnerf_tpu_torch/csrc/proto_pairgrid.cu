// The pair-grid prototype for Hopper: a dynamic-length list of (tile, bone
// pair) steps, each adding x * (column sums of its bones' [G, G] slabs) to
// its tile's output rows and one to every entry of those slabs' dvol.
//
// Replaces: tools/proto_pairgrid.py::run (the Pallas kernel `kernel`,
// launched from run), the prototype of the TPU pair-grid schedule's
// features: a grid whose length is a device scalar, output blocks chosen by
// a prefetched pair -> tile table and revisited by consecutive steps
// (first visit sets, later visits add), and dynamic-index accumulation
// into a resident output.
//
// Design. The TPU runs the steps in order on one core. Here one CTA takes
// one step slot; the pair count is read on the device, so slots at or
// beyond it return at once (no host sync). The first step of each run of
// consecutive steps on one tile leads the run: it walks the run in order,
// setting the tile's rows on the first step and adding on the later ones,
// exactly the TPU's order of sums; a tile revisited by a later run is
// written by that run (the last visit wins, as on the TPU). Tiles with no
// step below the count stay unwritten. Every step adds its dvol ones with
// atomics (exact: the counts are small integers).
//
// Bound: a few KB of traffic; launch latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// ptile [cap] int32 tile of each step; pbone [cap * ngb] int32 its bones;
// x [n_tiles * T] f32; vol [bpd, G, G] f32; out [n_tiles * T, G] f32;
// dvol [bpd, G, G] f32 (zeroed by the caller).
__global__ void __launch_bounds__(kThreads)
pairgrid_kernel(const int* __restrict__ n_pairs_p,
                const int* __restrict__ ptile, const int* __restrict__ pbone,
                const float* __restrict__ x, const float* __restrict__ vol,
                float* __restrict__ out, float* __restrict__ dvol, int cap,
                int T, int G, int ngb) {
  extern __shared__ float colsum[];                     // [ngb][G]
  const int i = blockIdx.x;
  const int n_pairs = min(*n_pairs_p, cap);
  if (i >= n_pairs) return;
  for (int j = 0; j < ngb; ++j) {
    float* dv = dvol + (size_t)pbone[i * ngb + j] * G * G;
    for (int e = threadIdx.x; e < G * G; e += blockDim.x)
      atomicAdd(dv + e, 1.f);
  }
  const int tile = ptile[i];
  if (i > 0 && ptile[i - 1] == tile) return;            // not a run leader
  int end = i + 1;
  while (end < n_pairs && ptile[end] == tile) ++end;
  for (int k = end; k < n_pairs; ++k)
    if (ptile[k] == tile) return;                       // a later run wins

  const float* xt = x + (size_t)tile * T;
  float* ot = out + (size_t)tile * T * G;
  for (int p = i; p < end; ++p) {
    __syncthreads();
    for (int c = threadIdx.x; c < ngb * G; c += blockDim.x) {
      const int j = c / G, g = c - j * G;
      const float* slab = vol + (size_t)pbone[p * ngb + j] * G * G;
      float s = 0.f;
      for (int r = 0; r < G; ++r) s = __fadd_rn(s, slab[r * G + g]);
      colsum[c] = s;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < T * G; e += blockDim.x) {
      const int r = e / G, g = e - r * G;
      float contrib = 0.f;
      for (int j = 0; j < ngb; ++j)
        contrib = __fadd_rn(contrib, __fmul_rn(xt[r], colsum[j * G + g]));
      ot[e] = p == i ? contrib : __fadd_rn(ot[e], contrib);
    }
  }
}

}  // namespace

extern "C" {

const char* hosnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// n_pairs [1] int32 on the device (clamped to cap); the rest as
// pairgrid_kernel. Returns cudaGetLastError() after the launch.
int hosnerf_proto_pairgrid(const int* n_pairs, const int* ptile,
                           const int* pbone, const float* x, const float* vol,
                           float* out, float* dvol, int cap, int T, int G,
                           int ngb, void* stream) {
  if (cap <= 0) return 0;
  if (T <= 0 || G <= 0 || ngb <= 0) return (int)cudaErrorInvalidValue;
  pairgrid_kernel<<<cap, kThreads, sizeof(float) * ngb * G,
                    static_cast<cudaStream_t>(stream)>>>(
      n_pairs, ptile, pbone, x, vol, out, dvol, cap, T, G, ngb);
  return (int)cudaGetLastError();
}

}  // extern "C"
