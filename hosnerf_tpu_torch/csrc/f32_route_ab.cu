// The two routes to f32-grade products on Hopper's tensor cores, side by
// side, for the choice behind the f32 ("highest") trunk kernels
// (trunk_common.cuh): no TPU kernel is replaced here.
//
//   bf16x3: each f32 operand as three bf16 pieces (trunk::split3), six
//           m64n128k16 bf16 products per 16 columns of K (piece indices
//           qa + qb <= 2, hi hi last);
//   3xTF32: each f32 operand as two TF32 pieces (hi = tf32(v) rounded to
//           nearest, lo = tf32(v - hi)), three m64n128k8 tf32 products per
//           8 columns of K (lo hi, hi lo, hi hi).
//
// One warpgroup per CTA multiplies a resident [64 x 64] A tile by a
// [64 x 128] B tile `reps` times into one accumulator, both operands
// K-major in 128-byte-swizzled shared memory: the tensor cores' issue rate
// for each route without any memory traffic. Bound by the tensor cores:
// 989 TFLOP/s bf16 / 6 = 495 TFLOP/s tf32 / 3 = 165 TFLOP/s of f32-grade
// products on an H100 SXM.

#include "trunk_common.cuh"

namespace {

using namespace trunk;

constexpr int kM = 64, kN = 128, kK = 64;

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db));
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// Element index of (row r, f32 column c) in [rows][32]-column panels of
// the 128-byte swizzle (16-byte group j of row r at group j ^ (r % 8)).
__device__ __forceinline__ int swz32(int r, int c, int rows) {
  return (c >> 5) * rows * 32 + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) +
         (c & 3);
}

// route 0: bf16x3; route 1: 3xTF32. a [64][64], b [128][64] (N rows of K),
// out [64][128] (the accumulator after `reps` passes, one CTA's).
template <int ROUTE>
__global__ void __launch_bounds__(128)
route_ab(const float* __restrict__ a, const float* __restrict__ b,
         float* __restrict__ out, int reps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int tid = threadIdx.x;
  constexpr int P = ROUTE == 0 ? 3 : 2;                    // pieces
  constexpr int EB = ROUTE == 0 ? 2 : 4;                   // element bytes
  constexpr int AS = kM * kK * EB, BS = kN * kK * EB;      // piece bytes
  unsigned char* As = base;
  unsigned char* Bs = base + P * AS;
  for (int i = tid; i < kM * kK + kN * kK; i += 128) {
    const bool is_a = i < kM * kK;
    const int j = is_a ? i : i - kM * kK;
    const int r = j / kK, c = j - r * kK;
    const float v = is_a ? a[j] : b[j];
    unsigned char* img = is_a ? As : Bs;
    const int ps = is_a ? AS : BS;
    if constexpr (ROUTE == 0) {
      __nv_bfloat16 p[3];
      split3(v, p);
      for (int k = 0; k < 3; ++k)
        reinterpret_cast<__nv_bfloat16*>(img + k * ps)[swz(r, c)] = p[k];
    } else {
      const float hi = tf32_rna(v);
      const int at = swz32(r, c, is_a ? kM : kN);
      reinterpret_cast<float*>(img)[at] = hi;
      reinterpret_cast<float*>(img + ps)[at] = tf32_rna(__fsub_rn(v, hi));
    }
  }
  fence_async();
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int rep = 0; rep < reps; ++rep) {
    wgmma_fence();
    if constexpr (ROUTE == 0) {
      // per 16 columns of K: the piece pairs (qa, qb) with qa + qb <= 2
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        auto prod = [&](int qa, int qb) {
          wgmma<128, 0, 0>(acc, sw128_desc(As + qa * AS + ks * 32),
                           sw128_desc(Bs + qb * BS + ks * 32));
        };
        prod(2, 0);
        prod(0, 2);
        prod(1, 1);
        prod(1, 0);
        prod(0, 1);
        prod(0, 0);
      }
    } else {
      // per 8 columns of K (32 bytes), in 32-column panels: lo hi, hi lo,
      // hi hi
#pragma unroll
      for (int ks = 0; ks < kK / 8; ++ks) {
        const int pa = (ks >> 2) * kM * 128, pb = (ks >> 2) * kN * 128;
        const int kb = (ks & 3) * 32;
        wgmma_tf32_n128(acc, sw128_desc(As + AS + pa + kb),
                        sw128_desc(Bs + pb + kb));
        wgmma_tf32_n128(acc, sw128_desc(As + pa + kb),
                        sw128_desc(Bs + BS + pb + kb));
        wgmma_tf32_n128(acc, sw128_desc(As + pa + kb),
                        sw128_desc(Bs + pb + kb));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  float* o = out + (size_t)blockIdx.x * kM * kN;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int r = warp * 16 + g + 8 * ((e >> 1) & 1);
    const int c = 8 * (e >> 2) + 2 * q + (e & 1);
    o[r * kN + c] = acc[e];
  }
}

template <int ROUTE>
int launch(const float* a, const float* b, float* out, int ctas, int reps,
           cudaStream_t s) {
  const int pieces = ROUTE == 0 ? 3 : 2, eb = ROUTE == 0 ? 2 : 4;
  const size_t smem = 1024 + (size_t)pieces * (kM + kN) * kK * eb;
  cudaError_t e = cudaFuncSetAttribute(
      route_ab<ROUTE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  route_ab<ROUTE><<<ctas, 128, smem, s>>>(a, b, out, reps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hosnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// route 0 bf16x3, 1 3xTF32; a [64, 64] and b [128, 64] f32 on the device;
// out [ctas, 64, 128] f32. Returns cudaGetLastError() after the launch.
int hosnerf_f32_route_ab(int route, const float* a, const float* b,
                         float* out, int ctas, int reps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas < 1 || reps < 1) return (int)cudaErrorInvalidValue;
  return route == 0 ? launch<0>(a, b, out, ctas, reps, s)
                    : launch<1>(a, b, out, ctas, reps, s);
}

}  // extern "C"
