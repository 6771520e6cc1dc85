// Grouped SwiGLU expert FFN  y = (silu(x Wg) * (x Wu)) Wd  for a batch of
// experts in the capacity layout.
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py::moe_ffn_kernel
// (_kernel).  x (E, C, D); Wg/Wu (E, D, F); Wd (E, F, D); y (E, C, D).
//
// Bound on an H100: at the main path's shape (E=128, C=16, D=2048, F=768,
// bf16) the call reads 1.21 GB of expert weights for 19 GFLOP, far below
// the card's ~295 FLOP/byte ridge, so it is memory-bound (~0.36 ms at
// 3.35 TB/s).  The design reads every weight byte exactly once per C-tile:
//   * one block per (expert, 16-row C-tile); the x tile is staged
//     transposed in shared memory ([D][16], 64 KB in bf16) and read back
//     with 16-byte vector loads that every thread of a warp shares;
//   * phase 1: threads run along F, so the reads of Wg/Wu (F contiguous)
//     coalesce; each thread keeps 16 gate and 16 up fp32 accumulators and
//     writes h = silu(g) * u, rounded to x's dtype as the reference does,
//     into shared memory ([F][16]);
//   * phase 2: threads run along D over Wd (D contiguous), 16 fp32
//     accumulators per output column.
// Rows past C in the last tile are zero in shared memory and never stored.
// wgmma/TMA pipelining is later work.
#include "common.cuh"

namespace {

constexpr int kRows = 16;      // rows of x per block (one C-tile)
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_ffn_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                   const T* __restrict__ wu, const T* __restrict__ wd,
                   T* __restrict__ y, int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // [D][kRows] transposed x tile
  T* hs = xs + static_cast<size_t>(D) * kRows;  // [F][kRows] rounded h

  const int e = blockIdx.x;
  const int c0 = blockIdx.y * kRows;
  const int rows = min(kRows, C - c0);
  const T* xe = x + (static_cast<size_t>(e) * C + c0) * D;

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int c = i / D, d = i - c * D;
    xs[d * kRows + c] =
        c < rows ? xe[static_cast<size_t>(c) * D + d] : Num<T>::from_f(0.f);
  }
  __syncthreads();

  const T* wge = wg + static_cast<size_t>(e) * D * F;
  const T* wue = wu + static_cast<size_t>(e) * D * F;
  for (int f = threadIdx.x; f < F; f += kThreads) {
    float g[kRows], u[kRows];
#pragma unroll
    for (int c = 0; c < kRows; ++c) g[c] = u[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a = Num<T>::to_f(wge[static_cast<size_t>(d) * F + f]);
      const float b = Num<T>::to_f(wue[static_cast<size_t>(d) * F + f]);
      float xv[kRows];
      load16<T>(xs + d * kRows, xv);
#pragma unroll
      for (int c = 0; c < kRows; ++c) {
        g[c] = fmaf(xv[c], a, g[c]);
        u[c] = fmaf(xv[c], b, u[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kRows; ++c) {
      const float s = g[c] / (1.f + expf(-g[c]));   // silu
      hs[f * kRows + c] = Num<T>::from_f(s * u[c]);
    }
  }
  __syncthreads();

  const T* wde = wd + static_cast<size_t>(e) * F * D;
  T* ye = y + (static_cast<size_t>(e) * C + c0) * D;
  for (int dd = threadIdx.x; dd < D; dd += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int c = 0; c < kRows; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      const float w = Num<T>::to_f(wde[static_cast<size_t>(f) * D + dd]);
      float hv[kRows];
      load16<T>(hs + f * kRows, hv);
#pragma unroll
      for (int c = 0; c < kRows; ++c) acc[c] = fmaf(hv[c], w, acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kRows; ++c)
      if (c < rows) ye[static_cast<size_t>(c) * D + dd] = Num<T>::from_f(acc[c]);
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* y, int E, int C, int D, int F, void* stream) {
  const size_t smem = static_cast<size_t>(D + F) * kRows * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      moe_ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(E, (C + kRows - 1) / kRows);
  moe_ffn_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<T*>(y), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int moe_ffn_f32(const void* x, const void* wg, const void* wu,
                           const void* wd, void* y, int E, int C, int D, int F,
                           void* stream) {
  return launch<float>(x, wg, wu, wd, y, E, C, D, F, stream);
}

extern "C" int moe_ffn_bf16(const void* x, const void* wg, const void* wu,
                            const void* wd, void* y, int E, int C, int D, int F,
                            void* stream) {
  return launch<__nv_bfloat16>(x, wg, wu, wd, y, E, C, D, F, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
