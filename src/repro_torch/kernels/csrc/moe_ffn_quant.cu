// Grouped SwiGLU expert FFN  y = (silu(x Wg) * (x Wu)) Wd  over blockwise
// quantized expert weights (int8, or int4 packed two to a byte).
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py::moe_ffn_kernel_quant
// (_kernel_q, _dequant_tile).  x (E, C, D) fp32 or bf16; Wg/Wu payload
// (E, D, F) int8 or (E, ceil(D/2), F) packed int4 with scales
// (E, ceil(D/qb), F) fp32; Wd payload (E, F, D) or (E, ceil(F/2), D) with
// scales (E, ceil(F/qb), D); y (E, C, D).  Int4 row 2i sits in the low
// nibble and row 2i+1 in the high nibble of byte row i, sign-extended.
//
// Rounding follows the reference: each weight value becomes
// T(float(q) * scale) (the reference's _dequant_tile then .astype(x.dtype))
// before the fp32 product, and h is rounded to T before the down-projection.
// Rows of an F or D that is not a multiple of qb are simply not visited:
// the reference pads them with zero payload and zero scales, which adds
// exact zeros.
//
// Bound on an H100: at the main path's shape (E=128, C=16, D=2048, F=768)
// the call reads 0.60 GB of int8 payload (0.30 GB int4) plus 19 MB of
// scales for 19 GFLOP, far below the card's ridge, so it is memory-bound
// (about 0.19 ms int8, 0.10 ms int4 at 3.35 TB/s).  The design is
// csrc/moe_ffn.cu's, reading the payload as bytes:
//   * one block per (expert, 16-row C-tile), the x tile transposed in
//     shared memory ([D][16]) and h in shared memory in T ([F][16]);
//   * phase 1: threads run along F (coalesced payload rows), loop over D
//     one quantization block at a time, reading one fp32 scale per block
//     and column; for int4 one byte feeds two consecutive rows of D;
//   * phase 2: threads run along D over Wd, the same way along F.
// wgmma/TMA pipelining is later work.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRows = 16;      // rows of x per block (one C-tile)
constexpr int kThreads = 256;

__device__ __forceinline__ int nibble(unsigned v) {
  const int n = static_cast<int>(v & 0xFu);
  return n > 7 ? n - 16 : n;
}

// Payload value of logical row `r`, column `col` of a (rows, n) matrix.
template <int kBits>
__device__ __forceinline__ int payload(const int8_t* __restrict__ w, int r,
                                       int col, int n) {
  if constexpr (kBits == 8) {
    return w[static_cast<size_t>(r) * n + col];
  } else {
    const unsigned b =
        static_cast<uint8_t>(w[static_cast<size_t>(r >> 1) * n + col]);
    return nibble(b >> ((r & 1) * 4));
  }
}

template <typename T>
__device__ __forceinline__ float dequant(int q, float s) {
  return round_to<T>(static_cast<float>(q) * s);
}

template <typename T, int kBits>
__global__ void __launch_bounds__(kThreads)
    moe_ffn_quant_kernel(const T* __restrict__ x,
                         const int8_t* __restrict__ wg,
                         const float* __restrict__ wgs,
                         const int8_t* __restrict__ wu,
                         const float* __restrict__ wus,
                         const int8_t* __restrict__ wd,
                         const float* __restrict__ wds, T* __restrict__ y,
                         int C, int D, int F, int qb) {
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

  const int rows_d = kBits == 4 ? (D + 1) / 2 : D;   // payload rows of Wg
  const int rows_f = kBits == 4 ? (F + 1) / 2 : F;   // payload rows of Wd
  const int nb_d = (D + qb - 1) / qb, nb_f = (F + qb - 1) / qb;
  const int8_t* wge = wg + static_cast<size_t>(e) * rows_d * F;
  const int8_t* wue = wu + static_cast<size_t>(e) * rows_d * F;
  const float* wgse = wgs + static_cast<size_t>(e) * nb_d * F;
  const float* wuse = wus + static_cast<size_t>(e) * nb_d * F;
  for (int f = threadIdx.x; f < F; f += kThreads) {
    float g[kRows], u[kRows];
#pragma unroll
    for (int c = 0; c < kRows; ++c) g[c] = u[c] = 0.f;
    for (int kb = 0; kb < nb_d; ++kb) {
      const float sg = wgse[static_cast<size_t>(kb) * F + f];
      const float su = wuse[static_cast<size_t>(kb) * F + f];
      const int d_end = min(D, (kb + 1) * qb);
#pragma unroll 4
      for (int d = kb * qb; d < d_end; ++d) {
        const float a = dequant<T>(payload<kBits>(wge, d, f, F), sg);
        const float b = dequant<T>(payload<kBits>(wue, d, f, F), su);
        float xv[kRows];
        load16<T>(xs + d * kRows, xv);
#pragma unroll
        for (int c = 0; c < kRows; ++c) {
          g[c] = fmaf(xv[c], a, g[c]);
          u[c] = fmaf(xv[c], b, u[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kRows; ++c) {
      const float s = g[c] / (1.f + expf(-g[c]));   // silu
      hs[f * kRows + c] = Num<T>::from_f(s * u[c]);
    }
  }
  __syncthreads();

  const int8_t* wde = wd + static_cast<size_t>(e) * rows_f * D;
  const float* wdse = wds + static_cast<size_t>(e) * nb_f * D;
  T* ye = y + (static_cast<size_t>(e) * C + c0) * D;
  for (int dd = threadIdx.x; dd < D; dd += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int c = 0; c < kRows; ++c) acc[c] = 0.f;
    for (int kb = 0; kb < nb_f; ++kb) {
      const float s = wdse[static_cast<size_t>(kb) * D + dd];
      const int f_end = min(F, (kb + 1) * qb);
#pragma unroll 4
      for (int f = kb * qb; f < f_end; ++f) {
        const float w = dequant<T>(payload<kBits>(wde, f, dd, D), s);
        float hv[kRows];
        load16<T>(hs + f * kRows, hv);
#pragma unroll
        for (int c = 0; c < kRows; ++c) acc[c] = fmaf(hv[c], w, acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kRows; ++c)
      if (c < rows) ye[static_cast<size_t>(c) * D + dd] = Num<T>::from_f(acc[c]);
  }
}

template <typename T, int kBits>
int launch(const void* x, const void* wg, const void* wgs, const void* wu,
           const void* wus, const void* wd, const void* wds, void* y, int E,
           int C, int D, int F, int qb, void* stream) {
  const size_t smem = static_cast<size_t>(D + F) * kRows * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      moe_ffn_quant_kernel<T, kBits>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(E, (C + kRows - 1) / kRows);
  moe_ffn_quant_kernel<T, kBits>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(wg),
          static_cast<const float*>(wgs), static_cast<const int8_t*>(wu),
          static_cast<const float*>(wus), static_cast<const int8_t*>(wd),
          static_cast<const float*>(wds), static_cast<T*>(y), C, D, F, qb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* wg, const void* wgs, const void* wu,
             const void* wus, const void* wd, const void* wds, void* y, int E,
             int C, int D, int F, int bits, int qb, void* stream) {
  // int4 rows pair up within a block only when the block is even
  if (qb < 2 || qb % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 8)
    return launch<T, 8>(x, wg, wgs, wu, wus, wd, wds, y, E, C, D, F, qb,
                        stream);
  if (bits == 4)
    return launch<T, 4>(x, wg, wgs, wu, wus, wd, wds, y, E, C, D, F, qb,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define MOE_FFN_QUANT_ENTRY(NAME, TYPE)                                       \
  extern "C" int NAME(const void* x, const void* wg, const void* wgs,        \
                      const void* wu, const void* wus, const void* wd,       \
                      const void* wds, void* y, int E, int C, int D, int F,  \
                      int bits, int qb, void* stream) {                      \
    return dispatch<TYPE>(x, wg, wgs, wu, wus, wd, wds, y, E, C, D, F, bits, \
                          qb, stream);                                       \
  }

MOE_FFN_QUANT_ENTRY(moe_ffn_quant_f32, float)
MOE_FFN_QUANT_ENTRY(moe_ffn_quant_bf16, __nv_bfloat16)
