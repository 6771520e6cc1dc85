// The fp32 grouped SwiGLU expert FFN on the CUDA cores, shared by
// csrc/moe_ffn.cu (fp32 weights) and csrc/moe_ffn_quant.cu (int8 or
// packed int4 payload with fp32 block scales).
//
// fp32 must not go through TF32 (the port holds fp32 to 2e-5), so the
// arithmetic is fp32 FMA on the CUDA cores.  Two launches per call, as the
// bf16 design does:
//   * gate/up: h = silu(x Wg) * (x Wu) into an fp32 scratch (E, C, F) the
//     wrapper allocates (h stays fp32: the reference rounds h to x's type);
//   * down: y = h Wd.
// Each launch is one tiled product: one 256-thread block per (C-tile of BM
// rows, BN output columns, expert), the C-tile innermost in the grid so the
// blocks that share a weight slab run together and re-read it from L2.  The
// reduction runs in k-steps of kK rows: the activation tile (transposed)
// and the weight tile(s), the latter dequantized on load for a quantized
// weight, go through shared memory, and each thread keeps a kTM x kTN tile
// of each product in registers.  Nothing bounds D or F: every width is
// tiled, and the ragged edges are zero-filled on load and never stored.
// Each output element is summed by one thread in a fixed order (no
// atomics, no split-K), so zero rows of x give exactly zero rows of y.
//
// Bound on an H100 (fp32, DBRX's widths E=16, D=6144, F=10752): the call
// must read 12.68 GB of fp32 weights (3.79 ms at 3.35 TB/s); its 6 E C D F
// operations take 60.6 ms at a forward's C=640 at 67 TFLOP/s, so it is
// memory-bound at a serve's C and bound by the CUDA cores' rate at a
// forward's.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace f32ffn {

constexpr int kThreads = 256;
constexpr int kK = 16;              // reduction rows per k-step
constexpr int kTM = 4, kTN = 4;     // a thread's tile of each product

// An fp32 weight stack (E, K, N), row-major.
struct DenseW {
  const float* w;
  int K, N;
  __device__ DenseW of(int e) const {
    return {w + static_cast<size_t>(e) * K * N, K, N};
  }
  __device__ float at(int r, int n) const {
    return w[static_cast<size_t>(r) * N + n];
  }
};

__device__ __forceinline__ int nibble(unsigned v) {
  const int n = static_cast<int>(v & 0xFu);
  return n > 7 ? n - 16 : n;
}

// A quantized weight stack: payload (E, K, N) int8, or (E, ceil(K/2), N)
// with row 2i in the low and 2i+1 in the high nibble of byte row i; scales
// (E, ceil(K/qb), N) fp32.  A value is float(q) * its block's scale (the
// reference's _dequant_tile, then .astype(fp32): no rounding).
template <int BITS>
struct QuantW {
  const int8_t* q;
  const float* s;
  int K, N, qb;
  __device__ QuantW of(int e) const {
    const int rows = BITS == 4 ? (K + 1) / 2 : K;
    const int nb = (K + qb - 1) / qb;
    return {q + static_cast<size_t>(e) * rows * N,
            s + static_cast<size_t>(e) * nb * N, K, N, qb};
  }
  __device__ float at(int r, int n) const {
    int v;
    if constexpr (BITS == 8) {
      v = q[static_cast<size_t>(r) * N + n];
    } else {
      const unsigned b = static_cast<uint8_t>(q[static_cast<size_t>(r >> 1) *
                                                 N + n]);
      v = nibble(b >> ((r & 1) * 4));
    }
    return static_cast<float>(v) * s[static_cast<size_t>(r / qb) * N + n];
  }
};

// out[e, c, n) for a BM x BN tile: NW = 2 multiplies a (E, C, K) by two
// weights and writes silu(a W0) * (a W1); NW = 1 writes a W0.
template <int BM, int BN, int NW, class W>
__global__ void __launch_bounds__(kThreads)
    moe_f32_kernel(const float* __restrict__ a, W w0, W w1,
                   float* __restrict__ out, int C, int K, int N) {
  static_assert((BM / kTM) * (BN / kTN) == kThreads, "one tile a thread");
  constexpr int kPad = 4;           // keeps the transposed stores 2-way
  __shared__ __align__(16) float as[kK][BM + kPad];
  __shared__ __align__(16) float ws[NW][kK][BN];

  const int c0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const W wa = w0.of(e), wb = w1.of(e);
  const float* ae = a + static_cast<size_t>(e) * C * K;
  constexpr int kTX = BN / kTN;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;

  float acc[NW][kTM][kTN];
#pragma unroll
  for (int m = 0; m < NW; ++m)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[m][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kK) {
    // the activation tile, transposed: neighbouring threads read
    // neighbouring k of one row
    for (int i = threadIdx.x; i < BM * kK; i += kThreads) {
      const int r = i / kK, k = i - r * kK;
      const int c = c0 + r, kk = k0 + k;
      as[k][r] = c < C && kk < K ? ae[static_cast<size_t>(c) * K + kk] : 0.f;
    }
    // the weight tiles: neighbouring threads read neighbouring columns
    for (int i = threadIdx.x; i < kK * BN; i += kThreads) {
      const int k = i / BN, n = i - k * BN;
      const int kk = k0 + k, nn = n0 + n;
      const bool ok = kk < K && nn < N;
      ws[0][k][n] = ok ? wa.at(kk, nn) : 0.f;
      if constexpr (NW == 2) ws[NW - 1][k][n] = ok ? wb.at(kk, nn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][ty * kTM]);
      const float ar[kTM] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int m = 0; m < NW; ++m) {
        const float4 bv =
            *reinterpret_cast<const float4*>(&ws[m][k][tx * kTN]);
        const float br[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[m][i][j] = fmaf(ar[i], br[j], acc[m][i][j]);
      }
    }
    __syncthreads();
  }

  float* oe = out + static_cast<size_t>(e) * C * N;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int c = c0 + ty * kTM + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n >= N) continue;
      float v = acc[0][i][j];
      if constexpr (NW == 2) v = v / (1.f + expf(-v)) * acc[NW - 1][i][j];
      oe[static_cast<size_t>(c) * N + n] = v;
    }
  }
}

template <int BM, int BN, class W>
int launch_tiles(const float* x, W wg, W wu, W wd, float* h, float* y, int E,
                 int C, int D, int F, cudaStream_t s) {
  const unsigned ct = (C + BM - 1) / BM;
  moe_f32_kernel<BM, BN, 2, W>
      <<<dim3(ct, (F + BN - 1) / BN, E), kThreads, 0, s>>>(x, wg, wu, h, C, D,
                                                           F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_f32_kernel<BM, BN, 1, W>
      <<<dim3(ct, (D + BN - 1) / BN, E), kThreads, 0, s>>>(h, wd, wd, y, C, F,
                                                           D);
  return static_cast<int>(cudaGetLastError());
}

// The C-tile: 16 rows (and 256 columns a block) where C is small, so a
// serve's few tokens waste no rows; 64 x 64 tiles above.
template <class W>
int launch(const float* x, W wg, W wu, W wd, float* h, float* y, int E,
           int C, int D, int F, cudaStream_t s) {
  if (E <= 0 || C <= 0) return 0;
  if (C <= 32)
    return launch_tiles<16, 256>(x, wg, wu, wd, h, y, E, C, D, F, s);
  return launch_tiles<64, 64>(x, wg, wu, wd, h, y, E, C, D, F, s);
}

}  // namespace f32ffn
