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
// (about 0.19 ms int8, 0.10 ms int4 at 3.35 TB/s): only the compressed
// bytes may cross HBM, and the dequantize must hide under their stream.
// Two designs, one per type:
//
// bf16, on the tensor cores (moe_ffn_quant_bf16, tc::): csrc/moe_ffn.cu's
//   design with the weights streamed compressed.  Two launches per call:
//   gate/up, one warpgroup per (C-tile, 64 columns of F, expert), and
//   down, one per (C-tile, 128 columns of D, expert), the C-tile (16, 32,
//   64, 128 or 160 tokens) innermost in the grid so blocks of one expert
//   share its slabs through L2.  Swap-AB: the 64 x 64 weight slab is the
//   M side of wgmma m64nNk16 and the tokens are N, so C=16 wastes no rows.
//   Per 64-row k-step, cp.async copies the two slabs' payload (4 KB int8,
//   2 KB int4 each), their fp32 scale rows and the x (or h) tile into a
//   ring of 4 stages (3 at N >= 128) guarded by mbarriers.  The weights
//   never reach shared memory as bf16: each thread dequantizes its own
//   part of wgmma's register A operand straight from the payload bytes,
//   each value bf16(float(q) * s) with the scale of its own row's block
//   (so any even qb works), and the warpgroup multiplies it by the x tile
//   (read from shared memory), with no barrier inside the k loop.  What
//   bounds it is that per-value dequantize (byte_perm to fp32, scale,
//   round), not HBM: int4 carries int8's work on half the bytes.  h =
//   silu(g) * u goes to a bf16 scratch (E, C, F) between the launches.
//   Products of two bf16 values are exact in fp32, so the result differs
//   from the CUDA-core kernel only in summation order.  D must be a
//   multiple of 128 and F of 64 (the wrapper checks).  Rows past C are
//   zero-filled on load and never stored, so zero rows of x give exactly
//   zero rows of y.
//
// fp32, on the CUDA cores (moe_ffn_quant_f32): fp32 must not go through
//   TF32 (the port holds it to 2e-5), so it is csrc/moe_f32.cuh's tiled
//   fp32 FMA product in two launches (gate/up into an fp32 h scratch, then
//   down), each weight tile dequantized as it is loaded into shared memory
//   (coalesced payload rows, one fp32 scale per block and column), with no
//   bound on D or F.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "moe_f32.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

namespace tc {

using namespace hopper;

constexpr int kThreads = 128;          // one warpgroup
constexpr int kTile = 64;              // output rows (F or D) and K depth

// Payload bytes of one slab's k-step: 64 rows of 64 int8, or 32 byte rows
// of 64 packed int4.
template <int BITS>
__host__ __device__ constexpr uint32_t raw_bytes() {
  return (BITS == 8 ? kTile : kTile / 2) * kTile;
}

// One ring stage: the N-row activation tile (1024-aligned, first), two
// slabs' payload, then their ``srows`` scale rows of 64 fp32 each.
template <int BITS>
__host__ __device__ constexpr uint32_t stage_bytes(int n, int srows) {
  return (static_cast<uint32_t>(n) * 128 + 2 * raw_bytes<BITS>() +
          2u * srows * kTile * 4 + 1023) & ~1023u;
}

// Shared memory of a block: the ring, its mbarriers, and room to align to
// 1024 bytes.
template <int BITS>
size_t smem_bytes(int n, int srows, int stages) {
  return 1024 + static_cast<size_t>(stages) * stage_bytes<BITS>(n, srows) +
         8 * stages;
}

// Scale rows a 64-row k-step of a K-deep weight can touch: the most
// distinct blocks floor(k / qb) over any step's rows.
int scale_rows(int K, int qb) {
  int most = 1;
  for (int k0 = 0; k0 < K; k0 += kTile)
    most = std::max(most, (std::min(k0 + kTile, K) - 1) / qb - k0 / qb + 1);
  return most;
}

// Byte offset of payload byte (row, col) in a stage's slab: 16-byte chunk
// j of row r sits at chunk j ^ ((r / 2) % 4), so the fragment reads below
// (four rows 2 apart, one chunk each) hit distinct banks.
__device__ __forceinline__ uint32_t raw_off(int row, int col) {
  return row * 64 + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// acc^T (64 x N) += W^T (64 x K) * A^T (K x N) for both weights of ``w``
// (payload (K[/2], ldw) row-major, int8 or packed int4, with scales
// (ceil(K / qb), ldw) fp32, each already offset to the block's 64
// columns); the activation rows ``a`` (rows x K bf16, row-major, rows past
// ``rows`` read as zero) stream beside the payload.  The weights never
// reach shared memory as bf16: each thread dequantizes its own part of
// wgmma's register A operand.  Row m of the 64-row tile holds slab column
// col(m) = 16 (m / 16) + 2 (m % 8) + (m % 16) / 8, so a thread's two rows
// are adjacent columns, read as one 16-bit load per K row.
template <int N, int BITS, int STAGES>
struct QuantMainloop {
  uint8_t* base;         // generic pointer to the 1024-aligned ring
  uint32_t ring, bars, stage;
  int srows, qb;

  __device__ void init(uint8_t* smem, int srows_, int qb_) {
    const uint32_t raw = smem_u32(smem);
    const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
    base = smem + pad;
    ring = raw + pad;
    srows = srows_;
    qb = qb_;
    stage = stage_bytes<BITS>(N, srows);
    bars = ring + STAGES * stage;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, kThreads);
      mbar_fence_init();
    }
    __syncthreads();
  }

  // Step k (rows k0 = 64 k .. k0 + 63 of K) into ring slot ``slot``.
  __device__ void load(const int8_t* const (&w)[2],
                       const float* const (&sc)[2], int ldw, const bf16* a,
                       int rows, int lda, int k, int slot) {
    const uint32_t st = ring + slot * stage;
    const int k0 = k * kTile;
    for (int i = threadIdx.x; i < N * 8; i += kThreads) {
      const int r = i >> 3, j = i & 7;
      const bool ok = r < rows;
      cp_async16(st + swizzle128(r, j),
                 ok ? a + static_cast<size_t>(r) * lda + k0 + j * 8 : a, ok);
    }
    constexpr int kRawRows = BITS == 8 ? kTile : kTile / 2;
    const int r0 = BITS == 8 ? k0 : k0 / 2;
    const uint32_t raw = st + N * 128;
    for (int i = threadIdx.x; i < kRawRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const size_t off = static_cast<size_t>(r0 + r) * ldw + j * 16;
#pragma unroll
      for (int s = 0; s < 2; ++s)
        cp_async16(raw + s * raw_bytes<BITS>() + raw_off(r, j * 16),
                   w[s] + off, true);
    }
    const int b0 = k0 / qb;
    const int nrows = (k0 + kTile - 1) / qb - b0 + 1;   // <= srows
    const uint32_t scl = raw + 2 * raw_bytes<BITS>();
    for (int i = threadIdx.x; i < nrows * 16; i += kThreads) {
      const int r = i >> 4, j = i & 15;
      const size_t off = static_cast<size_t>(b0 + r) * ldw + j * 4;
#pragma unroll
      for (int s = 0; s < 2; ++s)
        cp_async16(scl + (s * srows + r) * kTile * 4 + j * 16, sc[s] + off,
                   true);
    }
    mbar_arrive_cp_async(bars + 8 * slot);
  }

  // This thread's A fragments of step k from slot ``slot``: value
  // bf16(float(q) * s), s the scale of the value's own row's block; when
  // every row of a step shares one block (qb a multiple of 64) the two
  // scales are read once a step.
  __device__ void fragments(int k, int slot, uint32_t (&a)[4][2][4]) {
    const uint8_t* raw = base + slot * stage + N * 128;
    const float* scl =
        reinterpret_cast<const float*>(raw + 2 * raw_bytes<BITS>());
    const int t = threadIdx.x, c = t & 3;
    const int col = 16 * (t >> 5) + 2 * ((t & 31) >> 2);  // and col + 1
    const int k0 = k * kTile, b0 = k0 / qb;
    const bool one_block = qb % kTile == 0;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint8_t* slab = raw + s * raw_bytes<BITS>();
      float2 sv;
      auto scales = [&](int srow) {
        sv = *reinterpret_cast<const float2*>(
            scl + (s * srows + srow) * kTile + col);
      };
      if (one_block) scales(0);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kr = 16 * kk + 2 * c + 8 * half;   // K rows kr, kr + 1
          // an even qb never puts a block edge between kr and kr + 1
          if (!one_block) scales((k0 + kr) / qb - b0);
          // bytes: (kr, col), (kr, col + 1), (kr + 1, col), (kr + 1, col + 1)
          uint32_t word;
          if constexpr (BITS == 8) {
            const uint32_t u0 =
                *reinterpret_cast<const uint16_t*>(slab + raw_off(kr, col));
            const uint32_t u1 = *reinterpret_cast<const uint16_t*>(
                slab + raw_off(kr + 1, col));
            word = __byte_perm(u0, u1, 0x5410) ^ 0x80808080u;
          } else {   // packed row kr / 2: kr in the low nibbles, kr + 1 high
            const uint32_t u = *reinterpret_cast<const uint16_t*>(
                slab + raw_off(kr / 2, col));
            word = ((u & 0x0F0Fu) | ((u << 12) & 0x0F0F0000u)) ^ 0x08080808u;
          }
          auto val = [&](int n) {
            return BITS == 8 ? s8_to_f32(word, n) : s4_to_f32(word, n);
          };
          a[kk][s][2 * half] = pack_bf16(val(0) * sv.x, val(2) * sv.x);
          a[kk][s][2 * half + 1] = pack_bf16(val(1) * sv.y, val(3) * sv.y);
        }
    }
  }

  __device__ void run(const int8_t* const (&w)[2], const float* const (&sc)[2],
                      int ldw, const bf16* a, int rows, int lda, int ksteps,
                      float (&acc)[2][N / 2]) {
    for (int k = 0; k < STAGES && k < ksteps; ++k)
      load(w, sc, ldw, a, rows, lda, k, k);
    uint32_t frag[4][2][4];
    for (int k = 0; k < ksteps; ++k) {
      const int slot = k % STAGES;
      mbar_wait(bars + 8 * slot, (k / STAGES) & 1);
      fence_proxy_async();   // the x tile, written by cp.async, for wgmma
      fragments(k, slot, frag);
      const uint32_t xt = ring + slot * stage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint64_t db = desc_sw128(xt + kk * 32, 16, 1024);
#pragma unroll
        for (int s = 0; s < 2; ++s)
          WgmmaRS<N, 0>::run(acc[s], frag[kk][s], db, k > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < 2; ++s) fence_regs(acc[s]);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
        for (int s = 0; s < 2; ++s) fence_regs(frag[kk][s]);
      // every thread is past its own reads of the slot: it takes step
      // k + STAGES once all have arrived (the mbarrier counts them)
      if (k + STAGES < ksteps)
        load(w, sc, ldw, a, rows, lda, k + STAGES, slot);
    }
  }
};

// Blocks an SM must hold: four at int8's small C-tiles (128 registers, no
// spills; 6 % faster on an H100 than the three its 130 registers allowed).
// int4 runs about 3 % slower under any explicit bound than under none, but
// int8 carries the quantized serve.
template <int N, int BITS>
constexpr int kMinBlocks = BITS == 8 && N <= 32 ? 4 : 1;

// Accumulator value i of this thread: its slab column (see QuantMainloop)
// and its token.
__device__ __forceinline__ int quant_acc_col(int i) {
  const int t = threadIdx.x;
  return 16 * (t >> 5) + 2 * ((t & 31) >> 2) + ((i >> 1) & 1);
}

// h[e, c, f0 + 64) = bf16(silu(x Wg) * (x Wu)) for one C-tile.
template <int N, int BITS, int STAGES>
__global__ void __launch_bounds__(kThreads, kMinBlocks<N, BITS>)
    moe_quant_gate_up_kernel(const bf16* __restrict__ x,
                             const int8_t* __restrict__ wg,
                             const float* __restrict__ wgs,
                             const int8_t* __restrict__ wu,
                             const float* __restrict__ wus,
                             bf16* __restrict__ h, int C, int D, int F,
                             int qb, int srows) {
  extern __shared__ uint8_t smem[];
  const int c0 = blockIdx.x * N, f0 = blockIdx.y * kTile, e = blockIdx.z;
  QuantMainloop<N, BITS, STAGES> ml;
  ml.init(smem, srows, qb);
  const size_t we =
      static_cast<size_t>(e) * (BITS == 8 ? D : D / 2) * F + f0;
  const size_t se = static_cast<size_t>(e) * ((D + qb - 1) / qb) * F + f0;
  const int8_t* const w[2] = {wg + we, wu + we};
  const float* const sc[2] = {wgs + se, wus + se};
  float acc[2][N / 2];
  ml.run(w, sc, F, x + (static_cast<size_t>(e) * C + c0) * D, C - c0, D,
         D / kTile, acc);
  bf16* he = h + static_cast<size_t>(e) * C * F + f0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int c = c0 + wgmma_acc_col(i);
    if (c < C) {
      const float g = acc[0][i];
      he[static_cast<size_t>(c) * F + quant_acc_col(i)] =
          __float2bfloat16(g / (1.f + expf(-g)) * acc[1][i]);
    }
  }
}

// y[e, c, d0 + 128) = bf16(h Wd) for one C-tile: two 64-column slabs of
// Wd share each h tile.
template <int N, int BITS, int STAGES>
__global__ void __launch_bounds__(kThreads, kMinBlocks<N, BITS>)
    moe_quant_down_kernel(const bf16* __restrict__ h,
                          const int8_t* __restrict__ wd,
                          const float* __restrict__ wds,
                          bf16* __restrict__ y, int C, int D, int F, int qb,
                          int srows) {
  extern __shared__ uint8_t smem[];
  const int c0 = blockIdx.x * N, d0 = blockIdx.y * 2 * kTile, e = blockIdx.z;
  QuantMainloop<N, BITS, STAGES> ml;
  ml.init(smem, srows, qb);
  const int8_t* wde =
      wd + static_cast<size_t>(e) * (BITS == 8 ? F : F / 2) * D + d0;
  const float* sde = wds + static_cast<size_t>(e) * ((F + qb - 1) / qb) * D + d0;
  const int8_t* const w[2] = {wde, wde + kTile};
  const float* const sc[2] = {sde, sde + kTile};
  float acc[2][N / 2];
  ml.run(w, sc, D, h + (static_cast<size_t>(e) * C + c0) * F, C - c0, F,
         F / kTile, acc);
  bf16* ye = y + static_cast<size_t>(e) * C * D + d0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int c = c0 + wgmma_acc_col(i);
    if (c < C) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
        ye[static_cast<size_t>(c) * D + s * kTile + quant_acc_col(i)] =
            __float2bfloat16(acc[s][i]);
    }
  }
}

struct Args {
  const bf16* x;
  const int8_t *wg, *wu, *wd;
  const float *wgs, *wus, *wds;
  bf16 *h, *y;
  int E, C, D, F, qb;
};

template <int N, int BITS>
int launch_n(const Args& a, cudaStream_t s) {
  constexpr int kStages = N >= 128 ? 3 : 4;
  const int sr_up = scale_rows(a.D, a.qb), sr_down = scale_rows(a.F, a.qb);
  const size_t smem_up = smem_bytes<BITS>(N, sr_up, kStages);
  const size_t smem_down = smem_bytes<BITS>(N, sr_down, kStages);
  cudaError_t err = cudaFuncSetAttribute(
      moe_quant_gate_up_kernel<N, BITS, kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_up));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(moe_quant_down_kernel<N, BITS, kStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_down));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned ctiles = (a.C + N - 1) / N;
  moe_quant_gate_up_kernel<N, BITS, kStages>
      <<<dim3(ctiles, a.F / kTile, a.E), kThreads, smem_up, s>>>(
          a.x, a.wg, a.wgs, a.wu, a.wus, a.h, a.C, a.D, a.F, a.qb, sr_up);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_quant_down_kernel<N, BITS, kStages>
      <<<dim3(ctiles, a.D / (2 * kTile), a.E), kThreads, smem_down, s>>>(
          a.h, a.wd, a.wds, a.y, a.C, a.D, a.F, a.qb, sr_down);
  return static_cast<int>(cudaGetLastError());
}

// The C-tile as in moe_ffn.cu: the smallest of 16, 32, 64, 128 tokens
// that holds C; past 128, tiles of 160 where they pad less.
template <int BITS>
int launch(const Args& a, cudaStream_t s) {
  const int C = a.C;
  if (C <= 16) return launch_n<16, BITS>(a, s);
  if (C <= 32) return launch_n<32, BITS>(a, s);
  if (C <= 64) return launch_n<64, BITS>(a, s);
  if (C <= 128 || (C + 127) / 128 * 128 < (C + 159) / 160 * 160)
    return launch_n<128, BITS>(a, s);
  return launch_n<160, BITS>(a, s);
}

}  // namespace tc

}  // namespace

extern "C" int moe_ffn_quant_f32(const void* x, const void* wg,
                                 const void* wgs, const void* wu,
                                 const void* wus, const void* wd,
                                 const void* wds, void* h, void* y, int E,
                                 int C, int D, int F, int bits, int qb,
                                 void* stream) {
  // int4 rows pair up within a block only when the block is even
  if (qb < 2 || qb % 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* hf = static_cast<float*>(h);
  float* yf = static_cast<float*>(y);
  const auto q = [](const void* p) { return static_cast<const int8_t*>(p); };
  const auto sc = [](const void* p) { return static_cast<const float*>(p); };
  if (bits == 8) {
    using W = f32ffn::QuantW<8>;
    return f32ffn::launch(xf, W{q(wg), sc(wgs), D, F, qb},
                          W{q(wu), sc(wus), D, F, qb},
                          W{q(wd), sc(wds), F, D, qb}, hf, yf, E, C, D, F, s);
  }
  if (bits == 4) {
    using W = f32ffn::QuantW<4>;
    return f32ffn::launch(xf, W{q(wg), sc(wgs), D, F, qb},
                          W{q(wu), sc(wus), D, F, qb},
                          W{q(wd), sc(wds), F, D, qb}, hf, yf, E, C, D, F, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int moe_ffn_quant_bf16(const void* x, const void* wg,
                                  const void* wgs, const void* wu,
                                  const void* wus, const void* wd,
                                  const void* wds, void* h, void* y, int E,
                                  int C, int D, int F, int bits, int qb,
                                  void* stream) {
  if (qb < 2 || qb % 2 || D % (2 * tc::kTile) || F % tc::kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Args a{static_cast<const bf16*>(x),
                   static_cast<const int8_t*>(wg),
                   static_cast<const int8_t*>(wu),
                   static_cast<const int8_t*>(wd),
                   static_cast<const float*>(wgs),
                   static_cast<const float*>(wus),
                   static_cast<const float*>(wds),
                   static_cast<bf16*>(h),
                   static_cast<bf16*>(y),
                   E, C, D, F, qb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8) return tc::launch<8>(a, s);
  if (bits == 4) return tc::launch<4>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
