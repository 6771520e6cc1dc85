// Grouped SwiGLU expert FFN  y = (silu(x Wg) * (x Wu)) Wd  for a batch of
// experts in the capacity layout.
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py::moe_ffn_kernel
// (_kernel).  x (E, C, D); Wg/Wu (E, D, F); Wd (E, F, D); y (E, C, D).
// Rounding follows the reference: fp32 accumulation, h = silu(g) * u
// rounded to x's type before the down-projection, y rounded once.
//
// Bound on an H100 (bf16, E=128, D=2048, F=768): the call must read
// 1.21 GB of expert weights, 0.36 ms at 3.35 TB/s; its 6 E C D F
// operations take 0.02 ms at C=16 and 0.39 ms at C=320 on the tensor
// cores, so it is memory-bound at the serve's capacities and near the
// card's ridge at the forward's (C=320).  Two designs, one per type:
//
// bf16, on the tensor cores (moe_ffn_bf16): two launches per call,
//   * gate/up: one 128-thread block (one warpgroup) per (C-tile, 64
//     columns of F, expert), the C-tile innermost in the grid so the
//     blocks that share an expert's weight slab run together and re-read
//     it from L2, not HBM.  Swap-AB: the block computes G^T = Wg^T x^T and
//     U^T = Wu^T x^T with wgmma m64nNk16, the 64 x 64 weight slab as the
//     M-side operand (MN-major, straight from Wg's rows) and the C-tile as
//     N (16, 32, 64, 128 or 160 tokens: the smallest that holds C, or the
//     one that pads less above 128), so 16 tokens do not waste a 64-row
//     M.  Weight slabs and x tiles come through a ring of 3-4 stages of
//     128-byte-swizzled shared memory fed by 16-byte cp.async copies and
//     guarded by mbarriers, so two or three stages stream in while one is
//     multiplied, and one step's wgmma group stays in flight while the
//     next is issued.  h = silu(g) * u is rounded to bf16 and written to a
//     scratch h (E, C, F) the wrapper allocates;
//   * down: the same over Wd and h, one block per (C-tile, 128 columns of
//     D, expert): two 64-column slabs share each h tile.
//   At the forward's C=320 the blocks re-read x, h and the slabs from L2
//   (about 5 GB a call), and that traffic, not HBM or the tensor cores,
//   sets the pace; the 160-token tiles and the paired down slabs halve
//   it against 128-token tiles and single slabs.
//   Each output element is summed by one block in a fixed order (no
//   atomics, no split-K).  Rows past C are zero-filled on load and never
//   stored, so zero rows of x give exactly zero rows of y.  F must be a
//   multiple of 64 and D of 128 (the wrapper checks).
//
// fp32, on the CUDA cores (moe_ffn_f32): fp32 must not go through TF32
// (the port holds it to 2e-5), so it keeps the first design: one block
// per (expert, 16-row C-tile), x transposed and h in shared memory, fp32
// FMA with threads along F (phase 1, Wg/Wu) and along D (phase 2, Wd).
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

namespace tc {

using namespace hopper;

constexpr int kThreads = 128;          // one warpgroup
constexpr int kTile = 64;              // output rows (F or D) and K depth
constexpr uint32_t kSlab = kTile * kTile * 2;   // a 64 x 64 bf16 slab

// Shared memory of a block with ``slabs`` weight slabs and an N-row
// activation tile per stage: the ring, its mbarriers, and room to align
// the ring to 1024 bytes.
constexpr size_t smem_bytes(int slabs, int n, int stages) {
  return 1024 + static_cast<size_t>(stages) * (slabs * kSlab + n * 128) +
         8 * stages;
}

// One block of   acc^T (64 x N) = W^T (64 x K) * A^T (K x N)   for each
// weight of ``w`` (SLABS of them, each (K, ldw) row-major, the block's 64
// columns starting at w[s]): the activation rows a (rows x K, row-major,
// rows past ``rows`` read as zero) stream beside the slabs.
template <int N, int SLABS, int STAGES>
struct Mainloop {
  static constexpr uint32_t kStage = SLABS * kSlab + N * 128;

  uint32_t ring, bars;

  __device__ void init(uint8_t* smem) {
    ring = (smem_u32(smem) + 1023) & ~1023u;
    bars = ring + STAGES * kStage;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, kThreads);
      mbar_fence_init();
    }
    __syncthreads();
  }

  // Stage k of the K loop into ring slot ``slot``: SLABS slabs of 64 rows
  // (k) by 64 columns, and N activation rows by 64 values of k.
  __device__ void load(const bf16* const (&w)[SLABS], int ldw, const bf16* a,
                       int rows, int lda, int k, int slot) {
    const uint32_t st = ring + slot * kStage;
    const int k0 = k * kTile;
    for (int i = threadIdx.x; i < kTile * 8; i += kThreads) {
      const int r = i >> 3, j = i & 7;
      const size_t off = static_cast<size_t>(k0 + r) * ldw + j * 8;
#pragma unroll
      for (int s = 0; s < SLABS; ++s)
        cp_async16(st + s * kSlab + swizzle128(r, j), w[s] + off, true);
    }
    for (int i = threadIdx.x; i < N * 8; i += kThreads) {
      const int r = i >> 3, j = i & 7;
      const bool ok = r < rows;
      cp_async16(st + SLABS * kSlab + swizzle128(r, j),
                 ok ? a + static_cast<size_t>(r) * lda + k0 + j * 8 : a, ok);
    }
    mbar_arrive_cp_async(bars + 8 * slot);
  }

  __device__ void run(const bf16* const (&w)[SLABS], int ldw, const bf16* a,
                      int rows, int lda, int ksteps,
                      float (&acc)[SLABS][N / 2]) {
    for (int k = 0; k < STAGES - 1 && k < ksteps; ++k)
      load(w, ldw, a, rows, lda, k, k);
    for (int k = 0; k < ksteps; ++k) {
      const int slot = k % STAGES;
      mbar_wait(bars + 8 * slot, (k / STAGES) & 1);
      fence_proxy_async();
      const uint32_t st = ring + slot * kStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint64_t db =
            desc_sw128(st + SLABS * kSlab + kk * 32, 16, 1024);
#pragma unroll
        for (int s = 0; s < SLABS; ++s)
          WgmmaSS<N, 1, 0>::run(
              acc[s], desc_sw128(st + s * kSlab + kk * 2048, kSlab, 1024), db,
              k > 0 || kk > 0);
      }
      wgmma_commit();
      // step k - 1's products are done: its slot takes step k + STAGES - 1
      wgmma_wait<1>();
      if (k + STAGES - 1 < ksteps)
        load(w, ldw, a, rows, lda, k + STAGES - 1, (k + STAGES - 1) % STAGES);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < SLABS; ++s) fence_regs(acc[s]);
  }
};

// h[e, c, f0 + 64) = bf16(silu(x Wg) * (x Wu)) for one C-tile.
template <int N, int STAGES>
__global__ void __launch_bounds__(kThreads)
    moe_gate_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                       const bf16* __restrict__ wu, bf16* __restrict__ h,
                       int C, int D, int F) {
  extern __shared__ uint8_t smem[];
  const int c0 = blockIdx.x * N, f0 = blockIdx.y * kTile, e = blockIdx.z;
  Mainloop<N, 2, STAGES> ml;
  ml.init(smem);
  const size_t we = static_cast<size_t>(e) * D * F + f0;
  const bf16* const w[2] = {wg + we, wu + we};
  float acc[2][N / 2];
  ml.run(w, F, x + (static_cast<size_t>(e) * C + c0) * D, C - c0, D,
         D / kTile, acc);
  bf16* he = h + static_cast<size_t>(e) * C * F + f0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int c = c0 + wgmma_acc_col(i);
    if (c < C) {
      const float g = acc[0][i];
      he[static_cast<size_t>(c) * F + wgmma_acc_row(i)] =
          __float2bfloat16(g / (1.f + expf(-g)) * acc[1][i]);
    }
  }
}

// y[e, c, d0 + 128) = bf16(h Wd) for one C-tile: two 64-column slabs of
// Wd share each h tile.
template <int N, int STAGES>
__global__ void __launch_bounds__(kThreads)
    moe_down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ wd,
                    bf16* __restrict__ y, int C, int D, int F) {
  extern __shared__ uint8_t smem[];
  const int c0 = blockIdx.x * N, d0 = blockIdx.y * 2 * kTile, e = blockIdx.z;
  Mainloop<N, 2, STAGES> ml;
  ml.init(smem);
  const bf16* wde = wd + static_cast<size_t>(e) * F * D + d0;
  const bf16* const w[2] = {wde, wde + kTile};
  float acc[2][N / 2];
  ml.run(w, D, h + (static_cast<size_t>(e) * C + c0) * F, C - c0, F,
         F / kTile, acc);
  bf16* ye = y + static_cast<size_t>(e) * C * D + d0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int c = c0 + wgmma_acc_col(i);
    if (c < C) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
        ye[static_cast<size_t>(c) * D + s * kTile + wgmma_acc_row(i)] =
            __float2bfloat16(acc[s][i]);
    }
  }
}

template <int N>
int launch_n(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd,
             bf16* h, bf16* y, int E, int C, int D, int F, cudaStream_t s) {
  constexpr int kStages = N >= 128 ? 3 : 4;   // two blocks an SM
  const size_t smem = smem_bytes(2, N, kStages);
  cudaError_t err = cudaFuncSetAttribute(
      moe_gate_up_kernel<N, kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(moe_down_kernel<N, kStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned ctiles = (C + N - 1) / N;
  moe_gate_up_kernel<N, kStages>
      <<<dim3(ctiles, F / kTile, E), kThreads, smem, s>>>(x, wg, wu, h, C, D,
                                                           F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_down_kernel<N, kStages>
      <<<dim3(ctiles, D / (2 * kTile), E), kThreads, smem, s>>>(h, wd, y, C,
                                                                D, F);
  return static_cast<int>(cudaGetLastError());
}

// The C-tile: the smallest of 16, 32, 64, 128 tokens that holds C; past
// 128, tiles of 160 where they pad less than tiles of 128 (C=320: two).
int launch(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd,
           bf16* h, bf16* y, int E, int C, int D, int F, cudaStream_t s) {
  if (D % (2 * kTile) || F % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 16) return launch_n<16>(x, wg, wu, wd, h, y, E, C, D, F, s);
  if (C <= 32) return launch_n<32>(x, wg, wu, wd, h, y, E, C, D, F, s);
  if (C <= 64) return launch_n<64>(x, wg, wu, wd, h, y, E, C, D, F, s);
  if (C <= 128 || (C + 127) / 128 * 128 < (C + 159) / 160 * 160)
    return launch_n<128>(x, wg, wu, wd, h, y, E, C, D, F, s);
  return launch_n<160>(x, wg, wu, wd, h, y, E, C, D, F, s);
}

}  // namespace tc

}  // namespace

extern "C" int moe_ffn_f32(const void* x, const void* wg, const void* wu,
                           const void* wd, void* y, int E, int C, int D, int F,
                           void* stream) {
  return launch<float>(x, wg, wu, wd, y, E, C, D, F, stream);
}

extern "C" int moe_ffn_bf16(const void* x, const void* wg, const void* wu,
                            const void* wd, void* h, void* y, int E, int C,
                            int D, int F, void* stream) {
  return tc::launch(static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                    static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
                    static_cast<bf16*>(h), static_cast<bf16*>(y), E, C, D, F,
                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
