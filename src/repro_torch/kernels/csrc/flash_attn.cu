// Causal / sliding-window flash attention over a full sequence, GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (_kernel).  q (B, S, Hq, hd); k/v (B, S, Hkv, hd), each read by its own
// (batch, sequence, head) strides with the head dim contiguous; out
// (B, S, Hq, hd) contiguous.  Query head hq reads kv head hq / (Hq / Hkv),
// so K/V are never repeated and q/k/v never transposed.
// Key j is attended by the query at position i when j < S, and, with
// causal, j <= i, and, with a window w > 0, j > i - w.
//
// Bound on an H100: operations.  At the main path's shape (B=2, S=2048,
// Hq=32, hd=128) the causal half alone is 4*B*Hq*S(S+1)/2*hd = 69 GFLOP
// against 50 MB of q/k/v/out, far above the card's ridge: 0.07 ms at the
// bf16 tensor-core peak, 1.03 ms at the fp32 rate of the CUDA cores.
//
// Both types share the work split:
//   * one block per (64 grouped query rows, kv head, batch row); grouped
//     row r is (position r / G, query head h*G + r % G), G = Hq / Hkv, so
//     each K/V tile is staged once for all G query heads that read it;
//   * the block loops over 64-key tiles from the first key its rows'
//     window reaches to its last row's diagonal, skipping the tiles wholly
//     above the diagonal or wholly at or below i - w (exact: such a tile
//     leaves m, l and acc unchanged); blocks start with the longest rows;
//   * keys at or beyond S (the ragged last tile) are masked whatever
//     causal is, and rows at or beyond S are neither computed nor written.
//
// bf16 runs on the tensor cores (flash_attention_bf16, tc::): one
// warpgroup of 128 threads per block, two blocks an SM.  Q stays in
// registers as the A operand of S = Q K^T (wgmma m64n64k16, K read from
// 128-byte-swizzled shared memory, K-major); the online softmax runs on S
// in registers, and P, rounded to bf16 in registers, is the A operand of
// O += P V (wgmma m64n{hd}k16, V read as an MN-major operand), so neither
// Q nor P goes to shared memory.  Thread 0 streams the K/V tiles with TMA
// (a 4-d tensor map over the strided k/v views; keys past S read as zero)
// into a ring of two K and three V slots guarded by mbarriers, two tiles
// ahead.  Step i issues S_i and P_{i-1} V_{i-1} together and runs the
// softmax of S_i while the tensor cores finish P_{i-1} V_{i-1}.  The mask
// is applied only on tiles that need it: the diagonal, the window's edge
// and the ragged end.
//
// Any head dim hd from 1 to 256 runs on the smallest of four
// instantiations W = 64, 128, 192 and 256 that covers it (recurrentgemma-
// 2b's local attention is hd 256: 10 query heads on one kv head, so 64
// grouped rows hold 6.4 positions and a position's group can straddle two
// blocks; stablelm-12b's hd 160, phi-2's 80 and phi-3-mini's 96 run
// padded).  The kernel reads hd at run time: dims past hd are zero in the
// staged Q, K and V (K and V as W / 64 boxes of 64 dims whose dims past
// the tensor map's hd TMA fills with zeros), so they add exact zeros to
// Q K^T, give exact-zero columns of O that are never written, and the
// softmax scale (hd^-0.5, the caller's) and the output's row stride use the
// true hd.  bf16's TMA maps need hd * 2 bytes a multiple of 16: for an hd
// that is not a multiple of 8 the wrapper stages zero-padded copies of q,
// k and v at the next multiple of 8 (kernels/flash_attn.py).  W = 192 runs
// O += P V at N = 192 (m64n192k16: an MN-major operand of 128-byte swizzle
// covers N in whole 64-wide atoms); its 96 O and 48 Q registers a thread
// and 120 KB ring hold it to one block an SM.
// hd 256's O accumulator (m64n256) is 128 fp32 registers a thread; with Q
// in registers too (64 more) the S and P fragments would not fit the 255 a
// thread may have, so hd 256 stages the block's Q once in a 32 KB swizzled
// shared tile (four 64-dim boxes, K-major, by cp.async) and S = Q K^T reads
// both operands from shared memory (wgmma m64n64k16 SS).  With the 160 KB
// K/V ring that is 193 KB of shared memory, one block an SM.
//
// fp32 stays on the CUDA cores (flash_attention_f32): the port holds fp32
// to 2e-5, which TF32 cannot meet.  It reads element by element, so any hd
// runs on the same four widths W with no staging.  q (once) and each K
// tile are staged transposed in shared memory as fp32 ([W][64 + 4]), V as
// [64][W], dims past hd zero; 256 threads form a 16 x 16 grid, each owning
// a 4 x 4 tile of logits and a 4 x W/16 tile of the accumulator (dims
// c*64 + 4 tx..+3 for each 64 dims); row max and row sum are reduced with
// warp shuffles.  At W 256 the staged tiles take 256*68*2 + 64*256 + 64*68
// = 55,552 floats (222,208 bytes) of the 232,448 a block may have: one
// block an SM.
//
// Rounding follows the reference (_kernel): logits are an fp32 dot times
// hd^-0.5, masked logits are -1e30, p = exp(logit - m_new) with masked p
// forced to 0, l sums the unrounded p, P.V uses p rounded to V's type with
// fp32 accumulation, and out = acc / max(l, 1e-30) in q's type.  The
// rounded p depends on each tile's running max, so bf16 agrees with the
// dense oracle (which rounds normalised probabilities) only to bf16
// tolerance.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;      // grouped query rows per block
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 256;  // 16 x 16: (row group ty, key/dim group tx)
constexpr int kPad = 4;        // keeps 16-byte alignment, spreads banks
constexpr int kLd = kRows + kPad;   // == kKeys + kPad
constexpr float kNegInf = -1e30f;

struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
};

// hd: the true head dim (<= the instantiation's width W, the template's
// HD); scale: hd^-0.5
struct Geometry {
  int S, Hq, Hkv, hd, causal, window;
  float scale;
};

// Accumulator column c of thread tx (of kDims = HD / 16): float4 groups,
// 4 tx..4 tx+3 of each 64 dims.
__device__ __forceinline__ int acc_dim(int c, int tx) {
  return (c >> 2) * 64 + tx * 4 + (c & 3);
}

template <int HD>
constexpr size_t smem_floats() {
  // q^T [HD][kLd], K^T [HD][kLd], V [kKeys][HD], P [kRows][kLd]
  return static_cast<size_t>(HD) * kLd * 2 + kKeys * HD + kRows * kLd;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      Strides st, Geometry geo) {
  constexpr int kDims = HD / 16;   // accumulator columns per thread
  static_assert(HD % 64 == 0, "the instantiation: whole 64s");
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // [HD][kLd]   q^T
  float* ks = qs + HD * kLd;       // [HD][kLd]   K^T
  float* vs = ks + HD * kLd;       // [kKeys][HD] V
  float* ps = vs + kKeys * HD;     // [kRows][kLd] p, rounded to T

  const int G = geo.Hq / geo.Hkv;
  const int rows_total = geo.S * G;
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = tile * kRows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qb = q + b * st.q_b;
  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD, row = r0 + r;
    float val = 0.f;
    if (row < rows_total && d < geo.hd) {
      const int pos = row / G, g = row - pos * G;
      val = Num<T>::to_f(qb[pos * st.q_s + (h * G + g) * st.q_h + d]);
    }
    qs[d * kLd + r] = val;
  }

  // the keys this block's rows can attend
  const int p_lo = r0 / G;
  const int p_hi = (min(rows_total, r0 + kRows) - 1) / G;
  const int k_lo = geo.window > 0 ? max(p_lo - geo.window + 1, 0) : 0;
  const int k_hi = geo.causal ? p_hi : geo.S - 1;

  int pos[4];
  float m_run[4], l_run[4], acc[4][kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    pos[i] = row < rows_total ? row / G : -1;   // -1: no key attends
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.f;
  }

  for (int kt = k_lo / kKeys; kt <= k_hi / kKeys; ++kt) {
    const int key0 = kt * kKeys;
    __syncthreads();   // q staged / the previous tile fully consumed
    for (int i = tid; i < kKeys * HD; i += kThreads) {
      const int j = i / HD, d = i - j * HD, key = key0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < geo.S && d < geo.hd) {
        kv = Num<T>::to_f(kb[key * st.k_s + d]);
        vv = Num<T>::to_f(vb[key * st.v_s + d]);
      }
      ks[d * kLd + j] = kv;
      vs[j * HD + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qa = ld4(qs + d * kLd + ty * 4);
      const float4 kk = ld4(ks + d * kLd + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + tx * 4 + j;
        ok[j] = pos[i] >= 0 && key < geo.S &&
                (!geo.causal || key <= pos[i]) &&
                (geo.window <= 0 || key > pos[i] - geo.window);
        s[i][j] = ok[j] ? s[i][j] * geo.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[i][c] *= corr;
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kLd + tx * 4) =
          make_float4(round_to<T>(p[0]), round_to<T>(p[1]),
                      round_to<T>(p[2]), round_to<T>(p[3]));
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = ld4(ps + (ty * 4 + i) * kLd + j);
        pr[i][0] = t.x;
        pr[i][1] = t.y;
        pr[i][2] = t.z;
        pr[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * HD;
#pragma unroll
        for (int c4 = 0; c4 < HD / 64; ++c4) {
          const float4 t = ld4(vrow + c4 * 64 + tx * 4);
          const float vv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][c4 * 4 + e] = fmaf(pr[i][jj], vv[e], acc[i][c4 * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (pos[i] < 0) continue;
    const int row = r0 + ty * 4 + i, g = row - pos[i] * G;
    T* o = out + ((static_cast<long long>(b) * geo.S + pos[i]) * geo.Hq +
                  h * G + g) * geo.hd;
    const float l = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDims; ++c)
      if (acc_dim(c, tx) < geo.hd)
        o[acc_dim(c, tx)] = Num<T>::from_f(acc[i][c] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           const Strides& st, int B, const Geometry& geo, void* stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = geo.Hq / geo.Hkv;
  const long long tiles = (static_cast<long long>(geo.S) * G + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(tiles), geo.Hkv, B);
  flash_attn_kernel<T, HD><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), st, geo);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

namespace tc {

using namespace hopper;

constexpr int kThreads = 128;    // one warpgroup: 64 grouped rows
constexpr int kKStages = 2;      // K ring: K_i is read in step i
constexpr int kVStages = 3;      // V ring: V_i is read in step i + 1
constexpr float kLog2e = 1.4426950408889634f;

// K and V tiles hold the instantiation's HD / 64 whole 64-dim boxes, the
// dims past the true hd zero-filled by TMA
template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return 64 * HD * 2;   // 64 rows of HD bf16
}

// W 192's O accumulators (96 a thread) and 120 KB ring, and W 256's
// (128 a thread) and 193 KB: one block an SM
template <int HD>
__host__ __device__ constexpr int min_blocks() {
  return HD > 128 ? 1 : 2;
}

// hd 256 keeps Q in shared memory (the A operand of S = Q K^T), the
// narrower head dims in registers
template <int HD>
__host__ __device__ constexpr bool q_in_smem() {
  return HD > 192;
}

template <int HD>
constexpr size_t smem_bytes() {
  return 1024 + tile_bytes<HD>() * (kKStages + kVStages) +
         (q_in_smem<HD>() ? tile_bytes<HD>() : 0) + 8 * (kKStages + kVStages);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, min_blocks<HD>())
    flash_attn_tc_kernel(const bf16* __restrict__ q,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         bf16* __restrict__ out, Strides st, Geometry geo) {
  static_assert(HD % 64 == 0, "the instantiation: whole 64-dim boxes");
  constexpr uint32_t kTile = tile_bytes<HD>();
  constexpr int kHP = HD;                     // P V's N
  constexpr int kO = kHP / 2;                 // O accumulators a thread
  extern __shared__ uint8_t smem[];
  constexpr bool kQSmem = q_in_smem<HD>();
  const uint32_t k_ring = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t v_ring = k_ring + kKStages * kTile;
  const uint32_t q_tile = v_ring + kVStages * kTile;   // hd 256 only
  const uint32_t k_bars = q_tile + (kQSmem ? kTile : 0);
  const uint32_t v_bars = k_bars + 8 * kKStages;

  const int G = geo.Hq / geo.Hkv;
  const int rows_total = geo.S * G;
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = tile * 64;
  const int t = threadIdx.x, lane = t & 31;

  const bf16* qb = q + b * st.q_b + h * G * st.q_h;

  // the keys this block's rows can attend, in whole 64-key tiles
  const int p_lo = r0 / G;
  const int p_hi = (min(rows_total, r0 + 64) - 1) / G;
  const int k_lo = geo.window > 0 ? max(p_lo - geo.window + 1, 0) : 0;
  const int k_hi = geo.causal ? p_hi : geo.S - 1;
  const int t_lo = k_lo / 64, n_tiles = k_hi / 64 - t_lo + 1;

  if (t == 0) {
    for (int s = 0; s < kKStages; ++s) mbar_init(k_bars + 8 * s, 1);
    for (int s = 0; s < kVStages; ++s) mbar_init(v_bars + 8 * s, 1);
    mbar_fence_init();
  }
  if constexpr (kQSmem) {
    // the block's 64 grouped rows of Q into the swizzled tile, 16 bytes a
    // copy: row r's dims 8c..8c+7 go to box c / 8, chunk c % 8 (rows past
    // the end and dims past hd read as zero)
    for (int i = t; i < 64 * HD / 8; i += kThreads) {
      const int r = i / (HD / 8), c = i - r * (HD / 8), row = r0 + r;
      const bool ok = row < rows_total && 8 * c < geo.hd;
      const bf16* src =
          ok ? qb + (row % G) * st.q_h + (row / G) * st.q_s + 8 * c : qb;
      cp_async16(q_tile + (c >> 3) * (64 * 128) + swizzle128(r, c & 7), src,
                 ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
  }
  __syncthreads();

  // key tile i, by thread 0: K into K slot i % 2, V into V slot i % 3, each
  // as kHP / 64 TMA boxes of 64 keys x 64 dims (keys past S, and dims past
  // HD, read as zero)
  auto load_tile = [&](int i) {
    if (t != 0) return;
    const int key0 = (t_lo + i) * 64;
    const uint32_t kbar = k_bars + 8 * (i % kKStages);
    const uint32_t vbar = v_bars + 8 * (i % kVStages);
    mbar_arrive_expect_tx(kbar, kTile);
#pragma unroll
    for (int blk = 0; blk < kHP / 64; ++blk)
      tma_load_4d(k_ring + (i % kKStages) * kTile + blk * (64 * 128), &k_map,
                  blk * 64, h, key0, b, kbar);
    mbar_arrive_expect_tx(vbar, kTile);
#pragma unroll
    for (int blk = 0; blk < kHP / 64; ++blk)
      tma_load_4d(v_ring + (i % kVStages) * kTile + blk * (64 * 128), &v_map,
                  blk * 64, h, key0, b, vbar);
  };

  load_tile(0);
  if (n_tiles > 1) load_tile(1);

  // this thread's two rows (accumulator rows 16 w + lane / 4, and + 8);
  // grouped row r is position r / G, query head h G + r % G; rows past
  // the end take the last position, read zero queries and are not written
  const int ra = r0 + 16 * (t >> 5) + (lane >> 2), rb = ra + 8;
  const int pos_a = min(ra, rows_total - 1) / G;
  const int pos_b = min(rb, rows_total - 1) / G;
  // Q stays in registers as the A operand of S = Q K^T (below W 256):
  // per 16-wide step kk of hd, {row a, hd 16 kk + 2 (lane % 4) + 0..1},
  // {row b, ...}, {row a, ... + 8}, {row b, ... + 8}; dims past hd (a
  // multiple of 8) are zero
  uint32_t qa[kQSmem ? 1 : HD / 16][4];
  if constexpr (!kQSmem) {
    const int d0 = 2 * (lane & 3);
    const bf16* q_a = qb + (ra % G) * st.q_h + (ra / G) * st.q_s + d0;
    const bf16* q_b = qb + (rb % G) * st.q_h + (rb / G) * st.q_s + d0;
    const bool ok_a = ra < rows_total, ok_b = rb < rows_total;
    auto ld = [](const bf16* p, bool ok) {
      return ok ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const bool lo = 16 * kk < geo.hd, hi = 16 * kk + 8 < geo.hd;
      qa[kk][0] = ld(q_a + 16 * kk, ok_a && lo);
      qa[kk][1] = ld(q_b + 16 * kk, ok_b && lo);
      qa[kk][2] = ld(q_a + 16 * kk + 8, ok_a && hi);
      qa[kk][3] = ld(q_b + 16 * kk + 8, ok_b && hi);
    }
  }
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float s[32];
  uint32_t pa[4][4];

  auto issue_s = [&](int i) {   // S_i = Q K_i^T, K K-major, along hd
    const uint32_t ks = k_ring + (i % kKStages) * kTile;
    mbar_wait(k_bars + 8 * (i % kKStages), (i / kKStages) & 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      if constexpr (kQSmem)
        WgmmaSS<64, 0, 0>::run(s, desc_sw128(q_tile + off, 16, 1024),
                               desc_sw128(ks + off, 16, 1024), kk > 0);
      else
        WgmmaRS<64, 0>::run(s, qa[kk], desc_sw128(ks + off, 16, 1024),
                            kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int i) {  // O += P_i V_i, V MN-major, along keys
    const uint32_t vs = v_ring + (i % kVStages) * kTile;
    mbar_wait(v_bars + 8 * (i % kVStages), (i / kVStages) & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<kHP, 1>::run(o, pa[kk],
                           desc_sw128(vs + kk * 2048, 64 * 128, 1024), 1);
    wgmma_commit();
  };
  // the online softmax of S_i in place (s becomes p, unrounded), with the
  // factors that rescale O from the old running max to the new one.  m
  // runs over the unscaled dots (the scale is positive), and the scale
  // folds into the exponent: p = 2^((dot - m) scale log2 e)
  const float c = geo.scale * kLog2e;
  float corr_a, corr_b;
  auto softmax = [&](int i) {
    const int key0 = (t_lo + i) * 64;
    // the mask, only where a tile crosses the diagonal, the window's edge
    // or the end of the sequence
    const bool edge = key0 + 63 >= geo.S ||
                      (geo.causal && key0 + 63 > p_lo) ||
                      (geo.window > 0 && key0 <= p_hi - geo.window);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = s[j];
      if (edge) {
        const int key = key0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const int pos = (j & 2) ? pos_b : pos_a;
        const bool ok = key < geo.S && (!geo.causal || key <= pos) &&
                        (geo.window <= 0 || key > pos - geo.window);
        if (!ok) x = kNegInf;
      }
      s[j] = x;
      if (j & 2) mx_b = fmaxf(mx_b, x);
      else mx_a = fmaxf(mx_a, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    corr_a = ex2((m_a - mn_a) * c);
    corr_b = ex2((m_b - mn_b) * c);
    // p of a masked key is exactly 0: it underflows against a live row's
    // max, and a row with no live key yet (max still -1e30) exponentiates
    // against +inf
    const float ml_a = mn_a == kNegInf ? INFINITY : mn_a * c;
    const float ml_b = mn_b == kNegInf ? INFINITY : mn_b * c;
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = ex2(fmaf(s[j], c, (j & 2) ? -ml_b : -ml_a));
      s[j] = p;
      if (j & 2) sum_b += p;
      else sum_a += p;
    }
    l_a = l_a * corr_a + sum_a;     // this thread's share of the row sums
    l_b = l_b * corr_b + sum_b;
  };
  auto pack_p = [&]() {          // P_i in bf16: wgmma's A fragment
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0);                      // O is zero: nothing to rescale
  pack_p();
  if (n_tiles > 2) load_tile(2);   // into K_0's slot and a fresh V slot

  // Step i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} are issued together;
  // the softmax of S_i runs while the tensor cores finish P_{i-1} V_{i-1};
  // then O is rescaled to S_i's running max and P_i packed.
  for (int i = 1; i < n_tiles; ++i) {
    wgmma_fence();
    issue_s(i);
    issue_pv(i - 1);
    wgmma_wait<1>();               // S_i has landed
    fence_regs(s);
    softmax(i);
    wgmma_wait<0>();               // P_{i-1} V_{i-1} has landed in O
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
#pragma unroll
    for (int j = 0; j < kO; ++j) o[j] *= (j & 2) ? corr_b : corr_a;
    pack_p();
    // K_i's slot and V_{i-1}'s are free: tile i + 2 goes into them
    if (i + 2 < n_tiles) load_tile(i + 2);
  }
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= rows_total) continue;
    const int pos = row / G, g = row - pos * G;
    bf16* orow = out + ((static_cast<long long>(b) * geo.S + pos) * geo.Hq +
                        h * G + g) * geo.hd;
    const float l = half ? l_b : l_a;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {     // O's columns past hd stay
      const int d = 8 * j + 2 * (lane & 3);
      if (8 * j < geo.hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            o[4 * j + 2 * half] / l, o[4 * j + 2 * half + 1] / l);
    }
  }
}

// The TMA map of k or v (B, S, Hkv, hd) read by its strides (elements);
// a box is 64 dims of one head at 64 positions of one batch row (dims at
// or past hd read as zero).
int kv_map(CUtensorMap* map, const bf16* base, long long b_stride,
           long long s_stride, long long h_stride, int B, int S, int Hkv,
           int hd) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(h_stride) * 2,
                                 static_cast<cuuint64_t>(s_stride) * 2,
                                 static_cast<cuuint64_t>(b_stride) * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return encode_tma_bf16(map, base, 4, dims, strides, box);
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
           const Strides& st, int B, const Geometry& geo, cudaStream_t s) {
  CUtensorMap k_map, v_map;
  int rc = kv_map(&k_map, k, st.k_b, st.k_s, st.k_h, B, geo.S, geo.Hkv,
                  geo.hd);
  if (rc != 0) return rc;
  rc = kv_map(&v_map, v, st.v_b, st.v_s, st.v_h, B, geo.S, geo.Hkv, geo.hd);
  if (rc != 0) return rc;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = geo.Hq / geo.Hkv;
  const long long tiles = (static_cast<long long>(geo.S) * G + 63) / 64;
  const dim3 grid(static_cast<unsigned>(tiles), geo.Hkv, B);
  flash_attn_tc_kernel<HD><<<grid, kThreads, smem, s>>>(q, k_map, v_map, out,
                                                        st, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Strides are in elements; the head dim of q, k and v is contiguous (bf16:
// base addresses and strides 16-byte aligned and hd a multiple of 8, which
// the wrapper sees to).  Any hd from 1 to 256 runs on the smallest
// instantiation W that covers it.  window <= 0 means no window.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, long long q_b, long long q_s,
                                   long long q_h, long long k_b, long long k_s,
                                   long long k_h, long long v_b, long long v_s,
                                   long long v_h, int B, int S, int Hq, int Hkv,
                                   int hd, int causal, int window, float scale,
                                   void* stream) {
  const Strides st{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
  const Geometry geo{S, Hq, Hkv, hd, causal, window, scale};
  if (hd < 1 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64) return launch<float, 64>(q, k, v, out, st, B, geo, stream);
  if (hd <= 128) return launch<float, 128>(q, k, v, out, st, B, geo, stream);
  if (hd <= 192) return launch<float, 192>(q, k, v, out, st, B, geo, stream);
  return launch<float, 256>(q, k, v, out, st, B, geo, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, long long q_b, long long q_s,
                                    long long q_h, long long k_b, long long k_s,
                                    long long k_h, long long v_b, long long v_s,
                                    long long v_h, int B, int S, int Hq,
                                    int Hkv, int hd, int causal, int window,
                                    float scale, void* stream) {
  const Strides st{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
  const Geometry geo{S, Hq, Hkv, hd, causal, window, scale};
  if (hd < 1 || hd > 256 || hd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return tc::launch<64>(qp, kp, vp, op, st, B, geo, s);
  if (hd <= 128) return tc::launch<128>(qp, kp, vp, op, st, B, geo, s);
  if (hd <= 192) return tc::launch<192>(qp, kp, vp, op, st, B, geo, s);
  return tc::launch<256>(qp, kp, vp, op, st, B, geo, s);
}
