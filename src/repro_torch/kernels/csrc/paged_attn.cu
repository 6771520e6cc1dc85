// Paged flash attention over the block-table page pool (fp or int8 pools).
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_attention
// (_kernel, _page_index), both branches.  q (B, T, Hq, hd); k/v pools
// (P, ps, Hkv, hd) in q's type, or int8 with fp32 scale pools
// (P, ps, Hkv, 1); block_tables (B, NB), lengths / seg_lens (B,) int32
// -> out (B, T, Hq, hd).
// Token t of row b sits at absolute position lengths[b] + t and attends every
// slot at or before it (optionally within a window); tokens t >= seg_lens[b]
// are padding and get exactly zero rows.
//
// Bound on an H100: the bytes of the live K/V pages.  Each K/V byte feeds
// about G FLOP (G = Hq / Hkv = 8 at the main path's shapes, in bf16; twice
// that per int8 byte), far below the card's ~295 FLOP/byte ridge, so it is
// memory-bound.  The design reads only what the rows attend:
//   * one block per (row b, kv head h, tile of 16 grouped q rows); grouped
//     row r is (token r / G, q head h*G + r % G), so each K/V page is
//     staged once for all G query heads that share it (no GQA repeat);
//   * the block loops only over the live pages of its valid tokens
//     (pages 0 .. (lengths + last valid t) / ps, and with a window not the
//     pages wholly below it), clamping each table entry into [0, P);
//   * each page's K and V (ps x hd) are staged in shared memory as fp32;
//     an int8 pool is dequantized while staging, each value rounded to q's
//     type as T(float(q) * scale) before the dot, as the reference does
//     (one scale per slot and kv head); online
//     softmax state (m, l) is kept per row and the fp32 accumulator in
//     registers (thread = head dim).
// Rounding follows the reference: logits are an fp32 dot times hd^-0.5,
// masked slots are -1e30, p is rounded to V's dtype before P.V, l sums the
// unrounded p, and the output is acc / max(l, 1e-30).  Masked slots never
// touch the accumulator, so garbage in an attended page's dead slots
// cannot leak in.  Split-K decode (flash-decoding) is later work.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRows = 16;      // grouped q rows per block
constexpr int kThreads = 128;
constexpr int kDimsPerThread = 2;   // head_dim <= 256
constexpr float kNegInf = -1e30f;

struct Geometry {
  int T, Hq, Hkv, hd, P, ps, NB, window;
  float scale;
};

__device__ __forceinline__ bool attends(int row, int slot, int len, int seg,
                                        int TG, int G, int window) {
  if (row >= TG) return false;
  const int t = row / G;
  if (t >= seg) return false;
  const int qp = len + t;
  return slot <= qp && (window <= 0 || slot > qp - window);
}

// One pool value as fp32: an fp pool's value, or an int8 pool's value
// dequantized to q's type T.
template <typename T, typename P>
__device__ __forceinline__ float pool_value(const P* __restrict__ pool,
                                            const float* __restrict__ scale,
                                            size_t off, size_t soff) {
  if constexpr (std::is_same_v<P, int8_t>) {
    return round_to<T>(static_cast<float>(pool[off]) * scale[soff]);
  } else {
    return Num<T>::to_f(pool[off]);
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const T* __restrict__ q, const P* __restrict__ kpool,
                      const P* __restrict__ vpool,
                      const float* __restrict__ kscale,
                      const float* __restrict__ vscale,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ lengths,
                      const int* __restrict__ seg_lens, T* __restrict__ out,
                      Geometry geo) {
  extern __shared__ __align__(16) float sm[];
  const int hd = geo.hd, ps = geo.ps, G = geo.Hq / geo.Hkv;
  const int ldk = hd + 1;              // padded K row: conflict-free dots
  float* qs = sm;                      // [kRows][hd]
  float* ks = qs + kRows * hd;         // [ps][hd + 1]
  float* vs = ks + ps * ldk;           // [ps][hd]
  float* ss = vs + ps * hd;            // [kRows][ps] logits, then p
  float* rs = ss + kRows * ps;         // [kRows] correction, then l

  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int TG = geo.T * G;
  const int len = lengths[b], seg = seg_lens[b];
  const int tid = threadIdx.x;

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd, row = r0 + r;
    float v = 0.f;
    if (row < TG) {
      const int t = row / G, g = row - t * G;
      v = Num<T>::to_f(
          q[((static_cast<size_t>(b) * geo.T + t) * geo.Hq + h * G + g) * hd + d]);
    }
    qs[i] = v;
  }

  // live pages of this tile's valid tokens
  const int t_lo = r0 / G;
  const int t_hi = min(min((r0 + kRows - 1) / G, geo.T - 1), seg - 1);
  int p_lo = 0, p_hi = -1;
  if (t_lo <= t_hi) {
    p_hi = min((len + t_hi) / ps, geo.NB - 1);
    if (geo.window > 0) p_lo = max(len + t_lo - geo.window + 1, 0) / ps;
  }

  float acc[kRows][kDimsPerThread];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) acc[r][j] = 0.f;
  float m_run = kNegInf, l_run = 0.f;  // row tid's state (tid < kRows)

  const size_t slot_stride = static_cast<size_t>(geo.Hkv) * hd;
  for (int pi = p_lo; pi <= p_hi; ++pi) {
    const int page =
        min(max(block_tables[static_cast<size_t>(b) * geo.NB + pi], 0), geo.P - 1);
    const size_t sbase = static_cast<size_t>(page) * ps * geo.Hkv + h;
    const size_t base = sbase * hd;
    __syncthreads();   // q staged / previous page fully consumed
    for (int i = tid; i < ps * hd; i += kThreads) {
      const int j = i / hd, d = i - j * hd;
      const size_t off = base + j * slot_stride + d;
      const size_t soff = sbase + static_cast<size_t>(j) * geo.Hkv;
      ks[j * ldk + d] = pool_value<T, P>(kpool, kscale, off, soff);
      vs[j * hd + d] = pool_value<T, P>(vpool, vscale, off, soff);
    }
    __syncthreads();
    for (int i = tid; i < kRows * ps; i += kThreads) {
      const int r = i / ps, j = i - r * ps;
      float s = kNegInf;
      if (attends(r0 + r, pi * ps + j, len, seg, TG, G, geo.window)) {
        float a = 0.f;
        const float* qr = qs + r * hd;
        const float* kr = ks + j * ldk;
        for (int d = 0; d < hd; ++d) a = fmaf(qr[d], kr[d], a);
        s = a * geo.scale;
      }
      ss[i] = s;
    }
    __syncthreads();
    if (tid < kRows) {
      float* sr = ss + tid * ps;
      float mx = kNegInf;
      for (int j = 0; j < ps; ++j) mx = fmaxf(mx, sr[j]);
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int j = 0; j < ps; ++j) {
        const bool ok = attends(r0 + tid, pi * ps + j, len, seg, TG, G, geo.window);
        const float p = ok ? expf(sr[j] - m_new) : 0.f;
        sum += p;
        sr[j] = ok ? p : -1.f;      // -1 marks a masked slot
      }
      const float c = expf(m_run - m_new);
      l_run = l_run * c + sum;
      m_run = m_new;
      rs[tid] = c;
    }
    __syncthreads();
#pragma unroll
    for (int jd = 0; jd < kDimsPerThread; ++jd) {
      const int d = tid + jd * kThreads;
      if (d < hd) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float a = acc[r][jd] * rs[r];
          const float* pr = ss + r * ps;
          for (int j = 0; j < ps; ++j) {
            const float p = pr[j];
            if (p >= 0.f) a = fmaf(round_to<T>(p), vs[j * hd + d], a);
          }
          acc[r][jd] = a;
        }
      }
    }
  }

  __syncthreads();
  if (tid < kRows) rs[tid] = l_run;
  __syncthreads();
#pragma unroll
  for (int jd = 0; jd < kDimsPerThread; ++jd) {
    const int d = tid + jd * kThreads;
    if (d < hd) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = r0 + r;
        if (row < TG) {
          const int t = row / G, g = row - t * G;
          out[((static_cast<size_t>(b) * geo.T + t) * geo.Hq + h * G + g) * hd + d] =
              Num<T>::from_f(acc[r][jd] / fmaxf(rs[r], 1e-30f));
        }
      }
    }
  }
}

template <typename T, typename P>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* kscale, const void* vscale, const void* block_tables,
           const void* lengths, const void* seg_lens, void* out, int B,
           Geometry geo, void* stream) {
  const size_t smem =
      static_cast<size_t>(kRows * geo.hd + geo.ps * (geo.hd + 1) +
                          geo.ps * geo.hd + kRows * geo.ps + kRows) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int TG = geo.T * (geo.Hq / geo.Hkv);
  const dim3 grid(B, geo.Hkv, (TG + kRows - 1) / kRows);
  paged_attn_kernel<T, P><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const P*>(kpool),
      static_cast<const P*>(vpool), static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<const int*>(seg_lens),
      static_cast<T*>(out), geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PAGED_ATTN_ENTRY(NAME, TYPE)                                          \
  extern "C" int NAME(const void* q, const void* kpool, const void* vpool,   \
                      const void* block_tables, const void* lengths,         \
                      const void* seg_lens, void* out, int B, int T, int Hq, \
                      int Hkv, int hd, int P, int ps, int NB, int window,    \
                      float scale, void* stream) {                           \
    const Geometry geo{T, Hq, Hkv, hd, P, ps, NB, window, scale};            \
    return launch<TYPE, TYPE>(q, kpool, vpool, nullptr, nullptr,             \
                              block_tables, lengths, seg_lens, out, B, geo,  \
                              stream);                                       \
  }

// int8 pools: the fp32 scale pools (P, ps, Hkv, 1) follow the payload pools
#define PAGED_ATTN_INT8_ENTRY(NAME, TYPE)                                     \
  extern "C" int NAME(const void* q, const void* kpool, const void* vpool,   \
                      const void* kscale, const void* vscale,                \
                      const void* block_tables, const void* lengths,         \
                      const void* seg_lens, void* out, int B, int T, int Hq, \
                      int Hkv, int hd, int P, int ps, int NB, int window,    \
                      float scale, void* stream) {                           \
    const Geometry geo{T, Hq, Hkv, hd, P, ps, NB, window, scale};            \
    return launch<TYPE, int8_t>(q, kpool, vpool, kscale, vscale,             \
                                block_tables, lengths, seg_lens, out, B,     \
                                geo, stream);                                \
  }

PAGED_ATTN_ENTRY(paged_attention_f32, float)
PAGED_ATTN_ENTRY(paged_attention_bf16, __nv_bfloat16)
PAGED_ATTN_INT8_ENTRY(paged_attention_int8_f32, float)
PAGED_ATTN_INT8_ENTRY(paged_attention_int8_bf16, __nv_bfloat16)
