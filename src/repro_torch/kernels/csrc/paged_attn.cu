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
// memory-bound; at the serve's shapes it is latency-bound first (a decode
// step reads a few hundred KB).  The design gets many blocks in flight on
// few rows and keeps each block's page walk short:
//   * a block owns (row b, kv head h, tile of 16 grouped q rows, split s);
//     grouped row r is (token r / G, q head h*G + r % G), so each K/V page
//     is staged once for all G query heads that share it (no GQA repeat);
//   * split-K over pages (flash-decoding): the live pages of a tile's
//     valid tokens (pages 0 .. (lengths + last valid t) / ps, and with a
//     window not the pages wholly below it) are cut into S contiguous
//     ranges, one per block; S comes from shapes alone (paged_attn.py::
//     num_splits), so choosing it never reads a length on the host.  With
//     S > 1 each block writes fp32 partials (m, l, unnormalized acc) per
//     grouped row and paged_combine_kernel merges them:
//     out = sum_s e^{m_s - M} acc_s / max(sum_s e^{m_s - M} l_s, 1e-30),
//     skipping splits with l_s = 0 (nothing attended, acc not written);
//   * 64 keys a step through a two-stage cp.async ring, one barrier pair a
//     step; table entries are clamped into [0, P); slots that no row of the
//     tile attends are zero-filled, never read, so NaN in a live page's
//     dead slots cannot reach P.V; an int8 pool's payload and scales are
//     staged raw and dequantized into the tile, each value rounded to q's
//     type as T(float(q) * scale) (one scale per slot and kv head);
//   * any head dim hd from 1 to 256: bf16 runs on the instantiation of
//     width 64, 128 or 256 that covers it, fp32 on hd rounded up to 16
//     (its width); Q, K, V and the int8 payload are staged with their dims
//     past hd zero-filled up to the width, so they add exact zeros, and
//     only hd columns are written.  A pool row starts at a multiple of
//     hd * sizeof(element) bytes, so the copies are 16 bytes wide where
//     that allows and 8, 4, 2 or 1 where it does not (copy_unit), in a
//     kernel instantiated apart for such head dims (NARROW; bf16 at width
//     256 only) so the common one keeps its 16-byte loops alone; the
//     pools are read in place, never copied or padded;
//   * bf16 (paged_attn_tc_kernel) runs both products on the tensor cores
//     with mma.sync m16n8k16: each of the 4 warps takes 16 keys of the
//     step for all 16 rows (decode pads its 8 rows to 16), keeps its own
//     online-softmax state in registers, and P goes from the S fragment to
//     the A fragment of P.V without shared memory; the warps merge their
//     states once at the end.  fp32 (paged_attn_f32_kernel) keeps FMA on
//     the CUDA cores (the port holds it to 2e-5): 8 lanes a row, 8 keys a
//     lane, row reductions by shuffles.
// Rounding follows the reference: logits are an fp32 dot times hd^-0.5,
// masked slots are selected to -1e30 (and p to 0), p is rounded to V's
// dtype before P.V, l sums the unrounded p, and the output is
// acc / max(l, 1e-30), rounded once.  p is rounded against each warp's
// (and split's) running max, not the row's: within bf16 tolerance.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kRows = 16;      // grouped q rows per block
constexpr int kKeys = 64;      // keys per step
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Geometry {
  int T, Hq, Hkv, hd, P, ps, NB, window, splits;
  float scale;
};

// The slots [js, je) block ``s`` of a tile walks: the tile's valid tokens
// t_lo..t_hi attend slots s_lo..s_hi (their union); those slots' pages are
// cut into ``splits`` ranges of whole 64-key steps' worth of pages.  Empty
// when js >= je.  Copied in paged_attn.py::split_keys for the CPU tests:
// the two must stay in step.
__device__ __forceinline__ void split_keys(int len, int t_lo, int t_hi,
                                           const Geometry& g, int s, int& js,
                                           int& je) {
  js = je = 0;
  if (t_lo > t_hi) return;
  const int s_lo = g.window > 0 ? max(len + t_lo - g.window + 1, 0) : 0;
  const int s_hi = min(len + t_hi, g.NB * g.ps - 1);
  if (s_lo > s_hi) return;
  const int p_lo = s_lo / g.ps, p_hi = s_hi / g.ps;
  const int step = max(1, kKeys / g.ps);
  int per = (p_hi - p_lo + g.splits) / g.splits;
  per = (per + step - 1) / step * step;
  const int a = p_lo + s * per, e = min(a + per, p_hi + 1);
  if (a >= e) return;
  js = max(a * g.ps, s_lo);
  je = min(e * g.ps, s_hi + 1);
}

// The tile's valid tokens: t_lo..t_hi (empty when t_lo > t_hi).
__device__ __forceinline__ void tile_tokens(int r0, int seg, const Geometry& g,
                                            int& t_lo, int& t_hi) {
  const int G = g.Hq / g.Hkv;
  t_lo = r0 / G;
  t_hi = min(min((r0 + kRows - 1) / G, g.T - 1), seg - 1);
}

// Absolute position of grouped row R (or -1: past T*G or a padding token).
__device__ __forceinline__ int row_pos(int R, int len, int seg,
                                       const Geometry& g) {
  const int G = g.Hq / g.Hkv;
  if (R >= g.T * G) return -1;
  const int t = R / G;
  return t < seg ? len + t : -1;
}

__device__ __forceinline__ bool attends(int qp, int j, int je, int window) {
  return j <= qp && j < je && (window <= 0 || j > qp - window);
}

// Offset of grouped row R of (b, h) in q / out (elements).
__device__ __forceinline__ size_t row_off(int b, int h, int R,
                                          const Geometry& g) {
  const int G = g.Hq / g.Hkv, t = R / G;
  return ((static_cast<size_t>(b) * g.T + t) * g.Hq + h * G + R % G) * g.hd;
}

// The pool slots (page * ps + j % ps, the page clamped into [0, P)) of
// keys j0 .. j0 + 63, or -1 at or past je: one division per key a step,
// shared by K, V and their scales.
__device__ __forceinline__ void slot_table(int* __restrict__ tab,
                                           const int* __restrict__ bt_row,
                                           int j0, int je, const Geometry& g) {
  for (int i = threadIdx.x; i < kKeys; i += kThreads) {
    const int j = j0 + i;
    tab[i] = j < je ? min(max(bt_row[j / g.ps], 0), g.P - 1) * g.ps + j % g.ps
                    : -1;
  }
}

// The narrow copies of a head dim whose rows no 16-byte copy takes (hd *
// elt not a multiple of 16): ``width`` bytes a row at ``dst`` (a row every
// ``ld`` bytes), its first hd * elt bytes read from ``row(i)`` (nullptr: a
// zero row), the rest zero, in copies of copy_unit(hd * elt) bytes.
template <typename Row>
__device__ __forceinline__ void stage_narrow(uint32_t dst, int rows, int ld,
                                             int width, int valid,
                                             const void* any, Row row) {
  const int unit = copy_unit(valid), upr = width / unit;
  for (int u = threadIdx.x; u < rows * upr; u += kThreads) {
    const int i = u / upr, o = (u - i * upr) * unit;
    const char* src = row(i);
    const bool ok = src != nullptr && o < valid;
    copy_unit_async(dst + i * ld + o, ok ? src + o : any, unit, ok);
  }
}

// The 64 keys of slot table ``tab`` of one pool (elements of ``elt``
// bytes) through stage_narrow.
__device__ __forceinline__ void load_keys_narrow(uint32_t dst, int ld, int width,
                                              int elt, const char* pool,
                                              const int* tab, int h,
                                              Geometry g) {
  const size_t rb = static_cast<size_t>(g.hd) * elt;
  stage_narrow(dst, kKeys, ld * elt, width * elt, g.hd * elt, pool,
               [&](int i) -> const char* {
                 return tab[i] < 0 ? nullptr
                                   : pool + (static_cast<size_t>(tab[i]) *
                                                 g.Hkv + h) * rb;
               });
}

// The tile's 16 grouped rows of q through stage_narrow (rows past T*G
// zero).
__device__ __forceinline__ void load_q_narrow(uint32_t dst, int ld, int width,
                                           int elt, const char* q, int b,
                                           int h, int r0, int TG,
                                           Geometry g) {
  stage_narrow(dst, kRows, ld * elt, width * elt, g.hd * elt, q,
               [&](int r) -> const char* {
                 return r0 + r < TG ? q + row_off(b, h, r0 + r, g) * elt
                                    : nullptr;
               });
}

// Stage the 64 keys of slot table ``tab`` of one pool into rows of ``ld``
// elements at ``dst``: ``width`` elements a row, the first hd read, the
// rest and the rows of slot -1 zero-filled; 16 bytes a copy where the
// pool's rows allow (hd * sizeof(E) a multiple of 16), else, in a NARROW
// kernel, stage_narrow.
template <bool NARROW, typename E>
__device__ __forceinline__ void load_keys(uint32_t dst, int ld, int width,
                                          const E* __restrict__ pool,
                                          const int* __restrict__ tab, int h,
                                          const Geometry& g) {
  if (NARROW && copy_unit(g.hd * sizeof(E)) < 16) {
    load_keys_narrow(dst, ld, width, sizeof(E),
                     reinterpret_cast<const char*>(pool), tab, h, g);
    return;
  }
  constexpr int kC = 16 / sizeof(E);
  const int cpr = width / kC;
  for (int u = threadIdx.x; u < kKeys * cpr; u += kThreads) {
    const int i = u / cpr, c = u - i * cpr, slot = tab[i];
    const bool ok = slot >= 0 && c * kC < g.hd;
    const E* src =
        ok ? pool + (static_cast<size_t>(slot) * g.Hkv + h) * g.hd + c * kC
           : pool;
    cp_async16(dst + (i * ld + c * kC) * sizeof(E), src, ok);
  }
}

// Stage the tile's 16 grouped rows of q into rows of ``ld`` elements at
// ``dst``: ``width`` a row, rows past T*G and columns past hd zero; 16
// bytes a copy where q's rows allow, else, in a NARROW kernel,
// stage_narrow.
template <bool NARROW, typename T>
__device__ __forceinline__ void load_q(uint32_t dst, int ld, int width,
                                       const T* __restrict__ q, int b, int h,
                                       int r0, int TG, const Geometry& g) {
  if (NARROW && copy_unit(g.hd * sizeof(T)) < 16) {
    load_q_narrow(dst, ld, width, sizeof(T),
                  reinterpret_cast<const char*>(q), b, h, r0, TG, g);
    return;
  }
  constexpr int kC = 16 / sizeof(T);
  const int cpr = width / kC;
  for (int u = threadIdx.x; u < kRows * cpr; u += kThreads) {
    const int r = u / cpr, c = u - r * cpr, R = r0 + r;
    const bool ok = R < TG && c * kC < g.hd;
    cp_async16(dst + (r * ld + c * kC) * sizeof(T),
               ok ? q + row_off(b, h, R, g) + c * kC : q, ok);
  }
}

// Whether a launch over q of ``qelt``-byte and pools of ``pelt``-byte
// elements needs the narrow copies (a row of hd that no 16-byte copy
// takes): such a head dim runs on a kernel instantiated with NARROW, so
// the common one keeps the 16-byte loops alone.
inline bool narrow(int hd, int qelt, int pelt) {
  return copy_unit(hd * qelt) < 16 || copy_unit(hd * pelt) < 16;
}

// The fp32 scales of the 64 keys of ``tab`` (zero for slot -1).
__device__ __forceinline__ void load_scales(uint32_t dst,
                                            const float* __restrict__ scale,
                                            const int* __restrict__ tab,
                                            int h, const Geometry& g) {
  for (int i = threadIdx.x; i < kKeys; i += kThreads) {
    const int slot = tab[i];
    cp_async4(dst + 4 * i,
              slot >= 0 ? scale + static_cast<size_t>(slot) * g.Hkv + h
                        : scale,
              slot >= 0);
  }
}

// Raw int8 rows (``width`` bytes, unpadded) with their scales -> rows of
// ``ld`` elements of E, each value E(float(q) * scale).  Zero-filled rows
// (payload and scale zero) stay zero.
template <typename E>
__device__ __forceinline__ void dequant_keys(E* __restrict__ tile, int ld,
                                             const int8_t* __restrict__ raw,
                                             const float* __restrict__ sc,
                                             int width) {
  const int cpr = width / 16;
  for (int u = threadIdx.x; u < kKeys * cpr; u += kThreads) {
    const int i = u / cpr, c = u - i * cpr;
    const uint4 q = *reinterpret_cast<const uint4*>(raw + i * width + c * 16);
    const float s = sc[i];
    const uint32_t w[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u,
                           q.z ^ 0x80808080u, q.w ^ 0x80808080u};
    float f[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) f[n] = s8_to_f32(w[n >> 2], n & 3) * s;
    E* out = tile + i * ld + c * 16;
    if constexpr (std::is_same_v<E, float>) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        reinterpret_cast<float4*>(out)[n] =
            make_float4(f[4 * n], f[4 * n + 1], f[4 * n + 2], f[4 * n + 3]);
    } else {
      uint32_t p[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) p[n] = pack_bf16(f[2 * n], f[2 * n + 1]);
      reinterpret_cast<uint4*>(out)[0] = make_uint4(p[0], p[1], p[2], p[3]);
      reinterpret_cast<uint4*>(out)[1] = make_uint4(p[4], p[5], p[6], p[7]);
    }
  }
}

// A block with nothing to attend: with S = 1 its rows of out are zero;
// with S > 1 its partials say "nothing" (m = -1e30, l = 0; acc unwritten).
template <typename T>
__device__ void write_empty(int b, int h, int r0, int split,
                            const Geometry& g, T* __restrict__ out,
                            float* __restrict__ part_ml) {
  const int TG = g.T * (g.Hq / g.Hkv);
  for (int i = threadIdx.x; i < kRows * g.hd; i += kThreads) {
    const int r = i / g.hd, d = i - r * g.hd, R = r0 + r;
    if (R >= TG) continue;
    const size_t o = row_off(b, h, R, g);
    if (g.splits == 1) {
      out[o + d] = Num<T>::from_f(0.f);
    } else if (d == 0) {
      float* ml = part_ml + (o / g.hd * g.splits + split) * 2;
      ml[0] = kNegInf;
      ml[1] = 0.f;
    }
  }
}

// Row R's result from its (m, l, acc): out (S = 1, zero for a padding
// token) or the split's partials.
template <typename T>
__device__ __forceinline__ void write_row(int b, int h, int R, int d,
                                          int seg, float m, float l,
                                          const float* acc, int n,
                                          int split, const Geometry& g,
                                          T* __restrict__ out,
                                          float* __restrict__ part_acc,
                                          float* __restrict__ part_ml,
                                          bool write_ml) {
  const size_t o = row_off(b, h, R, g);
  if (g.splits == 1) {
    const bool pad = R / (g.Hq / g.Hkv) >= seg;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int k = 0; k < n; ++k)
      out[o + d + k] = Num<T>::from_f(pad ? 0.f : acc[k] * inv);
  } else {
    const size_t p = o / g.hd * g.splits + split;
    for (int k = 0; k < n; ++k) part_acc[p * g.hd + d + k] = acc[k];
    if (write_ml) {
      part_ml[2 * p] = m;
      part_ml[2 * p + 1] = l;
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = kThreads / 32;

// Shared memory: Q (16 rows), then two stages of K and V (fp pools), or
// one K/V tile plus two stages of raw int8 K/V and their scales; rows of
// HD + 8 bf16 (the 16-byte shift keeps ldmatrix conflict-free).  The warps'
// merge scratch reuses the K/V space.
template <int HD, bool INT8>
struct Smem {
  static constexpr int kLd = HD + 8;
  static constexpr uint32_t kQ = kRows * kLd * 2 + 2 * kKeys * 4;  // + tables
  static constexpr uint32_t kTile = kKeys * kLd * 2;         // K or V
  static constexpr uint32_t kRaw = 2 * kKeys * HD + 2 * kKeys * 4;
  static constexpr uint32_t kKV = INT8 ? 2 * kTile + 2 * kRaw : 4 * kTile;
  static constexpr uint32_t kMerge = kWarps * kRows * (HD + 2) * 4;
  static constexpr uint32_t kBytes = kQ + (kKV > kMerge ? kKV : kMerge);
};

// three blocks an SM (shared memory allows three at hd 128): up to 168
// registers, where the compiler's own choice of 128 spilled more
template <typename P, int HD, bool NARROW>
__global__ void __launch_bounds__(kThreads, 3)
    paged_attn_tc_kernel(const bf16* __restrict__ q,
                         const P* __restrict__ kpool,
                         const P* __restrict__ vpool,
                         const float* __restrict__ kscale,
                         const float* __restrict__ vscale,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ lengths,
                         const int* __restrict__ seg_lens,
                         bf16* __restrict__ out, float* __restrict__ part_acc,
                         float* __restrict__ part_ml, Geometry geo) {
  constexpr bool kInt8 = std::is_same_v<P, int8_t>;
  using L = Smem<HD, kInt8>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem);
  const uint32_t qs = sbase, kv = sbase + L::kQ;
  int* tabs = reinterpret_cast<int*>(smem + kRows * L::kLd * 2);  // [2][64]

  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = (blockIdx.z / geo.splits) * kRows;
  const int split = blockIdx.z % geo.splits;
  const int len = lengths[b], seg = seg_lens[b];
  int t_lo, t_hi, js, je;
  tile_tokens(r0, seg, geo, t_lo, t_hi);
  split_keys(len, t_lo, t_hi, geo, split, js, je);
  if (js >= je) {
    write_empty(b, h, r0, split, geo, out, part_ml);
    return;
  }
  const int* bt_row = block_tables + static_cast<size_t>(b) * geo.NB;
  const int TG = geo.T * (geo.Hq / geo.Hkv);

  // Q, rows past T*G and columns past hd zero
  load_q<NARROW>(qs, L::kLd, HD, q, b, h, r0, TG, geo);
  // step k's keys go to ring slot k % 2 through slot table k % 2, which
  // is filled a step ahead
  auto load = [&](int slot) {
    const int* tab = tabs + slot * kKeys;
    if constexpr (kInt8) {
      const uint32_t raw = kv + 2 * L::kTile + slot * L::kRaw;
      load_keys<NARROW>(raw, HD, HD, kpool, tab, h, geo);
      load_keys<NARROW>(raw + kKeys * HD, HD, HD, vpool, tab, h, geo);
      load_scales(raw + 2 * kKeys * HD, kscale, tab, h, geo);
      load_scales(raw + 2 * kKeys * HD + kKeys * 4, vscale, tab, h, geo);
    } else {
      const uint32_t st = kv + slot * 2 * L::kTile;
      load_keys<NARROW>(st, L::kLd, HD, kpool, tab, h, geo);
      load_keys<NARROW>(st + L::kTile, L::kLd, HD, vpool, tab, h, geo);
    }
  };
  slot_table(tabs, bt_row, js, je, geo);
  slot_table(tabs + kKeys, bt_row, js + kKeys, je, geo);
  __syncthreads();
  load(0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int qp[2] = {row_pos(r0 + g, len, seg, geo),
                     row_pos(r0 + g + 8, len, seg, geo)};
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) o[n][v] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  // ldmatrix lane addresses (bytes within a tile of rows of kLd bf16)
  const uint32_t a_q = ((lane & 7) + 8 * ((lane >> 3) & 1)) * L::kLd * 2 +
                       (lane >> 4) * 16;
  const uint32_t a_k =
      (16 * warp + (lane & 7) + 8 * (lane >> 4)) * L::kLd * 2 +
      ((lane >> 3) & 1) * 16;
  const uint32_t a_v =
      (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::kLd * 2 +
      (lane >> 4) * 16;

  const int nsteps = (je - js + kKeys - 1) / kKeys;
  for (int k = 0; k < nsteps; ++k) {
    const int j0 = js + k * kKeys;
    cp_async_wait<0>();
    __syncthreads();   // step k staged; every warp is done with step k - 1
    if (k + 1 < nsteps) load((k + 1) & 1);
    cp_async_commit();
    if (k + 2 < nsteps) slot_table(tabs + (k & 1) * kKeys, bt_row,
                                   j0 + 2 * kKeys, je, geo);
    uint32_t kt, vt;
    if constexpr (kInt8) {
      const uint8_t* raw = smem + L::kQ + 2 * L::kTile + (k & 1) * L::kRaw;
      const float* sc = reinterpret_cast<const float*>(raw + 2 * kKeys * HD);
      bf16* tile = reinterpret_cast<bf16*>(smem + L::kQ);
      dequant_keys<bf16>(tile, L::kLd, reinterpret_cast<const int8_t*>(raw),
                         sc, HD);
      dequant_keys<bf16>(tile + kKeys * L::kLd, L::kLd,
                         reinterpret_cast<const int8_t*>(raw + kKeys * HD),
                         sc + kKeys, HD);
      __syncthreads();
      kt = kv;
      vt = kv + L::kTile;
    } else {
      kt = kv + (k & 1) * 2 * L::kTile;
      vt = kt + L::kTile;
    }

    // S = Q K^T for the warp's 16 keys: two 16 x 8 tiles
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldmatrix_x4(qa, qs + a_q + kk * 32);
      ldmatrix_x4(kb, kt + a_k + kk * 32);
      mma_bf16_16816(s[0], qa, kb[0], kb[1]);
      mma_bf16_16816(s[1], qa, kb[2], kb[3]);
    }
    // mask by select, online softmax per row (rows g and g + 8)
    float mx[2] = {kNegInf, kNegInf};
    bool ok[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = j0 + 16 * warp + 8 * n + 2 * c + (v & 1);
        ok[n][v] = attends(qp[v >> 1], j, je, geo.window);
        s[n][v] = ok[n][v] ? s[n][v] * geo.scale : kNegInf;
        mx[v >> 1] = fmaxf(mx[v >> 1], s[n][v]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      corr[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float p = ok[n][v] ? expf(s[n][v] - m_run[v >> 1]) : 0.f;
        l_run[v >> 1] += p;      // l sums the unrounded p
        s[n][v] = p;
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) o[n][v] *= corr[v >> 1];
    // O += P V: P (rounded to bf16) is already the A fragment
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + a_v + n * 32);
      mma_bf16_16816(o[2 * n], pa, vb[0], vb[1]);
      mma_bf16_16816(o[2 * n + 1], pa, vb[2], vb[3]);
    }
  }

  // merge the four warps' states: rows of (acc[HD], m, l) per warp
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the K/V tiles
  float* merge = reinterpret_cast<float*>(smem + L::kQ);
  auto mrow = [&](int w, int r) { return merge + (w * kRows + r) * (HD + 2); };
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(mrow(warp, g + 8 * i) + 8 * n + 2 * c) =
          make_float2(o[n][2 * i], o[n][2 * i + 1]);
  if (c == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mrow(warp, g + 8 * i)[HD] = m_run[i];
      mrow(warp, g + 8 * i)[HD + 1] = l_run[i];
    }
  __syncthreads();
  // thread: row tid / 8, columns 8 (tid % 8) + 64 n .. + 7 within hd
  const int r = threadIdx.x >> 3, R = r0 + r;
  if (R >= TG) return;
  float m = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, mrow(w, r)[HD]);
  float e[kWarps], l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    e[w] = expf(mrow(w, r)[HD] - m);
    l += e[w] * mrow(w, r)[HD + 1];
  }
  for (int d = 8 * (threadIdx.x & 7); d < geo.hd; d += 64) {
    float acc[8];
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) {
      acc[k2] = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc[k2] += e[w] * mrow(w, r)[d + k2];
    }
    // a ragged last group only where hd is not a multiple of 8 (a NARROW
    // kernel: q's bf16 rows take no 16-byte copy then)
    if (!NARROW || d + 8 <= geo.hd)
      write_row(b, h, R, d, seg, m, l, acc, 8, split, geo, out, part_acc,
                part_ml, d == 0);
    else
      write_row(b, h, R, d, seg, m, l, acc, geo.hd - d, split, geo, out,
                part_acc, part_ml, d == 0);
  }
}

template <typename P, int HD, bool NARROW>
int launch_hd(const void* q, const void* kpool, const void* vpool,
              const void* kscale, const void* vscale, const void* bt,
              const void* lengths, const void* seg_lens, void* out,
              void* part_acc, void* part_ml, int B, const Geometry& geo,
              cudaStream_t stream) {
  constexpr size_t smem = Smem<HD, std::is_same_v<P, int8_t>>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_tc_kernel<P, HD, NARROW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int TG = geo.T * (geo.Hq / geo.Hkv);
  const dim3 grid(B, geo.Hkv, (TG + kRows - 1) / kRows * geo.splits);
  paged_attn_tc_kernel<P, HD, NARROW><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const P*>(kpool),
      static_cast<const P*>(vpool), static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<const int*>(seg_lens),
      static_cast<bf16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), geo);
  return static_cast<int>(cudaGetLastError());
}

// A narrow head dim runs on the 256-wide NARROW kernel whatever its
// width (one instantiation a pool type, so the build stays short); the
// others on the smallest width that covers them.
template <typename P>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* kscale, const void* vscale, const void* bt,
           const void* lengths, const void* seg_lens, void* out,
           void* part_acc, void* part_ml, int B, const Geometry& geo,
           cudaStream_t stream) {
  if (narrow(geo.hd, sizeof(bf16), sizeof(P)))
    return launch_hd<P, 256, true>(q, kpool, vpool, kscale, vscale, bt,
                                   lengths, seg_lens, out, part_acc, part_ml,
                                   B, geo, stream);
  if (geo.hd <= 64)
    return launch_hd<P, 64, false>(q, kpool, vpool, kscale, vscale, bt,
                                   lengths, seg_lens, out, part_acc, part_ml,
                                   B, geo, stream);
  if (geo.hd <= 128)
    return launch_hd<P, 128, false>(q, kpool, vpool, kscale, vscale, bt,
                                    lengths, seg_lens, out, part_acc, part_ml,
                                    B, geo, stream);
  return launch_hd<P, 256, false>(q, kpool, vpool, kscale, vscale, bt,
                                  lengths, seg_lens, out, part_acc, part_ml,
                                  B, geo, stream);
}

}  // namespace tc


// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kMaxVec = 8;   // float4s of a row a lane owns: hd <= 256

// The staged width of a row: hd rounded up to 16 (the int8 dequantize
// reads 16 payload bytes at a time), its dims past hd zero.
__host__ __device__ __forceinline__ int width(int hd) {
  return (hd + 15) / 16 * 16;
}

// Shared memory (floats): Q (16 rows), then ``stages`` stages of K and V
// (fp pools), or one K/V tile plus two stages of raw int8 K/V and their
// scales; rows of width(hd) + 4 floats (conflict-free float4 reads).
struct Layout {
  int ld, stages;
  size_t q, tile, raw, bytes;
  Layout(int hd, bool int8) : ld(width(hd) + 4) {
    q = static_cast<size_t>(kRows) * ld * 4 + 2 * kKeys * 4;  // + tables
    tile = static_cast<size_t>(kKeys) * ld * 4;
    raw = 2 * static_cast<size_t>(kKeys) * width(hd) + 2 * kKeys * 4;
    stages = int8 || q + 4 * tile <= 232448 ? 2 : 1;
    bytes = q + (int8 ? 2 * tile + 2 * raw : 2 * stages * tile);
  }
};

template <typename P, bool NARROW>
__global__ void __launch_bounds__(kThreads)
    paged_attn_f32_kernel(const float* __restrict__ q,
                          const P* __restrict__ kpool,
                          const P* __restrict__ vpool,
                          const float* __restrict__ kscale,
                          const float* __restrict__ vscale,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ lengths,
                          const int* __restrict__ seg_lens,
                          float* __restrict__ out,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, Geometry geo,
                          int stages) {
  constexpr bool kInt8 = std::is_same_v<P, int8_t>;
  extern __shared__ __align__(16) float fsm[];
  const int wd = width(geo.hd), ld = wd + 4;
  const size_t tile = static_cast<size_t>(kKeys) * ld;   // floats
  int* tabs = reinterpret_cast<int*>(fsm);              // [2][64] slots
  float* qs = fsm + 2 * kKeys;
  float* kvs = qs + kRows * ld;
  const uint32_t qs_u = smem_u32(qs), kv_u = smem_u32(kvs);

  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = (blockIdx.z / geo.splits) * kRows;
  const int split = blockIdx.z % geo.splits;
  const int len = lengths[b], seg = seg_lens[b];
  int t_lo, t_hi, js, je;
  tile_tokens(r0, seg, geo, t_lo, t_hi);
  split_keys(len, t_lo, t_hi, geo, split, js, je);
  if (js >= je) {
    write_empty(b, h, r0, split, geo, out, part_ml);
    return;
  }
  const int* bt_row = block_tables + static_cast<size_t>(b) * geo.NB;
  const int TG = geo.T * (geo.Hq / geo.Hkv);

  load_q<NARROW>(qs_u, ld, wd, q, b, h, r0, TG, geo);
  const size_t raw_bytes = 2 * static_cast<size_t>(kKeys) * wd + 2 * kKeys * 4;
  // step k's keys go to ring slot ``slot`` through slot table k % 2
  auto load = [&](int k, int slot) {
    const int* tab = tabs + (k & 1) * kKeys;
    if constexpr (kInt8) {
      const uint32_t raw = kv_u + 2 * tile * 4 + slot * raw_bytes;
      load_keys<NARROW>(raw, wd, wd, kpool, tab, h, geo);
      load_keys<NARROW>(raw + kKeys * wd, wd, wd, vpool, tab, h, geo);
      load_scales(raw + 2 * kKeys * wd, kscale, tab, h, geo);
      load_scales(raw + 2 * kKeys * wd + kKeys * 4, vscale, tab, h, geo);
    } else {
      const uint32_t st = kv_u + slot * 2 * tile * 4;
      load_keys<NARROW>(st, ld, wd, kpool, tab, h, geo);
      load_keys<NARROW>(st + tile * 4, ld, wd, vpool, tab, h, geo);
    }
  };
  slot_table(tabs, bt_row, js, je, geo);
  slot_table(tabs + kKeys, bt_row, js + kKeys, je, geo);
  __syncthreads();
  load(0, 0);
  cp_async_commit();

  // lane group of 8 per row: row tid / 8; keys sub + 8 i; float4s sub + 8 n
  const int r = threadIdx.x >> 3, sub = threadIdx.x & 7, R = r0 + r;
  const int qp = row_pos(R, len, seg, geo);
  const int nvec = wd / 4;
  float4 acc[kMaxVec];
#pragma unroll
  for (int n = 0; n < kMaxVec; ++n) acc[n] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_run = kNegInf, l_run = 0.f;
  const unsigned group = 0xFFu << (threadIdx.x & 24);

  const int nsteps = (je - js + kKeys - 1) / kKeys;
  for (int k = 0; k < nsteps; ++k) {
    const int j0 = js + k * kKeys;
    const int slot = stages == 2 ? k & 1 : 0;
    cp_async_wait<0>();
    __syncthreads();   // step k staged; every warp is done with step k - 1
    if (stages == 2 && k + 1 < nsteps) load(k + 1, slot ^ 1);
    cp_async_commit();
    if (k + 2 < nsteps) slot_table(tabs + (k & 1) * kKeys, bt_row,
                                   j0 + 2 * kKeys, je, geo);
    const float *kt, *vt;
    if constexpr (kInt8) {
      const uint8_t* raw = reinterpret_cast<const uint8_t*>(kvs + 2 * tile) +
                           slot * raw_bytes;
      const float* sc = reinterpret_cast<const float*>(raw + 2 * kKeys * wd);
      dequant_keys<float>(kvs, ld, reinterpret_cast<const int8_t*>(raw), sc,
                          wd);
      dequant_keys<float>(kvs + tile, ld,
                          reinterpret_cast<const int8_t*>(raw + kKeys * wd),
                          sc + kKeys, wd);
      __syncthreads();
      kt = kvs;
      vt = kvs + tile;
    } else {
      kt = kvs + slot * 2 * tile;
      vt = kt + tile;
    }
    float s[8] = {};
    const float* qr = qs + r * ld;
    for (int d4 = 0; d4 < nvec; ++d4) {
      const float4 qv = reinterpret_cast<const float4*>(qr)[d4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 kv4 =
            reinterpret_cast<const float4*>(kt + (sub + 8 * i) * ld)[d4];
        s[i] = fmaf(qv.x, kv4.x, s[i]);
        s[i] = fmaf(qv.y, kv4.y, s[i]);
        s[i] = fmaf(qv.z, kv4.z, s[i]);
        s[i] = fmaf(qv.w, kv4.w, s[i]);
      }
    }
    float mx = kNegInf;
    bool ok[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ok[i] = attends(qp, j0 + sub + 8 * i, je, geo.window);
      s[i] = ok[i] ? s[i] * geo.scale : kNegInf;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int x = 1; x < 8; x <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(group, mx, x, 8));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    m_run = m_new;
    l_run *= corr;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] = ok[i] ? expf(s[i] - m_new) : 0.f;
      l_run += s[i];
    }
#pragma unroll
    for (int n = 0; n < kMaxVec; ++n) {
      acc[n].x *= corr;
      acc[n].y *= corr;
      acc[n].z *= corr;
      acc[n].w *= corr;
    }
#pragma unroll
    for (int key = 0; key < kKeys; ++key) {
      const float p = __shfl_sync(group, s[key >> 3], key & 7, 8);
      const float4* vr = reinterpret_cast<const float4*>(vt + key * ld);
#pragma unroll
      for (int n = 0; n < kMaxVec; ++n) {
        const int d4 = sub + 8 * n;
        if (d4 < nvec) {
          const float4 v4 = vr[d4];
          acc[n].x = fmaf(p, v4.x, acc[n].x);
          acc[n].y = fmaf(p, v4.y, acc[n].y);
          acc[n].z = fmaf(p, v4.z, acc[n].z);
          acc[n].w = fmaf(p, v4.w, acc[n].w);
        }
      }
    }
    if (stages == 1 && k + 1 < nsteps) {
      __syncthreads();
      load(k + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int x = 1; x < 8; x <<= 1)
    l_run += __shfl_xor_sync(group, l_run, x, 8);
  if (R >= TG) return;
#pragma unroll
  for (int n = 0; n < kMaxVec; ++n) {
    const int d4 = sub + 8 * n;
    if (4 * d4 < geo.hd) {
      const float a[4] = {acc[n].x, acc[n].y, acc[n].z, acc[n].w};
      // a ragged last group only where hd is not a multiple of 4 (a NARROW
      // kernel: q's fp32 rows take no 16-byte copy then)
      if (!NARROW || 4 * d4 + 4 <= geo.hd)
        write_row(b, h, R, 4 * d4, seg, m_run, l_run, a, 4, split, geo, out,
                  part_acc, part_ml, d4 == 0);
      else
        write_row(b, h, R, 4 * d4, seg, m_run, l_run, a, geo.hd - 4 * d4,
                  split, geo, out, part_acc, part_ml, d4 == 0);
    }
  }
}

template <typename P, bool NARROW>
int launch_n(const void* q, const void* kpool, const void* vpool,
             const void* kscale, const void* vscale, const void* bt,
             const void* lengths, const void* seg_lens, void* out,
             void* part_acc, void* part_ml, int B, const Geometry& geo,
             cudaStream_t stream) {
  const Layout lay(geo.hd, std::is_same_v<P, int8_t>);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_f32_kernel<P, NARROW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int TG = geo.T * (geo.Hq / geo.Hkv);
  const dim3 grid(B, geo.Hkv, (TG + kRows - 1) / kRows * geo.splits);
  paged_attn_f32_kernel<P, NARROW><<<grid, kThreads, lay.bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const P*>(kpool),
      static_cast<const P*>(vpool), static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<const int*>(seg_lens),
      static_cast<float*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), geo, lay.stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* kscale, const void* vscale, const void* bt,
           const void* lengths, const void* seg_lens, void* out,
           void* part_acc, void* part_ml, int B, const Geometry& geo,
           cudaStream_t stream) {
  if (narrow(geo.hd, sizeof(float), sizeof(P)))
    return launch_n<P, true>(q, kpool, vpool, kscale, vscale, bt, lengths,
                             seg_lens, out, part_acc, part_ml, B, geo,
                             stream);
  return launch_n<P, false>(q, kpool, vpool, kscale, vscale, bt, lengths,
                            seg_lens, out, part_acc, part_ml, B, geo, stream);
}

}  // namespace f32


// ---------------------------------------------------------------------------
// the split combine: one block per (b, t, q head), a thread per column
// ---------------------------------------------------------------------------

constexpr int kMaxSplits = 64;   // paged_attn.py::MAX_SPLITS

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml,
                         const int* __restrict__ seg_lens,
                         T* __restrict__ out, int T_, int Hq, int hd, int S) {
  const int row = blockIdx.x;
  T* o = out + static_cast<size_t>(row) * hd;
  if (row / Hq % T_ >= seg_lens[row / (T_ * Hq)]) {
    for (int d = threadIdx.x; d < hd; d += kThreads) o[d] = Num<T>::from_f(0.f);
    return;
  }
  const float* ml = part_ml + static_cast<size_t>(row) * S * 2;
  const float* acc = part_acc + static_cast<size_t>(row) * S * hd;
  float m = kNegInf;
  for (int s = 0; s < S; ++s)
    if (ml[2 * s + 1] > 0.f) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, a[2] = {0.f, 0.f};      // hd <= 2 * kThreads
  for (int s = 0; s < S; ++s) {
    const float ls = ml[2 * s + 1];
    if (ls > 0.f) {                      // splits that attended something
      const float w = expf(ml[2 * s] - m);
      l += w * ls;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = threadIdx.x + i * kThreads;
        if (d < hd) a[i] = fmaf(w, acc[static_cast<size_t>(s) * hd + d], a[i]);
      }
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int d = threadIdx.x + i * kThreads;
    if (d < hd) o[d] = Num<T>::from_f(a[i] * inv);
  }
}

template <typename T>
int combine(const void* part_acc, const void* part_ml, const void* seg_lens,
            void* out, int B, const Geometry& geo, cudaStream_t stream) {
  paged_combine_kernel<T><<<B * geo.T * geo.Hq, kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(seg_lens), static_cast<T*>(out), geo.T, geo.Hq,
      geo.hd, geo.splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int run(const void* q, const void* kpool, const void* vpool,
        const void* kscale, const void* vscale, const void* bt,
        const void* lengths, const void* seg_lens, void* out, void* part_acc,
        void* part_ml, int B, const Geometry& geo, void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (geo.hd < 1 || geo.hd > 256 || geo.splits < 1 ||
      geo.splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if constexpr (std::is_same_v<T, float>)
    err = f32::launch<P>(q, kpool, vpool, kscale, vscale, bt, lengths,
                         seg_lens, out, part_acc, part_ml, B, geo, stream);
  else
    err = tc::launch<P>(q, kpool, vpool, kscale, vscale, bt, lengths,
                        seg_lens, out, part_acc, part_ml, B, geo, stream);
  if (err != 0 || geo.splits == 1) return err;
  return combine<T>(part_acc, part_ml, seg_lens, out, B, geo, stream);
}

}  // namespace

// part_acc (B, T, Hq, S, hd) and part_ml (B, T, Hq, S, 2) fp32: the split
// partials (unused, may be null, when splits == 1)
#define PAGED_ATTN_ENTRY(NAME, TYPE, POOL)                                    \
  extern "C" int NAME(const void* q, const void* kpool, const void* vpool,   \
                      const void* block_tables, const void* lengths,         \
                      const void* seg_lens, void* out, void* part_acc,       \
                      void* part_ml, int B, int T, int Hq, int Hkv, int hd,  \
                      int P, int ps, int NB, int window, int splits,         \
                      float scale, void* stream) {                           \
    const Geometry geo{T, Hq, Hkv, hd, P, ps, NB, window, splits, scale};    \
    return run<TYPE, POOL>(q, kpool, vpool, nullptr, nullptr, block_tables,  \
                           lengths, seg_lens, out, part_acc, part_ml, B,     \
                           geo, stream);                                     \
  }

// int8 pools: the fp32 scale pools (P, ps, Hkv, 1) follow the payload pools
#define PAGED_ATTN_INT8_ENTRY(NAME, TYPE)                                     \
  extern "C" int NAME(const void* q, const void* kpool, const void* vpool,   \
                      const void* kscale, const void* vscale,                \
                      const void* block_tables, const void* lengths,         \
                      const void* seg_lens, void* out, void* part_acc,       \
                      void* part_ml, int B, int T, int Hq, int Hkv, int hd,  \
                      int P, int ps, int NB, int window, int splits,         \
                      float scale, void* stream) {                           \
    const Geometry geo{T, Hq, Hkv, hd, P, ps, NB, window, splits, scale};    \
    return run<TYPE, int8_t>(q, kpool, vpool, kscale, vscale, block_tables,  \
                             lengths, seg_lens, out, part_acc, part_ml, B,   \
                             geo, stream);                                   \
  }

PAGED_ATTN_ENTRY(paged_attention_f32, float, float)
PAGED_ATTN_ENTRY(paged_attention_bf16, __nv_bfloat16, __nv_bfloat16)
PAGED_ATTN_INT8_ENTRY(paged_attention_int8_f32, float)
PAGED_ATTN_INT8_ENTRY(paged_attention_int8_bf16, __nv_bfloat16)
