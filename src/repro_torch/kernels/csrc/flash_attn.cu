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
// against 50 MB of q/k/v/out, far above the card's ridge.  This first
// kernel runs the two products on the CUDA cores in fp32 FMA (both types;
// fp32 inputs must not go through TF32), so it is held to the fp32 FMA
// rate, not the bf16 tensor-core peak; wgmma with TMA is later work.
// The design:
//   * one block per (64 grouped query rows, kv head, batch row); grouped
//     row r is (position r / G, query head h*G + r % G), G = Hq / Hkv, so
//     each K/V tile is staged once for all G query heads that read it;
//   * the block loops over 64-key tiles from the first key its rows'
//     window reaches to its last row's diagonal, skipping the tiles wholly
//     above the diagonal or wholly at or below i - w (exact: such a tile
//     leaves m, l and acc unchanged); blocks start with the longest rows;
//   * q (once) and each K tile are staged transposed in shared memory as
//     fp32 ([hd][64 + 4]), V as [64][hd]; 256 threads form a 16 x 16 grid,
//     each owning a 4 x 4 tile of logits and a 4 x hd/16 tile of the fp32
//     accumulator, read with 16-byte shared loads; row max and row sum are
//     reduced across the 16 threads of a row with warp shuffles;
//   * keys at or beyond S (the ragged last tile) are masked whatever
//     causal is, and rows at or beyond S are neither computed nor written.
// Rounding follows the reference (_kernel): logits are an fp32 dot times
// hd^-0.5, masked logits are -1e30, p = exp(logit - m_new) with masked p
// forced to 0, l sums the unrounded p, P.V uses p rounded to V's type with
// fp32 accumulation, and out = acc / max(l, 1e-30) in q's type.  The
// rounded p depends on each tile's running max, so bf16 agrees with the
// dense oracle (which rounds normalised probabilities) only to bf16
// tolerance.
#include "common.cuh"

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

struct Geometry {
  int S, Hq, Hkv, causal, window;
  float scale;
};

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
    if (row < rows_total) {
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
      if (key < geo.S) {
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
#pragma unroll
        for (int c4 = 0; c4 < kDims / 4; ++c4) {
          const float4 t = ld4(vs + (j + jj) * HD + c4 * 64 + tx * 4);
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
                  h * G + g) * HD;
    const float l = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c4 = 0; c4 < kDims / 4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[c4 * 64 + tx * 4 + e] = Num<T>::from_f(acc[i][c4 * 4 + e] / l);
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

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const Strides& st, int B, int hd, const Geometry& geo,
             void* stream) {
  if (hd == 64) return launch<T, 64>(q, k, v, out, st, B, geo, stream);
  if (hd == 128) return launch<T, 128>(q, k, v, out, st, B, geo, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Strides are in elements; the head dim of q, k and v is contiguous.
// window <= 0 means no window.
#define FLASH_ATTN_ENTRY(NAME, TYPE)                                          \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* out, \
                      long long q_b, long long q_s, long long q_h,            \
                      long long k_b, long long k_s, long long k_h,            \
                      long long v_b, long long v_s, long long v_h, int B,     \
                      int S, int Hq, int Hkv, int hd, int causal, int window, \
                      float scale, void* stream) {                            \
    const Strides st{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h};            \
    const Geometry geo{S, Hq, Hkv, causal, window, scale};                    \
    return dispatch<TYPE>(q, k, v, out, st, B, hd, geo, stream);              \
  }

FLASH_ATTN_ENTRY(flash_attention_f32, float)
FLASH_ATTN_ENTRY(flash_attention_bf16, __nv_bfloat16)
