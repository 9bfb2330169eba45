// Online-softmax (flash) attention, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:31 ::_kernel (the Pallas
// TPU kernel launched by flash_attention).  Same function: for every
// (batch, head, query row) the softmax over the visible keys of
// scale * q . k, applied to V, with GQA (kv head = h / (H / HKV)), causal
// masking and an optional sliding window on TOP-LEFT aligned positions
// (query row r of the sequence is at position r, key c at position c):
// visible iff c < Sk, (!causal || r >= c) and (!window || c > r - window).
// Masked scores are -1e30, p = mask ? exp(s - m_new) : 0, and the output
// is acc / max(l, 1e-30), so a row that sees no key is 0.  Inputs are f32
// or bf16; every score, softmax and PV operation is f32, as in the Pallas
// body; the output takes q's type.
//
// What bounds it on this card: at full width (32k-token prefill, 8k-token
// local and GQA attention) the work is 4*D operations per visible (query,
// key) pair per head against 2*D*(Sq + 2*Sk) bytes per head, hundreds of
// operations per byte: operations bound the function.  The card's bound
// is the bf16 tensor-core rate; this kernel uses the CUDA cores' f32 FMA
// instead, which caps it far below that bound.
//
// What this simple design does about it:
//  * One block owns one (batch, head, 64-row query tile).  The TPU grid
//    walked the kv blocks as a sequential axis with m, l and acc in VMEM
//    scratch; here the block loops over the kv tiles itself and keeps m,
//    l and acc in registers.  No cross-block reduction.
//  * Only live kv tiles are visited: tiles entirely in the future (causal)
//    or entirely expired (window) are skipped, which is exact, since a
//    fully masked tile leaves m, l and acc as they were.
//  * Scaled Q (transposed), then K (transposed) and V of each kv tile are
//    staged in shared memory as f32; 256 threads each compute a 4x4 block
//    of scores with float4 shared loads and 16 FMAs per head-dim step,
//    and a 4 x (D/16) block of the output.  K and V share one buffer, so
//    a 128-wide head fits two blocks per SM.
//  * The head dim is a template bucket (64, 128, 256), zero-filled past
//    D: D needs no padding in memory and D = 256 (recurrentgemma) fits.
//    Above 48 KB the shared memory is dynamic (cudaFuncSetAttribute).
// bf16 tensor-core MMA (mma.sync / wgmma), TMA, a pipeline of kv tiles and
// warp specialisation are left for later work.
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int QS = BQ + 4;      // row stride of qT and pT (float4-aligned)
constexpr int KS = BK + 4;      // row stride of kT (float4-aligned)
constexpr float NEG = -1e30f;

struct Params {
  const void* q;    // [B, H, Sq, D]
  const void* k;    // [B, HKV, Sk, D]
  const void* v;    // [B, HKV, Sk, D]
  void* o;          // [B, H, Sq, D]
  int B, H, HKV, Sq, Sk, D;
  float scale;
  int causal, has_window, window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DP>
constexpr size_t smem_bytes() {
  // qT [DP][QS] + kv [DP][KS] (kT, then V as [BK][DP]) + pT [BK][QS]
  return sizeof(float) * ((size_t)DP * QS + (size_t)DP * KS + (size_t)BK * QS);
}

// rows [row0, row0 + R) of a [rows, D] matrix, times `mul`, into
// dst[d * stride + r], zero past D and past `nrows`.  A warp covers 8 head
// dims x 4 rows, so its stores hit 32 distinct banks (stride = 4 mod 32).
template <typename T, int DP, int R>
__device__ __forceinline__ void load_transposed(float* dst, int stride,
                                                const T* src, int row0,
                                                int nrows, int D, float mul) {
  constexpr int GROUPS = (DP / 8) * (R / 4);
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < GROUPS; g += THREADS / 32) {
    const int d = (g % (DP / 8)) * 8 + (lane & 7);
    const int r = (g / (DP / 8)) * 4 + (lane >> 3);
    const int row = row0 + r;
    float x = 0.f;
    if (d < D && row < nrows) x = to_f(src[(size_t)row * D + d]) * mul;
    dst[d * stride + r] = x;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const Params p) {
  constexpr int DT = DP / 64;   // float4 column groups per thread in PV
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [DP][QS]
  float* kv = qT + DP * QS;                      // [DP][KS] | [BK][DP]
  float* pT = kv + DP * KS;                      // [BK][QS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.HKV);
  const int q0 = blockIdx.x * BQ;
  const size_t q_off = ((size_t)b * p.H + h) * p.Sq * p.D;
  const size_t kv_off = ((size_t)b * p.HKV + hk) * p.Sk * p.D;
  const T* Q = static_cast<const T*>(p.q) + q_off;
  const T* K = static_cast<const T*>(p.k) + kv_off;
  const T* V = static_cast<const T*>(p.v) + kv_off;
  T* O = static_cast<T*>(p.o) + q_off;

  load_transposed<T, DP, BQ>(qT, QS, Q, q0, p.Sq, p.D, p.scale);

  // live kv tiles: causal drops tiles past the tile's last query, the
  // window drops tiles before its first query's first visible key
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int j_begin = 0, j_end = (p.Sk + BK - 1) / BK;
  if (p.causal) j_end = min(j_end, q_last / BK + 1);
  if (p.has_window) {
    const long long lo = (long long)q0 - p.window + 1;
    if (lo > 0) j_begin = (int)(lo / BK);
  }

  float m[4], l[4], acc[4][DT * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT * 4; ++c) acc[i][c] = 0.f;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // the last tile's reads of kv and pT are done
    load_transposed<T, DP, BK>(kv, KS, K, k0, p.Sk, p.D, 1.f);
    __syncthreads();

    // scores of rows ty*4+i, keys tx*4+jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < p.D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * QS + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kv + d * KS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(av[i], cv[jj], s[i][jj]);
    }

    // mask, then the online-softmax update of m, l and acc
    bool vis[4][4];
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      mx[i] = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = k0 + tx * 4 + jj;
        bool ok = kj < p.Sk;
        if (p.causal) ok = ok && qi >= kj;
        if (p.has_window) ok = ok && kj > qi - p.window;
        vis[i][jj] = ok;
        s[i][jj] = ok ? s[i][jj] : NEG;
        mx[i] = fmaxf(mx[i], s[i][jj]);
      }
    }
    // a row's 16 column threads are the 16 lanes of one half warp
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    float alpha[4], rs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      rs[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = vis[i][jj] ? expf(s[i][jj] - m_new) : 0.f;
        rs[i] += s[i][jj];
      }
      m[i] = m_new;
    }
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = alpha[i] * l[i] + rs[i];
#pragma unroll
      for (int c = 0; c < DT * 4; ++c) acc[i][c] *= alpha[i];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(pT + (tx * 4 + jj) * QS + ty * 4) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    __syncthreads();   // every thread is done with kT; pT is complete

    // V of the tile, natural layout [BK][DP], over the kT buffer
    for (int e = tid; e < BK * DP; e += THREADS) {
      const int r = e / DP, d = e % DP, row = k0 + r;
      kv[e] = (d < p.D && row < p.Sk) ? to_f(V[(size_t)row * p.D + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pT + c * QS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const float4 w =
            *reinterpret_cast<const float4*>(kv + c * DP + t * 64 + tx * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][t * 4 + jj] = fmaf(av[i], wv[jj], acc[i][t * 4 + jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int t = 0; t < DT; ++t)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = t * 64 + tx * 4 + jj;
        if (d < p.D) store(O + (size_t)row * p.D + d, acc[i][t * 4 + jj] / den);
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_attention_kernel<T, DP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  if (p.D <= 256) return launch<T, 256>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int HKV, int Sq, int Sk, int D, float scale,
    int causal, int has_window, int window, int bf16, void* stream) {
  if (B <= 0 || H <= 0 || HKV <= 0 || Sq <= 0 || D <= 0 || Sk < 0 ||
      H % HKV != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.H = H; p.HKV = HKV; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.scale = scale;
  p.causal = causal; p.has_window = has_window; p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_d<__nv_bfloat16>(p, s) : launch_d<float>(p, s));
}
