// Online-softmax (flash) attention, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:31 ::_kernel (the Pallas
// TPU kernel launched by flash_attention).  Same function: for every
// (batch, head, query row) the softmax over the visible keys of
// scale * q . k, applied to V, with GQA (kv head = h / (H / HKV)), causal
// masking and an optional sliding window on TOP-LEFT aligned positions
// (query row r of the sequence is at position r, key c at position c):
// visible iff c < Sk, (!causal || r >= c) and (!window || c > r - window).
// Masked scores drop out (p = 0), the running max starts at -1e30 and the
// output is acc / max(l, 1e-30), so a row that sees no key is 0.  Inputs
// are f32 or bf16, all alike; the output takes q's type.
//
// What bounds it on this card: at full width (32k-token prefill, 8k-token
// local and GQA attention) the work is 4*D operations per visible (query,
// key) pair per head against 2*D*(Sq + 2*Sk) bytes per head, hundreds of
// operations per byte: operations bound the function, at the bf16
// tensor-core rate (989 TFLOP/s dense).
//
// bf16 inputs: flash_bf16_kernel, FlashAttention-2 on mma.sync.
//  * One block owns one (batch, head, 64-row query tile): 4 warps of 16
//    query rows.  Blocks start with the last query tiles, which see the
//    most keys under a causal mask, so the long blocks do not trail.
//  * S = Q K^T on mma.sync.m16n8k16 bf16 -> f32, fragments by ldmatrix
//    from shared memory.  The bf16 products are exact in f32; `scale` is
//    applied to the f32 scores, which differs from scaling q first by f32
//    rounding only.
//  * The online softmax runs on the accumulator fragments in registers:
//    row max by two quad shuffles, exp in f32, each thread's share of the
//    row sum kept apart and reduced once at the end.
//  * O += P V on mma.sync with ldmatrix.trans for V.  P is fed as a hi/lo
//    pair, p_hi = bf16(p) and p_lo = bf16(p - p_hi), two products into
//    the same f32 accumulator: about 16 mantissa bits of p.  One bf16
//    rounding of p would leave the output up to about 2^-9 off, which
//    is as large as the one-bf16-ulp limit the plain version holds it to.
//  * K and V tiles arrive by cp.async (16 bytes a thread) in a ring of
//    two stages, so the next tile's copy runs under this tile's MMAs.
//    Rows are padded by 16 bytes, which makes every ldmatrix phase hit
//    eight distinct 16-byte bank groups.  Rows past Sk and head dims past
//    D are zero-filled by the copy itself.
//  * Only live kv tiles are visited: tiles entirely in the future (causal)
//    or entirely expired (window) are skipped, which is exact, since a
//    fully masked tile leaves m, l and acc as they were.  Only tiles that
//    cross a mask edge or Sk test each element.
//  * Head-dim buckets 64 / 128 / 256, zero-filled past D.  D = 256 keeps
//    a 128-float accumulator a thread and takes 32-key tiles, so its
//    registers stay below the limit without spills.
//
// f32 inputs: flash_f32_kernel, f32 FMA on the CUDA cores.  TF32 tensor
// cores would not hold f32's 2e-5 tolerance.  One block per (batch, head,
// 64-row query tile) of 256 threads, each owning a 4x4 block of scores and
// a 4 x (D/16) block of the output; scaled Q and K staged transposed in
// shared memory, K and V sharing one buffer.
//
// wgmma, TMA and warp specialisation are the next redesign's work.
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;

struct Params {
  const void* q;    // [B, H, Sq, D]
  const void* k;    // [B, HKV, Sk, D]
  const void* v;    // [B, HKV, Sk, D]
  void* o;          // [B, H, Sq, D]
  int B, H, HKV, Sq, Sk, D;
  float scale;
  int causal, has_window, window, vec;
};

// Live kv tiles [j_begin, j_end) of a query tile starting at q0.
template <int BQ, int BK>
__device__ __forceinline__ void live_tiles(const Params& p, int q0,
                                           int& j_begin, int& j_end) {
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  j_begin = 0;
  j_end = (p.Sk + BK - 1) / BK;
  if (p.causal) j_end = min(j_end, q_last / BK + 1);
  if (p.has_window) {
    const long long lo = (long long)q0 - p.window + 1;
    if (lo > 0) j_begin = (int)min(lo / BK, (long long)j_end);
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  bool ok = kj < p.Sk;
  if (p.causal) ok = ok && qi >= kj;
  if (p.has_window) ok = ok && kj > qi - p.window;
  return ok;
}

// ------------------------------------------------------------ bf16 path

constexpr int BQ16 = 64;        // query rows per block
constexpr int WARPS16 = 4;      // 16 query rows each

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + R) of a [nrows, D] bf16 matrix into dst[R][ST],
// zero past nrows and past D (DP columns in all).  vec: D % 8 == 0 and a
// 16-byte aligned base, so each 8-column chunk is one cp.async.
template <int DP, int R, int ST>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, const Params& p) {
  constexpr int CH = DP / 8;
  if (p.vec) {
    for (int i = threadIdx.x; i < R * CH; i += WARPS16 * 32) {
      const int r = i / CH, c = i % CH, row = row0 + r;
      const bool live = row < nrows && c * 8 < p.D;
      const __nv_bfloat16* s = live ? src + (size_t)row * p.D + c * 8 : src;
      cp_async16(dst + r * ST + c * 8, s, live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += WARPS16 * 32) {
      const int r = i / DP, d = i % DP, row = row0 + r;
      dst[r * ST + d] = (row < nrows && d < p.D)
                            ? src[(size_t)row * p.D + d]
                            : __float2bfloat16_rn(0.f);
    }
  }
}

template <int DP, int BK>
constexpr size_t smem_bf16() {
  // Q [BQ][ST] + K [2][BK][ST] + V [2][BK][ST], ST = DP + 8
  return sizeof(__nv_bfloat16) * (DP + 8) * ((size_t)BQ16 + 4 * BK);
}

template <int DP, int BK>
__global__ void __launch_bounds__(WARPS16 * 32)
flash_bf16_kernel(const Params p) {
  constexpr int ST = DP + 8;     // padded row stride (bf16)
  constexpr int NT = BK / 8;     // score n-tiles per warp
  constexpr int DT = DP / 8;     // output n-tiles per warp
  extern __shared__ uint4 smem4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sK = sQ + BQ16 * ST;        // [2][BK][ST]
  __nv_bfloat16* sV = sK + 2 * BK * ST;      // [2][BK][ST]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.HKV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ16;
  const size_t q_off = ((size_t)b * p.H + h) * p.Sq * p.D;
  const size_t kv_off = ((size_t)b * p.HKV + hk) * p.Sk * p.D;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + q_off;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + q_off;

  int j_begin, j_end;
  live_tiles<BQ16, BK>(p, q0, j_begin, j_end);

  load_tile<DP, BQ16, ST>(sQ, Q, q0, p.Sq, p);
  if (j_begin < j_end) {
    load_tile<DP, BK, ST>(sK, K, j_begin * BK, p.Sk, p);
    load_tile<DP, BK, ST>(sV, V, j_begin * BK, p.Sk, p);
  }
  cp_async_commit();

  // rows r0 = q0 + warp*16 + g and r0 + 8 of this thread's fragments
  const int r0 = q0 + warp * 16 + g;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix lane addresses: matrix mat = lane / 8, its row lane % 8
  const int mat = lane >> 3, mrow = lane & 7;
  const __nv_bfloat16* qa =
      sQ + (warp * 16 + mrow + (mat & 1) * 8) * ST + (mat >> 1) * 8;
  const int k_row = mrow + (mat >> 1) * 8, k_col = (mat & 1) * 8;
  const int v_row = mrow + (mat & 1) * 8, v_col = (mat >> 1) * 8;

  for (int j = j_begin; j < j_end; ++j) {
    const int stage = (j - j_begin) & 1;
    if (j + 1 < j_end) {
      const int nxt = stage ^ 1;
      load_tile<DP, BK, ST>(sK + nxt * BK * ST, K, (j + 1) * BK, p.Sk, p);
      load_tile<DP, BK, ST>(sV + nxt * BK * ST, V, (j + 1) * BK, p.Sk, p);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* k_s = sK + stage * BK * ST;
    const __nv_bfloat16* v_s = sV + stage * BK * ST;
    const int k0 = j * BK;

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_s + (n2 * 16 + k_row) * ST + kk * 16 + k_col);
        mma_bf16(s[2 * n2], a, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask, then the online-softmax update
    const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0) ||
                      (p.has_window && (long long)k0 <=
                                           (long long)q0 + BQ16 - 1 - p.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale;
        if (edge && !visible(p, r0 + (e >> 1) * 8, k0 + n * 8 + 2 * t + (e & 1)))
          x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[n][e] - m[e >> 1]);   // masked: exp(-inf) = 0
        s[n][e] = pe;
        l[e >> 1] += pe;
      }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V, P as a bf16 hi/lo pair
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float f0 = s[2 * kt + (i >> 1)][(i & 1) * 2];
        const float f1 = s[2 * kt + (i >> 1)][(i & 1) * 2 + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(f0, f1);
        hi[i] = *reinterpret_cast<const uint32_t*>(&h2);
        lo[i] = pack_bf16(f0 - __low2float(h2), f1 - __high2float(h2));
      }
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_s + (kt * 16 + v_row) * ST + d2 * 16 + v_col);
        mma_bf16(acc[2 * d2], hi, bv[0], bv[1]);
        mma_bf16(acc[2 * d2], lo, bv[0], bv[1]);
        mma_bf16(acc[2 * d2 + 1], hi, bv[2], bv[3]);
        mma_bf16(acc[2 * d2 + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t + c;
        if (d < p.D)
          O[(size_t)row * p.D + d] = __float2bfloat16_rn(acc[n][2 * i + c] / den);
      }
  }
}

template <int DP, int BK>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bf16<DP, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ16 - 1) / BQ16, p.H, p.B);
  flash_bf16_kernel<DP, BK><<<grid, WARPS16 * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------- f32 path

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int QS = BQ + 4;      // row stride of qT and pT (float4-aligned)
constexpr int KS = BK + 4;      // row stride of kT (float4-aligned)

template <int DP>
constexpr size_t smem_f32() {
  // qT [DP][QS] + kv [DP][KS] (kT, then V as [BK][DP]) + pT [BK][QS]
  return sizeof(float) * ((size_t)DP * QS + (size_t)DP * KS + (size_t)BK * QS);
}

// rows [row0, row0 + R) of a [rows, D] matrix, times `mul`, into
// dst[d * stride + r], zero past D and past `nrows`.  A warp covers 8 head
// dims x 4 rows, so its stores hit 32 distinct banks (stride = 4 mod 32).
template <int DP, int R>
__device__ __forceinline__ void load_transposed(float* dst, int stride,
                                                const float* src, int row0,
                                                int nrows, int D, float mul) {
  constexpr int GROUPS = (DP / 8) * (R / 4);
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < GROUPS; g += THREADS / 32) {
    const int d = (g % (DP / 8)) * 8 + (lane & 7);
    const int r = (g / (DP / 8)) * 4 + (lane >> 3);
    const int row = row0 + r;
    float x = 0.f;
    if (d < D && row < nrows) x = src[(size_t)row * D + d] * mul;
    dst[d * stride + r] = x;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_f32_kernel(const Params p) {
  constexpr int DT = DP / 64;   // float4 column groups per thread in PV
  extern __shared__ float4 smem4f[];
  float* qT = reinterpret_cast<float*>(smem4f);  // [DP][QS]
  float* kv = qT + DP * QS;                      // [DP][KS] | [BK][DP]
  float* pT = kv + DP * KS;                      // [BK][QS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.HKV);
  const int q0 = blockIdx.x * BQ;
  const size_t q_off = ((size_t)b * p.H + h) * p.Sq * p.D;
  const size_t kv_off = ((size_t)b * p.HKV + hk) * p.Sk * p.D;
  const float* Q = static_cast<const float*>(p.q) + q_off;
  const float* K = static_cast<const float*>(p.k) + kv_off;
  const float* V = static_cast<const float*>(p.v) + kv_off;
  float* O = static_cast<float*>(p.o) + q_off;

  load_transposed<DP, BQ>(qT, QS, Q, q0, p.Sq, p.D, p.scale);

  int j_begin, j_end;
  live_tiles<BQ, BK>(p, q0, j_begin, j_end);

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
    load_transposed<DP, BK>(kv, KS, K, k0, p.Sk, p.D, 1.f);
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
        vis[i][jj] = visible(p, qi, k0 + tx * 4 + jj);
        s[i][jj] = vis[i][jj] ? s[i][jj] : NEG;
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
      kv[e] = (d < p.D && row < p.Sk) ? V[(size_t)row * p.D + d] : 0.f;
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
        if (d < p.D) O[(size_t)row * p.D + d] = acc[i][t * 4 + jj] / den;
      }
  }
}

template <int DP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_f32<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_f32_kernel<DP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Routes bf16 to the tensor-core kernel
// and f32 to the FMA kernel, launches on `stream` without synchronising
// and returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int HKV, int Sq, int Sk, int D, float scale,
    int causal, int has_window, int window, int bf16, void* stream) {
  if (B <= 0 || H <= 0 || HKV <= 0 || Sq <= 0 || D <= 0 || Sk < 0 ||
      H % HKV != 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.H = H; p.HKV = HKV; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.scale = scale;
  p.causal = causal; p.has_window = has_window; p.window = window;
  p.vec = D % 8 == 0 &&
          ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
            reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (D <= 64) return (int)launch_bf16<64, 64>(p, s);
    if (D <= 128) return (int)launch_bf16<128, 64>(p, s);
    return (int)launch_bf16<256, 32>(p, s);
  }
  if (D <= 64) return (int)launch_f32<64>(p, s);
  if (D <= 128) return (int)launch_f32<128>(p, s);
  return (int)launch_f32<256>(p, s);
}
