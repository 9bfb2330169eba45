// BP/BS mixed-signal MVM of the CIMU (paper Figs. 2-5), hand-written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cima_mvm.py::_kernel (the Pallas TPU kernel
// launched by cima_mvm_planes).  Same function: for every bank of
// `bank_n` input rows and every (kx, ka) input/weight plane pair, an exact
// plane dot product, the per-bank ADC epilogue (core/bpbs.py::
// gemm_adc_epilogue), a barrel shift by wx[kx]*wa[ka] and accumulation
// over pairs and banks; then the optional fused near-memory Postreduce
// (y*escale + pbias -> activation -> saturation to B_y bits).
//
// What bounds it on this card: at decode (a few rows) every weight plane
// byte is read once and used for a handful of rows, so the kernel is
// bound by device-memory bytes (N*BA*M int8).  At prefill (128 rows) the
// BX*BA plane-pair dot products dominate: 2*B*BX*BA*N*M int8 operations.
//
// What this simple design does about it:
//  * One thread block owns one output tile [TB rows x TM columns] and
//    loops over the banks itself.  The TPU grid carried the sum across a
//    sequential bank axis in VMEM; Hopper blocks run in no order, so the
//    loop inside the block takes that axis' place.  No cross-block
//    reduction and no atomics.
//  * Each weight-plane byte is read from device memory once per row tile
//    (decode: exactly once), staged in shared memory in chunks of KC
//    bank rows, and reused by the TB rows of the tile.
//  * Planes are {-1,0,+1} (XNOR) or {0,1} (AND) int8, so four bank rows
//    pack into one 32-bit word and one __dp4a does four exact
//    multiply-adds.  Accumulators are int32 per (row, kx, ka, column):
//    exact, since a bank has at most a few thousand rows.
//  * At the end of each bank the ADC epilogue runs per plane pair in f32
//    in the reference's exact operation order (IEEE division, rintf half
//    to even, no contraction), so the unfused output is bitwise equal to
//    the plain torch version.  Build without --use_fast_math.
// Tensor-core int8 MMA, TMA, double buffering and bit-packed planes are
// left for later work.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 4;          // batch rows per block
constexpr int TM = 32;         // output columns per block
constexpr int KC = 128;        // bank rows staged per shared-memory chunk
constexpr int KW = KC / 4;     // packed 4-row words per chunk
constexpr int KWP = KW + 1;    // padded weight word row: conflict-free reads
constexpr int THREADS = TB * TM;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3,
           ACT_SIGN = 4, ACT_IDENTITY = 5 };

struct Params {
  const int8_t* xs;   // [B, BX, N] masked input planes
  const int8_t* ws;   // [N, BA, M] weight planes
  const float* nu;    // [B, n_banks] unmasked rows per bank
  const float* fs;    // [n_banks] static ADC full scale per bank
  const float* es;    // [1 or B, M] fused scale registers (or null)
  const float* pb;    // [1 or B, M] fused bias registers (or null)
  float* out;         // [B, M]
  int B, N, M, bank_n, n_banks;
  int coding_and, adaptive, ideal;
  float cmax;         // 2^adc_bits - 1
  int fused, es_rows, pb_rows, act, by_bits, vec;
};

__device__ __forceinline__ float plane_weight(int k, int bits, int coding_and) {
  if (bits == 1) return 1.f;
  if (!coding_and)   // XNOR: [2^(B-2), ..., 2, 1, 1]
    return k == bits - 1 ? 1.f : (float)(1 << (bits - 2 - k));
  // AND (2's complement): [1, 2, ..., 2^(B-2), -2^(B-1)]
  return k == bits - 1 ? -(float)(1 << (bits - 1)) : (float)(1 << k);
}

// core/bpbs.py::gemm_adc_epilogue over core/adc.py, op for op.
__device__ __forceinline__ float adc_epilogue(float d, float nu, float fs_static,
                                              const Params& p) {
  float pc = p.coding_and ? d : __fmul_rn(__fadd_rn(d, nu), 0.5f);
  if (!p.ideal) {
    const float fsv = fmaxf(p.adaptive ? nu : fs_static, 1.f);
    const float x = __fmul_rn(fminf(fmaxf(pc, 0.f), fsv), __fdiv_rn(p.cmax, fsv));
    const float code = fminf(fmaxf(rintf(x), 0.f), p.cmax);
    pc = rintf(__fmul_rn(code, __fdiv_rn(fsv, p.cmax)));
  }
  return p.coding_and ? pc : __fsub_rn(__fmul_rn(2.f, pc), nu);
}

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(y, 0.f);
    case ACT_GELU: {   // tanh approximation (jax.nn.gelu's default)
      const float inner = 0.7978845608028654f * (y + 0.044715f * y * y * y);
      return 0.5f * y * (1.f + tanhf(inner));
    }
    case ACT_SILU: return y / (1.f + expf(-y));
    case ACT_SIGN: return y >= 0.f ? 1.f : -1.f;
    default: return y;
  }
}

template <int BX, int BA>
__global__ void __launch_bounds__(THREADS) cima_mvm_kernel(const Params p) {
  __shared__ uint32_t sx[TB * BX * KW];     // [row][kx][k/4]
  __shared__ uint32_t sw[BA * TM * KWP];    // [ka][column][k/4], padded

  const int tid = threadIdx.x;
  const int c = tid % TM, r = tid / TM;
  const int row0 = blockIdx.y * TB, col0 = blockIdx.x * TM;
  const int row = row0 + r, col = col0 + c;
  const bool live = row < p.B && col < p.M;

  float shift[BX][BA];
#pragma unroll
  for (int kx = 0; kx < BX; ++kx)
#pragma unroll
    for (int ka = 0; ka < BA; ++ka)
      shift[kx][ka] = plane_weight(kx, BX, p.coding_and) *
                      plane_weight(ka, BA, p.coding_and);

  float y = 0.f;
  for (int b = 0; b < p.n_banks; ++b) {
    const int kb0 = b * p.bank_n;
    const int kb1 = min(kb0 + p.bank_n, p.N);
    int acc[BX][BA];
#pragma unroll
    for (int kx = 0; kx < BX; ++kx)
#pragma unroll
      for (int ka = 0; ka < BA; ++ka) acc[kx][ka] = 0;

    for (int k0 = kb0; k0 < kb1; k0 += KC) {
      // input planes: word i = (rr*BX + kx)*KW + k4 packs rows k0+4*k4..+3
      for (int i = tid; i < TB * BX * KW; i += THREADS) {
        const int k4 = i % KW, kx = (i / KW) % BX, rr = i / (KW * BX);
        const int grow = row0 + rr;
        uint32_t word = 0;
        if (grow < p.B) {
          const int8_t* src = p.xs + ((size_t)grow * BX + kx) * p.N;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int k = k0 + 4 * k4 + t;
            if (k < kb1) word |= (uint32_t)(uint8_t)src[k] << (8 * t);
          }
        }
        sx[i] = word;
      }
      // weight planes, transposed so four bank rows share one word
      if (p.vec) {   // M % 4 == 0 and 4-byte aligned: one word = 4 columns
        for (int i = tid; i < KW * BA * (TM / 4); i += THREADS) {
          const int c4 = i % (TM / 4), ka = (i / (TM / 4)) % BA;
          const int k4 = i / ((TM / 4) * BA);
          const int gc = col0 + 4 * c4;
          uint32_t w[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int k = k0 + 4 * k4 + t;
            w[t] = (k < kb1 && gc < p.M)
                ? *reinterpret_cast<const uint32_t*>(
                      p.ws + ((size_t)k * BA + ka) * p.M + gc)
                : 0u;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t packed = 0;
#pragma unroll
            for (int t = 0; t < 4; ++t)
              packed |= ((w[t] >> (8 * j)) & 0xffu) << (8 * t);
            sw[(ka * TM + 4 * c4 + j) * KWP + k4] = packed;
          }
        }
      } else {       // any M: byte loads
        for (int i = tid; i < KW * BA * TM; i += THREADS) {
          const int cc = i % TM, ka = (i / TM) % BA, k4 = i / (TM * BA);
          const int gc = col0 + cc;
          uint32_t packed = 0;
          if (gc < p.M) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int k = k0 + 4 * k4 + t;
              if (k < kb1)
                packed |= (uint32_t)(uint8_t)p.ws[((size_t)k * BA + ka) * p.M + gc]
                          << (8 * t);
            }
          }
          sw[(ka * TM + cc) * KWP + k4] = packed;
        }
      }
      __syncthreads();

      const uint32_t* xr = sx + r * BX * KW;
      const uint32_t* wc = sw + c * KWP;
#pragma unroll 4
      for (int k4 = 0; k4 < KW; ++k4) {
        int xv[BX];
#pragma unroll
        for (int kx = 0; kx < BX; ++kx) xv[kx] = (int)xr[kx * KW + k4];
#pragma unroll
        for (int ka = 0; ka < BA; ++ka) {
          const int wv = (int)wc[ka * TM * KWP + k4];
#pragma unroll
          for (int kx = 0; kx < BX; ++kx) acc[kx][ka] = __dp4a(xv[kx], wv, acc[kx][ka]);
        }
      }
      __syncthreads();
    }

    if (live) {   // per-bank ADC epilogue, then shift-accumulate
      const float nu = p.nu[(size_t)row * p.n_banks + b];
      const float fsb = p.fs[b];
      float bank = 0.f;
#pragma unroll
      for (int kx = 0; kx < BX; ++kx)
#pragma unroll
        for (int ka = 0; ka < BA; ++ka)
          bank = __fadd_rn(bank, __fmul_rn(shift[kx][ka],
                                           adc_epilogue((float)acc[kx][ka], nu, fsb, p)));
      y = __fadd_rn(y, bank);
    }
  }
  if (!live) return;

  if (p.fused) {   // near-memory Postreduce after the last bank
    const float es = p.es ? p.es[(size_t)(p.es_rows ? row : 0) * p.M + col] : 1.f;
    const float pb = p.pb ? p.pb[(size_t)(p.pb_rows ? row : 0) * p.M + col] : 0.f;
    y = __fadd_rn(__fmul_rn(y, es), pb);
    y = activate(y, p.act);
    if (p.by_bits) {
      const float hi = (float)(ldexp(1.0, p.by_bits - 1) - 1.0);
      y = fminf(fmaxf(y, -(hi + 1.f)), hi);
    }
  }
  p.out[(size_t)row * p.M + col] = y;
}

template <int BX, int BA>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.M + TM - 1) / TM, (p.B + TB - 1) / TB);
  cima_mvm_kernel<BX, BA><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int BX>
cudaError_t launch_ba(int ba, const Params& p, cudaStream_t s) {
  switch (ba) {
    case 1: return launch<BX, 1>(p, s);
    case 2: return launch<BX, 2>(p, s);
    case 3: return launch<BX, 3>(p, s);
    case 4: return launch<BX, 4>(p, s);
    case 5: return launch<BX, 5>(p, s);
    case 6: return launch<BX, 6>(p, s);
    case 7: return launch<BX, 7>(p, s);
    case 8: return launch<BX, 8>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int cima_mvm_launch(
    const void* xs, const void* ws, const void* nu, const void* fs,
    const void* es, const void* pb, void* out,
    int B, int N, int M, int bx, int ba, int bank_n,
    int coding_and, int adaptive, int ideal, int adc_bits,
    int fused, int es_rows, int pb_rows, int act, int by_bits, int vec,
    void* stream) {
  Params p;
  p.xs = static_cast<const int8_t*>(xs);
  p.ws = static_cast<const int8_t*>(ws);
  p.nu = static_cast<const float*>(nu);
  p.fs = static_cast<const float*>(fs);
  p.es = static_cast<const float*>(es);
  p.pb = static_cast<const float*>(pb);
  p.out = static_cast<float*>(out);
  p.B = B; p.N = N; p.M = M; p.bank_n = bank_n;
  p.n_banks = (N + bank_n - 1) / bank_n;
  p.coding_and = coding_and; p.adaptive = adaptive; p.ideal = ideal;
  p.cmax = (float)((1 << adc_bits) - 1);
  p.fused = fused; p.es_rows = es_rows; p.pb_rows = pb_rows;
  p.act = act; p.by_bits = by_bits; p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bx) {
    case 1: return (int)launch_ba<1>(ba, p, s);
    case 2: return (int)launch_ba<2>(ba, p, s);
    case 3: return (int)launch_ba<3>(ba, p, s);
    case 4: return (int)launch_ba<4>(ba, p, s);
    case 5: return (int)launch_ba<5>(ba, p, s);
    case 6: return (int)launch_ba<6>(ba, p, s);
    case 7: return (int)launch_ba<7>(ba, p, s);
    case 8: return (int)launch_ba<8>(ba, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
