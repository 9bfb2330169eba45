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
// What the design does about it:
//  * The plane products run on the int8 tensor cores.  The input planes
//    xs [B, BX, N] are the row-major A = [B*BX, N] (K-contiguous, as laid
//    out); one bank of weight planes ws [N, BA, M] is B = [bank rows,
//    BA*M].  mma.sync.m16n8k32.s32.s8.s8.s32 is exact: planes are
//    {-1,0,+1} (XNOR) or {0,1} (AND) and a bank has a few thousand rows.
//    At decode, B*BX = 16 rows is exactly one m16 tile.
//  * A block owns TB batch rows (TB*BX <= 16*MT A rows; the rest of the
//    tile and any ragged row is zero-filled in shared memory) and TM = 64
//    output columns with all BA planes: a B tile of BA*64 columns, split
//    over 4 warps.  BX is a runtime row count; BA and MT (1 at decode, 2
//    or 4 at prefill, where each gathered weight fragment then feeds four
//    MMAs) are template arguments: 16 instances.  Row tiles run fastest
//    in the grid, so the blocks that share a weight tile run together and
//    read it from L2.
//  * Weights arrive by cp.async, 16 bytes a thread, in a ring of three
//    stages of 64 bank rows.  The int8 MMA wants B K-contiguous; ws keeps
//    its layout (the compiled images and the tests share it), so each
//    thread gathers its fragment's four bank rows with four 32-bit shared
//    loads and three __byte_perm.  The 16-byte chunks of a staged row are
//    XOR-swizzled by bank row / 4, which keeps those loads conflict-free.
//  * Decode parallelism: a 2048-column projection has only 32 column
//    tiles.  The launcher splits each bank's rows over the CS blocks of a
//    thread-block cluster (CS = 1, 2 or 4, picked by the launcher so the
//    grid holds up to two blocks per SM).  At the end of each bank every
//    block stages its s32 partial tile in shared memory, over the idle
//    ring; after a cluster
//    barrier each block owns TM/CS of the columns, sums the CS partials of
//    those columns through distributed shared memory (16-byte loads) into
//    its own tile and runs the epilogue on them.  Integer sums
//    are order-free, so any split gives the same bits.  A cluster and not
//    split-K with atomics: one launch, no scratch in device memory, no
//    second epilogue kernel, and the partials never leave the chip.
//  * The ADC epilogue runs per plane pair in f32 in the reference's exact
//    operation order (IEEE division, rintf half to even, no contraction),
//    kx outer and ka inner, banks added in order (the running sum waits in
//    `out` between banks), then the fused Postreduce, so the unfused
//    output is bitwise equal to the plain torch version.  The two IEEE
//    divisions depend on the row and bank only and run once per output.
//    Build without --use_fast_math.
//  * Groups: the expert FFNs of a MoE layer (the Pallas kernel under
//    jax.vmap, which adds a grid axis) are one launch with the group on
//    gridDim.z.  Every operand but fs gains a leading group axis, and each
//    block offsets its pointers by its group's slice; the cluster stays
//    within one group's column tiles.  A group is computed exactly as a
//    2-D launch on its own operands, so each gives the same bits.  At
//    decode a group holds one row (or none), so the launch is bound by
//    the bytes of all G groups' planes, read even for an empty group.
// wgmma, TMA, warp specialisation and bit-packed planes are the next
// redesign's work.
#include <atomic>
#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TM = 64;          // output columns per block
constexpr int KC = 64;          // bank rows per pipeline stage
constexpr int STAGES = 3;
constexpr int AST = KC + 16;    // A row stride in bytes: conflict-free

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3,
           ACT_SIGN = 4, ACT_IDENTITY = 5 };

// One group's operands; a grouped launch holds G of each (but fs) back to
// back and a block offsets the pointers by its group, blockIdx.z.
struct Params {
  const int8_t* xs;   // [G, B, BX, N] masked input planes
  const int8_t* ws;   // [G, N, BA, M] weight planes
  const float* nu;    // [G, B, n_banks] unmasked rows per bank
  const float* fs;    // [n_banks] static ADC full scale per bank, shared
  const float* es;    // [G or 1, 1 or B, M] fused scale registers (or null)
  const float* pb;    // [G or 1, 1 or B, M] fused bias registers (or null)
  float* out;         // [G, B, M]
  int B, N, M, BX, bank_n, n_banks;
  int coding_and, adaptive, ideal;
  float cmax;         // 2^adc_bits - 1
  int fused, es_rows, pb_rows, act, by_bits;
  int es_groups, pb_groups;   // es / pb carry a group axis
  int tb, cs, vec_x, vec_w;
};

__device__ __forceinline__ float plane_weight(int k, int bits, int coding_and) {
  if (bits == 1) return 1.f;
  if (!coding_and)   // XNOR: [2^(B-2), ..., 2, 1, 1]
    return k == bits - 1 ? 1.f : (float)(1 << (bits - 2 - k));
  // AND (2's complement): [1, 2, ..., 2^(B-2), -2^(B-1)]
  return k == bits - 1 ? -(float)(1 << (bits - 1)) : (float)(1 << k);
}

// core/bpbs.py::gemm_adc_epilogue over core/adc.py, op for op.  fsv is
// the clamped full scale; up = cmax / fsv and dn = fsv / cmax (IEEE
// divisions) depend on the output row and bank only.
__device__ __forceinline__ float adc_epilogue(float d, float nu, float fsv,
                                              float up, float dn,
                                              const Params& p) {
  float pc = p.coding_and ? d : __fmul_rn(__fadd_rn(d, nu), 0.5f);
  if (!p.ideal) {
    const float x = __fmul_rn(fminf(fmaxf(pc, 0.f), fsv), up);
    const float code = fminf(fmaxf(rintf(x), 0.f), p.cmax);
    pc = rintf(__fmul_rn(code, dn));
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// D (16x8 s32) += A (16x32 s8, row) * B (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This block's chunks [c0, c1) of `bank`: the bank's KC-row chunks split
// evenly over the CS blocks of the cluster.
__device__ __forceinline__ void chunk_range(const Params& p, int bank,
                                            int rank, int& c0, int& c1) {
  const int rows = min(p.bank_n, p.N - bank * p.bank_n);
  const int nch = (rows + KC - 1) / KC;
  c0 = rank * nch / p.cs;
  c1 = (rank + 1) * nch / p.cs;
}

constexpr size_t cmax_size(size_t a, size_t b) { return a > b ? a : b; }

template <int BA, int MT>
constexpr size_t smem_bytes() {
  // the ring W [STAGES][KC][BA*TM] + A [STAGES][16*MT][AST], and at the
  // end of each bank, over it, C [16*MT][BA*TM + 8] s32
  return cmax_size((size_t)STAGES * KC * BA * TM + (size_t)STAGES * 16 * MT * AST,
                   sizeof(int) * 16 * MT * (BA * TM + 8));
}

template <int BA, int MT>
__global__ void __launch_bounds__(THREADS, 2) cima_mvm_kernel(Params p) {
  constexpr int ROWS = 16 * MT;          // A rows per tile
  constexpr int WB = BA * TM;            // B columns = bytes per staged row
  constexpr int NTW = WB / 8 / WARPS;    // n8 tiles per warp (2*BA)
  constexpr int CST = WB + 8;            // C row stride (ints)
  extern __shared__ uint4 smem4[];
  int8_t* sW = reinterpret_cast<int8_t*>(smem4);
  int8_t* sA = sW + STAGES * KC * WB;
  int* sC = reinterpret_cast<int*>(smem4);   // over the ring, between banks

  // this block's group: every per-group operand starts at its slice
  const size_t grp = blockIdx.z;
  p.xs += grp * p.B * p.BX * (size_t)p.N;
  p.ws += grp * p.N * BA * (size_t)p.M;
  p.nu += grp * p.B * (size_t)p.n_banks;
  p.out += grp * p.B * (size_t)p.M;
  if (p.es && p.es_groups) p.es += grp * (p.es_rows ? p.B : 1) * (size_t)p.M;
  if (p.pb && p.pb_groups) p.pb += grp * (p.pb_rows ? p.B : 1) * (size_t)p.M;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * p.tb;              // row tiles run fastest:
  const int m0 = (blockIdx.y / p.cs) * TM;       // neighbours share weights
  const int arows = p.tb * p.BX;
  const int tmc = TM / p.cs, c_lo = rank * tmc;  // this block's outputs

  // one stage's copy: KC bank rows of the weight tile and the A tile
  auto load = [&](int stage, int bank, int c) {
    const int k0 = bank * p.bank_n + c * KC;
    const int kend = min(bank * p.bank_n + p.bank_n, p.N);
    int8_t* w = sW + stage * KC * WB;
    int8_t* a = sA + stage * ROWS * AST;
    if (p.vec_w) {
      for (int i = tid; i < KC * (WB / 16); i += THREADS) {
        const int r = i / (WB / 16), q = i % (WB / 16);
        const int ka = q / (TM / 16), m = m0 + (q % (TM / 16)) * 16;
        const int k = k0 + r;
        const bool live = k < kend && m < p.M;
        const int8_t* src = live ? p.ws + ((size_t)k * BA + ka) * p.M + m : p.ws;
        cp_async16(w + r * WB + ((q ^ ((r >> 2) & 3)) << 4), src, live ? 16 : 0);
      }
    } else {
      for (int i = tid; i < KC * WB; i += THREADS) {
        const int r = i / WB, n = i % WB;
        const int ka = n / TM, m = m0 + n % TM, k = k0 + r;
        w[r * WB + (((n >> 4) ^ ((r >> 2) & 3)) << 4) + (n & 15)] =
            (k < kend && m < p.M) ? p.ws[((size_t)k * BA + ka) * p.M + m] : 0;
      }
    }
    if (p.vec_x) {
      for (int i = tid; i < ROWS * (KC / 16); i += THREADS) {
        const int r = i / (KC / 16), k = k0 + (i % (KC / 16)) * 16;
        const bool live = r < arows && b0 + r / p.BX < p.B && k < kend;
        const int8_t* src =
            live ? p.xs + ((size_t)b0 * p.BX + r) * p.N + k : p.xs;
        cp_async16(a + r * AST + (i % (KC / 16)) * 16, src, live ? 16 : 0);
      }
    } else {
      for (int i = tid; i < ROWS * KC; i += THREADS) {
        const int r = i / KC, k = k0 + i % KC;
        a[r * AST + i % KC] =
            (r < arows && b0 + r / p.BX < p.B && k < kend)
                ? p.xs[((size_t)b0 * p.BX + r) * p.N + k] : 0;
      }
    }
  };

  // fragment gather: lane (g, t) needs bank rows 4t..4t+3 (+16) of column
  // n8*8 + g; its 16-byte chunk sits at chunk ^ t in every staged row
  const uint32_t sel = (uint32_t)(g & 3) | ((uint32_t)((g & 3) + 4) << 4);

  for (int bank = 0; bank < p.n_banks; ++bank) {
    int c0, c1;
    chunk_range(p, bank, rank, c0, c1);
    int next = c0;
    auto issue = [&]() {
      if (next < c1) load((next - c0) % STAGES, bank, next);
      ++next;
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue();

    int acc[MT][NTW][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

    for (int c = c0; c < c1; ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // chunk c landed; chunk c-1's stage is free
      issue();
      const int stage = (c - c0) % STAGES;
      const int8_t* w = sW + stage * KC * WB;
      const int8_t* a = sA + stage * ROWS * AST;
#pragma unroll
      for (int ks = 0; ks < KC / 32; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int8_t* ar = a + (mt * 16 + g) * AST + ks * 32 + 4 * t;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(ar);
          af[mt][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * AST);
          af[mt][2] = *reinterpret_cast<const uint32_t*>(ar + 16);
          af[mt][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * AST + 16);
        }
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int n8 = warp * NTW + j;
          const int col = (((n8 >> 1) ^ t) << 4) + (((n8 & 1) * 8 + g) & ~3);
          uint32_t bf[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int8_t* wr = w + (ks * 32 + h * 16 + 4 * t) * WB + col;
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr);
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + WB);
            const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wr + 2 * WB);
            const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wr + 3 * WB);
            bf[h] = __byte_perm(__byte_perm(w0, w1, sel),
                                __byte_perm(w2, w3, sel), 0x5410);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][j], af[mt], bf[0], bf[1]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is idle: C goes over it

    // the bank's s32 partial tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        int* cr = sC + (mt * 16 + g) * CST + (warp * NTW + j) * 8 + 2 * t;
        *reinterpret_cast<int2*>(cr) = make_int2(acc[mt][j][0], acc[mt][j][1]);
        *reinterpret_cast<int2*>(cr + 8 * CST) =
            make_int2(acc[mt][j][2], acc[mt][j][3]);
      }
    cluster.sync();
    if (p.cs > 1) {
      // sum the cluster's partials of this block's columns [c_lo, c_lo +
      // tmc) into its own tile: no other block reads these columns here
      const int q4 = tmc / 4;
      for (int i = tid; i < arows * BA * q4; i += THREADS) {
        const int q = i % q4, ka = (i / q4) % BA, row = i / (q4 * BA);
        int* e = sC + row * CST + ka * TM + c_lo + 4 * q;
        int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r >= p.cs) break;
          const int4 v = *reinterpret_cast<const int4*>(cluster.map_shared_rank(e, r));
          sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        }
        *reinterpret_cast<int4*>(e) = sum;
      }
      __syncthreads();
    }

    // ADC epilogue and shift-accumulate of this block's outputs; y lives
    // in `out` between banks, the fused Postreduce follows the last bank
    const float fsb = p.fs[bank];
    for (int o = tid; o < p.tb * tmc; o += THREADS) {
      const int bl = o / tmc, ml = c_lo + o % tmc;
      const int row = b0 + bl, col = m0 + ml;
      if (row >= p.B || col >= p.M) continue;
      const float nu = p.nu[(size_t)row * p.n_banks + bank];
      const float fsv = fmaxf(p.adaptive ? nu : fsb, 1.f);
      const float up = __fdiv_rn(p.cmax, fsv), dn = __fdiv_rn(fsv, p.cmax);
      float bsum = 0.f;
      for (int kx = 0; kx < p.BX; ++kx) {
        const float wx = plane_weight(kx, p.BX, p.coding_and);
        const int* cr = sC + (bl * p.BX + kx) * CST + ml;
#pragma unroll
        for (int ka = 0; ka < BA; ++ka)
          bsum = __fadd_rn(bsum, __fmul_rn(wx * plane_weight(ka, BA, p.coding_and),
                                           adc_epilogue((float)cr[ka * TM], nu, fsv,
                                                        up, dn, p)));
      }
      float* yo = p.out + (size_t)row * p.M + col;
      float v = __fadd_rn(bank == 0 ? 0.f : *yo, bsum);
      if (p.fused && bank == p.n_banks - 1) {   // near-memory Postreduce
        const float es = p.es ? p.es[(size_t)(p.es_rows ? row : 0) * p.M + col] : 1.f;
        const float pb = p.pb ? p.pb[(size_t)(p.pb_rows ? row : 0) * p.M + col] : 0.f;
        v = __fadd_rn(__fmul_rn(v, es), pb);
        v = activate(v, p.act);
        if (p.by_bits) {
          const float hi = (float)(ldexp(1.0, p.by_bits - 1) - 1.0);
          v = fminf(fmaxf(v, -(hi + 1.f)), hi);
        }
      }
      *yo = v;
    }
    cluster.sync();   // C is read; the ring may be refilled
  }
}

constexpr int MAX_DEVICES = 64;

template <int BA, int MT>
cudaError_t launch(const Params& p, int groups, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BA, MT>();
  // the shared-memory limit is a per-device attribute of the instance: set
  // it at the first launch on each device, not at every launch
  static std::atomic<bool> smem_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(cima_mvm_kernel<BA, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.B + p.tb - 1) / p.tb, ((p.M + TM - 1) / TM) * p.cs,
                     groups);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cima_mvm_kernel<BA, MT>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_ba(int ba, const Params& p, int g, cudaStream_t s) {
  switch (ba) {
    case 1: return launch<1, MT>(p, g, s);
    case 2: return launch<2, MT>(p, g, s);
    case 3: return launch<3, MT>(p, g, s);
    case 4: return launch<4, MT>(p, g, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_wide(int ba, const Params& p, int g, cudaStream_t s) {
  switch (ba) {
    case 5: return launch<5, 1>(p, g, s);
    case 6: return launch<6, 1>(p, g, s);
    case 7: return launch<7, 1>(p, g, s);
    case 8: return launch<8, 1>(p, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes.  `mt` (1, 2 or 4; above 1 only for
// ba <= 4) is the m16 tiles a block owns, `tb` its batch rows (tb*bx <=
// 16*mt), `cs` the cluster size (1, 2 or 4); vec_x / vec_w say the
// input / weight planes may be copied in 16-byte chunks.  `groups` (1 to
// 65,535) independent products run in the one launch: xs, ws, nu and out
// hold that many back to back, and es / pb too where es_groups /
// pb_groups is set (else one set of registers serves every group).
// Launches on `stream` without synchronising and returns the launch's
// CUDA error (0 = launched).
extern "C" int cima_mvm_launch(
    const void* xs, const void* ws, const void* nu, const void* fs,
    const void* es, const void* pb, void* out,
    int B, int N, int M, int bx, int ba, int bank_n,
    int coding_and, int adaptive, int ideal, int adc_bits,
    int fused, int es_rows, int pb_rows, int act, int by_bits,
    int mt, int tb, int cs, int vec_x, int vec_w,
    int groups, int es_groups, int pb_groups, void* stream) {
  if (groups < 1 || groups > 65535 ||
      B <= 0 || N <= 0 || M <= 0 || bx < 1 || bx > 8 || ba < 1 || ba > 8 ||
      bank_n <= 0 || (mt != 1 && mt != 2 && mt != 4) || (mt > 1 && ba > 4) ||
      tb < 1 || tb * bx > 16 * mt ||
      (cs != 1 && cs != 2 && cs != 4) ||
      (long long)((M + TM - 1) / TM) * cs > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xs = static_cast<const int8_t*>(xs);
  p.ws = static_cast<const int8_t*>(ws);
  p.nu = static_cast<const float*>(nu);
  p.fs = static_cast<const float*>(fs);
  p.es = static_cast<const float*>(es);
  p.pb = static_cast<const float*>(pb);
  p.out = static_cast<float*>(out);
  p.B = B; p.N = N; p.M = M; p.BX = bx; p.bank_n = bank_n;
  p.n_banks = (N + bank_n - 1) / bank_n;
  p.coding_and = coding_and; p.adaptive = adaptive; p.ideal = ideal;
  p.cmax = (float)((1 << adc_bits) - 1);
  p.fused = fused; p.es_rows = es_rows; p.pb_rows = pb_rows;
  p.act = act; p.by_bits = by_bits;
  p.es_groups = es_groups; p.pb_groups = pb_groups;
  p.tb = tb; p.cs = cs; p.vec_x = vec_x; p.vec_w = vec_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ba > 4) return (int)launch_wide(ba, p, groups, s);
  switch (mt) {
    case 1: return (int)launch_ba<1>(ba, p, groups, s);
    case 2: return (int)launch_ba<2>(ba, p, groups, s);
    default: return (int)launch_ba<4>(ba, p, groups, s);
  }
}
