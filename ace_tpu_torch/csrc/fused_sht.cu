// Forward real SHT for Hopper (sm_90a) on the TF32 tensor cores, split to
// f32 accuracy.
//
// Replaces the Pallas TPU kernel ace_tpu/ops/pallas_sht.py:fused_sht
// (_kernel :44, call :111), reached through RealSHT.forward_fused. For
// channels-last x [B, K, J, C] (K latitudes, J longitudes), all float32:
//
//   xm[b, m, k, p, c] = sum_j x[b, k, j, c] * dft_p[j, m]   (p: cos, sin)
//   out_p[b, l, m, c] = sum_k leg[m, l, k] * xm[b, m, k, p, c]
//
// What bounds it: at the flagship shape (B=1, K=L=180, J=360, M=181,
// C=512) the function needs 29.96 GFLOP (23.89 in the DFT over its 360
// nonzero columns, 6.0 in the Legendre contraction over the table's 16,290
// nonzero (l, m) pairs) and moves ~290 MB. For an f32-accurate result the
// card has two ways: f32 FMAs outside the tensor cores (67 TFLOP/s: 0.447
// ms) or three TF32 products per product, hi*hi + hi*lo + lo*hi (3 x 29.96
// GFLOP at 495 TFLOP/s: 0.182 ms). So it is bound by its operations, 0.182
// ms in split TF32; the memory time is 0.087 ms.
//
// What the design does about it: the products run as two GEMM phases on
// wgmma in TF32, each operand split as hi = tf32(v), lo = tf32(v - hi)
// (rounded to nearest, ties away, never truncated), and each product taken
// as lo*hi, hi*lo, then hi*hi into one f32 accumulator (about 22 of f32's
// 24 mantissa bits). The DFT intermediate xm (133 MB at the flagship shape)
// goes through device memory: a round trip costs ~0.08 ms at 3.35 TB/s,
// less than what keeping it on chip costs in re-read operands (the TPU
// kernel's docstring, pallas_sht.py:11-33, makes the same trade the other
// way with 16 MB of VMEM; an SM has 227 KB).
// - Phase 1, the DFT: for every (b, k), [C x J] x [J x 2M] with rows c and
//   the columns n = 2m + p interleaving cos and sin, written as xm in the
//   layout phase 2 reads ([B, M, K, 2, Cp], channels contiguous and padded
//   to Cp, a multiple of 32, so that no 32-row group of phase 2 straddles
//   the two parts).
// - Phase 2, the Legendre contraction: for every (b, m), [2Cp x K] x
//   [K x L], the real and imaginary rows sharing one product. Only l >= m is
//   computed: 64-column l chunks that lie wholly below m are skipped and
//   written as zeros (the table is exactly zero there).
// - One kernel template serves both phases: a tile is 128 rows (two
//   consumer warpgroups of 64) by three 64-column chunks, each its own
//   m64n64k8 accumulator, so a phase-2 item skips the chunks below m.
// - A persistent grid of one block per SM walks a list of tiles (phase 2:
//   smallest m first, so the items with the most live chunks start first).
//   One thread of a producer warpgroup keeps a 4-stage TMA ring full
//   through mbarriers. A stage is 16 deep: four [16 depth, 32 rows] f32
//   boxes of the A operand (128-byte swizzle) and, per live chunk, the hi
//   and lo table boxes ([64 rows, 16 depth], K-major, 64-byte swizzle): 32
//   KB at most. 16-deep stages and the deeper ring beat 32-deep stages in
//   a 3-stage ring of the same bytes (PERF.md, section 6).
// - For tf32, wgmma reads B from shared memory only K-major and A from
//   shared memory only K-major too, while x and xm have their rows (c)
//   contiguous. So A comes from registers: each consumer thread reads its
//   fragment from the swizzled stage and splits it there (cvt.rna.tf32).
//   The tables are the B operands, split once on the host (RealSHT's
//   kernel tables, K-major, cached per device).
// - Each warpgroup stages its finished tile in swizzled shared boxes (48
//   KB) and one of its threads stores them by TMA, so the warpgroup goes on
//   to its next tile while the stores drain.
// Ragged edges: TMA zero-fills A rows past C (2Cp), depths past J (K), and
// table rows past 2M (L), and drops stored parts past the tensors. The
// wrapper checks C % 4 == 0 (16-byte TMA strides); the host pads the
// tables' depth to a multiple of 4.
//
// Registers: a consumer thread holds 96 accumulators (three m64n64 chunks)
// and 16 fragment registers; setmaxnreg moves registers from the producer
// warpgroup (down to 40) to the consumers (up to 232), so that the
// compiler's cap of 168 a thread does not serialize the wgmma (the
// launcher refuses to run if it gave fewer).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;            // rows of a tile: two 64-row slabs
constexpr int CHUNK = 64;            // columns of one accumulator
constexpr int CHUNKS = 3;            // accumulators of a tile
constexpr int COLS = CHUNK * CHUNKS;
constexpr int BK = 16;               // depth of a stage
constexpr int STEPS = BK / 8;        // 8-deep wgmma steps of a stage
constexpr int STAGES = 4;
// the table boxes are K-major rows of 64 bytes (16 floats): the 64-byte
// swizzle, as the tensor map and the wgmma descriptor (layout 2) name it,
// with 8-row groups 512 bytes apart
static_assert(BK == 16, "the table boxes' swizzle fits 64-byte rows");
constexpr CUtensorMapSwizzle B_SWIZZLE = CU_TENSOR_MAP_SWIZZLE_64B;
constexpr uint64_t B_LAYOUT = 2;
constexpr uint32_t B_SBO = 8 * BK * 4;
constexpr int CONSUMERS = 2 * 128;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
// setmaxnreg: the producer warpgroup gives its registers to the consumers
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int A_BOX = BK * 32 * 4;       // one [BK depth, 32 rows] f32 box
constexpr int A_BYTES = (ROWS / 32) * A_BOX;
constexpr int B_BOX = CHUNK * BK * 4;    // one [64 rows, BK depth] box
constexpr int B_SLOT = 2 * B_BOX;        // hi and lo
constexpr int STAGE_BYTES = A_BYTES + CHUNKS * B_SLOT;
// a warpgroup's output staging: its 64 rows in two groups of 32, each
// chunk's [64 columns, 32 rows] f32 box in the 128-byte swizzled layout
constexpr int OUT_BOX = CHUNK * 32 * 4;
constexpr int OUT_WG = 2 * CHUNKS * OUT_BOX;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + (CONSUMERS / 128) * OUT_WG +
                           1024 + 2 * STAGES * 8;

struct Params {
  int B, K, C, M, L;
  int Cp;       // C rounded up to 32: xm's rows of one part
  int depth;    // J (phase 1) or K (phase 2)
  int n_rc;     // row tiles of one (b, k) or (b, m)
  int n_col;    // phase 1: column tiles of 2M; phase 2: l groups of L
  int n_items;
};

// One tile: where its operands are and which chunks it computes.
struct Item {
  int row0;     // first A row (c, or p*Cp + c)
  int a_batch;  // A's outer coordinate: b*K + k, or b*M + m
  int col0;     // first table row (n, or l)
  int b_batch;  // the table's outer coordinate: 0, or m
  int lo, hi;   // chunks [lo, hi) are computed; [0, hi) are stored
};

template <int PHASE>
__device__ __forceinline__ Item decode(const Params& p, int item) {
  Item it;
  const int rc = item % p.n_rc;
  const int rest = item / p.n_rc;
  it.row0 = rc * ROWS;
  if (PHASE == 1) {
    const int nt = rest % p.n_col;
    it.a_batch = rest / p.n_col;
    it.col0 = nt * COLS;
    it.b_batch = 0;
    it.lo = 0;
    it.hi = min(CHUNKS, (2 * p.M - it.col0 + CHUNK - 1) / CHUNK);
  } else {
    // rest = (m * n_col + lg) * B + b: the smallest m first
    const int b = rest % p.B;
    const int mg = rest / p.B;
    const int lg = mg % p.n_col;
    const int m = mg / p.n_col;
    it.a_batch = b * p.M + m;
    it.col0 = lg * COLS;
    it.b_batch = m;
    it.hi = min(CHUNKS, (p.L - it.col0 + CHUNK - 1) / CHUNK);
    it.lo = min(it.hi, max(0, m / CHUNK - lg * CHUNKS));
  }
  return it;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of `bar` with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Store a box from shared memory by TMA (parts past the tensor, before it
// included, are dropped).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5, %6}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
// Wait until this thread's committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// The 128 threads of consumer warpgroup `slab`.
__device__ __forceinline__ void wg_sync(int slab) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + slab) : "memory");
}

// wgmma shared-memory descriptor of a K-major table tile written by TMA
// with the swizzle B_SWIZZLE: rows of BK floats, 8-row groups B_SBO bytes
// apart.
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(B_SBO >> 4) << 32 | B_LAYOUT << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator accesses across a fence.
__device__ __forceinline__ void fence_regs(float (&d)[CHUNKS][32]) {
#pragma unroll
  for (int s = 0; s < CHUNKS; ++s) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[s][i])::"memory");
  }
}

// D (64 x 64, f32) += A (64 x 8, tf32 registers) * B (8 x 64, tf32 shared
// memory, K-major). The operand list names every accumulator register, as
// wgmma requires.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// v rounded to TF32 (10 mantissa bits, to nearest, ties away from zero).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The A fragments of a stage's 8-deep steps, split into TF32 hi and lo:
// element e of step kk holds row r0 + 8 (e & 1), depth 8 kk + t +
// 4 (e >> 1). A [BK depth, 32 rows] box keeps the 16-byte chunk q of depth
// row d at chunk q ^ (d % 8) (the 128-byte swizzle).
__device__ __forceinline__ void load_split(const float* sa, int r0, int t,
                                           uint32_t (&a_hi)[STEPS][4],
                                           uint32_t (&a_lo)[STEPS][4]) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1);
      const int d = kk * 8 + t + 4 * (e >> 1);
      const float v = sa[(r >> 5) * (A_BOX / 4) + d * 32 +
                         ((((r & 31) >> 2) ^ (d & 7)) << 2) + (r & 3)];
      a_hi[kk][e] = tf32_rna(v);
      a_lo[kk][e] = tf32_rna(v - __uint_as_float(a_hi[kk][e]));
    }
  }
}

// One stage's products: for the first NKK 8-deep steps and the chunks
// [LO, HI), lo*hi, hi*lo, then hi*hi into each chunk's accumulator, then
// commit. Straight-line code from the fence to the commit: a wgmma under a
// branch makes the compiler serialize every wgmma of the kernel.
template <int LO, int HI, int NKK>
__device__ __forceinline__ void mma_steps(float (&acc)[CHUNKS][32],
                                          const uint32_t (&a_hi)[STEPS][4],
                                          const uint32_t (&a_lo)[STEPS][4],
                                          const unsigned char* sb) {
  wgmma_fence();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
#pragma unroll
    for (int c = LO; c < HI; ++c) {
      const unsigned char* b = sb + c * B_SLOT + kk * 32;  // 8 floats a step
      const uint64_t b_hi = desc_kmajor(b);
      const uint64_t b_lo = desc_kmajor(b + B_BOX);
      wgmma_tf32(acc[c], a_lo[kk], b_hi);
      wgmma_tf32(acc[c], a_hi[kk], b_lo);
      wgmma_tf32(acc[c], a_hi[kk], b_hi);
    }
  }
  wgmma_commit();
}

// mma_steps for nkk (1 <= nkk <= N) steps, each count its own code.
template <int LO, int HI, int N = STEPS>
__device__ __forceinline__ void mma_chunks(int nkk, float (&acc)[CHUNKS][32],
                                           const uint32_t (&a_hi)[STEPS][4],
                                           const uint32_t (&a_lo)[STEPS][4],
                                           const unsigned char* sb) {
  if constexpr (N > 1) {
    if (nkk < N) {
      mma_chunks<LO, HI, N - 1>(nkk, acc, a_hi, a_lo, sb);
      return;
    }
  }
  mma_steps<LO, HI, N>(acc, a_hi, a_lo, sb);
}

// The stage's products for live chunks [lo, hi) (lo < hi <= CHUNKS) and
// nkk 8-deep steps, each case its own straight-line sequence.
__device__ __forceinline__ void mma_stage(int lo, int hi, int nkk,
                                          float (&acc)[CHUNKS][32],
                                          const uint32_t (&a_hi)[STEPS][4],
                                          const uint32_t (&a_lo)[STEPS][4],
                                          const unsigned char* sb) {
  switch (lo * 4 + hi) {
    case 1: mma_chunks<0, 1>(nkk, acc, a_hi, a_lo, sb); break;
    case 2: mma_chunks<0, 2>(nkk, acc, a_hi, a_lo, sb); break;
    case 6: mma_chunks<1, 2>(nkk, acc, a_hi, a_lo, sb); break;
    case 7: mma_chunks<1, 3>(nkk, acc, a_hi, a_lo, sb); break;
    case 11: mma_chunks<2, 3>(nkk, acc, a_hi, a_lo, sb); break;
    default: mma_chunks<0, 3>(nkk, acc, a_hi, a_lo, sb); break;
  }
}

template <int PHASE>
__global__ void __launch_bounds__(THREADS, 1)
fused_sht_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_hi,
                 const __grid_constant__ CUtensorMap map_lo,
                 const __grid_constant__ CUtensorMap map_out0,
                 const __grid_constant__ CUtensorMap map_out1, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* out_stage = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_stage +
                                               (CONSUMERS / 128) * OUT_WG);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (p.depth + BK - 1) / BK;
  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: one thread issues every copy, in the consumers'
    // order; the others only hand their registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
        const Item it = decode<PHASE>(p, item);
        if (it.lo >= it.hi) continue;
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* s = smem + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], A_BYTES + (it.hi - it.lo) * B_SLOT);
#pragma unroll
          for (int q = 0; q < ROWS / 32; ++q) {
            tma_load_3d(s + q * A_BOX, &map_a, &full[stage], it.row0 + 32 * q,
                        ks * BK, it.a_batch);
          }
          for (int c = it.lo; c < it.hi; ++c) {
            unsigned char* sb = s + A_BYTES + c * B_SLOT;
            tma_load_3d(sb, &map_hi, &full[stage], ks * BK,
                        it.col0 + c * CHUNK, it.b_batch);
            tma_load_3d(sb + B_BOX, &map_lo, &full[stage], ks * BK,
                        it.col0 + c * CHUNK, it.b_batch);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int slab = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // this thread's A rows in the tile: r0 and r0 + 8
  const int r0 = slab * 64 + warp * 16 + g;
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const Item it = decode<PHASE>(p, item);
    float acc[CHUNKS][32];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    }
    if (it.lo < it.hi) {
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&full[stage], phase);
        const unsigned char* s = smem + stage * STAGE_BYTES;
        uint32_t a_hi[STEPS][4], a_lo[STEPS][4];
        load_split(reinterpret_cast<const float*>(s), r0, t, a_hi, a_lo);
        // the last stage may hold fewer 8-deep steps
        const int nkk = ks + 1 < nk ? STEPS
                                    : min(STEPS, (p.depth - ks * BK + 7) / 8);
        mma_stage(it.lo, it.hi, nkk, acc, a_hi, a_lo, s + A_BYTES);
        // the stage is free once the products that read it are done
        wgmma_wait_all();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // epilogue: stage the tile in this warpgroup's swizzled boxes
    // (accumulator element 4j + 2h + e of chunk c is row r0 + 8h, column
    // 64c + 8j + 2t + e) and store them by TMA; the boxes are reused once
    // the previous tile's stores have read them
    unsigned char* so = out_stage + slab * OUT_WG;
    if (threadIdx.x % 128 == 0) bulk_wait_read();
    wg_sync(slab);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = warp * 16 + g + 8 * h;  // row of the warpgroup's 64
      unsigned char* row_base =
          so + (rr / 32) * CHUNKS * OUT_BOX + (rr % 4) * 4;
      const int chunk = (rr % 32) / 4;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // column 8j + 2t + e is row 8j + 2t + e of a box; 16-byte chunk
        // `chunk` of it sits at chunk ^ (2t + e)
        unsigned char* base =
            row_base + (2 * t + e) * 128 + ((chunk ^ (2 * t + e)) << 4);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            *reinterpret_cast<float*>(base + c * OUT_BOX + j * 8 * 128) =
                acc[c][4 * j + 2 * h + e];
          }
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(slab);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = it.row0 + slab * 64 + q * 32;
        for (int c = 0; c < it.hi; ++c) {
          const unsigned char* box = so + (q * CHUNKS + c) * OUT_BOX;
          const int col = it.col0 + c * CHUNK;
          if (PHASE == 1) {
            // xm [B, M, K, 2, Cp]: rows c, columns (m, p)
            if (r < p.Cp) {
              tma_store_5d(&map_out0, box, r, 0, it.a_batch % p.K, col / 2,
                           it.a_batch / p.K);
            }
          } else {
            // out_p [B, L, M, C]: rows p*Cp + c, columns l; a 32-row group
            // lies in one part
            const int part = r >= p.Cp;
            const int c0 = r - part * p.Cp;
            if (r < 2 * p.Cp && c0 < p.C) {
              tma_store_4d(part ? &map_out1 : &map_out0, box, c0, it.b_batch,
                           col, it.a_batch / p.M);
            }
          }
        }
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (threadIdx.x % 128 == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &status);
#endif
    if (status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A tiled f32 map over a contiguous row-major tensor of `rank` dims, dims[0]
// the fastest; parts past the tensor read as 0 and are not written.
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const uint64_t (&dims)[5], const uint32_t (&box)[5],
              CUtensorMapSwizzle swizzle) {
  cuuint64_t d[5], strides[4];
  cuuint32_t b[5], unit[5];
  uint64_t stride = 4;
  for (int i = 0; i < rank; ++i) {
    if (i > 0) strides[i - 1] = stride;
    stride *= dims[i];
    d[i] = dims[i];
    b[i] = box[i];
    unit[i] = 1;
  }
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                        const_cast<void*>(ptr), d, strides, b, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of one phase: its A operand, the hi and lo tables, its outputs.
struct Maps {
  CUtensorMap a, hi, lo, out0, out1;
};

template <int PHASE>
int launch(const Maps& m, const Params& p, int sms, cudaStream_t stream) {
  static int launch_regs = -1;
  if (launch_regs < 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fused_sht_kernel<PHASE>);
    if (err != cudaSuccess) return err;
    launch_regs = attr.numRegs;
  }
  // the consumers' setmaxnreg request must fit what the block holds
  if (launch_regs * THREADS <
      CONSUMERS * CONSUMER_REGS + (THREADS - CONSUMERS) * PRODUCER_REGS) {
    return cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_sht_kernel<PHASE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = p.n_items < sms ? p.n_items : sms;
  fused_sht_kernel<PHASE><<<grid, THREADS, SMEM_BYTES, stream>>>(
      m.a, m.hi, m.lo, m.out0, m.out1, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both phases on `stream`; returns a CUDA error code (0 on
// success). x [B, K, J, C]; the split tables d_hi, d_lo [2M, Jp] (row
// n = 2m + p: cos for p = 0, sin for p = 1; depth padded with zeros to
// Jp, a multiple of 4) and leg_hi, leg_lo [M, L, Kp] (K-major, padded to
// Kp); scratch xm [B, M, K, 2, Cp] with Cp = C rounded up to 32; out_r,
// out_i [B, L, M, C]. All float32,
// contiguous and 16-byte aligned, C % 4 == 0 (the wrapper checks).
extern "C" int fused_sht_forward(const void* x, const void* d_hi,
                                 const void* d_lo, const void* leg_hi,
                                 const void* leg_lo, void* xm, void* out_r,
                                 void* out_i, int B, int K, int J, int C,
                                 int M, int L, int Jp, int Kp, void* stream) {
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  const uint64_t BK_ = static_cast<uint64_t>(B) * K;
  const uint64_t BM_ = static_cast<uint64_t>(B) * M;
  // loads: A in boxes of 32 rows (128 bytes) by BK depths, tables in
  // boxes of CHUNK rows by BK depths; stores: boxes of 32 rows by CHUNK
  // columns, xm viewed as [B, M, K, 2, Cp] and the outputs as [B, L, M, C]
  const CUtensorMapSwizzle SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint32_t a_box[5] = {32, BK, 1}, b_box[5] = {BK, CHUNK, 1};
  const uint32_t xm_box[5] = {32, 2, 1, CHUNK / 2, 1};
  const uint32_t out_box[5] = {32, 1, CHUNK, 1};
  const uint64_t x_dims[5] = {(uint64_t)C, (uint64_t)J, BK_};
  const uint64_t d_dims[5] = {(uint64_t)Jp, 2 * (uint64_t)M, 1};
  const int Cp = (C + 31) / 32 * 32;
  const uint64_t xm_dims[5] = {(uint64_t)Cp, 2, (uint64_t)K, (uint64_t)M,
                               (uint64_t)B};
  const uint64_t xm_rows[5] = {2 * (uint64_t)Cp, (uint64_t)K, BM_};
  const uint64_t leg_dims[5] = {(uint64_t)Kp, (uint64_t)L, (uint64_t)M};
  const uint64_t out_dims[5] = {(uint64_t)C, (uint64_t)M, (uint64_t)L,
                                (uint64_t)B};
  Maps m1, m2;
  if (!make_map(&m1.a, x, 3, x_dims, a_box, SW128) ||
      !make_map(&m1.hi, d_hi, 3, d_dims, b_box, B_SWIZZLE) ||
      !make_map(&m1.lo, d_lo, 3, d_dims, b_box, B_SWIZZLE) ||
      !make_map(&m1.out0, xm, 5, xm_dims, xm_box, SW128) ||
      !make_map(&m2.a, xm, 3, xm_rows, a_box, SW128) ||
      !make_map(&m2.hi, leg_hi, 3, leg_dims, b_box, B_SWIZZLE) ||
      !make_map(&m2.lo, leg_lo, 3, leg_dims, b_box, B_SWIZZLE) ||
      !make_map(&m2.out0, out_r, 4, out_dims, out_box, SW128) ||
      !make_map(&m2.out1, out_i, 4, out_dims, out_box, SW128)) {
    return cudaErrorInvalidValue;
  }
  m1.out1 = m1.out0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);

  Params p1{B, K, C, M, L, Cp, J};
  p1.n_rc = (C + ROWS - 1) / ROWS;
  p1.n_col = (2 * M + COLS - 1) / COLS;
  const long long items1 = BK_ * p1.n_rc * p1.n_col;
  Params p2{B, K, C, M, L, Cp, K};
  p2.n_rc = (2 * Cp + ROWS - 1) / ROWS;
  p2.n_col = (L + COLS - 1) / COLS;
  const long long items2 = BM_ * p2.n_rc * p2.n_col;
  if (items1 > 0x7FFFFFFF || items2 > 0x7FFFFFFF) return cudaErrorInvalidValue;
  p1.n_items = static_cast<int>(items1);
  p2.n_items = static_cast<int>(items2);
  int err = launch<1>(m1, p1, sms, s);
  if (err != 0) return err;
  return launch<2>(m2, p2, sms, s);
}
