// Input gradient of the complex dhconv spectral filter (kernel 1b) for
// Hopper (sm_90a).
//
// Serves the custom VJP of the Pallas TPU kernel
// ace_tpu/ops/pallas_filter.py:dhconv_filter (_bwd :129-141), whose
// backward is four bf16 einsums with f32 accumulation and f32 results.
// With the forward out_r = x_r w_r - x_i w_i, out_i = x_r w_i + x_i w_r per
// degree l, and g_r, g_i the bf16 cotangents of out_r, out_i:
//
//   dx_r = g_r w_r^T + g_i w_i^T      dx_i = g_i w_r^T - g_r w_i^T
//
// per (b, l): [M, O] x [O, I] -> f32 [M, I]. w_r, w_i are bf16 [L, I, O];
// g_r, g_i bf16 [B, L, M, O]. Both products of an output element
// accumulate in one f32 accumulator (JAX adds two f32 einsums: the bf16
// products are exact in f32, so only the order of the sum differs). The
// weight gradient (1c) is dhconv_filter_dw.cu.
//
// What bounds it: at the flagship training shape (B=4, L=180, M=181,
// I=O=512) it does 273 GFLOP (0.276 ms at 989 TFLOP/s bf16) and moves
// 989 MB (g 267, w 189, dx 534: 0.295 ms at 3.35 TB/s): at the ridge, and
// more than half of the bytes are the f32 output.
//
// What the design does about it (K1's design, dhconv_filter.cu, with both
// operands in shared memory, an f32 epilogue and the contraction over O):
// - Weight-stationary over M. A tile is (b, l, 128-column i tile) with all
//   M rows of that l, up to 192 (three 64-row wgmma slabs; rows past M are
//   zero-filled by TMA and dropped by the TMA store; M > 192 takes more
//   tiles). Tiles are walked with the i tile fastest, then the M chunk,
//   then b, then l: the i tiles of one (b, l) re-read its g from L2, and
//   the B batches of one l re-read w[l] from L2.
// - A persistent grid: one block per SM walks the tile list, and its
//   producer runs ahead across tile boundaries, so one tile's epilogue
//   overlaps the next tile's loads.
// - A TMA + mbarrier ring of 4 stages, fed by one elected thread of a
//   producer warpgroup. A stage is 32 deep in O: g_r and g_i as bf16
//   [192 m, 32 o] boxes (12 KB each) from maps over (O, M, B*L), and w_r,
//   w_i as bf16 [128 i, 32 o] boxes (8 KB each) from maps over (O, I, L),
//   all with the 64-byte swizzle: 40 KB. (Four 32-deep stages measured
//   faster than two 64-deep ones with the 128-byte swizzle: PERF.md.)
// - wgmma m64n128k16 with both operands read from shared memory through
//   descriptors. g [M, O] is a K-major A and w[l] [I, O] a K-major B,
//   wgmma's native layouts: no transpose bit, no transposed copy, and no
//   thread reads or converts an operand. -g_r w_i^T is the instruction's
//   negate-A flag. The four products of a 16-deep step alternate between
//   the two accumulators, and one stage's products stay in flight while
//   the next stage's are issued.
// - The epilogue writes f32 through shared memory, never scattered: per
//   warpgroup 64 columns of one output at a time, as two [64 m, 32 i] f32
//   boxes in the 128-byte swizzled layout (16 KB), stored by TMA into dx
//   viewed as (I, M, B*L) (ragged M and I clipped by the tensor map); each
//   quarter reuses the staging once the store before it has read it.
//
// Tiles, registers, shared memory: 512 threads, three consumer warpgroups
// (one 64-row slab each) and one producer warpgroup, of which one thread
// issues the copies. A consumer holds dx_r and dx_i for its 64 x 128 slab
// (128 f32 registers a thread) and no operand fragments; setmaxnreg moves
// registers from the producer (down to 32) to the consumers (up to 160),
// which fills the SM's 65,536 from the 128 a thread the compiler gives a
// 512-thread block (the launcher refuses to run if it gave fewer, since
// the consumers' request could then not be met). Shared memory: 4 x 40 KB
// stages, 3 x 16 KB output staging, 1 KB alignment and the barriers
// (214,080 bytes), one block per SM. The wrapper checks I % 8 == 0 and
// O % 8 == 0 (16-byte TMA strides) and 16-byte alignment.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

constexpr int BN = 128;              // i columns of a tile
constexpr int BK = 32;               // contraction depth (o) of a stage
constexpr int SLABS = 3;             // 64-row wgmma slabs, one a warpgroup
constexpr int ROWS = 64 * SLABS;     // m rows of a tile
constexpr int STAGES = 4;
constexpr int CONSUMERS = 128 * SLABS;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int G_BYTES = ROWS * BK * 2;    // one bf16 [192 m, 32 o] box
constexpr int W_BYTES = BN * BK * 2;      // one bf16 [128 i, 32 o] box
constexpr int STAGE_BYTES = 2 * G_BYTES + 2 * W_BYTES;
// a consumer warpgroup's output staging: 64 columns of one output of its
// 64 x 128 slab, as two [64, 32] f32 boxes in the 128-byte swizzled layout
constexpr int OUT_BOX = 64 * 32 * 4;
constexpr int OUT_BYTES = 2 * OUT_BOX;
constexpr int SMEM_BYTES =
    STAGES * STAGE_BYTES + SLABS * OUT_BYTES + 1024 + 2 * STAGES * 8;
constexpr int CONSUMER_REGS = 160;
constexpr int PRODUCER_REGS = 32;

// Write columns 64 * half to 64 * half + 63 of a 64 x 128 f32 accumulator
// tile (this thread's: rows g and g + 8 of the warp's 16, columns 8j + 2t)
// into the warpgroup's two swizzled staging boxes.
__device__ __forceinline__ void stage_half(unsigned char* so,
                                           const float (&acc)[64], int warp,
                                           int g, int t, int half) {
  const int base = opaque(warp * 16 * 128 + g * 128 + (t & 1) * 8);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * half + jj;
      const int chunk = (2 * (j % 4) + (t >> 1)) ^ g;
      const int off = base + (jj / 4) * OUT_BOX + h * 8 * 128 + (chunk << 4);
      *reinterpret_cast<float2*>(so + off) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
dhconv_dx_kernel(const __grid_constant__ CUtensorMap map_gr,
                 const __grid_constant__ CUtensorMap map_gi,
                 const __grid_constant__ CUtensorMap map_wr,
                 const __grid_constant__ CUtensorMap map_wi,
                 const __grid_constant__ CUtensorMap map_dxr,
                 const __grid_constant__ CUtensorMap map_dxi, int B, int L,
                 int nk, int n_mc, int n_it, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* out_stage = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_stage + SLABS * OUT_BYTES);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: one thread issues every copy of every tile, in
    // order; the others only hand their registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int i0 = (tile % n_it) * BN;
        const int rest = tile / n_it;
        const int m0 = (rest % n_mc) * ROWS;
        const int b = (rest / n_mc) % B;
        const int l = rest / (n_mc * B);
        const int bl = b * L + l;
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* s = smem + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          tma_load_3d(s, &map_gr, &full[stage], ks * BK, m0, bl);
          tma_load_3d(s + G_BYTES, &map_gi, &full[stage], ks * BK, m0, bl);
          tma_load_3d(s + 2 * G_BYTES, &map_wr, &full[stage], ks * BK, i0, l);
          tma_load_3d(s + 2 * G_BYTES + W_BYTES, &map_wi, &full[stage],
                      ks * BK, i0, l);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int slab = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    float acc_r[64], acc_i[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_r[i] = acc_i[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int prev = -1;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&full[stage], phase);
        // this warpgroup's 64 rows of g, rows of BK values into the g boxes
        const unsigned char* sgr =
            smem + stage * STAGE_BYTES + opaque(slab * 64 * BK * 2);
        const unsigned char* sgi = sgr + G_BYTES;
        const unsigned char* swr = smem + stage * STAGE_BYTES + 2 * G_BYTES;
        const unsigned char* swi = swr + W_BYTES;
        wgmma_fence();
        fence_regs(acc_r);
        fence_regs(acc_i);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // 16 deeper: 32 bytes further into each 64-byte swizzled row
          const uint64_t dgr = desc_kmajor_sw64(sgr + kk * 32);
          const uint64_t dgi = desc_kmajor_sw64(sgi + kk * 32);
          const uint64_t dwr = desc_kmajor_sw64(swr + kk * 32);
          const uint64_t dwi = desc_kmajor_sw64(swi + kk * 32);
          const int sd = (ks > 0 || kk > 0) ? 1 : 0;
          wgmma_ss<1>(acc_r, dgr, dwr, sd);
          wgmma_ss<1>(acc_i, dgi, dwr, sd);
          wgmma_ss<1>(acc_r, dgi, dwi, 1);
          wgmma_ss<-1>(acc_i, dgr, dwi, 1);
        }
        wgmma_commit();
        if (prev >= 0) {
          // the previous stage's products are done: hand its slot back
          wgmma_wait<1>();
          release(prev);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc_r);
      fence_regs(acc_i);
      release(prev);
      // epilogue: dx_r, then dx_i, 64 columns at a time, through this
      // warpgroup's staging boxes, each reused once the previous store has
      // read it
      const int i0 = (tile % n_it) * BN;
      const int rest = tile / n_it;
      const int m0 = (rest % n_mc) * ROWS + slab * 64;
      const int bl = ((rest / n_mc) % B) * L + rest / (n_mc * B);
      unsigned char* so = out_stage + slab * OUT_BYTES;
      const bool leader = threadIdx.x % 128 == 0;
      auto store = [&](const float(&acc)[64], const CUtensorMap* map) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (leader) bulk_wait_read();
          named_barrier(1 + slab, 128);
          stage_half(so, acc, warp, g, t, half);
          fence_async_shared();
          named_barrier(1 + slab, 128);
          if (leader) {
            tma_store_3d(map, so, i0 + 64 * half, m0, bl);
            tma_store_3d(map, so + OUT_BOX, i0 + 64 * half + 32, m0, bl);
            bulk_commit();
          }
        }
      };
      store(acc_r, &map_dxr);
      store(acc_i, &map_dxi);
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

// A rank-3 tiled map over a row-major [d2, d1, d0] tensor, with the
// swizzle that matches its box rows: 64 bytes (the operands' 32-deep
// rows) or 128 (the f32 output's 32-column rows).
bool make_map_3d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                 const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
                 uint32_t box0, uint32_t box1) {
  const uint64_t dims[3] = {d0, d1, d2};
  const uint32_t box[3] = {box0, box1, 1};
  return make_map(map, type, elem_bytes, ptr, 3, dims, box,
                  box0 * elem_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// Launch 1b on `stream`; returns a CUDA error code (0 on success).
// g: bf16 [B, L, M, O]; w: bf16 [L, I, O]; dx: f32 [B, L, M, I].
// Pointers must be 16-byte aligned and contiguous, I % 8 == 0 and
// O % 8 == 0, B * L * M * I > 0 and O > 0 (the wrapper checks).
extern "C" int dhconv_filter_dx(const void* gr, const void* gi,
                                const void* wr, const void* wi, void* dxr,
                                void* dxi, int B, int L, int M, int I, int O,
                                void* stream) {
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  static int launch_regs = -1;
  if (launch_regs < 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, dhconv_dx_kernel);
    if (err != cudaSuccess) return err;
    launch_regs = attr.numRegs;
  }
  // the consumers' setmaxnreg request must fit what the block holds
  if (launch_regs * THREADS <
      CONSUMERS * CONSUMER_REGS + (THREADS - CONSUMERS) * PRODUCER_REGS) {
    return cudaErrorInvalidConfiguration;
  }
  const int device = current_device();
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const uint64_t batch_l = static_cast<uint64_t>(B) * L;
  CUtensorMap maps[6];
  if (!make_map_3d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, gr, O, M,
                   batch_l, BK, ROWS) ||
      !make_map_3d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, gi, O, M,
                   batch_l, BK, ROWS) ||
      !make_map_3d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wr, O, I, L,
                   BK, BN) ||
      !make_map_3d(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wi, O, I, L,
                   BK, BN) ||
      !make_map_3d(&maps[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dxr, I, M,
                   batch_l, 32, 64) ||
      !make_map_3d(&maps[5], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dxi, I, M,
                   batch_l, 32, 64)) {
    return cudaErrorInvalidValue;
  }
  const int n_mc = (M + ROWS - 1) / ROWS;
  const int n_it = (I + BN - 1) / BN;
  const long long tiles = static_cast<long long>(batch_l) * n_mc * n_it;
  if (tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dhconv_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  dhconv_dx_kernel<<<grid, THREADS, SMEM_BYTES,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], B, L,
      (O + BK - 1) / BK, n_mc, n_it, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
