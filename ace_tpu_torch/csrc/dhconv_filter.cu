// Complex dhconv spectral filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ace_tpu/ops/pallas_filter.py:dhconv_filter
// (_kernel :46, grid in _forward :69). For every (b, l), with x[b, l] an
// [M, I] block and w[l] an [I, O] block:
//
//   out_r = x_r w_r - x_i w_i        out_i = x_r w_i + x_i w_r
//
// x_r, x_i are f32 [B, L, M, I] (the forward SHT's output) and are rounded
// to bf16 on chip; w_r, w_i are bf16 [L, I, O]; products accumulate in f32
// and the outputs are bf16 [B, L, M, O] (the AMP contract of
// ace_tpu/ops/pallas_filter.py:26-30).
//
// What bounds it: at the flagship shape (B=1, L=180, M=181, I=O=512) a
// call moves ~389 MB (x f32 read once, w bf16 read once, out bf16 written
// once) and does 68 GFLOP, so on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16)
// it is bound by memory: ~0.116 ms against ~0.069 ms of tensor-core time.
//
// What the design does about it:
// - Weight-stationary over M. A tile is one (b*l, 128-column O tile) with
//   all M rows of that l, up to 192 (three 64-row wgmma slabs; rows past M
//   are zero-filled by TMA and dropped by the TMA store; M > 192 takes more
//   tiles). Each weight byte leaves device memory once per b, and x is read
//   O/128 times (4x at O = 512), by neighbouring tiles that run together
//   (the O tile is the fastest tile index), so mostly from L2.
// - A persistent grid: one block per SM walks the tile list, and its
//   producer runs ahead across tile boundaries, so one tile's epilogue
//   overlaps the next tile's loads.
// - A TMA + mbarrier ring of 2 stages, fed by one elected thread of a
//   producer warpgroup. A stage is one 32-deep step of the contraction:
//   x_r and x_i as f32 [192, 32] boxes (24 KB each) and w_r, w_i as two
//   bf16 [32, 64] boxes each (8 KB each), all with the 128-byte swizzle:
//   64 KB. (Three stages fit only without the output staging below, and
//   the staging is worth more: see PERF.md.)
// - wgmma m64n128k16, bf16 in, f32 accumulators in registers. B (the
//   weights, O contiguous) is read from shared memory as an MN-major
//   operand (the transpose bit). A is taken from registers: each consumer
//   thread reads its x fragment in f32 from the swizzled stage, rounds it
//   to bf16 in registers, and -x_i is the instruction's negate-A flag, so
//   neither a bf16 copy of x nor a -x_i tile exists anywhere.
// - The epilogue rounds the accumulators to bf16 in registers, writes them
//   into a per-warpgroup swizzled staging tile and stores that by TMA
//   (ragged M and O are clipped by the tensor map). The f32 tile never
//   leaves registers; the store replaces 4-byte scattered stores, which
//   had cost about half the kernel's time.
//
// Tiles, registers, shared memory: 512 threads, three consumer warpgroups
// (one 64-row slab each) and one producer warpgroup, of which one thread
// issues the copies. A consumer holds out_r and out_i for 64 x 128 as 128
// f32 registers a thread, plus 8 for the A fragments of one 16-deep step;
// setmaxnreg moves registers from the producer (down to 32) to the
// consumers (up to 160), which fills the SM's 65,536 from the 128 a thread
// the compiler gives a 512-thread block (the launcher refuses to run if it
// gave fewer, since the consumers' request could then not be met).
// Shared memory: 2 x 64 KB stages, 3 x 32 KB output staging, 1 KB
// alignment and the barriers (230,432 bytes), one block per SM. The
// wrapper checks I % 32 == 0 (whole steps) and O % 8 == 0 (16-byte TMA
// strides).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BN = 128;              // output columns (o) of a tile
constexpr int BK = 32;               // contraction depth of a stage
constexpr int SLABS = 3;             // 64-row wgmma slabs, one a warpgroup
constexpr int ROWS = 64 * SLABS;     // rows (m) of a tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 128 * SLABS;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int X_BYTES = ROWS * BK * 4;   // one f32 x box
constexpr int W_BOX = BK * 64 * 2;       // one bf16 [32, 64] weight box
constexpr int W_BYTES = (BN / 64) * W_BOX;
constexpr int STAGE_BYTES = 2 * X_BYTES + 2 * W_BYTES;
// a consumer warpgroup's output staging: out_r and out_i for its 64 x 128
// slab, each two [64, 64] bf16 blocks in the 128-byte swizzled layout
constexpr int OUT_BLOCK = 64 * 128;
constexpr int OUT_BYTES = 2 * (BN / 64) * OUT_BLOCK;
constexpr int SMEM_BYTES =
    STAGES * STAGE_BYTES + SLABS * OUT_BYTES + 1024 + 2 * STAGES * 8;
constexpr int CONSUMER_REGS = 160;
constexpr int PRODUCER_REGS = 32;

// Two consecutive f32 values of an x stage ([ROWS, 32] f32 rows of 128
// bytes, 16-byte chunk c of row r stored at chunk c ^ (r % 8)), rounded to
// a bf16 pair (the lower column in the low half).
__device__ __forceinline__ uint32_t x_pair(const float* tile, int row,
                                           int col) {
  const int chunk = (col >> 2) ^ (row & 7);
  const float2 v = *reinterpret_cast<const float2*>(tile + row * BK +
                                                    chunk * 4 + (col & 3));
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__global__ void __launch_bounds__(THREADS, 1)
dhconv_filter_kernel(const __grid_constant__ CUtensorMap map_xr,
                     const __grid_constant__ CUtensorMap map_xi,
                     const __grid_constant__ CUtensorMap map_wr,
                     const __grid_constant__ CUtensorMap map_wi,
                     const __grid_constant__ CUtensorMap map_outr,
                     const __grid_constant__ CUtensorMap map_outi, int L,
                     int I, int n_mchunk, int n_otile, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* out_stage = smem + STAGES * STAGE_BYTES;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(out_stage + SLABS * OUT_BYTES);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = I / BK;
  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: one thread issues every copy of every tile, in
    // order; the others only hand their registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int ot = tile % n_otile;
        const int rest = tile / n_otile;
        const int mc = rest % n_mchunk;
        const int bl = rest / n_mchunk;
        const int l = bl % L;
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* s = smem + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          tma_load_3d(s, &map_xr, &full[stage], ks * BK, mc * ROWS, bl);
          tma_load_3d(s + X_BYTES, &map_xi, &full[stage], ks * BK, mc * ROWS,
                      bl);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b) {
            const int o = ot * BN + b * 64;
            tma_load_3d(s + 2 * X_BYTES + b * W_BOX, &map_wr, &full[stage], o,
                        ks * BK, l);
            tma_load_3d(s + 2 * X_BYTES + W_BYTES + b * W_BOX, &map_wi,
                        &full[stage], o, ks * BK, l);
          }
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
    const int r0 = slab * 64 + warp * 16 + g;  // this thread's rows r0, r0+8
    float acc_r[64], acc_i[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_r[i] = acc_i[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int ot = tile % n_otile;
      const int rest = tile / n_otile;
      const int mc = rest % n_mchunk;
      const int bl = rest / n_mchunk;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&full[stage], phase);
        const unsigned char* s = smem + stage * STAGE_BYTES;
        const float* sxr = reinterpret_cast<const float*>(s);
        const float* sxi = reinterpret_cast<const float*>(s + X_BYTES);
        const unsigned char* swr = s + 2 * X_BYTES;
        const unsigned char* swi = swr + W_BYTES;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // one 16-deep step at a time, so that only its A fragments are
          // live: 128 accumulators + 8 fragment registers
          const int c0 = kk * 16 + 2 * t;
          const int r = opaque(r0);
          const uint32_t ar[4] = {
              x_pair(sxr, r, c0), x_pair(sxr, r + 8, c0),
              x_pair(sxr, r, c0 + 8), x_pair(sxr, r + 8, c0 + 8)};
          const uint32_t ai[4] = {
              x_pair(sxi, r, c0), x_pair(sxi, r + 8, c0),
              x_pair(sxi, r, c0 + 8), x_pair(sxi, r + 8, c0 + 8)};
          // 16 weight rows further down a [32, 64] box: 16 x 128 bytes;
          // the two 64-column boxes of a stage are W_BOX apart (LBO), and
          // 8-row groups 1024 bytes apart (SBO)
          const uint64_t dwr = desc_sw128(swr + kk * 2048, W_BOX, 1024);
          const uint64_t dwi = desc_sw128(swi + kk * 2048, W_BOX, 1024);
          const int sd = (ks > 0 || kk > 0) ? 1 : 0;
          wgmma_fence();
          fence_regs(acc_r);
          fence_regs(acc_i);
          wgmma_rs<1>(acc_r, ar, dwr, sd);
          wgmma_rs<-1>(acc_r, ai, dwi, 1);
          wgmma_rs<1>(acc_i, ar, dwi, sd);
          wgmma_rs<1>(acc_i, ai, dwr, 1);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc_r);
          fence_regs(acc_i);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // epilogue: round in registers, stage bf16 pairs (rows g and g + 8 of
      // the warp's 16, columns 8j + 2t of the tile) in this warpgroup's
      // swizzled staging tiles, and store them by TMA (rows past M and
      // columns past O are dropped). The staging tiles are reused once the
      // previous tile's store has read them.
      unsigned char* so = out_stage + slab * OUT_BYTES;
      if (threadIdx.x % 128 == 0) bulk_wait_read();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + slab) : "memory");
      const int base = opaque((warp * 16 + g) * 128 + 4 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int off = base + (j / 8) * OUT_BLOCK + h * 1024 +
                          (((j % 8) ^ g) << 4);
          store_pair(reinterpret_cast<bf16*>(so + off), acc_r[4 * j + 2 * h],
                     acc_r[4 * j + 2 * h + 1]);
          store_pair(reinterpret_cast<bf16*>(so + OUT_BYTES / 2 + off),
                     acc_i[4 * j + 2 * h], acc_i[4 * j + 2 * h + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + slab) : "memory");
      if (threadIdx.x % 128 == 0) {
        const int m0 = mc * ROWS + slab * 64;
#pragma unroll
        for (int b = 0; b < BN / 64; ++b) {
          tma_store_3d(&map_outr, so + b * OUT_BLOCK, ot * BN + b * 64, m0, bl);
          tma_store_3d(&map_outi, so + OUT_BYTES / 2 + b * OUT_BLOCK,
                       ot * BN + b * 64, m0, bl);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (threadIdx.x % 128 == 0) {
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
}

// A rank-3 tiled map over a row-major [d2, d1, d0] tensor.
bool make_map_3d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                 const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
                 uint32_t box0, uint32_t box1) {
  const uint64_t dims[3] = {d0, d1, d2};
  const uint32_t box[3] = {box0, box1, 1};
  return make_map(map, type, elem_bytes, ptr, 3, dims, box);
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success).
// batch_l = B * L. Pointers must be 16-byte aligned and contiguous,
// I % 32 == 0 and O % 8 == 0 (the wrapper checks).
extern "C" int dhconv_filter_forward(const void* xr, const void* xi,
                                     const void* wr, const void* wi,
                                     void* outr, void* outi, int batch_l,
                                     int L, int M, int I, int O,
                                     void* stream) {
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  static int launch_regs = -1;
  if (launch_regs < 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, dhconv_filter_kernel);
    if (err != cudaSuccess) return err;
    launch_regs = attr.numRegs;
  }
  // the consumers' setmaxnreg request must fit what the block holds
  if (launch_regs * THREADS <
      CONSUMERS * CONSUMER_REGS + (THREADS - CONSUMERS) * PRODUCER_REGS) {
    return cudaErrorInvalidConfiguration;
  }
  CUtensorMap maps[6];
  if (!make_map_3d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xr, I, M,
                batch_l, BK, ROWS) ||
      !make_map_3d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xi, I, M,
                batch_l, BK, ROWS) ||
      !make_map_3d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wr, O, I, L,
                64, BK) ||
      !make_map_3d(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wi, O, I, L,
                64, BK) ||
      !make_map_3d(&maps[4], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, outr, O, M,
                batch_l, 64, 64) ||
      !make_map_3d(&maps[5], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, outi, O, M,
                batch_l, 64, 64)) {
    return cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n_mchunk = (M + ROWS - 1) / ROWS;
  const int n_otile = (O + BN - 1) / BN;
  const long long tiles = static_cast<long long>(batch_l) * n_mchunk * n_otile;
  if (tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dhconv_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  dhconv_filter_kernel<<<grid, THREADS, SMEM_BYTES,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], L, I, n_mchunk,
      n_otile, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
