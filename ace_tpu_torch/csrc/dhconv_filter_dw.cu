// Weight gradient of the complex dhconv spectral filter (kernel 1c) for
// Hopper (sm_90a).
//
// Serves the custom VJP of the Pallas TPU kernel
// ace_tpu/ops/pallas_filter.py:dhconv_filter, whose backward is bf16
// einsums with f32 accumulation (_bwd :137-140). Per degree l:
//
//   dw_r[l] = x_r^T g_r + x_i^T g_i      dw_i[l] = x_r^T g_i - x_i^T g_r
//
// each an [I, B*M] x [B*M, O] product, summed over b and m. x_r, x_i are
// f32 [B, L, M, I] (the forward SHT's output, saved by the forward) and are
// rounded to bf16 on chip; g_r, g_i are the bf16 cotangents [B, L, M, O];
// both products of an output element accumulate in one f32 accumulator
// (JAX adds two f32 einsums: the bf16 products are exact in f32, so only
// the order of the sum differs). dw is f32 [2, L, I, O], dw_r then dw_i:
// the port's spectral weight layout, so each output tile is a plain
// row-major block.
//
// What bounds it: at the flagship training shape (B=4, L=180, M=181,
// I=O=512) a call moves 1178 MB (x 534, g 267, dw 378: 0.352 ms at
// 3.35 TB/s) and does 273 GFLOP (0.276 ms at 989 TFLOP/s bf16): memory,
// near the ridge. Each 128 x 128 tile reads its x rows O/128 times and its
// g rows I/128 times over all tiles (4x each at the flagship), mostly
// from L2: 3.4 GB of L2 traffic a call.
//
// What the design does about it (K1's design, dhconv_filter.cu, turned
// to the contraction over b and m):
// - A tile is (l, 128-row i tile, 128-column o tile), the o tile fastest,
//   then the i tile: the 16 tiles of one l run side by side, so x and g
//   leave device memory about once and are re-read from L2.
// - A persistent grid (one block per SM walks the tile list) whose
//   producer runs ahead across tile boundaries, so one tile's epilogue
//   overlaps the next tile's loads.
// - A TMA + mbarrier ring of 4 stages, fed by one elected thread of a
//   producer warpgroup. A stage is 32 rows of the contraction (one b, 32
//   m; rows past M are zero-filled by TMA, so M = 181 takes 6 stages a b):
//   x_r and x_i as four f32 [32 m, 32 i] boxes each (16 KB each), g_r and
//   g_i as two bf16 [32 m, 64 o] boxes each (8 KB each), all with the
//   128-byte swizzle, from 4-D tensor maps (I or O, M, L, B): 48 KB.
// - wgmma m64n128k16, bf16 in, f32 accumulators in registers. Two consumer
//   warpgroups, one 64-row i slab each, hold both outputs of their slab
//   (acc_r, acc_i), so every operand tile feeds four products. B (g, o
//   contiguous) is read from shared memory as an MN-major operand (the
//   transpose bit), as K1 reads its weights. A = x^T comes from registers:
//   each thread reads its fragment in f32 from the swizzled stage, the k
//   pair (k, k + 1) from two rows, and rounds it to bf16. The 128-byte
//   swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)) puts
//   the 32 reads of one load instruction (rows k0 + {0, 2, 4, 6}, 8
//   columns) in 32 distinct banks. -x_i is the negate-A flag.
// - The epilogue stages each output in shared memory, 64 columns at a
//   time (per warpgroup two [64 i, 32 o] f32 boxes in the 128-byte
//   swizzled layout, 16 KB), and stores them by TMA into dw viewed as
//   [2L, I, O] (ragged I and O clipped by the tensor map): dw_r, then
//   dw_i, each half reusing the staging once the store of the one before
//   has read it. Four ring stages with this staging measured faster than
//   three with whole outputs staged (PERF.md).
//
// Tiles, registers, shared memory: 384 threads, two consumer warpgroups
// and one producer warpgroup, of which one thread issues the copies. A
// consumer holds acc_r and acc_i (128 f32 registers a thread) plus 8 for
// the A fragments of one 16-deep step; setmaxnreg moves registers from the
// producer (down to 40) to the consumers (up to 232): 2 x 128 x 232 + 128
// x 40 = 64,512 = 168 x 384, the registers the compiler gives a 384-thread
// block (the launcher refuses to run if it gave fewer, since the consumers'
// request could then not be met). Shared memory: 4 x 48 KB stages, 2 x
// 16 KB output staging, 1 KB alignment and the barriers (230,464 bytes),
// one block per SM. The wrapper checks I % 8 == 0 and O % 8 == 0 (16-byte
// TMA strides) and 16-byte alignment.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

constexpr int BI = 128;              // i rows of a tile
constexpr int BN = 128;              // o columns of a tile
constexpr int BK = 32;               // contraction rows (m) of a stage
constexpr int SLABS = 2;             // 64-row i slabs, one a warpgroup
constexpr int STAGES = 4;
constexpr int CONSUMERS = 128 * SLABS;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int X_BOX = BK * 32 * 4;        // one f32 [32 m, 32 i] box
constexpr int X_BYTES = (BI / 32) * X_BOX;
constexpr int G_BOX = BK * 64 * 2;        // one bf16 [32 m, 64 o] box
constexpr int G_BYTES = (BN / 64) * G_BOX;
constexpr int STAGE_BYTES = 2 * X_BYTES + 2 * G_BYTES;
// a consumer warpgroup's output staging: 64 columns of one output of its
// 64 x 128 slab, as two [64, 32] f32 boxes in the 128-byte swizzled layout
constexpr int OUT_BOX = 64 * 32 * 4;
constexpr int OUT_BYTES = 2 * OUT_BOX;
constexpr int SMEM_BYTES =
    STAGES * STAGE_BYTES + SLABS * OUT_BYTES + 1024 + 2 * STAGES * 8;
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;

// x at rows k and k + 1 (m) and column c (i) of an f32 [32, 32] box stored
// with the 128-byte swizzle, rounded to a bf16 pair (row k in the low
// half, as the A fragment holds the lower k). k is even.
__device__ __forceinline__ uint32_t xt_pair(const float* box, int k, int c) {
  const int chunk = c >> 2, e = c & 3;
  const float a = box[k * 32 + ((chunk ^ (k & 7)) << 2) + e];
  const float b = box[(k + 1) * 32 + ((chunk ^ ((k & 7) | 1)) << 2) + e];
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

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
dhconv_dw_kernel(const __grid_constant__ CUtensorMap map_xr,
                 const __grid_constant__ CUtensorMap map_xi,
                 const __grid_constant__ CUtensorMap map_gr,
                 const __grid_constant__ CUtensorMap map_gi,
                 const __grid_constant__ CUtensorMap map_dw, int B, int L,
                 int n_mc, int n_it, int n_ot, int n_tiles) {
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

  const int nk = B * n_mc;  // stages of a tile
  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: one thread issues every copy of every tile, in
    // order; the others only hand their registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int o0 = (tile % n_ot) * BN;
        const int i0 = ((tile / n_ot) % n_it) * BI;
        const int l = tile / (n_ot * n_it);
        for (int ks = 0; ks < nk; ++ks) {
          const int b = ks / n_mc;
          const int m0 = (ks % n_mc) * BK;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* s = smem + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
#pragma unroll
          for (int q = 0; q < BI / 32; ++q) {
            tma_load_4d(s + q * X_BOX, &map_xr, &full[stage], i0 + 32 * q, m0,
                        l, b);
            tma_load_4d(s + X_BYTES + q * X_BOX, &map_xi, &full[stage],
                        i0 + 32 * q, m0, l, b);
          }
#pragma unroll
          for (int q = 0; q < BN / 64; ++q) {
            tma_load_4d(s + 2 * X_BYTES + q * G_BOX, &map_gr, &full[stage],
                        o0 + 64 * q, m0, l, b);
            tma_load_4d(s + 2 * X_BYTES + G_BYTES + q * G_BOX, &map_gi,
                        &full[stage], o0 + 64 * q, m0, l, b);
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
    // this thread's A rows (i) are slab * 64 + warp * 16 + g (+ 8): column
    // c (+ 8) of x box 2 * slab + warp / 2
    const int xbox = (2 * slab + warp / 2) * (X_BOX / 4);
    const int c = (warp % 2) * 16 + g;
    float acc_r[64], acc_i[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_r[i] = acc_i[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&full[stage], phase);
        const unsigned char* s = smem + stage * STAGE_BYTES;
        const float* sxr = reinterpret_cast<const float*>(s) + opaque(xbox);
        const float* sxi =
            reinterpret_cast<const float*>(s + X_BYTES) + opaque(xbox);
        const unsigned char* sgr = s + 2 * X_BYTES;
        const unsigned char* sgi = sgr + G_BYTES;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // one 16-deep step at a time, so that only its A fragments are
          // live: 128 accumulators + 8 fragment registers
          const int k0 = kk * 16 + 2 * t;
          const int cc = opaque(c);
          const uint32_t ar[4] = {
              xt_pair(sxr, k0, cc), xt_pair(sxr, k0, cc + 8),
              xt_pair(sxr, k0 + 8, cc), xt_pair(sxr, k0 + 8, cc + 8)};
          const uint32_t ai[4] = {
              xt_pair(sxi, k0, cc), xt_pair(sxi, k0, cc + 8),
              xt_pair(sxi, k0 + 8, cc), xt_pair(sxi, k0 + 8, cc + 8)};
          // 16 contraction rows further down a [32, 64] g box: 16 x 128
          // bytes; the two 64-column boxes of a stage are G_BOX apart (LBO),
          // and 8-row groups 1024 bytes apart (SBO)
          const uint64_t dgr = desc_sw128(sgr + kk * 2048, G_BOX, 1024);
          const uint64_t dgi = desc_sw128(sgi + kk * 2048, G_BOX, 1024);
          const int sd = (ks > 0 || kk > 0) ? 1 : 0;
          wgmma_fence();
          fence_regs(acc_r);
          fence_regs(acc_i);
          wgmma_rs<1>(acc_r, ar, dgr, sd);
          wgmma_rs<1>(acc_r, ai, dgi, 1);
          wgmma_rs<1>(acc_i, ar, dgi, sd);
          wgmma_rs<-1>(acc_i, ai, dgr, 1);
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
      // epilogue: dw_r, then dw_i, 64 columns at a time, through this
      // warpgroup's staging boxes, each reused once the previous store has
      // read it
      const int o0 = (tile % n_ot) * BN;
      const int i0 = ((tile / n_ot) % n_it) * BI + slab * 64;
      const int l = tile / (n_ot * n_it);
      unsigned char* so = out_stage + slab * OUT_BYTES;
      const bool leader = threadIdx.x % 128 == 0;
      auto store = [&](const float(&acc)[64], int part) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (leader) bulk_wait_read();
          named_barrier(1 + slab, 128);
          stage_half(so, acc, warp, g, t, half);
          fence_async_shared();
          named_barrier(1 + slab, 128);
          if (leader) {
            tma_store_3d(&map_dw, so, o0 + 64 * half, i0, part * L + l);
            tma_store_3d(&map_dw, so + OUT_BOX, o0 + 64 * half + 32, i0,
                         part * L + l);
            bulk_commit();
          }
        }
      };
      store(acc_r, 0);
      store(acc_i, 1);
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

}  // namespace

// Launch 1c on `stream`; returns a CUDA error code (0 on success).
// x: f32 [B, L, M, I]; g: bf16 [B, L, M, O]; dw: f32 [2, L, I, O].
// Pointers must be 16-byte aligned and contiguous, I % 8 == 0 and
// O % 8 == 0, B * M > 0 (the wrapper checks).
extern "C" int dhconv_filter_dw(const void* xr, const void* xi,
                                const void* gr, const void* gi, void* dw,
                                int B, int L, int M, int I, int O,
                                void* stream) {
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  static int launch_regs = -1;
  if (launch_regs < 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, dhconv_dw_kernel);
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
  const uint64_t x_dims[4] = {static_cast<uint64_t>(I),
                              static_cast<uint64_t>(M),
                              static_cast<uint64_t>(L),
                              static_cast<uint64_t>(B)};
  const uint64_t g_dims[4] = {static_cast<uint64_t>(O), x_dims[1], x_dims[2],
                              x_dims[3]};
  const uint64_t dw_dims[3] = {static_cast<uint64_t>(O),
                               static_cast<uint64_t>(I), 2ull * L};
  const uint32_t x_box[4] = {32, BK, 1, 1};
  const uint32_t g_box[4] = {64, BK, 1, 1};
  const uint32_t dw_box[3] = {32, 64, 1};
  CUtensorMap maps[5];
  if (!make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xr, 4, x_dims,
                x_box) ||
      !make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xi, 4, x_dims,
                x_box) ||
      !make_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, gr, 4, g_dims,
                g_box) ||
      !make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, gi, 4, g_dims,
                g_box) ||
      !make_map(&maps[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dw, 3, dw_dims,
                dw_box)) {
    return cudaErrorInvalidValue;
  }
  const int n_mc = (M + BK - 1) / BK;
  const int n_it = (I + BI - 1) / BI;
  const int n_ot = (O + BN - 1) / BN;
  const long long tiles = static_cast<long long>(L) * n_it * n_ot;
  if (tiles > 0x7FFFFFFF || static_cast<long long>(B) * n_mc > 0x7FFFFFFF) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      dhconv_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  dhconv_dw_kernel<<<grid, THREADS, SMEM_BYTES,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], B, L, n_mc, n_it, n_ot,
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
