// Fused SFNO block tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ace_tpu/ops/pallas_block.py:fused_block_tail
// (_kernel :74, grid in _forward :85). For every row (grid point) of C
// channels, with bf16 activations and f32 accumulation:
//
//   t   = gelu(x_f + (r @ W_skip + b_skip))
//   y   = layer_norm(t) * ln_w + ln_b           (f32 statistics)
//   y   = y * (1 + n @ W_s) + n @ W_b
//   out = gelu(y @ W1 + b1) @ W2 + b2 + r
//
// The rounding points are the JAX package's (_tail_math :44-71): each
// product's f32 sum is rounded to bf16 before its bias is added, and every
// elementwise step rounds to bf16; the layer norm takes its mean in f32,
// subtracts it after rounding, sums the bf16 squares of the centred values
// in f32 and rounds the 1/sqrt factor to bf16. The bf16 adds and multiplies
// run as packed bf16 instructions, which round their exact result once
// (the f32 operation rounded to bf16). GELU is the tanh form, computed in
// f32 from the bf16 input (tanh.approx, ~2^-11 relative) and rounded once.
// The noise arrives in f32 and is rounded to bf16 as it is loaded.
//
// What bounds it: at the flagship shape (N = 64,800 rows, C = 512, hidden
// 1024, noise 32) a call does 174 GFLOP of bf16 products and moves ~210 MB
// (x_f, r and out in bf16, the noise in f32, the weights once), so on an
// H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) it is bound by its operations:
// ~0.176 ms against ~0.063 ms of memory time.
//
// What the design does about it:
// - A block owns 64 rows at full C (the layer norm needs whole rows) and
//   keeps every intermediate on chip. Two consumer warpgroups split the
//   output columns of each C-wide product (64 * NB columns each, NB = C /
//   128 rounded up: 256 at C = 512) and the columns of each hidden chunk.
// - wgmma bf16 with f32 accumulators in registers. A (r, the noise, y,
//   the hidden chunk) is a bf16 tile in shared memory in the 128-byte
//   swizzled K-major layout; B is the weight tile, read MN-major (the
//   transpose bit) as TMA wrote it from the [in, out] kernels.
// - A producer warpgroup, one thread of which streams every weight tile of
//   the chain by TMA through one 3-stage mbarrier ring, in the fixed order
//   the consumers use them (W_skip, W_s, W_b, then W1 and W2 chunk by
//   chunk, then the residual tile once more for the outer skip), across
//   chunk, product and tile boundaries; all of the ring's bookkeeping is
//   the producer's. Consumers keep one stage of wgmma in flight and
//   release the stage before it. The residual and x_f tiles of the next
//   row tile come by TMA as soon as their buffers are free.
// - A register-resident fc2 accumulator: h is computed in chunks of 256
//   hidden columns, h_j = gelu(y @ W1[:, j] + b1[j]) (each warpgroup 128 of
//   them), and out += h_j @ W2[j, :] accumulates in registers across the
//   chunks (64 x 256 f32 a warpgroup at C = 512: 128 registers a thread),
//   so the 64 x 1024 h tile never exists whole.
// - Epilogues: each accumulator is rounded to bf16 in registers and stored
//   at its fragment's place in a shared tile (the f32 values make no round
//   trip), and the bias, GELU, layer norm, conditioning and residual then
//   run as short rolled loops over 16-byte vectors of the tile. Fully
//   unrolled register epilogues run once a tile and were bound by
//   instruction fetch (PERF.md). The layer norm is fused with the inner
//   skip's epilogue (a warp per row, t kept in registers); the noise
//   conditioning stays in registers; the output is staged in the t/y tile
//   and stored by TMA.
// - A persistent grid: one block per SM walks the row tiles.
//
// Tiles, registers, shared memory: 384 threads (two consumer warpgroups,
// one producer warpgroup); setmaxnreg moves registers from the producer
// (down to 40) to the consumers (up to 232) out of the 168 a thread the
// compiler gives a 384-thread block (the launcher refuses to run if it
// gave fewer). The ring's stages are 32 KB: 32 weight rows at the full
// C-wide block (2 * NB boxes of [32, 64]), 64 rows of a hidden chunk of W1
// (four [64, 64] boxes), or four 64-column blocks of the residual. Shared
// memory, in order: 1 KB alignment, the ring (96 KB), the x_f/t/y/out tile
// (64 x C bf16), the second tile (64 x max(C, noise rounded up to 64, 256)
// bf16: r, then the staged skip product, the noise and each hidden chunk)
// and 10 barriers: 230,480 bytes at C = 512
// (ops/fused_block_tail.py:tail_smem_bytes), one block per SM. Rows past N
// are zero-filled by TMA and dropped by the TMA store; the noise channels
// are zero-padded to a multiple of 64 on chip; C and hidden must be
// multiples of 64 (the wrapper checks).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;             // rows of a block's tile
constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int HC = 256;              // hidden columns per chunk
constexpr int BK = 32;               // weight rows per stage (C-wide products)
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 32768;
constexpr int BOX = BK * 64 * 2;     // one [32, 64] bf16 weight box
constexpr int BLOCK = ROWS * 128;    // one 64-column block of a tile, bytes
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr float EPS = 1e-5f;

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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Store a [64, 64] bf16 box from shared memory (rows past the tensor are
// dropped), and wait until the stores issued so far have read their
// shared memory (read) or completed (all).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor for a tile in the 128-byte swizzled
// layout; lbo and sbo in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator accesses across a fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Make this thread's shared-memory writes visible to wgmma (the async
// proxy), then wait for both consumer warpgroups.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// D (64 x N, f32) += A (64 x 16, bf16, K-major) * B (16 x N, bf16,
// MN-major), both in shared memory; D is overwritten when scale_d == 0.
// One overload per N (64, 128, 192, 256); the operand lists name every
// accumulator register, as wgmma requires.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}


__device__ __forceinline__ float gelu_tanh(float x) {
  const float beta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kappa = 0.044715f;
  float th;
  asm("tanh.approx.f32 %0, %1;\n"
      : "=f"(th)
      : "f"(beta * (x + kappa * (x * x * x))));
  return 0.5f * x * (1.f + th);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Byte offset of (row, col) in a 64-row bf16 tile of 64-column blocks,
// each [64 rows x 128 bytes] with 16-byte chunk q of row r at q ^ (r % 8)
// (the layout TMA's 128-byte swizzle writes and wgmma reads).
__device__ __forceinline__ uint32_t tile_off(int row, int col) {
  return (col >> 6) * BLOCK + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// A consumer thread's accumulator fragments sit at rows r0 and r0 + 8
// (r0 % 8 == g) and columns 8j + 2t of its share of a tile. frag_base is
// the byte offset of (r0, 2t) in its first 64-column block, made opaque to
// the compiler at each epilogue so that it recomputes the 64 fragment
// offsets there instead of keeping them in registers across the tile;
// frag_off adds n8 block j and row half h.
__device__ __forceinline__ uint32_t frag_base(int block, int r0, int t) {
  uint32_t v = block * BLOCK + r0 * 128 + 4 * t;
  asm volatile("" : "+r"(v));
  return v;
}

// v, hidden from the compiler's loop-invariant code motion.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ uint32_t frag_off(uint32_t base, int g, int j,
                                             int h) {
  return base + (j >> 3) * BLOCK + h * 1024 + (((j & 7) ^ g) << 4);
}

__device__ __forceinline__ void st_pair(unsigned char* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

typedef __nv_bfloat162 bf162;

// 16 bytes as four bf16 pairs, and back. The epilogues' bf16 adds and
// multiplies run as packed bf16 instructions (__hadd2, __hmul2): each
// rounds its exact result once, which is the f32 operation rounded to
// bf16, and costs no f32 -> bf16 conversion (a quarter-rate instruction,
// which had bounded the epilogues).
union Pairs {
  uint4 raw;
  bf162 p[4];
};

// Round a warpgroup's accumulator fragments to bf16 and store them at
// their places in a 64-row tile (n8 blocks from column `col` on, up to
// `limit`).
template <int NA>
__device__ __forceinline__ void stage(const float (&acc)[NA],
                                      unsigned char* tile, uint32_t base,
                                      int g, int col, int limit) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    if (col + 8 * j < limit) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        st_pair(tile + frag_off(base, g, j, h), acc[4 * j + 2 * h],
                acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// The weight ring as the consumers see it.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  const unsigned char* base;
  int stage;
  uint32_t phase;
};

__device__ __forceinline__ void advance(Ring& ring) {
  if (++ring.stage == STAGES) {
    ring.stage = 0;
    ring.phase ^= 1;
  }
}

__device__ __forceinline__ void release(Ring& ring, int stage) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(&ring.empty[stage]);
}

// Zero an accumulator right before a product that overwrites it: its old
// values are then dead in between, and their registers free for the
// epilogues (the product's asm reads its accumulators).
template <int N>
__device__ __forceinline__ void clear(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// acc (64 x N per warpgroup) = A (shared tile at a_base, K-major) @ B,
// over `steps` ring stages of KSTEP weight rows, the warpgroup's B at
// b_off in each stage with MN atoms b_lbo bytes apart. With accumulate,
// acc is added to. One stage of wgmma stays in flight; each stage is
// released as soon as its products are done.
template <int KSTEP, int NACC>
__device__ __forceinline__ void product(float (&acc)[NACC], Ring& ring,
                                        uint32_t a_base, int steps,
                                        uint32_t b_off, uint32_t b_lbo,
                                        bool accumulate) {
  int prev = -1;
  for (int s = 0; s < steps; ++s) {
    mbar_wait(&ring.full[ring.stage], ring.phase);
    const uint32_t b = smem_u32(ring.base + ring.stage * STAGE_BYTES) + b_off;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KSTEP / 16; ++kk) {
      const int k = s * KSTEP + kk * 16;
      const uint64_t da =
          desc_sw128(a_base + (k >> 6) * BLOCK + (k & 63) * 2, 16, 1024);
      const uint64_t db = desc_sw128(b + kk * 2048, b_lbo, 1024);
      wgmma_ss(acc, da, db, (accumulate || s > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      release(ring, prev);
    }
    prev = ring.stage;
    advance(ring);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(ring, prev);
}

// The producer's side of the ring: wait for a free stage, announce its
// bytes, return it.
struct Feed {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* base;
  int stage;
  uint32_t phase;
};

__device__ __forceinline__ unsigned char* next_stage(Feed& f, uint32_t bytes,
                                                     uint64_t** bar) {
  mbar_wait(&f.empty[f.stage], f.phase ^ 1);
  *bar = &f.full[f.stage];
  mbar_expect_tx(*bar, bytes);
  unsigned char* s = f.base + f.stage * STAGE_BYTES;
  if (++f.stage == STAGES) {
    f.stage = 0;
    f.phase ^= 1;
  }
  return s;
}

// Stream `steps` stages of BK rows of a [K, C] kernel: 2 * NB boxes of
// [32, 64] each (boxes past C are zero-filled by TMA).
template <int NB>
__device__ __forceinline__ void feed_wide(Feed& f, const CUtensorMap* map,
                                          int row0, int steps) {
  for (int s = 0; s < steps; ++s) {
    uint64_t* bar;
    unsigned char* dst = next_stage(f, 2 * NB * BOX, &bar);
#pragma unroll
    for (int b = 0; b < 2 * NB; ++b) {
      tma_load_2d(dst + b * BOX, map, bar, b * 64, row0 + s * BK);
    }
  }
}

// NB: 64-column blocks of a consumer warpgroup's share of C.
template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
fused_block_tail_kernel(const __grid_constant__ CUtensorMap map_r,
                        const __grid_constant__ CUtensorMap map_xf,
                        const __grid_constant__ CUtensorMap map_skip,
                        const __grid_constant__ CUtensorMap map_ws,
                        const __grid_constant__ CUtensorMap map_wb,
                        const __grid_constant__ CUtensorMap map_fc1,
                        const __grid_constant__ CUtensorMap map_fc2,
                        const __grid_constant__ CUtensorMap map_out,
                        const float* __restrict__ noise,
                        const bf16* __restrict__ skip_b,
                        const bf16* __restrict__ ln_w,
                        const bf16* __restrict__ ln_b,
                        const bf16* __restrict__ fc1_b,
                        const bf16* __restrict__ fc2_b, int N, int C, int H,
                        int NC) {
  constexpr int NACC = NB * 32;  // accumulator registers of a C-wide product
  constexpr int BOX1 = 64 * 64 * 2;  // one [64, 64] bf16 W1 box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int ncp = (NC + 63) / 64 * 64;
  unsigned char* ring_base = smem;
  unsigned char* s_act = ring_base + STAGES * STAGE_BYTES;  // x_f, t, y
  unsigned char* s_big = s_act + C * 128;  // r, then the noise, then h_j
  const int big_cols = max(max(C, ncp), HC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_big + big_cols * 128);
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  // the residual tile (s_big) and the x_f tile (s_act), each with a full
  // and an empty barrier: s_big is free once the last W2 product of a tile
  // is done, so the next residual tile loads during the last epilogue;
  // s_act once the output tile staged in it has been stored
  uint64_t* r_full = bars + 2 * STAGES;
  uint64_t* r_empty = r_full + 1;
  uint64_t* x_full = r_full + 2;
  uint64_t* x_empty = r_full + 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init(r_full, 1);
    mbar_init(r_empty, CONSUMERS / 32);
    mbar_init(x_full, 1);
    mbar_init(x_empty, CONSUMERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (N + ROWS - 1) / ROWS;
  const int k_noise = (NC + BK - 1) / BK;  // noise stages
  const int n_chunks = (H + HC - 1) / HC;

  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: one thread streams the residual tiles and every
    // weight tile, in the order the consumers use them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      Feed f{full, empty, ring_base, 0, 0};
      uint32_t r_phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        mbar_wait(r_empty, r_phase ^ 1);
        mbar_expect_tx(r_full, C * 128);
        for (int b = 0; b < C / 64; ++b) {
          tma_load_2d(s_big + b * BLOCK, &map_r, r_full, b * 64, tile * ROWS);
        }
        mbar_wait(x_empty, r_phase ^ 1);
        r_phase ^= 1;
        mbar_expect_tx(x_full, C * 128);
        for (int b = 0; b < C / 64; ++b) {
          tma_load_2d(s_act + b * BLOCK, &map_xf, x_full, b * 64, tile * ROWS);
        }
        feed_wide<NB>(f, &map_skip, 0, C / BK);
        feed_wide<NB>(f, &map_ws, 0, k_noise);
        feed_wide<NB>(f, &map_wb, 0, k_noise);
        for (int j = 0; j < n_chunks; ++j) {
          for (int s = 0; s < C / 64; ++s) {
            uint64_t* bar;
            unsigned char* dst = next_stage(f, 4 * BOX1, &bar);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              tma_load_2d(dst + b * BOX1, &map_fc1, bar, j * HC + b * 64,
                          s * 64);
            }
          }
          feed_wide<NB>(f, &map_fc2, j * HC, HC / BK);
        }
        // the residual tile once more, for the outer skip, through the
        // ring: four 64-column blocks a stage
        for (int b0 = 0; b0 < C / 64; b0 += 4) {
          const int nb = min(4, C / 64 - b0);
          uint64_t* bar;
          unsigned char* dst = next_stage(f, nb * BLOCK, &bar);
          for (int b = 0; b < nb; ++b) {
            tma_load_2d(dst + b * BLOCK, &map_r, bar, (b0 + b) * 64,
                        tile * ROWS);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = (warp % 4) * 16 + g;  // this thread's rows r0, r0 + 8
    const int col0 = wg * NB * 64 + 2 * t;  // + 8j: C-wide columns
    const uint32_t act = smem_u32(s_act);
    const uint32_t big = smem_u32(s_big);
    Ring ring{full, empty, ring_base, 0, 0};
    uint32_t r_phase = 0;
    float acc[NACC];
    // per-lane channel vectors of the layer norm (C <= 512: two per lane)
    uint4 skb[2], lnw[2], lnb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = min(lane * 8 + 256 * i, C - 8);
      skb[i] = __ldg(reinterpret_cast<const uint4*>(skip_b + c));
      lnw[i] = __ldg(reinterpret_cast<const uint4*>(ln_w + c));
      lnb[i] = __ldg(reinterpret_cast<const uint4*>(ln_b + c));
    }

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row_base = tile * ROWS;
      // this thread's share of the first 64 noise channels, loaded early
      float nz[ROWS / 4];
#pragma unroll
      for (int i = 0; i < ROWS / 4; ++i) {
        const int gr = row_base + threadIdx.x / 64 + 4 * i;
        const int k = threadIdx.x % 64;
        nz[i] = (gr < N && k < NC) ? __ldg(noise + (size_t)gr * NC + k) : 0.f;
      }
      mbar_wait(r_full, r_phase);

      // S = r @ W_skip, rounded, staged over r once both warpgroups are
      // done reading it. The epilogues stage the accumulators in shared
      // memory and then run as short rolled loops over the tile: fully
      // unrolled epilogues run once a tile and are bound by instruction
      // fetch.
      clear(acc);
      product<BK>(acc, ring, big, C / BK, wg * NB * BOX, BOX, false);
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
      stage(acc, s_big, frag_base(wg * NB, r0, t), g, opaque(col0), C);
      mbar_wait(x_full, r_phase);
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

      // t = gelu(x_f + (S + b_skip)), then y = layer_norm(t) * ln_w + ln_b,
      // a warp per row with t kept in registers in between
#pragma unroll 1
      for (int row = warp; row < ROWS; row += CONSUMERS / 32) {
        Pairs tv[2];
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = lane * 8 + 256 * i;
          const uint32_t off = tile_off(row, min(c, C - 8));
          Pairs sv, xv, bv;
          sv.raw = *reinterpret_cast<const uint4*>(s_big + off);
          xv.raw = *reinterpret_cast<const uint4*>(s_act + off);
          bv.raw = skb[i];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(
                __hadd2(xv.p[e], __hadd2(sv.p[e], bv.p[e])));
            tv[i].p[e] = __floats2bfloat162_rn(gelu_tanh(a.x), gelu_tanh(a.y));
            const float2 f = __bfloat1622float2(tv[i].p[e]);
            if (c < C) sum += f.x + f.y;
          }
        }
        const bf162 mean =
            __bfloat162bfloat162(__float2bfloat16(warp_sum(sum) / C));
        float sq = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bf162 d = __hsub2(tv[i].p[e], mean);
            const float2 q = __bfloat1622float2(__hmul2(d, d));
            if (lane * 8 + 256 * i < C) sq += q.x + q.y;
          }
        }
        const bf162 rs = __bfloat162bfloat162(
            __float2bfloat16(1.f / sqrtf(warp_sum(sq) / C + EPS)));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = lane * 8 + 256 * i;
          if (c >= C) continue;
          Pairs wv, bv, yv;
          wv.raw = lnw[i];
          bv.raw = lnb[i];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bf162 y = __hmul2(__hmul2(__hsub2(tv[i].p[e], mean), rs),
                                    wv.p[e]);
            yv.p[e] = __hadd2(y, bv.p[e]);
          }
          *reinterpret_cast<uint4*>(s_act + tile_off(row, c)) = yv.raw;
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

      // the noise tile, rounded to bf16 and zero-padded to ncp channels
#pragma unroll
      for (int i = 0; i < ROWS / 4; ++i) {
        *reinterpret_cast<bf16*>(s_big + tile_off(threadIdx.x / 64 + 4 * i,
                                                  threadIdx.x % 64)) =
            __float2bfloat16(nz[i]);
      }
      for (int kb = 64; kb < ncp; kb += 64) {
        const int k = kb + threadIdx.x % 64;
        for (int i = 0; i < ROWS / 4; ++i) {
          const int row = threadIdx.x / 64 + 4 * i;
          const int gr = row_base + row;
          const float v =
              (gr < N && k < NC) ? __ldg(noise + (size_t)gr * NC + k) : 0.f;
          *reinterpret_cast<bf16*>(s_big + tile_off(row, k)) =
              __float2bfloat16(v);
        }
      }
      consumers_sync();

      // y = y * (1 + n @ W_s), then y = y + n @ W_b, on this warpgroup's
      // columns of s_act
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        clear(acc);
        product<BK>(acc, ring, big, k_noise, wg * NB * BOX, BOX, false);
        const uint32_t fb = frag_base(wg * NB, r0, t);
        const int c0 = opaque(col0);
#pragma unroll
        for (int j = 0; j < NB * 8; ++j) {
          const bool in = c0 + 8 * j < C;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bf162* p = reinterpret_cast<bf162*>(
                s_act + (in ? frag_off(fb, g, j, h) : 0));
            const bf162 a = __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                                  acc[4 * j + 2 * h + 1]);
            const bf162 v =
                pass == 0
                    ? __hmul2(*p, __hadd2(__float2bfloat162_rn(1.f), a))
                    : __hadd2(*p, a);
            if (in) *p = v;
          }
        }
      }
      consumers_sync();

      // out = sum_j gelu(y @ W1[:, j] + b1[j]) @ W2[j, :], in registers
      for (int jc = 0; jc < n_chunks; ++jc) {
        {
          // scoped to the chunk, so that it holds no registers outside it
          float acc1[64];
          clear(acc1);
          product<64>(acc1, ring, act, C / 64, wg * 2 * BOX1, BOX1, false);
          // both warpgroups are done reading h_{j-1}
          asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
          stage(acc1, s_big, frag_base(wg * 2, r0, t), g, 0, HC);
        }
        // gelu(. + b1) over this warpgroup's 64 x 128 half of h_j, in place
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll 1
        for (int i = 0; i < 8; ++i) {
          const int idx = threadIdx.x % 128 + 128 * i;
          const int row = idx / 16;
          const int col = wg * 128 + (idx % 16) * 8;
          const int gcol = jc * HC + col;
          uint4* p = reinterpret_cast<uint4*>(s_big + tile_off(row, col));
          Pairs v, b;
          v.raw = *p;
          b.raw = gcol < H ? __ldg(reinterpret_cast<const uint4*>(fc1_b + gcol))
                           : make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(__hadd2(v.p[e], b.p[e]));
            v.p[e] = __floats2bfloat162_rn(gelu_tanh(a.x), gelu_tanh(a.y));
          }
          *p = v.raw;
        }
        consumers_sync();  // h_j is whole
        if (jc == 0) clear(acc);
        product<BK>(acc, ring, big, HC / BK, wg * NB * BOX, BOX, jc > 0);
      }
      // s_big (h) is read no more
      __syncwarp();
      if (lane == 0) mbar_arrive(r_empty);

      // out = (S + b2) + r with S = h @ W2 rounded, staged in s_act (free
      // since the last W1 product), finished in place and stored by TMA
      stage(acc, s_act, frag_base(wg * NB, r0, t), g, opaque(col0), C);
      // r arrives in one or two ring stages (blocks 0-3, 4-7)
      const int r_st0 = ring.stage;
      mbar_wait(&ring.full[ring.stage], ring.phase);
      advance(ring);
      const int r_st1 = C > 256 ? ring.stage : r_st0;
      if (C > 256) {
        mbar_wait(&ring.full[ring.stage], ring.phase);
        advance(ring);
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
      const int vpr = C / 8;  // 8-channel vectors a row
#pragma unroll 4
      for (int idx = threadIdx.x; idx < ROWS * vpr; idx += CONSUMERS) {
        const int row = idx / vpr;
        const int c = (idx % vpr) * 8;
        uint4* p = reinterpret_cast<uint4*>(s_act + tile_off(row, c));
        const unsigned char* rs =
            ring.base + (c < 256 ? r_st0 : r_st1) * STAGE_BYTES;
        Pairs sv, bv, rv;
        rv.raw = *reinterpret_cast<const uint4*>(rs + tile_off(row, c & 255));
        bv.raw = __ldg(reinterpret_cast<const uint4*>(fc2_b + c));
        sv.raw = *p;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sv.p[e] = __hadd2(__hadd2(sv.p[e], bv.p[e]), rv.p[e]);
        }
        *p = sv.raw;
      }
      consumers_sync();
      release(ring, r_st0);
      if (C > 256) release(ring, r_st1);
      if (threadIdx.x == 0) {
        for (int b = 0; b < C / 64; ++b) {
          tma_store_2d(&map_out, s_act + b * BLOCK, b * 64, row_base);
        }
        tma_store_wait_read();
      }
      // the store has read s_act: the next x_f tile may land there
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(x_empty);
      r_phase ^= 1;
    }
    if (threadIdx.x == 0) tma_store_wait_all();
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

// A rank-2 bf16 tiled map over a row-major [rows, cols] tensor with boxes of
// [box_rows, 64], 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
              uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
int launch(const CUtensorMap* maps, const void* noise,
           const void* skip_b, const void* ln_w, const void* ln_b,
           const void* fc1_b, const void* fc2_b, int N, int C, int H, int NC,
           int smem_bytes, cudaStream_t stream) {
  auto kernel = fused_block_tail_kernel<NB>;
  static int launch_regs = -1;
  if (launch_regs < 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    launch_regs = attr.numRegs;
  }
  // the consumers' setmaxnreg request must fit what the block holds
  if (launch_regs * THREADS <
      CONSUMERS * CONSUMER_REGS + (THREADS - CONSUMERS) * PRODUCER_REGS) {
    return cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int tiles = (N + ROWS - 1) / ROWS;
  kernel<<<tiles < sms ? tiles : sms, THREADS, smem_bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      static_cast<const float*>(noise), static_cast<const bf16*>(skip_b),
      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(fc1_b), static_cast<const bf16*>(fc2_b), N, C,
      H, NC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success).
// Rows are [N, C] bf16 (x_f, resid, out) and [N, NC] f32 (noise); dense
// kernels are [in, out] bf16, vectors bf16. Pointers must be 16-byte
// aligned and contiguous; C and H multiples of 64, C <= 512, NC >= 1.
// smem_bytes is the dynamic shared memory the wrapper computed for
// (C, H, NC).
extern "C" int fused_block_tail_forward(
    const void* xf, const void* resid, const void* noise, const void* skip_k,
    const void* skip_b, const void* ln_w, const void* ln_b, const void* w_s,
    const void* w_b, const void* fc1_k, const void* fc1_b, const void* fc2_k,
    const void* fc2_b, void* out, int N, int C, int H, int NC, int smem_bytes,
    void* stream) {
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap maps[8];
  if (!make_map(&maps[0], resid, N, C, ROWS) ||
      !make_map(&maps[1], xf, N, C, ROWS) ||
      !make_map(&maps[2], skip_k, C, C, BK) ||
      !make_map(&maps[3], w_s, NC, C, BK) ||
      !make_map(&maps[4], w_b, NC, C, BK) ||
      !make_map(&maps[5], fc1_k, C, H, 64) ||
      !make_map(&maps[6], fc2_k, H, C, BK) ||
      !make_map(&maps[7], out, N, C, ROWS)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define TAIL_LAUNCH(NB)                                                      \
  launch<NB>(maps, noise, skip_b, ln_w, ln_b, fc1_b, fc2_b, N, C, H, \
             NC, smem_bytes, s)
  switch ((C / 64 + 1) / 2) {
    case 1: return TAIL_LAUNCH(1);
    case 2: return TAIL_LAUNCH(2);
    case 3: return TAIL_LAUNCH(3);
    case 4: return TAIL_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef TAIL_LAUNCH
}
