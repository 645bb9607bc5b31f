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
// in f32 and rounds the 1/sqrt factor to bf16. GELU is the tanh form,
// computed in f32 from the bf16 input and rounded once. The noise arrives
// in f32 and is rounded to bf16 as it is loaded.
//
// What bounds it: at the flagship shape (N = 64,800 rows, C = 512, hidden
// 1024, noise 32) a call does 174 GFLOP of bf16 products and moves ~210 MB
// (x_f, r and out in bf16, the noise in f32, the weights once), so at
// 989 TFLOP/s and 3.35 TB/s it is bound by its operations (~0.176 ms
// against ~0.063 ms of memory time).
//
// What the design does about it: the layer norm needs whole rows, so a
// block owns a tile of 64 rows at full C and keeps every intermediate of
// the chain on chip: t and y in one bf16 tile, and in turn the residual,
// the noise and the hidden activations (64 x 1024) in a second one, so
// x_f and the noise are read once, r twice (the second time for the outer
// skip, mostly from L2) and only out is written. The four products are
// one routine: the A operand is the tile in shared memory, the weights
// (2.7 MB, kept in L2) stream through a three-stage cp.async ring in
// 32 x 64 steps (two in flight while one is multiplied), eight warps each
// own a 16 x 32 piece of a 64 x 64 output chunk (nvcuda::wmma bf16
// 16x16x16, f32 accumulators), and each chunk is staged in f32 through
// shared memory for its elementwise epilogue. The tiles take ~230 KB of
// shared memory, so one block runs on an SM. Rows past N are zero-filled
// and never stored; the noise channels are zero-padded to a multiple of
// 32 (the TPU pads rows to 1024 and the noise to 128 lanes instead). C
// and hidden must be multiples of 64 (the wrapper checks). wgmma, TMA and
// a register-resident fc2 accumulator are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;       // rows of a block's tile
constexpr int THREADS = 256;   // eight warps
constexpr int NCH = 64;        // output columns per chunk
constexpr int BK = 32;         // weight rows per stage
constexpr int W_LD = NCH + 8;  // padded leading dims of the smem tiles
constexpr int S_LD = NCH + 4;
constexpr int W_STAGE = BK * W_LD;  // bf16 elements per weight stage
constexpr int STAGES = 3;           // weight stages in the ring
constexpr float EPS = 1e-5f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float beta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kappa = 0.044715f;
  return 0.5f * x * (1.f + tanhf(beta * (x + kappa * (x * x * x))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte asynchronous copy to shared memory; zero fill when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage W[k0:k0+BK, n0:n0+NCH] (rows past k_real zero) into s_w.
__device__ __forceinline__ void load_w_stage(bf16* s_w, const bf16* w, int k0,
                                             int n0, int k_real, int ncols) {
  const int row = threadIdx.x / (NCH / 8);
  const int col = (threadIdx.x % (NCH / 8)) * 8;
  const int k = k0 + row;
  const bool ok = k < k_real;
  cp_async16(s_w + row * W_LD + col,
             ok ? w + (size_t)k * ncols + n0 + col : w, ok);
}

// s_stage[ROWS][S_LD] = s_a[ROWS, 0:k] @ w[0:k, n0:n0+NCH] in f32, with the
// A tile in shared memory (row stride lda) and w [k_real, ncols] in device
// memory. k is a multiple of BK; rows of w past k_real read as zero. The
// weight steps stream through a ring of STAGES buffers, STAGES - 1 ahead.
__device__ void gemm_chunk(const bf16* s_a, int lda, int k, int k_real,
                           const bf16* w, int ncols, int n0, bf16* s_w,
                           float* s_stage) {
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 16;
  const int wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  const int steps = k / BK;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < steps) load_w_stage(s_w + p * W_STAGE, w, p * BK, n0, k_real, ncols);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // step s has landed, and every warp is done with step s - 1, whose
    // buffer the next copy reuses
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int ahead = s + STAGES - 1;
    if (ahead < steps) {
      load_w_stage(s_w + (ahead % STAGES) * W_STAGE, w, ahead * BK, n0,
                   k_real, ncols);
    }
    cp_async_commit();
    const bf16* s_ws = s_w + (s % STAGES) * W_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, s_a + wm * lda + s * BK + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, s_ws + kk * W_LD + wn + 16 * j, W_LD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(s_stage + wm * S_LD + wn + 16 * j, acc[j], S_LD,
                            wmma::mem_row_major);
  }
  __syncthreads();
}

// Eight consecutive f32 values of the staged chunk, rounded to bf16 (the
// rounding of a product's sum before its bias).
__device__ __forceinline__ void staged8(const float* s_stage, int row, int col,
                                        float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(s_stage + row * S_LD + col);
  const float4 b =
      *reinterpret_cast<const float4*>(s_stage + row * S_LD + col + 4);
  v[0] = round_bf16(a.x); v[1] = round_bf16(a.y);
  v[2] = round_bf16(a.z); v[3] = round_bf16(a.w);
  v[4] = round_bf16(b.x); v[5] = round_bf16(b.y);
  v[6] = round_bf16(b.z); v[7] = round_bf16(b.w);
}

__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 raw;
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__global__ void __launch_bounds__(THREADS)
fused_block_tail_kernel(const bf16* __restrict__ xf,
                        const bf16* __restrict__ resid,
                        const float* __restrict__ noise,
                        const bf16* __restrict__ skip_k,
                        const bf16* __restrict__ skip_b,
                        const bf16* __restrict__ ln_w,
                        const bf16* __restrict__ ln_b,
                        const bf16* __restrict__ w_s,
                        const bf16* __restrict__ w_b,
                        const bf16* __restrict__ fc1_k,
                        const bf16* __restrict__ fc1_b,
                        const bf16* __restrict__ fc2_k,
                        const bf16* __restrict__ fc2_b,
                        bf16* __restrict__ out, int N, int C, int H, int NC) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ncp = (NC + 31) / 32 * 32;
  const int act_ld = C + 8;
  const int big_ld = max(max(C, H), ncp) + 8;
  const int noise_ld = ncp + 8;
  const int h_ld = H + 8;
  bf16* s_act = reinterpret_cast<bf16*>(smem);  // t, then y
  bf16* s_big = s_act + ROWS * act_ld;          // r, then noise, then h
  float* s_stage = reinterpret_cast<float*>(s_big + ROWS * big_ld);
  bf16* s_w = reinterpret_cast<bf16*>(s_stage + ROWS * S_LD);  // the ring

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  constexpr int ITEMS = ROWS * NCH / 8;  // 8-column groups of a chunk

  // residual tile -> s_big (rows past N zero)
  for (int v = tid; v < ROWS * (C / 8); v += THREADS) {
    const int row = v / (C / 8);
    const int col = (v % (C / 8)) * 8;
    const bool ok = row0 + row < N;
    cp_async16(s_big + row * act_ld + col,
               ok ? resid + (size_t)(row0 + row) * C + col : resid, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // t = gelu(x_f + (r @ W_skip + b_skip)) -> s_act
  for (int n0 = 0; n0 < C; n0 += NCH) {
    gemm_chunk(s_big, act_ld, C, C, skip_k, C, n0, s_w, s_stage);
    for (int v = tid; v < ITEMS; v += THREADS) {
      const int row = v / (NCH / 8);
      const int col = (v % (NCH / 8)) * 8;
      const int g = row0 + row;
      float s[8], a[8], b[8];
      staged8(s_stage, row, col, s);
      load8(skip_b + n0 + col, b);
      if (g < N) {
        load8(xf + (size_t)g * C + n0 + col, a);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] = gelu_tanh(round_bf16(a[i] + round_bf16(s[i] + b[i])));
      }
      store8(s_act + row * act_ld + n0 + col, s);
    }
    __syncthreads();
  }

  // layer norm over C, one warp per row, then the affine weights
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int row = warp; row < ROWS; row += THREADS / 32) {
    bf16* p = s_act + row * act_ld;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += __bfloat162float(p[c]);
    const float mean = round_bf16(warp_sum(sum) / C);
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xc = round_bf16(__bfloat162float(p[c]) - mean);
      sq += round_bf16(xc * xc);
    }
    const float rs = round_bf16(1.f / sqrtf(warp_sum(sq) / C + EPS));
    for (int c = lane; c < C; c += 32) {
      const float xc = round_bf16(__bfloat162float(p[c]) - mean);
      float y = round_bf16(xc * rs);
      y = round_bf16(y * __bfloat162float(ln_w[c]));
      y = y + __bfloat162float(ln_b[c]);
      p[c] = __float2bfloat16(y);
    }
  }

  // noise tile, rounded to bf16, zero-padded to ncp channels -> s_big
  for (int v = tid; v < ROWS * ncp; v += THREADS) {
    const int row = v / ncp;
    const int k = v % ncp;
    const int g = row0 + row;
    const float val = (g < N && k < NC) ? noise[(size_t)g * NC + k] : 0.f;
    s_big[row * noise_ld + k] = __float2bfloat16(val);
  }
  __syncthreads();

  // y = y * (1 + n @ W_s), then y = y + n @ W_b
  for (int pass = 0; pass < 2; ++pass) {
    for (int n0 = 0; n0 < C; n0 += NCH) {
      gemm_chunk(s_big, noise_ld, ncp, NC, pass == 0 ? w_s : w_b, C, n0, s_w,
                 s_stage);
      for (int v = tid; v < ITEMS; v += THREADS) {
        const int row = v / (NCH / 8);
        const int col = (v % (NCH / 8)) * 8;
        float s[8], y[8];
        staged8(s_stage, row, col, s);
        bf16* p = s_act + row * act_ld + n0 + col;
        load8(p, y);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          y[i] = pass == 0 ? y[i] * round_bf16(1.f + s[i]) : y[i] + s[i];
        }
        store8(p, y);
      }
      __syncthreads();
    }
  }

  // h = gelu(y @ W1 + b1) -> s_big
  for (int n0 = 0; n0 < H; n0 += NCH) {
    gemm_chunk(s_act, act_ld, C, C, fc1_k, H, n0, s_w, s_stage);
    for (int v = tid; v < ITEMS; v += THREADS) {
      const int row = v / (NCH / 8);
      const int col = (v % (NCH / 8)) * 8;
      float s[8], b[8];
      staged8(s_stage, row, col, s);
      load8(fc1_b + n0 + col, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = gelu_tanh(round_bf16(s[i] + b[i]));
      store8(s_big + row * h_ld + n0 + col, s);
    }
    __syncthreads();
  }

  // out = (h @ W2 + b2) + r
  for (int n0 = 0; n0 < C; n0 += NCH) {
    gemm_chunk(s_big, h_ld, H, H, fc2_k, C, n0, s_w, s_stage);
    for (int v = tid; v < ITEMS; v += THREADS) {
      const int row = v / (NCH / 8);
      const int col = (v % (NCH / 8)) * 8;
      const int g = row0 + row;
      if (g >= N) continue;
      float s[8], b[8], r[8];
      staged8(s_stage, row, col, s);
      load8(fc2_b + n0 + col, b);
      load8(resid + (size_t)g * C + n0 + col, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = round_bf16(s[i] + b[i]) + r[i];
      store8(out + (size_t)g * C + n0 + col, s);
    }
    __syncthreads();
  }
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success).
// Rows are [N, C] bf16 (x_f, resid, out) and [N, NC] f32 (noise); dense
// kernels are [in, out] bf16, vectors bf16. Pointers must be 16-byte
// aligned and contiguous; C and H multiples of 64. smem_bytes is the
// dynamic shared memory the wrapper computed for (C, H, NC).
extern "C" int fused_block_tail_forward(
    const void* xf, const void* resid, const void* noise, const void* skip_k,
    const void* skip_b, const void* ln_w, const void* ln_b, const void* w_s,
    const void* w_b, const void* fc1_k, const void* fc1_b, const void* fc2_k,
    const void* fc2_b, void* out, int N, int C, int H, int NC, int smem_bytes,
    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + ROWS - 1) / ROWS);
  fused_block_tail_kernel<<<grid, THREADS, smem_bytes,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xf), static_cast<const bf16*>(resid),
      static_cast<const float*>(noise), static_cast<const bf16*>(skip_k),
      static_cast<const bf16*>(skip_b), static_cast<const bf16*>(ln_w),
      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(w_s),
      static_cast<const bf16*>(w_b), static_cast<const bf16*>(fc1_k),
      static_cast<const bf16*>(fc1_b), static_cast<const bf16*>(fc2_k),
      static_cast<const bf16*>(fc2_b), static_cast<bf16*>(out), N, C, H, NC);
  return static_cast<int>(cudaGetLastError());
}
