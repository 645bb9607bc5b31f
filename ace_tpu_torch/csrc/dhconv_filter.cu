// Complex dhconv spectral filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ace_tpu/ops/pallas_filter.py:dhconv_filter
// (_kernel :46, grid in _forward :69). For every (b, l), with x[b, l] an
// [M, I] block and w[l] an [I, O] block:
//
//   out_r = x_r w_r - x_i w_i        out_i = x_r w_i + x_i w_r
//
// x_r, x_i are f32 [B, L, M, I] (the forward SHT's output) and are rounded
// to bf16 as they are loaded; w_r, w_i are bf16 [L, I, O]; products
// accumulate in f32 and the outputs are bf16 [B, L, M, O] (the AMP
// contract of ace_tpu/ops/pallas_filter.py:26-30).
//
// What bounds it: at the flagship shape (B=1, L=180, M=181, I=O=512) a
// call moves ~389 MB (x f32 read once, w bf16 read once, out bf16 written
// once) and does 68 GFLOP, so at 3.35 TB/s and 989 TFLOP/s it is bound by
// memory (~0.116 ms against ~0.069 ms of tensor-core time).
//
// What the design does about it: it keeps the TPU kernel's one idea, that
// each staged weight tile feeds both outputs, and it reads x in f32 once
// per output-column tile and rounds it on chip, so no bf16 copy of x is
// ever written to device memory. Blocks are ordered with the output-column
// tile fastest, so the blocks that share an x tile run together and find
// it in L2. Each block computes a 64 x 64 tile of out_r and out_i: four
// warps, each a 32 x 32 quarter, with nvcuda::wmma bf16 16x16x16 fragments
// and f32 accumulators. The contraction over I walks in steps of 32
// through shared memory; -x_i is staged beside x_i so that out_r is one
// accumulator fed by two products. Ragged M and O edges are masked; I must
// be a multiple of 32 and O a multiple of 8 (the wrapper checks). wgmma,
// TMA and a pipelined persistent schedule are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;         // rows (m) of a block's output tile
constexpr int BN = 64;         // columns (o) of a block's output tile
constexpr int BK = 32;         // depth (i) staged per step
constexpr int THREADS = 128;   // four warps, each a 32 x 32 quarter
constexpr int A_LD = BK + 8;   // padded leading dims of the smem tiles
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

constexpr int A_TILE = BM * A_LD;  // bf16 elements
constexpr int B_TILE = BK * B_LD;
constexpr int OPERAND_BYTES = (3 * A_TILE + 2 * B_TILE) * 2;
constexpr int STAGE_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES =
    OPERAND_BYTES > STAGE_BYTES ? OPERAND_BYTES : STAGE_BYTES;

__device__ __forceinline__ void store_bf16x4(bf16* dst, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Write one f32 accumulator tile, staged in smem, to a bf16 output.
__device__ __forceinline__ void write_tile(const float* s_c, bf16* out,
                                           int m0, int o0, int M, int O) {
  for (int v = threadIdx.x; v < BM * (BN / 8); v += THREADS) {
    const int row = v / (BN / 8);
    const int col = (v % (BN / 8)) * 8;
    if (m0 + row < M && o0 + col < O) {
      const float4 a = *reinterpret_cast<const float4*>(s_c + row * C_LD + col);
      const float4 b =
          *reinterpret_cast<const float4*>(s_c + row * C_LD + col + 4);
      uint4 packed;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&packed);
      p[0] = __floats2bfloat162_rn(a.x, a.y);
      p[1] = __floats2bfloat162_rn(a.z, a.w);
      p[2] = __floats2bfloat162_rn(b.x, b.y);
      p[3] = __floats2bfloat162_rn(b.z, b.w);
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + row) * O + o0 + col) =
          packed;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
dhconv_filter_kernel(const float* __restrict__ xr,
                     const float* __restrict__ xi,
                     const bf16* __restrict__ wr,
                     const bf16* __restrict__ wi,
                     bf16* __restrict__ outr, bf16* __restrict__ outi,
                     int L, int M, int I, int O) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* s_xr = reinterpret_cast<bf16*>(smem);
  bf16* s_xi = s_xr + A_TILE;
  bf16* s_xn = s_xi + A_TILE;
  bf16* s_wr = s_xn + A_TILE;
  bf16* s_wi = s_wr + B_TILE;
  float* s_c = reinterpret_cast<float*>(smem);

  const int o0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const size_t bl = blockIdx.z;  // b * L + l
  const size_t l = bl % L;
  const float* xr_bl = xr + bl * M * I;
  const float* xi_bl = xi + bl * M * I;
  const bf16* wr_l = wr + l * I * O;
  const bf16* wi_l = wi + l * I * O;

  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_r[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_i[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc_r[i][j], 0.0f);
      wmma::fill_fragment(acc_i[i][j], 0.0f);
    }
  }

  for (int k0 = 0; k0 < I; k0 += BK) {
    // x tiles: BM x BK f32 -> bf16 (and -x_i), zero rows past M
    for (int v = threadIdx.x; v < BM * (BK / 4); v += THREADS) {
      const int row = v / (BK / 4);
      const int col = (v % (BK / 4)) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 b = a;
      if (m0 + row < M) {
        const size_t off = (size_t)(m0 + row) * I + k0 + col;
        a = *reinterpret_cast<const float4*>(xr_bl + off);
        b = *reinterpret_cast<const float4*>(xi_bl + off);
      }
      store_bf16x4(s_xr + row * A_LD + col, a);
      store_bf16x4(s_xi + row * A_LD + col, b);
      store_bf16x4(s_xn + row * A_LD + col,
                   make_float4(-b.x, -b.y, -b.z, -b.w));
    }
    // w tiles: BK x BN bf16, zero columns past O (O % 8 == 0)
    for (int v = threadIdx.x; v < BK * (BN / 8); v += THREADS) {
      const int row = v / (BN / 8);
      const int col = (v % (BN / 8)) * 8;
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      uint4 b = a;
      if (o0 + col < O) {
        const size_t off = (size_t)(k0 + row) * O + o0 + col;
        a = *reinterpret_cast<const uint4*>(wr_l + off);
        b = *reinterpret_cast<const uint4*>(wi_l + off);
      }
      *reinterpret_cast<uint4*>(s_wr + row * B_LD + col) = a;
      *reinterpret_cast<uint4*>(s_wi + row * B_LD + col) = b;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a_r[2], a_i[2], a_n[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          b_r[2], b_i[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (wm + 16 * i) * A_LD + kk;
        wmma::load_matrix_sync(a_r[i], s_xr + r, A_LD);
        wmma::load_matrix_sync(a_i[i], s_xi + r, A_LD);
        wmma::load_matrix_sync(a_n[i], s_xn + r, A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = kk * B_LD + wn + 16 * j;
        wmma::load_matrix_sync(b_r[j], s_wr + c, B_LD);
        wmma::load_matrix_sync(b_i[j], s_wi + c, B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc_r[i][j], a_r[i], b_r[j], acc_r[i][j]);
          wmma::mma_sync(acc_r[i][j], a_n[i], b_i[j], acc_r[i][j]);
          wmma::mma_sync(acc_i[i][j], a_r[i], b_i[j], acc_i[i][j]);
          wmma::mma_sync(acc_i[i][j], a_i[i], b_r[j], acc_i[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: stage each f32 tile in smem (reusing the operand space),
  // then round to bf16 and write 16 bytes per thread
  bf16* out_r = outr + bl * M * O;
  bf16* out_i = outi + bl * M * O;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(s_c + (wm + 16 * i) * C_LD + wn + 16 * j,
                              acc_r[i][j], C_LD, wmma::mem_row_major);
    }
  }
  __syncthreads();
  write_tile(s_c, out_r, m0, o0, M, O);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(s_c + (wm + 16 * i) * C_LD + wn + 16 * j,
                              acc_i[i][j], C_LD, wmma::mem_row_major);
    }
  }
  __syncthreads();
  write_tile(s_c, out_i, m0, o0, M, O);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// batch_l = B * L. Pointers must be 16-byte aligned and contiguous.
extern "C" int dhconv_filter_forward(const void* xr, const void* xi,
                                     const void* wr, const void* wi,
                                     void* outr, void* outi, int batch_l,
                                     int L, int M, int I, int O,
                                     void* stream) {
  const dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM, batch_l);
  dhconv_filter_kernel<<<grid, THREADS, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const bf16*>(wr), static_cast<const bf16*>(wi),
      static_cast<bf16*>(outr), static_cast<bf16*>(outi), L, M, I, O);
  return static_cast<int>(cudaGetLastError());
}
