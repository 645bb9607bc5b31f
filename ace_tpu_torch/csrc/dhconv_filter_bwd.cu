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
// 989 MB (g 267, w 189, dx 534: 0.295 ms at 3.35 TB/s): near the ridge.
//
// What the design does about it (a first, simple version):
// - mma.sync m16n8k16 (bf16 in, f32 accumulators) on 64 x 128 block tiles,
//   8 warps of 32 x 32 each, with both outputs (re and im) of a tile in one
//   block, so every operand tile loaded feeds four products.
// - g and w stream by cp.async through a 3-stage ring of 32-deep stages;
//   both operands are K-contiguous, so fragments come straight from
//   ldmatrix. The transposed weight w^T is only an addressing choice: no
//   transposed copy is made.
// - The minus sign flips the sign bits of a bf16 fragment (exact).
// - The blocks of one l run next to each other, so their operands leave
//   device memory about once and are re-read from L2 by the other tiles.
// Rows past M (and columns past I or O) are zero-filled on load and
// dropped on store. The wrapper checks I % 8 == 0 and O % 8 == 0 (16-byte
// copies) and 16-byte alignment.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;     // rows (m) of a block tile
constexpr int BN = 128;    // columns (i) of a block tile
constexpr int BK = 32;     // contraction depth of a stage
constexpr int THREADS = 256;
// stage rows of BK bf16 padded to 40 (80 bytes: ldmatrix rows fall in
// distinct 16-byte bank groups)
constexpr int DX_PITCH = BK + 8;
constexpr int DX_STAGES = 3;
constexpr int DX_STAGE_ELEMS = 2 * BM * DX_PITCH + 2 * BN * DX_PITCH;
constexpr int DX_SMEM_BYTES = DX_STAGES * DX_STAGE_ELEMS * 2;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void negate(uint32_t (&dst)[4],
                                       const uint32_t (&src)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = src[i] ^ 0x80008000u;
}

// The four products of one warp's 32 x 32 tile of both outputs for one
// 16-deep step, from A fragments a_r, a_i [2 row tiles] and B fragments
// b_r, b_i [4 column tiles][2]:
//   out_r += a_r b_r + a_i b_i      out_i += a_i b_r - a_r b_i
__device__ __forceinline__ void products(float (&acc_r)[2][4][4],
                                         float (&acc_i)[2][4][4],
                                         const uint32_t (&a_r)[2][4],
                                         const uint32_t (&a_i)[2][4],
                                         const uint32_t (&b_r)[4][2],
                                         const uint32_t (&b_i)[4][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t neg[4];
    negate(neg, a_r[mt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma(acc_r[mt][nt], a_r[mt], b_r[nt][0], b_r[nt][1]);
      mma(acc_r[mt][nt], a_i[mt], b_i[nt][0], b_i[nt][1]);
      mma(acc_i[mt][nt], a_i[mt], b_r[nt][0], b_r[nt][1]);
      mma(acc_i[mt][nt], neg, b_i[nt][0], b_i[nt][1]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
dhconv_dx_kernel(const bf16* __restrict__ gr, const bf16* __restrict__ gi,
                 const bf16* __restrict__ wr, const bf16* __restrict__ wi,
                 float* __restrict__ dxr, float* __restrict__ dxi, int B,
                 int L, int M, int I, int O, int n_mt, int n_nt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  // block order: column tile fastest, then row tile, then b, then l
  int id = blockIdx.x;
  const int nt_blk = id % n_nt;
  id /= n_nt;
  const int mt_blk = id % n_mt;
  id /= n_mt;
  const int b = id % B;
  const int l = id / B;
  const long long bl = static_cast<long long>(b) * L + l;
  const int m0 = mt_blk * BM;
  const int i0 = nt_blk * BN;
  const bf16* g_base[2] = {gr + bl * M * O, gi + bl * M * O};
  const bf16* w_base[2] = {wr + static_cast<long long>(l) * I * O,
                           wi + static_cast<long long>(l) * I * O};

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm0 = (warp / 4) * 32;  // warp's rows within the tile
  const int wn0 = (warp % 4) * 32;  // warp's columns within the tile
  const int nk = (O + BK - 1) / BK;

  auto stage_ptr = [&](int s) { return smem + s * DX_STAGE_ELEMS; };
  // one stage: g_r, g_i [BM][BK] then w_r, w_i [BN][BK], rows padded
  auto load = [&](int kt, int s) {
    bf16* st = stage_ptr(s);
    const int k0 = kt * BK;
    // 16-byte chunks: g_r, g_i BM rows x 4 (one a thread each), w_r, w_i
    // BN rows x 4 (two a thread each)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = tid / 4, k = k0 + (tid % 4) * 8;
      const bool valid = (m0 + row < M) && (k < O);
      cp_async16(st + c * BM * DX_PITCH + row * DX_PITCH + (tid % 4) * 8,
                 valid ? g_base[c] + static_cast<long long>(m0 + row) * O + k
                       : g_base[c],
                 valid ? 16 : 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = tid + h * THREADS;
        const int wrow = idx / 4, wk = k0 + (idx % 4) * 8;
        const bool wvalid = (i0 + wrow < I) && (wk < O);
        cp_async16(st + 2 * BM * DX_PITCH + c * BN * DX_PITCH +
                       wrow * DX_PITCH + (idx % 4) * 8,
                   wvalid ? w_base[c] + static_cast<long long>(i0 + wrow) * O +
                                wk
                          : w_base[c],
                   wvalid ? 16 : 0);
      }
    }
  };

  float acc_r[2][4][4], acc_i[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_r[a][c][e] = acc_i[a][c][e] = 0.f;

#pragma unroll
  for (int s = 0; s < DX_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  const int j = lane / 8, r = lane % 8;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<DX_STAGES - 2>();
    __syncthreads();
    if (kt + DX_STAGES - 1 < nk) {
      load(kt + DX_STAGES - 1, (kt + DX_STAGES - 1) % DX_STAGES);
    }
    cp_async_commit();
    const bf16* st = stage_ptr(kt % DX_STAGES);
    const bf16* sg[2] = {st, st + BM * DX_PITCH};
    const bf16* sw[2] = {st + 2 * BM * DX_PITCH,
                         st + 2 * BM * DX_PITCH + BN * DX_PITCH};
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][2][4];   // [re/im][row tile]
      uint32_t bw[2][4][2];  // [re/im][column tile][half]
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // matrices: rows +0/+8 (j % 2), k +0/+8 (j / 2)
          ldmatrix_x4(a[c][mt], sg[c] + (wm0 + mt * 16 + (j % 2) * 8 + r) *
                                            DX_PITCH +
                                    kk * 16 + (j / 2) * 8);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          // matrices: k +0/+8 (j % 2), columns +0/+8 (j / 2)
          uint32_t q[4];
          ldmatrix_x4(q, sw[c] + (wn0 + np * 16 + (j / 2) * 8 + r) * DX_PITCH +
                             kk * 16 + (j % 2) * 8);
          bw[c][2 * np][0] = q[0];
          bw[c][2 * np][1] = q[1];
          bw[c][2 * np + 1][0] = q[2];
          bw[c][2 * np + 1][1] = q[3];
        }
      }
      products(acc_r, acc_i, a[0], a[1], bw[0], bw[1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
  float* out_r = dxr + bl * M * I;
  float* out_i = dxi + bl * M * I;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + mt * 16 + g + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int i = i0 + wn0 + nt * 8 + 2 * t;
        if (i >= I) continue;
        const long long off = static_cast<long long>(m) * I + i;
        *reinterpret_cast<float2*>(out_r + off) =
            make_float2(acc_r[mt][nt][2 * h], acc_r[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(out_i + off) =
            make_float2(acc_i[mt][nt][2 * h], acc_i[mt][nt][2 * h + 1]);
      }
    }
  }
}

}  // namespace

// Launch 1b on `stream`; returns a CUDA error code (0 on success).
// g: bf16 [B, L, M, O]; w: bf16 [L, I, O]; dx: f32 [B, L, M, I].
extern "C" int dhconv_filter_dx(const void* gr, const void* gi,
                                const void* wr, const void* wi, void* dxr,
                                void* dxi, int B, int L, int M, int I, int O,
                                void* stream) {
  const int n_mt = (M + BM - 1) / BM, n_nt = (I + BN - 1) / BN;
  const long long blocks = static_cast<long long>(B) * L * n_mt * n_nt;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dhconv_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DX_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dhconv_dx_kernel<<<static_cast<int>(blocks), THREADS, DX_SMEM_BYTES,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gr), static_cast<const bf16*>(gi),
      static_cast<const bf16*>(wr), static_cast<const bf16*>(wi),
      static_cast<float*>(dxr), static_cast<float*>(dxi), B, L, M, I, O, n_mt,
      n_nt);
  return static_cast<int>(cudaGetLastError());
}
