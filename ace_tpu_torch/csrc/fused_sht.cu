// Fused forward real SHT for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ace_tpu/ops/pallas_sht.py:fused_sht
// (_kernel :44, grid :108), reached through RealSHT.forward_fused. For
// channels-last x [B, K, J, C] (K latitudes, J longitudes), all float32:
//
//   xm[b, k, m, c]  = sum_j x[b, k, j, c] * dft[j, m]     (cos and sin)
//   out[b, l, m, c] = sum_k leg[k, l, m] * xm[b, k, m, c]
//
// with dft_r, dft_i [J, M] and the weighted Legendre table leg [K, L, M].
//
// What bounds it: at the flagship shape (B=1, K=L=180, J=360, M=181,
// C=512) the function needs 30.0 GFLOP of f32 (24.0 in the DFT, 6.0 in the
// Legendre contraction over the table's nonzero l >= m half) and moves
// ~290 MB (x read once, both outputs written once, the tables once), so at
// 67 TFLOP/s of f32 outside the tensor cores and 3.35 TB/s it is bound by
// its operations (~0.45 ms against ~0.087 ms of memory time). This kernel
// does the dense 36.0 GFLOP (see below). TF32 tensor cores would give
// another result, so the products are f32 FMAs.
//
// What the design does about it: the TPU kernel accumulates over k in
// output blocks revisited by a sequential grid; Hopper's blocks run in no
// order, so here one block owns an output tile (8 modes m x 8 channels c x
// up to 192 degrees l, the sums in registers, 96 a thread) and walks k
// itself, 4 latitudes a step. Each step computes the DFT of its latitudes
// for the block's 8 x 8 (m, c) pairs (one sum over J per thread) into
// shared memory and contracts it at once against the table slice
// leg[k, l, m-tile], so the intermediate never touches device memory.
// The x rows and the table slice of the next step are copied in with
// cp.async while the current step computes (two stages, ~71 KB each at
// J = 360; the block's DFT columns are loaded once), so the copies'
// latency hides behind the FMAs. The price is re-reading: each block reads
// the x slab of its 8 channels once, so x is read ceil(M / 8) = 23 times
// at the flagship shape (3.1 GB, mostly from L2: blocks are ordered with
// the m-tile fastest, so the 23 blocks that share a slab run together),
// and the table ceil(C / 8) = 64 times (1.5 GB from L2). The dense
// contraction also runs over the zero half of the table (l < m), as the
// TPU kernel does. Ragged K, J, M, C and L are masked (zero fill, no
// store); L above 192 takes several l-chunks, each recomputing the DFT.
// Each thread sums in the order of a plain GEMM (j, then k, ascending,
// one FMA a term).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MT = 8;      // modes m per block
constexpr int CT = 8;      // channels c per block
constexpr int MC = MT * CT;
constexpr int KT = 4;      // latitudes k per step (KT * MC == THREADS)
constexpr int LCH = 192;   // degrees l per block
constexpr int LG = THREADS / MC;  // l groups
constexpr int LPT = LCH / LG;     // degrees per thread
constexpr int LEG_STAGE = KT * LCH * MT;  // floats

static_assert(KT * MC == THREADS, "one DFT sum per thread");

// 4-byte asynchronous copy to shared memory; zero fill when !pred.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy the x rows [k0, k0+KT) x [0, J) x [c0, c0+CT) and the table slice
// [k0, k0+KT) x [l0, l0+LCH) x [m0, m0+MT) into one stage.
__device__ __forceinline__ void load_stage(float* s_x, float* s_leg,
                                           const float* xb, const float* leg,
                                           int k0, int l0, int m0, int c0,
                                           int K, int J, int C, int M,
                                           int L) {
  // x: rows r = k * J + j of CT channels; a thread keeps one channel and
  // steps its row (k, j) without dividing
  constexpr int ROW_STEP = THREADS / CT;
  const int c = threadIdx.x % CT;
  const bool c_ok = c0 + c < C;
  int k = 0;
  int j = threadIdx.x / CT;
  while (j >= J) {
    j -= J;
    ++k;
  }
  for (int r = threadIdx.x / CT; r < KT * J; r += ROW_STEP) {
    const bool ok = c_ok && k0 + k < K;
    cp_async4(s_x + r * CT + c,
              ok ? xb + ((size_t)(k0 + k) * J + j) * C + c0 + c : xb, ok);
    j += ROW_STEP;
    while (j >= J) {
      j -= J;
      ++k;
    }
  }
  for (int v = threadIdx.x; v < LEG_STAGE; v += THREADS) {
    const int k = v / (LCH * MT);
    const int l = (v / MT) % LCH;
    const int m = v % MT;
    const bool ok = k0 + k < K && l0 + l < L && m0 + m < M;
    cp_async4(s_leg + v,
              ok ? leg + ((size_t)(k0 + k) * L + l0 + l) * M + m0 + m : leg,
              ok);
  }
}

__global__ void __launch_bounds__(THREADS)
fused_sht_kernel(const float* __restrict__ x, const float* __restrict__ dft_r,
                 const float* __restrict__ dft_i,
                 const float* __restrict__ leg, float* __restrict__ out_r,
                 float* __restrict__ out_i, int K, int J, int C, int M, int L,
                 int l_chunks) {
  extern __shared__ __align__(16) float smem[];
  const int x_stage = KT * J * CT;
  float* s_x = smem;                             // [2][KT][J][CT]
  float* s_leg = s_x + 2 * x_stage;              // [2][KT][LCH][MT]
  float2* s_dft = reinterpret_cast<float2*>(s_leg + 2 * LEG_STAGE);  // [J][MT]
  float* s_xm_r = reinterpret_cast<float*>(s_dft + J * MT);  // [KT][MC]
  float* s_xm_i = s_xm_r + KT * MC;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * MT;
  const int c0 = blockIdx.y * CT;
  const int b = blockIdx.z / l_chunks;
  const int l0 = (blockIdx.z % l_chunks) * LCH;
  const float* xb = x + (size_t)b * K * J * C;

  // this thread's DFT sum: latitude kq of the step, pair (mq, cq); its
  // output: the pair mc = (mq, cq) at degrees lg + LG * i
  const int kq = tid / MC;
  const int mc = tid % MC;
  const int mq = mc / CT;
  const int cq = mc % CT;
  const int lg = tid / MC;

  const int steps = (K + KT - 1) / KT;
  if (steps > 0) {
    load_stage(s_x, s_leg, xb, leg, 0, l0, m0, c0, K, J, C, M, L);
  }
  cp_async_commit();
  // the block's DFT columns, once
  for (int v = tid; v < J * MT; v += THREADS) {
    const int j = v / MT;
    const int m = v % MT;
    const bool ok = m0 + m < M;
    const size_t off = (size_t)j * M + m0 + m;
    s_dft[v] = ok ? make_float2(dft_r[off], dft_i[off]) : make_float2(0.f, 0.f);
  }

  float acc_r[LPT], acc_i[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) acc_r[i] = acc_i[i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      const int next = (s + 1) & 1;
      load_stage(s_x + next * x_stage, s_leg + next * LEG_STAGE, xb, leg,
                 (s + 1) * KT, l0, m0, c0, K, J, C, M, L);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* sx = s_x + (s & 1) * x_stage + kq * J * CT + cq;
    const float* sl = s_leg + (s & 1) * LEG_STAGE;
    // the DFT of latitude kq for the pair (mq, cq)
    float dr = 0.f, di = 0.f;
#pragma unroll 8
    for (int j = 0; j < J; ++j) {
      const float xv = sx[j * CT];
      const float2 d = s_dft[j * MT + mq];
      dr = fmaf(xv, d.x, dr);
      di = fmaf(xv, d.y, di);
    }
    s_xm_r[kq * MC + mc] = dr;
    s_xm_i[kq * MC + mc] = di;
    __syncthreads();
    // the Legendre contraction of the step's latitudes into the tile
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const float xr = s_xm_r[k * MC + mc];
      const float xi = s_xm_i[k * MC + mc];
      const float* w = sl + k * LCH * MT + lg * MT + mq;
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        acc_r[i] = fmaf(w[i * LG * MT], xr, acc_r[i]);
        acc_i[i] = fmaf(w[i * LG * MT], xi, acc_i[i]);
      }
    }
    __syncthreads();
  }

  const int m = m0 + mq;
  const int c = c0 + cq;
  if (m >= M || c >= C) return;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int l = l0 + lg + LG * i;
    if (l < L) {
      const size_t off = (((size_t)b * L + l) * M + m) * C + c;
      out_r[off] = acc_r[i];
      out_i[off] = acc_i[i];
    }
  }
}

}  // namespace

// Dynamic shared memory of one block for J longitudes.
extern "C" int fused_sht_smem_bytes(int J) {
  return (2 * (KT * J * CT + LEG_STAGE) + 2 * J * MT + 2 * KT * MC) * 4;
}

// Launch on `stream`; returns the first CUDA error (0 on success).
// x [B, K, J, C], dft_r/dft_i [J, M], leg [K, L, M], out_r/out_i
// [B, L, M, C]; all float32 and contiguous. The wrapper checks that
// fused_sht_smem_bytes(J) fits a block.
extern "C" int fused_sht_forward(const void* x, const void* dft_r,
                                 const void* dft_i, const void* leg,
                                 void* out_r, void* out_i, int B, int K,
                                 int J, int C, int M, int L, void* stream) {
  const int smem = fused_sht_smem_bytes(J);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sht_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int l_chunks = (L + LCH - 1) / LCH;
  const dim3 grid((M + MT - 1) / MT, (C + CT - 1) / CT, B * l_chunks);
  fused_sht_kernel<<<grid, THREADS, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dft_r),
      static_cast<const float*>(dft_i), static_cast<const float*>(leg),
      static_cast<float*>(out_r), static_cast<float*>(out_i), K, J, C, M, L,
      l_chunks);
  return static_cast<int>(cudaGetLastError());
}
