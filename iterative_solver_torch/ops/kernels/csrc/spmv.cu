// Block-sparse (BSR) action y = x A^T on Hopper (sm_90a).
//
// Replaces the Pallas kernel of iterative_solver_tpu/ops/kernels/spmv_pallas.py:
//   bsr_matmat_f32, bsr_matmat_bf16 <- _bsr_matmat_pallas_impl (K6, :151,
//                                      pallas_call :212), f32 or bf16 values.
//
//   y[:, rb*bm + i] = sum_{k in row rb} sum_j x[:, col_idx[k]*bn + j] * V[k, i, j]
//
// The Pallas kernel runs one grid step per block row, streams that row's
// value blocks HBM->VMEM through two slots and keeps the (m, bm) f32
// accumulator on chip. Here one CTA owns one block row and IC = 32 of its
// output columns (blockIdx.y picks which), so it writes its part of y once,
// needs no atomics and gives the same bits on every run. Splitting a block
// row over bm/IC CTAs costs no extra value traffic: each CTA reads only its
// own IC rows of every block (a contiguous IC x bn slab), and only x, which
// stays in L2, is read again. At the bench operator (64 block rows) this
// gives 256 CTAs instead of 64.
//
// Inside the CTA, lane l of each warp owns output column i0 + l; the four
// warps split the bn inner columns of every staged chunk, and their partial
// sums are added in a fixed order at the end (deterministic). A chunk of JC
// inner columns of the value slab (converted to f32) and of the x tile is
// staged in shared memory per step: a lane reads its value row from shared
// memory with a padded stride (no bank conflicts), and x is read as float4
// broadcasts, MT rows at a time, into MT f32 accumulators in registers
// (MT = 4, 8, 16, 32 or 64, the least that holds m; rows beyond m are
// staged as zeros and never written).
//
// What bounds it on this card: bytes. Every value is read once and does m
// multiply-adds; at m = 16 that is 8 flop per f32 byte, below the CUDA
// cores' ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte). The sum runs in
// f32 at full f32 precision on the CUDA cores (the Pallas kernel asks for
// Precision.HIGHEST); bf16 values are widened exactly. The two-slot
// pipelining of the TPU kernel (cp.async or TMA) is later work: here the
// latency of the value loads is hidden only by the CTAs resident on an SM.
//
// A block row with no blocks writes zeros, so an operator with no blocks at
// all returns zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IC = 32;            // output columns per CTA (one per lane)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int JC = 64;            // inner columns staged per step
constexpr int CW = JC / WARPS;    // inner columns per warp per step
constexpr int VLD = JC + 1;       // padded stride of the staged value slab

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int MT>
__host__ __device__ constexpr int smem_floats() {
  // staging: value slab [IC][VLD] + x chunk [JC][MT + 4];
  // after the loop the same memory holds the partials [WARPS][MT][IC]
  return (IC * VLD + JC * (MT + 4)) > (WARPS * MT * IC)
             ? (IC * VLD + JC * (MT + 4))
             : (WARPS * MT * IC);
}

// VEC: 16-byte loads of the value slab (bn a multiple of 16 / sizeof(T)).
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
bsr_kernel(const float* __restrict__ x, const T* __restrict__ values,
           const int* __restrict__ row_ptr, const int* __restrict__ col_idx,
           float* __restrict__ y, int m, int n, int ny, int bm, int bn) {
  constexpr int XLD = MT + 4;     // float4-aligned stride of staged x
  __shared__ __align__(16) float smem[smem_floats<MT>()];
  float* vs = smem;               // [IC][VLD]
  float* xs = smem + IC * VLD;    // [JC][XLD]; IC * VLD * 4 bytes is 16-aligned

  const int rb = blockIdx.x;
  const int i0 = blockIdx.y * IC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ncols = min(IC, bm - i0);   // valid output columns of this CTA
  const int k0 = row_ptr[rb];
  const int k1 = row_ptr[rb + 1];

  float acc[MT];
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) acc[mm] = 0.0f;

  for (int k = k0; k < k1; ++k) {
    const size_t cb = size_t(col_idx[k]);
    const T* slab = values + size_t(k) * bm * bn + size_t(i0) * bn;
    const float* xb = x + cb * bn;
    for (int j0 = 0; j0 < bn; j0 += JC) {
      const int jn = min(JC, bn - j0);
      __syncthreads();  // the previous chunk is consumed
      if (VEC) {
        constexpr int VW = 16 / sizeof(T);
        for (int e = tid; e < IC * (JC / VW); e += THREADS) {
          const int r = e / (JC / VW);
          const int c = (e % (JC / VW)) * VW;
          float* dst = vs + r * VLD + c;
          if (r < ncols && c < jn) {
            const uint4 raw =
                __ldcs(reinterpret_cast<const uint4*>(slab + size_t(r) * bn + j0 + c));
            const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int q = 0; q < VW; ++q) dst[q] = to_f32<T>(vals[q]);
          } else {
#pragma unroll
            for (int q = 0; q < VW; ++q) dst[q] = 0.0f;
          }
        }
      } else {
        for (int e = tid; e < IC * JC; e += THREADS) {
          const int r = e / JC;
          const int c = e % JC;
          vs[r * VLD + c] =
              (r < ncols && c < jn) ? to_f32<T>(slab[size_t(r) * bn + j0 + c]) : 0.0f;
        }
      }
      for (int e = tid; e < MT * JC; e += THREADS) {
        const int mm = e / JC;
        const int c = e % JC;
        xs[c * XLD + mm] = (mm < m && c < jn) ? xb[size_t(mm) * n + j0 + c] : 0.0f;
      }
      __syncthreads();

      const float* vrow = vs + lane * VLD + warp * CW;
      const float* xcol = xs + warp * CW * XLD;
#pragma unroll 4
      for (int c = 0; c < CW; ++c) {
        const float a = vrow[c];
        const float4* x4 = reinterpret_cast<const float4*>(xcol + c * XLD);
#pragma unroll
        for (int v4 = 0; v4 < MT / 4; ++v4) {
          const float4 h = x4[v4];
          acc[4 * v4 + 0] = fmaf(h.x, a, acc[4 * v4 + 0]);
          acc[4 * v4 + 1] = fmaf(h.y, a, acc[4 * v4 + 1]);
          acc[4 * v4 + 2] = fmaf(h.z, a, acc[4 * v4 + 2]);
          acc[4 * v4 + 3] = fmaf(h.w, a, acc[4 * v4 + 3]);
        }
      }
    }
  }

  // add the warps' partial sums in a fixed order and write y once
  __syncthreads();
  float* red = smem;  // [WARPS][MT][IC]
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) red[(warp * MT + mm) * IC + lane] = acc[mm];
  __syncthreads();
  for (int e = tid; e < MT * IC; e += THREADS) {
    const int mm = e / IC;
    const int l = e % IC;
    if (mm < m && l < ncols) {
      float s = red[mm * IC + l];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += red[(w * MT + mm) * IC + l];
      y[size_t(mm) * ny + size_t(rb) * bm + i0 + l] = s;
    }
  }
}

template <typename T, int MT>
void launch_mt(dim3 grid, cudaStream_t stream, bool vec, const float* x,
               const T* values, const int* row_ptr, const int* col_idx,
               float* y, int m, int n, int ny, int bm, int bn) {
  if (vec)
    bsr_kernel<T, MT, true><<<grid, THREADS, 0, stream>>>(
        x, values, row_ptr, col_idx, y, m, n, ny, bm, bn);
  else
    bsr_kernel<T, MT, false><<<grid, THREADS, 0, stream>>>(
        x, values, row_ptr, col_idx, y, m, n, ny, bm, bn);
}

template <typename T>
int launch(const float* x, const T* values, const int* row_ptr,
           const int* col_idx, float* y, int m, int n, int bm, int bn,
           int n_rb, cudaStream_t stream) {
  const int nchunks = (bm + IC - 1) / IC;
  if (m <= 0 || m > 64 || n <= 0 || bm <= 0 || bn <= 0 || n_rb <= 0 ||
      n % bn != 0 || nchunks > 65535 || size_t(n_rb) * bm > 2147483647u)
    return int(cudaErrorInvalidValue);
  const int ny = n_rb * bm;
  const bool vec = bn % int(16 / sizeof(T)) == 0;
  const dim3 grid(n_rb, nchunks);
  if (m <= 4)
    launch_mt<T, 4>(grid, stream, vec, x, values, row_ptr, col_idx, y, m, n, ny, bm, bn);
  else if (m <= 8)
    launch_mt<T, 8>(grid, stream, vec, x, values, row_ptr, col_idx, y, m, n, ny, bm, bn);
  else if (m <= 16)
    launch_mt<T, 16>(grid, stream, vec, x, values, row_ptr, col_idx, y, m, n, ny, bm, bn);
  else if (m <= 32)
    launch_mt<T, 32>(grid, stream, vec, x, values, row_ptr, col_idx, y, m, n, ny, bm, bn);
  else
    launch_mt<T, 64>(grid, stream, vec, x, values, row_ptr, col_idx, y, m, n, ny, bm, bn);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (m, n_rb*bm) f32, every entry written; x (m, n) f32 with n = n_cb*bn;
// values (nb, bm, bn); row_ptr (n_rb + 1,), col_idx (nb,) int32.
int bsr_matmat_f32(const float* x, const float* values, const int* row_ptr,
                   const int* col_idx, float* y, int m, int n, int bm, int bn,
                   int n_rb, cudaStream_t stream) {
  return launch<float>(x, values, row_ptr, col_idx, y, m, n, bm, bn, n_rb, stream);
}

int bsr_matmat_bf16(const float* x, const __nv_bfloat16* values,
                    const int* row_ptr, const int* col_idx, float* y, int m,
                    int n, int bm, int bn, int n_rb, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, values, row_ptr, col_idx, y, m, n, bm, bn,
                               n_rb, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
