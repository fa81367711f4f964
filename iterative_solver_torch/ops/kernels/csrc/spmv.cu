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
// accumulator on chip. Here:
//
// - Work split. One CTA owns one block row and IC output columns of it:
//   IC = 128 where m <= 16, bm > 64 and that still gives two CTAs per SM
//   (the phenol scale: one CTA stages each x tile once for the whole
//   block row), else 32 (the bench operator's 64 block rows: 256 CTAs);
//   ``spmv.bsr_columns_per_cta`` chooses. CTA b takes block row
//   b / ceil(bm / IC) and column chunk b % ceil(bm / IC): the chunks of
//   one block row run side by side, so the x tiles they share are fetched
//   from HBM once and then read from L2. A CTA reads only its own IC rows
//   of each block (a contiguous IC x bn slab) and writes its outputs once:
//   no atomics, each output summed by one owner in the row's block order,
//   the same bits on every run. ``spmv.bsr_work_items`` lists the same
//   split for the CPU tests.
// - The TPU kernel's two-slot stream, done the Hopper way. The CTA's
//   blocks, cut into steps of JC = 64 inner columns, form one stream that
//   runs through a ring of cp.async copies across block boundaries (as
//   many stages as 104 KB hold, 2 to 8: 8 at m = 16 and 32 columns, 2 at
//   128 columns); a stage holds the value slab's step (staged raw: bf16
//   is widened when read) and the matching x step, both row-major along
//   the contraction, with padded strides (68 floats, 72 bf16) that make
//   the 16-byte (8-byte for bf16) reads free of bank conflicts.
// - FMAs per shared-memory read. The 4 warps form WC column groups (1 at
//   IC = 32, 2 at IC = 128) whose warps split each step's 16 float4s of
//   the contraction; a lane owns R = MT/4 rows of x by C = IC / (8 WC)
//   output columns (4 or 8; MT = 4..64, the least that holds m), reading
//   R + C float4s for 4 R C FMAs (at m = 16 and IC = 128: 12 reads, 128
//   FMAs). The warps' sums are added in warp order at the end.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W): at m = 16
// every f32 value is read once and does 16 multiply-adds, 8 flop per byte,
// under the CUDA cores' ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte):
// bytes bound it, and the ring keeps 40 to 90 KB of copies in flight per
// CTA. At
// m = 64 (32 flop per f32 byte, 64 per bf16 byte) it crosses the ridge and
// f32 operations bound it. The sum runs in full f32 on the CUDA cores (the
// Pallas kernel asks for Precision.HIGHEST); bf16 values are widened
// exactly. No TF32, no tensor cores.
//
// A block row with no blocks writes zeros, so an operator with no blocks at
// all returns zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;             // warps: column groups x shares of the contraction
constexpr int THREADS = 32 * NW;
constexpr int JC = 64;            // inner columns per step
constexpr int XLD = JC + 4;       // padded stride of a staged x row (floats)
constexpr int RING_BYTES = 104 * 1024;  // ring of a CTA: two CTAs fit an SM
constexpr int MAX_STAGES = 8;

template <typename T>
struct Vals;
template <>
struct Vals<float> {
  static constexpr int LD = JC + 4;   // 272 bytes: float4 reads of 8 rows hit 32 banks
  __device__ static float4 read4(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static float zero() { return 0.0f; }
};
template <>
struct Vals<__nv_bfloat16> {
  static constexpr int LD = JC + 8;   // 144 bytes: 16-byte aligned, 8-byte reads conflict-free
  __device__ static float4 read4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    // a bf16 is the high half of an f32: widening is a shift, exact
    return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16(0.0f); }
};

template <typename T, int MT, int IC>
__host__ __device__ constexpr int stage_bytes() {
  return MT * XLD * 4 + IC * Vals<T>::LD * int(sizeof(T));
}

// stages of the ring: as many as RING_BYTES holds (at least 2), at most
// MAX_STAGES
template <typename T, int MT, int IC>
__host__ __device__ constexpr int stages() {
  return RING_BYTES / stage_bytes<T, MT, IC>() < 2            ? 2
         : RING_BYTES / stage_bytes<T, MT, IC>() < MAX_STAGES ? RING_BYTES / stage_bytes<T, MT, IC>()
                                                              : MAX_STAGES;
}

template <typename T, int MT, int IC>
__host__ __device__ constexpr int smem_bytes() {
  return stages<T, MT, IC>() * stage_bytes<T, MT, IC>() > NW * MT * IC * 4
             ? stages<T, MT, IC>() * stage_bytes<T, MT, IC>()
             : NW * MT * IC * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage one step: rows [0, IC) of the value slab (rows >= ncols zero) and
// rows [0, MT) of x (rows >= m zero), inner columns [j0, j0 + JC) (those at
// or past bn zero). VEC: 16-byte cp.async (bn a multiple of 16 bytes of
// values, x and values 16-byte aligned); else plain loads and stores.
template <typename T, int MT, int IC, bool VEC>
__device__ __forceinline__ void load_step(unsigned char* stage, const float* __restrict__ x,
                                          const T* __restrict__ slab, int cb, int j0, int m,
                                          int n, int bn, int ncols) {
  constexpr int VLD = Vals<T>::LD;
  float* xs = reinterpret_cast<float*>(stage);
  T* vs = reinterpret_cast<T*>(stage + MT * XLD * 4);
  const float* xb = x + size_t(cb) * bn + j0;
  const T* vb = slab + j0;
  const int jn = min(JC, bn - j0);
  if (VEC) {
    constexpr int VW = 16 / int(sizeof(T));
    for (int e = threadIdx.x; e < IC * (JC / VW); e += THREADS) {
      const int r = e / (JC / VW);
      const int c = (e % (JC / VW)) * VW;
      const bool ok = r < ncols && c < jn;
      cp_async16(vs + r * VLD + c, ok ? vb + size_t(r) * bn + c : slab, ok);
    }
    for (int e = threadIdx.x; e < MT * (JC / 4); e += THREADS) {
      const int r = e / (JC / 4);
      const int c = (e % (JC / 4)) * 4;
      const bool ok = r < m && c < jn;
      cp_async16(xs + r * XLD + c, ok ? xb + size_t(r) * n + c : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < IC * JC; e += THREADS) {
      const int r = e / JC;
      const int c = e % JC;
      vs[r * VLD + c] = (r < ncols && c < jn) ? vb[size_t(r) * bn + c] : Vals<T>::zero();
    }
    for (int e = threadIdx.x; e < MT * JC; e += THREADS) {
      const int r = e / JC;
      const int c = e % JC;
      xs[r * XLD + c] = (r < m && c < jn) ? xb[size_t(r) * n + c] : 0.0f;
    }
  }
}

// WC column groups of NW / WC warps; a column group owns 8 C output
// columns, and its warps split the contraction.
template <typename T, int MT, int C, int WC, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
bsr_kernel(const float* __restrict__ x, const T* __restrict__ values,
           const int* __restrict__ row_ptr, const int* __restrict__ col_idx,
           float* __restrict__ y, int m, int n, int ny, int bm, int bn) {
  constexpr int IC = 8 * C * WC;  // output columns of the CTA
  constexpr int KW = NW / WC;     // warps sharing one column group's contraction
  constexpr int R = MT / 4;       // rows of x per lane
  constexpr int VLD = Vals<T>::LD;
  constexpr int SB = stage_bytes<T, MT, IC>();
  constexpr int STAGES = stages<T, MT, IC>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int nci = (bm + IC - 1) / IC;
  const int rb = blockIdx.x / nci;
  const int i0 = (blockIdx.x % nci) * IC;
  const int ncols = min(IC, bm - i0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kw = warp % KW;       // share of the contraction
  const int rr = lane >> 3;       // rows rr + 4p
  const int cc = (warp / KW) * 8 * C + (lane & 7);  // columns cc + 8q
  const int k0 = row_ptr[rb];
  const int nj = (bn + JC - 1) / JC;
  const int steps = (row_ptr[rb + 1] - k0) * nj;

  auto issue = [&](int s) {
    const int k = k0 + s / nj;
    const T* slab = values + (size_t(k) * bm + i0) * bn;
    load_step<T, MT, IC, VEC>(smem + (s % STAGES) * SB, x, slab, col_idx[k], (s % nj) * JC, m,
                              n, bn, ncols);
  };

  float acc[R][C];
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int q = 0; q < C; ++q) acc[p][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // step s has landed, step s - 1 is consumed
    if (s + STAGES - 1 < steps) issue(s + STAGES - 1);
    cp_commit();
    const float* xs = reinterpret_cast<const float*>(smem + (s % STAGES) * SB);
    const T* vs = reinterpret_cast<const T*>(smem + (s % STAGES) * SB + MT * XLD * 4);
#pragma unroll
    for (int t = 0; t < JC / 4 / KW; ++t) {
      const int k = 4 * (kw + KW * t);
      float4 b[C];
#pragma unroll
      for (int q = 0; q < C; ++q) b[q] = Vals<T>::read4(vs + (cc + 8 * q) * VLD + k);
#pragma unroll
      for (int p = 0; p < R; ++p) {
        const float4 a = *reinterpret_cast<const float4*>(xs + (rr + 4 * p) * XLD + k);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          float v = acc[p][q];
          v = fmaf(a.x, b[q].x, v);
          v = fmaf(a.y, b[q].y, v);
          v = fmaf(a.z, b[q].z, v);
          v = fmaf(a.w, b[q].w, v);
          acc[p][q] = v;
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free

  // add each column group's warp sums in warp order and write y once
  float* red = reinterpret_cast<float*>(smem);  // [NW][R * C][32]
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int q = 0; q < C; ++q) red[((warp * R + p) * C + q) * 32 + lane] = acc[p][q];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * IC; e += THREADS) {
    const int r = e / IC;
    const int i = e % IC;
    if (r < m && i < ncols) {
      const int il = i % (8 * C);
      const int at = (((i / (8 * C)) * KW * R + (r >> 2)) * C + (il >> 3)) * 32 + (r & 3) * 8 +
                     (il & 7);
      float s = red[at];
#pragma unroll
      for (int w = 1; w < KW; ++w) s += red[w * R * C * 32 + at];
      y[size_t(r) * ny + size_t(rb) * bm + i0 + i] = s;
    }
  }
}

template <typename T, int MT, int C, int WC, bool VEC>
cudaError_t launch_one(int grid, cudaStream_t stream, const float* x, const T* values,
                       const int* row_ptr, const int* col_idx, float* y, int m, int n, int ny,
                       int bm, int bn) {
  constexpr int SMEM = smem_bytes<T, MT, 8 * C * WC>();
  static bool attr = false;  // the ring takes more than 48 KB of shared memory
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_kernel<T, MT, C, WC, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  bsr_kernel<T, MT, C, WC, VEC><<<grid, THREADS, SMEM, stream>>>(x, values, row_ptr, col_idx,
                                                                 y, m, n, ny, bm, bn);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_vec(int mt, int ic, int grid, cudaStream_t stream, const float* x,
                       const T* values, const int* row_ptr, const int* col_idx, float* y, int m,
                       int n, int ny, int bm, int bn) {
#define BSR_CASE(MT, C, WC)                                                                   \
  if (mt == MT && ic == 8 * C * WC)                                                           \
    return launch_one<T, MT, C, WC, VEC>(grid, stream, x, values, row_ptr, col_idx, y, m, n, \
                                         ny, bm, bn);
  BSR_CASE(4, 4, 1)
  BSR_CASE(8, 4, 1)
  BSR_CASE(16, 4, 1)
  BSR_CASE(32, 4, 1)
  BSR_CASE(64, 4, 1)
  BSR_CASE(4, 8, 2)
  BSR_CASE(8, 8, 2)
  BSR_CASE(16, 8, 2)
#undef BSR_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const float* x, const T* values, const int* row_ptr, const int* col_idx, float* y,
           int m, int n, int bm, int bn, int n_rb, int ic, cudaStream_t stream) {
  if (m <= 0 || m > 64 || n <= 0 || bm <= 0 || bn <= 0 || n_rb <= 0 || n % bn != 0 ||
      (ic != 32 && ic != 128) || size_t(n_rb) * bm > 2147483647u ||
      size_t(n_rb) * ((bm + ic - 1) / ic) > 2147483647u)
    return int(cudaErrorInvalidValue);
  const int mt = m <= 4 ? 4 : m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : 64;
  if (ic == 128 && mt > 16) return int(cudaErrorInvalidValue);
  const int grid = n_rb * ((bm + ic - 1) / ic);
  const int ny = n_rb * bm;
  const bool vec = bn % int(16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0;
  const cudaError_t err =
      vec ? launch_vec<T, true>(mt, ic, grid, stream, x, values, row_ptr, col_idx, y, m, n,
                                ny, bm, bn)
          : launch_vec<T, false>(mt, ic, grid, stream, x, values, row_ptr, col_idx, y, m, n,
                                 ny, bm, bn);
  return int(err);
}

}  // namespace

extern "C" {

// y (m, n_rb*bm) f32, every entry written; x (m, n) f32 with n = n_cb*bn;
// values (nb, bm, bn); row_ptr (n_rb + 1,), col_idx (nb,) int32; ic the
// output columns per CTA, 32 or 128 (128 only for m <= 16).
int bsr_matmat_f32(const float* x, const float* values, const int* row_ptr,
                   const int* col_idx, float* y, int m, int n, int bm, int bn, int n_rb,
                   int ic, cudaStream_t stream) {
  return launch<float>(x, values, row_ptr, col_idx, y, m, n, bm, bn, n_rb, ic, stream);
}

int bsr_matmat_bf16(const float* x, const __nv_bfloat16* values, const int* row_ptr,
                    const int* col_idx, float* y, int m, int n, int bm, int bn, int n_rb,
                    int ic, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, values, row_ptr, col_idx, y, m, n, bm, bn, n_rb, ic,
                               stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
