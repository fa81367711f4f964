// Packed lower-triangle symmetric action y = x A on Hopper (sm_90a).
//
// Replaces two Pallas kernels of iterative_solver_tpu/ops/kernels/symm_pallas.py:
//   symm_packed_f32, symm_packed_bf16 <- _symm_matmat_pallas_impl (K1, :148,
//                                        pallas_call :211), f32 or bf16 tiles;
//   symm_packed_split                 <- _symm_matmat_split_impl (K3, :325,
//                                        pallas_call :382), bf16 hi/lo planes.
//
// A is stored as the (b, b) tiles A_ij of its lower triangle, listed by
// (ii[t], jj[t]) with jj <= ii. Every tile carries two contributions,
//     y_i += x_j A_ij^T          and, when i != j,      y_j += x_i A_ij,
// so the packed format halves the bytes of a dense action only if each tile
// is read ONCE for both. That is the design: a block stages one S x S
// sub-tile of one A_ij in shared memory and forms both contributions from
// it. Half of its threads own a row of the sub-tile (the x_j A_ij^T term,
// reduced over the sub-tile's columns), half own a column (the x_i A_ij
// term, reduced over its rows).
//
// The Pallas kernel walks the tiles in order and keeps the whole (m, N) f32
// accumulator resident in VMEM. Hopper has no such arena and its blocks run
// in parallel in no order, so partial sums go straight into y with f32
// atomics; the wrapper zeroes y first. Atomics change the order of the
// sum, so the result matches the plain PyTorch version by tolerance (about
// 1e-6 of max|y|), not bit for bit, and differs slightly from run to run.
//
// What bounds it on this card: bytes. At m = 16 the packed tiles are read
// once and do 32 flop per bf16 tile byte, far below the tensor cores' ridge
// (~295 flop/byte). This first version multiplies on the CUDA cores in f32
// (bf16 products are exact in f32), so at the main path's shapes it is
// limited by FMA issue and shared-memory reads rather than by the tile
// stream; wgmma, TMA and a pipelined tile ring are later work.
//
// Arithmetic, as in the Pallas kernels:
//   f32 tiles  -> f32 products and sums (the HIGHEST-precision tier);
//   bf16 tiles -> x rounded to bf16 (round to nearest even) first, exact
//                 products, f32 sums (symm_pallas.py:159, :176-178);
//   split      -> x split by bit mask into xh (top 16 bits, truncated) and
//                 xl = bf16(x - xh) (symm_pallas.py:315-320); three products
//                 per contribution, xh*hi + xh*lo + xl*hi, f32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 128;           // sub-tile edge
constexpr int MB = 16;           // rows of x per pass over the staged sub-tile
constexpr int XLD = MB + 4;      // padded stride of staged x (16-byte rows, fewer bank conflicts)
constexpr int THREADS = 2 * S;   // S row owners + S column owners

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float split_hi(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

// Padded row stride of a staged sub-tile: column reads (lanes walk rows) and
// row reads (lanes walk columns) are then both free of bank conflicts.
template <typename T>
__host__ __device__ constexpr int tile_ld() { return S + (sizeof(T) == 2 ? 2 : 1); }

template <typename T, int PLANES>
__host__ __device__ constexpr size_t tile_bytes() {
  return ((size_t(PLANES) * S * tile_ld<T>() * sizeof(T) + 15) / 16) * 16;
}

// x parts: 1 (f32 or bf16-rounded x) or 2 (split hi, lo); each part is
// staged twice, as the columns of block-col j and the rows of block-row i.
template <typename T, int PLANES>
__host__ __device__ constexpr size_t smem_bytes() {
  return tile_bytes<T, PLANES>() + size_t(PLANES) * 2 * S * XLD * sizeof(float);
}

// PLANES == 1: a0 holds the tiles, x rounded to bf16 when ROUND_X.
// PLANES == 2: a0 = hi, a1 = lo, x split into (xh, xl).
template <typename T, int PLANES, bool ROUND_X>
__global__ void __launch_bounds__(THREADS)
symm_packed_kernel(const float* __restrict__ x, const T* __restrict__ a0,
                   const T* __restrict__ a1, const int* __restrict__ ii,
                   const int* __restrict__ jj, float* __restrict__ y, int m,
                   int n, int b) {
  constexpr int LD = tile_ld<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);                         // [PLANES][S][LD]
  float* xs = reinterpret_cast<float*>(smem + tile_bytes<T, PLANES>());
  // xs[part][0] : x_j at the sub-tile's columns, [S][XLD] (q-major)
  // xs[part][1] : x_i at the sub-tile's rows,    [S][XLD] (p-major)

  const int t = blockIdx.x;
  const int nsub = (b + S - 1) / S;
  const int r0 = (blockIdx.y / nsub) * S;
  const int c0 = (blockIdx.y % nsub) * S;
  const int bi = ii[t];
  const int bj = jj[t];
  const int tid = threadIdx.x;
  const size_t tile_base = size_t(t) * b * b;

  // ---- stage the sub-tile of every plane (read once from device memory)
  const T* planes[2] = {a0, a1};
#pragma unroll
  for (int pl = 0; pl < PLANES; ++pl) {
    const T* a = planes[pl] + tile_base;
    T* dst = as + pl * S * LD;
    if (b % S == 0) {
      constexpr int VEC = 16 / sizeof(T);
      for (int e = tid; e < S * S / VEC; e += THREADS) {
        const int r = e / (S / VEC);
        const int c = (e % (S / VEC)) * VEC;
        const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(
            a + size_t(r0 + r) * b + c0 + c));
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < VEC; ++k) dst[r * LD + c + k] = vals[k];
      }
    } else {
      for (int e = tid; e < S * S; e += THREADS) {
        const int r = e / S;
        const int c = e % S;
        const bool ok = (r0 + r < b) && (c0 + c < b);
        dst[r * LD + c] = ok ? a[size_t(r0 + r) * b + c0 + c] : zero<T>();
      }
    }
  }

  const bool row_owner = tid < S;
  const int idx = row_owner ? tid : tid - S;
  const bool active = row_owner ? (r0 + idx < b) : (c0 + idx < b && bi != bj);
  const int qmax = min(S, b - c0);   // valid columns of the sub-tile
  const int pmax = min(S, b - r0);   // valid rows

  for (int mbase = 0; mbase < m; mbase += MB) {
    __syncthreads();  // the previous pass is done with xs
    // ---- stage x: columns of block j, rows of block i, MB rows of x
    for (int e = tid; e < 2 * S * MB; e += THREADS) {
      const int which = e / (S * MB);          // 0: x_j columns, 1: x_i rows
      const int rem = e % (S * MB);
      const int mm = rem / S;
      const int k = rem % S;
      const int lim = which == 0 ? qmax : pmax;
      const int col = which == 0 ? bj * b + c0 + k : bi * b + r0 + k;
      float v = (mbase + mm < m && k < lim) ? x[size_t(mbase + mm) * n + col] : 0.0f;
      if constexpr (PLANES == 2) {
        const float h = split_hi(v);
        xs[(0 * 2 + which) * S * XLD + k * XLD + mm] = h;
        xs[(1 * 2 + which) * S * XLD + k * XLD + mm] = round_bf16(v - h);
      } else {
        xs[which * S * XLD + k * XLD + mm] = ROUND_X ? round_bf16(v) : v;
      }
    }
    __syncthreads();

    if (active) {
      float acc[MB];
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) acc[mm] = 0.0f;
      const int which = row_owner ? 0 : 1;
      const int kmax = row_owner ? qmax : pmax;
      for (int k = 0; k < kmax; ++k) {
        // row owner idx = p walks columns k = q; column owner idx = q walks rows k = p
        const int off = row_owner ? idx * LD + k : k * LD + idx;
        const float ah = to_f32<T>(as[off]);
        const float4* xh4 =
            reinterpret_cast<const float4*>(xs + which * S * XLD + k * XLD);
        if constexpr (PLANES == 2) {
          const float al = to_f32<T>(as[S * LD + off]);
          const float4* xl4 = reinterpret_cast<const float4*>(
              xs + (2 + which) * S * XLD + k * XLD);
#pragma unroll
          for (int v4 = 0; v4 < MB / 4; ++v4) {
            const float4 h = xh4[v4];
            const float4 l = xl4[v4];
            acc[4 * v4 + 0] = fmaf(l.x, ah, fmaf(h.x, al, fmaf(h.x, ah, acc[4 * v4 + 0])));
            acc[4 * v4 + 1] = fmaf(l.y, ah, fmaf(h.y, al, fmaf(h.y, ah, acc[4 * v4 + 1])));
            acc[4 * v4 + 2] = fmaf(l.z, ah, fmaf(h.z, al, fmaf(h.z, ah, acc[4 * v4 + 2])));
            acc[4 * v4 + 3] = fmaf(l.w, ah, fmaf(h.w, al, fmaf(h.w, ah, acc[4 * v4 + 3])));
          }
        } else {
#pragma unroll
          for (int v4 = 0; v4 < MB / 4; ++v4) {
            const float4 h = xh4[v4];
            acc[4 * v4 + 0] = fmaf(h.x, ah, acc[4 * v4 + 0]);
            acc[4 * v4 + 1] = fmaf(h.y, ah, acc[4 * v4 + 1]);
            acc[4 * v4 + 2] = fmaf(h.z, ah, acc[4 * v4 + 2]);
            acc[4 * v4 + 3] = fmaf(h.w, ah, acc[4 * v4 + 3]);
          }
        }
      }
      // row owner: y_i[:, r0 + p]; column owner: y_j[:, c0 + q]
      const int col = row_owner ? bi * b + r0 + idx : bj * b + c0 + idx;
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) {
        if (mbase + mm < m) atomicAdd(y + size_t(mbase + mm) * n + col, acc[mm]);
      }
    }
  }
}

template <typename T, int PLANES, bool ROUND_X>
int launch(const float* x, const T* a0, const T* a1, const int* ii,
           const int* jj, float* y, int m, int n, int b, int n_pairs,
           cudaStream_t stream) {
  const int nsub = (b + S - 1) / S;
  if (m <= 0 || n <= 0 || b <= 0 || n_pairs <= 0 || n % b != 0 ||
      nsub * nsub > 65535)
    return int(cudaErrorInvalidValue);
  constexpr size_t smem = smem_bytes<T, PLANES>();
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      symm_packed_kernel<T, PLANES, ROUND_X>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  symm_packed_kernel<T, PLANES, ROUND_X>
      <<<dim3(n_pairs, nsub * nsub), THREADS, smem, stream>>>(
      x, a0, a1, ii, jj, y, m, n, b);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (m, n) f32, zeroed by the caller; x (m, n) f32; tiles (n_pairs, b, b).
int symm_packed_f32(const float* x, const float* a, const int* ii,
                    const int* jj, float* y, int m, int n, int b,
                    int n_pairs, cudaStream_t stream) {
  return launch<float, 1, false>(x, a, a, ii, jj, y, m, n, b, n_pairs, stream);
}

int symm_packed_bf16(const float* x, const __nv_bfloat16* a, const int* ii,
                     const int* jj, float* y, int m, int n, int b,
                     int n_pairs, cudaStream_t stream) {
  return launch<__nv_bfloat16, 1, true>(x, a, a, ii, jj, y, m, n, b, n_pairs,
                                        stream);
}

int symm_packed_split(const float* x, const __nv_bfloat16* hi,
                      const __nv_bfloat16* lo, const int* ii, const int* jj,
                      float* y, int m, int n, int b, int n_pairs,
                      cudaStream_t stream) {
  return launch<__nv_bfloat16, 2, false>(x, hi, lo, ii, jj, y, m, n, b,
                                         n_pairs, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
