// Masked symmetrised Gram matrix on Hopper (sm_90a).
//
// Replaces the Pallas kernel of iterative_solver_tpu/ops/kernels/gram_pallas.py:
//   masked_gram_f32 <- _masked_gram_fn (K7, :25, pallas_call :56).
//
//   G[i, j] = sum_n V[i, n] W[j, n],   h = G * mask_i * mask_j,
//   H = (h + h^T) / 2,                  V, W (M, N) f32, M <= 64.
//
// The Pallas kernel walks N in order on one core and keeps the (M, M)
// accumulator resident in VMEM, applying the mask and the symmetrisation
// on its last grid step. Here one launch does it all:
//
// - The columns are cut into chunks of the kernel's own choosing
//   (``gram.chunk_plan``: about two CTAs per SM, whatever the caller's
//   Pallas tile), one CTA per chunk, all resident at once (a cooperative
//   launch).
// - A CTA streams its chunk in steps of KC = 32 columns through a
//   three-stage ring of 16-byte cp.async copies of V and W row segments,
//   row-major as they lie in memory (no transposing scatter). The padded
//   row stride LD = 36 floats is 4 (mod 32), so that the float4 reads
//   along the contraction are free of bank conflicts.
// - Its 256 threads are four k-groups of 64; each k-group takes every
//   fourth float4 of the contraction, and each thread owns an 8 x 8 block
//   of the 64 x 64 product (rows past M are staged as zeros): rows ti + 8p
//   of V against rows tj + 8q of W, 256 FMAs per 16 float4 reads. The k-groups' sums are added in group
//   order through shared memory, and the CTA stores its chunk's partial.
// - One launch, deterministic. After one grid-wide barrier, CTA b adds
//   the 4 x 4 blocks (I, J) and (J, I) of block pair b (136 pairs at
//   M = 64) over all partials, each thread a fixed set of chunks in order,
//   the threads' sums in a fixed tree, then writes both blocks of H with
//   the mask and the symmetrisation (H[i, j] and H[j, i] get the same
//   bits). The order of every sum is fixed: the same bits on every run,
//   differing from the plain version (one cuBLAS product) only in the
//   order of the sum. No TF32, no tensor cores: the product runs in full
//   f32 on the CUDA cores (Precision.HIGHEST in the Pallas kernel).
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W): at M = 64
// the product does 2*64*64 flop per 512 bytes of V and W columns, 16
// flop/byte, just under the CUDA cores' ridge (67 TFLOP/s over 3.35 TB/s =
// 20 flop/byte), so bytes and f32 operations bound it nearly alike (160 us
// and 128 us at N = 2^20); the design keeps the FMA pipe fed from shared
// memory (16 FMAs per float4 read) while the ring keeps two steps of
// copies in flight. At N = 8192 (1.3 us of bytes) the tail of partial sums
// and the launch bound it: the barrier lets 136 CTAs share the sum of the
// partials, where a last-arriving CTA would add them alone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GM = 64;          // rows of V and W the kernel takes at most
constexpr int KC = 32;          // columns per step
constexpr int LD = KC + 4;      // padded row stride of a staged step, = 4 (mod 32)
constexpr int KG = 4;           // k-groups of 64 threads
constexpr int GT = 64 * KG;     // threads of a CTA
constexpr int STAGES = 3;
constexpr int PART = 32 * (GM / 4) * (GM / 4 + 1) / 2;  // floats of one partial: 136 pairs
constexpr int STAGE_FLOATS = 2 * GM * LD;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy step k0 of V and W into one stage; rows >= m and columns >= n are
// zero-filled (the copy reads 0 bytes of a valid address).
// VEC: 16-byte copies (n, ldv, ldw multiples of 4, V and W 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ void load_step(float* stage, const float* __restrict__ v,
                                          const float* __restrict__ w, int m, int n,
                                          int ldv, int ldw, int k0) {
  if (VEC) {
    for (int e = threadIdx.x; e < 2 * GM * (KC / 4); e += GT) {
      const int which = e / (GM * (KC / 4));
      const int rem = e % (GM * (KC / 4));
      const int r = rem / (KC / 4);
      const int c = (rem % (KC / 4)) * 4;
      const bool ok = r < m && k0 + c < n;
      const float* src = which ? w + size_t(ok ? r : 0) * ldw + (ok ? k0 + c : 0)
                               : v + size_t(ok ? r : 0) * ldv + (ok ? k0 + c : 0);
      cp_async16(stage + (which * GM + r) * LD + c, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < 2 * GM * KC; e += GT) {
      const int which = e / (GM * KC);
      const int rem = e % (GM * KC);
      const int r = rem / KC;
      const int c = rem % KC;
      const bool ok = r < m && k0 + c < n;
      const float* src = which ? w + size_t(ok ? r : 0) * ldw + (ok ? k0 + c : 0)
                               : v + size_t(ok ? r : 0) * ldv + (ok ? k0 + c : 0);
      cp_async4(stage + (which * GM + r) * LD + c, src, ok);
    }
  }
}

// Where G[i][j] lies in a partial: block pairs (I, J), I <= J, of 4 x 4
// blocks, in the order (0, 0), (0, 1), ..., (1, 1), ... of 16 blocks a row;
// pair b holds 32 floats at 32 b, block (I, J) row-major, then block (J, I)
// row-major (a diagonal pair holds its block twice).
__device__ __forceinline__ int pair_offset(int i, int j) {
  const int bi = min(i, j) >> 2;
  const int bj = max(i, j) >> 2;
  const int pair = bi * (2 * (GM / 4) - bi + 1) / 2 + (bj - bi);
  return 32 * pair + (i >> 2 > j >> 2 ? 16 : 0) + (i & 3) * 4 + (j & 3);
}

// One CTA per chunk of `chunk` columns (a multiple of KC; chunks past n are
// empty), all CTAs resident at once (a cooperative launch). The partial of
// chunk c lies in part[c] in block-pair order (pair_offset).
template <bool VEC>
__global__ void __launch_bounds__(GT, 2)
gram_kernel(const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ mask, float* __restrict__ part, float* __restrict__ h,
            int m, int n, int ldv, int ldw, int chunk) {
  constexpr int MP = GM / 8;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int g = tid / 64;        // k-group
  const int u = tid % 64;
  const int ti = u >> 3;
  const int tj = u & 7;
  const int n0 = blockIdx.x * chunk;
  const int steps = n0 < n ? (min(n, n0 + chunk) - n0 + KC - 1) / KC : 0;

  float acc[MP][MP];
#pragma unroll
  for (int p = 0; p < MP; ++p)
#pragma unroll
    for (int q = 0; q < MP; ++q) acc[p][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step<VEC>(smem + s * STAGE_FLOATS, v, w, m, n, ldv, ldw, n0 + s * KC);
    cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // step s has landed, step s - 1 is consumed
    const int nxt = s + STAGES - 1;
    if (nxt < steps)
      load_step<VEC>(smem + (nxt % STAGES) * STAGE_FLOATS, v, w, m, n, ldv, ldw,
                         n0 + nxt * KC);
    cp_commit();
    const float* vs = smem + (s % STAGES) * STAGE_FLOATS;
    const float* ws = vs + GM * LD;
#pragma unroll
    for (int jj = 0; jj < KC / 4 / KG; ++jj) {
      const int k = 4 * (g + KG * jj);
      float4 b[MP];
#pragma unroll
      for (int q = 0; q < MP; ++q)
        b[q] = *reinterpret_cast<const float4*>(ws + (tj + 8 * q) * LD + k);
#pragma unroll
      for (int p = 0; p < MP; ++p) {
        const float4 a = *reinterpret_cast<const float4*>(vs + (ti + 8 * p) * LD + k);
#pragma unroll
        for (int q = 0; q < MP; ++q) {
          float t = acc[p][q];
          t = fmaf(a.x, b[q].x, t);
          t = fmaf(a.y, b[q].y, t);
          t = fmaf(a.z, b[q].z, t);
          t = fmaf(a.w, b[q].w, t);
          acc[p][q] = t;
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free

  // the k-groups' sums, added in group order: this chunk's partial
  float* red = smem;  // [KG - 1][MP * MP][64]
  if (g > 0) {
#pragma unroll
    for (int p = 0; p < MP; ++p)
#pragma unroll
      for (int q = 0; q < MP; ++q) red[((g - 1) * MP * MP + p * MP + q) * 64 + u] = acc[p][q];
  }
  __syncthreads();
  if (g == 0) {
    float* out = part + size_t(blockIdx.x) * PART;
#pragma unroll
    for (int p = 0; p < MP; ++p)
#pragma unroll
      for (int q = 0; q < MP; ++q) {
        float t = acc[p][q];
#pragma unroll
        for (int r = 0; r < KG - 1; ++r) t += red[(r * MP * MP + p * MP + q) * 64 + u];
        const int i = ti + 8 * p;
        const int j = tj + 8 * q;
        out[pair_offset(i, j)] = t;
        if ((i >> 2) == (j >> 2)) out[pair_offset(i, j) + 16] = t;
      }
  }

  // every partial is stored: CTA b < nb (nb + 1) / 2 adds block pair b over
  // all chunks, then writes both blocks of H = (h + h^T) / 2
  cg::this_grid().sync();
  const int nb = (m + 3) / 4;
  int b = blockIdx.x;
  if (b >= nb * (nb + 1) / 2) return;
  int bi = 0;
  while (b >= nb - bi) b -= nb - bi++;
  const int bj = bi + b;
  const int pair = bi * (2 * (GM / 4) - bi + 1) / 2 + (bj - bi);
  // the pair's 32 floats are 8 float4 of one 128-byte line per chunk:
  // thread t adds float4 t % 8 of chunks t / 8, t / 8 + 32, ... in order
  // (a warp reads 4 whole lines per load), then a fixed shuffle tree over
  // the 4 lanes of each float4 in a warp, (s0 + s2) + (s1 + s3), then the
  // warps in order
  const int e = tid & 7;
  float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = tid >> 3; c0 < gridDim.x; c0 += 4 * (GT / 8)) {
    float4 x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k * (GT / 8);
      x[k] = c < gridDim.x ? __ldcg(reinterpret_cast<const float4*>(part + size_t(c) * PART +
                                                                    32 * pair) + e)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f.x += x[k].x;
      f.y += x[k].y;
      f.z += x[k].z;
      f.w += x[k].w;
    }
  }
#pragma unroll
  for (int off = 16; off >= 8; off /= 2) {
    f.x += __shfl_down_sync(0xffffffffu, f.x, off);
    f.y += __shfl_down_sync(0xffffffffu, f.y, off);
    f.z += __shfl_down_sync(0xffffffffu, f.z, off);
    f.w += __shfl_down_sync(0xffffffffu, f.w, off);
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float4* wsum4 = reinterpret_cast<float4*>(smem);  // [GT / 32][8]
  __syncthreads();
  if (lane < 8) wsum4[warp * 8 + lane] = f;
  __syncthreads();
  if (tid < 8) {
    float4 t = wsum4[tid];
#pragma unroll
    for (int w = 1; w < GT / 32; ++w) {
      const float4 y = wsum4[w * 8 + tid];
      t.x += y.x;
      t.y += y.y;
      t.z += y.z;
      t.w += y.w;
    }
    wsum4[tid] = t;  // [0, 4): block (I, J) row-major; [4, 8): block (J, I)
  }
  float* wsum = smem;
  __syncthreads();
  // G[4I + r][4J + s] and G[4J + s][4I + r]; H[i][j] and H[j][i] get the
  // same bits
  if (tid < 16) {
    const int r = tid / 4;
    const int s = tid % 4;
    const int i = 4 * bi + r;
    const int j = 4 * bj + s;
    if (i < m && j < m) {
      const float hij = wsum[4 * r + s] * mask[i] * mask[j];
      const float hji = wsum[16 + 4 * s + r] * mask[j] * mask[i];
      const float hv = 0.5f * (hij + hji);
      h[i * m + j] = hv;
      h[j * m + i] = hv;
    }
  }
}

template <bool VEC>
cudaError_t launch(const float* v, const float* w, const float* mask, float* part, float* h,
                   int m, int n, int ldv, int ldw, int chunk, int nchunks, cudaStream_t stream) {
  static bool attr = false;  // the ring takes more than 48 KB of shared memory
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  void* args[] = {&v, &w, &mask, &part, &h, &m, &n, &ldv, &ldw, &chunk};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gram_kernel<VEC>),
                                     dim3(nchunks), dim3(GT), args, SMEM_BYTES, stream);
}

}  // namespace

extern "C" {

// CTAs of the kernel that the current device holds at once: the most
// chunks a launch may have.
int masked_gram_capacity() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gram_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_kernel<true>, GT,
                                                        SMEM_BYTES);
  return err == cudaSuccess ? sms * per_sm : -int(err);
}

// v (m, n) rows ldv apart, w (m, n) rows ldw apart, mask (m,), all f32;
// part (nchunks, 4352) f32 scratch; h (m, m) f32 out. Chunk c covers
// columns [c*chunk, min(n, (c+1)*chunk)), chunk a multiple of 32, with
// ceil(n / chunk) <= nchunks <= masked_gram_capacity().
int masked_gram_f32(const float* v, const float* w, const float* mask, float* part, float* h,
                    int m, int n, int ldv, int ldw, int chunk, int nchunks,
                    cudaStream_t stream) {
  if (m <= 0 || m > GM || n <= 0 || ldv < n || ldw < n || chunk <= 0 || chunk % KC ||
      nchunks <= 0 || size_t(nchunks) * chunk < size_t(n) ||
      nchunks < (m + 3) / 4 * ((m + 3) / 4 + 1) / 2)
    return int(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && ldv % 4 == 0 && ldw % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaError_t err =
      vec ? launch<true>(v, w, mask, part, h, m, n, ldv, ldw, chunk, nchunks, stream)
          : launch<false>(v, w, mask, part, h, m, n, ldv, ldw, chunk, nchunks, stream);
  return int(err);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
