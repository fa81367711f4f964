// Fused expand chain of the Davidson step on Hopper (sm_90a).
//
// Replaces the Pallas kernel _chain_impl / _chain_kernel_body of
// iterative_solver_tpu/ops/kernels/chain_pallas.py (K2, :94 / :63,
// pallas_call :107). It computes, for r (R, N), basis v (M, N), mask (M,):
//
//   t  = r / (diag - evals + 1e-15 * (max|diag| + max|evals|))   (Jacobi, optional)
//   n0 = row_norms2(t)
//   gs_passes x [ proj = (t v^T) * mask ;  t -= proj v ]          (classical GS)
//   n2 = row_norms2(t) ;  g = t t^T
//
// The Pallas kernel has no grid: everything sits in VMEM and the chain is
// straight-line code. On Hopper the basis alone (2 MB at M=64, N=8192) is
// far above a block's 227 KB of shared memory, and every product in the
// chain is a reduction over N that must finish before the next step uses
// it. So the chain is a short sequence of launches on one stream, each a
// grid over N-chunks:
//
//   chain_absmax  : max|diag|, max|evals| (only with Jacobi)
//   stage 0       : t = jacobi(r) or r ; n0 ; partial t v^T -> proj[0]
//   stage k>0     : t -= (proj[k-1] * mask) v ; partial t v^T -> proj[k],
//                   and on the last stage n2 and g instead
//
// Each block reduces its chunk in shared memory and adds it to the global
// sums with f32 atomics (into buffers the wrapper zeroes). Atomics change
// the order of the sum, so results match the plain PyTorch version by
// tolerance (about 1e-6 relative), not bit for bit.
//
// What bounds it on this card: neither bytes (the ~3 MB working set sits in
// the 50 MB L2) nor operations (~70 MFLOP, about a microsecond of f32 FMA),
// but the latency of its 3-4 dependent launches, a few microseconds each.
// This first version runs each stage on n / C blocks (64 at N = 8192, half
// the SMs), every thread walking its dot products through shared memory, so
// a stage takes longer than a launch; a later PR may spread the stages over
// more blocks, capture the step in a CUDA graph or fuse the stages with a
// grid-wide sync.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// absmax[0] = max|diag|, absmax[1] = max|evals|, as float bits: for
// non-negative floats the unsigned order is the float order.
__global__ void __launch_bounds__(THREADS)
chain_absmax(const float* __restrict__ diag, int n, const float* __restrict__ evals,
             int r, unsigned* __restrict__ absmax) {
  __shared__ float red[THREADS / 32];
  float md = 0.0f;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS)
    md = fmaxf(md, fabsf(diag[i]));
  md = warp_max(md);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = md;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < THREADS / 32 ? red[threadIdx.x] : 0.0f;
    v = warp_max(v);
    if (threadIdx.x == 0) atomicMax(absmax, __float_as_uint(v));
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float me = 0.0f;
    for (int i = threadIdx.x; i < r; i += 32) me = fmaxf(me, fabsf(evals[i]));
    me = warp_max(me);
    if (threadIdx.x == 0) atomicMax(absmax + 1, __float_as_uint(me));
  }
}

// Shared memory: ts [R][C+1], vs [M][C+1], pm [R][M].
__global__ void __launch_bounds__(THREADS)
chain_stage(const float* src, float* dst,  // may alias (in-place stages)
            const float* __restrict__ v, const float* __restrict__ mask,
            const float* __restrict__ diag, const float* __restrict__ evals,
            const unsigned* __restrict__ absmax, const float* __restrict__ proj_in,
            float* __restrict__ proj_out, float* __restrict__ nrm,
            float* __restrict__ g, int R, int M, int n, int C) {
  extern __shared__ float sm[];
  const int ld = C + 1;
  float* ts = sm;
  float* vs = ts + R * ld;
  float* pm = vs + M * ld;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * C;
  const int cw = min(C, n - c0);

  for (int e = tid; e < M * C; e += THREADS) {
    const int mi = e / C, c = e % C;
    vs[mi * ld + c] = c < cw ? v[size_t(mi) * n + c0 + c] : 0.0f;
  }
  float scale = 0.0f;
  if (absmax != nullptr) scale = __uint_as_float(absmax[0]) + __uint_as_float(absmax[1]);
  for (int e = tid; e < R * C; e += THREADS) {
    const int rr = e / C, c = e % C;
    float val = 0.0f;
    if (c < cw) {
      val = src[size_t(rr) * n + c0 + c];
      if (absmax != nullptr) val = val / ((diag[c0 + c] - evals[rr]) + 1e-15f * scale);
    }
    ts[rr * ld + c] = val;
  }
  if (proj_in != nullptr)
    for (int e = tid; e < R * M; e += THREADS) pm[e] = proj_in[e] * mask[e % M];
  __syncthreads();

  if (proj_in != nullptr) {  // t -= (proj * mask) v over this chunk
    // each element is read and written by one thread only: no race on ts
    for (int e = tid; e < R * C; e += THREADS) {
      const int rr = e / C, c = e % C;
      float s = 0.0f;
      for (int mi = 0; mi < M; ++mi) s = fmaf(pm[rr * M + mi], vs[mi * ld + c], s);
      ts[rr * ld + c] -= s;
    }
    __syncthreads();
  }

  if (nrm != nullptr) {  // row norms^2, one warp per row
    for (int rr = tid / 32; rr < R; rr += THREADS / 32) {
      float s = 0.0f;
      for (int c = tid % 32; c < C; c += 32) s = fmaf(ts[rr * ld + c], ts[rr * ld + c], s);
      s = warp_sum(s);
      if (tid % 32 == 0) atomicAdd(nrm + rr, s);
    }
  }
  if (proj_out != nullptr) {  // partial t v^T
    for (int o = tid; o < R * M; o += THREADS) {
      const int rr = o / M, mi = o % M;
      float s = 0.0f;
      for (int c = 0; c < C; ++c) s = fmaf(ts[rr * ld + c], vs[mi * ld + c], s);
      atomicAdd(proj_out + o, s);
    }
  }
  if (g != nullptr) {  // partial t t^T
    for (int o = tid; o < R * R; o += THREADS) {
      const int rr = o / R, ss = o % R;
      float s = 0.0f;
      for (int c = 0; c < C; ++c) s = fmaf(ts[rr * ld + c], ts[ss * ld + c], s);
      atomicAdd(g + o, s);
    }
  }
  for (int e = tid; e < R * C; e += THREADS) {
    const int rr = e / C, c = e % C;
    if (c < cw) dst[size_t(rr) * n + c0 + c] = ts[rr * ld + c];
  }
}

}  // namespace

extern "C" {

// r, t (R, n); v (M, n); mask (M,); diag (n,) and evals (R,) or null (no
// Jacobi). scratch (zeroed by the caller, f32): [2 absmax | gs_passes*R*M
// proj | R n0 | R n2 | R*R g]. t may alias nothing else. gs_passes >= 1.
int chain_f32(const float* r, float* t, const float* v, const float* mask,
              const float* diag, const float* evals, float* scratch, int R,
              int M, int n, int gs_passes, cudaStream_t stream) {
  if (R <= 0 || M <= 0 || n <= 0 || gs_passes < 1) return int(cudaErrorInvalidValue);
  // chunk width: shared memory (R + M) * (C + 1) + R * M floats must fit
  int C = 128;
  auto smem_of = [&](int c) { return size_t((R + M) * (c + 1) + R * M) * sizeof(float); };
  while (C > 8 && smem_of(C) > 96 * 1024) C /= 2;
  const size_t smem = smem_of(C);
  constexpr int kMaxSmem = 227 * 1024;
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      chain_stage, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return int(err);

  unsigned* absmax = reinterpret_cast<unsigned*>(scratch);
  float* proj = scratch + 2;
  float* n0 = proj + size_t(gs_passes) * R * M;
  float* n2 = n0 + R;
  float* g = n2 + R;
  const bool jacobi = diag != nullptr;
  const int blocks = (n + C - 1) / C;

  if (jacobi) {
    chain_absmax<<<std::min(blocks, 132), THREADS, 0, stream>>>(diag, n, evals, R, absmax);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  for (int k = 0; k <= gs_passes; ++k) {
    const bool last = k == gs_passes;
    chain_stage<<<blocks, THREADS, smem, stream>>>(
        k == 0 ? r : t, t, v, mask, diag, evals,
        (k == 0 && jacobi) ? absmax : nullptr,
        k == 0 ? nullptr : proj + size_t(k - 1) * R * M,
        last ? nullptr : proj + size_t(k) * R * M,
        k == 0 ? n0 : (last ? n2 : nullptr),
        last ? g : nullptr, R, M, n, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  return int(cudaSuccess);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
