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
// on its last grid step. Blocks on this card run in parallel in no order,
// so the walk over N is split: launch 1 gives each CTA one chunk of columns
// (a whole number of the caller's tiles) and writes that chunk's partial
// (64, 64) product to a scratch slot of its own; launch 2 adds the partials
// in chunk order, then applies the mask and the symmetrisation. No atomics:
// the result has the same bits on every run, and differs from the plain
// version (one cuBLAS product) only in the order of the sum.
//
// Launch 1 is a small SGEMM tile: 256 threads, each a 4 x 4 block of the
// 64 x 64 product, with KC = 32 columns of V and W staged transposed in
// shared memory per step (16-byte row loads from device memory; float4
// reads of the staged columns).
//
// What bounds it on this card: at M = 64 the product does 2*64*64 flop per
// 512 bytes of V and W columns, 16 flop/byte, just under the CUDA cores'
// ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), so bytes and f32
// operations bound it nearly alike (160 us and 128 us at N = 2^20). The sum
// runs in f32 at full f32 precision (Precision.HIGHEST in the Pallas
// kernel); tensor cores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GM = 64;        // rows of V and W the kernel takes at most
constexpr int KC = 32;        // columns staged per step
constexpr int LD = GM + 4;    // padded, float4-aligned stride of a staged column
constexpr int GT = 256;       // 16 x 16 threads, 4 x 4 outputs each

// VEC: 16-byte loads (n a multiple of 4, chunk a multiple of KC, V and W
// 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(GT)
gram_partial(const float* __restrict__ v, const float* __restrict__ w,
             float* __restrict__ part, int mrows, int n, int chunk) {
  __shared__ __align__(16) float vs[KC * LD];   // vs[k][i] = V[i, n0 + k]
  __shared__ __align__(16) float ws[KC * LD];
  const int c = blockIdx.x;
  const int n0 = c * chunk;
  const int n1 = min(n, n0 + chunk);
  const int tid = threadIdx.x;
  const int ti = tid / 16;
  const int tj = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (int k0 = n0; k0 < n1; k0 += KC) {
    __syncthreads();  // the previous step is consumed
    if (VEC) {
      // a warp covers 4 rows x 8 float4: 128-byte row segments
      for (int e = tid; e < GM * (KC / 4); e += GT) {
        const int r = e / (KC / 4);
        const int kk = (e % (KC / 4)) * 4;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 b = a;
        if (r < mrows && k0 + kk < n1) {
          a = *reinterpret_cast<const float4*>(v + size_t(r) * n + k0 + kk);
          b = *reinterpret_cast<const float4*>(w + size_t(r) * n + k0 + kk);
        }
        vs[(kk + 0) * LD + r] = a.x;
        vs[(kk + 1) * LD + r] = a.y;
        vs[(kk + 2) * LD + r] = a.z;
        vs[(kk + 3) * LD + r] = a.w;
        ws[(kk + 0) * LD + r] = b.x;
        ws[(kk + 1) * LD + r] = b.y;
        ws[(kk + 2) * LD + r] = b.z;
        ws[(kk + 3) * LD + r] = b.w;
      }
    } else {
      for (int e = tid; e < GM * KC; e += GT) {
        const int r = e / KC;
        const int kk = e % KC;
        const bool ok = r < mrows && k0 + kk < n1;
        vs[kk * LD + r] = ok ? v[size_t(r) * n + k0 + kk] : 0.0f;
        ws[kk * LD + r] = ok ? w[size_t(r) * n + k0 + kk] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(vs + kk * LD + 4 * ti);
      const float4 b = *reinterpret_cast<const float4*>(ws + kk * LD + 4 * tj);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
  }

  float* out = part + size_t(c) * GM * GM;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) out[(4 * ti + p) * GM + 4 * tj + q] = acc[p][q];
}

// One CTA per row i, one thread per column j: the partials added in chunk
// order, then h = G * mask_i * mask_j and H = (h + h^T) / 2.
__global__ void gram_finish(const float* __restrict__ part,
                            const float* __restrict__ mask,
                            float* __restrict__ h, int mrows, int nchunks) {
  const int i = blockIdx.x;
  const int j = threadIdx.x;
  if (j >= mrows) return;
  float gij = 0.0f;
  float gji = 0.0f;
  for (int c = 0; c < nchunks; ++c) {
    const float* p = part + size_t(c) * GM * GM;
    gij += p[i * GM + j];
    gji += p[j * GM + i];
  }
  const float mi = mask[i];
  const float mj = mask[j];
  h[i * mrows + j] = 0.5f * (gij * mi * mj + gji * mj * mi);
}

}  // namespace

extern "C" {

// v, w (mrows, n) f32; mask (mrows,) f32; part (nchunks, 64, 64) f32
// scratch; h (mrows, mrows) f32 out. Chunk c covers columns
// [c*chunk, min(n, (c+1)*chunk)); nchunks = ceil(n / chunk).
int masked_gram_f32(const float* v, const float* w, const float* mask,
                    float* part, float* h, int mrows, int n, int chunk,
                    int nchunks, cudaStream_t stream) {
  if (mrows <= 0 || mrows > GM || n <= 0 || chunk <= 0 || nchunks <= 0 ||
      size_t(nchunks) * chunk < size_t(n) ||
      size_t(nchunks - 1) * chunk >= size_t(n))
    return int(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && chunk % KC == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    gram_partial<true><<<nchunks, GT, 0, stream>>>(v, w, part, mrows, n, chunk);
  else
    gram_partial<false><<<nchunks, GT, 0, stream>>>(v, w, part, mrows, n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  gram_finish<<<mrows, GM, 0, stream>>>(part, mask, h, mrows, nchunks);
  return int(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
