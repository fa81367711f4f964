// Int8 packed lower-triangle symmetric action on Hopper (sm_90a).
//
// Replaces two Pallas kernels of iterative_solver_tpu/ops/kernels/symm_int8.py:
//   symm_int8       <- _symm_matmat_int8_impl (K4, :344, pallas_call :397),
//                      one int8 plane Q;
//   symm_int8_split <- _symm_matmat_int8_split_impl (K5, :430, pallas_call
//                      :493), two planes Q1, Q2 and two x planes p1, p2.
//
// The off-diagonal part of the operator is stored as the (b, b) int8 tiles
// Q_ij of its lower triangle, listed by (ii[t], jj[t]) with jj <= ii. x comes
// in already quantized (qx, or p1 and p2, int8, made by the wrapper with the
// plain version's torch ops). Every tile carries two contributions,
//     acc_i += qx_j Q_ij^T        and, when i != j,      acc_j += qx_i Q_ij,
// summed exactly in int32. K5 keeps two accumulators: hi = p1 Q1 and
// lo = p1 Q2 + p2 Q1.
//
// Design, as K1 in symm_packed.cu: a block stages one S x S sub-tile of one
// tile in shared memory, so each tile is read once for both contributions.
// Half of its threads own a row of the sub-tile (the qx_j Q^T term, reduced
// along the row), half own a column (the qx_i Q term, reduced down the
// column). Products are __dp4a: four int8 x int8 products added into an
// int32 in one instruction. Along a row four consecutive bytes are one word;
// down a column they are not, so the block also keeps a transposed copy of
// the sub-tile, built from the row-major copy in 4 x 4 byte blocks with
// __byte_perm. Partial sums go into the (m, n) int32 accumulator with integer
// atomics: integer addition is exact and does not depend on order, so the
// accumulator equals the plain version's bit for bit (unlike K1's f32
// atomics). The wrapper zeroes it; nothing here allocates.
//
// A second launch from this file is the epilogue, once per output element:
//   K4: y = float(acc) * sx[row] * gq[col] + xf * d[col]
//   K5: y = (float(hi) + float(lo) * (float)(1/254)) * sx[row] * gq[col] + xf * d[col]
// written with __fmul_rn / __fadd_rn in the order PyTorch's plain expression
// rounds, ((acc * sx) * gq) + (xf * d), so nvcc contracts nothing into an
// FMA and y equals the plain version bit for bit too.
//
// What bounds it on this card: at the solver's row counts (m = 16 to 64)
// each tile byte feeds 2m int8 operations, far below the int8 tensor cores'
// ridge, so the bound is the tile stream. This first version multiplies on
// the CUDA cores (dp4a) and loads a sub-tile before computing on it, so it
// runs well above that bound; mma.sync m16n8k32 .s8 and a pipelined tile
// ring are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 128;            // sub-tile edge, in bytes of a tile row
constexpr int SW = S / 4;         // 32-bit words in a sub-tile row
constexpr int LDW = SW + 1;       // padded row stride in words (no bank conflicts
                                  // when lanes walk rows at a fixed word)
constexpr int MB = 16;            // rows of x per pass over the staged sub-tile
constexpr int THREADS = 2 * S;    // S row owners + S column owners

// shared memory, in words: per plane a row-major and a transposed sub-tile,
// then the staged x words [part][which][word k][row mm]
template <int PLANES>
__host__ __device__ constexpr int tile_words() { return PLANES * 2 * S * LDW; }

template <int PLANES>
__host__ __device__ constexpr size_t smem_bytes() {
  return size_t(tile_words<PLANES>() + PLANES * 2 * SW * MB) * 4;
}

// PLANES == 1: q0 = Q, x0 = qx, acc0 = acc.
// PLANES == 2: q0 = Q1, q1 = Q2, x0 = p1, x1 = p2, acc0 = hi, acc1 = lo.
template <int PLANES>
__global__ void __launch_bounds__(THREADS)
symm_int8_kernel(const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
                 const int8_t* __restrict__ q0, const int8_t* __restrict__ q1,
                 const int* __restrict__ ii, const int* __restrict__ jj,
                 int* __restrict__ acc0, int* __restrict__ acc1, int m, int n,
                 int b) {
  extern __shared__ __align__(16) int smem[];
  int* xs = smem + tile_words<PLANES>();

  const int t = blockIdx.x;
  const int nsub = (b + S - 1) / S;
  const int r0 = (blockIdx.y / nsub) * S;
  const int c0 = (blockIdx.y % nsub) * S;
  const int bi = ii[t];
  const int bj = jj[t];
  const int tid = threadIdx.x;
  const size_t tile_base = size_t(t) * b * b;
  const int pmax = min(S, b - r0);   // valid rows of the sub-tile
  const int qmax = min(S, b - c0);   // valid columns

  // ---- stage each plane's sub-tile row-major, zero outside the tile
  const int8_t* planes[2] = {q0, q1};
#pragma unroll
  for (int pl = 0; pl < PLANES; ++pl) {
    const int8_t* a = planes[pl] + tile_base;
    int* dst = smem + (2 * pl) * S * LDW;
    if (b % 16 == 0) {
      // 16-byte loads; with b and c0 multiples of 16 a chunk is all in or all out
      for (int e = tid; e < S * (S / 16); e += THREADS) {
        const int r = e / (S / 16);
        const int c = (e % (S / 16)) * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < pmax && c < qmax)
          v = __ldcs(reinterpret_cast<const uint4*>(a + size_t(r0 + r) * b + c0 + c));
        int* d = dst + r * LDW + c / 4;
        d[0] = int(v.x);
        d[1] = int(v.y);
        d[2] = int(v.z);
        d[3] = int(v.w);
      }
    } else {
      for (int e = tid; e < S * SW; e += THREADS) {
        const int r = e / SW;
        const int c = (e % SW) * 4;
        uint32_t w = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (r < pmax && c + k < qmax)
            w |= uint32_t(uint8_t(a[size_t(r0 + r) * b + c0 + c + k])) << (8 * k);
        }
        dst[r * LDW + c / 4] = int(w);
      }
    }
  }
  __syncthreads();

  // ---- transposed copy: word (q, p/4) holds Q[p..p+3][q]
#pragma unroll
  for (int pl = 0; pl < PLANES; ++pl) {
    const int* src = smem + (2 * pl) * S * LDW;
    int* dst = smem + (2 * pl + 1) * S * LDW;
    for (int e = tid; e < SW * SW; e += THREADS) {
      const int rb = e / SW;   // rows 4rb .. 4rb+3
      const int cw = e % SW;   // columns 4cw .. 4cw+3
      const uint32_t w0 = uint32_t(src[(4 * rb + 0) * LDW + cw]);
      const uint32_t w1 = uint32_t(src[(4 * rb + 1) * LDW + cw]);
      const uint32_t w2 = uint32_t(src[(4 * rb + 2) * LDW + cw]);
      const uint32_t w3 = uint32_t(src[(4 * rb + 3) * LDW + cw]);
      // byte k of w_r is Q[4rb + r][4cw + k]
      const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);  // w0.0 w1.0 w0.1 w1.1
      const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);  // w0.2 w1.2 w0.3 w1.3
      const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
      const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
      dst[(4 * cw + 0) * LDW + rb] = int(__byte_perm(lo01, lo23, 0x5410));
      dst[(4 * cw + 1) * LDW + rb] = int(__byte_perm(lo01, lo23, 0x7632));
      dst[(4 * cw + 2) * LDW + rb] = int(__byte_perm(hi01, hi23, 0x5410));
      dst[(4 * cw + 3) * LDW + rb] = int(__byte_perm(hi01, hi23, 0x7632));
    }
  }

  const bool row_owner = tid < S;
  const int idx = row_owner ? tid : tid - S;
  const int which = row_owner ? 0 : 1;   // x_j at the columns / x_i at the rows
  const bool active = row_owner ? (idx < pmax) : (idx < qmax && bi != bj);
  const int kw = ((row_owner ? qmax : pmax) + 3) / 4;   // words to reduce over
  // row owner p reads row p of the row-major copy; column owner q reads row q
  // of the transposed copy
  const int* a0 = smem + which * S * LDW + idx * LDW;
  const int* a1 = smem + (2 + which) * S * LDW + idx * LDW;
  const int col = row_owner ? bi * b + r0 + idx : bj * b + c0 + idx;

  for (int mbase = 0; mbase < m; mbase += MB) {
    __syncthreads();  // the transpose, or the previous pass, is done with xs
    // ---- stage MB rows of each x plane: columns of block j, rows of block i
    for (int e = tid; e < PLANES * 2 * MB * SW; e += THREADS) {
      const int k4 = e % SW;
      const int mm = (e / SW) % MB;
      const int wh = (e / (SW * MB)) % 2;
      const int part = e / (2 * SW * MB);
      const int lim = wh == 0 ? qmax : pmax;
      const int base = (wh == 0 ? bj * b + c0 : bi * b + r0) + 4 * k4;
      uint32_t w = 0u;
      if (mbase + mm < m) {
        const int8_t* xp = (part == 0 ? x0 : x1) + size_t(mbase + mm) * n + base;
        if (b % 4 == 0) {
          // lim is then a multiple of 4 and the word is aligned
          if (4 * k4 < lim) w = *reinterpret_cast<const uint32_t*>(xp);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * k4 + k < lim) w |= uint32_t(uint8_t(xp[k])) << (8 * k);
        }
      }
      xs[((part * 2 + wh) * SW + k4) * MB + mm] = int(w);
    }
    __syncthreads();

    if (active) {
      int hi[MB];
      int lo[MB];
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) {
        hi[mm] = 0;
        lo[mm] = 0;
      }
      for (int k = 0; k < kw; ++k) {
        const int qa = a0[k];
        const int4* xv = reinterpret_cast<const int4*>(xs + (which * SW + k) * MB);
        if constexpr (PLANES == 2) {
          const int qb = a1[k];
          const int4* xv2 = reinterpret_cast<const int4*>(xs + ((2 + which) * SW + k) * MB);
#pragma unroll
          for (int v = 0; v < MB / 4; ++v) {
            const int4 u = xv[v];    // p1
            const int4 u2 = xv2[v];  // p2
            hi[4 * v + 0] = __dp4a(qa, u.x, hi[4 * v + 0]);
            hi[4 * v + 1] = __dp4a(qa, u.y, hi[4 * v + 1]);
            hi[4 * v + 2] = __dp4a(qa, u.z, hi[4 * v + 2]);
            hi[4 * v + 3] = __dp4a(qa, u.w, hi[4 * v + 3]);
            lo[4 * v + 0] = __dp4a(qa, u2.x, __dp4a(qb, u.x, lo[4 * v + 0]));
            lo[4 * v + 1] = __dp4a(qa, u2.y, __dp4a(qb, u.y, lo[4 * v + 1]));
            lo[4 * v + 2] = __dp4a(qa, u2.z, __dp4a(qb, u.z, lo[4 * v + 2]));
            lo[4 * v + 3] = __dp4a(qa, u2.w, __dp4a(qb, u.w, lo[4 * v + 3]));
          }
        } else {
#pragma unroll
          for (int v = 0; v < MB / 4; ++v) {
            const int4 u = xv[v];
            hi[4 * v + 0] = __dp4a(qa, u.x, hi[4 * v + 0]);
            hi[4 * v + 1] = __dp4a(qa, u.y, hi[4 * v + 1]);
            hi[4 * v + 2] = __dp4a(qa, u.z, hi[4 * v + 2]);
            hi[4 * v + 3] = __dp4a(qa, u.w, hi[4 * v + 3]);
          }
        }
      }
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) {
        if (mbase + mm < m) {
          atomicAdd(acc0 + size_t(mbase + mm) * n + col, hi[mm]);
          if constexpr (PLANES == 2) atomicAdd(acc1 + size_t(mbase + mm) * n + col, lo[mm]);
        }
      }
    }
  }
}

template <bool SPLIT>
__global__ void symm_int8_epilogue(const int* __restrict__ acc0,
                                   const int* __restrict__ acc1,
                                   const float* __restrict__ xf,
                                   const float* __restrict__ sx,
                                   const float* __restrict__ gq,
                                   const float* __restrict__ d,
                                   float* __restrict__ y, int m, int n) {
  const size_t total = size_t(m) * n;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const int row = int(i / n);
    const int col = int(i % n);
    float a = __int2float_rn(acc0[i]);
    if constexpr (SPLIT)
      a = __fadd_rn(a, __fmul_rn(__int2float_rn(acc1[i]), float(1.0 / 254.0)));
    y[i] = __fadd_rn(__fmul_rn(__fmul_rn(a, sx[row]), gq[col]), __fmul_rn(xf[i], d[col]));
  }
}

template <int PLANES>
int launch(const int8_t* x0, const int8_t* x1, const int8_t* q0,
           const int8_t* q1, const int* ii, const int* jj, const float* xf,
           const float* sx, const float* gq, const float* d, int* acc0,
           int* acc1, float* y, int m, int n, int b, int n_pairs,
           cudaStream_t stream) {
  const int nsub = (b + S - 1) / S;
  if (m <= 0 || n <= 0 || b <= 0 || n_pairs <= 0 || n % b != 0 ||
      nsub * nsub > 65535)
    return int(cudaErrorInvalidValue);
  constexpr size_t smem = smem_bytes<PLANES>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      symm_int8_kernel<PLANES>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  symm_int8_kernel<PLANES><<<dim3(n_pairs, nsub * nsub), THREADS, smem, stream>>>(
      x0, x1, q0, q1, ii, jj, acc0, acc1, m, n, b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t total = size_t(m) * n;
  const int block = 256;
  const size_t blocks = (total + block - 1) / block;
  const int grid = int(blocks < 65536 ? blocks : 65536);   // grid-stride beyond
  symm_int8_epilogue<PLANES == 2><<<grid, block, 0, stream>>>(acc0, acc1, xf, sx, gq, d, y, m, n);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// K4. qx (m, n) int8; q (n_pairs, b, b) int8; xf (m, n) f32; sx (m,) f32;
// gq, d (n,) f32; acc (m, n) int32 zeroed by the caller; y (m, n) f32.
int symm_int8(const int8_t* qx, const int8_t* q, const int* ii, const int* jj,
              const float* xf, const float* sx, const float* gq, const float* d,
              int* acc, float* y, int m, int n, int b, int n_pairs,
              cudaStream_t stream) {
  return launch<1>(qx, qx, q, q, ii, jj, xf, sx, gq, d, acc, acc, y, m, n, b,
                   n_pairs, stream);
}

// K5. p1, p2 (m, n) int8; q1, q2 (n_pairs, b, b) int8; acc1 (hi) and acc2
// (lo) (m, n) int32 zeroed by the caller; the rest as K4.
int symm_int8_split(const int8_t* p1, const int8_t* p2, const int8_t* q1,
                    const int8_t* q2, const int* ii, const int* jj,
                    const float* xf, const float* sx, const float* gq,
                    const float* d, int* acc1, int* acc2, float* y, int m,
                    int n, int b, int n_pairs, cudaStream_t stream) {
  return launch<2>(p1, p2, q1, q2, ii, jj, xf, sx, gq, d, acc1, acc2, y, m, n,
                   b, n_pairs, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
