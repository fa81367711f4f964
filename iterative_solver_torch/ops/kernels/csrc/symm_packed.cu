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
// is read ONCE for both. The Pallas kernel walks the tiles in order with the
// whole (m, N) accumulator resident in VMEM; this card has no such arena and
// runs its blocks in parallel, so the walk is redesigned for it.
//
// What bounds it: bytes. At m = 16 the tiles are read once and carry 32
// flop per bf16 byte, far below the tensor cores' ridge (~295 flop/byte), so
// the bf16 and split variants are byte-bound on the tensor cores, and the
// f32 variant sits at the FMA ridge of the CUDA cores (2 flop per 4 bytes
// per row of x). The design answers the four limits of the first version:
//
// 1. Products on the tensor cores (bf16, split). Each contribution is an
//    m16n8k16 bf16 mma.sync with x as the 16-row M operand and the tile as
//    the N operand: y_i^T-rows = x_j . A_ij^T reads the staged chunk with
//    ldmatrix, y_j-rows = x_i . A_ij reads the SAME staged chunk with
//    ldmatrix.trans. The chunk is XOR-swizzled in 16-byte segments, so both
//    reads are free of bank conflicts. bf16 x bf16 products are exact in
//    f32 and the sums are f32, as on the TPU. The split variant sends
//    xh*hi + xh*lo + xl*hi into one accumulator. The f32 variant stays on the
//    CUDA cores (no TF32): a lane owns 2 tile rows (or columns) x 8 rows of
//    x over half a chunk's depth, so each tile value feeds 8 FMAs and each
//    x value 2, and the lanes forming y_i walk the chunk diagonally so that
//    16-byte rows need no padding that breaks cp.async (symm_packed_f32_kernel).
// 2. An asynchronous tile stream. A work item streams its 64 x 64 chunks
//    through a ring of STAGES shared-memory stages with cp.async (16-byte
//    .cg copies with an L2 evict-first hint; 4-byte ones where b is not a
//    multiple of 16 bytes), STAGES - 1 chunks in flight while one multiplies.
// 3. Partials with a fixed owner, summed in a fixed order. A work item is one
//    S x S square (S <= 256) of one tile; both contributions accumulate in
//    registers over the whole square and are stored once, through shared
//    memory, with plain float4 stores into the item's own two slots of a
//    workspace (slot 2 w: y_i at the square's rows, 2 w + 1: y_j at its
//    columns). A second launch (symm_packed_sum_kernel) owns each (row of x,
//    S-column segment of y): it adds the slots that feed the segment in the
//    order of a list built on the host (symm.py, square_sum_list), so the
//    result has the same bits on every call.
// 4. Work for 132 SMs. The work list (t, r0, c0, diagonal) is built on the
//    host from ii/jj (symm.py, square_work_list), off-diagonal squares
//    first, and cached on the storage object with the segments' list; one
//    block per (square, pass of 16 rows of x).
// A diagonal tile (ii == jj) forms only y_i += x_i A_ii^T. Any b >= 1 and
// m >= 1: ragged chunks are zero-filled, rows of x past m are zero, and b not
// a multiple of 8 (bf16) or 4 (f32, x, y) takes scalar copies and stores.
//
// The partial sums are added in another order than the plain PyTorch
// version's, so the result matches it by tolerance (about 1e-6 of max|y|);
// the order is fixed, so repeated calls give the same bits.
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

typedef __nv_bfloat16 bf16;

constexpr int CH = 64;             // chunk edge
constexpr int NCH = 4;             // chunks along a square's edge
constexpr int SQ = CH * NCH;       // square edge (symm.py SQUARE)
constexpr int MB = 16;             // rows of x per block (one mma M tile)
constexpr int STAGES = 4;          // chunk ring depth
constexpr int THREADS = 256;       // 8 warps
constexpr int XLD = SQ + 8;        // bf16 x staging stride (conflict-free ldmatrix)
constexpr int YLD = SQ + 8;        // f32 flush staging stride
constexpr int FLD = CH + 4;        // f32 chunk stride (16-byte rows)
constexpr int FXS = MB + 4;        // f32 x staging stride per column

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// 16-byte copy to shared memory; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes,
                                           uint64_t pol) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(dst),
      "l"(src), "r"(src_bytes), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits_rn(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// acc[i] <- acc[i + 1], acc[NCH - 1] <- acc[0]: the walk's loops run at run
// time (one copy of the chunk body, which keeps the code in the instruction
// cache), so the sums of the current chunk row or column live in acc[0] and
// the others rotate through it; NCH rotations restore the order.
template <int K>
__device__ __forceinline__ void rotate(float (&acc)[NCH][K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float first = acc[0][k];
#pragma unroll
    for (int i = 0; i + 1 < NCH; ++i) acc[i][k] = acc[i + 1][k];
    acc[NCH - 1][k] = first;
  }
}

// (square, pass) of this block and the extents of its square
struct Item {
  int t, r0, c0, bi, bj, mbase, rows, cols, na, nc;
  bool diag;
};

__device__ __forceinline__ Item read_item(const int4* work, const int* ii, const int* jj,
                                          int b) {
  const int4 w = work[blockIdx.x];
  Item it;
  it.t = w.x;
  it.r0 = w.y;
  it.c0 = w.z;
  it.bi = ii[it.t];
  it.bj = jj[it.t];
  it.diag = it.bi == it.bj;  // from the tiles' own indices, whatever w.w says
  it.mbase = blockIdx.y * MB;
  it.rows = min(SQ, b - it.r0);
  it.cols = min(SQ, b - it.c0);
  it.na = (it.rows + CH - 1) / CH;
  it.nc = (it.cols + CH - 1) / CH;
  return it;
}

// Four consecutive entries x[mbase + mm][col0 + q .. + 3], zero past m and
// past ``extent`` columns.
__device__ __forceinline__ float4 load_x4(const float* x, int m, int n, int row, int col0,
                                          int q, int extent, bool vec4) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= m) return v;
  const float* src = x + size_t(row) * n + col0 + q;
  if (vec4 && q + 4 <= extent) return *reinterpret_cast<const float4*>(src);
  if (q + 0 < extent) v.x = src[0];
  if (q + 1 < extent) v.y = src[1];
  if (q + 2 < extent) v.z = src[2];
  if (q + 3 < extent) v.w = src[3];
  return v;
}

// Store both contributions of a square, staged in ys [2][MB][YLD], into the
// block's slots of ws [2 n_items][m][SQ] (plain float4 stores: the slot
// stride is a multiple of 4 whatever b is; columns past the square's extent
// are never read back).
__device__ __forceinline__ void store_slots(const float* ys, float* ws, const Item& it,
                                            int m, int tid) {
  constexpr int PER = MB * (SQ / 4);
  for (int e = tid; e < 2 * PER; e += THREADS) {
    const int which = e / PER;  // 0: y_i at the square's rows, 1: y_j at its columns
    const int mm = (e % PER) / (SQ / 4);
    const int p = (e % (SQ / 4)) * 4;
    const int ext = which ? it.cols : it.rows;
    if ((which && it.diag) || it.mbase + mm >= m || p >= ext) continue;
    const float4 v = *reinterpret_cast<const float4*>(ys + (which * MB + mm) * YLD + p);
    float* dst = ws + ((size_t(2) * blockIdx.x + which) * m + it.mbase + mm) * SQ + p;
    *reinterpret_cast<float4*>(dst) = v;
  }
}

// y[row][seg's columns] = sum of the slots listed for the segment, in the
// list's order. Segment s = p * nsq + q covers columns p b + q SQ onwards
// (min(SQ, b - q SQ) of them); sums holds the n_seg + 1 offsets of the
// segments' runs, then the runs of slot numbers. A thread owns four
// consecutive columns of one row; four slots are loaded ahead and added in
// order. Every element of y is written (a segment no slot feeds gets 0);
// blocks stride over the rows where m needs more than 65535 of them.
__global__ void __launch_bounds__(THREADS)
symm_packed_sum_kernel(const float* __restrict__ ws, const int* __restrict__ sums,
                       float* __restrict__ y, int m, int n, int b, int n_seg) {
  const int nsq = (b + SQ - 1) / SQ;
  const int seg = blockIdx.x;
  const int sq = seg % nsq;
  const int width = min(SQ, b - sq * SQ);
  const int* slots = sums + n_seg + 1;
  const int k0 = sums[seg], k1 = sums[seg + 1];
  for (size_t e = size_t(blockIdx.y) * THREADS + threadIdx.x; e < size_t(m) * (SQ / 4);
       e += size_t(gridDim.y) * THREADS) {
    const int row = int(e / (SQ / 4));
    const int q4 = int(e % (SQ / 4)) * 4;
    if (q4 >= width) continue;
    auto at = [&](int k) {
      return __ldcs(reinterpret_cast<const float4*>(
          ws + (size_t(slots[k]) * m + row) * SQ + q4));
    };
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](const float4& v) {
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    };
    int k = k0;
    for (; k + 4 <= k1; k += 4) {
      const float4 v0 = at(k), v1 = at(k + 1), v2 = at(k + 2), v3 = at(k + 3);
      add(v0);
      add(v1);
      add(v2);
      add(v3);
    }
    for (; k < k1; ++k) add(at(k));
    float* dst = y + size_t(row) * n + (seg / nsq) * b + sq * SQ + q4;
    if ((b % 4) == 0 && q4 + 4 <= width) {
      *reinterpret_cast<float4*>(dst) = acc;
    } else {
      const float v[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int i = 0; i < 4 && q4 + i < width; ++i) dst[i] = v[i];
    }
  }
}

// ------------------------------------------------ bf16 and split (tensor cores)

// One 64 x 64 chunk of each plane into a stage: rows of 8 16-byte segments,
// segment s of row r stored at s ^ (r & 7).
template <int PLANES>
__device__ __forceinline__ void load_chunk_bf16(bf16* stage, const bf16* a0, const bf16* a1,
                                                size_t tile_base, int R, int C, int b,
                                                bool vec, uint64_t pol, int tid) {
#pragma unroll
  for (int pl = 0; pl < PLANES; ++pl) {
    const bf16* a = (pl == 0 ? a0 : a1) + tile_base;
    bf16* dst_plane = stage + pl * CH * CH;
#pragma unroll
    for (int i = 0; i < CH * 8 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e >> 3;
      const int s = e & 7;
      const int gr = R + r;
      const int gc = C + s * 8;
      bf16* dst = dst_plane + r * CH + ((s ^ (r & 7)) << 3);
      if (vec) {
        const bool ok = gr < b && gc < b;
        cp_async16(smem_u32(dst), ok ? a + size_t(gr) * b + gc : a, ok ? 16 : 0, pol);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t lo = 0, hi = 0;
          if (gr < b && gc + 2 * k < b)
            lo = __bfloat16_as_ushort(a[size_t(gr) * b + gc + 2 * k]);
          if (gr < b && gc + 2 * k + 1 < b)
            hi = __bfloat16_as_ushort(a[size_t(gr) * b + gc + 2 * k + 1]);
          w[k] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// x at SQ columns from col0 into xs [PLANES][MB][XLD] as bf16: rounded
// (PLANES == 1) or split into xh, xl (PLANES == 2).
template <int PLANES>
__device__ __forceinline__ void stage_x_bf16(bf16* xs, const float* x, int m, int n,
                                             int mbase, int col0, int extent, bool vec4,
                                             int tid) {
  for (int e = tid; e < MB * (SQ / 4); e += THREADS) {
    const int mm = e / (SQ / 4);
    const int q = (e % (SQ / 4)) * 4;
    const float4 v = load_x4(x, m, n, mbase + mm, col0, q, extent, vec4);
    const float f[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (PLANES == 2) {
        const uint32_t bits = __float_as_uint(f[k]) & 0xFFFF0000u;
        h[k] = bits >> 16;
        l[k] = bf16_bits_rn(f[k] - __uint_as_float(bits));
      } else {
        h[k] = bf16_bits_rn(f[k]);
      }
    }
    *reinterpret_cast<uint2*>(xs + mm * XLD + q) =
        make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    if (PLANES == 2)
      *reinterpret_cast<uint2*>(xs + (MB + mm) * XLD + q) =
          make_uint2(l[0] | (l[1] << 16), l[2] | (l[3] << 16));
  }
}

// PLANES == 1: a0 holds bf16 tiles, x rounded to bf16.
// PLANES == 2: a0 = hi, a1 = lo, x split into (xh, xl).
// Three blocks per SM for bf16 tiles (80 registers, 50 KB), two for split
// ones (99 KB): more chunks in flight per SM.
template <int PLANES>
__global__ void __launch_bounds__(THREADS, PLANES == 1 ? 3 : 2)
symm_packed_mma_kernel(const float* __restrict__ x, const bf16* __restrict__ a0,
                       const bf16* __restrict__ a1, const int* __restrict__ ii,
                       const int* __restrict__ jj, const int4* __restrict__ work,
                       float* __restrict__ ws, int m, int n, int b) {
  constexpr int STAGE = PLANES * CH * CH;  // bf16 elements per stage
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* xj_s = ring + STAGES * STAGE;       // [PLANES][MB][XLD] x at the square's columns
  bf16* xi_s = xj_s + PLANES * MB * XLD;    // [PLANES][MB][XLD] x at its rows
  float* ys = reinterpret_cast<float*>(smem);  // [2][MB][YLD], after the walk

  const Item it = read_item(work, ii, jj, b);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nchunks = it.na * it.nc;
  const size_t tile_base = size_t(it.t) * b * b;
  const bool vec = (b % 8) == 0;
  const uint64_t pol = evict_first_policy();

  auto fetch = [&](int k) {
    if (k < nchunks)
      load_chunk_bf16<PLANES>(ring + (k % STAGES) * STAGE, a0, a1, tile_base,
                              it.r0 + (k / it.nc) * CH, it.c0 + (k % it.nc) * CH, b, vec,
                              pol, tid);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  // x is staged while the first chunks are in flight
  const bool vec4 = (b % 4) == 0;
  stage_x_bf16<PLANES>(xj_s, x, m, n, it.mbase, it.bj * b + it.c0, it.cols, vec4, tid);
  if (!it.diag)
    stage_x_bf16<PLANES>(xi_s, x, m, n, it.mbase, it.bi * b + it.r0, it.rows, vec4, tid);
  __syncthreads();

  float acc_r[NCH][4];  // y_i: x rows (16) x this warp's 8 tile rows, per chunk row
  float acc_c[NCH][4];  // y_j: x rows (16) x this warp's 8 tile columns, per chunk column
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_r[i][k] = acc_c[i][k] = 0.f;

  // ldmatrix lane addresses: x fragments (row lane & 15, k half lane >> 4);
  // the tile for y_i (row 8 warp + lane & 7, segment (lane >> 3) of a
  // 32-column half) and for y_j (row (lane >> 3) * 8 + lane & 7 of a
  // 32-row half, segment warp)
  const int xrow = lane & 15;
  const int xcol = (lane >> 4) * 8;
  const int pr = 8 * warp + (lane & 7);
  const int sr = lane >> 3;

#pragma unroll 1
  for (int a = 0; a < it.na; ++a) {
    // x_i fragments of chunk row a, for the y_j products (4 k-steps)
    uint32_t fxi[PLANES][4][4];
    if (!it.diag) {
#pragma unroll
      for (int pt = 0; pt < PLANES; ++pt)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ldsm_x4(smem_u32(xi_s + (pt * MB + xrow) * XLD + a * CH + ks * 16 + xcol),
                  fxi[pt][ks]);
    }
#pragma unroll 1
    for (int c = 0; c < it.nc; ++c) {
      const int k = a * it.nc + c;
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // chunk k landed for all; chunk k - 1's stage is free
      fetch(k + STAGES - 1);
      const bf16* st = ring + (k % STAGES) * STAGE;

      // y_i += x_j A^T: B[k = q][n = p] = A[p][q], rows of the chunk
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int seg = 4 * h + sr;
        uint32_t bt[PLANES][4];
#pragma unroll
        for (int pl = 0; pl < PLANES; ++pl)
          ldsm_x4(smem_u32(st + pl * CH * CH + pr * CH + ((seg ^ (pr & 7)) << 3)),
                  bt[pl]);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int ks = 2 * h + kk;
          uint32_t fx[PLANES][4];
#pragma unroll
          for (int pt = 0; pt < PLANES; ++pt)
            ldsm_x4(smem_u32(xj_s + (pt * MB + xrow) * XLD + c * CH + ks * 16 + xcol),
                    fx[pt]);
          mma_bf16(acc_r[0], fx[0], bt[0][2 * kk], bt[0][2 * kk + 1]);
          if (PLANES == 2) {
            mma_bf16(acc_r[0], fx[0], bt[1][2 * kk], bt[1][2 * kk + 1]);
            mma_bf16(acc_r[0], fx[PLANES - 1], bt[0][2 * kk], bt[0][2 * kk + 1]);
          }
        }
      }
      // y_j += x_i A: B[k = p][n = q] = A[p][q], columns of the chunk
      if (!it.diag) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 32 * h + 8 * sr + (lane & 7);
          uint32_t bt[PLANES][4];
#pragma unroll
          for (int pl = 0; pl < PLANES; ++pl)
            ldsm_x4_trans(
                smem_u32(st + pl * CH * CH + p * CH + ((warp ^ (p & 7)) << 3)),
                bt[pl]);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int ks = 2 * h + kk;
            mma_bf16(acc_c[0], fxi[0][ks], bt[0][2 * kk], bt[0][2 * kk + 1]);
            if (PLANES == 2) {
              mma_bf16(acc_c[0], fxi[0][ks], bt[1][2 * kk], bt[1][2 * kk + 1]);
              mma_bf16(acc_c[0], fxi[PLANES - 1][ks], bt[0][2 * kk],
                       bt[0][2 * kk + 1]);
            }
          }
        }
      }
      rotate(acc_c);  // the next chunk column's sums
    }
    for (int r = it.nc; r < NCH; ++r) rotate(acc_c);
    rotate(acc_r);      // the next chunk row's sums
  }
  for (int r = it.na; r < NCH; ++r) rotate(acc_r);

  // ---- flush: fragments -> ys (aliases the ring) -> the block's slots
  cp_async_wait<0>();
  __syncthreads();
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int a = 0; a < NCH; ++a) {
    if (a < it.na) {
      const int p = a * CH + 8 * warp + t2;
      *reinterpret_cast<float2*>(ys + g * YLD + p) = make_float2(acc_r[a][0], acc_r[a][1]);
      *reinterpret_cast<float2*>(ys + (g + 8) * YLD + p) =
          make_float2(acc_r[a][2], acc_r[a][3]);
    }
  }
  if (!it.diag) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c < it.nc) {
        const int q = c * CH + 8 * warp + t2;
        *reinterpret_cast<float2*>(ys + (MB + g) * YLD + q) =
            make_float2(acc_c[c][0], acc_c[c][1]);
        *reinterpret_cast<float2*>(ys + (MB + g + 8) * YLD + q) =
            make_float2(acc_c[c][2], acc_c[c][3]);
      }
    }
  }
  __syncthreads();
  store_slots(ys, ws, it, m, tid);
}

// ------------------------------------------------------ f32 (CUDA cores)

// x at SQ columns from col0 into xs [SQ][FXS] (column-major: one column's
// rows are float4 reads; the stride of 20 floats keeps the 8 lanes of a
// quarter-warp reading 8 consecutive columns on distinct banks)
__device__ __forceinline__ void stage_x_f32(float* xs, const float* x, int m, int n, int mbase,
                                            int col0, int extent, bool vec4, int tid) {
  for (int e = tid; e < MB * (SQ / 4); e += THREADS) {
    const int mm = e & (MB - 1);
    const int q = (e / MB) * 4;
    const float4 v = load_x4(x, m, n, mbase + mm, col0, q, extent, vec4);
    xs[(q + 0) * FXS + mm] = v.x;
    xs[(q + 1) * FXS + mm] = v.y;
    xs[(q + 2) * FXS + mm] = v.z;
    xs[(q + 3) * FXS + mm] = v.w;
  }
}

// Warps 0-3 form y_i, warps 4-7 form y_j. A lane owns two tile rows (y_i)
// or columns (y_j), l and l + 32 of the chunk, for 8 rows of x (warp & 1)
// over half the chunk's depth ((warp >> 1) & 1): each x value feeds 2 FMAs
// and each tile value 8, and the two halves are summed once per square. The
// chunk arrives by 16-byte cp.async into rows of 68 floats; y_j lanes read
// along a row, y_i lanes walk the chunk diagonally (lane l reads column
// (s + l) mod 32 at step s: bank (5 l + s) mod 32), so neither read conflicts.
__global__ void __launch_bounds__(THREADS, 2)
symm_packed_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                       const int* __restrict__ ii, const int* __restrict__ jj,
                       const int4* __restrict__ work, float* __restrict__ ws, int m, int n,
                       int b) {
  constexpr int STAGE = CH * FLD;
  constexpr int HALF = CH / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* xj_s = ring + STAGES * STAGE;  // [SQ][FXS]
  float* xi_s = xj_s + SQ * FXS;        // [SQ][FXS]
  float* ys = ring;                     // [2][MB][YLD], after the walk

  const Item it = read_item(work, ii, jj, b);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nchunks = it.na * it.nc;
  const float* tile = a + size_t(it.t) * b * b;
  const bool vec4 = (b % 4) == 0;
  const uint64_t pol = evict_first_policy();

  auto fetch = [&](int k) {
    if (k < nchunks) {
      float* stage = ring + (k % STAGES) * STAGE;
      const int R = it.r0 + (k / it.nc) * CH;
      const int C = it.c0 + (k % it.nc) * CH;
#pragma unroll
      for (int e = tid; e < CH * CH / 4; e += THREADS) {
        const int r = e / (CH / 4);
        const int q = (e % (CH / 4)) * 4;
        const float* src = tile + size_t(R + r) * b + C + q;
        const uint32_t dst = smem_u32(stage + r * FLD + q);
        if (vec4) {
          const bool ok = R + r < b && C + q < b;
          cp_async16(dst, ok ? src : tile, ok ? 16 : 0, pol);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool ok = R + r < b && C + q + i < b;
            cp_async4(dst + 4 * i, ok ? src + i : tile, ok ? 4 : 0);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  stage_x_f32(xj_s, x, m, n, it.mbase, it.bj * b + it.c0, it.cols, vec4, tid);
  if (!it.diag) stage_x_f32(xi_s, x, m, n, it.mbase, it.bi * b + it.r0, it.rows, vec4, tid);
  __syncthreads();

  const bool row_warp = warp < 4;
  const int mm0 = 8 * (warp & 1);
  const int k0 = HALF * ((warp >> 1) & 1);  // this warp's half of the chunk's depth
  // acc[a] (row warps) or acc[c] (column warps): lane's 2 rows/columns x 8 rows of x
  // [i][8 j + r]: tile row/column l + 32 j, row mm0 + r of x
  float acc[NCH][16];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[i][k] = 0.f;

#pragma unroll 1
  for (int a = 0; a < it.na; ++a) {
#pragma unroll 1
    for (int c = 0; c < it.nc; ++c) {
      const int k = a * it.nc + c;
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      fetch(k + STAGES - 1);
      const float* st = ring + (k % STAGES) * STAGE;
      if (row_warp) {
        // y_i[mm][p] += sum_q A[p][q] x_j[mm][q], p = lane, lane + 32
        const float* arow = st + lane * FLD + k0;
        const float* xv = xj_s + (c * CH + k0) * FXS + mm0;
#pragma unroll 4
        for (int s = 0; s < HALF; ++s) {
          const int q = (s + lane) & (HALF - 1);
          const float a0 = arow[q];
          const float a1 = arow[32 * FLD + q];
          const float4 u = *reinterpret_cast<const float4*>(xv + q * FXS);
          const float4 w = *reinterpret_cast<const float4*>(xv + q * FXS + 4);
          const float xs[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            acc[0][r] = fmaf(a0, xs[r], acc[0][r]);
            acc[0][8 + r] = fmaf(a1, xs[r], acc[0][8 + r]);
          }
        }
      } else if (!it.diag) {
        // y_j[mm][q] += sum_p A[p][q] x_i[mm][p], q = lane, lane + 32
        const float* acol = st + k0 * FLD + lane;
        const float* xv = xi_s + (a * CH + k0) * FXS + mm0;
#pragma unroll 4
        for (int p = 0; p < HALF; ++p) {
          const float a0 = acol[p * FLD];
          const float a1 = acol[p * FLD + 32];
          const float4 u = *reinterpret_cast<const float4*>(xv + p * FXS);
          const float4 w = *reinterpret_cast<const float4*>(xv + p * FXS + 4);
          const float xs[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            acc[0][r] = fmaf(a0, xs[r], acc[0][r]);
            acc[0][8 + r] = fmaf(a1, xs[r], acc[0][8 + r]);
          }
        }
      }
      if (!row_warp) rotate(acc);  // the next chunk column's sums
    }
    if (row_warp) {
      rotate(acc);                     // the next chunk row's sums
    } else {
      for (int r = it.nc; r < NCH; ++r) rotate(acc);
    }
  }
  if (row_warp)
    for (int r = it.na; r < NCH; ++r) rotate(acc);

  // ---- flush: the first depth half writes ys, the second adds to it
  cp_async_wait<0>();
  __syncthreads();
  const int which = row_warp ? 0 : 1;
  const int nblk = row_warp ? it.na : it.nc;
  float* yrow = ys + (which * MB + mm0) * YLD + lane;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (k0 == half * HALF) {
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        if (i < nblk) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              float* dst = yrow + r * YLD + i * CH + 32 * j;
              *dst = half ? *dst + acc[i][8 * j + r] : acc[i][8 * j + r];
            }
        }
      }
    }
    __syncthreads();
  }
  store_slots(ys, ws, it, m, tid);
}

// ------------------------------------------------------------------ launch

template <typename T>
constexpr size_t ring_bytes(int planes) {
  return size_t(STAGES) * planes * CH * (sizeof(T) == 2 ? CH : FLD) * sizeof(T);
}

constexpr size_t max2(size_t u, size_t v) { return u > v ? u : v; }

constexpr size_t YS_BYTES = size_t(2) * MB * YLD * sizeof(float);

template <int PLANES>
constexpr size_t mma_smem() {
  return max2(ring_bytes<bf16>(PLANES) + size_t(2) * PLANES * MB * XLD * sizeof(bf16),
              YS_BYTES);
}

constexpr size_t f32_smem() {
  return max2(ring_bytes<float>(1) + size_t(2) * SQ * FXS * sizeof(float), YS_BYTES);
}

int check_shape(int m, int n, int b, int n_items, int n_seg) {
  if (m <= 0 || n <= 0 || b <= 0 || n_items <= 0 || n % b != 0 ||
      n_seg != (n / b) * ((b + SQ - 1) / SQ) || (m + MB - 1) / MB > 65535)
    return int(cudaErrorInvalidValue);
  return 0;
}

// The square walk into the slots, then the fixed-order sums into y.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, const float* ws, const int* sums, float* y, int m,
           int n, int b, int n_items, int n_seg, cudaStream_t stream, Args... args) {
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(n_items, (m + MB - 1) / MB), THREADS, smem, stream>>>(args...);
  if (cudaError_t e = cudaGetLastError()) return int(e);
  const size_t row_blocks = (size_t(m) * SQ / 4 + THREADS - 1) / THREADS;
  const int per_seg = int(row_blocks < 65535 ? row_blocks : 65535);
  symm_packed_sum_kernel<<<dim3(n_seg, per_seg), THREADS, 0, stream>>>(ws, sums, y, m, n, b,
                                                                        n_seg);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The square edge the work list must use (symm.py SQUARE).
int symm_packed_square_edge() { return SQ; }

// y (m, n) f32, every element written; x (m, n) f32; tiles (n_pairs, b, b);
// work (n_items, 4) int32 rows (t, r0, c0, diagonal), 16-byte aligned;
// sums the segments' slot lists (n_seg = (n / b) ceil(b / SQ) segments);
// ws (2 n_items, m, SQ) f32 scratch, 16-byte aligned.
int symm_packed_f32(const float* x, const float* a, const int* ii, const int* jj,
                    const int* work, const int* sums, float* ws, float* y, int m, int n,
                    int b, int n_items, int n_seg, cudaStream_t stream) {
  if (int e = check_shape(m, n, b, n_items, n_seg)) return e;
  return launch(symm_packed_f32_kernel, f32_smem(), ws, sums, y, m, n, b, n_items, n_seg,
                stream, x, a, ii, jj, reinterpret_cast<const int4*>(work), ws, m, n, b);
}

int symm_packed_bf16(const float* x, const bf16* a, const int* ii, const int* jj,
                     const int* work, const int* sums, float* ws, float* y, int m, int n,
                     int b, int n_items, int n_seg, cudaStream_t stream) {
  if (int e = check_shape(m, n, b, n_items, n_seg)) return e;
  return launch(symm_packed_mma_kernel<1>, mma_smem<1>(), ws, sums, y, m, n, b, n_items,
                n_seg, stream, x, a, a, ii, jj, reinterpret_cast<const int4*>(work), ws, m,
                n, b);
}

int symm_packed_split(const float* x, const bf16* hi, const bf16* lo, const int* ii,
                      const int* jj, const int* work, const int* sums, float* ws, float* y,
                      int m, int n, int b, int n_items, int n_seg, cudaStream_t stream) {
  if (int e = check_shape(m, n, b, n_items, n_seg)) return e;
  return launch(symm_packed_mma_kernel<2>, mma_smem<2>(), ws, sums, y, m, n, b, n_items,
                n_seg, stream, x, hi, lo, ii, jj, reinterpret_cast<const int4*>(work), ws,
                m, n, b);
}

const char* kernel_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
