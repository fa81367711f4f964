// Int8 packed lower-triangle symmetric action on Hopper (sm_90a).
//
// Replaces two Pallas kernels of iterative_solver_tpu/ops/kernels/symm_int8.py:
//   symm_int8       <- _symm_matmat_int8_impl (K4, :344, pallas_call :397),
//                      one int8 plane Q, in one of three walks chosen per
//                      call (symm_int8.py int8_walk): at one M tile on an
//                      operator with bands enough to fill the card,
//                      symm_int8_band_kernel (the band walk; see "K4 at one
//                      M tile" below); at four M tiles (33 to 64 rows of
//                      x) on one with strips enough, symm_int8_strip_kernel
//                      (the strip walk; "K4 at four M tiles"); otherwise
//                      symm_int8_mma_kernel<MT, 1> (the square walk);
//   symm_int8_split <- _symm_matmat_int8_split_impl (K5, :430, pallas_call
//                      :493), two planes Q1, Q2 and two x planes p1, p2:
//                      the same kernel on two planes, symm_int8_mma_kernel<1, 2>
//                      (hi = p1 Q1, lo = p1 Q2 + p2 Q1; see Cfg). It
//                      replaced the first port's dp4a kernel, which ran at
//                      22% of its byte bound.
//
// The off-diagonal part of the operator is stored as the (b, b) int8 tiles
// Q_ij of its lower triangle, listed by (ii[t], jj[t]) with jj <= ii. x comes
// in already quantized (qx, or p1 and p2, int8, made by the wrapper with the
// plain version's torch ops). Every tile carries two contributions,
//     acc_i += qx_j Q_ij^T        and, when i != j,      acc_j += qx_i Q_ij,
// summed exactly in int32 into (m, n) accumulators that the wrapper zeroes
// (K5: hi and lo, three such products per tile). Integer addition is exact
// in any order, so the accumulators, and the epilogue's y, equal the plain
// version bit for bit.
//
// What bounds K4 on this card: the tile stream. At the solver's row counts
// (m = 16 to 64) each tile byte feeds 2m int8 products; at m = 64 the
// PPCG flagship (n = 32768, b = 1024, 554 MB of tiles) needs 0.171 ms of
// bytes and, on the int8 tensor cores, about half that of products. The
// first port's kernel (dp4a) ran at 8% of that bound, held back by three
// limits; the design answers each:
//
// 1. Products on the int8 tensor cores. Each contribution is an
//    mma.sync m16n8k32 .s32.s8.s8.s32 (no .satfinite: from_dense's headroom
//    check rules out int32 overflow) with x as the 16-row A operand and the
//    tile as B. y_i += x_j Q^T contracts over the tile's column index, so
//    the row-major staged chunk is B's K-major layout and plain ldmatrix
//    gives its fragments. y_j += x_i Q contracts over the row index and
//    needs the chunk's bytes transposed, which ldmatrix.trans (16-bit
//    elements) cannot give for int8. Choice: the transpose is built in
//    registers, with no shared-memory copy and no shuffle. ldmatrix.trans
//    hands lane (g, t) the byte pairs (Q[p][2g], Q[p][2g+1]) of rows 2t and
//    2t + 1 of each 8-row matrix; the lanes' row addresses are chosen so
//    that those are rows 4t, 4t + 1 of one matrix and 4t + 2, 4t + 3 of the
//    next, and two prmt per pair of matrices then give, for one column, the
//    four bytes of rows 4t .. 4t + 3: B's K-major fragment, for the even and
//    for the odd columns of 16 (two N tiles, whose outputs land on four
//    consecutive columns of a lane). A shared-memory transpose would cost a
//    second staged copy, a barrier and scalar shared stores per chunk; this
//    costs four prmt per lane per 32 x 16 block. A diagonal tile
//    (ii == jj) forms only the first contribution.
// 2. An asynchronous tile stream. Each stage of a ring of STAGES holds one
//    chunk column of a square: up to 256 rows x 64 bytes, four 64 x 64
//    chunks, filled by cp.async (16-byte .cg copies; 4-byte ones where b is
//    not a multiple of 16, byte loads where it is not one of 4; K1's L2
//    evict-first hint is left out, see cp_async16). STAGES - 1 stages are in
//    flight while one multiplies. Blocks are persistent: a block walks the
//    squares blockIdx.x + k gridDim.x, its stream runs on from one square
//    into the next, and the next square's x is copied in the same way while
//    the current one multiplies. Rows are XOR-swizzled in 16-byte segments
//    (swz), so ldmatrix and the transposing ldmatrix.trans read them without
//    bank conflicts.
// 3. Each tile byte leaves device memory once per call, for all m rows, and
//    each work item flushes once. A work item is one SQ x SQ square of one
//    tile for MT M tiles of 16 rows of x at once (MT = 1, 2 or 4, chosen per
//    call from m; m > 64 takes passes of 64 rows, reading the tiles again).
//    The walk goes chunk column by chunk column. Half the warps form y_i,
//    half y_j, each sum owned by one warp over the chunk's whole depth:
//    y_i of the whole square stays in registers and is flushed from them
//    at its end; y_j of a chunk column is complete with its column and is
//    flushed from them then. PTX has no vector red for s32, so where b is even two
//    neighbouring int32 sums go out as one 64-bit red (red_pair): at the
//    flagship 134 M reds carry 268 M sums, where the first port issued 537 M
//    32-bit ones (symm_int8.int8_flush_atomics counts them).
// 4. Work for 132 SMs: as many persistent blocks as fit (one per SM at
//    MT = 4, two at MT = 2, three at MT = 1), each deriving its squares'
//    (t, r0, c0) from its index, with no host work list: 576 squares at
//    b = 1024, n = 8192; 8448 at the flagship. A block's warps take one of
//    two roles, y_i or y_j, with equal products (Cfg).
//
// What limits the square walk (H100, flagship): the SM's shared-memory and
// load / store pipe, not the bytes. Per 4 KB chunk the warps issue about
// 36 KB of ldmatrix (each tile fragment is read by up to two warps, each x
// fragment by four or eight, as 128 registers at 512 threads allow),
// beside the cp.async stores and the reds, and those costs add rather than
// overlap: without the reds the kernel takes about three quarters of its
// time, without the reds and the tile loads about half, and the products
// reach under a tenth of the int8 tensor-core peak. At one and at four M
// tiles the band and strip walks take its place (a TMA stream of whole
// tile rows; the strip walk's products as wgmma from shared memory); it
// stays for two M tiles, more than 64 rows, unaligned operands, b > 1024
// and K5.
//
// Any b >= 1 and m >= 1: ragged chunks are zero-filled, rows of x past m
// and columns past b are zero in the staging, the flush skips them.
//
// K4 at one M tile: the band walk (symm_int8_band_kernel). At m <= 16 the
// square walk ran at 46% of its byte bound on the benchmark's operator
// (16 x 131072, b = 1024, 8.06 GiB): its stream alone, with no products
// and no reds, took 4.12 ms against a bound of 2.59 (H100), as every 1 KB
// tile row left device memory in 16 pieces of 64 bytes, each fetched by
// cp.async and released by a block-wide barrier per stage. The band walk
// streams whole tile rows instead: a work item is 256 rows of a tile
// across its width, a stage 32 whole rows (32 KB) loaded by TMA boxes of
// 128-byte lines with the 128-byte swizzle, one producer warp, full and
// empty mbarriers and no block-wide barrier in the stream (the layout and
// the roles are in the note above the kernel). Its stream alone takes 2.74
// ms (94% of the bound); with the products and the flushes 3.3 ms (78%):
// what bounds it now is its flushes, 0.5 ms of y_j reds into the
// accumulator (16 K 32-bit sums a band); carrying y_j along the four
// bands of a tile would cut them fourfold. The square walk stays for:
//  - m > 16 (two or four M tiles): a band's y_j would take 32-64 K int32
//    a block, which the register file cannot hold beside the ring (at
//    four M tiles the strip walk turns the walk the other way);
//  - b not a multiple of 16, or an operand not 16-byte aligned: TMA's
//    strides and the bulk copies of x need 16 bytes;
//  - b > 1024: a warp holds y_j of one 128-byte line, eight warps eight;
//  - too few bands to fill the card (symm_int8.py int8_walk: fewer than 8
//    an SM): one block an SM would leave most SMs one or two bands, where
//    the square walk's three blocks an SM do as well (16 x 8192);
//  - K5, whose two planes double every sum.
//
// A second launch from this file is the epilogue, once per output element:
//   K4: y = float(acc) * sx[row] * gq[col] + xf * d[col]
//   K5: y = (float(hi) + float(lo) * (float)(1/254)) * sx[row] * gq[col] + xf * d[col]
// written with __fmul_rn / __fadd_rn in the order PyTorch's plain expression
// rounds, ((acc * sx) * gq) + (xf * d), so nvcc contracts nothing into an
// FMA and y equals the plain version bit for bit too. Where b is even it
// first adds back the 64-bit reds' carry into the odd columns of each
// accumulator (hi and lo alike; red_pair).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ------------------------------------------------------------------ helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory, bypassing L1; src_bytes = 0 writes zeros.
// (K1's L2 evict-first cache hint is left out: with it, a thread issuing
// four of these per stage faulted with an illegal instruction on the H100.)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
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

// d (16 x 8, s32) += a (16 x 32, s8, row) . b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------ K4 and K5: int8 tensor cores

constexpr int SQ = 256;              // square edge (symm_int8.py SQUARE_INT8)
constexpr int CH = 64;               // chunk edge, bytes of a tile row
constexpr int NCH = SQ / CH;         // chunks along a square's edge
constexpr int STAGE = SQ * CH;       // bytes per stage: one chunk column of a square
constexpr int MTILE = 16;            // rows of x per mma M tile
constexpr int XLD = SQ + 16;         // staged x row stride, bytes (conflict-free ldmatrix)

// MT M tiles per block, in 8 warps (MT = 1, 2) or 16 (MT = 4), half of
// them forming y_i and half y_j, each warp over all of a chunk's depth and
// for every M tile it takes, so that each y sum has one owner and leaves
// from its registers. y_i warp w (NW of them) takes the chunk's rows
// (64 / NW) w .. + 64 / NW - 1 for all MT M tiles; y_j warp w takes the
// chunk's columns 16 (w & 3) .. + 15 for the MJ M tiles from MJ (w >> 2).
// Both do 4 MT products per chunk at MT = 1 and 8 at MT = 2, 4.
//
// PL planes: K4 has one (Q, x quantized as qx); K5 two (Q1, Q2; p1, p2),
// and per fragment pair three products into two sums, hi += p1 Q1 and
// lo += p1 Q2 + p2 Q1 (the p2 Q2 term is dropped, as in the plain
// version). Each stage holds the chunk column of both planes, and the x
// buffers both x planes. The y_i warp's sums double with the second plane:
// at MT = 1 they are 64 registers, at MT = 2 they would be 128, over the
// 128-register cap of two blocks per SM. So K5 takes MT = 1 at every m (16
// rows of x per pass over the tiles; m > 16 takes passes), two blocks per
// SM (the cap of three would spill) and two stages (99 KB: three stages of
// two planes, 131 KB, would leave one block per SM).
template <int MT, int PL>
struct Cfg {
  static_assert(PL == 1 || MT == 1, "two planes take one M tile");
  static constexpr int NW = MT == 4 ? 8 : 4;          // warps per role
  static constexpr int RG = 8 / NW;                   // y_i: 8-row groups per warp
  static constexpr int MJ = MT == 1 ? 1 : 2;          // y_j: M tiles per warp
  static constexpr int THREADS = 64 * NW;
  static constexpr int BLOCKS_PER_SM = PL == 2 ? 2 : (MT == 4 ? 1 : (MT == 2 ? 2 : 3));
  static constexpr int STAGES = PL == 2 ? 2 : (MT == 4 ? 4 : 3);
  static constexpr int ROWS = MTILE * MT;             // rows of x per block
  static constexpr int RING = STAGES * PL * STAGE;    // a stage: the chunk column of each plane
  static constexpr int XS = ROWS * XLD;               // one staged x buffer
  // ring, then x_j and x_i of each plane for two items
  static constexpr size_t SMEM = size_t(RING) + 4 * PL * XS;
};

// 16-byte segment s of stage row r is stored at s ^ swz(r): conflict-free
// for ldmatrix of 8 consecutive rows and of the transposing row sets below.
__device__ __forceinline__ int swz(int r) { return ((r >> 1) ^ (r >> 3)) & 3; }

// One work item: a square of one tile and its extents.
struct Square {
  int t, r0, c0, rows, cols, na, nc;
};

__device__ __forceinline__ Square square_of(int item, int b) {
  const int nsq = (b + SQ - 1) / SQ;
  Square sq;
  sq.t = item / (nsq * nsq);
  const int s = item - sq.t * nsq * nsq;
  sq.r0 = (s / nsq) * SQ;
  sq.c0 = (s % nsq) * SQ;
  sq.rows = min(SQ, b - sq.r0);
  sq.cols = min(SQ, b - sq.c0);
  sq.na = (sq.rows + CH - 1) / CH;
  sq.nc = (sq.cols + CH - 1) / CH;
  return sq;
}

// x at SQ columns from col0 into [ROWS][XLD] bytes, zero past m and past
// ``extent``: 16-byte cp.async (vec 16), 4-byte (vec 4) or byte loads.
template <int MT, int PL>
__device__ __forceinline__ void fetch_x(unsigned char* xs, const int8_t* x, int m, int n,
                                        int mbase, int col0, int extent, int vec, int tid) {
  using C = Cfg<MT, PL>;
  if (vec == 16) {
    for (int e = tid; e < C::ROWS * (SQ / 16); e += C::THREADS) {
      const int mm = e / (SQ / 16);
      const int q = (e % (SQ / 16)) * 16;
      const bool ok = mbase + mm < m && q < extent;
      cp_async16(smem_u32(xs + mm * XLD + q), ok ? x + size_t(mbase + mm) * n + col0 + q : x,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < C::ROWS * (SQ / 4); e += C::THREADS) {
      const int mm = e / (SQ / 4);
      const int q = (e % (SQ / 4)) * 4;
      const int8_t* src = x + size_t(mbase + mm) * n + col0 + q;
      if (vec == 4) {
        const bool ok = mbase + mm < m && q < extent;
        cp_async4(smem_u32(xs + mm * XLD + q), ok ? src : x, ok ? 4 : 0);
      } else {
        uint32_t v = 0u;
        if (mbase + mm < m)
          for (int k = 0; k < 4 && q + k < extent; ++k)
            v |= uint32_t(uint8_t(src[k])) << (8 * k);
        *reinterpret_cast<uint32_t*>(xs + mm * XLD + q) = v;
      }
    }
  }
}

// acc[0] += v0, acc[1] += v1 as one 64-bit red of v1 * 2^32 + v0 (acc 8-byte
// aligned, the pair always added this way). Sums modulo 2^64 are exact, so
// the pair ends as the 64-bit integer B * 2^32 + A of its two int32 sums:
// acc[0] holds A, and acc[1] holds B, less one where A < 0 (the epilogue
// adds it back).
__device__ __forceinline__ void red_pair(int* p, int v0, int v1) {
  const long long v = (long long)v1 * 4294967296LL + (long long)v0;
  atomicAdd(reinterpret_cast<unsigned long long*>(p), (unsigned long long)v);
}

// acc (m, n) += the two contributions of the squares blockIdx.x,
// blockIdx.x + gridDim.x, ... of the tiles, for ROWS rows of x from
// blockIdx.y * ROWS. vec, xvec: 16 (16-byte copies), 4 or 1 (byte loads)
// for the tiles and for x; packed: b even, 64-bit reds of column pairs.
// PL = 2: x, x2 = p1, p2; q, q2 = Q1, Q2; acc, acc2 = hi, lo.
template <int MT, int PL>
__global__ void __launch_bounds__(Cfg<MT, PL>::THREADS, Cfg<MT, PL>::BLOCKS_PER_SM)
symm_int8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ x2,
                     const int8_t* __restrict__ q, const int8_t* __restrict__ q2,
                     const int* __restrict__ ii, const int* __restrict__ jj,
                     int* __restrict__ acc, int* __restrict__ acc2, int m, int n, int b,
                     int items, int vec, int xvec) {
  using C = Cfg<MT, PL>;
  extern __shared__ __align__(128) unsigned char smem_k4[];
  unsigned char* ring = smem_k4;
  unsigned char* xbuf = ring + C::RING;   // [item & 1][x_j of each plane, x_i of each plane]
  const int8_t* const xs_src[2] = {x, x2};
  const int8_t* const qs_src[2] = {q, q2};
  int* const out_acc[2] = {acc, acc2};

  const bool packed = (b & 1) == 0;
  const int ncs = (min(b, SQ) + CH - 1) / CH;  // chunk columns per item, at most
  const int mbase = blockIdx.y * C::ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // Stage g of this block's stream: chunk column g % ncs of its item g / ncs
  // (rows past the square zero-filled), of each plane; past the last item,
  // or past a ragged square's columns, nothing. At an item's first column,
  // also x of the item after it, into the other x buffer.
  auto fetch = [&](int g) {
    const int j = g / ncs;
    const int c = g - j * ncs;
    const int item = blockIdx.x + j * gridDim.x;
    if (item < items) {
      const Square sq = square_of(item, b);
      if (c < sq.nc) {
        const int col = sq.c0 + c * CH;    // first tile column of the chunk column
        const int qmax = sq.cols - c * CH; // its valid columns
#pragma unroll
        for (int pl = 0; pl < PL; ++pl) {
          unsigned char* stage = ring + ((g % C::STAGES) * PL + pl) * STAGE;
          const int8_t* tile = qs_src[pl] + size_t(sq.t) * b * b;
          if (vec == 16) {
            for (int e = tid; e < sq.na * CH * 4; e += C::THREADS) {
              const int r = e >> 2;
              const int sg = e & 3;
              const bool ok = r < sq.rows && 16 * sg < qmax;
              cp_async16(smem_u32(stage + r * CH + ((sg ^ swz(r)) << 4)),
                         ok ? tile + size_t(sq.r0 + r) * b + col + 16 * sg : tile, ok ? 16 : 0);
            }
          } else {
            for (int e = tid; e < sq.na * CH * 16; e += C::THREADS) {
              const int r = e >> 4;
              const int w = e & 15;
              unsigned char* dst = stage + r * CH + (((w >> 2) ^ swz(r)) << 4) + 4 * (w & 3);
              const int8_t* src = tile + size_t(sq.r0 + r) * b + col + 4 * w;
              if (vec == 4) {
                const bool ok = r < sq.rows && 4 * w < qmax;
                cp_async4(smem_u32(dst), ok ? src : tile, ok ? 4 : 0);
              } else {
                uint32_t v = 0u;
                if (r < sq.rows)
                  for (int k = 0; k < 4 && 4 * w + k < qmax; ++k)
                    v |= uint32_t(uint8_t(src[k])) << (8 * k);
                *reinterpret_cast<uint32_t*>(dst) = v;
              }
            }
          }
        }
      }
    }
  };
  auto fetch_item_x = [&](int j) {
    const int item = blockIdx.x + j * gridDim.x;
    if (item < items) {
      const Square sq = square_of(item, b);
      unsigned char* xs = xbuf + (j & 1) * 2 * PL * C::XS;
#pragma unroll
      for (int pl = 0; pl < PL; ++pl) {
        fetch_x<MT, PL>(xs + pl * C::XS, xs_src[pl], m, n, mbase, jj[sq.t] * b + sq.c0, sq.cols,
                        xvec, tid);
        if (ii[sq.t] != jj[sq.t])
          fetch_x<MT, PL>(xs + (PL + pl) * C::XS, xs_src[pl], m, n, mbase,
                          ii[sq.t] * b + sq.r0, sq.rows, xvec, tid);
      }
    }
  };
  fetch_item_x(0);
#pragma unroll 1
  for (int g = 0; g < C::STAGES - 1; ++g) {
    fetch(g);
    cp_async_commit();
  }

  const int g4 = lane >> 2;
  const int t4 = lane & 3;
  const int xrow = lane & 15;          // ldmatrix lane address of an A fragment
  const int xk = (lane >> 4) * 16;
  // ldmatrix.trans row of this lane in a 32-row half: matrix j (lane >> 3)
  // takes rows 4 (i >> 1) + (i & 1) + 2 (j & 1) (+ 16 for j >= 2), so that
  // the two byte pairs a lane receives from matrices 0 and 1 (and 2 and 3)
  // are four consecutive rows of one column
  const int tr = 16 * (lane >> 4) + 4 * ((lane & 7) >> 1) + (lane & 1) + 2 * ((lane >> 3) & 1);

  // The walk, for one role (y_i or y_j) of a warp. Both roles meet the same
  // barriers: one per chunk column.
  auto walk = [&](auto role) {
    constexpr bool YI = decltype(role)::value;
    const int w = YI ? warp : warp - C::NW;
    int g = 0;
#pragma unroll 1
    for (int k = 0, item = blockIdx.x; item < items; ++k, item += gridDim.x) {
      const Square sq = square_of(item, b);
      const int bi = ii[sq.t];
      const int bj = jj[sq.t];
      const bool diag = bi == bj;
      const unsigned char* xj_s = xbuf + (k & 1) * 2 * PL * C::XS;   // + pl * XS
      const unsigned char* xi_s = xj_s + PL * C::XS;                 // + pl * XS

      // y_i: per sum (hi, lo), chunk row, 8-row group and M tile, rows g4
      // and g4 + 8 of the M tile at tile rows p, p + 1 (p = 2 t4 in the group)
      int acc_i[YI ? PL : 1][YI ? NCH : 1][C::RG][MT][4];
      if constexpr (YI) {
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
#pragma unroll
          for (int a = 0; a < NCH; ++a)
#pragma unroll
            for (int rg = 0; rg < C::RG; ++rg)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc_i[pl][a][rg][mt][e] = 0;
      }

#pragma unroll 1
      for (int c = 0; c < ncs; ++c, ++g) {
        // stage g landed, and at c == 0 this item's x (committed ncs stages
        // earlier; all that is in flight where a stream is shorter)
        if (c == 0 && ncs < C::STAGES - 1)
          cp_async_wait<0>();
        else
          cp_async_wait<C::STAGES - 2>();
        __syncthreads();  // for all threads; stage g - 1 and x of item k - 1 are free
        fetch(g + C::STAGES - 1);
        if (c == 0) fetch_item_x(k + 1);
        cp_async_commit();
        if (c >= sq.nc) continue;
        const unsigned char* st = ring + (g % C::STAGES) * PL * STAGE;   // + pl * STAGE

        if constexpr (YI) {
          // y_i += x_j Q^T: B[k = q][n = p] = Q[p][q]; x_j of chunk column c
          // in two k-steps of 32 columns, for all M tiles and planes
          uint32_t fxj[PL][MT][2][4];
#pragma unroll
          for (int pl = 0; pl < PL; ++pl)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int ks = 0; ks < 2; ++ks)
                ldsm_x4(smem_u32(xj_s + pl * C::XS + (mt * MTILE + xrow) * XLD + c * CH +
                                 ks * 32 + xk),
                        fxj[pl][mt][ks]);
#pragma unroll
          for (int a = 0; a < NCH; ++a) {
            if (a >= sq.na) continue;
#pragma unroll
            for (int rg = 0; rg < C::RG; ++rg) {
              const int r = 8 * (C::RG * w + rg) + (lane & 7);
              uint32_t bq[PL][4];
#pragma unroll
              for (int pl = 0; pl < PL; ++pl)   // chunk (a, c) of plane pl
                ldsm_x4(smem_u32(st + pl * STAGE + a * CH * CH + r * CH +
                                 (((lane >> 3) ^ swz(r)) << 4)),
                        bq[pl]);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma_s8(acc_i[0][a][rg][mt], fxj[0][mt][0], bq[0][0], bq[0][1]);
                mma_s8(acc_i[0][a][rg][mt], fxj[0][mt][1], bq[0][2], bq[0][3]);
                if constexpr (PL == 2) {   // lo += p1 Q2 + p2 Q1
                  mma_s8(acc_i[1][a][rg][mt], fxj[0][mt][0], bq[1][0], bq[1][1]);
                  mma_s8(acc_i[1][a][rg][mt], fxj[0][mt][1], bq[1][2], bq[1][3]);
                  mma_s8(acc_i[1][a][rg][mt], fxj[1][mt][0], bq[0][0], bq[0][1]);
                  mma_s8(acc_i[1][a][rg][mt], fxj[1][mt][1], bq[0][2], bq[0][3]);
                }
              }
            }
          }
        } else {
          if (diag) continue;
          // y_j += x_i Q: B[k = p][n = q] = Q[p][q], transposed in registers;
          // even columns in acc_j[.][.][0], odd in acc_j[.][.][1]
          const int seg = w & 3;
          const int mj0 = (w >> 2) * C::MJ;
          int acc_j[PL][C::MJ][2][4];
#pragma unroll
          for (int pl = 0; pl < PL; ++pl)
#pragma unroll
            for (int mj = 0; mj < C::MJ; ++mj)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc_j[pl][mj][0][e] = acc_j[pl][mj][1][e] = 0;
#pragma unroll
          for (int a = 0; a < NCH; ++a) {
            if (a >= sq.na) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = 32 * h + tr;
              // rows 4 t4 .. + 3 of column 2 g4 (ev, even) and 2 g4 + 1 (od)
              uint32_t ev[PL][2], od[PL][2];
#pragma unroll
              for (int pl = 0; pl < PL; ++pl) {   // chunk (a, c) of plane pl
                uint32_t bt[4];
                ldsm_x4_trans(smem_u32(st + pl * STAGE + a * CH * CH + p * CH +
                                       ((seg ^ swz(p)) << 4)),
                              bt);
                ev[pl][0] = __byte_perm(bt[0], bt[1], 0x6420);
                ev[pl][1] = __byte_perm(bt[2], bt[3], 0x6420);
                od[pl][0] = __byte_perm(bt[0], bt[1], 0x7531);
                od[pl][1] = __byte_perm(bt[2], bt[3], 0x7531);
              }
              uint32_t fxi[PL][C::MJ][4];
#pragma unroll
              for (int pl = 0; pl < PL; ++pl)
#pragma unroll
                for (int mj = 0; mj < C::MJ; ++mj)
                  ldsm_x4(smem_u32(xi_s + pl * C::XS + ((mj0 + mj) * MTILE + xrow) * XLD +
                                   a * CH + 32 * h + xk),
                          fxi[pl][mj]);
#pragma unroll
              for (int mj = 0; mj < C::MJ; ++mj) {
                mma_s8(acc_j[0][mj][0], fxi[0][mj], ev[0][0], ev[0][1]);
                mma_s8(acc_j[0][mj][1], fxi[0][mj], od[0][0], od[0][1]);
                if constexpr (PL == 2) {   // lo += p1 Q2 + p2 Q1
                  mma_s8(acc_j[1][mj][0], fxi[0][mj], ev[1][0], ev[1][1]);
                  mma_s8(acc_j[1][mj][1], fxi[0][mj], od[1][0], od[1][1]);
                  mma_s8(acc_j[1][mj][0], fxi[1][mj], ev[0][0], ev[0][1]);
                  mma_s8(acc_j[1][mj][1], fxi[1][mj], od[0][0], od[0][1]);
                }
              }
            }
          }
          // y_j of column c, from the registers: a lane holds rows g4 and
          // g4 + 8 of each M tile at the columns 4 t4 .. + 3 of its 16
          const int ql = 16 * seg + 4 * t4;
          const int qmax = sq.cols - c * CH;
          if (ql >= qmax) continue;
#pragma unroll
          for (int pl = 0; pl < PL; ++pl) {
#pragma unroll
            for (int mj = 0; mj < C::MJ; ++mj) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = mbase + (mj0 + mj) * MTILE + g4 + 8 * h;
                if (row >= m) continue;
                int* out = out_acc[pl] + size_t(row) * n + bj * b + sq.c0 + c * CH + ql;
                const int v0 = acc_j[pl][mj][0][2 * h], v1 = acc_j[pl][mj][1][2 * h];
                const int v2 = acc_j[pl][mj][0][2 * h + 1], v3 = acc_j[pl][mj][1][2 * h + 1];
                if (packed) {
                  red_pair(out, v0, v1);
                  if (ql + 2 < qmax) red_pair(out + 2, v2, v3);
                } else {
                  atomicAdd(out, v0);
                  if (ql + 1 < qmax) atomicAdd(out + 1, v1);
                  if (ql + 2 < qmax) atomicAdd(out + 2, v2);
                  if (ql + 3 < qmax) atomicAdd(out + 3, v3);
                }
              }
            }
          }
        }
      }

      // y_i of the square, from the registers
      if constexpr (YI) {
#pragma unroll
        for (int pl = 0; pl < PL; ++pl) {
#pragma unroll
          for (int a = 0; a < NCH; ++a) {
#pragma unroll
            for (int rg = 0; rg < C::RG; ++rg) {
              const int p = a * CH + 8 * (C::RG * w + rg) + 2 * t4;
              if (a >= sq.na || p >= sq.rows) continue;
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int row = mbase + mt * MTILE + g4 + 8 * h;
                  if (row >= m) continue;
                  int* out = out_acc[pl] + size_t(row) * n + bi * b + sq.r0 + p;
                  const int v0 = acc_i[pl][a][rg][mt][2 * h];
                  const int v1 = acc_i[pl][a][rg][mt][2 * h + 1];
                  if (packed) {
                    red_pair(out, v0, v1);
                  } else {
                    atomicAdd(out, v0);
                    if (p + 1 < sq.rows) atomicAdd(out + 1, v1);
                  }
                }
              }
            }
          }
        }
      }
    }
  };
  if (warp < C::NW)
    walk(std::integral_constant<bool, true>());
  else
    walk(std::integral_constant<bool, false>());
  cp_async_wait<0>();
}

// ------------------------------------ K4 at one M tile: the band walk
//
// A work item is a band: BAND rows of one tile across its whole width b
// (b <= 1024, a multiple of 16). It streams through a ring of BSTAGES
// stages of BROWS whole tile rows, loaded by TMA: each stage is up to 8
// boxes of BROWS rows x 128 bytes, one per 128-byte line of the rows, each
// stored [row][128 B] with the 128-byte swizzle (16-byte segment s of row p
// at s ^ (p & 7); the stage's lines 4 KB apart, 1024-byte aligned). One
// producer warp issues the loads; 8 consumer warps, warp w on line w (tile
// columns 128 w .. + 127), take each stage on a full mbarrier and give it
// back on an empty one: no block-wide barrier in the stream.
//
// Per stage, warp w forms
//   y_i (the stage's 32 rows) += x_j (its 128 columns) Q^T: x_j's fragments
//     stay in registers for the band; the partial over the warp's columns
//     is added into the band's y_i in shared memory (shared-memory adds;
//     eight warps, one line each, add into each sum);
//   y_j (its 128 columns) += x_i (the stage's 32 rows) Q, one k-step of 32,
//     with the register transpose (ldmatrix.trans + prmt) of the square
//     walk. The lanes' row addresses pair the stage's rows so that each
//     8x8 matrix of one ldmatrix.trans reads 8 rows of distinct p & 7, which
//     the swizzle makes conflict-free: of the four rows 4t .. 4t + 3 that
//     lane t gathers, matrix 0 holds 4t, 4t + 1 for t < 2 and 4t + 2,
//     4t + 3 for t >= 2 (matrix 1 the other two), and the lane's prmt
//     selector puts them back in row order.
// y_j stays in registers over the band (64 a thread). Both sums leave once
// per band, 256 + b a row of x where the square walk's four squares of the
// same rows flush 4 x 512 at b = 1024, as 32-bit reds of 32 neighbouring
// sums of one row a warp (y_j through an 8-row staging of the warp's own):
// on the H100 these cost the band walk about 0.6 ms a call at the
// benchmark's shape, where the square walk's pattern of 64-bit reds of
// column pairs, scattered over eight rows a warp, cost it 1.4 ms. With no
// 64-bit pair, the epilogue adds back no carry after a band-walk call.
constexpr int BAND = 256;                 // rows of a band (symm_int8.py BAND_INT8)
constexpr int BROWS = 32;                 // tile rows per stage: one k-step of y_j
constexpr int BLINE = 128;                // bytes of a line: a warp's columns
constexpr int BLINES = 8;                 // lines of a stage, at most: b <= 1024
constexpr int BSTAGE = BROWS * BLINE * BLINES;   // 32 KB
constexpr int BSTAGES = 3;
constexpr int BCONS = 8;                  // consumer warps
constexpr int BTHREADS = 32 * (BCONS + 1);
constexpr int XJLD = BLINE * BLINES + 16; // staged x_j row stride, bytes
constexpr int XILD = BAND + 16;           // staged x_i row stride, bytes
constexpr int XJS = MTILE * XJLD;
constexpr int XIS = MTILE * XILD;
constexpr int YILD = 20;                  // int32 per band row of y_i: 16 rows of x + 4
constexpr int YIS = BAND * YILD * 4;      // bytes of one y_i buffer
constexpr int YJLD = BLINE + 16;          // int32 per staged row of y_j (conflict-free int4 stores)
constexpr int YJS = 8 * YJLD * 4;         // bytes of a warp's y_j staging: 8 rows of x
constexpr size_t BSMEM = size_t(BSTAGES) * BSTAGE + 2 * (XJS + XIS) + 2 * YIS + BCONS * YJS +
                         8 * (2 * BSTAGES + 4) + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// box (BLINE bytes, BROWS rows) of the tile-row matrix at (col, row) into
// shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int col,
                                            int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// acc (m, n) += both contributions of the bands blockIdx.x, blockIdx.x +
// gridDim.x, ... of the tiles, for m <= 16 rows of x. ``tiles``: the
// tensor map of q as (n_pairs b) rows of b bytes, boxes of (BLINE, BROWS).
__global__ void __launch_bounds__(BTHREADS, 1)
symm_int8_band_kernel(const __grid_constant__ CUtensorMap tiles, const int8_t* __restrict__ x,
                      const int* __restrict__ ii, const int* __restrict__ jj,
                      int* __restrict__ acc, int m, int n, int b, int bands) {
  extern __shared__ __align__(1024) unsigned char smem_band[];
  // the 128-byte swizzle's phase is read from address bits 7-9: the ring
  // starts on a 1024-byte boundary (BSMEM holds 1 KB to spare for it)
  unsigned char* ring = smem_band + ((1024 - (smem_u32(smem_band) & 1023)) & 1023);
  unsigned char* xbuf = ring + BSTAGES * BSTAGE;       // [k & 1][x_j, x_i]
  int* yib = reinterpret_cast<int*>(xbuf + 2 * (XJS + XIS));   // [k & 1][p][YILD]
  int* yjs = yib + 2 * BAND * YILD;                          // [warp][8][YJLD]
  const uint32_t bars = smem_u32(yjs) + BCONS * YJS;
  // full[s], empty[s], xfull[2], xempty[2]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (BSTAGES + s); };
  auto xfull = [&](int u) { return bars + 8 * (2 * BSTAGES + u); };
  auto xempty = [&](int u) { return bars + 8 * (2 * BSTAGES + 2 + u); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bpt = (b + BAND - 1) / BAND;   // bands per tile
  const int lines = (b + BLINE - 1) / BLINE;
  const int mrows = min(m, MTILE);

  for (int e = tid; e < 2 * BAND * YILD; e += BTHREADS) yib[e] = 0;
  if (tid == 0) {
    for (int s = 0; s < BSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), BCONS);
    }
    for (int u = 0; u < 2; ++u) {
      mbar_init(xfull(u), 1);
      mbar_init(xempty(u), BCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == BCONS) {
    // the producer: x of each band, then its stages, from one lane
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
#pragma unroll 1
      for (int k = 0, band = blockIdx.x; band < bands; ++k, band += gridDim.x) {
        const int t = band / bpt;
        const int r0 = (band - t * bpt) * BAND;
        const int rows = min(BAND, b - r0);
        const int bi = ii[t], bj = jj[t];
        const int u = k & 1;
        mbar_wait(xempty(u), ((k >> 1) & 1) ^ 1);
        unsigned char* xs = xbuf + u * (XJS + XIS);
        mbar_expect(xfull(u), mrows * (b + (bi != bj ? rows : 0)));
        for (int mm = 0; mm < mrows; ++mm) {
          bulk_load(smem_u32(xs + mm * XJLD), x + size_t(mm) * n + size_t(bj) * b, b, xfull(u));
          if (bi != bj)
            bulk_load(smem_u32(xs + XJS + mm * XILD), x + size_t(mm) * n + size_t(bi) * b + r0,
                      rows, xfull(u));
        }
        const int row0 = t * b + r0;
#pragma unroll 1
        for (int s = 0; s < rows; s += BROWS) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect(full(stage), lines * BROWS * BLINE);
          for (int l = 0; l < lines; ++l)
            tma_load_2d(smem_u32(ring + stage * BSTAGE + l * BROWS * BLINE), &tiles, l * BLINE,
                        row0 + s, full(stage));
          if (++stage == BSTAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warp w on line w
  const int w = warp;
  const bool active = w * BLINE < b;
  const int g4 = lane >> 2;
  const int t4 = lane & 3;
  const int xrow = lane & 15;
  const int xk = (lane >> 4) * 16;
  // ldmatrix.trans row of this lane (see the note above): matrix j = lane >> 3
  // (j >> 1: rows 16 and up; j & 1: the second pair of a lane's four rows),
  // stored row i = lane & 7 (i >> 1: the receiving lane's t, i & 1: which
  // of its pair)
  const int ti = (lane & 7) >> 1;
  const int tr = 16 * (lane >> 4) + 4 * ti + (lane & 1) + 2 * (((lane >> 3) & 1) ^ (ti >> 1));
  const uint32_t sel_even = t4 < 2 ? 0x6420u : 0x2064u;
  const uint32_t sel_odd = t4 < 2 ? 0x7531u : 0x3175u;
  int stage = 0;
  uint32_t phase = 0;

#pragma unroll 1
  for (int k = 0, band = blockIdx.x; band < bands; ++k, band += gridDim.x) {
    const int t = band / bpt;
    const int r0 = (band - t * bpt) * BAND;
    const int rows = min(BAND, b - r0);
    const int bi = ii[t], bj = jj[t];
    const bool diag = bi == bj;
    const int u = k & 1;
    const unsigned char* xj_s = xbuf + u * (XJS + XIS);
    const unsigned char* xi_s = xj_s + XJS;
    int* yi = yib + u * BAND * YILD;

    mbar_wait(xfull(u), (k >> 1) & 1);
    uint32_t fxj[4][4];   // x_j over the warp's line: four k-steps of 32
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(smem_u32(xj_s + xrow * XJLD + w * BLINE + ks * 32 + xk), fxj[ks]);
    int acc_j[8][2][4];   // y_j: per 16-column segment, even and odd columns
#pragma unroll
    for (int sg = 0; sg < 8; ++sg)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_j[sg][0][e] = acc_j[sg][1][e] = 0;

#pragma unroll 1
    for (int s = 0; s < rows; s += BROWS) {
      mbar_wait(full(stage), phase);
      const unsigned char* st = ring + stage * BSTAGE + w * BROWS * BLINE;
      int part[4][4];   // y_i of the stage's rows over this warp's columns
      if (active) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nt][e] = 0;
          const int p = 8 * nt + (lane & 7);
          uint32_t bq[2][4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            ldsm_x4(smem_u32(st + p * BLINE + (((4 * hf + (lane >> 3)) ^ (p & 7)) << 4)),
                    bq[hf]);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            mma_s8(part[nt], fxj[2 * hf], bq[hf][0], bq[hf][1]);
            mma_s8(part[nt], fxj[2 * hf + 1], bq[hf][2], bq[hf][3]);
          }
        }
        if (!diag) {
          uint32_t fxi[4];
          ldsm_x4(smem_u32(xi_s + xrow * XILD + s + xk), fxi);
          if (s + 16 >= rows) fxi[2] = fxi[3] = 0u;   // rows past the band: another tile's
#pragma unroll
          for (int sg = 0; sg < 8; ++sg) {
            uint32_t bt[4];
            ldsm_x4_trans(smem_u32(st + tr * BLINE + ((sg ^ (tr & 7)) << 4)), bt);
            mma_s8(acc_j[sg][0], fxi, __byte_perm(bt[0], bt[1], sel_even),
                   __byte_perm(bt[2], bt[3], sel_even));
            mma_s8(acc_j[sg][1], fxi, __byte_perm(bt[0], bt[1], sel_odd),
                   __byte_perm(bt[2], bt[3], sel_odd));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
      if (active) {
        // a lane holds rows g4, g4 + 8 of x at the stage rows 8 nt + 2 t4, + 1
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          int* y = yi + (s + 8 * nt + 2 * t4) * YILD + g4;
          atomicAdd(y, part[nt][0]);
          atomicAdd(y + YILD, part[nt][1]);
          atomicAdd(y + 8, part[nt][2]);
          atomicAdd(y + YILD + 8, part[nt][3]);
        }
      }
      if (++stage == BSTAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(xempty(u));

    // y_j of the band, from the registers through the warp's staging, 8
    // rows of x at a time: lane (g4, t4) holds rows g4 and g4 + 8 at the
    // columns 4 t4 .. + 3 of each 16-column segment; the reds go out a row
    // at a time, 32 neighbouring sums a warp-wide red
    if (active && !diag) {
      int* stg = yjs + w * 8 * YJLD;
      const int ncol = min(BLINE, b - w * BLINE);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __syncwarp();
#pragma unroll
        for (int sg = 0; sg < 8; ++sg)
          *reinterpret_cast<int4*>(stg + g4 * YJLD + 16 * sg + 4 * t4) =
              make_int4(acc_j[sg][0][2 * h], acc_j[sg][1][2 * h], acc_j[sg][0][2 * h + 1],
                        acc_j[sg][1][2 * h + 1]);
        __syncwarp();
        for (int r = 0; r < 8 && 8 * h + r < mrows; ++r) {
          int* out = acc + size_t(8 * h + r) * n + size_t(bj) * b + w * BLINE;
#pragma unroll
          for (int c = lane; c < BLINE; c += 32)
            if (c < ncol) atomicAdd(out + c, stg[r * YJLD + c]);
        }
      }
    }
    // y_i of the band, once all eight warps have added into it; then zero
    // it for the band after next
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * BCONS) : "memory");
    for (int e = tid; e < MTILE * BAND; e += 32 * BCONS) {
      const int row = e / BAND;
      const int p = e - row * BAND;
      int* y = yi + p * YILD + row;
      if (row < mrows && p < rows) atomicAdd(acc + size_t(row) * n + size_t(bi) * b + r0 + p, *y);
      *y = 0;
    }
  }
}

// ------------------------------------ K4 at four M tiles: the strip walk
//
// A work item is a strip: all b rows of one tile across STRIP of its
// columns (b <= 1024, a multiple of 16), for up to 64 rows of x.
// Persistent blocks, one an SM, walk the strips blockIdx.x + k gridDim.x.
// A block streams its strip through a ring of SSTAGES stages of SROWS
// whole strip rows, each up to four TMA boxes of SROWS rows x 128 bytes
// (one per 128-byte line of the strip, the 128-byte swizzle, 1024-byte
// aligned) and, off the diagonal, the stage's x_i: a box of 64 rows of x x
// SROWS bytes (the 64-byte swizzle). x_j of the strip (64 rows of x x
// STRIP bytes, boxes like the tile's) comes by TMA into one of two
// buffers. One producer warp issues the loads; two consumer warpgroups
// take each stage on a full mbarrier and give it back on an empty one (no
// block-wide barrier in the stream). The producer's warpgroup hands its
// registers to the consumers (setmaxnreg): ptxas sizes a block's
// registers by whole warpgroups, so at 288 threads it capped them at 168
// a thread, spilling the consumers' 128 of y_j and serializing their wgmma.
//
// Both products are warpgroup products (wgmma m64nNk32 .s32.s8.s8), B read
// from shared memory by a descriptor (K-major: int8 wgmma cannot
// transpose an operand it reads from shared memory). Every wgmma is
// issued on one path, with zero operands where a product must add
// nothing: ptxas serializes wgmma under a branch.
//   y_i (64 rows of x x the stage's rows) += x_j Q^T: A = x_j (M = rows of
//     x, K = strip columns), read from shared memory as it landed (past
//     the strip's columns, from a block of zeros); B = the staged tile
//     rows. Warpgroup g takes the stage's rows 32 g .. + 31 (N = 32) over
//     all the strip's columns; the sum is flushed after its stage;
//   y_j^T (the strip's columns x 64 rows of x) += Q^T x_i^T: A = Q^T (M =
//     strip columns, K = the stage's rows), built in registers with the
//     band walk's ldmatrix.trans + prmt; its m16n8k32 fragments are the
//     layout of a warp's slice of a register-sourced wgmma A, the even
//     columns of a 16-column segment on the fragment's rows g, the odd
//     ones on g + 8; B = x_i. Warpgroup g takes lines 2 g and 2 g + 1 (four
//     M blocks of 64 columns, warp w the columns 32 w .. + 31 of each
//     line): 128 registers a thread, kept for the whole strip and flushed
//     once.
// The flushes are 32-bit reds of 32 neighbouring sums of one row of x a
// warp-wide red, staged through the warp's own shared memory: per row of x
// and tile, b sums of y_i a strip and, off the diagonal, b of y_j
// (symm_int8.int8_flush_atomics); no 64-bit pair, so the epilogue adds
// back no carry. Rows of x past m read zeros from TMA and are not
// flushed; tile rows past b (another tile's, in a stage that overhangs the
// tile) are cut from y_j by zeroing their fragment half, and not flushed
// from y_i; columns past b read zeros from the tile's tensor map.
//
// What bounds it (H100, the PPCG cell, 64 x 131072, 5.13 ms against 2.60
// of bytes): the L2, which takes the tile stream and the reds together.
// The stream alone takes 2.90 ms; the reds of y_i add 0.9, those of y_j
// 0.6, the products 0.7 (copies of this source without each part). Strips
// of 256 columns (4 b sums of y_i a tile; 64 registers of y_j, x_j's A in
// registers) took 6.0 ms, 1.8 of them y_i's reds, whichever way they left
// (warp-wide reds or TMA bulk reductions, cp.reduce.async.bulk) and
// whether or not the strips of a tile added into the same rows at once.
// Adding a tile's strips in a cluster through distributed shared memory
// before one red took longer than the reds it saved (12 to 25 ms: the
// remote stores, loads and mbarriers of every stage). The wider strip
// halves y_i's sums.
constexpr int STRIP = 512;                  // tile columns of a strip (symm_int8.py STRIP_INT8)
constexpr int SROWS = 64;                   // tile rows per stage: two k-steps of y_j
constexpr int SLINES = STRIP / BLINE;       // 128-byte lines of a strip row
constexpr int SXROWS = 4 * MTILE;           // rows of x: four M tiles
constexpr int SBOX = SROWS * BLINE;         // one line of a stage's rows
constexpr int SXI = SXROWS * SROWS;         // x_i of a stage's rows
constexpr int SSTAGE = SLINES * SBOX + SXI; // 36 KB
constexpr int SSTAGES = 3;
constexpr int SXJ = SXROWS * STRIP;         // x_j of a strip
constexpr int SCONS = 8;                    // consumer warps: two warpgroups
constexpr int STHREADS = 32 * (SCONS + 4);  // and a producer warpgroup
constexpr int SREGS_PRODUCER = 40;          // registers a thread after setmaxnreg
constexpr int SREGS_CONSUMER = 232;         // 128 x 40 + 256 x 232 <= 65536
constexpr int SYJLD = 32 + 4;               // int32 per staged row of y_j (conflict-free int2 stores)
constexpr int SYILD = 32 + 8;               // int32 per staged row of y_i
constexpr int SSTG = 32 * SYJLD * 4;        // bytes of a warp's staging: 32 rows of y_j, or 16 of y_i
constexpr int SZERO = SXROWS * BLINE;       // zeros: x_j's A past the strip's columns
constexpr size_t SSMEM = size_t(SSTAGES) * SSTAGE + 2 * SXJ + SZERO + SCONS * SSTG +
                         8 * (2 * SSTAGES + 4) + 1024;
static_assert(SSTAGE % 1024 == 0 && SXJ % 1024 == 0, "swizzled boxes stay 1024-byte aligned");
static_assert(16 * SYILD <= 32 * SYJLD, "a warp's staging holds its y_i");

// wgmma operand descriptor of a K-major operand in shared memory: start
// address, stride between 8-row groups (sbo bytes), swizzle (1: 128-byte,
// 2: 64-byte); the leading offset is unused by swizzled K-major layouts
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int sbo, uint64_t swizzle) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(sbo >> 4) << 32) |
         (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory, before the async proxy (wgmma) reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving a register's uses across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, s32) (+)= a (64 x 32, s8, registers) . b (32 x 64, s8, K-major
// in shared memory); accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64(int (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (64 x 32, s32) (+)= a (64 x 32, s8, K-major in shared memory) . b (32 x
// 32, s8, K-major)
__device__ __forceinline__ void wgmma_m64n32_ss(int (&d)[16], uint64_t adesc, uint64_t bdesc,
                                                int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

// acc (m, n) += both contributions of the strips blockIdx.x, blockIdx.x +
// gridDim.x, ... of the tiles, for m <= 64 rows of x. ``tiles``: q as
// (n_pairs b) rows of b bytes, boxes of (BLINE, SROWS), 128-byte swizzle;
// ``xj_map``, ``xi_map``: x as m rows of n bytes, boxes of (BLINE, 64)
// with the 128-byte swizzle and of (SROWS, 64) with the 64-byte one.
__global__ void __launch_bounds__(STHREADS, 1)
symm_int8_strip_kernel(const __grid_constant__ CUtensorMap tiles,
                       const __grid_constant__ CUtensorMap xj_map,
                       const __grid_constant__ CUtensorMap xi_map, const int* __restrict__ ii,
                       const int* __restrict__ jj, int* __restrict__ acc, int m, int n, int b,
                       int strips) {
  extern __shared__ __align__(1024) unsigned char smem_strip[];
  unsigned char* ring = smem_strip + ((1024 - (smem_u32(smem_strip) & 1023)) & 1023);
  unsigned char* xjb = ring + SSTAGES * SSTAGE;                  // [k & 1]
  unsigned char* zero = xjb + 2 * SXJ;
  int* stg_all = reinterpret_cast<int*>(zero + SZERO);           // [warp][SSTG / 4]
  const uint32_t bars = smem_u32(stg_all) + SCONS * SSTG;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (SSTAGES + s); };
  auto xfull = [&](int u) { return bars + 8 * (2 * SSTAGES + u); };
  auto xempty = [&](int u) { return bars + 8 * (2 * SSTAGES + 2 + u); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int spt = (b + STRIP - 1) / STRIP;   // strips per tile

  for (int e = tid; e < SZERO / 16; e += STHREADS)
    reinterpret_cast<int4*>(zero)[e] = make_int4(0, 0, 0, 0);
  fence_proxy_async();   // the zeros, for wgmma's reads
  if (tid == 0) {
    for (int s = 0; s < SSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), SCONS);
    }
    for (int u = 0; u < 2; ++u) {
      mbar_init(xfull(u), 1);
      mbar_init(xempty(u), SCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= SCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SREGS_PRODUCER));
    // the producer: x_j of each strip, then its stages (the tile rows and,
    // off the diagonal, x_i), from one lane
    if (warp == SCONS && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
#pragma unroll 1
      for (int k = 0, item = blockIdx.x; item < strips; ++k, item += gridDim.x) {
        const int t = item / spt;
        const int c0 = (item - t * spt) * STRIP;
        const int lines = min(SLINES, (b - c0 + BLINE - 1) / BLINE);
        const int bi = ii[t], bj = jj[t];
        const int u = k & 1;
        mbar_wait(xempty(u), ((k >> 1) & 1) ^ 1);
        mbar_expect(xfull(u), lines * SXROWS * BLINE);
        for (int l = 0; l < lines; ++l)
          tma_load_2d(smem_u32(xjb + u * SXJ + l * SXROWS * BLINE), &xj_map,
                      bj * b + c0 + l * BLINE, 0, xfull(u));
#pragma unroll 1
        for (int p0 = 0; p0 < b; p0 += SROWS) {
          mbar_wait(empty(stage), phase ^ 1);
          unsigned char* st = ring + stage * SSTAGE;
          mbar_expect(full(stage), lines * SBOX + (bi != bj ? SXI : 0));
          for (int l = 0; l < lines; ++l)
            tma_load_2d(smem_u32(st + l * SBOX), &tiles, c0 + l * BLINE, t * b + p0, full(stage));
          if (bi != bj)
            tma_load_2d(smem_u32(st + SLINES * SBOX), &xi_map, bi * b + p0, 0, full(stage));
          if (++stage == SSTAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g (lines 2 g, 2 g + 1 of y_j, the stage rows
  // 32 g .. of y_i), warp w in it (rows 16 w .. of x in y_i, columns 32 w ..
  // of each of its lines in y_j)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(SREGS_CONSUMER));
  const int g = warp >> 2;
  const int w = warp & 3;
  const int g4 = lane >> 2;
  const int t4 = lane & 3;
  // the band walk's ldmatrix.trans rows and prmt selectors (see its note)
  const int ti = (lane & 7) >> 1;
  const int tr = 16 * (lane >> 4) + 4 * ti + (lane & 1) + 2 * (((lane >> 3) & 1) ^ (ti >> 1));
  const uint32_t sel_even = t4 < 2 ? 0x6420u : 0x2064u;
  const uint32_t sel_odd = t4 < 2 ? 0x7531u : 0x3175u;
  int* stg = stg_all + warp * (SSTG / 4);
  int stage = 0;
  uint32_t phase = 0;

#pragma unroll 1
  for (int k = 0, item = blockIdx.x; item < strips; ++k, item += gridDim.x) {
    const int t = item / spt;
    const int c0 = (item - t * spt) * STRIP;
    const int ncols = min(STRIP, b - c0);
    const int bi = ii[t], bj = jj[t];
    const int u = k & 1;
    const uint32_t xj_s = smem_u32(xjb + u * SXJ);
    mbar_wait(xfull(u), (k >> 1) & 1);

    int yj[4][32];   // y_j^T of the warpgroup's four M blocks: line 2 g + (mb >> 1)
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int e = 0; e < 32; ++e) yj[mb][e] = 0;

#pragma unroll 1
    for (int p0 = 0; p0 < b; p0 += SROWS) {
      mbar_wait(full(stage), phase);
      const unsigned char* st = ring + stage * SSTAGE;
      const int prow = b - p0;   // the stage's rows of this tile, if fewer than SROWS
      // Q^T's A fragments, per k-step of 32 rows and M block (line 2 g +
      // (mb >> 1)): columns 32 w + 16 (mb & 1) + 2 g4 of the line (rows g4
      // of the fragment) and + 1 (rows g4 + 8); zero where y_j takes
      // nothing (a diagonal tile, columns past b, rows of another tile)
      uint32_t qa[2][4][4];
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        const int line = 2 * g + (mb >> 1);
        const bool on = bi != bj && line * BLINE + 32 * w + 16 * (mb & 1) < ncols;
        const int sg = 2 * w + (mb & 1);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const bool lo = on && 32 * ks < prow;
          const bool hi = on && 32 * ks + 16 < prow;
          uint32_t bt[4];
          ldsm_x4_trans(
              smem_u32(st + line * SBOX + (32 * ks + tr) * BLINE + ((sg ^ (tr & 7)) << 4)), bt);
          qa[ks][mb][0] = lo ? __byte_perm(bt[0], bt[1], sel_even) : 0u;
          qa[ks][mb][1] = lo ? __byte_perm(bt[0], bt[1], sel_odd) : 0u;
          qa[ks][mb][2] = hi ? __byte_perm(bt[2], bt[3], sel_even) : 0u;
          qa[ks][mb][3] = hi ? __byte_perm(bt[2], bt[3], sel_odd) : 0u;
        }
      }
      int yi[16];
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) fence_regs(yj[mb]);
      wgmma_fence();
      const uint32_t xi_s = smem_u32(st + SLINES * SBOX);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int mb = 0; mb < 4; ++mb)
          wgmma_m64n64(yj[mb], qa[ks][mb], wgmma_desc(xi_s + 32 * ks, 8 * SROWS, 2), 1);
#pragma unroll
      for (int kk = 0; kk < 4 * SLINES; ++kk)
        wgmma_m64n32_ss(
            yi,
            wgmma_desc((32 * kk < ncols ? xj_s + (kk >> 2) * SXROWS * BLINE : smem_u32(zero)) +
                           32 * (kk & 3),
                       8 * BLINE, 1),
            wgmma_desc(smem_u32(st + (kk >> 2) * SBOX + 32 * g * BLINE) + 32 * (kk & 3),
                       8 * BLINE, 1),
            kk > 0);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) fence_regs(yj[mb]);
      fence_regs(yi);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
      if (++stage == SSTAGES) {
        stage = 0;
        phase ^= 1;
      }

      // y_i of the stage through the warp's staging: lane (g4, t4) holds
      // rows 16 w + g4 (+ 8) of x at the stage rows 32 g + 8 j + 2 t4 (+ 1)
      if (32 * g < prow) {
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<int2*>(stg + g4 * SYILD + 8 * j + 2 * t4) =
              make_int2(yi[4 * j], yi[4 * j + 1]);
          *reinterpret_cast<int2*>(stg + (g4 + 8) * SYILD + 8 * j + 2 * t4) =
              make_int2(yi[4 * j + 2], yi[4 * j + 3]);
        }
        __syncwarp();
        const int p = p0 + 32 * g + lane;
        if (p < b) {
          int* out = acc + size_t(bi) * b + p;
          for (int r = 0; r < MTILE && 16 * w + r < m; ++r)
            atomicAdd(out + size_t(16 * w + r) * n, stg[r * SYILD + lane]);
        }
      }
    }
    // x_j read by the strip's last product: its buffer is free
    __syncwarp();
    if (lane == 0) mbar_arrive(xempty(u));

    // y_j of the strip through the warp's staging, 32 rows of x at a time:
    // lane (g4, t4) holds the columns 32 w + 16 (mb & 1) + 2 g4 (+ 1) of
    // line 2 g + (mb >> 1) at the rows 8 j + 2 t4 (+ 1) of x
    if (bi != bj) {
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const int col = c0 + (2 * g + l) * BLINE + 32 * w + lane;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __syncwarp();
#pragma unroll
          for (int jq = 0; jq < 4; ++jq) {
            const int j = 4 * h + jq;
#pragma unroll
            for (int mh = 0; mh < 2; ++mh) {
              const int mb = 2 * l + mh;
              *reinterpret_cast<int2*>(stg + (8 * jq + 2 * t4) * SYJLD + 16 * mh + 2 * g4) =
                  make_int2(yj[mb][4 * j], yj[mb][4 * j + 2]);
              *reinterpret_cast<int2*>(stg + (8 * jq + 2 * t4 + 1) * SYJLD + 16 * mh + 2 * g4) =
                  make_int2(yj[mb][4 * j + 1], yj[mb][4 * j + 3]);
            }
          }
          __syncwarp();
          if (col < c0 + ncols) {
            int* out = acc + size_t(bj) * b + col;
            for (int r = 0; r < 32 && 32 * h + r < m; ++r)
              atomicAdd(out + size_t(32 * h + r) * n, stg[r * SYJLD + lane]);
          }
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
                                   float* __restrict__ y, int m, int n, bool packed) {
  const size_t total = size_t(m) * n;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const int row = int(i / n);
    const int col = int(i % n);
    const bool carry = packed && (col & 1);   // the packed column pairs' carry
    int v = acc0[i];
    if (carry) v += acc0[i - 1] < 0;
    float a = __int2float_rn(v);
    if constexpr (SPLIT) {
      int lo = acc1[i];
      if (carry) lo += acc1[i - 1] < 0;
      a = __fadd_rn(a, __fmul_rn(__int2float_rn(lo), float(1.0 / 254.0)));
    }
    y[i] = __fadd_rn(__fmul_rn(__fmul_rn(a, sx[row]), gq[col]), __fmul_rn(xf[i], d[col]));
  }
}

// ------------------------------------------------------------------ launch

int launch_epilogue(bool split, bool packed, const int* acc0, const int* acc1,
                    const float* xf, const float* sx, const float* gq, const float* d,
                    float* y, int m, int n, cudaStream_t stream) {
  const size_t total = size_t(m) * n;
  const int block = 256;
  const size_t blocks = (total + block - 1) / block;
  const int grid = int(blocks < 65536 ? blocks : 65536);   // grid-stride beyond
  if (split)
    symm_int8_epilogue<true><<<grid, block, 0, stream>>>(acc0, acc1, xf, sx, gq, d, y, m, n,
                                                         packed);
  else
    symm_int8_epilogue<false><<<grid, block, 0, stream>>>(acc0, acc1, xf, sx, gq, d, y, m, n,
                                                          packed);
  return int(cudaGetLastError());
}

int alignment(const void* p, int b) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return (b % 16 == 0 && a % 16 == 0) ? 16 : (b % 4 == 0 && a % 4 == 0) ? 4 : 1;
}

template <int MT, int PL>
int launch_mma(const int8_t* x, const int8_t* x2, const int8_t* q, const int8_t* q2,
               const int* ii, const int* jj, int* acc, int* acc2, int m, int n, int b,
               int items, cudaStream_t stream) {
  using C = Cfg<MT, PL>;
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      symm_int8_mma_kernel<MT, PL>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (err != cudaSuccess) return int(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, symm_int8_mma_kernel<MT, PL>, C::THREADS, C::SMEM)) != cudaSuccess)
    return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  // persistent blocks: each walks the squares blockIdx.x + k * gridDim.x
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  const int passes = (m + C::ROWS - 1) / C::ROWS;
  // the copies both planes take (both tensors of a pair alike)
  const int vec = PL == 1 ? alignment(q, b) : min(alignment(q, b), alignment(q2, b));
  const int xvec = PL == 1 ? alignment(x, b) : min(alignment(x, b), alignment(x2, b));
  symm_int8_mma_kernel<MT, PL><<<dim3(grid, passes), C::THREADS, C::SMEM, stream>>>(
      x, x2, q, q2, ii, jj, acc, acc2, m, n, b, items, vec, xvec);
  return int(cudaGetLastError());
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int launch_band(const int8_t* x, const int8_t* q, const int* ii, const int* jj, int* acc,
                int m, int n, int b, int n_pairs, cudaStream_t stream) {
  if (m > MTILE || b > BLINE * BLINES || alignment(q, b) != 16 || alignment(x, b) != 16)
    return int(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  // the tiles as (n_pairs b) rows of b bytes; a box is BROWS rows of one
  // 128-byte line, swizzled; columns past b read as zeros
  CUtensorMap tiles;
  const cuuint64_t dims[2] = {cuuint64_t(b), cuuint64_t(n_pairs) * cuuint64_t(b)};
  const cuuint64_t strides[1] = {cuuint64_t(b)};
  const cuuint32_t box[2] = {BLINE, BROWS};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&tiles, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(q), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      symm_int8_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(BSMEM));
  if (err != cudaSuccess) return int(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return int(err);
  const int bands = n_pairs * ((b + BAND - 1) / BAND);
  // persistent blocks, one an SM: each walks the bands blockIdx.x + k * gridDim.x
  symm_int8_band_kernel<<<bands < sms ? bands : sms, BTHREADS, BSMEM, stream>>>(
      tiles, x, ii, jj, acc, m, n, b, bands);
  return int(cudaGetLastError());
}

// an int8 matrix of rows x cols (a multiple of 16 bytes a row) as a tensor
// map of (box_cols, box_rows) boxes; elements outside it read as zeros
bool encode_int8_2d(EncodeTiled encode, CUtensorMap* map, const int8_t* base, uint64_t cols,
                    uint64_t rows, uint32_t box_cols, uint32_t box_rows,
                    CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int launch_strip(const int8_t* x, const int8_t* q, const int* ii, const int* jj, int* acc,
                 int m, int n, int b, int n_pairs, cudaStream_t stream) {
  if (m > SXROWS || b % 16 != 0 || alignment(q, b) != 16 || alignment(x, b) != 16)
    return int(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tiles, xj_map, xi_map;
  if (!encode_int8_2d(encode, &tiles, q, b, uint64_t(n_pairs) * b, BLINE, SROWS,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_int8_2d(encode, &xj_map, x, n, m, BLINE, SXROWS, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_int8_2d(encode, &xi_map, x, n, m, SROWS, SXROWS, CU_TENSOR_MAP_SWIZZLE_64B))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      symm_int8_strip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SSMEM));
  if (err != cudaSuccess) return int(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return int(err);
  const int strips = n_pairs * ((b + STRIP - 1) / STRIP);
  // persistent blocks, one an SM: each walks the strips blockIdx.x + k * gridDim.x
  symm_int8_strip_kernel<<<strips < sms ? strips : sms, STHREADS, SSMEM, stream>>>(
      tiles, xj_map, xi_map, ii, jj, acc, m, n, b, strips);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The band height of K4's band walk (symm_int8.py BAND_INT8).
int symm_int8_band_rows() { return BAND; }

// The strip width of K4's strip walk (symm_int8.py STRIP_INT8).
int symm_int8_strip_cols() { return STRIP; }

// The square edge of K4's and K5's work items (symm_int8.py SQUARE_INT8).
int symm_int8_square_edge() { return SQ; }

// K4. qx (m, n) int8; q (n_pairs, b, b) int8, 16-byte aligned; xf (m, n)
// f32; sx (m,) f32; gq, d (n,) f32; acc (m, n) int32 zeroed by the caller;
// y (m, n) f32. walk 1: the band walk (m <= 16, b <= 1024, b and both
// int8 operands 16-byte aligned; symm_int8.py int8_walk chooses); walk 2:
// the strip walk (m <= 64, b a multiple of 16, both int8 operands 16-byte
// aligned); walk 0: the square walk, M tiles per block 1 for m <= 16, 2
// for m <= 32, else 4.
int symm_int8(const int8_t* qx, const int8_t* q, const int* ii, const int* jj,
              const float* xf, const float* sx, const float* gq, const float* d,
              int* acc, float* y, int m, int n, int b, int n_pairs, int walk,
              cudaStream_t stream) {
  const long long nsq = (b + SQ - 1) / SQ;
  const long long items = n_pairs * nsq * nsq;
  if (m <= 0 || n <= 0 || b <= 0 || n_pairs <= 0 || n % b != 0 || items > 0x7fffffff ||
      (m + MTILE - 1) / MTILE > 65535 || walk < 0 || walk > 2)
    return int(cudaErrorInvalidValue);
  const int it = int(items);
  int err = walk == 1   ? launch_band(qx, q, ii, jj, acc, m, n, b, n_pairs, stream)
            : walk == 2 ? launch_strip(qx, q, ii, jj, acc, m, n, b, n_pairs, stream)
            : m <= MTILE
                ? launch_mma<1, 1>(qx, qx, q, q, ii, jj, acc, acc, m, n, b, it, stream)
            : m <= 2 * MTILE
                ? launch_mma<2, 1>(qx, qx, q, q, ii, jj, acc, acc, m, n, b, it, stream)
                : launch_mma<4, 1>(qx, qx, q, q, ii, jj, acc, acc, m, n, b, it, stream);
  if (err != 0) return err;
  // the band and strip walks add 32-bit sums: no 64-bit pairs' carry to add back
  return launch_epilogue(false, b % 2 == 0 && walk == 0, acc, acc, xf, sx, gq, d, y, m, n,
                         stream);
}

// K5. p1, p2 (m, n) int8; q1, q2 (n_pairs, b, b) int8; acc1 (hi) and acc2
// (lo) (m, n) int32 zeroed by the caller; the rest as K4. One M tile per
// block at every m (passes of 16 rows of x; see Cfg).
int symm_int8_split(const int8_t* p1, const int8_t* p2, const int8_t* q1,
                    const int8_t* q2, const int* ii, const int* jj,
                    const float* xf, const float* sx, const float* gq,
                    const float* d, int* acc1, int* acc2, float* y, int m,
                    int n, int b, int n_pairs, cudaStream_t stream) {
  const long long nsq = (b + SQ - 1) / SQ;
  const long long items = n_pairs * nsq * nsq;
  if (m <= 0 || n <= 0 || b <= 0 || n_pairs <= 0 || n % b != 0 || items > 0x7fffffff ||
      (m + MTILE - 1) / MTILE > 65535)
    return int(cudaErrorInvalidValue);
  const int err =
      launch_mma<1, 2>(p1, p2, q1, q2, ii, jj, acc1, acc2, m, n, b, int(items), stream);
  if (err != 0) return err;
  return launch_epilogue(true, b % 2 == 0, acc1, acc2, xf, sx, gq, d, y, m, n, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
