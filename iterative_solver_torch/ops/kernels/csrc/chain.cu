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
// straight-line code. On Hopper the basis (2 MB at M = 64, N = 8192; 256 MB
// at N = 2^20) is far above a block's shared memory, and every product in
// the chain is a reduction over N that must finish before the next step
// uses it. Here the whole chain is one cooperative launch (all CTAs
// resident), its dependent steps separated by grid-wide barriers:
//
// - The columns are cut into steps of KC = 128; CTA b of G owns the steps
//   b, b + G, b + 2G, ... (chain.chain_steps) in every pass, so at any time
//   the CTAs stream neighbouring columns of each row (contiguous ranges per
//   CTA read v about 7% slower at N = 2^20).
// - Phase 0 (Jacobi only): each CTA's max of |diag| over a grid-stride
//   share into its slot; after a barrier every CTA takes the max over all
//   slots and |evals| (a max is exact in any order).
// - Pass 0: t = jacobi(r) (or r) over the CTA's columns, its n0 partial and
//   its first t v^T partial. Pass k: t -= (proj * mask) v, and the next
//   t v^T partial from the same staged v: one read of v serves the
//   subtraction and the next projection, so the chain reads v
//   gs_passes + 1 times. The last pass: t -= (proj * mask) v, the n2 and
//   g = t t^T partials.
// - Every partial goes to the CTA's own slot, never added atomically.
//   After a barrier, CTA b adds a fixed slice of the pass's entries over
//   all slots (a warp per 4 entries: lane l adds slots l, l + 32, ... in
//   order, then a shuffle tree) and writes them; a second barrier
//   publishes the projection to every CTA. The same card gives the same
//   bits on every call.
//
// Fast path (R <= 32, M <= 128, N a multiple of 4, 16-byte aligned rows;
// RP, MP: R and M padded to 16 or 32 and 64 or 128): a CTA streams its
// steps through a two-stage cp.async ring of (v, t) row segments of 512
// bytes (stride 132 floats, = 4 mod 32: conflict-free float4 reads). Per
// step, 4 x 4 register tiles throughout:
//   t -= P v   : the basis rows split among 32 / RP groups of threads, their
//                partials added pairwise through shared memory;
//   t v^T, t t^T: as K7 (gram.cu), rows i + (RP/4) p of t against rows
//                j + (MP/4) q of v, k-groups of threads taking every k-th
//                float4 of the step's columns.
// A thread's product sums run in three levels: the step's FMAs from zero,
// the step sums in groups of 8 steps, the groups in order; the k-groups
// are added pairwise at the end of the pass. The row norms take the same
// levels in float64 and are rounded once. That keeps every sum shallow:
// the first design added each CTA's partial with f32 atomics into the
// global sums, so a large partial absorbed the thousands of small ones
// added after it (n2 and g off by 4.6e-5 at N = 2^20, where the plain f32
// version errs by 1.5e-7 and 1.1e-6). chain.expand_chain_emulated follows
// this partition and order in plain PyTorch for the CPU tests.
//
// Second path (other shapes): chain_generic, the same phases, steps, slots
// and reductions, each thread computing one element of t (the
// subtraction's sum over M in order) or one partial entry over the CTA's
// steps (the same three levels) from global memory. No TF32, no tensor
// cores: full f32 on the CUDA cores, as Precision.HIGHEST in the Pallas
// kernel.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W): at N = 8192
// the working set (about 3 MB) sits in L2 and the operations take about a
// microsecond, so latency bounds it: each pass is a chain of L2 round trips,
// block barriers and two grid barriers, about 10 us (scratch variants that
// skip the loads, the FMAs, the slot sums or the grid barriers each save
// 1-2 us of it). At N = 2^20 the data dependence forces three passes over v
// (256 MB each, v does not fit the 50 MB L2); with r read and t written,
// 0.94 GB, 0.28 ms at 3.35 TB/s (the "three-pass floor"), against 0.136 ms
// of f32 operations at the CUDA cores' peak. This design also writes t and
// reads it back between passes (0.26 GB more). The loads alone take about
// 0.47 ms and the FMAs alone about 0.40; the ring overlaps them to about
// 0.52. Each pass's first step is copied before the barriers that end the
// previous pass.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 128;             // columns per step (chain.CHAIN_STEP)
constexpr int LD = KC + 4;          // staged row stride, = 4 (mod 32)
constexpr int GROUP = 8;            // steps per group of a thread's sums
constexpr int RED_FLOATS = 4096;    // partials of the subtraction's groups, or of the k-groups

struct Args {
  const float* r;
  float* t;
  const float* v;
  const float* mask;
  const float* diag;   // null: no Jacobi
  const float* evals;
  float* n0;
  float* n2;
  float* g;
  float* amax;         // [G] max|diag| of each CTA's share
  float* proj;         // [R * M] the published projection
  float* part;         // [G][slot] each CTA's partials of the current pass
  double* norms;       // [G][R] each CTA's row norms of the first or last pass
  int R, M, n, passes, slot;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// This CTA's steps of KC columns: blockIdx.x, blockIdx.x + gridDim.x, ...
// (chain.chain_steps). step_count: how many; step_col: the first column
// of the CTA's s-th step.
__device__ __forceinline__ int step_count(int n) {
  const int total = (n + KC - 1) / KC;
  return int(blockIdx.x) < total ? (total - 1 - int(blockIdx.x)) / int(gridDim.x) + 1 : 0;
}

__device__ __forceinline__ int step_col(int s) {
  return (int(blockIdx.x) + s * int(gridDim.x)) * KC;
}

// Phase 0: 1e-15 (max|diag| + max|evals|), the Jacobi shift's guard, as the
// plain version rounds it: each CTA's max over a grid-stride share of diag,
// then, after one grid barrier, every CTA's max over all. Every CTA calls it.
__device__ float jacobi_eps(const Args& a, float* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float md = 0.0f;
  for (int c = blockIdx.x * THREADS + threadIdx.x; c < a.n; c += gridDim.x * THREADS)
    md = fmaxf(md, fabsf(__ldg(a.diag + c)));
  md = warp_max(md);
  if (lane == 0) sm[warp] = md;
  __syncthreads();
  if (threadIdx.x == 0) {
    float x = 0.0f;
    for (int w = 0; w < WARPS; ++w) x = fmaxf(x, sm[w]);
    a.amax[blockIdx.x] = x;
  }
  cg::this_grid().sync();
  float d = 0.0f, e = 0.0f;
  for (int b = threadIdx.x; b < gridDim.x; b += THREADS) d = fmaxf(d, __ldcg(a.amax + b));
  for (int i = threadIdx.x; i < a.R; i += THREADS) e = fmaxf(e, fabsf(__ldg(a.evals + i)));
  d = warp_max(d);
  e = warp_max(e);
  if (lane == 0) {
    sm[WARPS + warp] = d;
    sm[2 * WARPS + warp] = e;
  }
  __syncthreads();
  d = e = 0.0f;
  for (int w = 0; w < WARPS; ++w) {
    d = fmaxf(d, sm[WARPS + w]);
    e = fmaxf(e, sm[2 * WARPS + w]);
  }
  __syncthreads();  // sm is reused
  return 1e-15f * (d + e);
}

// This CTA's slice of the pass's `entries` (the projection R M, or in the
// last pass the Gram R R), each summed over all CTAs' slots in a fixed
// order (chain._slot_sum) and written to `out`: warp w takes the float4 of
// entries w, w + 8, ... of the slice; lane l adds slots l, l + 32, ... in
// order, then a shuffle tree. No shared memory, no block barrier.
__device__ void reduce_slice(const Args& a, int entries, float* out) {
  const int per = ((entries + gridDim.x - 1) / gridDim.x + 3) / 4 * 4;
  const int e0 = blockIdx.x * per;
  const int e1 = min(entries, e0 + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = e0 + 4 * warp; e < e1; e += 4 * WARPS) {
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = lane; s < gridDim.x; s += 32)
      x = add4(x, __ldcg(reinterpret_cast<const float4*>(a.part + size_t(s) * a.slot + e)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x.x += __shfl_down_sync(0xffffffffu, x.x, off);
      x.y += __shfl_down_sync(0xffffffffu, x.y, off);
      x.z += __shfl_down_sync(0xffffffffu, x.z, off);
      x.w += __shfl_down_sync(0xffffffffu, x.w, off);
    }
    if (lane == 0) {
      const float v[4] = {x.x, x.y, x.z, x.w};
      for (int k = 0; k < 4 && e + k < e1; ++k) out[e + k] = v[k];
    }
  }
}

// The row norms of the first (n0) or last pass (n2), summed over all CTAs'
// slots in float64 in the same order and rounded once to float32, by the
// last CTA: warp w takes rows w, w + 8, ....
__device__ void reduce_norms(const Args& a, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < a.R; i += WARPS) {
    double x = 0.0;
    for (int s = lane; s < gridDim.x; s += 32) x += __ldcg(a.norms + size_t(s) * a.R + i);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) out[i] = float(x);
  }
}

// The end of a pass: the slots are complete; reduce this CTA's slice, and
// before the next pass publish the projection.
__device__ __forceinline__ void end_pass(const Args& a, bool first, bool last) {
  cg::this_grid().sync();
  if (last)
    reduce_slice(a, a.R * a.R, a.g);
  else
    reduce_slice(a, a.R * a.M, a.proj);
  if ((first || last) && blockIdx.x == gridDim.x - 1) reduce_norms(a, first ? a.n0 : a.n2);
  if (!last) cg::this_grid().sync();
}

// A thread's sum over steps: the step's sum l1, added into l2; at the end
// of each group of GROUP steps l2 into l3 (chain._over_steps).
template <typename T>
__device__ __forceinline__ void fold(T& l2, T& l3, T l1, bool group_end) {
  l2 += l1;
  if (group_end) {
    l3 += l2;
    l2 = 0.0f;
  }
}

// ------------------------------------------------------------ fast path

template <int RP, int MP>
struct Fast {
  static constexpr int STAGES = 2;
  static constexpr int ROWS = MP + RP;                   // staged rows: v, then t
  static constexpr int STAGE = ROWS * LD;                // floats
  static constexpr int SUB_TILES = (RP / 4) * (KC / 4);  // 4 x 4 tiles of a step of t
  static constexpr int SUB_KG = THREADS / SUB_TILES;     // groups of basis rows
  static constexpr int NR = RP * KC / 4 / THREADS;       // float4 of t a thread finalizes
  static constexpr int SMEM = (STAGES * STAGE + RED_FLOATS + MP * RP) * 4;
  static_assert(SUB_KG * RP * KC == RED_FLOATS, "subtraction partials fill RED_FLOATS");
  static_assert(NR >= 1 && MP % SUB_KG == 0, "tiling");
};

// Step columns [col, col + KC) into a stage: rows 0 .. MP - 1 of v (zero
// past M), then RP rows of src (r or t; zero past R); zero past n.
template <int RP, int MP>
__device__ __forceinline__ void fetch_step(float* stage, const float* src, const Args& a,
                                           int col) {
  using F = Fast<RP, MP>;
  for (int e = threadIdx.x; e < F::ROWS * (KC / 4); e += THREADS) {
    const int row = e / (KC / 4);
    const int c = (e % (KC / 4)) * 4;
    const bool isv = row < MP;
    const int rr = isv ? row : row - MP;
    const bool ok = (isv ? rr < a.M : rr < a.R) && col + c < a.n;
    const float* base = isv ? a.v : src;
    cp_async16(stage + row * LD + c, ok ? base + size_t(rr) * a.n + col + c : base, ok);
  }
}

// l1 += the step's products of rows of `as` (RA of them) and `bs` (RB):
// this thread's 4 x 4 tile, rows ti + (RA/4) p and tj + (RB/4) q, over the
// float4 columns g, g + KG, ... of its k-group g.
template <int RA, int RB>
__device__ __forceinline__ void product(const float* as, const float* bs, float (&l1)[4][4]) {
  constexpr int T = (RA / 4) * (RB / 4);
  constexpr int KG = THREADS / T;
  static_assert(KG >= 1 && KG <= KC / 4, "k-groups");
  const int g = threadIdx.x / T;
  const int u = threadIdx.x % T;
  const int ti = u / (RB / 4);
  const int tj = u % (RB / 4);
#pragma unroll
  for (int jk = 0; jk < KC / 4 / KG; ++jk) {
    const int k4 = g + KG * jk;
    float4 x[4], y[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      x[p] = *reinterpret_cast<const float4*>(as + (ti + (RA / 4) * p) * LD + 4 * k4);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      y[q] = *reinterpret_cast<const float4*>(bs + (tj + (RB / 4) * q) * LD + 4 * k4);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = l1[p][q];
        s = fmaf(x[p].x, y[q].x, s);
        s = fmaf(x[p].y, y[q].y, s);
        s = fmaf(x[p].z, y[q].z, s);
        s = fmaf(x[p].w, y[q].w, s);
        l1[p][q] = s;
      }
  }
}

// The pass's sums of this thread (l3 + l2), added over the k-groups
// pairwise through `red`, written to this CTA's slot by k-group 0.
template <int RA, int RB>
__device__ __forceinline__ void combine(const Args& a, bool last, float (&l2)[4][4],
                                        float (&l3)[4][4], float* red) {
  constexpr int T = (RA / 4) * (RB / 4);
  constexpr int KG = THREADS / T;
  const int tid = threadIdx.x;
  float4* mine = reinterpret_cast<float4*>(red + 16 * tid);
#pragma unroll
  for (int p = 0; p < 4; ++p)
    mine[p] = make_float4(l3[p][0] + l2[p][0], l3[p][1] + l2[p][1], l3[p][2] + l2[p][2],
                          l3[p][3] + l2[p][3]);
  __syncthreads();
#pragma unroll
  for (int h = 1; h < KG; h *= 2) {
    if ((tid / T) % (2 * h) == 0) {
      const float4* other = reinterpret_cast<const float4*>(red + 16 * (tid + h * T));
#pragma unroll
      for (int p = 0; p < 4; ++p) mine[p] = add4(mine[p], other[p]);
    }
    __syncthreads();
  }
  if (tid < T) {
    const int ti = tid / (RB / 4);
    const int tj = tid % (RB / 4);
    const int cols = last ? a.R : a.M;
    float* out = a.part + size_t(blockIdx.x) * a.slot;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float4 s = mine[p];
      const float sv[4] = {s.x, s.y, s.z, s.w};
      const int i = ti + (RA / 4) * p;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = tj + (RB / 4) * q;
        if (i < a.R && j < cols) out[i * cols + j] = sv[q];
      }
    }
  }
}

template <int RP, int MP>
__global__ void __launch_bounds__(THREADS, 2) chain_fast(Args a) {
  using F = Fast<RP, MP>;
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;
  float* red = ring + F::STAGES * F::STAGE;
  float* pt = red + RED_FLOATS;  // [MP][RP]: the masked projection, transposed
  const int tid = threadIdx.x;
  const int steps = step_count(a.n);
  const bool jacobi = a.diag != nullptr;
  const float eps = jacobi ? jacobi_eps(a, red) : 0.0f;

  // subtraction: group gs of basis rows, tile rows 4 ri .., columns 4 ci ..
  const int gs = tid / F::SUB_TILES;
  const int ri = (tid % F::SUB_TILES) / (KC / 4);
  const int ci = (tid % F::SUB_TILES) % (KC / 4);
  bool prefetched = false;

  for (int pass = 0; pass <= a.passes; ++pass) {
    const bool first = pass == 0;
    const bool last = pass == a.passes;
    const float* src = first ? a.r : a.t;
    if (!prefetched) {
#pragma unroll
      for (int s = 0; s < F::STAGES - 1; ++s) {
        if (s < steps) fetch_step<RP, MP>(ring + s * F::STAGE, src, a, step_col(s));
        cp_commit();
      }
    }
    if (!first)
      for (int e = tid; e < MP * RP; e += THREADS) {
        const int m = e / RP;
        const int r = e % RP;
        pt[e] = (m < a.M && r < a.R) ? __ldcg(a.proj + r * a.M + m) * __ldg(a.mask + m) : 0.0f;
      }

    float l2[4][4], l3[4][4];
    double n2s[F::NR], n3s[F::NR];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) l2[p][q] = l3[p][q] = 0.0f;
#pragma unroll
    for (int k = 0; k < F::NR; ++k) n2s[k] = n3s[k] = 0.0;

    for (int s = 0; s < steps; ++s) {
      cp_wait<F::STAGES - 2>();
      __syncthreads();  // step s landed; step s - 1's stage and red are free
      const int nxt = s + F::STAGES - 1;
      if (nxt < steps)
        fetch_step<RP, MP>(ring + (nxt % F::STAGES) * F::STAGE, src, a, step_col(nxt));
      cp_commit();
      float* vs = ring + (s % F::STAGES) * F::STAGE;
      float* ts = vs + MP * LD;
      const int col = step_col(s);
      const bool group_end = (s + 1) % GROUP == 0;

      if (!first) {  // the groups' partials of (P mask) v over this step
        float acc[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
        constexpr int PER = MP / F::SUB_KG;
#pragma unroll 4
        for (int m = gs * PER; m < (gs + 1) * PER; ++m) {
          const float4 pm = *reinterpret_cast<const float4*>(pt + m * RP + 4 * ri);
          const float4 vv = *reinterpret_cast<const float4*>(vs + m * LD + 4 * ci);
          const float pv[4] = {pm.x, pm.y, pm.z, pm.w};
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc[p][0] = fmaf(pv[p], vv.x, acc[p][0]);
            acc[p][1] = fmaf(pv[p], vv.y, acc[p][1]);
            acc[p][2] = fmaf(pv[p], vv.z, acc[p][2]);
            acc[p][3] = fmaf(pv[p], vv.w, acc[p][3]);
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
          *reinterpret_cast<float4*>(red + (gs * RP + 4 * ri + p) * KC + 4 * ci) =
              make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
        __syncthreads();
      }

      // t of this step: a thread finalizes 4 columns of NR rows, stores them
      // to the stage and to t, and adds their squares on the first and last
      // pass in float64 (the products are exact; KC / 4 lanes a row, a
      // shuffle tree)
#pragma unroll
      for (int k = 0; k < F::NR; ++k) {
        const int row = tid / (KC / 4) + k * (THREADS / (KC / 4));
        const int c4 = tid % (KC / 4);
        const int cc = col + 4 * c4;
        float4* tp = reinterpret_cast<float4*>(ts + row * LD + 4 * c4);
        float4 x = *tp;
        if (!first) {
          float4 d[F::SUB_KG];
#pragma unroll
          for (int j = 0; j < F::SUB_KG; ++j)
            d[j] = *reinterpret_cast<const float4*>(red + (j * RP + row) * KC + 4 * c4);
#pragma unroll
          for (int h = 1; h < F::SUB_KG; h *= 2)
#pragma unroll
            for (int j = 0; j < F::SUB_KG; j += 2 * h) d[j] = add4(d[j], d[j + h]);
          x = make_float4(x.x - d[0].x, x.y - d[0].y, x.z - d[0].z, x.w - d[0].w);
        } else if (jacobi && row < a.R && cc < a.n) {
          const float ev = __ldg(a.evals + row);
          x.x = x.x / ((__ldg(a.diag + cc) - ev) + eps);
          x.y = x.y / ((__ldg(a.diag + cc + 1) - ev) + eps);
          x.z = x.z / ((__ldg(a.diag + cc + 2) - ev) + eps);
          x.w = x.w / ((__ldg(a.diag + cc + 3) - ev) + eps);
        }
        *tp = x;
        if (row < a.R && cc < a.n) *reinterpret_cast<float4*>(a.t + size_t(row) * a.n + cc) = x;
        if (first || last) {
          double q = double(x.x) * x.x;
          q = fma(double(x.y), double(x.y), q);
          q = fma(double(x.z), double(x.z), q);
          q = fma(double(x.w), double(x.w), q);
#pragma unroll
          for (int off = KC / 8; off > 0; off >>= 1)
            q += __shfl_down_sync(0xffffffffu, q, off, KC / 4);
          fold(n2s[k], n3s[k], q, group_end);
        }
      }
      __syncthreads();  // this step's t is in the stage

      float l1[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) l1[p][q] = 0.0f;
      if (last)
        product<RP, RP>(ts, ts, l1);
      else
        product<RP, MP>(ts, vs, l1);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) fold(l2[p][q], l3[p][q], l1[p][q], group_end);
    }
    cp_wait<0>();
    __syncthreads();  // the ring is free, and every t of this pass is stored

    // the next pass's first steps, copied while the barriers run
    prefetched = !last;
    if (!last) {
#pragma unroll
      for (int s = 0; s < F::STAGES - 1; ++s) {
        if (s < steps) fetch_step<RP, MP>(ring + s * F::STAGE, a.t, a, step_col(s));
        cp_commit();
      }
    }
    if (last)
      combine<RP, RP>(a, true, l2, l3, red);
    else
      combine<RP, MP>(a, false, l2, l3, red);
    if ((first || last) && tid % (KC / 4) == 0) {
      double* out = a.norms + size_t(blockIdx.x) * a.R;
#pragma unroll
      for (int k = 0; k < F::NR; ++k) {
        const int row = tid / (KC / 4) + k * (THREADS / (KC / 4));
        if (row < a.R) out[row] = n3s[k] + n2s[k];
      }
    }
    end_pass(a, first, last);
  }
}

// ---------------------------------------------------------- second path

// Any R, M, N: the fast path's phases, steps, slots and reductions, one
// thread per element of t (the subtraction's sum over M in order) or per
// partial entry (its step sums from zero, through fold), from global
// memory; rows of t, this launch's stores, are read through L2 (__ldcg).
// Shared memory: the masked P (R, M), after 32 floats of scratch.
__global__ void __launch_bounds__(THREADS) chain_generic(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* pm = sm + 32;
  const int tid = threadIdx.x;
  const int steps = step_count(a.n);
  const bool jacobi = a.diag != nullptr;
  const float eps = jacobi ? jacobi_eps(a, sm) : 0.0f;
  const int rm = a.R * a.M;
  float* slot = a.part + size_t(blockIdx.x) * a.slot;

  for (int pass = 0; pass <= a.passes; ++pass) {
    const bool first = pass == 0;
    const bool last = pass == a.passes;
    if (!first) {
      for (int e = tid; e < rm; e += THREADS) pm[e] = __ldcg(a.proj + e) * __ldg(a.mask + e % a.M);
      __syncthreads();
    }
    for (int s = 0; s < steps; ++s) {
      const int col = step_col(s);
      const int w = min(KC, a.n - col);
      for (int e = tid; e < a.R * w; e += THREADS) {
        const int row = e / w;
        const int c = col + e % w;
        float* tp = a.t + size_t(row) * a.n + c;
        float x;
        if (first) {
          x = __ldg(a.r + size_t(row) * a.n + c);
          if (jacobi) x = x / ((__ldg(a.diag + c) - __ldg(a.evals + row)) + eps);
        } else {
          float d = 0.0f;
          for (int m = 0; m < a.M; ++m)
            d = fmaf(pm[row * a.M + m], __ldg(a.v + size_t(m) * a.n + c), d);
          x = __ldcg(tp) - d;
        }
        *tp = x;
      }
    }
    __syncthreads();  // this CTA's columns of t are stored
    const int entries = last ? a.R * a.R : rm;
    for (int e = tid; e < entries; e += THREADS) {
      const float* x = a.t + size_t(last ? e / a.R : e / a.M) * a.n;
      const float* y = last ? a.t + size_t(e % a.R) * a.n : a.v + size_t(e % a.M) * a.n;
      float l2 = 0.0f, l3 = 0.0f;
      for (int s = 0; s < steps; ++s) {
        const int col = step_col(s);
        const int end = min(a.n, col + KC);
        float l1 = 0.0f;
        for (int c = col; c < end; ++c) l1 = fmaf(__ldcg(x + c), __ldcg(y + c), l1);
        fold(l2, l3, l1, (s + 1) % GROUP == 0);
      }
      slot[e] = l3 + l2;
    }
    if (first || last)
      for (int i = tid; i < a.R; i += THREADS) {
        const float* x = a.t + size_t(i) * a.n;
        double l2 = 0.0, l3 = 0.0;
        for (int s = 0; s < steps; ++s) {
          const int col = step_col(s);
          const int end = min(a.n, col + KC);
          double l1 = 0.0;
          for (int c = col; c < end; ++c) {
            const double xv = __ldcg(x + c);
            l1 = fma(xv, xv, l1);
          }
          fold(l2, l3, l1, (s + 1) % GROUP == 0);
        }
        a.norms[size_t(blockIdx.x) * a.R + i] = l3 + l2;
      }
    end_pass(a, first, last);
  }
}

struct Variant {
  const void* fn;
  int smem;
};

template <int RP, int MP>
Variant fast_variant() {
  return {reinterpret_cast<const void*>(chain_fast<RP, MP>), Fast<RP, MP>::SMEM};
}

Variant pick(int R, int M, int n, bool aligned) {
  if (aligned && n % 4 == 0 && R <= 32 && M <= 128) {
    if (R <= 16) return M <= 64 ? fast_variant<16, 64>() : fast_variant<16, 128>();
    return M <= 64 ? fast_variant<32, 64>() : fast_variant<32, 128>();
  }
  return {reinterpret_cast<const void*>(chain_generic),
          int((32 + size_t(R) * M) * sizeof(float))};
}

constexpr int kMaxSmem = 227 * 1024;

int slot_floats(int R, int M) {
  const int e = M > R ? R * M : R * R;
  return (e + 3) / 4 * 4;
}

}  // namespace

extern "C" {

// CTAs of the variant that (R, M, n, aligned) takes that the current device
// holds at once: the most a launch may have. A negative value is a CUDA error.
int chain_capacity(int R, int M, int n, int aligned) {
  const Variant v = pick(R, M, n, aligned != 0);
  if (v.smem > kMaxSmem) return -int(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, v.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v.fn, THREADS, v.smem);
  return err == cudaSuccess ? sms * per_sm : -int(err);
}

// r, t (R, n); v (M, n); mask (M,); diag (n,) and evals (R,) or null (no
// Jacobi); n0, n2 (R,) and g (R, R) out, all f32. scratch (16-byte
// aligned, not zeroed): [ceil4(ctas) absmax | ceil4(R M) projection | ctas
// slots of slot_floats(R, M) | ctas x R float64 row norms] in floats. t
// may alias nothing else. gs_passes >= 1; 1 <= ctas <= chain_capacity(R,
// M, n, aligned) (a cooperative launch).
int chain_f32(const float* r, float* t, const float* v, const float* mask, const float* diag,
              const float* evals, float* n0, float* n2, float* g, float* scratch, int R, int M,
              int n, int gs_passes, int ctas, cudaStream_t stream) {
  if (R <= 0 || M <= 0 || n <= 0 || gs_passes < 1 || ctas < 1 ||
      (diag == nullptr) != (evals == nullptr))
    return int(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const Variant var = pick(R, M, n, aligned);
  if (var.smem > kMaxSmem) return int(cudaErrorInvalidValue);
  // set on every launch: the attribute belongs to the current device
  cudaError_t err =
      cudaFuncSetAttribute(var.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, var.smem);
  if (err != cudaSuccess) return int(err);
  Args a;
  a.r = r;
  a.t = t;
  a.v = v;
  a.mask = mask;
  a.diag = diag;
  a.evals = evals;
  a.n0 = n0;
  a.n2 = n2;
  a.g = g;
  a.amax = scratch;
  a.proj = scratch + (ctas + 3) / 4 * 4;
  a.part = a.proj + (size_t(R) * M + 3) / 4 * 4;
  a.slot = slot_floats(R, M);
  a.norms = reinterpret_cast<double*>(a.part + size_t(ctas) * a.slot);
  a.R = R;
  a.M = M;
  a.n = n;
  a.passes = gs_passes;
  void* args[] = {&a};
  return int(cudaLaunchCooperativeKernel(var.fn, dim3(ctas), dim3(THREADS), args, var.smem,
                                         stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
