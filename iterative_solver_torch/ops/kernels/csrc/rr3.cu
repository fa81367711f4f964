// Per-root 3x3 Rayleigh-Ritz of the PPCG step on Hopper (sm_90a): K8.
//
// Replaces no Pallas kernel: the JAX package leaves this step to XLA
// (iterative_solver_tpu/solvers/fused_ppcg.py:130-195, :236-241). It is the
// hand-written counterpart of the port's eager chain in
// solvers/fused_ppcg.py: _rr3_dots (nine row dots over N), _rr3_coeffs and
// _jacobi3_packed (two packed 3x3 Jacobi eigensolves and the whitening,
// elementwise on (r,) vectors), and the four-block update
//
//   x'  = (c0 x  + c1 w)  + c2 p        p'  = c1 w  + c2 p
//   ax' = (c0 ax + c1 aw) + c2 ap       ap' = c1 aw + c2 ap
//
// for the six (R, N) float32 blocks x, ax, w, aw, p, ap, in two launches:
//
// - rr3_dots_kernel: one pass over the six blocks gives the (9, R) dots in
//   _rr3_dots' row order (x,w) (x,p) (w,p) (x,ax) (w,ax) (p,ax) (w,aw)
//   (p,aw) (p,ap). CTA (c, i) of a (C, R) grid takes row i and the column
//   steps c, c + C, ... of STEP = 1024 columns (rr3.rr3_chunks gives C from
//   R and N alone); thread t takes the 4 columns 4t .. 4t + 3 of each step.
//   A thread's products are exact in float64 and its sums run in float64,
//   steps in order, then a shuffle-down tree in each warp, the 8 warps in
//   order, and the C partials of a row in order by the CTA that finishes
//   that row last (a counter per row says which); the sum is rounded once
//   to float32. Every sum has a fixed order, so a card gives the same bits
//   on every call, and rr3.rr3_dots_emulated follows the same order in
//   plain PyTorch (float64 too) for the CPU tests. The partials and the
//   counters share one allocation with the result, made for the call, so
//   nothing stays allocated between steps; a memset on the stream zeroes
//   the counters. Under sharding the step all-reduces the (9, R) block
//   between the launches.
// - rr3_update_kernel: CTA (c, i) of the same grid first solves root i's
//   3x3 problem from its nine dots and two live flags (one thread; the
//   other CTAs of the row do the same), then writes x', ax', p', ap' for
//   its columns of row i. The coefficient code follows _rr3_coeffs and
//   _jacobi3_packed operation by operation in float32, in the same order,
//   with the same floors and masks, and with every operation rounded on its
//   own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: nvcc
//   contracts none of them into an FMA), as PyTorch's elementwise kernels
//   round each operation; 1 / sqrt stays a division of a square root, as
//   the chain's reciprocal is. The update rounds each product and sum on its
//   own in the chain's order. So given the same dots, the coefficients and
//   the blocks carry the eager chain's bits.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W): bytes. The
// dots read 6 R N floats and the update reads 6 and writes 4: 16 R N * 4
// bytes, 0.16 ms at 3.35 TB/s for R = 64, N = 131072. The eager chain spent
// about 4 ms an iteration there, most of it ~1,970 elementwise kernels of
// 64 numbers each, one after another, replayed from a CUDA graph. Before
// its stream, an update CTA waits on one thread's coefficients: about 36
// Jacobi rotations of dependent divisions and square roots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STEP = 4 * THREADS;  // columns a step (rr3.RR3_STEP)
constexpr int NDOTS = 9;
// _floor(1e-36, float32), _floor(1e-4, float32): np.float32's values
constexpr float SMALL_FLOOR = 0x1.54484ap-120f;
constexpr float EPS_KEEP = 0x1.a36e2ep-14f;

struct Blocks {
  const float* x;
  const float* ax;
  const float* w;
  const float* aw;
  const float* p;
  const float* ap;
};

struct DotsArgs {
  Blocks in;
  float* out;        // (9, R)
  double* part;      // [R][C][9] each CTA's partial sums
  unsigned* count;   // [R] CTAs of the row finished, zeroed before the launch
  int R, n;
  bool vec;          // n % 4 == 0 and 16-byte aligned rows: float4 loads
};

struct UpdateArgs {
  Blocks in;
  const float* dots;       // (9, R)
  const uint8_t* live_w;   // (R,) bool
  const uint8_t* live_p;
  float* xn;
  float* axn;
  float* pn;
  float* apn;
  float* coef;             // (R, 3)
  int R, n;
  bool vec;
};

// Columns [c, c + 4) of a row (`row` its first float), zero past n.
__device__ __forceinline__ float4 load4(const float* row, int c, int n, bool vec) {
  if (vec)
    return c < n ? __ldg(reinterpret_cast<const float4*>(row + c))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return make_float4(c < n ? __ldg(row + c) : 0.0f, c + 1 < n ? __ldg(row + c + 1) : 0.0f,
                     c + 2 < n ? __ldg(row + c + 2) : 0.0f, c + 3 < n ? __ldg(row + c + 3) : 0.0f);
}

__device__ __forceinline__ void store4(float* row, int c, int n, bool vec, float4 v) {
  if (vec) {
    if (c < n) *reinterpret_cast<float4*>(row + c) = v;
    return;
  }
  if (c < n) row[c] = v.x;
  if (c + 1 < n) row[c + 1] = v.y;
  if (c + 2 < n) row[c + 2] = v.z;
  if (c + 3 < n) row[c + 3] = v.w;
}

__device__ __forceinline__ void unpack(float4 v, float (&a)[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__global__ void __launch_bounds__(THREADS) rr3_dots_kernel(DotsArgs a) {
  __shared__ double warp_sums[WARPS][NDOTS];
  __shared__ bool last;
  const int i = blockIdx.y;
  const int chunks = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = size_t(i) * a.n;
  const int total = (a.n + STEP - 1) / STEP;

  double acc[NDOTS];
#pragma unroll
  for (int d = 0; d < NDOTS; ++d) acc[d] = 0.0;
#pragma unroll 2
  for (int s = blockIdx.x; s < total; s += chunks) {
    const int c = s * STEP + 4 * tid;
    float x[4], ax[4], w[4], aw[4], p[4], ap[4];
    unpack(load4(a.in.x + off, c, a.n, a.vec), x);
    unpack(load4(a.in.ax + off, c, a.n, a.vec), ax);
    unpack(load4(a.in.w + off, c, a.n, a.vec), w);
    unpack(load4(a.in.aw + off, c, a.n, a.vec), aw);
    unpack(load4(a.in.p + off, c, a.n, a.vec), p);
    unpack(load4(a.in.ap + off, c, a.n, a.vec), ap);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // a float32 product is exact in float64: fma adds it rounded once
      acc[0] = fma(double(x[k]), double(w[k]), acc[0]);
      acc[1] = fma(double(x[k]), double(p[k]), acc[1]);
      acc[2] = fma(double(w[k]), double(p[k]), acc[2]);
      acc[3] = fma(double(x[k]), double(ax[k]), acc[3]);
      acc[4] = fma(double(w[k]), double(ax[k]), acc[4]);
      acc[5] = fma(double(p[k]), double(ax[k]), acc[5]);
      acc[6] = fma(double(w[k]), double(aw[k]), acc[6]);
      acc[7] = fma(double(p[k]), double(aw[k]), acc[7]);
      acc[8] = fma(double(p[k]), double(ap[k]), acc[8]);
    }
  }
#pragma unroll
  for (int d = 0; d < NDOTS; ++d) {
    double v = acc[d];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[warp][d] = v;
  }
  __syncthreads();
  double sum = 0.0;
  if (tid < NDOTS) {
    sum = warp_sums[0][tid];
    for (int k = 1; k < WARPS; ++k) sum += warp_sums[k][tid];
  }
  if (chunks == 1) {
    if (tid < NDOTS) a.out[tid * a.R + i] = __double2float_rn(sum);
    return;
  }
  double* row_part = a.part + size_t(i) * chunks * NDOTS;
  if (tid < NDOTS) row_part[blockIdx.x * NDOTS + tid] = sum;
  __threadfence();  // the partial is visible before the count says so
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.count + i, 1u) == unsigned(chunks - 1);
  __syncthreads();
  if (!last) return;
  if (tid < NDOTS) {
    double s = __ldcg(row_part + tid);
    for (int k = 1; k < chunks; ++k) s += __ldcg(row_part + k * NDOTS + tid);
    a.out[tid * a.R + i] = __double2float_rn(s);
  }
}

// ------------------------------------------- the coefficients, one root

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// Index of a_ij (= a_ji) in a packed symmetric 3x3: a00 a11 a22 a01 a02 a12.
__device__ __forceinline__ int sym(int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return lo == hi ? lo : lo + hi + 2;
}

// _jacobi3_packed: 6 sweeps of the rotations (0,1), (0,2), (1,2) on the
// packed a; v[i][j] the i-th component of the j-th eigenvector.
__device__ __forceinline__ void jacobi3(float (&a)[6], float (&v)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) v[i][j] = i == j ? 1.0f : 0.0f;
#pragma unroll 1
  for (int sweep = 0; sweep < 6; ++sweep) {
#pragma unroll
    for (int rot = 0; rot < 3; ++rot) {
      const int p = rot == 2 ? 1 : 0;
      const int q = rot == 0 ? 1 : 2;
      const int r = 3 - p - q;
      const float app = a[p], aqq = a[q], apq = a[sym(p, q)];
      const bool small = fabsf(apq) <= SMALL_FLOOR;
      const float apq_safe = small ? 1.0f : apq;
      const float tau = quo(sub(aqq, app), mul(2.0f, apq_safe));
      const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
      float t = quo(sgn, add(fabsf(tau), __fsqrt_rn(add(mul(tau, tau), 1.0f))));
      if (small) t = 0.0f;
      const float c = quo(1.0f, __fsqrt_rn(add(mul(t, t), 1.0f)));
      const float s = mul(t, c);
      const float arp = a[sym(r, p)], arq = a[sym(r, q)];
      a[sym(r, p)] = sub(mul(c, arp), mul(s, arq));
      a[sym(r, q)] = add(mul(s, arp), mul(c, arq));
      a[p] = sub(app, mul(t, apq));
      a[q] = add(aqq, mul(t, apq));
      a[sym(p, q)] = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float vip = v[i][p], viq = v[i][q];
        v[i][p] = sub(mul(c, vip), mul(s, viq));
        v[i][q] = add(mul(s, vip), mul(c, viq));
      }
    }
  }
}

// _rr3_coeffs for root i of the (9, R) dots.
__device__ void coefficients(const float* dots, int R, int i, bool live_w, bool live_p,
                             float (&out)[3]) {
  float d[NDOTS];
#pragma unroll
  for (int k = 0; k < NDOTS; ++k) d[k] = dots[k * R + i];
  const float xw = d[0], xp = d[1], wp = d[2], hxx = d[3], hxw = d[4], hxp = d[5],
              hww = d[6], hwp = d[7], hpp = d[8];

  float g[6] = {1.0f, live_w ? 1.0f : 0.0f, live_p ? 1.0f : 0.0f, xw, xp, wp};
  float gu[3][3];
  jacobi3(g, gu);
  float scale[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const bool keep = g[j] > EPS_KEEP;
    scale[j] = keep ? quo(1.0f, __fsqrt_rn(keep ? g[j] : 1.0f)) : 0.0f;
  }
  float s[3][3];
#pragma unroll
  for (int i2 = 0; i2 < 3; ++i2)
#pragma unroll
    for (int j = 0; j < 3; ++j) s[i2][j] = mul(gu[i2][j], scale[j]);
  const float h[3][3] = {{hxx, hxw, hxp}, {hxw, hww, hwp}, {hxp, hwp, hpp}};
  float m[3][3];
#pragma unroll
  for (int i2 = 0; i2 < 3; ++i2)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      m[i2][j] = add(add(mul(h[i2][0], s[0][j]), mul(h[i2][1], s[1][j])), mul(h[i2][2], s[2][j]));
  // hw = s^T h s for j <= l, packed; absmax over _rr3_coeffs' order
  float hw[6];
  float absmax = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int l = j; l < 3; ++l) {
      const float v = add(add(mul(s[0][j], m[0][l]), mul(s[1][j], m[1][l])), mul(s[2][j], m[2][l]));
      hw[sym(j, l)] = v;
      absmax = nan_max(absmax, fabsf(v));
    }
  const float big = add(mul(4.0f, absmax), 1.0f);
#pragma unroll
  for (int j = 0; j < 3; ++j) hw[j] = add(hw[j], mul(g[j] <= EPS_KEEP ? 1.0f : 0.0f, big));
  float eu[3][3];
  jacobi3(hw, eu);
  const bool is0 = hw[0] <= hw[1] && hw[0] <= hw[2];
  const bool is1 = !is0 && hw[1] <= hw[2];
  float u[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) u[k] = is0 ? eu[k][0] : (is1 ? eu[k][1] : eu[k][2]);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out[k] = add(add(mul(s[k][0], u[0]), mul(s[k][1], u[1])), mul(s[k][2], u[2]));
}

__global__ void __launch_bounds__(THREADS) rr3_update_kernel(UpdateArgs a) {
  __shared__ float cs[3];
  const int i = blockIdx.y;
  if (threadIdx.x == 0) {
    float c[3];
    coefficients(a.dots, a.R, i, a.live_w[i] != 0, a.live_p[i] != 0, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cs[k] = c[k];
      if (blockIdx.x == 0) a.coef[3 * i + k] = c[k];
    }
  }
  __syncthreads();
  const float c0 = cs[0], c1 = cs[1], c2 = cs[2];
  const size_t off = size_t(i) * a.n;
  const int total = (a.n + STEP - 1) / STEP;
#pragma unroll 2
  for (int s = blockIdx.x; s < total; s += gridDim.x) {
    const int c = s * STEP + 4 * threadIdx.x;
    if (c >= a.n) break;
    float x[4], ax[4], w[4], aw[4], p[4], ap[4];
    unpack(load4(a.in.x + off, c, a.n, a.vec), x);
    unpack(load4(a.in.ax + off, c, a.n, a.vec), ax);
    unpack(load4(a.in.w + off, c, a.n, a.vec), w);
    unpack(load4(a.in.aw + off, c, a.n, a.vec), aw);
    unpack(load4(a.in.p + off, c, a.n, a.vec), p);
    unpack(load4(a.in.ap + off, c, a.n, a.vec), ap);
    float xn[4], axn[4], pn[4], apn[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float cw = mul(c1, w[k]), cp = mul(c2, p[k]);
      const float caw = mul(c1, aw[k]), cap = mul(c2, ap[k]);
      xn[k] = add(add(mul(c0, x[k]), cw), cp);
      axn[k] = add(add(mul(c0, ax[k]), caw), cap);
      pn[k] = add(cw, cp);
      apn[k] = add(caw, cap);
    }
    store4(a.xn + off, c, a.n, a.vec, make_float4(xn[0], xn[1], xn[2], xn[3]));
    store4(a.axn + off, c, a.n, a.vec, make_float4(axn[0], axn[1], axn[2], axn[3]));
    store4(a.pn + off, c, a.n, a.vec, make_float4(pn[0], pn[1], pn[2], pn[3]));
    store4(a.apn + off, c, a.n, a.vec, make_float4(apn[0], apn[1], apn[2], apn[3]));
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool rows_vec(const Blocks& b, int n) {
  return n % 4 == 0 && aligned(b.x) && aligned(b.ax) && aligned(b.w) && aligned(b.aw) &&
         aligned(b.p) && aligned(b.ap);
}

bool bad_grid(int R, int n, int chunks) {
  return R <= 0 || R > 65535 || n <= 0 || chunks < 1 || chunks > (n + STEP - 1) / STEP;
}

}  // namespace

extern "C" {

// x, ax, w, aw, p, ap (R, n) f32, contiguous; out (9, R) f32. part
// (R * chunks * 9 float64) and count (R uint32, zeroed here) are scratch
// that nothing else uses until the launch ends. 1 <= chunks <= ceil(n /
// 1024) (rr3.rr3_chunks).
int rr3_dots_f32(const float* x, const float* ax, const float* w, const float* aw,
                 const float* p, const float* ap, float* out, double* part, unsigned* count,
                 int R, int n, int chunks, cudaStream_t stream) {
  if (bad_grid(R, n, chunks)) return int(cudaErrorInvalidValue);
  DotsArgs a;
  a.in = {x, ax, w, aw, p, ap};
  a.out = out;
  a.part = part;
  a.count = count;
  a.R = R;
  a.n = n;
  a.vec = rows_vec(a.in, n);
  if (chunks > 1) {
    const cudaError_t err = cudaMemsetAsync(count, 0, size_t(R) * sizeof(unsigned), stream);
    if (err != cudaSuccess) return int(err);
  }
  rr3_dots_kernel<<<dim3(chunks, R), THREADS, 0, stream>>>(a);
  return int(cudaGetLastError());
}

// dots (9, R) f32; live_w, live_p (R,) bool; the six blocks (R, n) f32,
// contiguous; xn, axn, pn, apn (R, n) f32 out, aliasing no input; coef
// (R, 3) f32 out. 1 <= chunks <= ceil(n / 1024).
int rr3_update_f32(const float* dots, const uint8_t* live_w, const uint8_t* live_p,
                   const float* x, const float* ax, const float* w, const float* aw,
                   const float* p, const float* ap, float* xn, float* axn, float* pn, float* apn,
                   float* coef, int R, int n, int chunks, cudaStream_t stream) {
  if (bad_grid(R, n, chunks)) return int(cudaErrorInvalidValue);
  UpdateArgs a;
  a.in = {x, ax, w, aw, p, ap};
  a.dots = dots;
  a.live_w = live_w;
  a.live_p = live_p;
  a.xn = xn;
  a.axn = axn;
  a.pn = pn;
  a.apn = apn;
  a.coef = coef;
  a.R = R;
  a.n = n;
  a.vec = rows_vec(a.in, n) && aligned(xn) && aligned(axn) && aligned(pn) && aligned(apn);
  rr3_update_kernel<<<dim3(chunks, R), THREADS, 0, stream>>>(a);
  return int(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

}  // extern "C"
