// The packed GRF's diagonal PCG for Hopper (sm_90a): the vector passes of a
// batched PCG on A z = b, A diagonal (one row of L floats shared by the B
// lanes) and preconditioned by its exact inverse 1/A, in masked lockstep:
//
//   muse_diag_pcg_start_f32      b = s * xt / d in registers (or b given),
//                                r0 = b - A z0, p0 = r0 / A; partial sums of
//                                b.b, r0.p0 and r0.r0
//   muse_diag_pcg_update_f32     alpha = rz / pAp a lane (0 where the lane is
//                                done or pAp <= 0), x += alpha p,
//                                r -= alpha (A p); partial sums of r.(r/A)
//                                and r.r
//   muse_diag_pcg_direction_f32  p = r / A + beta p, p kept where the lane
//                                was done
//   muse_diag_pcg_finalize_f32   each lane's partials summed, then its state:
//                                after the start the stop threshold, |r|,
//                                rz, done and the iteration count; after an
//                                update beta, the frozen flag of the
//                                direction, the iteration count, |r|, done
//                                and rz
//
// They replace no TPU kernel: muse_tpu writes the loop of ops/cg.py as jnp
// expressions that XLA fuses. Here each expression of that loop was its own
// pass over device memory (some 17 vectors read or written to start a solve
// and 27 a step); now a step is the fused quadform kernel (pAp and A p,
// spectrum_quadform.cu) and two of these passes, 2 + 5 + 3 vectors, and the
// start 4. Each coordinate update is the same IEEE float32 arithmetic as the
// loop's torch expressions (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: no
// contraction into FMAs), and A p is recomputed from p as the fused kernel's
// one multiply. The stop rule and the per-lane scalars are ops/cg.py's.
//
// Layout: the state vectors are (B, L) f32, lane b at b * L; A and the
// right-hand side's scale s are (L,) and stay in L2 (__ldg), the state is
// streamed past it (evict-first loads and stores). Grid (S, B), one slab of
// kSlab floats of one lane a block. Thread t takes the groups of four floats
// t, t + kThreads, ... of its slab, the four in order, then (the thread that
// owns the group after the last whole one) the ragged tail, so every sum
// takes its terms in one order whatever the load width: float4 where every
// row is 16-byte aligned and L % 4 == 0, four scalar loads otherwise.
//
// Sums: a fixed shuffle tree over a block into one partial a (lane, slab,
// quantity), then the finalize's one block a lane over its S partials with
// the same tree. No float atomics: a lane's sums, and so its whole solve, do
// not depend on the lanes beside it or on the run. Under a field axis the
// finalize is run twice: once to write each lane's rank-local sums (`sums`
// not null), which the caller reduces over the ranks, then on the reduced
// sums as S = 1 partials.
//
// Bound: memory. At B = 128, n = 1024 (L = 1,050,624; one (B, L) vector is
// 537.9 MB) the start moves 4 vectors (2.15 GB, 0.64 ms at 3.35 TB/s), the
// update 5 (2.69 GB, 0.80 ms) and the direction 3 (1.61 GB, 0.48 ms). The
// row A (4.2 MB) and the partials are negligible beside them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr long long kSlab = 8192;      // floats of one lane a block; % 4 == 0

// NV sums over the block, each valid in thread 0: a shuffle tree in each
// warp, then one over the warp sums in warp 0.
template <int NV>
__device__ __forceinline__ void block_sums(float (&v)[NV], float (*smem)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
    if (lane == 0) smem[i][warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      v[i] = (lane < (int)(blockDim.x >> 5)) ? smem[i][lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Group j of four floats at `p`: a streamed state row, or the shared row
// that stays in L2.
__device__ __forceinline__ float4 load_stream(const float* p, long long j,
                                              bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const float4*>(p) + j);
  p += 4 * j;
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float4 load_row(const float* p, long long j,
                                           bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p) + j);
  p += 4 * j;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ void store_stream(float* p, long long j, float4 v,
                                             bool vec) {
  if (vec) {
    __stcs(reinterpret_cast<float4*>(p) + j, v);
    return;
  }
  p += 4 * j;
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
}

// Component k of a float4 (k a constant of an unrolled loop).
__device__ __forceinline__ float& at(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The slab of block (s, b): its first float and its length.
struct Slab {
  long long start, len, nvec;
  __device__ Slab(long long L) {
    start = (long long)blockIdx.x * kSlab;
    len = (L - start < kSlab) ? L - start : kSlab;
    nvec = len >> 2;
  }
  // whether this thread takes the ragged tail [4 nvec, len)
  __device__ bool owns_tail() const {
    return (long long)threadIdx.x == nvec % kThreads;
  }
};

// One coordinate of the start: b, r0 = b - A z0, p0 = r0 / A, and the
// lane's three sums.
template <bool ROW>
__device__ __forceinline__ void start_one(float src, float s, float d,
                                          float a, float z0, float& r,
                                          float& p, float (&acc)[3]) {
  const float b = ROW ? __fdiv_rn(__fmul_rn(s, src), d) : src;
  r = __fsub_rn(b, __fmul_rn(a, z0));
  p = __fdiv_rn(r, a);
  acc[0] = fmaf(b, b, acc[0]);
  acc[1] = fmaf(r, p, acc[1]);
  acc[2] = fmaf(r, r, acc[2]);
}

template <bool ROW>
__global__ void __launch_bounds__(kThreads)
diag_pcg_start_kernel(const float* __restrict__ src,
                      const float* __restrict__ row, float d,
                      const float* __restrict__ A,
                      const float* __restrict__ z0, float* __restrict__ r,
                      float* __restrict__ p, float* __restrict__ partial,
                      long long L, int S) {
  __shared__ float smem[3][32];
  const Slab sl(L);
  const long long off = (long long)blockIdx.y * L + sl.start;
  const float* xs = src + off;
  const float* zs = z0 + off;
  float* rs = r + off;
  float* ps = p + off;
  const float* as = A + sl.start;
  const float* ss = ROW ? row + sl.start : A + sl.start;
  const bool vec = (L & 3) == 0 && aligned16(src) && aligned16(z0) &&
                   aligned16(r) && aligned16(p) && aligned16(A) &&
                   (!ROW || aligned16(row));
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 2
  for (long long j = threadIdx.x; j < sl.nvec; j += kThreads) {
    const float4 x = load_stream(xs, j, vec), z = load_stream(zs, j, vec);
    const float4 a = load_row(as, j, vec);
    const float4 s = ROW ? load_row(ss, j, vec) : a;
    float4 rv, pv;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      start_one<ROW>(at(x, k), at(s, k), d, at(a, k), at(z, k), at(rv, k),
                     at(pv, k), acc);
    store_stream(rs, j, rv, vec);
    store_stream(ps, j, pv, vec);
  }
  if (sl.owns_tail()) {
    for (long long i = sl.nvec << 2; i < sl.len; ++i)
      start_one<ROW>(xs[i], ROW ? __ldg(ss + i) : 0.0f, d, __ldg(as + i),
                     zs[i], rs[i], ps[i], acc);
  }
  block_sums<3>(acc, smem);
  if (threadIdx.x == 0) {
    const long long base = (long long)blockIdx.y * 3 * S + blockIdx.x;
#pragma unroll
    for (int q = 0; q < 3; ++q) partial[base + q * S] = acc[q];
  }
}

// alpha = rz / pAp, or 0 where the lane is done or its curvature is not
// positive (ops/cg.py's two `where`s, NaN included).
__device__ __forceinline__ float step_alpha(float rz, float pAp, bool done) {
  const float alpha = __fdiv_rn(rz, pAp > 0.0f ? pAp : 1.0f);
  return (done || pAp <= 0.0f) ? 0.0f : alpha;
}

// One coordinate of the update: x + alpha p, r - alpha (A p), and the
// lane's sums r.(r/A) and r.r.
__device__ __forceinline__ void update_one(float alpha, float a, float pv,
                                           float& x, float& r,
                                           float (&acc)[2]) {
  x = __fadd_rn(x, __fmul_rn(alpha, pv));
  r = __fsub_rn(r, __fmul_rn(alpha, __fmul_rn(pv, a)));
  const float z = __fdiv_rn(r, a);
  acc[0] = fmaf(r, z, acc[0]);
  acc[1] = fmaf(r, r, acc[1]);
}

__global__ void __launch_bounds__(kThreads)
diag_pcg_update_kernel(const float* x_in, float* x_out, float* r,
                       const float* __restrict__ p,
                       const float* __restrict__ A,
                       const float* __restrict__ pAp,
                       const float* __restrict__ rz,
                       const bool* __restrict__ done,
                       float* __restrict__ partial, long long L, int S) {
  __shared__ float smem[2][32];
  const long long b = blockIdx.y;
  const float alpha = step_alpha(rz[b], pAp[b], done[b]);
  const Slab sl(L);
  const long long off = b * L + sl.start;
  const float* xi = x_in + off;
  float* xo = x_out + off;
  float* rs = r + off;
  const float* ps = p + off;
  const float* as = A + sl.start;
  const bool vec = (L & 3) == 0 && aligned16(x_in) && aligned16(x_out) &&
                   aligned16(r) && aligned16(p) && aligned16(A);
  float acc[2] = {0.0f, 0.0f};
#pragma unroll 2
  for (long long j = threadIdx.x; j < sl.nvec; j += kThreads) {
    float4 x = load_stream(xi, j, vec), rv = load_stream(rs, j, vec);
    const float4 pv = load_stream(ps, j, vec);
    const float4 a = load_row(as, j, vec);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      update_one(alpha, at(a, k), at(pv, k), at(x, k), at(rv, k), acc);
    store_stream(xo, j, x, vec);
    store_stream(rs, j, rv, vec);
  }
  if (sl.owns_tail()) {
    for (long long i = sl.nvec << 2; i < sl.len; ++i) {
      float x = xi[i];
      update_one(alpha, __ldg(as + i), ps[i], x, rs[i], acc);
      xo[i] = x;
    }
  }
  block_sums<2>(acc, smem);
  if (threadIdx.x == 0) {
    const long long base = b * 2 * S + blockIdx.x;
    partial[base] = acc[0];
    partial[base + S] = acc[1];
  }
}

__device__ __forceinline__ float direction_one(float r, float p, float a,
                                               float beta) {
  return __fadd_rn(__fdiv_rn(r, a), __fmul_rn(beta, p));
}

__global__ void __launch_bounds__(kThreads)
diag_pcg_direction_kernel(const float* __restrict__ r, float* p,
                          const float* __restrict__ A,
                          const float* __restrict__ beta,
                          const bool* __restrict__ keep, long long L) {
  const long long b = blockIdx.y;
  if (keep[b]) return;                  // a lane done before this step
  const float be = beta[b];
  const Slab sl(L);
  const long long off = b * L + sl.start;
  const float* rs = r + off;
  float* ps = p + off;
  const float* as = A + sl.start;
  const bool vec = (L & 3) == 0 && aligned16(r) && aligned16(p) &&
                   aligned16(A);
#pragma unroll 2
  for (long long j = threadIdx.x; j < sl.nvec; j += kThreads) {
    const float4 rv = load_stream(rs, j, vec), a = load_row(as, j, vec);
    float4 pv = load_stream(ps, j, vec);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      at(pv, k) = direction_one(at(rv, k), at(pv, k), at(a, k), be);
    store_stream(ps, j, pv, vec);
  }
  if (sl.owns_tail()) {
    for (long long i = sl.nvec << 2; i < sl.len; ++i)
      ps[i] = direction_one(rs[i], ps[i], __ldg(as + i), be);
  }
}

// One block a lane: its NQ sums over S partials, then (thread 0) either
// the sums into `sums` or the lane's new state. NQ = 3 after the start
// (b.b, rz, r.r), 2 after an update (rz, r.r).
template <int NQ>
__global__ void __launch_bounds__(kThreads)
diag_pcg_finalize_kernel(const float* __restrict__ partial, int S,
                         float* __restrict__ sums, float c, float* rz,
                         float* r_norm, float* thresh, float* beta,
                         bool* done, bool* keep, int* iters) {
  __shared__ float smem[NQ][32];
  const long long b = blockIdx.x;
  float acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    acc[q] = 0.0f;
    for (int s = threadIdx.x; s < S; s += kThreads)
      acc[q] += partial[(b * NQ + q) * S + s];
  }
  block_sums<NQ>(acc, smem);
  if (threadIdx.x != 0) return;
  if (sums != nullptr) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) sums[b * NQ + q] = acc[q];
    return;
  }
  if (NQ == 3) {
    // the stop: |r| < tol |b| with tol = c / max(|b|, 1e-30), c =
    // atol sqrt(nz), taken as torch takes `c / t` (t.reciprocal() * c)
    const float bn = sqrtf(acc[0]);
    const float cb = bn < 1e-30f ? 1e-30f : bn;
    const float th = __fmul_rn(__fmul_rn(__frcp_rn(cb), c), cb);
    const float rn = sqrtf(acc[NQ - 1]);
    thresh[b] = th;
    r_norm[b] = rn;
    rz[b] = acc[1];
    beta[b] = 0.0f;
    done[b] = rn < th;
    keep[b] = rn < th;
    iters[b] = 0;
  } else {
    const bool was = done[b];
    const float rz0 = rz[b], rz1 = acc[0];
    const float rn = sqrtf(acc[NQ - 1]);
    beta[b] = was ? 0.0f : __fdiv_rn(rz1, rz0 == 0.0f ? 1.0f : rz0);
    keep[b] = was;
    iters[b] += was ? 0 : 1;
    done[b] = was || rn < thresh[b] || !isfinite(rz1);
    rz[b] = rz1;
    r_norm[b] = rn;
  }
}

bool bad_shape(long long B, long long L, int S) {
  return B <= 0 || B > 65535 || L <= 0 || S <= 0 ||
         (long long)S * kSlab < L || (long long)(S - 1) * kSlab >= L;
}

}  // namespace

extern "C" {

// Floats per slab: the wrapper sizes the partials as S = ceil(L / slab).
long long muse_diag_pcg_slab(void) { return kSlab; }

// src: (B, L) xt (row not null: b = row * xt / d) or b (row null); A: (L,);
// z0: (B, L); r, p: (B, L) out; partial: (B, 3, S) out. Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
int muse_diag_pcg_start_f32(const float* src, const float* row, float d,
                            const float* A, const float* z0, float* r,
                            float* p, float* partial, long long B, long long L,
                            int S, void* stream) {
  if (bad_shape(B, L, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)S, (unsigned)B);
  if (row != nullptr)
    diag_pcg_start_kernel<true><<<grid, kThreads, 0, st>>>(
        src, row, d, A, z0, r, p, partial, L, S);
  else
    diag_pcg_start_kernel<false><<<grid, kThreads, 0, st>>>(
        src, row, d, A, z0, r, p, partial, L, S);
  return (int)cudaGetLastError();
}

// x_in, x_out: (B, L), x_out may be x_in; r: (B, L) in and out; p: (B, L);
// A: (L,); pAp, rz: (B,) f32; done: (B,) bool; partial: (B, 2, S) out.
int muse_diag_pcg_update_f32(const float* x_in, float* x_out, float* r,
                             const float* p, const float* A, const float* pAp,
                             const float* rz, const bool* done,
                             float* partial, long long B, long long L, int S,
                             void* stream) {
  if (bad_shape(B, L, S)) return (int)cudaErrorInvalidValue;
  diag_pcg_update_kernel<<<dim3((unsigned)S, (unsigned)B), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x_in, x_out, r, p, A, pAp, rz, done, partial, L, S);
  return (int)cudaGetLastError();
}

// r: (B, L); p: (B, L) in and out; A: (L,); beta: (B,) f32; keep: (B,) bool.
int muse_diag_pcg_direction_f32(const float* r, float* p, const float* A,
                                const float* beta, const bool* keep,
                                long long B, long long L, int S,
                                void* stream) {
  if (bad_shape(B, L, S)) return (int)cudaErrorInvalidValue;
  diag_pcg_direction_kernel<<<dim3((unsigned)S, (unsigned)B), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      r, p, A, beta, keep, L);
  return (int)cudaGetLastError();
}

// nq = 3 after the start, 2 after an update; partial: (B, nq, S); sums:
// (B, nq) out, or null to write the lanes' state (rz, r_norm, thresh, beta:
// (B,) f32; done, keep: (B,) bool; iters: (B,) int32; c = atol sqrt(nz)).
int muse_diag_pcg_finalize_f32(int nq, const float* partial, int S,
                               float* sums, float c, float* rz, float* r_norm,
                               float* thresh, float* beta, bool* done,
                               bool* keep, int* iters, long long B,
                               void* stream) {
  if (B <= 0 || B > 2147483647LL || S <= 0 || (nq != 2 && nq != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq == 3)
    diag_pcg_finalize_kernel<3><<<(unsigned)B, kThreads, 0, st>>>(
        partial, S, sums, c, rz, r_norm, thresh, beta, done, keep, iters);
  else
    diag_pcg_finalize_kernel<2><<<(unsigned)B, kThreads, 0, st>>>(
        partial, S, sums, c, rz, r_norm, thresh, beta, done, keep, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
