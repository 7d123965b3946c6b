// Lens planes for Hopper (sm_90a): the elementwise passes of the lensing
// model's lens operator around cuFFT, for B lanes of an n x n field
// (nr = n/2 + 1 columns of a half-spectrum, m = n*nr, N = n*n):
//
//   muse_lens_expand_f32    P^[b,j] = c * S_j * herm_sym(unpack(zt[b]))
//                           (B, 6, n, nr) complex, the irfft2 input
//   muse_lens_combine_f32   F = sum_j D_j * P[b,j]; with x, the residual
//                           r = x - F (where out is not null), sum r^2 a
//                           lane and the deflection cotangents r * dF/ddx,
//                           r * dF/ddy
//   muse_lens_spread_f32    D_j * W, (B, 6, n, n), the rfft2 input
//   muse_lens_contract_f32  pack(herm_sym(sum_j conj(S_j) * c * F^[b,j]))
//
// with the spectral diagonals S_j in {1, i kx, i ky, -kx^2, -ky^2, -kx ky}
// and the pixel diagonals D_j in {1, dx, dy, dx^2/2, dy^2/2, dx dy}. Lane
// b's six planes lie contiguous at (b*6 + j) * (m or N), its deflection
// planes (dx, dy) at (b*2 + j) * N, its packed spectrum (re | im) at b*2*m.
//
// They replace no TPU kernel: muse_tpu writes the same passes as jnp
// products that XLA fuses around its FFTs (models/lensing.py, `lin_ops`).
// Here each was a broadcast product over a six-plane stack in PyTorch (the
// spectral product, the D stack and its products, the plane sums,
// herm_sym's `cat`), and autograd re-read the stacks for the reduced
// gradient. Now G = combine(irfft2(expand(zt))) and
// G^T = contract(rfft2(spread(w))), and the reduced gradient and the
// certificate need only the two cotangent planes of the residual form.
//
// Bound: memory, each pass reads and writes every plane once. At B = 65,
// n = 1024: expand reads 273 MB and writes 1.64 GB (0.57 ms at 3.35 TB/s),
// combine reads 6 + 2 planes and writes 1 (2.46 GB, 0.73 ms), its residual
// form reads x too and writes r and the two cotangents (3.27 GB, 0.98 ms;
// 3.00 GB, 0.90 ms without r),
// spread reads 3 planes and writes 6 (2.46 GB, 0.73 ms), contract reads
// 1.64 GB and writes 273 MB (0.57 ms). The diagonals are formed in
// registers from kx (nr floats) and ky (n floats), as the hermitian
// projection of models/lensing.py's `_derivative_diagonals` gives them:
// in the self-conjugate columns (0 and, for even n, nr - 1) each is the
// average of its own value and its row partner's (n - r) % n, which zeroes
// i kx in the last column and i ky in row n/2. The unpack scale 1/(sqrt(w)/n)
// and the pack scale sqrt(w)/n (w = 1 in those columns, 2 elsewhere) are
// formed in registers too. A half-spectrum pass takes one element a thread
// (consecutive threads on consecutive columns: every plane read or written
// as one coalesced run a warp); a pixel pass takes float4s of a slab of
// kSlab pixels a block, where N % 4 == 0 and the planes are 16-byte aligned
// (scalars otherwise).
//
// The residual form's sum r^2 a lane is a fixed two-pass tree, as
// spectrum_quadform.cu's: a partial a (lane, slab) block, then one block a
// lane over its partials. No atomics, so a rerun is bitwise equal and a
// lane's sum does not depend on the lanes beside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr long long kSlab = 4096;      // pixels of one lane a block; % 4 == 0

// One sum over the block, valid in thread 0: a shuffle tree in each warp,
// then one over the warp sums in warp 0.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x >> 5)) ? smem[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// S_j at (kx, ky) as real scalars s_j: S_j = s_j for j = 0, 3, 4, 5 and
// S_j = i * s_j for j = 1, 2.
__device__ __forceinline__ void raw_diagonals(float kx, float ky,
                                              float (&s)[6]) {
  s[0] = 1.0f;
  s[1] = kx;
  s[2] = ky;
  s[3] = -(kx * kx);
  s[4] = -(ky * ky);
  s[5] = -(kx * ky);
}

__device__ __forceinline__ bool imaginary(int j) { return j == 1 || j == 2; }

// The hermitian-consistent S_j at (r, c): in a self-conjugate column
// 0.5 * (S_j(r) + conj(S_j(p))), p the row partner.
__device__ __forceinline__ void diagonals(const float* kx, const float* ky,
                                          int r, int c, bool selfconj, int p,
                                          float (&s)[6]) {
  raw_diagonals(kx[c], ky[r], s);
  if (selfconj) {
    float t[6];
    raw_diagonals(kx[c], ky[p], t);
#pragma unroll
    for (int j = 0; j < 6; ++j)
      s[j] = 0.5f * (imaginary(j) ? s[j] - t[j] : s[j] + t[j]);
  }
}

// sqrt(w)/n of column c: the isometric pack scale.
__device__ __forceinline__ float pack_scale(bool selfconj, int n) {
  return (selfconj ? 1.0f : sqrtf(2.0f)) / (float)n;
}

// Block (x, b): thread t takes element i = x*kThreads + t of lane b's
// half-spectrum (row r, column c).
__global__ void __launch_bounds__(kThreads)
expand_kernel(const float* __restrict__ zt, const float* __restrict__ cs,
              const float* __restrict__ kx, const float* __restrict__ ky,
              float2* __restrict__ out, int n, int nr) {
  const long long m = (long long)n * nr;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const long long b = blockIdx.y;
  const int r = (int)(i / nr);
  const int c = (int)(i - (long long)r * nr);
  const bool sc = c == 0 || ((n & 1) == 0 && c == nr - 1);
  const int p = (n - r) % n;
  const float sqw = pack_scale(sc, n);
  const float* re = zt + b * 2 * m;
  const float* im = re + m;
  float vr = re[i] / sqw;
  float vi = im[i] / sqw;
  if (sc) {
    const long long ip = (long long)p * nr + c;
    vr = 0.5f * (vr + re[ip] / sqw);
    vi = 0.5f * (vi - im[ip] / sqw);
  }
  const float a = cs[i];
  vr *= a;
  vi *= a;
  float s[6];
  diagonals(kx, ky, r, c, sc, p, s);
  float2* o = out + b * 6 * m + i;
#pragma unroll
  for (int j = 0; j < 6; ++j)
    o[j * m] = imaginary(j) ? make_float2(-vi * s[j], vr * s[j])
                            : make_float2(vr * s[j], vi * s[j]);
}

// The same element mapping; writes lane b's packed (re | im) coordinate i.
__global__ void __launch_bounds__(kThreads)
contract_kernel(const float2* __restrict__ F6, const float* __restrict__ cs,
                const float* __restrict__ kx, const float* __restrict__ ky,
                float* __restrict__ out, int n, int nr) {
  const long long m = (long long)n * nr;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const long long b = blockIdx.y;
  const int r = (int)(i / nr);
  const int c = (int)(i - (long long)r * nr);
  const bool sc = c == 0 || ((n & 1) == 0 && c == nr - 1);
  const int p = (n - r) % n;
  float s[6];
  diagonals(kx, ky, r, c, sc, p, s);
  const float2* f = F6 + b * 6 * m;
  // t = sum_j conj(S_j) F_j at (r, c)
  float tr = 0.0f, ti = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float2 v = f[j * m + i];
    if (imaginary(j)) {
      tr += s[j] * v.y;
      ti -= s[j] * v.x;
    } else {
      tr += s[j] * v.x;
      ti += s[j] * v.y;
    }
  }
  float yr = cs[i] * tr;
  float yi = cs[i] * ti;
  if (sc) {
    // the partner row's sum: there conj(S_j(p)) = S_j(r)
    const long long ip = (long long)p * nr + c;
    float ur = 0.0f, ui = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float2 v = f[j * m + ip];
      if (imaginary(j)) {
        ur -= s[j] * v.y;
        ui += s[j] * v.x;
      } else {
        ur += s[j] * v.x;
        ui += s[j] * v.y;
      }
    }
    yr = 0.5f * (yr + cs[ip] * ur);
    yi = 0.5f * (yi - cs[ip] * ui);
  }
  const float sqw = pack_scale(sc, n);
  out[b * 2 * m + i] = yr * sqw;
  out[b * 2 * m + m + i] = yi * sqw;
}

__device__ __forceinline__ float& comp(float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// One pixel of combine: F, or with RESID the residual r = x - F (into o),
// its square into acc and the cotangents ax, ay.
template <bool RESID>
__device__ __forceinline__ void combine_pixel(const float (&q)[6], float dx,
                                              float dy, float x, float& o,
                                              float& ax, float& ay,
                                              float& acc) {
  const float F = q[0] + dx * q[1] + dy * q[2] + (0.5f * dx * dx) * q[3] +
                  (0.5f * dy * dy) * q[4] + (dx * dy) * q[5];
  if (RESID) {
    const float r = x - F;
    o = r;
    acc = fmaf(r, r, acc);
    ax = r * (q[1] + dx * q[3] + dy * q[5]);
    ay = r * (q[2] + dy * q[4] + dx * q[5]);
  } else {
    o = F;
  }
}

// Block (s, b) takes pixels [s*kSlab, s*kSlab + kSlab) of lane b: thread t
// the float4s t, t + kThreads, ... (where vec), then the scalars past the
// last whole float4 (all of them where not vec). With RESID, a null out
// stores no r.
template <bool RESID>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ P6, const float* __restrict__ d,
               const float* __restrict__ x, float* __restrict__ out,
               float* __restrict__ A, float* __restrict__ partial,
               long long N, int S, bool vec) {
  __shared__ float smem[32];
  const int s = blockIdx.x;
  const long long b = blockIdx.y;
  const long long start = (long long)s * kSlab;
  const long long len = (N - start < kSlab) ? N - start : kSlab;
  const float* P = P6 + b * 6 * N + start;
  const float* dxp = d + b * 2 * N + start;
  const float* dyp = dxp + N;
  const float* xp = RESID ? x + b * N + start : nullptr;
  float* op = out ? out + b * N + start : nullptr;
  float* axp = RESID ? A + b * 2 * N + start : nullptr;
  float* ayp = RESID ? axp + N : nullptr;
  float acc = 0.0f;
  long long tail = 0;
  if (vec) {
    const long long nvec = len >> 2;
    for (long long v = threadIdx.x; v < nvec; v += kThreads) {
      float4 q4[6];
#pragma unroll
      for (int j = 0; j < 6; ++j)
        q4[j] = __ldcs(reinterpret_cast<const float4*>(P + j * N) + v);
      float4 dx4 = __ldcs(reinterpret_cast<const float4*>(dxp) + v);
      float4 dy4 = __ldcs(reinterpret_cast<const float4*>(dyp) + v);
      float4 x4 = RESID ? __ldcs(reinterpret_cast<const float4*>(xp) + v)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 o4, ax4, ay4;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float q[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) q[j] = comp(q4[j], k);
        combine_pixel<RESID>(q, comp(dx4, k), comp(dy4, k), comp(x4, k),
                             comp(o4, k), comp(ax4, k), comp(ay4, k), acc);
      }
      if (op) reinterpret_cast<float4*>(op)[v] = o4;
      if (RESID) {
        reinterpret_cast<float4*>(axp)[v] = ax4;
        reinterpret_cast<float4*>(ayp)[v] = ay4;
      }
    }
    tail = nvec << 2;
  }
  for (long long i = tail + threadIdx.x; i < len; i += kThreads) {
    float q[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) q[j] = P[j * N + i];
    float o, ax, ay;
    combine_pixel<RESID>(q, dxp[i], dyp[i], RESID ? xp[i] : 0.0f, o, ax, ay,
                         acc);
    if (op) op[i] = o;
    if (RESID) {
      axp[i] = ax;
      ayp[i] = ay;
    }
  }
  if (RESID) {
    acc = block_sum(acc, smem);
    if (threadIdx.x == 0) partial[b * S + s] = acc;
  }
}

// The same blocks as combine_kernel; writes D_j * W into lane b's planes.
__global__ void __launch_bounds__(kThreads)
spread_kernel(const float* __restrict__ W, const float* __restrict__ d,
              float* __restrict__ out, long long N, bool vec) {
  const int s = blockIdx.x;
  const long long b = blockIdx.y;
  const long long start = (long long)s * kSlab;
  const long long len = (N - start < kSlab) ? N - start : kSlab;
  const float* wp = W + b * N + start;
  const float* dxp = d + b * 2 * N + start;
  const float* dyp = dxp + N;
  float* op = out + b * 6 * N + start;
  long long tail = 0;
  if (vec) {
    const long long nvec = len >> 2;
    for (long long v = threadIdx.x; v < nvec; v += kThreads) {
      float4 w4 = __ldcs(reinterpret_cast<const float4*>(wp) + v);
      float4 dx4 = __ldcs(reinterpret_cast<const float4*>(dxp) + v);
      float4 dy4 = __ldcs(reinterpret_cast<const float4*>(dyp) + v);
      float4 o4[6];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float w = comp(w4, k), dx = comp(dx4, k), dy = comp(dy4, k);
        comp(o4[0], k) = w;
        comp(o4[1], k) = dx * w;
        comp(o4[2], k) = dy * w;
        comp(o4[3], k) = (0.5f * dx * dx) * w;
        comp(o4[4], k) = (0.5f * dy * dy) * w;
        comp(o4[5], k) = (dx * dy) * w;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j)
        reinterpret_cast<float4*>(op + j * N)[v] = o4[j];
    }
    tail = nvec << 2;
  }
  for (long long i = tail + threadIdx.x; i < len; i += kThreads) {
    const float w = wp[i], dx = dxp[i], dy = dyp[i];
    op[i] = w;
    op[N + i] = dx * w;
    op[2 * N + i] = dy * w;
    op[3 * N + i] = (0.5f * dx * dx) * w;
    op[4 * N + i] = (0.5f * dy * dy) * w;
    op[5 * N + i] = (dx * dy) * w;
  }
}

__global__ void __launch_bounds__(kThreads)
lane_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                int S) {
  __shared__ float smem[32];
  const long long b = blockIdx.x;
  float acc = 0.0f;
  for (int s = threadIdx.x; s < S; s += kThreads) acc += partial[b * S + s];
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) out[b] = acc;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool bad_shape(long long B, int n) {
  return B <= 0 || B > 65535 || n < 2;
}

dim3 spectrum_grid(long long B, int n) {
  const long long m = (long long)n * (n / 2 + 1);
  return dim3((unsigned)((m + kThreads - 1) / kThreads), (unsigned)B);
}

int slabs(int n) {
  const long long N = (long long)n * n;
  return (int)((N + kSlab - 1) / kSlab);
}

}  // namespace

extern "C" {

// Pixels a block of combine and spread: combine's partial scratch holds
// B * ceil(n*n / slab) floats.
long long muse_lens_slab(void) { return kSlab; }

// zt: (B, 2*m) f32, cs: (n, nr) f32, kx: (nr,) f32, ky: (n,) f32, out:
// (B, 6, n, nr) complex64. Launches on `stream` and returns
// cudaGetLastError() (0 = ok); so do the others.
int muse_lens_expand_f32(const float* zt, const float* cs, const float* kx,
                         const float* ky, void* out, long long B, int n,
                         void* stream) {
  if (bad_shape(B, n)) return (int)cudaErrorInvalidValue;
  expand_kernel<<<spectrum_grid(B, n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      zt, cs, kx, ky, static_cast<float2*>(out), n, n / 2 + 1);
  return (int)cudaGetLastError();
}

// F6: (B, 6, n, nr) complex64, out: (B, 2*m) f32; the rest as expand's.
int muse_lens_contract_f32(const void* F6, const float* cs, const float* kx,
                           const float* ky, float* out, long long B, int n,
                           void* stream) {
  if (bad_shape(B, n)) return (int)cudaErrorInvalidValue;
  contract_kernel<<<spectrum_grid(B, n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(F6), cs, kx, ky, out, n, n / 2 + 1);
  return (int)cudaGetLastError();
}

// P6: (B, 6, n, n), d: (B, 2, n, n), out: (B, n, n), all f32. With x
// (B, n, n) not null, the residual form: out gets r (null: r is not
// stored), A (B, 2, n, n) the cotangents, partial (B, S) scratch
// (S = ceil(n*n / slab)) and rr (B,) the sums of r^2.
int muse_lens_combine_f32(const float* P6, const float* d, const float* x,
                          float* out, float* A, float* partial, float* rr,
                          long long B, int n, void* stream) {
  if (bad_shape(B, n) || (x == nullptr && out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = (long long)n * n;
  const int S = slabs(n);
  const bool vec = (N & 3) == 0 && aligned16(P6) && aligned16(d) &&
                   aligned16(out) &&
                   (x == nullptr || (aligned16(x) && aligned16(A)));
  const dim3 grid((unsigned)S, (unsigned)B);
  if (x == nullptr) {
    combine_kernel<false><<<grid, kThreads, 0, st>>>(
        P6, d, nullptr, out, nullptr, nullptr, N, S, vec);
    return (int)cudaGetLastError();
  }
  combine_kernel<true><<<grid, kThreads, 0, st>>>(P6, d, x, out, A, partial,
                                                  N, S, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lane_sum_kernel<<<(unsigned)B, kThreads, 0, st>>>(partial, rr, S);
  return (int)cudaGetLastError();
}

// W: (B, n, n), d: (B, 2, n, n), out: (B, 6, n, n), all f32.
int muse_lens_spread_f32(const float* W, const float* d, float* out,
                         long long B, int n, void* stream) {
  if (bad_shape(B, n)) return (int)cudaErrorInvalidValue;
  const long long N = (long long)n * n;
  const bool vec =
      (N & 3) == 0 && aligned16(W) && aligned16(d) && aligned16(out);
  spread_kernel<<<dim3((unsigned)slabs(n), (unsigned)B), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(W, d, out, N, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
