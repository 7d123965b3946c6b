// Spectrum quadforms for Hopper (sm_90a), over the L = n*2m packed re|im
// coordinates of each lane b:
//
//   muse_spectrum_quadforms_f32          quad[b,k] = sum_i z[b,i]^2 * W[k,i]
//                                        for K = 1..4 weights W[k]
//   muse_spectrum_quadform_and_grad_f32  g[b,i] = z[b,i] * w[i] and
//                                        quad[b] = sum_i z[b,i] * g[b,i]
//
// The first replaces the TPU kernel `_quad_only_kernel`
// (muse_tpu/ops/pallas_grf.py:137, launched by `_quad_only_impl`,
// pallas_grf.py:150): its K = 1 launch is that kernel, and K > 1 weights
// are read beside z in the same pass, so that every θ-derivative of a GRF
// score (one weight per θ component) costs one read of z. The second
// replaces `_quadform_kernel` (pallas_grf.py:73, launched by
// `_quadform_fwd_impl`, pallas_grf.py:100), the fused value +
// half-gradient that the diagonal PCG of the packed GRF uses as its
// operator and curvature in one read of p. The TPU kernels walk the row
// tiles of a lane in order and carry the sum in a VMEM accumulator; here
// blocks run in parallel and in no order, so the sum is split:
//
//   pass 1  the quadforms: grid (S slabs, ceil(B / G) lane groups); each
//           block reads one slab of kSlab = 8192 floats of each of its G
//           lanes (the ragged last group masks the lanes past B) and of
//           each of the K weights, and reduces every (lane, weight) sum
//           with a fixed warp/block tree into one partial of a (B, K, S)
//           scratch. Each weight float4 is loaded once for the block's G
//           lanes, which cuts the weights' L2 traffic by G. G = 1 at K = 1
//           (the one weight is 1/B of the bytes) and G = 2 at K >= 2: a
//           sweep on the H100 over G = 1, 2, 4, 8, the loop's unroll and
//           the blocks per SM found wider groups slower, their G*K
//           registers of sums cutting the blocks in flight. z is streamed
//           past L2 (evict-first loads), where the weights stay.
//           The fused kernel: grid (S, B), one lane a block.
//   pass 2  grid (B*K): one block per (lane, weight) sums its S partials
//           with the same fixed tree.
//
// No float atomics: every sum is taken in an order fixed by L alone. Each
// (lane, weight) sum has its own register and takes its terms in the order
// that a K = 1 launch takes them, whatever its lane's place in its block
// and whether the loads are float4 or scalar (misaligned or L % 4 != 0).
// So two launches on the same inputs are bitwise equal, a K-weight launch is
// bitwise equal to K launches at K = 1, and a lane's value does not depend
// on how many lanes share the launch. The tree also keeps the rounding
// error of the ~1e6-term sum near log2(L)*eps instead of the L*eps of a
// sequential f32 sum.
//
// The fused kernel writes g from the same pass. g is one IEEE multiply
// z*w, bitwise equal to PyTorch's `z * w` (the library is built without
// --use_fast_math); the sum takes z*g.
//
// Bound: memory. The quadforms read B*L*4 bytes of z and K*L*4 bytes of
// weights and write B*K*4 bytes: at B=101, n=1024 (L=1,050,624) that is
// ~424 MB at K = 1 (~0.127 ms at 3.35 TB/s) and ~429 MB at K = 2
// (~0.128 ms); the operations, B*L*(1 + 2K), are far below the float32
// peak. The fused kernel also writes B*L*4 bytes of g: at B=128 it reads
// 537.9 MB of z and 4.2 MB of w and writes 537.9 MB, ~1.08 GB, i.e.
// ~0.32 ms. Pass 2 reads B*K*S*4 bytes, negligible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr long long kSlab = 8192;      // floats per (lane, slab); % 4 == 0
constexpr int kMaxWeights = 4;         // K of one quadforms launch

// Lanes per block of the quadforms kernel at K weights (see the note).
constexpr int lanes_per_block(int K) { return K == 1 ? 1 : 2; }

// NV sums over the block, each valid in thread 0. Fixed order: a shuffle
// tree in each warp, then a shuffle tree over the warp sums in warp 0. Each
// value takes the same tree whatever NV.
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

// One sum over the block, valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float (*smem)[32]) {
  float a[1] = {v};
  block_sums<1>(a, smem);
  return a[0];
}

__device__ __forceinline__ float4 load4(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

// Pass 1 of the K-weight quadforms: block (s, y) takes slab s of the G
// lanes y*G ... y*G + G - 1 (those below B) and writes one partial per
// (lane, weight) into the (B, K, S) scratch. Thread t takes the groups
// of four floats t, t + kThreads, ... of the slab, the four in order, then
// (the thread that owns the group after the last whole one) the ragged
// tail: every (lane, weight) sum takes its terms in this one order, whatever
// K, the lane's place in the block and the load width.
template <int K, int G>
__global__ void __launch_bounds__(kThreads)
quad_partial_kernel(const float* __restrict__ z, const float* __restrict__ W,
                    float* __restrict__ partial, long long B, long long L,
                    int S) {
  __shared__ float smem[G * K][32];
  const int s = blockIdx.x;
  const long long b0 = (long long)blockIdx.y * G;
  const int nb = (B - b0 < G) ? (int)(B - b0) : G;
  const long long start = (long long)s * kSlab;
  const long long len = (L - start < kSlab) ? L - start : kSlab;
  const long long nvec = len >> 2;
  const float* zs = z + b0 * L + start;   // lane b0 + g at zs + g*L
  const float* ws = W + start;            // weight k at ws + k*L
  // float4 loads where every lane and weight row is 16-byte aligned (start
  // is a multiple of 4), four scalar loads otherwise: the same sums
  const bool vec = (L & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(W)) &
       15u) == 0;

  float acc[G * K];
#pragma unroll
  for (int i = 0; i < G * K; ++i) acc[i] = 0.0f;

#pragma unroll 1
  for (long long j = threadIdx.x; j < nvec; j += kThreads) {
    float4 c[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      c[k] = vec ? __ldg(reinterpret_cast<const float4*>(ws + k * L) + j)
                 : load4(ws + k * L + 4 * j);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < nb) {
        // z is read once: stream it past L2, where the weights stay
        const float4 a =
            vec ? __ldcs(reinterpret_cast<const float4*>(zs + g * L) + j)
                : load4(zs + g * L + 4 * j);
        const float x2 = a.x * a.x, y2 = a.y * a.y, z2 = a.z * a.z,
                    w2 = a.w * a.w;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float t = acc[g * K + k];
          t = fmaf(x2, c[k].x, t);
          t = fmaf(y2, c[k].y, t);
          t = fmaf(z2, c[k].z, t);
          t = fmaf(w2, c[k].w, t);
          acc[g * K + k] = t;
        }
      }
    }
  }
  if ((long long)threadIdx.x == nvec % kThreads) {
    for (long long i = nvec << 2; i < len; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < nb) {
          const float a = zs[g * L + i];
          const float a2 = a * a;
#pragma unroll
          for (int k = 0; k < K; ++k)
            acc[g * K + k] = fmaf(a2, ws[k * L + i], acc[g * K + k]);
        }
      }
    }
  }

  block_sums<G * K>(acc, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < nb) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          partial[((b0 + g) * K + k) * S + s] = acc[g * K + k];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
quadgrad_partial_kernel(const float* __restrict__ z, const float* __restrict__ w,
                        float* __restrict__ g, float* __restrict__ partial,
                        long long L, int S) {
  __shared__ float smem[1][32];
  const int s = blockIdx.x;
  const long long b = blockIdx.y;
  const float* zb = z + b * L;
  float* gb = g + b * L;
  const long long start = (long long)s * kSlab;
  const long long stop = (start + kSlab < L) ? start + kSlab : L;

  float acc = 0.0f;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(zb) | reinterpret_cast<uintptr_t>(gb) |
        reinterpret_cast<uintptr_t>(w)) & 15u) == 0;
  long long tail = start;
  if (aligned) {
    const long long nvec = (stop - start) >> 2;
    const float4* z4 = reinterpret_cast<const float4*>(zb + start);
    const float4* w4 = reinterpret_cast<const float4*>(w + start);
    float4* g4 = reinterpret_cast<float4*>(gb + start);
#pragma unroll 4
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      const float4 a = z4[i];
      const float4 c = __ldg(w4 + i);
      float4 p;
      p.x = __fmul_rn(a.x, c.x);
      p.y = __fmul_rn(a.y, c.y);
      p.z = __fmul_rn(a.z, c.z);
      p.w = __fmul_rn(a.w, c.w);
      g4[i] = p;
      acc = fmaf(a.x, p.x, acc);
      acc = fmaf(a.y, p.y, acc);
      acc = fmaf(a.z, p.z, acc);
      acc = fmaf(a.w, p.w, acc);
    }
    tail = start + (nvec << 2);
  }
  for (long long i = tail + threadIdx.x; i < stop; i += kThreads) {
    const float a = zb[i];
    const float p = __fmul_rn(a, __ldg(w + i));
    gb[i] = p;
    acc = fmaf(a, p, acc);
  }

  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) partial[b * S + s] = acc;
}

__global__ void __launch_bounds__(kThreads)
quad_finalize_kernel(const float* __restrict__ partial, float* __restrict__ out, int S) {
  __shared__ float smem[1][32];
  const long long b = blockIdx.x;
  float acc = 0.0f;
  for (int s = threadIdx.x; s < S; s += kThreads) acc += partial[b * S + s];
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) out[b] = acc;
}

template <int K>
void launch_partial(const float* z, const float* W, float* partial,
                    long long B, long long L, int S, cudaStream_t st) {
  constexpr int G = lanes_per_block(K);
  quad_partial_kernel<K, G><<<dim3((unsigned)S, (unsigned)((B + G - 1) / G)),
                              kThreads, 0, st>>>(z, W, partial, B, L, S);
}

}  // namespace

extern "C" {

// Floats per slab: the wrapper sizes the scratch as S = ceil(L / slab).
long long muse_spectrum_quadform_slab(void) { return kSlab; }

// The most weights one muse_spectrum_quadforms_f32 launch takes.
int muse_spectrum_quadforms_max_weights(void) { return kMaxWeights; }

// z: (B, L) f32, W: (K, L) f32, partial: (B, K, S) f32 scratch, out: (B, K)
// f32, 1 <= K <= kMaxWeights. Launches both passes on `stream` and returns
// cudaGetLastError() (0 = ok).
int muse_spectrum_quadforms_f32(const float* z, const float* W, float* partial,
                                float* out, long long B, int K, long long L,
                                int S, void* stream) {
  if (B <= 0 || B > 65535 || K < 1 || K > kMaxWeights || L <= 0 || S <= 0 ||
      (long long)S * kSlab < L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: launch_partial<1>(z, W, partial, B, L, S, st); break;
    case 2: launch_partial<2>(z, W, partial, B, L, S, st); break;
    case 3: launch_partial<3>(z, W, partial, B, L, S, st); break;
    default: launch_partial<4>(z, W, partial, B, L, S, st); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quad_finalize_kernel<<<(unsigned)(B * K), kThreads, 0, st>>>(partial, out, S);
  return (int)cudaGetLastError();
}

// z: (B, L) f32, w: (L,) f32, g: (B, L) f32 out, partial: (B, S) f32
// scratch, out: (B,) f32. Same contract as muse_spectrum_quadforms_f32.
int muse_spectrum_quadform_and_grad_f32(const float* z, const float* w, float* g,
                                        float* partial, float* out, long long B,
                                        long long L, int S, void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || S <= 0 || (long long)S * kSlab < L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  quadgrad_partial_kernel<<<dim3((unsigned)S, (unsigned)B), kThreads, 0, st>>>(
      z, w, g, partial, L, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quad_finalize_kernel<<<(unsigned)B, kThreads, 0, st>>>(partial, out, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
