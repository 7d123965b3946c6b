// Spectrum quadforms for Hopper (sm_90a), over the L = n*2m packed re|im
// coordinates of each lane b:
//
//   muse_spectrum_quadform_f32           quad[b] = sum_i z[b,i]^2 * w[i]
//   muse_spectrum_quadform_and_grad_f32  g[b,i] = z[b,i] * w[i] and
//                                        quad[b] = sum_i z[b,i] * g[b,i]
//
// The first replaces the TPU kernel `_quad_only_kernel`
// (muse_tpu/ops/pallas_grf.py:137, launched by `_quad_only_impl`,
// pallas_grf.py:150); the second replaces `_quadform_kernel`
// (pallas_grf.py:73, launched by `_quadform_fwd_impl`, pallas_grf.py:100),
// the fused value + half-gradient that the diagonal PCG of the packed GRF
// uses as its operator and curvature in one read of p. The TPU kernels
// walk the row tiles of a lane in order and carry the sum in a VMEM
// accumulator; here blocks run in parallel and in no order, so the sum is
// split:
//
//   pass 1  grid (S slabs, B lanes): each block reads one slab of
//           kSlab = 8192 floats of one lane (float4 loads where the lane is
//           16-byte aligned, scalar loads for the ragged tail and for
//           misaligned lanes), reduces it with a fixed warp/block tree and
//           writes one partial into a (B, S) scratch;
//   pass 2  grid (B): one block per lane sums its S partials with the same
//           fixed tree.
//
// No float atomics: every sum is taken in an order fixed by the shapes
// alone, so two launches on the same inputs give bitwise-equal results, and
// a lane's value does not depend on how many lanes share the launch (S
// depends on L only). The tree also keeps the rounding error of the ~1e6-term
// sum near log2(L)*eps instead of the L*eps of a sequential f32 sum.
//
// The fused kernel writes g from the same pass. g is one IEEE multiply
// z*w, bitwise equal to PyTorch's `z * w` (the library is built without
// --use_fast_math); the sum takes z*g.
//
// Bound: memory. Pass 1 reads B*L*4 bytes of z and L*4 bytes of w (w is
// re-read by every lane and stays in the 50 MB L2). At B=101, n=1024
// (L=1,050,624) that is ~424 MB, i.e. ~0.13 ms at 3.35 TB/s. The fused
// kernel also writes B*L*4 bytes of g: at B=128 it reads 537.9 MB of z and
// 4.2 MB of w and writes 537.9 MB, ~1.08 GB, i.e. ~0.32 ms. Pass 2 reads
// B*S*4 bytes, negligible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr long long kSlab = 8192;      // floats per (lane, slab) block; % 4 == 0

// Sum of v over the block, valid in thread 0. Fixed order: a shuffle tree in
// each warp, then a shuffle tree over the warp sums in warp 0.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x >> 5)) ? smem[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
quad_partial_kernel(const float* __restrict__ z, const float* __restrict__ w,
                    float* __restrict__ partial, long long L, int S) {
  __shared__ float smem[32];
  const int s = blockIdx.x;
  const long long b = blockIdx.y;
  const float* zb = z + b * L;
  const long long start = (long long)s * kSlab;
  const long long stop = (start + kSlab < L) ? start + kSlab : L;

  float acc = 0.0f;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(zb) | reinterpret_cast<uintptr_t>(w)) & 15u) == 0;
  long long tail = start;
  if (aligned) {
    // start is a multiple of 4, so zb + start and w + start stay aligned
    const long long nvec = (stop - start) >> 2;
    const float4* z4 = reinterpret_cast<const float4*>(zb + start);
    const float4* w4 = reinterpret_cast<const float4*>(w + start);
#pragma unroll 4
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      const float4 a = z4[i];
      const float4 c = __ldg(w4 + i);
      acc = fmaf(a.x * a.x, c.x, acc);
      acc = fmaf(a.y * a.y, c.y, acc);
      acc = fmaf(a.z * a.z, c.z, acc);
      acc = fmaf(a.w * a.w, c.w, acc);
    }
    tail = start + (nvec << 2);
  }
  for (long long i = tail + threadIdx.x; i < stop; i += kThreads) {
    const float a = zb[i];
    acc = fmaf(a * a, __ldg(w + i), acc);
  }

  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) partial[b * S + s] = acc;
}

__global__ void __launch_bounds__(kThreads)
quadgrad_partial_kernel(const float* __restrict__ z, const float* __restrict__ w,
                        float* __restrict__ g, float* __restrict__ partial,
                        long long L, int S) {
  __shared__ float smem[32];
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
  __shared__ float smem[32];
  const long long b = blockIdx.x;
  float acc = 0.0f;
  for (int s = threadIdx.x; s < S; s += kThreads) acc += partial[b * S + s];
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) out[b] = acc;
}

}  // namespace

extern "C" {

// Floats per slab: the wrapper sizes the (B, S) scratch as S = ceil(L / slab).
long long muse_spectrum_quadform_slab(void) { return kSlab; }

// z: (B, L) f32, w: (L,) f32, partial: (B, S) f32 scratch, out: (B,) f32.
// Launches both passes on `stream` and returns cudaGetLastError() (0 = ok).
int muse_spectrum_quadform_f32(const float* z, const float* w, float* partial,
                               float* out, long long B, long long L, int S,
                               void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || S <= 0 || (long long)S * kSlab < L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  quad_partial_kernel<<<dim3((unsigned)S, (unsigned)B), kThreads, 0, st>>>(
      z, w, partial, L, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quad_finalize_kernel<<<(unsigned)B, kThreads, 0, st>>>(partial, out, S);
  return (int)cudaGetLastError();
}

// z: (B, L) f32, w: (L,) f32, g: (B, L) f32 out, partial: (B, S) f32
// scratch, out: (B,) f32. Same contract as muse_spectrum_quadform_f32.
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
