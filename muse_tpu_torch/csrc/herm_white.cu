// The packed hermitian white draw for Hopper (sm_90a), for B lanes at once:
//
//   muse_herm_white_f32   out_p[b, j - start] = W_p(seed_b)[j] for the
//                         packed coordinates j in [start, start + count) of
//                         each drawn part p
//
// A lane's draw is what a fresh torch.Generator(device="cuda") seeded with
// seed_b gives through the per-lane loop of the packed GRF models
// (ops/herm_white.py `herm_white_draw`, once a part): for each part two
// float32 torch.randn((n, m)) calls, m = n/2 + 1, g then h, and
//
//   re = a*g + b*flip(g),  im = c*h + d*flip(h),  flip(v)[r] = v[(n - r) % n]
//
// with the coefficient planes (a, b, c, d) of `_herm_white_coeffs`, the part
// packed as [re | im] (L = 2*n*m floats). Every float is bitwise the loop's:
// the benchmark's reference redraws lanes with torch's own generator.
//
// It replaces no TPU kernel. In muse_tpu the sampler is jax.random under
// vmap, one XLA program; in the port the loop dispatched ~26 small launches
// a lane from the host, one lane at a time, which made the sampler the
// largest block of idle device time of a 512-sim fit. This kernel draws all
// lanes of a call in one launch.
//
// torch's stream. randn on a CUDA generator launches
// distribution_elementwise_grid_stride_kernel (ATen/native/cuda/
// DistributionTemplates.h): thread t of T = 256 * grid threads, grid =
// min(SMs * maxThreadsPerSM / 256, ceil(numel / 256)), runs
// curand_init(seed, t, offset) and then, for each grid-stride step s of
// S = (numel - 1) / (4T) + 1, one curand_normal4 whose component k is
// element s*4T + k*T + t, written as rand*1 + 0. The call then advances the
// generator's offset by 4S. So element e of a lane's call number q (counted
// from the generator's first call) is component k of the Philox4x32-10
// block at counter q*S + s of subsequence t under the key seed. The host
// mirrors T and S (ops/herm_white.py `randn_policy`) from the card's SM
// count and threads per SM. The kernel evaluates that block and its
// Box-Muller pairs with the toolkit's own device functions that
// curand_init + curand_normal4 are made of (curand_Philox4x32_10 on the
// counter (q*S + s, t) and key, _curand_box_muller on words (x, y) for
// components 0-1 and (z, w) for 2-3), so every normal is the same
// instructions on the same words. It leaves out what torch's thread
// computes and throws away: curand4's look-ahead block for a next step
// that a one-step call never takes, and a pair whose elements lie past
// the call's end (at n = 1024, T = 270,336 and numel = 525,312: pair 1 of
// every thread). That took the kernel from 1.25 to 0.74 ms at 128 lanes,
// bitwise the same (H100, one part).
//
// Design. Grid (T / 256, ceil(B / kLanes)): thread t plays torch's thread
// t for each call of kLanes lanes. Each normal lands on its packed
// coordinate at once: neighbouring threads write neighbouring floats, and
// no normal goes through memory before the combine. The flip partner
// (n - r) % n of a row lies in another thread, so a thread evaluates it
// itself, but only where it can change the result: where the mirror
// coefficient is non-zero, or where the own term rounds to -0 (then the
// sign of the zero mirror term decides the sign of the sum). Elsewhere
// a*g + 0*flip(g) rounds to a*g whatever flip(g) is. With the GRF's
// coefficients that is the mirrored rows of columns 0 and m - 1, ~2n of
// the n*m floats of a plane (a self-mirrored row is its own partner).
// Products and the sum round as the plain path's separate mul and add do
// (__fmul_rn, __fadd_rn: no contraction into an FMA). The library is built
// without --use_fast_math, as torch is.
//
// Launches: one a call, whatever B and the parts drawn. Memory: the outputs
// only, written once; no scratch.
//
// Bound: the random numbers' arithmetic, then memory. The draw writes
// B*count*4 bytes a part: at n = 1024 a whole part is L = 1,050,624 floats,
// so B = 128 lanes write 537.9 MB, ~0.161 ms at 3.35 TB/s. It reads the
// four (n, m) coefficient planes (8.4 MB, L2-resident) and B seeds. But
// torch's mapping asks for one Philox block (10 rounds of two 32-bit
// multiplies) per thread and call, T blocks for numel floats (1.94 floats a
// block at n = 1024), and a Box-Muller pair (logf, sqrtf, __sincosf) per
// two floats: on the H100, alone and without a store, one part's blocks
// take ~0.12 ms and its pairs ~0.07 ms of issue at 128 lanes, and the
// stream cannot be drawn from fewer of them.

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // torch's block_size_bound
constexpr int kLanes = 4;       // lanes a thread plays

// torch's normal transform rand*std + mean at std = 1, mean = 0: rand,
// with -0 taken to +0 (fused or not, -0*1 + 0 rounds to +0).
__device__ __forceinline__ float torch_normal(float r) { return r + 0.0f; }

// The Philox block that curand_init(seed, t, 4*ctr) + curand_normal4
// turns into normals.
__device__ __forceinline__ uint4 philox_block(uint2 key, unsigned t,
                                              unsigned long long ctr) {
  return curand_Philox4x32_10(
      make_uint4((unsigned)ctr, (unsigned)(ctr >> 32), t, 0u), key);
}

// The normal that torch's randn writes at element e of the call whose
// first counter is `ctr0` (= the call's number * S), evaluated afresh.
__device__ float normal_at(uint2 key, unsigned e, unsigned T,
                           unsigned long long ctr0) {
  const unsigned s = e / (4u * T);
  const unsigned rem = e - s * 4u * T;
  const unsigned k = rem / T;
  const uint4 x = philox_block(key, rem - k * T, ctr0 + s);
  const float2 v = k < 2 ? _curand_box_muller(x.x, x.y)
                         : _curand_box_muller(x.z, x.w);
  return torch_normal((k & 1) ? v.y : v.x);
}

__global__ void __launch_bounds__(kThreads)
herm_white_kernel(const long long* __restrict__ seeds,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, const float* __restrict__ d,
                  float* __restrict__ out0, float* __restrict__ out1, int B,
                  int n, unsigned T, int S, int call0, int ncalls,
                  long long start, long long count) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const unsigned m = n / 2 + 1;
  const unsigned N = (unsigned)n * m;            // floats of one randn call
  const int lane1 = min(B, (int)(blockIdx.y + 1) * kLanes);
  for (int lane = blockIdx.y * kLanes; lane < lane1; ++lane) {
    const unsigned long long seed = (unsigned long long)seeds[lane];
    const uint2 key = make_uint2((unsigned)seed, (unsigned)(seed >> 32));
    for (int q = 0; q < ncalls; ++q) {
      const int call = call0 + q;
      const int half = call & 1;                 // g → re, h → im
      const float* own = half ? c : a;
      const float* mir = half ? d : b;
      float* out = (q < 2 ? out0 : out1) + (long long)lane * count;
      const long long base = (long long)half * N - start;
      const unsigned long long ctr0 = (unsigned long long)call * S;
      for (int s = 0; s < S; ++s) {
        const uint4 x = philox_block(key, t, ctr0 + s);
#pragma unroll
        for (int p = 0; p < 2; ++p) {            // components 2p, 2p + 1
          const unsigned e0 = (unsigned)s * 4u * T + 2u * p * T + t;
          if (e0 >= N) break;
          const float2 v = p ? _curand_box_muller(x.z, x.w)
                             : _curand_box_muller(x.x, x.y);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const unsigned e = e0 + i * T;
            const long long j = base + e;
            if (e >= N || j < 0 || j >= count) continue;
            const float g = torch_normal(i ? v.y : v.x);
            const float ag = __fmul_rn(__ldg(own + e), g);
            const float bm = __ldg(mir + e);
            float val = ag;
            if (bm != 0.0f || (ag == 0.0f && signbit(ag))) {
              const unsigned r = e / m;
              const unsigned pe = ((n - r) % n) * m + (e - r * m);
              const float fg = pe == e ? g : normal_at(key, pe, T, ctr0);
              val = __fadd_rn(ag, __fmul_rn(bm, fg));
            }
            out[j] = val;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// seeds: (B,) int64, each a lane generator's 64-bit seed; a, b, c, d: the
// (n, n/2 + 1) f32 coefficient planes; out0, out1: (B, count) f32 outputs of
// the first and second part drawn (out1 unused with one part). T, S: torch's
// threads and grid-stride steps for one (n, n/2 + 1) randn on this card;
// call0 = 2 * first part drawn; ncalls = 2 * parts drawn (2 or 4); [start,
// start + count) the packed coordinates written. Launches on `stream` and
// returns cudaGetLastError() (0 = ok).
int muse_herm_white_f32(const long long* seeds, const float* a, const float* b,
                        const float* c, const float* d, float* out0,
                        float* out1, long long B, int n, long long T, int S,
                        int call0, int ncalls, long long start,
                        long long count, void* stream) {
  const long long N = (long long)n * (n / 2 + 1);
  if (B <= 0 || (B + kLanes - 1) / kLanes > 65535 || n <= 0 || T <= 0 ||
      T % kThreads != 0 || S != (N - 1) / (4 * T) + 1 ||
      (long long)S * 4 * T > 0xffffffffLL ||
      call0 < 0 || (call0 & 1) || (ncalls != 2 && ncalls != 4) ||
      (ncalls == 4 && out1 == nullptr) || start < 0 || count <= 0 ||
      start + count > 2 * N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  herm_white_kernel<<<dim3((unsigned)(T / kThreads),
                           (unsigned)((B + kLanes - 1) / kLanes)),
                      kThreads, 0, st>>>(seeds, a, b, c, d, out0, out1,
                                         (int)B, n, (unsigned)T, S, call0,
                                         ncalls, start, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
