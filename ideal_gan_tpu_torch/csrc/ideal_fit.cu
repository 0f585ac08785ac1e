// IDEAL water/fat map fit, one thread per voxel.
//
// Replaces the TPU kernel `_fit_kernel` of ideal_gan_tpu/ops/pallas_ideal.py
// (launched there by `fit_rho_planar` and `fit_rho_fused`). Per voxel v of
// batch row b it computes
//
//   rho_s(v) = (1/rho_sc) * sum_e Mp[b][s][e] * exp(-2*pi*i*te_e*xi(v)) * S_e(v)
//   xi(v)    = phi(v)*fm_sc + i*r2(v)*r2_sc/(2*pi)
//
// i.e. demodulate each echo by its phasor (a rotation that grows by
// exp(+te*R2*)) and contract with the pseudo-inverse Mp of the ne x ns model
// matrix. With a uniformly spaced TE train the phasors follow the recurrence
// W_e = W_{e-1} * exp(-2*pi*i*dTE*xi): two sincos/exp per voxel instead of
// one per echo. `mode` picks the form: 0 per-echo, 1 recurrence (the
// caller vouches for uniform spacing), 2 decide per batch row in the block
// from te itself, with the JAX package's test (all spacings within 1e-9 s of
// the first, in double) -- no host round trip to inspect te.
//
// Bound on an H100: memory. At ne=6, ns=2 in float32 a voxel reads
// 4*(2*ne + 2) = 56 bytes and writes 4*2*ns = 16 bytes: 72 B/voxel against
// about 70 FMAs and 2-12 transcendentals, far below the card's
// operations-per-byte balance. At bench.py's shape (nb=128, 384^2,
// 18.9 M voxels) that is 1.36 GB, or about 0.41 ms at 3.35 TB/s. bf16
// echoes plus bf16 rho bring it to 40 B/voxel.
//
// Design: one thread per voxel so every load and store is a contiguous
// (or stride-2 for the interleaved MEBCRN layout) sweep across a warp; the
// per-row Mp (2*ns*ne floats) and te (ne floats) sit in shared memory; ne
// is a template parameter so the echo loop unrolls into straight-line FMAs.
// Echo loads accept float32 or bfloat16 and the math is always float32;
// stores follow the output type. Strides are passed in elements, so the
// same kernel reads planar (nb, ne, H, W) buffers and the interleaved
// (nb, ne, H, W, 2) layout without a copy.
//
// CUDA rather than Triton: the same nvcc/ctypes build serves all of the
// port's kernels, and the phasor code is shared with ideal_cycle.cu
// (ideal_phasor.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ideal_phasor.cuh"

namespace {

using ideal::kNs;
using ideal::kThreads;

struct FitArgs {
  const void* s_re;
  const void* s_im;
  const float* phi;
  const float* r2;
  const float* mp;   // (nb, 2*ns*ne): [(s*ne + e)*2 + {re, im}]
  const float* te;   // (nb, ne)
  void* r_re;
  void* r_im;
  long long nvox;
  long long s_b, s_e, s_v;  // echo strides (elements)
  long long p_b, p_v;       // phi / r2 strides
  long long r_b, r_s, r_v;  // output strides
  float fm_sc, r2_sc, inv_rho;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int NE, typename TIn, typename TOut, int MODE>
__global__ void __launch_bounds__(kThreads) fit_kernel(FitArgs a) {
  __shared__ float sm_mp[2 * kNs * NE];
  __shared__ float sm_te[NE];
  __shared__ bool sm_uniform;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * kNs * NE; i += blockDim.x)
    sm_mp[i] = a.mp[b * 2 * kNs * NE + i];
  for (int i = threadIdx.x; i < NE; i += blockDim.x)
    sm_te[i] = a.te[b * NE + i];
  if (MODE == 2 && threadIdx.x == 0)
    sm_uniform = ideal::te_is_uniform<NE>(a.te + b * NE);
  __syncthreads();
  const bool uniform = MODE == 1 || (MODE == 2 && sm_uniform);

  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= a.nvox) return;
  const float phi = a.phi[b * a.p_b + v * a.p_v] * a.fm_sc;
  const float r2 = a.r2[b * a.p_b + v * a.p_v] * a.r2_sc;
  const TIn* pre = static_cast<const TIn*>(a.s_re) + b * a.s_b + v * a.s_v;
  const TIn* pim = static_cast<const TIn*>(a.s_im) + b * a.s_b + v * a.s_v;

  float c = 0.f, s = 0.f, dc = 0.f, ds = 0.f;
  if (uniform) {
    ideal::phasor(-1.f, sm_te[0], phi, r2, c, s);
    ideal::phasor(-1.f, sm_te[1] - sm_te[0], phi, r2, dc, ds);
  }

  float acc[kNs][2];
#pragma unroll
  for (int sp = 0; sp < kNs; ++sp) acc[sp][0] = acc[sp][1] = 0.f;

#pragma unroll
  for (int e = 0; e < NE; ++e) {
    if (!uniform) ideal::phasor(-1.f, sm_te[e], phi, r2, c, s);
    const float sre = load(pre + e * a.s_e);
    const float sim = load(pim + e * a.s_e);
    const float yre = c * sre - s * sim;
    const float yim = c * sim + s * sre;
#pragma unroll
    for (int sp = 0; sp < kNs; ++sp) {
      const float mre = sm_mp[(sp * NE + e) * 2];
      const float mim = sm_mp[(sp * NE + e) * 2 + 1];
      acc[sp][0] += mre * yre - mim * yim;
      acc[sp][1] += mre * yim + mim * yre;
    }
    if (uniform && e < NE - 1) ideal::rotate(c, s, dc, ds);
  }

  TOut* ore = static_cast<TOut*>(a.r_re) + b * a.r_b + v * a.r_v;
  TOut* oim = static_cast<TOut*>(a.r_im) + b * a.r_b + v * a.r_v;
#pragma unroll
  for (int sp = 0; sp < kNs; ++sp) {
    store(ore + sp * a.r_s, acc[sp][0] * a.inv_rho);
    store(oim + sp * a.r_s, acc[sp][1] * a.inv_rho);
  }
}

template <int NE, typename TIn, typename TOut>
void launch_typed(const FitArgs& a, int nb, int mode, cudaStream_t st) {
  const dim3 grid((unsigned)((a.nvox + kThreads - 1) / kThreads), nb);
  if (mode == 0)
    fit_kernel<NE, TIn, TOut, 0><<<grid, kThreads, 0, st>>>(a);
  else if (mode == 1)
    fit_kernel<NE, TIn, TOut, 1><<<grid, kThreads, 0, st>>>(a);
  else
    fit_kernel<NE, TIn, TOut, 2><<<grid, kThreads, 0, st>>>(a);
}

template <int NE>
void launch_ne(const FitArgs& a, int nb, int in_bf16, int out_bf16,
               int mode, cudaStream_t st) {
  if (in_bf16 && out_bf16)
    launch_typed<NE, __nv_bfloat16, __nv_bfloat16>(a, nb, mode, st);
  else if (in_bf16)
    launch_typed<NE, __nv_bfloat16, float>(a, nb, mode, st);
  else if (out_bf16)
    launch_typed<NE, float, __nv_bfloat16>(a, nb, mode, st);
  else
    launch_typed<NE, float, float>(a, nb, mode, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); 1001 for an echo
// count outside 2..12 (the caller checks).
extern "C" int ideal_fit(const void* s_re, const void* s_im, const float* phi,
                         const float* r2, const float* mp, const float* te,
                         void* r_re, void* r_im, int nb, int ne,
                         long long nvox, long long s_b, long long s_e,
                         long long s_v, long long p_b, long long p_v,
                         long long r_b, long long r_s, long long r_v,
                         int in_bf16, int out_bf16, int mode, float fm_sc,
                         float r2_sc, float rho_sc, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FitArgs a{s_re, s_im, phi, r2, mp, te, r_re, r_im, nvox, s_b, s_e, s_v,
            p_b, p_v, r_b, r_s, r_v, fm_sc, r2_sc, 1.0f / rho_sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ne) {
#define IDEAL_FIT_CASE(N) \
  case N:                 \
    launch_ne<N>(a, nb, in_bf16, out_bf16, mode, st); \
    break;
    IDEAL_FIT_CASE(2) IDEAL_FIT_CASE(3) IDEAL_FIT_CASE(4) IDEAL_FIT_CASE(5)
    IDEAL_FIT_CASE(6) IDEAL_FIT_CASE(7) IDEAL_FIT_CASE(8) IDEAL_FIT_CASE(9)
    IDEAL_FIT_CASE(10) IDEAL_FIT_CASE(11) IDEAL_FIT_CASE(12)
#undef IDEAL_FIT_CASE
    default:
      return 1001;
  }
  return (int)cudaGetLastError();
}
