// IDEAL forward synthesis, one thread per voxel.
//
// Replaces the TPU kernel `_forward_kernel` of ideal_gan_tpu/ops/pallas_ideal.py
// (launched there by `synthesize_fused`). Per voxel v of batch row b it
// computes
//
//   S_e(v)  = exp(+2*pi*i*te_e*xi(v)) * sum_s M[b][e][s] * (rho_sc*rho_s(v))
//   xi(v)   = phi(v)*fm_sc + i*max(r2(v), 0)*r2_sc/(2*pi)
//
// the B -> A synthesis of the TE-augmentation trainer: echoes from the
// water/fat maps and the (field map, R2*) row at a sampled TE train. The
// clamp of R2* at 0 is part of the function (physics.synthesize has it; the
// cycle kernel, which reads a fitted R2*, has none). `mode` picks the phasor
// form as in ideal_fit.cu: 0 one sincos/exp per echo, 1 the uniform-TE
// recurrence, 2 decided per batch row on the card from te.
//
// Bound on an H100: memory. At ne=6, ns=2 in float32 a voxel reads
// 4*(2*ns + 2) = 24 bytes and writes 4*2*ne = 48 bytes: 72 B/voxel against
// about 50 FMAs and 2-12 transcendentals, far below the card's
// operations-per-byte balance. At the trainer's shape (nb=8, 384^2) that is
// 84.9 MB, or 0.0253 ms at 3.35 TB/s.
//
// Design: the fit and cycle kernels' (one thread per voxel, per-row M and te
// in shared memory, ne a template parameter so the echo loop unrolls).
// Strides are in elements, so the kernel reads the interleaved MEBCRN maps
// (nb, 3, H, W, 2) and writes the echoes (nb, ne, H, W, 2) in place. Math is
// float32 with the full-precision sincosf/expf of ideal_phasor.cuh (the JAX
// kernel is held to rtol 1e-4 / atol 1e-5). The backward is not a kernel:
// autograd through the plain version, as in the JAX package.

#include <cuda_runtime.h>

#include "ideal_phasor.cuh"

namespace {

using ideal::kNs;
using ideal::kThreads;

struct ForwardArgs {
  const float* r_re;
  const float* r_im;
  const float* phi;
  const float* r2;
  const float* m;    // (nb, 2*ne*ns): [(e*ns + s)*2 + {re, im}]
  const float* te;   // (nb, ne)
  float* o_re;
  float* o_im;
  long long nvox;
  long long r_b, r_s, r_v;  // rho strides (elements)
  long long p_b, p_v;       // phi / r2 strides
  long long o_b, o_e, o_v;  // echo strides
  float fm_sc, r2_sc, rho_sc;
};

template <int NE, int MODE>
__global__ void __launch_bounds__(kThreads) synth_kernel(ForwardArgs a) {
  __shared__ float sm_m[2 * kNs * NE];
  __shared__ float sm_te[NE];
  __shared__ bool sm_uniform;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * kNs * NE; i += blockDim.x)
    sm_m[i] = a.m[b * 2 * kNs * NE + i];
  for (int i = threadIdx.x; i < NE; i += blockDim.x)
    sm_te[i] = a.te[b * NE + i];
  if (MODE == 2 && threadIdx.x == 0)
    sm_uniform = ideal::te_is_uniform<NE>(a.te + b * NE);
  __syncthreads();
  const bool uniform = MODE == 1 || (MODE == 2 && sm_uniform);

  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= a.nvox) return;
  const float phi = a.phi[b * a.p_b + v * a.p_v] * a.fm_sc;
  const float r2 = fmaxf(a.r2[b * a.p_b + v * a.p_v], 0.f) * a.r2_sc;
  const float* pre = a.r_re + b * a.r_b + v * a.r_v;
  const float* pim = a.r_im + b * a.r_b + v * a.r_v;
  float rho[kNs][2];
#pragma unroll
  for (int sp = 0; sp < kNs; ++sp) {
    rho[sp][0] = pre[sp * a.r_s] * a.rho_sc;
    rho[sp][1] = pim[sp * a.r_s] * a.rho_sc;
  }

  float c = 0.f, s = 0.f, dc = 0.f, ds = 0.f;
  if (uniform) {
    ideal::phasor(1.f, sm_te[0], phi, r2, c, s);
    ideal::phasor(1.f, sm_te[1] - sm_te[0], phi, r2, dc, ds);
  }
  float* ore = a.o_re + b * a.o_b + v * a.o_v;
  float* oim = a.o_im + b * a.o_b + v * a.o_v;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    if (!uniform) ideal::phasor(1.f, sm_te[e], phi, r2, c, s);
    float zre = 0.f, zim = 0.f;
#pragma unroll
    for (int sp = 0; sp < kNs; ++sp) {
      const float mre = sm_m[(e * kNs + sp) * 2];
      const float mim = sm_m[(e * kNs + sp) * 2 + 1];
      zre += mre * rho[sp][0] - mim * rho[sp][1];
      zim += mre * rho[sp][1] + mim * rho[sp][0];
    }
    ore[e * a.o_e] = c * zre - s * zim;
    oim[e * a.o_e] = c * zim + s * zre;
    if (uniform && e < NE - 1) ideal::rotate(c, s, dc, ds);
  }
}

template <int NE>
void launch_ne(const ForwardArgs& a, int nb, int mode, cudaStream_t st) {
  const dim3 grid((unsigned)((a.nvox + kThreads - 1) / kThreads), nb);
  if (mode == 0)
    synth_kernel<NE, 0><<<grid, kThreads, 0, st>>>(a);
  else if (mode == 1)
    synth_kernel<NE, 1><<<grid, kThreads, 0, st>>>(a);
  else
    synth_kernel<NE, 2><<<grid, kThreads, 0, st>>>(a);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); 1001 for an echo
// count outside 2..12 (the caller checks).
extern "C" int ideal_forward(const float* r_re, const float* r_im,
                             const float* phi, const float* r2,
                             const float* m, const float* te, float* o_re,
                             float* o_im, int nb, int ne, long long nvox,
                             long long r_b, long long r_s, long long r_v,
                             long long p_b, long long p_v, long long o_b,
                             long long o_e, long long o_v, int mode,
                             float fm_sc, float r2_sc, float rho_sc,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ForwardArgs a{r_re, r_im, phi, r2,  m,   te,  o_re, o_im,  nvox,
                r_b,  r_s,  r_v, p_b, p_v, o_b, o_e,  o_v,   fm_sc,
                r2_sc, rho_sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ne) {
#define IDEAL_FORWARD_CASE(N)        \
  case N:                            \
    launch_ne<N>(a, nb, mode, st);   \
    break;
    IDEAL_FORWARD_CASE(2) IDEAL_FORWARD_CASE(3) IDEAL_FORWARD_CASE(4)
    IDEAL_FORWARD_CASE(5) IDEAL_FORWARD_CASE(6) IDEAL_FORWARD_CASE(7)
    IDEAL_FORWARD_CASE(8) IDEAL_FORWARD_CASE(9) IDEAL_FORWARD_CASE(10)
    IDEAL_FORWARD_CASE(11) IDEAL_FORWARD_CASE(12)
#undef IDEAL_FORWARD_CASE
    default:
      return 1001;
  }
  return (int)cudaGetLastError();
}
