// The IDEAL cycle (fit, then reprojection), one thread per voxel.
//
// Replaces the TPU kernel `_cycle_kernel` of ideal_gan_tpu/ops/pallas_ideal.py
// (launched there by `cycle_full_fused` and `cycle_fused`). Per voxel v of
// batch row b it computes
//
//   acc_s(v) = sum_e Mp[b][s][e] * exp(-2*pi*i*te_e*xi(v)) * S_e(v)
//   rho_s(v) = acc_s(v) / rho_sc
//   A^_e(v)  = exp(+2*pi*i*te_e*xi(v)) * sum_s M[b][e][s] * acc_s(v)
//   xi(v)    = phi(v)*fm_sc + i*r2(v)*r2_sc/(2*pi)
//
// the (A2B_WF, A2B2A) pair of the unsupervised physics loss. The
// reprojection uses the accumulator before the 1/rho_sc scaling. The
// demodulating phasor grows by exp(+te*R2*), the remodulating one decays.
// `mode` picks the phasor form as in ideal_fit.cu: 0 per echo, 1 the
// uniform-TE recurrence, 2 decided per batch row on the card from te.
//
// Bound on an H100: memory. At ne=6, ns=2 in float32 a voxel reads
// 4*(2*ne + 2) = 56 bytes and writes 4*(2*ns + 2*ne) = 64 bytes: 120 B/voxel
// against about 150 FMAs and 4-24 transcendentals, far below the card's
// operations-per-byte balance. At the trainer's shape (nb=8, 384^2) that is
// 141.6 MB, or 0.042 ms at 3.35 TB/s.
//
// Design: the fit kernel's, with a second unrolled echo loop for the
// reprojection; the echoes are read once and only the ns complex
// accumulators live across the two loops. Strides are in elements, so the
// kernel reads and writes the interleaved MEBCRN layout (nb, k, H, W, 2) in
// place. Math is float32 (the JAX cycle has no bf16 mode). The backward is
// not a kernel: autograd through the plain version, as in the JAX package.

#include <cuda_runtime.h>

#include "ideal_phasor.cuh"

namespace {

using ideal::kNs;
using ideal::kThreads;

struct CycleArgs {
  const float* s_re;
  const float* s_im;
  const float* phi;
  const float* r2;
  const float* m;    // (nb, 2*ne*ns): [(e*ns + s)*2 + {re, im}]
  const float* mp;   // (nb, 2*ns*ne): [(s*ne + e)*2 + {re, im}]
  const float* te;   // (nb, ne)
  float* r_re;
  float* r_im;
  float* o_re;
  float* o_im;
  long long nvox;
  long long s_b, s_e, s_v;  // echo strides (elements)
  long long p_b, p_v;       // phi / r2 strides
  long long r_b, r_s, r_v;  // rho strides
  long long o_b, o_e, o_v;  // reprojection strides
  float fm_sc, r2_sc, inv_rho;
};

template <int NE, int MODE>
__global__ void __launch_bounds__(kThreads) cycle_kernel(CycleArgs a) {
  __shared__ float sm_m[2 * kNs * NE];
  __shared__ float sm_mp[2 * kNs * NE];
  __shared__ float sm_te[NE];
  __shared__ bool sm_uniform;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * kNs * NE; i += blockDim.x) {
    sm_m[i] = a.m[b * 2 * kNs * NE + i];
    sm_mp[i] = a.mp[b * 2 * kNs * NE + i];
  }
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
  const float* pre = a.s_re + b * a.s_b + v * a.s_v;
  const float* pim = a.s_im + b * a.s_b + v * a.s_v;

  // fit: demodulate and contract with Mp
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
    const float sre = pre[e * a.s_e];
    const float sim = pim[e * a.s_e];
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
  float* rre = a.r_re + b * a.r_b + v * a.r_v;
  float* rim = a.r_im + b * a.r_b + v * a.r_v;
#pragma unroll
  for (int sp = 0; sp < kNs; ++sp) {
    rre[sp * a.r_s] = acc[sp][0] * a.inv_rho;
    rim[sp * a.r_s] = acc[sp][1] * a.inv_rho;
  }

  // reprojection: M times the unscaled accumulator, remodulated
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
      zre += mre * acc[sp][0] - mim * acc[sp][1];
      zim += mre * acc[sp][1] + mim * acc[sp][0];
    }
    ore[e * a.o_e] = c * zre - s * zim;
    oim[e * a.o_e] = c * zim + s * zre;
    if (uniform && e < NE - 1) ideal::rotate(c, s, dc, ds);
  }
}

template <int NE>
void launch_ne(const CycleArgs& a, int nb, int mode, cudaStream_t st) {
  const dim3 grid((unsigned)((a.nvox + kThreads - 1) / kThreads), nb);
  if (mode == 0)
    cycle_kernel<NE, 0><<<grid, kThreads, 0, st>>>(a);
  else if (mode == 1)
    cycle_kernel<NE, 1><<<grid, kThreads, 0, st>>>(a);
  else
    cycle_kernel<NE, 2><<<grid, kThreads, 0, st>>>(a);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); 1001 for an echo
// count outside 2..12 (the caller checks).
extern "C" int ideal_cycle(const float* s_re, const float* s_im,
                           const float* phi, const float* r2, const float* m,
                           const float* mp, const float* te, float* r_re,
                           float* r_im, float* o_re, float* o_im, int nb,
                           int ne, long long nvox, long long s_b,
                           long long s_e, long long s_v, long long p_b,
                           long long p_v, long long r_b, long long r_s,
                           long long r_v, long long o_b, long long o_e,
                           long long o_v, int mode, float fm_sc, float r2_sc,
                           float rho_sc, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CycleArgs a{s_re, s_im, phi, r2,  m,   mp,  te,  r_re, r_im,
              o_re, o_im, nvox, s_b, s_e, s_v, p_b, p_v, r_b,
              r_s,  r_v,  o_b,  o_e, o_v, fm_sc, r2_sc, 1.0f / rho_sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ne) {
#define IDEAL_CYCLE_CASE(N) \
  case N:                   \
    launch_ne<N>(a, nb, mode, st); \
    break;
    IDEAL_CYCLE_CASE(2) IDEAL_CYCLE_CASE(3) IDEAL_CYCLE_CASE(4)
    IDEAL_CYCLE_CASE(5) IDEAL_CYCLE_CASE(6) IDEAL_CYCLE_CASE(7)
    IDEAL_CYCLE_CASE(8) IDEAL_CYCLE_CASE(9) IDEAL_CYCLE_CASE(10)
    IDEAL_CYCLE_CASE(11) IDEAL_CYCLE_CASE(12)
#undef IDEAL_CYCLE_CASE
    default:
      return 1001;
  }
  return (int)cudaGetLastError();
}
