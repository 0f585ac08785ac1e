// Magnitude-domain water/fat LS fit, one thread per voxel.
//
// Replaces the TPU kernel `_mag_fit_kernel` of ideal_gan_tpu/ops/pallas_ideal.py
// (launched there by `cse_mag_fused`). Per voxel v of batch row b, with
// r2(v) = R2*(v)*r2_sc:
//
//   w_e(v)     = exp(te_e*r2(v))                      demodulation of the decay
//   d_e(v)     = (w_e(v)*|S_e(v)|)^2
//   (a, b, c)  = Ap[b] . d                            Ap = (A^T A)^-1 A^T, 3 x ne
//   |S^_e(v)|  = sqrt(A[b][e] . (a, b, c)) / w_e(v)   where that sum > 1e-6, else 0
//   lambda_max, lambda_min, v_max of [[a, b/2], [b/2, c]] in closed form
//   (|W|, |F|) = sqrt(max(lambda_max, 0))*v_max / rho_sc   (0 where lambda_max <= 0)
//   ratio      = max(lambda_min, 0) / lambda_max       (0 where lambda_max <= 0)
//   ls         = (a, b, c) / rho_sc^2
//
// A = [|M_w|, Re M_f, |M_f|^2] is the ne x 3 design matrix of |S|^2 from the
// model matrix M of the batch row's TE train (physics.mag_design_matrix).
// `mode` picks how w_e is formed, as the phasors of ideal_fit.cu: 0 one exp
// per echo, 1 the uniform-TE recurrence w_e = w_{e-1}*exp(dTE*r2) (real
// here: the magnitude fit has no field-map phase), 2 decided per batch row
// on the card from te, with the JAX package's uniformity test.
//
// R2* is read from channel 0 of the out_maps row (nb, 1, H, W, >=1) through
// element strides, with no copy (the complex kernels read R2* from channel 1
// of (phi, R2*)). |S| (nb, ne, H, W, 1) is planar, its trailing 1 gives
// unit voxel stride. Outputs are contiguous float32: rho (nb, 2, H, W),
// |S^| (nb, ne, H, W), ls (nb, 3, H, W), ratio (nb, 1, H, W).
//
// Bound on an H100: memory. At ne=6 in float32 a voxel reads |S| 24 B and
// R2* 4 B and writes rho 8, |S^| 24, ls 12 and the ratio 4: 76 B/voxel
// against about 60 FMAs, 1-6 exp and 3 sqrt, far below the card's
// operations-per-byte balance. At nb=8, 384^2 that is 89.7 MB, or 0.0268 ms
// at 3.35 TB/s.
//
// Design: the fit kernel's (one thread per voxel, per-row A, Ap and te in
// shared memory, ne a template parameter so the echo loops unroll and w_e
// stays in registers), not the TPU kernel's row tiling. Math is float32 in
// the plain version's order: the LS sums run over the echoes as the matmul
// Ap . d does, without folding A.Ap into one matrix, since
// exp(2*te*R2*) reaches e^5.6 at R2* = r2_sc and Ap's contraction cancels.
// Two thresholds (A.(a,b,c) > 1e-6 and lambda_max > 0) can flip at voxels
// sitting on them under another summation order; the JAX package holds its
// own kernel to rtol 1e-3 / atol 5e-4 for that. The backward is not a
// kernel: autograd through the plain version, as in the JAX package.

#include <cuda_runtime.h>

#include "ideal_phasor.cuh"

namespace {

using ideal::kThreads;

struct MagArgs {
  const float* s;    // |S|
  const float* r2;   // R2*, channel 0 of the out_maps row
  const float* a;    // (nb, ne*3): [e*3 + k]
  const float* ap;   // (nb, 3*ne): [k*ne + e]
  const float* te;   // (nb, ne)
  float* rho;        // (nb, 2, nvox)
  float* rec;        // (nb, ne, nvox)
  float* ls;         // (nb, 3, nvox)
  float* unc;        // (nb, 1, nvox)
  long long nvox;
  long long s_b, s_e, s_v;  // |S| strides (elements)
  long long p_b, p_v;       // R2* strides
  float r2_sc, rho_sc, rho_sc2;
};

template <int NE, int MODE>
__global__ void __launch_bounds__(kThreads) mag_ls_kernel(MagArgs a) {
  __shared__ float sm_a[3 * NE];
  __shared__ float sm_ap[3 * NE];
  __shared__ float sm_te[NE];
  __shared__ bool sm_uniform;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 3 * NE; i += blockDim.x) {
    sm_a[i] = a.a[b * 3 * NE + i];
    sm_ap[i] = a.ap[b * 3 * NE + i];
  }
  for (int i = threadIdx.x; i < NE; i += blockDim.x)
    sm_te[i] = a.te[b * NE + i];
  if (MODE == 2 && threadIdx.x == 0)
    sm_uniform = ideal::te_is_uniform<NE>(a.te + b * NE);
  __syncthreads();
  const bool uniform = MODE == 1 || (MODE == 2 && sm_uniform);

  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= a.nvox) return;
  const float r2 = a.r2[b * a.p_b + v * a.p_v] * a.r2_sc;
  const float* ps = a.s + b * a.s_b + v * a.s_v;

  float w[NE];
  float wd = 0.f;
  if (uniform) {
    w[0] = expf(sm_te[0] * r2);
    wd = expf((sm_te[1] - sm_te[0]) * r2);
  }
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    if (!uniform)
      w[e] = expf(sm_te[e] * r2);
    else if (e > 0)
      w[e] = w[e - 1] * wd;
    const float x = w[e] * ps[e * a.s_e];
    const float d = x * x;
    acc0 += sm_ap[e] * d;
    acc1 += sm_ap[NE + e] * d;
    acc2 += sm_ap[2 * NE + e] * d;
  }

  const long long nv = a.nvox;
  float* pl = a.ls + (long long)b * 3 * nv + v;
  pl[0] = acc0 / a.rho_sc2;
  pl[nv] = acc1 / a.rho_sc2;
  pl[2 * nv] = acc2 / a.rho_sc2;

  float* pr = a.rec + (long long)b * NE * nv + v;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const float fit = sm_a[e * 3] * acc0 + sm_a[e * 3 + 1] * acc1 +
                      sm_a[e * 3 + 2] * acc2;
    pr[e * nv] = fit > 1e-6f ? sqrtf(fit) / w[e] : 0.f;
  }

  // closed-form eigensolve of [[a, b/2], [b/2, c]] (physics.eigenvals_2x2)
  const float adiff_half = 0.5f * (acc0 - acc2);
  const float b_half = 0.5f * acc1;
  const float delta =
      sqrtf(adiff_half * adiff_half + b_half * b_half + 1e-12f);
  const float lam_max = 0.5f * (acc0 + acc2) + delta;
  const float lam_min = 0.5f * (acc0 + acc2) - delta;
  const float lam_max_pos = fmaxf(lam_max, 0.f);
  const float lam_min_pos = fmaxf(lam_min, 0.f);
  const float vy_raw = lam_max - acc0;
  const float norm = sqrtf(b_half * b_half + vy_raw * vy_raw + 1e-12f);
  const float vx = norm > 0.f ? b_half / norm : 0.f;
  const float vy = norm > 0.f ? vy_raw / norm : 0.f;
  const bool pos = lam_max_pos > 0.f;
  const float scale = pos ? sqrtf(lam_max_pos) : 0.f;
  float* po = a.rho + (long long)b * 2 * nv + v;
  po[0] = scale * vx / a.rho_sc;
  po[nv] = scale * vy / a.rho_sc;
  a.unc[(long long)b * nv + v] = pos ? lam_min_pos / lam_max_pos : 0.f;
}

template <int NE>
void launch_ne(const MagArgs& a, int nb, int mode, cudaStream_t st) {
  const dim3 grid((unsigned)((a.nvox + kThreads - 1) / kThreads), nb);
  if (mode == 0)
    mag_ls_kernel<NE, 0><<<grid, kThreads, 0, st>>>(a);
  else if (mode == 1)
    mag_ls_kernel<NE, 1><<<grid, kThreads, 0, st>>>(a);
  else
    mag_ls_kernel<NE, 2><<<grid, kThreads, 0, st>>>(a);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); 1001 for an echo
// count outside 3..12 (the caller checks: Ap needs ne >= 3).
extern "C" int ideal_mag_fit(const float* s, const float* r2, const float* a,
                             const float* ap, const float* te, float* rho,
                             float* rec, float* ls, float* unc, int nb, int ne,
                             long long nvox, long long s_b, long long s_e,
                             long long s_v, long long p_b, long long p_v,
                             int mode, float r2_sc, float rho_sc,
                             float rho_sc2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  MagArgs args{s,   r2,   a,   ap,  te,  rho, rec,   ls,     unc,
               nvox, s_b, s_e, s_v, p_b, p_v, r2_sc, rho_sc, rho_sc2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ne) {
#define IDEAL_MAG_CASE(N)              \
  case N:                              \
    launch_ne<N>(args, nb, mode, st);  \
    break;
    IDEAL_MAG_CASE(3) IDEAL_MAG_CASE(4) IDEAL_MAG_CASE(5) IDEAL_MAG_CASE(6)
    IDEAL_MAG_CASE(7) IDEAL_MAG_CASE(8) IDEAL_MAG_CASE(9) IDEAL_MAG_CASE(10)
    IDEAL_MAG_CASE(11) IDEAL_MAG_CASE(12)
#undef IDEAL_MAG_CASE
    default:
      return 1001;
  }
  return (int)cudaGetLastError();
}
