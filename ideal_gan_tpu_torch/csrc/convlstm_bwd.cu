// The multi-echo ConvLSTM backward, one echo of the reverse sweep per call,
// as implicit GEMMs on the H100's tensor cores in split TF32 (3xTF32).
//
// Replaces the TPU kernel `_bwd_kernel` of
// ideal_gan_tpu/ops/pallas_convlstm.py (launched there by
// `convlstm_bwd_pallas` from the custom VJP `_fused_bwd`). The host first
// recomputes the per-echo states h_e, c_e (e < ne-1) with the forward kernel
// (convlstm_fwd.cu) into an (ne-1, nb, F, H, W) stack, then calls
// `convlstm_echo_bwd` for e = ne-1 .. 0 and `convlstm_bwd_reduce` once.
// Per echo, over the P = nb*H*W pixels and C = Cin + F input channels:
//
//  stage                      M          N              K
//  (a) gates_mma              P          4F             9*C  (C padded to 8)
//  (b) dinp_mma               P          F (+Cin: dx)   9*4F
//  (c) dk_mma                 4F         9*C (+1: db)   P, split in slots
//
//  (a) recomputes the gates z = conv3x3_SAME(concat(x_e, h_{e-1}), k) + b
//      and applies the cell's derivative in the epilogue:
//        dc~   = dc_e + dh_e * o * lrelu'(c_e)
//        dz_i  = dc~ * g * i(1-i)      dz_f = dc~ * c_{e-1} * f(1-f)
//        dz_g  = dc~ * i * lrelu'(z_g) dz_o = dh_e * lrelu(c_e) * o(1-o)
//        dc_{e-1} = dc~ * f
//      with sigmoid' = s(1-s) and lrelu' = 1 for x >= 0, else 0.2 (the JAX
//      package's convention at 0). The N columns of a warp are the four
//      gates of 8 hidden channels (four n8 tiles), so every thread holds
//      i, f, g, o of its pixels and channels in registers: no interleaved
//      copy of k and no pass through shared memory.
//  (b) the transposed 3x3 convolution of dgates with k, i.e. a SAME
//      convolution with the flipped kernel: dinp[p][c] = sum over taps t and
//      gates n of dz[p + off(t)][n] * k[8 - t][c][n]. Gives dh_{e-1}
//      (c >= Cin) and, when asked, dx_e (c < Cin).
//  (c) dk^T[n][(t, c)] = sum over pixels p of dz[p][n] * in[p + off(t)][c],
//      where in = concat(x_e, h_{e-1}, 1): the constant channel C makes the
//      centre tap's column db. Deterministic: block (slot, channels, gates)
//      walks the pixel chunks slot, slot + S, ... in order with its sums in
//      registers, and adds them once per echo into its own slot of an
//      (S, 9, C, 4F) scratch buffer; `sum_slots` sums the S slots in a
//      fixed order. No float atomics: two runs give the same gradients.
//  Echo 0 has zero state: its state channels, dh_{-1} and dc_{-1} are
//  skipped.
//
// Precision: every product is 3xTF32 on `mma.sync.m16n8k8.tf32`: each f32
// operand is split into hi = tf32(x) and lo = tf32(x - hi), and a tile sums
// lo*hi + hi*lo + hi*hi (lo*lo, below f32's rounding, is dropped). Plain
// TF32 keeps ~3 digits, short of the backward's 1e-4-of-scale gate against
// float64. The tensor core's FP32 accumulation truncates, so a long K summed
// inside it drifts toward zero by a few 1e-6 of the partial sums. Stage (a)
// decides, by its gate values, which side of leaky_relu's kink a pixel
// takes: there every k8 step is summed on the tensor core from zero and
// added to FP32 registers with a rounded add, which keeps the gates as close
// to float64 as an FP32 FMA chain. Stage (c) does the same once per pixel
// chunk (a slot walks ~4500 pixels an echo at nb=8, 384^2). Stage (b)'s K
// (9*4F) is short enough to sum on the tensor core alone.
//
// Bounds on an H100 (NVIDIA H100 SXM data sheet): the necessary work (one
// forward plus dinp and dk) is 1.72 TFLOP at Cin=2, F=36, nb=8, 384^2,
// ne=6 (6.75 at F=72): 25.7 ms at 67 TFLOP/s FP32 on CUDA cores, 10.4 ms
// as 3xTF32 on the tensor cores (495/3 = 165 TFLOP/s). The bytes (x, k, b,
// dL/dh in, dx, dk, db out) are a few hundred MB: operations bound it.
//
// Design: stage (a)'s mainloop is the forward kernel's (convlstm_tile.cuh:
// the same code, so the recomputed gates are the forward's bit for bit).
// Each stage is a tiled implicit GEMM whose operand tiles are
// staged in shared memory with cp.async in a ring of two stages, so the next
// channel octet's (or pixel chunk's) loads overlap this one's MMAs. Shared
// memory strides are padded so that every fragment load is free of bank
// conflicts. The fragments are read with scalar shared loads (ldmatrix
// moves 16-bit elements) and split into hi/lo in registers. A warp issues
// each of the three products over all its tiles before the next, so its
// MMAs do not wait on one another. Blocks of (a) and (b) need ~70 KB of
// shared memory, so two to three share an SM; (c) runs one block of 9 warps
// an SM. Rows of 4 contiguous floats (weights, dgates) are copied 16 bytes
// at a time.
//  (a), (b): a block owns a 16x16 pixel tile of one image (4608 tiles per
//    echo at nb=8, 384^2) and up to 64 (a: 2 x 8 channels x 4 gates) or 40
//    (b) output columns; each of its 8 warps owns two tile rows (two m16
//    tiles). K runs over octets of input channels (a) or gates (b), 9 taps
//    each. (a)'s epilogue moves each thread's two adjacent channels as one
//    float2 (F even).
//  (c): a block of 9 warps owns up to 144 gate rows and 16 input channels x
//    9 taps, and walks chunks of 8 rows x 16 pixels; warp (dy, third) owns
//    three m16 tiles of gates and the six n8 tiles of its tap row. A
//    channel octet with nothing to sum (padding past C, echo 0's zero
//    state) is skipped by a block-uniform branch.
// The TPU kernel's whole-recurrence VMEM state, taint fronts and dx
// overlap-add have no counterpart: per-echo launches need none of them.
//
// The bf16 storage mode (`convlstm_echo_bwd_bf16`: gates_mma_bf16,
// dinp_mma_bf16, dk_mma_bf16, sum_slots_bf16) is the TPU kernel's bf16
// reverse sweep, the same templates on S = the bits of bf16: k, x and the
// state stacks are bf16; dL/dh, dL/dc and dL/dz stay f32 in device memory,
// and dL/dz is rounded to bf16 where it becomes an operand of (b) and (c)
// (at the fragment); db is summed from the f32 dL/dz beside (c)'s MMAs (no
// bias column); dx leaves in bf16, the dk/db partials in f32, dk and db in
// bf16. Each product is one m16n8k16 bf16 MMA with f32 accumulation. Only
// the stages' inner steps (3xTF32 k8 against bf16 k16 fragments) and
// loaders differ between the two modes.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convlstm_tile.cuh"

namespace {

using namespace convlstm;

// T, P, PS, kWarps, kGroups: the 16x16 pixel tiles of (a) and (b)
// (convlstm_tile.cuh)
constexpr int kCols = 40;    // (b): at most 40 output channels a block
constexpr int kGateRows = 144;  // (c): gate rows a block
constexpr int RY = 8;        // (c): image rows a pixel chunk
constexpr int DS = kGateRows + 8;  // (c): dgates stride per pixel
constexpr int CS = 24;       // (c): patch stride per pixel (16 channels)

// ---------------------------------------------------------------- (a)

// x, k, the bias and the state stacks stored as S (float, or bf16 bits);
// dL/dh, dL/dc and dL/dz are float32 in both modes
template <class S>
struct GatesArgsT {
  GateConvT<S> conv;    // x_e, k, h_{e-1} and the shape
  const S* bias;
  const S* c_prev;      // (nb, F, H, W), unused without state
  const float* dh;      // dL/dh_e (nb, H, W, F)
  const float* dc;      // dL/dc_e (nb, H, W, F), null at the last echo
  float* dgates;        // dL/dz (nb, H, W, 4F)
  float* dc_prev;       // dL/dc_{e-1} (nb, H, W, F), null at echo 0
};
using GatesArgs = GatesArgsT<float>;

template <class S>
__device__ __forceinline__ void gates_body(const GatesArgsT<S>& ga,
                                           float* smem) {
  const GateConvT<S>& a = ga.conv;
  const int tiles_x = (a.W + T - 1) / T;
  const int tx0 = (blockIdx.y % tiles_x) * T;
  const int ty0 = (blockIdx.y / tiles_x) * T;
  const int j0 = blockIdx.x * a.gpb;
  const int ng = min(a.gpb, (a.F + 7) / 8 - j0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x >> 2) & 7;
  const int t = threadIdx.x & 3;

  float acc[2][kGroups][4][4];
  gate_mainloop(a, smem, b, ty0, tx0, j0, ng, acc);

  // epilogue: thread (g, t) holds, for tile rows 2*warp + mi, pixels g and
  // g + 8 (fragment halves h) of channels f0 = 8*(j0+jj) + 2t and f0 + 1,
  // all 4 gates. The two channels are adjacent in the channels-last
  // buffers, so with F even they move as one float2.
  const long long hw = (long long)a.H * a.W;
  const bool pair = a.F % 2 == 0;
#pragma unroll
  for (int jj = 0; jj < kGroups; ++jj) {
    const int f0 = (j0 + jj) * 8 + 2 * t;
    if (jj >= ng || f0 >= a.F) continue;
    const int ne = f0 + 1 < a.F ? 2 : 1;  // channels of the pair in range
    float bias[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bias[q][e] = load_f(ga.bias, q * a.F + min(f0 + e, a.F - 1));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int y = ty0 + 2 * warp + mi;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xx = tx0 + g + 8 * h;
        if (y >= a.H || xx >= a.W) continue;
        const long long pix = ((long long)b * a.H + y) * a.W + xx;
        const long long at = pix * a.F + f0;  // (pixel, f0) in dh, dc
        float dh[2] = {0.f, 0.f}, dc[2] = {0.f, 0.f};
        if (pair && ne == 2) {
          const float2 v = *reinterpret_cast<const float2*>(ga.dh + at);
          dh[0] = v.x;
          dh[1] = v.y;
          if (ga.dc) {
            const float2 w = *reinterpret_cast<const float2*>(ga.dc + at);
            dc[0] = w.x;
            dc[1] = w.y;
          }
        } else {
          for (int e = 0; e < ne; ++e) {
            dh[e] = ga.dh[at + e];
            dc[e] = ga.dc ? ga.dc[at + e] : 0.f;
          }
        }
        float out[5][2];  // dz_i, dz_f, dz_g, dz_o, dc_{e-1}
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * h + e;
          const float zg = acc[mi][jj][2][r] + bias[2][e];
          const float gi = sigmoid(acc[mi][jj][0][r] + bias[0][e]);
          const float gf = sigmoid(acc[mi][jj][1][r] + bias[1][e]);
          const float gg = leaky_relu(zg);
          const float go = sigmoid(acc[mi][jj][3][r] + bias[3][e]);
          const float cp =
              a.has_state && e < ne
                  ? load_f(ga.c_prev, ((long long)b * a.F + f0 + e) * hw +
                                          (long long)y * a.W + xx)
                  : 0.f;
          const float cn = gf * cp + gi * gg;
          const float dct = dc[e] + dh[e] * go * leaky_relu_grad(cn);
          out[0][e] = dct * gg * gi * (1.f - gi);
          out[1][e] = dct * cp * gf * (1.f - gf);
          out[2][e] = dct * gi * leaky_relu_grad(zg);
          out[3][e] = dh[e] * leaky_relu(cn) * go * (1.f - go);
          out[4][e] = dct * gf;
        }
        float* dg = ga.dgates + pix * 4 * a.F + f0;
        if (pair && ne == 2) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float2*>(dg + q * a.F) =
                make_float2(out[q][0], out[q][1]);
          if (ga.dc_prev)
            *reinterpret_cast<float2*>(ga.dc_prev + at) =
                make_float2(out[4][0], out[4][1]);
        } else {
          for (int e = 0; e < ne; ++e) {
#pragma unroll
            for (int q = 0; q < 4; ++q) dg[q * a.F + e] = out[q][e];
            if (ga.dc_prev) ga.dc_prev[at + e] = out[4][e];
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32, 2) gates_mma(GatesArgs ga) {
  extern __shared__ float smem[];
  gates_body(ga, smem);
}

// stage (a) in the bf16 storage mode: the bf16 gate mainloop; the epilogue
// reads the bias and c_{e-1} (the stack's bf16 copy) as f32 and writes
// dL/dz and dL/dc_{e-1} in f32, as the TPU kernel's f32 dgates and dc
__global__ void __launch_bounds__(kWarps * 32, 2)
    gates_mma_bf16(GatesArgsT<uint16_t> ga) {
  extern __shared__ float smem[];
  gates_body(ga, smem);
}

// ---------------------------------------------------------------- (b)

// k and dx stored as S; dL/dz and dL/dh float32 in both modes
template <class S>
struct DinpArgsT {
  const float* dg;  // (nb, H, W, 4F)
  const S* k;       // (3, 3, Cin+F, 4F)
  S* dx;            // echo e of dx (nb, ne, H, W, Cin), may be null
  long long dx_b;   // batch stride of dx (elements)
  float* dh;        // dL/dh_{e-1} (nb, H, W, F), may be null
  int cin, F, H, W, c0, nco, cpb;  // output channels [c0, c0 + nco)
};
using DinpArgs = DinpArgsT<float>;

// A stage in 32-bit words: the dgates patch (float32 in both modes; bf16
// rounds it at the fragment) and the flipped weights, float32 rows of 8
// gates (stride PS) or bf16 pairs of consecutive gates (4 words a row).
template <class S>
__host__ __device__ inline int dinp_stage(int cpb) {
  return P * P * PS + 9 * cpb * (sizeof(S) == 2 ? 4 : PS);
}

// the flipped weights ws[t][j][n] = k[8 - t][c][n0 + n] of the block's
// output channels, float32: rows of 4 gates 16 bytes at a time
__device__ __forceinline__ void dinp_load_w(const DinpArgs& a, float* ws,
                                            int n0, int cbase) {
  const int N = 4 * a.F;
  const int C = a.cin + a.F;
  for (int i = threadIdx.x; i < 9 * a.cpb * 2; i += blockDim.x) {
    const int n = n0 + 4 * (i & 1);
    const int r = i >> 1;  // tap * cpb + j
    const int tap = r / a.cpb;
    const int c = cbase + (r - tap * a.cpb);
    const bool in = n < N && c < a.c0 + a.nco;
    copy16(ws + r * PS + 4 * (i & 1),
           in ? a.k + ((long long)(8 - tap) * C + c) * N + n : nullptr, in);
  }
}

// bf16: word (tap, j, p) = k[8 - tap][c_j][n0 + 2p, n0 + 2p + 1]; 4
// consecutive gates are 8 bytes, aligned (N % 4 == 0, n0 % 8 == 0)
__device__ __forceinline__ void dinp_load_w(const DinpArgsT<uint16_t>& a,
                                            float* buf, int n0, int cbase) {
  const int N = 4 * a.F;
  const int C = a.cin + a.F;
  uint32_t* ws = reinterpret_cast<uint32_t*>(buf);
  for (int i = threadIdx.x; i < 9 * a.cpb * 2; i += blockDim.x) {
    const int half = i & 1;
    const int r = i >> 1;  // tap * cpb + j
    const int tap = r / a.cpb;
    const int c = cbase + (r - tap * a.cpb);
    const int n = n0 + 4 * half;
    uint32_t* dst = ws + r * 4 + 2 * half;
    if (n < N && c < a.c0 + a.nco) {
      __pipeline_memcpy_async(dst, a.k + ((long long)(8 - tap) * C + c) * N + n,
                              8);
    } else {
      dst[0] = 0u;
      dst[1] = 0u;
    }
  }
}

// Stage gates [n0, n0 + 8) of the dgates patch and the flipped weights of
// the block's output channels.
template <class S>
__device__ __forceinline__ void dinp_load(const DinpArgsT<S>& a, float* buf,
                                          int n0, int b, int ty0, int tx0,
                                          int cbase) {
  const int N = 4 * a.F;
  float* patch = buf;
  // 4 consecutive gates are contiguous and 16-byte aligned (N % 4 == 0)
  for (int i = threadIdx.x; i < 2 * P * P; i += blockDim.x) {
    const int pix = i >> 1;
    const int n = n0 + 4 * (i & 1);
    const int py = pix / P;
    const int y = ty0 + py - 1;
    const int xx = tx0 + (pix - py * P) - 1;
    const bool in = n < N && y >= 0 && y < a.H && xx >= 0 && xx < a.W;
    copy16(patch + pix * PS + 4 * (i & 1),
           in ? a.dg + (((long long)b * a.H + y) * a.W + xx) * N + n
              : nullptr,
           in);
  }
  dinp_load_w(a, buf + P * P * PS, n0, cbase);
  __pipeline_commit();
}

constexpr int NT = kCols / 8;  // (b): n8 tiles a block

// One stage of (b), float32: 9 taps of 3xTF32 k8 steps.
__device__ __forceinline__ void dinp_step(const DinpArgs& a,
                                          const float* patch, int nt,
                                          float (&acc)[2][NT][4]) {
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x >> 2) & 7;
  const int t = threadIdx.x & 3;
  const float* ws = patch + P * P * PS;
#pragma unroll 3
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    FragA fa[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      load_a_patch(patch, 2 * warp + mi + dy, dx, g, t, fa[mi]);
    const float* wt = ws + (tap * a.cpb + g) * PS + t;
    FragB fb[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        fb[j].set(0, wt[j * 8 * PS]);
        fb[j].set(1, wt[j * 8 * PS + 4]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) mma(acc[mi][j], fa[mi].lo, fb[j].hi);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) mma(acc[mi][j], fa[mi].hi, fb[j].lo);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) mma(acc[mi][j], fa[mi].hi, fb[j].hi);
  }
}

// One stage of (b), bf16: 5 k16 steps of two taps (the tenth zero), the
// f32 dgates packed into bf16 pairs at the fragment.
__device__ __forceinline__ void dinp_step(const DinpArgsT<uint16_t>& a,
                                          const float* patch, int nt,
                                          float (&acc)[2][NT][4]) {
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x >> 2) & 7;
  const int t = threadIdx.x & 3;
  const uint32_t* ws = reinterpret_cast<const uint32_t*>(patch + P * P * PS);
#pragma unroll 1
  for (int tp = 0; tp < 5; ++tp) {
    const int t0 = 2 * tp, t1 = 2 * tp + 1;  // tap 9 is zero
    uint32_t fa[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      // gates 2t, 2t+1 of pixels g and g + 8, taps t0 and t1
      const float* p0 =
          patch + ((2 * warp + mi + t0 / 3) * P + t0 % 3 + g) * PS + 2 * t;
      fa[mi][0] = pack_bf16(p0[0], p0[1]);
      fa[mi][1] = pack_bf16(p0[8 * PS], p0[8 * PS + 1]);
      if (t1 < 9) {
        const float* p1 =
            patch + ((2 * warp + mi + t1 / 3) * P + t1 % 3 + g) * PS + 2 * t;
        fa[mi][2] = pack_bf16(p1[0], p1[1]);
        fa[mi][3] = pack_bf16(p1[8 * PS], p1[8 * PS + 1]);
      } else {
        fa[mi][2] = fa[mi][3] = 0u;
      }
    }
    uint32_t fb[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        fb[j][0] = ws[(t0 * a.cpb + 8 * j + g) * 4 + t];
        fb[j][1] = t1 < 9 ? ws[(t1 * a.cpb + 8 * j + g) * 4 + t] : 0u;
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) mma_bf16(acc[mi][j], fa[mi], fb[j]);
  }
}

template <class S>
__device__ __forceinline__ void dinp_body(const DinpArgsT<S>& a,
                                          float* smem) {
  const int tiles_x = (a.W + T - 1) / T;
  const int tx0 = (blockIdx.x % tiles_x) * T;
  const int ty0 = (blockIdx.x / tiles_x) * T;
  const int b = blockIdx.z;
  const int cbase = a.c0 + blockIdx.y * a.cpb;
  const int nt = a.cpb / 8;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x >> 2) & 7;
  const int t = threadIdx.x & 3;

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0.f;

  ring(
      smem, dinp_stage<S>(a.cpb), (4 * a.F + 7) / 8,
      [&](int s, float* buf) { dinp_load(a, buf, 8 * s, b, ty0, tx0, cbase); },
      [&](const float* patch) { dinp_step(a, patch, nt, acc); });

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int y = ty0 + 2 * warp + mi;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int xx = tx0 + g + 8 * (r >> 1);
        const int c = cbase + 8 * j + 2 * t + (r & 1);
        if (j >= nt || c >= a.c0 + a.nco || y >= a.H || xx >= a.W) continue;
        const long long pix = (long long)y * a.W + xx;
        if (c < a.cin) {
          if (a.dx) store_f(a.dx, b * a.dx_b + pix * a.cin + c, acc[mi][j][r]);
        } else if (a.dh) {
          a.dh[((long long)b * a.H * a.W + pix) * a.F + (c - a.cin)] =
              acc[mi][j][r];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32, 2) dinp_mma(DinpArgs a) {
  extern __shared__ float smem[];
  dinp_body(a, smem);
}

__global__ void __launch_bounds__(kWarps * 32, 2)
    dinp_mma_bf16(DinpArgsT<uint16_t> a) {
  extern __shared__ float smem[];
  dinp_body(a, smem);
}

// ---------------------------------------------------------------- (c)

// x and h_{e-1} stored as S; dL/dz and the slot partials float32
template <class S>
struct DkArgsT {
  const S* x;  // echo e of x (nb, ne, H, W, Cin)
  long long x_b;
  const S* h_prev;      // (nb, F, H, W), null at echo 0
  const float* dg;      // (nb, H, W, 4F)
  float* part;          // (S, 9, C, 4F) slot partials of dk
  float* part_b;        // (S, 4F) slot partials of db
  int nb, cin, F, H, W, ceff;
};
using DkArgs = DkArgsT<float>;

constexpr int kDkStage = RY * T * DS + (RY + 2) * P * CS;

// an input value into the staged patch: float32 by cp.async, bf16 widened
// to f32 (exactly)
__device__ __forceinline__ void stage_in(float* dst, const float* src,
                                         bool in) {
  copy4(dst, src, in);
}
__device__ __forceinline__ void stage_in(float* dst, const uint16_t* src,
                                         bool in) {
  *dst = in ? bf2f(*src) : 0.f;
}

// Stage pixel chunk (b, rows y0 .. y0 + RY - 1, columns x0 .. x0 + 15): its
// dgates rows [m0, m0 + 144) and the (RY + 2) x 18 input patch of channels
// [cp0, cp0 + 16). Float32 stages channel C as 1 (the bias column: db is
// the centre tap's column); bf16 sums db from the f32 dgates instead.
template <class S>
__device__ __forceinline__ void dk_load(const DkArgsT<S>& a, float* buf,
                                        int b, int y0, int x0, int m0,
                                        int cp0) {
  const int N = 4 * a.F;
  const int C = a.cin + a.F;
  const long long hw = (long long)a.H * a.W;
  float* ds = buf;
  float* ps = buf + RY * T * DS;
  // 4 consecutive gates are contiguous and 16-byte aligned (N % 4 == 0)
  for (int i = threadIdx.x; i < RY * T * kGateRows / 4; i += blockDim.x) {
    const int px = i / (kGateRows / 4);
    const int m = 4 * (i - px * (kGateRows / 4));
    const int y = y0 + px / T;
    const int xx = x0 + px % T;
    const bool in = y < a.H && xx < a.W && m0 + m < N;
    copy16(ds + px * DS + m,
           in ? a.dg + (((long long)b * a.H + y) * a.W + xx) * N + m0 + m
              : nullptr,
           in);
  }
  for (int i = threadIdx.x; i < 16 * (RY + 2) * P; i += blockDim.x) {
    const int cc = i / ((RY + 2) * P);
    const int pix = i - cc * ((RY + 2) * P);
    const int py = pix / P;
    const int y = y0 + py - 1;
    const int xx = x0 + (pix - py * P) - 1;
    const int c = cp0 + cc;
    float* dst = ps + pix * CS + cc;
    if (sizeof(S) == 4 && c == C) {
      *dst = 1.f;  // the bias column
      continue;
    }
    const bool in = c < a.ceff && y >= 0 && y < a.H && xx >= 0 && xx < a.W;
    const S* src =
        !in ? nullptr
        : c < a.cin
            ? a.x + b * a.x_b + ((long long)y * a.W + xx) * a.cin + c
            : a.h_prev + ((long long)b * a.F + (c - a.cin)) * hw +
                  (long long)y * a.W + xx;
    stage_in(dst, src, in);
  }
  __pipeline_commit();
}

// One chunk of (c), float32: 2*RY k8 steps of 8 pixels, 3xTF32, summed on
// the tensor core from zero into d.
__device__ __forceinline__ void dk_step(const DkArgs&, const float* ds,
                                        const bool (&used)[2], int mw, int dy,
                                        float (&d)[3][6][4]) {
  const int g = (threadIdx.x >> 2) & 7;
  const int t = threadIdx.x & 3;
  const float* ps = ds + RY * T * DS;
#pragma unroll
  for (int ks = 0; ks < 2 * RY; ++ks) {  // 8 pixels of row ks / 2
    FragA fa[3];
#pragma unroll
    for (int mi = 0; mi < 3; ++mi) {
      const float* dz = ds + (8 * ks + t) * DS + mw + 16 * mi + g;
      fa[mi].set(0, dz[0]);
      fa[mi].set(1, dz[8]);
      fa[mi].set(2, dz[4 * DS]);
      fa[mi].set(3, dz[4 * DS + 8]);
    }
#pragma unroll
    for (int o = 0; o < 2; ++o) {  // channel octet; tile 2 * dx + o
      if (!used[o]) continue;
      FragB fb[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* p = ps + ((ks / 2 + dy) * P + 8 * (ks & 1) + t +
                               dx) * CS + 8 * o + g;
        fb[dx].set(0, p[0]);
        fb[dx].set(1, p[4 * CS]);
      }
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          mma(d[mi][2 * dx + o], fa[mi].lo, fb[dx].hi);
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          mma(d[mi][2 * dx + o], fa[mi].hi, fb[dx].lo);
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          mma(d[mi][2 * dx + o], fa[mi].hi, fb[dx].hi);
    }
  }
}

// One chunk of (c), bf16: RY k16 steps, one chunk row of 16 pixels each,
// the dgates and the widened inputs packed into bf16 pairs at the fragment.
__device__ __forceinline__ void dk_step(const DkArgsT<uint16_t>&,
                                        const float* ds, const bool (&used)[2],
                                        int mw, int dy, float (&d)[3][6][4]) {
  const int g = (threadIdx.x >> 2) & 7;
  const int t = threadIdx.x & 3;
  const float* ps = ds + RY * T * DS;
#pragma unroll 1
  for (int row = 0; row < RY; ++row) {  // 16 pixels of chunk row
    uint32_t fa[3][4];
#pragma unroll
    for (int mi = 0; mi < 3; ++mi) {
      // gates m, m + 8 of pixels 2t, 2t + 1 (and + 8)
      const float* dz = ds + (16 * row + 2 * t) * DS + mw + 16 * mi + g;
      fa[mi][0] = pack_bf16(dz[0], dz[DS]);
      fa[mi][1] = pack_bf16(dz[8], dz[DS + 8]);
      fa[mi][2] = pack_bf16(dz[8 * DS], dz[9 * DS]);
      fa[mi][3] = pack_bf16(dz[8 * DS + 8], dz[9 * DS + 8]);
    }
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      if (!used[o]) continue;
      uint32_t fb[3][2];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* p = ps + ((row + dy) * P + 2 * t + dx) * CS + 8 * o + g;
        fb[dx][0] = pack_bf16(p[0], p[CS]);
        fb[dx][1] = pack_bf16(p[8 * CS], p[9 * CS]);
      }
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          mma_bf16(d[mi][2 * dx + o], fa[mi], fb[dx]);
    }
  }
}

// block (slot, channel pair, gate chunk): 9 warps, warp (dy, third). In the
// bf16 mode the block that holds channel C sums db from the staged f32
// dgates beside the MMAs: thread (half, row) sums 64 of the chunk's 128
// pixels of its gate row.
template <class S>
__device__ __forceinline__ void dk_body(const DkArgsT<S>& a, float* smem) {
  constexpr bool bf16 = sizeof(S) == 2;
  const int N = 4 * a.F;
  const int C = a.cin + a.F;
  const int slot = blockIdx.x;
  const int cp0 = blockIdx.y * 16;
  const int m0 = blockIdx.z * kGateRows;
  const int warp = threadIdx.x >> 5;
  const int dy = warp / 3;
  const int mw = (warp - 3 * dy) * 48;  // the warp's first gate row
  const int g = (threadIdx.x >> 2) & 7;
  const int t = threadIdx.x & 3;
  const int xs = (a.W + T - 1) / T;
  const int ys = (a.H + RY - 1) / RY;
  const int n_chunks = a.nb * ys * xs;
  const int S_ = gridDim.x;
  const bool rows = m0 + mw < N;  // the warp has gate rows to sum
  // octets of the block's 16 channels with a channel to sum: below ceff,
  // or (float32) the bias column C; padding past C and echo 0's zero
  // state are skipped
  bool used[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const int c = cp0 + 8 * o;
    used[o] = c < a.ceff || (!bf16 && c <= C && C < c + 8);
  }
  const bool bias_block = bf16 && cp0 <= C && C < cp0 + 16;
  if (!used[0] && !used[1] && !bias_block) return;

  float acc[3][6][4];
#pragma unroll
  for (int mi = 0; mi < 3; ++mi)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0.f;
  float db = 0.f;
  const int db_row = threadIdx.x % kGateRows;
  const int db_px = (threadIdx.x / kGateRows) * (RY * T / 2);

  ring(
      smem, kDkStage, slot < n_chunks ? (n_chunks - 1 - slot) / S_ + 1 : 0,
      [&](int s, float* buf) {
        const int chunk = slot + s * S_;
        const int xq = chunk % xs;
        const int by = chunk / xs;
        dk_load(a, buf, by / ys, (by % ys) * RY, xq * T, m0, cp0);
      },
      [&](const float* ds) {
        if (bias_block) {
          float sum = 0.f;
          for (int px = db_px; px < db_px + RY * T / 2; ++px)
            sum += ds[px * DS + db_row];
          db += sum;
        }
        if (!rows) return;
        // this chunk's sums on the tensor core from zero, then rounded into
        // the FP32 accumulators: a slot walks thousands of pixels an echo,
        // too long a sum for the tensor core's truncating accumulation
        float d[3][6][4];
#pragma unroll
        for (int mi = 0; mi < 3; ++mi)
#pragma unroll
          for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) d[mi][j][r] = 0.f;
        dk_step(a, ds, used, mw, dy, d);
#pragma unroll
        for (int mi = 0; mi < 3; ++mi)
#pragma unroll
          for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][j][r] += d[mi][j][r];
      });
  if (bias_block) {  // the ring ended synchronised: smem is free
    smem[threadIdx.x] = db;
    __syncthreads();
    if (threadIdx.x < kGateRows && m0 + threadIdx.x < N)
      a.part_b[(long long)slot * N + m0 + threadIdx.x] +=
          smem[threadIdx.x] + smem[threadIdx.x + kGateRows];
  }
  if (!rows) return;

  float* part = a.part + (long long)slot * 9 * C * N;
  float* part_b = a.part_b + (long long)slot * N;
#pragma unroll
  for (int mi = 0; mi < 3; ++mi)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = m0 + mw + 16 * mi + g + 8 * (r >> 1);
        const int c = cp0 + 8 * (j & 1) + 2 * t + (r & 1);
        const int tap = dy * 3 + (j >> 1);
        if (n >= N) continue;
        if (c < a.ceff) {
          part[((long long)tap * C + c) * N + n] += acc[mi][j][r];
        } else if (!bf16 && c == C && tap == 4) {
          part_b[n] += acc[mi][j][r];
        }
      }
}

__global__ void __launch_bounds__(9 * 32, 1) dk_mma(DkArgs a) {
  extern __shared__ float smem[];
  dk_body(a, smem);
}

__global__ void __launch_bounds__(9 * 32, 1) dk_mma_bf16(DkArgsT<uint16_t> a) {
  extern __shared__ float smem[];
  dk_body(a, smem);
}

// dk[i] = sum over slots of part[s][i], in slot order; db likewise; stored
// as S.
template <class S>
__device__ __forceinline__ void sum_slots_body(const float* part,
                                               const float* part_b, S* dk,
                                               S* db, int n_slots,
                                               long long K, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < K) {
    float s = 0.f;
    for (int j = 0; j < n_slots; ++j) s += part[j * K + i];
    store_f(dk, i, s);
  }
  if (i < N) {
    float s = 0.f;
    for (int j = 0; j < n_slots; ++j) s += part_b[(long long)j * N + i];
    store_f(db, i, s);
  }
}

__global__ void sum_slots(const float* part, const float* part_b, float* dk,
                          float* db, int n_slots, long long K, int N) {
  sum_slots_body(part, part_b, dk, db, n_slots, K, N);
}

__global__ void sum_slots_bf16(const float* part, const float* part_b,
                               uint16_t* dk, uint16_t* db, int n_slots,
                               long long K, int N) {
  sum_slots_body(part, part_b, dk, db, n_slots, K, N);
}

// output channels per dinp block: octets, at most kCols, spread evenly
int dinp_cpb(int nco) {
  const int oct = (nco + 7) / 8;
  const int chunks = (oct + kCols / 8 - 1) / (kCols / 8);
  return 8 * ((oct + chunks - 1) / chunks);
}

template <class S>
int echo_bwd(const S* x, long long x_b, const S* k, const S* bias,
             const S* h_prev, const S* c_prev, const float* dh,
             const float* dc, float* dgates, float* dc_prev, float* dh_prev,
             S* dx, long long dx_b, float* part, float* part_b, int n_slots,
             int nb, int cin, int F, int H, int W, int has_state, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = ((W + T - 1) / T) * ((H + T - 1) / T);

  // the storage type's kernels
  void (*gates)(GatesArgsT<S>);
  void (*dinp)(DinpArgsT<S>);
  void (*dk)(DkArgsT<S>);
  if constexpr (sizeof(S) == 2) {
    gates = gates_mma_bf16;
    dinp = dinp_mma_bf16;
    dk = dk_mma_bf16;
  } else {
    gates = gates_mma;
    dinp = dinp_mma;
    dk = dk_mma;
  }

  const int gpb = gates_gpb(F);
  GatesArgsT<S> ga{{x, x_b, k, h_prev, cin, F, H, W, has_state, gpb},
                   bias, c_prev, dh, dc, dgates, dc_prev};
  size_t bytes = gates_smem_bytes<S>(gpb);
  err = allow_smem(gates, bytes);
  if (err != cudaSuccess) return (int)err;
  // channel chunks fastest: the blocks that stage one tile's input patch
  // run together and share it in L2
  gates<<<dim3(((F + 7) / 8 + gpb - 1) / gpb, tiles, nb), kWarps * 32, bytes,
          st>>>(ga);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int c0 = dx ? 0 : cin;
  const int c1 = has_state ? cin + F : cin;
  if (c1 > c0) {
    const int cpb = dinp_cpb(c1 - c0);
    DinpArgsT<S> d{dgates, k, dx, dx_b, has_state ? dh_prev : nullptr,
                   cin,    F, H,  W,    c0,
                   c1 - c0, cpb};
    bytes = 2 * (size_t)dinp_stage<S>(cpb) * sizeof(float);
    err = allow_smem(dinp, bytes);
    if (err != cudaSuccess) return (int)err;
    dinp<<<dim3(tiles, (c1 - c0 + cpb - 1) / cpb, nb), kWarps * 32, bytes,
           st>>>(d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  DkArgsT<S> kd{x, x_b, has_state ? h_prev : nullptr, dgates, part, part_b,
                nb, cin, F, H, W, has_state ? cin + F : cin};
  bytes = 2 * (size_t)kDkStage * sizeof(float);
  err = allow_smem(dk, bytes);
  if (err != cudaSuccess) return (int)err;
  dk<<<dim3(n_slots, (cin + F + 1 + 15) / 16,
            (4 * F + kGateRows - 1) / kGateRows),
       9 * 32, bytes, st>>>(kd);
  return (int)cudaGetLastError();
}

template <class S>
int bwd_reduce(const float* part, const float* part_b, S* dk, S* db,
               int n_slots, long long K, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long n = K > N ? K : N;
  void (*reduce)(const float*, const float*, S*, S*, int, long long, int);
  if constexpr (sizeof(S) == 2) {
    reduce = sum_slots_bf16;
  } else {
    reduce = sum_slots;
  }
  reduce<<<(unsigned)((n + threads - 1) / threads), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(part, part_b, dk, db, n_slots,
                                                K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest shared memory any block of the backward needs at (cin, F): the
// float32 stages', which the bf16 ones do not exceed.
extern "C" long long convlstm_bwd_smem_bytes(int cin, int F) {
  const size_t a = gates_smem_bytes<float>(gates_gpb(F));
  const size_t b =
      2 * (size_t)dinp_stage<float>(dinp_cpb(cin + F)) * sizeof(float);
  const size_t c = 2 * (size_t)kDkStage * sizeof(float);
  return (long long)(a > b ? (a > c ? a : c) : (b > c ? b : c));
}

// One echo e of the reverse sweep: (a) dgates and dc_{e-1}, (b) dh_{e-1} and
// (when dx is not null) dx_e, (c) dk/db slot partials. Null pointers: dc at
// the last echo; h_prev, c_prev, dc_prev and dh_prev at echo 0 (has_state
// 0). dh, dc, dgates, dc_prev and dh_prev are channels-last (nb, H, W, ·);
// h_prev and c_prev are the forward kernel's (nb, F, H, W). Returns the
// first cudaError_t of the launches (0 on success). The caller checks
// convlstm_bwd_smem_bytes against a block's shared memory.
extern "C" int convlstm_echo_bwd(
    const float* x, long long x_b, const float* k, const float* bias,
    const float* h_prev, const float* c_prev, const float* dh,
    const float* dc, float* dgates, float* dc_prev, float* dh_prev,
    float* dx, long long dx_b, float* part, float* part_b, int n_slots,
    int nb, int cin, int F, int H, int W, int has_state, int device,
    void* stream) {
  return echo_bwd(x, x_b, k, bias, h_prev, c_prev, dh, dc, dgates, dc_prev,
                  dh_prev, dx, dx_b, part, part_b, n_slots, nb, cin, F, H, W,
                  has_state, device, stream);
}

// dk (3, 3, C, 4F) and db (4F) from the slot partials.
extern "C" int convlstm_bwd_reduce(const float* part, const float* part_b,
                                   float* dk, float* db, int n_slots,
                                   long long K, int N, int device,
                                   void* stream) {
  return bwd_reduce(part, part_b, dk, db, n_slots, K, N, device, stream);
}

// One echo of the reverse sweep in the bf16 storage mode: x, k, the bias,
// h_prev, c_prev (the recompute's bf16 stacks) and dx are bf16; dh, dc,
// dgates, dc_prev, dh_prev and the partials f32. Arguments otherwise as
// convlstm_echo_bwd.
extern "C" int convlstm_echo_bwd_bf16(
    const uint16_t* x, long long x_b, const uint16_t* k, const uint16_t* bias,
    const uint16_t* h_prev, const uint16_t* c_prev, const float* dh,
    const float* dc, float* dgates, float* dc_prev, float* dh_prev,
    uint16_t* dx, long long dx_b, float* part, float* part_b, int n_slots,
    int nb, int cin, int F, int H, int W, int has_state, int device,
    void* stream) {
  return echo_bwd(x, x_b, k, bias, h_prev, c_prev, dh, dc, dgates, dc_prev,
                  dh_prev, dx, dx_b, part, part_b, n_slots, nb, cin, F, H, W,
                  has_state, device, stream);
}

// dk (3, 3, C, 4F) and db (4F) in bf16 from the slot partials.
extern "C" int convlstm_bwd_reduce_bf16(const float* part,
                                        const float* part_b, uint16_t* dk,
                                        uint16_t* db, int n_slots,
                                        long long K, int N, int device,
                                        void* stream) {
  return bwd_reduce(part, part_b, dk, db, n_slots, K, N, device, stream);
}
