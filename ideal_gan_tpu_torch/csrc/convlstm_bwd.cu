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
// The bf16 storage mode (`convlstm_echo_bwd_bf16`: gates_wg_bf16,
// dinp_mma_bf16, dk_mma_bf16; `convlstm_bwd_reduce_bf16`: sum_slots_bf16)
// is the TPU kernel's bf16 reverse sweep on kernels of its own, written for
// Hopper (see the bf16 section below): k, x and the state stacks are bf16;
// dL/dh and dL/dc stay f32; dL/dz is rounded to bf16 once, by stage (a),
// which also sums db from the f32 dL/dz; dx leaves in bf16, the dk partials
// in f32, dk and db in bf16. The float32 kernels above are unchanged by it.

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

struct GatesArgs {
  GateConv conv;        // x_e, k, h_{e-1} and the shape
  const float* bias;
  const float* c_prev;  // (nb, F, H, W), unused without state
  const float* dh;      // dL/dh_e (nb, H, W, F)
  const float* dc;      // dL/dc_e (nb, H, W, F), null at the last echo
  float* dgates;        // dL/dz (nb, H, W, 4F)
  float* dc_prev;       // dL/dc_{e-1} (nb, H, W, F), null at echo 0
};

__device__ __forceinline__ void gates_body(const GatesArgs& ga, float* smem) {
  const GateConv& a = ga.conv;
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
        float out[2][5];  // dz_i, dz_f, dz_g, dz_o, dc_{e-1}
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * h + e;
          const float be[4] = {bias[0][e], bias[1][e], bias[2][e],
                               bias[3][e]};
          Cell c = cell_gates(acc[mi][jj][0][r], acc[mi][jj][1][r],
                              acc[mi][jj][2][r], acc[mi][jj][3][r], be);
          const float cp =
              a.has_state && e < ne
                  ? load_f(ga.c_prev, ((long long)b * a.F + f0 + e) * hw +
                                          (long long)y * a.W + xx)
                  : 0.f;
          cell_state(c, cp);
          cell_grad(c, cp, dh[e], dc[e], out[e]);
        }
        float* dg = ga.dgates + pix * 4 * a.F + f0;
        if (pair && ne == 2) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float2*>(dg + q * a.F) =
                make_float2(out[0][q], out[1][q]);
          if (ga.dc_prev)
            *reinterpret_cast<float2*>(ga.dc_prev + at) =
                make_float2(out[0][4], out[1][4]);
        } else {
          for (int e = 0; e < ne; ++e) {
#pragma unroll
            for (int q = 0; q < 4; ++q) dg[q * a.F + e] = out[e][q];
            if (ga.dc_prev) ga.dc_prev[at + e] = out[e][4];
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

// ---------------------------------------------------------------- (b)

struct DinpArgs {
  const float* dg;  // (nb, H, W, 4F)
  const float* k;   // (3, 3, Cin+F, 4F)
  float* dx;        // echo e of dx (nb, ne, H, W, Cin), may be null
  long long dx_b;   // batch stride of dx (elements)
  float* dh;        // dL/dh_{e-1} (nb, H, W, F), may be null
  int cin, F, H, W, c0, nco, cpb;  // output channels [c0, c0 + nco)
};

// A stage in floats: the dgates patch and the flipped weights, rows of 8
// gates (stride PS).
__host__ __device__ inline int dinp_stage(int cpb) {
  return P * P * PS + 9 * cpb * PS;
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

// Stage gates [n0, n0 + 8) of the dgates patch and the flipped weights of
// the block's output channels.
__device__ __forceinline__ void dinp_load(const DinpArgs& a, float* buf,
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

__device__ __forceinline__ void dinp_body(const DinpArgs& a, float* smem) {
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
      smem, dinp_stage(a.cpb), (4 * a.F + 7) / 8,
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

// ---------------------------------------------------------------- (c)

struct DkArgs {
  const float* x;  // echo e of x (nb, ne, H, W, Cin)
  long long x_b;
  const float* h_prev;  // (nb, F, H, W), null at echo 0
  const float* dg;      // (nb, H, W, 4F)
  float* part;          // (S, 9, C, 4F) slot partials of dk
  float* part_b;        // (S, 4F) slot partials of db
  int nb, cin, F, H, W, ceff;
};

constexpr int kDkStage = RY * T * DS + (RY + 2) * P * CS;

// Stage pixel chunk (b, rows y0 .. y0 + RY - 1, columns x0 .. x0 + 15): its
// dgates rows [m0, m0 + 144) and the (RY + 2) x 18 input patch of channels
// [cp0, cp0 + 16), channel C as 1 (the bias column: db is the centre tap's
// column).
__device__ __forceinline__ void dk_load(const DkArgs& a, float* buf,
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
    if (c == C) {
      *dst = 1.f;  // the bias column
      continue;
    }
    const bool in = c < a.ceff && y >= 0 && y < a.H && xx >= 0 && xx < a.W;
    const float* src =
        !in ? nullptr
        : c < a.cin
            ? a.x + b * a.x_b + ((long long)y * a.W + xx) * a.cin + c
            : a.h_prev + ((long long)b * a.F + (c - a.cin)) * hw +
                  (long long)y * a.W + xx;
    copy4(dst, src, in);
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

// block (slot, channel pair, gate chunk): 9 warps, warp (dy, third)
__device__ __forceinline__ void dk_body(const DkArgs& a, float* smem) {
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
  // or the bias column C; padding past C and echo 0's zero state are
  // skipped
  bool used[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const int c = cp0 + 8 * o;
    used[o] = c < a.ceff || (c <= C && C < c + 8);
  }
  if (!used[0] && !used[1]) return;

  float acc[3][6][4];
#pragma unroll
  for (int mi = 0; mi < 3; ++mi)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0.f;

  ring(
      smem, kDkStage, slot < n_chunks ? (n_chunks - 1 - slot) / S_ + 1 : 0,
      [&](int s, float* buf) {
        const int chunk = slot + s * S_;
        const int xq = chunk % xs;
        const int by = chunk / xs;
        dk_load(a, buf, by / ys, (by % ys) * RY, xq * T, m0, cp0);
      },
      [&](const float* ds) {
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
        } else if (c == C && tap == 4) {
          part_b[n] += acc[mi][j][r];
        }
      }
}

__global__ void __launch_bounds__(9 * 32, 1) dk_mma(DkArgs a) {
  extern __shared__ float smem[];
  dk_body(a, smem);
}

// dk[i] = sum over slots of part[s][i], in slot order; db likewise
__global__ void sum_slots(const float* part, const float* part_b, float* dk,
                          float* db, int n_slots, long long K, int N) {
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

// output channels per dinp block: octets, at most kCols, spread evenly
// (ops/convlstm.py::_dinp_cpb computes the same for the bf16 packing)
int dinp_cpb(int nco) {
  const int oct = (nco + 7) / 8;
  const int chunks = (oct + kCols / 8 - 1) / (kCols / 8);
  return 8 * ((oct + chunks - 1) / chunks);
}

int echo_bwd(const float* x, long long x_b, const float* k, const float* bias,
             const float* h_prev, const float* c_prev, const float* dh,
             const float* dc, float* dgates, float* dc_prev, float* dh_prev,
             float* dx, long long dx_b, float* part, float* part_b,
             int n_slots, int nb, int cin, int F, int H, int W, int has_state,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = ((W + T - 1) / T) * ((H + T - 1) / T);

  const int gpb = gates_gpb(F);
  GatesArgs ga{{x, x_b, k, h_prev, cin, F, H, W, has_state, gpb},
               bias, c_prev, dh, dc, dgates, dc_prev};
  size_t bytes = gates_smem_bytes(gpb);
  err = allow_smem(gates_mma, bytes);
  if (err != cudaSuccess) return (int)err;
  // channel chunks fastest: the blocks that stage one tile's input patch
  // run together and share it in L2
  gates_mma<<<dim3(((F + 7) / 8 + gpb - 1) / gpb, tiles, nb), kWarps * 32,
              bytes, st>>>(ga);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int c0 = dx ? 0 : cin;
  const int c1 = has_state ? cin + F : cin;
  if (c1 > c0) {
    const int cpb = dinp_cpb(c1 - c0);
    DinpArgs d{dgates, k, dx, dx_b, has_state ? dh_prev : nullptr,
               cin,    F, H,  W,    c0,
               c1 - c0, cpb};
    bytes = 2 * (size_t)dinp_stage(cpb) * sizeof(float);
    err = allow_smem(dinp_mma, bytes);
    if (err != cudaSuccess) return (int)err;
    dinp_mma<<<dim3(tiles, (c1 - c0 + cpb - 1) / cpb, nb), kWarps * 32, bytes,
               st>>>(d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  DkArgs kd{x, x_b, has_state ? h_prev : nullptr, dgates, part, part_b,
            nb, cin, F, H, W, has_state ? cin + F : cin};
  bytes = 2 * (size_t)kDkStage * sizeof(float);
  err = allow_smem(dk_mma, bytes);
  if (err != cudaSuccess) return (int)err;
  dk_mma<<<dim3(n_slots, (cin + F + 1 + 15) / 16,
                (4 * F + kGateRows - 1) / kGateRows),
           9 * 32, bytes, st>>>(kd);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16
//
// The bf16 storage mode's reverse sweep. The echo's input is the bf16
// channels-last buffer of the forward (x_e, h_{e-1}, zero padding: the
// recompute's stack), c_{e-1} the stack's bf16 copy (nb, H, W, F).
//  (a) gates_wg_bf16: the forward's mainloop (gate_mainloop_wg) and the
//      cell's derivative in the epilogue; it writes dL/dz rounded to bf16
//      (nearest even), channels-last (nb, H, W, np), np = 4F rounded up to
//      16, and adds db's partial of its 16x8 tile, summed from the f32
//      dL/dz in a fixed order, into its own row of an (nb * tiles, 4F)
//      buffer.
//  (b) dinp_mma_bf16 and (c) dk_mma_bf16 read only bf16 operands, staged
//      with 16-byte cp.async (zero fill outside the image) in a ring of two
//      and fed to m16n8k16 bf16 MMAs by ldmatrix (.trans where the operand
//      is pixel-major: (c)'s dL/dz and input patch). (b)'s flipped weights
//      come pre-packed (ops/convlstm.py::_pack_dinp_weights) as the exact
//      stage image, one contiguous run a stage.
// Their inner loops hold no conversion. Bound on an H100: the necessary
// work (one forward, dinp and dk) is 1.72 TFLOP at Cin=2, F=36, nb=8,
// 384^2, ne=6 (6.75 at F=72), 1.74 ms (6.83) at 989 TFLOP/s dense bf16:
// operations, not bytes, bound it. What holds each stage is in PERF.md.

// (a) in the bf16 storage mode
struct GatesArgsB {
  WgConv conv;             // the input buffer's map, the packed weights
  const uint16_t* bias;    // (4F,)
  const uint16_t* c_prev;  // (nb, H, W, F), unused without state
  const float* dh;         // dL/dh_e (nb, H, W, F)
  const float* dc;         // dL/dc_e (nb, H, W, F), null at the last echo
  uint16_t* dz;            // dL/dz in bf16 (nb, H, W, np)
  float* dc_prev;          // dL/dc_{e-1} (nb, H, W, F), null at echo 0
  float* part_db;          // (nb * 16x8 tiles, 4F) db partials, added to
  int np, has_state;
};

template <int NG>
__device__ __forceinline__ void gates_body_wg(const GatesArgsB& ga,
                                              uint8_t* smem) {
  const WgConv& a = ga.conv;
  const int tiles_x = (a.W + T - 1) / T;
  const int tx0 = (blockIdx.y % tiles_x) * T;
  const int ty0 = (blockIdx.y / tiles_x) * TH;
  const int j0 = blockIdx.x * a.gpb;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x >> 2) & 7;
  const int t = threadIdx.x & 3;
  const int y = ty0 + warp;  // the warp's tile row

  float acc[16 * NG];
  gate_mainloop_wg<NG>(a, smem, b, ty0, tx0, acc);

  // thread (g, t) holds channels f0 = 8*(j0+jj) + 2t and f0 + 1 of pixels
  // g and g + 8 of its row, all 4 gates; with F even the two move as one
  // word
  const bool pairs = a.F % 2 == 0;
  float dbs[NG][4][2];
#pragma unroll
  for (int jj = 0; jj < NG; ++jj)
#pragma unroll
    for (int q = 0; q < 4; ++q) dbs[jj][q][0] = dbs[jj][q][1] = 0.f;
#pragma unroll
  for (int jj = 0; jj < NG; ++jj) {
    const int f0 = 8 * (j0 + jj) + 2 * t;
    if (f0 >= a.F) continue;
    const bool two = f0 + 1 < a.F;
    float bias[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bias[e][q] = bf2f(ga.bias[q * a.F + min(f0 + e, a.F - 1)]);
    {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xx = tx0 + g + 8 * h;
        if (y >= a.H || xx >= a.W) continue;
        const long long pix = ((long long)b * a.H + y) * a.W + xx;
        const long long at = pix * a.F + f0;  // (pixel, f0) in dh, dc, c
        float dh[2] = {0.f, 0.f}, dc[2] = {0.f, 0.f};
        if (pairs) {
          const float2 v = *reinterpret_cast<const float2*>(ga.dh + at);
          dh[0] = v.x;
          dh[1] = v.y;
          if (ga.dc) {
            const float2 u = *reinterpret_cast<const float2*>(ga.dc + at);
            dc[0] = u.x;
            dc[1] = u.y;
          }
        } else {
          for (int e = 0; e < (two ? 2 : 1); ++e) {
            dh[e] = ga.dh[at + e];
            dc[e] = ga.dc ? ga.dc[at + e] : 0.f;
          }
        }
        float cps[2] = {0.f, 0.f};  // c_{e-1}
        if (ga.has_state && pairs) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(ga.c_prev + at);
          cps[0] = bf2f(v & 0xffffu);
          cps[1] = bf2f(v >> 16);
        } else if (ga.has_state) {
          for (int e = 0; e < (two ? 2 : 1); ++e)
            cps[e] = bf2f(ga.c_prev[at + e]);
        }
        float out[2][5];  // dz_i, dz_f, dz_g, dz_o, dc_{e-1}
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * h + e;
          const Cell c = cell(acc[(4 * jj) * 4 + r], acc[(4 * jj + 1) * 4 + r],
                              acc[(4 * jj + 2) * 4 + r],
                              acc[(4 * jj + 3) * 4 + r], bias[e], cps[e]);
          cell_grad(c, cps[e], dh[e], dc[e], out[e]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dbs[jj][q][0] += out[0][q];
          if (two) dbs[jj][q][1] += out[1][q];
        }
        uint16_t* dz = ga.dz + pix * ga.np + f0;
        if (pairs) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<uint32_t*>(dz + q * a.F) =
                pack_bf16(out[0][q], out[1][q]);
          if (ga.dc_prev)
            *reinterpret_cast<float2*>(ga.dc_prev + at) =
                make_float2(out[0][4], out[1][4]);
        } else {
          for (int e = 0; e < (two ? 2 : 1); ++e) {
#pragma unroll
            for (int q = 0; q < 4; ++q) dz[q * a.F + e] = f2bf(out[e][q]);
            if (ga.dc_prev) ga.dc_prev[at + e] = out[e][4];
          }
        }
      }
    }
  }

  // db: the block's sum over its pixels, lanes of one t, then the 8 warps
  // in order (the mainloop ended synchronised: the ring is free)
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int jj = 0; jj < NG; ++jj)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = dbs[jj][q][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[warp * 128 + (4 * jj + q) * 8 + 2 * t + e] = v;
      }
  __syncthreads();
  if (threadIdx.x < 32 * NG) {
    const int n = threadIdx.x;
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * 128 + n];
    const int f = 8 * (j0 + (n >> 5)) + (n & 7);
    if (f < a.F)
      ga.part_db[((long long)b * gridDim.y + blockIdx.y) * 4 * a.F +
                 ((n >> 3) & 3) * a.F + f] += s;
  }
}

__global__ void __launch_bounds__(256, 2)
    gates_wg_bf16(const __grid_constant__ GatesArgsB ga) {
  extern __shared__ __align__(128) uint8_t smem_wg[];
  const int groups = (ga.conv.F + 7) / 8 - (int)blockIdx.x * ga.conv.gpb;
  switch (min(ga.conv.gpb, groups)) {
    case 1:
      gates_body_wg<1>(ga, smem_wg);
      break;
    case 2:
      gates_body_wg<2>(ga, smem_wg);
      break;
    default:  // one instantiation per group count, 1 .. kMaxGroups
      gates_body_wg<kMaxGroups>(ga, smem_wg);
  }
}

// (b) in the bf16 storage mode
struct DinpArgsB {
  const uint16_t* dz;  // (nb, H, W, np)
  const uint16_t* w;   // the packed flipped weights, block after block
  uint16_t* dx;        // echo e of dx (nb, ne, H, W, Cin), may be null
  long long dx_b;      // batch stride of dx (elements)
  float* dh;           // dL/dh_{e-1} (nb, H, W, F), may be null
  // output channels [c0, c1); block y is channel block cb0 + y of cpb
  int cin, F, H, W, np, c0, c1, cpb, cb0;
};

constexpr int kDinpPatch = 2 * P * P * 16;  // two 8-gate halves, 16 B a px

// a (b) stage in bytes: the dz patch and 9 taps x cpb channels x 16 gates
__host__ __device__ inline int dinp_stage_bf16(int cpb) {
  return kDinpPatch + 9 * cpb * 32;
}

// Stage gates [16 s, 16 s + 16) of the dz patch ([half][pixel][8 gates])
// and their packed weights (tap, n8 tile, k half, 8 channels x 8 gates).
__device__ __forceinline__ void dinp_load_bf16(const DinpArgsB& a,
                                               uint8_t* buf, int s, int b,
                                               int ty0, int tx0,
                                               const uint16_t* w) {
  for (int i = threadIdx.x; i < 2 * P * P; i += blockDim.x) {
    const int half = i / (P * P);
    const int pix = i - half * (P * P);
    const int py = pix / P;
    const int y = ty0 + py - 1;
    const int xx = tx0 + (pix - py * P) - 1;
    const bool in = y >= 0 && y < a.H && xx >= 0 && xx < a.W;
    cp16(buf + i * 16,
         in ? a.dz + (((long long)b * a.H + y) * a.W + xx) * a.np + 16 * s +
                  8 * half
            : a.dz,
         in);
  }
  const uint16_t* ws = w + (long long)s * 9 * a.cpb * 16;
  for (int i = threadIdx.x; i < 9 * a.cpb * 2; i += blockDim.x)
    cp16(buf + kDinpPatch + i * 16, ws + i * 8, true);
  __pipeline_commit();
}

// One stage of (b): 9 taps of one k16 step (16 gates) each.
__device__ __forceinline__ void dinp_step_bf16(const uint8_t* st, int cpb,
                                               int nt,
                                               float (&acc)[2][NT][4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int x = lane & 15, hi = lane >> 4;
  const uint32_t patch = smem_u32(st);
  // lane l < 16 addresses row l % 8 of k half l / 8 of an n8 tile
  const uint32_t ws = patch + kDinpPatch + (lane & 15) * 16;
#pragma unroll 3
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    uint32_t fa[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(fa[mi], patch + hi * (P * P * 16) +
                          ((2 * warp + mi + dy) * P + x + dx) * 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) continue;
      uint32_t fb[2];
      ldsm_x2(fb, ws + (tap * (cpb / 8) + j) * 256);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][j], fa[mi], fb);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32, 2)
    dinp_mma_bf16(DinpArgsB a) {
  extern __shared__ __align__(128) uint8_t smem_b[];
  const int tiles_x = (a.W + T - 1) / T;
  const int tx0 = (blockIdx.x % tiles_x) * T;
  const int ty0 = (blockIdx.x / tiles_x) * T;
  const int b = blockIdx.z;
  const int cb = a.cb0 + blockIdx.y;
  const int cbase = cb * a.cpb;
  const int nt = min(a.cpb / 8, (a.c1 - cbase + 7) / 8);
  const int n_s = a.np / 16;
  const uint16_t* w = a.w + (long long)cb * n_s * 9 * a.cpb * 16;
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
      reinterpret_cast<float*>(smem_b), dinp_stage_bf16(a.cpb) / 4, n_s,
      [&](int s, float* buf) {
        dinp_load_bf16(a, reinterpret_cast<uint8_t*>(buf), s, b, ty0, tx0, w);
      },
      [&](const float* st) {
        dinp_step_bf16(reinterpret_cast<const uint8_t*>(st), a.cpb, nt, acc);
      });

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int y = ty0 + 2 * warp + mi;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int xx = tx0 + g + 8 * (r >> 1);
        const int c = cbase + 8 * j + 2 * t + (r & 1);
        if (j >= nt || c < a.c0 || c >= a.c1 || y >= a.H || xx >= a.W)
          continue;
        const long long pix = (long long)y * a.W + xx;
        if (c < a.cin) {
          if (a.dx) a.dx[b * a.dx_b + pix * a.cin + c] = f2bf(acc[mi][j][r]);
        } else if (a.dh) {
          a.dh[((long long)b * a.H * a.W + pix) * a.F + (c - a.cin)] =
              acc[mi][j][r];
        }
      }
    }
  }
}

// (c) in the bf16 storage mode
struct DkArgsB {
  const uint16_t* inp;  // the echo's input buffer (nb, H, W, cp)
  const uint16_t* dz;   // (nb, H, W, np)
  float* part;          // (S, 9, C, 4F) slot partials of dk
  int nb, F, H, W, cp, np, C, ceff;
};

constexpr int kDkDz = kGateRows / 8 * RY * T * 16;  // [octet][pixel][8 gates]
constexpr int kDkPatch = 2 * (RY + 2) * P * 16;     // [half][pixel][8 ch]
constexpr int kDkStageB = kDkDz + kDkPatch;         // bytes

// Stage pixel chunk (b, rows y0 .. y0 + RY - 1, columns x0 .. x0 + 15): its
// dz rows [m0, m0 + 144) and the (RY + 2) x 18 input patch of channels
// [cp0, cp0 + 16), both zero outside.
__device__ __forceinline__ void dk_load_bf16(const DkArgsB& a, uint8_t* buf,
                                             int b, int y0, int x0, int m0,
                                             int cp0) {
  for (int i = threadIdx.x; i < kGateRows / 8 * RY * T; i += blockDim.x) {
    const int o = i / (RY * T);
    const int px = i - o * (RY * T);
    const int y = y0 + px / T;
    const int xx = x0 + px % T;
    const int m = m0 + 8 * o;
    const bool in = y < a.H && xx < a.W && m < a.np;
    cp16(buf + i * 16,
         in ? a.dz + (((long long)b * a.H + y) * a.W + xx) * a.np + m : a.dz,
         in);
  }
  uint8_t* ps = buf + kDkDz;
  for (int i = threadIdx.x; i < 2 * (RY + 2) * P; i += blockDim.x) {
    const int half = i / ((RY + 2) * P);
    const int pix = i - half * ((RY + 2) * P);
    const int py = pix / P;
    const int y = y0 + py - 1;
    const int xx = x0 + (pix - py * P) - 1;
    const int c = cp0 + 8 * half;
    const bool in = c < a.cp && y >= 0 && y < a.H && xx >= 0 && xx < a.W;
    cp16(ps + i * 16,
         in ? a.inp + (((long long)b * a.H + y) * a.W + xx) * a.cp + c
            : a.inp,
         in);
  }
  __pipeline_commit();
}

// One chunk of (c): RY k16 steps, one chunk row of 16 pixels each. A (16
// gates x 16 pixels) and B (16 pixels x 8 channels) by ldmatrix.trans.
__device__ __forceinline__ void dk_step_bf16(const uint8_t* st,
                                             const bool (&used)[2], int mw,
                                             int dy, float (&d)[3][6][4]) {
  const int lane = threadIdx.x & 31;
  const int i8 = lane & 7, mat = lane >> 3;
  const uint32_t ds = smem_u32(st);
  const uint32_t ps = ds + kDkDz;
#pragma unroll 1
  for (int row = 0; row < RY; ++row) {
    // A: matrices (gates 0-7, px 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
    uint32_t fa[3][4];
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
      ldsm_x4_t(fa[mi], ds + (((mw + 16 * mi) / 8 + (mat & 1)) * RY * T +
                              16 * row + 8 * (mat >> 1) + i8) * 16);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      // B: matrices (octet 0, px 0-7), (0, 8-15), (1, 0-7), (1, 8-15)
      uint32_t fb[4];
      ldsm_x4_t(fb, ps + ((mat >> 1) * (RY + 2) * P + (row + dy) * P +
                          8 * (mat & 1) + i8 + dx) * 16);
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        if (!used[o]) continue;
        const uint32_t b2[2] = {fb[2 * o], fb[2 * o + 1]};
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) mma_bf16(d[mi][2 * dx + o], fa[mi], b2);
      }
    }
  }
}

// block (slot, 16 channels, 144 gate rows): 9 warps, warp (dy, third)
__global__ void __launch_bounds__(9 * 32, 1) dk_mma_bf16(DkArgsB a) {
  extern __shared__ __align__(128) uint8_t smem_c[];
  const int N = 4 * a.F;
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
  // octets of the block's 16 channels below ceff (padding past C and echo
  // 0's zero state are skipped)
  const bool used[2] = {cp0 < a.ceff, cp0 + 8 < a.ceff};

  float acc[3][6][4];
#pragma unroll
  for (int mi = 0; mi < 3; ++mi)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0.f;

  ring(
      reinterpret_cast<float*>(smem_c), kDkStageB / 4,
      slot < n_chunks ? (n_chunks - 1 - slot) / S_ + 1 : 0,
      [&](int s, float* buf) {
        const int chunk = slot + s * S_;
        const int xq = chunk % xs;
        const int by = chunk / xs;
        dk_load_bf16(a, reinterpret_cast<uint8_t*>(buf), by / ys,
                     (by % ys) * RY, xq * T, m0, cp0);
      },
      [&](const float* st) {
        if (!rows) return;
        // this chunk's sums on the tensor core from zero, then rounded into
        // the FP32 accumulators (a slot walks thousands of pixels an echo)
        float d[3][6][4];
#pragma unroll
        for (int mi = 0; mi < 3; ++mi)
#pragma unroll
          for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) d[mi][j][r] = 0.f;
        dk_step_bf16(reinterpret_cast<const uint8_t*>(st), used, mw, dy, d);
#pragma unroll
        for (int mi = 0; mi < 3; ++mi)
#pragma unroll
          for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][j][r] += d[mi][j][r];
      });
  if (!rows) return;

  float* part = a.part + (long long)slot * 9 * a.C * N;
#pragma unroll
  for (int mi = 0; mi < 3; ++mi)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = m0 + mw + 16 * mi + g + 8 * (r >> 1);
        const int c = cp0 + 8 * (j & 1) + 2 * t + (r & 1);
        const int tap = dy * 3 + (j >> 1);
        if (n < N && c < a.ceff)
          part[((long long)tap * a.C + c) * N + n] += acc[mi][j][r];
      }
}

// The first dk_blocks blocks: dk[i] = the sum of part[s][i] over the dk
// slots in order. The others, 8 columns each: db[n] = the sum of
// part_db[j][n] over the pixel tiles (nb x 1152 rows at 384^2), 32 row
// lanes each summing every 32nd row in order, then a fixed tree over the
// lanes. Both stored as bf16.
__global__ void __launch_bounds__(256)
    sum_slots_bf16(const float* part, int n_slots, long long K,
                   const float* part_db, int n_db, int N, uint16_t* dk,
                   uint16_t* db, int dk_blocks) {
  if ((int)blockIdx.x < dk_blocks) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < K) {
      float s = 0.f;
      for (int j = 0; j < n_slots; ++j) s += part[j * K + i];
      dk[i] = f2bf(s);
    }
    return;
  }
  __shared__ float red[32][8];
  const int col = threadIdx.x & 7, lane = threadIdx.x >> 3;
  const int n = ((int)blockIdx.x - dk_blocks) * 8 + col;
  float s = 0.f;
  if (n < N) {
#pragma unroll 8
    for (int j = lane; j < n_db; j += 32) s += part_db[(long long)j * N + n];
  }
  red[lane][col] = s;
  __syncthreads();
  for (int w = 16; w > 0; w >>= 1) {
    if (lane < w) red[lane][col] += red[lane + w][col];
    __syncthreads();
  }
  if (lane == 0 && n < N) db[n] = f2bf(red[0][col]);
}

}  // namespace

// Largest shared memory any float32 block of the backward needs at (cin, F).
extern "C" long long convlstm_bwd_smem_bytes(int cin, int F) {
  const size_t a = gates_smem_bytes(gates_gpb(F));
  const size_t b =
      2 * (size_t)dinp_stage(dinp_cpb(cin + F)) * sizeof(float);
  const size_t c = 2 * (size_t)kDkStage * sizeof(float);
  return (long long)(a > b ? (a > c ? a : c) : (b > c ? b : c));
}

// One echo e of the float32 reverse sweep: (a) dgates and dc_{e-1}, (b)
// dh_{e-1} and (when dx is not null) dx_e, (c) dk/db slot partials. Null
// pointers: dc at the last echo; h_prev, c_prev, dc_prev and dh_prev at echo
// 0 (has_state 0). dh, dc, dgates, dc_prev and dh_prev are channels-last
// (nb, H, W, ·); h_prev and c_prev are the forward kernel's (nb, F, H, W).
// Returns the first cudaError_t of the launches (0 on success). The caller
// checks convlstm_bwd_smem_bytes against a block's shared memory.
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long n = K > N ? K : N;
  sum_slots<<<(unsigned)((n + threads - 1) / threads), threads, 0,
              static_cast<cudaStream_t>(stream)>>>(part, part_b, dk, db,
                                                   n_slots, K, N);
  return (int)cudaGetLastError();
}

// One echo e of the reverse sweep in the bf16 storage mode. inp: the echo's
// input buffer (nb, H, W, cp), x_e and h_{e-1} (the recompute's stack);
// w, wb: the packed weights of (a) (_pack_gate_weights at gpb) and (b)
// (_pack_dinp_weights at cpb); c_prev: the stack's bf16 c_{e-1} (nb, H, W,
// F); dh, dc, dc_prev, dh_prev f32 (nb, H, W, F); dz bf16 (nb, H, W, np),
// np = 4F rounded up to 16 (columns past 4F zero); dx bf16 (nb, ne, H, W,
// Cin), echo e; part (n_slots, 9, C, 4F) and part_db (nb * 16x8 pixel
// tiles, 4F) f32 partials, added to. Null pointers as convlstm_echo_bwd. Returns the first
// cudaError_t of the map or the launches.
extern "C" int convlstm_echo_bwd_bf16(
    const uint16_t* inp, const uint16_t* w, const uint16_t* wb,
    const uint16_t* bias, const uint16_t* c_prev, const float* dh,
    const float* dc, uint16_t* dz, float* dc_prev, float* dh_prev,
    uint16_t* dx, long long dx_b, float* part, float* part_db, int n_slots,
    int nb, int cin, int F, int H, int W, int cp, int gpb, int cpb,
    int has_state, int device, void* stream) {
  // the plan (ops/convlstm.py::_bf16_plan) must fit the compiled tiles
  if (gpb < 1 || gpb > kMaxGroups || cp % 8 != 0 || cp < cin + F ||
      cpb < 8 || cpb > kCols || cpb % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = ((W + T - 1) / T) * ((H + T - 1) / T);  // (b): 16x16
  const int tiles8 = ((W + T - 1) / T) * ((H + TH - 1) / TH);  // (a): 16x8
  const int np = (4 * F + 15) / 16 * 16;

  GatesArgsB ga{};
  const int rc = encode_input_map(&ga.conv.in, inp, cp, W, H, nb);
  if (rc != 0) return rc;
  ga.conv.w = w;
  ga.conv.F = F;
  ga.conv.H = H;
  ga.conv.W = W;
  ga.conv.cp = cp;
  ga.conv.gpb = gpb;
  ga.conv.n_chunks = has_state ? (cp + 15) / 16 : (cin + 15) / 16;
  ga.conv.k16 = 9 * (cp / 16) + (cp % 16 ? 5 : 0);
  ga.bias = bias;
  ga.c_prev = c_prev;
  ga.dh = dh;
  ga.dc = dc;
  ga.dz = dz;
  ga.dc_prev = dc_prev;
  ga.part_db = part_db;
  ga.np = np;
  ga.has_state = has_state;
  size_t bytes = wg_smem_bytes(gpb);
  err = allow_smem(gates_wg_bf16, bytes);
  if (err != cudaSuccess) return (int)err;
  gates_wg_bf16<<<dim3(((F + 7) / 8 + gpb - 1) / gpb, tiles8, nb), 256, bytes,
                  st>>>(ga);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int c0 = dx ? 0 : cin;
  const int c1 = has_state ? cin + F : cin;
  if (c1 > c0) {
    DinpArgsB d{dz, wb, dx, dx_b, has_state ? dh_prev : nullptr,
                cin, F, H, W, np, c0, c1, cpb, c0 / cpb};
    bytes = 2 * (size_t)dinp_stage_bf16(cpb);
    err = allow_smem(dinp_mma_bf16, bytes);
    if (err != cudaSuccess) return (int)err;
    dinp_mma_bf16<<<dim3(tiles, (c1 - 1) / cpb - c0 / cpb + 1, nb),
                    kWarps * 32, bytes, st>>>(d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  DkArgsB kd{inp, dz, part, nb, F, H, W, cp, np, cin + F,
             has_state ? cin + F : cin};
  bytes = 2 * (size_t)kDkStageB;
  err = allow_smem(dk_mma_bf16, bytes);
  if (err != cudaSuccess) return (int)err;
  dk_mma_bf16<<<dim3(n_slots, (kd.ceff + 15) / 16,
                     (4 * F + kGateRows - 1) / kGateRows),
                9 * 32, bytes, st>>>(kd);
  return (int)cudaGetLastError();
}

// dk (3, 3, C, 4F) and db (4F) in bf16 from the partials: part (n_slots, K)
// and part_db (n_db, N).
extern "C" int convlstm_bwd_reduce_bf16(const float* part, int n_slots,
                                        long long K, const float* part_db,
                                        int n_db, int N, uint16_t* dk,
                                        uint16_t* db, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int dk_blocks = (int)((K + 255) / 256);
  sum_slots_bf16<<<dk_blocks + (N + 7) / 8, 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      part, n_slots, K, part_db, n_db, N, dk, db, dk_blocks);
  return (int)cudaGetLastError();
}
