// One echo of the multi-echo ConvLSTM forward, an implicit GEMM on the
// H100's tensor cores in split TF32 (3xTF32) with the LSTM cell fused into
// its epilogue.
//
// Replaces the TPU kernel `_fwd_kernel` of
// ideal_gan_tpu/ops/pallas_convlstm.py (launched there by `convlstm_pallas`).
// The host calls this kernel once per echo e with ping-pong state buffers:
//
//   gates  = conv3x3_SAME(concat(x_e, h_{e-1}), k) + bias      (4F channels)
//   i, f, g, o = split(gates)                       (keras order i, f, g, o)
//   c_e = rec(f) * c_{e-1} + rec(i) * act(g)
//   h_e = rec(o) * act(c_e)
//
// with act = leaky_relu(0.2) and rec = sigmoid, the ConvLSTM's activations
// everywhere in the model zoo (the wrapper rejects other pairs). The
// (nb, 4F, H, W) gate tensor never reaches device memory: each thread keeps
// its gates in registers and applies the cell update in place. The same
// kernel recomputes the states for the backward (convlstm_bwd.cu).
//
// Bound on an H100 (NVIDIA H100 SXM data sheet): operations. Per echo and
// pixel the gate product is 2*9*(Cin+F)*4F FLOP: 98.5 kFLOP at Cin=2, F=36.
// At 384^2, ne=6, nb=8 that is 587 GFLOP (echo 0 convolves only the Cin
// input channels; 2.275 TFLOP at F=72): 3.56 ms as 3xTF32 at 495/3 TFLOP/s
// (8.76 ms as FP32 on the CUDA cores at 67). State traffic (read x_e, c;
// write h, c) is about 0.7 GB an echo at F=36, about 1.2 ms a call at
// 3.35 TB/s, so the MMAs and not memory set the floor.
//
// Design: the gate product is the backward's stage (a) mainloop,
// `convlstm_tile.cuh::gate_mainloop`: a block owns a 16x16 pixel tile of one
// image and up to two groups of 8 hidden channels (4 gates each, so N = 64
// columns), 8 warps of two m16 tile rows; K runs over channel octets x 9
// taps, staged with cp.async in a ring of two; every k8 step is summed on
// the tensor core from zero and rounded into FP32 registers (the core's
// accumulation truncates, and the gate values decide leaky_relu's
// branches). Blocks need 72.6 KB of shared memory whatever C is, so two
// share an SM. The grid runs one tile's channel chunks next to each other,
// so L2 serves the patch they all stage. The epilogue reads c_{e-1} and
// writes h_e and c_e in NCHW (nb, F, H, W): a warp's store covers 8
// contiguous pixels of 4 channel rows, whole 32-byte sectors. Hidden
// channels past F (the last octet's padding) are never written.
//
// The bfloat16 storage mode (`convlstm_echo_fwd_bf16`, kernel
// `convlstm_echo_wg_bf16`) is the TPU kernel's bf16 form: x, k, the bias and
// the state are bf16; the gate product multiplies bf16 operands with f32
// accumulation; the bias is added, the gates and the cell computed in f32;
// h and c are rounded to bf16 at the end of every echo. Its mainloop is
// convlstm_tile.cuh's `gate_mainloop_wg` (TMA-staged patches of the
// channels-last input buffer, pre-packed weights in one bulk copy a stage,
// a ring of three stages on mbarriers, wgmma with A from ldmatrix). The
// epilogue writes h_e as bf16 straight into the next echo's input buffer
// (channels [Cin, Cin+F) of (nb, H, W, Cp)), or into the (nb, H, W, F)
// result at the last echo, and c_e into an (nb, H, W, F) buffer. Its
// recompute form for the backward reads c_{e-1} in f32 and writes c_e in f32
// (the chain) and as a bf16 copy (the sweep's stack), as the TPU backward
// carries its cell in f32. Bound: 2.275 TFLOP at F=72 (Cin=2, nb=8, 384^2,
// ne=6) is 2.3 ms at 989 TFLOP/s dense bf16; 587 GFLOP at F=36 is 0.59 ms.
// A block (256 threads, two warpgroups, a 16x8 pixel tile) holds a ring of
// 3 x 33 KB at gpb=3 and under 128 registers a thread, so two blocks share
// an SM; what sets its pace is in PERF.md.

#include <cuda_runtime.h>

#include "convlstm_tile.cuh"

namespace {

using namespace convlstm;

// The echo's float32 operands.
struct EchoArgs {
  GateConv conv;        // x_e, k, h_{e-1} and the shape
  const float* bias;    // (4F,)
  const float* c_prev;  // (nb, F, H, W), unused without state
  float* h_next;        // (nb, F, H, W)
  float* c_next;        // (nb, F, H, W), or null (the last echo)
};

__device__ __forceinline__ void echo_body(const EchoArgs& ea, float* smem) {
  const GateConv& a = ea.conv;
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

  // thread (g, t) holds, for tile rows 2*warp + mi, pixels g and g + 8
  // (fragment halves h) of channels 8*(j0+jj) + 2t + e (e = 0, 1), all
  // four gates: acc[mi][jj][q][2*h + e]
  const long long hw = (long long)a.H * a.W;
#pragma unroll
  for (int jj = 0; jj < kGroups; ++jj) {
    if (jj >= ng) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = (j0 + jj) * 8 + 2 * t + e;
      if (f >= a.F) continue;
      const float bias[4] = {load_f(ea.bias, f), load_f(ea.bias, a.F + f),
                             load_f(ea.bias, 2 * a.F + f),
                             load_f(ea.bias, 3 * a.F + f)};
      const long long plane = ((long long)b * a.F + f) * hw;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int y = ty0 + 2 * warp + mi;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int xx = tx0 + g + 8 * h;
          if (y >= a.H || xx >= a.W) continue;
          const int r = 2 * h + e;
          const long long o = plane + (long long)y * a.W + xx;
          const float cp = !a.has_state ? 0.f : load_f(ea.c_prev, o);
          const Cell c = cell(acc[mi][jj][0][r], acc[mi][jj][1][r],
                              acc[mi][jj][2][r], acc[mi][jj][3][r], bias, cp);
          store_f(ea.h_next, o, c.o * leaky_relu(c.c));
          if (ea.c_next) store_f(ea.c_next, o, c.c);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32, 2)
    convlstm_echo_mma(EchoArgs ea) {
  extern __shared__ float smem[];
  echo_body(ea, smem);
}

// ---------------------------------------------------------------- bf16

// The echo's bf16 operands (bf16 bits as uint16_t); c_prev32 and c_next32
// are the recompute's float32 cell chain (null in the forward).
struct EchoArgsB {
  WgConv conv;             // the input buffer's map, the packed weights
  const uint16_t* bias;    // (4F,)
  const uint16_t* c_prev;  // (nb, H, W, F), unused without state
  const float* c_prev32;   // f32 c_{e-1} (nb, H, W, F), or null
  uint16_t* h_next;        // h_e of pixel p, channel f: p * h_stride + f
  long long h_stride;
  uint16_t* c_next;  // (nb, H, W, F), or null (the last echo)
  float* c_next32;   // f32 c_e, or null
  int has_state;
};

template <int NG>
__device__ __forceinline__ void echo_body_wg(const EchoArgsB& ea,
                                             uint8_t* smem) {
  const WgConv& a = ea.conv;
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

  // channels f0, f0 + 1 move as one 32-bit word where both are in range
  // and the word is aligned
  const bool h_pairs =
      ((reinterpret_cast<uintptr_t>(ea.h_next) | ea.h_stride * 2) & 3) == 0;
  const bool f_pairs = a.F % 2 == 0;
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
        bias[e][q] = bf2f(ea.bias[q * a.F + min(f0 + e, a.F - 1)]);
    {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xx = tx0 + g + 8 * h;
        if (y >= a.H || xx >= a.W) continue;
        const long long pix = ((long long)b * a.H + y) * a.W + xx;
        const long long o = pix * a.F + f0;
        float cps[2] = {0.f, 0.f};  // c_{e-1}
        if (ea.has_state && two && f_pairs) {
          if (ea.c_prev32) {
            const float2 v = *reinterpret_cast<const float2*>(ea.c_prev32 + o);
            cps[0] = v.x;
            cps[1] = v.y;
          } else {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(ea.c_prev + o);
            cps[0] = bf2f(v & 0xffffu);
            cps[1] = bf2f(v >> 16);
          }
        } else if (ea.has_state) {
          for (int e = 0; e < (two ? 2 : 1); ++e)
            cps[e] = ea.c_prev32 ? ea.c_prev32[o + e] : bf2f(ea.c_prev[o + e]);
        }
        float hv[2], cv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * h + e;
          const float cp = cps[e];
          const Cell c = cell(acc[(4 * jj) * 4 + r], acc[(4 * jj + 1) * 4 + r],
                              acc[(4 * jj + 2) * 4 + r],
                              acc[(4 * jj + 3) * 4 + r], bias[e], cp);
          hv[e] = c.o * leaky_relu(c.c);
          cv[e] = c.c;
        }
        uint16_t* hp = ea.h_next + pix * ea.h_stride + f0;
        if (two && h_pairs) {
          *reinterpret_cast<uint32_t*>(hp) = pack_bf16(hv[0], hv[1]);
        } else {
          hp[0] = f2bf(hv[0]);
          if (two) hp[1] = f2bf(hv[1]);
        }
        if (ea.c_next) {
          if (two && f_pairs) {
            *reinterpret_cast<uint32_t*>(ea.c_next + o) =
                pack_bf16(cv[0], cv[1]);
          } else {
            ea.c_next[o] = f2bf(cv[0]);
            if (two) ea.c_next[o + 1] = f2bf(cv[1]);
          }
        }
        if (ea.c_next32) {
          if (two && f_pairs) {
            *reinterpret_cast<float2*>(ea.c_next32 + o) =
                make_float2(cv[0], cv[1]);
          } else {
            ea.c_next32[o] = cv[0];
            if (two) ea.c_next32[o + 1] = cv[1];
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(256, 2)
    convlstm_echo_wg_bf16(const __grid_constant__ EchoArgsB ea) {
  extern __shared__ __align__(128) uint8_t smem_wg[];
  const int groups = (ea.conv.F + 7) / 8 - (int)blockIdx.x * ea.conv.gpb;
  switch (min(ea.conv.gpb, groups)) {
    case 1:
      echo_body_wg<1>(ea, smem_wg);
      break;
    case 2:
      echo_body_wg<2>(ea, smem_wg);
      break;
    default:  // one instantiation per group count, 1 .. kMaxGroups
      echo_body_wg<kMaxGroups>(ea, smem_wg);
  }
}

}  // namespace

// Dynamic shared memory a float32 block needs for F hidden channels: two
// channel-octet stages, whatever Cin is.
extern "C" long long convlstm_smem_bytes(int F) {
  return (long long)gates_smem_bytes(gates_gpb(F));
}

// One float32 echo. Returns the cudaError_t of the launch (0 on success).
// The caller checks that the grid (ceil(F/8 / gpb), 16x16 tiles, nb) fits
// the launch limits. h_prev and c_prev may be null when has_state is 0
// (echo 0).
extern "C" int convlstm_echo_fwd(const float* x, long long x_b,
                                 const float* k, const float* bias,
                                 const float* h_prev, const float* c_prev,
                                 float* h_next, float* c_next, int nb,
                                 int cin, int F, int H, int W, int has_state,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int gpb = gates_gpb(F);
  EchoArgs ea{{x, x_b, k, h_prev, cin, F, H, W, has_state, gpb},
              bias, c_prev, h_next, c_next};
  const size_t bytes = gates_smem_bytes(gpb);
  err = allow_smem(convlstm_echo_mma, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((W + T - 1) / T) * ((H + T - 1) / T);
  // channel chunks fastest: the blocks that stage one tile's input patch
  // run together and share it in L2
  convlstm_echo_mma<<<dim3(((F + 7) / 8 + gpb - 1) / gpb, tiles, nb),
                      kWarps * 32, bytes,
                      static_cast<cudaStream_t>(stream)>>>(ea);
  return (int)cudaGetLastError();
}

// One echo in the bf16 storage mode (bf16 bits as uint16_t) over the input
// buffer `inp` (nb, H, W, cp): x_e, h_{e-1}, zero padding; `w` the packed
// weights (ops/convlstm.py::_pack_gate_weights at gpb <= 3 groups a block;
// the grid: column blocks, 16x8 pixel tiles, images). The
// forward passes c_prev (bf16, null at echo 0) and c_next (null at the last
// echo); the backward's recompute passes c_prev32 (in place of c_prev) and
// both c_next (the stack's copy) and c_next32 (the chain). h_e goes to
// h_next[pixel * h_stride + f]. Echo 0 (has_state 0) sums only the chunks
// that hold x. Returns the cudaError_t of the launch or of the map, and
// cudaErrorInvalidValue for a plan the compiled tiles do not fit.
extern "C" int convlstm_echo_fwd_bf16(
    const uint16_t* inp, const uint16_t* w, const uint16_t* bias,
    const uint16_t* c_prev, const float* c_prev32, uint16_t* h_next,
    long long h_stride, uint16_t* c_next, float* c_next32, int nb, int cin,
    int F, int H, int W, int cp, int gpb, int has_state, int device,
    void* stream) {
  // the plan (ops/convlstm.py::_bf16_plan) must fit the compiled tiles
  if (gpb < 1 || gpb > kMaxGroups || cp % 8 != 0 || cp < cin + F)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  EchoArgsB ea{};
  const int rc = encode_input_map(&ea.conv.in, inp, cp, W, H, nb);
  if (rc != 0) return rc;
  ea.conv.w = w;
  ea.conv.F = F;
  ea.conv.H = H;
  ea.conv.W = W;
  ea.conv.cp = cp;
  ea.conv.gpb = gpb;
  ea.conv.n_chunks = has_state ? (cp + 15) / 16 : (cin + 15) / 16;
  ea.conv.k16 = 9 * (cp / 16) + (cp % 16 ? 5 : 0);
  ea.bias = bias;
  ea.c_prev = c_prev;
  ea.c_prev32 = c_prev32;
  ea.h_next = h_next;
  ea.h_stride = h_stride;
  ea.c_next = c_next;
  ea.c_next32 = c_next32;
  ea.has_state = has_state;
  const size_t bytes = wg_smem_bytes(gpb);
  err = allow_smem(convlstm_echo_wg_bf16, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((W + T - 1) / T) * ((H + TH - 1) / TH);
  convlstm_echo_wg_bf16<<<dim3(((F + 7) / 8 + gpb - 1) / gpb, tiles, nb), 256,
                          bytes, static_cast<cudaStream_t>(stream)>>>(ea);
  return (int)cudaGetLastError();
}
