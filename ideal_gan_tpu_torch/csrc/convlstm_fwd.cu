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
// `convlstm_echo_mma_bf16`) is the TPU kernel's bf16 form: x, k, the bias
// and the state are bf16; the gate product multiplies bf16 operands with f32
// accumulation (one m16n8k16 MMA where 3xTF32 takes three, the bf16 mainloop
// of convlstm_tile.cuh); the bias is added, the gates and the cell computed
// in f32; h and c are rounded to bf16 at the end of every echo. Its
// recompute form for the backward reads c_{e-1} in f32 and writes c_e in f32
// (the chain) and as a bf16 copy (the sweep's stack), as the TPU backward
// carries its cell in f32. Bound: 2.275 TFLOP at F=72 (Cin=2, nb=8, 384^2,
// ne=6) is 2.3 ms at 989 TFLOP/s dense bf16; 587 GFLOP at F=36 is 0.59 ms.

#include <cuda_runtime.h>

#include "convlstm_tile.cuh"

namespace {

using namespace convlstm;

// The echo's operands, stored as S (float, or the bits of bf16). c_prev32
// and c_next32 are the bf16 recompute's float32 cell chain (null otherwise,
// and always for float32).
template <class S>
struct EchoArgsT {
  GateConvT<S> conv;      // x_e, k, h_{e-1} and the shape
  const S* bias;          // (4F,)
  const S* c_prev;        // (nb, F, H, W), unused without state
  S* h_next;              // (nb, F, H, W)
  S* c_next;              // (nb, F, H, W), or null (the last echo)
  const float* c_prev32;  // (nb, F, H, W) f32 c_{e-1}, or null
  float* c_next32;        // f32 c_e, or null
};
using EchoArgs = EchoArgsT<float>;

template <class S>
__device__ __forceinline__ void echo_body(const EchoArgsT<S>& ea,
                                          float* smem) {
  constexpr bool bf16 = sizeof(S) == 2;
  const GateConvT<S>& a = ea.conv;
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
      const float bi = load_f(ea.bias, f), bf = load_f(ea.bias, a.F + f);
      const float bg = load_f(ea.bias, 2 * a.F + f);
      const float bo = load_f(ea.bias, 3 * a.F + f);
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
          const float gi = sigmoid(acc[mi][jj][0][r] + bi);
          const float gf = sigmoid(acc[mi][jj][1][r] + bf);
          const float gg = leaky_relu(acc[mi][jj][2][r] + bg);
          const float go = sigmoid(acc[mi][jj][3][r] + bo);
          const float cp = !a.has_state           ? 0.f
                           : bf16 && ea.c_prev32 ? ea.c_prev32[o]
                                                 : load_f(ea.c_prev, o);
          const float cn = gf * cp + gi * gg;
          store_f(ea.h_next, o, go * leaky_relu(cn));
          if (ea.c_next) store_f(ea.c_next, o, cn);
          if (bf16 && ea.c_next32) ea.c_next32[o] = cn;
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

__global__ void __launch_bounds__(kWarps * 32, 2)
    convlstm_echo_mma_bf16(EchoArgsT<uint16_t> ea) {
  extern __shared__ float smem[];
  echo_body(ea, smem);
}

template <class S>
int echo_fwd(const S* x, long long x_b, const S* k, const S* bias,
             const S* h_prev, const S* c_prev, const float* c_prev32,
             S* h_next, S* c_next, float* c_next32, int nb, int cin, int F,
             int H, int W, int has_state, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int gpb = gates_gpb(F);
  EchoArgsT<S> ea{{x, x_b, k, h_prev, cin, F, H, W, has_state, gpb},
                  bias, c_prev, h_next, c_next, c_prev32, c_next32};
  const size_t bytes = gates_smem_bytes<S>(gpb);
  void (*kernel)(EchoArgsT<S>);
  if constexpr (sizeof(S) == 2) {
    kernel = convlstm_echo_mma_bf16;
  } else {
    kernel = convlstm_echo_mma;
  }
  err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((W + T - 1) / T) * ((H + T - 1) / T);
  // channel chunks fastest: the blocks that stage one tile's input patch
  // run together and share it in L2
  kernel<<<dim3(((F + 7) / 8 + gpb - 1) / gpb, tiles, nb), kWarps * 32, bytes,
           static_cast<cudaStream_t>(stream)>>>(ea);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a block needs for F hidden channels: two
// channel-octet stages, whatever Cin is (float32's, the larger).
extern "C" long long convlstm_smem_bytes(int F) {
  return (long long)gates_smem_bytes<float>(gates_gpb(F));
}

// One echo. Returns the cudaError_t of the launch (0 on success). The caller
// checks that the grid (ceil(F/8 / gpb), 16x16 tiles, nb) fits the launch
// limits. h_prev and c_prev may be null when has_state is 0 (echo 0);
// c_prev32 and c_next32 must be null (the bf16 entry's cell chain).
extern "C" int convlstm_echo_fwd(const float* x, long long x_b,
                                 const float* k, const float* bias,
                                 const float* h_prev, const float* c_prev,
                                 const float* c_prev32, float* h_next,
                                 float* c_next, float* c_next32, int nb,
                                 int cin, int F, int H, int W, int has_state,
                                 int device, void* stream) {
  return echo_fwd(x, x_b, k, bias, h_prev, c_prev, c_prev32, h_next, c_next,
                  c_next32, nb, cin, F, H, W, has_state, device, stream);
}

// One echo in the bf16 storage mode (bf16 bits as uint16_t). The forward
// passes c_prev (bf16) and c_next (null at the last echo); the backward's
// recompute passes c_prev32 (in place of c_prev) and both c_next (the
// stack's copy) and c_next32 (the chain). Returns the cudaError_t of the
// launch.
extern "C" int convlstm_echo_fwd_bf16(
    const uint16_t* x, long long x_b, const uint16_t* k, const uint16_t* bias,
    const uint16_t* h_prev, const uint16_t* c_prev, const float* c_prev32,
    uint16_t* h_next, uint16_t* c_next, float* c_next32, int nb, int cin,
    int F, int H, int W, int has_state, int device, void* stream) {
  return echo_fwd(x, x_b, k, bias, h_prev, c_prev, c_prev32, h_next, c_next,
                  c_next32, nb, cin, F, H, W, has_state, device, stream);
}
