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

#include <cuda_runtime.h>

#include "convlstm_tile.cuh"

namespace {

using namespace convlstm;

struct EchoArgs {
  GateConv conv;        // x_e, k, h_{e-1} and the shape
  const float* bias;    // (4F,)
  const float* c_prev;  // (nb, F, H, W), unused without state
  float* h_next;        // (nb, F, H, W)
  float* c_next;        // (nb, F, H, W), null at the last echo
};

__global__ void __launch_bounds__(kWarps * 32, 2)
    convlstm_echo_mma(EchoArgs ea) {
  extern __shared__ float smem[];
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
      const float bi = ea.bias[f], bf = ea.bias[a.F + f];
      const float bg = ea.bias[2 * a.F + f], bo = ea.bias[3 * a.F + f];
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
          const float cp = a.has_state ? ea.c_prev[o] : 0.f;
          const float cn = gf * cp + gi * gg;
          ea.h_next[o] = go * leaky_relu(cn);
          if (ea.c_next) ea.c_next[o] = cn;
        }
      }
    }
  }
}

}  // namespace

// Dynamic shared memory a block needs for F hidden channels: two
// channel-octet stages, whatever Cin is.
extern "C" long long convlstm_smem_bytes(int F) {
  return (long long)gates_smem_bytes(gates_gpb(F));
}

// One echo. Returns the cudaError_t of the launch (0 on success). The caller
// checks that the grid (ceil(F/8 / gpb), 16x16 tiles, nb) fits the launch
// limits. h_prev and c_prev may be null when has_state is 0 (echo 0).
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
                      kWarps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      ea);
  return (int)cudaGetLastError();
}
