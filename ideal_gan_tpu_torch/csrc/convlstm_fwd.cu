// One echo of the multi-echo ConvLSTM forward, with the gate epilogue fused.
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
// its gates in registers and applies the cell update in place.
//
// Bound on an H100: operations. Per echo and pixel the convolution does
// 2*9*(Cin+F)*4F FLOP: 98.5 kFLOP at Cin=2, F=36 and 95.9 kFLOP at Cin=1.
// At 384^2, ne=6, nb=8 that is 697 and 679 GFLOP (less at echo 0, where the
// state is zero and only the Cin input channels contribute), or about
// 10 ms per net at the H100 SXM's 67 TFLOP/s FP32. State traffic (read
// x_e, h, c; write h, c) is about 0.7 GB per echo, about 1.2 ms per net at
// 3.35 TB/s, so the FP32 units and not memory set the floor.
//
// Design (a simple FP32 form; TF32 tensor cores, TMA and a whole-recurrence
// kernel with on-chip state are later steps):
//  - A block owns a TH x TW pixel tile of one image and a chunk of FC hidden
//    channels. It stages the (TH+2) x (TW+2) x C input patch (x_e and
//    h_{e-1}, zero outside the image, which gives SAME padding) in shared
//    memory once, with cp.async so the loads are all in flight together.
//  - Thread (row, f) computes the four gates of channel f for the TW pixels
//    of one tile row: 4*TW accumulators in registers. Per (channel, dy) it
//    reads TW+2 patch values and, per dx, four weights; that is 64 FMAs per
//    4 weight loads and ~6 per patch load, so the FMA pipes rather than the
//    load units limit it.
//  - Weights are staged in shared memory too, CC input channels at a time
//    (9 taps x 4 gates x FC floats per channel), double-buffered with
//    cp.async so the next group streams in while this one is used: read
//    straight from device memory, the block's ~100 KB of weights did not
//    stay in L1 and every load waited on L2.
//  - State is float32 NCHW (nb, F, H, W). At echo 0 the state is zero, so
//    only the Cin input channels are convolved and no state is read.
//  - Math is float32 on CUDA cores; no library GEMM or convolution.
//  - The tile convolution lives in convlstm_tile.cuh, shared with the
//    backward's gate recompute (convlstm_bwd.cu).

#include <cuda_runtime.h>

#include "convlstm_tile.cuh"

namespace {

using namespace convlstm;

__global__ void __launch_bounds__(kMaxThreads) convlstm_echo(LstmArgs a) {
  float acc[4][TW];
  gate_sums(a, acc);
  const int tiles_x = (a.W + TW - 1) / TW;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int y = (blockIdx.x / tiles_x) * TH + threadIdx.x / a.fc;
  const int f = blockIdx.y * a.fc + threadIdx.x % a.fc;
  const int b = blockIdx.z;
  if (f >= a.F || y >= a.H) return;
  const float bi = a.bias[f], bf = a.bias[a.F + f];
  const float bg = a.bias[2 * a.F + f], bo = a.bias[3 * a.F + f];
  const long long hw = (long long)a.H * a.W;
  const long long base = ((long long)b * a.F + f) * hw + (long long)y * a.W;
#pragma unroll
  for (int p = 0; p < TW; ++p) {
    const int xx = tx0 + p;
    if (xx < a.W) {
      const long long o = base + xx;
      const float gi = sigmoid(acc[0][p] + bi);
      const float gf = sigmoid(acc[1][p] + bf);
      const float gg = leaky_relu(acc[2][p] + bg);
      const float go = sigmoid(acc[3][p] + bo);
      const float cp = a.has_state ? a.c_prev[o] : 0.f;
      const float cn = gf * cp + gi * gg;
      a.h_next[o] = go * leaky_relu(cn);
      if (a.c_next) a.c_next[o] = cn;
    }
  }
}

}  // namespace

// Shared memory a block needs for `cin` input and F hidden channels with the
// state convolved (the patch and two weight stages).
extern "C" long long convlstm_smem_bytes(int cin, int F) {
  return (long long)tile_smem_bytes(cin + F, chunk_width(F));
}

// One echo. Returns the cudaError_t of the launch (0 on success). The caller
// checks that convlstm_smem_bytes(cin, F) fits in a block's shared memory.
extern "C" int convlstm_echo_fwd(const float* x, long long x_b,
                                 const float* k, const float* bias,
                                 const float* h_prev, const float* c_prev,
                                 float* h_next, float* c_next, int nb,
                                 int cin, int F, int H, int W, int has_state,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  LstmArgs a{x,       x_b,     k,       bias,    h_prev, c_prev,
             h_next,  c_next,  nullptr, nullptr, nullptr, nullptr,
             cin,     F,       H,       W,       chunk_width(F), has_state};
  return (int)launch_gate_tiles(convlstm_echo, a, nb,
                                static_cast<cudaStream_t>(stream));
}
