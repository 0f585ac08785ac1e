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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;   // tile rows (one per thread row)
constexpr int TW = 16;  // tile columns (pixels per thread)
constexpr int PH = TH + 2;
constexpr int PW = TW + 2;
constexpr int CC = 4;   // input channels per weight stage
constexpr int kMaxThreads = 256;

struct LstmArgs {
  const float* x;  // echo e of x (nb, ne, H, W, Cin): x + e*H*W*Cin
  long long x_b;   // batch stride of x (elements)
  const float* k;  // (3, 3, Cin+F, 4F)
  const float* bias;
  const float* h_prev;  // (nb, F, H, W), unused when !has_state
  const float* c_prev;
  float* h_next;
  float* c_next;  // may be null (last echo)
  int cin, F, H, W, fc, has_state;
};

// the reference's cell activation: tf.nn.leaky_relu, slope 0.2
__device__ __forceinline__ float leaky_relu(float v) {
  return v >= 0.f ? v : 0.2f * v;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// Channel chunking shared by the host and the kernel: at most 32 channels a
// block, so a block has at most TH*32 threads.
__host__ __device__ inline int chunk_width(int F) {
  const int nfc = (F + 31) / 32;
  return (F + nfc - 1) / nfc;
}

// Stage the weights of input channels [c0, c0 + CC) for the block's channel
// chunk into ws[cc][tap][gate][fl]; channels past `ceff` and hidden channels
// past F are zero. Thread (j, fl) of the block's fc x TH threads copies the
// entries of its channel fl, rows q = j, j + TH, ... of the CC*36 (channel,
// tap, gate) rows: coalesced across fl in device memory and in shared memory.
__device__ __forceinline__ void stage_weights(const LstmArgs& a, float* ws,
                                              int c0, int ceff, int f, int fl,
                                              int j) {
  const int C = a.cin + a.F;
  for (int q = j; q < CC * 36; q += TH) {
    const int cc = q / 36;
    const int tg = q - cc * 36;  // tap * 4 + gate
    const int c = c0 + cc;
    float* dst = ws + q * a.fc + fl;
    if (c < ceff && f < a.F) {
      __pipeline_memcpy_async(
          dst, a.k + (((long long)(tg >> 2) * C + c) * 4 + (tg & 3)) * a.F + f,
          sizeof(float));
    } else {
      *dst = 0.f;
    }
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kMaxThreads) convlstm_echo(LstmArgs a) {
  extern __shared__ float smem[];
  const int tiles_x = (a.W + TW - 1) / TW;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int f0 = blockIdx.y * a.fc;
  const int b = blockIdx.z;
  const int ceff = a.has_state ? a.cin + a.F : a.cin;
  const int n_stages = (ceff + CC - 1) / CC;
  const long long hw = (long long)a.H * a.W;
  float* patch = smem;                       // [n_stages*CC][PH][PW]
  float* wbuf = smem + n_stages * CC * PH * PW;  // 2 x [CC][9][4][fc]
  const int wstage = CC * 36 * a.fc;

  const int row = threadIdx.x / a.fc;  // blockDim.x == fc * TH
  const int fl = threadIdx.x % a.fc;
  const int f = f0 + fl;
  stage_weights(a, wbuf, 0, ceff, f, fl, row);
  for (int i = threadIdx.x; i < n_stages * CC * PH * PW; i += blockDim.x) {
    const int c = i / (PH * PW);
    const int r = i - c * (PH * PW);
    const int py = r / PW;
    const int y = ty0 + py - 1;
    const int xx = tx0 + (r - py * PW) - 1;
    if (c < ceff && y >= 0 && y < a.H && xx >= 0 && xx < a.W) {
      const float* src =
          c < a.cin ? a.x + b * a.x_b + ((long long)y * a.W + xx) * a.cin + c
                    : a.h_prev + ((long long)b * a.F + (c - a.cin)) * hw +
                          (long long)y * a.W + xx;
      __pipeline_memcpy_async(patch + i, src, sizeof(float));
    } else {
      patch[i] = 0.f;  // SAME padding ring, and channels past ceff
    }
  }
  __pipeline_commit();

  float acc[4][TW];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int p = 0; p < TW; ++p) acc[g][p] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      stage_weights(a, wbuf + ((s + 1) & 1) * wstage, (s + 1) * CC, ceff, f,
                    fl, row);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float* ws = wbuf + (s & 1) * wstage + fl;
#pragma unroll 1
    for (int cc = 0; cc < CC; ++cc) {
      const float* prow = patch + ((s * CC + cc) * PH + row) * PW;
      const float* wc = ws + cc * 36 * a.fc;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float v[PW];
#pragma unroll
        for (int j = 0; j < PW; ++j) v[j] = prow[dy * PW + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wp = wc + (dy * 3 + dx) * 4 * a.fc;
          const float w0 = wp[0];
          const float w1 = wp[a.fc];
          const float w2 = wp[2 * a.fc];
          const float w3 = wp[3 * a.fc];
#pragma unroll
          for (int p = 0; p < TW; ++p) {
            const float xv = v[p + dx];
            acc[0][p] = fmaf(w0, xv, acc[0][p]);
            acc[1][p] = fmaf(w1, xv, acc[1][p]);
            acc[2][p] = fmaf(w2, xv, acc[2][p]);
            acc[3][p] = fmaf(w3, xv, acc[3][p]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled two stages on
  }

  const int y = ty0 + row;
  if (f >= a.F || y >= a.H) return;
  const float bi = a.bias[f], bf = a.bias[a.F + f];
  const float bg = a.bias[2 * a.F + f], bo = a.bias[3 * a.F + f];
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

size_t smem_bytes(int ceff, int fc) {
  const size_t patch = (size_t)((ceff + CC - 1) / CC * CC) * PH * PW;
  return (patch + 2 * (size_t)CC * 36 * fc) * sizeof(float);
}

}  // namespace

// Shared memory a block needs for `cin` input and F hidden channels with the
// state convolved (the patch and two weight stages).
extern "C" long long convlstm_smem_bytes(int cin, int F) {
  return (long long)smem_bytes(cin + F, chunk_width(F));
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
  const int fc = chunk_width(F);
  const int nfc = (F + fc - 1) / fc;
  const size_t bytes = smem_bytes(has_state ? cin + F : cin, fc);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(convlstm_echo,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
  LstmArgs a{x,   x_b, k, bias, h_prev, c_prev,   h_next,
             c_next, cin, F, H, W,    fc,     has_state};
  const dim3 grid(tiles, nfc, nb);
  convlstm_echo<<<grid, fc * TH, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
