// The gate convolution of one ConvLSTM echo over a pixel tile, shared by the
// forward kernel (convlstm_fwd.cu) and the backward's gate recompute
// (convlstm_bwd.cu):
//
//   gates = conv3x3_SAME(concat(x_e, h_{e-1}), k)            (4F channels)
//
// without the bias. Design (see convlstm_fwd.cu for the reasoning):
//  - A block owns a TH x TW pixel tile of one image (blockIdx.x, blockIdx.z)
//    and a chunk of fc hidden channels (blockIdx.y). It stages the
//    (TH+2) x (TW+2) x C input patch (x_e and h_{e-1}, zero outside the
//    image, which gives SAME padding) in shared memory with cp.async.
//  - Thread (row, f) computes the four gates of channel f for the TW pixels
//    of one tile row: 4*TW accumulators in registers.
//  - Weights are staged in shared memory CC input channels at a time,
//    double-buffered with cp.async.
//  - State is float32 NCHW (nb, F, H, W). Without state (echo 0) only the
//    Cin input channels are convolved.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace convlstm {

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
  float* h_next;   // forward outputs
  float* c_next;   // may be null (last echo)
  const float* dh;  // backward: dL/dh_e (nb, F, H, W)
  const float* dc;  // backward: dL/dc_e, null at the last echo
  float* dgates;    // backward: dL/dgates (nb, 4F, H, W)
  float* dc_prev;   // backward: dL/dc_{e-1}, null at echo 0
  int cin, F, H, W, fc, has_state;
};

// the reference's cell activation: tf.nn.leaky_relu, slope 0.2
__device__ __forceinline__ float leaky_relu(float v) {
  return v >= 0.f ? v : 0.2f * v;
}

// its derivative, 1 at 0 as in the JAX package (where(x >= 0, x, 0.2x))
__device__ __forceinline__ float leaky_relu_grad(float v) {
  return v >= 0.f ? 1.f : 0.2f;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// Channel chunking shared by the host and the kernels: at most 32 channels a
// block, so a block has at most TH*32 threads.
__host__ __device__ inline int chunk_width(int F) {
  const int nfc = (F + 31) / 32;
  return (F + nfc - 1) / nfc;
}

// Shared memory a block needs for `ceff` convolved channels and chunk fc.
inline size_t tile_smem_bytes(int ceff, int fc) {
  const size_t patch = (size_t)((ceff + CC - 1) / CC * CC) * PH * PW;
  return (patch + 2 * (size_t)CC * 36 * fc) * sizeof(float);
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

// The tile's gate sums: acc[gate][p] for channel f = blockIdx.y*fc +
// threadIdx.x % fc and pixel p of tile row threadIdx.x / fc. Every thread of
// the block must call it (it synchronises the block).
__device__ __forceinline__ void gate_sums(const LstmArgs& a,
                                          float (&acc)[4][TW]) {
  extern __shared__ float smem[];
  const int tiles_x = (a.W + TW - 1) / TW;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int f0 = blockIdx.y * a.fc;
  const int b = blockIdx.z;
  const int ceff = a.has_state ? a.cin + a.F : a.cin;
  const int n_stages = (ceff + CC - 1) / CC;
  const long long hw = (long long)a.H * a.W;
  float* patch = smem;                           // [n_stages*CC][PH][PW]
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
}

// Launch geometry of a gate-tile kernel: (tiles, channel chunks, nb) blocks
// of fc*TH threads, and its dynamic shared memory (raising the kernel's
// limit above 48 KB when needed).
template <class Kernel>
cudaError_t launch_gate_tiles(Kernel kernel, const LstmArgs& a, int nb,
                              cudaStream_t stream) {
  const int nfc = (a.F + a.fc - 1) / a.fc;
  const size_t bytes =
      tile_smem_bytes(a.has_state ? a.cin + a.F : a.cin, a.fc);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int tiles = ((a.W + TW - 1) / TW) * ((a.H + TH - 1) / TH);
  const dim3 grid(tiles, nfc, nb);
  kernel<<<grid, a.fc * TH, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace convlstm
