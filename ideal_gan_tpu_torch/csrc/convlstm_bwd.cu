// The multi-echo ConvLSTM backward, one echo of the reverse sweep per call.
//
// Replaces the TPU kernel `_bwd_kernel` of
// ideal_gan_tpu/ops/pallas_convlstm.py (launched there by
// `convlstm_bwd_pallas` from the custom VJP `_fused_bwd`). The host first
// recomputes the per-echo states h_e, c_e (e < ne-1) with the forward kernel
// (convlstm_fwd.cu) into an (ne-1, nb, F, H, W) stack, then calls
// `convlstm_echo_bwd` for e = ne-1 .. 0 and `convlstm_bwd_reduce` once:
//
//  (a) gates_bwd: recompute the gates of echo e from (x_e, h_{e-1}) with the
//      forward kernel's tiling (convlstm_tile.cuh) and apply the cell's
//      derivative in the epilogue:
//        dc~   = dc_e + dh_e * o * lrelu'(c_e)
//        dz_i  = dc~ * g * i(1-i)      dz_f = dc~ * c_{e-1} * f(1-f)
//        dz_g  = dc~ * i * lrelu'(z_g) dz_o = dh_e * lrelu(c_e) * o(1-o)
//        dc_{e-1} = dc~ * f
//      with sigmoid' = s(1-s) and lrelu' = 1 for x >= 0, else 0.2 (the JAX
//      package's convention at 0). Writes dgates (nb, 4F, H, W).
//  (b) dinp_kernel: the SAME transposed 3x3 convolution of dgates with k,
//      i.e. a forward convolution with the spatially flipped kernel
//      wt[n][tap][c] = k[8 - tap][c][n]. Gives dh_{e-1} (channels c >= Cin)
//      and, when asked, dx_e (c < Cin).
//  (c) dk_kernel: dk[tap][c][n] += sum over pixels of
//      concat(x_e, h_{e-1})[c] shifted by tap, times dgates[n]; db[n] +=
//      sum of dgates[n]. Deterministic: block (slot, chunk) walks the pixel
//      tiles t = slot, slot + S, ... in order and adds into its own slot of
//      a (S, 9, C, 4F) scratch buffer, across echoes too; the reduction
//      kernel then sums the S slots in a fixed order. No float atomics, so
//      two runs give the same gradients.
//  Echo 0 has zero state: its state channels, dh_{-1} and dc_{-1} are
//  skipped.
//
// Bound on an H100: operations. Per echo and pixel each of the gate
// recompute, dinp and dk does up to 2*9*(Cin+F)*4F FLOP (98.5 kFLOP at
// Cin=2, F=36); with the state recompute the kernels do 2.2 TFLOP per net
// at 384^2, ne=6, nb=8 (33 ms at 67 TFLOP/s FP32). The necessary work (one
// forward plus dinp and dk) is 1.72 TFLOP, 25.7 ms.
//
// Design: a simple FP32 form on CUDA cores (no tensor cores, no TMA):
//  - (a) and (b) keep 4 output channels x 16 pixels of accumulators per
//    thread and stage input patch and weights in shared memory with
//    cp.async (double-buffered in (b), which has 4F = 144 input channels);
//  - (c) keeps, per work item (input channel c, 4 gate channels), the 9 taps
//    x 4 gates in registers; per tile row it loads 4 x 16 dgates and
//    3 x 18 patch values for 576 FMAs.
//  - The TPU kernel's whole-recurrence VMEM state, taint fronts and dx
//    overlap-add have no counterpart: per-echo launches need none of them.
// Math is float32; no library GEMM or convolution.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "convlstm_tile.cuh"

namespace {

using namespace convlstm;

constexpr int DCC = 8;         // dgates channels per dinp stage
constexpr int kMaxGroups = 32;  // output-channel groups of 4 per dinp block
constexpr int NG = 9;          // gate-channel groups of 4 per dk block
constexpr int DPS = TH * TW + 1;  // padded plane stride of the dgates tile

// (a) gate recompute with the cell derivative in the epilogue
__global__ void __launch_bounds__(kMaxThreads) gates_bwd(LstmArgs a) {
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
  float* dgi = a.dgates + ((long long)b * 4 * a.F + f) * hw +
               (long long)y * a.W;
  const long long gs = (long long)a.F * hw;  // gate plane stride
#pragma unroll
  for (int p = 0; p < TW; ++p) {
    const int xx = tx0 + p;
    if (xx < a.W) {
      const long long o = base + xx;
      const float zg = acc[2][p] + bg;
      const float gi = sigmoid(acc[0][p] + bi);
      const float gf = sigmoid(acc[1][p] + bf);
      const float gg = leaky_relu(zg);
      const float go = sigmoid(acc[3][p] + bo);
      const float cp = a.has_state ? a.c_prev[o] : 0.f;
      const float cn = gf * cp + gi * gg;
      const float dh = a.dh[o];
      const float dct = (a.dc ? a.dc[o] : 0.f) + dh * go * leaky_relu_grad(cn);
      dgi[xx] = dct * gg * gi * (1.f - gi);
      dgi[gs + xx] = dct * cp * gf * (1.f - gf);
      dgi[2 * gs + xx] = dct * gi * leaky_relu_grad(zg);
      dgi[3 * gs + xx] = dh * leaky_relu(cn) * go * (1.f - go);
      if (a.dc_prev) a.dc_prev[o] = dct * gf;
    }
  }
}

struct DinpArgs {
  const float* dg;  // (nb, 4F, H, W)
  const float* wt;  // (4F, 9, C): wt[n][tap][c] = k[8 - tap][c][n]
  float* dx;        // echo e of dx (nb, ne, H, W, Cin), may be null
  long long dx_b;   // batch stride of dx (elements)
  float* dh;        // dL/dh_{e-1} (nb, F, H, W), may be null
  int cin, F, H, W, c0, nco, cg;  // output channels [c0, c0 + nco)
};

// Stage dgates channels [n0, n0 + DCC) of the tile's patch, and their
// flipped weights for the block's output channels, into one buffer.
__device__ __forceinline__ void dinp_stage(const DinpArgs& a, float* buf,
                                           int n0, int b, int ty0, int tx0,
                                           int cbase) {
  const int N = 4 * a.F;
  const int C = a.cin + a.F;
  const int ow = 4 * a.cg;
  const long long hw = (long long)a.H * a.W;
  float* patch = buf;
  float* ws = buf + DCC * PH * PW;
  for (int i = threadIdx.x; i < DCC * PH * PW; i += blockDim.x) {
    const int cc = i / (PH * PW);
    const int r = i - cc * (PH * PW);
    const int py = r / PW;
    const int y = ty0 + py - 1;
    const int xx = tx0 + (r - py * PW) - 1;
    const int n = n0 + cc;
    if (n < N && y >= 0 && y < a.H && xx >= 0 && xx < a.W) {
      __pipeline_memcpy_async(
          patch + i, a.dg + ((long long)b * N + n) * hw + (long long)y * a.W + xx,
          sizeof(float));
    } else {
      patch[i] = 0.f;
    }
  }
  for (int i = threadIdx.x; i < DCC * 9 * ow; i += blockDim.x) {
    const int cc = i / (9 * ow);
    const int r = i - cc * (9 * ow);
    const int t = r / ow;
    const int c = cbase + (r - t * ow);
    const int n = n0 + cc;
    if (n < N && c < a.c0 + a.nco) {
      __pipeline_memcpy_async(ws + i, a.wt + ((long long)n * 9 + t) * C + c,
                              sizeof(float));
    } else {
      ws[i] = 0.f;
    }
  }
  __pipeline_commit();
}

// (b) dinp = conv3x3_SAME(dgates, flipped k): thread (row, g) computes
// output channels cbase + 4g .. +3 for the TW pixels of one tile row.
__global__ void __launch_bounds__(kMaxThreads) dinp_kernel(DinpArgs a) {
  extern __shared__ float smem[];
  const int tiles_x = (a.W + TW - 1) / TW;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int b = blockIdx.z;
  const int cbase = a.c0 + blockIdx.y * 4 * a.cg;
  const int row = threadIdx.x / a.cg;  // blockDim.x == cg * TH
  const int g = threadIdx.x % a.cg;
  const int ow = 4 * a.cg;
  const int stage = DCC * PH * PW + DCC * 9 * ow;
  const int n_stages = (4 * a.F + DCC - 1) / DCC;

  float acc[4][TW];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int p = 0; p < TW; ++p) acc[j][p] = 0.f;

  dinp_stage(a, smem, 0, b, ty0, tx0, cbase);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      dinp_stage(a, smem + ((s + 1) & 1) * stage, (s + 1) * DCC, b, ty0, tx0,
                 cbase);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float* patch = smem + (s & 1) * stage;
    const float* ws = patch + DCC * PH * PW + 4 * g;
#pragma unroll 1
    for (int cc = 0; cc < DCC; ++cc) {
      const float* prow = patch + (cc * PH + row) * PW;
      const float* wc = ws + cc * 9 * ow;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float v[PW];
#pragma unroll
        for (int j = 0; j < PW; ++j) v[j] = prow[dy * PW + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wp = wc + (dy * 3 + dx) * ow;
          const float w0 = wp[0];
          const float w1 = wp[1];
          const float w2 = wp[2];
          const float w3 = wp[3];
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
  if (y >= a.H) return;
  const long long hw = (long long)a.H * a.W;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = cbase + 4 * g + j;
    if (c >= a.c0 + a.nco) continue;
#pragma unroll
    for (int p = 0; p < TW; ++p) {
      const int xx = tx0 + p;
      if (xx >= a.W) continue;
      if (c < a.cin) {
        if (a.dx)
          a.dx[b * a.dx_b + ((long long)y * a.W + xx) * a.cin + c] = acc[j][p];
      } else if (a.dh) {
        a.dh[((long long)b * a.F + (c - a.cin)) * hw + (long long)y * a.W +
             xx] = acc[j][p];
      }
    }
  }
}

struct DkArgs {
  const float* x;  // echo e of x (nb, ne, H, W, Cin)
  long long x_b;
  const float* h_prev;  // (nb, F, H, W), null at echo 0
  const float* dg;      // (nb, 4F, H, W)
  float* part;          // (S, 9, C, 4F) slot partials of dk
  float* part_b;        // (S, 4F) slot partials of db
  int nb, cin, F, H, W, ceff;
};

// (c) dk / db partials: block (slot, chunk) owns gate groups
// [9*chunk, 9*chunk + 9) and the pixel tiles t = slot, slot + S, ...
__global__ void __launch_bounds__(kMaxThreads) dk_kernel(DkArgs a) {
  extern __shared__ float smem[];
  const int N = 4 * a.F;
  const int C = a.cin + a.F;
  const int g0 = blockIdx.y * NG;
  const int ng = min(NG, a.F - g0);
  const int slot = blockIdx.x;
  const int tiles_x = (a.W + TW - 1) / TW;
  const int tiles_img = tiles_x * ((a.H + TH - 1) / TH);
  const int n_tiles = a.nb * tiles_img;
  const long long hw = (long long)a.H * a.W;
  float* patch = smem;                      // [ceff][PH][PW]
  float* dgs = smem + a.ceff * PH * PW;     // [4*ng][DPS]
  float* part = a.part + (long long)slot * 9 * C * N;
  float* part_b = a.part_b + (long long)slot * N;
  const int items = a.ceff * ng;

  for (int t = slot; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_img;
    const int r = t - b * tiles_img;
    const int ty0 = (r / tiles_x) * TH;
    const int tx0 = (r % tiles_x) * TW;
    for (int i = threadIdx.x; i < a.ceff * PH * PW; i += blockDim.x) {
      const int c = i / (PH * PW);
      const int q = i - c * (PH * PW);
      const int py = q / PW;
      const int y = ty0 + py - 1;
      const int xx = tx0 + (q - py * PW) - 1;
      if (y >= 0 && y < a.H && xx >= 0 && xx < a.W) {
        const float* src =
            c < a.cin ? a.x + b * a.x_b + ((long long)y * a.W + xx) * a.cin + c
                      : a.h_prev + ((long long)b * a.F + (c - a.cin)) * hw +
                            (long long)y * a.W + xx;
        __pipeline_memcpy_async(patch + i, src, sizeof(float));
      } else {
        patch[i] = 0.f;
      }
    }
    for (int i = threadIdx.x; i < 4 * ng * TH * TW; i += blockDim.x) {
      const int q = i / (TH * TW);
      const int rr = i - q * (TH * TW);
      const int y = ty0 + rr / TW;
      const int xx = tx0 + rr % TW;
      float* dst = dgs + q * DPS + rr;
      if (y < a.H && xx < a.W) {
        __pipeline_memcpy_async(
            dst, a.dg + ((long long)b * N + 4 * g0 + q) * hw +
                     (long long)y * a.W + xx,
            sizeof(float));
      } else {
        *dst = 0.f;  // pixels past the image contribute nothing
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    for (int w = threadIdx.x; w < items; w += blockDim.x) {
      const int c = w / ng;
      const int gl = w - c * ng;
      float acc[9][4];
      float accb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        accb[j] = 0.f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) acc[tap][j] = 0.f;
      }
      const float* dgp = dgs + 4 * gl * DPS;
      const float* pc = patch + c * PH * PW;
#pragma unroll 1
      for (int row = 0; row < TH; ++row) {
        float d[4][TW];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int p = 0; p < TW; ++p) d[j][p] = dgp[j * DPS + row * TW + p];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float v[PW];
#pragma unroll
          for (int jj = 0; jj < PW; ++jj) v[jj] = pc[(row + dy) * PW + jj];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int p = 0; p < TW; ++p)
                acc[dy * 3 + dx][j] =
                    fmaf(v[p + dx], d[j][p], acc[dy * 3 + dx][j]);
        }
        if (c == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int p = 0; p < TW; ++p) accb[j] += d[j][p];
        }
      }
      const int n = 4 * (g0 + gl);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[((long long)tap * C + c) * N + n + j] += acc[tap][j];
      if (c == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) part_b[n + j] += accb[j];
      }
    }
    __syncthreads();  // the next tile overwrites the staged patch
  }
}

// dk[i] = sum over slots of part[s][i], in slot order; db likewise.
__global__ void reduce_kernel(const float* part, const float* part_b,
                              float* dk, float* db, int n_slots, long long K,
                              int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < K) {
    float s = 0.f;
    for (int j = 0; j < n_slots; ++j) s += part[j * K + i];
    dk[i] = s;
  }
  if (i < N) {
    float s = 0.f;
    for (int j = 0; j < n_slots; ++j) s += part_b[(long long)j * N + i];
    db[i] = s;
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t dinp_smem_bytes(int cg) {
  return 2 * (size_t)(DCC * PH * PW + DCC * 9 * 4 * cg) * sizeof(float);
}

size_t dk_smem_bytes(int ceff, int F) {
  return (size_t)(ceff * PH * PW + 4 * (F < NG ? F : NG) * DPS) *
         sizeof(float);
}

}  // namespace

// Largest shared memory any block of the backward needs at (cin, F).
extern "C" long long convlstm_bwd_smem_bytes(int cin, int F) {
  const int groups = (cin + F + 3) / 4;
  const int nchunk = (groups + kMaxGroups - 1) / kMaxGroups;
  const size_t a = tile_smem_bytes(cin + F, chunk_width(F));
  const size_t b = dinp_smem_bytes((groups + nchunk - 1) / nchunk);
  const size_t c = dk_smem_bytes(cin + F, F);
  return (long long)(a > b ? (a > c ? a : c) : (b > c ? b : c));
}

// One echo e of the reverse sweep: (a) dgates and dc_{e-1}, (b) dh_{e-1} and
// (when dx is not null) dx_e, (c) dk/db slot partials. Null pointers: dc at
// the last echo; h_prev, c_prev, dc_prev and dh_prev at echo 0 (has_state
// 0). Returns the first cudaError_t of the launches (0 on success). The
// caller checks convlstm_bwd_smem_bytes against a block's shared memory.
extern "C" int convlstm_echo_bwd(
    const float* x, long long x_b, const float* k, const float* bias,
    const float* wt, const float* h_prev, const float* c_prev,
    const float* dh, const float* dc, float* dgates, float* dc_prev,
    float* dh_prev, float* dx, long long dx_b, float* part, float* part_b,
    int n_slots, int nb, int cin, int F, int H, int W, int has_state,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = ((W + TW - 1) / TW) * ((H + TH - 1) / TH);

  LstmArgs a{x,      x_b,    k,  bias, h_prev,  c_prev,
             nullptr, nullptr, dh, dc,   dgates,  dc_prev,
             cin,    F,      H,  W,    chunk_width(F), has_state};
  err = launch_gate_tiles(gates_bwd, a, nb, st);
  if (err != cudaSuccess) return (int)err;

  const int c0 = dx ? 0 : cin;
  const int c1 = has_state ? cin + F : cin;
  if (c1 > c0) {
    const int groups = (c1 - c0 + 3) / 4;
    const int nchunk = (groups + kMaxGroups - 1) / kMaxGroups;
    const int cg = (groups + nchunk - 1) / nchunk;
    DinpArgs d{dgates, wt,     dx, dx_b, has_state ? dh_prev : nullptr,
               cin,    F,      H,  W,    c0,
               c1 - c0, cg};
    const size_t bytes = dinp_smem_bytes(cg);
    err = allow_smem(dinp_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    dinp_kernel<<<dim3(tiles, nchunk, nb), cg * TH, bytes, st>>>(d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  const int ceff = has_state ? cin + F : cin;
  const int items = ceff * (F < NG ? F : NG);
  const int rounds = (items + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((items + rounds - 1) / rounds + 31) / 32 * 32;
  DkArgs kd{x, x_b, has_state ? h_prev : nullptr, dgates, part, part_b,
            nb, cin, F, H, W, ceff};
  const size_t bytes = dk_smem_bytes(ceff, F);
  err = allow_smem(dk_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dk_kernel<<<dim3(n_slots, (F + NG - 1) / NG), threads, bytes, st>>>(kd);
  return (int)cudaGetLastError();
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
  reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(part, part_b, dk, db,
                                                       n_slots, K, N);
  return (int)cudaGetLastError();
}
