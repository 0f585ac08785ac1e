// The gate convolution of one ConvLSTM echo over a 16x16 pixel tile, as an
// implicit GEMM on the tensor cores in split TF32 (3xTF32), shared by the
// forward kernel (convlstm_fwd.cu) and the backward's stage (a)
// (convlstm_bwd.cu::gates_mma):
//
//   z = conv3x3_SAME(concat(x_e, h_{e-1}), k)            (4F channels)
//
// without the bias. M = the tile's 256 pixels, N = 4 gates x 8 hidden
// channels per group of the block, K = 9 taps x C input channels (C = Cin
// + F, padded to channel octets; Cin alone at echo 0, whose state is
// zero). Each of the block's 8 warps owns two tile rows (two m16 tiles);
// its four n8 tiles per group are the gates i, f, g, o of the same 8
// hidden channels, so every thread ends with all four gates of its pixels
// and channels in registers, which is what both epilogues need.
//
// Precision: every f32 operand is split into hi = tf32(x) and lo = tf32(x -
// hi), and a tile sums lo*hi + hi*lo + hi*hi (lo*lo, below f32's rounding,
// is dropped). The tensor core's FP32 accumulation truncates, so each k8
// step (one tap of one channel octet) is summed on the tensor core from
// zero and added into FP32 registers with a rounded add: the gate values
// stay as close to float64 as an FP32 FMA chain, which matters because
// they decide leaky_relu's branches.
//
// Staging: the block walks K one channel octet at a time. A stage holds the
// octet's (16+2) x (16+2) input patch (x_e and h_{e-1}, zero outside the
// image, which gives SAME padding; [pixel][PS] with 4 floats of padding so
// that fragment loads are free of bank conflicts) and its 9 x 8 rows of
// weights for the block's gate columns; stages are loaded with cp.async in
// a ring of two, so the next octet streams in while this one is used.
// State is float32 NCHW (nb, F, H, W); x is the echo's slice of (nb, ne, H,
// W, Cin).
//
// The bfloat16 storage mode (`gate_mainloop` on a GateConvT<uint16_t>, the
// raw bf16 bits of x, k and h_{e-1}) is the TPU kernel's bf16 form: bf16
// operands, f32 accumulation. One mma.sync.m16n8k16.bf16 takes the place of
// the three TF32 products: its k16 step is two taps (2j, 2j+1) of one
// channel octet, so a stage runs 5 tap pairs, the tenth tap zero. A stage
// holds the octet's patch as bf16 pairs ([pixel][4 words], no padding:
// fragment loads hit 32 banks) and its weights as pairs of consecutive
// channels ([tap][channel pair][column], stride gates_ws words), 15.5 KB
// against float32's 36.3 KB. The loads are plain 16-bit loads (cp.async
// moves 4 bytes or more; the state is bf16 NCHW). Products of two bf16
// values are exact in f32, so the sums equal a float32 convolution of the
// bf16 operands up to summation order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace convlstm {

constexpr int T = 16;       // pixel tile side (ops/convlstm.py: _TILE)
constexpr int P = T + 2;    // patch side with the SAME halo
constexpr int PS = 12;      // patch stride per pixel: 8 channels + 4 pad
constexpr int kWarps = 8;   // warp w owns tile rows 2w, 2w+1
constexpr int kGroups = 2;  // at most 2 x 8 hidden channels a gate block

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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a*b on the tensor core (not volatile: the compiler may interleave
// independent tiles' MMAs)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a*b on the tensor core, summed from zero
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d += a*b on the tensor core, bf16 operands (two per register, the lower k
// in the low half), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 bits <-> float: the widening is exact; the narrowing rounds to
// nearest even, as torch's float32 -> bfloat16 cast does
__device__ __forceinline__ float bf2f(uint16_t u) {
  return __uint_as_float((uint32_t)u << 16);
}
__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// two floats as a bf16 pair, `lo` in the low half (rounded to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// an element of a state or parameter buffer as float: float32, or bf16 bits
__device__ __forceinline__ float load_f(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const uint16_t* p, long long i) {
  return bf2f(p[i]);
}
// a float stored into such a buffer (rounded to nearest even for bf16)
__device__ __forceinline__ void store_f(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(uint16_t* p, long long i, float v) {
  p[i] = f2bf(v);
}

// Fragments with each f32 element split: x = hi + lo, both TF32.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int i, float v) {
    hi[i] = to_tf32(v);
    lo[i] = to_tf32(v - __uint_as_float(hi[i]));
  }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(int i, float v) {
    hi[i] = to_tf32(v);
    lo[i] = to_tf32(v - __uint_as_float(hi[i]));
  }
};

// The A fragment of an m16 tile whose rows are the 16 pixels of patch row
// `pr` starting at column `pc` (tap offset included), k = channels 0..7 of
// a [pixel][PS] patch: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
__device__ __forceinline__ void load_a_patch(const float* patch, int pr,
                                             int pc, int g, int t,
                                             FragA& a) {
  const float* p = patch + (pr * P + pc + g) * PS + t;
  a.set(0, p[0]);
  a.set(1, p[8 * PS]);
  a.set(2, p[4]);
  a.set(3, p[8 * PS + 4]);
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  if (valid) {
    __pipeline_memcpy_async(dst, src, sizeof(float));
  } else {
    *dst = 0.f;
  }
}

// four floats, both addresses 16-byte aligned
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  if (valid) {
    __pipeline_memcpy_async(dst, src, 4 * sizeof(float));
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// A K loop: `n` stages of `stage` floats, loaded by load(s, buf) (cp.async,
// one commit group each) into a ring of two buffers and consumed by
// compute(buf); stage s + 1 is in flight while stage s is computed. Shared
// memory: 2 * stage floats.
template <class Load, class Compute>
__device__ __forceinline__ void ring(float* smem, int stage, int n, Load load,
                                     Compute compute) {
  if (n > 0) load(0, smem);
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) {
      load(s + 1, smem + ((s + 1) & 1) * stage);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    compute(smem + (s & 1) * stage);
    __syncthreads();  // this buffer is refilled two stages on
  }
}

// The operands of an echo's gate convolution, stored as S: float, or
// uint16_t for the bits of bf16.
template <class S>
struct GateConvT {
  const S* x;      // echo e of x (nb, ne, H, W, Cin): x + e*H*W*Cin
  long long x_b;   // batch stride of x (elements)
  const S* k;      // (3, 3, Cin+F, 4F)
  const S* h_prev;  // (nb, F, H, W), unused without state
  int cin, F, H, W, has_state, gpb;  // gpb: groups of 8 channels a block
};
using GateConv = GateConvT<float>;
using GateConvB = GateConvT<uint16_t>;

// column stride of the staged weights: 4 gates x 8 channels per group, plus
// 8 so that k-rows t and t+4 fall in other banks
__host__ __device__ inline int gates_ws(int gpb) { return gpb * 32 + 8; }

// A stage in 32-bit words. float32: the patch [pixel][PS] and the weights'
// 9 taps x 8 channels rows; bf16: the patch's bf16 pairs [pixel][4 words]
// and the weights' 9 taps x 4 channel pairs rows.
template <class S>
__host__ __device__ inline int gates_stage(int gpb) {
  return sizeof(S) == 2 ? P * P * 4 + 9 * 4 * gates_ws(gpb)
                        : P * P * PS + 9 * 8 * gates_ws(gpb);
}

// groups of 8 hidden channels per gate block: at most kGroups, spread
// evenly over the blocks
inline int gates_gpb(int F) {
  const int groups = (F + 7) / 8;
  const int chunks = (groups + kGroups - 1) / kGroups;
  return (groups + chunks - 1) / chunks;
}

// Dynamic shared memory of a gate block (two stages).
template <class S>
inline size_t gates_smem_bytes(int gpb) {
  return 2 * (size_t)gates_stage<S>(gpb) * sizeof(float);
}

// Stage input channels [c0, c0 + 8) of the patch and their weights for the
// block's channel groups.
__device__ __forceinline__ void gates_load(const GateConv& a, float* buf,
                                           int c0, int ceff, int b, int ty0,
                                           int tx0, int j0) {
  const int C = a.cin + a.F;
  const long long hw = (long long)a.H * a.W;
  float* patch = buf;
  float* ws = buf + P * P * PS;
  for (int i = threadIdx.x; i < 8 * P * P; i += blockDim.x) {
    const int cc = i / (P * P);
    const int pix = i - cc * (P * P);
    const int py = pix / P;
    const int y = ty0 + py - 1;
    const int xx = tx0 + (pix - py * P) - 1;
    const int c = c0 + cc;
    const bool in = c < ceff && y >= 0 && y < a.H && xx >= 0 && xx < a.W;
    const float* src =
        !in ? nullptr
        : c < a.cin
            ? a.x + b * a.x_b + ((long long)y * a.W + xx) * a.cin + c
            : a.h_prev + ((long long)b * a.F + (c - a.cin)) * hw +
                  (long long)y * a.W + xx;
    copy4(patch + pix * PS + cc, src, in);
  }
  const int cols = a.gpb * 32;
  const int wstr = gates_ws(a.gpb);
  // 4 consecutive channels f of one gate are contiguous in k; 16-byte
  // aligned when F is a multiple of 4
  const int vec = a.F % 4 == 0 ? 4 : 1;
  for (int i = threadIdx.x * vec; i < 72 * cols; i += blockDim.x * vec) {
    const int r = i / cols;  // tap * 8 + channel
    const int n = i - r * cols;
    const int tap = r >> 3;
    const int c = c0 + (r & 7);
    const int q = (n >> 3) & 3;  // gate
    const int f = (j0 + (n >> 5)) * 8 + (n & 7);
    const bool in = c < ceff && f < a.F;
    const float* src =
        in ? a.k + ((long long)tap * C + c) * 4 * a.F + q * a.F + f : nullptr;
    if (vec == 4) {
      copy16(ws + r * wstr + n, src, in);
    } else {
      copy4(ws + r * wstr + n, src, in);
    }
  }
  __pipeline_commit();
}

// One stage of the float32 mainloop: 9 taps of 3xTF32 k8 steps.
__device__ __forceinline__ void gates_step(const GateConv& a,
                                           const float* patch, int ng,
                                           float (&acc)[2][kGroups][4][4]) {
  const int wstr = gates_ws(a.gpb);
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
    const float* wt = ws + (tap * 8 + t) * wstr + g;
#pragma unroll
    for (int jj = 0; jj < kGroups; ++jj) {
      if (jj >= ng) continue;
      FragB fb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fb[q].set(0, wt[(jj * 4 + q) * 8]);
        fb[q].set(1, wt[4 * wstr + (jj * 4 + q) * 8]);
      }
      // this k8 step of 8 tiles, summed from zero, then rounded
      // into the FP32 accumulators
      float d[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_zero(d[mi][q], fa[mi].lo, fb[q].hi);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) mma(d[mi][q], fa[mi].hi, fb[q].lo);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) mma(d[mi][q], fa[mi].hi, fb[q].hi);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][jj][q][r] += d[mi][q][r];
    }
  }
}

// Stage input channels [c0, c0 + 8) of the patch and their weights, bf16:
// word (pixel, p) of the patch holds channels c0 + 2p, c0 + 2p + 1; word
// (tap, p, n) of the weights holds the same two channels' k at column n.
__device__ __forceinline__ void gates_load(const GateConvB& a, float* buf,
                                           int c0, int ceff, int b, int ty0,
                                           int tx0, int j0) {
  const int C = a.cin + a.F;
  const long long hw = (long long)a.H * a.W;
  uint32_t* patch = reinterpret_cast<uint32_t*>(buf);
  uint32_t* ws = patch + P * P * 4;
  for (int i = threadIdx.x; i < 4 * P * P; i += blockDim.x) {
    const int cp = i / (P * P);
    const int pix = i - cp * (P * P);
    const int py = pix / P;
    const int y = ty0 + py - 1;
    const int xx = tx0 + (pix - py * P) - 1;
    uint32_t v = 0;
    if (y >= 0 && y < a.H && xx >= 0 && xx < a.W) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 2 * cp + e;
        if (c >= ceff) continue;
        const uint16_t u =
            c < a.cin
                ? a.x[b * a.x_b + ((long long)y * a.W + xx) * a.cin + c]
                : a.h_prev[((long long)b * a.F + (c - a.cin)) * hw +
                           (long long)y * a.W + xx];
        v |= (uint32_t)u << (16 * e);
      }
    }
    patch[pix * 4 + cp] = v;
  }
  const int cols = a.gpb * 32;
  const int wstr = gates_ws(a.gpb);
  for (int i = threadIdx.x; i < 36 * cols; i += blockDim.x) {
    const int r = i / cols;  // tap * 4 + channel pair
    const int n = i - r * cols;
    const int tap = r >> 2;
    const int q = (n >> 3) & 3;  // gate
    const int f = (j0 + (n >> 5)) * 8 + (n & 7);
    uint32_t v = 0;
    if (f < a.F) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 2 * (r & 3) + e;
        if (c < ceff)
          v |= (uint32_t)a.k[((long long)tap * C + c) * 4 * a.F + q * a.F + f]
               << (16 * e);
      }
    }
    ws[r * wstr + n] = v;
  }
  __pipeline_commit();  // an empty group: the ring counts one a stage
}

// One stage of the bf16 mainloop: 5 k16 steps of two taps (2j, 2j+1) of
// the channel octet, the tenth tap zero; the m16n8k16 D fragment is the
// m16n8k8 one, so the accumulator layout is float32's.
__device__ __forceinline__ void gates_step(const GateConvB& a,
                                           const float* stage, int ng,
                                           float (&acc)[2][kGroups][4][4]) {
  const int wstr = gates_ws(a.gpb);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x >> 2) & 7;
  const int t = threadIdx.x & 3;
  const uint32_t* patch = reinterpret_cast<const uint32_t*>(stage);
  const uint32_t* ws = patch + P * P * 4;
#pragma unroll 1
  for (int tp = 0; tp < 5; ++tp) {
    const int t0 = 2 * tp, t1 = 2 * tp + 1;  // tap 9 is zero
    uint32_t fa[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint32_t* p0 =
          patch + ((2 * warp + mi + t0 / 3) * P + t0 % 3 + g) * 4 + t;
      fa[mi][0] = p0[0];
      fa[mi][1] = p0[8 * 4];
      if (t1 < 9) {
        const uint32_t* p1 =
            patch + ((2 * warp + mi + t1 / 3) * P + t1 % 3 + g) * 4 + t;
        fa[mi][2] = p1[0];
        fa[mi][3] = p1[8 * 4];
      } else {
        fa[mi][2] = fa[mi][3] = 0u;
      }
    }
#pragma unroll
    for (int jj = 0; jj < kGroups; ++jj) {
      if (jj >= ng) continue;
      uint32_t fb[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = (jj * 4 + q) * 8 + g;
        fb[q][0] = ws[(t0 * 4 + t) * wstr + col];
        fb[q][1] = t1 < 9 ? ws[(t1 * 4 + t) * wstr + col] : 0u;
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_bf16(acc[mi][jj][q], fa[mi], fb[q]);
    }
  }
}

// The block's gate sums, without the bias: acc[mi][jj][q][r] is gate q of
// tile row ty0 + 2*warp + mi, pixel tx0 + g + 8*(r >> 1) (g = lane / 4),
// channel 8*(j0 + jj) + 2*t + (r & 1) (t = lane % 4), for the block's
// groups jj < ng. The block is 8 warps; every thread must call it (it
// synchronises the block). `smem` holds gates_smem_bytes<S>(a.gpb).
template <class S>
__device__ __forceinline__ void gate_mainloop(
    const GateConvT<S>& a, float* smem, int b, int ty0, int tx0, int j0,
    int ng, float (&acc)[2][kGroups][4][4]) {
  const int ceff = a.has_state ? a.cin + a.F : a.cin;

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int jj = 0; jj < kGroups; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][jj][q][r] = 0.f;

  ring(
      smem, gates_stage<S>(a.gpb), (ceff + 7) / 8,
      [&](int s, float* buf) {
        gates_load(a, buf, 8 * s, ceff, b, ty0, tx0, j0);
      },
      [&](const float* stage) { gates_step(a, stage, ng, acc); });
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace convlstm
