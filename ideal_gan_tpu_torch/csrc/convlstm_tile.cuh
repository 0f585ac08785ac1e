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
// The bfloat16 storage mode has a mainloop of its own, `gate_mainloop_wg`
// below: see the note above it.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
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
// an element of a float32 state or parameter buffer
__device__ __forceinline__ float load_f(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) {
  p[i] = v;
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

// The operands of an echo's gate convolution (float32).
struct GateConv {
  const float* x;       // echo e of x (nb, ne, H, W, Cin): x + e*H*W*Cin
  long long x_b;        // batch stride of x (elements)
  const float* k;       // (3, 3, Cin+F, 4F)
  const float* h_prev;  // (nb, F, H, W), unused without state
  int cin, F, H, W, has_state, gpb;  // gpb: groups of 8 channels a block
};

// column stride of the staged weights: 4 gates x 8 channels per group, plus
// 8 so that k-rows t and t+4 fall in other banks
__host__ __device__ inline int gates_ws(int gpb) { return gpb * 32 + 8; }

// A stage in floats: the patch [pixel][PS] and the weights' 9 taps x 8
// channels rows.
__host__ __device__ inline int gates_stage(int gpb) {
  return P * P * PS + 9 * 8 * gates_ws(gpb);
}

// groups of 8 hidden channels per gate block: at most kGroups, spread
// evenly over the blocks
inline int gates_gpb(int F) {
  const int groups = (F + 7) / 8;
  const int chunks = (groups + kGroups - 1) / kGroups;
  return (groups + chunks - 1) / chunks;
}

// Dynamic shared memory of a gate block (two stages).
inline size_t gates_smem_bytes(int gpb) {
  return 2 * (size_t)gates_stage(gpb) * sizeof(float);
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

// The block's gate sums, without the bias: acc[mi][jj][q][r] is gate q of
// tile row ty0 + 2*warp + mi, pixel tx0 + g + 8*(r >> 1) (g = lane / 4),
// channel 8*(j0 + jj) + 2*t + (r & 1) (t = lane % 4), for the block's
// groups jj < ng. The block is 8 warps; every thread must call it (it
// synchronises the block). `smem` holds gates_smem_bytes(a.gpb).
__device__ __forceinline__ void gate_mainloop(
    const GateConv& a, float* smem, int b, int ty0, int tx0, int j0, int ng,
    float (&acc)[2][kGroups][4][4]) {
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
      smem, gates_stage(a.gpb), (ceff + 7) / 8,
      [&](int s, float* buf) {
        gates_load(a, buf, 8 * s, ceff, b, ty0, tx0, j0);
      },
      [&](const float* stage) { gates_step(a, stage, ng, acc); });
}

// ---------------------------------------------------------------- bf16
//
// The bfloat16 storage mode's gate mainloop (the forward kernel
// convlstm_echo_wg_bf16 and the backward's stage (a) gates_wg_bf16): the
// product above, bf16 operands with f32 accumulation, for a 16x8 pixel
// tile (16 columns, TH = 8 rows), designed for the H100:
//
// - State: the echo's input is one channels-last bf16 buffer (nb, H, W, Cp):
//   channels [0, Cin) x_e, [Cin, Cin+F) h_{e-1}, the rest zero; Cp is Cin+F
//   rounded up to 8, so a pixel's channels are whole 16-byte rows.
// - K: chunks of 16 channels, the last one 8 when Cp % 16 = 8. A k16 step is
//   one tap of a 16-channel chunk (9 steps, no zero tap), or two taps of the
//   8-channel chunk (5 steps, the tenth tap zero).
// - Patch: a TMA tiled load (cp.async.bulk.tensor.4d over the buffer) of box
//   (8 channels, 18, 10, 1) at (c0, tx0-1, ty0-1, b) per 8 channels: the
//   hardware's out-of-bounds zero fill is the SAME padding. A box lands as
//   [pixel][8 channels], 16 bytes a pixel, so the eight row addresses of an
//   ldmatrix are 128 contiguous bytes (no bank conflict).
// - Weights: packed once per call (ops/convlstm.py::_pack_gate_weights) into
//   the exact shared-memory image of each (column block, chunk): per k16
//   step the K-major core matrices (8 columns x 8 k, 128 B) that wgmma's B
//   descriptor reads without swizzle, the two k halves 128 B apart and the
//   n8 tiles 256 B apart. A stage's weights are one bulk copy.
// - Ring: kStages stages on mbarriers. Thread 0 issues a stage's copies
//   (expect_tx: the bytes of its boxes and weights); every thread waits on
//   the stage's barrier; a slot is refilled after the __syncthreads that
//   follows its use. Copies stay in flight while the tensor cores work.
// - MMA: wgmma.mma_async m64nNk16 bf16 -> f32, N = 32 ng (4 gates x 8
//   hidden channels a group, ng <= kMaxGroups). The block is two
//   warpgroups; warpgroup w owns tile rows 4w .. 4w+3 as one m64 tile, warp
//   i of it rows 16i .. 16i+15, i.e. tile row 4w + i: warp k owns row k.
//   A (the tap-shifted pixel rows) comes from registers, loaded by
//   ldmatrix.x4, since the halo patch fits no single descriptor stride; B
//   (the weights) from shared memory. A stage's A fragments are all loaded
//   first, then its wgmmas issued back to back and waited for once, so no
//   register that an MMA in flight reads is written. The accumulator columns
//   are ordered (group, gate, channel): thread (g, t) of a warp holds, for
//   pixels g and g + 8 of its tile row, channels 2t, 2t+1 of every group,
//   all four gates: acc[(4 jj + q) * 4 + 2 h + e], which is what both
//   epilogues need.
// - Occupancy: at most 3 groups (N <= 96: 48 accumulators) and one m64 tile
//   a warpgroup keep a thread under 128 registers, and a 3-stage ring at
//   N = 96 is 98 KB, so two blocks share an SM: one's epilogue, ldmatrix
//   and barrier waits overlap the other's MMAs.
// Products of two bf16 values are exact in f32, so the sums equal a float32
// convolution of the bf16 operands up to summation order.

constexpr int kStages = 3;     // the bf16 ring's depth
constexpr int kMaxGroups = 3;  // at most 3 x 8 hidden channels a bf16 block
constexpr int TH = 8;          // bf16 tile rows (ops/convlstm.py: _TILE_ROWS)
constexpr int kBox = (TH + 2) * P * 8 * 2;  // one box: 10x18 px, 8 channels
constexpr int kBoxPad = (kBox + 127) / 128 * 128;  // TMA targets 128 B aligned
constexpr int kPatch = 2 * kBoxPad;

// bytes of a bf16 stage: two boxes and 9 k16 steps of 16 k x 32 gpb columns
__host__ __device__ inline int wg_stage_bytes(int gpb) {
  return kPatch + 9 * 1024 * gpb;
}

// dynamic shared memory of a bf16 gate block: the ring and its barriers
inline size_t wg_smem_bytes(int gpb) {
  return kStages * ((size_t)wg_stage_bytes(gpb) + sizeof(uint64_t));
}

// The bf16 gate convolution's operands. `in` must stay the kernel
// parameter's own (a __grid_constant__ argument), which TMA reads.
struct WgConv {
  CUtensorMap in;     // the echo's input buffer (nb, H, W, Cp)
  const uint16_t* w;  // the packed weights, column block after column block
  int F, H, W, cp, gpb;
  int n_chunks;  // channel chunks to sum: all, or those of x_e at echo 0
  int k16;       // k16 steps over all Cp channels (a column block's image)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the barrier's phase `parity` to complete; a copy that never
// arrives traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  for (int spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == 1 << 26) __trap();
  }
}

// one TMA box of the input buffer at (channel, x, y, image) into dst
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c, int x, int y, int b,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16) into dst, one bulk copy
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes from global into shared memory (cp.async, a commit group of the
// `ring`); zero-filled where `valid` is false (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// four (x4) or two (x2) 8x8 b16 matrices; lane l gives the address of row
// l % 8 of matrix l / 8; .trans transposes each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// wgmma's shared-memory matrix descriptor of a K-major B tile without
// swizzle: LBO (bits 16-29) = 128 B between the two k halves, SBO (bits
// 32-45) = 256 B between n8 tiles
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving accesses of accumulators across the
// asynchronous MMAs that write them
template <int n>
__device__ __forceinline__ void fence_acc(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a * B, one m64nNk16 bf16 MMA of the warpgroup (N = 32, 64, 96, 128):
// a is the warp's 16 rows of A (the m16n8k16 A fragment), desc the
// descriptor of B in shared memory (wg_desc)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// One stage of k16 steps on the tensor cores. STEPS = 9: a 16-channel
// chunk, step s is tap s, the lanes 16-31 address the second 8-channel box;
// STEPS = 5: the 8-channel chunk, step s is taps 2s (lanes 0-15) and 2s + 1
// (lanes 16-31), the tenth tap zero. The warp's tile row: its index.
template <int NG, int STEPS>
__device__ __forceinline__ void wg_stage(const uint8_t* st,
                                         float (&acc)[16 * NG]) {
  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int x = lane & 15, hi = lane >> 4;
  const uint32_t patch = smem_u32(st);
  uint32_t fa[STEPS][4];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int tap = STEPS == 9 ? s : min(2 * s + hi, 8);
    const uint32_t box = STEPS == 9 ? hi * kBoxPad : 0;
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    ldsm_x4(fa[s], patch + box + ((row + dy) * P + x + dx) * 16);
  }
  if (STEPS == 5) fa[STEPS - 1][2] = fa[STEPS - 1][3] = 0u;  // tap 9
  const uint64_t desc = wg_desc(patch + kPatch);
  fence_acc(acc);
  wg_fence();
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    wgmma_rs(acc, fa[s], desc + ((s * 1024 * NG) >> 4));
  wg_commit();
  wg_wait0();
  fence_acc(acc);
}

// The block's bf16 gate sums without the bias, for column block blockIdx.x
// (NG groups from 8 * gpb * blockIdx.x): see the note above. The block is
// two warpgroups; every thread must call it (it synchronises the block).
// `smem` holds wg_smem_bytes(a.gpb), 128-byte aligned.
template <int NG>
__device__ __forceinline__ void gate_mainloop_wg(const WgConv& a,
                                                 uint8_t* smem, int b,
                                                 int ty0, int tx0,
                                                 float (&acc)[16 * NG]) {
  const int stage = wg_stage_bytes(a.gpb);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage);
  const uint16_t* w = a.w + (long long)blockIdx.x * a.k16 * 512 * a.gpb;
#pragma unroll
  for (int i = 0; i < 16 * NG; ++i) acc[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // thread 0: chunk s's boxes and weights into slot s % kStages
  auto issue = [&](int s) {
    uint8_t* st = smem + (s % kStages) * stage;
    uint64_t* bar = &full[s % kStages];
    const int boxes = min(2, (a.cp - 16 * s) / 8);
    const int wbytes = (boxes == 2 ? 9 : 5) * 1024 * NG;
    mbar_expect_tx(bar, boxes * kBox + wbytes);
    for (int h = 0; h < boxes; ++h)
      tma_box(st + h * kBoxPad, &a.in, 16 * s + 8 * h, tx0 - 1, ty0 - 1, b,
              bar);
    bulk_copy(st + kPatch, w + (long long)s * 9 * 512 * NG, wbytes, bar);
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < min(kStages, a.n_chunks); ++s) issue(s);
  for (int s = 0; s < a.n_chunks; ++s) {
    mbar_wait(&full[s % kStages], (s / kStages) & 1);
    const uint8_t* st = smem + (s % kStages) * stage;
    if (a.cp - 16 * s >= 16) {
      wg_stage<NG, 9>(st, acc);
    } else {
      wg_stage<NG, 5>(st, acc);
    }
    __syncthreads();  // both warpgroups are done with this slot
    if (threadIdx.x == 0 && s + kStages < a.n_chunks) issue(s + kStages);
  }
}

// The TMA map of a bf16 input buffer (nb, H, W, cp) at `base` (16-byte
// aligned, cp a multiple of 8): box (8, 18, TH + 2, 1), zero fill outside.
// cuTensorMapEncodeTiled is looked up at run time
// (cudaGetDriverEntryPoint), so the library needs no link to libcuda.
// Returns a cudaError_t.
inline int encode_input_map(CUtensorMap* map, const void* base, int cp,
                            int W, int H, int nb) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)cp, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)nb};
  const cuuint64_t strides[3] = {(cuuint64_t)cp * 2, (cuuint64_t)W * cp * 2,
                                 (cuuint64_t)H * W * cp * 2};
  const cuuint32_t box[4] = {8, P, TH + 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The LSTM cell of one pixel and channel from its gate sums z (without the
// bias) and c_{e-1}: (i, f, g, o) and c_e, in f32. Both storage modes'
// epilogues compute it here; h_e = o * leaky_relu(c_e). cell() is
// cell_gates then cell_state; the f32 stage (a) loads c_{e-1} between the
// two, in the order its instructions were scheduled in before the sharing.
struct Cell {
  float i, f, g, o, zg, c;
};
__device__ __forceinline__ Cell cell_gates(float zi, float zf, float zg,
                                           float zo, const float (&bias)[4]) {
  Cell r;
  r.zg = zg + bias[2];
  r.i = sigmoid(zi + bias[0]);
  r.f = sigmoid(zf + bias[1]);
  r.g = leaky_relu(r.zg);
  r.o = sigmoid(zo + bias[3]);
  return r;
}
__device__ __forceinline__ void cell_state(Cell& r, float cp) {
  r.c = r.f * cp + r.i * r.g;
}
__device__ __forceinline__ Cell cell(float zi, float zf, float zg, float zo,
                                     const float (&bias)[4], float cp) {
  Cell r = cell_gates(zi, zf, zg, zo, bias);
  cell_state(r, cp);
  return r;
}

// The cell's derivative, stage (a)'s epilogue in both storage modes: from
// the cell, c_{e-1}, dL/dh_e and dL/dc_e, out = dL/dz (i, f, g, o) and
// dL/dc_{e-1}.
__device__ __forceinline__ void cell_grad(const Cell& c, float cp, float dh,
                                          float dc, float (&out)[5]) {
  const float dct = dc + dh * c.o * leaky_relu_grad(c.c);
  out[0] = dct * c.g * c.i * (1.f - c.i);
  out[1] = dct * cp * c.f * (1.f - c.f);
  out[2] = dct * c.i * leaky_relu_grad(c.zg);
  out[3] = dh * leaky_relu(c.c) * c.o * (1.f - c.o);
  out[4] = dct * c.f;
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace convlstm
