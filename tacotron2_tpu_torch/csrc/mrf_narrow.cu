// Kernel K2, the other shapes: the HiFi-GAN MRF stage's convs at every
// channel count the wide kernels do not take, for sm_90a (the tensor cores
// at Co >= 8, the CUDA cores below).
//
// Replaces tacotron2_tpu/ops/mrf_pallas.py's stage kernels at the channel
// counts that the wide kernels (csrc/mrf.cu, csrc/mrf_f32.cu: Co a multiple
// of 32, their N tiles, and Ci a multiple of 8, whole 16-byte pieces as TMA
// reads them) do not take. The TPU kernel takes any C (_make_stage_kernel
// :285, launched at :488): folded s = 128 / C where 128 % C == 0, else
// unfolded (:440); the aligned upsample fused in front (_make_stage_kernel_ups
// :378, launched at :583, its fold at :516-517) and the expanded one
// (_make_stage_kernel_ups_expand :312, launched at :675), in both modes
// (bf16=True and False, `_dt` at :463, :540 and :636). So HiFi-GAN V2's
// stages 3 and 4 (C = 16 and 8) and its last upsample (16 -> 2 x 8), a
// generator's stages at C = 4, 2 or 1, widths off 32 (200, 100, 50, 25), and
// a conv_pre from a num_mels off 8 all run here.
//
//   t2_narrow_conv[_f32]  from the operand a = op(lrelu(x)) (B, T, Ci):
//                         v = conv_d(a) + bias (+ res), and any of y = v (f32),
//                         act = op(lrelu(v)) (the next conv's operand) and
//                         acc_out = (acc_in) + scale * v (the stage mean), or
//                         that sum's operand (mode & 4); mode & 8 rounds the
//                         sum to the operand type before the bias (conv_pre,
//                         and an upsample the JAX package runs on XLA). The
//                         folded upsample (ops/mrf.py::fold_upsample: a SAME
//                         3-tap conv to u Co channels) runs on it too
//   t2_narrow_pair[_f32]  a ResBlock1 pair in one launch (C = 8 or 16): the
//                         second conv (dilation 1) on the operand of the
//                         first's output, which stays in shared memory
//
// op is bf16 (t2_narrow_*: bf16 operands and weights, f32 sums, act =
// bf16(lrelu(v)) as csrc/mrf.cu rounds) or f32 (t2_narrow_*_f32: f32
// operands and weights, products f32 keeps, as the JAX package's F32
// vocoder). One template of each kernel serves both.
//
// Three routes, by shape (narrow_plan):
//
// - Ci and Co 8 or 16 (HiFi-GAN V2's stages 3-4, its last upsample's fold
//   16 -> 2 x 8, c2_deep's C = 16 / 8 pairs and folds), and the fused pair:
//   narrow_small_kernel<Op, CI, CO, PAIR>, an implicit GEMM on mma.sync
//   (bf16 m16n8k16 at 16 input channels, m16n8k8 at 8; f32 m16n8k8 TF32 as
//   the three-pass split below). Bound, per launch, by bytes: a pair moves
//   ~18 bytes a sample and channel in f32 (operand, res, y, act, the stage
//   mean) against its 2 k C flops, and at one row by its round trips. So a
//   block takes 128 outputs of one row (8 warps, an m16 tile each: V2's
//   stages 3-4 at one row of the 384-frame bucket 384 / 768 blocks,
//   c2_deep's 16 / 32) and makes one round trip: the whole weight copy of
//   both convs (made once at load in the B fragments' order,
//   ops/mrf.py::tile_conv: 5.6 KB a conv at C = 16, K = 11 in bf16, 22.5 KB
//   in f32 with its hi / lo planes), the operand's rows with their dilated
//   halo (SAME padding, zero outside [0, T)) and the epilogue's res / acc_in
//   tiles come by cp.async at its start, one wait, then every tap's products
//   without a barrier: A by ldmatrix of the staged rows at the tap's shift
//   (rows padded to an odd number of 16-byte units, so the eight row
//   addresses fall on distinct banks), B a lane's fragment in one load. The
//   pair's first conv runs over its 128 outputs and kSmallLead rows on each
//   side (9 m16 tiles), writes its operand op(lrelu(v + bias1)) over the
//   slab, 0 outside [0, T) (the second conv's SAME padding), and the second
//   conv (dilation 1) reads it there: one launch, no intermediate in device
//   memory. The epilogue goes through shared memory, a thread 8 channels of
//   a row (16-byte accesses). What holds it back on the card (NVIDIA H100
//   80GB HBM3, 700.00 W; chip_smoke.py --narrow-design, parts taken out in
//   turns): at one row a launch's round trip, 4-27 us; at 16 and 64 rows in
//   f32 the three TF32 passes (without the products a V2 pair at 64 rows
//   takes 443-456 us against 772-856), in bf16 the epilogue's stores. The
//   same convs on narrow_mma_kernel (a pair as its two launches) take 2-7x
//   as long.
// - Co >= 8 at every other shape: narrow_mma_kernel, an implicit GEMM
//   on the tensor cores. Bound, per launch: bytes in bf16 (c2_wide's convs
//   move 10-20 bytes a sample and channel through the residual, stage-mean
//   and operand epilogue, against 2 k Ci flops at 989 TFLOP/s), operations
//   in f32 (three TF32 passes at 495). M is 128 samples of one batch row (two
//   warpgroups of 64, a warp 16), N the output channels padded to n8 tiles,
//   up to 8 a block, K the taps x Ci padded to the k tile (16 bf16, 8 tf32).
//   wgmma m64nNk16 bf16 / m64nNk8 tf32 with A from registers: a warp's A
//   fragment is ldmatrix of its 16 samples of the staged operand at the
//   tap's shift (as above), B the weights in shared memory in the
//   K-major no-swizzle core-matrix layout. f32: the three-pass TF32 split of
//   csrc/mrf_f32.cu, a_lo w_hi + a_hi w_lo + a_hi w_hi (a split in
//   registers: hi = tf32_rna(a), lo = tf32_rna(a - hi); the weights' hi and
//   lo planes from the copy), each step's products in their own registers
//   added rounded to nearest (the tensor cores' accumulation truncates;
//   kTf32Passes names the passes for the planted defects, on both tensor-core
//   routes). A block stages its operand once for its output channels: rows
//   x0 .. x0 + rows - 1 of one batch row over all Ci are one contiguous run
//   of a (B, T, Ci), read as 16-byte pieces and laid out [row][channel] in
//   shared memory, the channels padded with zeros to the k tile (odd Ci: 50
//   bytes a row at bf16 and Ci = 25, so no TMA boxes of rows) and rows
//   outside [0, T) zero (SAME padding; never the neighbouring batch row).
//   The weights come from a copy made once at load (ops/mrf.py::tile_conv:
//   (K, planes, Co8, Ci_pad), zero-padded) through a 3-stage cp.async ring, a
//   step a tap's 8 k tiles (bf16) or 4 (f32). The grid (ceil(T / 128), B, N
//   chunks): where fewer than kFillBlocks blocks would run, N splits into
//   more chunks of a power of two of n8 tiles (stage 1 of c2_wide at one
//   row: 8 x 13 blocks). The block's res and acc_in tiles come by cp.async
//   at its start where two blocks an SM still fit; the epilogue goes through
//   shared memory, the block's outputs a contiguous run; the pad channels
//   of a partial last n8 tile are never written. An operand wider than two
//   blocks an SM allow is staged in chunks of ck channels (ck from Ci, K,
//   dil and the type alone). What holds it back on the card (chip_smoke.py
//   --narrow-design, parts taken out in turns): at one row each launch is
//   a chain of memory round trips (staging, weights, epilogue) of ~10-20 us;
//   at 16 rows the epilogue's bytes in bf16 and the products, the weights'
//   L2 reads (each 128-sample block reads every weight) and the staging in
//   f32.
// - Co < 8: narrow_group_kernel on the CUDA cores (FFMA). Bound: bytes (at
//   C = 4, k = 11, 352 flops a sample against 32-80 bytes). A block takes
//   128 samples of one row and every output channel (G, the least power of
//   two >= Co), a thread one sample; per slice of kc input channels (16
//   where they divide Ci, else 8 where they do, else min(16, Ci); the last
//   slice maybe partial) the operand's rows and dilated halo as
//   [channel][row] in shared memory (scalar loads, so a row of any Ci is
//   read) and the slice's weights [channel][tap][G] (the copy (Ci, K, Co)).
//   Blocks of 128 samples fill the card at one row (c2_deep's C = 4, 2, 1:
//   64 to 256 blocks).
//
// Sums: each output's sum runs in one order per (shape, mode) whatever B
// and T: over (tap, k step, pass) on the small route (f32: a tap's passes in
// their own registers), over (input-channel chunk, tap, k tile) on
// narrow_mma_kernel (f32: in sets of a weight step, whose size follows T and
// Co, never B), over (input channel, tap) on the CUDA cores. So a served
// request's audio does not depend on its window, and the fused pair gives
// the bits of its two launches: a single conv and the pair's second conv run
// the same code (small_conv; chip_smoke.py holds both).
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (cudaErrorInvalidValue for dimensions it does
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <initializer_list>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kSlope = 0.1f;
constexpr int kThreads = 128;     // a block's threads, every route
constexpr int kFfmaRows = 1;      // samples a thread of narrow_group_kernel
constexpr int kMmaThreads = 256;  // a block of narrow_mma_kernel: two warpgroups
constexpr int kMmaRows = 128;     // its samples: 64 a warpgroup, 16 a warp
constexpr int kMmaTiles = 8;      // n8 tiles a block of narrow_mma_kernel at most: wgmma N 64
constexpr int kRing = 3;          // the weight ring's stages
constexpr int kStepTiles = 8;     // k tiles a weight step at most: bf16 (f32 half, its A twice)
constexpr int kLoadBatch = 8;     // global loads a thread has in flight: staging, epilogue
constexpr int kFillBlocks = 132;  // the card's SMs: N splits until a launch has as many blocks
constexpr int kTf32Passes = 7;    // 1 a_lo w_hi, 2 a_hi w_lo, 4 a_hi w_hi
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kSoftSmem = 113 * 1024;  // two blocks an SM
constexpr int kSmallThreads = 256;  // a block of narrow_small_kernel: 8 warps, an m16 tile each
constexpr int kSmallRows = 128;     // its outputs
constexpr int kSmallLead = 8;       // rows the pair's first conv starts before them (K <= 17)
constexpr int kSmallPitchO = 24;    // its epilogue tile's row pitch, floats

__device__ __forceinline__ float lrelu(float x) { return x > 0.0f ? x : kSlope * x; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// v as the operand type holds it, back in f32 (the identity for f32)
template <typename Op>
__device__ __forceinline__ float round_op(float v) {
  if constexpr (sizeof(Op) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

// n values of v (n a multiple of 4) to p in the operand type
__device__ __forceinline__ void store_op(float* p, const float* v, int n) {
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
__device__ __forceinline__ void store_op(bf16* p, const float* v, int n) {
  for (int i = 0; i < n; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(v[i], v[i + 1]);
}

// one value to p in the operand type
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// acc[r][g] += sum over (channel ci < nci, tap j < K), in that order, of
// w[ci][j][g] * a[ci][tid + kThreads r + j dil]: the operand sa as
// [channel][row] (rows_p apart), the weights sw as [channel][tap][G]
template <int R, int G>
__device__ __forceinline__ void accumulate(float (&acc)[R][G], const float* sa, int rows_p,
                                           const float* sw, int nci, int K, int dil) {
  for (int ci = 0; ci < nci; ++ci) {
    const float* ap = sa + ci * rows_p + threadIdx.x;
    const float* wp = sw + ci * K * G;
    for (int j = 0; j < K; ++j) {
      float w[G];
      if constexpr (G % 4 == 0) {
#pragma unroll
        for (int q = 0; q < G / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(wp + j * G)[q];
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < G; ++q) w[q] = wp[j * G + q];
      }
      const float* aj = ap + j * dil;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = aj[r * kThreads];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[r][g] = fmaf(x, w[g], acc[r][g]);
      }
    }
  }
}

// Stage one slice: the operand's channels c0 .. c0 + nci - 1 of rows x0 ..
// x0 + rows - 1 of batch row b into sa as [channel][row] (rows_p apart, 0
// outside [0, T)), and the weights of those channels into sw as
// [channel][tap][G] (0 past Co). a (B, T, Ci) and wt (Ci, K, Co) in the
// operand type. Where Co is G (a power of two) the slice's weights are one
// run, copied as is.
template <int G, typename Op>
__device__ __forceinline__ void stage_slice(float* __restrict__ sa, float* __restrict__ sw,
                                            const Op* __restrict__ a, const Op* __restrict__ wt,
                                            int b, int T, int Ci, int Co, int K, int c0, int nci,
                                            int x0, int rows, int rows_p) {
  const int tid = threadIdx.x;
  for (int i = tid; i < rows * nci; i += kThreads) {
    const int row = i / nci, cc = i - row * nci, t = x0 + row;
    sa[cc * rows_p + row] =
        (t >= 0 && t < T) ? to_f32(a[((size_t)b * T + t) * Ci + c0 + cc]) : 0.0f;
  }
  if (Co == G) {
    const Op* ws = wt + (size_t)c0 * K * G;
    for (int i = tid; i < nci * K * G; i += kThreads) sw[i] = to_f32(ws[i]);
    return;
  }
  for (int i = tid; i < nci * K * G; i += kThreads) {
    const int cj = i / G, q = i - cj * G;  // cj = channel * K + tap
    sw[i] = q < Co ? to_f32(wt[((size_t)c0 * K + cj) * Co + q]) : 0.0f;
  }
}

// The stores of one output value v (the sum, rounded with mode & 8, plus
// the bias and the residual) at o: y, act and acc_out (mode as
// narrow_group_kernel's; a = acc_in[o] where mode & 3 is 2)
template <typename Op>
__device__ __forceinline__ void epilogue_store(float v, float a, size_t o,
                                               void* __restrict__ acc_out, float* __restrict__ y,
                                               Op* __restrict__ act, int mode, float scale) {
  if (y != nullptr) y[o] = v;
  if (act != nullptr) store_one(act + o, lrelu(v));
  if (mode & 3) {
    float s = scale * v;
    if ((mode & 3) == 2) s = a + scale * v;
    if (mode & 4) store_one(reinterpret_cast<Op*>(acc_out) + o, lrelu(s));
    else reinterpret_cast<float*>(acc_out)[o] = s;
  }
}

// The epilogue of one output value v (the sum, rounded with mode & 8, plus
// the bias) at o: + res, then the stores
template <typename Op>
__device__ __forceinline__ void epilogue_out(float v, size_t o, const float* __restrict__ res,
                                             const float* __restrict__ acc_in,
                                             void* __restrict__ acc_out, float* __restrict__ y,
                                             Op* __restrict__ act, int mode, float scale) {
  if (res != nullptr) v += res[o];
  epilogue_store<Op>(v, (mode & 3) == 2 ? acc_in[o] : 0.0f, o, acc_out, y, act, mode, scale);
}

// The epilogue of one output row: v = the sums acc (rounded to the operand
// type with mode & 8) + bias bo, + res, then y, act and acc_out (mode as
// narrow_group_kernel's) for the row's ng channels from o on; vec: float4 /
// bf16-pair accesses (ng % 4 == 0 and o 16-byte aligned), else one channel
// at a time.
template <typename Op, int G>
__device__ __forceinline__ void epilogue_row(const float (&acc)[G], const float* __restrict__ bo,
                                             int ng, bool vec, size_t o,
                                             const float* __restrict__ res,
                                             const float* __restrict__ acc_in,
                                             void* __restrict__ acc_out, float* __restrict__ y,
                                             Op* __restrict__ act, int mode, float scale) {
  float v[G], s[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    v[g] = g < ng ? ((mode & 8) ? round_op<Op>(acc[g]) : acc[g]) + bo[g] : 0.0f;
  if (G % 4 == 0 && vec) {
    if (res != nullptr) {
#pragma unroll
      for (int q = 0; q < G / 4; ++q) {
        if (4 * q >= ng) break;
        const float4 rv = reinterpret_cast<const float4*>(res + o)[q];
        v[4 * q] += rv.x;
        v[4 * q + 1] += rv.y;
        v[4 * q + 2] += rv.z;
        v[4 * q + 3] += rv.w;
      }
    }
    if (y != nullptr) store_op(y + o, v, ng);
    if (act != nullptr) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = lrelu(v[g]);
      store_op(act + o, s, ng);
    }
    if (mode & 3) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = scale * v[g];
      if ((mode & 3) == 2) {
#pragma unroll
        for (int q = 0; q < G / 4; ++q) {
          if (4 * q >= ng) break;
          const float4 av = reinterpret_cast<const float4*>(acc_in + o)[q];
          s[4 * q] = av.x + scale * v[4 * q];
          s[4 * q + 1] = av.y + scale * v[4 * q + 1];
          s[4 * q + 2] = av.z + scale * v[4 * q + 2];
          s[4 * q + 3] = av.w + scale * v[4 * q + 3];
        }
      }
      if (mode & 4) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = lrelu(s[g]);
        store_op(reinterpret_cast<Op*>(acc_out) + o, s, ng);
      } else {
        store_op(reinterpret_cast<float*>(acc_out) + o, s, ng);
      }
    }
    return;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= ng) break;
    epilogue_out<Op>(v[g], o + g, res, acc_in, acc_out, y, act, mode, scale);
  }
}

// narrow_group_kernel: Co < 8 (G = the least power of two >= Co), any Ci.
// grid (ceil(T / BT), B), block kThreads, dynamic shared memory (kc K G +
// kc rows_p) floats: the weights of a slice first (16-byte aligned for the
// float4 reads), then the operand's slice, rows_p >= BT + dil (K - 1), odd.
// a (B, T, Ci) and the weight copy wt (Ci, K, Co) in the operand type Op;
// bias (Co) f32; res, acc_in, y (B, T, Co) f32 and act (B, T, Co) Op where
// given; acc_out (B, T, Co) f32, or Op with mode & 4 (mode & 3 = 0: no
// acc_out; 1: acc_out = scale v; 2: acc_out = acc_in + scale v; mode & 4:
// acc_out gets op(lrelu(that sum)); mode & 8: the sum rounded to Op before
// the bias). Every route takes the same outputs and modes.
template <typename Op, int G>
__global__ void __launch_bounds__(kThreads)
narrow_group_kernel(const Op* __restrict__ a, const Op* __restrict__ wt,
                    const float* __restrict__ bias, const float* __restrict__ res,
                    const float* __restrict__ acc_in, void* __restrict__ acc_out,
                    float* __restrict__ y, Op* __restrict__ act, int T, int Ci, int Co, int K,
                    int dil, int kc, int rows_p, int mode, float scale) {
  constexpr int R = kFfmaRows;      // samples a thread
  constexpr int BT = kThreads * R;  // rows a block
  extern __shared__ float4 narrow_raw[];
  float* sw = reinterpret_cast<float*>(narrow_raw);
  float* sa = sw + kc * K * G;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT, b = blockIdx.y;
  const int x0 = t0 - dil * (K - 1) / 2;  // the first operand row the block reads
  const int rows = BT + dil * (K - 1);
  float acc[R][G];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[r][g] = 0.0f;

  for (int c0 = 0; c0 < Ci; c0 += kc) {
    const int nci = Ci - c0 < kc ? Ci - c0 : kc;  // the slice's channels (the last may be partial)
    __syncthreads();  // every thread is done with the previous slice
    stage_slice<G>(sa, sw, a, wt, b, T, Ci, Co, K, c0, nci, x0, rows, rows_p);
    __syncthreads();
    accumulate<R, G>(acc, sa, rows_p, sw, nci, K, dil);
  }

  // epilogue: the Co channels
  const bool vec = G % 4 == 0 && Co % 4 == 0;  // then every row 16-byte aligned
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + tid + kThreads * r;
    if (t >= T) continue;
    epilogue_row<Op, G>(acc[r], bias, Co, vec, ((size_t)b * T + t) * Co, res, acc_in, acc_out, y,
                        act, mode, scale);
  }
}

// ---------------------------------------------------------------------------
// the tensor-core route: narrow_mma_kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A shared-memory matrix descriptor without swizzle, K-major: 8-row x
// 16-byte core matrices, lbo bytes apart along K, sbo bytes apart along N
// (csrc/mrf_f32.cu's smem_desc)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x N f32, N / 2 a thread: per warp its 16 rows, per n8 tile the
// mma.sync m16n8 layout) += A (64 x k16 bf16 or k8 tf32 in registers, per
// warp the mma.sync m16n8k16 / m16n8k8 A layout) . B (k x N, descriptor db)
template <int N, bool F32>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<8, false>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16, false>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32, false>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, false>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<8, true>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16, true>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32, true>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, true>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// x rounded to tf32, to nearest, ties away from zero: the low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

template <typename Op>
__device__ __forceinline__ Op op_zero() {
  if constexpr (sizeof(Op) == 2) return __float2bfloat16_rn(0.0f);
  else return 0.0f;
}

// The plan of a narrow_mma_kernel launch (narrow_plan)
struct MmaPlan {
  int ci_pad, co_pad;  // Ci to the k tile, Co to n8: the weight copy (K, planes, co_pad, ci_pad)
  int ck;              // input channels a staged operand chunk (a multiple of the k tile)
  int ckw;             // input channels a weight step: a chunk, or a piece of one
  int ct;              // n8 tiles a block, the wgmma's N / 8 (grid z: ceil(co_pad / 8 / ct))
  int pitch_a;         // the slab's row pitch, 16-byte units (odd)
  int pitch_o;         // the epilogue tile's row pitch, floats
  int ring_off;        // bytes from the start of shared memory to the weight ring
  int plane_bytes;     // bytes of a ring stage's plane: ckw / (16-byte units) x N rows x 16
  int pre_off;         // bytes to the res and acc_in tiles copied at the start (0: none)
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Stage the operand's channels c0 .. c0 + cl - 1 of slab rows 0 .. rows - 1
// (operand rows x0 + r of batch row b) as [row][channel], pe elements a
// row: zero outside rows ra .. rb - 1 (those in [0, T)) and at channels
// past Ci. The rows' channels are one run of a, read in 16-byte pieces
// (elementwise where a piece reaches past the run), kLoadBatch pieces a
// thread in flight, and scattered.
template <typename Op>
__device__ __forceinline__ void mma_stage(Op* __restrict__ slab, const Op* __restrict__ a, int b,
                                          int T, int Ci, int x0, int rows, int ra, int rb, int c0,
                                          int cl, int pe) {
  constexpr int EPU = 16 / (int)sizeof(Op);
  const int tid = threadIdx.x;
  const int units = cl / EPU, real = min(cl, Ci - c0);
  const int nz = ra + (rows - rb);  // rows outside [0, T)
  for (int i = tid; i < nz * units; i += kMmaThreads) {
    int r = i / units;
    const int u = i - r * units;
    r = r < ra ? r : rb + (r - ra);
    *reinterpret_cast<uint4*>(slab + r * pe + u * EPU) = make_uint4(0u, 0u, 0u, 0u);
  }
  const int npad = cl - real;  // the k tile's pad channels
  for (int i = tid; i < (rb - ra) * npad; i += kMmaThreads) {
    const int r = ra + i / npad, ch = real + i % npad;
    slab[r * pe + ch] = op_zero<Op>();
  }
  const Op* run = a + ((size_t)b * T + x0 + ra) * Ci;
  const int n = (rb - ra) * Ci;  // the run's elements
  const uintptr_t p0 = reinterpret_cast<uintptr_t>(run) & ~(uintptr_t)15;
  const int off0 = (int)((reinterpret_cast<uintptr_t>(run) - p0) / sizeof(Op));
  const int np = (off0 + n + EPU - 1) / EPU;  // 16-byte pieces over the run
  for (int i0 = tid; i0 < np; i0 += kLoadBatch * kMmaThreads) {
    uint4 raw[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kMmaThreads, e0 = i * EPU - off0;
      if (i < np && e0 >= 0 && e0 + EPU <= n)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(p0) + i);
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kMmaThreads, e0 = i * EPU - off0;  // e0: the piece's first element
      if (i >= np) break;
      Op v[EPU];
      if (e0 >= 0 && e0 + EPU <= n) {
        memcpy(v, &raw[u], 16);
      } else {
#pragma unroll
        for (int q = 0; q < EPU; ++q)
          v[q] = (e0 + q >= 0 && e0 + q < n) ? run[e0 + q] : op_zero<Op>();
      }
      const int e = e0 < 0 ? 0 : e0;
      int r = e / Ci, ch = e - r * Ci;
#pragma unroll
      for (int q = 0; q < EPU; ++q) {
        if (e0 + q < 0) continue;
        if (e0 + q >= n) break;
        if (ch >= c0 && ch < c0 + real) slab[(ra + r) * pe + ch - c0] = v[q];
        if (++ch == Ci) {
          ch = 0;
          ++r;
        }
      }
    }
  }
}

// Issue the cp.async copies of one weight step: tap j, input channels k0 ..
// k0 + kl - 1, the block's nrows output channels from n0, each plane, from
// the copy (K, planes, co_pad, ci_pad) into a ring stage at dst in wgmma's
// K-major core-matrix layout: a plane [16-byte unit of k][N rows][16
// bytes], plane_bytes apart
template <typename Op, int kPlanes, int N>
__device__ __forceinline__ void mma_load_w(uint32_t dst, const Op* __restrict__ wt, int j, int n0,
                                           int nrows, int k0, int kl, int co_pad, int ci_pad,
                                           int plane_bytes) {
  constexpr int EPU = 16 / (int)sizeof(Op);
  const int units = kl / EPU;
#pragma unroll
  for (int pl = 0; pl < kPlanes; ++pl) {
    const Op* src = wt + ((size_t)(j * kPlanes + pl) * co_pad + n0) * ci_pad + k0;
    for (int i = threadIdx.x; i < nrows * units; i += kMmaThreads) {
      const int r = i / units, u = i - r * units;
      cp_async16(dst + pl * plane_bytes + (u * N + r) * 16, src + (size_t)r * ci_pad + u * EPU);
    }
  }
}

// narrow_mma_kernel: Co >= 8, any Ci (but V2's shapes). grid (ceil(T /
// 128), B, N chunks of ct n8 tiles), two warpgroups a block (64 samples
// each, one weight ring), dynamic shared memory p's: the operand slab (128
// + dil (K - 1) rows of ck channels), then the weight ring; after the main
// loop the epilogue's tile (128 rows x pitch_o floats) over both; the
// prefetched res and acc_in tiles past them (pre_off). a (B, T, Ci) and
// the weight copy wt (K, planes, co_pad, ci_pad) in the operand type Op;
// bias (Co) f32; res, acc_in, y, act and acc_out as narrow_group_kernel's
// (mode as there). NW: n8 tiles of the wgmma (N = 8 NW = 8 ct; past the
// chunk's tiles the ring holds stale rows, whose columns are not written).
// Each step loads its k tiles' A fragments (warp w: samples 16 w .. 16 w +
// 15 at the tap's shift) and each warpgroup issues its wgmmas together.
// f32: the products of a step go into their own registers, added rounded
// to nearest when the step is done.
template <typename Op, int NW>
__global__ void __launch_bounds__(kMmaThreads, 2)
narrow_mma_kernel(const Op* __restrict__ a, const Op* __restrict__ wt,
                  const float* __restrict__ bias, const float* __restrict__ res,
                  const float* __restrict__ acc_in, void* __restrict__ acc_out,
                  float* __restrict__ y, Op* __restrict__ act, int T, int Ci, int Co, int K,
                  int dil, int mode, float scale, const MmaPlan p) {
  constexpr bool kF32 = sizeof(Op) == 4;
  constexpr int KT = kF32 ? 8 : 16;          // channels a k tile: two 16-byte units
  constexpr int EPU = 16 / (int)sizeof(Op);  // elements a 16-byte unit
  constexpr int kPlanes = kF32 ? 2 : 1;      // the weights' hi and lo planes (f32)
  constexpr int N = 8 * NW;                  // the wgmma's width
  constexpr int kSteps = kF32 ? kStepTiles / 2 : kStepTiles;  // k tiles a step at most
  extern __shared__ float4 mma_raw[];
  Op* slab = reinterpret_cast<Op*>(mma_raw);
  const uint32_t slab_s = smem_addr(mma_raw), ring_s = slab_s + p.ring_off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * kMmaRows, b = blockIdx.y;
  const int tile0 = blockIdx.z * p.ct;                  // the block's first n8 tile
  const int ntl = min(p.ct, p.co_pad / 8 - tile0);      // its n8 tiles
  const int x0 = t0 - dil * (K - 1) / 2;                // the slab's first operand row
  const int rows = kMmaRows + dil * (K - 1);
  const int ra = max(0, -x0), rb = min(rows, T - x0);   // the slab's rows inside [0, T)
  const int n0 = tile0 * 8;
  // the chunk's channels (the last chunk may be partial)
  const int ncols = Co - n0 < p.ct * 8 ? Co - n0 : p.ct * 8;
  const int nrows = min(kMmaRows, T - t0);
  const int ck = p.ck, ckw = p.ckw, ci_pad = p.ci_pad, co_pad = p.co_pad;
  const int pitch_a = p.pitch_a, pe = pitch_a * EPU, plane_bytes = p.plane_bytes;
  const int stage_bytes = kPlanes * plane_bytes;
  const int nck = (ci_pad + ck - 1) / ck;               // operand chunks
  const int q_full = (ck + ckw - 1) / ckw;              // steps a tap of a whole chunk
  const int last_len = ci_pad - (nck - 1) * ck;
  const int q_last = (last_len + ckw - 1) / ckw;
  const int steps = K * ((nck - 1) * q_full + q_last);  // (chunk, tap, piece), in that order

  float acc[N / 2], part[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = part[e] = 0.0f;

  // the step the ring loads next: (chunk lc, tap lj, piece lq)
  int lc = 0, lj = 0, lq = 0;
  auto load_next = [&](int slot) {
    const int len = lc == nck - 1 ? last_len : ck;
    mma_load_w<Op, kPlanes, N>(ring_s + slot * stage_bytes, wt, lj, tile0 * 8, ntl * 8,
                               lc * ck + lq * ckw, min(ckw, len - lq * ckw), co_pad, ci_pad,
                               plane_bytes);
    if (++lq == (lc == nck - 1 ? q_last : q_full)) {
      lq = 0;
      if (++lj == K) {
        lj = 0;
        ++lc;
      }
    }
  };
  // the epilogue's res and acc_in tiles, [row][ct 8] floats, with step 0's
  // weights (where the plan has room)
  const float* pre = reinterpret_cast<const float*>(reinterpret_cast<const uint8_t*>(mma_raw) +
                                                    p.pre_off);
  const int pre_tile = kMmaRows * p.ct * 8;  // floats a tile
  if (p.pre_off != 0) {
    const uint32_t pre_s = slab_s + p.pre_off;
    for (int e = tid; e < nrows * ncols; e += kMmaThreads) {
      const int r = e / ncols, col = e - r * ncols;
      const size_t o = ((size_t)b * T + t0 + r) * Co + n0 + col;
      const uint32_t d = pre_s + (r * p.ct * 8 + col) * 4;
      if (res != nullptr) cp_async4(d, res + o);
      if ((mode & 3) == 2) cp_async4(d + pre_tile * 4, acc_in + o);
    }
  }
#pragma unroll 1
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < steps) load_next(s);
    cp_async_commit();
  }
  mma_stage<Op>(slab, a, b, T, Ci, x0, rows, ra, rb, 0, min(ck, ci_pad), pe);

  // the lane's ldmatrix row: sample 16 warp + (lane & 15) (warpgroup warp /
  // 4 its 64), unit + lane >> 4
  const uint32_t a_lane = slab_s + ((warp * 16 + (lane & 15)) * pitch_a + (lane >> 4)) * 16;
  int c = 0, j = 0, q = 0, staged = 0;  // the step computed next
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // step s's weights and the slab are in; step s - 1's wgmmas are done
    if (c != staged) {  // the operand's next chunk
      mma_stage<Op>(slab, a, b, T, Ci, x0, rows, ra, rb, c * ck, min(ck, ci_pad - c * ck), pe);
      staged = c;
      __syncthreads();
    }
    if (s + kRing - 1 < steps) load_next((s + kRing - 1) % kRing);
    cp_async_commit();

    const int len = c == nck - 1 ? last_len : ck;
    const int cs = q * ckw, nk = min(ckw, len - cs) / KT;  // the piece's slab columns, k tiles
    const uint32_t a_s = a_lane + (j * dil * pitch_a + cs / EPU) * 16;
    const uint32_t w_s = ring_s + (s % kRing) * stage_bytes;
    uint32_t ah[kSteps][4], al[kF32 ? kSteps : 1][4];
#pragma unroll
    for (int k = 0; k < kSteps; ++k)
      if (k < nk) ldsm_x4(ah[k], a_s + 2 * k * 16);
    if constexpr (kF32) {  // a = hi + lo, each rounded to tf32
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = __uint_as_float(ah[k][e]);
          ah[k][e] = tf32_rna(x);
          al[k][e] = tf32_rna(x - __uint_as_float(ah[k][e]));
        }
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      if (k < nk) {
        const uint64_t bh = smem_desc(w_s + 2 * k * N * 16, N * 16, 128);
        if constexpr (kF32) {
          const uint64_t bl = smem_desc(w_s + plane_bytes + 2 * k * N * 16, N * 16, 128);
          if constexpr ((kTf32Passes & 1) != 0) wgmma_rs<N, true>(part, al[k], bh);
          if constexpr ((kTf32Passes & 2) != 0) wgmma_rs<N, true>(part, ah[k], bl);
          if constexpr ((kTf32Passes & 4) != 0) wgmma_rs<N, true>(part, ah[k], bh);
        } else {
          wgmma_rs<N, false>(acc, ah[k], bh);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    if constexpr (kF32) {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) {
        acc[e] = __fadd_rn(acc[e], part[e]);
        part[e] = 0.0f;
      }
    }
    if (++q == (c == nck - 1 ? q_last : q_full)) {
      q = 0;
      if (++j == K) {
        j = 0;
        ++c;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the slab and the ring

  // epilogue: the sums through shared memory, then the block's outputs
  // (rows of the chunk's channels, contiguous in y), kLoadBatch a thread in
  // flight
  float* so = reinterpret_cast<float*>(mma_raw);
  const int g = lane >> 2, tq = lane & 3, r0 = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (i < ntl) {
      const int col = 8 * i + 2 * tq;
      *reinterpret_cast<float2*>(so + r0 * p.pitch_o + col) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(so + (r0 + 8) * p.pitch_o + col) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
  __syncthreads();
  const int nout = nrows * ncols;
  for (int e0 = tid; e0 < nout; e0 += kLoadBatch * kMmaThreads) {
    float v[kLoadBatch], av[kLoadBatch];
    size_t o[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = e0 + u * kMmaThreads;
      if (e >= nout) break;
      const int r = e / ncols, col = e - r * ncols;
      o[u] = ((size_t)b * T + t0 + r) * Co + n0 + col;
      const float sum = so[r * p.pitch_o + col];
      const int pi = r * p.ct * 8 + col;  // in the prefetched tiles
      v[u] = ((mode & 8) ? round_op<Op>(sum) : sum) + bias[n0 + col];
      if (res != nullptr) v[u] += p.pre_off != 0 ? pre[pi] : res[o[u]];
      av[u] = (mode & 3) != 2 ? 0.0f : p.pre_off != 0 ? pre[pre_tile + pi] : acc_in[o[u]];
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      if (e0 + u * kMmaThreads >= nout) break;
      epilogue_store<Op>(v[u], av[u], o[u], acc_out, y, act, mode, scale);
    }
  }
}

// ---------------------------------------------------------------------------
// the small route: narrow_small_kernel (Ci and Co 8 or 16, and the pair)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a b: mma.sync m16n8k16 bf16 (a 4 registers, b 2), m16n8k8 bf16 (a 2,
// b 1) and m16n8k8 tf32 (a 4, b 2), f32 sums
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The copy of one conv of the small route (ops/mrf.py::tile_conv), in the
// B fragments' order: (K, CO / 8 n8 tiles, k steps, 32 lanes, kSmallE
// elements), a lane's elements one 4-, 8- or 16-byte load. bf16: one k step
// of CI (m16n8k16 at 16, m16n8k8 at 8), lane 4 g + t holding w[n = g][k =
// 2t, 2t + 1 (, 2t + 8, 2t + 9)]; f32: CI / 8 steps of m16n8k8, w[g][t],
// w[g][t + 4] of the hi plane, then of the lo plane.
template <typename Op, int CI>
constexpr int kSmallSteps = sizeof(Op) == 4 ? CI / 8 : 1;
template <typename Op, int CI>
constexpr int kSmallE = sizeof(Op) == 4 ? 4 : CI / 4;

// acc[m][n] (the warp's m16 tile warp + 8 m, n8 tile n) += the conv's sums
// over (tap, k step, pass) in that order: A the slab's rows row0 + 16 (warp
// + 8 m) + tap dil .. + 15 (pitch 16-byte units a row; ldmatrix of the
// rows at the tap's shift, no copy a tap), B the tap's fragments of the
// copy sw. f32: the three-pass TF32 split a_lo w_hi + a_hi w_lo + a_hi w_hi
// (a split in registers: hi = tf32_rna(a), lo = tf32_rna(a - hi)), a tap's
// products in their own registers added rounded to nearest (the tensor
// cores' accumulation truncates). Tiles at or past ntiles are left out. A
// single conv and the pair's second conv run this same code, so the pair
// gives the bits of its two launches.
template <typename Op, int CI, int CO, int MT>
__device__ __forceinline__ void small_conv(float (&acc)[MT][CO / 8][4], uint32_t slab_s, int pitch,
                                           int row0, int ntiles, const Op* __restrict__ sw, int K,
                                           int dil) {
  constexpr bool kF32 = sizeof(Op) == 4;
  constexpr int NT = CO / 8, KS = kSmallSteps<Op, CI>, E = kSmallE<Op, CI>;
  constexpr int W = E * (int)sizeof(Op) / 4;  // 32-bit words a lane's fragment
  constexpr bool kX2 = !kF32 && CI == 8;      // m16n8k8 bf16: rows of one 16-byte unit
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t a_lane =
      slab_s + ((row0 + warp * 16 + (lane & 15)) * pitch + (kX2 ? 0 : lane >> 4)) * 16;
#pragma unroll 1
  for (int tap = 0; tap < K; ++tap) {
    uint32_t bw[NT][KS][W];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const Op* q = sw + ((size_t)((tap * NT + n) * KS + s) * 32 + lane) * E;
        if constexpr (W == 4) {
          const uint4 v = *reinterpret_cast<const uint4*>(q);
          bw[n][s][0] = v.x, bw[n][s][1] = v.y, bw[n][s][2] = v.z, bw[n][s][3] = v.w;
        } else if constexpr (W == 2) {
          const uint2 v = *reinterpret_cast<const uint2*>(q);
          bw[n][s][0] = v.x, bw[n][s][1] = v.y;
        } else {
          bw[n][s][0] = *reinterpret_cast<const uint32_t*>(q);
        }
      }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (warp + 8 * m >= ntiles) break;
      const uint32_t am = a_lane + (128 * m + tap * dil) * pitch * 16;
      if constexpr (kF32) {
        float part[NT][4] = {};
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, am + 2 * s * 16);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = __uint_as_float(ah[e]);
            ah[e] = tf32_rna(x);
            al[e] = tf32_rna(x - __uint_as_float(ah[e]));
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if constexpr ((kTf32Passes & 1) != 0) mma_tf32(part[n], al, bw[n][s][0], bw[n][s][1]);
            if constexpr ((kTf32Passes & 2) != 0) mma_tf32(part[n], ah, bw[n][s][2], bw[n][s][3]);
            if constexpr ((kTf32Passes & 4) != 0) mma_tf32(part[n], ah, bw[n][s][0], bw[n][s][1]);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = __fadd_rn(acc[m][n][e], part[n][e]);
      } else if constexpr (kX2) {
        uint32_t a2[2];
        ldsm_x2(a2, am);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_k8(acc[m][n], a2, bw[n][0][0]);
      } else {
        uint32_t a4[4];
        ldsm_x4(a4, am);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_k16(acc[m][n], a4, bw[n][0][0], bw[n][0][1]);
      }
    }
  }
}

// 8 values of v to p in the operand type, as 16-byte stores
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
                                            bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7]));
}

__device__ __forceinline__ void load8(float* v, const float* p) {
  const float4 x = reinterpret_cast<const float4*>(p)[0], z = reinterpret_cast<const float4*>(p)[1];
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = z.x, v[5] = z.y, v[6] = z.z, v[7] = z.w;
}

// The plan of a narrow_small_kernel launch (narrow_plan)
struct SmallPlan {
  int rows;      // slab rows: the first conv's m16 tiles x 16 + dil (K - 1)
  int pitch;     // the slab's row pitch, 16-byte units (odd)
  int w_units;   // 16-byte units of one conv's copy
  int slab_off;  // bytes to the slab (past the weights: both convs' for the pair)
  int pre_off;   // bytes to the res and acc_in tiles (kSmallRows x CO floats each)
};

// narrow_small_kernel: Ci = CI and Co = CO, each 8 or 16; PAIR: the fused
// ResBlock1 pair (CI = CO). grid (ceil(T / kSmallRows), B), kSmallThreads
// threads (warp w the outputs' m16 tile w), dynamic shared memory p's: the
// weights (both convs' with PAIR), the slab (operand rows x0 .. x0 + rows -
// 1 of batch row b, [row][channel], 0 outside [0, T): SAME padding, never the
// neighbouring batch row), then the res and acc_in tiles where given, all
// copied by cp.async at the block's start: one wait, then the products, no
// barrier between taps. PAIR: the first conv runs over the rows t0 -
// kSmallLead .. t0 + kSmallRows + kSmallLead - 1 (9 m16 tiles, warp 0 two),
// its operand op(lrelu(v + bias1)) (0 outside [0, T): the second conv's
// SAME padding) written over the slab, and the second conv (dilation 1)
// reads it from row kSmallLead - (K - 1) / 2. The epilogue goes through
// shared memory (a tile over the slab), a thread 8 channels of a row (16-byte
// accesses; the block's outputs one contiguous run). a (B, T, CI) and the
// copies wt, wt2 (kSmallE) in the operand type Op; bias, bias2 (CO) f32;
// res, acc_in, y, act and acc_out as narrow_group_kernel's (mode as there).
template <typename Op, int CI, int CO, bool PAIR>
__global__ void __launch_bounds__(kSmallThreads, 2)
narrow_small_kernel(const Op* __restrict__ a, const Op* __restrict__ wt,
                    const float* __restrict__ bias, const Op* __restrict__ wt2,
                    const float* __restrict__ bias2, const float* __restrict__ res,
                    const float* __restrict__ acc_in, void* __restrict__ acc_out,
                    float* __restrict__ y, Op* __restrict__ act, int T, int K, int dil, int mode,
                    float scale, const SmallPlan p) {
  constexpr int NT = CO / 8;
  constexpr int EPU = 16 / (int)sizeof(Op);
  constexpr int UNITS = CI / EPU;  // 16-byte units of an operand row
  extern __shared__ float4 small_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(small_raw);
  const uint32_t smem_s = smem_addr(small_raw), slab_s = smem_s + p.slab_off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * kSmallRows, b = blockIdx.y;
  const int r0 = PAIR ? t0 - kSmallLead : t0;  // the first conv's first row
  const int x0 = r0 - dil * (K - 1) / 2;       // the slab's first operand row
  const int nrows = min(kSmallRows, T - t0);
  const Op* w1 = reinterpret_cast<const Op*>(smem);
  const Op* w2 = w1 + (size_t)p.w_units * EPU;
  float* pre_res = reinterpret_cast<float*>(smem + p.pre_off);
  float* pre_acc = pre_res + (res != nullptr ? kSmallRows * CO : 0);

  // one round trip: the weights, the slab and the epilogue's inputs
  for (int i = tid; i < p.w_units; i += kSmallThreads) {
    cp_async16(smem_s + i * 16, reinterpret_cast<const uint4*>(wt) + i);
    if (PAIR) cp_async16(smem_s + (p.w_units + i) * 16, reinterpret_cast<const uint4*>(wt2) + i);
  }
  for (int i = tid; i < p.rows * UNITS; i += kSmallThreads) {
    const int r = i / UNITS, u = i - r * UNITS, t = x0 + r;
    const bool in = t >= 0 && t < T;
    cp_async16_zfill(slab_s + (r * p.pitch + u) * 16,
                     a + ((size_t)b * T + (in ? t : 0)) * CI + u * EPU, in ? 16 : 0);
  }
  const size_t o0 = ((size_t)b * T + t0) * CO;  // the block's outputs: one run
  for (int i = tid; i < nrows * CO / 4; i += kSmallThreads) {
    if (res != nullptr) cp_async16(smem_addr(pre_res + 4 * i), res + o0 + 4 * i);
    if ((mode & 3) == 2) cp_async16(smem_addr(pre_acc + 4 * i), acc_in + o0 + 4 * i);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[1][NT][4] = {};
  if constexpr (PAIR) {
    constexpr int kTiles = kSmallRows / 16 + 1;  // the first conv's m16 tiles
    float acc1[2][NT][4] = {};
    small_conv<Op, CI, CO, 2>(acc1, slab_s, p.pitch, 0, kTiles, w1, K, dil);
    __syncthreads();  // every warp is done with the slab
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (warp + 8 * m >= kTiles) break;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the tile
          const int row = 16 * (warp + 8 * m) + g + 8 * h, col = 8 * n + 2 * tq;
          const int tr = r0 + row;
          const bool kept = tr >= 0 && tr < T;  // outside [0, T): the second conv's padding
          const float v0 = kept ? round_op<Op>(lrelu(acc1[m][n][2 * h] + bias[col])) : 0.0f;
          const float v1 = kept ? round_op<Op>(lrelu(acc1[m][n][2 * h + 1] + bias[col + 1])) : 0.0f;
          Op* q = reinterpret_cast<Op*>(smem + p.slab_off + row * p.pitch * 16) + col;
          if constexpr (sizeof(Op) == 4) {
            *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(v0, v1);
          }
        }
    }
    __syncthreads();
    small_conv<Op, CO, CO, 1>(acc, slab_s, p.pitch, kSmallLead - (K - 1) / 2, kSmallRows / 16, w2,
                              K, 1);
  } else {
    small_conv<Op, CI, CO, 1>(acc, slab_s, p.pitch, 0, kSmallRows / 16, w1, K, dil);
  }
  __syncthreads();  // the weights and the slab are free: the epilogue's tile over them

  float* so = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, tq = lane & 3, row = 16 * warp + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * tq;
      *reinterpret_cast<float2*>(so + row * kSmallPitchO + col) =
          make_float2(acc[0][n][0], acc[0][n][1]);
      *reinterpret_cast<float2*>(so + (row + 8) * kSmallPitchO + col) =
          make_float2(acc[0][n][2], acc[0][n][3]);
    }
  }
  __syncthreads();
  const float* bo = PAIR ? bias2 : bias;
  for (int i = tid; i < nrows * NT; i += kSmallThreads) {  // 8 channels of a row
    const int r = i / NT, c = 8 * (i - r * NT);
    float v[8], s[8], x[8];
    load8(x, so + r * kSmallPitchO + c);
    load8(s, bo + c);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = ((mode & 8) ? round_op<Op>(x[q]) : x[q]) + s[q];
    if (res != nullptr) {
      load8(x, pre_res + 8 * i);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] += x[q];
    }
    const size_t o = o0 + 8 * (size_t)i;
    if (y != nullptr) store8(y + o, v);
    if (act != nullptr) {
#pragma unroll
      for (int q = 0; q < 8; ++q) s[q] = lrelu(v[q]);
      store8(act + o, s);
    }
    if (mode & 3) {
      if ((mode & 3) == 2) load8(x, pre_acc + 8 * i);
#pragma unroll
      for (int q = 0; q < 8; ++q) s[q] = (mode & 3) == 2 ? x[q] + scale * v[q] : scale * v[q];
      if (mode & 4) {
#pragma unroll
        for (int q = 0; q < 8; ++q) s[q] = lrelu(s[q]);
        store8(reinterpret_cast<Op*>(acc_out) + o, s);
      } else {
        store8(reinterpret_cast<float*>(acc_out) + o, s);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the plan and the launches
// ---------------------------------------------------------------------------

// The output channels a block of narrow_group_kernel (G): the least power
// of two >= Co (Co < 8)
int narrow_group(int Co) {
  int g = 1;
  while (g < Co) g *= 2;
  return g;
}

enum Route { kSmall, kFfma, kMma };

// The plan of one launch. kSmall, narrow_small_kernel (Ci and Co 8 or 16;
// the pair, its K at most 2 kSmallLead + 1): the slab's rows and pitch, the
// copy's size, the shared memory's offsets (smem: both epilogue tiles; a
// launch takes those it reads). kFfma, narrow_group_kernel (Co < 8): G =
// narrow_group(Co), kc 16 where it divides Ci, else 8 where it does, else
// min(16, Ci), halved rounding up while the slice does not fit the shared
// memory; rows_p: the operand's rows a slice, odd (the staging's column
// writes then fall on distinct banks). kMma, narrow_mma_kernel (every other
// shape): the MmaPlan (its ct the kernel's instance, the wgmma's n8 tiles).
// Nothing but grid y depends on B.
struct NarrowPlan {
  Route route;
  int group, kc, rows_p;
  SmallPlan small;
  MmaPlan mma;
  size_t smem;
  dim3 grid;
};

int narrow_plan(int B, int T, int Ci, int Co, int K, int dil, bool pair, int es, NarrowPlan* p) {
  const bool small = (Co == 8 || Co == 16) && (Ci == 8 || Ci == 16);
  p->route = small ? kSmall : Co < 8 ? kFfma : kMma;
  if (B < 1 || B > 65535 || T < 1 || Ci < 1 || Co < 1 || K < 1 || K % 2 == 0 || dil < 1 ||
      (pair && (Ci != Co || !small || K > 2 * kSmallLead + 1)))
    return (int)cudaErrorInvalidValue;
  const long long halo = (long long)dil * (K - 1);
  if (halo >= (1 << 29)) return (int)cudaErrorInvalidValue;
  if (p->route == kSmall) {
    SmallPlan& s = p->small;
    s.rows = (pair ? kSmallRows + 2 * kSmallLead : kSmallRows) + (int)halo;
    s.pitch = (Ci * es / 16) | 1;
    s.w_units = K * (Co / 8) * (es == 4 ? Ci / 8 : 1) * 32 * (es == 4 ? 4 : Ci / 4) * es / 16;
    s.slab_off = (pair ? 2 : 1) * s.w_units * 16;
    const size_t body = (size_t)s.slab_off + (size_t)s.rows * s.pitch * 16;
    s.pre_off = (int)std::min(std::max(body, (size_t)kSmallRows * kSmallPitchO * sizeof(float)),
                              kMaxSmem + 1);
    p->smem = s.pre_off + 2 * (size_t)kSmallRows * Co * sizeof(float);
    if (p->smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    p->grid = dim3((T + kSmallRows - 1) / kSmallRows, B, 1);
    return 0;
  }
  if (p->route == kFfma) {
    p->group = narrow_group(Co);
    const int bt = kThreads * kFfmaRows;
    p->rows_p = (int)((bt + halo) | 1);
    p->kc = Ci % 16 == 0 ? 16 : Ci % 8 == 0 ? 8 : (Ci < 16 ? Ci : 16);
    auto smem = [&](int kc) {
      return ((size_t)kc * K * p->group + (size_t)kc * p->rows_p) * sizeof(float);
    };
    while (p->kc > 1 && smem(p->kc) > kMaxSmem) p->kc = (p->kc + 1) / 2;
    p->smem = smem(p->kc);
    if (p->smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    p->grid = dim3((T + bt - 1) / bt, B, 1);
    return 0;
  }
  const int kt = es == 4 ? 8 : 16, epu = 16 / es, planes = es == 4 ? 2 : 1;
  const int max_tiles = kMmaTiles;
  MmaPlan& m = p->mma;
  m.ci_pad = (Ci + kt - 1) / kt * kt;
  m.co_pad = (Co + 7) / 8 * 8;
  const int tiles = m.co_pad / 8;
  const int mblocks = (T + kMmaRows - 1) / kMmaRows;
  // N chunks: up to max_tiles n8 tiles each, more where fewer than fill
  // blocks would run; a chunk is a power of two of tiles (the wgmma's N),
  // the last maybe partial. bf16 fills the card, its chunks rounded down;
  // f32, whose restaged operand and narrow wgmmas cost more at 16 rows
  // (chip_smoke.py --narrow-design), half the card, rounded up
  const int fill = es == 4 ? kFillBlocks / 2 : kFillBlocks;
  const int nch0 = std::max((tiles + max_tiles - 1) / max_tiles,
                            std::min(tiles, (fill + mblocks - 1) / mblocks));
  const int ct0 = (tiles + nch0 - 1) / nch0;
  m.ct = 1;
  while (es == 4 ? m.ct < ct0 : 2 * m.ct <= ct0) m.ct *= 2;
  const int nch = (tiles + m.ct - 1) / m.ct;
  if (nch > 65535) return (int)cudaErrorInvalidValue;
  const long long rows = kMmaRows + halo;
  auto slab = [&](int ck) { return rows * ((ck / epu) | 1) * 16; };
  auto ring = [&](int nrows, int ckw) {
    return (long long)kRing * planes * (ckw / epu) * nrows * 16;
  };
  auto halve = [&](int ch) { return (ch / 2 + kt - 1) / kt * kt; };
  // the operand chunk: all of Ci where it fits beside the least ring of the
  // widest block, two blocks an SM, else one (from the shape alone: it sets
  // the sums' order)
  m.ck = m.ci_pad;
  for (const size_t budget : {kSoftSmem, kMaxSmem})
    while (m.ck > kt && slab(m.ck) + ring(max_tiles * 8, kt) > (long long)budget)
      m.ck = halve(m.ck);
  if (slab(m.ck) + ring(max_tiles * 8, kt) > (long long)kMaxSmem) return (int)cudaErrorInvalidValue;
  // a weight step: up to kStepTiles k tiles of the chunk, halved while two
  // blocks an SM do not fit (not below 64 bf16 / 32 f32 channels), then
  // while one does not
  const int ckw_min = es == 4 ? 32 : 64;
  m.ckw = std::min(m.ck, (es == 4 ? kStepTiles / 2 : kStepTiles) * kt);
  while (m.ckw > ckw_min && slab(m.ck) + ring(m.ct * 8, m.ckw) > (long long)kSoftSmem)
    m.ckw = halve(m.ckw);
  while (m.ckw > kt && slab(m.ck) + ring(m.ct * 8, m.ckw) > (long long)kMaxSmem)
    m.ckw = halve(m.ckw);
  m.pitch_a = (m.ck / epu) | 1;
  m.pitch_o = (m.ct * 8 + 31) / 32 * 32 + 8;
  m.ring_off = (int)slab(m.ck);
  m.plane_bytes = (m.ckw / epu) * m.ct * 8 * 16;
  p->smem = std::max((size_t)m.ring_off + (size_t)kRing * planes * m.plane_bytes,
                     (size_t)kMmaRows * m.pitch_o * sizeof(float));
  // the res and acc_in tiles after both, where two blocks an SM still fit
  const size_t pre = 2 * (size_t)kMmaRows * m.ct * 8 * sizeof(float);
  m.pre_off = p->smem + pre <= kSoftSmem ? (int)p->smem : 0;
  if (m.pre_off != 0) p->smem += pre;
  p->grid = dim3(mblocks, B, nch);
  return 0;
}

// the largest dynamic shared memory a kernel may take, asked for once
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  allowed = kMaxSmem;
  return 0;
}

template <typename Op, int CI, int CO, bool PAIR>
int launch_small(const NarrowPlan& p, const void* a, const void* wt, const void* bias,
                 const void* wt2, const void* bias2, const void* res, const void* acc_in,
                 void* acc_out, void* y, void* act, int T, int K, int dil, int mode, float scale,
                 cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const int tiles = (res != nullptr) + ((mode & 3) == 2);  // the epilogue tiles it reads
  const size_t smem = p.small.pre_off + (size_t)tiles * kSmallRows * CO * sizeof(float);
  if (const int err = allow_smem(narrow_small_kernel<Op, CI, CO, PAIR>, smem, allowed)) return err;
  narrow_small_kernel<Op, CI, CO, PAIR><<<p.grid, kSmallThreads, smem, stream>>>(
      (const Op*)a, (const Op*)wt, (const float*)bias, (const Op*)wt2, (const float*)bias2,
      (const float*)res, (const float*)acc_in, acc_out, (float*)y, (Op*)act, T, K, dil, mode, scale,
      p.small);
  return (int)cudaGetLastError();
}

template <typename Op, int G>
int launch_group(const NarrowPlan& p, const void* a, const void* wt, const void* bias,
                 const void* res, const void* acc_in, void* acc_out, void* y, void* act, int T,
                 int Ci, int Co, int K, int dil, int mode, float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  if (const int err = allow_smem(narrow_group_kernel<Op, G>, p.smem, allowed)) return err;
  narrow_group_kernel<Op, G><<<p.grid, kThreads, p.smem, stream>>>(
      (const Op*)a, (const Op*)wt, (const float*)bias, (const float*)res, (const float*)acc_in,
      acc_out, (float*)y, (Op*)act, T, Ci, Co, K, dil, p.kc, p.rows_p, mode, scale);
  return (int)cudaGetLastError();
}

template <typename Op, int NW>
int launch_mma(const NarrowPlan& p, const void* a, const void* wt, const void* bias,
               const void* res, const void* acc_in, void* acc_out, void* y, void* act, int T,
               int Ci, int Co, int K, int dil, int mode, float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  if (const int err = allow_smem(narrow_mma_kernel<Op, NW>, p.smem, allowed)) return err;
  narrow_mma_kernel<Op, NW><<<p.grid, kMmaThreads, p.smem, stream>>>(
      (const Op*)a, (const Op*)wt, (const float*)bias, (const float*)res, (const float*)acc_in,
      acc_out, (float*)y, (Op*)act, T, Ci, Co, K, dil, mode, scale, p.mma);
  return (int)cudaGetLastError();
}

// one conv, or with wt2 a fused ResBlock1 pair (see narrow_small_kernel)
template <typename Op>
int launch_narrow_mrf(const void* a, const void* wt, const void* bias, const void* wt2,
                      const void* bias2, const void* res, const void* acc_in, void* acc_out,
                      void* y, void* act, int B, int T, int Ci, int Co, int K, int dil, int mode,
                      float scale, cudaStream_t stream) {
  const bool pair = wt2 != nullptr;
  if (((mode & 3) == 2 && acc_in == nullptr) || ((mode & 3) != 0) != (acc_out != nullptr) ||
      mode < 0 || mode > 15 || (mode & 3) == 3 || (pair && (mode & 8)) ||
      (pair && bias2 == nullptr) || a == nullptr || wt == nullptr || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  if (Co % 4 == 0)  // the epilogue's vector accesses
    for (const void* q : {res, acc_in, (const void*)acc_out, (const void*)y, (const void*)act})
      if ((uintptr_t)q & 15) return (int)cudaErrorInvalidValue;
  NarrowPlan p;
  const int err = narrow_plan(B, T, Ci, Co, K, dil, pair, (int)sizeof(Op), &p);
  if (err) return err;
  if (p.route == kSmall)  // its copies and operand come by 16-byte cp.async, its biases by float4
    for (const void* q : {a, wt, wt2, bias, bias2})
      if ((uintptr_t)q & 15) return (int)cudaErrorInvalidValue;
#define T2_SMALL(CI_, CO_, PAIR_)                                                               \
  if (p.route == kSmall && Ci == CI_ && Co == CO_ && pair == PAIR_)                             \
    return launch_small<Op, CI_, CO_, PAIR_>(p, a, wt, bias, wt2, bias2, res, acc_in, acc_out, y, \
                                             act, T, K, dil, mode, scale, stream);
  T2_SMALL(16, 16, false)
  T2_SMALL(8, 8, false)
  T2_SMALL(8, 16, false)
  T2_SMALL(16, 8, false)
  T2_SMALL(16, 16, true)
  T2_SMALL(8, 8, true)
#undef T2_SMALL
#define T2_GROUP(G_)                                                                            \
  if (p.route == kFfma && p.group == G_)                                                        \
    return launch_group<Op, G_>(p, a, wt, bias, res, acc_in, acc_out, y, act, T, Ci, Co, K, dil, \
                                mode, scale, stream);
  T2_GROUP(8)
  T2_GROUP(4)
  T2_GROUP(2)
  T2_GROUP(1)
#undef T2_GROUP
#define T2_MMA(NT_)                                                                             \
  if (p.route == kMma && p.mma.ct == NT_)                                                           \
    return launch_mma<Op, NT_>(p, a, wt, bias, res, acc_in, acc_out, y, act, T, Ci, Co, K, dil,  \
                               mode, scale, stream);
  T2_MMA(8)
  T2_MMA(4)
  T2_MMA(2)
  T2_MMA(1)
#undef T2_MMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a (B, T, Ci) bf16 = bf16(lrelu(x)), wt the copy of a (K, Co, Ci) conv of
// dilation dil that ops/mrf.py::tile_conv makes for its route (the small
// route's fragments (K, Co / 8, 1, 32, Ci / 4), narrow_mma_kernel's (K, 1,
// Co8, Ci_pad), else (Ci, K, Co)): v = conv_dil(a) + bias (+ res), SAME; y,
// act and acc_out where given (mode as narrow_group_kernel); any Co and Ci
// >= 1
int t2_narrow_conv(const void* a, const void* wt, const void* bias, const void* res,
                   const void* acc_in, void* acc_out, void* y, void* act, int B, int T, int Ci,
                   int Co, int K, int dil, int mode, float scale, void* stream) {
  return launch_narrow_mrf<bf16>(a, wt, bias, nullptr, nullptr, res, acc_in, acc_out, y, act, B,
                                 T, Ci, Co, K, dil, mode, scale, (cudaStream_t)stream);
}

// a ResBlock1 pair in one launch: v = conv_1(bf16(lrelu(conv_dil(a) +
// bias1))) + bias2 (+ res), both convs (K, C, C), C 8 or 16; outputs as
// t2_narrow_conv
int t2_narrow_pair(const void* a, const void* wt1, const void* bias1, const void* wt2,
                   const void* bias2, const void* res, const void* acc_in, void* acc_out, void* y,
                   void* act, int B, int T, int C, int K, int dil, int mode, float scale,
                   void* stream) {
  if (wt2 == nullptr) return (int)cudaErrorInvalidValue;
  return launch_narrow_mrf<bf16>(a, wt1, bias1, wt2, bias2, res, acc_in, acc_out, y, act, B, T, C,
                                 C, K, dil, mode, scale, (cudaStream_t)stream);
}

// t2_narrow_conv on f32 operands and weights (the tensor-core routes'
// copies with hi and lo planes: (K, Co / 8, Ci / 8, 32, 4), (K, 2, Co8,
// Ci_pad)), act and an acc_out operand f32
int t2_narrow_conv_f32(const void* a, const void* wt, const void* bias, const void* res,
                       const void* acc_in, void* acc_out, void* y, void* act, int B, int T,
                       int Ci, int Co, int K, int dil, int mode, float scale, void* stream) {
  return launch_narrow_mrf<float>(a, wt, bias, nullptr, nullptr, res, acc_in, acc_out, y, act, B,
                                  T, Ci, Co, K, dil, mode, scale, (cudaStream_t)stream);
}

// t2_narrow_pair on f32 operands and weights: v = conv_1(lrelu(conv_dil(a) +
// bias1)) + bias2 (+ res)
int t2_narrow_pair_f32(const void* a, const void* wt1, const void* bias1, const void* wt2,
                       const void* bias2, const void* res, const void* acc_in, void* acc_out,
                       void* y, void* act, int B, int T, int C, int K, int dil, int mode,
                       float scale, void* stream) {
  if (wt2 == nullptr) return (int)cudaErrorInvalidValue;
  return launch_narrow_mrf<float>(a, wt1, bias1, wt2, bias2, res, acc_in, acc_out, y, act, B, T,
                                  C, C, K, dil, mode, scale, (cudaStream_t)stream);
}

}  // extern "C"
