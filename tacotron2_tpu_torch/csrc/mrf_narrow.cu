// Kernel K2, the other shapes: the HiFi-GAN MRF stage's convs at every
// channel count the wide kernels do not take, for sm_90a (CUDA cores, FFMA).
//
// Replaces tacotron2_tpu/ops/mrf_pallas.py's stage kernels at the channel
// counts that the wide kernels (csrc/mrf.cu, csrc/mrf_f32.cu: Co a multiple
// of 32, their N tiles, and Ci a multiple of 8, whole 16-byte pieces as TMA
// reads them) do not take. The TPU kernel takes any C (_make_stage_kernel
// :285, launched at :488): folded s = 128 / C where 128 % C == 0, else
// unfolded (:440); the aligned upsample fused in front (_make_stage_kernel_ups
// :378, launched at :583, its fold at :516-517), in both modes (bf16=True
// and False, `_dt` at :463 and :540). So HiFi-GAN V2's stages 3 and 4 (C =
// 16 and 8) and its last upsample (16 -> 2 x 8), a generator's stages at C =
// 4, 2 or 1, widths off 32 (200, 100, 50, 25), and a conv_pre from a
// num_mels off 8 all run here.
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
// operands, weights and FFMA sums, exact to f32 rounding, as the JAX
// package's F32 vocoder). One template serves both.
//
// Bound: bytes, or near the balance point, at the narrow widths. At C = 8 a
// k = 11 conv does 2 x 11 x 8 x 8 = 1,408 flops a sample against 64-160
// bytes moved a sample in f32 (the operand, the residual, the stage mean and
// the outputs), under the card's 67 TFLOP/s / 3.35 TB/s = 20 flops a byte of
// FP32; at C = 16, k = 11, 5,632 flops against 128-320 bytes. So the tensor
// cores would buy little there: wgmma's narrowest N is 8, and f32 would take
// TF32's three passes. Plain FP32 FFMA on the CUDA cores is exact to f32
// rounding and needs no split. At the wider odd widths (25 to 400 channels)
// the convs are bound by operations, and FFMA is the simple design, not the
// fast one (PERF.md has its times beside cuDNN's).
//
// Design: a block takes a group of G output channels (G = 16, or the least
// power of two >= Co below 16; the grid's z covers ceil(Co / G) groups, the
// last one maybe partial: zero in the staged weights, not written by the
// epilogue) and BT = 128 R samples of one batch row (R = 64 / G samples a
// thread, rows tid + 128 r, so a warp reads consecutive rows of shared
// memory). Per slice of kc input channels (16 where they divide Ci, else 8
// where they do, else min(16, Ci), halved while the slice does not fit the
// shared memory; the last slice maybe partial: only its channels below Ci
// are staged and summed) it stages the operand's rows of the block and its
// dilated halo, converted to f32, as [channel][row] in shared memory (0
// outside [0, T): the SAME padding, and never the neighbouring batch row;
// scalar loads, so a row of any Ci is read), and the slice's weights of the
// group [channel][tap][G] (from the copy ops/mrf.py::tile_conv makes at
// load: (Ci, K, Co)). Each thread holds R x G f32 sums; per (channel, tap)
// it reads G weights (a broadcast) and R operands and does R G FFMAs. Each
// output's sum runs over (input channel, tap) in that one order whatever B,
// T, the tile, the slice or the group, so a served request's audio does not
// depend on its window, and the fused pair gives the bits of its two
// launches (chip_smoke.py holds both). The epilogue stores float4 / bf16
// pairs where Co % 4 == 0 and G % 4 == 0, else one channel at a time.
//
// Two kernels share that design and its code (stage_slice, accumulate,
// epilogue_row). narrow_conv_kernel<Op, CO, PAIR> takes Co = CO = 8 or 16
// and Ci a multiple of 8 (HiFi-GAN V2's convs, and the fused pair): Co, the
// group and the slices' width are its compile-time shape, so the shared
// code's partial-group and scalar paths fold away. narrow_group_kernel<Op,
// G> takes every other shape: Co at run time, a partial last group and
// slice. (One kernel with Co at run time read V2's convs 14-25% slower.)
//
// PAIR (Ci = Co = CO = kc, 8 or 16): the block computes the first conv over
// its BT rows starting (K - 1) / 2 before its outputs, writes the operand of
// its output (0 outside [0, T): the second conv's padding) into shared
// memory over the staged operand, loads the second conv's weights over the
// first's and runs the second conv on it: BT - (K - 1) outputs a block.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (cudaErrorInvalidValue for dimensions it does
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kSlope = 0.1f;
constexpr int kThreads = 128;  // a block's threads
constexpr int kAccum = 64;     // f32 sums a thread holds: R samples x G channels
constexpr int kGroup = 16;     // output channels a block, at Co >= 16
constexpr size_t kMaxSmem = 227 * 1024;

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
// outside [0, T)), and the weights of those channels for output channels g0
// .. g0 + ng - 1 into sw as [channel][tap][G] (0 past ng). a (B, T, Ci) and
// wt (Ci, K, Co) in the operand type. Where the group is all of Co (every
// narrow_conv_kernel launch) the slice's weights are one run, copied as is.
template <int G, typename Op>
__device__ __forceinline__ void stage_slice(float* __restrict__ sa, float* __restrict__ sw,
                                            const Op* __restrict__ a, const Op* __restrict__ wt,
                                            int b, int T, int Ci, int Co, int K, int c0, int nci,
                                            int g0, int ng, int x0, int rows, int rows_p) {
  const int tid = threadIdx.x;
  for (int i = tid; i < rows * nci; i += kThreads) {
    const int row = i / nci, cc = i - row * nci, t = x0 + row;
    sa[cc * rows_p + row] =
        (t >= 0 && t < T) ? to_f32(a[((size_t)b * T + t) * Ci + c0 + cc]) : 0.0f;
  }
  if (Co == G && ng == G) {
    const Op* ws = wt + (size_t)c0 * K * G;
    for (int i = tid; i < nci * K * G; i += kThreads) sw[i] = to_f32(ws[i]);
    return;
  }
  for (int i = tid; i < nci * K * G; i += kThreads) {
    const int cj = i / G, q = i - cj * G;  // cj = channel * K + tap
    sw[i] = q < ng ? to_f32(wt[((size_t)c0 * K + cj) * Co + g0 + q]) : 0.0f;
  }
}

// The epilogue of one output row: v = the sums acc (rounded to the operand
// type with mode & 8) + bias bo, + res, then y, act and acc_out (mode as
// narrow_conv_kernel's) for the row's ng channels from o on; vec: float4 /
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
    float vg = v[g];
    if (res != nullptr) vg += res[o + g];
    if (y != nullptr) y[o + g] = vg;
    if (act != nullptr) store_one(act + o + g, lrelu(vg));
    if (mode & 3) {
      float sg = scale * vg;
      if ((mode & 3) == 2) sg = acc_in[o + g] + scale * vg;
      if (mode & 4) store_one(reinterpret_cast<Op*>(acc_out) + o + g, lrelu(sg));
      else reinterpret_cast<float*>(acc_out)[o + g] = sg;
    }
  }
}

// grid (ceil(T / BMo), B), block kThreads, dynamic shared memory (kc K CO +
// kc rows_p) floats: the weights of a slice first (16-byte aligned for the
// float4 reads), then the operand's slice, rows_p >= BT + dil (K - 1), odd.
// a (B, T, Ci) and the weight copy wt (Ci, K, CO) in the operand type Op;
// bias (CO) f32; res, acc_in, y (B, T, CO) f32 and act (B, T, CO) Op where
// given; acc_out (B, T, CO) f32, or Op with mode & 4 (mode & 3 = 0: no
// acc_out; 1: acc_out = scale v; 2: acc_out = acc_in + scale v; mode & 4:
// acc_out gets op(lrelu(that sum)); mode & 8: the sum rounded to Op before
// the bias). PAIR: wt2 (CO, K, CO) and bias2, the second conv (dilation 1).
template <typename Op, int CO, bool PAIR>
__global__ void __launch_bounds__(kThreads)
narrow_conv_kernel(const Op* __restrict__ a, const Op* __restrict__ wt,
                   const float* __restrict__ bias, const Op* __restrict__ wt2,
                   const float* __restrict__ bias2, const float* __restrict__ res,
                   const float* __restrict__ acc_in, void* __restrict__ acc_out,
                   float* __restrict__ y, Op* __restrict__ act, int T, int Ci, int K, int dil,
                   int kc, int rows_p, int mode, float scale) {
  constexpr int R = kAccum / CO;     // samples a thread
  constexpr int BT = kThreads * R;   // the first conv's rows a block
  extern __shared__ float4 narrow_raw[];
  float* sw = reinterpret_cast<float*>(narrow_raw);
  float* sa = sw + kc * K * CO;
  const int tid = threadIdx.x;
  const int bmo = PAIR ? BT - (K - 1) : BT;
  const int t0 = blockIdx.x * bmo, b = blockIdx.y;
  const int r0 = PAIR ? t0 - (K - 1) / 2 : t0;  // the first row of the first conv's tile
  const int x0 = r0 - dil * (K - 1) / 2;       // the first operand row it reads
  const int rows = BT + dil * (K - 1);
  float acc[R][CO];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[r][co] = 0.0f;

  for (int c0 = 0; c0 < Ci; c0 += kc) {
    __syncthreads();  // every thread is done with the previous slice
    stage_slice<CO>(sa, sw, a, wt, b, T, Ci, CO, K, c0, kc, 0, CO, x0, rows, rows_p);
    __syncthreads();
    accumulate<R, CO>(acc, sa, rows_p, sw, kc, K, dil);
  }

  if constexpr (PAIR) {
    // the first conv's operand, rows r0 .. r0 + BT - 1, as [CO][rows_p] over
    // the staged operand (kc == CO), rows BT .. BT + K - 2 zero (read only
    // for outputs past BMo); the second conv's weights over the first's
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int lr = tid + kThreads * r, t = r0 + lr;
      const bool in = t >= 0 && t < T;
#pragma unroll
      for (int co = 0; co < CO; ++co) {
        sa[co * rows_p + lr] = in ? round_op<Op>(lrelu(acc[r][co] + bias[co])) : 0.0f;
        acc[r][co] = 0.0f;
      }
    }
    for (int i = tid; i < CO * (K - 1); i += kThreads)
      sa[(i / (K - 1)) * rows_p + BT + i % (K - 1)] = 0.0f;
    for (int i = tid; i < CO * K * CO; i += kThreads) sw[i] = to_f32(wt2[i]);
    __syncthreads();
    accumulate<R, CO>(acc, sa, rows_p, sw, CO, K, 1);
  }

  // epilogue (of the second conv where PAIR)
  const float* bo = PAIR ? bias2 : bias;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int lr = tid + kThreads * r, t = t0 + lr;
    if (lr >= bmo || t >= T) continue;
    epilogue_row<Op, CO>(acc[r], bo, CO, true, ((size_t)b * T + t) * CO, res, acc_in, acc_out,
                         y, act, mode, scale);
  }
}

// narrow_group_kernel: any Co and Ci. grid (ceil(T / BT), B, ceil(Co / G)),
// block kThreads, dynamic shared memory (kc K G + kc rows_p) floats: the
// weights of a slice first (16-byte aligned for the float4 reads), then the
// operand's slice, rows_p >= BT + dil (K - 1), odd. a (B, T, Ci) and the
// weight copy wt (Ci, K, Co) in the operand type Op; bias (Co) f32; res,
// acc_in, y (B, T, Co) f32 and act (B, T, Co) Op where given; acc_out as
// narrow_conv_kernel's (mode as there).
template <typename Op, int G>
__global__ void __launch_bounds__(kThreads)
narrow_group_kernel(const Op* __restrict__ a, const Op* __restrict__ wt,
                    const float* __restrict__ bias, const float* __restrict__ res,
                    const float* __restrict__ acc_in, void* __restrict__ acc_out,
                    float* __restrict__ y, Op* __restrict__ act, int T, int Ci, int Co, int K,
                    int dil, int kc, int rows_p, int mode, float scale) {
  constexpr int R = kAccum / G;     // samples a thread
  constexpr int BT = kThreads * R;  // rows a block
  extern __shared__ float4 narrow_raw[];
  float* sw = reinterpret_cast<float*>(narrow_raw);
  float* sa = sw + kc * K * G;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT, b = blockIdx.y, g0 = blockIdx.z * G;
  const int ng = Co - g0 < G ? Co - g0 : G;  // the group's channels (the last group may be partial)
  const int x0 = t0 - dil * (K - 1) / 2;     // the first operand row the block reads
  const int rows = BT + dil * (K - 1);
  float acc[R][G];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[r][g] = 0.0f;

  for (int c0 = 0; c0 < Ci; c0 += kc) {
    const int nci = Ci - c0 < kc ? Ci - c0 : kc;  // the slice's channels (the last may be partial)
    __syncthreads();  // every thread is done with the previous slice
    stage_slice<G>(sa, sw, a, wt, b, T, Ci, Co, K, c0, nci, g0, ng, x0, rows, rows_p);
    __syncthreads();
    accumulate<R, G>(acc, sa, rows_p, sw, nci, K, dil);
  }

  // epilogue: the group's ng channels
  const bool vec = G % 4 == 0 && Co % 4 == 0;  // then ng % 4 == 0 and every row 16-byte aligned
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + tid + kThreads * r;
    if (t >= T) continue;
    epilogue_row<Op, G>(acc[r], bias + g0, ng, vec, ((size_t)b * T + t) * Co + g0, res, acc_in,
                        acc_out, y, act, mode, scale);
  }
}

// The output channels a block of narrow_group_kernel (G): kGroup, or the
// least power of two >= Co below it
int narrow_group(int Co) {
  int g = 1;
  while (g < Co && g < kGroup) g *= 2;
  return g;
}

// The plan of one launch. narrow_conv_kernel (Co 8 or 16, Ci a multiple of
// 8; a pair): kc 16 where it divides Ci, else 8; narrow_group_kernel (every
// other shape): G = narrow_group(Co), kc 16 where it divides Ci, else 8
// where it does, else min(16, Ci), halved rounding up while the slice does
// not fit the shared memory. rows_p: the operand's rows a slice, odd (the
// staging's column writes then fall on distinct banks).
struct NarrowPlan {
  bool general;
  int group, kc, rows_p;
  size_t smem;
  dim3 grid;
};

int narrow_plan(int B, int T, int Ci, int Co, int K, int dil, bool pair, NarrowPlan* p) {
  p->general = !((Co == 8 || Co == 16) && Ci % 8 == 0);
  if (B < 1 || B > 65535 || T < 1 || Ci < 1 || Co < 1 || K < 1 || K % 2 == 0 || dil < 1 ||
      (pair && (Ci != Co || p->general)))
    return (int)cudaErrorInvalidValue;
  p->group = p->general ? narrow_group(Co) : Co;
  const int groups = (Co + p->group - 1) / p->group;
  const int bt = kThreads * (kAccum / p->group), bmo = pair ? bt - (K - 1) : bt;
  if (bmo < 1 || groups > 65535) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)bt + (long long)dil * (K - 1);
  if (rows >= (1 << 30)) return (int)cudaErrorInvalidValue;
  p->rows_p = (int)(rows | 1);
  p->kc = Ci % 16 == 0 ? 16 : Ci % 8 == 0 ? 8 : (Ci < 16 ? Ci : 16);
  auto smem = [&](int kc) {
    return ((size_t)kc * K * p->group + (size_t)kc * p->rows_p) * sizeof(float);
  };
  while (p->general && p->kc > 1 && smem(p->kc) > kMaxSmem) p->kc = (p->kc + 1) / 2;
  p->smem = smem(p->kc);
  if (p->smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  p->grid = dim3((T + bmo - 1) / bmo, B, groups);
  return 0;
}

template <typename Op, int CO, bool PAIR>
int launch_narrow(const NarrowPlan& p, const void* a, const void* wt, const void* bias,
                  const void* wt2, const void* bias2, const void* res, const void* acc_in,
                  void* acc_out, void* y, void* act, int T, int Ci, int K, int dil, int mode,
                  float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  if (p.smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(narrow_conv_kernel<Op, CO, PAIR>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    allowed = kMaxSmem;
  }
  narrow_conv_kernel<Op, CO, PAIR><<<p.grid, kThreads, p.smem, stream>>>(
      (const Op*)a, (const Op*)wt, (const float*)bias, (const Op*)wt2, (const float*)bias2,
      (const float*)res, (const float*)acc_in, acc_out, (float*)y, (Op*)act, T, Ci, K, dil, p.kc,
      p.rows_p, mode, scale);
  return (int)cudaGetLastError();
}

template <typename Op, int G>
int launch_group(const NarrowPlan& p, const void* a, const void* wt, const void* bias,
                 const void* res, const void* acc_in, void* acc_out, void* y, void* act, int T,
                 int Ci, int Co, int K, int dil, int mode, float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  if (p.smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(narrow_group_kernel<Op, G>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    allowed = kMaxSmem;
  }
  narrow_group_kernel<Op, G><<<p.grid, kThreads, p.smem, stream>>>(
      (const Op*)a, (const Op*)wt, (const float*)bias, (const float*)res, (const float*)acc_in,
      acc_out, (float*)y, (Op*)act, T, Ci, Co, K, dil, p.kc, p.rows_p, mode, scale);
  return (int)cudaGetLastError();
}

// one conv, or with wt2 a fused ResBlock1 pair (see narrow_conv_kernel)
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
  const int err = narrow_plan(B, T, Ci, Co, K, dil, pair, &p);
  if (err) return err;
#define T2_NARROW(CO_, PAIR_)                                                                   \
  if (!p.general && Co == CO_ && pair == PAIR_)                                                 \
    return launch_narrow<Op, CO_, PAIR_>(p, a, wt, bias, wt2, bias2, res, acc_in, acc_out, y, act, \
                                         T, Ci, K, dil, mode, scale, stream);
  T2_NARROW(16, false)
  T2_NARROW(8, false)
  T2_NARROW(16, true)
  T2_NARROW(8, true)
#undef T2_NARROW
#define T2_GROUP(G_)                                                                            \
  if (p.general && p.group == G_)                                                               \
    return launch_group<Op, G_>(p, a, wt, bias, res, acc_in, acc_out, y, act, T, Ci, Co, K, dil, \
                                mode, scale, stream);
  T2_GROUP(16)
  T2_GROUP(8)
  T2_GROUP(4)
  T2_GROUP(2)
  T2_GROUP(1)
#undef T2_GROUP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a (B, T, Ci) bf16 = bf16(lrelu(x)), wt the (Ci, K, Co) bf16 copy of a (K,
// Co, Ci) conv of dilation dil: v = conv_dil(a) + bias (+ res), SAME; y, act
// and acc_out where given (mode as narrow_conv_kernel); any Co and Ci >= 1
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

// t2_narrow_conv on f32 operands and weights, act and an acc_out operand f32
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
