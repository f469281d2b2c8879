// Kernel K2, f32 mode: the HiFi-GAN MRF stage at f32 precision, for sm_90a.
//
// Replaces the three stage kernels of tacotron2_tpu/ops/mrf_pallas.py in
// their bf16=False mode (_make_stage_kernel :285, _make_stage_kernel_ups
// :378, _make_stage_kernel_ups_expand :312, their operands and weights f32:
// `_dt = jnp.float32` at :463, :540, :636), the mode of every vocode of the
// JAX package (its HiFi-GAN's default policy is F32). Same function as
// csrc/mrf.cu, with f32 operands, f32 products and f32 sums (no TF32, no
// bf16 rounding anywhere):
//
//   t2_mrf_conv_f32    from the operand a = lrelu(x) (B, T, Ci) f32:
//                      v = conv_d(a) + bias (+ res), and any of y = v,
//                      act = lrelu(v) (the next conv's operand) and
//                      acc_out = (acc_in) + scale * v (the stage mean), or
//                      lrelu of that sum (mode & 4, the next stage's
//                      upsample's operand), all f32. The folded upsample
//                      (ops/mrf.py::fold_upsample: a SAME 3-tap conv to
//                      u Co channels) and the vocoder's conv_pre (from the
//                      mel itself, Ci = 80, k = 7) run on it too; mode & 8
//                      (conv_pre's rounding of the sum to the weights' type
//                      before the bias) is the identity at f32
//   t2_mrf_pair_f32    a ResBlock1 pair in one launch: the second conv
//                      (dilation 1) on lrelu of the first's output, which
//                      stays in shared memory (C = Ci = Co one N tile, <= 128)
//
// Bound: operations. At f32 a UNIVERSAL_V1 vocode does ~0.6 GFLOP per mel
// frame; the card's route to f32-exact products is the CUDA cores' FFMA
// (67 TFLOP/s) or a three-pass TF32 split on the tensor cores (3 x the
// flops at 495 TFLOP/s). This kernel takes the CUDA cores.
//
// Design: an implicit GEMM on the CUDA cores, M = output samples, N =
// output channels, K = Ci x taps.
// - A block of 256 threads owns BM x BN outputs (BN = 128, 64 or 32 by Co;
//   BM = 16384 / BN) of one batch row; a thread owns an 8 x 8 register tile,
//   rows trow + TROWS m and channels 4 tcol + e, BN / 2 + 4 tcol + e, and
//   accumulates it with FFMA.
// - Per slice of kKC input channels the block stages the operand over its
//   rows and the dilated halo in shared memory, channel-major [c][row]
//   (rows outside [0, T) and channels past Ci zero, never the next batch
//   row), and beside it the slice's weights of every tap, [tap][c][BN], one
//   contiguous run of a copy tiled once at load (ops/mrf.py::tile_conv).
//   Every tap reads the one staged copy at its own row offset.
// - Each output's sum runs over (slice, tap, channel) in that one order,
//   one FFMA each, whatever B, T, the grid or the tile: a served request's
//   audio does not depend on its window, and the fused pair's first conv
//   gives the bits of its own launch (chip_smoke.py holds both).
// - PAIR: the block computes the first conv over BM rows starting (K - 1) / 2
//   before its outputs, writes lrelu of them (0 outside [0, T): the second
//   conv's padding) into shared memory, and runs the second conv on that:
//   BM - (K - 1) outputs a block.
// Single-buffered: the loads of a slice wait for the products of the last.
// Making this mode fast (the TF32 split on wgmma / TMA, double buffering) is
// later work.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (cudaErrorInvalidValue for dimensions it does
// not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kSlope = 0.1f;
constexpr int kThreads = 256;
constexpr int kTM = 8, kTN = 8;                  // a thread's register tile
constexpr int kOut = kThreads * kTM * kTN;       // BM x BN outputs a block
constexpr int kKC = 16;                          // input channels a staged slice
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float lrelu(float x) { return x > 0.0f ? x : kSlope * x; }

// Rows of a staged slice: 2 mod 8, so the staging stores of 8 rows x 4
// channel quads of a warp fall in distinct banks
__host__ __device__ __forceinline__ int slice_stride(int rows) { return ((rows + 7) & ~7) + 2; }

// One conv's products over its slices into acc. The operand is x in device
// memory (B, T, Ci), the block's rows from x_row, staged slice by slice into
// As; or, where x is null, already in shared memory at inter ([Ci][istride]
// rows from the block's first). wt: the tiled copy, N tile nt.
template <int BN>
__device__ __forceinline__ void conv_products(float (&acc)[kTM][kTN], const float* __restrict__ x,
                                              const float* inter, int istride,
                                              const float* __restrict__ wt, float* As, float* Ws,
                                              int b, int T, int Ci, int K, int dil, int x_row,
                                              int rows, int nt) {
  constexpr int TCOLS = BN / kTN, TROWS = kThreads / TCOLS;
  const int tid = threadIdx.x, tcol = tid % TCOLS, trow = tid / TCOLS;
  const int ns = (Ci + kKC - 1) / kKC, run = K * kKC * BN, astr = slice_stride(rows);
  for (int s = 0; s < ns; ++s) {
    __syncthreads();  // the last slice's products are done
    const float4* wsrc = reinterpret_cast<const float4*>(wt + ((size_t)nt * ns + s) * run);
    for (int i = tid; i < run / 4; i += kThreads)
      reinterpret_cast<float4*>(Ws)[i] = __ldg(wsrc + i);
    const float* A = As;
    int stride = astr;
    if (x != nullptr) {
      for (int i = tid; i < rows * (kKC / 4); i += kThreads) {
        const int r = i / (kKC / 4), q = i % (kKC / 4), t = x_row + r, ch = s * kKC + 4 * q;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (t >= 0 && t < T && ch < Ci)
          v = __ldg(reinterpret_cast<const float4*>(x + ((size_t)b * T + t) * Ci + ch));
        As[(4 * q + 0) * astr + r] = v.x;
        As[(4 * q + 1) * astr + r] = v.y;
        As[(4 * q + 2) * astr + r] = v.z;
        As[(4 * q + 3) * astr + r] = v.w;
      }
    } else {
      A = inter + (size_t)s * kKC * istride;
      stride = istride;
    }
    __syncthreads();
    for (int j = 0; j < K; ++j) {
      const float* Aj = A + trow + j * dil;
      const float* Wj = Ws + j * kKC * BN + 4 * tcol;
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        float a[kTM];
#pragma unroll
        for (int m = 0; m < kTM; ++m) a[m] = Aj[c * stride + m * TROWS];
        const float4 w0 = *reinterpret_cast<const float4*>(Wj + c * BN);
        const float4 w1 = *reinterpret_cast<const float4*>(Wj + c * BN + BN / 2);
        const float w[kTN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int n = 0; n < kTN; ++n) acc[m][n] = fmaf(a[m], w[n], acc[m][n]);
      }
    }
  }
}

// grid (ceil(T / BMo), Co / BN, B), block kThreads. a (B, T, Ci) f32; wt
// the tiled weights (Co / BN, ceil(Ci / kKC), K, kKC, BN), zero past Ci;
// bias (Co); res, acc_in, acc_out, y, act (B, T, Co) f32 where given (mode
// & 3 = 0: no acc_out; 1: acc_out = scale v; 2: acc_out = acc_in + scale v;
// mode & 4: acc_out = lrelu of that sum). PAIR: wt2 / bias2 the second conv
// (K, C, C) of dilation 1, Ci = Co = BN.
template <int BN, bool PAIR>
__global__ void __launch_bounds__(kThreads, 2)
conv_f32_kernel(const float* __restrict__ a, const float* __restrict__ wt,
                const float* __restrict__ bias, const float* __restrict__ wt2,
                const float* __restrict__ bias2, const float* __restrict__ res,
                const float* __restrict__ acc_in, float* __restrict__ acc_out,
                float* __restrict__ y, float* __restrict__ act, int T, int Ci, int Co, int K,
                int dil, int mode, float scale) {
  constexpr int BM = kOut / BN, TCOLS = BN / kTN, TROWS = kThreads / TCOLS;
  constexpr int IS = BM + 16;  // PAIR: the first conv's operand rows, the taps' overrun included
  const int bmo = PAIR ? BM - (K - 1) : BM;
  const int t0 = blockIdx.x * bmo, nt = blockIdx.y, b = blockIdx.z;
  const int r0 = PAIR ? t0 - (K - 1) / 2 : t0;  // the first row of the first conv's tile
  const int rows = BM + (K - 1) * dil;
  extern __shared__ float4 smem_f4[];
  float* As = reinterpret_cast<float*>(smem_f4);
  float* Ws = As + kKC * slice_stride(rows);
  float* inter = Ws + K * kKC * BN;
  const int tid = threadIdx.x, tcol = tid % TCOLS, trow = tid / TCOLS;

  float acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[m][n] = 0.0f;
  conv_products<BN>(acc, a, nullptr, 0, wt, As, Ws, b, T, Ci, K, dil, r0 - dil * (K - 1) / 2, rows,
                    nt);

  if constexpr (PAIR) {
    // lrelu(v) of the first conv, 0 outside [0, T), into inter [C][IS]; rows
    // past BM (read only for outputs past bmo) zero
    for (int i = tid; i < BN * (IS - BM); i += kThreads)
      inter[(i / (IS - BM)) * IS + BM + i % (IS - BM)] = 0.0f;
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      const int lr = trow + m * TROWS, t = r0 + lr;
      const bool in = t >= 0 && t < T;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        const int co = (n < 4 ? 0 : BN / 2) + 4 * tcol + (n & 3);
        inter[co * IS + lr] = in ? lrelu(acc[m][n] + bias[co]) : 0.0f;
        acc[m][n] = 0.0f;
      }
    }
    conv_products<BN>(acc, nullptr, inter, IS, wt2, As, Ws, b, T, Ci, K, 1, 0, rows, 0);
  }

  const float* bo = PAIR ? bias2 : bias;
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int lr = trow + m * TROWS, t = t0 + lr;
    if (lr >= bmo || t >= T) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = nt * BN + h * (BN / 2) + 4 * tcol;
      const size_t o = ((size_t)b * T + t) * Co + co;
      const float4 bb = *reinterpret_cast<const float4*>(bo + co);
      float4 v = make_float4(acc[m][4 * h] + bb.x, acc[m][4 * h + 1] + bb.y,
                             acc[m][4 * h + 2] + bb.z, acc[m][4 * h + 3] + bb.w);
      if (res != nullptr) {
        const float4 rv = *reinterpret_cast<const float4*>(res + o);
        v.x += rv.x;
        v.y += rv.y;
        v.z += rv.z;
        v.w += rv.w;
      }
      if (y != nullptr) *reinterpret_cast<float4*>(y + o) = v;
      if (act != nullptr)
        *reinterpret_cast<float4*>(act + o) = make_float4(lrelu(v.x), lrelu(v.y), lrelu(v.z),
                                                          lrelu(v.w));
      if (mode & 3) {
        float4 s = make_float4(scale * v.x, scale * v.y, scale * v.z, scale * v.w);
        if ((mode & 3) == 2) {
          const float4 av = *reinterpret_cast<const float4*>(acc_in + o);
          s = make_float4(av.x + scale * v.x, av.y + scale * v.y, av.z + scale * v.z,
                          av.w + scale * v.w);
        }
        if (mode & 4) s = make_float4(lrelu(s.x), lrelu(s.y), lrelu(s.z), lrelu(s.w));
        *reinterpret_cast<float4*>(acc_out + o) = s;
      }
    }
  }
}

// Shared memory of a launch: the staged slice, the slice's weights of every
// tap and, for a pair, the first conv's operand
size_t conv_f32_smem(int BN, int K, int dil, bool pair) {
  const int BM = kOut / BN;
  return sizeof(float) * ((size_t)kKC * slice_stride(BM + (K - 1) * dil) + (size_t)K * kKC * BN +
                          (pair ? (size_t)BN * (BM + 16) : 0));
}

template <int BN, bool PAIR>
int launch_f32(const float* a, const float* wt, const float* bias, const float* wt2,
               const float* bias2, const float* res, const float* acc_in, float* acc_out, float* y,
               float* act, int B, int T, int Ci, int Co, int K, int dil, int mode, float scale,
               cudaStream_t stream) {
  constexpr int BM = kOut / BN;
  const int bmo = PAIR ? BM - (K - 1) : BM;
  const size_t smem = conv_f32_smem(BN, K, dil, PAIR);
  if (bmo < 1 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_f32_kernel<BN, PAIR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    allowed = kMaxSmem;
  }
  const dim3 grid((T + bmo - 1) / bmo, Co / BN, B);
  conv_f32_kernel<BN, PAIR><<<grid, kThreads, smem, stream>>>(
      a, wt, bias, wt2, bias2, res, acc_in, acc_out, y, act, T, Ci, Co, K, dil, mode, scale);
  return (int)cudaGetLastError();
}

// one conv, or with wt2 a fused ResBlock1 pair (see conv_f32_kernel)
int launch_mrf_f32(const void* a, const void* wt, const void* bias, const void* wt2,
                   const void* bias2, const void* res, const void* acc_in, void* acc_out, void* y,
                   void* act, int B, int T, int Ci, int Co, int K, int dil, int mode, float scale,
                   cudaStream_t stream) {
  const bool pair = wt2 != nullptr;
  const int BN = Co % 128 == 0 ? 128 : (Co % 64 == 0 ? 64 : 32);
  if (B < 1 || T < 1 || Ci < 8 || Ci % 8 || Co % 32 || K % 2 == 0 || dil < 1 || B > 65535 ||
      ((mode & 3) == 2 && acc_in == nullptr) || ((mode & 3) != 0) != (acc_out != nullptr) ||
      mode < 0 || mode > 15 || (mode & 3) == 3 || (pair && (mode & 8)) ||
      (pair && (bias2 == nullptr || Ci != Co || Co != BN || K > 17)))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {a, wt, bias, wt2, bias2, res, acc_in, (const void*)acc_out, (const void*)y,
                        (const void*)act})
    if ((uintptr_t)p & 15) return (int)cudaErrorInvalidValue;
  const float *fa = (const float*)a, *fw = (const float*)wt, *fb = (const float*)bias,
              *fw2 = (const float*)wt2, *fb2 = (const float*)bias2, *fr = (const float*)res,
              *fi = (const float*)acc_in;
  float *fo = (float*)acc_out, *fy = (float*)y, *fact = (float*)act;
#define T2_F32(BN_, PAIR_)                                                                     \
  if (BN == BN_ && pair == PAIR_)                                                              \
    return launch_f32<BN_, PAIR_>(fa, fw, fb, fw2, fb2, fr, fi, fo, fy, fact, B, T, Ci, Co, K, \
                                  dil, mode, scale, stream);
  T2_F32(128, false)
  T2_F32(64, false)
  T2_F32(32, false)
  T2_F32(128, true)
  T2_F32(64, true)
  T2_F32(32, true)
#undef T2_F32
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a (B, T, Ci) f32 = lrelu(x) (conv_pre: the mel), wt the f32 tiled weights
// of a (K, Co, Ci) conv of dilation dil: v = conv_dil(a) + bias (+ res),
// SAME; y, act and acc_out where given (mode as conv_f32_kernel); Ci a
// multiple of 8, Co of 32
int t2_mrf_conv_f32(const void* a, const void* wt, const void* bias, const void* res,
                    const void* acc_in, void* acc_out, void* y, void* act, int B, int T, int Ci,
                    int Co, int K, int dil, int mode, float scale, void* stream) {
  return launch_mrf_f32(a, wt, bias, nullptr, nullptr, res, acc_in, acc_out, y, act, B, T, Ci, Co,
                        K, dil, mode, scale, (cudaStream_t)stream);
}

// a ResBlock1 pair in one launch: v = conv_1(lrelu(conv_dil(a) + bias1)) +
// bias2 (+ res), both convs (K, C, C), C one N tile (32, 64 or 128);
// outputs as t2_mrf_conv_f32
int t2_mrf_pair_f32(const void* a, const void* wt1, const void* bias1, const void* wt2,
                    const void* bias2, const void* res, const void* acc_in, void* acc_out,
                    void* y, void* act, int B, int T, int C, int K, int dil, int mode, float scale,
                    void* stream) {
  if (wt2 == nullptr) return (int)cudaErrorInvalidValue;
  return launch_mrf_f32(a, wt1, bias1, wt2, bias2, res, acc_in, acc_out, y, act, B, T, C, C, K,
                        dil, mode, scale, (cudaStream_t)stream);
}

}  // extern "C"
