// Kernel K2: the HiFi-GAN MRF stage, for sm_90a.
//
// Replaces the three stage kernels of tacotron2_tpu/ops/mrf_pallas.py
// (_make_stage_kernel, _make_stage_kernel_ups, _make_stage_kernel_ups_expand):
// [lrelu -> ConvTranspose1d] -> mean over resblocks of
// [lrelu -> dilated conv -> (lrelu -> conv) -> + residual], channels-last.
//
//   t2_mrf_conv        y = conv_d(lrelu(x)) + bias (+ res);
//                      acc_out = (acc_in) + scale * y   (the stage mean)
//   t2_conv_transpose  y = ConvTranspose1d(lrelu(x)) + bias
//
// Bound: the stage is bound by operations (~0.6 GFLOP per mel frame for
// UNIVERSAL_V1, ~0.6 us at 989 TFLOP/s bf16); with one launch per conv, as
// here, each conv moves its f32 activations through device memory, and
// summed over a vocode those bytes outweigh the flops.
// t2_mrf_conv is an implicit GEMM on the tensor cores:
// each 128-thread block owns a 64-sample x 32-channel output tile, stages
// the input slice with its dilated halo in shared memory once per 32 input
// channels (leaky ReLU and the bf16 rounding applied on the way in), and
// runs mma.sync m16n8k16 (bf16 in, f32 accumulate) for every tap against
// that one staged slice. Bias, residual and the scaled sum into the stage
// mean are applied in the epilogue, so no elementwise pass goes through
// device memory. t2_conv_transpose runs on the same kernel: a transposed
// conv of stride u is u plain convs of k/u taps (one per output phase,
// written with stride u), so it gets the tensor cores too.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSlope = 0.1f;
constexpr int TM = 64;        // output samples per block
constexpr int TN = 32;        // output channels per block
constexpr int TK = 32;        // input channels per staged slice
constexpr int LDS = TK + 8;   // padded shared row (bf16), 80 bytes
constexpr int kThreads = 128; // 4 warps x 16 output rows

__device__ __forceinline__ float lrelu(float x) { return x > 0.0f ? x : kSlope * x; }

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Implicit-GEMM convolution on the tensor cores, shared by both entry points.
//
// Output row q of phase r is written to sample t = q * nphase + r and reads
// input rows q + x_off + j * dil for taps j < KT (zero outside [0, Tin)):
//   conv (nphase 1):           x_off = -dil * (KT - 1) / 2, SAME padding;
//   transposed conv, stride u: nphase = u, and phase r is a plain conv over
//     the KT = K / u taps m = m0 + (KT - 1 - j) * u, m0 = (r + pad) % u, with
//     x_off = (r + pad - m0) / u - (KT - 1); its weights come packed per
//     phase and tap.
// grid (ceil(Tq / TM), Co / TN, B * nphase), block kThreads.
// x (B, Tin, Ci) f32, w (nphase, KT, Co, Ci) bf16, bias (Co) f32,
// res / acc_in / acc_out / y (B, Tout, Co) f32.
// mode 0: y only; 1: acc_out = scale * y; 2: acc_out = acc_in + scale * y.
__global__ void __launch_bounds__(kThreads)
conv_mma_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ res,
                const float* __restrict__ acc_in, float* __restrict__ acc_out,
                float* __restrict__ y, int Tin, int Tout, int Ci, int Co, int KT, int dil,
                int nphase, int tpad, int mode, float scale) {
  extern __shared__ uint4 smem_u4[];
  const int rows_ext = TM + (KT - 1) * dil;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // rows_ext x LDS
  __nv_bfloat16* Bs = As + (size_t)rows_ext * LDS;                  // TN x LDS

  const int r = blockIdx.z % nphase, b = blockIdx.z / nphase;
  int x_off;
  if (nphase == 1) {
    x_off = -(dil * (KT - 1)) / 2;
  } else {
    const int m0 = (r + tpad) % nphase;
    x_off = (r + tpad - m0) / nphase - (KT - 1);
  }
  const int Tq = (Tout - r + nphase - 1) / nphase;  // output rows of this phase
  const int t0 = blockIdx.x * TM, co0 = blockIdx.y * TN;
  if (t0 >= Tq) return;  // uniform over the block
  const __nv_bfloat16* wr = w + (size_t)r * KT * Co * Ci;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const float* xb = x + (size_t)b * Tin * Ci;

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  for (int ci0 = 0; ci0 < Ci; ci0 += TK) {
    __syncthreads();
    for (int i = tid; i < rows_ext * TK; i += kThreads) {
      const int rr = i / TK, c = i - rr * TK;
      const int t = t0 + x_off + rr;
      const float v = (t >= 0 && t < Tin) ? lrelu(xb[(size_t)t * Ci + ci0 + c]) : 0.0f;
      As[rr * LDS + c] = __float2bfloat16_rn(v);
    }
    for (int kk = 0; kk < KT; ++kk) {
      __syncthreads();
      const __nv_bfloat16* wk = wr + ((size_t)kk * Co + co0) * Ci + ci0;
      for (int i = tid; i < TN * TK; i += kThreads) {
        const int n = i / TK, c = i - n * TK;
        Bs[n * LDS + c] = wk[(size_t)n * Ci + c];
      }
      __syncthreads();
      const int ra = warp * 16 + g + kk * dil;  // staged row of output row warp*16+g
#pragma unroll
      for (int ks = 0; ks < TK; ks += 16) {
        const int ca = ks + q * 2;
        const uint32_t a0 = ld32(As + ra * LDS + ca);
        const uint32_t a1 = ld32(As + (ra + 8) * LDS + ca);
        const uint32_t a2 = ld32(As + ra * LDS + ca + 8);
        const uint32_t a3 = ld32(As + (ra + 8) * LDS + ca + 8);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const __nv_bfloat16* bp = Bs + (n * 8 + g) * LDS + ca;
          mma_bf16(acc[n], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qq = t0 + warp * 16 + g + hh * 8;
      if (qq >= Tq) continue;
      const int t = qq * nphase + r;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + n * 8 + q * 2 + e;
        const size_t o = ((size_t)b * Tout + t) * Co + co;
        float v = acc[n][hh * 2 + e] + bias[co];
        if (res != nullptr) v += res[o];
        y[o] = v;
        if (mode == 1) acc_out[o] = scale * v;
        else if (mode == 2) acc_out[o] = acc_in[o] + scale * v;
      }
    }
  }
}

int launch_conv(const void* x, const void* w, const void* bias, const void* res,
                const void* acc_in, void* acc_out, void* y, int B, int Tin, int Tout, int Ci,
                int Co, int KT, int dil, int nphase, int tpad, int mode, float scale,
                void* stream) {
  if (Ci % TK || Co % TN || (mode == 2 && acc_in == nullptr) ||
      (mode != 0 && acc_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(TM + (KT - 1) * dil + TN) * LDS * sizeof(__nv_bfloat16);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const int tq_max = (Tout + nphase - 1) / nphase;
  dim3 grid((tq_max + TM - 1) / TM, Co / TN, B * nphase);
  conv_mma_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const __nv_bfloat16*)w, (const float*)bias, (const float*)res,
      (const float*)acc_in, (float*)acc_out, (float*)y, Tin, Tout, Ci, Co, KT, dil, nphase,
      tpad, mode, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, T, Ci), w (K, Co, Ci): y = conv_dil(lrelu(x)) + bias (+ res), SAME
int t2_mrf_conv(const void* x, const void* w, const void* bias, const void* res,
                const void* acc_in, void* acc_out, void* y, int B, int T, int Ci, int Co, int K,
                int dil, int mode, float scale, void* stream) {
  if (K % 2 == 0) return (int)cudaErrorInvalidValue;
  return launch_conv(x, w, bias, res, acc_in, acc_out, y, B, T, T, Ci, Co, K, dil, 1, 0, mode,
                     scale, stream);
}

// x (B, Tin, Ci), w (stride, K / stride, Co, Ci) packed per phase:
// y = ConvTranspose1d(lrelu(x), stride, padding) + bias
int t2_conv_transpose(const void* x, const void* w, const void* bias, void* y, int B, int Tin,
                      int Tout, int Ci, int Co, int K, int stride, int padding, void* stream) {
  if (K % stride || padding < 0) return (int)cudaErrorInvalidValue;
  return launch_conv(x, w, bias, nullptr, nullptr, nullptr, y, B, Tin, Tout, Ci, Co,
                     K / stride, 1, stride, padding, 0, 0.0f, stream);
}

}  // extern "C"
