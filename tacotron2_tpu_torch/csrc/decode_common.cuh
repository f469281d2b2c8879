// Kernels of K1 (decode_step.cu), for sm_90a; K3/K4 (train_decode.cu)
// share the warp helpers and the bf16 staging.
//
//   heads_kernel               mel + gate linear over [rnn_h | ctx]
//   location_attention_kernel  query, folded location conv, tanh energies,
//                              masked softmax, context, cumulative weights
//
// plus the warp helpers and bf16 staging they use. Each launcher checks
// the dimensions it takes, launches on the given stream, allocates nothing
// and returns cudaGetLastError() (cudaErrorInvalidValue for dimensions it
// does not take).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 4;         // batch rows per pass over a weight row
constexpr int kHeadsWarps = 8;    // output rows per heads block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// 8 bf16 (16 bytes) -> 8 floats
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Stage rows [b0, b0 + nb) of the concatenated input [x1 | x2 | x3] as bf16.
__device__ void stage_inputs(__nv_bfloat16* xs, const float* x1, int n1, const float* x2,
                             int n2, const float* x3, int n3, int b0, int nb) {
  const int R = n1 + n2 + n3;
  for (int i = threadIdx.x; i < nb * R; i += blockDim.x) {
    const int g = i / R, k = i - g * R, b = b0 + g;
    float v;
    if (k < n1) v = x1[(size_t)b * n1 + k];
    else if (k < n1 + n2) v = x2[(size_t)b * n2 + (k - n1)];
    else v = x3[(size_t)b * n3 + (k - n1 - n2)];
    xs[i] = __float2bfloat16_rn(v);
  }
}

// Dot of one bf16 weight row (length R, R % 8 == 0) with nb staged rows;
// every lane returns the full sums in acc[0..nb).
__device__ __forceinline__ void row_dot(const __nv_bfloat16* __restrict__ wrow,
                                        const __nv_bfloat16* xs, int R, int nb,
                                        float acc[kGroup]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) acc[g] = 0.0f;
  for (int k8 = lane; k8 < R / 8; k8 += 32) {
    float w[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(wrow) + k8), w);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g < nb) {
        float x[8];
        unpack8(*reinterpret_cast<const uint4*>(xs + (size_t)g * R + k8 * 8), x);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g] = fmaf(w[i], x[i], acc[g]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) acc[g] = warp_sum(acc[g]);
}

// grid (ceil(N / kHeadsWarps), ceil(B / kGroup)), block kHeadsWarps warps;
// warp -> output row, blockIdx.y -> a group of kGroup batch rows
__global__ void heads_kernel(const __nv_bfloat16* __restrict__ W, const float* __restrict__ bias,
                             const float* x1, int n1, const float* x2, int n2,
                             float* __restrict__ out, int B, int N) {
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  const int R = n1 + n2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kHeadsWarps + warp;
  const int b0 = blockIdx.y * kGroup, nb = min(kGroup, B - b0);
  stage_inputs(xs, x1, n1, x2, n2, x2, 0, b0, nb);
  __syncthreads();
  if (row < N) {
    float acc[kGroup];
    row_dot(W + (size_t)row * R, xs, R, nb, acc);
    if (lane == 0) {
      for (int g = 0; g < nb; ++g) out[(size_t)(b0 + g) * N + row] = acc[g] + bias[row];
    }
  }
}

constexpr int kAttThreads = 512;

__device__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float r = (lane < nw) ? red[lane] : (is_max ? -INFINITY : 0.0f);
  r = is_max ? warp_max(r) : warp_sum(r);
  return r;
}

// The part of K1's location-attention step before the energies: stage row
// b's query input (bf16-rounded), the energy vector, the folded
// location weight transposed to (channel, tap, a), the previous and
// cumulative weights padded by K/2 zeros (bf16-rounded, LW = L + K + 2 per
// channel), then the query projection q = wq . h, rounded to bf16. Ends
// synchronised.
__device__ void att_prologue(const float* __restrict__ h, const __nv_bfloat16* __restrict__ wq,
                             const __nv_bfloat16* __restrict__ wloc,
                             const __nv_bfloat16* __restrict__ wv,
                             const float* __restrict__ w_prev, const float* __restrict__ cum_prev,
                             int b, int L, int H, int A, int K, float* wlt, float* hs, float* q,
                             float* wvs, float* win) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int pad = K / 2, LW = L + K + 2;
  for (int k = tid; k < H; k += blockDim.x) hs[k] = rnd_bf16(h[(size_t)b * H + k]);
  for (int a = tid; a < A; a += blockDim.x) wvs[a] = __bfloat162float(wv[a]);
  for (int i = tid; i < A * 2 * K; i += blockDim.x) {
    const int ck = i / A, a = i - ck * A;  // wloc is (A, 2, K); writes stay contiguous
    wlt[i] = __bfloat162float(wloc[(size_t)a * 2 * K + ck]);
  }
  for (int i = tid; i < LW; i += blockDim.x) {
    const int l = i - pad;
    const bool in = l >= 0 && l < L;
    win[i] = in ? rnd_bf16(w_prev[(size_t)b * L + l]) : 0.0f;
    win[LW + i] = in ? rnd_bf16(cum_prev[(size_t)b * L + l]) : 0.0f;
  }
  __syncthreads();

  // query projection: a warp takes 4 outputs at once (4 independent 16-byte
  // weight loads in flight per step)
  for (int a0 = warp * 4; a0 < A; a0 += nwarps * 4) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k8 = lane; k8 < H / 8; k8 += 32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (a0 + i < A) {
          float w[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(wq + (size_t)(a0 + i) * H) + k8), w);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[i] = fmaf(w[k], hs[k8 * 8 + k], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = warp_sum(acc[i]);
      if (lane == 0 && a0 + i < A) q[a0 + i] = rnd_bf16(v);  // as the JAX kernels' qT.astype(dt)
    }
  }
  __syncthreads();
}

// grid B, block kAttThreads. Dynamic shared memory (floats):
//   hs[H] q[A] wv[A] wlt[2*K*A] win[2*LW] e[L] part[(A/4)*L]
// with LW = L + K + 2: the prev / cum weights padded by K/2 zeros in front
// and enough behind for the last 4-char group. wlt is the folded location
// weight transposed to (channel, tap, a) so a thread reads its 4 attention
// dims as one float4.
__global__ void location_attention_kernel(
    const float* __restrict__ h, const __nv_bfloat16* __restrict__ wq,
    const __nv_bfloat16* __restrict__ wloc, const __nv_bfloat16* __restrict__ wv,
    const float* __restrict__ att_enc, const __nv_bfloat16* __restrict__ enc,
    const int* __restrict__ lengths, const float* __restrict__ w_prev,
    const float* __restrict__ cum_prev, float* __restrict__ ctx_out, float* __restrict__ w_out,
    float* __restrict__ cum_out, int L, int H, int A, int D, int K) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ float red[32];
  const int LW = L + K + 2, AG = A / 4;
  float* wlt = sm;                 // 2*K*A, first so float4 reads stay aligned
  float* hs = wlt + 2 * K * A;
  float* q = hs + H;
  float* wvs = q + A;
  float* win = wvs + A;
  float* e = win + 2 * LW;
  float* part = e + L;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int len = lengths[b];

  att_prologue(h, wq, wloc, wv, w_prev, cum_prev, b, L, H, A, K, wlt, hs, q, wvs, win);

  // energies: a thread owns 4 chars x 4 attention dims, so each tap's 4
  // window values and one float4 of weights feed 16 independent FMAs
  const int LG = (L + 3) / 4;
  for (int item = tid; item < AG * LG; item += blockDim.x) {
    const int ag = item % AG, l0 = (item / AG) * 4, a0 = ag * 4;
    float loc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) loc[i][j] = 0.0f;
    for (int c = 0; c < 2; ++c) {
      const float* wn = win + c * LW + l0;
      const float* wc = wlt + (size_t)c * K * A + a0;
      for (int k = 0; k < K; ++k) {
        const float4 w4 = *reinterpret_cast<const float4*>(wc + (size_t)k * A);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = wn[k + i];
          loc[i][0] = fmaf(w4.x, xv, loc[i][0]);
          loc[i][1] = fmaf(w4.y, xv, loc[i][1]);
          loc[i][2] = fmaf(w4.z, xv, loc[i][2]);
          loc[i][3] = fmaf(w4.w, xv, loc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + i;
      if (l < L) {
        const float* ae = att_enc + ((size_t)b * L + l) * A + a0;
        float es = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          es = fmaf(rnd_bf16(tanhf(q[a0 + j] + loc[i][j] + ae[j])), wvs[a0 + j], es);
        part[ag * L + l] = es;
      }
    }
  }
  __syncthreads();
  for (int l = tid; l < L; l += blockDim.x) {
    float es = 0.0f;
    for (int ag = 0; ag < AG; ++ag) es += part[ag * L + l];
    e[l] = (l < len) ? es : -INFINITY;
  }
  __syncthreads();

  // masked softmax over the chars
  float m = -INFINITY;
  for (int l = tid; l < L; l += blockDim.x) m = fmaxf(m, e[l]);
  m = block_reduce(m, red, true);
  float s = 0.0f;
  for (int l = tid; l < L; l += blockDim.x) s += expf(e[l] - m);
  s = block_reduce(s, red, false);
  __syncthreads();
  for (int l = tid; l < L; l += blockDim.x) {
    const float w = expf(e[l] - m) / s;
    w_out[(size_t)b * L + l] = w;
    cum_out[(size_t)b * L + l] = cum_prev[(size_t)b * L + l] + w;
    e[l] = rnd_bf16(w);
  }
  __syncthreads();

  // context: thread per feature d, weights read from shared memory; four
  // independent partial sums keep several memory loads in flight
  for (int d = tid; d < D; d += blockDim.x) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const __nv_bfloat16* col = enc + (size_t)b * L * D + d;
    int l = 0;
    for (; l + 4 <= L; l += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = fmaf(e[l + i], __bfloat162float(col[(size_t)(l + i) * D]), acc[i]);
    }
    for (; l < L; ++l) acc[0] = fmaf(e[l], __bfloat162float(col[(size_t)l * D]), acc[0]);
    ctx_out[(size_t)b * D + d] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

int launch_heads(const void* w, const void* b, const void* x1, int n1, const void* x2, int n2,
                 void* out, int B, int N, cudaStream_t stream) {
  const int R = n1 + n2;
  const size_t smem = (size_t)kGroup * R * sizeof(__nv_bfloat16);
  if (R % 8 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kHeadsWarps - 1) / kHeadsWarps, (B + kGroup - 1) / kGroup);
  heads_kernel<<<grid, kHeadsWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)w, (const float*)b, (const float*)x1, n1, (const float*)x2, n2,
      (float*)out, B, N);
  return (int)cudaGetLastError();
}

int launch_location_attention(const void* h, const void* wq, const void* wloc, const void* wv,
                              const void* att_enc, const void* enc, const void* lengths,
                              const void* w_prev, const void* cum_prev, void* ctx_out,
                              void* w_out, void* cum_out, int B, int L, int H, int A, int D,
                              int K, cudaStream_t stream) {
  if (H % 8 || A % 4 || K % 2 == 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(2 * K * A + H + 2 * A + 2 * (L + K + 2) + L + (A / 4) * L) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(location_attention_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  location_attention_kernel<<<B, kAttThreads, smem, stream>>>(
      (const float*)h, (const __nv_bfloat16*)wq, (const __nv_bfloat16*)wloc,
      (const __nv_bfloat16*)wv, (const float*)att_enc, (const __nv_bfloat16*)enc,
      (const int*)lengths, (const float*)w_prev, (const float*)cum_prev, (float*)ctx_out,
      (float*)w_out, (float*)cum_out, L, H, A, D, K);
  return (int)cudaGetLastError();
}

}  // namespace
