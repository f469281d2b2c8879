// The encoder's bidirectional LSTM recurrence under the bf16 policy, for
// sm_90a.
//
// Not a Pallas kernel: it runs the recurrence of
// tacotron2_tpu/models/layers.py::lstm_sequence (XLA's scan under a bf16
// policy) for both directions at once. The input projection of every step
// (with b_ih) is one product outside, over all rows. Each step adds
// h . W_hh^T with h rounded to bf16 (bf16 operands, f32 sums) and b_hh, and
// keeps h and c in f32, as JAX does; a PyTorch loop of ~10 small ops a step
// each way cost more in launches than cuDNN's f32 LSTM, so the whole loop is
// one host call here.
//
//   t2_bilstm_forward   T launches: step s of both directions, gates + LSTM
//                       epilogue; saves the activated gates and cell states
//                       for the backward.
//   t2_bilstm_backward  2 T launches: step s's gate cotangents from the
//                       saved activations, then the recurrent pull
//                       dh_prev = bf16(dg . W_hh) (the cotangent of the
//                       bf16-rounded operand, as autograd and JAX round it).
//
// Bound: per step the bf16 W_hh of both directions (2 x 1024 x 256, 1 MB,
// L2-resident across steps) and 2 B x 4H x H multiply-adds (33.6 MFLOP at
// B = 32): latency-bound, ~1 us a step at the HBM rate. A block owns 4
// hidden units x 4 gates of one direction for 32 batch rows and computes
// them with plain FMAs from shared memory; every output has one fixed sum
// order, so a batch row's result does not depend on the other rows.
//
// Every entry launches on the given stream, allocates nothing and returns
// the launch's CUDA error (cudaErrorInvalidValue for dimensions it does not
// take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int EU = 4;          // hidden units per block
constexpr int ER = 4 * EU;     // their gate rows
constexpr int EM = 32;         // batch rows per block
constexpr int EThreads = 256;
constexpr int EMB = EThreads / ER;  // batch rows a pass of the threads covers
constexpr int ERPT = EM / EMB;      // batch rows per thread
constexpr int RThreads = 256;       // recurrent pull: 8 k-slices x 32 units

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// grid (H / EU, 2, ceil(B / EM)): gates of rows [m0, m0 + EM), units
// [j0, j0 + EU) of direction blockIdx.y at step s:
//   g = (xp[d, m, s, :] + hb[d, m, :] . W[d, :, :]^T) + b[d]
// then c = sig(f) c + sig(i) tanh(g), h = sig(o) tanh(c). Writes c (in
// place), hs[d, m, s], cs[d, m, s], act[d, m, s] (sig i, sig f, tanh g,
// sig o) and bf16(h) into hb_next. Dynamic shared memory: W rows (ER x
// (H + 2) bf16, padded so a warp's ER rows fall on distinct banks), h rows
// (EM x H bf16), the products (ER x EM f32).
__global__ void __launch_bounds__(EThreads)
lstm_seq_step_kernel(const float* __restrict__ xp, const bf16* __restrict__ W,
                     const float* __restrict__ bias, const bf16* __restrict__ hb, int B, int T,
                     int H, int s, float* __restrict__ c, float* __restrict__ hs,
                     float* __restrict__ cs, float* __restrict__ act, bf16* __restrict__ hb_next) {
  extern __shared__ uint4 es_u4[];
  const int LW = H + 2, G = 4 * H;
  bf16* Ws = reinterpret_cast<bf16*>(es_u4);
  bf16* Hs = Ws + ER * LW;
  float* P = reinterpret_cast<float*>(Hs + EM * H);
  const int d = blockIdx.y, j0 = blockIdx.x * EU, m0 = blockIdx.z * EM, tid = threadIdx.x;
  const bf16* Wd = W + (size_t)d * G * H;
  for (int i = tid; i < ER * (H / 2); i += EThreads) {
    const int r = i / (H / 2), k2 = i - r * (H / 2);
    const int row = (r / EU) * H + j0 + r % EU;  // gate r / EU of unit j0 + r % EU
    reinterpret_cast<uint32_t*>(Ws + r * LW)[k2] =
        reinterpret_cast<const uint32_t*>(Wd + (size_t)row * H)[k2];
  }
  for (int i = tid; i < EM * (H / 2); i += EThreads) {
    const int m = i / (H / 2), k2 = i - m * (H / 2);
    uint32_t v = 0;
    if (m0 + m < B) v = reinterpret_cast<const uint32_t*>(hb + ((size_t)d * B + m0 + m) * H)[k2];
    reinterpret_cast<uint32_t*>(Hs + m * H)[k2] = v;
  }
  __syncthreads();
  // thread: gate row r = tid % ER, batch rows m = tid / ER + EMB i
  {
    const int r = tid % ER, mb = tid / ER;
    float acc[ERPT];
#pragma unroll
    for (int i = 0; i < ERPT; ++i) acc[i] = 0.0f;
    const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(Ws + r * LW);
#pragma unroll 4
    for (int k2 = 0; k2 < H / 2; ++k2) {
      const float2 w = __bfloat1622float2(w2[k2]);
#pragma unroll
      for (int i = 0; i < ERPT; ++i) {
        const float2 h = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(Hs + (mb + EMB * i) * H)[k2]);
        acc[i] = fmaf(w.y, h.y, fmaf(w.x, h.x, acc[i]));
      }
    }
#pragma unroll
    for (int i = 0; i < ERPT; ++i) P[r * EM + mb + EMB * i] = acc[i];
  }
  __syncthreads();
  const int m = tid / EU, u = tid % EU, row = m0 + m, j = j0 + u;
  if (m >= EM || row >= B) return;
  const size_t st = (((size_t)d * B + row) * T + s);
  const float* x = xp + st * G;
  const float* bd = bias + (size_t)d * G;
  float gv[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
    gv[gate] = (x[gate * H + j] + P[(gate * EU + u) * EM + m]) + bd[gate * H + j];
  const float ig = sigmoid_f(gv[0]), fg = sigmoid_f(gv[1]), gg = tanhf(gv[2]),
              og = sigmoid_f(gv[3]);
  const size_t o = ((size_t)d * B + row) * H + j;
  const float cv = fg * c[o] + ig * gg;
  const float hv = og * tanhf(cv);
  c[o] = cv;
  hs[st * H + j] = hv;
  cs[st * H + j] = cv;
  float* a = act + st * G;
  a[j] = ig;
  a[H + j] = fg;
  a[2 * H + j] = gg;
  a[3 * H + j] = og;
  hb_next[o] = __float2bfloat16_rn(hv);
}

// thread per (d, m, j): the gate cotangents of step s (dh = dhs[s] + the
// recurrent pull; dc carried in place) into dg[d, m, s]
__global__ void lstm_seq_pull_kernel(const float* __restrict__ dhs, const float* __restrict__ act,
                                     const float* __restrict__ cs, const float* __restrict__ dh_rec,
                                     float* __restrict__ dc, float* __restrict__ dg, int B, int T,
                                     int H, int s) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)2 * B * H) return;
  const size_t dm = i / H;  // d * B + m
  const int j = (int)(i - dm * H), G = 4 * H;
  const size_t st = dm * T + s;
  const float* a = act + st * G;
  const float ig = a[j], fg = a[H + j], gg = a[2 * H + j], og = a[3 * H + j];
  const float cv = cs[st * H + j], c_prev = s > 0 ? cs[(st - 1) * H + j] : 0.0f;
  const float tc = tanhf(cv);
  const float dh = dhs[st * H + j] + dh_rec[i];
  const float dcv = dc[i] + dh * og * (1.0f - tc * tc);
  float* g = dg + st * G;
  g[j] = dcv * gg * ig * (1.0f - ig);
  g[H + j] = dcv * c_prev * fg * (1.0f - fg);
  g[2 * H + j] = dcv * ig * (1.0f - gg * gg);
  g[3 * H + j] = dh * tc * og * (1.0f - og);
  dc[i] = dcv * fg;
}

// grid (H / 32, B, 2), block RThreads: dh_rec[d, m, u] = bf16(sum over k
// of dg[d, m, s, k] W[d, k, u]); warp w sums k-slice w of the 4H, lane l unit
// u0 + l, and the slices meet in slice order
__global__ void __launch_bounds__(RThreads)
lstm_seq_rec_kernel(const float* __restrict__ dg, const bf16* __restrict__ W,
                    float* __restrict__ dh_rec, int B, int T, int H, int s) {
  constexpr int NS = RThreads / 32;
  __shared__ float part[NS][32];
  const int d = blockIdx.z, m = blockIdx.y, lane = threadIdx.x & 31, ks = threadIdx.x >> 5;
  const int u = blockIdx.x * 32 + lane, G = 4 * H, KS = G / NS;
  const float* g = dg + (((size_t)d * B + m) * T + s) * G + ks * KS;
  const bf16* Wd = W + (size_t)d * G * H + (size_t)ks * KS * H + u;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < KS; ++k) acc = fmaf(g[k], __bfloat162float(Wd[(size_t)k * H]), acc);
  part[ks][lane] = acc;
  __syncthreads();
  if (ks == 0) {
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i) v += part[i][lane];
    dh_rec[((size_t)d * B + m) * H + u] = __bfloat162float(__float2bfloat16_rn(v));
  }
}

inline unsigned blocks_for(size_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

size_t step_smem(int H) {
  return (size_t)ER * (H + 2) * sizeof(bf16) + (size_t)EM * H * sizeof(bf16) +
         (size_t)ER * EM * sizeof(float);
}

}  // namespace

extern "C" {

// Forward, T launches. p: xp (2, B, T, 4H) f32 (the input projection + b_ih),
// W_hh (2, 4H, H) bf16, b_hh (2, 4H) f32; out hs (2, B, T, H), cs (2, B, T,
// H), act (2, B, T, 4H) f32; scratch c (2, B, H) f32 and hb (2, 2, B, H)
// bf16 (a ping-pong pair of bf16(h)), both zero at entry. d = {B, T, H}.
int t2_bilstm_forward(void** p, const int* d, void* stream_) {
  const int B = d[0], T = d[1], H = d[2];
  if (B <= 0 || T <= 0 || H % EU || H % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const size_t smem = step_smem(H);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_seq_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  bf16* hb = (bf16*)p[7];
  const size_t half = (size_t)2 * B * H;
  const dim3 grid(H / EU, 2, (B + EM - 1) / EM);
  for (int s = 0; s < T; ++s) {
    lstm_seq_step_kernel<<<grid, EThreads, smem, stream>>>(
        (const float*)p[0], (const bf16*)p[1], (const float*)p[2], hb + (s % 2) * half, B, T, H,
        s, (float*)p[6], (float*)p[3], (float*)p[4], (float*)p[5], hb + ((s + 1) % 2) * half);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// Backward, 2 T launches. p: dhs (2, B, T, H) f32, act, cs (the forward's),
// W_hh (2, 4H, H) bf16; out dg (2, B, T, 4H) f32; scratch dh_rec, dc (2, B,
// H) f32, zero at entry. d = {B, T, H}.
int t2_bilstm_backward(void** p, const int* d, void* stream_) {
  const int B = d[0], T = d[1], H = d[2];
  if (B <= 0 || T <= 0 || H % 32 || (4 * H) % (RThreads / 32)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const size_t n = (size_t)2 * B * H;
  for (int s = T - 1; s >= 0; --s) {
    lstm_seq_pull_kernel<<<blocks_for(n, 256), 256, 0, stream>>>(
        (const float*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[5],
        (float*)p[6], (float*)p[4], B, T, H, s);
    int err = (int)cudaGetLastError();
    if (err) return err;
    lstm_seq_rec_kernel<<<dim3(H / 32, B, 2), RThreads, 0, stream>>>(
        (const float*)p[4], (const bf16*)p[3], (float*)p[5], B, T, H, s);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
