// Kernel K1: one Tacotron 2 decode step as four kernels, for sm_90a.
//
// Replaces tacotron2_tpu/ops/decoder_loop_pallas.py::_decode_chunk_kernel
// (bf16 mode) with its batched_location_attention epilogue. The TPU kernel
// keeps both LSTM weight blocks (35.7 MB bf16 at the flagship dims) in VMEM
// for 64 frames; an H100 SM has 227 KB of shared memory, so here each step
// streams the weights through the whole card:
//
//   t2_prenet              prenet: 2 x (Linear, ReLU, x dropout mask)
//   t2_lstm_cell           LSTM gate matvec + i/f/g/o nonlinearity + c/h
//   t2_location_attention  query, folded location conv, tanh energies,
//                          masked softmax, context, cumulative weights, over
//                          a thread-block cluster of S blocks per batch row
//   t2_heads               mel + gate linear over [rnn_h | ctx]
//   t2_decode_chunk        n steps of the four, five launches a step, from
//                          one host call (the decode's main path)
//
// Bound: the LSTM weight bytes over HBM bandwidth (35.7 MB / 3.35 TB/s =
// 10.7 us per step at batch 1). t2_lstm_cell spreads the 4H gate rows over
// H/4 blocks, one warp per row with 16-byte loads, so all SMs stream at
// once; each row is read once per group of 4 batch rows. Operands are bf16
// (activations rounded as they are staged), sums f32, state f32.
//
// The location attention and heads kernels live in decode_common.cuh, which
// K3 (train_decode.cu) shares. The attention is latency of dependent
// phases: at batch 1 one block would stream the 256 KB query weight and run
// the location conv, softmax and 512-wide context alone on one SM. Here a
// cluster of S blocks takes each batch row (att_fwd_cluster_kernel, K3's
// design): rank r computes A/S of the query and the energies of its slice
// of chars, and the ranks combine the softmax's max and sum and the context
// in rank order through distributed shared memory, with no atomics. S comes
// from the model's dims and L alone (the wrapper's location_cluster_size),
// never from the batch, so a row's sums run in the same order whatever
// rows it shares a launch with. Every entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().
//
// Kernel K5, the int8 mode of the same TPU kernel (pack_decoder_params(
// quantize=True), its _quantize_xh and int8 gate products):
//
//   t2_lstm_cell_int8      the LSTM cell over int8 weights with one f32 scale
//                          per gate row: the block quantises its batch rows'
//                          f32 input per row (scale max|x| / 127, round half
//                          to even, clip to +-127) as it stages them, sums
//                          int8 x int8 products in int32 (__dp4a), and scales
//                          the sum back before the fused c/h update
//   t2_decode_chunk        with int8 weights, the same n steps with the two
//                          LSTM launches on this cell instead
//
// Bound: the int8 LSTM weight bytes, 17.8 MB at the flagship dims, over HBM
// bandwidth: 5.3 us per step at batch 1, half of K1's. Same layout as
// lstm_cell_kernel (one warp per gate row, 16 weights per 16-byte load);
// integer sums are exact in any order, so the gates equal the plain
// version's up to the float epilogue, whose multiplies and add are rounded
// one by one (no contraction into an FMA) in the plain version's order.

#include "decode_common.cuh"

namespace {

constexpr int kUnits = 4;         // hidden units per lstm_cell block


// grid H / kUnits, block 4 * kUnits warps; warp w -> unit w / 4, gate w % 4
__global__ void lstm_cell_kernel(const __nv_bfloat16* __restrict__ W, const float* __restrict__ bias,
                                 const float* x1, int n1, const float* x2, int n2,
                                 const float* x3, int n3, const float* __restrict__ c_in,
                                 float* __restrict__ h_out, float* __restrict__ c_out, int B,
                                 int H) {
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __shared__ float gsum[4 * kUnits][kGroup];
  const int R = n1 + n2 + n3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = warp >> 2, gate = warp & 3;
  const int j = blockIdx.x * kUnits + unit;
  const int row = gate * H + j;
  for (int b0 = 0; b0 < B; b0 += kGroup) {
    const int nb = min(kGroup, B - b0);
    __syncthreads();
    stage_inputs(xs, x1, n1, x2, n2, x3, n3, b0, nb);
    __syncthreads();
    float acc[kGroup];
    row_dot(W + (size_t)row * R, xs, R, nb, acc);
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) gsum[warp][g] = acc[g] + bias[row];
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t < kUnits * kGroup) {
      const int u = t / kGroup, g = t % kGroup;
      if (g < nb) {
        const int jj = blockIdx.x * kUnits + u;
        const size_t o = (size_t)(b0 + g) * H + jj;
        const float ig = sigmoid_f(gsum[u * 4 + 0][g]);
        const float fg = sigmoid_f(gsum[u * 4 + 1][g]);
        const float gg = tanhf(gsum[u * 4 + 2][g]);
        const float og = sigmoid_f(gsum[u * 4 + 3][g]);
        const float c = fg * c_in[o] + ig * gg;
        c_out[o] = c;
        h_out[o] = og * tanhf(c);
      }
    }
  }
}

// Element k of batch row b of the concatenated input [x1 | x2 | x3].
__device__ __forceinline__ float input_at(const float* x1, int n1, const float* x2, int n2,
                                          const float* x3, int n3, int b, int k) {
  if (k < n1) return x1[(size_t)b * n1 + k];
  if (k < n1 + n2) return x2[(size_t)b * n2 + (k - n1)];
  return x3[(size_t)b * n3 + (k - n1 - n2)];
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K5. grid H / kUnits, block 4 * kUnits warps (as lstm_cell_kernel); warp w
// -> unit w / 4, gate w % 4. Dynamic shared memory: the kGroup staged rows
// as int8, kGroup * R bytes (R % 16 == 0).
__global__ void lstm_cell_int8_kernel(const int8_t* __restrict__ W, const float* __restrict__ ws,
                                      const float* __restrict__ bias, const float* x1, int n1,
                                      const float* x2, int n2, const float* x3, int n3,
                                      const float* __restrict__ c_in, float* __restrict__ h_out,
                                      float* __restrict__ c_out, int B, int H) {
  extern __shared__ uint4 smem_u4[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem_u4);
  __shared__ float sx[kGroup];
  __shared__ float red[4 * kUnits][kGroup];
  __shared__ float gsum[4 * kUnits][kGroup];
  const int R = n1 + n2 + n3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = warp >> 2, gate = warp & 3;
  const int j = blockIdx.x * kUnits + unit;
  const int row = gate * H + j;
  for (int b0 = 0; b0 < B; b0 += kGroup) {
    const int nb = min(kGroup, B - b0);
    __syncthreads();
    // per-row activation scale from the f32 input (not a bf16-rounded
    // copy): every thread takes a strided share of each row, then the block
    // reduces the warps' maxima
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      float m = 0.0f;
      if (g < nb)
        for (int k = threadIdx.x; k < R; k += blockDim.x)
          m = fmaxf(m, fabsf(input_at(x1, n1, x2, n2, x3, n3, b0 + g, k)));
      m = warp_max(m);
      if (lane == 0) red[warp][g] = m;
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      float m = 0.0f;
      for (int w = 0; w < 4 * kUnits; ++w) m = fmaxf(m, red[w][threadIdx.x]);
      sx[threadIdx.x] = fmaxf(m, 1e-12f) / 127.0f;
    }
    __syncthreads();
    // q = clip(round_half_even(x / sx), -127, 127), true division
    for (int i = threadIdx.x; i < nb * R; i += blockDim.x) {
      const int g = i / R, k = i - g * R;
      const float v = rintf(input_at(x1, n1, x2, n2, x3, n3, b0 + g, k) / sx[g]);
      xq[i] = (int8_t)__float2int_rn(fminf(fmaxf(v, -127.0f), 127.0f));
    }
    __syncthreads();
    int acc[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) acc[g] = 0;
    const uint4* wrow = reinterpret_cast<const uint4*>(W + (size_t)row * R);
    for (int k16 = lane; k16 < R / 16; k16 += 32) {
      const uint4 w = __ldg(wrow + k16);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (g < nb) {
          const uint4 x = *(reinterpret_cast<const uint4*>(xq + (size_t)g * R) + k16);
          acc[g] = __dp4a((int)w.x, (int)x.x, acc[g]);
          acc[g] = __dp4a((int)w.y, (int)x.y, acc[g]);
          acc[g] = __dp4a((int)w.z, (int)x.z, acc[g]);
          acc[g] = __dp4a((int)w.w, (int)x.w, acc[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) acc[g] = warp_sum_int(acc[g]);
    if (lane == 0) {
      for (int g = 0; g < nb; ++g)
        gsum[warp][g] = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[g]), sx[g]), ws[row]), bias[row]);
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t < kUnits * kGroup) {
      const int u = t / kGroup, g = t % kGroup;
      if (g < nb) {
        const int jj = blockIdx.x * kUnits + u;
        const size_t o = (size_t)(b0 + g) * H + jj;
        const float ig = sigmoid_f(gsum[u * 4 + 0][g]);
        const float fg = sigmoid_f(gsum[u * 4 + 1][g]);
        const float gg = tanhf(gsum[u * 4 + 2][g]);
        const float og = sigmoid_f(gsum[u * 4 + 3][g]);
        const float c = fg * c_in[o] + ig * gg;
        c_out[o] = c;
        h_out[o] = og * tanhf(c);
      }
    }
  }
}

// grid B, block P threads; thread p -> prenet unit p (weights input-major);
// mel rows are ldm floats apart
__global__ void prenet_kernel(const float* __restrict__ mel, const __nv_bfloat16* __restrict__ w1t,
                              const __nv_bfloat16* __restrict__ w2t, const float* __restrict__ m1,
                              const float* __restrict__ m2, float* __restrict__ out, int M,
                              int P, int ldm) {
  extern __shared__ float sm[];
  float* xs = sm;      // M
  float* hs = sm + M;  // P
  const int b = blockIdx.x, p = threadIdx.x;
  for (int k = threadIdx.x; k < M; k += blockDim.x) xs[k] = rnd_bf16(mel[(size_t)b * ldm + k]);
  __syncthreads();
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < M; ++k) acc = fmaf(xs[k], __bfloat162float(w1t[(size_t)k * P + p]), acc);
  hs[p] = rnd_bf16(fmaxf(acc, 0.0f) * m1[(size_t)b * P + p]);
  __syncthreads();
  acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < P; ++k) acc = fmaf(hs[k], __bfloat162float(w2t[(size_t)k * P + p]), acc);
  out[(size_t)b * P + p] = fmaxf(acc, 0.0f) * m2[(size_t)b * P + p];
}

// ---- launchers (shared by the one-kernel entry points and the chunk) ----

// K1's attention: blocks of 256 threads, or of 128 where the clusters are
// more blocks than the card has SMs (the serve windows: 64 rows x S = 8).
// The sums' order does not follow: while a rank has at most 128 chars, a
// thread holds at most one char in the softmax's sums and the other sums
// run per output, whatever the block size.
int launch_k1_att(const void* h, const void* wq, const void* wloc, const void* wv,
                  const void* att_enc, const void* enc, const void* lengths, const void* w_prev,
                  const void* cum_prev, void* ctx_out, void* w_out, void* cum_out, int B, int L,
                  int H, int A, int D, int K, int S, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  if (S < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * S > sms && (L + S - 1) / S <= 128)
    return launch_att_fwd<float, float, 128>(h, H, wq, wloc, wv, att_enc, enc, lengths, w_prev,
                                             cum_prev, w_out, cum_out, ctx_out, D, nullptr, 0,
                                             B, S, L, H, A, D, K, false, stream);
  return launch_att_fwd<float, float, 256>(h, H, wq, wloc, wv, att_enc, enc, lengths, w_prev,
                                           cum_prev, w_out, cum_out, ctx_out, D, nullptr, 0, B,
                                           S, L, H, A, D, K, false, stream);
}

int launch_lstm_cell(const void* w, const void* b, const void* x1, int n1, const void* x2,
                     int n2, const void* x3, int n3, const void* c_in, void* h_out, void* c_out,
                     int B, int H, cudaStream_t stream) {
  const int R = n1 + n2 + n3;
  const size_t smem = (size_t)kGroup * R * sizeof(__nv_bfloat16);
  if (R % 8 || H % kUnits || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  lstm_cell_kernel<<<H / kUnits, 4 * kUnits * 32, smem, stream>>>(
      (const __nv_bfloat16*)w, (const float*)b, (const float*)x1, n1, (const float*)x2, n2,
      (const float*)x3, n3, (const float*)c_in, (float*)h_out, (float*)c_out, B, H);
  return (int)cudaGetLastError();
}

int launch_lstm_cell_int8(const void* w, const void* ws, const void* b, const void* x1, int n1,
                          const void* x2, int n2, const void* x3, int n3, const void* c_in,
                          void* h_out, void* c_out, int B, int H, cudaStream_t stream) {
  const int R = n1 + n2 + n3;
  const size_t smem = (size_t)kGroup * R;
  if (R % 16 || H % kUnits || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  lstm_cell_int8_kernel<<<H / kUnits, 4 * kUnits * 32, smem, stream>>>(
      (const int8_t*)w, (const float*)ws, (const float*)b, (const float*)x1, n1,
      (const float*)x2, n2, (const float*)x3, n3, (const float*)c_in, (float*)h_out,
      (float*)c_out, B, H);
  return (int)cudaGetLastError();
}

int launch_prenet(const void* mel, int ldm, const void* w1t, const void* w2t, const void* m1,
                  const void* m2, void* out, int B, int M, int P, cudaStream_t stream) {
  if (P > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(M + P) * sizeof(float);
  prenet_kernel<<<B, P, smem, stream>>>(
      (const float*)mel, (const __nv_bfloat16*)w1t, (const __nv_bfloat16*)w2t, (const float*)m1,
      (const float*)m2, (float*)out, M, P, ldm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int t2_lstm_cell(const void* w, const void* b, const void* x1, int n1, const void* x2, int n2,
                 const void* x3, int n3, const void* c_in, void* h_out, void* c_out, int B, int H,
                 void* stream) {
  return launch_lstm_cell(w, b, x1, n1, x2, n2, x3, n3, c_in, h_out, c_out, B, H,
                          (cudaStream_t)stream);
}

int t2_lstm_cell_int8(const void* w, const void* ws, const void* b, const void* x1, int n1,
                      const void* x2, int n2, const void* x3, int n3, const void* c_in,
                      void* h_out, void* c_out, int B, int H, void* stream) {
  return launch_lstm_cell_int8(w, ws, b, x1, n1, x2, n2, x3, n3, c_in, h_out, c_out, B, H,
                               (cudaStream_t)stream);
}

int t2_heads(const void* w, const void* b, const void* x1, int n1, const void* x2, int n2,
             void* out, int B, int N, void* stream) {
  return launch_heads(w, b, x1, n1, x2, n2, out, B, N, (cudaStream_t)stream);
}

int t2_prenet(const void* mel, const void* w1t, const void* w2t, const void* m1, const void* m2,
              void* out, int B, int M, int P, void* stream) {
  return launch_prenet(mel, M, w1t, w2t, m1, m2, out, B, M, P, (cudaStream_t)stream);
}

// the attention over a cluster of S blocks per batch row: h (B, H), ctx_out
// (B, D) f32
int t2_location_attention(const void* h, const void* wq, const void* wloc, const void* wv,
                          const void* att_enc, const void* enc, const void* lengths,
                          const void* w_prev, const void* cum_prev, void* ctx_out, void* w_out,
                          void* cum_out, int B, int L, int H, int A, int D, int K, int S,
                          void* stream) {
  return launch_k1_att(h, wq, wloc, wv, att_enc, enc, lengths, w_prev, cum_prev, ctx_out, w_out,
                       cum_out, B, L, H, A, D, K, S, (cudaStream_t)stream);
}

// n decode steps, five launches each, from one host call. Pointer slots:
//   p[0..10]  w_att b_att w_dec b_dec wp1_t wp2_t wq w_loc wv w_out b_out
//   p[11..13] att_enc encoded lengths
//   p[14..15] prenet masks m1 m2, (n, B, P) each
//   p[16..23] state in: mel att_h att_c ctx att_w att_cum rnn_h rnn_c
//   p[24..25] out: mel_gate (n, B, M+1), aligns (n, B, L)
//   p[26]     scratch: prenet output (B, P)
//   p[27..32] state ping-pong, (2, B, width) each: att_h att_c ctx att_cum rnn_h rnn_c
//   p[33..34] int8 mode only: the gate-row scales of w_att and w_dec, (4H,) f32
// Step t writes slot t % 2 and reads slot (t - 1) % 2 (the state in at t = 0);
// the previous attention weights and mel are the aligns and mel_gate rows of
// step t - 1. d = {n, B, M, P, H, D, L, A, K, int8, S}: with int8 != 0, w_att
// and w_dec are int8 and both LSTM cells run on K5; S blocks per batch row in
// the attention's cluster.
int t2_decode_chunk(void** p, const int* d, void* stream_) {
  const int n = d[0], B = d[1], M = d[2], P = d[3], H = d[4], D = d[5], L = d[6], A = d[7],
            K = d[8], N = M + 1;
  const bool int8 = d[9] != 0;
  const int S = d[10];
  cudaStream_t stream = (cudaStream_t)stream_;
  auto cell = [&](int w, int b, int scale, const void* x1, int n1, const void* x2, int n2,
                  const void* x3, int n3, const void* c_in, void* h_out, void* c_out) {
    return int8 ? launch_lstm_cell_int8(p[w], p[scale], p[b], x1, n1, x2, n2, x3, n3, c_in,
                                        h_out, c_out, B, H, stream)
                : launch_lstm_cell(p[w], p[b], x1, n1, x2, n2, x3, n3, c_in, h_out, c_out, B, H,
                                   stream);
  };
  float* mg = (float*)p[24];
  float* al = (float*)p[25];
  auto slot = [&](int i, int t, int width) -> float* {
    return (float*)p[i] + (size_t)(t & 1) * B * width;
  };
  for (int t = 0; t < n; ++t) {
    const bool first = t == 0;
    const void* mel = first ? p[16] : (const void*)(mg + (size_t)(t - 1) * B * N);
    const void* att_h = first ? p[17] : slot(27, t - 1, H);
    const void* att_c = first ? p[18] : slot(28, t - 1, H);
    const void* ctx = first ? p[19] : slot(29, t - 1, D);
    const void* att_w = first ? p[20] : (const void*)(al + (size_t)(t - 1) * B * L);
    const void* cum = first ? p[21] : slot(30, t - 1, L);
    const void* rnn_h = first ? p[22] : slot(31, t - 1, H);
    const void* rnn_c = first ? p[23] : slot(32, t - 1, H);
    const size_t mo = (size_t)t * B * P;
    int err = launch_prenet(mel, first ? M : N, p[4], p[5], (const float*)p[14] + mo,
                            (const float*)p[15] + mo, p[26], B, M, P, stream);
    if (!err)
      err = cell(0, 1, 33, p[26], P, ctx, D, att_h, H, att_c, slot(27, t, H), slot(28, t, H));
    if (!err)
      err = launch_k1_att(slot(27, t, H), p[6], p[7], p[8], p[11], p[12], p[13], att_w, cum,
                          slot(29, t, D), al + (size_t)t * B * L, slot(30, t, L), B, L, H, A, D,
                          K, S, stream);
    if (!err)
      err = cell(2, 3, 34, slot(27, t, H), H, slot(29, t, D), D, rnn_h, H, rnn_c,
                 slot(31, t, H), slot(32, t, H));
    if (!err)
      err = launch_heads(p[9], p[10], slot(31, t, H), H, slot(29, t, D), D,
                         mg + (size_t)t * B * N, B, N, stream);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
