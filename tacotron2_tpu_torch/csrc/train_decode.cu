// Kernels K3 and K4: the teacher-forced decode of training, forward and
// backward, for sm_90a.
//
// K3 replaces tacotron2_tpu/ops/train_decode_pallas.py::_teacher_step_kernel
// and K4 its _teacher_bwd_kernel. The TPU kernels keep the packed LSTM
// weights (35.7 MB bf16 at the flagship dims) in VMEM for all T steps; an
// H100 SM has 227 KB of shared memory, so here every step streams them
// through the whole card, as K1 does, but at batch 32 the gate products are
// real (skinny) GEMMs and run on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 sums).
//
//   t2_teacher_forward   K3: all T steps from one host call, six launches
//                        a step: gather xh1 -> gate GEMM + LSTM epilogue x
//                        dm1 -> location attention (decode_common.cuh) ->
//                        gather xh2 -> gate GEMM + epilogue x dm2 -> heads.
//                        The residual stacks are written as the step runs:
//                        xh1/xh2 (bf16) by the gathers, and the cell states,
//                        attention weights and cumulative weights as stacks
//                        with T + 1 slots (slot 0 zero) that the step reads
//                        at t and writes at t + 1, so nothing is copied.
//   t2_gate_lstm         one gate GEMM + LSTM epilogue (K3's core), alone.
//   t2_teacher_backward  K4: the gate pre-activations of all T steps as two
//                        large GEMMs (they do not depend on the cotangents),
//                        then t = T-1 .. 0 with eight launches a step:
//                        heads pull -> decoder-LSTM pull (and attention-LSTM
//                        recompute) -> dxh2 = dg2 . W2 (split over the 4H
//                        contraction, partial sums reduced in a second pass:
//                        deterministic) -> attention recompute and pull ->
//                        attention-LSTM pull -> dxh1 = dg1 . W1 (split).
//                        Sums over steps of the small weights' gradients
//                        (d_attenc, d_wv, the folded location window) are
//                        read-modify-written per batch row by the one block
//                        that owns that row; d_wq, d_wout and dW1/dW2 are
//                        formed after the loop from stacks (dq, head_h, dg).
//
// Bound: per forward step and per backward step, the bf16 LSTM weights
// (35.7 MB) over the HBM rate: 10.7 us; the operations (2 x 32 x 4352 x 4096
// = 1.14 GFLOP per step, twice in the backward) take 1.2 us at the bf16
// tensor-core peak. A gate GEMM block owns 8 hidden units x 4 gates (32
// weight rows) for 32 batch rows, so the LSTM epilogue is fused and the
// gates never reach device memory in the forward; 128 blocks cover 132 SMs
// at H = 1024. Each block streams its 32 weight rows once through shared
// memory, with the next 64-column chunk loaded into registers while the
// tensor cores work on the current one.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (cudaErrorInvalidValue for dimensions it does
// not take).

#include "decode_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int GM = 32;         // gate GEMM: batch rows per block
constexpr int GU = 8;          // hidden units per block (x 4 gates = 32 columns)
constexpr int GN = 4 * GU;
constexpr int TKC = 64;        // contraction chunk
constexpr int LDS = TKC + 8;   // padded shared row (bf16), 144 bytes
constexpr int kThreads = 128;  // 4 warps
constexpr int DXN = 64;        // dx GEMM: output columns per block
constexpr int kStages = 4;     // cp.async ring depth of the gate GEMM
constexpr int kDxStages = 3;   // and of the dx GEMM (its B tile is twice as big)

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 that are not neighbours in memory -> one mma operand register
__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(lo)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// 16 bytes global -> shared without registers (zero-filled when !valid, and
// then nothing is read); a group per k-chunk keeps kStages - 1 in flight
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// gate GEMM: g[m, gate * H + j] = xh[m, :] . W[gate * H + j, :] + bias
// xh (M, R) bf16, W (4H, R) bf16, R % 8 == 0. grid (H / GU, ceil(M / GM)).
// Block column c is gate c / GU of unit j0 + c % GU.
// mode 0: out (M, 4H) f32 = the pre-activations.
// mode 1: LSTM epilogue, c = sig(f) c_prev + sig(i) tanh(g),
//         h = sig(o) tanh(c) * mask -> c_out, h_out (M, H).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
gate_gemm_kernel(const bf16* __restrict__ xh, const bf16* __restrict__ W,
                 const float* __restrict__ bias, int M, int R, int H, int mode,
                 float* __restrict__ out, const float* __restrict__ c_prev,
                 const float* __restrict__ mask, float* __restrict__ c_out,
                 float* __restrict__ h_out) {
  __shared__ __align__(16) bf16 As[kStages][GM * LDS];
  __shared__ __align__(16) bf16 Bs[kStages][GN * LDS];
  __shared__ float G[GM][GN + 1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.y * GM, j0 = blockIdx.x * GU;
  const int mt = warp & 1, nt0 = (warp >> 1) * 2;
  const int nk = (R + TKC - 1) / TKC;

  float acc[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  // k-chunk kt into ring slot kt % kStages: 32 rows of xh, the block's 32
  // weight rows (unit j0 + r % GU of gate r / GU)
  auto issue = [&](int kt) {
    if (kt < nk) {
      const int st = kt % kStages;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int i = tid + s * kThreads, r = i >> 3, c = (i & 7) * 8, k = kt * TKC + c;
        const int m = m0 + r, wrow = (r / GU) * H + j0 + (r % GU);
        const bool in_a = k < R && m < M, in_b = k < R;
        cp_async16(As[st] + r * LDS + c, xh + (in_a ? (size_t)m * R + k : 0), in_a);
        cp_async16(Bs[st] + r * LDS + c, W + (in_b ? (size_t)wrow * R + k : 0), in_b);
      }
    }
    cp_async_commit();  // empty past the end: the wait count stays uniform
  };
  for (int kt = 0; kt < kStages - 1; ++kt) issue(kt);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kt landed for all; slot (kt - 1) % kStages is free
    issue(kt + kStages - 1);
    const bf16* as = As[kt % kStages];
    const bf16* bs = Bs[kt % kStages];
    const int ra0 = mt * 16 + g;
#pragma unroll
    for (int ks = 0; ks < TKC; ks += 16) {
      const int ca = ks + q * 2;
      const uint32_t a0 = ld32(as + ra0 * LDS + ca);
      const uint32_t a1 = ld32(as + (ra0 + 8) * LDS + ca);
      const uint32_t a2 = ld32(as + ra0 * LDS + ca + 8);
      const uint32_t a3 = ld32(as + (ra0 + 8) * LDS + ca + 8);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const bf16* bp = bs + ((nt0 + n) * 8 + g) * LDS + ca;
        mma_bf16(acc[n], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        G[mt * 16 + g + hh * 8][(nt0 + n) * 8 + q * 2 + e] = acc[n][hh * 2 + e];
  __syncthreads();

  if (mode == 0) {
    for (int i = tid; i < GM * GN; i += kThreads) {
      const int r = i / GN, c = i - r * GN, m = m0 + r;
      if (m < M) {
        const int n = (c / GU) * H + j0 + c % GU;
        out[(size_t)m * 4 * H + n] = G[r][c] + bias[n];
      }
    }
  } else {
    for (int i = tid; i < GM * GU; i += kThreads) {
      const int r = i / GU, u = i - r * GU, m = m0 + r, j = j0 + u;
      if (m < M) {
        const float gi = G[r][u] + bias[j];
        const float gf = G[r][GU + u] + bias[H + j];
        const float gg = G[r][2 * GU + u] + bias[2 * H + j];
        const float go = G[r][3 * GU + u] + bias[3 * H + j];
        const size_t o = (size_t)m * H + j;
        const float c = sigmoid_f(gf) * c_prev[o] + sigmoid_f(gi) * tanhf(gg);
        c_out[o] = c;
        h_out[o] = sigmoid_f(go) * tanhf(c) * mask[o];
      }
    }
  }
}

// xh[m, :] = bf16([x1[m, :n1] | x2[m, :n2] | x3[m, :n3]]), rows ld1/ld2/ld3 apart
__global__ void gather_kernel(const float* __restrict__ x1, int ld1, int n1,
                              const float* __restrict__ x2, int ld2, int n2,
                              const float* __restrict__ x3, int ld3, int n3,
                              bf16* __restrict__ xh, int M) {
  const int R = n1 + n2 + n3;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * R) return;
  const int m = (int)(i / R), k = (int)(i - (size_t)m * R);
  float v;
  if (k < n1) v = x1[(size_t)m * ld1 + k];
  else if (k < n1 + n2) v = x2[(size_t)m * ld2 + k - n1];
  else v = x3[(size_t)m * ld3 + k - n1 - n2];
  xh[i] = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// dx GEMM, split over the contraction: part[s, m, r] = sum over n in split s
// of dg[m, n] * W[n, r]. dg (M, N) bf16, W (N, R) bf16, N % (S * TKC) == 0,
// R % 8 == 0. grid (ceil(R / DXN), S, ceil(M / GM)); warp w owns rows
// (w & 1) * 16 and columns (w >> 1) * 32 of the 32 x 64 tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
dx_partial_kernel(const bf16* __restrict__ dg, const bf16* __restrict__ W, int M, int N, int R,
                  int S, float* __restrict__ part) {
  constexpr int LDB = DXN + 8;
  __shared__ __align__(16) bf16 As[kDxStages][GM * LDS];
  __shared__ __align__(16) bf16 Bs[kDxStages][TKC * LDB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = blockIdx.x * DXN, s = blockIdx.y, m0 = blockIdx.z * GM;
  const int KS = N / S, kbeg = s * KS, nk = KS / TKC;
  const int mt = warp & 1, nt0 = (warp >> 1) * 4;

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  // k-chunk kt of this split into ring slot kt % kDxStages: dg 32 rows x 64
  // k, W 64 k rows x 64 columns
  auto issue = [&](int kt) {
    if (kt < nk) {
      const int st = kt % kDxStages, k0 = kbeg + kt * TKC;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = tid + t * kThreads, r = i >> 3, c = (i & 7) * 8, m = m0 + r;
        cp_async16(As[st] + r * LDS + c, dg + (m < M ? (size_t)m * N + k0 + c : 0), m < M);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = tid + t * kThreads, kr = i >> 3, c = r0 + (i & 7) * 8;
        cp_async16(Bs[st] + kr * LDB + (i & 7) * 8,
                   W + (c < R ? (size_t)(k0 + kr) * R + c : 0), c < R);
      }
    }
    cp_async_commit();
  };
  for (int kt = 0; kt < kDxStages - 1; ++kt) issue(kt);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kDxStages - 2>();
    __syncthreads();
    issue(kt + kDxStages - 1);
    const bf16* as = As[kt % kDxStages];
    const bf16* bs = Bs[kt % kDxStages];
    const int ra0 = mt * 16 + g;
#pragma unroll
    for (int ks = 0; ks < TKC; ks += 16) {
      const int ca = ks + q * 2;
      const uint32_t a0 = ld32(as + ra0 * LDS + ca);
      const uint32_t a1 = ld32(as + (ra0 + 8) * LDS + ca);
      const uint32_t a2 = ld32(as + ra0 * LDS + ca + 8);
      const uint32_t a3 = ld32(as + (ra0 + 8) * LDS + ca + 8);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = (nt0 + n) * 8 + g;
        const uint32_t b0 = pack2(bs + ca * LDB + col, bs + (ca + 1) * LDB + col);
        const uint32_t b1 = pack2(bs + (ca + 8) * LDB + col, bs + (ca + 9) * LDB + col);
        mma_bf16(acc[n], a0, a1, a2, a3, b0, b1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + mt * 16 + g + hh * 8;
      if (m >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + (nt0 + n) * 8 + q * 2 + e;
        if (r < R) part[((size_t)s * M + m) * R + r] = acc[n][hh * 2 + e];
      }
    }
}

// out[m, r] (rows ldo apart) = sum over s of part[s, m, r], in split order
__global__ void dx_reduce_kernel(const float* __restrict__ part, int M, int R, int S,
                                 float* __restrict__ out, int ldo) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * R) return;
  const int m = (int)(i / R), r = (int)(i - (size_t)m * R);
  float v = 0.0f;
  for (int s = 0; s < S; ++s) v += part[(size_t)s * M * R + i];
  out[(size_t)m * ldo + r] = v;
}

// d_headin[m, r] = sum over n of bf16(dmg[m, n]) * w_out[n, r]; grid
// (ceil(RH / 256), M), block 256; dmg (M, N) f32, w_out (N, RH) bf16
__global__ void heads_bwd_kernel(const float* __restrict__ dmg, const bf16* __restrict__ w_out,
                                 int N, int RH, float* __restrict__ out) {
  extern __shared__ float dm[];
  const int m = blockIdx.y, r = blockIdx.x * blockDim.x + threadIdx.x;
  for (int n = threadIdx.x; n < N; n += blockDim.x) dm[n] = rnd_bf16(dmg[(size_t)m * N + n]);
  __syncthreads();
  if (r >= RH) return;
  float acc = 0.0f;
  for (int n = 0; n < N; ++n) acc = fmaf(dm[n], __bfloat162float(w_out[(size_t)n * RH + r]), acc);
  out[(size_t)m * RH + r] = acc;
}

struct Lstm {
  float i, f, g, o, c, tc;
};

__device__ __forceinline__ Lstm lstm_recompute(const float* G, int H, int m, int j, float c_prev) {
  const float* row = G + (size_t)m * 4 * H;
  Lstm s;
  s.i = sigmoid_f(row[j]);
  s.f = sigmoid_f(row[H + j]);
  s.g = tanhf(row[2 * H + j]);
  s.o = sigmoid_f(row[3 * H + j]);
  s.c = s.f * c_prev + s.i * s.g;
  s.tc = tanhf(s.c);
  return s;
}

// The pull through one LSTM cell whose output h (times mask) has cotangent
// d_hd and whose cell state has cotangent *d_c: writes the gate cotangents
// (bf16) and replaces *d_c by that of the previous cell state.
__device__ __forceinline__ void lstm_pull(const Lstm& s, float d_hd, float mask, float c_prev,
                                          float* d_c, bf16* dg, int H, int m, int j) {
  const float dh = d_hd * mask;
  const float dc = *d_c + dh * s.o * (1.0f - s.tc * s.tc);
  bf16* row = dg + (size_t)m * 4 * H;
  row[j] = __float2bfloat16_rn(dc * s.g * s.i * (1.0f - s.i));
  row[H + j] = __float2bfloat16_rn(dc * c_prev * s.f * (1.0f - s.f));
  row[2 * H + j] = __float2bfloat16_rn(dc * s.i * (1.0f - s.g * s.g));
  row[3 * H + j] = __float2bfloat16_rn(dh * s.tc * s.o * (1.0f - s.o));
  *d_c = dc * s.f;
}

// Per (m, j): the decoder-LSTM pull of step t (its output's cotangent is the
// heads' pull plus the carried d_rnn_h) and the attention-LSTM recompute
// (h_att for the attention pull). Also writes bf16(rnn_h_d) for d_wout.
__global__ void lstm_mid_kernel(const float* __restrict__ G2, const float* __restrict__ c_rnn_prev,
                                const float* __restrict__ dm2, const float* __restrict__ d_headin,
                                int ldh, const float* __restrict__ d_rnn_h, int ldr,
                                float* __restrict__ d_rnn_c, const float* __restrict__ G1,
                                const float* __restrict__ c_att_prev,
                                const float* __restrict__ dm1, bf16* __restrict__ dg2,
                                bf16* __restrict__ head_h, float* __restrict__ h_att, int M,
                                int H) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * H) return;
  const int m = (int)(i / H), j = (int)(i - (size_t)m * H);
  const Lstm s2 = lstm_recompute(G2, H, m, j, c_rnn_prev[i]);
  head_h[i] = __float2bfloat16_rn(s2.o * s2.tc * dm2[i]);
  const float d_hd = d_headin[(size_t)m * ldh + j] + d_rnn_h[(size_t)m * ldr + j];
  lstm_pull(s2, d_hd, dm2[i], c_rnn_prev[i], &d_rnn_c[i], dg2, H, m, j);
  const Lstm s1 = lstm_recompute(G1, H, m, j, c_att_prev[i]);
  h_att[i] = s1.o * s1.tc * dm1[i];
}

// Per (m, j): the attention-LSTM pull; its output's cotangent is the carry
// from step t + 1 (d_att_h, rows lda apart), the decoder LSTM's input
// (dxh2[:, :H], rows ldx apart) and the query projection's (d_hq).
__global__ void lstm_att_bwd_kernel(const float* __restrict__ G1,
                                    const float* __restrict__ c_att_prev,
                                    const float* __restrict__ dm1,
                                    const float* __restrict__ d_att_h, int lda,
                                    const float* __restrict__ dxh2, int ldx,
                                    const float* __restrict__ d_hq, float* __restrict__ d_att_c,
                                    bf16* __restrict__ dg1, int M, int H) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * H) return;
  const int m = (int)(i / H), j = (int)(i - (size_t)m * H);
  const Lstm s1 = lstm_recompute(G1, H, m, j, c_att_prev[i]);
  const float d_hd = d_att_h[(size_t)m * lda + j] + dxh2[(size_t)m * ldx + j] + d_hq[i];
  lstm_pull(s1, d_hd, dm1[i], c_att_prev[i], &d_att_c[i], dg1, H, m, j);
}

// ---------------------------------------------------------------------------
// Attention recompute and pull for one step; grid B, block kAttThreads.
// Recomputes q, the folded location features, th = tanh(q + loc + att_enc)
// and the masked softmax w, then pulls the context's cotangent (the sum of
// three sources, also written to dctx_out for d_encoded) and the weights'
// cotangent (carried d_w and d_cum, the loss's d_align, the context's)
// through the softmax, the energies and tanh:
//   d_attenc[b] += de_pre, d_wv[b] += sum_l th * de,
//   d_wloc[b] += sum_l window * de_pre, dq = sum_l de_pre (-> dq_out),
//   d_hq = dq . wq, and the window's pull -> new d_w, d_cum.
// Dynamic shared memory (floats): wlt[2KA] hs[H] q[A] wvs[A] win[2 LW, to a
// multiple of 4] th[L A] wt[L] dws[L] dcs[D] pdq[NG A] pdwv[NG A] dqs[A],
// NG = blockDim / A; th starts 16-byte aligned for float4 reads. The conv
// and its pull are register-blocked 4 x 4 (16 independent FMAs per pair of
// shared loads), the global loads vectorized or unrolled to keep several in
// flight: one block owns a row, so the row's whole chain runs on one SM.
// ---------------------------------------------------------------------------
constexpr int kAttBwdThreads = 1024;

__global__ void __launch_bounds__(kAttBwdThreads) att_bwd_kernel(
    const float* __restrict__ h, const bf16* __restrict__ wq, const bf16* __restrict__ wloc,
    const bf16* __restrict__ wv, const float* __restrict__ att_enc, const bf16* __restrict__ enc,
    const int* __restrict__ lengths, const float* __restrict__ w_prev,
    const float* __restrict__ cum_prev, const float* __restrict__ dctx_a, int lda,
    const float* __restrict__ dctx_b, int ldb, const float* __restrict__ dctx_c, int ldc,
    const float* __restrict__ d_align, float* __restrict__ d_w, float* __restrict__ d_cum,
    float* __restrict__ dctx_out, float* __restrict__ d_attenc, float* __restrict__ d_wv,
    float* __restrict__ d_wloc, float* __restrict__ dq_out, float* __restrict__ d_hq, int L,
    int H, int A, int D, int K) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ float red[32];
  const int LW = L + K + 2, pad = K / 2, NG = blockDim.x / A;
  float* wlt = sm;
  float* hs = wlt + 2 * K * A;
  float* q = hs + H;
  float* wvs = q + A;
  float* win = wvs + A;
  float* th = win + ((2 * LW + 3) & ~3);
  float* wt = th + (size_t)L * A;
  float* dws = wt + L;
  float* dcs = dws + L;
  float* pdq = dcs + D;
  float* pdwv = pdq + NG * A;
  float* dqs = pdwv + NG * A;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int len = lengths[b];
  const size_t bl = (size_t)b * L;

  att_prologue(h, wq, wloc, wv, w_prev, cum_prev, b, L, H, A, K, wlt, hs, q, wvs, win);

  // th = tanh(q + folded location conv + att_enc), kept for the pull; a
  // thread owns 4 chars x 4 attention dims, summed in the forward's order
  const int AG = A / 4;
  for (int item = tid; item < AG * ((L + 3) / 4); item += blockDim.x) {
    const int a0 = (item % AG) * 4, l0 = (item / AG) * 4;
    float loc[4][4] = {};
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
      const size_t l = l0 + i;
      if (l < (size_t)L) {
        const float4 ae = *reinterpret_cast<const float4*>(att_enc + (bl + l) * A + a0);
        *reinterpret_cast<float4*>(th + l * A + a0) =
            make_float4(tanhf(q[a0] + loc[i][0] + ae.x), tanhf(q[a0 + 1] + loc[i][1] + ae.y),
                        tanhf(q[a0 + 2] + loc[i][2] + ae.z), tanhf(q[a0 + 3] + loc[i][3] + ae.w));
      }
    }
  }
  // the context's cotangent, three sources
  for (int d = tid; d < D; d += blockDim.x) {
    const float v = dctx_a[(size_t)b * lda + d] + dctx_b[(size_t)b * ldb + d] +
                    dctx_c[(size_t)b * ldc + d];
    dctx_out[(size_t)b * D + d] = v;
    dcs[d] = rnd_bf16(v);
  }
  __syncthreads();
  // energies (warp per char) and the context's pull into the weights
  for (int l = warp; l < L; l += nwarps) {
    float e = 0.0f, dc = 0.0f;
    for (int a = lane; a < A; a += 32) e = fmaf(rnd_bf16(th[(size_t)l * A + a]), wvs[a], e);
    const uint4* er = reinterpret_cast<const uint4*>(enc + (bl + l) * D);
    for (int d8 = lane; d8 < D / 8; d8 += 32) {
      float ev[8];
      unpack8(__ldg(er + d8), ev);
#pragma unroll
      for (int i = 0; i < 8; ++i) dc = fmaf(dcs[d8 * 8 + i], ev[i], dc);
    }
    e = warp_sum(e);
    dc = warp_sum(dc);
    if (lane == 0) {
      wt[l] = (l < len) ? e : -INFINITY;
      dws[l] = d_w[bl + l] + d_align[bl + l] + d_cum[bl + l] + dc;
    }
  }
  __syncthreads();
  // masked softmax, then its pull: de = w * (dws - sum(dws * w)) -> dws
  float mx = -INFINITY;
  for (int l = tid; l < L; l += blockDim.x) mx = fmaxf(mx, wt[l]);
  mx = block_reduce(mx, red, true);
  float se = 0.0f;
  for (int l = tid; l < L; l += blockDim.x) se += expf(wt[l] - mx);
  se = block_reduce(se, red, false);
  __syncthreads();
  float sd = 0.0f;
  for (int l = tid; l < L; l += blockDim.x) {
    const float w = expf(wt[l] - mx) / se;
    wt[l] = w;
    sd += dws[l] * w;
  }
  sd = block_reduce(sd, red, false);
  __syncthreads();
  for (int l = tid; l < L; l += blockDim.x) dws[l] = wt[l] * (dws[l] - sd);
  __syncthreads();
  // energies' and tanh's pull: de_pre replaces th
  {
    const int a = tid % A, lg = tid / A;
    float sq = 0.0f, sv = 0.0f;
    if (lg < NG) {
#pragma unroll 4
      for (int l = lg; l < L; l += NG) {
        const size_t i = (size_t)l * A + a;
        const float t = th[i], de = dws[l];
        const float dp = de * wvs[a] * (1.0f - t * t);
        sv = fmaf(t, de, sv);
        sq += dp;
        th[i] = dp;
        d_attenc[bl * A + i] += dp;
      }
      pdq[lg * A + a] = sq;
      pdwv[lg * A + a] = sv;
    }
  }
  __syncthreads();
  for (int a = tid; a < A; a += blockDim.x) {
    float sq = 0.0f, sv = 0.0f;
    for (int lg = 0; lg < NG; ++lg) {
      sq += pdq[lg * A + a];
      sv += pdwv[lg * A + a];
    }
    dqs[a] = sq;
    dq_out[(size_t)b * A + a] = sq;
    d_wv[(size_t)b * A + a] += sv;
  }
  __syncthreads();
  // folded location window: d_wloc[b, a, c, k] += sum_l win[c, l + k]
  // de_pre[l, a]; a thread owns 4 taps x 4 attention dims of one channel
  const int KG = (K + 3) / 4;
  for (int item = tid; item < AG * 2 * KG; item += blockDim.x) {
    const int a0 = (item % AG) * 4, ck = item / AG, c = ck / KG, k0 = (ck % KG) * 4;
    const float* wn = win + c * LW + k0;
    float s[4][4] = {};
    for (int l = 0; l < L; ++l) {
      const float4 d4 = *reinterpret_cast<const float4*>(th + (size_t)l * A + a0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = wn[l + i];
        s[i][0] = fmaf(xv, d4.x, s[i][0]);
        s[i][1] = fmaf(xv, d4.y, s[i][1]);
        s[i][2] = fmaf(xv, d4.z, s[i][2]);
        s[i][3] = fmaf(xv, d4.w, s[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k0 + i < K) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          d_wloc[(((size_t)b * A + a0 + j) * 2 + c) * K + k0 + i] += s[i][j];
      }
    }
  }
  // the window's pull: d_win[c, j] = sum over a, k of wloc[a, c, k]
  // de_pre[j - k + pad, a]; a warp owns 4 chars of one channel (each weight
  // read feeds 4 FMAs), its lanes the attention dims
  const int JG = (L + 3) / 4;
  for (int it = warp; it < 2 * JG; it += nwarps) {
    const int c = it / JG, j0 = (it - c * JG) * 4;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < K; ++k) {
      const float* wc = wlt + ((size_t)c * K + k) * A;
      for (int a = lane; a < A; a += 32) {
        const float wa = wc[a];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = j0 + i - k + pad;
          if (l >= 0 && l < L) s[i] = fmaf(wa, th[(size_t)l * A + a], s[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = warp_sum(s[i]);
      const int j = j0 + i;
      if (lane == 0 && j < L) {
        if (c == 0) d_w[bl + j] = v;
        else d_cum[bl + j] += v;
      }
    }
  }
  // the query's pull: four partial sums, unrolled, so 16 loads are in flight
  for (int k = tid; k < H; k += blockDim.x) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int a = 0; a < A; a += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] = fmaf(dqs[a + j], __bfloat162float(wq[(size_t)(a + j) * H + k]), s[j]);
    }
    d_hq[(size_t)b * H + k] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

// ---- launchers ----

inline unsigned blocks_for(size_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

int launch_gate_gemm(const void* xh, const void* W, const void* bias, int M, int R, int H, int mode,
                     void* out, const void* c_prev, const void* mask, void* c_out, void* h_out,
                     cudaStream_t stream) {
  if (R % 8 || H % GU || M <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid(H / GU, (M + GM - 1) / GM);
  gate_gemm_kernel<<<grid, kThreads, 0, stream>>>(
      (const bf16*)xh, (const bf16*)W, (const float*)bias, M, R, H, mode, (float*)out,
      (const float*)c_prev, (const float*)mask, (float*)c_out, (float*)h_out);
  return (int)cudaGetLastError();
}

int launch_gather(const void* x1, int ld1, int n1, const void* x2, int ld2, int n2,
                  const void* x3, int ld3, int n3, void* xh, int M, cudaStream_t stream) {
  const size_t n = (size_t)M * (n1 + n2 + n3);
  gather_kernel<<<blocks_for(n, 256), 256, 0, stream>>>(
      (const float*)x1, ld1, n1, (const float*)x2, ld2, n2, (const float*)x3, ld3, n3,
      (bf16*)xh, M);
  return (int)cudaGetLastError();
}

// two launches: the split partial products, then their sum into out
int launch_dx(const void* dg, const void* W, int M, int N, int R, int S, void* part, void* out,
              int ldo, cudaStream_t stream) {
  if (S <= 0 || N % (S * TKC) || R % 8) return (int)cudaErrorInvalidValue;
  dim3 grid((R + DXN - 1) / DXN, S, (M + GM - 1) / GM);
  dx_partial_kernel<<<grid, kThreads, 0, stream>>>((const bf16*)dg, (const bf16*)W, M, N, R, S,
                                                   (float*)part);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t n = (size_t)M * R;
  dx_reduce_kernel<<<blocks_for(n, 256), 256, 0, stream>>>((const float*)part, M, R, S,
                                                           (float*)out, ldo);
  return (int)cudaGetLastError();
}

size_t att_bwd_smem(int L, int H, int A, int D, int K) {
  const int NG = kAttBwdThreads / A;
  return (size_t)(2 * K * A + H + 2 * A + ((2 * (L + K + 2) + 3) & ~3) + (size_t)L * A +
                  2 * L + D + 2 * NG * A + A) * sizeof(float);
}

int launch_att_bwd(const void* h, const void* wq, const void* wloc, const void* wv,
                   const void* att_enc, const void* enc, const void* lengths, const void* w_prev,
                   const void* cum_prev, const void* dctx_a, int lda, const void* dctx_b, int ldb,
                   const void* dctx_c, int ldc, const void* d_align, void* d_w, void* d_cum,
                   void* dctx_out, void* d_attenc, void* d_wv, void* d_wloc, void* dq_out,
                   void* d_hq, int B, int L, int H, int A, int D, int K, cudaStream_t stream) {
  if (H % 8 || D % 8 || A % 4 || A > kAttBwdThreads || kAttBwdThreads % A || K % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = att_bwd_smem(L, H, A, D, K);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(att_bwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  att_bwd_kernel<<<B, kAttBwdThreads, smem, stream>>>(
      (const float*)h, (const bf16*)wq, (const bf16*)wloc, (const bf16*)wv, (const float*)att_enc,
      (const bf16*)enc, (const int*)lengths, (const float*)w_prev, (const float*)cum_prev,
      (const float*)dctx_a, lda, (const float*)dctx_b, ldb, (const float*)dctx_c, ldc,
      (const float*)d_align, (float*)d_w, (float*)d_cum, (float*)dctx_out, (float*)d_attenc,
      (float*)d_wv, (float*)d_wloc, (float*)dq_out, (float*)d_hq, L, H, A, D, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One gate GEMM with the LSTM epilogue: xh (M, R) bf16, W (4H, R) bf16,
// bias (4H) f32, c_prev and mask (M, H) f32 -> c_out, h_out (M, H) f32.
int t2_gate_lstm(const void* xh, const void* W, const void* bias, const void* c_prev,
                 const void* mask, void* c_out, void* h_out, int M, int R, int H, void* stream) {
  return launch_gate_gemm(xh, W, bias, M, R, H, 1, nullptr, c_prev, mask, c_out, h_out,
                          (cudaStream_t)stream);
}

// K3: T teacher-forced steps, six launches each. Pointer slots:
//   p[0..8]   w1 b1 w2 b2 wq w_loc wv w_out b_out
//   p[9..14]  decoder_in (T, B, P) f32, encoded (B, L, D) bf16, att_enc
//             (B, L, A) f32, lengths (B) int32, dm1 dm2 (T, B, H) f32
//   p[15..21] out: mel_gate (T, B, N), xh1 (T, B, R1) bf16, xh2 (T, B, R2)
//             bf16, c_att c_rnn (T + 1, B, H), al cum (T + 1, B, L); slot 0
//             of the four stacks zero
//   p[22..24] state, zero at entry: att_h (B, H), ctx (B, D), rnn_h (B, H)
// d = {T, B, P, H, D, L, A, K, N}; R1 = P + D + H, R2 = 2H + D.
int t2_teacher_forward(void** p, const int* d, void* stream_) {
  const int T = d[0], B = d[1], P = d[2], H = d[3], D = d[4], L = d[5], A = d[6], K = d[7],
            N = d[8];
  const int R1 = P + D + H, R2 = 2 * H + D;
  const size_t BH = (size_t)B * H, BL = (size_t)B * L;
  cudaStream_t stream = (cudaStream_t)stream_;
  const float* din = (const float*)p[9];
  const float* dm1 = (const float*)p[13];
  const float* dm2 = (const float*)p[14];
  float* mg = (float*)p[15];
  bf16* xh1 = (bf16*)p[16];
  bf16* xh2 = (bf16*)p[17];
  float* c_att = (float*)p[18];
  float* c_rnn = (float*)p[19];
  float* al = (float*)p[20];
  float* cum = (float*)p[21];
  void *att_h = p[22], *ctx = p[23], *rnn_h = p[24];
  for (int t = 0; t < T; ++t) {
    bf16* x1 = xh1 + (size_t)t * B * R1;
    bf16* x2 = xh2 + (size_t)t * B * R2;
    int err = launch_gather(din + (size_t)t * B * P, P, P, ctx, D, D, att_h, H, H, x1, B, stream);
    if (!err)
      err = launch_gate_gemm(x1, p[0], p[1], B, R1, H, 1, nullptr, c_att + t * BH, dm1 + t * BH,
                             c_att + (t + 1) * BH, att_h, stream);
    if (!err)
      err = launch_location_attention(att_h, p[4], p[5], p[6], p[11], p[10], p[12], al + t * BL,
                                      cum + t * BL, ctx, al + (t + 1) * BL, cum + (t + 1) * BL, B,
                                      L, H, A, D, K, stream);
    if (!err) err = launch_gather(att_h, H, H, ctx, D, D, rnn_h, H, H, x2, B, stream);
    if (!err)
      err = launch_gate_gemm(x2, p[2], p[3], B, R2, H, 1, nullptr, c_rnn + t * BH, dm2 + t * BH,
                             c_rnn + (t + 1) * BH, rnn_h, stream);
    if (!err) err = launch_heads(p[7], p[8], rnn_h, H, ctx, D, mg + (size_t)t * B * N, B, N, stream);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

// K4: the reverse pass, 2 + 8 T launches. Pointer slots:
//   p[0..7]   w1 b1 w2 b2 wq w_loc wv w_out
//   p[8..14]  encoded, att_enc, lengths, dm1, dm2, d_mel_gate (T, B, N) f32,
//             d_align (T, B, L) f32
//   p[15..20] K3's residuals: xh1 xh2 c_att c_rnn al cum
//   p[21..29] out: dg1 dg2 (T, B, 4H) bf16, dxh1 (T + 1, B, R1) f32 (slot T
//             zero), dctx (T, B, D), dq (T, B, A), head_h (T, B, H) bf16,
//             d_attenc (B, L, A), d_wv (B, A), d_wloc (B, A, 2, K), the last
//             three zero at entry
//   p[30..40] scratch: G1 G2 (T, B, 4H) f32, d_headin (B, H + D), dxh2
//             (B, R2) zero, h_att (B, H), d_hq (B, H), d_att_c d_rnn_c (B, H)
//             zero, d_w d_cum (B, L) zero, part (S, B, max(R1, R2)) f32
// d = {T, B, P, H, D, L, A, K, N, S}.
int t2_teacher_backward(void** p, const int* d, void* stream_) {
  const int T = d[0], B = d[1], P = d[2], H = d[3], D = d[4], L = d[5], A = d[6], K = d[7],
            N = d[8], S = d[9];
  const int R1 = P + D + H, R2 = 2 * H + D, H4 = 4 * H, RH = H + D;
  const size_t BH = (size_t)B * H, BL = (size_t)B * L, BG = (size_t)B * H4;
  cudaStream_t stream = (cudaStream_t)stream_;
  const float* dm1 = (const float*)p[11];
  const float* dm2 = (const float*)p[12];
  const float* dmg = (const float*)p[13];
  const float* dal = (const float*)p[14];
  const float* c_att = (const float*)p[17];
  const float* c_rnn = (const float*)p[18];
  const float* al = (const float*)p[19];
  const float* cum = (const float*)p[20];
  bf16* dg1 = (bf16*)p[21];
  bf16* dg2 = (bf16*)p[22];
  float* dxh1 = (float*)p[23];
  float* dctx = (float*)p[24];
  float* dq = (float*)p[25];
  bf16* head_h = (bf16*)p[26];
  float* G1 = (float*)p[30];
  float* G2 = (float*)p[31];
  float* d_headin = (float*)p[32];
  float* dxh2 = (float*)p[33];
  int err = launch_gate_gemm(p[15], p[0], p[1], T * B, R1, H, 0, G1, nullptr, nullptr, nullptr,
                             nullptr, stream);
  if (!err)
    err = launch_gate_gemm(p[16], p[2], p[3], T * B, R2, H, 0, G2, nullptr, nullptr, nullptr,
                           nullptr, stream);
  if (err) return err;
  for (int t = T - 1; t >= 0; --t) {
    const float* dx1_next = dxh1 + (size_t)(t + 1) * B * R1;  // step t + 1's dxh1
    dim3 hgrid((RH + 255) / 256, B);
    heads_bwd_kernel<<<hgrid, 256, N * sizeof(float), stream>>>(dmg + (size_t)t * B * N,
                                                                (const bf16*)p[7], N, RH,
                                                                d_headin);
    err = (int)cudaGetLastError();
    if (!err) {
      lstm_mid_kernel<<<blocks_for(BH, 256), 256, 0, stream>>>(
          G2 + t * BG, c_rnn + t * BH, dm2 + t * BH, d_headin, RH, dxh2 + H + D, R2,
          (float*)p[37], G1 + t * BG, c_att + t * BH, dm1 + t * BH, dg2 + t * BG,
          head_h + t * BH, (float*)p[34], B, H);
      err = (int)cudaGetLastError();
    }
    if (!err) err = launch_dx(dg2 + t * BG, p[2], B, H4, R2, S, p[40], dxh2, R2, stream);
    if (!err)
      err = launch_att_bwd(p[34], p[4], p[5], p[6], p[9], p[8], p[10], al + t * BL, cum + t * BL,
                           dx1_next + P, R1, d_headin + H, RH, dxh2 + H, R2, dal + t * BL, p[38],
                           p[39], dctx + (size_t)t * B * D, p[27], p[28], p[29],
                           dq + (size_t)t * B * A, p[35], B, L, H, A, D, K, stream);
    if (!err) {
      lstm_att_bwd_kernel<<<blocks_for(BH, 256), 256, 0, stream>>>(
          G1 + t * BG, c_att + t * BH, dm1 + t * BH, dx1_next + P + D, R1, dxh2, R2,
          (const float*)p[35], (float*)p[36], dg1 + t * BG, B, H);
      err = (int)cudaGetLastError();
    }
    if (!err)
      err = launch_dx(dg1 + t * BG, p[0], B, H4, R1, S, p[40], dxh1 + (size_t)t * B * R1, R1,
                      stream);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
