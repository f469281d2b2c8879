// Kernels K3 and K4: the teacher-forced decode of training, forward and
// backward, for sm_90a (thread-block clusters, TMA, mbarriers).
//
// K3 replaces tacotron2_tpu/ops/train_decode_pallas.py::_teacher_step_kernel
// and K4 its _teacher_bwd_kernel. The TPU kernels keep the packed LSTM
// weights (35.7 MB bf16 at the flagship dims) in VMEM for all T steps; an
// H100 SM has 227 KB of shared memory, so here every step streams them
// through the whole card, as K1 does, but at batch 32 the gate products are
// real (skinny) GEMMs and run on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 sums).
//
//   t2_teacher_forward   K3: all T steps from one host call, 2 + 3 T
//                        launches: the prenet slice of every step's xh1,
//                        the zero initial state and the gate GEMM's tiled
//                        copies of the two LSTM weights once, then a step is
//                        gate GEMM + LSTM epilogue x dm1 -> location
//                        attention over a cluster of S blocks per batch row
//                        -> gate GEMM + epilogue x dm2, and after the loop
//                        the mel + gate heads of every step as one GEMM
//                        (nothing in the loop reads them). Each producer
//                        writes its bf16 copy straight into the residual
//                        stacks xh1/xh2 (the epilogues h, the attention
//                        ctx), so no gather runs; the cell states,
//                        attention weights and cumulative weights are
//                        stacks with T + 1 slots (slot 0 zero) that the
//                        step reads at t and writes at t + 1.
//   t2_teacher_backward  K4: the gate pre-activations and the query
//                        projection of all T steps as three large GEMMs and
//                        the heads' pull of all T steps (none depends on
//                        another step), then t = T-1 .. 0 with four launches
//                        a step: decoder-LSTM pull -> dxh2 = dg2 . W2 ->
//                        attention recompute and pull over a cluster of S
//                        blocks per batch row, ending in the attention-LSTM
//                        pull of each rank's H/S columns -> dxh1 = dg1 . W1.
//                        Sums over steps of the small weights' gradients
//                        (d_attenc, d_wv, the folded location window) are
//                        read-modify-written per batch row by the cluster
//                        that owns the row; d_wq, d_wout and dW1/dW2 are
//                        formed after the loop from stacks (dq, head_h, dg).
//
// Bound: per forward step and per backward step, the bf16 LSTM weights
// (35.7 MB) over the HBM rate: 10.7 us; the operations (2 x 32 x 4352 x 4096
// = 1.14 GFLOP per step, twice in the backward) take 1.2 us at the bf16
// tensor-core peak, so the products are bound by the weight stream, and the
// attention by latency: one batch row's chain of dependent reductions.
// What the design does about each:
// - The forward gate GEMM (gate_tma_kernel) puts the 4H weight rows on the
//   M side of the product and the batch on N: a block owns 8 hidden units x
//   4 gates (32 weight rows), so the LSTM epilogue is fused and the gates
//   never reach device memory; 128 blocks cover the card at H = 1024. The
//   weights are read from a copy tiled once per call (tile_piece): each
//   block's 32 rows as 64-column tiles in TMA's 128-byte swizzle, laid end
//   to end, so a block streams one contiguous run, not 128-byte pieces of
//   32 rows 3.5-5 KB apart. One producer warp streams them with 1-D bulk
//   copies (four chunks a stage: fewer barrier round trips), and xh
//   with TMA boxes (each element of xh read once per block), into a ring of
//   3 stages of 4 chunks (32 KB) under mbarriers, ~96 KB per SM in flight;
//   four consumer warps each take 16 of a chunk's 64 columns and their
//   partial sums meet in shared memory in a fixed order.
// - The attention (forward and backward) runs on a cluster of S blocks per
//   batch row, S the largest power of two up to 8 with B S <= the SM count
//   (S = 4 at B = 32: 128 SMs work, not 32). Rank r owns chars
//   [r ceil(L/S), ...) and A/S of the query projection (read from the
//   other ranks through distributed shared memory). The softmax's max, its
//   sum and the backward's sum(dws w) are per-rank partials combined in rank
//   order; the context, dq, d_wv and d_wloc are per-rank partials reduced in
//   rank order, each rank reducing its share. The location window's pull
//   reads the K/2 chars of de_pre on each side from the neighbouring ranks.
//   Every sum has a fixed order: the kernels are deterministic without
//   atomics.
// - The backward's dx GEMMs split the 4H contraction over a cluster of 8
//   blocks whose partial tiles are summed through distributed shared memory
//   in split order, one launch each.
// - Between a step's launches: each launch may start while the previous
//   one ends (programmatic dependent launch, pdl_wait), and the GEMMs
//   stream their first weight tiles meanwhile; the weight streams are
//   marked evict-first in L2 (evict_first_policy).
// - What does not feed back runs outside the step loops, one launch over
//   all T B rows each: K3's heads and K4's gate recompute and query
//   projection (gemm_tn_kernel, compute-bound at those sizes), K4's heads'
//   pull (heads_pull_kernel). K4's query projection reads the forward's
//   bf16 att_h from xh2, where the plain version (as the JAX kernel)
//   rebuilds att_h from the recomputed gates: the same values up to the
//   order of the gates' sums, so a one-ulp flip of the rebuilt att_h is the
//   only difference.
//
// The controls rows (a controllable model; the TPU kernels' xh[:, H + D:H +
// D + E] and w_out[H + D:]): K3 writes the controls' bf16 operand, zero
// past the model's C columns up to E = round16(C), into every step's xh2 =
// [att_h | ctx | controls | rnn_h] once, in its first launch; the decoder
// cell's gate GEMM then reads R2 = 2H + D + E columns (a partial last
// 64-column tile, zero past R2 in both operands) and the heads K = H + D + E
// (xh2 from ctx on). K4 reads the same stacks, pulls the heads over H + D +
// E, reads d_rnn_h past the controls, and its attention launch (rank 0 of
// each row) adds the step's controls cotangent, the heads' plus the decoder
// LSTM's dx, to d_ctrl. No launch is added; E = 0 is the vanilla model.
//
// Every entry point launches on the given stream, allocates nothing and
// returns the launch's CUDA error (cudaErrorInvalidValue for dimensions it
// does not take; the cluster launch's own error when the card refuses a
// cluster size or its shared memory).

#include "decode_common.cuh"
#include "tma.cuh"

namespace {

constexpr int GM = 32;         // dx GEMM: batch rows per block
constexpr int TKC = 64;        // contraction chunk
constexpr int LDS = TKC + 8;   // padded shared row (bf16), 144 bytes
constexpr int kThreads = 128;  // 4 warps
constexpr int DXN = 64;        // dx GEMM: output columns per block
constexpr int kDxStages = 3;   // cp.async ring depth of the dx GEMM

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
// then nothing is read); a group per k-chunk keeps the ring's depth in flight
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

// An L2 policy that evicts first what it marks: the LSTM weights that K3's
// gate GEMMs and K4's dx GEMMs stream every step. At 35.7 MB they do not
// stay in the 50 MB L2 beside the step's other data anyway, and unmarked
// they push out the attention's working set (encoded, att_enc, d_attenc).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// cp_async16 with an L2 policy
__device__ __forceinline__ void cp_async16_hint(void* smem, const void* gmem, bool valid,
                                                uint64_t policy) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0), "l"(policy));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8 (mma's fragment layout)
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// ---------------------------------------------------------------------------
// The products over all T B rows at once: out[m, n] = x[m, :K] . W[n, :K]
// (+ bias[n] where given), x[m] = [X[m, :K1] | X2[m, :K - K1]] (bf16, rows
// ldx / ld2 apart; X2 unused where K1 == K), W (N, K) bf16, K % 8 == K1 % 8
// == ldx % 8 == ld2 % 8 == 0, out (M, N) f32. K4's gate recompute (W an
// LSTM's, N = 4H) and query projection of every step (W = wq), K3's heads
// after its loop (x = [rnn_h | ctx | controls], W = w_out). Compute-bound at these
// sizes (M = T B rows): 128 x 128 tiles, 8 warps of 64 x 32 fed by ldmatrix
// from a 4-stage cp.async ring of 32-deep slices (rows padded to 80 bytes:
// conflict-free); grid (ceil(N / 128), ceil(M / 128)).
// ---------------------------------------------------------------------------
constexpr int RB = 128, RBK = 32, RST = 4, RLD = RBK + 8, RTHREADS = 256;
constexpr size_t RSMEM = (size_t)RST * 2 * RB * RLD * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(RTHREADS, 2)
gemm_tn_kernel(const bf16* __restrict__ X, int ldx, int K1, const bf16* __restrict__ X2, int ld2,
               const bf16* __restrict__ W, const float* __restrict__ bias, int M, int N, int K,
               float* __restrict__ out) {
  extern __shared__ uint4 rg_u4[];
  bf16* As = reinterpret_cast<bf16*>(rg_u4);
  bf16* Bs = As + RST * RB * RLD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps of 64 rows x 32 columns
  const int m0 = blockIdx.y * RB, n0 = blockIdx.x * RB;
  const int nk = (K + RBK - 1) / RBK;
  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;
  // slice kt into ring slot kt % RST: 128 rows of X and of W, 32 k each
  auto issue = [&](int kt) {
    if (kt < nk) {
      const int st = kt % RST;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int i = tid + s * RTHREADS, r = i >> 2, c = (i & 3) * 8, k = kt * RBK + c;
        const bool va = m0 + r < M && k < K, vb = n0 + r < N && k < K;
        const bf16* xa = !va ? X : k < K1 ? X + (size_t)(m0 + r) * ldx + k
                                          : X2 + (size_t)(m0 + r) * ld2 + (k - K1);
        cp_async16(As + (st * RB + r) * RLD + c, xa, va);
        cp_async16(Bs + (st * RB + r) * RLD + c, W + (vb ? (size_t)(n0 + r) * K + k : 0), vb);
      }
    }
    cp_async_commit();  // empty past the end: the wait count stays uniform
  };
  for (int kt = 0; kt < RST - 1; ++kt) issue(kt);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<RST - 2>();
    __syncthreads();  // slice kt landed for all; slot (kt - 1) % RST is free
    issue(kt + RST - 1);
    const bf16* as = As + (kt % RST) * RB * RLD;
    const bf16* bs = Bs + (kt % RST) * RB * RLD;
#pragma unroll
    for (int ks = 0; ks < RBK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                as + (wm * 64 + mt * 16 + (lane & 15)) * RLD + ks + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)  // n-tiles 2 np and 2 np + 1
        ldsm_x4(b[2 * np][0], b[2 * np][1], b[2 * np + 1][0], b[2 * np + 1][1],
                bs + (wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * RLD + ks +
                    ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[nt][0], b[nt][1]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + q * 2;
      if (col >= N) continue;
      const float b0 = bias ? bias[col] : 0.0f, b1 = bias && col + 1 < N ? bias[col + 1] : 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 64 + mt * 16 + g + hh * 8;
        if (row >= M) continue;
        float* o = out + (size_t)row * N + col;
        if (N % 2 == 0) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[mt][nt][hh * 2] + b0, acc[mt][nt][hh * 2 + 1] + b1);
        } else {  // rows of odd length: not 8-byte aligned
          o[0] = acc[mt][nt][hh * 2] + b0;
          if (col + 1 < N) o[1] = acc[mt][nt][hh * 2 + 1] + b1;
        }
      }
    }
}

// ---------------------------------------------------------------------------
// dx GEMM: out[m, r] (rows ldo apart) = sum over n of dg[m, n] * W[n, r].
// dg (M, N) bf16, W (N, R) bf16, N % (S * TKC) == 0, R % 8 == 0. grid
// (ceil(R / DXN), S, ceil(M / GM)), a cluster of the S blocks of one output
// tile, each summing its N / S of the contraction; the partial tiles meet
// in distributed shared memory, where rank s sums rows [s GM / S, ...) over
// the ranks in split order. Warp w owns rows (w & 1) * 16 and columns
// (w >> 1) * 32 of the 32 x 64 tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
dx_cluster_kernel(const bf16* __restrict__ dg, const bf16* __restrict__ W, int M, int N, int R,
                  float* __restrict__ out, int ldo) {
  constexpr int LDB = DXN + 8, LDT = DXN + 1;
  static_assert(sizeof(float) * GM * LDT <= sizeof(bf16) * kDxStages * GM * LDS,
                "the partial tile reuses the A ring");
  __shared__ __align__(16) bf16 As[kDxStages][GM * LDS];
  __shared__ __align__(16) bf16 Bs[kDxStages][TKC * LDB];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int S = gridDim.y, r0 = blockIdx.x * DXN, s = blockIdx.y, m0 = blockIdx.z * GM;
  const int KS = N / S, kbeg = s * KS, nk = KS / TKC;
  const int mt = warp & 1, nt0 = (warp >> 1) * 4;

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  // k-chunk kt of this split into ring slot kt % kDxStages: W 64 k rows x
  // 64 columns, then dg 32 rows x 64 k and the chunk's commit (the first
  // chunks' W goes ahead of the wait for the previous kernel)
  const uint64_t w_policy = evict_first_policy();
  auto issue_w = [&](int kt) {
    if (kt < nk) {
      const int st = kt % kDxStages, k0 = kbeg + kt * TKC;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = tid + t * kThreads, kr = i >> 3, c = r0 + (i & 7) * 8;
        cp_async16_hint(Bs[st] + kr * LDB + (i & 7) * 8,
                        W + (c < R ? (size_t)(k0 + kr) * R + c : 0), c < R, w_policy);
      }
    }
  };
  auto issue_dg = [&](int kt) {
    if (kt < nk) {
      const int st = kt % kDxStages, k0 = kbeg + kt * TKC;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = tid + t * kThreads, r = i >> 3, c = (i & 7) * 8, m = m0 + r;
        cp_async16(As[st] + r * LDS + c, dg + (m < M ? (size_t)m * N + k0 + c : 0), m < M);
      }
    }
    cp_async_commit();  // empty past the end: the wait count stays uniform
  };
  for (int kt = 0; kt < kDxStages - 1; ++kt) issue_w(kt);
  pdl_wait();
  for (int kt = 0; kt < kDxStages - 1; ++kt) issue_dg(kt);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kDxStages - 2>();
    __syncthreads();
    issue_w(kt + kDxStages - 1);
    issue_dg(kt + kDxStages - 1);
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
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: its A part holds the partial tile
  float* tile = reinterpret_cast<float*>(&As[0][0]);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tile[(mt * 16 + g + hh * 8) * LDT + (nt0 + n) * 8 + q * 2 + e] = acc[n][hh * 2 + e];
  cluster.sync();
  const int rows = GM / S;
  for (int i = tid; i < rows * DXN; i += kThreads) {
    const int rr = s * rows + i / DXN, cc = i % DXN, m = m0 + rr, c = r0 + cc;
    if (m < M && c < R) {
      float v = 0.0f;
      for (int p = 0; p < S; ++p) v += *cluster.map_shared_rank(tile + rr * LDT + cc, p);
      out[(size_t)m * ldo + c] = v;
    }
  }
  cluster.sync();  // no rank leaves while another still reads its tile
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

// The heads' pull of every step before K4's loop (nothing in it feeds
// back): d_headin[m, r] = sum over n of bf16(dmg[m, n]) * w_out[n, r] (n
// in order); grid (M, ceil(RH / 256)), block 256, N floats of shared
// memory; dmg (M, N) f32, w_out (N, RH) bf16, out (M, RH).
__global__ void heads_pull_kernel(const float* __restrict__ dmg, const bf16* __restrict__ w_out,
                                  int N, int RH, float* __restrict__ out) {
  extern __shared__ float dm[];
  const int m = blockIdx.x, r = blockIdx.y * blockDim.x + threadIdx.x;
  for (int n = threadIdx.x; n < N; n += blockDim.x) dm[n] = rnd_bf16(dmg[(size_t)m * N + n]);
  __syncthreads();
  if (r >= RH) return;
  float acc = 0.0f;
  for (int n = 0; n < N; ++n) acc = fmaf(dm[n], __bfloat162float(w_out[(size_t)n * RH + r]), acc);
  out[(size_t)m * RH + r] = acc;
}

// Per (m, j): the decoder-LSTM pull of step t (its output's cotangent is the
// heads' pull, rows ldh apart, plus the carried d_rnn_h, rows ldr apart).
// Also writes bf16(rnn_h_d) for d_wout.
__global__ void lstm_mid_kernel(const float* __restrict__ G2, const float* __restrict__ c_rnn_prev,
                                const float* __restrict__ dm2, const float* __restrict__ d_headin,
                                int ldh, const float* __restrict__ d_rnn_h, int ldr,
                                float* __restrict__ d_rnn_c, bf16* __restrict__ dg2,
                                bf16* __restrict__ head_h, int M, int H) {
  pdl_wait();
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * H) return;
  const int m = (int)(i / H), j = (int)(i - (size_t)m * H);
  const Lstm s2 = lstm_recompute(G2, H, m, j, c_rnn_prev[i]);
  head_h[i] = __float2bfloat16_rn(s2.o * s2.tc * dm2[i]);
  const float d_hd = d_headin[(size_t)m * ldh + j] + d_rnn_h[(size_t)m * ldr + j];
  lstm_pull(s2, d_hd, dm2[i], c_rnn_prev[i], &d_rnn_c[i], dg2, H, m, j);
}

// The attention-LSTM pull's operands at one step, rows of the batch:
// its output's cotangent is the carry from step t + 1 (d_h_next, rows
// ld_next apart), the decoder LSTM's input's (d_x2 = dxh2[:, :H], rows ld_x2
// apart) and the query projection's (summed in that order).
struct AttLstmPull {
  const float* G1;      // (B, 4H) gate pre-activations
  const float* c_prev;  // (B, H)
  const float* mask;    // (B, H) LSTM dropout scale
  const float* d_h_next;
  int ld_next;
  const float* d_x2;
  int ld_x2;
  float* d_c;  // (B, H) the cell state's cotangent, replaced by the previous one's
  bf16* dg;    // (B, 4H) out: the gate cotangents
};

// ---------------------------------------------------------------------------
// K3's gate GEMM with the LSTM epilogue, TMA-fed.
// ---------------------------------------------------------------------------
constexpr int TG_U = 8;                        // hidden units per block
constexpr int TG_ROWS = 4 * TG_U;              // its weight rows: 4 gates x TG_U units
constexpr int TG_M = 32;                       // batch rows per block
constexpr int TG_WBYTES = TG_ROWS * 128;       // a 64-column chunk of the weight rows (one tile)
constexpr int TG_XBYTES = TG_M * 128;          // and of xh
constexpr int TG_CHUNK = TG_WBYTES + TG_XBYTES;
constexpr int TG_KSUB = 4;                     // chunks a stage
constexpr int TG_STAGE = TG_KSUB * TG_CHUNK;
constexpr int TG_STAGES = 3;                   // ring depth: 96 KB in flight
constexpr int TG_CONSUMERS = 4;                // warps 0..3 multiply; warp 4 issues the copies
constexpr int TG_THREADS = 32 * (TG_CONSUMERS + 1);
constexpr int TG_GLD = TG_M + 1;
constexpr size_t TG_SMEM = 1024 + (size_t)TG_STAGES * TG_STAGE + 2 * TG_STAGES * sizeof(uint64_t) +
                           (size_t)TG_CONSUMERS * TG_ROWS * TG_GLD * sizeof(float);

// The gate GEMM's copy of an LSTM weight W (4H, R): the tiles that block
// j0 / TG_U reads, in its order, each tile the block's TG_ROWS rows (row
// gate TG_U + u is W's row gate H + j0 + u) x 64 columns (zero past R) in
// TMA's 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)),
// so a block streams one contiguous run with 1-D bulk copies and reads it
// back with ld_sw. Tile kt of block bx starts at byte (bx nk + kt) 4096,
// nk = ceil(R / 64); the copy holds 4H x 64 nk bf16. Piece i (16 bytes)
// of the copy from W:
__device__ __forceinline__ void tile_piece(const bf16* __restrict__ W, uint8_t* __restrict__ wt,
                                           int H, int R, size_t i) {
  const int nk = (R + 63) / 64, c8 = (int)(i & 7);
  const size_t rest = i >> 3, tile = rest / TG_ROWS;
  const int r = (int)(rest - tile * TG_ROWS), kt = (int)(tile % nk), bx = (int)(tile / nk);
  const int col = kt * 64 + c8 * 8, wrow = (r / TG_U) * H + bx * TG_U + r % TG_U;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (col < R) v = *reinterpret_cast<const uint4*>(W + (size_t)wrow * R + col);
  *reinterpret_cast<uint4*>(wt + tile * TG_WBYTES + r * 128 + ((c8 ^ (r & 7)) << 4)) = v;
}

__host__ __device__ inline size_t tile_pieces(int H, int R) {
  return (size_t)4 * H * ((R + 63) / 64) * 8;
}

// K3's first launch: xh1[t, m, :P] = bf16(decoder_in[t, m, :]) for every
// step, the zero initial state in the stacks (xh1[0, :, P:] = ctx, att_h;
// xh2[0, :, H + D + E:] = rnn_h), the controls' operand ctl (M, E) bf16
// (zero past the model's C) in the controls columns xh2[t, :, H + D:H + D +
// E] of every step (nothing else writes them; E = 0 without controls), and
// the gate GEMM's tiled copies wt1, wt2 of W1 (4H, R1) and W2 (4H, R2).
// Grid-stride over all six parts.
__global__ void stage_kernel(const float* __restrict__ din, int T, int M, int P, int H, int D,
                             int E, const bf16* __restrict__ ctl, bf16* __restrict__ xh1,
                             bf16* __restrict__ xh2, const bf16* __restrict__ W1,
                             uint8_t* __restrict__ wt1, const bf16* __restrict__ W2,
                             uint8_t* __restrict__ wt2) {
  const int R1 = P + D + H, R2 = 2 * H + D + E;
  const size_t n1 = (size_t)T * M * P, n2 = n1 + (size_t)M * (D + H), n3 = n2 + (size_t)M * H;
  const size_t nc = n3 + (size_t)T * M * E;
  const size_t n4 = nc + tile_pieces(H, R1), n5 = n4 + tile_pieces(H, R2);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n5;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < n1) {
      const size_t row = i / P;
      xh1[row * R1 + (i - row * P)] = __float2bfloat16_rn(din[i]);
    } else if (i < n2) {
      const size_t j = i - n1, m = j / (D + H);
      xh1[m * R1 + P + (j - m * (D + H))] = __float2bfloat16_rn(0.0f);
    } else if (i < n3) {
      const size_t j = i - n2, m = j / H;
      xh2[m * R2 + H + D + E + (j - m * H)] = __float2bfloat16_rn(0.0f);
    } else if (i < nc) {
      const size_t j = i - n3, row = j / E, e = j - row * E;  // row = t M + m
      xh2[row * R2 + H + D + e] = ctl[(row % M) * E + e];
    } else if (i < n4) {
      tile_piece(W1, wt1, H, R1, i - nc);
    } else {
      tile_piece(W2, wt2, H, R2, i - n4);
    }
  }
}

// 32 bits at (row, col) of a tile with 128-byte rows (64 bf16) as TMA's
// 128-byte swizzle lays it out: the 16-byte chunk index XOR row % 8
__device__ __forceinline__ uint32_t ld_sw(const uint8_t* tile, int row, int col) {
  return *reinterpret_cast<const uint32_t*>(tile + row * 128 + (((col >> 3) ^ (row & 7)) << 4) +
                                            ((col & 7) << 1));
}

// grid (H / TG_U, ceil(M / TG_M)), block TG_THREADS, TG_SMEM bytes. wt: the
// tiled copy of W (4H, R) (tile_piece); x_map: the xh rows, boxes 64 x TG_M,
// the product's rows starting at x_row0 (rows past M are read and ignored,
// rows past the map are zero). The epilogue writes c_out, and h x mask as
// f32 into h_out and as bf16 into hx0 / hx1 (rows ld0 / ld1 apart), where
// given.
__global__ void __launch_bounds__(TG_THREADS)
gate_tma_kernel(const uint8_t* __restrict__ wt, const __grid_constant__ CUtensorMap x_map,
                int x_row0, const float* __restrict__ bias, int M, int R, int H,
                const float* __restrict__ c_prev, const float* __restrict__ mask,
                float* __restrict__ c_out, float* __restrict__ h_out, bf16* __restrict__ hx0,
                int ld0, bf16* __restrict__ hx1, int ld1) {
  extern __shared__ uint8_t tg_raw[];
  // 128-byte swizzle: every box starts on a 1024-byte boundary
  uint8_t* ring = reinterpret_cast<uint8_t*>(((uintptr_t)tg_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + TG_STAGES * TG_STAGE);
  uint64_t* empty = full + TG_STAGES;
  float* G = reinterpret_cast<float*>(empty + TG_STAGES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * TG_U, m0 = blockIdx.y * TG_M;
  const int nk = (R + 63) / 64, ns = (nk + TG_KSUB - 1) / TG_KSUB;
  if (tid == 0) {
    for (int s = 0; s < TG_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, TG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == TG_CONSUMERS) {
    // producer: chunks [TG_KSUB it, ...) into stage it % TG_STAGES once its
    // last use is done; a chunk is the block's weight tile (one bulk copy of
    // its contiguous run) and a box of xh. The first stages' weight tiles go
    // ahead of the wait for the previous kernel.
    if (lane == 0) {
      const uint8_t* wb = wt + (size_t)blockIdx.x * nk * TG_WBYTES;
      const uint64_t w_policy = evict_first_policy();
      auto load_w = [&](int it) {
        const int s = it % TG_STAGES, k0 = it * TG_KSUB, kn = min(TG_KSUB, nk - k0);
        uint8_t* st = ring + s * TG_STAGE;
        mbar_expect_tx(full + s, kn * TG_CHUNK);  // the stage's xh boxes included
        for (int q = 0; q < kn; ++q)
          bulk_load(st + q * TG_CHUNK, wb + (size_t)(k0 + q) * TG_WBYTES, TG_WBYTES, full + s,
                    w_policy);
      };
      for (int it = 0; it < ns && it < TG_STAGES; ++it) load_w(it);
      pdl_wait();
      for (int it = 0; it < ns; ++it) {
        const int s = it % TG_STAGES, k0 = it * TG_KSUB, kn = min(TG_KSUB, nk - k0);
        if (it >= TG_STAGES) {
          mbar_wait(empty + s, ((it / TG_STAGES) & 1) ^ 1);
          load_w(it);
        }
        uint8_t* st = ring + s * TG_STAGE;
        for (int q = 0; q < kn; ++q)
          tma_load_2d(st + q * TG_CHUNK + TG_WBYTES, &x_map, (k0 + q) * 64, x_row0 + m0, full + s);
      }
    } else {
      pdl_wait();
    }
  } else {
    // consumer warp w: columns [16 w, 16 w + 16) of every chunk, all
    // TG_ROWS weight rows (MT m-tiles) x 32 batch rows (4 n-tiles)
    pdl_wait();
    constexpr int MT = TG_ROWS / 16;  // m16 tiles of weight rows
    float acc[MT][4][4];
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[a][n][i] = 0.0f;
    const int g = lane >> 2, ca = warp * 16 + (lane & 3) * 2;
    for (int it = 0; it < ns; ++it) {
      const int s = it % TG_STAGES, kn = min(TG_KSUB, nk - it * TG_KSUB);
      mbar_wait(full + s, (it / TG_STAGES) & 1);
      for (int q = 0; q < kn; ++q) {
        const uint8_t* wq = ring + s * TG_STAGE + q * TG_CHUNK;
        const uint8_t* xq = wq + TG_WBYTES;
        uint32_t a[MT][4], bb[4][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = mt * 16 + g;
          a[mt][0] = ld_sw(wq, r, ca);
          a[mt][1] = ld_sw(wq, r + 8, ca);
          a[mt][2] = ld_sw(wq, r, ca + 8);
          a[mt][3] = ld_sw(wq, r + 8, ca + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bb[nt][0] = ld_sw(xq, nt * 8 + g, ca);
          bb[nt][1] = ld_sw(xq, nt * 8 + g, ca + 8);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], bb[nt][0], bb[nt][1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);  // the stage is read: free it
    }
    float* Gw = G + warp * TG_ROWS * TG_GLD;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            Gw[(mt * 16 + g + hh * 8) * TG_GLD + nt * 8 + (lane & 3) * 2 + e] =
                acc[mt][nt][hh * 2 + e];
  }
  __syncthreads();
  // LSTM epilogue: the four warps' partial sums in warp order, + bias
  for (int i = tid; i < TG_M * TG_U; i += TG_THREADS) {
    const int m = i / TG_U, u = i - m * TG_U, row = m0 + m, j = j0 + u;
    if (row >= M) continue;
    float gv[4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      const int r = gate * TG_U + u;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < TG_CONSUMERS; ++w) v += G[(w * TG_ROWS + r) * TG_GLD + m];
      gv[gate] = v + bias[gate * H + j];
    }
    const size_t o = (size_t)row * H + j;
    const float c = sigmoid_f(gv[1]) * c_prev[o] + sigmoid_f(gv[0]) * tanhf(gv[2]);
    const float hv = sigmoid_f(gv[3]) * tanhf(c) * mask[o];
    c_out[o] = c;
    if (h_out) h_out[o] = hv;
    const bf16 hb = __float2bfloat16_rn(hv);
    if (hx0) hx0[(size_t)row * ld0 + j] = hb;
    if (hx1) hx1[(size_t)row * ld1 + j] = hb;
  }
}

// ---------------------------------------------------------------------------
// The location attention over a cluster of S blocks per batch row (grid (S,
// B), cluster (S, 1, 1), block kClThreads): the forward
// (att_fwd_cluster_kernel) and the cluster helpers are in
// decode_common.cuh, shared with K1.
// ---------------------------------------------------------------------------

// Backward, one step, row blockIdx.y: from the step's q (qall, (B, A),
// precomputed for every step) recomputes the folded location features,
// th = tanh(q + loc + att_enc) and the masked softmax w of the own chars,
// then pulls the context's cotangent (the sum of three sources, also
// written to dctx_out for d_encoded) and the weights' cotangent (carried
// d_w and d_cum, the loss's d_align, the context's) through the softmax,
// the energies and tanh:
//   d_attenc[b] += de_pre (own chars), d_wv[b] += sum_l th de,
//   d_wloc[b] += sum_l window de_pre, dq = sum_l de_pre (-> dq_out),
//   the window's pull -> new d_w, d_cum of the own chars, and d_hq = dq . wq
//   over this rank's H/S columns, which go on through the attention LSTM's
//   pull (ap) of those columns. Rank 0 also adds the step's cotangent of the
//   E controls to d_ctrl[b] (E = 0 without controls): the heads' pull and
//   the decoder LSTM's dx hold it right after the context's (columns D .. D
//   + E of dctx_b and dctx_c).
__global__ void __launch_bounds__(kClThreads) att_bwd_cluster_kernel(
    const float* __restrict__ qall, const bf16* __restrict__ wq, const bf16* __restrict__ wloc,
    const bf16* __restrict__ wv, const float* __restrict__ att_enc, const bf16* __restrict__ enc,
    const int* __restrict__ lengths, const float* __restrict__ w_prev,
    const float* __restrict__ cum_prev, const float* __restrict__ dctx_a, int lda,
    const float* __restrict__ dctx_b, int ldb, const float* __restrict__ dctx_c, int ldc,
    const float* __restrict__ d_align, float* __restrict__ d_w, float* __restrict__ d_cum,
    float* __restrict__ dctx_out, float* __restrict__ d_attenc, float* __restrict__ d_wv,
    float* __restrict__ d_wloc, float* __restrict__ dq_out, const AttLstmPull ap,
    float* __restrict__ d_ctrl, int L, int H, int A, int D, int K, int E) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ float red[32], bc[2];
  const int S = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const AttSmem o = att_smem(true, L, S, H, A, D, K);
  pdl_wait();
  const Slice sl = slice_of(L, S, r);
  const int pad = K / 2, ww = o.ww, NG = kClThreads / A;
  float *wlt = sm + o.wlt, *hs = sm + o.hs, *q = sm + o.q, *wvs = sm + o.wvs, *win = sm + o.win;
  float *wt = sm + o.e, *stats = sm + o.stats, *dp = sm + o.dp, *dws = sm + o.dws;
  float *dcs = sm + o.dcs, *pdq = sm + o.pdq, *pdwv = sm + o.pdwv, *dqs = sm + o.dqs;
  float *dqf = sm + o.dqf, *dwv = sm + o.dwv, *pwl = sm + o.pwl;
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5, len = lengths[b];
  const size_t bl = (size_t)b * L;
  const int AS = A / S, DS = D / S, HS = H / S;

  cl_prologue<bf16, bf16>(cluster, nullptr, nullptr, qall, wloc, wv, w_prev, cum_prev, b, L, H, A,
                          K, sl, ww, wlt, hs, q, wvs, win);

  // the context's cotangent, three sources; this rank writes its D/S
  for (int d = tid; d < D; d += blockDim.x) {
    const float v = dctx_a[(size_t)b * lda + d] + dctx_b[(size_t)b * ldb + d] +
                    dctx_c[(size_t)b * ldc + d];
    if (d / DS == r) dctx_out[(size_t)b * D + d] = v;
    dcs[d] = rnd_bf16(v);
  }
  if (r == 0)
    for (int e = tid; e < E; e += blockDim.x)
      d_ctrl[(size_t)b * E + e] +=
          dctx_b[(size_t)b * ldb + D + e] + dctx_c[(size_t)b * ldc + D + e];
  // th of the own chars into dp rows pad + li, summed in the forward's order
  const int AG = A / 4;
  for (int item = tid; item < AG * (sl.ch4 / 4); item += blockDim.x) {
    const int a0 = (item % AG) * 4, li0 = (item / AG) * 4;
    float loc[4][4];
    loc_conv(win, ww, wlt, K, A, li0, a0, loc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int li = li0 + i;
      if (li < sl.n) {
        const float4 ae =
            *reinterpret_cast<const float4*>(att_enc + (bl + sl.l0 + li) * A + a0);
        *reinterpret_cast<float4*>(dp + (size_t)(pad + li) * A + a0) =
            make_float4(tanhf(q[a0] + loc[i][0] + ae.x), tanhf(q[a0 + 1] + loc[i][1] + ae.y),
                        tanhf(q[a0 + 2] + loc[i][2] + ae.z), tanhf(q[a0 + 3] + loc[i][3] + ae.w));
      }
    }
  }
  __syncthreads();
  // energies (warp per own char) and the context's pull into the weights
  for (int li = warp; li < sl.n; li += nwarps) {
    const size_t l = bl + sl.l0 + li;
    const float* th = dp + (size_t)(pad + li) * A;
    float e = 0.0f, dc = 0.0f;
    for (int a = lane; a < A; a += 32) e = fmaf(rnd_bf16(th[a]), wvs[a], e);
    const uint4* er = reinterpret_cast<const uint4*>(enc + l * D);
    for (int d8 = lane; d8 < D / 8; d8 += 32) {
      float ev[8];
      unpack8(__ldg(er + d8), ev);
#pragma unroll
      for (int i = 0; i < 8; ++i) dc = fmaf(dcs[d8 * 8 + i], ev[i], dc);
    }
    e = warp_sum(e);
    dc = warp_sum(dc);
    if (lane == 0) {
      wt[li] = (sl.l0 + li < len) ? e : -INFINITY;
      dws[li] = d_w[l] + d_align[l] + d_cum[l] + dc;
    }
  }
  __syncthreads();
  // masked softmax over the row, each sum combined over the ranks in rank
  // order, then its pull: de = w (dws - sum(dws w)) -> dws
  float mx = -INFINITY;
  for (int li = tid; li < sl.n; li += blockDim.x) mx = fmaxf(mx, wt[li]);
  mx = block_reduce(mx, red, true);
  float se = 0.0f;
  for (int li = tid; li < sl.n; li += blockDim.x) se += expf(wt[li] - mx);
  se = block_reduce(se, red, false);
  if (tid == 0) {
    stats[0] = mx;
    stats[1] = se;
  }
  cluster.sync();
  const float2 ms = cluster_softmax(cluster, stats, bc);
  mx = ms.x;
  se = ms.y;
  float sd = 0.0f;
  for (int li = tid; li < sl.n; li += blockDim.x) {
    const float w = expf(wt[li] - mx) / se;
    wt[li] = w;
    sd += dws[li] * w;
  }
  sd = block_reduce(sd, red, false);
  if (tid == 0) stats[2] = sd;
  cluster.sync();
  sd = cluster_sum(cluster, stats + 2, bc);
  for (int li = tid; li < sl.n; li += blockDim.x) dws[li] = wt[li] * (dws[li] - sd);
  __syncthreads();
  // energies' and tanh's pull: de_pre replaces th
  {
    const int a = tid % A, lg = tid / A;
    float sq = 0.0f, sv = 0.0f;
    if (lg < NG) {
#pragma unroll 4
      for (int li = lg; li < sl.n; li += NG) {
        float* p = dp + (size_t)(pad + li) * A + a;
        const float t = *p, de = dws[li];
        const float dpv = de * wvs[a] * (1.0f - t * t);
        sv = fmaf(t, de, sv);
        sq += dpv;
        *p = dpv;
        d_attenc[(bl + sl.l0 + li) * A + a] += dpv;
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
    dwv[a] = sv;
  }
  // this rank's part of the folded location window's gradient:
  // pwl[a, c, k] = sum over own l of win[c, l + k] de_pre[l, a]; a thread
  // owns 4 taps x 4 attention dims of one channel
  const int KG = (K + 3) / 4;
  for (int item = tid; item < AG * 2 * KG; item += blockDim.x) {
    const int a0 = (item % AG) * 4, ck = item / AG, c = ck / KG, k0 = (ck % KG) * 4;
    const float* wn = win + c * ww + k0;
    float s[4][4] = {};
    for (int li = 0; li < sl.n; ++li) {
      const float4 d4 = *reinterpret_cast<const float4*>(dp + (size_t)(pad + li) * A + a0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = wn[li + i];
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
        for (int j = 0; j < 4; ++j) pwl[((a0 + j) * 2 + c) * K + k0 + i] = s[i][j];
      }
    }
  }
  cluster.sync();  // every rank's de_pre and partials are complete
  // the halo: de_pre of the K/2 chars on each side from the ranks that own
  // them, 0 outside the row (the plain version's zero padding)
#pragma unroll 4
  for (int i = tid; i < 2 * pad * A; i += blockDim.x) {
    const int side = i / (pad * A), rem = i - side * pad * A, k = rem / A, a = rem - k * A;
    const int l = side == 0 ? sl.l0 - pad + k : sl.l0 + sl.n + k;
    const int row = side == 0 ? k : pad + sl.n + k;
    float v = 0.0f;
    if (l >= 0 && l < L) {
      const int owner = l / sl.chunk;
      v = *cluster.map_shared_rank(dp + (size_t)(pad + l - owner * sl.chunk) * A + a, owner);
    }
    dp[(size_t)row * A + a] = v;
  }
  // dq summed over the ranks in rank order (every rank needs it for its
  // columns of d_hq); this rank's A/S of dq_out and d_wv and its share of
  // d_wloc, each summed over the ranks in rank order
  for (int a = tid; a < A; a += blockDim.x) {
    float v = 0.0f;
#pragma unroll 8
    for (int p = 0; p < S; ++p) v += *cluster.map_shared_rank(dqs + a, p);
    dqf[a] = v;
    if (a / AS == r) {
      float w = 0.0f;
#pragma unroll 8
      for (int p = 0; p < S; ++p) w += *cluster.map_shared_rank(dwv + a, p);
      dq_out[(size_t)b * A + a] = v;
      d_wv[(size_t)b * A + a] += w;
    }
  }
  const int EW = 2 * K * A, ES = (EW + S - 1) / S, e_hi = (r + 1) * ES < EW ? (r + 1) * ES : EW;
#pragma unroll 4
  for (int i = r * ES + tid; i < e_hi; i += blockDim.x) {
    float v = 0.0f;
#pragma unroll 8
    for (int p = 0; p < S; ++p) v += *cluster.map_shared_rank(pwl + i, p);
    d_wloc[(size_t)b * EW + i] += v;
  }
  cluster.sync();  // the last reads of other ranks' memory are done
  // the window's pull: d_win[c, j] = sum over a, k of wloc[a, c, k]
  // de_pre[j - k + pad, a] for own chars j (local row jl + 2 pad - k, the
  // halo rows zero past the row's ends). A thread owns 4 chars x 4
  // attention dims of one channel (16 FMAs per tap from 5 float4 loads);
  // the AG partial sums of a char meet in ag order (pq reuses pwl, free
  // since the last cluster.sync)
  const int JG = sl.ch4 / 4;
  float* pq = pwl;  // (2, ch4, AG)
  for (int item = tid; item < 2 * JG * AG; item += blockDim.x) {
    const int ag = item % AG, cj = item / AG, c = cj / JG, j0 = (cj - c * JG) * 4, a0 = ag * 4;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < K; ++k) {
      const float4 w4 = *reinterpret_cast<const float4*>(wlt + ((size_t)c * K + k) * A + a0);
      const float* dk = dp + (size_t)(j0 - k + 2 * pad) * A + a0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 d4 = *reinterpret_cast<const float4*>(dk + (size_t)i * A);
        s[i] = fmaf(w4.w, d4.w, fmaf(w4.z, d4.z, fmaf(w4.y, d4.y, fmaf(w4.x, d4.x, s[i]))));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) pq[((size_t)c * sl.ch4 + j0 + i) * AG + ag] = s[i];
  }
  __syncthreads();
  for (int cj = tid; cj < 2 * sl.n; cj += blockDim.x) {
    const int c = cj / sl.n, jl = cj - c * sl.n;
    const float* row = pq + ((size_t)c * sl.ch4 + jl) * AG;
    float v = 0.0f;
    for (int ag = 0; ag < AG; ++ag) v += row[ag];
    const size_t j = bl + sl.l0 + jl;
    if (c == 0) d_w[j] = v;
    else d_cum[j] += v;
  }
  __syncthreads();  // pq is free again
  // the query's pull over this rank's H/S columns: a thread owns 8 columns
  // (one 16-byte load of wq a row) of a group of rows; the RG groups'
  // partial sums (in pq) meet in group order, then each column's
  // attention-LSTM pull
  {
    const int CG = HS / 8;
    int RG = (int)blockDim.x / CG;
    RG = RG < 1 ? 1 : (RG > A ? A : RG);
    if (RG * HS > 2 * K * A) RG = (2 * K * A) / HS;
    for (int item = tid; item < RG * CG; item += blockDim.x) {
      const int cg = item % CG, rg = item / CG;
      float s8[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int a = rg; a < A; a += RG) {
        float w[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(wq + (size_t)a * H + r * HS) + cg), w);
        const float dqa = dqf[a];
#pragma unroll
        for (int j = 0; j < 8; ++j) s8[j] = fmaf(dqa, w[j], s8[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) pq[rg * HS + cg * 8 + j] = s8[j];
    }
    __syncthreads();
    for (int k = tid; k < HS; k += blockDim.x) {
      float v = 0.0f;
      for (int rg = 0; rg < RG; ++rg) v += pq[rg * HS + k];
      const int j = r * HS + k;
      const size_t i = (size_t)b * H + j;
      const Lstm s1 = lstm_recompute(ap.G1, H, b, j, ap.c_prev[i]);
      const float d_hd =
          ap.d_h_next[(size_t)b * ap.ld_next + j] + ap.d_x2[(size_t)b * ap.ld_x2 + j] + v;
      lstm_pull(s1, d_hd, ap.mask[i], ap.c_prev[i], &ap.d_c[i], ap.dg, H, b, j);
    }
  }
}

// ---- launchers ----

inline unsigned blocks_for(size_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

// A TMA map of a row-major bf16 matrix (rows x cols, cols % 8 == 0, base
// 16-byte aligned), boxes of 64 columns x box_rows rows in the 128-byte
// swizzle; columns and rows past the matrix read as zero. The driver's
// encoder is looked up once through the runtime (no link to libcuda).
int make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled encode = nullptr;
  const int found = encode_tiled(&encode);
  if (found) return found;
  if (rows <= 0 || cols % 8 || ((uintptr_t)base & 15)) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_gate_tma(const void* wt, const CUtensorMap& x_map, int x_row0, const void* bias, int M,
                    int R, int H, const void* c_prev, const void* mask, void* c_out, void* h_out,
                    void* hx0, int ld0, void* hx1, int ld1, bool pdl, cudaStream_t stream) {
  if (H % TG_U || R % 8 || M <= 0 || ((uintptr_t)wt & 15)) return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  const int err = allow_smem(gate_tma_kernel, TG_SMEM, &allowed);
  if (err) return err;
  const dim3 grid(H / TG_U, (M + TG_M - 1) / TG_M);
  return launch_ex(gate_tma_kernel, grid, kNoCluster, TG_THREADS, TG_SMEM, pdl, stream,
                   (const uint8_t*)wt, x_map, x_row0, (const float*)bias, M, R, H,
                   (const float*)c_prev, (const float*)mask, (float*)c_out, (float*)h_out,
                   (bf16*)hx0, ld0, (bf16*)hx1, ld1);
}

int launch_att_bwd(const void* qall, const void* wq, const void* wloc, const void* wv,
                   const void* att_enc, const void* enc, const void* lengths, const void* w_prev,
                   const void* cum_prev, const void* dctx_a, int lda, const void* dctx_b, int ldb,
                   const void* dctx_c, int ldc, const void* d_align, void* d_w, void* d_cum,
                   void* dctx_out, void* d_attenc, void* d_wv, void* d_wloc, void* dq_out,
                   const AttLstmPull& ap, void* d_ctrl, int B, int S, int L, int H, int A, int D,
                   int K, int E, bool pdl, cudaStream_t stream) {
  size_t smem = 0;
  static size_t allowed = 48 * 1024;
  int err = att_cluster_check(true, S, L, H, A, D, K, &smem);
  if (!err) err = allow_smem(att_bwd_cluster_kernel, smem, &allowed);
  if (err) return err;
  return launch_ex(att_bwd_cluster_kernel, dim3(S, B), dim3(S, 1, 1), kClThreads, smem, pdl,
                        stream, (const float*)qall, (const bf16*)wq, (const bf16*)wloc,
                        (const bf16*)wv,
                        (const float*)att_enc, (const bf16*)enc, (const int*)lengths,
                        (const float*)w_prev, (const float*)cum_prev, (const float*)dctx_a, lda,
                        (const float*)dctx_b, ldb, (const float*)dctx_c, ldc,
                        (const float*)d_align, (float*)d_w, (float*)d_cum, (float*)dctx_out,
                        (float*)d_attenc, (float*)d_wv, (float*)d_wloc, (float*)dq_out,
                        ap, (float*)d_ctrl, L, H, A, D, K, E);
}

// one launch: the S split partial products summed in a cluster
int launch_dx(const void* dg, const void* W, int M, int N, int R, int S, void* out, int ldo,
              bool pdl, cudaStream_t stream) {
  if (S < 1 || S > 8 || GM % S || N % (S * TKC) || R % 8) return (int)cudaErrorInvalidValue;
  return launch_ex(dx_cluster_kernel, dim3((R + DXN - 1) / DXN, S, (M + GM - 1) / GM),
                   dim3(1, S, 1), kThreads, 0, pdl, stream, (const bf16*)dg, (const bf16*)W, M, N,
                   R, (float*)out, ldo);
}

int launch_gemm_tn(const void* X, int ldx, int K1, const void* X2, int ld2, const void* W,
                   const void* bias, int M, int N, int K, void* out, cudaStream_t stream) {
  if (K % 8 || K1 % 8 || K1 > K || ldx % 8 || ld2 % 8 || (K1 < K && X2 == nullptr) || M <= 0 ||
      N <= 0)
    return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  const int err = allow_smem(gemm_tn_kernel, RSMEM, &allowed);
  if (err) return err;
  const dim3 grid((N + RB - 1) / RB, (M + RB - 1) / RB);
  gemm_tn_kernel<<<grid, RTHREADS, RSMEM, stream>>>((const bf16*)X, ldx, K1, (const bf16*)X2, ld2,
                                                   (const bf16*)W, (const float*)bias, M, N, K,
                                                   (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory in bytes of K3's gate GEMM (which 0) and of the
// cluster attention's forward (1) and backward (2) at d = {L, S, H, A, D, K}.
int t2_smem_bytes(int which, const int* d) {
  if (which == 0) return (int)TG_SMEM;
  return att_smem(which == 2, d[0], d[1], d[2], d[3], d[4], d[5]).total * (int)sizeof(float);
}

// K3: T teacher-forced steps, 2 + 3 T launches. Pointer slots:
//   p[0..8]   w1 b1 w2 b2 wq w_loc wv w_out b_out
//   p[9..14]  decoder_in (T, B, P) f32, encoded (B, L, D) bf16, att_enc
//             (B, L, A) f32, lengths (B) int32, dm1 dm2 (T, B, H) f32
//   p[15..21] out: mel_gate (T, B, N), xh1 (T, B, R1) bf16, xh2 (T, B, R2)
//             bf16, c_att c_rnn (T + 1, B, H), al cum (T + 1, B, L); slot 0
//             of the four stacks zero
//   p[22..24] scratch: rnn_h (T, B, H) bf16, every step's (the heads'
//             input beside xh2's ctx and controls); wt1, wt2: the gate
//             GEMM's tiled copies of w1, w2 (4H x 64 ceil(R / 64) bf16 each,
//             tile_piece)
//   p[25]     ctl (B, E) bf16: the controls, zero past the model's C (unread
//             when E = 0)
// d = {T, B, P, H, D, L, A, K, N, S, pdl, E}: S blocks per batch row in the
// attention's cluster; pdl: the step loop's launches (all but the first)
// with programmatic dependent launch; E the controls' columns (a multiple of
// 16, 0 without controls). R1 = P + D + H; R2 = 2H + D + E, xh2's columns
// [att_h | ctx | controls | rnn_h] and w2's; w_out (N, H + D + E). R2 need
// not be a multiple of the gate GEMM's 64-column tile: the tiled weight
// copy is zero past R2 (tile_piece) and the TMA boxes of xh2 read zeros
// past it.
int t2_teacher_forward(void** p, const int* d, void* stream_) {
  const int T = d[0], B = d[1], P = d[2], H = d[3], D = d[4], L = d[5], A = d[6], K = d[7],
            N = d[8], S = d[9], E = d[11];
  const bool pdl = d[10] != 0;
  const int R1 = P + D + H, R2 = 2 * H + D + E;
  const size_t BH = (size_t)B * H, BL = (size_t)B * L;
  cudaStream_t stream = (cudaStream_t)stream_;
  const float* dm1 = (const float*)p[13];
  const float* dm2 = (const float*)p[14];
  float* mg = (float*)p[15];
  bf16* xh1 = (bf16*)p[16];
  bf16* xh2 = (bf16*)p[17];
  float* c_att = (float*)p[18];
  float* c_rnn = (float*)p[19];
  float* al = (float*)p[20];
  float* cum = (float*)p[21];
  bf16* rnn_h = (bf16*)p[22];
  uint8_t* wt1 = (uint8_t*)p[23];
  uint8_t* wt2 = (uint8_t*)p[24];
  CUtensorMap mx1, mx2;
  int err = make_map(&mx1, xh1, T * B, R1, TG_M);
  if (!err) err = make_map(&mx2, xh2, T * B, R2, TG_M);
  if (err) return err;
  if (E < 0 || E % 16) return (int)cudaErrorInvalidValue;
  const unsigned sb = blocks_for(
      (size_t)T * B * (P + E) + tile_pieces(H, R1) + tile_pieces(H, R2), 256);
  stage_kernel<<<sb < 1024 ? sb : 1024, 256, 0, stream>>>(
      (const float*)p[9], T, B, P, H, D, E, (const bf16*)p[25], xh1, xh2, (const bf16*)p[0], wt1,
      (const bf16*)p[2], wt2);
  err = (int)cudaGetLastError();
  for (int t = 0; t < T && !err; ++t) {
    const bool more = t + 1 < T;
    bf16* x2 = xh2 + (size_t)t * B * R2;
    bf16* x1n = more ? xh1 + (size_t)(t + 1) * B * R1 : nullptr;
    bf16* x2n = more ? xh2 + (size_t)(t + 1) * B * R2 : nullptr;
    // the first gate GEMM prefetches wt1 before its wait: not while
    // stage_kernel still writes it
    err = launch_gate_tma(wt1, mx1, t * B, p[1], B, R1, H, c_att + t * BH, dm1 + t * BH,
                          c_att + (t + 1) * BH, nullptr, x2, R2, more ? x1n + P + D : nullptr,
                          R1, pdl && t > 0, stream);
    if (!err)
      err = launch_att_fwd<bf16, bf16>(x2, R2, p[4], p[5], p[6], p[11], p[10], p[12], al + t * BL,
                           cum + t * BL, al + (t + 1) * BL, cum + (t + 1) * BL, x2 + H, R2,
                           more ? x1n + P : nullptr, R1, B, S, L, H, A, D, K, pdl, stream);
    if (!err)
      err = launch_gate_tma(wt2, mx2, t * B, p[3], B, R2, H, c_rnn + t * BH, dm2 + t * BH,
                            c_rnn + (t + 1) * BH, nullptr, rnn_h + t * BH, H,
                            more ? x2n + H + D + E : nullptr, R2, pdl, stream);
  }
  // the mel + gate heads of every step: nothing in the loop reads them;
  // [rnn_h | ctx | controls], the last two from xh2
  if (!err)
    err = launch_gemm_tn(rnn_h, H, H, xh2 + H, R2, p[7], p[8], T * B, N, H + D + E, mg, stream);
  return err;
}

// K4: the reverse pass, 4 + 4 T launches. Pointer slots:
//   p[0..7]   w1 b1 w2 b2 wq w_loc wv w_out
//   p[8..14]  encoded, att_enc, lengths, dm1, dm2, d_mel_gate (T, B, N) f32,
//             d_align (T, B, L) f32
//   p[15..20] K3's residuals: xh1 xh2 c_att c_rnn al cum
//   p[21..29] out: dg1 dg2 (T, B, 4H) bf16, dxh1 (T + 1, B, R1) f32 (slot T
//             zero), dctx (T, B, D), dq (T, B, A), head_h (T, B, H) bf16,
//             d_attenc (B, L, A), d_wv (B, A), d_wloc (B, A, 2, K), the last
//             three zero at entry
//   p[30..38] scratch: G1 G2 (T, B, 4H) f32, Q (T, B, A) f32, d_headin
//             (T, B, H + D + E), dxh2 (B, R2) zero, d_att_c d_rnn_c (B, H)
//             zero, d_w d_cum (B, L) zero
//   p[39]     out: d_ctrl (B, E) f32, zero at entry: the controls'
//             cotangent summed over the steps (unread when E = 0)
// d = {T, B, P, H, D, L, A, K, N, SX, S, pdl, E}: SX splits of the dx GEMMs'
// 4H contraction (one cluster), S blocks per batch row in the attention's;
// pdl: the step loop's launches with programmatic dependent launch; E the
// controls' columns (R2 = 2H + D + E, as in K3).
int t2_teacher_backward(void** p, const int* d, void* stream_) {
  const int T = d[0], B = d[1], P = d[2], H = d[3], D = d[4], L = d[5], A = d[6], K = d[7],
            N = d[8], SX = d[9], S = d[10], E = d[12];
  const bool pdl = d[11] != 0;
  if (E < 0 || E % 16) return (int)cudaErrorInvalidValue;
  const int R1 = P + D + H, R2 = 2 * H + D + E, H4 = 4 * H, RH = H + D + E;
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
  float* Q = (float*)p[32];
  float* d_headin = (float*)p[33];
  float* dxh2 = (float*)p[34];
  int err = launch_gemm_tn(p[15], R1, R1, nullptr, 0, p[0], p[1], T * B, H4, R1, G1, stream);
  if (!err) err = launch_gemm_tn(p[16], R2, R2, nullptr, 0, p[2], p[3], T * B, H4, R2, G2, stream);
  // q of every step from the forward's bf16 att_h (xh2[:, :, :H])
  if (!err) err = launch_gemm_tn(p[16], R2, H, nullptr, 0, p[4], nullptr, T * B, A, H, Q, stream);
  if (!err) {
    heads_pull_kernel<<<dim3(T * B, (RH + 255) / 256), 256, N * sizeof(float), stream>>>(
        dmg, (const bf16*)p[7], N, RH, d_headin);
    err = (int)cudaGetLastError();
  }
  for (int t = T - 1; t >= 0 && !err; --t) {
    const float* dx1_next = dxh1 + (size_t)(t + 1) * B * R1;  // step t + 1's dxh1
    const float* dh = d_headin + (size_t)t * B * RH;  // step t's heads pull
    err = launch_ex(lstm_mid_kernel, dim3(blocks_for(BH, 256)), kNoCluster, 256, 0, pdl, stream,
                    (const float*)(G2 + t * BG), c_rnn + t * BH, dm2 + t * BH, dh, RH,
                    (const float*)(dxh2 + H + D + E), R2, (float*)p[36], dg2 + t * BG,
                    head_h + t * BH, B, H);
    if (!err) err = launch_dx(dg2 + t * BG, p[2], B, H4, R2, SX, dxh2, R2, pdl, stream);
    const AttLstmPull ap = {G1 + t * BG, c_att + t * BH, dm1 + t * BH, dx1_next + P + D, R1,
                            dxh2, R2, (float*)p[35], dg1 + t * BG};
    if (!err)
      err = launch_att_bwd(Q + (size_t)t * B * A, p[4], p[5], p[6], p[9], p[8], p[10],
                           al + t * BL, cum + t * BL, dx1_next + P, R1, dh + H, RH,
                           dxh2 + H, R2, dal + t * BL, p[37], p[38], dctx + (size_t)t * B * D,
                           p[27], p[28], p[29], dq + (size_t)t * B * A, ap, p[39], B, S, L, H, A,
                           D, K, E, pdl, stream);
    if (!err)
      err = launch_dx(dg1 + t * BG, p[0], B, H4, R1, SX, dxh1 + (size_t)t * B * R1, R1, pdl,
                      stream);
  }
  return err;
}

}  // extern "C"
