// Kernels shared by K1 (decode_step.cu) and K3/K4 (train_decode.cu), for
// sm_90a:
//
//   att_fwd_cluster_kernel  the location attention's forward over a
//                           thread-block cluster of S blocks per batch row:
//                           query, folded location conv, tanh energies,
//                           masked softmax, context, cumulative weights (K1's
//                           step with f32 query input and context, K3's with
//                           bf16 ones); over bf16 weights and memory (K1's
//                           bf16 and int8 modes, K3), or f32 ones (K1's f32
//                           mode: nothing rounded, as the JAX kernel with
//                           dt = f32)
//
// plus the warp helpers, the cluster helpers that K4's
// backward attention shares (slice_of, att_smem, cl_prologue, loc_conv, the
// rank-order combines) and the launch helpers. Each launcher checks the
// dimensions it takes, launches on the given stream, allocates nothing and
// returns cudaGetLastError() (cudaErrorInvalidValue for dimensions it does
// not take; the cluster launch's own error when the card refuses a cluster
// size or its shared memory).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

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

// Programmatic dependent launch: a kernel launched with it (launch_ex,
// pdl) may start while the previous kernel on the stream ends; this waits
// until that kernel has completed and its writes are visible. K3's and K4's
// step loops launch their kernels with it; K1 its LSTM cells and K5's
// quantize_xh, its other kernels without. Every kernel launched with it
// calls it in every thread before it reads what an earlier launch wrote or
// writes anything, so each launch still follows all earlier ones; only
// reads of the weights (written before the loop) go ahead of it. A no-op
// when the launch did not ask for the overlap.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// Let the next launch on the stream, where it asks for programmatic
// dependent launch, start now rather than when this kernel's blocks exit:
// K1's attention, the chunk's bf16 prenet and K5's quantize_xh call it
// first, so that the launch after each (an LSTM cell, which streams its
// first weight chunks meanwhile, or quantize_xh after the attention) starts
// early; its pdl_wait still waits for this kernel to complete. A no-op for
// a next launch without the overlap.
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// a launch through cudaLaunchKernelEx: with a cluster of cluster.x x
// cluster.y blocks where cluster.x > 0, and with programmatic dependent
// launch (pdl_wait) where pdl
template <typename... KArgs, typename... Args>
int launch_ex(void (*kernel)(KArgs...), dim3 grid, dim3 cluster, int threads, size_t smem,
              bool pdl, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (cluster.x > 0) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster.x;
    attr[n].val.clusterDim.y = cluster.y;
    attr[n].val.clusterDim.z = cluster.z;
    ++n;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

const dim3 kNoCluster(0, 0, 0);

// dynamic shared memory above 48 KB, asked for once per kernel and size
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, size_t* allowed) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > *allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *allowed = smem;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Location attention over a cluster of S blocks per batch row (grid (S, B),
// cluster (S, 1, 1), block kClThreads): rank r owns the chars of slice_of.
// ---------------------------------------------------------------------------
constexpr int kClThreads = 512;

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

// rank r's chars [l0, l0 + n) of L split into S slices of chunk chars
struct Slice {
  int chunk, ch4, l0, n;
};

__host__ __device__ inline Slice slice_of(int L, int S, int r) {
  Slice s;
  s.chunk = (L + S - 1) / S;
  s.ch4 = up4(s.chunk);
  s.l0 = r * s.chunk < L ? r * s.chunk : L;
  s.n = (s.l0 + s.chunk < L ? s.l0 + s.chunk : L) - s.l0;
  return s;
}

// Offsets (floats) of the cluster kernels' shared arrays, each on a 16-byte
// boundary: wlt[2KA] hs[H] q[A] wvs[A] win[2 ww + 4] e[ch4] stats[4], then
// forward: part[(A/4) ch4] ctxp[D]; backward: dp[(ch4 + K - 1) A] (th, then
// de_pre, with K/2 halo rows on each side) dws[ch4] dcs[D] pdq pdwv[NG A]
// dqs dqf dwv[A] pwl[max(2KA, ch4 A / 2)]. ww = ch4 + K - 1 chars of the location window.
struct AttSmem {
  int ww, wlt, hs, q, wvs, win, e, stats, part, ctxp, dp, dws, dcs, pdq, pdwv, dqs, dqf, dwv, pwl,
      total;
};

__host__ __device__ inline int take(int* at, int n) {
  const int p = *at;
  *at += up4(n);
  return p;
}

__host__ __device__ inline AttSmem att_smem(bool bwd, int L, int S, int H, int A, int D, int K) {
  const Slice s = slice_of(L, S, 0);
  const int NG = kClThreads / A;
  AttSmem o = {};
  int at = 0;
  o.ww = s.ch4 + K - 1;
  o.wlt = take(&at, 2 * K * A);
  o.hs = take(&at, H);
  o.q = take(&at, A);
  o.wvs = take(&at, A);
  o.win = take(&at, 2 * o.ww + 4);
  o.e = take(&at, s.ch4);
  o.stats = take(&at, 4);
  if (bwd) {
    o.dp = take(&at, (s.ch4 + K - 1) * A);
    o.dws = take(&at, s.ch4);
    o.dcs = take(&at, D);
    o.pdq = take(&at, NG * A);
    o.pdwv = take(&at, NG * A);
    o.dqs = take(&at, A);
    o.dqf = take(&at, A);
    o.dwv = take(&at, A);
    // pwl, later the window pull's partial sums (2 ch4 A/4)
    o.pwl = take(&at, 2 * K * A > s.ch4 * A / 2 ? 2 * K * A : s.ch4 * A / 2);
  } else {
    o.part = take(&at, (A / 4) * s.ch4);
    o.ctxp = take(&at, D);
  }
  o.total = at;
  return o;
}

// The sum over the cluster's ranks, in rank order, of the float at v in
// each rank's shared memory; every thread gets it. bc: a shared float.
__device__ float cluster_sum(cg::cluster_group& cluster, float* v, float* bc) {
  if (threadIdx.x == 0) {
    const unsigned S = cluster.num_blocks();
    float x[8];  // every load in flight at once, then summed in rank order
#pragma unroll
    for (unsigned p = 0; p < 8; ++p) x[p] = p < S ? *cluster.map_shared_rank(v, p) : 0.0f;
    float acc = 0.0f;
#pragma unroll
    for (unsigned p = 0; p < 8; ++p)
      if (p < S) acc += x[p];
    *bc = acc;
  }
  __syncthreads();
  const float r = *bc;
  __syncthreads();  // bc is free for the next call
  return r;
}

// The softmax statistics of the row from each rank's (max m, sum of exp(e -
// m)) at st[0], st[1], combined in rank order: M = max of the m, S = sum of
// s exp(m - M) over the ranks with a valid char (m = -inf is skipped, never
// exp(-inf - -inf)). Every thread gets (M, S); bc: two shared floats.
__device__ float2 cluster_softmax(cg::cluster_group& cluster, float* st, float* bc) {
  if (threadIdx.x == 0) {
    const unsigned S = cluster.num_blocks();
    float m[8], sm[8];
#pragma unroll
    for (unsigned p = 0; p < 8; ++p) {
      m[p] = p < S ? *cluster.map_shared_rank(st, p) : -INFINITY;
      sm[p] = p < S ? *cluster.map_shared_rank(st + 1, p) : 0.0f;
    }
    float mx = -INFINITY, tot = 0.0f;
#pragma unroll
    for (unsigned p = 0; p < 8; ++p) mx = fmaxf(mx, m[p]);
#pragma unroll
    for (unsigned p = 0; p < 8; ++p)
      if (m[p] != -INFINITY) tot += sm[p] * expf(m[p] - mx);
    bc[0] = mx;
    bc[1] = tot;
  }
  __syncthreads();
  const float2 r = make_float2(bc[0], bc[1]);
  __syncthreads();
  return r;
}

// Stage the energy vector, the folded location weight transposed to
// (channel, tap, a), this rank's window of the previous and cumulative
// weights (chars l0 - K/2 .. l0 + ch4 + K/2, bf16-rounded, 0 outside the
// row) and q = bf16(wq . h) (as the JAX kernels' qT.astype(dt)). The
// forward passes h (this row's query input, rounded to bf16 as it is
// staged when it is f32), computes this rank's A/S
// of q and reads the rest from the other ranks; the backward passes qrow
// (row b of the step's precomputed q) and does not synchronise the
// cluster. Ends synchronised, q whole.
__device__ __forceinline__ float as_bf16_operand(float x) { return rnd_bf16(x); }
__device__ __forceinline__ float as_bf16_operand(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// The operand type WT of the attention's products (its weights' and the
// memory's type): bf16 rounds every operand it stages (the JAX kernel's
// astype(dt) with dt = bf16), f32 none (dt = f32).
template <typename WT>
__device__ __forceinline__ float op_round(float x) {
  if constexpr (std::is_same<WT, float>::value) return x;
  else return rnd_bf16(x);
}
template <typename WT, typename HT>
__device__ __forceinline__ float as_operand(HT x) {
  if constexpr (std::is_same<WT, float>::value) return (float)x;
  else return as_bf16_operand(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// 8 consecutive weights from p (16-byte aligned): one 16-byte load of bf16,
// two of f32
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <typename HT, typename WT = bf16>
__device__ void cl_prologue(cg::cluster_group& cluster, const HT* __restrict__ h,
                            const WT* __restrict__ wq, const float* __restrict__ qrow,
                            const WT* __restrict__ wloc, const WT* __restrict__ wv,
                            const float* __restrict__ w_prev, const float* __restrict__ cum_prev,
                            int b, int L, int H, int A, int K, const Slice& sl, int ww, float* wlt,
                            float* hs, float* q, float* wvs, float* win) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int S = (int)cluster.num_blocks(), r = (int)cluster.block_rank(), pad = K / 2;
  if (qrow) {
    for (int a = tid; a < A; a += blockDim.x) q[a] = op_round<WT>(qrow[(size_t)b * A + a]);
  } else {
    for (int k = tid; k < H; k += blockDim.x) hs[k] = as_operand<WT>(h[k]);
  }
  for (int a = tid; a < A; a += blockDim.x) wvs[a] = to_f32(wv[a]);
  // wloc (A, 2, K) read 8 weights a load (A 2K % 8 == 0), written transposed
  for (int i8 = tid; i8 < A * 2 * K / 8; i8 += blockDim.x) {
    float v[8];
    load8(wloc + (size_t)i8 * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i8 * 8 + j, a = i / (2 * K);
      wlt[(i - a * 2 * K) * A + a] = v[j];
    }
  }
  for (int i = tid; i < ww; i += blockDim.x) {
    const int l = sl.l0 - pad + i;
    const bool in = l >= 0 && l < L;
    win[i] = in ? op_round<WT>(w_prev[(size_t)b * L + l]) : 0.0f;
    win[ww + i] = in ? op_round<WT>(cum_prev[(size_t)b * L + l]) : 0.0f;
  }
  __syncthreads();
  if (qrow) return;
  // this rank's A/S outputs of the query projection, 2 a warp, a lane's
  // 16-byte weight loads all in flight
  const int AS = A / S, a_lo = r * AS, a_hi = a_lo + AS;
  for (int a0 = a_lo + warp * 2; a0 < a_hi; a0 += nwarps * 2) {
    float acc[2] = {0.0f, 0.0f};
#pragma unroll 4
    for (int k8 = lane; k8 < H / 8; k8 += 32) {
      const float4 h0 = *reinterpret_cast<const float4*>(hs + k8 * 8);
      const float4 h1 = *reinterpret_cast<const float4*>(hs + k8 * 8 + 4);
      const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (a0 + i < a_hi) {
          float w[8];
          load8(wq + (size_t)(a0 + i) * H + (size_t)k8 * 8, w);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[i] = fmaf(w[k], hv[k], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = warp_sum(acc[i]);
      if (lane == 0 && a0 + i < a_hi) q[a0 + i] = op_round<WT>(v);
    }
  }
  cluster.sync();
  for (int a = tid; a < A; a += blockDim.x) {
    const int owner = a / AS;
    if (owner != r) q[a] = *cluster.map_shared_rank(q + a, owner);
  }
  __syncthreads();
}

// the folded location conv at local chars li0..li0+3 x attention dims
// a0..a0+3 from the staged window: 16 independent FMAs per tap and channel
__device__ __forceinline__ void loc_conv(const float* win, int ww, const float* wlt, int K, int A,
                                         int li0, int a0, float loc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) loc[i][j] = 0.0f;
  for (int c = 0; c < 2; ++c) {
    const float* wn = win + c * ww + li0;
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
}

// Forward: energies, masked softmax, context and cumulative weights of row
// blockIdx.y from the query input h (HT: K1's f32, K3's bf16; rows ldh
// apart). The context goes into xa and, where given, xb (CT: K1's f32, K3's
// bf16; rows lda / ldb apart); w_out, cum_out (B, L). A rank whose chars
// are all masked or that has none gives the partial (max -inf, sum 0), which
// the combine skips. TRIGGER: pdl_trigger first; CB: the type of xb (K1's
// instances: the context as f32 into xa and as its bf16 operand into xb).
// WT: the type of wq, wloc, wv and enc and of the products' operands
// (op_round): bf16, or K1's f32 mode's f32.
template <typename HT, typename CT, int THREADS, bool TRIGGER, typename CB, typename WT = bf16>
__global__ void __launch_bounds__(THREADS) att_fwd_cluster_kernel(
    const HT* __restrict__ h, int ldh, const WT* __restrict__ wq,
    const WT* __restrict__ wloc, const WT* __restrict__ wv, const float* __restrict__ att_enc,
    const WT* __restrict__ enc, const int* __restrict__ lengths,
    const float* __restrict__ w_prev, const float* __restrict__ cum_prev, float* __restrict__ w_out,
    float* __restrict__ cum_out, CT* __restrict__ xa, int lda, CB* __restrict__ xb, int ldb,
    int L, int H, int A, int D, int K) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ float red[32], bc[2];
  const int S = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const AttSmem o = att_smem(false, L, S, H, A, D, K);
  if (TRIGGER) pdl_trigger();
  pdl_wait();
  const Slice sl = slice_of(L, S, r);
  float *wlt = sm + o.wlt, *hs = sm + o.hs, *q = sm + o.q, *wvs = sm + o.wvs, *win = sm + o.win;
  float *e = sm + o.e, *stats = sm + o.stats, *part = sm + o.part, *ctxp = sm + o.ctxp;
  const int b = blockIdx.y, tid = threadIdx.x, len = lengths[b];
  const size_t bl = (size_t)b * L;

  cl_prologue<HT, WT>(cluster, h + (size_t)b * ldh, wq, nullptr, wloc, wv, w_prev, cum_prev, b, L,
                      H, A, K, sl, o.ww, wlt, hs, q, wvs, win);

  // energies of the own chars: a thread owns 4 chars x 4 attention dims
  const int AG = A / 4, CH = sl.ch4;
  for (int item = tid; item < AG * (CH / 4); item += blockDim.x) {
    const int ag = item % AG, li0 = (item / AG) * 4, a0 = ag * 4;
    float loc[4][4];
    loc_conv(win, o.ww, wlt, K, A, li0, a0, loc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int li = li0 + i;
      if (li < sl.n) {
        const float* ae = att_enc + (bl + sl.l0 + li) * A + a0;
        float es = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          es = fmaf(op_round<WT>(tanhf(q[a0 + j] + loc[i][j] + ae[j])), wvs[a0 + j], es);
        part[ag * CH + li] = es;
      }
    }
  }
  __syncthreads();
  for (int li = tid; li < sl.n; li += blockDim.x) {
    float es = 0.0f;
    for (int ag = 0; ag < AG; ++ag) es += part[ag * CH + li];
    e[li] = (sl.l0 + li < len) ? es : -INFINITY;
  }
  __syncthreads();

  // masked softmax over the row: each rank's max and sum of exp(e - max),
  // combined in rank order (cluster_softmax)
  float m = -INFINITY;
  for (int li = tid; li < sl.n; li += blockDim.x) m = fmaxf(m, e[li]);
  m = block_reduce(m, red, true);
  float s = 0.0f;
  if (m != -INFINITY)  // never exp(-inf - -inf)
    for (int li = tid; li < sl.n; li += blockDim.x) s += expf(e[li] - m);
  s = block_reduce(s, red, false);
  if (tid == 0) {
    stats[0] = m;
    stats[1] = s;
  }
  cluster.sync();
  const float2 ms = cluster_softmax(cluster, stats, bc);
  const float mx = ms.x, tot = ms.y;
  for (int li = tid; li < sl.n; li += blockDim.x) {
    const size_t l = bl + sl.l0 + li;
    const float w = expf(e[li] - mx) / tot;
    w_out[l] = w;
    cum_out[l] = cum_prev[l] + w;
    e[li] = op_round<WT>(w);
  }
  __syncthreads();

  // the context over the own chars (thread per feature d, four partial
  // sums), then rank r sums dims [r D/S, ...) over the ranks in rank order
  for (int d = tid; d < D; d += blockDim.x) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const WT* col = enc + (bl + sl.l0) * D + d;
    int li = 0;
#pragma unroll 2
    for (; li + 4 <= sl.n; li += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = fmaf(e[li + i], to_f32(col[(size_t)(li + i) * D]), acc[i]);
    }
    for (; li < sl.n; ++li) acc[0] = fmaf(e[li], to_f32(col[(size_t)li * D]), acc[0]);
    ctxp[d] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  cluster.sync();
  const int DS = D / S;
  for (int d = r * DS + tid; d < (r + 1) * DS; d += blockDim.x) {
    float v = 0.0f;
#pragma unroll 8
    for (int p = 0; p < S; ++p) v += *cluster.map_shared_rank(ctxp + d, p);
    store_as(xa + (size_t)b * lda + d, v);
    if (xb) store_as(xb + (size_t)b * ldb + d, v);
  }
  cluster.sync();  // no rank leaves while another still reads its partials
}

// the dimensions the cluster attention takes, and its shared memory
int att_cluster_check(bool bwd, int S, int L, int H, int A, int D, int K, size_t* smem) {
  if (S < 1 || S > 8 || L < 1 || H % (8 * S) || D % 8 || A % 4 || A > kClThreads ||
      kClThreads % A || A % S || D % S || K % 2 == 0)
    return (int)cudaErrorInvalidValue;
  *smem = (size_t)att_smem(bwd, L, S, H, A, D, K).total * sizeof(float);
  return 0;
}

// the forward attention over a cluster of S blocks per row, grid (S, B),
// THREADS a block (K3: kClThreads; K1 fewer, so that the serve windows'
// clusters run in one wave); HT / CT the types of the query input and of
// the context (see the kernel). THREADS is fixed per caller, never taken
// from the batch; TRIGGER, CB, WT: see the kernel.
template <typename HT, typename CT, int THREADS = kClThreads, bool TRIGGER = false,
          typename CB = CT, typename WT = bf16>
int launch_att_fwd(const void* h, int ldh, const void* wq, const void* wloc, const void* wv,
                   const void* att_enc, const void* enc, const void* lengths, const void* w_prev,
                   const void* cum_prev, void* w_out, void* cum_out, void* xa, int lda, void* xb,
                   int ldb, int B, int S, int L, int H, int A, int D, int K, bool pdl,
                   cudaStream_t stream) {
  size_t smem = 0;
  static size_t allowed = 48 * 1024;
  int err = att_cluster_check(false, S, L, H, A, D, K, &smem);
  auto kernel = att_fwd_cluster_kernel<HT, CT, THREADS, TRIGGER, CB, WT>;
  if (!err) err = allow_smem(kernel, smem, &allowed);
  if (err) return err;
  return launch_ex(kernel, dim3(S, B), dim3(S, 1, 1), THREADS, smem, pdl, stream, (const HT*)h,
                   ldh, (const WT*)wq, (const WT*)wloc, (const WT*)wv, (const float*)att_enc,
                   (const WT*)enc, (const int*)lengths,
                   (const float*)w_prev, (const float*)cum_prev, (float*)w_out, (float*)cum_out,
                   (CT*)xa, lda, (CB*)xb, ldb, L, H, A, D, K);
}

}  // namespace
