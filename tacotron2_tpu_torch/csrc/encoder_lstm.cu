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
//   t2_bilstm_forward   one launch: a persistent kernel that walks all T
//                       steps of both directions, gates + LSTM epilogue;
//                       saves the activated gates and cell states for the
//                       backward.
//   t2_bilstm_backward  one launch: a persistent kernel that walks all T
//                       steps of both directions in reverse: each step's
//                       gate cotangents from the saved activations, and the
//                       recurrent pull dh_prev = bf16(dg . W_hh) (the
//                       cotangent of the bf16-rounded operand, as autograd
//                       and JAX round it).
//
// Bound: per step the bf16 W_hh of both directions (2 x 1024 x 256, 1 MB)
// and 2 B x 4H x H multiply-adds (33.6 MFLOP at B = 32): a chain of T
// dependent steps, each of a few us of work spread over the card.
//
// The backward (bilstm_bwd_kernel) has the forward's shape: a cluster of
// ES blocks per direction and 8-row tile, rank r owning units [r EU, (r +
// 1) EU), dc in registers, its units' gate cotangents pushed to every rank
// by st.async under an mbarrier a step, no cluster barrier a step. It needs
// W's columns of its units over the full K = 4H (dh_rec of a unit sums
// over every gate row), so a row's sum needs no reduction across ranks and
// runs in one order whatever B; a warp holds its (m16 tile, K quarter) of
// those columns as mma.sync fragments in registers (64 a thread at H =
// 256), read once per call. The plain version multiplies f32 dg by bf16 W
// and rounds only the result, so dg enters the bf16 tensor-core product as
// hi + lo, two bf16 operands holding 16 bits of its mantissa.
//
// The forward's design: one cluster of ES = 8 blocks per direction and
// tile of up to ETILE = 8 batch rows, grid (ES, 2, ceil(B / ETILE)). Rank
// r owns the EU = H / ES units [r EU, (r + 1) EU) of its direction, 4 EU
// gate rows of W_hh (at H = 256: 128 rows x 256 columns, 64 KB of bf16),
// bulk-copied once per call into shared memory (rows 16 bytes apart more
// than their length: conflict-free fragment loads), where they stay for
// the whole sequence, as do h (bf16, double-buffered, every rank holding
// the whole tile's h) and c (f32, in registers). A step:
//   1. each warp computes one m16 tile of the rank's gate rows for the
//      tile's rows with mma.sync m16n8k16 (weight rows on M, batch rows on
//      N, k in order), h from shared memory; the tile's rows are ordered
//      (gate, unit) so that a lane and the lane 16 away hold the four gates
//      of one unit, which one shuffle brings together;
//   2. adds the step's xp, copied into shared memory (cp.async) during the
//      previous step, and b_hh: g = (xp + h . W_hh^T) + b_hh, as the plain
//      version;
//   3. applies the LSTM update (c in registers), writes hs, cs and act;
//   4. pushes bf16(h) of its units into every rank's next h buffer over
//      distributed shared memory (st.async, counted by that buffer's
//      mbarrier in each rank);
// the next step waits for its h buffer's mbarrier, which those pushes
// complete. A cluster barrier a step instead (the first design) made each
// step wait for the step's global loads and stores too: 6.5 us a step at one
// row, against 2.0 now (chip_smoke.py --enc-ab). No step touches device memory
// for h, c or W_hh. A row's sums run in one order whatever B (an mma's
// output element depends only on its own row and column; chip_smoke.py
// holds rows of a 64-row launch against the rows alone, bit for bit).
// Tiles of 8 rows, not 64: a step's product, epilogue and push grow with a
// cluster's rows while 64-row tiles kept 16 of the 132 SMs busy; 8-row
// tiles spread B = 64 over 128 SMs (a step 2.3 us against 8.7 us at B =
// 64; 1.95 against 2.72 at one row; chip_smoke.py --enc-ab, PERF.md).
//
// Every entry launches on the given stream, allocates nothing and returns
// the launch's CUDA error (cudaErrorInvalidValue for dimensions it does not
// take).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tma.cuh"

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int ES = 8;            // blocks per cluster: the units' split
constexpr int ETILE = 8;         // batch rows per cluster: one n8 tile
constexpr int EMAXWARPS = 16;    // a block: one warp per m16 tile of its 4 EU gate rows
constexpr int BKS = 4;           // the backward's K quarters: a warp per (m16 tile, quarter)

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// byte offsets of a forward block's shared arrays: the mbarriers (W's
// copy; each h buffer's pushes); W's 4 EU rows (row rr = 16 mt + i holds
// gate i / 4 of unit r EU + 4 mt + i % 4), 2 H + 16 bytes apart; h of the
// tile's rows, two buffers of nrows rows 2 H + 16 bytes apart; the rank's
// own bf16(h), nrows x EU; xp of two steps, [step % 2][row][gate][EU] f32,
// rows 16 bytes longer than their 4 EU (conflict-free reads)
struct EncSmem {
  int w, h, hloc, xs, stride, xrow, total;
};

__host__ __device__ inline EncSmem enc_smem(int H, int nrows) {
  const int EU = H / ES;
  EncSmem o;
  o.stride = 2 * H + 16;
  o.xrow = 4 * EU + 4;
  o.w = 32;
  o.h = o.w + 4 * EU * o.stride;
  o.hloc = o.h + 2 * nrows * o.stride;
  o.xs = o.hloc + nrows * EU * 2;
  o.total = o.xs + 2 * nrows * o.xrow * 4;
  return o;
}

// the shared::cluster address of p (this block's shared memory) in rank r
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(r));
  return a;
}

// 16 bytes into another rank's shared memory, counted by its mbarrier
__device__ __forceinline__ void st_async16(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// wait for a phase of an mbarrier that other ranks' st.async complete
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// wait until at most one cp.async group of this thread is in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// grid (ES, 2, ceil(B / ETILE)), cluster (ES, 1, 1), 32 EU / 4 threads,
// enc_smem(H, rows of the tile padded to 8).total bytes: all T steps of
// direction blockIdx.y for rows [b0, b0 + bt):
//   g = (xp[d, m, s, :] + bf16(h) . W[d, :, :]^T) + b[d]
// then c = sig(f) c + sig(i) tanh(g), h = sig(o) tanh(c), h and c zero at
// s = 0. Writes hs[d, m, s], cs[d, m, s], act[d, m, s] (sig i, sig f,
// tanh g, sig o). A step waits only for its h buffer's mbarrier, which the
// ranks' pushes (st.async) complete: no cluster-wide barrier, so no step
// waits for another's global stores. A rank's pushes for step s + 1 follow
// its step s, which needed every rank's step s - 1 pushes, sent after their
// step s - 1 products: so no push overwrites an h buffer still being read.
// xp of step s + 1 is copied into shared memory (cp.async) during step s.
__global__ void __launch_bounds__(32 * EMAXWARPS, 1)
bilstm_fwd_kernel(const float* __restrict__ xp, const bf16* __restrict__ W,
                  const float* __restrict__ bias, int B, int T, int H, float* __restrict__ hs,
                  float* __restrict__ cs, float* __restrict__ act) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) uint8_t es_raw[];
  const int EU = H / ES, R = 4 * EU, G = 4 * H, KS = H / 16;  // warps: R / 16
  const int rank = (int)cluster.block_rank(), d = blockIdx.y;
  const int b0 = blockIdx.z * ETILE, bt = min(ETILE, B - b0), ntl = (bt + 7) >> 3;
  const EncSmem o = enc_smem(H, ntl * 8);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(es_raw);
  uint64_t* hfull = wbar + 1;  // [2]
  const uint8_t* ws = es_raw + o.w;
  uint8_t* hbuf = es_raw + o.h;
  bf16* hloc = reinterpret_cast<bf16*>(es_raw + o.hloc);
  float* xs = reinterpret_cast<float*>(es_raw + o.xs);
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const bf16* Wd = W + (size_t)d * G * H;
  const int hbytes = ntl * 8 * o.stride, xslot = ntl * 8 * o.xrow;
  if (tid == 0) {
    mbar_init(wbar, 1);
    mbar_init(hfull, 1);
    mbar_init(hfull + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(wbar, (uint32_t)(R * H * 2));
  }
  __syncthreads();
  if (warp == 0)  // the rank's rows of W, a bulk copy each
    for (int rr = lane; rr < R; rr += 32) {
      const int mt = rr / 16, i = rr % 16;
      const int row = (i / 4) * H + rank * EU + mt * 4 + i % 4;
      bulk_load(es_raw + o.w + rr * o.stride, Wd + (size_t)row * H, 2 * H, wbar);
    }
  // h = 0 at s = 0; rows past bt stay zero (their columns are not kept)
  for (int i = tid; i < 2 * hbytes / 4; i += nthreads) reinterpret_cast<uint32_t*>(hbuf)[i] = 0u;
  // xp of step s, this rank's units of each gate, into slot s % 2
  auto fetch_x = [&](int s) {
    float* slot = xs + (s & 1) * xslot;
    const int q4 = EU / 4;  // 16-byte pieces of a gate's units
    for (int i = tid; i < bt * 4 * q4; i += nthreads) {
      const int b = i / (4 * q4), rem = i - b * 4 * q4, q = rem / q4, k = rem - q * q4;
      cp_async16(slot + b * o.xrow + q * EU + 4 * k,
                 xp + (((size_t)d * B + b0 + b) * T + s) * G + q * H + rank * EU + 4 * k);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  fetch_x(0);

  // lane roles: rows g, g + 8 of m tile `warp` (gates g / 4 and 2 + g / 4 of
  // unit 4 warp + g % 4), batch columns 2 t, 2 t + 1 of each n8 tile; after
  // the shuffle the lane keeps column 2 t + hi of unit u
  const int g = lane >> 2, t = lane & 3, hi = g >> 2, t4 = t * 4;
  const int ul = warp * 4 + (g & 3), u = rank * EU + ul;  // the lane's unit
  float bgate[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bgate[q] = bias[(size_t)d * G + q * H + u];
  float c[ETILE / 8];
#pragma unroll
  for (int n = 0; n < ETILE / 8; ++n) c[n] = 0.0f;
  uint32_t phases = 0u;  // bit j: the parity of h buffer j's next phase
  cluster.sync();  // every rank has started, zeroed its h and set its mbarriers
  mbar_wait(wbar, 0);

  for (int s = 0; s < T; ++s) {
    const uint8_t* hc = hbuf + (s & 1) * hbytes;
    if (s > 0) {  // every rank's h of step s - 1 has landed
      mbar_wait_cluster(hfull + (s & 1), (phases >> (s & 1)) & 1u);
      phases ^= 1u << (s & 1);
    }
    if (s + 1 < T) fetch_x(s + 1);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
    float acc[ETILE / 8][4];
#pragma unroll
    for (int n = 0; n < ETILE / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    {
      const int row = warp * 16 + g;
#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks) {
        const uint8_t* wr = ws + row * o.stride + ks * 32 + t4;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(wr);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(wr + 8 * o.stride);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(wr + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(wr + 8 * o.stride + 16);
#pragma unroll
        for (int n = 0; n < ETILE / 8; ++n)
          if (n < ntl) {
            const uint8_t* hr = hc + (n * 8 + g) * o.stride + ks * 32 + t4;
            mma_bf16(acc[n], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(hr),
                     *reinterpret_cast<const uint32_t*>(hr + 16));
          }
      }
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this step's xp has landed
    __syncthreads();
    // the four gates of unit u, column 2 t + hi: from this lane (rows g,
    // g + 8) and the lane 16 away (the unit's other two gates)
    const float* xsl = xs + (s & 1) * xslot;
#pragma unroll
    for (int n = 0; n < ETILE / 8; ++n) {
      if (n >= ntl) break;
      const float r0 = __shfl_xor_sync(0xffffffffu, hi ? acc[n][0] : acc[n][1], 16);
      const float r1 = __shfl_xor_sync(0xffffffffu, hi ? acc[n][2] : acc[n][3], 16);
      const int b = n * 8 + 2 * t + hi;
      if (b >= bt) continue;
      // gate sums i, f, g, o
      const float p[4] = {hi ? r0 : acc[n][0], hi ? acc[n][1] : r0, hi ? r1 : acc[n][2],
                          hi ? acc[n][3] : r1};
      float gv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) gv[q] = (xsl[b * o.xrow + q * EU + ul] + p[q]) + bgate[q];
      const float ig = sigmoid_f(gv[0]), fg = sigmoid_f(gv[1]), gg = tanhf(gv[2]),
                  og = sigmoid_f(gv[3]);
      c[n] = fg * c[n] + ig * gg;
      const float hv = og * tanhf(c[n]);
      const size_t st = ((size_t)d * B + b0 + b) * T + s;
      hs[st * H + u] = hv;
      cs[st * H + u] = c[n];
      float* a = act + st * G + u;
      a[0] = ig;
      a[H] = fg;
      a[2 * H] = gg;
      a[3 * H] = og;
      hloc[b * EU + ul] = __float2bfloat16_rn(hv);
    }
    if (s + 1 == T) break;
    const int nb = (s + 1) & 1;
    if (tid == 0) mbar_expect_tx(hfull + nb, (uint32_t)(bt * H * 2));  // every rank's pushes
    __syncthreads();  // the rank's bf16(h) is whole
    // push it into every rank's next h buffer, 16 bytes a store
    uint8_t* hn = hbuf + nb * hbytes;
    const int pieces = EU / 8;  // 16-byte pieces of a row's EU units
    for (int i = tid; i < ES * bt * pieces; i += nthreads) {
      const int p = i / (bt * pieces), rem = i - p * bt * pieces, b = rem / pieces,
                k = rem - b * pieces;
      const uint4 v = reinterpret_cast<const uint4*>(hloc + b * EU)[k];
      const uint8_t* dst = hn + b * o.stride + rank * EU * 2 + k * 16;
      st_async16(cluster_addr(dst, p), v, cluster_addr(hfull + nb, p));
    }
  }
  cluster.sync();  // no rank leaves while a push to it may be in flight
}

// byte offsets of a backward block's shared arrays: the mbarriers (each
// dg buffer's pushes); two dg buffers, each [hi, lo][ETILE rows][4H bf16 +
// 16 bytes] in the k order of bwd_wrow; the rank's own hi and lo, [hi, lo]
// [ETILE][4 EU] bf16; act, cs of the step before and dhs, two steps of
// [step % 2][row][4 EU | EU | EU] f32, rows 16 bytes longer; the product's
// partial sums, [BKS][ETILE][EU] f32
struct BwdSmem {
  int buf, stride, hloc, stage, srow, part, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int H) {
  const int EU = H / ES;
  BwdSmem o;
  o.stride = 8 * H + 16;
  o.buf = 32;
  o.hloc = o.buf + 2 * 2 * ETILE * o.stride;
  o.stage = o.hloc + 2 * ETILE * 4 * EU * 2;
  o.srow = 6 * EU + 4;
  o.part = o.stage + 2 * ETILE * o.srow * 4;
  o.total = o.part + BKS * ETILE * EU * 4;
  return o;
}

// The W_hh row (of one direction) at position k of the backward's k order:
// rank p's gate cotangents are contiguous, k = p 4 EU + q EU + j holds gate
// q of unit p EU + j (so a rank pushes one run of 4 EU values a row)
__host__ __device__ inline int bwd_wrow(int k, int H) {
  const int EU = H / ES, p = k / (4 * EU), rem = k - p * 4 * EU, q = rem / EU;
  return q * H + p * EU + (rem - q * EU);
}

// W[d][row k][u] and W[d][row k + 1][u] in the k order of bwd_wrow as one
// bf16x2 register (k in the lower half): an A fragment of mma.sync
__device__ __forceinline__ uint32_t w_pair(const bf16* Wd, int k, int u, int H) {
  const uint32_t lo = __bfloat16_as_ushort(Wd[(size_t)bwd_wrow(k, H) * H + u]);
  const uint32_t hi = __bfloat16_as_ushort(Wd[(size_t)bwd_wrow(k + 1, H) * H + u]);
  return lo | (hi << 16);
}

// grid (ES, 2, ceil(B / ETILE)), cluster (ES, 1, 1), 8 EU threads,
// bwd_smem(H).total bytes: all T steps of direction blockIdx.y's backward
// for rows [b0, b0 + bt), in reverse. Rank r owns the EU units [r EU, (r
// + 1) EU). A step s:
//   1. the recurrent pull of its units, dh_rec[b][u] = bf16(sum over k of
//      dg[s + 1][b][k] W[k][u]), over the full K = 4H of the buffer the
//      ranks pushed at step s + 1: mma.sync m16n8k16 with W's columns on M
//      (the rank's units; a warp's fragments held in registers for the
//      whole sequence), the tile's rows on N, K split in BKS quarters, one
//      warp per (m16 tile, quarter). dg is f32 and W bf16, and the plain
//      version multiplies them in f32: dg enters as two bf16 operands, hi =
//      bf16(dg) and lo = bf16(dg - hi) (16 bits of its mantissa), in two
//      chains. A row's sum is ((q0 + q1) + q2) + q3, q = hi chain + lo
//      chain of a quarter, whatever B;
//   2. the pull of its units (thread (b, u)): dh = dhs + dh_rec, the gate
//      cotangents from the activations the forward saved, dc carried in a
//      register, as bilstm_backward_plain; dg written to device memory
//      (dW_hh, db and dxp read it after the loop);
//   3. pushes hi and lo of its 4 EU gate cotangents a row into every rank's
//      next dg buffer over distributed shared memory (st.async, counted by
//      that buffer's mbarrier in each rank), as the forward pushes h.
// The next step waits only for its buffer's mbarrier (the forward's
// argument: a rank pushes step s's dg after its step s + 1 product, which
// needed every rank's pushes of step s + 1, sent after their step s + 2
// products; so no push overwrites a buffer still being read). act, cs and
// dhs of the step come by cp.async a step ahead. No step reads W or dg
// from device memory. Two blocks fit an SM (at most 128 registers a thread,
// 86,816 bytes of shared memory at H = 256): with one block an SM the card
// runs fewer clusters of 8 at once than the 16 of 57-64 rows
// (t2_bilstm_backward_clusters), and the last waited for another to end,
// doubling the time (chip_smoke.py --enc-ab reads both builds).
template <int H>
__global__ void __launch_bounds__(32 * (H / ES / 4), 2)
bilstm_bwd_kernel(const float* __restrict__ dhs, const float* __restrict__ act,
                  const float* __restrict__ cs, const bf16* __restrict__ W, int B, int T,
                  float* __restrict__ dg) {
  constexpr int EU = H / ES, G = 4 * H, MT = EU / 16, KQ = H / 16;  // k16 steps a quarter
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) uint8_t eb_raw[];
  const BwdSmem o = bwd_smem(H);
  const int rank = (int)cluster.block_rank(), d = blockIdx.y;
  const int b0 = blockIdx.z * ETILE, bt = min(ETILE, B - b0);
  uint64_t* full = reinterpret_cast<uint64_t*>(eb_raw);  // [2]
  uint8_t* bufs = eb_raw + o.buf;
  bf16* hloc = reinterpret_cast<bf16*>(eb_raw + o.hloc);
  float* stg = reinterpret_cast<float*>(eb_raw + o.stage);
  float* part = reinterpret_cast<float*>(eb_raw + o.part);
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int bufbytes = 2 * ETILE * o.stride, slot_f = ETILE * o.srow;
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // both dg buffers zero: rows past bt are never pushed
  for (int i = tid; i < 2 * bufbytes / 4; i += nthreads) reinterpret_cast<uint32_t*>(bufs)[i] = 0u;

  // warp roles in the product: m16 tile mt of the rank's units, K quarter kq
  const int g = lane >> 2, t = lane & 3, mt = warp % MT, kq = warp / MT;
  const bf16* Wd = W + (size_t)d * G * H;
  uint32_t afr[KQ][4];
  {
    const int ua = rank * EU + mt * 16 + g;  // A rows g and g + 8
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks) {
      const int k0 = kq * H + ks * 16 + 2 * t;
      afr[ks][0] = w_pair(Wd, k0, ua, H);
      afr[ks][1] = w_pair(Wd, k0, ua + 8, H);
      afr[ks][2] = w_pair(Wd, k0 + 8, ua, H);
      afr[ks][3] = w_pair(Wd, k0 + 8, ua + 8, H);
    }
  }
  // pull roles: row b of the tile, unit ul of the rank
  const int b = tid / EU, ul = tid - b * EU, u = rank * EU + ul;
  const bool live = b < bt;
  const size_t row0 = ((size_t)d * B + b0 + b) * T;  // (d, m)'s step 0
  float dc = 0.0f, cv = live ? cs[(row0 + T - 1) * H + u] : 0.0f;
  // act, cs[s - 1] and dhs of step s, the rank's units, into slot `slot`
  auto fetch = [&](int s, int slot) {
    float* sl = stg + slot * slot_f;
    constexpr int q4 = EU / 4, per_row = 6 * q4;  // 16-byte pieces
    for (int i = tid; i < bt * per_row; i += nthreads) {
      const int bb = i / per_row, rem = i - bb * per_row, seg = rem / q4, k = rem - seg * q4;
      if (seg == 4 && s == 0) continue;  // c before step 0 is zero
      const size_t st = ((size_t)d * B + b0 + bb) * T + s;
      const float* src = seg < 4 ? act + st * G + seg * H
                                 : (seg == 4 ? cs + (st - 1) * H : dhs + st * H);
      cp_async16(sl + bb * o.srow + seg * EU + 4 * k, src + rank * EU + 4 * k);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  uint32_t phases = 0u;  // bit j: the parity of dg buffer j's next phase
  cluster.sync();  // every rank has started, zeroed its buffers and set its mbarriers
  fetch(T - 1, 0);

  for (int n = 0; n < T; ++n) {
    const int s = T - 1 - n;
    if (n > 0) {  // every rank's dg of step s + 1 has landed
      const int j = (n - 1) & 1;
      mbar_wait_cluster(full + j, (phases >> j) & 1u);
      phases ^= 1u << j;
    }
    if (s > 0) fetch(s - 1, (n + 1) & 1);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (n > 0) {
      const uint8_t* hr = bufs + ((n - 1) & 1) * bufbytes + g * o.stride + (kq * H + 2 * t) * 2;
      const uint8_t* lr = hr + ETILE * o.stride;
      float ah[4] = {0.0f, 0.0f, 0.0f, 0.0f}, al[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < KQ; ++ks) {
        mma_bf16(ah, afr[ks][0], afr[ks][1], afr[ks][2], afr[ks][3],
                 *reinterpret_cast<const uint32_t*>(hr + ks * 32),
                 *reinterpret_cast<const uint32_t*>(hr + ks * 32 + 16));
        mma_bf16(al, afr[ks][0], afr[ks][1], afr[ks][2], afr[ks][3],
                 *reinterpret_cast<const uint32_t*>(lr + ks * 32),
                 *reinterpret_cast<const uint32_t*>(lr + ks * 32 + 16));
      }
      // c0, c1: unit row g, batch columns 2t, 2t + 1; c2, c3: unit row g + 8
      float* pq = part + kq * ETILE * EU + mt * 16 + g;
      pq[(2 * t) * EU] = ah[0] + al[0];
      pq[(2 * t + 1) * EU] = ah[1] + al[1];
      pq[(2 * t) * EU + 8] = ah[2] + al[2];
      pq[(2 * t + 1) * EU + 8] = ah[3] + al[3];
    }
    cp_async_wait1();  // this step's act, cs, dhs
    __syncthreads();
    if (live) {
      float dh_rec = 0.0f;
      if (n > 0) {
        float v = part[b * EU + ul];
#pragma unroll
        for (int q = 1; q < BKS; ++q) v += part[(q * ETILE + b) * EU + ul];
        dh_rec = __bfloat162float(__float2bfloat16_rn(v));
      }
      const float* sl = stg + (n & 1) * slot_f + b * o.srow;
      const float ig = sl[ul], fg = sl[EU + ul], gg = sl[2 * EU + ul], og = sl[3 * EU + ul];
      const float c_prev = s > 0 ? sl[4 * EU + ul] : 0.0f;
      const float tc = tanhf(cv);
      const float dh = sl[5 * EU + ul] + dh_rec;
      const float dcv = dc + dh * og * (1.0f - tc * tc);
      float gv[4];
      gv[0] = dcv * gg * ig * (1.0f - ig);
      gv[1] = dcv * c_prev * fg * (1.0f - fg);
      gv[2] = dcv * ig * (1.0f - gg * gg);
      gv[3] = dh * tc * og * (1.0f - og);
      dc = dcv * fg;
      cv = c_prev;
      float* out = dg + (row0 + s) * G + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[q * H] = gv[q];
        const bf16 hi = __float2bfloat16_rn(gv[q]);
        hloc[b * 4 * EU + q * EU + ul] = hi;
        hloc[(ETILE + b) * 4 * EU + q * EU + ul] =
            __float2bfloat16_rn(gv[q] - __bfloat162float(hi));
      }
    }
    if (n + 1 == T) break;
    const int nb = n & 1;
    if (tid == 0) mbar_expect_tx(full + nb, (uint32_t)(ES * 2 * bt * 4 * EU * 2));
    __syncthreads();  // the rank's hi and lo are whole
    // push them into every rank's next buffer at the rank's k run, 16 bytes a store
    uint8_t* bn = bufs + nb * bufbytes;
    constexpr int pieces = 4 * EU * 2 / 16;  // of a row's 4 EU bf16
    const int per_rank = 2 * bt * pieces;
    for (int i = tid; i < ES * per_rank; i += nthreads) {
      const int p = i / per_rank, rem = i - p * per_rank, hl = rem / (bt * pieces),
                rem2 = rem - hl * bt * pieces, bb = rem2 / pieces, k = rem2 - bb * pieces;
      const uint4 v = reinterpret_cast<const uint4*>(hloc + (hl * ETILE + bb) * 4 * EU)[k];
      const uint8_t* dst = bn + (hl * ETILE + bb) * o.stride + rank * 4 * EU * 2 + k * 16;
      st_async16(cluster_addr(dst, p), v, cluster_addr(full + nb, p));
    }
  }
  cluster.sync();  // every push to this rank has landed before any rank leaves
}

// the forward's dimensions: ES ranks of EU = H / ES units, EU a multiple
// of 8 (whole 16-byte pieces of a row's h; 4 EU / 16 m16 tiles, one warp
// each, at most EMAXWARPS), its shared memory within a block's
inline int enc_check(int B, int T, int H, size_t* smem) {
  if (B <= 0 || T <= 0 || H % (8 * ES) || 4 * (H / ES) / 16 > EMAXWARPS)
    return (int)cudaErrorInvalidValue;
  *smem = (size_t)enc_smem(H, (std::min(B, ETILE) + 7) & ~7).total;
  return *smem > 227 * 1024 ? (int)cudaErrorInvalidValue : 0;
}

// the backward's dimensions: its template instances, H = 128 and 256 (EU
// a multiple of 16: whole m16 tiles of units; a warp's W fragments, H / 4
// registers a thread, held for the whole sequence)
inline int bwd_check(int B, int T, int H) {
  return B <= 0 || T <= 0 || (H != 128 && H != 256) ? (int)cudaErrorInvalidValue : 0;
}

// the backward's launch at width H for B rows (its dynamic shared memory
// allowed once): grid (ES, 2, ceil(B / ETILE)), clusters of ES; attr holds
// the cluster's dimension -> a CUDA error or 0
template <int H>
int bwd_config(int B, cudaStream_t stream, cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  const size_t smem = (size_t)bwd_smem(H).total;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        bilstm_bwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ES, 2, (B + ETILE - 1) / ETILE);
  cfg->blockDim = dim3(8 * (H / ES));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ES;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <int H>
int launch_bwd(void** p, int B, int T, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int err = bwd_config<H>(B, stream, attr, &cfg);
  if (err) return err;
  err = (int)cudaLaunchKernelEx(&cfg, bilstm_bwd_kernel<H>, (const float*)p[0],
                                (const float*)p[1], (const float*)p[2], (const bf16*)p[3], B, T,
                                (float*)p[4]);
  return err ? err : (int)cudaGetLastError();
}

template <int H>
int bwd_max_clusters(int* out) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  const int err = bwd_config<H>(1, nullptr, attr, &cfg);
  return err ? err : (int)cudaOccupancyMaxActiveClusters(out, bilstm_bwd_kernel<H>, &cfg);
}

}  // namespace

extern "C" {

// Forward, one launch. p: xp (2, B, T, 4H) f32 (the input projection +
// b_ih), W_hh (2, 4H, H) bf16, b_hh (2, 4H) f32; out hs (2, B, T, H), cs
// (2, B, T, H), act (2, B, T, 4H) f32. d = {B, T, H}.
int t2_bilstm_forward(void** p, const int* d, void* stream_) {
  const int B = d[0], T = d[1], H = d[2];
  size_t smem = 0;
  int err = enc_check(B, T, H, &smem);
  if (err) return err;
  if (((uintptr_t)p[1] & 15) || (H * 2) % 16) return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        bilstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ES, 2, (B + ETILE - 1) / ETILE);
  cfg.blockDim = dim3(32 * (4 * (H / ES) / 16));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream_;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ES;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, bilstm_fwd_kernel, (const float*)p[0], (const bf16*)p[1],
                                (const float*)p[2], B, T, H, (float*)p[3], (float*)p[4],
                                (float*)p[5]);
  return err ? err : (int)cudaGetLastError();
}

// Backward, one launch. p: dhs (2, B, T, H) f32, act, cs (the forward's),
// W_hh (2, 4H, H) bf16; out dg (2, B, T, 4H) f32. d = {B, T, H}, H 128 or
// 256 (bwd_check).
int t2_bilstm_backward(void** p, const int* d, void* stream_) {
  const int B = d[0], T = d[1], H = d[2];
  const int err = bwd_check(B, T, H);
  if (err) return err;
  if ((uintptr_t)p[0] & 15 || (uintptr_t)p[1] & 15 || (uintptr_t)p[2] & 15)
    return (int)cudaErrorInvalidValue;  // cp.async's 16-byte pieces
  return H == 256 ? launch_bwd<256>(p, B, T, (cudaStream_t)stream_)
                  : launch_bwd<128>(p, B, T, (cudaStream_t)stream_);
}

// The most clusters of the backward at width H that the card runs at once
// (cudaOccupancyMaxActiveClusters) into *out -> a CUDA error or 0. More
// than that many (two a tile of 8 rows) and a cluster waits for another
// to end.
int t2_bilstm_backward_clusters(int H, int* out) {
  const int err = bwd_check(1, 1, H);
  if (err) return err;
  return H == 256 ? bwd_max_clusters<256>(out) : bwd_max_clusters<128>(out);
}

}  // extern "C"
