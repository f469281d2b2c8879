// Kernel K1: one Tacotron 2 decode step as four kernels, for sm_90a.
//
// Replaces tacotron2_tpu/ops/decoder_loop_pallas.py::_decode_chunk_kernel
// (bf16 mode) with its batched_location_attention epilogue. The TPU kernel
// keeps both LSTM weight blocks (35.7 MB bf16 at the flagship dims) in VMEM
// for 64 frames and computes each cell's gates as one batched matmul on the
// MXU (jnp.dot(xh, w_s), :469); an H100 SM has 227 KB of shared memory, so
// here each step streams the weights through the whole card:
//
//   t2_prenet              prenet: 2 x (Linear, ReLU, x dropout mask), over
//                          a thread-block cluster that shares the weights
//   t2_lstm_cell           the LSTM cell: gate GEMM on the tensor cores over
//                          a thread-block cluster, the i/f/g/o nonlinearity
//                          and the c/h update fused (gate_cell_kernel)
//   t2_location_attention  query, folded location conv, tanh energies,
//                          masked softmax, context, cumulative weights, over
//                          a thread-block cluster of S blocks per batch row
//   t2_heads               mel + gate linear over [rnn_h | ctx | controls]: a
//                          split-K tensor-core product over a thread-block
//                          cluster
//   t2_decode_chunk        n steps of the four, five launches a step, from
//                          one host call (the decode's main path)
//
// Bound: the LSTM weight bytes over HBM bandwidth (35.7 MB / 3.35 TB/s =
// 10.7 us per step), at every B the decode runs (1 to 64 rows: the 2.3
// GFLOP of a 64-row step take 2.4 us at the bf16 peak). The cell kernel
// reads each weight byte once per step whatever the rows (see its notes
// below). Operands are bf16 (activations rounded as they are staged), sums
// f32, state f32.
//
// The location attention lives in decode_common.cuh, which K3
// (train_decode.cu) shares. The attention is latency of dependent
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
// quantize=True), its _quantize_xh :388 and int8 gate products :466):
//
//   t2_quantize_xh         the cell's f32 input quantised per row (scale
//                          max|x| / 127, round half to even, clip to +-127)
//   t2_lstm_cell_int8      the LSTM cell over int8 weights with one f32 scale
//                          per gate row: the same kernel on the int8 tensor
//                          cores (gate_cell_kernel<true>) over that operand,
//                          sums in int32, scaled back before the fused c/h
//                          update
//   t2_decode_chunk        with int8 weights, the same n steps with the two
//                          LSTM cells on these two kernels instead
//
// Bound: the int8 LSTM weight bytes, 17.8 MB at the flagship dims, over HBM
// bandwidth: 5.3 us per step, half of K1's.
//
// K1's f32 mode, the same TPU kernel with f32 weights (dt = w_s.dtype = f32,
// :386: the JAX package's default policy and every "32-true" model):
//
//   t2_lstm_cell_f32       the LSTM cell over an f32 copy of the weights: the
//                          gate GEMM as a three-pass TF32 split on the tensor
//                          cores with f32 sums over a thread-block cluster
//                          (gate_cell_f32_kernel)
//   t2_prenet_f32          the prenet over f32 weights; with act_bf16 its
//                          activations rounded to bf16 (the int8 mode of an
//                          F32 model, whose prenet and heads weights stay f32)
//   t2_location_attention_f32  the attention over f32 weights and memory
//   t2_heads_f32           the heads over f32 weights, the same three-pass
//                          split over the heads' split-K cluster; act_bf16 as
//                          the prenet's
//   t2_decode_chunk        mode 2: the n steps on these five launches a step;
//                          mode 3 (int8 of an F32 model): K5's cells, the bf16
//                          attention and the f32 prenet and heads, seven
//
// Bound: the f32 LSTM weights, 71.3 MB a step at the flagship dims, over HBM
// bandwidth: 21.3 us at one row; at 64 rows the three passes' 6.8 G tensor
// operations take 14 us at the TF32 peak, under the bytes.
//
// The controls mode of both (the controllable configs, _decode_chunk_kernel's
// controls rows: xh[H + D : H + D + E] = controls :534, the heads' controls @
// w_out[H + D:] :569): the decoder cell's input is [att_h | ctx | controls |
// rnn_h] and the heads' [rnn_h | ctx | controls], the controls zero-padded
// to E = a multiple of 16 columns (whole 16-byte pieces of the bf16 and
// int8 operands; the weights' columns there are zero, as is the gate row's
// over all E: JAX's gate reads [rnn_h | ctx]). The controls are a fourth
// segment of the cell's operand, staged once per decode (a bf16 copy for K1,
// the f32 values that K5's quantize_xh takes into the row's scale). They add
// E = 16 of 2576 columns to the decoder cell and of 1552 to the heads.

#include <algorithm>
#include <type_traits>

#include "decode_common.cuh"
#include "tma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The LSTM cells (K1's lstm_cell, bf16; K5's lstm_cell_int8): one gate GEMM
// gates = xh . W^T + b with the LSTM update fused, on the tensor cores.
//
// Weight rows on M, the batch on N (mma.sync m16n8k16 bf16 / m16n8k32 s8,
// f32 / s32 sums). Chosen over wgmma: the product is bound by the weight
// stream at every B of the path (2.3 GFLOP at 64 rows take 2.4 us at the
// bf16 peak, the 35.7 MB of weights 10.7 us), so the multiply only has to
// keep up; mma.sync takes N in tiles of 8 rows with its fragments loaded
// from shared memory by each warp, so one B = 1 row costs one n8 tile, and
// bf16 and int8 read the same bytes: both fragments are 32-bit words at
// byte 4t and 16 + 4t of a row's 32-byte k-step.
//
// A cluster of GC_S = 2 blocks owns GC_U = 16 hidden units x 4 gates (64
// weight rows; grid (2, H / 16): 128 blocks at H = 1024) and splits the
// contraction: rank r takes the 128-byte column chunks [r nk / 2, (r + 1)
// nk / 2) of the rows (nk = ceil(row bytes / 128): 28 / 40 chunks of the
// bf16 rows R1 = 1792 and R2 = 2560, 14 / 20 of the int8 ones). Pairs,
// because the card runs 66 clusters of 2 at once but only 30 of 4 (read
// with cudaOccupancyMaxActiveClusters at this kernel's shared memory): a
// grid of 32 clusters of 4 ran in two waves. So:
// - each weight byte is read from device memory once per step for any B up
//   to 64 (the server's largest window); past 64 rows the block loops over
//   N tiles of 64 and streams its weights again for each;
// - a block needs its B rows of xh over its half of the columns, as the
//   operand the tensor cores take: K1's bf16 operands are written by their
//   producers (the prenet's output, the attention's context, each cell's
//   h); K5's int8 operand by quantize_xh_kernel, one launch before each K5
//   cell (JAX's _quantize_xh: a row's scale is over all of R, which no
//   block of the split sees; quantised once per step, not by each of the
//   64 clusters; quantising in the prenet's or the attention's epilogue
//   instead made the one-row int8 chunk no faster, PERF.md). The producer
//   warp copies the rows' pieces into shared memory with 1-D bulk copies:
//   at 64 rows the decoder cell's block takes 64 x
//   1280 x 2 B = 164 KB (bf16; 82 KB int8), 35.7 MB of L2 reads a bf16 step
//   over the 64 clusters, as many bytes as the weights;
// - each rank pushes its partial gate sums to the rank that owns the unit
//   (distributed shared memory), one cluster barrier, and the owner adds
//   them in rank order (p0 + p1) + bias and applies the LSTM update of its
//   8 units. No atomics, and nothing in a row's sums depends on B: the
//   chunk split, the k order inside a chunk and the rank order follow the
//   dims alone, and an mma's output element depends only on its own row and
//   column (chip_smoke.py holds rows of a 64-row launch against the rows
//   alone, bit for bit). Gates never reach device memory.
// - int8: quantize_xh takes a row's scale max|x| / 127 over all R from the
//   f32 input and quantises it (round half to even, clip to +-127, true
//   division), one block per row. The int32 sums are exact, so the gates
//   equal the plain version's up to the float epilogue, whose multiplies
//   and add are rounded one by one ((float(acc) sx) ws + b, __fmul_rn /
//   __fadd_rn), in the plain version's order.
//
// The weights come from a copy tiled once per model (pack_decoder, its
// gate_tile_offset is this addressing): for cluster gi, chunk c, its 64
// rows (row gate 16 + u is W's row gate H + 16 gi + u) x 128 bytes, the
// 16-byte piece k of row rr at piece k ^ (rr % 8) (bank-conflict-free
// fragment loads), laid end to end: a block streams one contiguous run.
// One producer warp streams it with 1-D bulk copies (8 KB a chunk) into a
// ring of up to GC_RING = 96 KB under mbarriers (at 64 rows the xh slice
// leaves room for 6 chunks), marked evict-first in L2 (int8 streamed
// without a policy read the one-row int8 chunk within its spread and the
// 64-row one 10 us a step slower, PERF.md). Every cell launches with
// programmatic dependent launch: the kernel before it (in the chunk the
// prenet, the attention or K5's quantize_xh) lets it launch as it starts,
// and it streams its first GC_PREFETCH weight chunks while that kernel runs
// (the weights depend on nothing the step computes), then its xh copies
// after the wait, then the rest. More chunks before the wait queue ahead of
// the xh copies in the copy engine: the whole ring (12 chunks at one row)
// made the one-row bf16 chunk ~4 us a step slower, 1 or 4 chunks no faster
// (chip_smoke.py --k1-ab's cell_ab builds copies of this file with other
// GC_PREFETCH; it changes no result). A cell lets the next launch start
// once its weights are read. Eight consumer warps take an m16 tile of rows
// each over half the n8 tiles.
// Tried on the card and dropped (PERF.md): clusters of 4 (30 fit at once:
// a second wave), xh staged by the consumers from f32, xh boxes by TMA
// beside each weight chunk, xh barriers per 4 chunks, K5 quantising in the
// cell at a few rows.
constexpr int GC_U = 16;                   // hidden units per cluster
constexpr int GC_ROWS = 4 * GC_U;          // weight rows per block
constexpr int GC_S = 2;                    // blocks per cluster: the contraction split
constexpr int GC_CHUNK = GC_ROWS * 128;    // a chunk's weights: 128 bytes of each row
constexpr int GC_RING = 96 * 1024;         // the weight ring's most bytes
constexpr int GC_MAX_STAGES = GC_RING / GC_CHUNK;
constexpr int GC_CONSUMERS = 8;            // warps 0..7 multiply; warp 8 streams
constexpr int GC_THREADS = 32 * (GC_CONSUMERS + 1);
constexpr int GC_NTILE = 64;               // batch rows per pass: 8 n8 tiles
constexpr int GC_MT = GC_ROWS / 16;        // m16 tiles of a block's rows
constexpr int GC_NSPLIT = GC_CONSUMERS / GC_MT;   // warps sharing an m tile
constexpr int GC_NPW = GC_NTILE / 8 / GC_NSPLIT;  // n8 tiles a warp takes at most
constexpr int GC_UPR = GC_U / GC_S;        // units whose LSTM update a rank applies
constexpr int GC_PREFETCH = 2;             // weight chunks streamed before the wait
constexpr int GC_SMEM_MAX = 227 * 1024;
constexpr int kSeg = 4;                    // segments of a cell's input
static_assert(GC_ROWS % 16 == 0 && GC_CONSUMERS % GC_MT == 0 && GC_U % GC_S == 0 &&
                  GC_MAX_STAGES >= 2,
              "the cell kernel's tiling");

// byte offsets of the cell kernel's shared arrays: the ring's barriers and
// xs's; xs (the pass's rows of the xh operand over this rank's chunks, kb
// bytes + 16 of padding a row: conflict-free fragment loads); the partial
// sums pushed to this rank by every rank (4-byte f32 or s32, [rank][gate]
// [unit of this rank][row], pld words a unit); the update's operands,
// loaded before the product (c_in [row][unit], bias and ws [gate][unit]);
// then the weight ring of `stages` chunks: as many as fit, up to GC_RING
// bytes (the depth follows the rows and changes no sum)
struct CellSmem {
  int xs_stride, pld, bars, xs, part, epi, ring, stages, total;
};

__host__ __device__ inline CellSmem cell_smem(int kb, int nrows) {
  CellSmem o;
  o.xs_stride = kb + 16;
  o.pld = nrows + 4;
  o.bars = 0;
  o.xs = (2 * GC_MAX_STAGES + 2) * 8;
  o.part = o.xs + nrows * o.xs_stride;
  o.epi = o.part + GC_S * 4 * GC_UPR * o.pld * 4;
  o.ring = (o.epi + (nrows + 8) * GC_UPR * 4 + 127) & ~127;
  o.stages = (GC_SMEM_MAX - o.ring) / GC_CHUNK;
  if (o.stages > GC_MAX_STAGES) o.stages = GC_MAX_STAGES;
  o.total = o.ring + o.stages * GC_CHUNK;
  return o;
}

// elements of xh in a 128-byte chunk, the chunks of a weight row, and the
// bytes of a rank's xs row (the most chunks a rank takes)
__host__ __device__ inline int cell_cw(bool int8) { return int8 ? 128 : 64; }
__host__ __device__ inline int cell_chunks(int R, bool int8) {
  return (R + cell_cw(int8) - 1) / cell_cw(int8);
}
__host__ __device__ inline int cell_kb(int R, bool int8) {
  return (cell_chunks(R, int8) + GC_S - 1) / GC_S * 128;
}

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 32 bits at byte `byte` of row `row` of a weight chunk (128-byte rows, the
// 16-byte piece k of row r at piece k ^ (r % 8))
__device__ __forceinline__ uint32_t ld_chunk(const uint8_t* chunk, int row, int byte) {
  return *reinterpret_cast<const uint32_t*>(chunk + row * 128 + ((((byte >> 4) ^ row) & 7) << 4) +
                                            (byte & 15));
}

// the weight stream's L2 policy: evict first what it marks
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(GC_CONSUMERS * 32) : "memory");
}

// float4 at column col (a multiple of 4, not crossing a segment) of row b
// of the f32 input [x1 | x2 | x3 | x4] (segments x[i], n[i] floats a row; a
// segment may be empty). The segments are picked with constant indices: an
// index that varies would put the kernel's parameter arrays on the stack
__device__ __forceinline__ float4 input4(const float* const x[kSeg], const int n[kSeg], int b,
                                         int col) {
  static_assert(kSeg == 4, "input4 picks one of four segments");
  const int e0 = n[0], e1 = e0 + n[1], e2 = e1 + n[2];
  const float* p = col < e0   ? x[0] + (size_t)b * n[0] + col
                   : col < e1 ? x[1] + (size_t)b * n[1] + (col - e0)
                   : col < e2 ? x[2] + (size_t)b * n[2] + (col - e1)
                              : x[3] + (size_t)b * n[3] + (col - e2);
  return *reinterpret_cast<const float4*>(p);
}

// K5's quantisation of four inputs with the row's scale sx: clip(round half
// to even(x / sx), -127, 127), true division, as four int8 in a word
__device__ __forceinline__ uint32_t quantize4(float4 v, float sx) {
  auto q = [sx](float x) {
    const float r = rintf(x / sx);
    return (uint32_t)(uint8_t)(int8_t)__float2int_rn(fminf(fmaxf(r, -127.0f), 127.0f));
  };
  return q(v.x) | (q(v.y) << 8) | (q(v.z) << 16) | (q(v.w) << 24);
}

// a cell's xh operand: segment i (n[i] elements of esize bytes a row) at
// x[i], rows pitch[i] bytes apart (bf16: the producers' arrays; K5: the
// parts of quantize_xh's one int8 array). The attention cell reads [prenet |
// ctx | att_h], the decoder cell [att_h | ctx | controls | rnn_h]; an empty
// segment (n = 0) stands for the controls of a model without them.
struct CellOperand {
  const uint8_t* x[kSeg];
  int n[kSeg];
  int pitch[kSeg];
};

__host__ __device__ inline int operand_width(const CellOperand& xo) {
  int R = 0;
  for (int i = 0; i < kSeg; ++i) R += xo.n[i];
  return R;
}

// grid (GC_S, H / GC_U), cluster (GC_S, 1, 1), GC_THREADS threads,
// cell_smem(cell_kb(R), rows of a pass padded to 8).total bytes. wt: the
// tiled copy (see above); xo: the xh operand (bf16, or K5's int8); ws, sx:
// K5's weight-row scales (4H,) and row scales (B,); bias (4H,) f32; c_in,
// h_out, c_out (B, H) f32; h_bf, where given, gets h's bf16 operand (B, H).
template <bool INT8>
__global__ void __launch_bounds__(GC_THREADS, 1)
gate_cell_kernel(const uint8_t* __restrict__ wt, const CellOperand xo,
                 const float* __restrict__ ws, const float* __restrict__ sx,
                 const float* __restrict__ bias, const float* __restrict__ c_in,
                 float* __restrict__ h_out, float* __restrict__ c_out, bf16* __restrict__ h_bf,
                 int B, int H) {
  typedef typename std::conditional<INT8, int, float>::type Acc;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) uint8_t gc_raw[];
  const int ES = INT8 ? 1 : 2, CW = cell_cw(INT8);
  const int R = operand_width(xo), nk = cell_chunks(R, INT8);
  const int rank = (int)cluster.block_rank(), gi = blockIdx.y;
  const int c0 = rank * nk / GC_S, nc = (rank + 1) * nk / GC_S - c0;
  const int nrows = (min(B, GC_NTILE) + 7) & ~7;
  const CellSmem o = cell_smem(cell_kb(R, INT8), nrows);
  const int NS = o.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(gc_raw + o.bars);
  uint64_t* empty = full + GC_MAX_STAGES;
  uint64_t* xs_full = empty + GC_MAX_STAGES;
  uint8_t* xs = gc_raw + o.xs;
  Acc* part = reinterpret_cast<Acc*>(gc_raw + o.part);
  float* cpre = reinterpret_cast<float*>(gc_raw + o.epi);  // [row][unit]
  float* bpre = cpre + nrows * GC_UPR;                     // [gate][unit]
  float* wpre = bpre + 4 * GC_UPR;                         // [gate][unit]
  uint8_t* ring = gc_raw + o.ring;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (B + GC_NTILE - 1) / GC_NTILE;
  const int lo = c0 * CW, hi = min(R, (c0 + nc) * CW);  // this rank's columns of xh
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, GC_CONSUMERS);
    }
    mbar_init(xs_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == GC_CONSUMERS) {
    // producer: chunk it of the run (it % nc of pass it / nc) into stage
    // it % NS once its last use is done (lane 0; the first GC_PREFETCH, at
    // most NS, before the wait for the previous kernel); the pass's rows of
    // xh over [lo, hi), a row's piece of each segment by 1-D bulk copies
    // into xs (all lanes). The warp joins the passes' cluster syncs, so it
    // issues a pass's copies only within that pass.
    const uint8_t* wb = wt + ((size_t)gi * nk + c0) * GC_CHUNK;
    const uint64_t policy = evict_first_policy();
    auto issue = [&](int it) {
      const int s = it % NS;
      mbar_expect_tx(full + s, GC_CHUNK);
      bulk_load(ring + s * GC_CHUNK, wb + (size_t)(it % nc) * GC_CHUNK, GC_CHUNK, full + s,
                policy);
    };
    const int early = min(min(GC_PREFETCH, NS), nc);
    if (lane == 0)
      for (int it = 0; it < early; ++it) issue(it);
    pdl_wait();
    for (int tile = 0; tile < ntiles; ++tile) {
      const int b0 = tile * GC_NTILE, bt = min(GC_NTILE, B - b0);
      if (lane == 0) mbar_expect_tx(xs_full, (uint32_t)(bt * (hi - lo) * ES));
      __syncwarp();
      for (int b = lane; b < bt; b += 32)
        for (int i = 0, seg = 0; i < kSeg; seg += xo.n[i], ++i) {
          const int a = max(lo, seg), e = min(hi, seg + xo.n[i]);
          if (a < e)
            bulk_load(xs + (size_t)b * o.xs_stride + (a - lo) * ES,
                      xo.x[i] + (size_t)(b0 + b) * xo.pitch[i] + (size_t)(a - seg) * ES,
                      (uint32_t)((e - a) * ES), xs_full);
        }
      if (lane == 0)
        for (int it = max(tile * nc, early); it < (tile + 1) * nc; ++it) {
          if (it >= NS) mbar_wait(empty + it % NS, ((it / NS) & 1) ^ 1);
          issue(it);
        }
      __syncwarp();
      cluster.sync();  // the pass's partial sums are pushed
      if (tile + 1 < ntiles) cluster.sync();  // and summed
    }
    return;
  }

  // consumers
  pdl_wait();
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  const int row = (warp % GC_MT) * 16 + g, nq = warp / GC_MT;  // n8 tiles nq + GC_NSPLIT j
  // columns of the last chunk past R read as zero (the weights' pad is
  // zero; xs must not hold a NaN there)
  const int tail = nc * 128 - (hi - lo) * ES;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int b0 = tile * GC_NTILE, bt = min(GC_NTILE, B - b0), ntl = (bt + 7) >> 3;
    // the update's operands, in flight while the product runs
    for (int i = tid; i < bt * GC_UPR; i += GC_CONSUMERS * 32) {
      const int b = i / GC_UPR, ul = i - b * GC_UPR;
      cpre[i] = c_in[(size_t)(b0 + b) * H + gi * GC_U + rank * GC_UPR + ul];
    }
    for (int i = tid; i < 4 * GC_UPR; i += GC_CONSUMERS * 32) {
      const int wrow = (i / GC_UPR) * H + gi * GC_U + rank * GC_UPR + i % GC_UPR;
      bpre[i] = bias[wrow];
      if (INT8) wpre[i] = ws[wrow];
    }
    if (tail > 0) {
      for (int i = tid; i < ntl * 8 * (tail / 4); i += GC_CONSUMERS * 32) {
        const int b = i / (tail / 4), q = i - b * (tail / 4);
        *reinterpret_cast<uint32_t*>(xs + (size_t)b * o.xs_stride + (hi - lo) * ES + q * 4) = 0u;
      }
      bar_consumers();
    }
    mbar_wait(xs_full, tile & 1);

    // the product over this rank's chunks: warp w -> rows 16 (w % GC_MT) +
    // 0..15, n8 tiles w / GC_MT + GC_NSPLIT j of the pass; k in chunk
    // order, 4 k-steps of 32 bytes a chunk
    Acc acc[GC_NPW][4];
#pragma unroll
    for (int j = 0; j < GC_NPW; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0;
    for (int kc = 0; kc < nc; ++kc) {
      const int it = tile * nc + kc, s = it % NS;
      mbar_wait(full + s, (it / NS) & 1);
      const uint8_t* wc = ring + s * GC_CHUNK;
      const uint8_t* xc = xs + kc * 128 + t4;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int byte = ks * 32 + t4;
        const uint32_t a0 = ld_chunk(wc, row, byte), a1 = ld_chunk(wc, row + 8, byte);
        const uint32_t a2 = ld_chunk(wc, row, byte + 16), a3 = ld_chunk(wc, row + 8, byte + 16);
#pragma unroll
        for (int j = 0; j < GC_NPW; ++j) {
          const int n = nq + GC_NSPLIT * j;
          if (n < ntl) {
            const uint8_t* xr = xc + (size_t)(n * 8 + g) * o.xs_stride + ks * 32;
            const uint32_t bb0 = *reinterpret_cast<const uint32_t*>(xr);
            const uint32_t bb1 = *reinterpret_cast<const uint32_t*>(xr + 16);
            if constexpr (INT8) mma_s8(acc[j], a0, a1, a2, a3, bb0, bb1);
            else mma_bf16(acc[j], a0, a1, a2, a3, bb0, bb1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);  // the stage is read: free it
    }
    pdl_trigger();  // the weights are read: the next launch may start streaming
    // push each partial sum to the rank that applies its unit's update:
    // row gate GC_U + u -> rank u / GC_UPR, slot [this rank][gate][u % GC_UPR]
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int gate = (row + 8 * h8) / GC_U, u = (row + 8 * h8) % GC_U;
      Acc* dst = cluster.map_shared_rank(part, u / GC_UPR) +
                 ((rank * 4 + gate) * GC_UPR + u % GC_UPR) * o.pld;
#pragma unroll
      for (int j = 0; j < GC_NPW; ++j) {
        const int n = nq + GC_NSPLIT * j;
        if (n < ntl) {
          const int col = n * 8 + (lane & 3) * 2;
          dst[col] = acc[j][2 * h8];
          dst[col + 1] = acc[j][2 * h8 + 1];
        }
      }
    }
    cluster.sync();

    // the LSTM update of this rank's GC_UPR units: the ranks' partial sums
    // in rank order, + bias (int8: scaled back first)
    for (int i = tid; i < GC_UPR * bt; i += GC_CONSUMERS * 32) {
      const int b = i / GC_UPR, ul = i - b * GC_UPR, j = gi * GC_U + rank * GC_UPR + ul;
      float gv[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        Acc v = part[(gate * GC_UPR + ul) * o.pld + b];
#pragma unroll
        for (int p = 1; p < GC_S; ++p) v += part[((p * 4 + gate) * GC_UPR + ul) * o.pld + b];
        if constexpr (INT8)
          gv[gate] = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(v), sx[b0 + b]), wpre[gate * GC_UPR + ul]),
              bpre[gate * GC_UPR + ul]);
        else
          gv[gate] = v + bpre[gate * GC_UPR + ul];
      }
      const size_t oo = (size_t)(b0 + b) * H + j;
      const float c = sigmoid_f(gv[1]) * cpre[i] + sigmoid_f(gv[0]) * tanhf(gv[2]);
      const float hv = sigmoid_f(gv[3]) * tanhf(c);
      c_out[oo] = c;
      h_out[oo] = hv;
      if (h_bf) h_bf[oo] = __float2bfloat16_rn(hv);
    }
    if (tile + 1 < ntiles) cluster.sync();  // no rank pushes the next pass's sums early
  }
}

// K5's operand: row b of the f32 input [x1 | x2 | x3 | x4] (n_i % 4 == 0;
// the decoder cell's [att_h | ctx | controls | rnn_h], the attention cell's
// with no controls) quantised over all of R, the controls included (scale
// max|x| / 127 from the f32 values, q = clip(round_half_even(x / scale),
// -127, 127), true division) into xq (B, R) int8 and sx (B,). grid B, 256
// threads. Launched with programmatic
// dependent launch (it waits for the previous kernel before it reads or
// writes; after the attention, which lets it start at once, its launch
// overlaps the attention: the int8 chunk read ~1 us a step faster with the
// host's launches at one row, 1.3-3 at 16 rows, chip_smoke.py --k1-ab);
// the next launch (the cell) may start at once and stream its weights.
struct QuantInput {
  const float* x[kSeg];
  int n[kSeg];
};

__global__ void __launch_bounds__(256) quantize_xh_kernel(const QuantInput in,
                                                          int8_t* __restrict__ xq,
                                                          float* __restrict__ sx) {
  pdl_trigger();
  pdl_wait();
  __shared__ float red[32];
  const float* const x[kSeg] = {in.x[0], in.x[1], in.x[2], in.x[3]};
  const int n[kSeg] = {in.n[0], in.n[1], in.n[2], in.n[3]};
  const int b = blockIdx.x, R = n[0] + n[1] + n[2] + n[3];
  float m = 0.0f;
  for (int k = threadIdx.x * 4; k < R; k += blockDim.x * 4) {
    const float4 v = input4(x, n, b, k);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  const float s = fmaxf(block_reduce(m, red, true), 1e-12f) / 127.0f;
  for (int k = threadIdx.x * 4; k < R; k += blockDim.x * 4)
    *reinterpret_cast<uint32_t*>(xq + (size_t)b * R + k) = quantize4(input4(x, n, b, k), s);
  if (threadIdx.x == 0) sx[b] = s;
}

// The prenet (K1's first launch of a step; _decode_chunk_kernel's phase 0,
// decoder_loop_pallas.py:436-445): out = relu(bf16(relu(bf16(mel) W1) m1)
// W2) m2, M = 80 -> P = 256 -> 256, bf16 weights (172 KB), f32 sums.
// Bound: its bytes, 0.05 us at one row; what it costs is latency, and it is
// on every step's critical path.
//
// A cluster of PN_S = 8 blocks takes a group of up to PN_THREADS / U rows
// (8 at P = 256), one cluster per group above that; block (rank) r owns the
// U = P / PN_S units [r U, (r + 1) U) of both layers. It bulk-copies its
// slice of both weights, (M + P) x U bf16 (21 KB at the flagship dims) as
// [k / 4][u][4] (a unit's 4 consecutive weights one 8-byte load), laid end
// to end by a copy tiled once per model (pack_decoder, tile_prenet),
// into shared memory under one mbarrier. It launches without programmatic
// dependent launch: in the chunk, launched with it after the heads, its
// copy overlapping their end, it gained nothing measurable (PERF.md).
// Thread (row, u) computes its unit's layer-1 sum for its row, pushes
// bf16(relu(sum) m1) (as JAX rounds it) into every rank's h1 over
// distributed shared memory, and after one cluster barrier its layer-2 sum
// from its own shared memory. Each output's sum is one fmaf chain, k = 0 ..
// M - 1, then 0 .. P - 1, whatever B or the split: a row's output does not
// depend on the rows or the cluster it shares a launch with (chip_smoke.py
// holds rows of a 64-row launch against the rows alone). Its time is
// latency: the launch, the copy, two cluster barriers and the chains (336
// dependent fmaf), whatever the rows up to 8 a group.
// OPERAND (the chunk's launches, bf16 mode): let the LSTM cell after it
// start at once (pdl_trigger) and write its operand, the output's bf16
// copy, into out_bf; without, the output alone (the one-kernel entry and
// int8 mode). grid (PN_S, ceil(B / rows a group)), cluster (PN_S, 1, 1),
// block PN_THREADS; mel rows are ldm floats apart.
// K1's f32 mode (prenet_kernel<false, float, ...>): the same kernel over an
// f32 copy of the weights (float4 loads, 43 KB a block at the flagship
// dims), OPERAND false. RND: round the mel and h1 to bf16 before their
// products, as the bf16 mode and the int8 mode of an F32 model do (the JAX
// kernel's x.astype(dt) with dt = bf16 on f32 weights, :441-444: the
// ACT_BF16 entry); without, nothing is rounded (dt = f32).
constexpr int PN_S = 8;          // blocks per cluster: the units' split
constexpr int PN_THREADS = 256;  // a block: (rows of the group) x U

// shared memory of one block: its mbarrier, the weight slice (esize bytes
// a weight: 2 bf16, 4 f32), the group's mel and h1 (f32 values)
inline size_t prenet_smem(int M, int P, int esize = 2) {
  const int U = P / PN_S, rows = PN_THREADS / U;
  return 16 + (size_t)(M + P) * U * esize + (size_t)rows * (M + P) * 4;
}

// acc + x[4 i + j] w[4 i + j] over i < n4, j < 4, as one fmaf chain in that
// order: x 4 floats a load, w a unit's bf16 weights 4 a load (uint2, ld
// apart), the next PN_G loads issued while the chain takes the current ones,
// so that it runs near the fmaf's latency, not the loads' or the issue's
constexpr int PN_G = 4;
__device__ __forceinline__ float fma4(float acc, const float4& x, const uint2& w) {
  acc = fmaf(x.x, __uint_as_float(w.x << 16), acc);
  acc = fmaf(x.y, __uint_as_float(w.x & 0xffff0000u), acc);
  acc = fmaf(x.z, __uint_as_float(w.y << 16), acc);
  return fmaf(x.w, __uint_as_float(w.y & 0xffff0000u), acc);
}

// the same over 4 f32 weights (the f32 prenet's float4 loads)
__device__ __forceinline__ float fma4(float acc, const float4& x, const float4& w) {
  acc = fmaf(x.x, w.x, acc);
  acc = fmaf(x.y, w.y, acc);
  acc = fmaf(x.z, w.z, acc);
  return fmaf(x.w, w.w, acc);
}

template <typename W4>
__device__ __forceinline__ float fmaf_chain(const float4* __restrict__ x,
                                            const W4* __restrict__ w, int ld, int n4) {
  float acc = 0.0f;
  float4 xa[PN_G];
  W4 wa[PN_G];
  const int nb = n4 - n4 % PN_G;
  if (nb > 0) {
#pragma unroll
    for (int i = 0; i < PN_G; ++i) {
      xa[i] = x[i];
      wa[i] = w[i * ld];
    }
#pragma unroll 2
    for (int k = PN_G; k < nb; k += PN_G) {
      float4 xb[PN_G];
      W4 wb[PN_G];
#pragma unroll
      for (int i = 0; i < PN_G; ++i) {
        xb[i] = x[k + i];
        wb[i] = w[(k + i) * ld];
      }
#pragma unroll
      for (int i = 0; i < PN_G; ++i) {
        acc = fma4(acc, xa[i], wa[i]);
        xa[i] = xb[i];
        wa[i] = wb[i];
      }
    }
#pragma unroll
    for (int i = 0; i < PN_G; ++i) acc = fma4(acc, xa[i], wa[i]);
  }
  for (int k = nb; k < n4; ++k) acc = fma4(acc, x[k], w[k * ld]);
  return acc;
}

template <bool OPERAND, typename W = bf16, bool RND = true>
__global__ void __launch_bounds__(PN_THREADS) prenet_kernel(
    const float* __restrict__ mel, const W* __restrict__ wt, const float* __restrict__ m1,
    const float* __restrict__ m2, float* __restrict__ out, bf16* __restrict__ out_bf, int B, int M,
    int P, int ldm) {
  typedef typename std::conditional<std::is_same<W, float>::value, float4, uint2>::type W4;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint8_t pn_raw[];
  const int U = P / PN_S, rows = PN_THREADS / U, rank = (int)cluster.block_rank();
  const uint32_t w_bytes = (uint32_t)(M + P) * U * sizeof(W);
  uint64_t* bar = reinterpret_cast<uint64_t*>(pn_raw);
  // [k / 4][u][4], k < M layer 1, then layer 2
  const W4* w4 = reinterpret_cast<const W4*>(pn_raw + 16);
  float* xs = reinterpret_cast<float*>(pn_raw + 16 + w_bytes);  // rows x M
  float* hs = xs + rows * M;                                     // rows x P
  const int tid = threadIdx.x, row = tid / U, u = tid - row * U;
  const int r0 = blockIdx.y * rows, b = r0 + row, unit = rank * U + u;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, w_bytes);
    bulk_load(pn_raw + 16, wt + (size_t)rank * (M + P) * U, w_bytes, bar);
  }
  if (OPERAND) pdl_trigger();
  // this block has started: the ranks may write its h1 once all have
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const float k1 = b < B ? m1[(size_t)b * P + unit] : 0.0f;
  const float k2 = b < B ? m2[(size_t)b * P + unit] : 0.0f;
  const int live = min(rows, B - r0);  // the group's rows in [0, B)
  for (int i = tid; i < live * M; i += PN_THREADS) {
    const int rr = i / M;
    const float v = mel[(size_t)(r0 + rr) * ldm + i - rr * M];
    xs[i] = RND ? rnd_bf16(v) : v;
  }
  __syncthreads();
  mbar_wait(bar, 0);
  float h = 0.0f;
  if (b < B) {
    const float4* x = reinterpret_cast<const float4*>(xs + row * M);
    const float v = fmaxf(fmaf_chain(x, w4 + u, U, M / 4), 0.0f) * k1;
    h = RND ? rnd_bf16(v) : v;
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (b < B)  // rows past B are neither computed nor read
    for (int p = 0; p < PN_S; ++p) cluster.map_shared_rank(hs, p)[row * P + unit] = h;
  cluster.sync();  // every rank's h1 is whole
  if (b < B) {
    const float4* x = reinterpret_cast<const float4*>(hs + row * P);
    const float v = fmaxf(fmaf_chain(x, w4 + M / 4 * U + u, U, P / 4), 0.0f) * k2;
    out[(size_t)b * P + unit] = v;
    if (OPERAND) out_bf[(size_t)b * P + unit] = __float2bfloat16_rn(v);
  }
}

// The heads (K1's last launch of a step; _decode_chunk_kernel's mel and
// gate linear, decoder_loop_pallas.py:565-571): out = [x1 | x2 | x3] (bf16)
// . W_out^T + b_out over [rnn_h | ctx | controls], N = M + 1 = 81 outputs,
// K = H + D (+ E) = 1,536 (1,552) columns, bf16 weights (249 KB), f32 sums.
// Bound: its bytes, 0.08 us at one row, 0.20 at 64; what it costs is
// latency, on every step's critical path.
//
// The weight rows go on M (N padded to NP = 96: six m16 tiles), the batch
// on N (n8 tiles), on the tensor cores with mma.sync m16n8k16, as the cells
// (see their notes: the product is bound by the weight stream, and one
// batch row costs one n8 tile). A cluster of HD_S = 8 blocks splits the
// contraction in 16-column pieces: rank r takes the pieces [r nk / HD_S,
// (r + 1) nk / HD_S) (nk = K / 16: 12 each at 1,536, 12 or 13 at 1,552), by
// the dims alone. Each rank bulk-copies its slice of W_out, NP rows x its
// pieces, one contiguous run of the copy tiled once per model
// (pack_decoder, tile_heads: [piece][row][32 bytes], the 16-byte half h of
// row r at half h ^ ((r >> 2) & 1), so that the fragment loads are
// conflict-free), and stages and converts only its own columns of the f32
// inputs. So each weight byte is read once per launch for up to HD_NTILE =
// 64 rows (a further 64-row tile is a cluster of its own). Each rank pushes
// its partial sums of n8 tile n to rank n % HD_S over distributed shared
// memory; after one cluster barrier that owner adds them in rank order,
// then the bias. A row's output is ((p_0 + p_1) + ... + p_7) + b whatever B
// or the rows it shares a launch with: the pieces, their order and the
// rank order follow the dims, and an mma's output element depends only on
// its own row and column (chip_smoke.py holds rows of 64- and 80-row
// launches against the rows alone, bit for bit). The gate's row is zero
// over the controls' columns, a whole piece of zero products, so the gate
// logits do not move with the controls.
// HD_PDL: launched with programmatic dependent launch, the weight copy
// issued before pdl_wait, while the decoder cell ends: the chunk read
// 0.4-1.0 us a step faster than without at 1, 16 and 64 rows, bf16 and
// int8 (chip_smoke.py --k1-rows --cell-ab, PERF.md).
constexpr int HD_S = 8;                       // blocks per cluster: the contraction split
constexpr int HD_WARPS = 12;                  // (m16 tile, half of the n8 tiles) a warp
constexpr int HD_THREADS = 32 * HD_WARPS;
constexpr int HD_NTILE = 64;                  // batch rows per cluster: 8 n8 tiles
constexpr int HD_NT = HD_NTILE / 8;
constexpr int HD_OWN = (HD_NT + HD_S - 1) / HD_S;  // n8 tiles whose sums a rank adds
constexpr bool HD_PDL = true;

// byte offsets of a heads block's shared arrays: its mbarrier; the weight
// slice (npmax pieces x NP rows x 32 bytes); the staged input (HD_NTILE
// rows of npmax x 32 bytes + 16 of padding: conflict-free fragment loads);
// the partial sums pushed to this rank, [rank][owned tile][column][row],
// rows NP + 4 apart
struct HeadsSmem {
  int ws, xs, xs_stride, part, pld, total;
};

__host__ __device__ inline HeadsSmem heads_smem(int NP, int npmax) {
  HeadsSmem o;
  o.ws = 16;
  o.xs = o.ws + npmax * NP * 32;
  o.xs_stride = npmax * 32 + 16;
  o.part = o.xs + HD_NTILE * o.xs_stride;
  o.pld = NP + 4;
  o.total = o.part + HD_S * HD_OWN * 8 * o.pld * 4;
  return o;
}

// 32 bits at byte `byte` (< 32) of row `row` of local piece j of a heads
// weight slice
__device__ __forceinline__ uint32_t ld_piece(const uint8_t* ws, int NP, int j, int row,
                                             int byte) {
  return *reinterpret_cast<const uint32_t*>(ws + (j * NP + row) * 32 +
                                            ((((byte >> 4) ^ (row >> 2)) & 1) << 4) + (byte & 15));
}

// grid (HD_S, ceil(B / HD_NTILE)), cluster (HD_S, 1, 1), HD_THREADS threads,
// heads_smem(NP, ceil(nk / HD_S)).total bytes. wt: the tiled copy (see
// above); bias (N,) f32; x1, x2, x3 (B, n_i) f32 (n_i % 16 == 0; x3 the
// controls, n3 = 0 without); out (B, N) f32.
__global__ void __launch_bounds__(HD_THREADS)
heads_kernel(const uint8_t* __restrict__ wt, const float* __restrict__ bias,
             const float* __restrict__ x1, int n1, const float* __restrict__ x2, int n2,
             const float* __restrict__ x3, int n3, float* __restrict__ out, int B, int N) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) uint8_t hd_raw[];
  const int nk = (n1 + n2 + n3) / 16, NP = (N + 15) & ~15, MT = NP / 16;
  const int rank = (int)cluster.block_rank();
  const int p0 = rank * nk / HD_S, np = (rank + 1) * nk / HD_S - p0;
  const HeadsSmem o = heads_smem(NP, (nk + HD_S - 1) / HD_S);
  uint64_t* bar = reinterpret_cast<uint64_t*>(hd_raw);
  const uint8_t* ws = hd_raw + o.ws;
  uint8_t* xs = hd_raw + o.xs;
  float* part = reinterpret_cast<float*>(hd_raw + o.part);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.y * HD_NTILE, bt = min(HD_NTILE, B - b0), ntl = (bt + 7) >> 3;
  if (tid == 0) {
    const uint32_t bytes = (uint32_t)np * NP * 32;
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, bytes);  // a rank with no piece (nk < HD_S) adds zeros
    if (bytes) bulk_load(hd_raw + o.ws, wt + (size_t)p0 * NP * 32, bytes, bar);
  }
  // this block has started: the ranks may push into its partial sums once
  // all have
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  pdl_wait();  // with HD_PDL: the inputs are the launch before's outputs
  // this rank's columns [16 p0, 16 (p0 + np)) of the tile's rows, as bf16
  const int q4 = np * 4, c0 = p0 * 16;  // float4s of a row
  for (int i = tid; i < bt * q4; i += HD_THREADS) {
    const int b = i / q4, q = i - b * q4, col = c0 + 4 * q, row = b0 + b;
    const float* src = col < n1        ? x1 + (size_t)row * n1 + col
                       : col < n1 + n2 ? x2 + (size_t)row * n2 + (col - n1)
                                       : x3 + (size_t)row * n3 + (col - n1 - n2);
    const float4 v = *reinterpret_cast<const float4*>(src);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(xs + (size_t)b * o.xs_stride + q * 8) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
  __syncthreads();
  mbar_wait(bar, 0);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // warp task: m16 tile mt of the rows, n8 tiles nh + 2 i of the batch; k
  // in piece order. Then each n8 tile's sums to its owner, rank n % HD_S,
  // slot [this rank][n / HD_S][column][row]
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  for (int task = warp; task < 2 * MT; task += HD_WARPS) {
    const int mt = task % MT, nh = task / MT, row = mt * 16 + g;
    float acc[HD_NT / 2][4];
#pragma unroll
    for (int i = 0; i < HD_NT / 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    for (int j = 0; j < np; ++j) {
      const uint32_t a0 = ld_piece(ws, NP, j, row, t4), a1 = ld_piece(ws, NP, j, row + 8, t4);
      const uint32_t a2 = ld_piece(ws, NP, j, row, 16 + t4);
      const uint32_t a3 = ld_piece(ws, NP, j, row + 8, 16 + t4);
#pragma unroll
      for (int i = 0; i < HD_NT / 2; ++i) {
        const int n = nh + 2 * i;
        if (n < ntl) {
          const uint8_t* xr = xs + (size_t)(n * 8 + g) * o.xs_stride + j * 32 + t4;
          mma_bf16(acc[i], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(xr),
                   *reinterpret_cast<const uint32_t*>(xr + 16));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < HD_NT / 2; ++i) {
      const int n = nh + 2 * i;
      if (n < ntl) {
        float* dst = cluster.map_shared_rank(part, n % HD_S) +
                     (rank * HD_OWN + n / HD_S) * 8 * o.pld;
        const int col = (lane & 3) * 2;
        dst[col * o.pld + row] = acc[i][0];
        dst[(col + 1) * o.pld + row] = acc[i][1];
        dst[col * o.pld + row + 8] = acc[i][2];
        dst[(col + 1) * o.pld + row + 8] = acc[i][3];
      }
    }
  }
  cluster.sync();  // every partial sum is pushed

  // the owner: the ranks' partial sums in rank order, then the bias
  for (int i = tid; i < HD_OWN * 8 * N; i += HD_THREADS) {
    const int own = i / (8 * N), rem = i - own * 8 * N, c = rem / N, m = rem - c * N;
    const int n = own * HD_S + rank, b = n * 8 + c;
    if (n >= ntl || b >= bt) continue;
    const float* s = part + (own * 8 + c) * o.pld + m;
    float v = s[0];
#pragma unroll
    for (int p = 1; p < HD_S; ++p) v += s[(size_t)p * HD_OWN * 8 * o.pld];
    out[(size_t)(b0 + b) * N + m] = v + bias[m];
  }
}

// ---------------------------------------------------------------------------
// K1's f32 mode (the JAX kernel with f32 weights: dt = w_s.dtype = f32,
// decoder_loop_pallas.py:386, the mode of every model whose precision is
// "32-true" or "32"): every product takes f32 operands with f32 sums.
//
// The products f32 keeps run on the tensor cores as a three-pass TF32 split
// (the route of csrc/mrf_f32.cu): each f32 value x is split into hi =
// cvt.rna.tf32.f32(x) and lo = the same of x - hi (tf32_split), and each
// product is w_hi a_lo + w_lo a_hi + w_hi a_hi, issued in that order (the
// small terms first), with f32 sums; the lo lo term (~2^-22 of the product)
// is left out. The tensor cores' f32 accumulation truncates and its bias
// grows with the number of accumulations, so each 64-column group's products
// go into their own accumulators and are added, rounded to nearest, into the
// running sums. CF_PASSES / HF_PASSES name the passes (1 w_hi a_lo, 2 w_lo
// a_hi, 4 w_hi a_hi), and cf_op is where the cell takes its operands: the
// smoke's planted defects are copies of this source with passes left out or
// the operands rounded there.
//
// The f32 LSTM cell (t2_lstm_cell_f32). Bound: its weights, 71.3 MB a step
// at the flagship dims (twice the bf16 cell's), 21.3 us over HBM for any B
// up to 64; the three passes of 64 rows are 6.8 G tensor operations, 14 us
// at wgmma's TF32 peak. The design is the bf16 cell's (gate_cell_kernel
// above), in f32:
// - a cluster of CF_S = 2 blocks owns CF_U = 16 hidden units x 4 gates (64
//   weight rows, one m16 tile a gate; grid (2, H / 16), 128 blocks at H =
//   1024) and splits the contraction in 64-column chunks (rank r the chunks
//   [r nk / 2, (r + 1) nk / 2), nk = ceil(R / 64): 14 / 20 each of R1 =
//   1792 and R2 = 2560), so each weight byte is read once per step for up to
//   64 rows (past 64 a block streams its weights again per 64-row pass);
// - weight rows on M, the batch on N; two consumer warpgroups, warpgroup kh
//   the half kh of each chunk's k8 steps over every n8 tile of the pass (the
//   halves' sums added, half 0 + half 1, once a pass), warp w of it the m16
//   tile w % 4 (gate w % 4) as the product's A registers, so that all eight
//   warps work at one row. An instance of the kernel a row count (NT = 1, 2
//   or 8 n8 tiles): at 1 to 16 rows mma.sync m16n8k8 tf32, one n8 tile a row
//   group, the input's fragments split in registers as they load; past 16
//   rows wgmma m64n64k8 tf32 a pass and step, each warpgroup splitting its
//   half of the chunk's input into hi and lo planes in shared memory (wgmma
//   takes B only from there; a 16-byte store a core matrix's row), one
//   barrier of its 128 threads, then the wgmma. The two give the same sums,
//   bit for bit (the tensor cores' k8 step is the same), so a row's output
//   does not follow the instance. mma.sync at every row count read the
//   cells at 30.5 / 47.5 / 107.4 us at 1 / 16 / 64 rows, wgmma at every row
//   count 49.2 / 54.8 / 80.3 (chip_smoke.py's K1F_CELL_AB, mma_only and
//   wgmma_only, NVIDIA H100 80GB HBM3, 700.00 W): the planes' split and
//   barriers cost more than wgmma saves at a few rows;
// - the weights come from a copy tiled once per model (pack_decoder,
//   tile_gates_f32) in the fragments' order: for cluster gi, chunk c, m16
//   tile mt, k8 step s, lane l, its four A registers side by side (one
//   16-byte load a lane a step, conflict-free; wgmma's A registers take
//   mma.sync's m16n8k8 layout per warp); within a k16 pair of steps lane (g,
//   t) takes columns 4t .. 4t + 3, step 2q + h the columns 16q + 4t + 2h (k =
//   t) and 16q + 4t + 2h + 1 (k = t + 4), so that the input's fragment of a
//   pair is one 16-byte load too (the k order inside a step is the
//   hardware's; it follows the dims alone);
// - a producer warp streams the weights with 1-D bulk copies (16 KB a
//   chunk, evict-first) into a ring under mbarriers, its first CF_PREFETCH
//   chunks before griddepcontrol.wait (the weights depend on nothing the
//   step computes); and the input, beside each weight chunk in its ring
//   stage: the pass's rows of [x1 | x2 | xc | x3] over the chunk's 64
//   columns. A stage's mbarrier counts two arrivals, the weights' and the
//   input's, so nothing but its phase separates the consumers from the
//   producer: no consumer staging of the input from device memory. The copy
//   holds f32 values, not hi / lo planes: both planes would double the 71.3
//   MB that bound a step at one row;
// - the 64-row input: the f32 input is 10 KB a row for the decoder cell; a
//   rank's half of its columns is 327 KB at 64 rows, past a block's 227 KB,
//   so it cannot stay resident as the bf16 cell's operand does. Taken: the
//   input streamed in the ring beside each weight chunk (its L2 reads at 64
//   rows, 71 MB a step over the two cells, as many bytes as the weights),
//   by a bulk copy a row and segment up to CF_ROW_COPIES = 16 rows and above
//   by TMA boxes of 16 columns x the pass's rows, a map a segment made on the
//   host at each launch (cell_boxes). Both cells at 1 / 16 / 64 rows
//   (K1F_CELL_AB's input_rows and input_boxes, the same card): row copies
//   30.6 / 46.6 / 109.5 us, boxes 66.5 / 68.5 / 79.9 (a box's cost hardly
//   follows its rows). Not built: passes of 32 rows with the
//   input resident (the weights read twice at 64 rows, +21 us of HBM), and
//   an input chunk multicast over a cluster of ranks that share its columns
//   (clusters of 4 run 30 at once, a second wave; see the bf16 cell's notes);
// - each rank pushes its partial gate sums to the rank that owns the unit
//   (distributed shared memory), one cluster barrier, and the owner adds
//   them in rank order (p0 + p1) + bias and applies the LSTM update of its 8
//   units; gates never reach device memory. A row's sums follow the dims
//   alone, never B: the chunk split, the k order and halves, the passes, the
//   per-chunk accumulators (k8 steps of even and odd h apart, then (even +
//   odd) into the running sums) and the rank order follow (H, R), and a
//   product's output element depends only on its own row and column
//   (chip_smoke.py holds rows of a 64-row launch and the last of an 80-row
//   one against the rows alone, bit for bit).
// Readings (both cells, in turns against the FFMA design it replaced, NVIDIA
// H100 80GB HBM3, 700.00 W, chip_smoke.py --k1-f32-ab): 30.8 / 48.0 / 80.2
// us at 1 / 16 / 64 rows (was 78.0 / 94.1 / 155.9; nn.LSTMCell x2 f32 41.7 /
// 83.6 / 99.0). At one row the ring's bytes bound it (no product: 27.2, the
// bytes 21.3); at 16 rows the input's row copies and the product (no product
// 36.1, one pass 45.8); at 64 rows the split into planes and the input's
// boxes (no product 71.0, one pass 76.1).
constexpr int CF_U = 16;                            // hidden units per cluster
constexpr int CF_ROWS = 4 * CF_U;                   // weight rows per block: an m16 tile a gate
constexpr int CF_S = 2;                             // blocks per cluster: the contraction split
constexpr int CF_KC = 64;                           // columns of a chunk: 8 k8 steps
constexpr int CF_CHUNK = CF_ROWS * CF_KC * 4;       // a chunk's weight bytes
constexpr int CF_CONSUMERS = 8;                     // warps 0..7 multiply; warp 8 streams
constexpr int CF_THREADS = 32 * (CF_CONSUMERS + 1);
constexpr int CF_NTILE = 64;                        // batch rows per pass
constexpr int CF_NT = CF_NTILE / 8;                 // its n8 tiles
constexpr int CF_MT = CF_ROWS / 16;                 // m16 tiles of a block's rows
constexpr int CF_XS = CF_KC + 16;                   // floats of an input row copied by rows
constexpr int CF_ROW_COPIES = 16;                   // most rows whose input is copied by rows
constexpr int CF_UPR = CF_U / CF_S;                 // units whose LSTM update a rank applies
constexpr int CF_PREFETCH = 4;                      // weight chunks streamed before the wait
constexpr int CF_MAX_STAGES = 12;                   // the ring's most stages
constexpr int CF_PASSES = 7;                        // 1 w_hi a_lo, 2 w_lo a_hi, 4 w_hi a_hi
static_assert(CF_U == 16 && CF_S == 2 && CF_UPR == 8,
              "an m16 tile's rows g and g + 8 are units g and g + 8: ranks 0 and 1");
static_assert(CF_CONSUMERS == 2 * CF_MT && CF_KC % 32 == 0 && CF_XS % 32 == 16,
              "the f32 cell's tiling: two k halves an m16 tile");

__device__ __forceinline__ float cf_op(float x) { return x; }

// x rounded to TF32, to nearest, ties away from zero, the low 13 bits zero:
// cvt.rna.tf32.f32 of a finite x as one add and a mask, the same bits (the
// instruction itself read the cells 1.08x slower at one row and 1.02x at 16,
// 0.96x at 64: K1F_CELL_AB's split_cvt)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x -> hi = tf32_rna(x) and lo = tf32_rna(x - hi), as mma operands
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the passes of one k8 step into c: A the weights' fragment (4 f32 values),
// B the input's (2), each split as it is taken; PASSES picks them
template <int PASSES>
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t wh[4], const uint32_t wl[4],
                                           float b0, float b1) {
  uint32_t bh[2], bl[2];
  tf32_split(b0, bh[0], bl[0]);
  tf32_split(b1, bh[1], bl[1]);
  if constexpr ((PASSES & 1) != 0) mma_tf32(c, wh, bl);
  if constexpr ((PASSES & 2) != 0) mma_tf32(c, wl, bh);
  if constexpr ((PASSES & 4) != 0) mma_tf32(c, wh, bh);
}

// A shared-memory matrix descriptor without swizzle, K-major: 8-row x
// 16-byte core matrices, lbo bytes apart along K, sbo bytes apart along N
// (csrc/mrf_f32.cu's smem_desc)
__device__ __forceinline__ uint64_t cf_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x N f32, N / 2 a thread, the mma.sync m16n8 layout per warp and n8
// tile) += A (64 x 8 tf32 in registers, the mma.sync m16n8k8 A layout per
// warp) . B (8 x N, descriptor db)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t a[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void cf_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cf_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cf_wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// byte offsets of the f32 cell's shared arrays: the ring's barriers; the
// partial sums pushed to this rank by every rank ([rank][gate][unit of this
// rank][row], pld floats a unit); the k halves' exchange (CF_MT m16 tiles x
// the pass's n8 tiles x 32 lanes x 4 floats); the update's operands (c_in
// [row][unit], bias [gate][unit]); then the ring: a stage is a weight chunk
// and the pass's rows of the input over its columns, as many stages as fit,
// up to CF_MAX_STAGES (the depth follows the rows and changes no sum). The
// input's layout follows its copies (cell_boxes): rows of CF_XS floats, a
// row's 64 columns and a pad (conflict-free fragment loads), or four TMA
// boxes of nrows x 16 floats ([16-column group][row][16]: 64-byte rows,
// conflict-free too)
struct CellF32Smem {
  int stage, pld, part, xchg, planes, epi, ring, stages, total;
};

// the n8 tiles of the kernel's instance for a pass of nrows rows: its
// wgmma's N / 8
__host__ __device__ inline int cf_nt(int nrows) { return nrows <= 8 ? 1 : nrows <= 16 ? 2 : CF_NT; }

// bytes of a consumer warpgroup's split input in the wgmma instance (NT =
// CF_NT; none in the others): its four k8 steps of a chunk, hi and lo planes,
// as wgmma's B (K-major core matrices of 8 rows x 4 columns: [plane][step][k4
// group][row / 8][row % 8][4]) over the instance's 8 NT rows
__host__ __device__ inline int cf_plane_bytes(int nt) {
  return nt == CF_NT ? 2 * 4 * 8 * nt * 8 * 4 : 0;
}

// the input by TMA boxes of 16 columns (a pass of more than CF_ROW_COPIES
// rows), else by a bulk copy a row and segment
__host__ __device__ inline bool cell_boxes(int nrows) { return nrows > CF_ROW_COPIES; }

__host__ __device__ inline CellF32Smem cell_f32_smem(int nrows) {
  CellF32Smem o;
  o.stage = CF_CHUNK + nrows * (cell_boxes(nrows) ? CF_KC : CF_XS) * 4;
  o.pld = nrows + 4;
  o.part = 2 * CF_MAX_STAGES * 8;
  o.xchg = o.part + CF_S * 4 * CF_UPR * o.pld * 4;
  o.planes = (o.xchg + CF_MT * (nrows / 8) * 32 * 16 + 127) & ~127;
  o.epi = o.planes + 2 * cf_plane_bytes(cf_nt(nrows));
  o.ring = (o.epi + (nrows + 4) * CF_UPR * 4 + 127) & ~127;
  o.stages = (GC_SMEM_MAX - o.ring) / o.stage;
  if (o.stages > CF_MAX_STAGES) o.stages = CF_MAX_STAGES;
  o.total = o.ring + o.stages * o.stage;
  return o;
}

// the f32 cell's input [x1 | x2 | xc | x3]: segment i, n[i] columns (a
// multiple of 16; 0 for no controls) of the (B, n[i]) f32 array x[i] and, for
// TMA boxes (cell_boxes), its 2-D tensor map, boxes of 16 columns x the
// pass's rows padded to 8 (zero past B)
struct CellMaps {
  CUtensorMap m[kSeg];
  const float* x[kSeg];
  int n[kSeg];
};

// grid (CF_S, H / CF_U), cluster (CF_S, 1, 1), CF_THREADS threads,
// cell_f32_smem(rows of a pass padded to 8).total bytes; NT: the pass's n8
// tiles at most (1, 2 or CF_NT, cf_nt: an instance a row count, so that a few
// rows hold no registers for eight tiles; the sums do not depend on it). wt:
// the tiled copy (see above); xm: the input; bias (4H,); c_in, h_out, c_out
// (B, H) f32.
template <int NT>
__global__ void __launch_bounds__(CF_THREADS, 1)
gate_cell_f32_kernel(const float* __restrict__ wt, const __grid_constant__ CellMaps xm,
                     const float* __restrict__ bias, const float* __restrict__ c_in,
                     float* __restrict__ h_out, float* __restrict__ c_out, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) uint8_t cf_raw[];
  const int R = xm.n[0] + xm.n[1] + xm.n[2] + xm.n[3], nk = (R + CF_KC - 1) / CF_KC;
  const int rank = (int)cluster.block_rank(), gi = blockIdx.y;
  const int c0 = rank * nk / CF_S, nc = (rank + 1) * nk / CF_S - c0;
  const int nrows = (min(B, CF_NTILE) + 7) & ~7;
  const bool boxes = cell_boxes(nrows);
  const CellF32Smem o = cell_f32_smem(nrows);
  const int NS = o.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(cf_raw);
  uint64_t* empty = full + CF_MAX_STAGES;
  float* part = reinterpret_cast<float*>(cf_raw + o.part);
  float4* xchg = reinterpret_cast<float4*>(cf_raw + o.xchg);  // [m tile][n8 tile][lane]
  float* cpre = reinterpret_cast<float*>(cf_raw + o.epi);     // [row][unit]
  float* bpre = cpre + nrows * CF_UPR;                        // [gate][unit]
  uint8_t* ring = cf_raw + o.ring;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (B + CF_NTILE - 1) / CF_NTILE;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 2);  // the weight chunk's arrival and the input's
      mbar_init(empty + s, CF_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this block has started: the ranks may push into its partial sums once
  // all have
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  if (warp == CF_CONSUMERS) {
    // producer: chunk it of the run (chunk it % nc of pass it / nc) into
    // stage it % NS once its last use is done, the weights by lane 0 (the
    // first `early` before the wait for the previous kernel), then the
    // pass's rows of the input over the chunk's columns [k0, k1): a TMA box
    // of each 16-column group (lane 0), or a bulk copy of each row's piece
    // of each segment (all lanes). The warp joins the passes' cluster syncs,
    // so it issues a pass's copies only within that pass.
    const uint8_t* wb = reinterpret_cast<const uint8_t*>(wt) + ((size_t)gi * nk + c0) * CF_CHUNK;
    const uint64_t policy = evict_first_policy();
    auto issue = [&](int it) {
      const int s = it % NS;
      mbar_expect_tx(full + s, CF_CHUNK);
      bulk_load(ring + s * o.stage, wb + (size_t)(it % nc) * CF_CHUNK, CF_CHUNK, full + s, policy);
    };
    const int early = min(min(CF_PREFETCH, NS), nc);
    if (lane == 0)
      for (int it = 0; it < early; ++it) issue(it);
    pdl_wait();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int tile = 0; tile < ntiles; ++tile) {
      const int b0 = tile * CF_NTILE, bt = min(CF_NTILE, B - b0);
      for (int kc = 0; kc < nc; ++kc) {
        const int it = tile * nc + kc, s = it % NS;
        const int k0 = (c0 + kc) * CF_KC, k1 = min(R, k0 + CF_KC);
        uint8_t* xs = ring + s * o.stage + CF_CHUNK;
        if (lane == 0) {
          if (it >= early) {
            if (it >= NS) mbar_wait(empty + s, ((it / NS) & 1) ^ 1);
            issue(it);
          }
          mbar_expect_tx(full + s, (uint32_t)((boxes ? nrows : bt) * (k1 - k0) * 4));
          int seg = 0;
#pragma unroll
          for (int i = 0; i < kSeg; ++i) {
            for (int q = 0; boxes && q < (k1 - k0) / 16; ++q) {
              const int col = k0 + 16 * q;
              if (col >= seg && col < seg + xm.n[i])
                tma_load_2d(xs + q * nrows * 64, &xm.m[i], col - seg, b0, full + s);
            }
            seg += xm.n[i];
          }
        }
        __syncwarp();
        for (int b = lane; !boxes && b < bt; b += 32) {
          int seg = 0;
#pragma unroll
          for (int i = 0; i < kSeg; ++i) {
            const int a = max(k0, seg), e = min(k1, seg + xm.n[i]);
            if (a < e)
              bulk_load(xs + (size_t)b * CF_XS * 4 + (a - k0) * 4,
                        xm.x[i] + (size_t)(b0 + b) * xm.n[i] + (a - seg),
                        (uint32_t)((e - a) * 4), full + s);
            seg += xm.n[i];
          }
        }
      }
      __syncwarp();
      cluster.sync();  // the pass's partial sums are pushed
      if (tile + 1 < ntiles) cluster.sync();  // and summed
    }
    return;
  }

  // consumers: warpgroup kh (warps 4 kh .. 4 kh + 3) the half kh of each
  // chunk's k8 steps (4 kh .. 4 kh + 3) over the block's 64 rows and every
  // n8 tile of the pass; warp w the rows of m16 tile mt = w % 4 (gate mt), as
  // the A registers of mma.sync m16n8k8 (NT < CF_NT) or of one wgmma
  // m64nNk8 a pass and step (NT = CF_NT, N = 64)
  pdl_wait();
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % CF_MT, kh = warp / CF_MT, ntp = nrows / 8, wg_tid = tid & 127;
  constexpr int NR = 8 * NT;  // the rows of wgmma's B
  float* planes = reinterpret_cast<float*>(cf_raw + o.planes) + kh * cf_plane_bytes(NT) / 4;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int b0 = tile * CF_NTILE, bt = min(CF_NTILE, B - b0), ntl = (bt + 7) >> 3;
    // the update's operands, in flight while the product runs
    for (int i = tid; i < bt * CF_UPR; i += CF_CONSUMERS * 32) {
      const int b = i / CF_UPR, ul = i - b * CF_UPR;
      cpre[i] = c_in[(size_t)(b0 + b) * H + gi * CF_U + rank * CF_UPR + ul];
    }
    for (int i = tid; i < 4 * CF_UPR; i += CF_CONSUMERS * 32)
      bpre[i] = bias[(i / CF_UPR) * H + gi * CF_U + rank * CF_UPR + i % CF_UPR];

    // the product over this rank's chunks, k in chunk order; each chunk's
    // sums of this warpgroup's steps in two accumulators (steps 4 kh + 2 q'
    // + h, h = 0, 1), then (even + odd) into the running sums
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    if constexpr (NT == CF_NT) {  // a pass of more than 16 rows: wgmma
      for (int kc = 0; kc < nc; ++kc) {
        const int it = tile * nc + kc, s = it % NS;
        // the chunk's columns below R (a multiple of 16: past them nothing
        // was copied, and the weights are zero)
        const int valid = min(CF_KC, R - (c0 + kc) * CF_KC);
        mbar_wait(full + s, (it / NS) & 1);
        const uint8_t* wc = ring + s * o.stage;
        const float* xc = reinterpret_cast<const float*>(wc + CF_CHUNK);
        // the warpgroup's wgmma of the chunk before are done with the planes
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + kh) : "memory");
        // the input's columns of this half, split into the hi and lo planes:
        // thread (row, k16 group q) takes columns 16 q .. 16 q + 15 of a row;
        // column 4 t + c goes to step 2 q' + c / 2 (the weight copy's k order:
        // 4 t + 2 h at k = t, 4 t + 2 h + 1 at k = t + 4), k4 group c % 2,
        // element t: four columns of a core matrix's row, one 16-byte store
        for (int i = wg_tid; i < 2 * NR; i += 128) {
          const int row = i % NR, qq = i / NR, q = 2 * kh + qq;
          float4 v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (row < ntl * 8 && 16 * q < valid)
              v[j] = *reinterpret_cast<const float4*>(
                  xc + (boxes ? (q * nrows + row) * 16 : row * CF_XS + 16 * q) + 4 * j);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float x = c == 0 ? v[j].x : c == 1 ? v[j].y : c == 2 ? v[j].z : v[j].w;
              tf32_split(cf_op(x), hi[j], lo[j]);
            }
            float* dst = planes + ((2 * qq + c / 2) * 2 + c % 2) * NR * 4 + row * 4;
            *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<uint4*>(dst + 4 * NR * 8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          }
        }
        // this warp's A fragments of the half's four steps, split
        uint32_t wh[4][4], wl[4][4];
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
          const float4 w = *reinterpret_cast<const float4*>(
              wc + ((mt * 8 + 4 * kh + sl) * 32 + lane) * 16);
          tf32_split(cf_op(w.x), wh[sl][0], wl[sl][0]);
          tf32_split(cf_op(w.y), wh[sl][1], wl[sl][1]);
          tf32_split(cf_op(w.z), wh[sl][2], wl[sl][2]);
          tf32_split(cf_op(w.w), wh[sl][3], wl[sl][3]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + kh) : "memory");  // the planes are whole
        if (lane == 0) mbar_arrive(empty + s);  // the stage is read: free it
        float pc[2][NT * 4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < NT * 4; ++e) pc[h][e] = 0.0f;
        cf_wgmma_fence();
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
          const float* hp = planes + sl * NR * 8;
          const uint64_t dh = cf_desc(hp, NR * 16, 128);
          const uint64_t dl = cf_desc(hp + 4 * NR * 8, NR * 16, 128);
          if constexpr ((CF_PASSES & 1) != 0) wgmma_rs<NR>(pc[sl & 1], wh[sl], dl);
          if constexpr ((CF_PASSES & 2) != 0) wgmma_rs<NR>(pc[sl & 1], wl[sl], dh);
          if constexpr ((CF_PASSES & 4) != 0) wgmma_rs<NR>(pc[sl & 1], wh[sl], dh);
        }
        cf_wgmma_commit();
        cf_wgmma_wait_all();
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += pc[0][4 * n + e] + pc[1][4 * n + e];
      }
    } else {  // mma.sync m16n8k8: the same sums, bit for bit
      for (int kc = 0; kc < nc; ++kc) {
        const int it = tile * nc + kc, s = it % NS;
        // the chunk's columns below R (a multiple of 16: past them nothing
        // was copied, and the weights are zero)
        const int valid = min(CF_KC, R - (c0 + kc) * CF_KC);
        mbar_wait(full + s, (it / NS) & 1);
        const uint8_t* wc = ring + s * o.stage;
        const float* xc = reinterpret_cast<const float*>(wc + CF_CHUNK);
        float pc[2][NT][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pc[h][n][e] = 0.0f;
#pragma unroll
        for (int qq = 0; qq < CF_KC / 32; ++qq) {
          const int q = kh * (CF_KC / 32) + qq;  // the k16 group: steps 2q, 2q + 1
          float4 xv[NT];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            xv[n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (n < ntl && 16 * q < valid)
              xv[n] = *reinterpret_cast<const float4*>(
                  xc + (boxes ? (q * nrows + n * 8 + g) * 16 : (n * 8 + g) * CF_XS + 16 * q) +
                  4 * t);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 w =
                *reinterpret_cast<const float4*>(wc + ((mt * 8 + 2 * q + h) * 32 + lane) * 16);
            uint32_t wh[4], wl[4];
            tf32_split(cf_op(w.x), wh[0], wl[0]);
            tf32_split(cf_op(w.y), wh[1], wl[1]);
            tf32_split(cf_op(w.z), wh[2], wl[2]);
            tf32_split(cf_op(w.w), wh[3], wl[3]);
#pragma unroll
            for (int n = 0; n < NT; ++n)
              if (n < ntl)
                mma_3xtf32<CF_PASSES>(pc[h][n], wh, wl, cf_op(h ? xv[n].z : xv[n].x),
                                      cf_op(h ? xv[n].w : xv[n].y));
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);  // the stage is read: free it
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += pc[0][n][e] + pc[1][n][e];
      }
    }
    pdl_trigger();  // the weights are read: the next launch may start streaming
    // the k halves: half 1's sums to half 0, which adds them (half 0 + half 1)
    if (kh == 1)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < ntl)
          xchg[(mt * ntp + n) * 32 + lane] = make_float4(acc[n][0], acc[n][1], acc[n][2],
                                                         acc[n][3]);
    bar_consumers();
    if (tile == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    // push each sum to the rank that applies its unit's update: rows g and
    // g + 8 of m tile mt are units g and g + 8 of gate mt, ranks 0 and 1,
    // slot [this rank][gate][g]
    if (kh == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < ntl) {
          const float4 v = xchg[(mt * ntp + n) * 32 + lane];
          acc[n][0] += v.x;
          acc[n][1] += v.y;
          acc[n][2] += v.z;
          acc[n][3] += v.w;
        }
      }
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        float* dst = cluster.map_shared_rank(part, h8) + ((rank * 4 + mt) * CF_UPR + g) * o.pld;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < ntl) {
            dst[n * 8 + 2 * t] = acc[n][2 * h8];
            dst[n * 8 + 2 * t + 1] = acc[n][2 * h8 + 1];
          }
        }
      }
    }
    cluster.sync();

    // the LSTM update of this rank's CF_UPR units: the ranks' partial sums
    // in rank order, + bias
    for (int i = tid; i < CF_UPR * bt; i += CF_CONSUMERS * 32) {
      const int b = i / CF_UPR, ul = i - b * CF_UPR, j = gi * CF_U + rank * CF_UPR + ul;
      float gv[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        float v = part[(gate * CF_UPR + ul) * o.pld + b];
#pragma unroll
        for (int p = 1; p < CF_S; ++p) v += part[((p * 4 + gate) * CF_UPR + ul) * o.pld + b];
        gv[gate] = v + bpre[gate * CF_UPR + ul];
      }
      const size_t oo = (size_t)(b0 + b) * H + j;
      const float cc = sigmoid_f(gv[1]) * cpre[i] + sigmoid_f(gv[0]) * tanhf(gv[2]);
      c_out[oo] = cc;
      h_out[oo] = sigmoid_f(gv[3]) * tanhf(cc);
    }
    if (tile + 1 < ntiles) cluster.sync();  // no rank pushes the next pass's sums early
  }
}

// The f32 heads (t2_heads_f32, heads_f32_kernel). Bound: their bytes, 0.5 MB
// of f32 weights, 0.18 us at one row; what they cost is latency, on every
// step's critical path. The design is the bf16 heads' (heads_kernel above)
// on the three-pass TF32 split: a cluster of HD_S blocks splits the
// contraction in 16-column pieces (rank r the pieces [r nk / HD_S, (r + 1) nk
// / HD_S)); each rank bulk-copies its slice of an f32 copy tiled once per
// model (pack_decoder, tile_heads_f32: for piece p, m16 tile mt, k8 step h,
// lane l, its four A registers side by side, the cell's k order within a
// piece; zero past N and K) before griddepcontrol.wait, and its columns of
// the tile's input rows by bulk copies after it (the consumers stage
// nothing). Weight rows on M (N padded to NP = 96: six m16 tiles), the batch
// on N: a cluster takes HF_NTILE = 8 rows (one n8 tile; grid.y = ceil(B /
// 8), so 64 rows run on 64 SMs, not 8). Warp w takes m16 tile w % MT over
// the part kq = w / MT of the rank's pieces (KQ = HD_WARPS / MT parts: two
// at NP = 96), each four pieces' products in their own accumulators (k8
// steps of even and odd h apart). Each (n8 tile, m16 tile) has an owner,
// rank (n MT + mt) % HD_S, to which every rank pushes its parts' sums over
// distributed shared memory; after one cluster barrier the owner adds them,
// ((p0 + p1) + ... + p7) + b with p_r = (part 0 + part 1 + ...) of rank r:
// the pieces, the parts, their order and the rank order follow the dims,
// never B. RND (the int8 mode of an F32 model, the ACT_BF16 entry: the JAX
// kernel's h_new.astype(bf16) @ w_out on f32 weights, :567-572): each input
// rounded to bf16 as its fragment loads, before the split (its lo is then
// zero); without, nothing is rounded. Readings (in turns against the FFMA
// design it replaced, NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py
// --k1-f32-ab): 6.2 / 6.4 / 6.4 us at 1 / 16 / 64 rows (was 7.0 / 10.8 /
// 31.5; F.linear f32 4.1 / 9.1 / 19.5); 16 rows a cluster read 6.1 / 7.7 /
// 7.8, one pass 5.4 / 5.6 / 5.6 (K1F_CELL_AB): at one row the launch, the
// copies and the cluster barriers bound it, not the product.
constexpr int HF_NTILE = 8;                  // batch rows a cluster: one n8 tile
constexpr int HF_NT = HF_NTILE / 8;
constexpr int HF_GROUP = 4;                  // pieces summed in their own accumulators
constexpr int HF_PASSES = 7;                 // as CF_PASSES

// byte offsets of an f32 heads block's shared arrays: two mbarriers (the
// weights', the input's); the weight slice (npmax pieces x NP rows x 64
// bytes); the tile's input rows over the rank's columns (xs_stride floats a
// row, = 16 mod 32: conflict-free fragment loads); the partial sums pushed
// to this rank, [slot][rank][part][column][row], rows pld apart; kq the
// parts of a rank's pieces, slots the (n8, m16) tiles a rank owns at most
struct HeadsF32Smem {
  int ws, xs, xs_stride, part, pld, kq, slots, total;
};

__host__ __device__ inline HeadsF32Smem heads_f32_smem(int NP, int npmax) {
  HeadsF32Smem o;
  const int MT = NP / 16, width = npmax * 16;
  o.kq = HD_WARPS / MT > 1 ? HD_WARPS / MT : 1;
  o.slots = (HF_NT * MT + HD_S - 1) / HD_S;
  o.ws = 16;
  o.xs = o.ws + npmax * NP * 64;
  o.xs_stride = width + (48 - width % 32) % 32;
  o.part = o.xs + HF_NTILE * o.xs_stride * 4;
  o.pld = 16 + 4;
  o.total = o.part + o.slots * HD_S * o.kq * 8 * o.pld * 4;
  return o;
}

// grid (HD_S, ceil(B / HF_NTILE)), cluster (HD_S, 1, 1), HD_THREADS threads,
// heads_f32_smem(NP, ceil(nk / HD_S)).total bytes; wt the f32 tiled copy,
// the other operands as heads_kernel's
template <bool RND>
__global__ void __launch_bounds__(HD_THREADS)
heads_f32_kernel(const float* __restrict__ wt, const float* __restrict__ bias,
                 const float* __restrict__ x1, int n1, const float* __restrict__ x2, int n2,
                 const float* __restrict__ x3, int n3, float* __restrict__ out, int B, int N) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) uint8_t hf_raw[];
  const int nk = (n1 + n2 + n3) / 16, NP = (N + 15) & ~15, MT = NP / 16;
  const int rank = (int)cluster.block_rank();
  const int p0 = rank * nk / HD_S, np = (rank + 1) * nk / HD_S - p0;
  const HeadsF32Smem o = heads_f32_smem(NP, (nk + HD_S - 1) / HD_S);
  uint64_t* bar = reinterpret_cast<uint64_t*>(hf_raw);  // [0] the weights, [1] the input
  const uint8_t* ws = hf_raw + o.ws;
  float* xs = reinterpret_cast<float*>(hf_raw + o.xs);
  float* part = reinterpret_cast<float*>(hf_raw + o.part);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.y * HF_NTILE, bt = min(HF_NTILE, B - b0), ntl = (bt + 7) >> 3;
  if (tid == 0) {
    const uint32_t bytes = (uint32_t)np * NP * 64;
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, bytes);  // a rank with no piece (nk < HD_S) adds zeros
    if (bytes) bulk_load(hf_raw + o.ws, wt + (size_t)p0 * NP * 16, bytes, bar);
  }
  __syncthreads();
  // this block has started: the ranks may push into its partial sums once
  // all have
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  pdl_wait();  // with HD_PDL: the inputs are the launch before's outputs
  if (warp == 0) {
    // the tile's rows of [x1 | x2 | x3] over this rank's columns [k0, k1)
    const int k0 = p0 * 16, k1 = (p0 + np) * 16;
    if (lane == 0) mbar_expect_tx(bar + 1, (uint32_t)(bt * (k1 - k0) * 4));
    __syncwarp();
    for (int b = lane; b < bt; b += 32) {
      const size_t row = (size_t)(b0 + b);
      float* dst = xs + (size_t)b * o.xs_stride;
      int a = max(k0, 0), e = min(k1, n1);
      if (a < e) bulk_load(dst + (a - k0), x1 + row * n1 + a, (uint32_t)((e - a) * 4), bar + 1);
      a = max(k0, n1), e = min(k1, n1 + n2);
      if (a < e)
        bulk_load(dst + (a - k0), x2 + row * n2 + (a - n1), (uint32_t)((e - a) * 4), bar + 1);
      a = max(k0, n1 + n2), e = min(k1, n1 + n2 + n3);
      if (a < e)
        bulk_load(dst + (a - k0), x3 + row * n3 + (a - n1 - n2), (uint32_t)((e - a) * 4),
                  bar + 1);
    }
  }
  mbar_wait(bar, 0);
  mbar_wait(bar + 1, 0);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // warp task (m16 tile mt, part kq): the rank's pieces [j0, j1), the tile's
  // n8 tiles; then each (n8, m16) tile's sums to its owner, slot [this
  // rank][kq][column][row]
  const int g = lane >> 2, t = lane & 3, KQ = o.kq;
  for (int task = warp; task < MT * KQ; task += HD_WARPS) {
    const int mt = task % MT, kq = task / MT;
    const int j0 = kq * np / KQ, j1 = (kq + 1) * np / KQ;
    float acc[HF_NT][4], pc[2][HF_NT][4];
#pragma unroll
    for (int n = 0; n < HF_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = pc[0][n][e] = pc[1][n][e] = 0.0f;
    for (int j = j0; j < j1; ++j) {
      float4 xv[HF_NT];
#pragma unroll
      for (int n = 0; n < HF_NT; ++n) {
        xv[n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (n < ntl) {
          xv[n] = *reinterpret_cast<const float4*>(xs + (size_t)(n * 8 + g) * o.xs_stride +
                                                   16 * j + 4 * t);
          if (RND)
            xv[n] = make_float4(rnd_bf16(xv[n].x), rnd_bf16(xv[n].y), rnd_bf16(xv[n].z),
                                rnd_bf16(xv[n].w));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 w =
            *reinterpret_cast<const float4*>(ws + (((j * MT + mt) * 2 + h) * 32 + lane) * 16);
        uint32_t wh[4], wl[4];
        tf32_split(w.x, wh[0], wl[0]);
        tf32_split(w.y, wh[1], wl[1]);
        tf32_split(w.z, wh[2], wl[2]);
        tf32_split(w.w, wh[3], wl[3]);
#pragma unroll
        for (int n = 0; n < HF_NT; ++n)
          if (n < ntl)
            mma_3xtf32<HF_PASSES>(pc[h][n], wh, wl, h ? xv[n].z : xv[n].x,
                                  h ? xv[n].w : xv[n].y);
      }
      if ((j - j0) % HF_GROUP == HF_GROUP - 1 || j + 1 == j1) {
#pragma unroll
        for (int n = 0; n < HF_NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[n][e] += pc[0][n][e] + pc[1][n][e];
            pc[0][n][e] = pc[1][n][e] = 0.0f;
          }
      }
    }
#pragma unroll
    for (int n = 0; n < HF_NT; ++n) {
      if (n < ntl) {
        const int unit = n * MT + mt;
        float* dst = cluster.map_shared_rank(part, unit % HD_S) +
                     (((unit / HD_S) * HD_S + rank) * KQ + kq) * 8 * o.pld;
        dst[(2 * t) * o.pld + g] = acc[n][0];
        dst[(2 * t + 1) * o.pld + g] = acc[n][1];
        dst[(2 * t) * o.pld + g + 8] = acc[n][2];
        dst[(2 * t + 1) * o.pld + g + 8] = acc[n][3];
      }
    }
  }
  cluster.sync();  // every partial sum is pushed

  // the owner: each rank's parts in order, the ranks' sums in rank order,
  // then the bias
  for (int i = tid; i < o.slots * 8 * 16; i += HD_THREADS) {
    const int slot = i / 128, c = (i / 16) % 8, r = i % 16, unit = slot * HD_S + rank;
    const int n = unit / MT, m = (unit % MT) * 16 + r, b = n * 8 + c;
    if (n >= ntl || b >= bt || m >= N) continue;
    const float* s = part + (size_t)slot * HD_S * KQ * 8 * o.pld + c * o.pld + r;
    float v = 0.0f;
    for (int p = 0; p < HD_S; ++p) {
      float vp = s[(size_t)p * KQ * 8 * o.pld];
      for (int q = 1; q < KQ; ++q) vp += s[(size_t)(p * KQ + q) * 8 * o.pld];
      v = p ? v + vp : vp;
    }
    out[(size_t)(b0 + b) * N + m] = v + bias[m];
  }
}

// ---- launchers (shared by the one-kernel entry points and the chunk) ----

// K1's attention: blocks of 256 threads, or of 128 where the clusters are
// more blocks than the card has SMs (the serve windows: 64 rows x S = 8).
// The sums' order does not follow: while a rank has at most 128 chars, a
// thread holds at most one char in the softmax's sums and the other sums
// run per output, whatever the block size. ctx_bf, where given, gets the
// context's bf16 operand (both LSTM cells' input). f32: K1's f32 mode, f32
// weights and memory (the attention's WT = float instance), no ctx_bf.
int launch_k1_att(const void* h, const void* wq, const void* wloc, const void* wv,
                  const void* att_enc, const void* enc, const void* lengths, const void* w_prev,
                  const void* cum_prev, void* ctx_out, void* ctx_bf, void* w_out, void* cum_out,
                  int B, int L, int H, int A, int D, int K, int S, cudaStream_t stream,
                  bool f32 = false) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  if (S < 1 || (f32 && ctx_bf)) return (int)cudaErrorInvalidValue;
  const bool narrow = (long long)B * S > sms && (L + S - 1) / S <= 128;
  if (f32)
    return narrow ? launch_att_fwd<float, float, 128, true, float, float>(
                        h, H, wq, wloc, wv, att_enc, enc, lengths, w_prev, cum_prev, w_out,
                        cum_out, ctx_out, D, nullptr, D, B, S, L, H, A, D, K, false, stream)
                  : launch_att_fwd<float, float, 256, true, float, float>(
                        h, H, wq, wloc, wv, att_enc, enc, lengths, w_prev, cum_prev, w_out,
                        cum_out, ctx_out, D, nullptr, D, B, S, L, H, A, D, K, false, stream);
  if (narrow)
    return launch_att_fwd<float, float, 128, true, bf16>(
        h, H, wq, wloc, wv, att_enc, enc, lengths, w_prev, cum_prev, w_out, cum_out, ctx_out, D,
        ctx_bf, D, B, S, L, H, A, D, K, false, stream);
  return launch_att_fwd<float, float, 256, true, bf16>(
      h, H, wq, wloc, wv, att_enc, enc, lengths, w_prev, cum_prev, w_out, cum_out, ctx_out, D,
      ctx_bf, D, B, S, L, H, A, D, K, false, stream);
}

// bf16 operand: the (B, n_i) arrays [x1 | x2 | xc | x3], xc the controls
// (nc = 0: none)
CellOperand bf16_operand(const void* x1, int n1, const void* x2, int n2, const void* xc, int nc,
                         const void* x3, int n3) {
  return CellOperand{{(const uint8_t*)x1, (const uint8_t*)x2, (const uint8_t*)xc,
                      (const uint8_t*)x3},
                     {n1, n2, nc, n3},
                     {2 * n1, 2 * n2, 2 * nc, 2 * n3}};
}

// K5's operand: the parts of quantize_xh's (B, n1 + n2 + nc + n3) int8 array
CellOperand int8_operand(const void* xq, int n1, int n2, int nc, int n3) {
  const uint8_t* q = (const uint8_t*)xq;
  const int R = n1 + n2 + nc + n3;
  return CellOperand{{q, q + n1, q + n1 + n2, q + n1 + n2 + nc}, {n1, n2, nc, n3}, {R, R, R, R}};
}

// the cell's launch: grid (GC_S, H / GC_U), a cluster of GC_S blocks, with
// programmatic dependent launch (the weights stream while the previous
// kernel ends); h_bf may be null
template <bool INT8>
int launch_gate_cell(const void* wt, const CellOperand& xo, const void* ws, const void* sx,
                     const void* b, const void* c_in, void* h_out, void* c_out, void* h_bf, int B,
                     int H, cudaStream_t stream) {
  const int R = operand_width(xo), nk = cell_chunks(R, INT8);
  bool aligned = ((uintptr_t)wt & 15) == 0;
  for (int i = 0; i < kSeg; ++i)
    aligned = aligned && ((uintptr_t)xo.x[i] & 15) == 0 && xo.pitch[i] % 16 == 0 &&
              xo.n[i] % 16 == 0;
  if (B < 1 || H < GC_U || H % GC_U || nk < GC_S || !aligned)
    return (int)cudaErrorInvalidValue;
  const CellSmem o = cell_smem(cell_kb(R, INT8), (std::min(B, GC_NTILE) + 7) & ~7);
  if (o.stages < 2) return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  const int err = allow_smem(gate_cell_kernel<INT8>, (size_t)o.total, &allowed);
  if (err) return err;
  return launch_ex(gate_cell_kernel<INT8>, dim3(GC_S, H / GC_U), dim3(GC_S, 1, 1), GC_THREADS,
                   (size_t)o.total, true, stream, (const uint8_t*)wt, xo, (const float*)ws,
                   (const float*)sx, (const float*)b, (const float*)c_in, (float*)h_out,
                   (float*)c_out, (bf16*)h_bf, B, H);
}

// the f32 input [x1 | x2 | xc | x3], xc the controls (nc = 0: none)
int launch_quantize_xh(const void* x1, int n1, const void* x2, int n2, const void* xc, int nc,
                       const void* x3, int n3, void* xq, void* sx, int B, cudaStream_t stream) {
  if (B < 1 || n1 % 4 || n2 % 4 || nc % 4 || n3 % 4) return (int)cudaErrorInvalidValue;
  const QuantInput in{{(const float*)x1, (const float*)x2, (const float*)xc, (const float*)x3},
                      {n1, n2, nc, n3}};
  return launch_ex(quantize_xh_kernel, dim3(B), kNoCluster, 256, 0, true, stream, in,
                   (int8_t*)xq, (float*)sx);
}

// the prenet over the tiled copy wt of its weights (pack_decoder); out_bf,
// where given, gets its output's bf16 operand (the chunk's launch in bf16
// mode: prenet_kernel<true>)
// the prenet over the f32 copy (K1's f32 mode), its activations rounded to
// bf16 where act_bf16 (the int8 mode of an F32 model)
int launch_prenet_f32(const void* mel, int ldm, const void* wt, const void* m1, const void* m2,
                      void* out, int B, int M, int P, bool act_bf16, cudaStream_t stream) {
  const int U = P / PN_S;
  if (B < 1 || M < 1 || M % 4 || P % PN_S || U % 8 || PN_THREADS % U || ((uintptr_t)wt & 15))
    return (int)cudaErrorInvalidValue;
  const size_t smem = prenet_smem(M, P, 4);
  static size_t allowed[2] = {48 * 1024, 48 * 1024};
  auto kernel = act_bf16 ? prenet_kernel<false, float, true> : prenet_kernel<false, float, false>;
  const int err = allow_smem(kernel, smem, &allowed[act_bf16 ? 1 : 0]);
  if (err) return err;
  const int rows = PN_THREADS / U;
  return launch_ex(kernel, dim3(PN_S, (B + rows - 1) / rows), dim3(PN_S, 1, 1), PN_THREADS, smem,
                   false, stream, (const float*)mel, (const float*)wt, (const float*)m1,
                   (const float*)m2, (float*)out, (bf16*)nullptr, B, M, P, ldm);
}

int launch_prenet(const void* mel, int ldm, const void* wt, const void* m1, const void* m2,
                  void* out, void* out_bf, int B, int M, int P, cudaStream_t stream) {
  const int U = P / PN_S;
  if (B < 1 || M < 1 || M % 4 || P % PN_S || U % 8 || PN_THREADS % U || ((uintptr_t)wt & 15))
    return (int)cudaErrorInvalidValue;
  const size_t smem = prenet_smem(M, P);
  static size_t allowed[2] = {48 * 1024, 48 * 1024};
  auto kernel = out_bf ? prenet_kernel<true> : prenet_kernel<false>;
  const int err = allow_smem(kernel, smem, &allowed[out_bf ? 1 : 0]);
  if (err) return err;
  const int rows = PN_THREADS / U;
  return launch_ex(kernel, dim3(PN_S, (B + rows - 1) / rows), dim3(PN_S, 1, 1), PN_THREADS, smem,
                   false, stream, (const float*)mel, (const bf16*)wt, (const float*)m1,
                   (const float*)m2, (float*)out, (bf16*)out_bf, B, M, P, ldm);
}

// the heads over the tiled copy wt of W_out (pack_decoder, tile_heads): a
// cluster of HD_S blocks per 64 rows; [x1 | x2 | x3] (B, n_i) f32, each n_i
// a multiple of 16 (x3 the controls, n3 = 0: none)
int launch_heads(const void* wt, const void* b, const void* x1, int n1, const void* x2, int n2,
                 const void* x3, int n3, void* out, int B, int N, cudaStream_t stream) {
  const int nk = (n1 + n2 + n3) / 16, NP = (N + 15) & ~15;
  const bool aligned = ((uintptr_t)wt & 15) == 0 && ((uintptr_t)x1 & 15) == 0 &&
                       ((uintptr_t)x2 & 15) == 0 && (n3 == 0 || ((uintptr_t)x3 & 15) == 0);
  if (B < 1 || N < 1 || n1 % 16 || n2 % 16 || n3 % 16 || nk < 1 || !aligned)
    return (int)cudaErrorInvalidValue;
  const HeadsSmem o = heads_smem(NP, (nk + HD_S - 1) / HD_S);
  static size_t allowed = 48 * 1024;
  int err = allow_smem(heads_kernel, (size_t)o.total, &allowed);
  if (err) return err;
  if (HD_S > 8) {  // a cluster past the portable size
    static bool asked = false;
    if (!asked) {
      err = (int)cudaFuncSetAttribute(heads_kernel,
                                      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err) return err;
      asked = true;
    }
  }
  return launch_ex(heads_kernel, dim3(HD_S, (B + HD_NTILE - 1) / HD_NTILE), dim3(HD_S, 1, 1),
                   HD_THREADS, (size_t)o.total, HD_PDL, stream, (const uint8_t*)wt,
                   (const float*)b, (const float*)x1, n1, (const float*)x2, n2, (const float*)x3,
                   n3, (float*)out, B, N);
}

// the f32 heads over the f32 tiled copy wt of W_out (tile_heads_f32): a
// cluster of HD_S blocks per HF_NTILE rows; the inputs rounded to bf16 as
// their fragments load where act_bf16
int launch_heads_f32(const void* wt, const void* b, const void* x1, int n1, const void* x2, int n2,
                     const void* x3, int n3, void* out, int B, int N, bool act_bf16,
                     cudaStream_t stream) {
  const int nk = (n1 + n2 + n3) / 16, NP = (N + 15) & ~15;
  const bool aligned = ((uintptr_t)wt & 15) == 0 && ((uintptr_t)x1 & 15) == 0 &&
                       ((uintptr_t)x2 & 15) == 0 && (n3 == 0 || ((uintptr_t)x3 & 15) == 0);
  if (B < 1 || N < 1 || n1 % 16 || n2 % 16 || n3 % 16 || nk < 1 || !aligned)
    return (int)cudaErrorInvalidValue;
  const HeadsF32Smem o = heads_f32_smem(NP, (nk + HD_S - 1) / HD_S);
  static size_t allowed[2] = {48 * 1024, 48 * 1024};
  auto kernel = act_bf16 ? heads_f32_kernel<true> : heads_f32_kernel<false>;
  const int err = allow_smem(kernel, (size_t)o.total, &allowed[act_bf16 ? 1 : 0]);
  if (err) return err;
  return launch_ex(kernel, dim3(HD_S, (B + HF_NTILE - 1) / HF_NTILE), dim3(HD_S, 1, 1),
                   HD_THREADS, (size_t)o.total, HD_PDL, stream, (const float*)wt, (const float*)b,
                   (const float*)x1, n1, (const float*)x2, n2, (const float*)x3, n3, (float*)out,
                   B, N);
}

// the f32 cell: grid (CF_S, H / CF_U), a cluster of CF_S blocks, with
// programmatic dependent launch (its first CF_PREFETCH weight chunks stream
// while the previous kernel ends); the input [x1 | x2 | xc | x3] (B, n_i)
// f32 each, n_i % 4 == 0, 16-byte aligned
// segment i of the f32 cell's input, (B, n) f32 at x, as CellMaps' map:
// boxes of 16 columns x rows
int make_cell_map(CUtensorMap* map, const void* x, int n, int B, int rows) {
  EncodeTiled encode = nullptr;
  const int found = encode_tiled(&encode);
  if (found) return found;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)B};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(float)};
  const cuuint32_t box[2] = {16, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the f32 cell: grid (CF_S, H / CF_U), a cluster of CF_S blocks, with
// programmatic dependent launch (its first CF_PREFETCH weight chunks stream
// while the previous kernel ends); the input [x1 | x2 | xc | x3] (B, n_i)
// f32 each, n_i % 16 == 0, 16-byte aligned (past CF_ROW_COPIES rows a tensor
// map of each segment is made here)
int launch_gate_cell_f32(const void* wt, const QuantInput& xin, const void* b, const void* c_in,
                         void* h_out, void* c_out, int B, int H, cudaStream_t stream) {
  const int R = xin.n[0] + xin.n[1] + xin.n[2] + xin.n[3], nk = (R + CF_KC - 1) / CF_KC;
  bool aligned = ((uintptr_t)wt & 15) == 0;
  for (int i = 0; i < kSeg; ++i)
    aligned = aligned && ((uintptr_t)xin.x[i] & 15) == 0 && xin.n[i] % 16 == 0;
  if (B < 1 || H < CF_U || H % CF_U || nk < CF_S || !aligned) return (int)cudaErrorInvalidValue;
  const int rows = (std::min(B, CF_NTILE) + 7) & ~7;
  const CellF32Smem o = cell_f32_smem(rows);
  if (o.stages < 2) return (int)cudaErrorInvalidValue;
  CellMaps xm = {};
  for (int i = 0; i < kSeg; ++i) {
    xm.x[i] = xin.x[i];
    xm.n[i] = xin.n[i];
    if (xin.n[i] == 0 || !cell_boxes(rows)) continue;
    const int err = make_cell_map(&xm.m[i], xin.x[i], xin.n[i], B, rows);
    if (err) return err;
  }
  const int inst = cf_nt(rows) == 1 ? 0 : cf_nt(rows) == 2 ? 1 : 2;
  auto kernel = inst == 0 ? gate_cell_f32_kernel<1>
                : inst == 1 ? gate_cell_f32_kernel<2> : gate_cell_f32_kernel<CF_NT>;
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  const int err = allow_smem(kernel, (size_t)o.total, &allowed[inst]);
  if (err) return err;
  return launch_ex(kernel, dim3(CF_S, H / CF_U), dim3(CF_S, 1, 1), CF_THREADS, (size_t)o.total,
                   true, stream, (const float*)wt, xm, (const float*)b, (const float*)c_in,
                   (float*)h_out, (float*)c_out, B, H);
}

QuantInput f32_input(const void* x1, int n1, const void* x2, int n2, const void* xc, int nc,
                     const void* x3, int n3) {
  return QuantInput{{(const float*)x1, (const float*)x2, (const float*)xc, (const float*)x3},
                    {n1, n2, nc, n3}};
}

}  // namespace

extern "C" {

// the LSTM cell over the tiled copy wt of its weights (pack_decoder): its
// input [x1 | x2 | xc | x3], (B, n_i) bf16 operands each, xc the controls
// (nc = 0: none); c_in, h_out, c_out (B, H) f32
int t2_lstm_cell(const void* wt, const void* b, const void* x1, int n1, const void* x2, int n2,
                 const void* xc, int nc, const void* x3, int n3, const void* c_in, void* h_out,
                 void* c_out, int B, int H, void* stream) {
  return launch_gate_cell<false>(wt, bf16_operand(x1, n1, x2, n2, xc, nc, x3, n3), nullptr,
                                 nullptr, b, c_in, h_out, c_out, nullptr, B, H,
                                 (cudaStream_t)stream);
}

// K5's operand: [x1 | x2 | xc | x3], (B, n_i) f32 each -> xq (B, n1 + n2 +
// nc + n3) int8, sx (B,) f32
int t2_quantize_xh(const void* x1, int n1, const void* x2, int n2, const void* xc, int nc,
                   const void* x3, int n3, void* xq, void* sx, int B, void* stream) {
  return launch_quantize_xh(x1, n1, x2, n2, xc, nc, x3, n3, xq, sx, B, (cudaStream_t)stream);
}

// K5: the LSTM cell over int8 weights with row scales ws on the operand
// that t2_quantize_xh made (xq, sx); n1, n2, nc, n3 the segments' widths
int t2_lstm_cell_int8(const void* wt, const void* ws, const void* b, const void* xq,
                      const void* sx, int n1, int n2, int nc, int n3, const void* c_in,
                      void* h_out, void* c_out, int B, int H, void* stream) {
  return launch_gate_cell<true>(wt, int8_operand(xq, n1, n2, nc, n3), ws, sx, b, c_in, h_out,
                                c_out, nullptr, B, H, (cudaStream_t)stream);
}

// the heads over the tiled copy wt of W_out (pack_decoder, tile_heads):
// [x1 | x2 | xc], (B, n_i) f32 each, xc the controls (nc = 0: none)
int t2_heads(const void* wt, const void* b, const void* x1, int n1, const void* x2, int n2,
             const void* xc, int nc, void* out, int B, int N, void* stream) {
  return launch_heads(wt, b, x1, n1, x2, n2, xc, nc, out, B, N, (cudaStream_t)stream);
}

// the prenet over the tiled copy wt of its weights (pack_decoder,
// tile_prenet): mel (B, M), m1, m2, out (B, P) f32
int t2_prenet(const void* mel, const void* wt, const void* m1, const void* m2, void* out, int B,
              int M, int P, void* stream) {
  return launch_prenet(mel, M, wt, m1, m2, out, nullptr, B, M, P, (cudaStream_t)stream);
}

// the attention over a cluster of S blocks per batch row: h (B, H), ctx_out
// (B, D) f32
int t2_location_attention(const void* h, const void* wq, const void* wloc, const void* wv,
                          const void* att_enc, const void* enc, const void* lengths,
                          const void* w_prev, const void* cum_prev, void* ctx_out, void* w_out,
                          void* cum_out, int B, int L, int H, int A, int D, int K, int S,
                          void* stream) {
  return launch_k1_att(h, wq, wloc, wv, att_enc, enc, lengths, w_prev, cum_prev, ctx_out, nullptr,
                       w_out, cum_out, B, L, H, A, D, K, S, (cudaStream_t)stream);
}

// K1's f32 mode, one kernel each (the same arguments as the bf16 entries;
// act_bf16: the int8 mode's rounding of an F32 model's activations)
int t2_lstm_cell_f32(const void* wt, const void* b, const void* x1, int n1, const void* x2,
                     int n2, const void* xc, int nc, const void* x3, int n3, const void* c_in,
                     void* h_out, void* c_out, int B, int H, void* stream) {
  return launch_gate_cell_f32(wt, f32_input(x1, n1, x2, n2, xc, nc, x3, n3), b, c_in, h_out,
                              c_out, B, H, (cudaStream_t)stream);
}

int t2_prenet_f32(const void* mel, const void* wt, const void* m1, const void* m2, void* out,
                  int B, int M, int P, int act_bf16, void* stream) {
  return launch_prenet_f32(mel, M, wt, m1, m2, out, B, M, P, act_bf16 != 0,
                           (cudaStream_t)stream);
}

int t2_location_attention_f32(const void* h, const void* wq, const void* wloc, const void* wv,
                              const void* att_enc, const void* enc, const void* lengths,
                              const void* w_prev, const void* cum_prev, void* ctx_out,
                              void* w_out, void* cum_out, int B, int L, int H, int A, int D,
                              int K, int S, void* stream) {
  return launch_k1_att(h, wq, wloc, wv, att_enc, enc, lengths, w_prev, cum_prev, ctx_out, nullptr,
                       w_out, cum_out, B, L, H, A, D, K, S, (cudaStream_t)stream, true);
}

int t2_heads_f32(const void* wt, const void* b, const void* x1, int n1, const void* x2, int n2,
                 const void* xc, int nc, void* out, int B, int N, int act_bf16, void* stream) {
  return launch_heads_f32(wt, b, x1, n1, x2, n2, xc, nc, out, B, N, act_bf16 != 0,
                          (cudaStream_t)stream);
}

// n decode steps, five launches each, from one host call. Pointer slots:
//   p[0..10]  w_att b_att w_dec b_dec wp1_t wp2_t wq w_loc wv wt_out b_out
//             (wt_out: the heads' tiled copy of w_out, pack_decoder's)
//   p[11..13] att_enc encoded lengths
//   p[14..15] prenet masks m1 m2, (n, B, P) each
//   p[16..23] state in: mel att_h att_c ctx att_w att_cum rnn_h rnn_c
//   p[24..25] out: mel_gate (n, B, M+1), aligns (n, B, L)
//   p[26]     scratch: prenet output (B, P)
//   p[27..32] state ping-pong, (2, B, width) each: att_h att_c ctx att_cum rnn_h rnn_c
//   p[33..34] int8 mode: the gate-row scales of w_att and w_dec, (4H,) f32
//   p[35..36] the cells' tiled weight copies of w_att and w_dec (pack_decoder)
//   p[37..40] bf16 mode: the cells' bf16 operands, written by their
//             producers: prenet output (B, P), context (B, D), and att_h and
//             rnn_h (2, B, H) each in ping-pong, slot 1 holding the state in
//   p[41..42] int8 mode: the cells' quantised operand, (B, max(R1, R2))
//             int8, and its row scales (B,) f32 (quantize_xh)
//   p[43]     the prenet's tiled weight copy (pack_decoder, tile_prenet)
//   p[44..45] the controls, E columns each (zero past the model's own):
//             (B, E) f32, which the heads and K5's quantize_xh read, and its
//             bf16 operand (B, E), which K1's decoder cell reads; staged once
//             per decode (the request's controls do not change); null where
//             E = 0
// Step t writes slot t % 2 and reads slot (t - 1) % 2 (the state in at t = 0);
// the previous attention weights and mel are the aligns and mel_gate rows of
// step t - 1. d = {n, B, M, P, H, D, L, A, K, mode, S, E}: mode bit 0 (int8),
// w_att and w_dec are int8 and both LSTM cells run on K5 (a quantize_xh
// launch before each); mode bit 1 (f32), the prenet's and the heads' weights
// (p[43], p[9]) are f32 copies (tile_prenet, tile_heads_f32), run by the f32
// entries: with bit 0 too (mode 3, the int8 mode of an F32 model) their
// activations rounded to bf16, the attention bf16; alone (mode 2, K1's f32
// mode) the cells on the f32 cell over f32 copies (p[35..36],
// tile_gates_f32), reading the f32 state and prenet output, the controls at
// p[44], and the attention over f32 weights and memory, nothing rounded; the
// bf16 operands p[37..40] and p[45] are not read (null). Five launches a
// step in mode 2, seven in mode 3. S blocks per batch row in the attention's cluster;
// E the controls' columns (a multiple of 16, or 0), with which the decoder
// cell reads [att_h | ctx | controls | rnn_h] (w_dec (4H, 2H + D + E)) and
// the heads [rnn_h | ctx | controls] (w_out (M + 1, H + D + E)), as
// _decode_chunk_kernel's xh (:534) and heads (:569). Each cell streams its
// first weight chunks while the launch before it runs (launch_gate_cell).
int t2_decode_chunk(void** p, const int* d, void* stream_) {
  const int n = d[0], B = d[1], M = d[2], P = d[3], H = d[4], D = d[5], L = d[6], A = d[7],
            K = d[8], N = M + 1;
  const bool int8 = (d[9] & 1) != 0, f32w = (d[9] & 2) != 0, f32 = f32w && !int8;
  const int S = d[10], E = d[11];
  cudaStream_t stream = (cudaStream_t)stream_;
  auto bslot = [&](int i, int t) -> bf16* { return (bf16*)p[i] + (size_t)(t & 1) * B * H; };
  // the cells' operands: bf16, the attention cell's for the att_h slot it
  // reads, (t - 1) % 2, and the decoder cell's for the slot pair it reads;
  // int8, the two layouts of the quantised operand
  CellOperand att_x[2], dec_x[2];
  for (int par = 0; par < 2 && !f32; ++par) {
    att_x[par] = int8 ? int8_operand(p[41], P, D, 0, H)
                      : bf16_operand(p[37], P, p[38], D, nullptr, 0, bslot(39, par), H);
    dec_x[par] = int8 ? int8_operand(p[41], H, D, E, H)
                      : bf16_operand(bslot(39, par), H, p[38], D, p[45], E, bslot(40, par + 1), H);
  }
  int err = 0;
  // xf: the f32 cell's input (f32 mode)
  auto cell = [&](const CellOperand& xo, const QuantInput& xf, int wt, int b, int scale,
                  const void* c_in, void* h_out, void* c_out, void* h_bf) {
    if (f32) return launch_gate_cell_f32(p[wt], xf, p[b], c_in, h_out, c_out, B, H, stream);
    return int8 ? launch_gate_cell<true>(p[wt], xo, p[scale], p[42], p[b], c_in, h_out, c_out,
                                         nullptr, B, H, stream)
                : launch_gate_cell<false>(p[wt], xo, nullptr, nullptr, p[b], c_in, h_out, c_out,
                                          h_bf, B, H, stream);
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
    err = f32w ? launch_prenet_f32(mel, first ? M : N, p[43], (const float*)p[14] + mo,
                                   (const float*)p[15] + mo, p[26], B, M, P, int8, stream)
               : launch_prenet(mel, first ? M : N, p[43], (const float*)p[14] + mo,
                               (const float*)p[15] + mo, p[26], int8 ? nullptr : p[37], B, M, P,
                               stream);
    if (!err && int8)
      err = launch_quantize_xh(p[26], P, ctx, D, nullptr, 0, att_h, H, p[41], p[42], B, stream);
    if (!err)
      err = cell(att_x[(t - 1) & 1], f32_input(p[26], P, ctx, D, nullptr, 0, att_h, H), 35, 1, 33,
                 att_c, slot(27, t, H), slot(28, t, H), bslot(39, t));
    if (!err)
      err = launch_k1_att(slot(27, t, H), p[6], p[7], p[8], p[11], p[12], p[13], att_w, cum,
                          slot(29, t, D), int8 || f32 ? nullptr : p[38], al + (size_t)t * B * L,
                          slot(30, t, L), B, L, H, A, D, K, S, stream, f32);
    if (!err && int8)
      err = launch_quantize_xh(slot(27, t, H), H, slot(29, t, D), D, p[44], E, rnn_h, H, p[41],
                               p[42], B, stream);
    if (!err)
      err = cell(dec_x[t & 1], f32_input(slot(27, t, H), H, slot(29, t, D), D, p[44], E, rnn_h, H),
                 36, 3, 34, rnn_c, slot(31, t, H), slot(32, t, H), bslot(40, t));
    if (!err)
      err = f32w ? launch_heads_f32(p[9], p[10], slot(31, t, H), H, slot(29, t, D), D, p[44], E,
                                    mg + (size_t)t * B * N, B, N, int8, stream)
                 : launch_heads(p[9], p[10], slot(31, t, H), H, slot(29, t, D), D, p[44], E,
                                mg + (size_t)t * B * N, B, N, stream);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
