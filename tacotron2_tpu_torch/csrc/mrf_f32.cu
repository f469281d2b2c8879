// Kernel K2, f32 mode: the HiFi-GAN MRF stage at f32 precision, for sm_90a
// (wgmma, TMA, mbarriers).
//
// Replaces the three stage kernels of tacotron2_tpu/ops/mrf_pallas.py in
// their bf16=False mode (_make_stage_kernel :285, launched at :488;
// _make_stage_kernel_ups :378, launched at :583; _make_stage_kernel_ups_expand
// :312, launched at :675; their operands and weights f32: `_dt =
// jnp.float32` at :463, :540, :636), the mode of every vocode of the JAX
// package (its HiFi-GAN's default policy is F32), and the vocoder's conv_pre
// (tacotron2_tpu/models/hifigan.py:366, XLA). Same function as csrc/mrf.cu,
// with f32 operands and weights, f32 products and f32 sums:
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
// Bound: operations. A UNIVERSAL_V1 vocode does ~0.6 GFLOP per mel frame.
// The card's route to products f32 keeps is a three-pass TF32 split on the
// tensor cores: 3 x the flops at 495 TFLOP/s, ~3.6 us a frame (at the CUDA
// cores' 67 TFLOP/s FFMA, the design this one replaced, ~9 us).
//
// The arithmetic. Each f32 value x is split into hi = tf32_rna(x) (its low
// 13 mantissa bits zero) and lo = x - hi (exact in f32; the tensor core
// reads it truncated to tf32). Each product is a_lo w_hi + a_hi w_lo +
// a_hi w_hi, issued in that order, the two small terms before the large
// one, into the f32 wgmma accumulators; lo lo (~2^-22 of the product) is
// left out. kPasses names the passes, for the planted defects of
// chip_smoke.py (copies of this file with some left out).
//
// Design: an implicit GEMM on Hopper's warpgroup products, M = output
// samples, N = output channels, K = Ci x taps (the pipeline of csrc/mrf.cu,
// rethought for 4-byte elements and three passes).
// - Two consumer warpgroups of MT m64 tiles each (a block of 128, 256 or,
//   for a pair at C = 32, 512 samples) issue wgmma m64nNk8 tf32 (N = NI =
//   128, 64 or 32 channels, MT NI at most 128), both operands K-major in
//   shared memory (the only layout tf32 takes), f32 sums in registers. A
//   block takes NI channels (blockIdx.y): the weight copy's N tile (128, 64
//   or 32 by Co), or a part of it: 64 at MT = 2, and at 128 samples a block
//   narrower while that takes fewer waves of blocks x channels (one row:
//   stage 1 at 64 of 256 channels, conv_pre at 32).
// - The sums. The tensor cores' f32 accumulation truncates, and its bias
//   grows with the number of accumulations (a 1,536-term conv read 7.8e-6 of
//   its max in one accumulator on the card): each slice's products (K taps
//   x 2 k8 steps x 3 passes) go into their own wgmma accumulators, added,
//   rounded to nearest, into the running sums when the slice is done. So a
//   thread holds MT NI / 2 sums twice, and MT NI is at most 128.
// - Warp roles: two consumer warpgroups and a producer warpgroup, one warp
//   of which issues the copies; the producer gives its registers up
//   (setmaxnreg 40) so that a consumer thread holds 232, both sets of sums
//   without spilling (with 168 the pairs spilled and ran 11% slower).
// - A: the operand's slice of kKC = 16 input channels (the last may reach
//   past Ci, a multiple of 8: the tensor map's channel extent is Ci, so TMA
//   reads zeros there, and the weight copy is zero past Ci) over the block's
//   samples and the dilated halo, staged once per slice by TMA from a 3-D
//   (B, T, C) f32 tensor map, so rows outside [0, T) read zero and never the
//   neighbouring batch row; double-buffered. It lies as [4-channel
//   group][row][4 channels], the no-swizzle core-matrix layout (8 rows x 16
//   bytes): the descriptor of tap j starts j dil rows further into the one
//   staged copy. Where the operand is split: in shared memory, once per
//   slice, by the consumers (hi in place, lo into the buffer's second
//   plane), then a proxy fence and a barrier of the two warpgroups. That is
//   one pass over the slice (rows x 16 values) against its K taps x 6
//   products per m64 tile (~3% of the time, measured), and it leaves the
//   producers' epilogues and the C interface as they were: the operands
//   stay plain f32 tensors.
// - B: the weights, split once at load into hi and lo tiles side by side
//   per (N tile, slice, tap) (ops/mrf.py::tile_conv), NI x kKC each in the
//   same core-matrix layout; a stage of the mbarrier ring (2 to 4 stages,
//   as many as the shared memory beside the A region holds), fed by the
//   producer warp, holds up to 32 KB of consecutive taps of one slice as one
//   bulk copy or, where NI is a part of the copy's N tile, one copy per tap,
//   plane and 4-channel group. Measured on the card (chip_smoke.py-style
//   copies of this file): a stage's fixed cost (its barriers, the wait for
//   the previous stage's products) is what the pipeline pays most, so fewer,
//   larger stages run faster; a deeper ring, more A buffers or two stages'
//   products in flight did not.
// - Each output's sum runs over (slice, tap, k8 step, pass) in that one
//   order whatever B, T, the M tile, the N part or the grid, and K is never
//   split across blocks: a served request's audio does not depend on its
//   window, and the fused pair's first conv gives the bits of its own launch
//   (chip_smoke.py holds both).
// - PAIR: the block computes the first conv over its BM rows starting
//   (K - 1) / 2 before its outputs, writes lrelu of them (0 outside [0, T):
//   the second conv's padding) into shared memory over the A buffers, and
//   runs the second conv on that: BM - (K - 1) outputs a block. As hi and
//   lo planes, that intermediate is 147 KB at C = 128 for 128 rows (256
//   rows would not fit 227 KB), so the pair's M tile is the largest of 512,
//   256 and 128 rows that fits and keeps MT C <= 128, by C and K only
//   (conv_plan): 128 rows at C = 128, 256 at 64, 512 at 32. At C = 128 and
//   K >= 7 it stays as it is and each slice is split when the second conv
//   reads it, which leaves the ring a third stage.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (cudaErrorInvalidValue for dimensions it does
// not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "tma.cuh"

namespace {

constexpr float kSlope = 0.1f;
constexpr int kWG = 2;                            // consumer warpgroups
constexpr int kConvThreads = 128 * (kWG + 1);     // and a producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // a thread's registers (setmaxnreg)
constexpr int kStages = 4;                        // the weight ring's depth at most
constexpr int kStageBytes = 32768;                // weight tiles a ring stage holds at most
constexpr int kKC = 16;                           // input channels a staged slice
constexpr int kMinSplitN = 32;                    // the narrowest N part a block takes
constexpr int kAccum = 128;                       // MT x NI at most (two sets of sums)
constexpr size_t kMaxSmem = 227 * 1024;
// the products of a k8 step, issued in this order: 1 a_lo w_hi, 2 a_hi
// w_lo, 4 a_hi w_hi
constexpr int kPasses = 7;

__device__ __forceinline__ float lrelu(float x) { return x > 0.0f ? x : kSlope * x; }

// x rounded to tf32, to nearest, ties away from zero: the low 13 bits zero
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// A shared-memory matrix descriptor without swizzle, K-major: 8-row x
// 16-byte core matrices, lbo bytes apart along K, sbo bytes apart along M
// (or N); the start any 16-byte aligned address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[N / 2] += A (64 x 8, descriptor da) . B (8 x N, descriptor db), tf32
// operands (f32 bits, the low 13 read as zero), f32 sums
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int NI>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db) {
  if constexpr (NI == 128) wgmma_n128(d, da, db);
  else if constexpr (NI == 64) wgmma_n64(d, da, db);
  else wgmma_n32(d, da, db);
}

// The consumers' view of the weight ring: its mbarriers, the stages' bytes
// and how stages map to (slice, taps); n1 stages are the first conv's
struct Ring {
  uint64_t *full, *empty, *afull, *aempty;
  uint32_t w_base, st_bytes, w_bytes;
  int nslot, na, kg, G, K, n1, lane;
};

// stage it's products are done: free its slot (and, at the first conv's
// last tap of a slice, its A buffer)
__device__ __forceinline__ void ring_release(const Ring& r, int it) {
  __syncwarp();
  if (r.lane == 0) {
    mbar_arrive(r.empty + it % r.nslot);
    if (it < r.n1 && it % r.kg == r.kg - 1) mbar_arrive(r.aempty + (it / r.kg) % r.na);
  }
}

// A slice's f32 values at src (bytes of them) -> hi = tf32_rna(x) at dst
// (src itself where the slice was staged there) and lo = x - hi lo_off bytes
// further; every consumer thread, 16 bytes at a time, then a proxy fence
// (wgmma reads them) and a barrier of the consumers
__device__ __forceinline__ void split_slice(const uint8_t* src, uint8_t* dst, uint32_t bytes,
                                            uint32_t lo_off) {
  for (uint32_t i = threadIdx.x * 16; i < bytes; i += 128 * kWG * 16) {
    const float4 x = *reinterpret_cast<const float4*>(src + i);
    const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
    *reinterpret_cast<float4*>(dst + i) = h;
    *reinterpret_cast<float4*>(dst + lo_off + i) =
        make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
}

// One warpgroup's products over ring stages [it0, it1) into acc, against an
// A operand in shared memory at a_base (a_ptr generic): the first conv's
// slices from TMA (wait_a: slice s in buffer s % na, a_step bytes apart,
// its hi plane lo_off bytes, split in place when it lands), the pair's
// operand split per slice from src (src_step bytes a slice) into buffer s %
// 2, or the pair's split operand (slice s a_step bytes in); the lo plane
// lo_off bytes after the hi one, its 4-channel groups lbo bytes apart, taps
// tdil rows apart;
// warpgroup wg's rows from wg MT 64. Each slice's products go into part,
// which is added into acc, rounded to nearest, when the slice is done (the
// tensor cores' sums truncate). Ends with every product done and its
// stages released.
template <int NI, int MT>
__device__ __forceinline__ void conv_mainloop(float (&acc)[MT][NI / 2], float (&part)[MT][NI / 2],
                                              const Ring& r, int it0, int it1, uint32_t a_base,
                                              uint8_t* a_ptr, uint32_t a_step, uint32_t lo_off,
                                              uint32_t lbo, int tdil, bool wait_a,
                                              const uint8_t* src, uint32_t src_step, int wg) {
  const uint32_t w_lbo = NI * 16;
  int pend = -1;  // a stage whose products may still run
  for (int it = it0; it < it1; ++it) {
    const int i1 = it - it0, s = i1 / r.kg, j0 = (i1 - s * r.kg) * r.G;
    const int gn = min(r.G, r.K - j0), slot = it % r.nslot;
    const uint32_t a_s = (wait_a ? s % r.na : src != nullptr ? s & 1 : s) * a_step;
    if (wait_a && j0 == 0) {
      mbar_wait(r.afull + s % r.na, (s / r.na) & 1);
      split_slice(a_ptr + a_s, a_ptr + a_s, lo_off, lo_off);
    } else if (src != nullptr && j0 == 0) {
      split_slice(src + s * src_step, a_ptr + a_s, lo_off, lo_off);
    }
    mbar_wait(r.full + slot, (it / r.nslot) & 1);
    __syncwarp();
    wgmma_fence();
    for (int jj = 0; jj < gn; ++jj) {
      const uint32_t a0 = a_base + a_s + (uint32_t)(wg * MT * 64 + (j0 + jj) * tdil) * 16;
      const uint32_t w0 = r.w_base + slot * r.st_bytes + jj * 2 * r.w_bytes;
#pragma unroll
      for (int kk = 0; kk < kKC / 8; ++kk) {
        const uint64_t bh = smem_desc(w0 + kk * 2 * w_lbo, w_lbo, 128);
        const uint64_t bl = smem_desc(w0 + r.w_bytes + kk * 2 * w_lbo, w_lbo, 128);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t am = a0 + mt * 64 * 16 + kk * 2 * lbo;
          const uint64_t ah = smem_desc(am, lbo, 128), al = smem_desc(am + lo_off, lbo, 128);
          if constexpr ((kPasses & 1) != 0) wgmma_tile<NI>(part[mt], al, bh);
          if constexpr ((kPasses & 2) != 0) wgmma_tile<NI>(part[mt], ah, bl);
          if constexpr ((kPasses & 4) != 0) wgmma_tile<NI>(part[mt], ah, bh);
        }
      }
    }
    wgmma_commit();
    if (j0 + gn < r.K) {  // the slice goes on: the previous stage's products are done
      wgmma_wait<1>();
      if (pend >= 0) ring_release(r, pend);
      pend = it;
      continue;
    }
    wgmma_wait<0>();  // the slice is done: its sums into acc
    if (pend >= 0) ring_release(r, pend);
    ring_release(r, it);
    pend = -1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) {
        asm volatile("" : "+f"(part[mt][i])::"memory");
        acc[mt][i] += part[mt][i];
        part[mt][i] = 0.0f;
      }
  }
}

// grid (ceil(T / BMo), Co / NI, B), block kConvThreads, BM = 2 MT 64.
// a_map: the operand (B, T, Ci) f32, boxes of 4 channels x box_rows rows x
// 1 batch row; wt: the tiled weights (tile_conv: per N tile of wni
// channels, slice and tap, the hi and lo tiles [2][kKC / 4][wni][4]; wni a
// multiple of NI); bias (Co); res, acc_in, acc_out, y, act (B, T, Co) f32
// where given (mode & 3 = 0: no acc_out; 1: acc_out = scale v; 2: acc_out =
// acc_in + scale v; mode & 4: acc_out = lrelu of that sum; mode & 8 the
// identity). A ring stage holds the hi and lo tiles of G consecutive taps
// of one slice, nslot stages; the A region a_region bytes (na A buffers,
// each a hi and a lo plane of box_rows nbox rows; PAIR: or the
// intermediate, the larger).
//
// PAIR: a ResBlock1 pair in one launch, c2(lrelu(c1(a))) with c2 of
// dilation 1 (wt2, bias2) and Ci = Co = NI. The block first computes c1
// over its BM rows starting K/2 rows before its outputs, writes its operand
// (0 outside [0, T), c2's padding) [C / 4][rows_t][4] over the A buffers,
// as hi and lo planes or (split2) as it is, followed by two slices' hi and
// lo planes that c2 splits it into, and then runs c2 on it: BMo = BM - (K -
// 1) outputs a block, the c1 rows of the halo computed twice. The weight
// ring runs on from c1's stages into c2's. Without PAIR, BMo = BM.
template <int NI, int MT, bool PAIR>
__global__ void __launch_bounds__(kConvThreads, 1)
conv_tf32_kernel(const __grid_constant__ CUtensorMap a_map, const float* __restrict__ wt,
                 const float* __restrict__ bias, const float* __restrict__ wt2,
                 const float* __restrict__ bias2, const float* __restrict__ res,
                 const float* __restrict__ acc_in, float* __restrict__ acc_out,
                 float* __restrict__ y, float* __restrict__ act, int T, int Ci, int Co, int wni,
                 int K, int dil, int box_rows, int nbox, int G, int nslot, int na,
                 uint32_t a_region, bool split2, int mode, float scale) {
  constexpr int BM = kWG * MT * 64;
  constexpr int NACC = NI / 2;  // f32 sums a thread holds per m64 tile, in acc and in part
  static_assert(MT * NI <= kAccum, "a thread's sums do not fit its registers");
  static_assert(128 * (kProducerRegs + kWG * kConsumerRegs) <= 65536, "the register file");
  const int ns = (Ci + kKC - 1) / kKC, kg = (K + G - 1) / G, n1 = ns * kg;
  const int n_it = PAIR ? 2 * n1 : n1;
  const int rows_p = box_rows * nbox;
  const int rows_t = (BM + K - 1 + 7) & ~7;  // PAIR: c1's operand rows in shared memory
  const uint32_t a_bytes = (uint32_t)rows_p * kKC * 4;  // one plane of a staged slice
  const uint32_t w_bytes = (uint32_t)NI * kKC * 4;      // one plane of a tap's tile
  const uint32_t st_bytes = G * 2 * w_bytes;
  const int bmo = PAIR ? BM - (K - 1) : BM;
  const int t0 = blockIdx.x * bmo, nt = blockIdx.y, b = blockIdx.z;
  const int r0 = PAIR ? t0 - (K - 1) / 2 : t0;  // the first row of the first conv's tile
  extern __shared__ uint8_t conv_raw[];
  uint8_t* abuf = reinterpret_cast<uint8_t*>(((uintptr_t)conv_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* wbuf = abuf + a_region;
  uint64_t* full = reinterpret_cast<uint64_t*>(wbuf + nslot * st_bytes);
  uint64_t* empty = full + kStages;
  uint64_t* afull = empty + kStages;
  uint64_t* aempty = afull + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < nslot; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kWG);
    }
    for (int i = 0; i < na; ++i) {
      mbar_init(afull + i, 1);
      mbar_init(aempty + i, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp > 4 * kWG) return;
    // producer: stage it = (slice s, taps j0 .. j0 + gn - 1) is those taps'
    // hi and lo tiles of N tile nt and slice s (one run), into ring slot it
    // % nslot once its last use is done; at j0 = 0 of the first conv the
    // slice of the operand goes first into A buffer s % 2 (its hi plane).
    // PAIR: stages n1 .. 2 n1 - 1 are the second conv's weights. The
    // block's NI channels are columns nsub .. nsub + NI - 1 of the copy's N
    // tile nt NI / wni.
    if (lane == 0) {
      const int x_row = r0 - dil * (K - 1) / 2;
      const int nsub = nt * NI % wni;
      for (int it = 0; it < n_it; ++it) {
        const bool first = it < n1;
        const int i1 = first ? it : it - n1;
        const int s = i1 / kg, j0 = (i1 - s * kg) * G, gn = min(G, K - j0), slot = it % nslot;
        if (first && j0 == 0) {
          const int ab = s % na;
          if (s >= na) mbar_wait(aempty + ab, ((s / na) - 1) & 1);
          mbar_expect_tx(afull + ab, a_bytes);
          uint8_t* dst = abuf + ab * 2 * a_bytes;
          for (int gq = 0; gq < kKC / 4; ++gq)
            for (int q = 0; q < nbox; ++q)
              tma_load_3d(dst + ((size_t)gq * rows_p + q * box_rows) * 16, &a_map,
                          s * kKC + gq * 4, x_row + q * box_rows, b, afull + ab);
        }
        const float* wn = (first ? wt : wt2) +
                          (((size_t)(nt * NI / wni) * ns + s) * K + j0) * 2 * wni * kKC;
        if (it >= nslot) mbar_wait(empty + slot, ((it / nslot) - 1) & 1);
        mbar_expect_tx(full + slot, gn * 2 * w_bytes);
        if (wni == NI) {
          bulk_load(wbuf + slot * st_bytes, wn, gn * 2 * w_bytes, full + slot);
        } else {
          for (int c = 0; c < gn * 2 * (kKC / 4); ++c)  // (tap, plane, 4-channel group)
            bulk_load(wbuf + slot * st_bytes + (size_t)c * NI * 16,
                      wn + ((size_t)c * wni + nsub) * 4, NI * 16, full + slot);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns m64 tiles wg MT .. wg MT + MT - 1 of the block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, q = lane & 3;
  float acc[MT][NACC], part[MT][NACC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[mt][i] = part[mt][i] = 0.0f;
  const uint32_t a_base = smem_u32(abuf);
  const Ring ring = {full, empty, afull, aempty, smem_u32(wbuf), st_bytes, w_bytes,
                     nslot, na, kg, G, K, n1, lane};
  conv_mainloop<NI, MT>(acc, part, ring, 0, n1, a_base, abuf, 2 * a_bytes, a_bytes,
                        (uint32_t)rows_p * 16, dil, true, nullptr, 0, wg);

  // register i * 4 + h * 2 + e of m tile mt is row 16 (warp % 4) + lane / 4
  // + 8 h of the tile, column 8 i + 2 (lane % 4) + e
  if constexpr (PAIR) {
    // the first conv's operand, 0 outside [0, T), [C / 4][rows_t][4] over
    // the A buffers (every warpgroup is done reading them): split into hi
    // and lo planes, or (split2) as it is, split per slice when the second
    // conv reads it (half the bytes: a 128-row block's at C = 128 leaves the
    // ring three stages); rows past BM are read only for outputs past BMo
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
    float* hi = reinterpret_cast<float*>(abuf);
    float* lo = hi + (size_t)rows_t * NI;
    const uint32_t inter_bytes = (uint32_t)rows_t * NI * 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = (wg * MT + mt) * 64 + wl * 16 + g + 8 * h, t = r0 + lr;
        const bool in = t >= 0 && t < T;
#pragma unroll
        for (int i = 0; i < NI / 8; ++i) {
          const int co = i * 8 + q * 2;
          const float2 bb = *reinterpret_cast<const float2*>(bias + co);
          const float v0 = in ? lrelu(acc[mt][i * 4 + h * 2] + bb.x) : 0.0f;
          const float v1 = in ? lrelu(acc[mt][i * 4 + h * 2 + 1] + bb.y) : 0.0f;
          const size_t o = ((size_t)(co >> 2) * rows_t + lr) * 4 + (co & 3);
          if (split2) {
            *reinterpret_cast<float2*>(hi + o) = make_float2(v0, v1);
          } else {
            const float h0 = tf32_rna(v0), h1 = tf32_rna(v1);
            *reinterpret_cast<float2*>(hi + o) = make_float2(h0, h1);
            *reinterpret_cast<float2*>(lo + o) = make_float2(v0 - h0, v1 - h1);
          }
          acc[mt][i * 4 + h * 2] = 0.0f;
          acc[mt][i * 4 + h * 2 + 1] = 0.0f;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
    const uint32_t slice_bytes = (uint32_t)(kKC / 4) * rows_t * 16;
    if (split2)  // two buffers of a slice's hi and lo planes after the operand
      conv_mainloop<NI, MT>(acc, part, ring, n1, n_it, a_base + inter_bytes, abuf + inter_bytes,
                            2 * slice_bytes, slice_bytes, (uint32_t)rows_t * 16, 1, false, abuf,
                            slice_bytes, wg);
    else
      conv_mainloop<NI, MT>(acc, part, ring, n1, n_it, a_base, abuf, slice_bytes, inter_bytes,
                            (uint32_t)rows_t * 16, 1, false, nullptr, 0, wg);
  }

  // epilogue (of the second conv where PAIR)
  const float* bo = PAIR ? bias2 : bias;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = (wg * MT + mt) * 64 + wl * 16 + g + 8 * h, t = t0 + lr;
      if (lr >= bmo || t >= T) continue;
      const size_t ro = ((size_t)b * T + t) * Co;
#pragma unroll
      for (int i = 0; i < NI / 8; ++i) {
        const int co = nt * NI + i * 8 + q * 2;
        const size_t o = ro + co;
        const float2 bb = *reinterpret_cast<const float2*>(bo + co);
        float v0 = acc[mt][i * 4 + h * 2] + bb.x, v1 = acc[mt][i * 4 + h * 2 + 1] + bb.y;
        if (res != nullptr) {
          const float2 rv = *reinterpret_cast<const float2*>(res + o);
          v0 += rv.x;
          v1 += rv.y;
        }
        if (y != nullptr) *reinterpret_cast<float2*>(y + o) = make_float2(v0, v1);
        if (act != nullptr)
          *reinterpret_cast<float2*>(act + o) = make_float2(lrelu(v0), lrelu(v1));
        if (mode & 3) {
          float s0 = scale * v0, s1 = scale * v1;
          if ((mode & 3) == 2) {
            const float2 av = *reinterpret_cast<const float2*>(acc_in + o);
            s0 = av.x + scale * v0;
            s1 = av.y + scale * v1;
          }
          if (mode & 4) {
            s0 = lrelu(s0);
            s1 = lrelu(s1);
          }
          *reinterpret_cast<float2*>(acc_out + o) = make_float2(s0, s1);
        }
      }
    }
  }
}

// The tile plan of one conv: the weight copy's N tile (WN, by Co: 128, 64
// or 32), N per instruction and per block (NI: WN, or down to kMinSplitN
// where even 128-sample blocks leave SMs idle), m64 tiles per warpgroup (MT:
// 2 where the grid still fills the card at 256 samples a block, else 1; a
// pair the larger that fits, by its shape only), the operand's TMA boxes
// (nbox boxes of box_rows rows, at most 256 each), the A region, and the
// weight ring (G taps a stage, nslot stages).
struct ConvPlan {
  int WN, NI, MT, box_rows, nbox, G, nslot, na;
  bool split2;  // a pair's intermediate kept as it is, split per slice
  uint32_t a_region;
  size_t smem;
  dim3 grid;
};

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// bytes of shared memory but the weight ring's
size_t fixed_smem(uint32_t a_region) {
  return 1024 + a_region + (2 * kStages + 4) * sizeof(uint64_t);
}

int conv_plan(int B, int T, int Ci, int Co, int K, int dil, bool pair, ConvPlan* p) {
  if (B < 1 || B > 65535 || T < 1 || Ci < 8 || Ci % 8 || Co % 32 || K % 2 == 0 || dil < 1)
    return (int)cudaErrorInvalidValue;
  p->WN = Co % 128 == 0 ? 128 : (Co % 64 == 0 ? 64 : 32);
  if (pair && (Ci != Co || Co != p->WN)) return (int)cudaErrorInvalidValue;
  const int ns = (Ci + kKC - 1) / kKC, convs = pair ? 2 : 1, sms = sm_count();
  for (int mt = pair ? 4 : 2; mt >= 1; mt /= 2) {
    const int ni2 = std::min(p->WN, kAccum / 2);  // N a block takes at MT = 2
    if (!pair && mt == 2 && (long long)((T + 255) / 256) * B * (Co / ni2) < sms) continue;
    p->MT = mt;
    p->NI = pair ? p->WN : std::min(p->WN, kAccum / mt);
    if (pair && mt * p->NI > kAccum) continue;
    // at 128 rows a block, a narrower N part where it takes fewer waves of
    // blocks x channels (one row: stage 1 at 64 of 256 channels, 96 blocks)
    for (long long b = (long long)((T + 127) / 128) * B * (Co / p->NI);
         !pair && mt == 1 && p->NI > kMinSplitN &&
         (2 * b + sms - 1) / sms * (p->NI / 2) < (b + sms - 1) / sms * p->NI;
         b *= 2)
      p->NI /= 2;
    const int bm = kWG * mt * 64, rows = bm + (K - 1) * dil;
    p->nbox = (rows + 255) / 256;
    p->box_rows = ((rows + p->nbox - 1) / p->nbox + 7) & ~7;
    if (p->box_rows > 256) continue;
    // the A buffers (two where there are two slices or more; more did not
    // run faster on the card), the pair's intermediate, then the weight
    // ring: stages of G taps' hi and lo tiles, at most kStageBytes and fewer
    // where two stages do not fit (measured: fewer, larger stages beat a
    // deeper ring), as many stages as fit up to kStages
    p->na = ns > 1 ? 2 : 1;
    size_t region = (size_t)p->na * 2 * p->nbox * p->box_rows * kKC * 4;
    // a pair's intermediate: hi and lo planes, or at C = 128 and K >= 7 the
    // operand itself and two slices' planes, which leaves the ring a third
    // stage (14.8 against 16.4 ms at k = 11; at k = 3 the per-slice split
    // costs more than it gains)
    const size_t rows_t = (bm + K - 1 + 7) & ~7;
    p->split2 = pair && Co > 64 && K >= 7;
    if (pair) region = std::max(region, p->split2 ? rows_t * (Co * 4 + 4 * kKC * 4)
                                                  : 2 * rows_t * Co * 4);
    p->a_region = (uint32_t)region;
    const size_t fixed = fixed_smem(p->a_region);
    if (fixed >= kMaxSmem) continue;
    const int tile = 2 * p->NI * kKC * 4;
    int n_it = 0;
    for (p->G = std::max(1, std::min(K, kStageBytes / tile));; p->G = (p->G + 1) / 2) {
      n_it = convs * ns * ((K + p->G - 1) / p->G);
      p->nslot = std::min<int>({kStages, n_it, (int)((kMaxSmem - fixed) / ((size_t)p->G * tile))});
      if (p->nslot >= std::min(2, n_it) || p->G == 1) break;
    }
    if (p->nslot < std::min(2, n_it)) continue;
    p->smem = fixed + (size_t)p->nslot * p->G * tile;
    const int bmo = pair ? bm - (K - 1) : bm;
    if (bmo < 1) continue;
    p->grid = dim3((T + bmo - 1) / bmo, Co / p->NI, B);
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// the operand (B, T, C) f32 as a 3-D TMA map, boxes of 4 channels x
// box_rows rows x 1 batch row, no swizzle; rows outside [0, T) and channels
// past C read zero
int make_act_map(CUtensorMap* map, const void* base, int B, int T, int C, int box_rows) {
  EncodeTiled encode = nullptr;
  const int err = encode_tiled(&encode);
  if (err) return err;
  if (((uintptr_t)base & 15) || C % 4) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(float), (cuuint64_t)T * C * sizeof(float)};
  const cuuint32_t box[3] = {4, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NI, int MT, bool PAIR>
int launch_tf32(const ConvPlan& p, const CUtensorMap& map, const float* wt, const float* bias,
                const float* wt2, const float* bias2, const float* res, const float* acc_in,
                float* acc_out, float* y, float* act, int T, int Ci, int Co, int K, int dil,
                int mode, float scale, cudaStream_t stream) {
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_tf32_kernel<NI, MT, PAIR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  conv_tf32_kernel<NI, MT, PAIR><<<p.grid, kConvThreads, p.smem, stream>>>(
      map, wt, bias, wt2, bias2, res, acc_in, acc_out, y, act, T, Ci, Co, p.WN, K, dil,
      p.box_rows, p.nbox, p.G, p.nslot, p.na, p.a_region, p.split2, mode, scale);
  return (int)cudaGetLastError();
}

// one conv, or with wt2 a fused ResBlock1 pair (see conv_tf32_kernel)
int launch_mrf_f32(const void* a, const void* wt, const void* bias, const void* wt2,
                   const void* bias2, const void* res, const void* acc_in, void* acc_out, void* y,
                   void* act, int B, int T, int Ci, int Co, int K, int dil, int mode, float scale,
                   cudaStream_t stream) {
  const bool pair = wt2 != nullptr;
  if (((mode & 3) == 2 && acc_in == nullptr) || ((mode & 3) != 0) != (acc_out != nullptr) ||
      mode < 0 || mode > 15 || (mode & 3) == 3 || (pair && (mode & 8)) ||
      (pair && bias2 == nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {a, wt, bias, wt2, bias2, res, acc_in, (const void*)acc_out, (const void*)y,
                        (const void*)act})
    if ((uintptr_t)p & 15) return (int)cudaErrorInvalidValue;
  ConvPlan p;
  int err = conv_plan(B, T, Ci, Co, K, dil, pair, &p);
  if (err) return err;
  CUtensorMap map;
  err = make_act_map(&map, a, B, T, Ci, p.box_rows);
  if (err) return err;
  const float *fw = (const float*)wt, *fb = (const float*)bias, *fw2 = (const float*)wt2,
              *fb2 = (const float*)bias2, *fr = (const float*)res, *fi = (const float*)acc_in;
  float *fo = (float*)acc_out, *fy = (float*)y, *fact = (float*)act;
#define T2_TF32(NI_, MT_, PAIR_)                                                              \
  if (p.NI == NI_ && p.MT == MT_ && pair == PAIR_)                                            \
    return launch_tf32<NI_, MT_, PAIR_>(p, map, fw, fb, fw2, fb2, fr, fi, fo, fy, fact, T, Ci, \
                                        Co, K, dil, mode, scale, stream);
  T2_TF32(128, 1, false)
  T2_TF32(64, 2, false)
  T2_TF32(64, 1, false)
  T2_TF32(32, 2, false)
  T2_TF32(32, 1, false)
  T2_TF32(128, 1, true)
  T2_TF32(64, 2, true)
  T2_TF32(64, 1, true)
  T2_TF32(32, 4, true)
  T2_TF32(32, 2, true)
  T2_TF32(32, 1, true)
#undef T2_TF32
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a (B, T, Ci) f32 = lrelu(x) (conv_pre: the mel), wt the f32 tiled weights
// (hi and lo planes) of a (K, Co, Ci) conv of dilation dil: v =
// conv_dil(a) + bias (+ res), SAME; y, act and acc_out where given (mode as
// conv_tf32_kernel); Ci a multiple of 8, Co of 32
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
