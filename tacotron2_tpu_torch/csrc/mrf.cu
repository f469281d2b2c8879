// Kernel K2: the HiFi-GAN MRF stage, for sm_90a (wgmma, TMA, mbarriers).
//
// Replaces the three stage kernels of tacotron2_tpu/ops/mrf_pallas.py
// (_make_stage_kernel, _make_stage_kernel_ups, _make_stage_kernel_ups_expand):
// [lrelu -> ConvTranspose1d] -> mean over resblocks of
// [lrelu -> dilated conv -> (lrelu -> conv) -> + residual], channels-last.
//
//   t2_mrf_conv        from the bf16 operand a = bf16(lrelu(x)) (B, T, Ci):
//                      v = conv_d(a) + bias (+ res), and any of y = v (f32),
//                      act = bf16(lrelu(v)) (the next conv's operand) and
//                      acc_out = (acc_in) + scale * v (the stage mean), or
//                      that sum's operand (the next stage's upsample's
//                      input). The upsample runs on it too: a transposed
//                      conv of stride u and kernel 2u is, in channels-last
//                      memory, a SAME 3-tap conv to u Co channels
//                      (ops/mrf.py::fold_upsample)
//   t2_mrf_pair        a ResBlock1 pair in one launch: t2_mrf_conv of the
//                      second conv (dilation 1) on the operand of the
//                      first's output, which stays in shared memory
//   (conv_pre)         t2_mrf_conv of the vocoder's conv_pre (num_mels ->
//                      initial channels, k = 7) on the bf16 mel, in the
//                      epilogue mode that rounds the sum to bf16 before the
//                      bias (JAX's conv1d_apply under a bf16 policy) and
//                      writes only act, stage 1's upsample operand
//
// Bound: the stage is bound by operations (~0.6 GFLOP per mel frame for
// UNIVERSAL_V1, ~0.6 us at 989 TFLOP/s bf16); with one launch per conv, as
// here, each conv also moves its activations through device memory.
//
// t2_mrf_conv (conv_wgmma_kernel) is an implicit GEMM on Hopper's
// warpgroup tensor-core products: M = output samples, N = output channels,
// K = Ci x taps.
// - Two consumer warpgroups of MT m64 tiles each (a block of 128 or 256
//   samples, MT from the shape) issue wgmma m64nNk16 (N = NI = 32, 64 or
//   128 channels) with both operands in shared memory, f32 sums in
//   registers. A block takes NI channels (blockIdx.y): the weight copy's N
//   tile (128, 64 or 32 by Co), or a part of it where the grid would leave
//   SMs idle (conv_plan).
// - A: the operand's slice of KC input channels (64, or 32; the last slice
//   may reach past Ci, a multiple of 8, as conv_pre's 80 mel channels: the
//   tensor map's channel extent is Ci, so TMA reads zeros there, and the
//   weight copy is zero past Ci) over the
//   block's samples and the dilated halo, staged once per slice by TMA from
//   a 3-D (B, T, C) tensor map, so rows outside [0, T) read zero and never
//   the neighbouring batch row. It lies in shared memory as [8-channel
//   group][row][8 channels], the no-swizzle core-matrix layout: the
//   descriptor of tap j starts at row (m tile) + j dil, any row (16-byte
//   steps), so every tap of the slice reads the one staged copy.
// - B: the weights, NI x KC per (slice, tap), from a copy tiled once at
//   load (ops/mrf.py::tile_conv) in the same core-matrix layout; a stage of
//   the 4-stage mbarrier ring, fed by one producer warp, holds up to 32 KB
//   of consecutive taps of one slice as one 1-D bulk copy (at C = 32 all 11
//   taps: one tap's 2 KB would leave the tensor cores waiting on barriers),
//   or, where NI is a part of the copy's N tile, one copy per tap and
//   8-channel group.
// - Each output's sum runs over (slice, tap, 16-channel step) in that one
//   order whatever B, T or the tile: a served request's audio does not
//   depend on its window. (A narrower N, or the fused pair, whose first
//   conv's tiles start at other rows, gives the same bits: chip_smoke.py
//   holds both to it.)
// - The epilogue adds bias and residual and writes only what the next
//   conv and the stage mean read: act = bf16(lrelu(v)) is exactly what the
//   next conv's prologue would compute from v, so the intermediate of a
//   ResBlock1 pair is never written as f32; fused (t2_mrf_pair, channels
//   up to 128: one N tile, so one block has every channel of the
//   intermediate) it is never written at all.
// The folded upsample (UNIVERSAL_V1: Ci 512 -> 8 x 256, 256 -> 8 x 128,
// 128 -> 2 x 64, 64 -> 2 x 32) is such a conv of K = 3; the tap a phase
// does not reach is a zero tile, kept (1.5x the transposed conv's flops,
// the stage's MRF convs do ~20x more). Its output, written as y (the
// residual stream) and act, is the transposed conv's, (B, u Tin, Co).
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() (cudaErrorInvalidValue for dimensions it does
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float x) { return x > 0.0f ? x : kSlope * x; }

// ---------------------------------------------------------------------------
// mrf_conv: wgmma implicit GEMM fed by TMA (see the top of the file)
// ---------------------------------------------------------------------------
constexpr int kWG = 2;                            // consumer warpgroups
constexpr int kConvThreads = 32 * (4 * kWG + 1);  // and one producer warp
constexpr int kStages = 4;                        // the weight ring's depth
constexpr int kStageBytes = 32768;                // weight tiles a ring stage holds at most

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

// d[N / 2] += A (64 x 16, descriptor da) . B (16 x N, descriptor db), bf16
// operands, f32 sums
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// Shared memory of one block: the A slices (rows_p x KC bf16 each, one or
// two buffers), the weight ring (nslot stages of G taps' NI x KC tiles),
// then the mbarriers; 1024 bytes of slack to align the start.
inline size_t conv_smem(int NI, int KC, int rows_p, int na, int G, int nslot) {
  return 1024 + (size_t)na * rows_p * KC * 2 + (size_t)nslot * G * NI * KC * 2 +
         (2 * kStages + 4) * sizeof(uint64_t);
}

// The consumers' view of the weight ring: its mbarriers, the stages' bytes
// and how stages map to (slice, taps); n1 stages are the first conv's
struct Ring {
  uint64_t *full, *empty, *afull, *aempty;
  uint32_t w_base, st_bytes, w_bytes;
  int nslot, kg, G, K, n1, lane;
};

// stage it's products are done: free its slot (and, at the first conv's
// last tap of a slice, its A buffer)
__device__ __forceinline__ void ring_release(const Ring& r, int it) {
  __syncwarp();
  if (r.lane == 0) {
    mbar_arrive(r.empty + it % r.nslot);
    if (it < r.n1 && it % r.kg == r.kg - 1) mbar_arrive(r.aempty + ((it / r.kg) & 1));
  }
}

// One warpgroup's products over ring stages [it0, it1) into acc, against an
// A operand in shared memory at a_base: the first conv's slices from TMA
// (wait_a: slice s in buffer s % 2, a_step bytes apart) or the pair's staged
// operand (slice s a_step bytes in); its 8-channel groups lbo bytes apart,
// taps tdil rows apart; warpgroup wg's rows from wg MT 64. Ends with every
// product done and its stages released.
template <int NI, int MT>
__device__ __forceinline__ void conv_mainloop(float (&acc)[MT][NI / 2], const Ring& r, int it0,
                                              int it1, uint32_t a_base, uint32_t a_step,
                                              uint32_t lbo, int tdil, bool wait_a, int KC,
                                              int wg) {
  const uint32_t w_lbo = NI * 16;
  for (int it = it0; it < it1; ++it) {
    const int i1 = it - it0, s = i1 / r.kg, j0 = (i1 - s * r.kg) * r.G;
    const int gn = min(r.G, r.K - j0), slot = it % r.nslot;
    if (wait_a && j0 == 0) mbar_wait(r.afull + (s & 1), (s >> 1) & 1);
    mbar_wait(r.full + slot, (it / r.nslot) & 1);
    __syncwarp();
    wgmma_fence();
    for (int jj = 0; jj < gn; ++jj) {
      const uint32_t a0 = a_base + (wait_a ? (s & 1) : s) * a_step +
                          (uint32_t)(wg * MT * 64 + (j0 + jj) * tdil) * 16;
      const uint32_t w0 = r.w_base + slot * r.st_bytes + jj * r.w_bytes;
      for (int kk = 0; kk < KC / 16; ++kk) {
        const uint64_t db = smem_desc(w0 + kk * 2 * w_lbo, w_lbo, 128);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_tile<NI>(acc[mt], smem_desc(a0 + mt * 64 * 16 + kk * 2 * lbo, lbo, 128), db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    if (it > it0) ring_release(r, it - 1);
  }
  wgmma_wait<0>();
  ring_release(r, it1 - 1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) asm volatile("" : "+f"(acc[mt][i])::"memory");
}

// grid (ceil(T / BMo), Co / NI, B), block kConvThreads, BM = 2 MT 64.
// a_map: the operand (B, T, Ci) bf16, boxes of 8 channels x box_rows rows
// x 1 batch row; wt: the tiled weights (tile_conv: per N tile of wni
// channels, slice and tap, wni x KC as [KC/8][wni][8]; wni a multiple of
// NI); bias (Co) f32; res, acc_in, acc_out, y
// (B, T, Co) f32 and act (B, T, Co) bf16 where given (mode & 3 = 0: no
// acc_out; 1: acc_out = scale v; 2: acc_out = acc_in + scale v; mode & 4:
// acc_out (B, T, Co) bf16 gets that sum's operand, bf16(lrelu(sum)), what
// the next stage's upsample would compute from it; mode & 8: the f32 sum
// is rounded to bf16 before the bias, v = bf16(sum) + bias, as JAX's
// conv1d_apply emits a bf16 policy's type: conv_pre). A ring stage holds
// the tiles of G consecutive taps of one slice (one bulk copy: small tiles
// would leave the tensor cores waiting on the ring's barriers), nslot
// stages.
//
// PAIR: a ResBlock1 pair in one launch, c2(bf16(lrelu(c1(a)))) with c2 of
// dilation 1 (wt2, bias2) and Ci = Co = NI. The block first computes c1
// over its BM rows starting K/2 rows before its outputs, writes their
// operand (0 outside [0, T), c2's padding) into shared memory where the A
// slices were, and then runs c2 on it: BMo = BM - (K - 1) outputs a block,
// the c1 rows of the halo computed twice. The weight ring runs on from
// c1's stages into c2's. Without PAIR, BMo = BM.
template <int NI, int MT, bool PAIR>
__global__ void __launch_bounds__(kConvThreads, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap a_map, const bf16* __restrict__ wt,
                  const float* __restrict__ bias, const bf16* __restrict__ wt2,
                  const float* __restrict__ bias2, const float* __restrict__ res,
                  const float* __restrict__ acc_in, float* __restrict__ acc_out,
                  float* __restrict__ y, bf16* __restrict__ act, int T, int Ci, int Co, int wni,
                  int K, int dil, int KC, int box_rows, int nbox, int G, int nslot, int mode,
                  float scale) {
  constexpr int BM = kWG * MT * 64;
  constexpr int NACC = NI / 2;  // f32 sums a thread holds per m64 tile
  const int ns = (Ci + KC - 1) / KC, ncg = KC / 8, kg = (K + G - 1) / G, n1 = ns * kg;
  const int n_it = PAIR ? 2 * n1 : n1;
  const int rows_p = box_rows * nbox, na = ns > 1 ? 2 : 1;
  const int rows_t = (BM + K - 1 + 7) & ~7;  // PAIR: c1's operand rows in shared memory
  const uint32_t a_bytes = (uint32_t)rows_p * KC * 2, w_bytes = (uint32_t)NI * KC * 2;
  const uint32_t st_bytes = G * w_bytes;
  const int bmo = PAIR ? BM - (K - 1) : BM;
  const int t0 = blockIdx.x * bmo, nt = blockIdx.y, b = blockIdx.z;
  const int r0 = PAIR ? t0 - (K - 1) / 2 : t0;  // the first row of the first conv's tile
  extern __shared__ uint8_t conv_raw[];
  uint8_t* abuf = reinterpret_cast<uint8_t*>(((uintptr_t)conv_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* wbuf = abuf + na * a_bytes;
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
    for (int i = 0; i < 2; ++i) {
      mbar_init(afull + i, 1);
      mbar_init(aempty + i, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWG) {
    // producer: stage it = (slice s, taps j0 .. j0 + gn - 1) is those taps'
    // weight tiles of N tile nt and slice s (one run), into ring slot it %
    // nslot once its last use is done; at j0 = 0 of the first conv the
    // slice of the operand goes first into A buffer s % 2. PAIR: stages
    // n1 .. 2 n1 - 1 are the second conv's weights. The block's NI channels
    // are columns nsub .. nsub + NI - 1 of the copy's N tile nt NI / wni.
    if (lane == 0) {
      const int x_row = r0 - dil * (K - 1) / 2;
      const int nsub = nt * NI % wni;
      for (int it = 0; it < n_it; ++it) {
        const bool first = it < n1;
        const int i1 = first ? it : it - n1;
        const int s = i1 / kg, j0 = (i1 - s * kg) * G, gn = min(G, K - j0), slot = it % nslot;
        if (first && j0 == 0) {
          const int ab = s & 1;
          if (s >= 2) mbar_wait(aempty + ab, ((s >> 1) - 1) & 1);
          mbar_expect_tx(afull + ab, a_bytes);
          uint8_t* dst = abuf + ab * a_bytes;
          for (int gq = 0; gq < ncg; ++gq)
            for (int q = 0; q < nbox; ++q)
              tma_load_3d(dst + ((size_t)gq * rows_p + q * box_rows) * 16, &a_map,
                          s * KC + gq * 8, x_row + q * box_rows, b, afull + ab);
        }
        const bf16* wn = (first ? wt : wt2) + (size_t)(nt * NI / wni) * ns * K * wni * KC +
                         ((size_t)s * K + j0) * wni * KC;
        if (it >= nslot) mbar_wait(empty + slot, ((it / nslot) - 1) & 1);
        mbar_expect_tx(full + slot, gn * w_bytes);
        if (wni == NI) {
          bulk_load(wbuf + slot * st_bytes, wn, gn * w_bytes, full + slot);
        } else {
          for (int jj = 0; jj < gn; ++jj)
            for (int gq = 0; gq < ncg; ++gq)
              bulk_load(wbuf + slot * st_bytes + ((size_t)jj * ncg + gq) * NI * 16,
                        wn + (size_t)jj * wni * KC + ((size_t)gq * wni + nsub) * 8, NI * 16,
                        full + slot);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns m64 tiles wg MT .. wg MT + MT - 1 of the block
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, q = lane & 3;
  float acc[MT][NACC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[mt][i] = 0.0f;
  const uint32_t a_base = smem_u32(abuf);
  const Ring ring = {full, empty, afull, aempty, smem_u32(wbuf), st_bytes, w_bytes,
                     nslot, kg, G, K, n1, lane};
  conv_mainloop<NI, MT>(acc, ring, 0, n1, a_base, a_bytes, (uint32_t)rows_p * 16, dil, true, KC,
                        wg);

  // register i * 4 + h * 2 + e of m tile mt is row 16 (warp % 4) + lane / 4
  // + 8 h of the tile, column 8 i + 2 (lane % 4) + e
  if constexpr (PAIR) {
    // the first conv's operand, 0 outside [0, T), into [C / 8][rows_t][8]
    // over the A buffers (every warpgroup is done reading them)
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
    bf16* tbuf = reinterpret_cast<bf16*>(abuf);
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
          const float v0 = acc[mt][i * 4 + h * 2] + bb.x, v1 = acc[mt][i * 4 + h * 2 + 1] + bb.y;
          *reinterpret_cast<__nv_bfloat162*>(tbuf + ((size_t)i * rows_t + lr) * 8 + q * 2) =
              in ? __floats2bfloat162_rn(lrelu(v0), lrelu(v1)) : __floats2bfloat162_rn(0.f, 0.f);
          acc[mt][i * 4 + h * 2] = 0.0f;
          acc[mt][i * 4 + h * 2 + 1] = 0.0f;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
    conv_mainloop<NI, MT>(acc, ring, n1, n_it, a_base, (uint32_t)KC / 8 * rows_t * 16,
                          (uint32_t)rows_t * 16, 1, false, KC, wg);
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
        float s0 = acc[mt][i * 4 + h * 2], s1 = acc[mt][i * 4 + h * 2 + 1];
        if (mode & 8) {
          s0 = __bfloat162float(__float2bfloat16_rn(s0));
          s1 = __bfloat162float(__float2bfloat16_rn(s1));
        }
        float v0 = s0 + bb.x, v1 = s1 + bb.y;
        if (res != nullptr) {
          const float2 rv = *reinterpret_cast<const float2*>(res + o);
          v0 += rv.x;
          v1 += rv.y;
        }
        if (y != nullptr) *reinterpret_cast<float2*>(y + o) = make_float2(v0, v1);
        if (act != nullptr)
          *reinterpret_cast<__nv_bfloat162*>(act + o) = __floats2bfloat162_rn(lrelu(v0), lrelu(v1));
        if (mode & 3) {
          float s0 = scale * v0, s1 = scale * v1;
          if ((mode & 3) == 2) {
            const float2 av = *reinterpret_cast<const float2*>(acc_in + o);
            s0 = av.x + scale * v0;
            s1 = av.y + scale * v1;
          }
          if (mode & 4)
            *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(acc_out) + o) =
                __floats2bfloat162_rn(lrelu(s0), lrelu(s1));
          else
            *reinterpret_cast<float2*>(acc_out + o) = make_float2(s0, s1);
        }
      }
    }
  }
}

// The tile plan of one conv: the weight copy's N tile (WN, by Co: 128, 64
// or 32), N per instruction and per block (NI: WN, or down to kMinSplitN
// where even 128-sample blocks leave SMs idle), input channels per staged
// slice (KC; the last may reach past Ci), m64 tiles per warpgroup (MT: 2 where the grid still fills
// the card at 256 samples a block, else 1), and the operand's TMA boxes
// (nbox boxes of box_rows rows, at most 256 each).
constexpr int kMinSplitN = 64;

struct ConvPlan {
  int WN, NI, KC, MT, box_rows, nbox, rows_p, na, G, nslot;
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

// pair: a fused ResBlock1 pair (Ci = Co <= 128, one N tile; MT = 2 always,
// so its tiles, BM - (K - 1) outputs, do not follow the batch)
int conv_plan(int B, int T, int Ci, int Co, int K, int dil, bool pair, ConvPlan* p) {
  if (B < 1 || T < 1 || Ci % 8 || Co % 32 || K % 2 == 0 || dil < 1)
    return (int)cudaErrorInvalidValue;
  p->WN = p->NI = Co % 128 == 0 ? 128 : (Co % 64 == 0 ? 64 : 32);
  p->KC = Ci % 64 == 0 ? 64 : 32;
  if (pair && (Ci != Co || Co != p->WN)) return (int)cudaErrorInvalidValue;
  p->MT = pair || (long long)((T + 255) / 256) * B * (Co / p->NI) >= sm_count() ? 2 : 1;
  while (!pair && p->MT == 1 && p->NI > kMinSplitN &&
         (long long)((T + 127) / 128) * B * (Co / p->NI) < sm_count())
    p->NI /= 2;
  const int ntiles = Co / p->NI;
  const int bm = kWG * p->MT * 64, rows = bm + (K - 1) * dil;
  p->nbox = (rows + 255) / 256;
  p->box_rows = ((rows + p->nbox - 1) / p->nbox + 7) & ~7;
  p->rows_p = p->nbox * p->box_rows;
  const int ns = (Ci + p->KC - 1) / p->KC;
  p->na = ns > 1 ? 2 : 1;
  if (p->box_rows > 256) return (int)cudaErrorInvalidValue;
  const int tile = p->NI * p->KC * 2, convs = pair ? 2 : 1;
  if (pair && ((bm + K - 1 + 7) & ~7) * Co * 2 > p->na * p->rows_p * p->KC * 2)
    return (int)cudaErrorInvalidValue;  // the pair's operand does not fit the A buffers
  p->G = std::max(1, std::min(K, kStageBytes / tile));
  p->nslot = std::min(kStages, convs * ns * ((K + p->G - 1) / p->G));
  p->smem = conv_smem(p->NI, p->KC, p->rows_p, p->na, p->G, p->nslot);
  while (p->smem > 227 * 1024 && p->G > 1) {  // fewer taps a stage where it does not fit
    p->G = (p->G + 1) / 2;
    p->nslot = std::min(kStages, convs * ns * ((K + p->G - 1) / p->G));
    p->smem = conv_smem(p->NI, p->KC, p->rows_p, p->na, p->G, p->nslot);
  }
  if (p->smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int bmo = pair ? bm - (K - 1) : bm;
  p->grid = dim3((T + bmo - 1) / bmo, ntiles, B);
  return 0;
}

// the operand (B, T, C) bf16 as a 3-D TMA map, boxes of 8 channels x
// box_rows rows x 1 batch row, no swizzle; rows outside [0, T) read zero
int make_act_map(CUtensorMap* map, const void* base, int B, int T, int C, int box_rows) {
  EncodeTiled encode = nullptr;
  const int err = encode_tiled(&encode);
  if (err) return err;
  if (((uintptr_t)base & 15) || C % 8) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(bf16), (cuuint64_t)T * C * sizeof(bf16)};
  const cuuint32_t box[3] = {8, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NI, int MT, bool PAIR>
int launch_wgmma(const ConvPlan& p, const CUtensorMap& map, const void* wt, const void* bias,
                 const void* wt2, const void* bias2, const void* res, const void* acc_in,
                 void* acc_out, void* y, void* act, int T, int Ci, int Co, int K, int dil,
                 int mode, float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  if (p.smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(conv_wgmma_kernel<NI, MT, PAIR>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)p.smem);
    if (err != cudaSuccess) return (int)err;
    allowed = p.smem;
  }
  conv_wgmma_kernel<NI, MT, PAIR><<<p.grid, kConvThreads, p.smem, stream>>>(
      map, (const bf16*)wt, (const float*)bias, (const bf16*)wt2, (const float*)bias2,
      (const float*)res, (const float*)acc_in, (float*)acc_out, (float*)y, (bf16*)act, T, Ci, Co,
      p.WN, K, dil, p.KC, p.box_rows, p.nbox, p.G, p.nslot, mode, scale);
  return (int)cudaGetLastError();
}

// one conv, or with wt2 a fused ResBlock1 pair (see conv_wgmma_kernel)
int launch_mrf(const void* a, const void* wt, const void* bias, const void* wt2,
               const void* bias2, const void* res, const void* acc_in, void* acc_out, void* y,
               void* act, int B, int T, int Ci, int Co, int K, int dil, int mode, float scale,
               cudaStream_t stream) {
  const bool pair = wt2 != nullptr;
  if (((mode & 3) == 2 && acc_in == nullptr) || ((mode & 3) != 0) != (acc_out != nullptr) ||
      mode < 0 || mode > 14 || (mode & 3) == 3 || (pair && (mode & 8)) || ((uintptr_t)wt & 15) ||
      ((uintptr_t)wt2 & 15) ||
      (pair && bias2 == nullptr))
    return (int)cudaErrorInvalidValue;
  ConvPlan p;
  int err = conv_plan(B, T, Ci, Co, K, dil, pair, &p);
  if (err) return err;
  CUtensorMap map;
  err = make_act_map(&map, a, B, T, Ci, p.box_rows);
  if (err) return err;
#define T2_CONV(NI_, MT_, PAIR_)                                                                \
  if (p.NI == NI_ && p.MT == MT_ && pair == PAIR_)                                              \
    return launch_wgmma<NI_, MT_, PAIR_>(p, map, wt, bias, wt2, bias2, res, acc_in, acc_out, y, \
                                         act, T, Ci, Co, K, dil, mode, scale, stream);
  T2_CONV(128, 2, false)
  T2_CONV(128, 1, false)
  T2_CONV(64, 2, false)
  T2_CONV(64, 1, false)
  T2_CONV(32, 2, false)
  T2_CONV(32, 1, false)
  T2_CONV(128, 2, true)
  T2_CONV(64, 2, true)
  T2_CONV(32, 2, true)
#undef T2_CONV
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a (B, T, Ci) bf16 = bf16(lrelu(x)), wt the tiled weights of a (K, Co, Ci)
// conv of dilation dil: v = conv_dil(a) + bias (+ res), SAME; y, act and
// acc_out where given (mode as conv_wgmma_kernel); Ci a multiple of 8
int t2_mrf_conv(const void* a, const void* wt, const void* bias, const void* res,
                const void* acc_in, void* acc_out, void* y, void* act, int B, int T, int Ci,
                int Co, int K, int dil, int mode, float scale, void* stream) {
  return launch_mrf(a, wt, bias, nullptr, nullptr, res, acc_in, acc_out, y, act, B, T, Ci, Co, K,
                    dil, mode, scale, (cudaStream_t)stream);
}

// a ResBlock1 pair in one launch: v = conv_1(bf16(lrelu(conv_dil(a) +
// bias1))) + bias2 (+ res), both convs (K, C, C), C <= 128; outputs as
// t2_mrf_conv
int t2_mrf_pair(const void* a, const void* wt1, const void* bias1, const void* wt2,
                const void* bias2, const void* res, const void* acc_in, void* acc_out, void* y,
                void* act, int B, int T, int C, int K, int dil, int mode, float scale,
                void* stream) {
  if (wt2 == nullptr) return (int)cudaErrorInvalidValue;
  return launch_mrf(a, wt1, bias1, wt2, bias2, res, acc_in, acc_out, y, act, B, T, C, C, K, dil,
                    mode, scale, (cudaStream_t)stream);
}

}  // extern "C"
