// The back half of a Swin block (K1 / K3) at C <= 256 as one persistent,
// warp-specialised CTA per SM:
//   h1  = bf16(x + bf16((ctx . Wp^T + proj_b) x dp1))     (scattered rows)
//   out = bf16(h1 + (gelu(LN2(h1) . W1^T + b1) . W2^T + b2) x dp2)
// for ctx (T, C) bf16 in window order (the attention's output) and x, out
// (B, D, H, W, C) bf16 in spatial order: window row r is token
// win_row_to_token(r), the cyclic shift of K3 included, so the store carries
// the shift back.
//
// Replaces, on the H100, what _block_kernel (lrce_tpu/ops/pallas_swin_block.py
// l.81-119) and _one_block (lrce_tpu/ops/pallas_swin_pair.py) do after the
// attention on the TPU: proj, the residual, LN2 and an FF-chunked fc1 ->
// GELU -> fc2 in one program, the hidden never leaving VMEM. Before this
// kernel the port ran them as four launches (proj, LN2, fc1, fc2) with h1,
// the LN2 output and the (T, 4C) GELU hidden making round trips through
// device memory: about 13 units of (T, C) bf16 a call. Here only ctx and x
// are read and out is written.
//
// Per tile of 128 window rows (two consumer warpgroups of 64 rows):
//   - proj: wgmma from the ctx tile (A, shared memory) and Wp in 64-deep
//     k-blocks (B, through the ring); + proj_b, x dp1, rounded, + x as a
//     bf16 add: h1, which stays in the accumulator registers for LN2 and in
//     shared memory (each thread's own words) for the last residual;
//   - LN2 in f32 on the registers (the row's sums over a quad of lanes),
//     the bf16 result written over the warpgroup's own rows of the ctx
//     tile as fc1's A operand;
//   - FF in chunks of 64: fc1 (m64n64k16, W1's 64 rows through the ring)
//     into 32 registers, + b1 and exact-erf GELU in f32, rounded to bf16
//     and packed straight into wgmma's register A fragments of fc2
//     (m64n128k16 with A in registers, W2's 64 columns through the ring),
//     which accumulates the whole FF sum in 64 (C = 128) or 128 (C = 256)
//     registers; the hidden never leaves the registers;
//   - + b2, x dp2, + h1 in f32, rounded once, stored to spatial order.
// x comes in and out goes back as 16-byte chunks of whole rows through
// each warp's share of the h1 area (a warp instruction moves 8 rows x 64
// contiguous bytes): with 4-byte accesses in the accumulators' layout the
// two took a seventh of the kernel's time (0.726 -> 0.628 ms at stage 0,
// 48 clips, tools/piece_bench.py on an NVIDIA H100 80GB HBM3, 700.00 W).
// One thread of a producer warpgroup feeds a ring of stages (one stage =
// one 64-deep k-block of Wp, 64 rows of W1 or 64 columns of W2: C x 128
// bytes) with TMA copies completed on mbarriers, and the next tile's ctx
// rows (two ctx buffers at C = 128, one at C = 256 where shared memory runs
// out). setmaxnreg moves registers from the producer warpgroup (40) to the
// consumers (232).
//
// What bounds it on the H100: the exact-erf GELU, 4 T C of them, about 30
// FP32 instructions each, issued by the consumers' eight warps (the
// largest part of their time in clock64() counts of an instrumented
// build); then 18 T C^2
// operations of the tensor cores and the weights (Wp + W1 + W2 = 9 C^2
// bf16, 288 KB at C = 128 and 1.1 MB at C = 256) read again from L2 for
// every 128-row tile, 64 operations per L2 byte at C = 128. A cluster of
// CTAs sharing each weight stage through TMA multicast, or a 256-row tile
// (twice the consumers' accumulator registers), would cut the latter; both
// are left for later. ptxas compiles the consumers within the 168
// registers of a 384-thread CTA: at C = 256 (fc2's accumulator 128 of
// them) it spills 676 bytes. At C = 512 (stage 2) that accumulator alone
// would be 256 registers a thread: K1 / K3 keep separate launches there
// (proj, LN2, fc1, fc2 on the shared GEMM).
#include "swin_common.cuh"

#include "hopper.cuh"

#include <stdint.h>

namespace lrce {
namespace {

#define LRCE_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

constexpr int BH_ROWS = 128;     // window rows a tile
constexpr int BH_FC = 64;        // FF chunk
constexpr int BH_THREADS = 384;  // producer + two consumer warpgroups
constexpr int BH_PRODUCER_REGS = 40, BH_CONSUMER_REGS = 232;

template <int C>
struct BackHalf {
  static constexpr int UNIT = C * 128;          // one ring stage, bytes
  static constexpr int STAGES = C == 128 ? 6 : 3;
  static constexpr int NCTX = C == 128 ? 2 : 1; // ctx / z buffers
  static constexpr int CTX = BH_ROWS * C * 2;   // a ctx tile, bytes
  static constexpr int H1 = BH_ROWS * C * 2;    // h1 of a tile, bytes
  static constexpr int NB = 2 * STAGES + 2 * NCTX;  // mbarriers
  static constexpr size_t SMEM =
      1024 + (size_t)NCTX * CTX + H1 + (size_t)STAGES * UNIT + 8 * NB;
};

struct BackHalfArgs {
  const bf16* ctx;
  const bf16* x;
  bf16* out;
  const bf16* proj_w;
  const float* proj_b;
  const float* ln_s;
  const float* ln_b;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const float* dp1;
  const float* dp2;
  long long dp_rows;
  long long T;
  float eps;
  WinGeom g;
};

// kProj = false: the MLP core alone (K8): the tile's rows of x come by TMA
// where ctx does (contiguous rows, no window scatter), LN runs on them and
// x stays as the residual in place of h1; no proj, no dp1.
template <int C, bool kProj>
__global__ void __launch_bounds__(BH_THREADS, 1)
back_half_kernel(const __grid_constant__ CUtensorMap tm_ctx,
                 const __grid_constant__ CUtensorMap tm_wp,
                 const __grid_constant__ CUtensorMap tm_w1,
                 const __grid_constant__ CUtensorMap tm_w2,
                 const __grid_constant__ BackHalfArgs p) {
  using L = BackHalf<C>;
  constexpr int FF = 4 * C, NCH = FF / BH_FC, KB = C / 64, NH = C / 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ctxz = base;                      // NCTX x CTX
  const uint32_t h1s = ctxz + L::NCTX * L::CTX;    // per-thread words
  const uint32_t ring = h1s + L::H1;
  const uint32_t full = ring + L::STAGES * L::UNIT;
  const uint32_t empty = full + 8 * L::STAGES;
  const uint32_t cfull = empty + 8 * L::STAGES;
  const uint32_t cempty = cfull + 8 * L::NCTX;
  const int tid = threadIdx.x, wg = tid >> 7;
  const long long tiles = (p.T + BH_ROWS - 1) / BH_ROWS;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    for (int b = 0; b < L::NCTX; ++b) {
      mbar_init(cfull + 8 * b, 1);
      mbar_init(cempty + 8 * b, 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues the TMA copies: the ctx (x) tile,
    // then per tile KB (none without proj) + 2 NCH weight units
    setmaxnreg_dec<BH_PRODUCER_REGS>();
    if (tid != 0) return;
    int s = 0, cb = 0;
    uint32_t phase = 0, cphase = 0;
    auto unit = [&]() {  // wait for a free stage, expect one unit's bytes
      mbar_wait(empty + 8 * s, phase ^ 1);
      mbar_expect_tx(full + 8 * s, L::UNIT);
      return ring + s * L::UNIT;
    };
    auto next = [&]() {
      if (++s == L::STAGES) {
        s = 0;
        phase ^= 1;
      }
    };
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (int)(tile * BH_ROWS);
      // the ctx rows (zeros past T), KB blocks of 64 columns
      mbar_wait(cempty + 8 * cb, cphase ^ 1);
      mbar_expect_tx(cfull + 8 * cb, L::CTX);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        tma_load_2d(ctxz + cb * L::CTX + kb * (BH_ROWS * 128), &tm_ctx,
                    kb * 64, m0, cfull + 8 * cb);
      if (++cb == L::NCTX) {
        cb = 0;
        cphase ^= 1;
      }
      // Wp, one 64-deep k-block a stage: C rows of 128 bytes
      if constexpr (kProj)
        for (int kb = 0; kb < KB; ++kb) {
          tma_load_2d(unit(), &tm_wp, kb * 64, 0, full + 8 * s);
          next();
        }
      for (int f = 0; f < NCH; ++f) {
        // W1 rows f*64 .. + 63, all of C: KB blocks of 64 rows x 128 bytes
        const uint32_t d1 = unit();
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
          tma_load_2d(d1 + kb * 8192, &tm_w1, kb * 64, f * BH_FC,
                      full + 8 * s);
        next();
        // W2 columns f*64 .. + 63 of every row: C rows of 128 bytes
        tma_load_2d(unit(), &tm_w2, f * BH_FC, 0, full + 8 * s);
        next();
      }
    }
    return;
  }

  // ---- consumers. Ring units are numbered as the producer fills them;
  // unit u lies in stage u % STAGES, its fill of parity (u / STAGES) & 1.
  // Per tile: Wp k-blocks 0 .. KB-1, then W1(f) = KB + 2f, W2(f) = KB +
  // 2f + 1 (KB = 0 without proj). The consumers may take W1(f + 1)
  // before W2(f): a unit's predecessor in its stage was always taken
  // before.
  constexpr int KP = kProj ? KB : 0;  // Wp units a tile
  setmaxnreg_inc<BH_CONSUMER_REGS>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ct = tid - 128;  // 0..255: this thread's h1 words
  const bool leader = (tid & 127) == 0;
  int cb = 0;
  uint32_t cphase = 0, ubase = 0;
  auto take = [&](uint32_t u) {  // wait for unit u; its stage's address
    const uint32_t st = u % L::STAGES;
    mbar_wait(full + 8 * st, (u / L::STAGES) & 1);
    return ring + st * L::UNIT;
  };
  auto give = [&](uint32_t u) {
    if (leader) mbar_arrive(empty + 8 * (u % L::STAGES));
  };

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m0 = tile * BH_ROWS;
    const uint32_t az = ctxz + cb * L::CTX + cw * 8192;  // this WG's rows
    const uint32_t u1 = ubase + KP;  // W1(f) = u1 + 2f, W2(f) = u1 + 2f + 1
    mbar_wait(cfull + 8 * cb, cphase);

    // The rows of this thread's fragments: half 0 -> g, half 1 -> g + 8
    bool live[2];
    float k1[2], k2[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long row = m0 + cw * 64 + warp * 16 + g + 8 * hf;
      live[hf] = row < p.T;
      k1[hf] = kProj && live[hf] && p.dp1 ? p.dp1[row / p.dp_rows] : 1.f;
      k2[hf] = live[hf] && p.dp2 ? p.dp2[row / p.dp_rows] : 1.f;
    }
    // x in, out back: as 16-byte chunks, lane l moving chunks l / 8, + 4,
    // ... of rows l % 8 and l % 8 + 8 of this warp's 16 (a warp
    // instruction: 8 rows x 64 contiguous bytes). Chunk J of row (g, hf)
    // is the words (2 J + hf, threads 4 g .. 4 g + 3 of the warp) of the
    // per-thread h1 area, 16 contiguous bytes: the residual lands where
    // each thread reads it, under the proj's products.
    const int cg = lane & 7, cq = lane >> 3;
    long long ctok[2];
    bool clive[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long row = m0 + cw * 64 + warp * 16 + cg + 8 * hf;
      clive[hf] = row < p.T;
      ctok[hf] = !clive[hf] ? 0 : kProj ? win_row_to_token(p.g, row) : row;
    }
    const uint32_t cbase = h1s + (uint32_t)(ct - (lane & 31) + 4 * cg) * 4;
    __syncwarp();  // the last tile's output has left this warp's words
    if constexpr (kProj) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int jq = 0; jq < C / 32; ++jq) {
          const int J = 4 * jq + cq;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (clive[hf])
            v = *reinterpret_cast<const uint4*>(p.x + ctok[hf] * C + 8 * J);
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           cbase + (2 * J + hf) * 1024),
                       "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
        }
    }

    // proj: acc = ctx . Wp^T, one wgmma group in flight across k-blocks
    float acc[NH][64];
    if constexpr (kProj) {
      for (int kb = 0; kb < KB; ++kb) {
        const uint32_t sb = take(ubase + kb);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t da =
              wgmma_desc(az + kb * (BH_ROWS * 128) + ks * 32, 16, 1024);
#pragma unroll
          for (int h = 0; h < NH; ++h)
            wgmma_m64n128k16<0, 0>(
                acc[h], da, wgmma_desc(sb + h * 16384 + ks * 32, 16, 1024),
                kb > 0 || ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (kb > 0) give(ubase + kb - 1);
      }
      wgmma_wait<0>();
      give(ubase + KB - 1);
#pragma unroll
      for (int h = 0; h < NH; ++h) reg_fence(acc[h]);

      __syncwarp();  // this warp's x chunks are in
    }
    float sum[2] = {0.f, 0.f};
    if constexpr (kProj) {
      // h1 = bf16(x + bf16((acc + proj_b) x dp1)), kept as f32 in acc
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = h * 128 + 8 * j + 2 * t;
          const float2 pb = *reinterpret_cast<const float2*>(p.proj_b + col);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const uint32_t w = (uint32_t)((h * 16 + j) * 2 + hf);
            uint32_t xr;
            asm volatile("ld.shared.u32 %0, [%1];\n"
                         : "=r"(xr)
                         : "r"(h1s + (w * 256 + ct) * 4));
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&xr));
            float* a = &acc[h][4 * j + 2 * hf];
            const float a0 =
                __bfloat162float(__float2bfloat16((a[0] + pb.x) * k1[hf]));
            const float a1 =
                __bfloat162float(__float2bfloat16((a[1] + pb.y) * k1[hf]));
            a[0] = __bfloat162float(__float2bfloat16(a0 + xv.x));
            a[1] = __bfloat162float(__float2bfloat16(a1 + xv.y));
            sum[hf] += a[0] + a[1];
            // this thread's own words of h1: word (h, j, hf) at thread ct
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                             h1s + (w * 256 + ct) * 4),
                         "r"(pack_bf16x2(a[0], a[1])));
          }
        }
    } else {
      // x from the TMA tile, in the accumulators' layout: acc = x in f32,
      // and each thread's own words of it kept in the h1 area for the
      // residual (LN below writes z over the same addresses)
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = h * 128 + 8 * j + 2 * t;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const uint32_t w = (uint32_t)((h * 16 + j) * 2 + hf);
            const int r = warp * 16 + g + 8 * hf;
            uint32_t xr;
            asm volatile("ld.shared.u32 %0, [%1];\n"
                         : "=r"(xr)
                         : "r"(az + (col >> 6) * (BH_ROWS * 128) +
                               swz128(r, (col & 63) >> 3) + (col & 7) * 2));
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&xr));
            float* a = &acc[h][4 * j + 2 * hf];
            a[0] = xv.x;
            a[1] = xv.y;
            sum[hf] += a[0] + a[1];
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                             h1s + (w * 256 + ct) * 4),
                         "r"(xr));
          }
        }
    }
    // LN2 over the row: the four lanes of a quad hold it
    float mean[2], rstd[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = sum[hf];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      mean[hf] = v / (float)C;
    }
    float sq[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = acc[h][4 * j + 2 * hf + e] - mean[hf];
            sq[hf] += d * d;
          }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = sq[hf];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      rstd[hf] = rsqrtf(v / (float)C + p.eps);
    }
    // z = bf16(LN2(h1)) over this warpgroup's rows of the ctx tile, in
    // wgmma's swizzled A layout (64-column blocks of 128-byte rows)
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = h * 128 + 8 * j + 2 * t;
        const float2 gm = *reinterpret_cast<const float2*>(p.ln_s + col);
        const float2 bt = *reinterpret_cast<const float2*>(p.ln_b + col);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* a = &acc[h][4 * j + 2 * hf];
          const int r = warp * 16 + g + 8 * hf;
          const uint32_t addr = az + (col >> 6) * (BH_ROWS * 128) +
                                swz128(r, (col & 63) >> 3) + (col & 7) * 2;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr),
                       "r"(pack_bf16x2(
                           (a[0] - mean[hf]) * rstd[hf] * gm.x + bt.x,
                           (a[1] - mean[hf]) * rstd[hf] * gm.y + bt.y)));
        }
      }
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);  // the warpgroup's z is whole

    // fc1 -> GELU -> fc2, FF in chunks of 64; fc2 accumulates into acc
    auto fc1 = [&](int f, float (&hid)[32]) {
      const uint32_t sb = take(u1 + 2 * f);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n64k16(
              hid, wgmma_desc(az + kb * (BH_ROWS * 128) + ks * 32, 16, 1024),
              wgmma_desc(sb + kb * 8192 + ks * 32, 16, 1024),
              kb > 0 || ks > 0);
      wgmma_commit();
    };
    auto gelu = [&](int f, float (&hid)[32]) {  // + b1, GELU, in f32
      reg_fence(hid);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(
            p.b1 + f * BH_FC + 8 * j + 2 * t);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          hid[4 * j + 2 * hf] = gelu_erf(hid[4 * j + 2 * hf] + bb.x);
          hid[4 * j + 2 * hf + 1] = gelu_erf(hid[4 * j + 2 * hf + 1] + bb.y);
        }
      }
    };
    auto fc2 = [&](int f, const float (&hid)[32]) {  // hid rounds to bf16
      const uint32_t sb = take(u1 + 2 * f + 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4];
        wgmma_a_from_acc(hid, ks, a);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma_m64n128k16_rs(acc[h], a,
                              wgmma_desc(sb + h * 16384 + ks * 32, 16, 1024),
                              f > 0 || ks > 0);
      }
      wgmma_commit();
    };
    // fc2 must be done reading the hidden before the next fc1 writes it.
    // Measured slower at stage 0, 48 clips (tools/piece_bench.py, NVIDIA
    // H100 80GB HBM3, 700.00 W): two hidden buffers with the GELU of chunk f + 1 under fc2
    // of chunk f (0.770 against 0.742 ms), and the two warpgroups taking
    // turns at the tensor cores section by section (0.666 against 0.628).
    float hid[32];
    for (int f = 0; f < NCH; ++f) {
      fc1(f, hid);
      wgmma_wait<0>();
      give(u1 + 2 * f);
      gelu(f, hid);
      fc2(f, hid);
      wgmma_wait<0>();
      give(u1 + 2 * f + 1);
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
    if (leader) mbar_arrive(cempty + 8 * cb);  // z is no longer read
    if (++cb == L::NCTX) {
      cb = 0;
      cphase ^= 1;
    }
    ubase += KP + 2 * NCH;

    // out = bf16(h1 + (acc + b2) x dp2) over h1's words, then back to
    // spatial order as 16-byte chunks
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = h * 128 + 8 * j + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(p.b2 + col);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const uint32_t w = (uint32_t)((h * 16 + j) * 2 + hf);
          const uint32_t addr = h1s + (w * 256 + ct) * 4;
          uint32_t hw;
          asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(hw) : "r"(addr));
          const float2 hv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&hw));
          const float* a = &acc[h][4 * j + 2 * hf];
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr),
                       "r"(pack_bf16x2(hv.x + (a[0] + bb.x) * k2[hf],
                                       hv.y + (a[1] + bb.y) * k2[hf])));
        }
      }
    __syncwarp();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int jq = 0; jq < C / 32; ++jq) {
        const int J = 4 * jq + cq;
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(cbase + (2 * J + hf) * 1024));
        if (clive[hf])
          *reinterpret_cast<uint4*>(p.out + ctok[hf] * C + 8 * J) = v;
      }
  }
}

template <int C, bool kProj>
int launch_back_half_c(const BackHalfArgs& a, cudaStream_t stream) {
  using L = BackHalf<C>;
  static_assert(L::SMEM <= kMaxSmem, "back half: shared memory");
  if (a.T >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap tc, tp, t1, t2;
  int rc = make_tmap(&tc, a.ctx, a.T, C, C, BH_ROWS);
  if (!rc && kProj) rc = make_tmap(&tp, a.proj_w, C, C, C, C);
  if (!kProj) tp = tc;  // not read
  if (!rc) rc = make_tmap(&t1, a.w1, 4 * C, C, C, BH_FC);
  if (!rc) rc = make_tmap(&t2, a.w2, C, 4 * C, 4 * C, C);
  if (rc) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      back_half_kernel<C, kProj>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (a.T + BH_ROWS - 1) / BH_ROWS;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  back_half_kernel<C, kProj><<<grid, BH_THREADS, L::SMEM, stream>>>(
      tc, tp, t1, t2, a);
  LRCE_CHECK_LAUNCH();
  return 0;
}

}  // namespace

bool back_half_supported(int C) { return C == 128 || C == 256; }

int launch_back_half(const bf16* ctx, const bf16* x, bf16* out,
                     const WinGeom& g, float eps, const bf16* proj_w,
                     const float* proj_b, const float* ln_s,
                     const float* ln_b, const bf16* w1, const float* b1,
                     const bf16* w2, const float* b2, const float* dp1,
                     const float* dp2, cudaStream_t stream) {
  BackHalfArgs a;
  a.ctx = ctx;
  a.x = x;
  a.out = out;
  a.proj_w = proj_w;
  a.proj_b = proj_b;
  a.ln_s = ln_s;
  a.ln_b = ln_b;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.dp1 = dp1;
  a.dp2 = dp2;
  a.dp_rows = (long long)g.D * g.H * g.W;
  a.T = (long long)g.B * g.D * g.H * g.W;
  a.eps = eps;
  a.g = g;
  if (a.T < 1) return (int)cudaErrorInvalidValue;
  if (g.C == 128) return launch_back_half_c<128, true>(a, stream);
  if (g.C == 256) return launch_back_half_c<256, true>(a, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_mlp_core(const bf16* x, bf16* out, long long T, int C, float eps,
                    const float* ln_s, const float* ln_b, const bf16* w1,
                    const float* b1, const bf16* w2, const float* b2,
                    cudaStream_t stream) {
  BackHalfArgs a = {};
  a.ctx = x;  // the TMA tile: x's rows, contiguous
  a.x = x;
  a.out = out;
  a.ln_s = ln_s;
  a.ln_b = ln_b;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.dp_rows = 1;
  a.T = T;
  a.eps = eps;
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (C == 128) return launch_back_half_c<128, false>(a, stream);
  if (C == 256) return launch_back_half_c<256, false>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace lrce

extern "C" {

// The back half of one block on its own: ctx (T, C) bf16 in window order,
// x and out (B, D, H, W, C) bf16, out must not alias x or ctx; C = 128 or
// 256, FF = 4 C. Weights in nn.Linear layout (bf16), LN parameters and
// biases f32, dp1 / dp2 (B) f32 or null.
int lrce_back_half(const void* ctx, const void* x, void* out, int B, int D,
                   int H, int W, int C, int wd, int wh, int ww, int sd,
                   int sh, int sw, float eps, const void* proj_w,
                   const void* proj_b, const void* ln2s, const void* ln2b,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* dp1, const void* dp2,
                   void* stream_ptr) {
  using namespace lrce;
  const WinGeom g = make_geom(B, D, H, W, C, wd, wh, ww, sd, sh, sw);
  return launch_back_half(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(x),
      static_cast<bf16*>(out), g, eps, static_cast<const bf16*>(proj_w),
      static_cast<const float*>(proj_b), static_cast<const float*>(ln2s),
      static_cast<const float*>(ln2b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(dp1),
      static_cast<const float*>(dp2),
      reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K8 (fused_mlp): out = x + fc2(gelu(fc1(LN x))) for x, out (T, C) bf16,
// out must not alias x; C = 128 or 256, FF = 4 C. Weights in nn.Linear
// layout (bf16), LN parameters and biases f32.
int lrce_fused_mlp(const void* x, void* out, int T, int C, float eps,
                   const void* ln_s, const void* ln_b, const void* w1,
                   const void* b1, const void* w2, const void* b2,
                   void* stream_ptr) {
  using namespace lrce;
  return launch_mlp_core(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), T, C, eps,
      static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      reinterpret_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
