// The pieces of the shared bf16 GEMM (gemm_wgmma_kernel, swin_common.cu)
// that a persistent kernel runs on its own tiles: the ring of TMA stages
// filled by one producer thread, a consumer warpgroup's main loop over one
// 128 x 128 output tile (wgmma m64n128k16, two m64 blocks, the turn passed
// to the other consumer once its last k-step is issued), and the epilogue
// from the accumulator registers through the warp's staging tile. The GEMM
// itself and K7's persistent kernel (ln_mlp.cu) are built from them; see
// swin_common.cu for the design and what was measured.
#pragma once

#include "swin_common.cuh"

#include "hopper.cuh"

#include <stdint.h>

namespace lrce {

// The epilogue for columns n .. n + 7 of one accumulator row, in f32, up to
// the rounding of the store: kdp is the row's dp multiplier (1 without
// one) and res its residual's eight bf16 (modes EPI_ATTN_OUT with a
// residual and EPI_MLP_OUT). EPI_BIAS_GELU's bias and GELU were applied in
// the accumulator registers already. The mode is a template argument, so
// each GEMM instantiation carries only its own epilogue.
template <int kMode>
__device__ __forceinline__ void epilogue8(const Epilogue& ep, int n,
                                          float kdp, const uint4& res,
                                          float (&a)[8]) {
  if constexpr (kMode == EPI_BIAS_GELU) return;
  if (ep.bias) {
    float b[8];
    load8(ep.bias + n, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] += b[i];
  }
  if constexpr (kMode != EPI_BIAS) {
    float r[8];
    load8(reinterpret_cast<const bf16*>(&res), r);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] *= kdp;
    if constexpr (kMode == EPI_ATTN_OUT) {
      // the product rounds to bf16 first, the residual is a bf16 add
      if (ep.res) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = __bfloat162float(__float2bfloat16(a[i])) + r[i];
      }
    } else {  // EPI_MLP_OUT: the residual is added in f32
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] += r[i];
    }
  }
}

constexpr int GBM = 128, GBN = 128, GBK = 64;  // a consumer's tile
constexpr int G_THREADS = 384;  // producer + two consumer warpgroups
constexpr int G_PRODUCER_REGS = 40, G_CONSUMER_REGS = 232;
constexpr int G_A_BYTES = GBM * 128, G_STAGE_BYTES = (GBM + GBN) * 128;
// The epilogue's staging: per consumer warp 16 rows x 32 f32 columns at a
// time, rows of 36 floats (a quarter-warp's 16-byte reads of two rows fall
// in disjoint banks)
constexpr int G_ST_LD = 36;
constexpr int G_STAGING_BYTES = 8 * 16 * G_ST_LD * 4;  // 8 consumer warps
constexpr int G_STAGES = (220 * 1024 - G_STAGING_BYTES) / G_STAGE_BYTES;  // 6
// the ring at the 1024-aligned base, then the staging tiles, then the
// full / empty mbarriers of the stages and the two consumers' turns
constexpr size_t G_SMEM = 1024 + (size_t)G_STAGES * G_STAGE_BYTES +
                          G_STAGING_BYTES + 8 * (2 * G_STAGES + 2);

// Producer: k-step (k, the reduction offset in elements) of the tile at
// (m0, n0) into the next stage of the ring: waits for the stage to be
// empty, then one TMA copy of A's 128 x 64 box and B's (W's 128 x 64 box,
// or with kBkn two 64 x 64 boxes of a K x N matrix) complete on its full
// mbarrier. s and phase walk the ring.
template <bool kBkn>
__device__ __forceinline__ void gemm_load_kstep(
    uint32_t base, uint32_t full, uint32_t empty, int& s, uint32_t& phase,
    const CUtensorMap* tmA, const CUtensorMap* tmB, int k, int m0, int n0) {
  mbar_wait(empty + 8 * s, phase ^ 1);
  const uint32_t sa = base + s * G_STAGE_BYTES, sb = sa + G_A_BYTES;
  mbar_expect_tx(full + 8 * s, G_STAGE_BYTES);
  tma_load_2d(sa, tmA, k, m0, full + 8 * s);
  if constexpr (!kBkn) {
    tma_load_2d(sb, tmB, k, n0, full + 8 * s);
  } else {
    // 64 rows of the reduction x 128 columns: two blocks of 64 columns,
    // 8 KB each, rows of 128 bytes
    tma_load_2d(sb, tmB, n0, k, full + 8 * s);
    tma_load_2d(sb + 8192, tmB, n0 + 64, k, full + 8 * s);
  }
  if (++s == G_STAGES) {
    s = 0;
    phase ^= 1;
  }
}

// Consumer warpgroup: acc = the tile's products over nk k-steps, taken
// from ring units u0 .. u0 + nk - 1 (unit u lies in stage u % G_STAGES,
// its fill of parity (u / G_STAGES) & 1). One wgmma group stays in flight
// across k-steps; a stage is released once the group after it is issued.
// turn_next: the other consumer's turn mbarrier, arrived at once this
// warpgroup has issued its last k-step. Returns with acc complete.
template <bool kBkn>
__device__ __forceinline__ void gemm_mainloop(float (&acc)[GBM / 64][64],
                                              uint32_t base, uint32_t full,
                                              uint32_t empty, long long u0,
                                              int nk, bool leader,
                                              uint32_t turn_next) {
  constexpr int MB = GBM / 64, STAGES = G_STAGES, SB = G_STAGE_BYTES;
  long long u = u0;
  for (int kt = 0; kt < nk; ++kt, ++u) {
    const int s = (int)(u % STAGES);
    mbar_wait(full + 8 * s, (uint32_t)(u / STAGES) & 1);
    const uint32_t sa = base + s * SB, sb = sa + G_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < GBK / 16; ++ks)
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        wgmma_m64n128k16<0, kBkn ? 1 : 0>(
            acc[mb], wgmma_desc(sa + mb * 8192 + ks * 32, 16, 1024),
            kBkn ? wgmma_desc(sb + ks * 2048, 8192, 1024)
                 : wgmma_desc(sb + ks * 32, 16, 1024),
            kt > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the group before this one is done with its stage
    if (kt > 0 && leader) mbar_arrive(empty + 8 * (int)((u - 1) % STAGES));
  }
  if (leader) mbar_arrive(turn_next);  // the other's main loop
  wgmma_wait<0>();
  if (leader) mbar_arrive(empty + 8 * (int)((u - 1) % STAGES));
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) reg_fence(acc[mb]);
}

// Consumer warpgroup: out (M x N, row-major) rows m0 .. + 127, columns n0
// .. + 127 = epilogue(acc) (rows past M and columns past N are not
// stored). st: this warp's staging tile (16 x G_ST_LD f32).
template <int kMode>
__device__ __forceinline__ void gemm_epilogue(float (&acc)[GBM / 64][64],
                                              float* st,
                                              bf16* __restrict__ out,
                                              long long M, int N,
                                              long long m0, int n0,
                                              const Epilogue& ep, int warp,
                                              int lane) {
  constexpr int MB = GBM / 64;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kMode == EPI_BIAS_GELU) {
    // + bias and the GELU on the registers: 64 independent erf chains a
    // thread per m64 block, under the other consumer's products. Against
    // 8 at a time inside the staging loop: K8's fc1 on slabs of 16,384
    // rows faster (K8 1.36 -> 1.19 ms a step), fc1 on 451,584 rows slower
    // (0.512 -> 0.576 ms; the earlier cp.async kernel 0.46; PERF.md).
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const int col = n0 + 8 * jn + 2 * t;
      float2 b = make_float2(0.f, 0.f);
      if (ep.bias && col < N)
        b = *reinterpret_cast<const float2*>(ep.bias + col);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float* a = &acc[mb][4 * jn + 2 * hf];
          a[0] = gelu_erf(a[0] + b.x);
          a[1] = gelu_erf(a[1] + b.y);
        }
    }
  }

  // epilogue through this warp's own staging tile, 32 columns at a time:
  // lane l then owns columns 8 (l % 4) .. + 7 of rows l / 4 and l / 4 + 8
  // of each m64 block. A row's output row (scattered for EPI_ATTN_OUT)
  // and dp multiplier are found once; the residual of two quarters is
  // loaded ahead of their staging.
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    long long dst[2];
    float kdp[2];
    bool live[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long gm = m0 + mb * 64 + warp * 16 + g + 8 * hf;
      live[hf] = gm < M;
      dst[hf] = gm;
      kdp[hf] = 1.f;
      if constexpr (kMode == EPI_ATTN_OUT)
        if (ep.scatter && live[hf]) dst[hf] = win_row_to_token(ep.g, gm);
      if constexpr (kMode == EPI_ATTN_OUT || kMode == EPI_MLP_OUT)
        if (ep.dp && live[hf]) kdp[hf] = ep.dp[gm / ep.dp_rows];
    }
#pragma unroll
    for (int qp = 0; qp < 4; qp += 2) {
      uint4 res[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = n0 + 32 * (qp + q) + 8 * t;
          res[q][hf] = make_uint4(0, 0, 0, 0);
          if constexpr (kMode == EPI_ATTN_OUT || kMode == EPI_MLP_OUT)
            if (ep.res && live[hf] && n < N)
              res[q][hf] = *reinterpret_cast<const uint4*>(
                  ep.res + dst[hf] * N + n);
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(st + (g + 8 * hf) * G_ST_LD +
                                       8 * jj + 2 * t) =
                make_float2(acc[mb][4 * (4 * (qp + q) + jj) + 2 * hf],
                            acc[mb][4 * (4 * (qp + q) + jj) + 2 * hf + 1]);
        __syncwarp();
        const int n = n0 + 32 * (qp + q) + 8 * t;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (live[hf] && n < N) {
            float v[8];
            load8(st + (g + 8 * hf) * G_ST_LD + 8 * t, v);
            epilogue8<kMode>(ep, n, kdp[hf], res[q][hf], v);
            store8(out + dst[hf] * N + n, v);
          }
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace lrce
