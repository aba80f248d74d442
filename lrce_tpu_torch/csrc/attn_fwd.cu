// The window-attention forward CTA: ctx = softmax(q k^T + rel_bias [+ mask]) v
// per (window, head), from the packed (T, 3C) qkv of a block to its (T, C)
// ctx, both bf16 in window order. K6 and K2 (window_attn.cu) and K1 / K3
// (swin_block.cu) reach it through attention_front; lrce_window_attn_core
// below is its own entry.
//
// It is the attention part of the TPU kernels _kernel / _attn_ctx and
// _hsplit_kernel (lrce_tpu/ops/pallas_window_attn.py) and of _block_kernel
// (pallas_swin_block.py), with their rounding points: q is scaled on its
// bf16 value; the logits, the bias, the mask and the softmax are f32 (an
// exact softmax: the TPU's bf16 lane-sum does not port); P rounds to bf16;
// ctx = P v sums in f32 and rounds once. Padded keys are at -inf, padded
// query rows are never stored.
//
// What bounds it on the H100, and what the design does (attn_fwd_kernel):
//   - the function moves little (qkv read once, ctx written once: 0.138 ms
//     at stage 0 and 48 clips at 3.35 TB/s) and its two 147 x 147 x 32
//     products are 0.04 ms of tensor-core time; what it costs is the softmax
//     (22,000 exponentials and half a dozen f32 instructions per logit for
//     every (window, head)), the latency of a short dependent chain per
//     window, and everything that is not kept on chip. So:
//   - mma.sync m16n8k16 fed by ldmatrix, one warp per 16 query rows, ten
//     warps for the 160 padded rows (147 x 32 operands are too small for
//     wgmma's 64-row tiles). S = q k^T stays in the accumulators (80 f32
//     registers a thread) through bias, mask and softmax; row maxima and sums
//     run as four chains a thread and take two shuffles within a quad of
//     lanes. The accumulator layout of S is the A-fragment layout of the
//     next product, so P is packed to bf16 pairs in registers and multiplied
//     with v read by ldmatrix.trans: S and P never touch shared memory.
//     Four ldmatrix are in flight before the products that read them; a key
//     block without a key (147 -> 160: the last of twenty) is skipped;
//   - exp(s - max) is 2^((s - max) log2 e): one fused multiply-add and one
//     ex2.approx (2 ulp in f32, far inside P's rounding to bf16) instead of
//     expf's eight instructions: 10% of the kernel's time;
//   - a CTA walks the windows of one head (grid: window groups x heads, one
//     CTA per SM); q, k, v tiles are XOR-swizzled (every ldmatrix free of
//     bank conflicts) and double-buffered: the next window's three tiles
//     arrive by cp.async while this one multiplies;
//   - the head's bias is read once per CTA, not once per window: it lies in
//     shared memory as f32 in fragment order (thread (warp, lane) finds the
//     four values of key block j at one float4), with -inf already at the
//     padded keys. Each thread reads back only what it wrote itself;
//   - the shift mask is 0 or one value v by whether two tokens carry the
//     same region label, so a window's mask arrives as Np labels (640 bytes,
//     with the tiles) and its v, not as 86 KB per (window, head), and a
//     window whose mask is all zero (v = 0: 49 of a stage-0 clip's 64) adds
//     nothing. A window whose mask is not of that form (mask_off[window] is
//     NaN), or a call without labels, reads the dense f32 mask as it lies;
//   - ctx leaves as bf16 pairs straight from the accumulators, 16 bytes per
//     quad of lanes (staging the warp's block through its idle q rows for
//     16-byte stores measured 1.5% slower over a step's 46 calls);
//   - the count of key blocks is a template argument for the flagship's
//     window (19 blocks of 8 for N = 147): read at run time it made every
//     key block of every loop a branch, which kept the compiler from
//     scheduling one block's exponentials under another's sums and cost 26%
//     (7.8 -> 5.8 ms over a step's 46 calls). Other windows take the same
//     kernel with the count read at run time.
// On an NVIDIA H100 80GB HBM3, 700.00 W, at the flagship's window (N = 147,
// head_dim 32) and 48 clips it takes 0.33 / 0.18 / 0.094 / 0.053 ms a call at
// stages 0-3, 2.4 to 2.9 times its bound. Tried there and not kept: a copying
// warp and mbarriers per stage of a three-window ring instead of the
// per-window __syncthreads (the consumer warps free to drift apart): 1.5%.
// Takes head_dim 16 or 32 and windows of at most 160 tokens. Windows of
// 161-448 tokens at head_dim 16 or 32 run attn_fwd_big_kernel (below):
// launch_attn chooses by shape between the two and refuses any other shape.
#include "swin_common.cuh"

#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace lrce {
namespace {

constexpr int FW_MAX_NB = 20;     // key blocks of 8: up to 160 padded tokens
constexpr int FW_MAX_WARPS = 10;  // one warp per 16 query rows

size_t fwd_smem_bytes(int Np, int hd) {
  return (size_t)6 * Np * hd * sizeof(bf16) +  // q k v, twice
         (size_t)2 * Np * sizeof(int) +        // labels, twice
         (size_t)Np * Np * sizeof(float);      // the head's bias
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t u, float k) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  return pack_bf16(f.x * k, f.y * k);
}

// One CTA per (window group, head), one warp per 16 query rows; it walks
// windows grp, grp + groups, ... qkv: (T, 3C) window order, [q | k | v] with
// head h at columns h*HD; ctx: (T, C). labels: (nwin_clip, Np) int32 or
// null; mask_off: (nwin_clip) f32, NaN where the window takes the dense mask.
// NBV: the key blocks that hold a key, (N + 7) / 8, when it is known at
// compile time (19 for the flagship's N = 147), or 0: with NBV fixed the
// loops over key blocks unroll into straight code, which the compiler
// schedules across blocks (the exponentials of one under the sums of
// another); with the count read at run time every block is a branch.
template <int HD, int NBV>
__global__ void __launch_bounds__(FW_MAX_WARPS * 32, 1)
attn_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx,
                const float* __restrict__ rel_bias,
                const float* __restrict__ mask,
                const int* __restrict__ labels,
                const float* __restrict__ mask_off, int nwin_total,
                int nwin_clip, int N, int Np, int C, int groups, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k-steps over the head dim
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x, h = blockIdx.y;
  // key blocks of 8: all of the padded window's, and those that hold a key
  const int nb = NBV ? (NBV + 1) / 2 * 2 : Np >> 3;
  const int nbv = NBV ? NBV : (N + 7) >> 3;
  const int tile = Np * HD * 2;  // bytes of one of q, k, v
  const int lab_off = 6 * tile, bias_off = lab_off + 2 * Np * 4;
  const uint32_t sbase = smem_u32(smem);
  // this thread's float4 of key block j is bias_s[32 * j]
  float4* bias_s =
      reinterpret_cast<float4*>(smem + bias_off) + warp * nb * 32 + lane;

  auto start_loads = [&](int win, int b) {
    const bf16* qrow = qkv + (long long)win * N * (3LL * C) + h * HD;
    for (int idx = tid; idx < Np * CH; idx += blockDim.x) {
      const int tok = idx / CH, c = idx % CH;
      const bool ok = tok < N;
      const uint32_t dst = sbase + b * 3 * tile + tok_off<HD>(tok, c);
      const bf16* src = qrow + (long long)tok * 3 * C + c * 8;
      cp_async16(dst, ok ? src : qkv, ok);
      cp_async16(dst + tile, ok ? src + C : qkv, ok);
      cp_async16(dst + 2 * tile, ok ? src + 2 * C : qkv, ok);
    }
    if (labels && tid < Np / 4)
      cp_async16(sbase + lab_off + b * Np * 4 + tid * 16,
                 labels + (win % nwin_clip) * Np + tid * 4, true);
  };

  if (grp < nwin_total) start_loads(grp, 0);
  cp_async_commit();

  // the head's bias into fragment order, under the first window's copies
  const int r_lo = 16 * warp + g;  // this lane's rows: r_lo, r_lo + 8
  {
    const float* bias_h = rel_bias + (long long)h * N * N;
#pragma unroll
    for (int j = 0; j < FW_MAX_NB; ++j) {
      if (j < nbv) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r_lo + (e >> 1) * 8, col = 8 * j + 2 * t + (e & 1);
          v[e] = col >= N ? -INFINITY
                          : (r < N ? bias_h[(long long)r * N + col] : 0.f);
        }
        bias_s[32 * j] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }

  const int a_row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int k_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // B, trans

  int b = 0;
  for (int win = grp; win < nwin_total; win += groups, b ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tiles of `win` complete; the previous window is done
    if (win + groups < nwin_total) start_loads(win + groups, b ^ 1);
    cp_async_commit();

    const uint32_t qs = sbase + b * 3 * tile, ks = qs + tile, vs = ks + tile;
    // this window's mask: labels and one value, or the dense mask
    const int wc = win % nwin_clip;
    float offv = 0.f;
    const float* mask_w = nullptr;
    if (mask) {
      if (labels) offv = mask_off[wc];
      if (!labels || isnan(offv)) mask_w = mask + (long long)wc * N * N;
    }

    // q of this warp's 16 rows, scaled on its bf16 value
    uint32_t aq[KS][4];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      ldsm_x4(aq[k], qs + tok_off<HD>(a_row, 2 * k + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < 4; ++i) aq[k][i] = scale_bf16x2(aq[k][i], scale);
    }

    // S = q k^T: one ldmatrix.x4 brings a key block's whole head dim
    // (HD = 32) or two key blocks (HD = 16); four of them are in flight
    // before the products that read them
    float s[FW_MAX_NB][4];
#pragma unroll
    for (int j = 0; j < FW_MAX_NB; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (HD == 32) {
#pragma unroll
      for (int j0 = 0; j0 < FW_MAX_NB; j0 += 4) {
        uint32_t bb[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j0 + i < nbv)
            ldsm_x4(bb[i],
                    ks + tok_off<HD>(8 * (j0 + i) + (lane & 7), lane >> 3));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j0 + i < nbv) {
            mma_bf16(s[j0 + i], aq[0], bb[i][0], bb[i][1]);
            mma_bf16(s[j0 + i], aq[1], bb[i][2], bb[i][3]);
          }
      }
    } else {
#pragma unroll
      for (int j0 = 0; j0 < FW_MAX_NB; j0 += 8) {
        uint32_t bb[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j0 + 2 * i < nbv)
            ldsm_x4(bb[i], ks + tok_off<HD>(8 * (j0 + 2 * i) + (lane & 7) +
                                                (lane >> 4) * 8,
                                            (lane >> 3) & 1));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j0 + 2 * i < nbv) {
            mma_bf16(s[j0 + 2 * i], aq[0], bb[i][0], bb[i][1]);
            mma_bf16(s[j0 + 2 * i + 1], aq[0], bb[i][2], bb[i][3]);
          }
      }
    }

    // + bias (+ mask), row maxima (a chain per accumulator element). A
    // window whose mask is all zero (off 0: most windows of a clip) adds
    // the bias alone. A key block without keys keeps P = 0.
    const int* lab = reinterpret_cast<const int*>(smem + lab_off + b * Np * 4);
    const bool by_label = mask && !mask_w && offv != 0.f;
    int lr0 = 0, lr1 = 0;
    if (by_label) {
      lr0 = lab[r_lo];
      lr1 = lab[r_lo + 8];
    }
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    // kind 0: the bias alone; 1: + the mask by labels; 2: + the dense mask
    auto add_bias = [&](auto kind) {
      constexpr int kKind = decltype(kind)::value;
#pragma unroll
      for (int j = 0; j < FW_MAX_NB; ++j) {
        if (j < nbv) {
          const float4 bv = bias_s[32 * j];
          float add[4] = {bv.x, bv.y, bv.z, bv.w};
          if constexpr (kKind == 2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = r_lo + (e >> 1) * 8, col = 8 * j + 2 * t + (e & 1);
              if (r < N && col < N) add[e] += mask_w[(long long)r * N + col];
            }
          } else if constexpr (kKind == 1) {
            const int2 lc =
                *reinterpret_cast<const int2*>(lab + 8 * j + 2 * t);
            add[0] += lr0 == lc.x ? 0.f : offv;
            add[1] += lr0 == lc.y ? 0.f : offv;
            add[2] += lr1 == lc.x ? 0.f : offv;
            add[3] += lr1 == lc.y ? 0.f : offv;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] += add[e];
            mx[e] = fmaxf(mx[e], s[j][e]);
          }
        }
      }
    };
    if (mask_w)
      add_bias(std::integral_constant<int, 2>{});
    else if (by_label)
      add_bias(std::integral_constant<int, 1>{});
    else
      add_bias(std::integral_constant<int, 0>{});
    // exp(s - max) as 2^((s - max) log2 e): one fused multiply-add and one
    // ex2.approx (2 ulp) per logit
    constexpr float kLog2e = 1.4426950408889634f;
    float mxs[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float m = fmaxf(mx[2 * hf], mx[2 * hf + 1]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      mxs[hf] = m * kLog2e;
    }
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < FW_MAX_NB; ++j) {
      if (j < nbv) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2_approx(fmaf(s[j][e], kLog2e, -mxs[e >> 1]));
          sum[e] += s[j][e];
        }
      }
    }
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float a = sum[2 * hf] + sum[2 * hf + 1];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      inv[hf] = 1.f / a;
    }

    // ctx = bf16(P) v: P from the accumulators, 16 keys a step, the v
    // fragments of two steps in flight before their products; then out as
    // bf16 pairs
    float acc[CH][4];
#pragma unroll
    for (int n = 0; n < CH; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < FW_MAX_NB; j0 += 4) {
      uint32_t bv[2][KS][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (j0 + 2 * i < nb)
#pragma unroll
          for (int n2 = 0; n2 < KS; ++n2)
            ldsm_x4_t(bv[i][n2],
                      vs + tok_off<HD>(8 * (j0 + 2 * i) + k_row,
                                       2 * n2 + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = j0 + 2 * i;
        if (j < nb) {
          uint32_t ap[4];
          ap[0] = pack_bf16(s[j][0] * inv[0], s[j][1] * inv[0]);
          ap[1] = pack_bf16(s[j][2] * inv[1], s[j][3] * inv[1]);
          ap[2] = pack_bf16(s[j + 1][0] * inv[0], s[j + 1][1] * inv[0]);
          ap[3] = pack_bf16(s[j + 1][2] * inv[1], s[j + 1][3] * inv[1]);
#pragma unroll
          for (int n2 = 0; n2 < KS; ++n2) {
            mma_bf16(acc[2 * n2], ap, bv[i][n2][0], bv[i][n2][1]);
            mma_bf16(acc[2 * n2 + 1], ap, bv[i][n2][2], bv[i][n2][3]);
          }
        }
      }
    }

    bf16* out = ctx + (long long)win * N * C + h * HD;
#pragma unroll
    for (int n = 0; n < CH; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r_lo + hf * 8;
        if (r < N)
          *reinterpret_cast<uint32_t*>(out + (long long)r * C + 8 * n + 2 * t) =
              pack_bf16(acc[n][2 * hf], acc[n][2 * hf + 1]);
      }
  }
}

template <int HD, int NBV>
int launch_attn_fwd(const bf16* qkv, bf16* ctx, const float* rel_bias,
                    const float* mask, const int* labels,
                    const float* mask_off, int nwin_total, int nwin_clip,
                    int N, int Np, int C, int num_heads, int groups,
                    cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(Np, HD);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<HD, NBV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_fwd_kernel<HD, NBV><<<dim3(groups, num_heads), Np * 2, smem, stream>>>(
      qkv, ctx, rel_bias, mask, labels, mask_off, nwin_total, nwin_clip, N,
      Np, C, groups, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Windows of 161-448 tokens (16-frame clips of Swin-B: the window (8, 7, 7),
// N = 392 at every stage; 5-frame clips of Swin-L at 384: (3, 12, 12), N =
// 432), head_dim 16 or 32: attn_fwd_big_kernel. See the note at
// the top of this file for what it keeps of attn_fwd_kernel; what differs:
//   - a window's S is 392 x 392: no register array may be sized by N (400
//     keys would be 200 f32 registers a thread), so the keys stream in
//     16-wide steps with a run-time count, and the softmax takes two passes
//     over them to keep the reference's rounding point P = bf16(exp(S - m)
//     / l): the first forms each row's max and sum online (32 keys an
//     update), the second forms P and accumulates ctx = P v (a one-pass
//     online softmax would round the unnormalised exponentials instead).
//     The logits of a warp's first FB_CACHE = 10 steps (80 registers, a
//     fixed count: the steps are unrolled) stay in registers from the first
//     pass to the second, which forms S again only for the steps after
//     them;
//   - the CTA takes 80 query rows of one head (64 past 400 tokens, below;
//     grid: window
//     groups x heads x query blocks) and splits the keys in two halves over
//     two sets of five warps: ten warps an SM share one copy of the bias
//     rows, and each warp walks half the keys. The halves meet twice a
//     window in shared memory, in a fixed order: the (max, sum) of each row
//     after the first pass, and the upper half's f32 ctx, which the lower
//     half adds to its own before the one rounding;
//   - the head's bias rows of the CTA lie in shared memory in fragment
//     order for every window it walks (80 x 400 x 4 B = 128 KB; -inf past
//     N), and the accumulators of S start from them, so q k^T lands on the
//     bias; exp(s - m) / l is 2^(s log2 e - c) with c = m log2 e + log2 l
//     per row: one fused multiply-add and one ex2.approx a logit in the
//     second pass. k of the next window and v of this one arrive by
//     cp.async while the first pass runs (k twice, v once: 3 x 25.6 KB), q
//     of the next window while the second pass runs; ~220 KB in all, one
//     CTA an SM;
//   - past 400 padded tokens 80 bias rows no longer fit beside k and v (at
//     N = 432: 235.6 KB of the 227 KB a CTA may take), so windows of
//     401-448 tokens take CTAs of FB_WIDE_ROW_WARPS = 4 row warps (64 query
//     rows, eight warps, 210-218 KB): the same code, instantiated apart, so
//     that the 80-row CTA of N <= 400 is the one measured before. At N =
//     432, 7 blocks of 64 rows cover 448 padded rows where 6 of 80 would
//     cover 480;
//   - what bounds it: at N = 392 a warp's 16-key step reads 2 KB of shared
//     memory in the first pass (k and the bias) and 1 KB in the second (v;
//     2 KB more past the ten kept steps), and issues 17 exponentials a
//     lane: on 132 SMs at 128 bytes and 16 exponentials a clock, about 0.9
//     and 1.1 ms a call at stage 0 and 48 clips, where its bound is 0.37 ms
//     (bytes). Measured on an NVIDIA H100 80GB HBM3 at 700 W (the 46 calls
//     of a 48-clip step of 16 frames) and not kept: issuing the next step's
//     S before this step's exponentials, +14%; moving the max only when a
//     logit passes it by 8 (fewer rescaling exponentials), +1%; 64-row
//     blocks with the keys in three parts (12 warps an SM), +3.5%; keeping
//     12 steps' logits, which spills; keeping 6 or 8, +1.6% and +2.2%.
// ---------------------------------------------------------------------------
constexpr int FB_ROW_WARPS = 5;       // 16 query rows each, up to 400 tokens
constexpr int FB_WIDE_ROW_WARPS = 4;  // 401-448 tokens
constexpr int FB_WIDE_NP = 400;       // padded tokens of the 80-row CTA
constexpr int FB_SPLITS = 2;          // key halves
constexpr int FB_CACHE = 10;  // 16-key steps whose logits pass 1 keeps
constexpr int FB_MAX_NP = 448;        // padded tokens

int big_fwd_rows(int Np) {  // query rows of a CTA
  return 16 * (Np > FB_WIDE_NP ? FB_WIDE_ROW_WARPS : FB_ROW_WARPS);
}

int big_fwd_blocks(int Np) {
  return (Np + big_fwd_rows(Np) - 1) / big_fwd_rows(Np);
}

size_t big_fwd_smem_bytes(int Np, int hd) {
  const size_t rows = (size_t)big_fwd_rows(Np);
  return rows * Np * sizeof(float) +                   // bias rows
         (size_t)3 * Np * hd * sizeof(bf16) +          // k twice, v
         rows * hd * sizeof(bf16) +                    // q of the block
         (size_t)2 * Np * sizeof(int) +                // labels, twice
         FB_SPLITS * rows * sizeof(float2) +           // (max, sum)
         rows * hd * sizeof(float);                    // the upper ctx
}

// grid (groups, heads, big_fwd_blocks(Np)), RW x FB_SPLITS warps: warp w
// takes rows 16 (w % RW) .. + 15 of the block and key half w / RW.
// Arguments as attn_fwd_kernel's.
template <int HD, int RW>
__global__ void __launch_bounds__(RW * FB_SPLITS * 32, 1)
attn_fwd_big_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx,
                    const float* __restrict__ rel_bias,
                    const float* __restrict__ mask,
                    const int* __restrict__ labels,
                    const float* __restrict__ mask_off, int nwin_total,
                    int nwin_clip, int N, int Np, int C, int groups,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k-steps over the head dim
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int FB_ROWS = 16 * RW;  // query rows of the CTA
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp % RW, sp = warp / RW;
  const int grp = blockIdx.x, h = blockIdx.y, row0 = blockIdx.z * FB_ROWS;
  const int nb = Np >> 3;                // key blocks of 8
  const int nk = Np >> 4;                // key steps of 16
  const int kb0 = sp ? (nk + 1) / 2 : 0, kb1 = sp ? nk : (nk + 1) / 2;
  const int tile = Np * HD * 2;          // bytes of k or v
  const int bias_bytes = FB_ROWS * Np * 4;
  const int q_off = bias_bytes + 3 * tile;
  const int lab_off = q_off + FB_ROWS * HD * 2;
  const int stat_off = lab_off + 2 * Np * 4;
  const int xc_off = stat_off + FB_SPLITS * FB_ROWS * 8;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t k_s = sbase + bias_bytes, v_s = k_s + 2 * tile,
                 q_s = sbase + q_off;
  // this thread's float4 of key block j is bias_s[32 * j]
  const float4* bias_s =
      reinterpret_cast<const float4*>(smem) + rw * nb * 32 + lane;
  float2* rowstat = reinterpret_cast<float2*>(smem + stat_off);  // [sp][row]
  float4* xc = reinterpret_cast<float4*>(smem + xc_off);      // [rw][n][lane]

  auto load_kv = [&](int win, uint32_t dst, int which) {  // 1: k, 2: v
    const bf16* src0 = qkv + (long long)win * N * (3LL * C) + which * C +
                       h * HD;
    for (int idx = tid; idx < Np * CH; idx += blockDim.x) {
      const int tok = idx / CH, c = idx % CH;
      const bool ok = tok < N;
      cp_async16(dst + tok_off<HD>(tok, c),
                 ok ? src0 + (long long)tok * 3 * C + c * 8 : qkv, ok);
    }
  };
  auto load_k = [&](int win, int b) {  // k and the labels into buffer b
    load_kv(win, k_s + b * tile, 1);
    if (labels)
      for (int i = tid; i < Np / 4; i += blockDim.x)
        cp_async16(sbase + lab_off + b * Np * 4 + i * 16,
                   labels + (long long)(win % nwin_clip) * Np + 4 * i, true);
  };
  auto load_q = [&](int win) {
    const bf16* src0 = qkv + (long long)win * N * (3LL * C) + h * HD;
    for (int idx = tid; idx < FB_ROWS * CH; idx += blockDim.x) {
      const int r = idx / CH, c = idx % CH, tok = row0 + r;
      const bool ok = tok < N;
      cp_async16(q_s + tok_off<HD>(r, c),
                 ok ? src0 + (long long)tok * 3 * C + c * 8 : qkv, ok);
    }
  };

  if (grp < nwin_total) {
    load_k(grp, 0);
    load_q(grp);
  }
  cp_async_commit();

  // the head's bias rows into fragment order, under the first copies
  {
    const float* bias_h = rel_bias + (long long)h * N * N;
    float4* bs = reinterpret_cast<float4*>(smem);
    for (int i = tid; i < RW * nb * 32; i += blockDim.x) {
      const int l = i & 31, j = (i >> 5) % nb, w = (i >> 5) / nb;
      const int r = row0 + 16 * w + (l >> 2), c = 8 * j + 2 * (l & 3);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e >> 1) * 8, cc = c + (e & 1);
        v[e] = cc >= N ? -INFINITY
                       : (rr < N ? bias_h[(long long)rr * N + cc] : 0.f);
      }
      bs[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  const int a_row = 16 * rw + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int k_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // B, trans
  const int r_lo = row0 + 16 * rw + g;   // this lane's rows: r_lo, r_lo + 8
  const bool active = row0 + 16 * rw < N;  // warp-uniform

  int b = 0;
  for (int win = grp; win < nwin_total; win += groups, b ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // k, q, labels of `win`; the previous window is done
    load_kv(win, v_s, 2);
    cp_async_commit();
    if (win + groups < nwin_total) load_k(win + groups, b ^ 1);
    cp_async_commit();

    const uint32_t ks = k_s + b * tile;
    const int* lab = reinterpret_cast<const int*>(smem + lab_off + b * Np * 4);
    const int wc = win % nwin_clip;
    float offv = 0.f;
    const float* mask_w = nullptr;
    if (mask) {
      if (labels) offv = mask_off[wc];
      if (!labels || isnan(offv)) mask_w = mask + (long long)wc * N * N;
    }
    const bool by_label = mask && !mask_w && offv != 0.f;
    int lr0 = 0, lr1 = 0;
    if (active && by_label) {
      lr0 = lab[r_lo];
      lr1 = lab[r_lo + 8];
    }

    uint32_t aq[KS][4];
    if (active) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        ldsm_x4(aq[k], q_s + tok_off<HD>(a_row, 2 * k + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < 4; ++i) aq[k][i] = scale_bf16x2(aq[k][i], scale);
      }
    }

    // s = S + bias (+ mask) of this lane's rows for keys 16 kb .. + 15, as
    // two 8-key tiles s[0], s[1]: the accumulators start from the bias
    // (-inf past N) and q k^T adds to it. kind 0: the bias alone; 1: + the
    // mask by labels; 2: + the dense mask
    auto logits = [&](float (&s)[2][4], int kb, auto kind) {
      constexpr int kKind = decltype(kind)::value;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 bv = bias_s[32 * (2 * kb + i)];
        s[i][0] = bv.x;
        s[i][1] = bv.y;
        s[i][2] = bv.z;
        s[i][3] = bv.w;
      }
      if constexpr (HD == 32) {
        uint32_t bb[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(bb[i], ks + tok_off<HD>(16 * kb + 8 * i + (lane & 7),
                                          lane >> 3));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(s[i], aq[0], bb[i][0], bb[i][1]);
          mma_bf16(s[i], aq[1], bb[i][2], bb[i][3]);
        }
      } else {
        uint32_t bb[4];
        ldsm_x4(bb, ks + tok_off<HD>(16 * kb + (lane & 7) + (lane >> 4) * 8,
                                     (lane >> 3) & 1));
        mma_bf16(s[0], aq[0], bb[0], bb[1]);
        mma_bf16(s[1], aq[0], bb[2], bb[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 2 * kb + i;
        if constexpr (kKind == 2) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r_lo + (e >> 1) * 8, col = 8 * j + 2 * t + (e & 1);
            if (r < N && col < N) s[i][e] += mask_w[(long long)r * N + col];
          }
        } else if constexpr (kKind == 1) {
          const int2 lc = *reinterpret_cast<const int2*>(lab + 8 * j + 2 * t);
          s[i][0] += lr0 == lc.x ? 0.f : offv;
          s[i][1] += lr0 == lc.y ? 0.f : offv;
          s[i][2] += lr1 == lc.x ? 0.f : offv;
          s[i][3] += lr1 == lc.y ? 0.f : offv;
        }
      }
    };

    // pass 1: per row an online max mr and l = sum exp(s - mr) over this
    // warp's keys, 32 keys an update, then across the quad's lanes; exp(s -
    // m) is 2^(s log2 e - m log2 e), one fused multiply-add and one
    // ex2.approx. The first step of either half holds a key for every lane
    // (N >= 161), so mr is finite from there on; a missing second step of
    // an update is -inf. The logits of the first FB_CACHE steps stay in
    // registers for pass 2 (a fixed count, unrolled: no register array is
    // sized by N), which then forms S again only for the steps after them
    float mr[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float cache[FB_CACHE][2][4];
    auto update = [&](const float (&sa)[2][4], const float (&sb)[2][4]) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = mr[hf];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mx = fmaxf(mx, fmaxf(fmaxf(sa[i][2 * hf], sa[i][2 * hf + 1]),
                               fmaxf(sb[i][2 * hf], sb[i][2 * hf + 1])));
        const float mxs = mx * kLog2e;
        float a = l[hf] * exp2_approx(fmaf(mr[hf], kLog2e, -mxs));
#pragma unroll
        for (int i = 0; i < 2; ++i)
          a += (exp2_approx(fmaf(sa[i][2 * hf], kLog2e, -mxs)) +
                exp2_approx(fmaf(sa[i][2 * hf + 1], kLog2e, -mxs))) +
               (exp2_approx(fmaf(sb[i][2 * hf], kLog2e, -mxs)) +
                exp2_approx(fmaf(sb[i][2 * hf + 1], kLog2e, -mxs)));
        l[hf] = a;
        mr[hf] = mx;
      }
    };
    auto no_keys = [](float (&sb)[2][4]) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        sb[i][0] = sb[i][1] = sb[i][2] = sb[i][3] = -INFINITY;
    };
    auto pass1 = [&](auto kind) {
#pragma unroll
      for (int u = 0; u < FB_CACHE; u += 2) {
        const int kb = kb0 + u;
        if (kb < kb1) {
          logits(cache[u], kb, kind);
          if (kb + 1 < kb1)
            logits(cache[u + 1], kb + 1, kind);
          else
            no_keys(cache[u + 1]);
          update(cache[u], cache[u + 1]);
        }
      }
      for (int kb = kb0 + FB_CACHE; kb < kb1; kb += 2) {
        float sa[2][4], sb[2][4];
        logits(sa, kb, kind);
        if (kb + 1 < kb1)
          logits(sb, kb + 1, kind);
        else
          no_keys(sb);
        update(sa, sb);
      }
    };
    if (active) {
      if (mask_w)
        pass1(std::integral_constant<int, 2>{});
      else if (by_label)
        pass1(std::integral_constant<int, 1>{});
      else
        pass1(std::integral_constant<int, 0>{});
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float mo = __shfl_xor_sync(0xffffffffu, mr[hf], o);
          const float lo = __shfl_xor_sync(0xffffffffu, l[hf], o);
          const float mx = fmaxf(mr[hf], mo);
          l[hf] = l[hf] * exp2_approx((mr[hf] - mx) * kLog2e) +
                  lo * exp2_approx((mo - mx) * kLog2e);
          mr[hf] = mx;
        }
        if (t == 0)
          rowstat[sp * FB_ROWS + 16 * rw + g + 8 * hf] =
              make_float2(mr[hf], l[hf]);
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // v of `win`, both halves' (max, sum); q is free
    if (win + groups < nwin_total) load_q(win + groups);
    cp_async_commit();
    float acc[CH][4];
#pragma unroll
    for (int n = 0; n < CH; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (active) {
      // per row c = m log2 e + log2 l over all keys, the lower half first
      // (the same arithmetic in both halves' warps): P = 2^(s log2 e - c)
      float c[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * rw + g + 8 * hf;
        const float2 lo = rowstat[row], up = rowstat[FB_ROWS + row];
        const float mx = fmaxf(lo.x, up.x);
        c[hf] = mx * kLog2e +
                __log2f(lo.y * exp2_approx((lo.x - mx) * kLog2e) +
                        up.y * exp2_approx((up.x - mx) * kLog2e));
      }

      // pass 2: P = bf16(exp(S - m) / l) from the accumulators, ctx += P v,
      // 16 keys a step; S from the registers for the first FB_CACHE steps
      auto pv = [&](const float (&s)[2][4], int kb) {
        uint32_t ap[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            ap[2 * i + hf] = pack_bf16(
                exp2_approx(fmaf(s[i][2 * hf], kLog2e, -c[hf])),
                exp2_approx(fmaf(s[i][2 * hf + 1], kLog2e, -c[hf])));
#pragma unroll
        for (int n2 = 0; n2 < KS; ++n2) {
          uint32_t bv[4];
          ldsm_x4_t(bv, v_s + tok_off<HD>(16 * kb + k_row,
                                          2 * n2 + (lane >> 4)));
          mma_bf16(acc[2 * n2], ap, bv[0], bv[1]);
          mma_bf16(acc[2 * n2 + 1], ap, bv[2], bv[3]);
        }
      };
      auto pass2 = [&](auto kind) {
#pragma unroll
        for (int u = 0; u < FB_CACHE; ++u)
          if (kb0 + u < kb1) pv(cache[u], kb0 + u);
#pragma unroll 2
        for (int kb = kb0 + FB_CACHE; kb < kb1; ++kb) {
          float s[2][4];
          logits(s, kb, kind);
          pv(s, kb);
        }
      };
      if (mask_w)
        pass2(std::integral_constant<int, 2>{});
      else if (by_label)
        pass2(std::integral_constant<int, 1>{});
      else
        pass2(std::integral_constant<int, 0>{});

      // the upper half's f32 ctx into shared memory, for the lower half
      if (sp == 1) {
#pragma unroll
        for (int n = 0; n < CH; ++n)
          xc[(rw * CH + n) * 32 + lane] =
              make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
      }
    }
    __syncthreads();  // the upper half's ctx is in shared memory
    // the lower half adds it to its own in a fixed order and stores ctx
    // once, as bf16 pairs
    if (active && sp == 0) {
      bf16* out = ctx + (long long)win * N * C + h * HD;
#pragma unroll
      for (int n = 0; n < CH; ++n) {
        const float4 u = xc[(rw * CH + n) * 32 + lane];
        acc[n][0] += u.x;
        acc[n][1] += u.y;
        acc[n][2] += u.z;
        acc[n][3] += u.w;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r_lo + hf * 8;
          if (r < N)
            *reinterpret_cast<uint32_t*>(out + (long long)r * C + 8 * n +
                                         2 * t) =
                pack_bf16(acc[n][2 * hf], acc[n][2 * hf + 1]);
        }
      }
    }
  }
}

template <int HD, int RW>
int launch_attn_fwd_big(const bf16* qkv, bf16* ctx, const float* rel_bias,
                        const float* mask, const int* labels,
                        const float* mask_off, int nwin_total, int nwin_clip,
                        int N, int Np, int C, int num_heads, int groups,
                        cudaStream_t stream) {
  const size_t smem = big_fwd_smem_bytes(Np, HD);
  if (smem > kMaxSmem || 16 * RW != big_fwd_rows(Np))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_big_kernel<HD, RW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_fwd_big_kernel<HD, RW>
      <<<dim3(groups, num_heads, big_fwd_blocks(Np)), RW * FB_SPLITS * 32,
         smem, stream>>>(qkv, ctx, rel_bias, mask, labels, mask_off,
                         nwin_total, nwin_clip, N, Np, C, groups,
                         1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// attn_fwd_big_kernel at head_dim HD, its rows by the window
template <int HD>
int launch_attn_fwd_big_rows(const bf16* qkv, bf16* ctx,
                             const float* rel_bias, const float* mask,
                             const int* labels, const float* mask_off,
                             int nwin_total, int nwin_clip, int N, int Np,
                             int C, int num_heads, int groups,
                             cudaStream_t stream) {
  if (Np > FB_WIDE_NP)
    return launch_attn_fwd_big<HD, FB_WIDE_ROW_WARPS>(
        qkv, ctx, rel_bias, mask, labels, mask_off, nwin_total, nwin_clip, N,
        Np, C, num_heads, groups, stream);
  return launch_attn_fwd_big<HD, FB_ROW_WARPS>(
      qkv, ctx, rel_bias, mask, labels, mask_off, nwin_total, nwin_clip, N,
      Np, C, num_heads, groups, stream);
}

// launches of each CTA that launch_attn chose: attn_fwd_kernel,
// attn_fwd_big_kernel (host-side, read by lrce_attn_fwd_counts)
long long g_attn_counts[2] = {0, 0};

int counted(int rc, int which) {
  if (rc == 0) ++g_attn_counts[which];
  return rc;
}

}  // namespace

// The choice by shape between the two hand-written kernels, for head_dim
// 16 or 32 (ops/window_attn.attn_supported): attn_fwd_kernel for windows of
// at most 160 tokens (every stage of Swin-B on 5-frame clips),
// attn_fwd_big_kernel for 161-448 (Swin-B on 16-frame clips, Swin-L at 384
// on 5-frame clips); any other shape is refused. groups: window groups of
// the grid (ops/window_attn.attn_fwd_launch_groups). Returns the launch's
// error code; a launch is counted per kernel.
int launch_attn(const bf16* qkv, bf16* ctx, const float* rel_bias,
                const float* mask, const int* labels, const float* mask_off,
                long long nwin_total, int nwin_clip, int N, int C,
                int num_heads, int groups, cudaStream_t stream) {
  const int hd = C / num_heads;
  const int Np = (N + 15) / 16 * 16;
  if (Np > FB_MAX_NP || (hd != 16 && hd != 32) || groups < 1 ||
      groups > nwin_total || (labels && !mask_off) ||
      nwin_total > 0x7fffffffLL - groups)
    return (int)cudaErrorInvalidValue;
  const int n = (int)nwin_total;
  if (Np > 8 * FW_MAX_NB) {
    if (hd == 16)
      return counted(launch_attn_fwd_big_rows<16>(
                         qkv, ctx, rel_bias, mask, labels, mask_off, n,
                         nwin_clip, N, Np, C, num_heads, groups, stream),
                     1);
    return counted(launch_attn_fwd_big_rows<32>(
                       qkv, ctx, rel_bias, mask, labels, mask_off, n,
                       nwin_clip, N, Np, C, num_heads, groups, stream),
                   1);
  }
  if (hd == 16)
    return counted(launch_attn_fwd<16, 0>(qkv, ctx, rel_bias, mask, labels,
                                          mask_off, n, nwin_clip, N, Np, C,
                                          num_heads, groups, stream),
                   0);
  if ((N + 7) / 8 == 19)  // the (3, 7, 7) window: N = 147
    return counted(launch_attn_fwd<32, 19>(qkv, ctx, rel_bias, mask, labels,
                                           mask_off, n, nwin_clip, N, Np, C,
                                           num_heads, groups, stream),
                   0);
  return counted(launch_attn_fwd<32, 0>(qkv, ctx, rel_bias, mask, labels,
                                        mask_off, n, nwin_clip, N, Np, C,
                                        num_heads, groups, stream),
                 0);
}

}  // namespace lrce

using namespace lrce;

extern "C" {

// The CTA alone. qkv (nwin_total * N, 3C) bf16, window order; rel_bias
// (num_heads, N, N) f32; mask (nwin_clip, N, N) f32 or null; mask_labels
// (nwin_clip, ceil16(N)) int32 and mask_off (nwin_clip) f32, or both null
// (see launch_attn in swin_common.cuh); ctx (nwin_total * N, C) bf16 out.
// 1 <= groups <= nwin_total window groups; head_dim 16 or 32, N <= 448.
int lrce_window_attn_core(const void* qkv, void* ctx, const void* rel_bias,
                          const void* mask, const void* mask_labels,
                          const void* mask_off, int nwin_total, int nwin_clip,
                          int N, int C, int num_heads, int groups,
                          void* stream_ptr) {
  if (nwin_total < 1 || nwin_clip < 1 || N < 1 || num_heads < 1 ||
      C % num_heads != 0)
    return (int)cudaErrorInvalidValue;
  return launch_attn(static_cast<const bf16*>(qkv), static_cast<bf16*>(ctx),
                     static_cast<const float*>(rel_bias),
                     static_cast<const float*>(mask),
                     static_cast<const int*>(mask_labels),
                     static_cast<const float*>(mask_off), nwin_total,
                     nwin_clip, N, C, num_heads, groups,
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}

// The launches counted by launch_attn since the last reset, per kernel:
// out (2 int64) = attn_fwd_kernel, attn_fwd_big_kernel. reset != 0 zeroes
// the counts after reading them.
int lrce_attn_fwd_counts(void* out, int reset) {
  long long* o = static_cast<long long*>(out);
  for (int i = 0; i < 2; ++i) {
    o[i] = g_attn_counts[i];
    if (reset) g_attn_counts[i] = 0;
  }
  return 0;
}

}  // extern "C"
