// K4: the window-attention backward, up to the LN1 output. For the block
// input x and the cotangent g of the attention output (both spatial order,
// the block's cyclic shift in the addressing) it recomputes LN1, qkv and
// the softmax and returns
//   dy      = dqkv . Wqkv, the cotangent of the LN1 output, bf16 (rounded
//             once), scattered back to spatial order;
//   dWqkv   = dqkv^T . y and dWproj = g^T . ctx, f32 (nn.Linear layouts);
//   dbqkv   = sum of the f32 dq, dk, dv before their rounding;
//   drel    = sum over windows of the f32 dS, per head.
// The LN1 input backward and d proj_b = sum g stay outside, as in JAX.
//
// Replaces the TPU kernel _bwd_chunk_kernel / _pallas_bwd_impl
// (lrce_tpu/ops/pallas_window_attn.py), with its rounding points: dctx =
// g . Wproj rounds to bf16; q is pre-scaled on its bf16 value; P is an
// exact f32 softmax (the TPU's bf16 lane-sum does not port) and pb = bf16(P);
// dv = pb^T . dctx; dS = P (dP - rowsum(dP P)); dq = bf16(dS) . k . scale;
// dk = bf16(dS)^T . q_scaled. The TPU splits heads into chunks and W into
// groups only to fit VMEM; none of that comes across.
//
// What bounds it on the H100, and what the design does:
//   - the dense products (qkv again, dctx, dy) and the weight gradients are
//     the wgmma GEMMs of swin_common.cu; dctx and dy read Wproj and Wqkv in
//     place as (K x N) operands, the weight gradients are split-K with f32
//     partials summed in a fixed order;
//   - the attention CTA (attn_bwd_kernel) is bound by latency and shared
//     memory, not by the tensor cores: six 147 x 147 x 32 products per
//     (window, head) are too small for wgmma's 64-row tiles (N = 147 would
//     pad to 192 rows, 30% more work, and a head's 32-wide operands fill a
//     quarter of its 128-byte rows), so it uses mma.sync m16n8k16 fed by
//     ldmatrix, one warp per 16 query rows, ten warps for the 160 padded
//     rows. S = q k^T stays in the accumulator registers (80 a thread)
//     through bias, mask, softmax and dS; dP = dctx v^T is formed 8 keys at
//     a time, once for rowsum(dP P) and once more for dS (two k-steps each,
//     cheaper than 80 more live registers). Only bf16 P and dS go to shared
//     memory, for the transposed products dv = P^T dctx and dk = dS^T q,
//     which ldmatrix.trans reads in place;
//   - drel: each warp owns the same 16 query rows in every window its CTA
//     (window group, head) walks, so the f32 sum of dS over those windows
//     stays in its registers (80 more) and is written once per CTA; the
//     qkv-bias sums stay in shared memory per warp. Nothing is read back and
//     modified in device memory per window. The partials (groups x nH x N x
//     N, groups x 3C) are summed afterwards in a fixed order: no atomics;
//   - q, k, v, dctx rows of a head are 64 bytes: their tiles are stored
//     with an XOR swizzle on the 16-byte chunk and P / dS with rows padded
//     by 16 bytes, so every ldmatrix and every fragment store is free of
//     bank conflicts; the next window's four tiles arrive by cp.async into a
//     second buffer while this window multiplies; outputs leave as bf16
//     pairs straight from the accumulators (16 bytes per quad of lanes);
//   - padded keys are -inf before the softmax, so P and dS are zero there;
//     padded query rows of P and dS are stored as zeros and their q, k, v,
//     dctx rows are zero-filled, so they add nothing to dv, dk, drel or the
//     bias sums.
// The pieces are separate launches (LN + gather, qkv GEMM, dctx GEMM, the
// attention CTA, split-K GEMMs, dy GEMM) and the recomputed qkv and ctx are
// stored; keeping them on chip is later work.
//
// Windows of 161-448 tokens (16-frame clips of Swin-B: the window (8, 7, 7),
// N = 392 at every stage; Swin-L at 384 on 5-frame clips: (3, 12, 12), N =
// 432) take a pair of CTAs instead, because attn_bwd_kernel keeps
// a window's whole P and dS in shared memory (2 x 400 x 408 x 2 bytes at
// N = 392, three times the 227 KB there is) and a warp's S and drel for 400
// keys in registers (400 a thread, past the 255 cap). Nothing of size N x N
// stays on chip here; both CTAs stream over 16-wide blocks of the other
// side, with a runtime block count: no register array is indexed by it, so
// the loop body is the same for any N (the 26% that a runtime count cost
// attn_fwd_kernel came from register arrays sized by it).
//   - attn_bwd_rows_kernel, a CTA per (window group, head, 80 query rows),
//     a warp per 16 rows; k and v of the whole window in shared memory. A
//     first pass over the keys forms S and dP = dctx v^T 16 keys at a time
//     and keeps an online max, sum and sum of exp(S - max) dP per row, so
//     that P = exp(S - m) / l and rowsum(dP P) are known; it stores (m,
//     1 / l, rowsum) per row for the second CTA. A second pass forms S and
//     dP again, P and dS, and accumulates ctx = pb v and dq = bf16(dS) k
//     straight from the accumulator registers (the m16n8 result of two key
//     tiles is the m16k16 A operand of the next product), so P and dS never
//     reach shared memory;
//   - attn_bwd_cols_kernel, a CTA per (window group, head, 80 keys): two
//     sets of five warps, a warp per 16 keys in each set, the sets taking
//     alternate blocks of 16 queries. q and dctx of the window, the row
//     statistics and the labels stream into shared memory block by block
//     (a set refills a block's slot with the next window's block as soon
//     as it is done with it). For 16 queries at a time a warp forms S^T =
//     k q^T and dP^T = v dctx^T, P^T and dS^T from the statistics, and
//     accumulates dv = pb^T dctx and dk = bf16(dS)^T q; at the end of a
//     window set 1's f32 dk / dv are added to set 0's (in that order) and
//     leave once. Its 80 keys' columns of drel (N x 80 f32, rows padded to
//     84 floats: conflict-free fragment adds) stay in shared memory across
//     the windows it walks, each element owned by one thread of the set
//     whose queries it belongs to, and leave once per CTA (past 432 padded
//     tokens the rows lose their 4 floats of padding, BL_DREL_LD_TIGHT: at
//     Np = 448 the padded slice would take the CTA past 227 KB; the adds
//     then meet 4-way bank conflicts). Its first
//     version (one set of five warps, the window's tiles loaded and waited
//     for at each window's start, the bias read from L2 where each logit
//     needed it) ran 23x its bound at N = 392: one CTA of five warps an SM
//     left the card waiting on latency. Its expf became ex2.approx (2 ulp),
//     10-17% a call;
//   - the bias gradient's partials are per (window group, 80-row block):
//     the rows CTA writes the q columns, the columns CTA the k and v
//     columns. All f32 sums run in a fixed order: no atomics, and two calls
//     give the same bits;
//   - the rel_bias (0.61 MB a head at N = 392) is read from L2 once per
//     (window, head), CTA and pass, into registers a 16-wide block ahead of
//     its use (8 values a lane; read where it was needed, it left each step
//     waiting on L2: the rows CTA was 27% slower); the shift mask by its
//     region labels (Np ints a window, as attn_fwd.cu reads it): densely,
//     a clip's 64 masks at stage 0 are 39 MB, read three times a window;
//   - the pair does ten 16-row products per (window, head) where the
//     ten-warp CTA does six (S and dP once more in each CTA). On an NVIDIA
//     H100 80GB HBM3 at 700 W, the 24 calls of a 48-clip step of 16 frames
//     take ~190 ms against a 16.2 ms bound: the rows CTA ~64, the columns
//     CTA ~92 (timed alone); both wait on latency and on shared
//     memory, not on the tensor cores.
#include "swin_common.cuh"

#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

using namespace lrce;

namespace {

constexpr int BW_MAX_NB = 20;     // key blocks of 8: up to 160 padded tokens
constexpr int BW_MAX_WARPS = 10;  // one warp per 16 query rows
// the rows / columns pair for windows of 161-448 tokens
constexpr int BW_BIG_MAX_NP = 448;         // padded tokens
constexpr int BL_WARPS = 5;                // a warp per 16 rows of a block
constexpr int BL_ROWS = 16 * BL_WARPS;     // query rows or keys of a CTA
constexpr int BL_DREL_LD = BL_ROWS + 4;    // floats a row of the drel slice
constexpr int BL_DREL_LD_TIGHT = BL_ROWS;  // the same where that does not fit
constexpr int BC_SETS = 2;                 // the columns CTA's warp sets
constexpr int BC_WARPS = BL_WARPS * BC_SETS;

size_t bwd_smem_bytes(int Np, int hd) {
  return (size_t)8 * Np * hd * sizeof(bf16) +          // q k v dctx, twice
         (size_t)2 * Np * (Np + 8) * sizeof(bf16) +    // bf16 P and dS
         (size_t)(Np / 16) * 3 * hd * sizeof(float);   // bias sums per warp
}

int big_blocks(int Np) { return (Np + BL_ROWS - 1) / BL_ROWS; }

size_t rows_smem_bytes(int Np, int hd) {
  return (size_t)2 * BL_ROWS * hd * sizeof(bf16) +   // q, dctx of the block
         (size_t)2 * Np * hd * sizeof(bf16) +        // k, v of the window
         (size_t)Np * sizeof(int) +                  // mask labels
         (size_t)BL_WARPS * hd * sizeof(float);      // dq column sums
}

size_t cols_smem_bytes(int Np, int hd, int drel_ld) {
  return (size_t)2 * Np * hd * sizeof(bf16) +        // q, dctx of the window
         (size_t)Np * sizeof(float4) +               // row statistics
         (size_t)Np * sizeof(int) +                  // mask labels
         (size_t)Np * drel_ld * sizeof(float) +      // drel slice
         (size_t)BL_ROWS * 2 * hd * sizeof(float) +  // set 1's dk, dv
         (size_t)BL_WARPS * 2 * hd * sizeof(float);  // dk, dv column sums
}

// Floats a row of the columns CTA's drel slice: padded where it fits
int cols_drel_ld(int Np, int hd) {
  return cols_smem_bytes(Np, hd, BL_DREL_LD) <= kMaxSmem ? BL_DREL_LD
                                                          : BL_DREL_LD_TIGHT;
}

// Rows of the qkv-bias partials: one per window group for attn_bwd_kernel,
// one per (window group, 80-row block) for the pair.
long long bias_parts(int Np, int groups) {
  return Np <= 8 * BW_MAX_NB ? groups : (long long)groups * big_blocks(Np);
}

// One CTA per (window group, head), one warp per 16 query rows; it walks
// windows grp, grp + groups, ... qkv: (T, 3C) window order, [q | k | v]
// with head h at columns h*HD; dctx: (T, C) window order. Writes ctx (T, C)
// and dqkv (T, 3C), bf16, and at its end its partials prel[grp][h] (N x N)
// and pb[grp][.] (its head's 3 x HD columns of 3C).
template <int HD>
__global__ void __launch_bounds__(BW_MAX_WARPS * 32, 1)
attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                const float* __restrict__ rel_bias,
                const float* __restrict__ mask, bf16* __restrict__ ctx,
                bf16* __restrict__ dqkv, float* __restrict__ prel,
                float* __restrict__ pb, long long nwin_total, int nwin_clip,
                int N, int Np, int C, int groups, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k-steps over the head dim
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x, h = blockIdx.y, nH = gridDim.y;
  const int nb = Np >> 3;
  const int tile = Np * HD * 2;      // bytes of one of q, k, v, dctx
  const int PS = (Np + 8) * 2;       // bytes of a row of P / dS
  const uint32_t sbase = smem_u32(smem);
  const uint32_t p_off = 8 * tile, s_off = p_off + Np * PS;
  float* wbias = reinterpret_cast<float*>(smem + s_off + Np * PS);

  for (int i = tid; i < nwarps * 3 * HD; i += blockDim.x) wbias[i] = 0.f;
  float drel[BW_MAX_NB][4];
#pragma unroll
  for (int j = 0; j < BW_MAX_NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) drel[j][e] = 0.f;

  auto start_loads = [&](long long win, int b) {
    const bf16* qrow = qkv + win * N * (3LL * C) + h * HD;
    const bf16* grow = dctx + win * N * (long long)C + h * HD;
    for (int idx = tid; idx < Np * CH; idx += blockDim.x) {
      const int tok = idx / CH, c = idx % CH;
      const bool ok = tok < N;
      const uint32_t dst = sbase + b * 4 * tile + tok_off<HD>(tok, c);
      const bf16* src = qrow + (long long)tok * 3 * C + c * 8;
      cp_async16(dst, ok ? src : qkv, ok);
      cp_async16(dst + tile, ok ? src + C : qkv, ok);
      cp_async16(dst + 2 * tile, ok ? src + 2 * C : qkv, ok);
      cp_async16(dst + 3 * tile,
                 ok ? grow + (long long)tok * C + c * 8 : dctx, ok);
    }
  };

  const float* bias_h = rel_bias + (long long)h * N * N;
  const int r_lo = 16 * warp + g;          // this lane's rows: r_lo, r_lo + 8
  const int a_row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;

  int b = 0;
  if (grp < nwin_total) start_loads(grp, 0);
  cp_async_commit();
  for (long long win = grp; win < nwin_total; win += groups, b ^= 1) {
    cp_async_wait<0>();
    // pre-scale q on its bf16 value: each thread the chunks it copied
    for (int idx = tid; idx < N * CH; idx += blockDim.x) {
      uint4* p = reinterpret_cast<uint4*>(smem + b * 4 * tile +
                                          tok_off<HD>(idx / CH, idx % CH));
      uint4 v = *p;
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
      *p = v;
    }
    __syncthreads();  // tiles of `win` complete; the previous window is done
    if (win + groups < nwin_total) start_loads(win + groups, b ^ 1);
    cp_async_commit();

    const uint32_t qs = sbase + b * 4 * tile, ks = qs + tile, vs = ks + tile,
                   gs = vs + tile;

    // ---- phase 1, this warp's 16 query rows: P, dS, drel ----
    {
      uint32_t aq[KS][4], ag[KS][4];
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        ldsm_x4(aq[k], qs + tok_off<HD>(a_row, 2 * k + (lane >> 4)));
        ldsm_x4(ag[k], gs + tok_off<HD>(a_row, 2 * k + (lane >> 4)));
      }
      const int b_row = lane & 7, b_ch = (lane >> 3) & 1;
      float s[BW_MAX_NB][4];
#pragma unroll
      for (int j = 0; j < BW_MAX_NB; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        if (j < nb) {
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            uint32_t bb[2];
            ldsm_x2(bb, ks + tok_off<HD>(8 * j + b_row, 2 * k + b_ch));
            mma_bf16(s[j], aq[k], bb[0], bb[1]);
          }
        }
      }
      const float* mask_w =
          mask ? mask + (long long)(win % nwin_clip) * N * N : nullptr;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BW_MAX_NB; ++j) {
        if (j < nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r_lo + (e >> 1) * 8, col = 8 * j + 2 * t + (e & 1);
            float v = s[j][e];
            if (col >= N) {
              v = -INFINITY;
            } else if (r < N) {
              const long long o = (long long)r * N + col;
              v += mask_w ? bias_h[o] + mask_w[o] : bias_h[o];
            }
            s[j][e] = v;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
          }
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      }
#pragma unroll
      for (int j = 0; j < BW_MAX_NB; ++j) {
        if (j < nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = expf(s[j][e] - mx[e >> 1]);
            sum[e >> 1] += s[j][e];
          }
        }
      }
      float inv[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
        sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
        // a padded query row keeps P = dS = 0
        inv[hf] = r_lo + hf * 8 < N ? 1.f / sum[hf] : 0.f;
      }
      // P in s; rowsum(dP P) with dP = dctx v^T formed 8 keys at a time
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BW_MAX_NB; ++j) {
        if (j < nb) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            uint32_t bb[2];
            ldsm_x2(bb, vs + tok_off<HD>(8 * j + b_row, 2 * k + b_ch));
            mma_bf16(d, ag[k], bb[0], bb[1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= inv[e >> 1];
            rs[e >> 1] += d[e] * s[j][e];
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 1);
        rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 2);
      }
      // dS = P (dP - rs): into drel (f32), bf16 P and dS to shared memory
#pragma unroll
      for (int j = 0; j < BW_MAX_NB; ++j) {
        if (j < nb) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            uint32_t bb[2];
            ldsm_x2(bb, vs + tok_off<HD>(8 * j + b_row, 2 * k + b_ch));
            mma_bf16(d, ag[k], bb[0], bb[1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d[e] = s[j][e] * (d[e] - rs[e >> 1]);
            drel[j][e] += d[e];
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int o = (r_lo + hf * 8) * PS + (8 * j + 2 * t) * 2;
            *reinterpret_cast<__nv_bfloat162*>(smem + p_off + o) =
                __floats2bfloat162_rn(s[j][2 * hf], s[j][2 * hf + 1]);
            *reinterpret_cast<__nv_bfloat162*>(smem + s_off + o) =
                __floats2bfloat162_rn(d[2 * hf], d[2 * hf + 1]);
          }
        }
      }
    }
    __syncthreads();  // P and dS of every row are in shared memory

    // ---- phase 2, this warp's 16 rows of each product:
    //      ctx = pb v; dq = bf16(dS) k scale (its query rows);
    //      dv = pb^T dctx; dk = bf16(dS)^T q (its key rows) ----
    {
      float* wb = wbias + warp * 3 * HD;
      const long long tok0 = win * N;
      // sums the 16 rows of acc per column into wb[which], stores bf16
      auto finish = [&](float (&acc)[CH][4], int which, bf16* out, int ld,
                        float k) {
#pragma unroll
        for (int n = 0; n < CH; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= k;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r_lo + hf * 8;
            if (r < N)
              *reinterpret_cast<__nv_bfloat162*>(
                  out + (tok0 + r) * ld + h * HD + 8 * n + 2 * t) =
                  __floats2bfloat162_rn(acc[n][2 * hf], acc[n][2 * hf + 1]);
          }
          if (which >= 0) {
            float c0 = acc[n][0] + acc[n][2], c1 = acc[n][1] + acc[n][3];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              c0 += __shfl_xor_sync(0xffffffffu, c0, o);
              c1 += __shfl_xor_sync(0xffffffffu, c1, o);
            }
            if (g == 0) {
              wb[which * HD + 8 * n + 2 * t] += c0;
              wb[which * HD + 8 * n + 2 * t + 1] += c1;
            }
          }
        }
      };
      const int k_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // B, trans
      float acc_a[CH][4], acc_b[CH][4];
      auto clear = [&]() {
#pragma unroll
        for (int n = 0; n < CH; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc_a[n][e] = acc_b[n][e] = 0.f;
      };
      // ctx (from P, v) and dq (from dS, k): rows of P / dS as they lie
      clear();
      for (int kk = 0; kk < Np; kk += 16) {
        uint32_t ap[4], as[4];
        const uint32_t ao = a_row * PS + (kk + (lane >> 4) * 8) * 2;
        ldsm_x4(ap, sbase + p_off + ao);
        ldsm_x4(as, sbase + s_off + ao);
#pragma unroll
        for (int n2 = 0; n2 < KS; ++n2) {
          uint32_t bv[4], bk[4];
          const uint32_t bo = tok_off<HD>(kk + k_row, 2 * n2 + (lane >> 4));
          ldsm_x4_t(bv, vs + bo);
          ldsm_x4_t(bk, ks + bo);
          mma_bf16(acc_a[2 * n2], ap, bv[0], bv[1]);
          mma_bf16(acc_a[2 * n2 + 1], ap, bv[2], bv[3]);
          mma_bf16(acc_b[2 * n2], as, bk[0], bk[1]);
          mma_bf16(acc_b[2 * n2 + 1], as, bk[2], bk[3]);
        }
      }
      finish(acc_a, -1, ctx, C, 1.f);
      finish(acc_b, 0, dqkv, 3 * C, scale);
      // dv (from P^T, dctx) and dk (from dS^T, q): P / dS read transposed
      clear();
      const int t_row = (lane & 7) + (lane >> 4) * 8;        // query (k)
      const int t_col = 16 * warp + ((lane >> 3) & 1) * 8;   // key (m)
      for (int kk = 0; kk < Np; kk += 16) {
        uint32_t ap[4], as[4];
        const uint32_t ao = (kk + t_row) * PS + t_col * 2;
        ldsm_x4_t(ap, sbase + p_off + ao);
        ldsm_x4_t(as, sbase + s_off + ao);
#pragma unroll
        for (int n2 = 0; n2 < KS; ++n2) {
          uint32_t bg[4], bq[4];
          const uint32_t bo = tok_off<HD>(kk + k_row, 2 * n2 + (lane >> 4));
          ldsm_x4_t(bg, gs + bo);
          ldsm_x4_t(bq, qs + bo);
          mma_bf16(acc_a[2 * n2], ap, bg[0], bg[1]);
          mma_bf16(acc_a[2 * n2 + 1], ap, bg[2], bg[3]);
          mma_bf16(acc_b[2 * n2], as, bq[0], bq[1]);
          mma_bf16(acc_b[2 * n2 + 1], as, bq[2], bq[3]);
        }
      }
      finish(acc_a, 2, dqkv + 2 * C, 3 * C, 1.f);
      finish(acc_b, 1, dqkv + C, 3 * C, 1.f);
    }
  }

  // this CTA's partials, written once
  __syncthreads();
  for (int i = tid; i < 3 * HD; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += wbias[w * 3 * HD + i];
    pb[(long long)grp * 3 * C + (i / HD) * C + h * HD + i % HD] = s;
  }
  float* relp = prel + ((long long)grp * nH + h) * N * N;
#pragma unroll
  for (int j = 0; j < BW_MAX_NB; ++j) {
    if (j < nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_lo + (e >> 1) * 8, col = 8 * j + 2 * t + (e & 1);
        if (r < N && col < N) relp[(long long)r * N + col] = drel[j][e];
      }
    }
  }
}

// Pre-scales the q rows [0, rows) of a swizzled head tile at `tile` (a
// generic pointer) on their bf16 values: each thread the chunks that the
// same loop over idx gave it to copy.
template <int HD>
__device__ __forceinline__ void scale_tile(unsigned char* tile, int rows,
                                           float scale) {
  constexpr int CH = HD / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    uint4* p = reinterpret_cast<uint4*>(tile + tok_off<HD>(idx / CH,
                                                           idx % CH));
    uint4 v = *p;
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
    *p = v;
  }
}

// A warp's 16 x HD f32 accumulator (rows r_lo and r_lo + 8 of the window
// for lane 4 g + t) times k: rows below N stored as bf16 at out + row * ld;
// with sums, the column sums of the scaled f32 values added into sums[0,
// HD) (rows at or past N hold zeros).
template <int HD>
__device__ __forceinline__ void store_rows(float (&acc)[HD / 8][4], float k,
                                           bf16* out, long long ld, int r_lo,
                                           int N, float* sums, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= k;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r_lo + hf * 8;
      if (r < N)
        *reinterpret_cast<__nv_bfloat162*>(out + r * ld + 8 * n + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
    if (sums) {
      float c0 = acc[n][0] + acc[n][2], c1 = acc[n][1] + acc[n][3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        c0 += __shfl_xor_sync(0xffffffffu, c0, o);
        c1 += __shfl_xor_sync(0xffffffffu, c1, o);
      }
      if (g == 0) {
        sums[8 * n + 2 * t] += c0;
        sums[8 * n + 2 * t + 1] += c1;
      }
    }
  }
}

// What window `win` adds to the logit of (query r, key c) besides the bias,
// as attn_fwd.cu reads it: nothing; off where the two tokens' labels differ
// (labels of the window in shared memory, off = mask_off[window], not NaN);
// or the dense mask. The three give the same sums: a label form exists only
// where it reproduces the dense mask exactly (ops/window_attn.
// shift_mask_labels), and bias + 0 is the bias.
struct MaskForm {
  const float* dense;  // the window's (N, N) mask, or null
  bool by_label;
  float off;
  __device__ __forceinline__ float value(const int* lab, int r, int c,
                                         int N) const {
    if (dense) return dense[(long long)r * N + c];
    if (by_label) return lab[r] == lab[c] ? 0.f : off;
    return 0.f;
  }
};

__device__ __forceinline__ MaskForm mask_form(const float* mask,
                                              const int* labels,
                                              const float* mask_off,
                                              long long win, int nwin_clip,
                                              int N) {
  MaskForm f = {nullptr, false, 0.f};
  if (!mask) return f;
  const int wc = (int)(win % nwin_clip);
  if (labels) f.off = mask_off[wc];
  if (!labels || isnan(f.off))
    f.dense = mask + (long long)wc * N * N;
  else
    f.by_label = f.off != 0.f;
  return f;
}

// The Np int32 labels of a window (Np a multiple of 16) into shared memory
// at dst, by cp.async.
__device__ __forceinline__ void load_labels(uint32_t dst, const int* src,
                                            int Np) {
  for (int i = threadIdx.x; i < Np / 4; i += blockDim.x)
    cp_async16(dst + i * 16, src + 4 * i, true);
}

// 2^x by ex2.approx (2 ulp): exp(v - m) is 2^(v log2 e - m log2 e), one
// fused multiply-add and one MUFU op where expf takes eight instructions
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The rows CTA of the pair (see the note at the top): grid (groups, nH,
// big_blocks(Np)), BL_WARPS warps. Writes ctx and the dq columns of dqkv
// for its rows, (m, 1 / l, rowsum(dP P), 0) of every row below Np into
// stats[(win * nH + h) * Np + row], and its dq column sums into row (grp *
// blocks + blk) of pb.
template <int HD>
__global__ void __launch_bounds__(BL_WARPS * 32)
attn_bwd_rows_kernel(const bf16* __restrict__ qkv,
                     const bf16* __restrict__ dctx,
                     const float* __restrict__ rel_bias,
                     const float* __restrict__ mask,
                     const int* __restrict__ labels,
                     const float* __restrict__ mask_off,
                     bf16* __restrict__ ctx,
                     bf16* __restrict__ dqkv, float4* __restrict__ stats,
                     float* __restrict__ pb, long long nwin_total,
                     int nwin_clip, int N, int Np, int C, int groups,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k-steps over the head dim
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x, h = blockIdx.y, blk = blockIdx.z;
  const int nH = gridDim.y, nblk = gridDim.z;
  const int row0 = blk * BL_ROWS;
  const int own = BL_ROWS * HD * 2, full = Np * HD * 2;   // tile bytes
  const uint32_t qs = smem_u32(smem), gs = qs + own, ks = gs + own,
                 vs = ks + full, ls = vs + full;
  const int* lab = reinterpret_cast<const int*>(smem + 2 * own + 2 * full);
  float* wsum = reinterpret_cast<float*>(smem + 2 * own + 2 * full +
                                         Np * sizeof(int));
  for (int i = tid; i < BL_WARPS * HD; i += blockDim.x) wsum[i] = 0.f;

  const float* bias_h = rel_bias + (long long)h * N * N;
  const int r_lo = row0 + 16 * warp + g;   // this lane's rows: r_lo, r_lo + 8
  const int a_row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_row = lane & 7, b_ch = (lane >> 3) & 1;
  const int k_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // B, trans
  const bool active = row0 + 16 * warp < N;               // warp-uniform

  for (long long win = grp; win < nwin_total; win += groups) {
    const bf16* qrow = qkv + win * N * (3LL * C) + h * HD;
    const bf16* grow = dctx + win * N * (long long)C + h * HD;
    for (int idx = tid; idx < BL_ROWS * CH; idx += blockDim.x) {
      const int r = idx / CH, c = idx % CH, tok = row0 + r;
      const bool ok = tok < N;
      const uint32_t dst = tok_off<HD>(r, c);
      cp_async16(qs + dst, ok ? qrow + (long long)tok * 3 * C + c * 8 : qkv,
                 ok);
      cp_async16(gs + dst, ok ? grow + (long long)tok * C + c * 8 : dctx, ok);
    }
    for (int idx = tid; idx < Np * CH; idx += blockDim.x) {
      const int tok = idx / CH, c = idx % CH;
      const bool ok = tok < N;
      const uint32_t dst = tok_off<HD>(tok, c);
      const bf16* src = qrow + (long long)tok * 3 * C + c * 8;
      cp_async16(ks + dst, ok ? src + C : qkv, ok);
      cp_async16(vs + dst, ok ? src + 2 * C : qkv, ok);
    }
    const MaskForm mf = mask_form(mask, labels, mask_off, win, nwin_clip, N);
    if (mf.by_label)
      load_labels(ls, labels + (long long)(win % nwin_clip) * Np, Np);
    cp_async_commit();
    cp_async_wait<0>();
    scale_tile<HD>(smem, BL_ROWS, scale);
    __syncthreads();  // the window's tiles are complete

    if (active) {
      uint32_t aq[KS][4], ag[KS][4];
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        ldsm_x4(aq[k], qs + tok_off<HD>(a_row, 2 * k + (lane >> 4)));
        ldsm_x4(ag[k], gs + tok_off<HD>(a_row, 2 * k + (lane >> 4)));
      }
      // this lane's bias for keys kk .. kk + 15 (0 past N), loaded a step
      // ahead of its use
      auto load_bias = [&](float (&bv)[2][4], int kk) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r_lo + (e >> 1) * 8,
                      col = kk + 8 * j + 2 * t + (e & 1);
            bv[j][e] = col < N && r < N ? bias_h[(long long)r * N + col] : 0.f;
          }
      };
      // S (+ bias, mask; -inf past N) and dP for keys kk .. kk + 15
      auto scores = [&](float (&s)[2][4], float (&d)[2][4], int kk,
                        const float (&bv)[2][4]) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = d[j][e] = 0.f;
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            uint32_t bb[2];
            const uint32_t o = tok_off<HD>(kk + 8 * j + b_row, 2 * k + b_ch);
            ldsm_x2(bb, ks + o);
            mma_bf16(s[j], aq[k], bb[0], bb[1]);
            ldsm_x2(bb, vs + o);
            mma_bf16(d[j], ag[k], bb[0], bb[1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r_lo + (e >> 1) * 8,
                      col = kk + 8 * j + 2 * t + (e & 1);
            if (col >= N)
              s[j][e] = -INFINITY;
            else if (r < N)
              s[j][e] += bv[j][e] + mf.value(lab, r, col, N);
          }
        }
      };

      // pass 1: per row the max m, l = sum exp(S - m) and sum exp(S - m)
      // dP, online over the key blocks, then across the quad's lanes
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
            rsum[2] = {0.f, 0.f};
      float bcur[2][4];
      load_bias(bcur, 0);
      for (int kk = 0; kk < Np; kk += 16) {
        float s[2][4], d[2][4], bnxt[2][4];
        load_bias(bnxt, kk + 16 < Np ? kk + 16 : 0);
        scores(s, d, kk, bcur);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) bcur[j][e] = bnxt[j][e];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = m[hf];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
          const float base = mx == -INFINITY ? 0.f : mx;
          const float c = expf(m[hf] - base);
          l[hf] *= c;
          rsum[hf] *= c;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
              const float p = expf(s[j][e] - base);
              l[hf] += p;
              rsum[hf] += p * d[j][e];
            }
          m[hf] = mx;
        }
      }
      float inv[2], rs[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[hf], o);
          const float lo = __shfl_xor_sync(0xffffffffu, l[hf], o);
          const float ro = __shfl_xor_sync(0xffffffffu, rsum[hf], o);
          const float mx = fmaxf(m[hf], mo);
          const float base = mx == -INFINITY ? 0.f : mx;
          const float ca = expf(m[hf] - base), cb = expf(mo - base);
          l[hf] = l[hf] * ca + lo * cb;
          rsum[hf] = rsum[hf] * ca + ro * cb;
          m[hf] = mx;
        }
        const int r = r_lo + hf * 8;
        // a padded query row keeps P = dS = 0
        inv[hf] = r < N ? 1.f / l[hf] : 0.f;
        rs[hf] = rsum[hf] * inv[hf];
        if (t == 0)
          stats[((long long)win * nH + h) * Np + r] =
              make_float4(m[hf], inv[hf], rs[hf], 0.f);
      }

      // pass 2: P, dS; ctx += pb v and dq += bf16(dS) k, 16 keys a step
      float acc_c[CH][4], acc_q[CH][4];
#pragma unroll
      for (int n = 0; n < CH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_c[n][e] = acc_q[n][e] = 0.f;
      load_bias(bcur, 0);
      for (int kk = 0; kk < Np; kk += 16) {
        float s[2][4], d[2][4], bnxt[2][4];
        load_bias(bnxt, kk + 16 < Np ? kk + 16 : 0);
        scores(s, d, kk, bcur);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) bcur[j][e] = bnxt[j][e];
        uint32_t ap[4], as[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float p0 = expf(s[j][2 * hf] - m[hf]) * inv[hf];
            const float p1 = expf(s[j][2 * hf + 1] - m[hf]) * inv[hf];
            ap[2 * j + hf] = pack_bf16(p0, p1);
            as[2 * j + hf] = pack_bf16(p0 * (d[j][2 * hf] - rs[hf]),
                                       p1 * (d[j][2 * hf + 1] - rs[hf]));
          }
#pragma unroll
        for (int n2 = 0; n2 < KS; ++n2) {
          uint32_t bv[4], bk[4];
          const uint32_t bo = tok_off<HD>(kk + k_row, 2 * n2 + (lane >> 4));
          ldsm_x4_t(bv, vs + bo);
          ldsm_x4_t(bk, ks + bo);
          mma_bf16(acc_c[2 * n2], ap, bv[0], bv[1]);
          mma_bf16(acc_c[2 * n2 + 1], ap, bv[2], bv[3]);
          mma_bf16(acc_q[2 * n2], as, bk[0], bk[1]);
          mma_bf16(acc_q[2 * n2 + 1], as, bk[2], bk[3]);
        }
      }
      store_rows<HD>(acc_c, 1.f, ctx + win * N * (long long)C + h * HD, C,
                     r_lo, N, nullptr, lane);
      store_rows<HD>(acc_q, scale, dqkv + win * N * (3LL * C) + h * HD,
                     3LL * C, r_lo, N, wsum + warp * HD, lane);
    }
    __syncthreads();  // every warp is done with this window's tiles
  }

  for (int i = tid; i < HD; i += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < BL_WARPS; ++w) v += wsum[w * HD + i];
    pb[((long long)grp * nblk + blk) * 3 * C + h * HD + i] = v;
  }
}

// Waits until at most n (0 .. 12) of this thread's cp.async groups are
// still in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 12: cp_async_wait<12>(); break;
    case 11: cp_async_wait<11>(); break;
    case 10: cp_async_wait<10>(); break;
    case 9: cp_async_wait<9>(); break;
    case 8: cp_async_wait<8>(); break;
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// Arrival at named barrier `id` without waiting for it (the producer's
// side of a producer / consumer pair of warps; named_bar_sync waits).
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The columns CTA of the pair: grid (groups, nH, big_blocks(Np)), BC_WARPS
// warps in BC_SETS sets of BL_WARPS, LD floats a row of the drel slice
// (cols_drel_ld); runs after the rows CTA, whose stats it
// reads. Writes the dk and dv columns of dqkv for its keys, its keys'
// columns of drel summed over its windows into prel[grp][h] (N x N), and its
// dk, dv column sums into row (grp * blocks + blk) of pb.
//   - warp w of set s takes keys key0 + 16 w .. + 15 and the query blocks
//     qb = s, s + 2, s + 4, ... of every window, so that the two sets add
//     into disjoint rows of the one N x 80 drel slice; at the end of a
//     window set 1 hands its f32 dk / dv through shared memory to set 0,
//     which adds them to its own (set 0 first) and stores them once;
//   - q, dctx, the statistics and the labels stream in per query block: a
//     set refills the slot of the block it finished with the same block of
//     its next window, so a window's copies are in flight while the one
//     before it multiplies (cp.async groups, one a block, waited for in
//     order; a set's own named barrier per block);
//   - k and v of the CTA's keys go from device memory straight into the
//     warps' A fragments, the next window's while this one runs;
//   - the bias of the next query block is loaded into registers while this
//     one multiplies (8 values a thread), not read when it is needed.
template <int HD, int LD>
__global__ void __launch_bounds__(BC_WARPS * 32, 1)
attn_bwd_cols_kernel(const bf16* __restrict__ qkv,
                     const bf16* __restrict__ dctx,
                     const float* __restrict__ rel_bias,
                     const float* __restrict__ mask,
                     const int* __restrict__ labels,
                     const float* __restrict__ mask_off,
                     const float4* __restrict__ stats,
                     bf16* __restrict__ dqkv, float* __restrict__ prel,
                     float* __restrict__ pb, long long nwin_total,
                     int nwin_clip, int N, int Np, int C, int groups,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CH = HD / 8;
  constexpr int KS = HD / 16;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp % BL_WARPS, set = warp / BL_WARPS;
  const int st = tid % (BL_WARPS * 32);          // thread within its set
  const int grp = blockIdx.x, h = blockIdx.y, blk = blockIdx.z;
  const int nH = gridDim.y, nblk = gridDim.z;
  const int key0 = blk * BL_ROWS;
  const int full = Np * HD * 2;                  // tile bytes
  const int nqb = Np >> 4;                       // query blocks of 16
  const int nbs = (nqb - set + 1) >> 1;          // this set's blocks
  const uint32_t qs = smem_u32(smem), gs = qs + full, ss = gs + full,
                 ls = ss + Np * sizeof(float4);
  const float4* stq = reinterpret_cast<const float4*>(smem + 2 * full);
  const int* lab = reinterpret_cast<const int*>(smem + 2 * full +
                                                Np * sizeof(float4));
  float* drs = reinterpret_cast<float*>(smem + 2 * full +
                                        Np * (sizeof(float4) + sizeof(int)));
  float4* xk = reinterpret_cast<float4*>(drs + Np * LD);
  float* wsum = reinterpret_cast<float*>(xk + BL_WARPS * 2 * CH * 32);

  // the copies of query block qb of window win, by this set's threads
  auto load_block = [&](long long win, int qb) {
    constexpr int TILE_COPIES = 2 * 16 * CH;  // q and dctx rows
    const bf16* qrow = qkv + win * N * (3LL * C) + h * HD;
    const bf16* grow = dctx + win * N * (long long)C + h * HD;
    const int r0 = 16 * qb;
    for (int idx = st; idx < TILE_COPIES + 16 + 4; idx += BL_WARPS * 32) {
      if (idx < TILE_COPIES) {
        const int which = idx / (16 * CH), r = (idx / CH) % 16, c = idx % CH;
        const int tok = r0 + r;
        const bool ok = tok < N;
        const bf16* src = which ? grow + (long long)tok * C + c * 8
                                : qrow + (long long)tok * 3 * C + c * 8;
        cp_async16((which ? gs : qs) + tok_off<HD>(tok, c), ok ? src : qkv,
                   ok);
      } else if (idx < TILE_COPIES + 16) {
        const int r = r0 + idx - TILE_COPIES;
        cp_async16(ss + (uint32_t)r * 16u,
                   stats + ((long long)win * nH + h) * Np + r, true);
      } else if (labels) {
        const int r = r0 + 4 * (idx - TILE_COPIES - 16);
        cp_async16(ls + r * 4, labels + (long long)(win % nwin_clip) * Np + r,
                   true);
      }
    }
  };
  // pre-scales the q rows of block qb that this thread copied, once its
  // copies have landed
  auto scale_block = [&](int qb) {
    for (int idx = st; idx < 16 * CH; idx += BL_WARPS * 32) {
      uint4* p = reinterpret_cast<uint4*>(
          smem + tok_off<HD>(16 * qb + idx / CH, idx % CH));
      uint4 v = *p;
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
      *p = v;
    }
  };

  // the set's walk is a sequence of items (window, i), block qb = 2 i +
  // set; item k's copies are cp.async group k of this thread: the first
  // nbs - 1 here, item k + nbs - 1's when item k starts
  {
    int i = 0;
    for (long long win = grp; win < nwin_total && i < nbs - 1; ++i)
      load_block(win, 2 * i + set), cp_async_commit();
    for (; i < nbs - 1; ++i) cp_async_commit();
  }
  for (int i = tid; i < Np * LD; i += blockDim.x) drs[i] = 0.f;
  for (int i = tid; i < BL_WARPS * 2 * HD; i += blockDim.x) wsum[i] = 0.f;
  __syncthreads();

  const float* bias_h = rel_bias + (long long)h * N * N;
  const int kr_lo = key0 + 16 * kw + g;    // this lane's keys: kr_lo, + 8
  const int b_row = lane & 7, b_ch = (lane >> 3) & 1;
  const int k_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const bool active = key0 + 16 * kw < N;  // warp-uniform

  // k and v of the warp's 16 keys as A fragments, straight from qkv
  auto load_kv = [&](long long win, uint32_t (&ak)[KS][4],
                     uint32_t (&av)[KS][4]) {
    const bf16* base = qkv + win * N * (3LL * C) + h * HD;
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = kr_lo + (i & 1) * 8, c = 16 * k + 2 * t + (i >> 1) * 8;
        const bf16* p = base + (long long)r * 3 * C + c;
        ak[k][i] = r < N ? *reinterpret_cast<const uint32_t*>(p + C) : 0u;
        av[k][i] = r < N ? *reinterpret_cast<const uint32_t*>(p + 2 * C) : 0u;
      }
  };
  // this lane's bias values of query block qb: (j, hf, i) -> query 16 qb +
  // 8 j + 2 t + i, key kr_lo + 8 hf
  auto load_bias = [&](int qb, float (&bv)[2][2][2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kr = kr_lo + hf * 8, qc = 16 * qb + 8 * j + 2 * t + i;
          bv[j][hf][i] =
              kr < N && qc < N ? bias_h[(long long)qc * N + kr] : 0.f;
        }
  };

  uint32_t ak[KS][4], av[KS][4], nk[KS][4], nv[KS][4];
  float bias_cur[2][2][2];
  if (active && grp < nwin_total) {
    load_kv(grp, nk, nv);
    load_bias(set, bias_cur);
  }
  bool handed = false;  // set 1 has handed set 0 a window's dk / dv
  for (long long win = grp; win < nwin_total; win += groups) {
    const MaskForm mf = mask_form(mask, labels, mask_off, win, nwin_clip, N);
    const bool more = win + groups < nwin_total;
    if (active) {
#pragma unroll
      for (int k = 0; k < KS; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ak[k][i] = nk[k][i];
          av[k][i] = nv[k][i];
        }
      if (more) load_kv(win + groups, nk, nv);
    }
    // the labels of this lane's two keys (a query's come with its block)
    int klab[2] = {0, 0};
    if (active && mf.by_label)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        klab[hf] = labels[(long long)(win % nwin_clip) * Np + kr_lo + 8 * hf];
    float acc_k[CH][4], acc_v[CH][4];
#pragma unroll
    for (int n = 0; n < CH; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

    for (int i = 0; i < nbs; ++i) {
      const int qb = 2 * i + set;
      cp_async_wait_upto(nbs - 2);
      scale_block(qb);
      named_bar_sync(1 + set, BL_WARPS * 32);  // block qb is in, i - 1 done
      // refill: block nbs - 1 of this window at i = 0, else block i - 1 of
      // the next window
      if (i == 0)
        load_block(win, 2 * (nbs - 1) + set);
      else if (more)
        load_block(win + groups, qb - 2);
      cp_async_commit();
      if (!active) continue;

      // the next block's bias (the first of the next window after the last)
      float bias_nxt[2][2][2];
      load_bias(i + 1 < nbs ? qb + 2 : set, bias_nxt);

      // S^T and dP^T for this warp's 16 keys and queries 16 qb .. + 15
      float s[2][4], d[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = d[j][e] = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          uint32_t bb[2];
          const uint32_t o = tok_off<HD>(16 * qb + 8 * j + b_row, 2 * k + b_ch);
          ldsm_x2(bb, qs + o);
          mma_bf16(s[j], ak[k], bb[0], bb[1]);
          ldsm_x2(bb, gs + o);
          mma_bf16(d[j], av[k], bb[0], bb[1]);
        }
      }
      uint32_t ap[4], as[4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float p[2], ds[2];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int e = 2 * hf + ii;
            const int kr = kr_lo + hf * 8, qc = 16 * qb + 8 * j + 2 * t + ii;
            p[ii] = ds[ii] = 0.f;
            if (kr < N && qc < N) {
              const float4 sq = stq[qc];
              float madd = 0.f;
              if (mf.dense)
                madd = mf.dense[(long long)qc * N + kr];
              else if (mf.by_label)
                madd = lab[qc] == klab[hf] ? 0.f : mf.off;
              const float v = s[j][e] + (bias_cur[j][hf][ii] + madd);
              p[ii] = ex2_approx(fmaf(v, kLog2e, -sq.x * kLog2e)) * sq.y;
              ds[ii] = p[ii] * (d[j][e] - sq.z);
            }
            drs[qc * LD + 16 * kw + g + hf * 8] += ds[ii];
          }
          ap[2 * j + hf] = pack_bf16(p[0], p[1]);
          as[2 * j + hf] = pack_bf16(ds[0], ds[1]);
        }
#pragma unroll
      for (int n2 = 0; n2 < KS; ++n2) {
        uint32_t bg[4], bq[4];
        const uint32_t bo = tok_off<HD>(16 * qb + k_row, 2 * n2 + (lane >> 4));
        ldsm_x4_t(bg, gs + bo);
        ldsm_x4_t(bq, qs + bo);
        mma_bf16(acc_v[2 * n2], ap, bg[0], bg[1]);
        mma_bf16(acc_v[2 * n2 + 1], ap, bg[2], bg[3]);
        mma_bf16(acc_k[2 * n2], as, bq[0], bq[1]);
        mma_bf16(acc_k[2 * n2 + 1], as, bq[2], bq[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
            bias_cur[j][hf][ii] = bias_nxt[j][hf][ii];
    }

    // set 1's dk / dv into set 0's, set 0's first; out once as bf16
    float4* x = xk + kw * 2 * CH * 32 + lane;
    if (set == 1) {
      // set 0 has read the last window's
      if (handed) named_bar_sync(4, BC_WARPS * 32);
      if (active)
#pragma unroll
        for (int n = 0; n < CH; ++n) {
          x[(2 * n) * 32] =
              make_float4(acc_k[n][0], acc_k[n][1], acc_k[n][2], acc_k[n][3]);
          x[(2 * n + 1) * 32] =
              make_float4(acc_v[n][0], acc_v[n][1], acc_v[n][2], acc_v[n][3]);
        }
      named_bar_arrive(3, BC_WARPS * 32);
      handed = true;
    } else {
      named_bar_sync(3, BC_WARPS * 32);
      if (active) {
#pragma unroll
        for (int n = 0; n < CH; ++n) {
          const float4 uk = x[(2 * n) * 32], uv = x[(2 * n + 1) * 32];
          acc_k[n][0] += uk.x; acc_k[n][1] += uk.y;
          acc_k[n][2] += uk.z; acc_k[n][3] += uk.w;
          acc_v[n][0] += uv.x; acc_v[n][1] += uv.y;
          acc_v[n][2] += uv.z; acc_v[n][3] += uv.w;
        }
        bf16* out = dqkv + win * N * (3LL * C) + h * HD;
        float* ws = wsum + kw * 2 * HD;
        store_rows<HD>(acc_k, 1.f, out + C, 3LL * C, kr_lo, N, ws, lane);
        store_rows<HD>(acc_v, 1.f, out + 2 * C, 3LL * C, kr_lo, N, ws + HD,
                       lane);
      }
      named_bar_arrive(4, BC_WARPS * 32);
    }
  }
  if (set == 1 && handed) named_bar_sync(4, BC_WARPS * 32);
  cp_async_wait<0>();
  __syncthreads();  // every drel add and column sum is in

  for (int i = tid; i < 2 * HD; i += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < BL_WARPS; ++w) v += wsum[w * 2 * HD + i];
    pb[((long long)grp * nblk + blk) * 3 * C + (1 + i / HD) * C + h * HD +
       i % HD] = v;
  }
  float* relp = prel + ((long long)grp * nH + h) * N * N;
  for (int idx = tid; idx < N * BL_ROWS; idx += blockDim.x) {
    const int q = idx / BL_ROWS, kl = idx % BL_ROWS;
    if (key0 + kl < N)
      relp[(long long)q * N + key0 + kl] = drs[q * LD + kl];
  }
}

// The attention backward proper, by shape: attn_bwd_kernel for windows of at
// most 160 padded tokens (the dense mask), else the rows / columns pair
// (the mask by labels where they are given, see MaskForm; stats: (windows,
// nH, Np) float4).
template <int HD>
int launch_attn_bwd(const bf16* qkv, const bf16* dctx, const float* rel_bias,
                    const float* mask, const int* labels,
                    const float* mask_off, bf16* ctx, bf16* dqkv, float* prel,
                    float* pb, float4* stats, long long nwin_total,
                    int nwin_clip, int N, int Np, int C, int num_heads,
                    int groups, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)HD);
  if (Np <= 8 * BW_MAX_NB) {
    const size_t smem = bwd_smem_bytes(Np, HD);
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attn_bwd_kernel<HD><<<dim3(groups, num_heads), Np * 2, smem, stream>>>(
        qkv, dctx, rel_bias, mask, ctx, dqkv, prel, pb, nwin_total,
        nwin_clip, N, Np, C, groups, scale);
    return (int)cudaGetLastError();
  }
  const int drel_ld = cols_drel_ld(Np, HD);
  const size_t s_rows = rows_smem_bytes(Np, HD);
  const size_t s_cols = cols_smem_bytes(Np, HD, drel_ld);
  if (Np > BW_BIG_MAX_NP || s_rows > kMaxSmem || s_cols > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto cols = drel_ld == BL_DREL_LD ? attn_bwd_cols_kernel<HD, BL_DREL_LD>
                                    : attn_bwd_cols_kernel<HD, BL_DREL_LD_TIGHT>;
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_rows_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s_rows);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)s_cols);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(groups, num_heads, big_blocks(Np));
  attn_bwd_rows_kernel<HD><<<grid, BL_WARPS * 32, s_rows, stream>>>(
      qkv, dctx, rel_bias, mask, labels, mask_off, ctx, dqkv, stats, pb,
      nwin_total, nwin_clip, N, Np, C, groups, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cols<<<grid, BC_WARPS * 32, s_cols, stream>>>(
      qkv, dctx, rel_bias, mask, labels, mask_off, stats, dqkv, prel, pb,
      nwin_total, nwin_clip, N, Np, C, groups, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4. Spatial inputs x, g (B, D, H, W, C) bf16; qkv_w (3C, C), proj_w
// (C, C) bf16; ln_s, ln_b, qkv_b, rel_bias (nH, N, N), mask (nd, nh, nw, N,
// N) or null, f32; mask_labels (nd nh nw, Np) int32 and mask_off (nd nh nw)
// f32, the mask's label form (launch_attn in swin_common.cuh), or null:
// read by the pair only. Outputs: dy (B, D, H, W, C) bf16; dqkv_w (3C, C), dqkv_b
// (3C), dproj_w (C, C), drel (nH, N, N) f32. Workspaces (T = B D H W
// tokens): ws_y, ws_g, ws_dctx, ws_ctx (T, C) bf16; ws_qkv, ws_dqkv (T, 3C)
// bf16; ws_prel (groups, nH, N, N) f32; ws_pb (groups, 3C) f32, or
// (groups x blocks, 3C) for windows of more than 160 padded tokens (blocks =
// ceil(Np / 80)); ws_split (splits, 3C, C) f32; ws_stats (windows, nH, Np,
// 4) f32 for windows of more than 160 padded tokens, else unused (Np = N
// rounded up to 16). Takes head_dim 16 or 32 and windows of at most 448
// tokens; 1 <= groups <= windows.
int lrce_attn_bwd(const void* x, const void* g, int B, int D, int H, int W,
                  int C, int wd, int wh, int ww, int sd, int sh, int sw,
                  int num_heads, float eps, const void* ln_s,
                  const void* ln_b, const void* qkv_w, const void* qkv_b,
                  const void* proj_w, const void* rel_bias, const void* mask,
                  const void* mask_labels, const void* mask_off,
                  void* dy, void* dqkv_w, void* dqkv_b, void* dproj_w,
                  void* drel, void* ws_y, void* ws_qkv, void* ws_g,
                  void* ws_dctx, void* ws_ctx, void* ws_dqkv, void* ws_prel,
                  void* ws_pb, void* ws_split, void* ws_stats, int groups,
                  int splits, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const WinGeom geo = make_geom(B, D, H, W, C, wd, wh, ww, sd, sh, sw);
  const long long T = (long long)B * D * H * W;
  const int N = geo.N;
  const int Np = (N + 15) / 16 * 16;
  const int hd = C / num_heads;
  const long long nwin_total = T / N;
  if (Np > BW_BIG_MAX_NP || groups < 1 || groups > nwin_total ||
      (mask_labels && !mask_off))
    return (int)cudaErrorInvalidValue;
  bf16* y = static_cast<bf16*>(ws_y);
  bf16* qkv = static_cast<bf16*>(ws_qkv);
  bf16* gw = static_cast<bf16*>(ws_g);
  bf16* dctx = static_cast<bf16*>(ws_dctx);
  bf16* ctx = static_cast<bf16*>(ws_ctx);
  bf16* dqkv = static_cast<bf16*>(ws_dqkv);
  float* prel = static_cast<float*>(ws_prel);
  float* pbias = static_cast<float*>(ws_pb);
  float4* stats = static_cast<float4*>(ws_stats);

  // recompute y = LN1(x) and qkv, window order (shift in the gather)
  int rc = launch_ln(static_cast<const bf16*>(x), y,
                     static_cast<const float*>(ln_s),
                     static_cast<const float*>(ln_b), T, eps, geo, 1, stream);
  if (rc) return rc;
  Epilogue eq = {};
  eq.mode = EPI_BIAS;
  eq.bias = static_cast<const float*>(qkv_b);
  rc = launch_gemm(y, static_cast<const bf16*>(qkv_w), qkv, T, 3 * C, C, eq,
                   stream);
  if (rc) return rc;
  // g into window order; dctx = g . Wproj, rounded to bf16
  rc = launch_gather(static_cast<const bf16*>(g), gw, T, geo, stream);
  if (rc) return rc;
  Epilogue er = {};
  er.mode = EPI_ATTN_OUT;  // bias null, no dp / residual / scatter: bf16(acc)
  er.dp_rows = 1;
  rc = launch_gemm(gw, static_cast<const bf16*>(proj_w), dctx, T, C, C, er,
                   stream, true);
  if (rc) return rc;

  // the attention backward proper
  const int nwin_clip = geo.nd * geo.nh * geo.nw;
  const float* rb = static_cast<const float*>(rel_bias);
  const float* mk = static_cast<const float*>(mask);
  const int* lb = static_cast<const int*>(mask_labels);
  const float* mo = static_cast<const float*>(mask_off);
  switch (hd) {
    case 16:
      rc = launch_attn_bwd<16>(qkv, dctx, rb, mk, lb, mo, ctx, dqkv, prel,
                               pbias, stats, nwin_total, nwin_clip, N, Np, C,
                               num_heads, groups, stream);
      break;
    case 32:
      rc = launch_attn_bwd<32>(qkv, dctx, rb, mk, lb, mo, ctx, dqkv, prel,
                               pbias, stats, nwin_total, nwin_clip, N, Np, C,
                               num_heads, groups, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  rc = launch_sum_parts(prel, static_cast<float*>(drel), groups,
                        (long long)num_heads * N * N, stream);
  if (rc) return rc;
  rc = launch_sum_parts(pbias, static_cast<float*>(dqkv_b),
                        (int)bias_parts(Np, groups), 3LL * C, stream);
  if (rc) return rc;

  // weight gradients (split-K) and dy = dqkv . Wqkv back to spatial order
  float* split = static_cast<float*>(ws_split);
  rc = launch_gemm_tn(dqkv, y, static_cast<float*>(dqkv_w), T, 3 * C, C,
                      splits, split, stream);
  if (rc) return rc;
  rc = launch_gemm_tn(gw, ctx, static_cast<float*>(dproj_w), T, C, C, splits,
                      split, stream);
  if (rc) return rc;
  Epilogue ey = {};
  ey.mode = EPI_ATTN_OUT;  // bf16(acc), scattered to spatial order
  ey.dp_rows = 1;
  ey.scatter = 1;
  ey.g = geo;
  return launch_gemm(dqkv, static_cast<const bf16*>(qkv_w),
                     static_cast<bf16*>(dy), T, C, 3 * C, ey, stream, true);
}

}  // extern "C"
