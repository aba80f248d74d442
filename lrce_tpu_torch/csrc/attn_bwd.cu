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
#include "swin_common.cuh"

#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

using namespace lrce;

namespace {

constexpr int BW_MAX_NB = 20;     // key blocks of 8: up to 160 padded tokens
constexpr int BW_MAX_WARPS = 10;  // one warp per 16 query rows

size_t bwd_smem_bytes(int Np, int hd) {
  return (size_t)8 * Np * hd * sizeof(bf16) +          // q k v dctx, twice
         (size_t)2 * Np * (Np + 8) * sizeof(bf16) +    // bf16 P and dS
         (size_t)(Np / 16) * 3 * hd * sizeof(float);   // bias sums per warp
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

template <int HD>
int launch_attn_bwd(const bf16* qkv, const bf16* dctx, const float* rel_bias,
                    const float* mask, bf16* ctx, bf16* dqkv, float* prel,
                    float* pb, long long nwin_total, int nwin_clip, int N,
                    int Np, int C, int num_heads, int groups, size_t smem,
                    cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_kernel<HD><<<dim3(groups, num_heads), Np * 2, smem, stream>>>(
      qkv, dctx, rel_bias, mask, ctx, dqkv, prel, pb, nwin_total, nwin_clip,
      N, Np, C, groups, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4. Spatial inputs x, g (B, D, H, W, C) bf16; qkv_w (3C, C), proj_w
// (C, C) bf16; ln_s, ln_b, qkv_b, rel_bias (nH, N, N), mask (nd, nh, nw, N,
// N) or null, f32. Outputs: dy (B, D, H, W, C) bf16; dqkv_w (3C, C), dqkv_b
// (3C), dproj_w (C, C), drel (nH, N, N) f32. Workspaces (T = B D H W
// tokens): ws_y, ws_g, ws_dctx, ws_ctx (T, C) bf16; ws_qkv, ws_dqkv (T, 3C)
// bf16; ws_prel (groups, nH, N, N) f32; ws_pb (groups, 3C) f32;
// ws_split (splits, 3C, C) f32. Takes head_dim 16 or 32 and windows of at
// most 160 tokens; 1 <= groups <= windows.
int lrce_attn_bwd(const void* x, const void* g, int B, int D, int H, int W,
                  int C, int wd, int wh, int ww, int sd, int sh, int sw,
                  int num_heads, float eps, const void* ln_s,
                  const void* ln_b, const void* qkv_w, const void* qkv_b,
                  const void* proj_w, const void* rel_bias, const void* mask,
                  void* dy, void* dqkv_w, void* dqkv_b, void* dproj_w,
                  void* drel, void* ws_y, void* ws_qkv, void* ws_g,
                  void* ws_dctx, void* ws_ctx, void* ws_dqkv, void* ws_prel,
                  void* ws_pb, void* ws_split, int groups, int splits,
                  void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const WinGeom geo = make_geom(B, D, H, W, C, wd, wh, ww, sd, sh, sw);
  const long long T = (long long)B * D * H * W;
  const int N = geo.N;
  const int Np = (N + 15) / 16 * 16;
  const int hd = C / num_heads;
  const long long nwin_total = T / N;
  if (Np > 8 * BW_MAX_NB || groups < 1 || groups > nwin_total)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(Np, hd);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  bf16* y = static_cast<bf16*>(ws_y);
  bf16* qkv = static_cast<bf16*>(ws_qkv);
  bf16* gw = static_cast<bf16*>(ws_g);
  bf16* dctx = static_cast<bf16*>(ws_dctx);
  bf16* ctx = static_cast<bf16*>(ws_ctx);
  bf16* dqkv = static_cast<bf16*>(ws_dqkv);
  float* prel = static_cast<float*>(ws_prel);
  float* pbias = static_cast<float*>(ws_pb);

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
  switch (hd) {
    case 16:
      rc = launch_attn_bwd<16>(qkv, dctx, rb, mk, ctx, dqkv, prel, pbias,
                               nwin_total, nwin_clip, N, Np, C, num_heads,
                               groups, smem, stream);
      break;
    case 32:
      rc = launch_attn_bwd<32>(qkv, dctx, rb, mk, ctx, dqkv, prel, pbias,
                               nwin_total, nwin_clip, N, Np, C, num_heads,
                               groups, smem, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  rc = launch_sum_parts(prel, static_cast<float*>(drel), groups,
                        (long long)num_heads * N * N, stream);
  if (rc) return rc;
  rc = launch_sum_parts(pbias, static_cast<float*>(dqkv_b), groups,
                        3LL * C, stream);
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
