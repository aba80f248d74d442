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
// g . Wproj^T rounds to bf16; q is pre-scaled on its bf16 value; P is an
// exact f32 softmax (the TPU's bf16 lane-sum does not port) and pb = bf16(P);
// dv = pb^T . dctx; dS = P (dP - rowsum(dP P)); dq = bf16(dS) . k . scale;
// dk = bf16(dS)^T . q_scaled. The TPU splits heads into chunks and W into
// groups only to fit VMEM; none of that comes across.
//
// What bounds it on the H100, and what the design does:
//   - the weight-gradient GEMMs reduce over every token (451,584 at stage 0
//     with 48 clips) into a small output (384 x 128 for dWqkv): a split-K
//     GEMM spreads the reduction over about two CTAs per SM into f32
//     partials that a second pass sums in a fixed order (deterministic);
//   - drel is (nH, 147, 147) f32 summed over every window (3,072 per head
//     at stage 0): a per-window partial buffer would be ~1 GB, and atomics
//     would make the sum's order vary from run to run. Each CTA
//     (window group, head) instead walks its windows and adds into its own
//     f32 partial (groups x nH x N x N, ~23 MB at stage 0, read-modify-write
//     from L2), summed afterwards in a fixed order. The qkv-bias sums use
//     the same scheme;
//   - one (window, head) needs P and dS for 160 x 160 padded tokens: bf16
//     copies of both (100 KB), q, k, v, dctx (40 KB) and per warp an f32
//     row slab of S and dP (4 warps, 80 KB): 220 KB of the 227 KB a CTA
//     may hold, one CTA per SM. Padded keys are -inf before the softmax, so
//     P and dS are zero there; padded query rows of P and dS are stored as
//     zeros, so they add nothing to dv, dk, drel or the bias sums.
// This first version keeps the pieces as separate launches (LN + gather,
// qkv GEMM, dctx GEMM, the attention CTA, split-K GEMMs, dy GEMM) and
// stores the recomputed qkv and ctx; the flash-style form that keeps them
// on chip is later work.
#include "swin_common.cuh"

#include <math.h>
#include <mma.h>

using namespace lrce;

namespace {

namespace wmma = nvcuda::wmma;

constexpr int BW_WARPS = 4;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc += A (16 x 16*ksteps) . B (16*ksteps x 16), B row-major; Lay is A's
// layout, a_step the pointer step of A per 16 of the reduction.
template <typename Lay>
__device__ __forceinline__ void mma_steps(Acc& acc, const bf16* A, int lda,
                                          int a_step, const bf16* B, int ldb,
                                          int ksteps) {
  for (int s = 0; s < ksteps; ++s) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, Lay> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    wmma::load_matrix_sync(a, A + s * a_step, lda);
    wmma::load_matrix_sync(b, B + (long long)s * 16 * ldb, ldb);
    wmma::mma_sync(acc, a, b, acc);
  }
}

size_t bwd_smem_bytes(int Np, int hd) {
  return (size_t)4 * Np * hd * sizeof(bf16) +
         (size_t)2 * Np * Np * sizeof(bf16) +
         (size_t)BW_WARPS * 2 * 16 * Np * sizeof(float);
}

// One CTA per (window group, head); it walks windows grp, grp + groups, ...
// qkv: (T, 3C) window order, [q | k | v] with head h at columns h*hd;
// dctx: (T, C) window order. Writes ctx (T, C) and dqkv (T, 3C), bf16, and
// adds into its partials prel[grp][h] (N x N) and pb[grp] (3C).
__global__ void __launch_bounds__(BW_WARPS * 32)
attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                const float* __restrict__ rel_bias,
                const float* __restrict__ mask, bf16* __restrict__ ctx,
                bf16* __restrict__ dqkv, float* __restrict__ prel,
                float* __restrict__ pb, long long nwin_total, int nwin_clip,
                int N, int Np, int C, int hd, int groups, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.x, h = blockIdx.y;
  const int nH = gridDim.y;

  bf16* Qs = reinterpret_cast<bf16*>(smem);   // q pre-scaled
  bf16* Ks = Qs + Np * hd;
  bf16* Vs = Ks + Np * hd;
  bf16* Gs = Vs + Np * hd;                    // dctx of this head
  bf16* Pb = Gs + Np * hd;                    // bf16(P), Np x Np
  bf16* Sb = Pb + Np * Np;                    // bf16(dS), Np x Np
  float* S = reinterpret_cast<float*>(Sb + Np * Np) + warp * 2 * 16 * Np;
  float* dP = S + 16 * Np;

  float* relp = prel + ((long long)grp * nH + h) * N * N;
  float* bp = pb + (long long)grp * 3 * C;
  const float* bias_h = rel_bias + (long long)h * N * N;
  const int vecs = hd >> 3;
  const int nrb = Np >> 4;
  const int ncb = hd >> 4;

  for (long long win = grp; win < nwin_total; win += groups) {
    const bf16* base = qkv + win * N * (3LL * C);
    const bf16* gbase = dctx + win * N * (long long)C;
    for (int idx = threadIdx.x; idx < Np * vecs; idx += blockDim.x) {
      const int t = idx / vecs;
      const int d0 = (idx % vecs) * 8;
      uint4 qv = make_uint4(0, 0, 0, 0), kv = qv, vv = qv, gv = qv;
      if (t < N) {
        const bf16* row = base + (long long)t * 3 * C + h * hd + d0;
        qv = *reinterpret_cast<const uint4*>(row);
        kv = *reinterpret_cast<const uint4*>(row + C);
        vv = *reinterpret_cast<const uint4*>(row + 2 * C);
        gv = *reinterpret_cast<const uint4*>(gbase + (long long)t * C +
                                             h * hd + d0);
        bf16* qe = reinterpret_cast<bf16*>(&qv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          qe[e] = __float2bfloat16(__bfloat162float(qe[e]) * scale);
      }
      *reinterpret_cast<uint4*>(Qs + t * hd + d0) = qv;
      *reinterpret_cast<uint4*>(Ks + t * hd + d0) = kv;
      *reinterpret_cast<uint4*>(Vs + t * hd + d0) = vv;
      *reinterpret_cast<uint4*>(Gs + t * hd + d0) = gv;
    }
    __syncthreads();

    // ---- phase 1, per warp and 16 query rows: P, dS, drel ----
    const float* mask_w =
        mask ? mask + (long long)(win % nwin_clip) * N * N : nullptr;
    for (int rb = warp; rb < nrb; rb += BW_WARPS) {
      for (int cb = 0; cb < nrb; ++cb) {
        Acc acc_s, acc_p;
        wmma::fill_fragment(acc_s, 0.f);
        wmma::fill_fragment(acc_p, 0.f);
        for (int kk = 0; kk < hd; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, Qs + rb * 16 * hd + kk, hd);
          wmma::load_matrix_sync(b, Ks + cb * 16 * hd + kk, hd);
          wmma::mma_sync(acc_s, a, b, acc_s);
          wmma::load_matrix_sync(a, Gs + rb * 16 * hd + kk, hd);
          wmma::load_matrix_sync(b, Vs + cb * 16 * hd + kk, hd);
          wmma::mma_sync(acc_p, a, b, acc_p);
        }
        wmma::store_matrix_sync(S + cb * 16, acc_s, Np, wmma::mem_row_major);
        wmma::store_matrix_sync(dP + cb * 16, acc_p, Np, wmma::mem_row_major);
      }
      __syncwarp();
      for (int i = 0; i < 16; ++i) {
        const int qi = rb * 16 + i;
        float* srow = S + i * Np;
        const float* prow = dP + i * Np;
        bf16* pbrow = Pb + qi * Np;
        bf16* sbrow = Sb + qi * Np;
        if (qi >= N) {
          for (int j = lane; j < Np; j += 32) {
            pbrow[j] = __float2bfloat16(0.f);
            sbrow[j] = __float2bfloat16(0.f);
          }
          continue;
        }
        const float* brow = bias_h + (long long)qi * N;
        const float* mrow = mask_w ? mask_w + (long long)qi * N : nullptr;
        float mx = -INFINITY;
        for (int j = lane; j < Np; j += 32) {
          float l = -INFINITY;
          if (j < N) l = srow[j] + (mrow ? brow[j] + mrow[j] : brow[j]);
          srow[j] = l;
          mx = fmaxf(mx, l);
        }
        mx = warp_max(mx);
        float sum = 0.f;
        for (int j = lane; j < Np; j += 32) {
          const float e = j < N ? expf(srow[j] - mx) : 0.f;
          srow[j] = e;
          sum += e;
        }
        const float r = 1.f / warp_sum(sum);
        float rs = 0.f;
        for (int j = lane; j < Np; j += 32) {
          const float p = srow[j] * r;
          srow[j] = p;
          pbrow[j] = __float2bfloat16(p);
          rs += prow[j] * p;
        }
        rs = warp_sum(rs);
        float* rrow = relp + (long long)qi * N;
        for (int j = lane; j < Np; j += 32) {
          const float ds = srow[j] * (prow[j] - rs);
          sbrow[j] = __float2bfloat16(ds);
          if (j < N) rrow[j] += ds;
        }
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- phase 2: ctx = pb v; dv = pb^T dctx; dq = bf16(dS) k scale;
    //      dk = bf16(dS)^T q. One unit = (product, 16 output columns). ----
    float* stage = S;  // this warp's 16 x 16 f32 staging
    for (int u = warp; u < 4 * ncb; u += BW_WARPS) {
      const int mat = u / ncb;
      const int db = (u % ncb) * 16;
      float colacc = 0.f;
      for (int ob = 0; ob < nrb; ++ob) {
        Acc acc;
        wmma::fill_fragment(acc, 0.f);
        switch (mat) {
          case 0:
            mma_steps<wmma::row_major>(acc, Pb + ob * 16 * Np, Np, 16,
                                       Vs + db, hd, nrb);
            break;
          case 1:
            mma_steps<wmma::col_major>(acc, Pb + ob * 16, Np, 16 * Np,
                                       Gs + db, hd, nrb);
            break;
          case 2:
            mma_steps<wmma::row_major>(acc, Sb + ob * 16 * Np, Np, 16,
                                       Ks + db, hd, nrb);
            break;
          default:
            mma_steps<wmma::col_major>(acc, Sb + ob * 16, Np, 16 * Np,
                                       Qs + db, hd, nrb);
            break;
        }
        wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
        __syncwarp();
        const float k = mat == 2 ? scale : 1.f;
        for (int e = lane; e < 256; e += 32) {
          const int t = ob * 16 + (e >> 4);
          if (t >= N) continue;
          const long long row = win * N + t;
          const int col = h * hd + db + (e & 15);
          const bf16 v = __float2bfloat16(stage[e] * k);
          if (mat == 0)
            ctx[row * C + col] = v;
          else  // dq at 0, dk at C, dv at 2C
            dqkv[row * 3 * C + (mat == 2 ? 0 : mat == 3 ? C : 2 * C) + col] = v;
        }
        if (lane < 16) {
          for (int r = 0; r < 16 && ob * 16 + r < N; ++r)
            colacc += stage[r * 16 + lane] * k;
        }
        __syncwarp();
      }
      if (mat > 0 && lane < 16)
        bp[(mat == 2 ? 0 : mat == 3 ? C : 2 * C) + h * hd + db + lane] +=
            colacc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// K4. Spatial inputs x, g (B, D, H, W, C) bf16; qkv_w (3C, C) and its
// transpose qkv_wt (C, 3C), proj_wt = proj_w^T (C, C), bf16; ln_s, ln_b,
// qkv_b, rel_bias (nH, N, N), mask (nd, nh, nw, N, N) or null, f32.
// Outputs: dy (B, D, H, W, C) bf16; dqkv_w (3C, C), dqkv_b (3C),
// dproj_w (C, C), drel (nH, N, N) f32. Workspaces (T = B D H W tokens):
// ws_y, ws_g, ws_dctx, ws_ctx (T, C) bf16; ws_qkv, ws_dqkv (T, 3C) bf16;
// ws_prel (groups, nH, N, N) f32; ws_pb (groups, 3C) f32;
// ws_split (splits, 3C, C) f32.
int lrce_attn_bwd(const void* x, const void* g, int B, int D, int H, int W,
                  int C, int wd, int wh, int ww, int sd, int sh, int sw,
                  int num_heads, float eps, const void* ln_s,
                  const void* ln_b, const void* qkv_w, const void* qkv_b,
                  const void* qkv_wt, const void* proj_wt,
                  const void* rel_bias, const void* mask, void* dy,
                  void* dqkv_w, void* dqkv_b, void* dproj_w, void* drel,
                  void* ws_y, void* ws_qkv, void* ws_g, void* ws_dctx,
                  void* ws_ctx, void* ws_dqkv, void* ws_prel, void* ws_pb,
                  void* ws_split, int groups, int splits, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const WinGeom geo = make_geom(B, D, H, W, C, wd, wh, ww, sd, sh, sw);
  const long long T = (long long)B * D * H * W;
  const int N = geo.N;
  const int Np = (N + 15) / 16 * 16;
  const int hd = C / num_heads;
  if (hd % 16 != 0 || groups < 1) return (int)cudaErrorInvalidValue;
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
  // g into window order; dctx = g . Wproj^T, rounded to bf16
  rc = launch_gather(static_cast<const bf16*>(g), gw, T, geo, stream);
  if (rc) return rc;
  Epilogue er = {};
  er.mode = EPI_ATTN_OUT;  // bias null, no dp / residual / scatter: bf16(acc)
  er.dp_rows = 1;
  rc = launch_gemm(gw, static_cast<const bf16*>(proj_wt), dctx, T, C, C, er,
                   stream);
  if (rc) return rc;

  // the attention backward proper
  cudaError_t e = cudaMemsetAsync(
      prel, 0, sizeof(float) * (size_t)groups * num_heads * N * N, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(pbias, 0, sizeof(float) * (size_t)groups * 3 * C,
                      stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attn_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nwin_total = T / N;
  const int nwin_clip = geo.nd * geo.nh * geo.nw;
  attn_bwd_kernel<<<dim3(groups, num_heads), BW_WARPS * 32, smem, stream>>>(
      qkv, dctx, static_cast<const float*>(rel_bias),
      static_cast<const float*>(mask), ctx, dqkv, prel, pbias, nwin_total,
      nwin_clip, N, Np, C, hd, groups, 1.f / sqrtf((float)hd));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
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
  return launch_gemm(dqkv, static_cast<const bf16*>(qkv_wt),
                     static_cast<bf16*>(dy), T, C, 3 * C, ey, stream);
}

}  // extern "C"
