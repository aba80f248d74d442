// Device pieces shared by the Swin kernels K1/K3 (swin_block.cu), K2/K6
// (window_attn.cu), K4 (attn_bwd.cu) and K5 (mlp_bwd.cu):
//   (a) LayerNorm with a window gather: row r of the output is window token
//       r, read from its spatial position, cyclic shift included; and the
//       same gather without the LayerNorm;
//   (b) window attention, one CTA per (window, head);
//   (c) a bf16 tensor-core GEMM (WMMA, f32 accumulate), out = A . Wt^T,
//       with epilogues: +bias; +bias and exact-erf GELU; +bias, x dp,
//       + residual, scattered back to spatial order; the GELU's f32
//       pre-activation kept beside its bf16 output; the GELU backward with
//       per-CTA column sums;
//   (d) the weight-gradient GEMM out = G^T . A (both row-major with the
//       long reduction axis first), split over the reduction into f32
//       partials that a second pass sums in a fixed order.
//
// Rounding points follow the JAX kernels (lrce_tpu/ops/pallas_swin_block.py
// _block_kernel, pallas_window_attn.py _attn_ctx / _hsplit_kernel): qkv+bias
// rounds to bf16, q is pre-scaled on the bf16 value, softmax runs in f32
// and its weights round to bf16 before P.V, ctx is bf16, proj+bias is f32
// then x dp1, rounds to bf16 and the residual is a bf16 add; fc1+bias+GELU
// run in f32 then round; fc2+bias is f32, x dp2, and the residual is added
// in f32 before the final rounding.
//
// Every kernel is launched on the caller's stream and allocates nothing;
// the kernels themselves are in swin_common.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lrce {

using bf16 = __nv_bfloat16;

// Geometry of a window-aligned (B, D, H, W, C) activation.
struct WinGeom {
  int B, D, H, W, C;
  int wd, wh, ww;  // window
  int sd, sh, sw;  // cyclic shift, 0 for unshifted blocks
  int nd, nh, nw;  // windows per axis
  int N;           // tokens per window
};

inline WinGeom make_geom(int B, int D, int H, int W, int C, int wd, int wh,
                         int ww, int sd, int sh, int sw) {
  WinGeom g;
  g.B = B; g.D = D; g.H = H; g.W = W; g.C = C;
  g.wd = wd; g.wh = wh; g.ww = ww;
  g.sd = sd; g.sh = sh; g.sw = sw;
  g.nd = D / wd; g.nh = H / wh; g.nw = W / ww;
  g.N = wd * wh * ww;
  return g;
}

enum EpiMode {
  EPI_BIAS = 0,       // bf16(acc + bias)
  EPI_BIAS_GELU = 1,  // bf16(gelu(acc + bias))
  EPI_ATTN_OUT = 2,   // bf16(x res + bf16((acc + bias) x dp)), scatter
  EPI_MLP_OUT = 3,    // bf16(res + (acc + bias) x dp)
  EPI_PRE_GELU = 4,   // aux = acc + bias (f32); out = bf16(gelu(aux))
  EPI_GELU_BWD = 5    // out = bf16(acc x gelu'(aux)), column sums of the f32
};

// What the GEMM does with its f32 accumulator (see epilogue_store).
struct Epilogue {
  int mode;
  const float* bias;  // (N,) f32, or null
  const float* dp;    // per-sample multiplier dp[row / dp_rows], or null
  long long dp_rows;
  const bf16* res;    // residual (row-major, ld N), or null
  int scatter;        // EPI_ATTN_OUT: rows are window order, write spatial
  WinGeom g;
  float* aux;         // EPI_PRE_GELU: (M, N) f32 out; EPI_GELU_BWD: (M, N) in
  float* colsum;      // EPI_GELU_BWD: (gridDim.x * 4, N) f32 column sums,
                      // one row per (CTA, warp row), every row written
};

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static __device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory per CTA

// Each returns 0 or a cudaError_t code.
// (a) LayerNorm of `rows` rows of C; gather != 0 reads row r at its window
//     token's spatial position.
int launch_ln(const bf16* x, bf16* out, const float* gamma, const float* beta,
              long long rows, float eps, const WinGeom& g, int gather,
              cudaStream_t stream);
// (b) window attention over packed (nwin_total * N, 3C) qkv -> ctx (., C).
int launch_attn(const bf16* qkv, bf16* ctx, const float* rel_bias,
                const float* mask, long long nwin_total, int nwin_clip, int N,
                int C, int num_heads, cudaStream_t stream);
// (c) out = epilogue(A (M x K) . Wt^T), Wt (N x K).
int launch_gemm(const bf16* A, const bf16* Wt, bf16* out, long long M, int N,
                int K, const Epilogue& ep, cudaStream_t stream);
// Rows in window order: dst row r = src row at window token r's spatial
// position (shift included), C wide.
int launch_gather(const bf16* src, bf16* dst, long long rows,
                  const WinGeom& g, cudaStream_t stream);
// out[r, :] = bf16(in[r, :] x dp[r / dp_rows]), rows of C.
int launch_scale_rows(const bf16* in, bf16* out, const float* dp,
                      long long rows, int C, long long dp_rows,
                      cudaStream_t stream);
// (d) out (N x K, f32) = G^T . A with G (M x N) and A (M x K) row-major;
//     M split into `splits` chunks whose f32 partials (splits x N x K, in
//     ws) are summed in order. N % 8 == 0, K % 8 == 0.
int launch_gemm_tn(const bf16* G, const bf16* A, float* out, long long M,
                   int N, int K, int splits, float* ws, cudaStream_t stream);
// out[i] = sum over s = 0 .. parts-1, in order, of part[s * n + i].
int launch_sum_parts(const float* part, float* out, int parts, long long n,
                     cudaStream_t stream);
// LN1 (window gather) -> qkv GEMM -> window attention; ctx (window order)
// is left in ws_tc. Shared by K1/K3, K2 and K6.
int attention_front(const bf16* x, const WinGeom& g, int num_heads, float eps,
                    const float* ln_s, const float* ln_b, const bf16* qkv_w,
                    const float* qkv_b, const float* rel_bias,
                    const float* mask, bf16* ws_tc, bf16* ws_qkv,
                    cudaStream_t stream);

}  // namespace lrce
