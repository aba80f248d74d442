// Device pieces shared by the Swin kernels K1/K3 (swin_block.cu) and K2
// (window_attn.cu):
//   (a) LayerNorm with a window gather: row r of the output is window token
//       r, read from its spatial position, cyclic shift included;
//   (b) window attention, one CTA per (window, head);
//   (c) a bf16 tensor-core GEMM (WMMA, f32 accumulate) with epilogues:
//       +bias; +bias and exact-erf GELU; +bias, x dp, + residual, scattered
//       back to spatial order.
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

enum EpiMode { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_ATTN_OUT = 2, EPI_MLP_OUT = 3 };

// What the GEMM does with its f32 accumulator (see epilogue_store).
struct Epilogue {
  int mode;
  const float* bias;  // (N,) f32
  const float* dp;    // per-sample multiplier dp[row / dp_rows], or null
  long long dp_rows;
  const bf16* res;    // residual (row-major, ld N), or null
  int scatter;        // EPI_ATTN_OUT: rows are window order, write spatial
  WinGeom g;
};

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
// LN1 (window gather) -> qkv GEMM -> window attention; ctx (window order)
// is left in ws_tc. Shared by K1/K3 and K2.
int attention_front(const bf16* x, const WinGeom& g, int num_heads, float eps,
                    const float* ln_s, const float* ln_b, const bf16* qkv_w,
                    const float* qkv_b, const float* rel_bias,
                    const float* mask, bf16* ws_tc, bf16* ws_qkv,
                    cudaStream_t stream);

}  // namespace lrce
