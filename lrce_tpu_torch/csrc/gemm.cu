// Entry points of the two shared GEMMs and of the LayerNorm (+ window
// gather) on their own, so that each can be held against its plain version
// and timed at the shapes K1-K8 give it (see swin_common.cuh (a), (c), (d)).
#include "swin_common.cuh"

using namespace lrce;

extern "C" {

// out (M x N, bf16) = epilogue(a (M x K) . b^T) with b (N x K), or with
// b_kn != 0 (mode EPI_ATTN_OUT only) epilogue(a . b) with b (K x N). bias
// (N) f32 or null; dp f32 per-sample multipliers dp[row / dp_rows] or null;
// res (M x N) bf16 or null (required by EPI_MLP_OUT). No scatter.
int lrce_gemm(const void* a, const void* b, void* out, int M, int N, int K,
              int mode, int b_kn, const void* bias, const void* dp,
              int dp_rows, const void* res, void* stream_ptr) {
  Epilogue ep = {};
  ep.mode = mode;
  ep.bias = static_cast<const float*>(bias);
  ep.dp = static_cast<const float*>(dp);
  ep.dp_rows = dp_rows > 0 ? dp_rows : 1;
  ep.res = static_cast<const bf16*>(res);
  if (mode == EPI_MLP_OUT && !res) return (int)cudaErrorInvalidValue;
  return launch_gemm(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                     static_cast<bf16*>(out), M, N, K, ep,
                     reinterpret_cast<cudaStream_t>(stream_ptr), b_kn != 0);
}

// *out (a double) = host nanoseconds of one TMA tensor-map encode, over n
// encodes that miss the cache (the host cost of a GEMM call's two maps).
int lrce_tmap_encode_ns(int n, void* out) {
  const double ns = tmap_encode_ns(n > 0 ? n : 1);
  *static_cast<double*>(out) = ns;
  return ns < 0 ? (int)cudaErrorNotSupported : 0;
}

// out (N x K, f32) = g^T . a with g (M x N), a (M x K) bf16; ws (splits,
// N K) f32 when splits > 1.
int lrce_gemm_tn(const void* g, const void* a, void* out, int M, int N, int K,
                 int splits, void* ws, void* stream_ptr) {
  return launch_gemm_tn(static_cast<const bf16*>(g),
                        static_cast<const bf16*>(a), static_cast<float*>(out),
                        M, N, K, splits, static_cast<float*>(ws),
                        reinterpret_cast<cudaStream_t>(stream_ptr));
}

// out (T, C) bf16 = LayerNorm over C of the rows of x (B, D, H, W, C) bf16,
// gamma and beta f32. gather != 0: row r of out is window token r of the
// window (wd, wh, ww), read at its position under the cyclic shift (sd, sh,
// sw): the LN1 of a block. gather == 0: token order, the LN2 of a block.
int lrce_ln_rows(const void* x, void* out, int B, int D, int H, int W, int C,
                 int wd, int wh, int ww, int sd, int sh, int sw, float eps,
                 const void* gamma, const void* beta, int gather,
                 void* stream_ptr) {
  const WinGeom g = make_geom(B, D, H, W, C, wd, wh, ww, sd, sh, sw);
  return launch_ln(static_cast<const bf16*>(x), static_cast<bf16*>(out),
                   static_cast<const float*>(gamma),
                   static_cast<const float*>(beta),
                   (long long)B * D * H * W, eps, g, gather,
                   reinterpret_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
