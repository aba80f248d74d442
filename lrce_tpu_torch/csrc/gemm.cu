// Entry points of the two shared GEMMs on their own, so that each can be
// held against an f32 product of the same bf16 operands and timed at the
// shapes K1-K8 give it (see swin_common.cuh (c) and (d)).
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

// 1 where lrce_gemm takes its 128 x 256 tile on a card of `sms` SMs, else 0.
int lrce_gemm_wide_tile(int M, int N, int K, int sms) {
  return gemm_wide_tile(M, N, K, sms) ? 1 : 0;
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

}  // extern "C"
