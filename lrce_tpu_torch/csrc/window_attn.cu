// K2: LN1 + window partition + qkv + window attention with rel_bias
// [+ mask] + proj + window reverse on a pre-rolled, window-aligned
// (B, D, H, W, C) bf16 activation. No residual, no MLP. On the model's path
// it runs both stage-3 blocks (C = 1024, 32 heads, one 3x7x7 window per
// clip, no shift, no mask).
//
// Replaces the TPU kernel fused_window_attention_hsplit / _hsplit_kernel
// (lrce_tpu/ops/pallas_window_attn.py). The TPU version splits the heads
// into groups only to fit VMEM and accumulates the proj over groups; here
// the whole of C stays in one pass: the attention CTA holds one head's
// q, k, v (30 KB) and the proj is one GEMM over all heads.
//
// What bounds it on the H100: at stage 3 the qkv and proj GEMMs read
// 8 MB of bf16 weights for 147 tokens per clip, so at small batch the
// weight reads, not the operations, bound it; the attention grid has one
// CTA per (clip, head), 32 per clip, too few to fill 132 SMs below about
// 8 clips. This first version keeps LN, qkv, attention and proj as
// separate launches.
#include "swin_common.cuh"

using namespace lrce;

extern "C" {

// ws_tc: (T, C) bf16 scratch; ws_qkv: (T, 3C) bf16 scratch.
int lrce_window_attn_fwd(const void* x, void* out, int B, int D, int H, int W,
                         int C, int wd, int wh, int ww, int num_heads,
                         float eps, const void* ln_s, const void* ln_b,
                         const void* qkv_w, const void* qkv_b,
                         const void* proj_w, const void* proj_b,
                         const void* rel_bias, const void* mask, void* ws_tc,
                         void* ws_qkv, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const WinGeom g = make_geom(B, D, H, W, C, wd, wh, ww, 0, 0, 0);
  const long long T = (long long)B * D * H * W;
  bf16* tc = static_cast<bf16*>(ws_tc);
  int rc = attention_front(static_cast<const bf16*>(x), g, num_heads, eps,
                           static_cast<const float*>(ln_s),
                           static_cast<const float*>(ln_b),
                           static_cast<const bf16*>(qkv_w),
                           static_cast<const float*>(qkv_b),
                           static_cast<const float*>(rel_bias),
                           static_cast<const float*>(mask), tc,
                           static_cast<bf16*>(ws_qkv), stream);
  if (rc) return rc;
  // proj + bias -> bf16, window reverse
  Epilogue ep = {};
  ep.mode = EPI_ATTN_OUT;
  ep.bias = static_cast<const float*>(proj_b);
  ep.dp_rows = 1;
  ep.scatter = 1;
  ep.g = g;
  return launch_gemm(tc, static_cast<const bf16*>(proj_w),
                     static_cast<bf16*>(out), T, C, C, ep, stream);
}

}  // extern "C"
