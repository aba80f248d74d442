// K2 and K6: LN1 + window partition + qkv + window attention with rel_bias
// [+ mask] + proj + window reverse on a window-aligned (B, D, H, W, C) bf16
// activation. No residual, no MLP.
//
// K2 replaces the TPU kernel fused_window_attention_hsplit /
// _hsplit_kernel (lrce_tpu/ops/pallas_window_attn.py): on the model's path
// it runs both stage-3 blocks (C = 1024, 32 heads, one 3x7x7 window per
// clip, no shift, no mask) on a pre-rolled input. The TPU version splits
// the heads into groups only to fit VMEM and accumulates the proj over
// groups; here the whole of C stays in one pass: the attention CTA holds
// one head's q, k, v (30 KB) and the proj is one GEMM over all heads.
//
// K6 replaces fused_window_attention / _kernel (same file), the forward
// that the block backward recomputes (pallas_swin_block.py _block_bwd). It
// takes the block's cyclic shift as index arithmetic: the LN1 gather reads
// window token (w, t) at its shifted position and the proj epilogue writes
// it back there, so an unrolled x needs no roll passes.
//
// What bounds it on the H100: at stage 3 the qkv and proj GEMMs read
// 8 MB of bf16 weights for 147 tokens per clip, so at small batch the
// weight reads, not the operations, bound it; the attention grid has one
// CTA per (clip, head), 32 per clip, too few to fill 132 SMs below about
// 8 clips. At stages 0-2 (K6) the (T, 3C) qkv round trip through device
// memory is the larger cost. This first version keeps LN, qkv, attention
// and proj as separate launches.
#include "swin_common.cuh"

using namespace lrce;

namespace {

// ws_tc: (T, C) bf16 scratch; ws_qkv: (T, 3C) bf16 scratch.
int window_attn(const WinGeom& g, const void* x, void* out, int num_heads,
                float eps, const void* ln_s, const void* ln_b,
                const void* qkv_w, const void* qkv_b, const void* proj_w,
                const void* proj_b, const void* rel_bias, const void* mask,
                void* ws_tc, void* ws_qkv, cudaStream_t stream) {
  const long long T = (long long)g.B * g.D * g.H * g.W;
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
  // proj + bias -> bf16, window reverse (and the shift back)
  Epilogue ep = {};
  ep.mode = EPI_ATTN_OUT;
  ep.bias = static_cast<const float*>(proj_b);
  ep.dp_rows = 1;
  ep.scatter = 1;
  ep.g = g;
  return launch_gemm(tc, static_cast<const bf16*>(proj_w),
                     static_cast<bf16*>(out), T, g.C, g.C, ep, stream);
}

}  // namespace

extern "C" {

// K6: an unrolled x and the block's shift (sd, sh, sw); K2 is the same
// call on a pre-rolled x with shift (0, 0, 0).
int lrce_window_attn_fwd(const void* x, void* out, int B, int D, int H, int W,
                         int C, int wd, int wh, int ww, int sd, int sh, int sw,
                         int num_heads, float eps, const void* ln_s,
                         const void* ln_b, const void* qkv_w,
                         const void* qkv_b, const void* proj_w,
                         const void* proj_b, const void* rel_bias,
                         const void* mask, void* ws_tc, void* ws_qkv,
                         void* stream_ptr) {
  return window_attn(make_geom(B, D, H, W, C, wd, wh, ww, sd, sh, sw), x, out,
                     num_heads, eps, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b,
                     rel_bias, mask, ws_tc, ws_qkv,
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
