// K1 and K3: one whole Swin block on a window-aligned (B, D, H, W, C) bf16
// activation, C <= 512 on the model's path:
//   h   = x + dp1 * proj(W-MSA(LN1 x) + rel_bias [+ mask])
//   out = h + dp2 * fc2(gelu(fc1(LN2 h)))
//
// Replaces the TPU kernels fused_swin_block / _block_kernel
// (lrce_tpu/ops/pallas_swin_block.py) and fused_swin_pair / _one_block
// (lrce_tpu/ops/pallas_swin_pair.py). The pair kernel's cyclic shift is
// index arithmetic here: the LN1 gather reads window token (w, t) at
// ((d_w + t_d + s_d) mod D, (h_w + t_h + s_h) mod H, (w_w + t_w + s_w) mod W)
// and the proj epilogue writes it back to the same place, so a shifted block
// needs no roll passes. With shift (0, 0, 0) it is K1 on a pre-rolled input.
//
// What bounds it on the H100: the four GEMMs (qkv, proj, fc1, fc2) are
// 72% (stage 0) to 91% (stage 2) of the block's operations and run on the
// tensor cores; the attention between qkv and proj is the CTA of
// attn_fwd.cu (mma.sync, S and P in registers, several windows per CTA,
// the head's bias resident in shared memory, the mask as labels), bound by
// its softmax arithmetic. The front half is three launches: LN1 + window
// gather, the qkv GEMM (the shared warp-specialised wgmma GEMM of
// swin_common.cu) and the attention CTA; ctx leaves it in window order.
// The back half at C <= 256 (stages 0 and 1) is one launch, back_half.cu:
// proj, the residual, LN2, fc1, GELU and fc2 with h1 and the (T, 4C) hidden
// kept on chip. At C = 512 (stage 2) the fc2 accumulator of a 64-row tile
// does not fit a thread's registers, and the back half is four launches on
// the shared GEMM (proj with the scatter, LN2, fc1 + GELU, fc2), with h1
// and the hidden through device memory.
#include "swin_common.cuh"

using namespace lrce;

extern "C" {

// One block. ws_tc: (T, C) bf16 scratch; ws_big: (T, 3C) bf16 scratch, or
// (T, max(3C, ff)) without back_half; ws_h1: (T, C) bf16 scratch, unused
// (may be null) with back_half. out must not alias x. mask_labels,
// mask_off: the mask as labels, or both null; groups: the attention CTA's
// window groups (launch_attn, swin_common.cuh). back_half != 0: the back
// half as one launch (back_half.cu; C = 128 or 256 and ff = 4 C only), else
// as four.
int lrce_swin_block_fwd(const void* x, void* out, int B, int D, int H, int W,
                        int C, int wd, int wh, int ww, int sd, int sh, int sw,
                        int num_heads, int ff, float eps, const void* ln1s,
                        const void* ln1b, const void* qkv_w,
                        const void* qkv_b, const void* proj_w,
                        const void* proj_b, const void* rel_bias,
                        const void* mask, const void* mask_labels,
                        const void* mask_off, const void* ln2s,
                        const void* ln2b,
                        const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* dp1, const void* dp2,
                        int groups, int back_half, void* ws_tc,
                        void* ws_big, void* ws_h1, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const WinGeom g = make_geom(B, D, H, W, C, wd, wh, ww, sd, sh, sw);
  const long long T = (long long)B * D * H * W;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* tc = static_cast<bf16*>(ws_tc);
  bf16* big = static_cast<bf16*>(ws_big);
  bf16* h1 = static_cast<bf16*>(ws_h1);

  int rc = attention_front(xb, g, num_heads, eps,
                           static_cast<const float*>(ln1s),
                           static_cast<const float*>(ln1b),
                           static_cast<const bf16*>(qkv_w),
                           static_cast<const float*>(qkv_b),
                           static_cast<const float*>(rel_bias),
                           static_cast<const float*>(mask),
                           static_cast<const int*>(mask_labels),
                           static_cast<const float*>(mask_off), groups, tc,
                           big, stream);
  if (rc) return rc;
  if (back_half) {
    if (!back_half_supported(C) || ff != 4 * C)
      return (int)cudaErrorInvalidValue;
    return launch_back_half(
        tc, xb, static_cast<bf16*>(out), g, eps,
        static_cast<const bf16*>(proj_w), static_cast<const float*>(proj_b),
        static_cast<const float*>(ln2s), static_cast<const float*>(ln2b),
        static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2),
        static_cast<const float*>(dp1), static_cast<const float*>(dp2),
        stream);
  }

  // proj + bias, x dp1, bf16, + x (bf16), back to spatial order -> h1
  Epilogue ep = {};
  ep.mode = EPI_ATTN_OUT;
  ep.bias = static_cast<const float*>(proj_b);
  ep.dp = static_cast<const float*>(dp1);
  ep.dp_rows = (long long)g.nd * g.nh * g.nw * g.N;
  ep.res = xb;
  ep.scatter = 1;
  ep.g = g;
  rc = launch_gemm(tc, static_cast<const bf16*>(proj_w), h1, T, C, C, ep,
                   stream);
  if (rc) return rc;

  // LN2 (token order) -> fc1 + bias + GELU -> fc2 + bias, x dp2, + h1 (f32)
  rc = launch_ln(h1, tc, static_cast<const float*>(ln2s),
                 static_cast<const float*>(ln2b), T, eps, g, 0, stream);
  if (rc) return rc;
  Epilogue e1 = {};
  e1.mode = EPI_BIAS_GELU;
  e1.bias = static_cast<const float*>(b1);
  rc = launch_gemm(tc, static_cast<const bf16*>(w1), big, T, ff, C, e1,
                   stream);
  if (rc) return rc;
  Epilogue e2 = {};
  e2.mode = EPI_MLP_OUT;
  e2.bias = static_cast<const float*>(b2);
  e2.dp = static_cast<const float*>(dp2);
  e2.dp_rows = (long long)D * H * W;
  e2.res = h1;
  return launch_gemm(big, static_cast<const bf16*>(w2),
                     static_cast<bf16*>(out), T, C, ff, e2, stream);
}

const char* lrce_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
