// K5: the MLP backward of a Swin block, out = h1 + dp2 * fc2(gelu(fc1(
// LN2 h1))), up to the LN2 output. For h1 and the output cotangent g it
// recomputes z = LN2(h1) (bf16) and the f32 pre-activation, and returns
//   dz  = bf16(dpre) . W1, the cotangent of the LN2 output, bf16 (rounded
//         once);
//   dW1 = bf16(dpre)^T . z, dW2 = g2^T . bf16(gelu(pre)), f32 (nn.Linear
//         layouts), db1 = sum of the f32 dpre;
// with g2 = bf16(g * dp2) and dpre = (g2 . W2) * (cdf(pre) + pre pdf(pre)),
// exact erf. The LN2 input backward and db2 = sum g2 stay outside, as in
// JAX.
//
// Replaces the TPU kernel _mlp_bwd_kernel / _mlp_bwd_impl
// (lrce_tpu/ops/pallas_swin_block.py) with its rounding points. The TPU
// splits FF into chunks only to fit VMEM; here every GEMM spans all of FF.
//
// What bounds it on the H100: four GEMMs of 2 T C FF operations each
// (fc1 recompute, dhid, dW1, dW2, plus dz), on the tensor cores through
// WMMA. dW1 and dW2 reduce over every token into a (FF, C) output, so they
// run as split-K GEMMs with f32 partials summed in a fixed order. db1 is
// summed in the dhid GEMM's epilogue, one f32 row per (CTA, warp row),
// then in a fixed order: no atomics, the result does not vary from run to
// run. This first version stores the (T, FF) f32 pre-activation, the bf16
// hidden and the bf16 dpre in workspaces (925 MB of f32 at stage 0 with 48
// clips); the flash-style form that never stores the hidden is later work.
#include "swin_common.cuh"

using namespace lrce;

extern "C" {

// h1, g: (B, D, H, W, C) bf16; w1 (FF, C), w1t = w1^T (C, FF), w2t = w2^T
// (FF, C) bf16; ln2s, ln2b (C), b1 (FF), dp2 (B) or null, f32. Outputs: dz
// (B, D, H, W, C) bf16; dw1 (FF, C), db1 (FF), dw2 (C, FF) f32; g2 (T, C)
// bf16. Workspaces: ws_z (T, C) bf16; ws_pre (T, FF) f32; ws_hid, ws_dpre
// (T, FF) bf16; ws_col (col_rows, FF) f32 with col_rows = 4 ceil(T / 128);
// ws_split (splits, FF C) f32.
int lrce_mlp_bwd(const void* h1, const void* g, int B, int D, int H, int W,
                 int C, int ff, float eps, const void* ln2s,
                 const void* ln2b, const void* w1, const void* b1,
                 const void* w1t, const void* w2t, const void* dp2, void* dz,
                 void* dw1, void* db1, void* dw2, void* g2, void* ws_z,
                 void* ws_pre, void* ws_hid, void* ws_dpre, void* ws_col,
                 void* ws_split, int col_rows, int splits,
                 void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const WinGeom geo = make_geom(B, D, H, W, C, 1, 1, 1, 0, 0, 0);
  const long long T = (long long)B * D * H * W;
  if (col_rows != (int)((T + 127) / 128 * 4)) return (int)cudaErrorInvalidValue;
  bf16* z = static_cast<bf16*>(ws_z);
  bf16* gs = static_cast<bf16*>(g2);
  float* pre = static_cast<float*>(ws_pre);
  bf16* hid = static_cast<bf16*>(ws_hid);
  bf16* dpre = static_cast<bf16*>(ws_dpre);
  float* split = static_cast<float*>(ws_split);

  int rc = launch_ln(static_cast<const bf16*>(h1), z,
                     static_cast<const float*>(ln2s),
                     static_cast<const float*>(ln2b), T, eps, geo, 0, stream);
  if (rc) return rc;
  if (dp2) {
    rc = launch_scale_rows(static_cast<const bf16*>(g), gs,
                           static_cast<const float*>(dp2), T, C,
                           (long long)D * H * W, stream);
  } else {
    cudaError_t e = cudaMemcpyAsync(gs, g, sizeof(bf16) * (size_t)T * C,
                                    cudaMemcpyDeviceToDevice, stream);
    rc = e == cudaSuccess ? 0 : (int)e;
  }
  if (rc) return rc;

  // pre = z . W1^T + b1 (f32, kept); hid = bf16(gelu(pre))
  Epilogue e1 = {};
  e1.mode = EPI_PRE_GELU;
  e1.bias = static_cast<const float*>(b1);
  e1.aux = pre;
  rc = launch_gemm(z, static_cast<const bf16*>(w1), hid, T, ff, C, e1, stream);
  if (rc) return rc;
  // dW2 = g2^T . hid
  rc = launch_gemm_tn(gs, hid, static_cast<float*>(dw2), T, C, ff, splits,
                      split, stream);
  if (rc) return rc;
  // dpre = (g2 . W2) * gelu'(pre), bf16, with its f32 column sums -> db1
  Epilogue e2 = {};
  e2.mode = EPI_GELU_BWD;
  e2.aux = pre;
  e2.colsum = static_cast<float*>(ws_col);
  rc = launch_gemm(gs, static_cast<const bf16*>(w2t), dpre, T, ff, C, e2,
                   stream);
  if (rc) return rc;
  rc = launch_sum_parts(static_cast<const float*>(ws_col),
                        static_cast<float*>(db1), col_rows, ff, stream);
  if (rc) return rc;
  // dW1 = dpre^T . z; dz = dpre . W1
  rc = launch_gemm_tn(dpre, z, static_cast<float*>(dw1), T, ff, C, splits,
                      split, stream);
  if (rc) return rc;
  Epilogue e3 = {};
  e3.mode = EPI_ATTN_OUT;  // bias null, no dp / residual / scatter: bf16(acc)
  e3.dp_rows = 1;
  return launch_gemm(dpre, static_cast<const bf16*>(w1t),
                     static_cast<bf16*>(dz), T, C, ff, e3, stream);
}

}  // extern "C"
