// K7 and K8: the LayerNorm + MLP + residual half of a transformer block on
// (T, C) bf16 rows,
//   out = x + dp * fc2(gelu(fc1(LN(x)))),
// as one call. K7 (fused_ln_mlp) is the call at any C <= 1024 with a
// per-sample multiplier dp (or none): the stage-3 route of the Swin tower,
// C = 1024, FF = 4096. K8 (fused_mlp) is the call without dp at C <= 128.
//
// Replaces the TPU kernels _ln_mlp_kernel / _ln_mlp_fwd_impl
// (lrce_tpu/ops/pallas_swin_block.py) and _kernel / _fwd_impl
// (lrce_tpu/ops/pallas_mlp.py), with their rounding points: LN in f32,
// rounded to bf16; fc1 accumulated in f32, + b1 in f32, exact-erf GELU in
// f32, the hidden rounded to bf16; fc2 accumulated in f32 over all of FF,
// + b2, x the row's dp, + x in f32, rounded once. The TPU kernel's sample
// blocks, its FF chunks with an f32 accumulator carried across grid steps
// and its VMEM budget do not come across: blocks of a CUDA grid run in no
// order and carry nothing, so fc2 keeps its whole FF sum in the tensor
// cores' f32 accumulators instead.
//
// What bounds it on the H100: the two GEMMs (2 x 2 T C FF operations, the
// shared wgmma GEMM of swin_common.cu) at both widths, by the card's published peaks: at
// C = 1024 they are 725 operations per byte that must move, at C = 128
// still 507 (the card turns at about 295). What this version pays on top is
// the bf16 hidden (T, FF), four times the activation, which goes through a
// device workspace. So the rows are walked in slabs (the caller picks the
// slab, a multiple of tokens_per_sample when dp is given): the workspace is
// (slab, C) + (slab, FF) bf16 whatever T is, and a slab's hidden is small
// enough to be read back by fc2 from the L2 cache rather than from device
// memory. Keeping the hidden on chip between fc1 and fc2 is later work.
#include "swin_common.cuh"

using namespace lrce;

extern "C" {

// x, out: (T, C) bf16, out must not alias x; ln_s, ln_b (C), b1 (FF), b2 (C)
// f32; w1 (FF, C), w2 (C, FF) bf16 (nn.Linear layouts); dp2: (T /
// tokens_per_sample) f32 or null. Workspaces: ws_z (slab_rows, C) bf16,
// ws_hid (slab_rows, FF) bf16.
int lrce_ln_mlp_fwd(const void* x, void* out, int T, int C, int ff,
                    int tokens_per_sample, int slab_rows, float eps,
                    const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* w2, const void* b2,
                    const void* dp2, void* ws_z, void* ws_hid,
                    void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (T < 1 || slab_rows < 1 || tokens_per_sample < 1 ||
      T % tokens_per_sample != 0)
    return (int)cudaErrorInvalidValue;
  if (dp2 && slab_rows % tokens_per_sample != 0)
    return (int)cudaErrorInvalidValue;
  const WinGeom geo = make_geom(1, 1, 1, 1, C, 1, 1, 1, 0, 0, 0);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  bf16* z = static_cast<bf16*>(ws_z);
  bf16* hid = static_cast<bf16*>(ws_hid);
  const float* dp = static_cast<const float*>(dp2);

  Epilogue e1 = {};
  e1.mode = EPI_BIAS_GELU;
  e1.bias = static_cast<const float*>(b1);
  Epilogue e2 = {};
  e2.mode = EPI_MLP_OUT;
  e2.bias = static_cast<const float*>(b2);
  e2.dp_rows = tokens_per_sample;

  for (long long r0 = 0; r0 < T; r0 += slab_rows) {
    const long long rows = r0 + slab_rows <= T ? slab_rows : T - r0;
    const bf16* xs = xb + r0 * C;
    // z = bf16(LN(x))
    int rc = launch_ln(xs, z, static_cast<const float*>(ln_s),
                       static_cast<const float*>(ln_b), rows, eps, geo, 0,
                       stream);
    if (rc) return rc;
    // hid = bf16(gelu(z . W1^T + b1))
    rc = launch_gemm(z, static_cast<const bf16*>(w1), hid, rows, ff, C, e1,
                     stream);
    if (rc) return rc;
    // out = bf16(x + (hid . W2^T + b2) x dp)
    e2.dp = dp ? dp + r0 / tokens_per_sample : nullptr;
    e2.res = xs;
    rc = launch_gemm(hid, static_cast<const bf16*>(w2), ob + r0 * C, rows, C,
                     ff, e2, stream);
    if (rc) return rc;
  }
  return 0;
}

}  // extern "C"
