// Device pieces shared by the Swin kernels K1/K3 (swin_block.cu), K2/K6
// (window_attn.cu), K4 (attn_bwd.cu) and K5 (mlp_bwd.cu):
//   (a) LayerNorm with a window gather: row r of the output is window token
//       r, read from its spatial position, cyclic shift included; and the
//       same gather without the LayerNorm;
//   (b) window attention: for head_dim 16 or 32 and windows of at most 160
//       tokens a CTA per (window group, head) on mma.sync with S and P in
//       registers (attn_fwd.cu); for other shapes one WMMA CTA per (window,
//       head) (swin_common.cu);
//   (c) a bf16 tensor-core GEMM (a persistent, warp-specialised CTA: TMA
//       into a ring of stages, two consumer warpgroups on wgmma in turns,
//       f32 accumulate in registers), out = A . W^T or A . B, with epilogues
//       applied from the registers: +bias; +bias and exact-erf GELU; +bias,
//       x dp, + residual, scattered back to spatial order; + residual in
//       f32;
//   (d) the weight-gradient GEMM out = G^T . A (both row-major with the
//       long reduction axis first, read as they lie), split over the
//       reduction into f32 partials that a second pass sums in a fixed
//       order.
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

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
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
  EPI_MLP_OUT = 3     // bf16(res + (acc + bias) x dp)
};

// What the GEMM does with its f32 accumulator (see epilogue8 in
// swin_common.cu).
struct Epilogue {
  int mode;
  const float* bias;  // (N,) f32, or null
  const float* dp;    // per-sample multiplier dp[row / dp_rows], or null
  long long dp_rows;
  const bf16* res;    // residual (row-major, ld N), or null
  int scatter;        // EPI_ATTN_OUT: rows are window order, write spatial
  WinGeom g;
};

// Window-order row -> spatial token index. Rows follow window_partition:
// ((((b*nd + id)*nh + ih)*nw + iw)*N + (td*wh + th)*ww + tw). The token of a
// shifted block is read where jnp.roll(x, -shift) would have put it, and
// the block's output goes back to the same place, which is the roll by
// +shift after the block.
// Rows and tokens are below 2^31 (the launchers check it), so the
// divisions run in 32 bits, a third of the instructions of 64-bit ones.
static __device__ __forceinline__ long long win_row_to_token(const WinGeom& g,
                                                      long long row) {
  const unsigned r = (unsigned)row;
  const unsigned t = r % (unsigned)g.N;
  unsigned wi = r / (unsigned)g.N;
  const unsigned iw = wi % (unsigned)g.nw; wi /= (unsigned)g.nw;
  const unsigned ih = wi % (unsigned)g.nh; wi /= (unsigned)g.nh;
  const unsigned id = wi % (unsigned)g.nd;
  const unsigned b = wi / (unsigned)g.nd;
  const unsigned tw = t % (unsigned)g.ww;
  const unsigned th = (t / (unsigned)g.ww) % (unsigned)g.wh;
  const unsigned td = t / (unsigned)(g.ww * g.wh);
  const unsigned d = (id * g.wd + td + g.sd) % (unsigned)g.D;
  const unsigned h = (ih * g.wh + th + g.sh) % (unsigned)g.H;
  const unsigned w = (iw * g.ww + tw + g.sw) % (unsigned)g.W;
  return ((long long)(b * g.D + d) * g.H + h) * (long long)g.W + w;
}

// erf in f32 as XLA computes it, the rational approximation the reference
// kernels call (_erf_f32, lrce_tpu/ops/pallas_mlp.py; the port's own copy
// of the coefficients, also in ops/nn.py ERF_ALPHA / ERF_BETA): x clamped
// to [-4, 4], x P(x^2) / Q(x^2) with P of degree 6 and Q of degree 4,
// clamped to [-1, 1]. The quotient is __fdividef (one MUFU.RCP and a
// multiply): Q(x^2) lies in [-2.4, -0.0143], where it keeps 2 ulp.
static __device__ __forceinline__ float erf_xla(float x) {
  x = fminf(fmaxf(x, -4.f), 4.f);
  const float x2 = x * x;
  float p = -2.72614225801306e-10f;
  p = fmaf(p, x2, 2.77068142495902e-08f);
  p = fmaf(p, x2, -2.10102402082508e-06f);
  p = fmaf(p, x2, -5.69250639462346e-05f);
  p = fmaf(p, x2, -7.34990630326855e-04f);
  p = fmaf(p, x2, -2.95459980854025e-03f);
  p = fmaf(p, x2, -1.60960333262415e-02f);
  float q = -1.45660718464996e-05f;
  q = fmaf(q, x2, -2.13374055278905e-04f);
  q = fmaf(q, x2, -1.68282697438203e-03f);
  q = fmaf(q, x2, -7.37332916720468e-03f);
  q = fmaf(q, x2, -1.42647390514189e-02f);
  return fminf(fmaxf(__fdividef(x * p, q), -1.f), 1.f);
}

// Exact-erf GELU in f32, the erf as the reference computes it.
static __device__ __forceinline__ float gelu_erf(float a) {
  return a * 0.5f * (1.f + erf_xla(a * 0.70710678118654752f));
}

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

// A TMA tensor map of a row-major bf16 matrix (rows x cols, row stride ld
// elements): boxes of 64 columns (128 bytes, stored with the 128-byte
// swizzle) by box_rows rows, zeros past the edges. The driver's encoder is
// reached through cudaGetDriverEntryPoint; the last few maps are kept by
// (pointer, shape), so a call on the same tensors encodes nothing. Returns
// 0 or a cudaError_t code.
int make_tmap(CUtensorMap* map, const bf16* ptr, long long rows,
              long long cols, long long ld, int box_rows);
// Host nanoseconds of one encode, measured over `n` encodes that miss the
// cache (chip_smoke prints it).
double tmap_encode_ns(int n);

// Each returns 0 or a cudaError_t code.
// (a) LayerNorm of `rows` rows of C; gather != 0 reads row r at its window
//     token's spatial position.
int launch_ln(const bf16* x, bf16* out, const float* gamma, const float* beta,
              long long rows, float eps, const WinGeom& g, int gather,
              cudaStream_t stream);
// (b) window attention over packed (nwin_total * N, 3C) qkv -> ctx (., C);
//     mask (nwin_clip, N, N) f32 or null. The shift mask may also come as
//     labels: mask_labels (nwin_clip, ceil16(N)) int32 and mask_off
//     (nwin_clip) f32 say that window w adds mask_off[w] to the logit of
//     (i, j) where labels[w][i] != labels[w][j] and nothing elsewhere; a NaN
//     in mask_off[w] says that w's mask is not of that form and is read as
//     it lies. Both null: every window reads the dense mask. groups: window
//     groups of attn_fwd_kernel's grid, 1 .. nwin_total (unused where the
//     shape takes launch_attn_wmma, see attn_fwd.cu).
int launch_attn(const bf16* qkv, bf16* ctx, const float* rel_bias,
                const float* mask, const int* mask_labels,
                const float* mask_off, long long nwin_total, int nwin_clip,
                int N, int C, int num_heads, int groups, cudaStream_t stream);
int launch_attn_wmma(const bf16* qkv, bf16* ctx, const float* rel_bias,
                     const float* mask, long long nwin_total, int nwin_clip,
                     int N, int C, int num_heads, cudaStream_t stream);
// (c) out = epilogue(A (M x K) . W^T) with Bm = W (N x K), or, with b_kn
//     (EPI_ATTN_OUT only), epilogue(A . Bm) with Bm (K x N); all row-major,
//     K % 8 == 0, N % 8 == 0.
int launch_gemm(const bf16* A, const bf16* Bm, bf16* out, long long M, int N,
                int K, const Epilogue& ep, cudaStream_t stream,
                bool b_kn = false);
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
// The block's back half as one persistent kernel (back_half.cu), C = 128
// or 256, FF = 4 C: out = h1 + dp2 x fc2(gelu(fc1(LN2 h1))) with h1 = x +
// dp1 x proj(ctx), ctx (T, C) in window order, x and out in spatial order
// (rows scattered through g, shift included); dp1, dp2 per sample or null.
bool back_half_supported(int C);
int launch_back_half(const bf16* ctx, const bf16* x, bf16* out,
                     const WinGeom& g, float eps, const bf16* proj_w,
                     const float* proj_b, const float* ln_s,
                     const float* ln_b, const bf16* w1, const float* b1,
                     const bf16* w2, const float* b2, const float* dp1,
                     const float* dp2, cudaStream_t stream);
// LN1 (window gather) -> qkv GEMM -> window attention; ctx (window order)
// is left in ws_tc. Shared by K1/K3, K2 and K6.
int attention_front(const bf16* x, const WinGeom& g, int num_heads, float eps,
                    const float* ln_s, const float* ln_b, const bf16* qkv_w,
                    const float* qkv_b, const float* rel_bias,
                    const float* mask, const int* mask_labels,
                    const float* mask_off, int groups, bf16* ws_tc,
                    bf16* ws_qkv, cudaStream_t stream);

}  // namespace lrce
