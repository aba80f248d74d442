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
// (lrce_tpu/ops/pallas_swin_block.py) with its rounding points: pre in f32,
// hid / dpre / g2 rounded once. The TPU splits FF into chunks only to fit
// VMEM; here every product spans all of FF.
//
// What bounds it on the H100: five products of 2 T C FF operations each
// (the fc1 recompute, dhid, dW2, dW1, dz) against (T, FF) intermediates
// that every one of them would otherwise read or write in device memory.
// What the design does:
//   - one kernel (mlp_bwd_hidden_kernel) holds, for a 128-row x 128-column
//     tile of the hidden, both accumulators pre = z . W1^T and dhid =
//     g2 . W2 in registers (two wgmma chains over the same C, W2 read in
//     place through the transpose bit), and forms hid, dpre and db1's
//     column sums there: the f32 pre-activation never exists in device
//     memory, only the two bf16 (T, FF) arrays that dW2, dW1 and dz read;
//   - dW1 and dW2 reduce over every token into a (FF, C) output, so they
//     run as split-K wgmma GEMMs with f32 partials summed in a fixed order;
//   - db1 is summed per tile in registers, across a CTA's eight warps in
//     shared memory in a fixed order, one f32 row per 128 tokens, and those
//     rows in a fixed order: no atomics, the result does not vary from run
//     to run;
//   - dz = dpre . W1 reads W1 (FF, C) in place as the (K x N) operand.
#include "swin_common.cuh"

#include "hopper.cuh"

#include <math.h>

using namespace lrce;

namespace {

constexpr int HB = 128, HK = 64, HSTAGES = 3;
constexpr int H_TILE_BYTES = 128 * 128;
constexpr int H_STAGE_BYTES = 4 * H_TILE_BYTES;  // z, g2, W1, W2 tiles
constexpr size_t H_SMEM =
    (size_t)HSTAGES * H_STAGE_BYTES + 8 * HB * sizeof(float) + 1024;

// z, g2: (T, C); w1: (FF, C); w2: (C, FF); b1: (FF). hid, dpre: (T, FF)
// bf16. colsum: (gridDim.y, FF) f32, row y = the column sums of the f32
// dpre over tokens 128 y .. 128 y + 127.
__global__ void __launch_bounds__(256, 1)
mlp_bwd_hidden_kernel(const bf16* __restrict__ z, const bf16* __restrict__ g2,
                      const bf16* __restrict__ w1,
                      const bf16* __restrict__ w2,
                      const float* __restrict__ b1, bf16* __restrict__ hid,
                      bf16* __restrict__ dpre, float* __restrict__ colsum,
                      long long T, int C, int FF) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* colsm = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + HSTAGES * H_STAGE_BYTES);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = blockIdx.x * HB;
  const long long m0 = (long long)blockIdx.y * HB;
  const int nk = (C + HK - 1) / HK;

  float pre[64], dh[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    pre[i] = 0.f;
    dh[i] = 0.f;
  }

  auto load = [&](int kt, int s) {
    const uint32_t sz = base + s * H_STAGE_BYTES, sg = sz + H_TILE_BYTES;
    const uint32_t s1 = sg + H_TILE_BYTES, s2 = s1 + H_TILE_BYTES;
    const int c = tid & 7, r0 = tid >> 3;
    const int gk = kt * HK + c * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 32 * i;
      const long long gm = m0 + r;
      const bool ok = gm < T && gk < C;
      cp_async16(sz + swz128(r, c), ok ? z + gm * C + gk : z, ok);
      cp_async16(sg + swz128(r, c), ok ? g2 + gm * C + gk : g2, ok);
      const int gn = n0 + r;
      const bool okw = gn < FF && gk < C;
      cp_async16(s1 + swz128(r, c), okw ? w1 + (long long)gn * C + gk : w1,
                 okw);
    }
    const int c16 = tid & 15, q0 = tid >> 4;
    const int gn = n0 + c16 * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = q0 + 16 * i;
      const int gc = kt * HK + kr;
      const bool ok = gc < C && gn < FF;
      cp_async16(s2 + (c16 >> 3) * 8192 + swz128(kr, c16 & 7),
                 ok ? w2 + (long long)gc * FF + gn : w2, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < HSTAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<HSTAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    if (kt + HSTAGES - 1 < nk)
      load(kt + HSTAGES - 1, (kt + HSTAGES - 1) % HSTAGES);
    cp_async_commit();
    const uint32_t sz = base + (kt % HSTAGES) * H_STAGE_BYTES + wg * 8192;
    const uint32_t sg = sz + H_TILE_BYTES;
    const uint32_t s1 = base + (kt % HSTAGES) * H_STAGE_BYTES + 2 * H_TILE_BYTES;
    const uint32_t s2 = s1 + H_TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HK / 16; ++ks) {
      wgmma_m64n128k16<0, 0>(pre, wgmma_desc(sz + ks * 32, 16, 1024),
                             wgmma_desc(s1 + ks * 32, 16, 1024), 1);
      wgmma_m64n128k16<0, 1>(dh, wgmma_desc(sg + ks * 32, 16, 1024),
                             wgmma_desc(s2 + ks * 2048, 8192, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }

  // hid = bf16(gelu(pre + b1)); dpre = bf16(dhid gelu'(pre + b1)) with
  // gelu'(p) = cdf(p) + p pdf(p), pdf(p) = exp(-p^2 / 2) / sqrt(2 pi);
  // column sums of the f32 dpre. Both accumulators leave through this
  // warp's two staging tiles in the idle ring (hopper.cuh), then every lane
  // owns 8 neighbouring columns of a row.
  cp_async_wait<0>();
  __syncthreads();
  const int w8 = tid >> 5;
  float* st_p = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + w8 * 2 * STAGE_WARP_BYTES);
  float* st_d = st_p + 16 * STAGE_LD;
  stage_acc(st_p, pre, lane);
  stage_acc(st_d, dh, lane);
  __syncwarp();
  const int cc = lane & 15, rsel = lane >> 4;
  const int n = n0 + 8 * cc;
  float cs[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) cs[e] = 0.f;
  if (n < FF) {
    float b[8];
    load8(b1 + n, b);
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int row = 2 * it + rsel;
      const long long gm = m0 + wg * 64 + warp * 16 + row;
      if (gm >= T) continue;
      float p[8], d[8];
      load8(st_p + row * STAGE_LD + 8 * cc, p);
      load8(st_d + row * STAGE_LD + 8 * cc, d);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float x = p[e] + b[e];
        const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
        const float pdf = expf(-0.5f * x * x) * 0.39894228040143268f;
        p[e] = x * cdf;
        d[e] *= cdf + x * pdf;
        cs[e] += d[e];
      }
      store8(hid + gm * FF + n, p);
      store8(dpre + gm * FF + n, d);
    }
  }
  // even rows (lanes 0-15) + odd rows (lanes 16-31), a fixed order
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 16);
    if (rsel == 0) colsm[w8 * HB + 8 * cc + e] = cs[e];
  }
  __syncthreads();
  if (tid < HB && n0 + tid < FF) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += colsm[w * HB + tid];
    colsum[(long long)blockIdx.y * FF + n0 + tid] = s;
  }
}

}  // namespace

extern "C" {

// h1, g: (B, D, H, W, C) bf16; w1 (FF, C), w2 (C, FF) bf16; ln2s, ln2b (C),
// b1 (FF), dp2 (B) or null, f32. Outputs: dz (B, D, H, W, C) bf16; dw1
// (FF, C), db1 (FF), dw2 (C, FF) f32; g2 (T, C) bf16. Workspaces: ws_z
// (T, C) bf16; ws_hid, ws_dpre (T, FF) bf16; ws_col (col_rows, FF) f32 with
// col_rows = ceil(T / 128); ws_split (splits, FF C) f32.
int lrce_mlp_bwd(const void* h1, const void* g, int B, int D, int H, int W,
                 int C, int ff, float eps, const void* ln2s,
                 const void* ln2b, const void* w1, const void* b1,
                 const void* w2, const void* dp2, void* dz, void* dw1,
                 void* db1, void* dw2, void* g2, void* ws_z, void* ws_hid,
                 void* ws_dpre, void* ws_col, void* ws_split, int col_rows,
                 int splits, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const WinGeom geo = make_geom(B, D, H, W, C, 1, 1, 1, 0, 0, 0);
  const long long T = (long long)B * D * H * W;
  if (col_rows != (int)((T + HB - 1) / HB) || C % 8 != 0 || ff % 8 != 0)
    return (int)cudaErrorInvalidValue;
  bf16* z = static_cast<bf16*>(ws_z);
  bf16* gs = static_cast<bf16*>(g2);
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

  // hid = bf16(gelu(z . W1^T + b1)), dpre = bf16((g2 . W2) gelu'(.)), and
  // the column sums of the f32 dpre -> db1
  cudaError_t ea = cudaFuncSetAttribute(
      mlp_bwd_hidden_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)H_SMEM);
  if (ea != cudaSuccess) return (int)ea;
  mlp_bwd_hidden_kernel<<<dim3((ff + HB - 1) / HB, col_rows), 256, H_SMEM,
                          stream>>>(
      z, gs, static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b1), hid, dpre, static_cast<float*>(ws_col),
      T, C, ff);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rc = launch_sum_parts(static_cast<const float*>(ws_col),
                        static_cast<float*>(db1), col_rows, ff, stream);
  if (rc) return rc;
  // dW2 = g2^T . hid; dW1 = dpre^T . z; dz = dpre . W1
  rc = launch_gemm_tn(gs, hid, static_cast<float*>(dw2), T, C, ff, splits,
                      split, stream);
  if (rc) return rc;
  rc = launch_gemm_tn(dpre, z, static_cast<float*>(dw1), T, ff, C, splits,
                      split, stream);
  if (rc) return rc;
  Epilogue e3 = {};
  e3.mode = EPI_ATTN_OUT;  // bias null, no dp / residual / scatter: bf16(acc)
  e3.dp_rows = 1;
  return launch_gemm(dpre, static_cast<const bf16*>(w1),
                     static_cast<bf16*>(dz), T, C, ff, e3, stream, true);
}

}  // extern "C"
