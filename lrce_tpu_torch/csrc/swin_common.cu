// Kernels (a) LN + window gather, (b) window attention, (c) bf16 GEMM with
// epilogues, and their launchers; see swin_common.cuh.
#include "swin_common.cuh"

#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace lrce {
namespace {

namespace wmma = nvcuda::wmma;

#define LRCE_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

// Window-order row -> spatial token index. Rows follow window_partition:
// ((((b*nd + id)*nh + ih)*nw + iw)*N + (td*wh + th)*ww + tw). The token of a
// shifted block is read where jnp.roll(x, -shift) would have put it, and
// the block's output goes back to the same place, which is the roll by
// +shift after the block.
__device__ __forceinline__ long long win_row_to_token(const WinGeom& g,
                                                      long long r) {
  int t = (int)(r % g.N);
  long long wi = r / g.N;
  int iw = (int)(wi % g.nw); wi /= g.nw;
  int ih = (int)(wi % g.nh); wi /= g.nh;
  int id = (int)(wi % g.nd);
  long long b = wi / g.nd;
  int tw = t % g.ww;
  int th = (t / g.ww) % g.wh;
  int td = t / (g.ww * g.wh);
  int d = (id * g.wd + td + g.sd) % g.D;
  int h = (ih * g.wh + th + g.sh) % g.H;
  int w = (iw * g.ww + tw + g.sw) % g.W;
  return ((b * g.D + d) * g.H + h) * (long long)g.W + w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// (a) LayerNorm over C (C % 32 == 0, C <= 1024), one warp per row, f32 math,
// bf16 out. gather != 0: output row r is window token r (win_row_to_token).
// ---------------------------------------------------------------------------
constexpr int LN_WARPS = 8;

__global__ void __launch_bounds__(LN_WARPS * 32)
ln_rows_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               long long rows, float eps, WinGeom g, int gather) {
  long long row = (long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int C = g.C;
  const int per = C >> 5;
  long long src = gather ? win_row_to_token(g, row) : row;
  const bf16* xr = x + src * C;
  float v[32];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i < per) {
      v[i] = __bfloat162float(xr[lane + 32 * i]);
      s += v[i];
    }
  }
  const float mean = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i < per) {
      v[i] -= mean;
      q += v[i] * v[i];
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)C + eps);
  bf16* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i < per) {
      int c = lane + 32 * i;
      orow[c] = __float2bfloat16(v[i] * rstd * gamma[c] + beta[c]);
    }
  }
}

}  // namespace

int launch_ln(const bf16* x, bf16* out, const float* gamma, const float* beta,
              long long rows, float eps, const WinGeom& g, int gather,
              cudaStream_t stream) {
  if (g.C % 32 != 0 || g.C > 1024) return (int)cudaErrorInvalidValue;
  long long blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  ln_rows_kernel<<<(unsigned)blocks, LN_WARPS * 32, 0, stream>>>(
      x, out, gamma, beta, rows, eps, g, gather);
  LRCE_CHECK_LAUNCH();
  return 0;
}

namespace {

// ---------------------------------------------------------------------------
// (b) Window attention. qkv: (nwin_total*N, 3C) bf16 in window order, packed
// [q | k | v] with head h at columns h*hd. One CTA per (window, head):
// q, k, v of the window sit in shared memory padded to Np = ceil16(N) rows.
// Each warp takes 16 query rows at a time: S = q k^T (WMMA, f32) into its
// own shared slab, + rel_bias[h] (+ mask of the window), f32 softmax with
// the padded keys at -inf, P rounded to bf16, ctx = P v (WMMA, f32) rounded
// to bf16. Padded query rows are never stored.
// ---------------------------------------------------------------------------
__global__ void window_attn_kernel(const bf16* __restrict__ qkv,
                                   bf16* __restrict__ ctx,
                                   const float* __restrict__ rel_bias,
                                   const float* __restrict__ mask,
                                   int N, int Np, int C, int hd,
                                   int nwin_clip, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long win = blockIdx.x;
  const int h = blockIdx.y;

  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + Np * hd;
  bf16* Vs = Ks + Np * hd;
  unsigned char* wbase = reinterpret_cast<unsigned char*>(Vs + Np * hd) +
                         (size_t)warp * (16 * Np * (sizeof(float) + sizeof(bf16)));
  float* S = reinterpret_cast<float*>(wbase);
  bf16* P = reinterpret_cast<bf16*>(S + 16 * Np);

  // q, k, v rows of this (window, head): 8 bf16 (16 bytes) per load
  const bf16* base = qkv + win * N * (3LL * C);
  const int vecs_per_row = hd >> 3;
  for (int idx = threadIdx.x; idx < Np * vecs_per_row; idx += blockDim.x) {
    const int t = idx / vecs_per_row;
    const int d0 = (idx % vecs_per_row) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0), kv = qv, vv = qv;
    if (t < N) {
      const bf16* row = base + (long long)t * 3 * C + h * hd + d0;
      qv = *reinterpret_cast<const uint4*>(row);
      kv = *reinterpret_cast<const uint4*>(row + C);
      vv = *reinterpret_cast<const uint4*>(row + 2 * C);
      bf16* qe = reinterpret_cast<bf16*>(&qv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qe[e] = __float2bfloat16(__bfloat162float(qe[e]) * scale);
    }
    *reinterpret_cast<uint4*>(Qs + t * hd + d0) = qv;
    *reinterpret_cast<uint4*>(Ks + t * hd + d0) = kv;
    *reinterpret_cast<uint4*>(Vs + t * hd + d0) = vv;
  }
  __syncthreads();

  const int nrb = Np >> 4;
  const float* bias_h = rel_bias + (long long)h * N * N;
  const float* mask_w =
      mask ? mask + (long long)(win % nwin_clip) * N * N : nullptr;
  for (int rb = warp; rb < nrb; rb += nwarps) {
    // S = Q[rb] K^T
    for (int cb = 0; cb < nrb; ++cb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < hd; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + rb * 16 * hd + kk, hd);
        wmma::load_matrix_sync(b, Ks + cb * 16 * hd + kk, hd);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(S + cb * 16, acc, Np, wmma::mem_row_major);
    }
    __syncwarp();

    for (int i = 0; i < 16; ++i) {
      const int qi = rb * 16 + i;
      float* srow = S + i * Np;
      bf16* prow = P + i * Np;
      if (qi >= N) {
        for (int j = lane; j < Np; j += 32) prow[j] = __float2bfloat16(0.f);
        continue;
      }
      const float* brow = bias_h + (long long)qi * N;
      const float* mrow = mask_w ? mask_w + (long long)qi * N : nullptr;
      float mx = -INFINITY;
      for (int j = lane; j < Np; j += 32) {
        float l = -INFINITY;
        if (j < N) l = srow[j] + (mrow ? brow[j] + mrow[j] : brow[j]);
        srow[j] = l;
        mx = fmaxf(mx, l);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < Np; j += 32) {
        float e = j < N ? expf(srow[j] - mx) : 0.f;
        srow[j] = e;
        sum += e;
      }
      const float r = 1.f / warp_sum(sum);
      for (int j = lane; j < Np; j += 32)
        prow[j] = __float2bfloat16(srow[j] * r);
    }
    __syncwarp();

    // ctx = P V, 16 x hd, staged through S (ld = hd)
    for (int db = 0; db < hd; db += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < Np; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, P + kk, Np);
        wmma::load_matrix_sync(b, Vs + kk * hd + db, hd);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(S + db, acc, hd, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * hd; e += 32) {
      const int i = e / hd, d = e % hd;
      const int qi = rb * 16 + i;
      if (qi < N)
        ctx[(win * N + qi) * C + h * hd + d] = __float2bfloat16(S[i * hd + d]);
    }
    __syncwarp();
  }
}

// Shared-memory bytes for nwarps warps, and the warp count launched: as
// many as fit about half an SM (two CTAs resident per SM), at least one.
size_t attn_smem_bytes(int Np, int hd, int nwarps) {
  return (size_t)3 * Np * hd * sizeof(bf16) +
         (size_t)nwarps * 16 * Np * (sizeof(float) + sizeof(bf16));
}

constexpr size_t kMaxSmem = 227 * 1024;

int attn_warps(int Np, int hd) {
  const size_t fixed = attn_smem_bytes(Np, hd, 0);
  const size_t per = attn_smem_bytes(Np, hd, 1) - fixed;
  const size_t half = 110 * 1024;
  int w = half > fixed ? (int)((half - fixed) / per) : 0;
  if (w < 1) w = 1;
  if (w > Np / 16) w = Np / 16;
  return w;
}

}  // namespace

int launch_attn(const bf16* qkv, bf16* ctx, const float* rel_bias,
                const float* mask, long long nwin_total, int nwin_clip, int N,
                int C, int num_heads, cudaStream_t stream) {
  const int hd = C / num_heads;
  const int Np = (N + 15) / 16 * 16;
  if (hd % 16 != 0 || hd > Np) return (int)cudaErrorInvalidValue;
  const int nwarps = attn_warps(Np, hd);
  const size_t smem = attn_smem_bytes(Np, hd, nwarps);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      window_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)nwin_total, num_heads);
  window_attn_kernel<<<grid, nwarps * 32, smem, stream>>>(
      qkv, ctx, rel_bias, mask, N, Np, C, hd, nwin_clip,
      1.f / sqrtf((float)hd));
  LRCE_CHECK_LAUNCH();
  return 0;
}

namespace {

// ---------------------------------------------------------------------------
// (c) GEMM: out = epilogue(A (M x K, row-major) . W^T), W (N x K, row-major,
// the nn.Linear layout). bf16 in, f32 accumulate on the tensor cores (WMMA
// 16x16x16). Block tile 128 x 128 x 32, 8 warps of 32 x 64; the next k-tile
// is fetched into registers while the current one multiplies.
// Requires K % 8 == 0 (16-byte loads); M and N are bounds-checked.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void epilogue_store(const Epilogue& ep, bf16* out,
                                               long long m, int n, int ldc,
                                               float acc) {
  float a = acc + ep.bias[n];
  switch (ep.mode) {
    case EPI_BIAS:
      out[m * ldc + n] = __float2bfloat16(a);
      break;
    case EPI_BIAS_GELU:
      out[m * ldc + n] = __float2bfloat16(
          a * 0.5f * (1.f + erff(a * 0.70710678118654752f)));
      break;
    case EPI_ATTN_OUT: {
      if (ep.dp) a *= ep.dp[m / ep.dp_rows];
      float v = __bfloat162float(__float2bfloat16(a));
      const long long dst = ep.scatter ? win_row_to_token(ep.g, m) : m;
      if (ep.res) v += __bfloat162float(ep.res[dst * ldc + n]);
      out[dst * ldc + n] = __float2bfloat16(v);
      break;
    }
    case EPI_MLP_OUT: {
      if (ep.dp) a *= ep.dp[m / ep.dp_rows];
      out[m * ldc + n] =
          __float2bfloat16(__bfloat162float(ep.res[m * ldc + n]) + a);
      break;
    }
  }
}

constexpr int GBM = 128, GBN = 128, GBK = 32, GLDS = GBK + 8;

__global__ void __launch_bounds__(256)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wt,
                 bf16* __restrict__ out, long long M, int N, int K,
                 Epilogue ep) {
  __shared__ __align__(128) bf16 As[GBM * GLDS];
  __shared__ __align__(128) bf16 Bs[GBN * GLDS];
  __shared__ __align__(128) float Cs[8][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1;  // 4 warp rows of 32
  const int wn = warp & 1;   // 2 warp cols of 64
  const long long m0 = (long long)blockIdx.x * GBM;
  const int n0 = blockIdx.y * GBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[2], rb[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * 256;
      const int r = idx >> 2, kv = (idx & 3) * 8;
      const int gk = k0 + kv;
      const long long gm = m0 + r;
      const int gn = n0 + r;
      ra[v] = (gm < M && gk < K)
                  ? *reinterpret_cast<const uint4*>(A + gm * K + gk)
                  : make_uint4(0, 0, 0, 0);
      rb[v] = (gn < N && gk < K)
                  ? *reinterpret_cast<const uint4*>(Wt + (long long)gn * K + gk)
                  : make_uint4(0, 0, 0, 0);
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += GBK) {
    __syncthreads();
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * 256;
      const int r = idx >> 2, kv = (idx & 3) * 8;
      *reinterpret_cast<uint4*>(As + r * GLDS + kv) = ra[v];
      *reinterpret_cast<uint4*>(Bs + r * GLDS + kv) = rb[v];
    }
    __syncthreads();
    if (k0 + GBK < K) load_tile(k0 + GBK);
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * GLDS + kk, GLDS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 64 + j * 16) * GLDS + kk, GLDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  float* cs = Cs[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long gm = m0 + wm * 32 + i * 16 + r;
      const int gn0 = n0 + wn * 64 + j * 16 + c0;
      if (gm < M) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (gn0 + c < N) epilogue_store(ep, out, gm, gn0 + c, N, cs[r * 16 + c0 + c]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

int launch_gemm(const bf16* A, const bf16* Wt, bf16* out, long long M, int N,
                int K, const Epilogue& ep, cudaStream_t stream) {
  if (K % 8 != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + GBM - 1) / GBM), (N + GBN - 1) / GBN);
  gemm_bf16_kernel<<<grid, 256, 0, stream>>>(A, Wt, out, M, N, K, ep);
  LRCE_CHECK_LAUNCH();
  return 0;
}

namespace {

Epilogue epi_bias(const float* bias) {
  Epilogue e = {};
  e.mode = EPI_BIAS;
  e.bias = bias;
  return e;
}

}  // namespace

// LN1 (window gather) -> qkv GEMM -> window attention. Leaves ctx (window
// order) in ws_tc. Shared by K1/K3 and K2.
int attention_front(const bf16* x, const WinGeom& g, int num_heads, float eps,
                    const float* ln_s, const float* ln_b, const bf16* qkv_w,
                    const float* qkv_b, const float* rel_bias,
                    const float* mask, bf16* ws_tc, bf16* ws_qkv,
                    cudaStream_t stream) {
  const long long T = (long long)g.B * g.D * g.H * g.W;
  int rc = launch_ln(x, ws_tc, ln_s, ln_b, T, eps, g, 1, stream);
  if (rc) return rc;
  rc = launch_gemm(ws_tc, qkv_w, ws_qkv, T, 3 * g.C, g.C, epi_bias(qkv_b),
                   stream);
  if (rc) return rc;
  const long long nwin_clip = (long long)g.nd * g.nh * g.nw;
  return launch_attn(ws_qkv, ws_tc, rel_bias, mask, T / g.N, (int)nwin_clip,
                     g.N, g.C, num_heads, stream);
}


}  // namespace lrce
