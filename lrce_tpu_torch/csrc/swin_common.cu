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
// Stores one element; returns the f32 value whose column sum EPI_GELU_BWD
// keeps (0 for the other modes). The mode is a template argument, so each
// GEMM instantiation carries only its own epilogue.
template <int kMode>
__device__ __forceinline__ float epilogue_store(const Epilogue& ep, bf16* out,
                                                long long m, int n, int ldc,
                                                float acc) {
  float a = ep.bias ? acc + ep.bias[n] : acc;
  if constexpr (kMode == EPI_BIAS) {
    out[m * ldc + n] = __float2bfloat16(a);
  } else if constexpr (kMode == EPI_BIAS_GELU) {
    out[m * ldc + n] = __float2bfloat16(
        a * 0.5f * (1.f + erff(a * 0.70710678118654752f)));
  } else if constexpr (kMode == EPI_ATTN_OUT) {
    if (ep.dp) a *= ep.dp[m / ep.dp_rows];
    float v = __bfloat162float(__float2bfloat16(a));
    const long long dst = ep.scatter ? win_row_to_token(ep.g, m) : m;
    if (ep.res) v += __bfloat162float(ep.res[dst * ldc + n]);
    out[dst * ldc + n] = __float2bfloat16(v);
  } else if constexpr (kMode == EPI_MLP_OUT) {
    if (ep.dp) a *= ep.dp[m / ep.dp_rows];
    out[m * ldc + n] =
        __float2bfloat16(__bfloat162float(ep.res[m * ldc + n]) + a);
  } else if constexpr (kMode == EPI_PRE_GELU) {
    ep.aux[m * ldc + n] = a;
    out[m * ldc + n] = __float2bfloat16(
        a * 0.5f * (1.f + erff(a * 0.70710678118654752f)));
  } else {  // EPI_GELU_BWD
    // gelu'(p) = cdf(p) + p pdf(p), pdf(p) = exp(-p^2 / 2) / sqrt(2 pi)
    const float p = ep.aux[m * ldc + n];
    const float cdf = 0.5f * (1.f + erff(p * 0.70710678118654752f));
    const float pdf = expf(-0.5f * p * p) * 0.39894228040143268f;
    const float d = a * (cdf + p * pdf);
    out[m * ldc + n] = __float2bfloat16(d);
    return d;
  }
  return 0.f;
}

constexpr int GBM = 128, GBN = 128, GBK = 32, GLDS = GBK + 8;

// kMode: the epilogue; EPI_GELU_BWD also keeps column sums.
template <int kMode>
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

  constexpr bool kColSum = kMode == EPI_GELU_BWD;
  float* cs = Cs[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  float colacc[kColSum ? 4 : 1][8];
#pragma unroll
  for (int j = 0; j < (kColSum ? 4 : 1); ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) colacc[j][c] = 0.f;
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
        for (int c = 0; c < 8; ++c) {
          if (gn0 + c < N) {
            const float v = epilogue_store<kMode>(ep, out, gm, gn0 + c, N,
                                                  cs[r * 16 + c0 + c]);
            if constexpr (kColSum) colacc[j][c] += v;
          }
        }
      }
      __syncwarp();
    }
  }
  if constexpr (kColSum) {
    // sum the 16 rows a lane pair covers (lanes of equal parity), then
    // lanes 0 and 1 write this warp row's column sums: a fixed order
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float v = colacc[j][c];
#pragma unroll
        for (int o = 2; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        colacc[j][c] = v;
      }
    }
    if (lane < 2) {
      float* row = ep.colsum + ((long long)blockIdx.x * 4 + wm) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn0 = n0 + wn * 64 + j * 16 + lane * 8;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (gn0 + c < N) row[gn0 + c] = colacc[j][c];
      }
    }
  }
}

}  // namespace

int launch_gemm(const bf16* A, const bf16* Wt, bf16* out, long long M, int N,
                int K, const Epilogue& ep, cudaStream_t stream) {
  if (K % 8 != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + GBM - 1) / GBM), (N + GBN - 1) / GBN);
  switch (ep.mode) {
#define LRCE_GEMM_CASE(MODE)                                              \
  case MODE:                                                              \
    gemm_bf16_kernel<MODE><<<grid, 256, 0, stream>>>(A, Wt, out, M, N, K, \
                                                     ep);                 \
    break;
    LRCE_GEMM_CASE(EPI_BIAS)
    LRCE_GEMM_CASE(EPI_BIAS_GELU)
    LRCE_GEMM_CASE(EPI_ATTN_OUT)
    LRCE_GEMM_CASE(EPI_MLP_OUT)
    LRCE_GEMM_CASE(EPI_PRE_GELU)
    LRCE_GEMM_CASE(EPI_GELU_BWD)
#undef LRCE_GEMM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  LRCE_CHECK_LAUNCH();
  return 0;
}

namespace {

// ---------------------------------------------------------------------------
// Row gather into window order, and per-sample row scaling (8 bf16 a thread)
// ---------------------------------------------------------------------------
__global__ void gather_rows_kernel(const bf16* __restrict__ src,
                                   bf16* __restrict__ dst, long long rows,
                                   WinGeom g) {
  const int vecs = g.C >> 3;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * vecs) return;
  const long long r = idx / vecs;
  const int v = (int)(idx % vecs);
  const long long s = win_row_to_token(g, r);
  reinterpret_cast<uint4*>(dst + r * g.C)[v] =
      reinterpret_cast<const uint4*>(src + s * g.C)[v];
}

__global__ void scale_rows_kernel(const bf16* __restrict__ in,
                                  bf16* __restrict__ out,
                                  const float* __restrict__ dp,
                                  long long rows, int C, long long dp_rows) {
  const int vecs = C >> 3;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * vecs) return;
  const long long r = idx / vecs;
  const float k = dp[r / dp_rows];
  uint4 u = reinterpret_cast<const uint4*>(in)[idx];
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = __float2bfloat16(__bfloat162float(e[i]) * k);
  reinterpret_cast<uint4*>(out)[idx] = u;
}

// ---------------------------------------------------------------------------
// (d) Weight-gradient GEMM: part[s] (N x K) = G[m in chunk s]^T . A[same m].
// Output tile 64 x 64 per CTA (4 warps of 32 x 32), reduction step 32 rows;
// G's tile is the col-major A operand of WMMA, A's tile the row-major B
// operand, so neither needs a transpose. The next step's rows are fetched
// into registers while the current ones multiply.
// ---------------------------------------------------------------------------
constexpr int TBN = 64, TBK = 64, TBM = 32, TLD = 72;

__global__ void __launch_bounds__(128)
gemm_tn_kernel(const bf16* __restrict__ G, const bf16* __restrict__ A,
               float* __restrict__ part, long long M, int N, int K,
               long long chunk) {
  __shared__ __align__(128) bf16 Gs[TBM * TLD];
  __shared__ __align__(128) bf16 As[TBM * TLD];
  __shared__ __align__(128) float Cs[4][16 * 16];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wn = warp >> 1, wk = warp & 1;
  const int n0 = blockIdx.x * TBN, k0 = blockIdx.y * TBK;
  const long long m_begin = (long long)blockIdx.z * chunk;
  const long long m_end = m_begin + chunk < M ? m_begin + chunk : M;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 rg[2], ra[2];
  auto load = [&](long long m0) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * 128;
      const int r = idx >> 3, c = (idx & 7) * 8;
      const long long gm = m0 + r;
      const bool in = gm < m_end;
      rg[v] = (in && n0 + c < N)
                  ? *reinterpret_cast<const uint4*>(G + gm * N + n0 + c)
                  : make_uint4(0, 0, 0, 0);
      ra[v] = (in && k0 + c < K)
                  ? *reinterpret_cast<const uint4*>(A + gm * K + k0 + c)
                  : make_uint4(0, 0, 0, 0);
    }
  };

  if (m_begin < m_end) load(m_begin);
  for (long long m0 = m_begin; m0 < m_end; m0 += TBM) {
    __syncthreads();
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * 128;
      const int r = idx >> 3, c = (idx & 7) * 8;
      *reinterpret_cast<uint4*>(Gs + r * TLD + c) = rg[v];
      *reinterpret_cast<uint4*>(As + r * TLD + c) = ra[v];
    }
    __syncthreads();
    if (m0 + TBM < m_end) load(m0 + TBM);
#pragma unroll
    for (int kk = 0; kk < TBM; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], Gs + kk * TLD + wn * 32 + i * 16, TLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], As + kk * TLD + wk * 32 + j * 16, TLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  float* out = part + (long long)blockIdx.z * N * K;
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gn = n0 + wn * 32 + i * 16 + (e >> 4);
        const int gk = k0 + wk * 32 + j * 16 + (e & 15);
        if (gn < N && gk < K) out[(long long)gn * K + gk] = cs[e];
      }
      __syncwarp();
    }
  }
}

__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int parts,
                                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(long long)p * n + i];
  out[i] = s;
}

unsigned blocks_for(long long work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

}  // namespace

int launch_gather(const bf16* src, bf16* dst, long long rows,
                  const WinGeom& g, cudaStream_t stream) {
  if (g.C % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long work = rows * (g.C / 8);
  gather_rows_kernel<<<blocks_for(work, 256), 256, 0, stream>>>(src, dst,
                                                                rows, g);
  LRCE_CHECK_LAUNCH();
  return 0;
}

int launch_scale_rows(const bf16* in, bf16* out, const float* dp,
                      long long rows, int C, long long dp_rows,
                      cudaStream_t stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long work = rows * (C / 8);
  scale_rows_kernel<<<blocks_for(work, 256), 256, 0, stream>>>(
      in, out, dp, rows, C, dp_rows);
  LRCE_CHECK_LAUNCH();
  return 0;
}

int launch_sum_parts(const float* part, float* out, int parts, long long n,
                     cudaStream_t stream) {
  sum_parts_kernel<<<blocks_for(n, 256), 256, 0, stream>>>(part, out, parts,
                                                           n);
  LRCE_CHECK_LAUNCH();
  return 0;
}

int launch_gemm_tn(const bf16* G, const bf16* A, float* out, long long M,
                   int N, int K, int splits, float* ws, cudaStream_t stream) {
  if (N % 8 != 0 || K % 8 != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  long long chunk = (M + splits - 1) / splits;
  chunk = (chunk + TBM - 1) / TBM * TBM;
  dim3 grid((N + TBN - 1) / TBN, (K + TBK - 1) / TBK, splits);
  float* part = splits == 1 ? out : ws;
  gemm_tn_kernel<<<grid, 128, 0, stream>>>(G, A, part, M, N, K, chunk);
  LRCE_CHECK_LAUNCH();
  if (splits == 1) return 0;
  return launch_sum_parts(ws, out, splits, (long long)N * K, stream);
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
