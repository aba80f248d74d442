// Kernels (a) LN + window gather, (b) window attention for the shapes that
// attn_fwd.cu does not take, (c) the bf16 wgmma GEMM with epilogues, (d) the
// split-K weight-gradient wgmma GEMM, and their launchers; see
// swin_common.cuh.
#include "swin_common.cuh"

#include "hopper.cuh"

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
// (a) LayerNorm over C (C % 8 == 0, C <= 1024), f32 math, bf16 out. kLanes
// lanes share a row (16 for C <= 128, two rows a warp; else 32) and each
// moves 16 bytes at a time: lane l holds the 8-element vectors l, l +
// kLanes, ... of its row, so a warp instruction reads or writes whole
// 256- or 512-byte row segments. gather != 0: output row r is window token r
// (win_row_to_token). Bound by bytes (each row read and written once): LN1 +
// gather of a stage-0 block at 48 clips (451,584 rows of 128) takes 0.17 ms
// and LN2 0.11 ms on an NVIDIA H100 80GB HBM3, 700.00 W, against a bound of
// 0.069 ms; with one warp a row and 2-byte accesses they took 0.45 and 0.31.
// ---------------------------------------------------------------------------
constexpr int LN_WARPS = 8;
constexpr int LN_MAX_VECS = 4;  // 8-element vectors a lane: C <= 1024

template <int kLanes>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kLanes>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_rows_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               long long rows, float eps, WinGeom g, int gather) {
  constexpr int kRows = 32 / kLanes;  // rows a warp
  const int lane = threadIdx.x & 31, l = lane % kLanes;
  const long long row =
      ((long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5)) * kRows +
      lane / kLanes;
  const bool live = row < rows;  // every lane stays for the shuffles
  const int C = g.C;
  const int nv = C >> 3;
  const long long src = !live ? 0 : gather ? win_row_to_token(g, row) : row;
  const bf16* xr = x + src * C;
  float v[LN_MAX_VECS][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_VECS; ++i) {
    const int vec = l + kLanes * i;
    if (live && vec < nv) {
      load8(xr + vec * 8, v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[i][e];
    }
  }
  const float mean = lanes_sum<kLanes>(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_VECS; ++i) {
    if (live && l + kLanes * i < nv) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] -= mean;
        q += v[i][e] * v[i][e];
      }
    }
  }
  const float rstd = rsqrtf(lanes_sum<kLanes>(q) / (float)C + eps);
  bf16* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < LN_MAX_VECS; ++i) {
    const int vec = l + kLanes * i;
    if (live && vec < nv) {
      float gm[8], bt[8];
      load8(gamma + vec * 8, gm);
      load8(beta + vec * 8, bt);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = v[i][e] * rstd * gm[e] + bt[e];
      store8(orow + vec * 8, v[i]);
    }
  }
}

}  // namespace

int launch_ln(const bf16* x, bf16* out, const float* gamma, const float* beta,
              long long rows, float eps, const WinGeom& g, int gather,
              cudaStream_t stream) {
  if (g.C % 8 != 0 || g.C > 8 * 32 * LN_MAX_VECS)
    return (int)cudaErrorInvalidValue;
  if (g.C <= 128) {
    const long long per = LN_WARPS * 2;
    ln_rows_kernel<16><<<(unsigned)((rows + per - 1) / per), LN_WARPS * 32, 0,
                         stream>>>(x, out, gamma, beta, rows, eps, g, gather);
  } else {
    ln_rows_kernel<32><<<(unsigned)((rows + LN_WARPS - 1) / LN_WARPS),
                         LN_WARPS * 32, 0, stream>>>(x, out, gamma, beta, rows,
                                                     eps, g, gather);
  }
  LRCE_CHECK_LAUNCH();
  return 0;
}

namespace {

// ---------------------------------------------------------------------------
// (b) Window attention for any head_dim that is a multiple of 16 and any
// window whose tiles fit shared memory (head_dim 16 or 32 with at most 160
// tokens runs attn_fwd_kernel of attn_fwd.cu instead: launch_attn chooses).
// qkv: (nwin_total*N, 3C) bf16 in window order, packed
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

int launch_attn_wmma(const bf16* qkv, bf16* ctx, const float* rel_bias,
                     const float* mask, long long nwin_total, int nwin_clip,
                     int N, int C, int num_heads, cudaStream_t stream) {
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
// (c) GEMM: out = epilogue(A (M x K, row-major) . B), bf16 in, f32
// accumulate in registers through wgmma (m64n128k16). B is either W (N x K,
// row-major, the nn.Linear layout: out = A . W^T) or, with kBkn, a (K x N)
// row-major matrix read in place (out = A . B: the products of the backward
// passes that used to need a transposed copy of the weight).
// Two warpgroups of 64 rows each, k-tile 64, a ring of shared-memory stages
// filled by cp.async ahead of the tensor cores, tiles stored with the
// 128-byte swizzle (hopper.cuh), rows or columns beyond M, N, K zero-filled.
// Two tile shapes:
//   128 x 128, three stages (32 KB each), two CTAs per SM, so one CTA's
//     epilogue runs under the other's main loop: for the shapes that the
//     output's bytes bound (K = 128 or 256 at stages 0 and 1);
//   128 x 256, four stages (48 KB each), one CTA per SM, two accumulators a
//     warpgroup: a 128 x 128 tile needs 32 KB from L2 for every 2.1 MFLOP,
//     more than L2 delivers at the tensor cores' rate (measured: 29% of the
//     bf16 peak at stage 2 on an NVIDIA H100 80GB HBM3, 700.00 W); the wide
//     tile needs 48 KB for twice the work.
// The epilogue leaves the registers through a per-warp f32 staging tile in
// the (by then idle) ring, so that every lane then owns 8 neighbouring
// columns of a row: bias, dp, residual and output move as 16-byte accesses
// and a warp instruction covers whole 256-byte row segments.
// cp.async and not TMA: a tensor map has to be encoded on the host for
// every operand of every call (the workspaces are new allocations each
// time), about 25 encodes per K4 + K5 pair on a train step that is already
// bound by the host, and the split-K kernel's chunks end inside the tensor,
// where TMA's out-of-bounds fill does not apply; 16-byte cp.async with
// zero-fill does both on the device.
// Requires K % 8 == 0 and N % 8 == 0.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float gelu_erf(float a) {
  return a * 0.5f * (1.f + erff(a * 0.70710678118654752f));
}

// The epilogue for columns n .. n + 7 of accumulator row m (dst: its output
// row, scattered for EPI_ATTN_OUT). The mode is a template argument, so
// each GEMM instantiation carries only its own epilogue.
template <int kMode>
__device__ __forceinline__ void epilogue8(const Epilogue& ep, bf16* out,
                                          long long m, long long dst, int n,
                                          int ldc, float (&a)[8]) {
  if (ep.bias) {
    float b[8];
    load8(ep.bias + n, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] += b[i];
  }
  bf16* o = out + dst * ldc + n;
  if constexpr (kMode == EPI_BIAS) {
    store8(o, a);
  } else if constexpr (kMode == EPI_BIAS_GELU) {
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = gelu_erf(a[i]);
    store8(o, a);
  } else {
    if (ep.dp) {
      const float k = ep.dp[m / ep.dp_rows];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] *= k;
    }
    if constexpr (kMode == EPI_ATTN_OUT) {
      // the product rounds to bf16 first, the residual is a bf16 add
      if (ep.res) {
        float r[8];
        load8(ep.res + dst * ldc + n, r);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = __bfloat162float(__float2bfloat16(a[i])) + r[i];
      }
    } else {  // EPI_MLP_OUT: the residual is added in f32
      float r[8];
      load8(ep.res + dst * ldc + n, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] += r[i];
    }
    store8(o, a);
  }
}

constexpr int GBM = 128, GBK = 64;
constexpr int G_A_BYTES = GBM * 128;  // 128 rows of 64 bf16
__host__ __device__ constexpr int gemm_stages(int bn) { return bn == 128 ? 3 : 4; }
__host__ __device__ constexpr int gemm_stage_bytes(int bn) { return G_A_BYTES + bn * 128; }
constexpr size_t gemm_smem(int bn) {
  return (size_t)gemm_stages(bn) * gemm_stage_bytes(bn) + 1024;
}

template <int kMode, bool kBkn, int BN>
__global__ void __launch_bounds__(256, BN == 128 ? 2 : 1)
gemm_wgmma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                  bf16* __restrict__ out, long long M, int N, int K,
                  Epilogue ep) {
  constexpr int STAGES = gemm_stages(BN), SB = gemm_stage_bytes(BN);
  constexpr int NACC = BN / 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const long long m0 = (long long)blockIdx.y * GBM;
  const int nk = (K + GBK - 1) / GBK;

  float acc[NACC][64];
#pragma unroll
  for (int h = 0; h < NACC; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

  auto load = [&](int kt, int s) {
    const uint32_t sa = base + s * SB, sb = sa + G_A_BYTES;
    const int c = tid & 7, r0 = tid >> 3;
    const int gk = kt * GBK + c * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 32 * i;
      const long long gm = m0 + r;
      const bool ok = gm < M && gk < K;
      cp_async16(sa + swz128(r, c), ok ? A + gm * K + gk : A, ok);
    }
    if constexpr (!kBkn) {
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int r = r0 + 32 * i;
        const int gn = n0 + r;
        const bool ok = gn < N && gk < K;
        cp_async16(sb + swz128(r, c), ok ? Bm + (long long)gn * K + gk : Bm,
                   ok);
      }
    } else {
      // 64 rows of the reduction x BN columns: blocks of 64 columns, 8 KB
      // each, rows of 128 bytes
      constexpr int CPR = BN / 8;  // 16-byte chunks per row
      const int cc = tid % CPR, q0 = tid / CPR;
      const int gn = n0 + cc * 8;
#pragma unroll
      for (int i = 0; i < 64 * CPR / 256; ++i) {
        const int kr = q0 + (256 / CPR) * i;
        const int gkk = kt * GBK + kr;
        const bool ok = gkk < K && gn < N;
        cp_async16(sb + (cc >> 3) * 8192 + swz128(kr, cc & 7),
                   ok ? Bm + (long long)gkk * N + gn : Bm, ok);
      }
    }
  };

  // KEEP wgmma groups stay in flight across the barrier (the wide tile: the
  // tensor cores never drain between k-tiles); the copies run AHEAD tiles
  // ahead, into the stage whose last reader every warp is known to have
  // waited for before the barrier.
  constexpr int KEEP = BN == 128 ? 0 : 1, AHEAD = STAGES - 1 - KEEP;
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<AHEAD - 1>();  // tile kt has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread, and tile kt-1-KEEP is consumed
    if (kt + AHEAD < nk) load(kt + AHEAD, (kt + AHEAD) % STAGES);
    cp_async_commit();
    const uint32_t sa = base + (kt % STAGES) * SB + wg * 8192;
    const uint32_t sb = base + (kt % STAGES) * SB + G_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < GBK / 16; ++ks) {
      const uint64_t da = wgmma_desc(sa + ks * 32, 16, 1024);
#pragma unroll
      for (int h = 0; h < NACC; ++h) {
        const uint64_t db =
            kBkn ? wgmma_desc(sb + h * 16384 + ks * 2048, 8192, 1024)
                 : wgmma_desc(sb + h * 16384 + ks * 32, 16, 1024);
        wgmma_m64n128k16<0, kBkn ? 1 : 0>(acc[h], da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<KEEP>();
  }

  // epilogue through this warp's staging tile in the idle ring
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                       (tid >> 5) * STAGE_WARP_BYTES);
  const int cc = lane & 15, rsel = lane >> 4;
#pragma unroll
  for (int h = 0; h < NACC; ++h) {
    stage_acc(st, acc[h], lane);
    __syncwarp();
    const int n = n0 + h * 128 + 8 * cc;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int row = 2 * it + rsel;
      const long long gm = m0 + wg * 64 + warp * 16 + row;
      if (gm < M && n < N) {
        float v[8];
        load8(st + row * STAGE_LD + 8 * cc, v);
        long long dst = gm;
        if constexpr (kMode == EPI_ATTN_OUT)
          if (ep.scatter) dst = win_row_to_token(ep.g, gm);
        epilogue8<kMode>(ep, out, gm, dst, n, N, v);
      }
    }
    __syncwarp();
  }
}

template <int kMode, bool kBkn, int BN>
int launch_gemm_as(const bf16* A, const bf16* Bm, bf16* out, long long M,
                   int N, int K, const Epilogue& ep, cudaStream_t stream) {
  cudaError_t ea = cudaFuncSetAttribute(
      gemm_wgmma_kernel<kMode, kBkn, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gemm_smem(BN));
  if (ea != cudaSuccess) return (int)ea;
  dim3 grid((N + BN - 1) / BN, (unsigned)((M + GBM - 1) / GBM));
  gemm_wgmma_kernel<kMode, kBkn, BN><<<grid, 256, gemm_smem(BN), stream>>>(
      A, Bm, out, M, N, K, ep);
  LRCE_CHECK_LAUNCH();
  return 0;
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <int kMode, bool kBkn>
int launch_gemm_mode(const bf16* A, const bf16* Bm, bf16* out, long long M,
                     int N, int K, const Epilogue& ep, cudaStream_t stream) {
  if (gemm_wide_tile(M, N, K, sm_count()))
    return launch_gemm_as<kMode, kBkn, 256>(A, Bm, out, M, N, K, ep, stream);
  return launch_gemm_as<kMode, kBkn, 128>(A, Bm, out, M, N, K, ep, stream);
}

}  // namespace

// The 128 x 256 tile where the tensor cores bound the product and the wide
// tiles still fill the card.
bool gemm_wide_tile(long long M, int N, int K, int sms) {
  return N % 256 == 0 && K >= 512 && (M + GBM - 1) / GBM * (N / 256) >= sms;
}

int launch_gemm(const bf16* A, const bf16* Bm, bf16* out, long long M, int N,
                int K, const Epilogue& ep, cudaStream_t stream, bool b_kn) {
  if (K % 8 != 0 || N % 8 != 0 || M < 1) return (int)cudaErrorInvalidValue;
  if (b_kn) {
    if (ep.mode != EPI_ATTN_OUT) return (int)cudaErrorInvalidValue;
    return launch_gemm_mode<EPI_ATTN_OUT, true>(A, Bm, out, M, N, K, ep,
                                                stream);
  }
  switch (ep.mode) {
    case EPI_BIAS:
      return launch_gemm_mode<EPI_BIAS, false>(A, Bm, out, M, N, K, ep,
                                               stream);
    case EPI_BIAS_GELU:
      return launch_gemm_mode<EPI_BIAS_GELU, false>(A, Bm, out, M, N, K, ep,
                                                    stream);
    case EPI_ATTN_OUT:
      return launch_gemm_mode<EPI_ATTN_OUT, false>(A, Bm, out, M, N, K, ep,
                                                   stream);
    case EPI_MLP_OUT:
      return launch_gemm_mode<EPI_MLP_OUT, false>(A, Bm, out, M, N, K, ep,
                                                  stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
// (d) Weight-gradient GEMM: part[s] (N x K) = G[m in chunk s]^T . A[same m],
// f32. Both operands lie in device memory with the reduction axis (the
// tokens) first; their tiles are copied as they lie (64 tokens x 128
// columns, cp.async, three stages) and wgmma reads both across the rows
// (the transpose bits), so nothing is transposed anywhere. CTA tile 128 x
// 128 of the output, two warpgroups of 64 output rows, two CTAs per SM, one
// chunk of the tokens per blockIdx.z; rows past the chunk's end are
// zero-filled. (A 128 x 256 tile with one CTA per SM measured 10-20% slower
// at stages 2 and 3 on an NVIDIA H100 80GB HBM3, 700.00 W: the loop is bound
// by the latency of a step, which a second resident CTA hides better than a
// wider tile.)
// ---------------------------------------------------------------------------
constexpr int TBN = 128, TBK = 128, TBM = 64, TSTAGES = 3;
constexpr int T_STAGE_BYTES = 2 * TBM * 256;  // G tile + A tile
constexpr size_t T_SMEM = (size_t)TSTAGES * T_STAGE_BYTES + 1024;

__global__ void __launch_bounds__(256, 2)
gemm_tn_wgmma_kernel(const bf16* __restrict__ G, const bf16* __restrict__ A,
                     float* __restrict__ part, long long M, int N, int K,
                     long long chunk) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = blockIdx.x * TBN, k0 = blockIdx.y * TBK;
  const long long m_begin = (long long)blockIdx.z * chunk;
  const long long m_end = m_begin + chunk < M ? m_begin + chunk : M;
  const int steps =
      m_end > m_begin ? (int)((m_end - m_begin + TBM - 1) / TBM) : 0;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  auto load = [&](int step, int s) {
    const uint32_t sg = base + s * T_STAGE_BYTES, sa = sg + TBM * 256;
    const int c16 = tid & 15, q0 = tid >> 4;
    const int gn = n0 + c16 * 8, gk = k0 + c16 * 8;
    const uint32_t off = (c16 >> 3) * 8192;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 16 * i;
      const long long gm = m_begin + (long long)step * TBM + r;
      const bool in = gm < m_end;
      const uint32_t o = off + swz128(r, c16 & 7);
      cp_async16(sg + o, in && gn < N ? G + gm * N + gn : G, in && gn < N);
      cp_async16(sa + o, in && gk < K ? A + gm * K + gk : A, in && gk < K);
    }
  };

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<TSTAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    if (st + TSTAGES - 1 < steps)
      load(st + TSTAGES - 1, (st + TSTAGES - 1) % TSTAGES);
    cp_async_commit();
    const uint32_t sg = base + (st % TSTAGES) * T_STAGE_BYTES + wg * 8192;
    const uint32_t sa = base + (st % TSTAGES) * T_STAGE_BYTES + TBM * 256;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TBM / 16; ++ks)
      wgmma_m64n128k16<1, 1>(acc, wgmma_desc(sg + ks * 2048, 8192, 1024),
                             wgmma_desc(sa + ks * 2048, 8192, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }

  float* out = part + (long long)blockIdx.z * N * K;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gn = n0 + wg * 64 + warp * 16 + g + half * 8;
    if (gn >= N) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gk = k0 + 8 * j + 2 * t;
      if (gk < K)
        *reinterpret_cast<float2*>(out + (long long)gn * K + gk) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// out[i] = sum of part[p * n + i] over p in a fixed order: thread row s of
// the block adds parts s, s + 8, ... in order, then the eight sums are added
// in order.
__global__ void __launch_bounds__(256)
sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                 int parts, long long n) {
  __shared__ float sm[8][32];
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * 32 + lane;
  float v = 0.f;
  if (i < n)
    for (int p = s; p < parts; p += 8) v += part[(long long)p * n + i];
  sm[s][lane] = v;
  __syncthreads();
  if (s == 0 && i < n) {
#pragma unroll
    for (int q = 1; q < 8; ++q) v += sm[q][lane];
    out[i] = v;
  }
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
  sum_parts_kernel<<<blocks_for(n, 32), 256, 0, stream>>>(part, out, parts,
                                                          n);
  LRCE_CHECK_LAUNCH();
  return 0;
}

int launch_gemm_tn(const bf16* G, const bf16* A, float* out, long long M,
                   int N, int K, int splits, float* ws, cudaStream_t stream) {
  if (N % 8 != 0 || K % 8 != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaError_t ea = cudaFuncSetAttribute(
      gemm_tn_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T_SMEM);
  if (ea != cudaSuccess) return (int)ea;
  long long chunk = (M + splits - 1) / splits;
  chunk = (chunk + TBM - 1) / TBM * TBM;
  dim3 grid((N + TBN - 1) / TBN, (K + TBK - 1) / TBK, splits);
  float* part = splits == 1 ? out : ws;
  gemm_tn_wgmma_kernel<<<grid, 256, T_SMEM, stream>>>(G, A, part, M, N, K,
                                                      chunk);
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
// order) in ws_tc. Shared by K1/K3, K2 and K6.
int attention_front(const bf16* x, const WinGeom& g, int num_heads, float eps,
                    const float* ln_s, const float* ln_b, const bf16* qkv_w,
                    const float* qkv_b, const float* rel_bias,
                    const float* mask, const int* mask_labels,
                    const float* mask_off, int groups, bf16* ws_tc,
                    bf16* ws_qkv, cudaStream_t stream) {
  const long long T = (long long)g.B * g.D * g.H * g.W;
  int rc = launch_ln(x, ws_tc, ln_s, ln_b, T, eps, g, 1, stream);
  if (rc) return rc;
  rc = launch_gemm(ws_tc, qkv_w, ws_qkv, T, 3 * g.C, g.C, epi_bias(qkv_b),
                   stream);
  if (rc) return rc;
  const long long nwin_clip = (long long)g.nd * g.nh * g.nw;
  return launch_attn(ws_qkv, ws_tc, rel_bias, mask, mask_labels, mask_off,
                     T / g.N, (int)nwin_clip, g.N, g.C, num_heads, groups,
                     stream);
}


}  // namespace lrce
