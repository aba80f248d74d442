// Kernels (a) LN + window gather, (c) the bf16 wgmma GEMM with epilogues, (d)
// the split-K weight-gradient wgmma GEMM, and their launchers; (b), the
// window attention, is attn_fwd.cu's. See swin_common.cuh.
#include "swin_common.cuh"

#include "gemm_tile.cuh"
#include "hopper.cuh"

#include <cudaTypedefs.h>
#include <math.h>
#include <stdint.h>

#include <chrono>
#include <mutex>

namespace lrce {
namespace {

#define LRCE_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

// ---------------------------------------------------------------------------
// (a) LayerNorm over C (C % 8 == 0, C <= 1536), f32 math, bf16 out. kLanes
// lanes share a row (16 for C <= 128, two rows a warp; else 32) and each
// moves 16 bytes at a time: lane l holds the 8-element vectors l, l +
// kLanes, ... of its row (at most kVecs of them: 4 up to C = 1024, 6 for
// Video Swin-L's last stage, C = 1536, a separate instance so that the
// narrower rows keep their code), so a warp instruction reads or writes
// whole 256- or 512-byte row segments. gather != 0: output row r is window token r
// (win_row_to_token). Bound by bytes (each row read and written once): LN1 +
// gather of a stage-0 block at 48 clips (451,584 rows of 128) takes 0.17 ms
// and LN2 0.11 ms on an NVIDIA H100 80GB HBM3, 700.00 W, against a bound of
// 0.069 ms; with one warp a row and 2-byte accesses they took 0.45 and 0.31.
// ---------------------------------------------------------------------------
constexpr int LN_WARPS = 8;
constexpr int LN_MAX_VECS = 4;   // 8-element vectors a lane: C <= 1024
constexpr int LN_WIDE_VECS = 6;  // C <= 1536

template <int kLanes>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kLanes, int kVecs>
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
  float v[kVecs][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
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
  for (int i = 0; i < kVecs; ++i) {
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
  for (int i = 0; i < kVecs; ++i) {
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

namespace {

PFN_cuTensorMapEncodeTiled_v12000 tmap_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  });
  return fn;
}

int encode_tmap(CUtensorMap* map, const bf16* ptr, long long rows,
                long long cols, long long ld, int box_rows) {
  auto fn = tmap_encoder();
  if (!fn) return (int)cudaErrorNotSupported;
  if (((uintptr_t)ptr & 15) || (ld * 2) % 16 || box_rows < 1 ||
      box_rows > 256)
    return (int)cudaErrorInvalidValue;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<bf16*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

struct TmapEntry {
  const bf16* ptr;
  long long rows, cols, ld;
  int box_rows;
  CUtensorMap map;
};

}  // namespace

int make_tmap(CUtensorMap* map, const bf16* ptr, long long rows,
              long long cols, long long ld, int box_rows) {
  constexpr int kEntries = 32;
  static TmapEntry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const TmapEntry& e = cache[i];
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.ld == ld &&
        e.box_rows == box_rows) {
      *map = e.map;
      return 0;
    }
  }
  const int rc = encode_tmap(map, ptr, rows, cols, ld, box_rows);
  if (rc) return rc;
  cache[next] = TmapEntry{ptr, rows, cols, ld, box_rows, *map};
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return 0;
}

double tmap_encode_ns(int n) {
  bf16* probe = nullptr;  // the encoder takes device addresses only
  if (cudaMalloc(&probe, (size_t)(64 + n) * 64 * sizeof(bf16)) != cudaSuccess)
    return -1.0;
  CUtensorMap m;
  int rc = 0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n && !rc; ++i)
    rc = encode_tmap(&m, probe, 64 + i, 64, 64, 64);
  const auto t1 = std::chrono::steady_clock::now();
  cudaFree(probe);
  if (rc) return -1.0;
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / n;
}

int launch_ln(const bf16* x, bf16* out, const float* gamma, const float* beta,
              long long rows, float eps, const WinGeom& g, int gather,
              cudaStream_t stream) {
  if (g.C % 8 != 0 || g.C > 8 * 32 * LN_WIDE_VECS || rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + LN_WARPS - 1) / LN_WARPS);
  if (g.C <= 128) {
    const long long per = LN_WARPS * 2;
    ln_rows_kernel<16, LN_MAX_VECS>
        <<<(unsigned)((rows + per - 1) / per), LN_WARPS * 32, 0, stream>>>(
            x, out, gamma, beta, rows, eps, g, gather);
  } else if (g.C <= 8 * 32 * LN_MAX_VECS) {
    ln_rows_kernel<32, LN_MAX_VECS><<<blocks, LN_WARPS * 32, 0, stream>>>(
        x, out, gamma, beta, rows, eps, g, gather);
  } else {
    ln_rows_kernel<32, LN_WIDE_VECS><<<blocks, LN_WARPS * 32, 0, stream>>>(
        x, out, gamma, beta, rows, eps, g, gather);
  }
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
// A persistent, warp-specialised CTA (one per SM): one producer thread
// fills a ring of six 32 KB shared-memory stages with TMA copies (64-deep
// boxes of A's and of B's rows, stored with the 128-byte swizzle that
// wgmma reads, zeros past M, N, K) and two consumer warpgroups take whole
// 128 x 128 output tiles in turns (ping-pong). The epilogue leaves the
// registers through a per-warp f32 staging tile of its own (the ring is
// busy with the next tiles' loads by then), 32 columns at a time, so that
// every lane then owns 8 neighbouring columns of a row: bias, dp, residual
// and output move as 16-byte accesses and a warp instruction covers
// 64-byte row segments. Its global loads are latency-bound; ping-pong hides
// them under the other consumer's products. What was measured on the way
// (timed alone on an NVIDIA H100 80GB HBM3, 700.00 W): both on
// one 128-row tile ran 10-45% slower than the PR-4 kernel (cp.async by all
// 256 threads of two CTAs per SM, a CTA-wide barrier on every k-tile);
// 16-byte cp.async issued by a producer warpgroup of 128 threads instead
// of TMA took issue slots and L1 bandwidth from the consumers and was
// slower than the PR-4 kernel in every variant; a 64 x 256 consumer tile
// was slower than 128 x 128 at every shape. The two tensor maps of a call
// are encoded on the host (make_tmap, 126 ns each) and kept by pointer and
// shape. The split-K weight-gradient GEMM keeps cp.async: its chunks end
// inside the tensor, where TMA's zero fill does not apply.
// Requires K % 8 == 0 and N % 8 == 0.
// ---------------------------------------------------------------------------
// The pieces (epilogue8, the constants, the producer's k-step, the
// consumer's main loop and epilogue) are in gemm_tile.cuh, which K7's
// persistent kernel (ln_mlp.cu) shares.
// One CTA per SM walks output tiles j = 0, 1, ... (tile blockIdx.x + j
// gridDim.x; the column tiles of a row block side by side, so that
// neighbouring CTAs share A's rows in L2). Warpgroup 0 is the producer:
// one of its threads issues the TMA copies of the A and B tiles of every
// k-step of every tile, in that order, into a ring of G_STAGES stages,
// after waiting on the stage's `empty` mbarrier; the copies complete on
// its `full` mbarrier. Warpgroups 1 and 2 are the consumers, ping-pong:
// consumer c takes tiles j = c, c + 2, ..., the whole 128 x 128 tile (two
// m64 blocks, 128 accumulator registers a thread); it keeps one wgmma
// group in flight across k-steps and releases a stage once the group after
// it is issued. The two take turns at their main loops (an mbarrier each,
// passed on once a warpgroup has issued its last k-step), so that one's
// epilogue runs while the other's products keep the tensor cores busy,
// and so that every stage is waited for in the order it was filled (the
// parity of a wait names the right fill). No CTA-wide barrier runs after
// the set-up. setmaxnreg moves registers from the producer (40) to the
// consumers (232).
template <int kMode, bool kBkn>
__global__ void __launch_bounds__(G_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                  const __grid_constant__ CUtensorMap tmB,
                  bf16* __restrict__ out, long long M, int N, int K,
                  Epilogue ep) {
  constexpr int MB = GBM / 64, STAGES = G_STAGES, SB = G_STAGE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* staging =
      reinterpret_cast<float*>(smem_raw + (base - raw) + STAGES * SB);
  const uint32_t full = base + STAGES * SB + G_STAGING_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t turn = empty + 8 * STAGES;  // turn[c]: consumer c's
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n_tiles = (N + GBN - 1) / GBN;
  const long long tiles = (M + GBM - 1) / GBM * n_tiles;
  const int nk = (K + GBK - 1) / GBK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_init(turn, 1);
    mbar_init(turn + 8, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues the TMA copies of every stage ----
    setmaxnreg_dec<G_PRODUCER_REGS>();
    if (tid != 0) return;
    int s = 0;
    uint32_t phase = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (int)(tile / n_tiles * GBM);
      const int n0 = (int)(tile % n_tiles) * GBN;
      for (int kt = 0; kt < nk; ++kt)
        gemm_load_kstep<kBkn>(base, full, empty, s, phase, &tmA, &tmB,
                              kt * GBK, m0, n0);
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<G_CONSUMER_REGS>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const bool leader = (tid & 127) == 0;
  float* st = staging + (cw * 4 + warp) * (16 * G_ST_LD);
  uint32_t tphase = cw == 0 ? 1 : 0;  // consumer 0 goes first
  long long j = cw;
  for (long long tile = blockIdx.x + cw * (long long)gridDim.x; tile < tiles;
       tile += 2LL * gridDim.x, j += 2) {
    const long long m0 = tile / n_tiles * GBM;
    const int n0 = (int)(tile % n_tiles) * GBN;
    float acc[MB][64];
    mbar_wait(turn + 8 * cw, tphase);
    tphase ^= 1;
    // the ring unit of (tile, k-step 0) is j * nk
    gemm_mainloop<kBkn>(acc, base, full, empty, j * nk, nk, leader,
                        turn + 8 * (1 - cw));
    gemm_epilogue<kMode>(acc, st, out, M, N, m0, n0, ep, warp, lane);
  }
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
  static_assert(G_SMEM <= kMaxSmem, "GEMM: shared memory");
  if (M >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap tmA, tmB;
  int rc = make_tmap(&tmA, A, M, K, K, GBM);
  if (!rc)
    rc = kBkn ? make_tmap(&tmB, Bm, K, N, N, 64)
              : make_tmap(&tmB, Bm, N, K, K, GBN);
  if (rc) return rc;
  cudaError_t ea = cudaFuncSetAttribute(
      gemm_wgmma_kernel<kMode, kBkn>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G_SMEM);
  if (ea != cudaSuccess) return (int)ea;
  const long long tiles =
      (long long)((N + GBN - 1) / GBN) * ((M + GBM - 1) / GBM);
  const unsigned grid =
      (unsigned)(tiles < sm_count() ? tiles : (long long)sm_count());
  gemm_wgmma_kernel<kMode, kBkn><<<grid, G_THREADS, G_SMEM, stream>>>(
      tmA, tmB, out, M, N, K, ep);
  LRCE_CHECK_LAUNCH();
  return 0;
}

}  // namespace

int launch_gemm(const bf16* A, const bf16* Bm, bf16* out, long long M, int N,
                int K, const Epilogue& ep, cudaStream_t stream, bool b_kn) {
  if (K % 8 != 0 || N % 8 != 0 || M < 1 || K < 8)
    return (int)cudaErrorInvalidValue;
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
  if (g.C % 8 != 0 || rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
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
