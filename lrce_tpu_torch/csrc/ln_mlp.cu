// K7: the LayerNorm + MLP + residual half of a transformer block on (T, C)
// bf16 rows,
//   out = x + dp * fc2(gelu(fc1(LN(x)))),
// as one persistent launch, at any C <= 1024 with C % 64 == 0 and FF %
// 128 == 0, with a per-sample multiplier dp (or none): the stage-3 route of
// the Swin tower (C = 1024, FF = 4096), and K8's kernel at the widths its
// one-CTA core (back_half.cu) does not take.
//
// Replaces the TPU kernel _ln_mlp_kernel / _ln_mlp_fwd_impl
// (lrce_tpu/ops/pallas_swin_block.py), with its rounding points: LN in f32,
// rounded to bf16; fc1 accumulated in f32, + b1 in f32, exact-erf GELU in
// f32, the hidden rounded to bf16; fc2 accumulated in f32 over all of FF,
// + b2, x the row's dp, + x in f32, rounded once. The TPU kernel carries an
// f32 accumulator across its sequential FF grid axis; on the H100 at C =
// 1024 the fc2 accumulator of a 128-row block is 512 KB, beyond a CTA's
// registers, so the hidden goes through a device workspace read back from
// L2, and what carries over is one program with the card full at every T.
//
// One CTA per SM: the shared GEMM's roles (gemm_tile.cuh: one TMA producer
// thread, two consumer warpgroups on wgmma taking tasks in turns) and, in
// the producer's warpgroup, three LayerNorm warps.
//   - The LN warps take jobs of 2 rows from one global ticket, in row
//     order, and write z = bf16(LN(x)) to a workspace: LN runs beside the
//     products from the start. (As tasks of the consumers' work list it
//     gated every product, and a consumer running LN while the other ran
//     its main loop wedged the CTA now and then, in some ordering of the
//     two that was not found; a consumer holding the turn through its LN
//     did not.)
//   - The producer takes the work list's tasks from another ticket, in a
//     fixed order: the FF / 128 fc1 tiles of each row block (z . W1^T +
//     b1, the GELU on the accumulator registers, the bf16 hidden written
//     to the workspace) and, lag row blocks later in the list, its fc2
//     tasks, C / 128 column tiles x S slices of FF (hidden . W2^T over FF
//     / S). The lag (from ops/swin_block.ln_mlp_plan) puts two waves of
//     the card's consumers of fc1 work between a row block's fc1 and its
//     fc2: a producer whose next task still waits for its inputs holds its
//     whole CTA idle, and with fc2 right after fc1 (the first version)
//     the row blocks went through nearly one at a time (0.21 ms a call at
//     6 clips, tools/mlp_bench.py on an NVIDIA H100 80GB HBM3, 700.00 W).
//     The hidden of lag row blocks (17 MB at T = 7,056) stays in L2.
// A task waits only on a per-row-block counter raised by its row block's
// LN jobs (fc1) and by tasks earlier in the list (fc2: its fc1 tiles), and
// only a CTA that runs takes a ticket, so the earliest unfinished task can
// always finish: nothing deadlocks, whatever is resident. The producer
// waits (an acquire load) before it issues a task's copies; the writers
// order their stores before the count with a release, and the async-proxy
// fence on both sides orders the generic stores before the TMA loads that
// read them. With S > 1 the slices of a tile add up in slice order: slice
// s waits for slice s - 1's running sum (f32, in a workspace), adds its own
// product and stores the sum, and the last runs the epilogue on it: + b2, x
// the row's own sample dp (row / tokens_per_sample), + x in f32, rounded
// once. The adds happen in the same order however the slices' products
// finish, so runs are bitwise reproducible; the waits cost one load and
// store of a 128 x 128 f32 tile a slice. (With every slice storing a
// partial and the last to arrive reading all S back, that read was the
// longest step of a call at T = 882.) The warp
// that leaves last sets every counter back to zero for the next call.
//
// What bounds it on the H100: the two GEMMs, 4 T C FF operations (0.12 ms
// at T = 7,056, C = 1,024), then the GELU's FP32 issue. The work list
// lets fc2 of a row block start as soon as its fc1 tiles are done, and S
// (from ops/swin_block.ln_mlp_plan) fills the consumer slots where the row
// blocks x column tiles would leave them empty (6 clips: 7 x 8 tiles).
// The hidden of a row block (128 x FF bf16, 1 MB at FF = 4096) is written
// and read back while it is still in L2.
#include "swin_common.cuh"

#include "gemm_tile.cuh"
#include "hopper.cuh"

#include <stdint.h>

namespace lrce {
namespace {

#define LRCE_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

constexpr int LM_QUEUE = 4;   // task slots between producer and consumers
constexpr int LM_LN_WARPS = 3;  // the producer warpgroup's other warps
constexpr int LM_PRODUCER_REGS = 64, LM_CONSUMER_REGS = 224;
constexpr int LM_LN_JOB = 2;    // rows of an LN job (one warp)
constexpr int LM_LN_JOBS = GBM / LM_LN_JOB;  // LN jobs a row block
// counters (unsigned): task ticket, warps done, LN job ticket, then
// ready[row block] (LN jobs + fc1 tiles done), then progress[row
// block][column tile] (fc2 slices summed)
constexpr int LM_TICKET = 0, LM_DONE = 1, LM_LN_TICKET = 2, LM_READY = 3;
enum LmKind { LM_FC1 = 1, LM_FC2 = 2 };
constexpr size_t LM_SMEM =
    G_SMEM + 8 * 2 * LM_QUEUE + 8 * LM_QUEUE;  // + the task queue

struct LnMlpArgs {
  const bf16* x;
  bf16* out;
  bf16* z;        // (T, C) workspace
  bf16* hid;      // (T, FF) workspace
  float* part;    // (RB * 128, NCT * 128) f32 running sums, S > 1
  unsigned* cnt;  // 3 + RB + RB * NCT counters, zero at the launch
  const float* ln_s;
  const float* ln_b;
  const float* b1;
  const float* b2;
  const float* dp;
  long long T;
  int C, FF, tokens, rb, nf1, nct, splits, lag, ntasks;
  float eps;
  // fc1's (+ b1, GELU) and fc2's (+ b2, x dp, + x) epilogues, read from
  // the kernel's parameters rather than held in registers
  Epilogue e1, e2;
};

struct LmTask {
  int kind, rb, i, s;  // fc1: i = column tile; fc2: i = column tile, s =
};                     // slice

// Ticket t -> task: step i = 0, 1, ... holds the fc1 tiles of row block i
// (i < rb) and the fc2 tasks of row block i - lag (i >= lag): F = min(rb,
// lag) steps of fc1 alone, M = rb - F steps of both, then the fc2 tasks of
// the last F row blocks.
__device__ __forceinline__ LmTask lm_decode(const LnMlpArgs& p, int t) {
  const int nf2 = p.nct * p.splits;
  const int F = p.rb < p.lag ? p.rb : p.lag, M = p.rb - F;
  int rb2;  // the row block of an fc2 task
  if (t < F * p.nf1) return {LM_FC1, t / p.nf1, t % p.nf1, 0};
  t -= F * p.nf1;
  if (t < M * (p.nf1 + nf2)) {
    const int j = t / (p.nf1 + nf2), k = t % (p.nf1 + nf2);
    if (k < p.nf1) return {LM_FC1, F + j, k, 0};
    rb2 = j;
    t = k - p.nf1;
  } else {
    t -= M * (p.nf1 + nf2);
    rb2 = M + t / nf2;
    t %= nf2;
  }
  return {LM_FC2, rb2, t / p.splits, t % p.splits};
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* ptr) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(ptr)
               : "memory");
  return v;
}

// Generic-proxy accesses of this thread before, async-proxy (TMA) ones
// after, in every state space.
__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The consumer warpgroup's own barrier. bar.sync is the aligned form: every
// lane of a warp must reach it together, which a spin on an mbarrier or a
// lane-dependent branch before it does not promise, so the warp converges
// first.
__device__ __forceinline__ void lm_bar(int cw) {
  __syncwarp();
  named_bar_sync(1 + cw, 128);
}

// The warpgroup's stores are done: count them on *ctr (release), after
// the async-proxy fence that lets another CTA's TMA read them.
__device__ __forceinline__ void lm_publish(unsigned* ctr, int cw,
                                          bool leader) {
  fence_proxy_async_all();
  lm_bar(cw);
  if (leader) {
    __threadfence();
    atomicAdd(ctr, 1u);
  }
}

// A warp's last step: the last of the grid's 5 warps a CTA to leave sets
// the counters back to zero (every ticket and count of this launch has
// been taken by then).
__device__ __forceinline__ void lm_leave(const LnMlpArgs& p) {
  __threadfence();
  const unsigned done = atomicAdd(p.cnt + LM_DONE, 1u);
  if (done == (2u + LM_LN_WARPS) * gridDim.x - 1u) {
    __threadfence();
    const int n = LM_READY + p.rb + p.rb * p.nct;
    for (int i = 0; i < n; ++i) p.cnt[i] = 0u;
    __threadfence();
  }
}

// LN job: rows r0, r0 + 1 of x -> z by one warp (the rows' 16-byte loads
// all in flight); lane l holds the 8-element vectors l, l + 32, ... of a
// row (C <= 1024: at most four).
__device__ __forceinline__ void lm_ln(const LnMlpArgs& p, long long r0,
                                      int lane) {
  const int C = p.C, nv = C >> 3;
  const long long rw = r0;
  uint4 raw[LM_LN_JOB][4];
#pragma unroll
  for (int r = 0; r < LM_LN_JOB; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int vec = lane + 32 * i;
      raw[r][i] = make_uint4(0, 0, 0, 0);
      if (rw + r < p.T && vec < nv)
        raw[r][i] =
            *reinterpret_cast<const uint4*>(p.x + (rw + r) * C + vec * 8);
    }
#pragma unroll
  for (int r = 0; r < LM_LN_JOB; ++r) {
    float v[4][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load8(reinterpret_cast<const bf16*>(&raw[r][i]), v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[i][e];
    }
    const float mean = warp_sum(s) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (lane + 32 * i < nv)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[i][e] -= mean;
          q += v[i][e] * v[i][e];
        }
    const float rstd = rsqrtf(warp_sum(q) / (float)C + p.eps);
    if (rw + r >= p.T) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int vec = lane + 32 * i;
      if (vec < nv) {
        float gm[8], bt[8];
        load8(p.ln_s + vec * 8, gm);
        load8(p.ln_b + vec * 8, bt);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] = v[i][e] * rstd * gm[e] + bt[e];
        store8(p.z + (rw + r) * C + vec * 8, v[i]);
      }
    }
  }
}

__global__ void __launch_bounds__(G_THREADS, 1)
ln_mlp_kernel(const __grid_constant__ CUtensorMap tm_z,
              const __grid_constant__ CUtensorMap tm_w1,
              const __grid_constant__ CUtensorMap tm_hid,
              const __grid_constant__ CUtensorMap tm_w2,
              const __grid_constant__ LnMlpArgs p) {
  constexpr int MB = GBM / 64, STAGES = G_STAGES, SB = G_STAGE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* staging =
      reinterpret_cast<float*>(smem_raw + (base - raw) + STAGES * SB);
  const uint32_t full = base + STAGES * SB + G_STAGING_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t turn = empty + 8 * STAGES;  // turn[c]: consumer c's
  const uint32_t qfull = turn + 16, qempty = qfull + 8 * LM_QUEUE;
  // the task slots (ticket, first ring unit)
  int2* slot =
      reinterpret_cast<int2*>(smem_raw + (qempty + 8 * LM_QUEUE - raw));
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nk1 = p.C / GBK, nk2 = p.FF / GBK / p.splits;
  unsigned* ready = p.cnt + LM_READY;
  unsigned* progress = ready + p.rb;  // fc2 slices summed, per tile
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_init(turn, 1);
    mbar_init(turn + 8, 1);
    for (int q = 0; q < LM_QUEUE; ++q) {
      mbar_init(qfull + 8 * q, 1);
      mbar_init(qempty + 8 * q, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // registers: the producer's warpgroup (the TMA thread and the LN warps)
  // gives some to the consumers
  if (wg == 0)
    setmaxnreg_dec<LM_PRODUCER_REGS>();
  else
    setmaxnreg_inc<LM_CONSUMER_REGS>();
  if (wg == 0 && tid >= 32) {
    // ---- LN warps: jobs of 2 rows in row order, each counted on its
    // row block once its z rows are stored (after the async-proxy fence
    // that lets the fc1 tiles' TMA read them)
    const int lane = tid & 31;
    for (;;) {
      int job = 0;
      if (lane == 0) job = (int)atomicAdd(p.cnt + LM_LN_TICKET, 1u);
      job = __shfl_sync(0xffffffffu, job, 0);
      if (job >= p.rb * LM_LN_JOBS) break;
      lm_ln(p, (long long)job * LM_LN_JOB, lane);
      fence_proxy_async_all();
      __syncwarp();
      if (lane == 0) {
        __threadfence();
        atomicAdd(ready + job / LM_LN_JOBS, 1u);
      }
    }
    if (lane == 0) lm_leave(p);
    return;
  }
  if (wg == 0) {
    // ---- producer: one thread takes the tickets, waits for each task's
    // inputs, hands the task to the consumers and issues its copies
    if (tid != 0) return;
    int s = 0;
    uint32_t phase = 0;
    int u = 0;  // ring units issued so far
    for (int j = 0, stops = 0; stops < 2; ++j) {
      const int q = j % LM_QUEUE;
      mbar_wait(qempty + 8 * q, ((j / LM_QUEUE) & 1) ^ 1);
      const int t = stops ? p.ntasks : (int)atomicAdd(p.cnt + LM_TICKET, 1u);
      if (t >= p.ntasks) {  // one stop for each consumer
        slot[q] = make_int2(-1, 0);
        mbar_arrive(qfull + 8 * q);
        ++stops;
        continue;
      }
      const LmTask k = lm_decode(p, t);
      const unsigned need = LM_LN_JOBS + (k.kind == LM_FC2 ? p.nf1 : 0);
      for (unsigned ns = 64; ld_acquire(ready + k.rb) < need;) {
        __nanosleep(ns);
        if (ns < 1024) ns *= 2;
      }
      fence_proxy_async_all();
      slot[q] = make_int2(t, u);
      mbar_arrive(qfull + 8 * q);
      const int m0 = k.rb * GBM, n0 = k.i * GBN;
      if (k.kind == LM_FC1) {
        for (int kt = 0; kt < nk1; ++kt)
          gemm_load_kstep<false>(base, full, empty, s, phase, &tm_z, &tm_w1,
                                 kt * GBK, m0, n0);
        u += nk1;
      } else {
        const int k0 = k.s * nk2 * GBK;
        for (int kt = 0; kt < nk2; ++kt)
          gemm_load_kstep<false>(base, full, empty, s, phase, &tm_hid,
                                 &tm_w2, k0 + kt * GBK, m0, n0);
        u += nk2;
      }
    }
    return;
  }

  // ---- consumers: local tasks j = cw, cw + 2, ... in turns
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const bool leader = (tid & 127) == 0;
  float* st = staging + (cw * 4 + warp) * (16 * G_ST_LD);
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t tphase = cw == 0 ? 1 : 0;  // consumer 0 goes first
  const int pld = p.nct * GBN;  // the running sums' row length
  for (int j = cw;; j += 2) {
    const int q = j % LM_QUEUE;
    mbar_wait(qfull + 8 * q, (j / LM_QUEUE) & 1);
    const int2 sl = slot[q];
    lm_bar(cw);  // every thread has read the slot
    if (sl.x < 0) break;
    if (leader) mbar_arrive(qempty + 8 * q);
    const LmTask k = lm_decode(p, sl.x);
    mbar_wait(turn + 8 * cw, tphase);
    tphase ^= 1;
    __syncwarp();  // the lanes leave the spin together
    const long long m0 = (long long)k.rb * GBM;
    const int n0 = k.i * GBN;
    float acc[MB][64];
    if (k.kind == LM_FC1) {
      gemm_mainloop<false>(acc, base, full, empty, sl.y, nk1, leader,
                           turn + 8 * (1 - cw));
      gemm_epilogue<EPI_BIAS_GELU>(acc, st, p.hid, p.T, p.FF, m0, n0, p.e1,
                                   warp, lane);
      lm_publish(ready + k.rb, cw, leader);
      continue;
    }
    gemm_mainloop<false>(acc, base, full, empty, sl.y, nk2, leader,
                         turn + 8 * (1 - cw));
    if (p.splits > 1) {
      // the tile's running sum over FF, in slice order: slice s waits for
      // slices 0 .. s - 1, adds their sum to its own product and stores
      // it (or, the last, runs the epilogue on it); the same order of f32
      // adds whichever slice finishes its products first
      const int tile = k.rb * p.nct + k.i;
      float* sum = p.part + m0 * pld + n0;
      if (k.s > 0) {
        if (leader) {
          for (unsigned ns = 64; ld_acquire(progress + tile) < (unsigned)k.s;) {
            __nanosleep(ns);
            if (ns < 1024) ns *= 2;
          }
        }
        lm_bar(cw);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int j8 = 0; j8 < 16; ++j8)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float2 v = __ldcg(reinterpret_cast<const float2*>(
                  sum + (mb * 64 + warp * 16 + g + 8 * hf) * pld + 8 * j8 +
                  2 * t4));
              acc[mb][4 * j8 + 2 * hf] += v.x;
              acc[mb][4 * j8 + 2 * hf + 1] += v.y;
            }
      }
      if (k.s < p.splits - 1) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int j8 = 0; j8 < 16; ++j8)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              *reinterpret_cast<float2*>(
                  sum + (mb * 64 + warp * 16 + g + 8 * hf) * pld + 8 * j8 +
                  2 * t4) = make_float2(acc[mb][4 * j8 + 2 * hf],
                                        acc[mb][4 * j8 + 2 * hf + 1]);
        __threadfence();
        lm_bar(cw);
        if (leader) atomicAdd(progress + tile, 1u);
        continue;
      }
    }
    gemm_epilogue<EPI_MLP_OUT>(acc, st, p.out, p.T, p.C, m0, n0, p.e2,
                               warp, lane);
  }
  if (leader) lm_leave(p);
}

int launch_ln_mlp(const LnMlpArgs& a, const bf16* w1, const bf16* w2,
                  int grid, cudaStream_t stream) {
  static_assert(LM_SMEM <= kMaxSmem, "K7: shared memory");
  CUtensorMap tz, t1, th, t2;
  int rc = make_tmap(&tz, a.z, a.T, a.C, a.C, GBM);
  if (!rc) rc = make_tmap(&t1, w1, a.FF, a.C, a.C, GBN);
  if (!rc) rc = make_tmap(&th, a.hid, a.T, a.FF, a.FF, GBM);
  if (!rc) rc = make_tmap(&t2, w2, a.C, a.FF, a.FF, GBN);
  if (rc) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      ln_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)LM_SMEM);
  if (e != cudaSuccess) return (int)e;
  ln_mlp_kernel<<<grid, G_THREADS, LM_SMEM, stream>>>(tz, t1, th, t2, a);
  LRCE_CHECK_LAUNCH();
  return 0;
}

}  // namespace

}  // namespace lrce

extern "C" {

// K7 (and K8 at the widths back_half.cu does not take): x, out (T, C)
// bf16, out must not alias x; ln_s, ln_b (C), b1 (FF), b2 (C) f32; w1 (FF,
// C), w2 (C, FF) bf16 (nn.Linear layouts); dp2: (T / tokens_per_sample)
// f32 or null. C % 64 == 0, C <= 1024, FF % 128 == 0; splits: the fc2
// slices of FF, dividing FF / 64; lag: the fc1 row blocks ahead of a row
// block's fc2 in the work list; grid: CTAs, at most one per SM.
// Workspaces: ws_z (T, C) and ws_hid (T, FF) bf16; ws_part (ceil(T / 128)
// * 128, ceil(C / 128) * 128) f32 when splits > 1, else null; counters:
// 3 + R + R ceil(C / 128) unsigned ints for R = ceil(T / 128), all zero,
// and zero again when the kernel ends.
int lrce_ln_mlp_fwd(const void* x, void* out, int T, int C, int ff,
                    int tokens_per_sample, int splits, int lag, int grid,
                    float eps,
                    const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* w2, const void* b2,
                    const void* dp2, void* ws_z, void* ws_hid, void* ws_part,
                    void* counters, void* stream_ptr) {
  using namespace lrce;
  if (T < 1 || tokens_per_sample < 1 || T % tokens_per_sample != 0 ||
      C < 64 || C > 1024 || C % 64 != 0 || ff < 128 || ff % 128 != 0 ||
      splits < 1 || (ff / GBK) % splits != 0 || lag < 1 || grid < 1 ||
      (splits > 1 && !ws_part))
    return (int)cudaErrorInvalidValue;
  LnMlpArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.z = static_cast<bf16*>(ws_z);
  a.hid = static_cast<bf16*>(ws_hid);
  a.part = static_cast<float*>(ws_part);
  a.cnt = static_cast<unsigned*>(counters);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.dp = static_cast<const float*>(dp2);
  a.T = T;
  a.C = C;
  a.FF = ff;
  a.tokens = tokens_per_sample;
  a.rb = (T + GBM - 1) / GBM;
  a.nf1 = ff / GBN;
  a.nct = (C + GBN - 1) / GBN;
  a.splits = splits;
  a.lag = lag;
  a.ntasks = a.rb * (a.nf1 + a.nct * splits);
  a.eps = eps;
  a.e1.mode = EPI_BIAS_GELU;
  a.e1.bias = a.b1;
  a.e2.mode = EPI_MLP_OUT;
  a.e2.bias = a.b2;
  a.e2.dp = a.dp;
  a.e2.dp_rows = tokens_per_sample;
  a.e2.res = a.x;
  return launch_ln_mlp(a, static_cast<const bf16*>(w1),
                       static_cast<const bf16*>(w2), grid,
                       reinterpret_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
