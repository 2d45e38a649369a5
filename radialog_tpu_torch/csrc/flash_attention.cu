// Causal, length-masked attention forward with an online softmax (flash
// attention), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel radialog_tpu/ops/flash_attention.py
// `_fwd_kernel` (called through `_fwd_call` / `_flash_attention_jit`), the
// forward only. The math is the TPU kernel's, not its blocking:
//   s = (q . k summed in f32) * scale; key j of lane b is valid for query i
//       iff j < min(len[b], S) and, when causal, j <= i; invalid -> -1e30
//   online softmax in f32 over key tiles in order; p is rounded to the
//   input dtype before p @ v (the TPU kernel's p.astype(v.dtype)), f32 sums
//   out = acc / max(l, 1e-30) in the input dtype; lse = m + log(l)
//   a lane of length 0 (no valid key, l = 0) emits zeros and lse = 1e30
// q is (B,T,H,D), k/v (B,S,H,D), read through their batch, token and head
// strides (last dim dense, rows 16-byte aligned); out is dense (B,T,H,D)
// and lse (B,H,T).
//
// What bounds it on an H100: a prefill of T = S = 448 with H = 32, D = 128
// does 4*H*D*T^2/2 ~ 1.6 GFLOP on 14.7 MB of q, k, v and out, about 110
// operations per byte, below the 295 at which the bf16 tensor cores and not
// the memory would be the limit; so the least time is the bytes'. At these
// sizes (a few MB, a few hundred blocks) what a kernel actually waits on is
// the latency of its loads and of its two products per key tile, so the
// design keeps both in flight and off the threads' instruction stream:
//   * bf16 with D in {64, 128} (fwd_tma, FlashAttention-3 in shape): a
//     block of 128 query rows for one (head, lane): two consumer warpgroups
//     of 64 rows and one producer warp whose lane 0 loads Q once and K/V
//     tiles of 128 keys into a 2-stage mbarrier ring with TMA. The maps are
//     4-D {D, H, rows, B} over the strided views (the fused projection's
//     q/k/v need no copy); rows past T or S arrive as zeros. S = Q.K^T is
//     wgmma m64n128k16 from shared memory (both K-major, 128-byte swizzle);
//     the online softmax runs in registers in log2 units (exp2f on scores
//     prescaled by scale * log2 e), masking element by element only the
//     tiles that cross the length or this warpgroup's diagonal; P, rounded
//     to bf16, goes from the accumulator to wgmma's A registers (the same
//     fragment order as FA2's trick) and O += P.V is a second wgmma with V
//     MN-major from shared memory (the transpose bit). Key tiles past
//     min(len, last query row + 1) are never loaded; a warpgroup whose rows
//     all precede a tile skips its products. 128-row blocks give the qa
//     prefix (B=1, T=431, H=32) 128 blocks, one wave on 132 SMs, and share
//     each K/V tile between two warpgroups; the last query tiles (the most
//     keys) are started first. No setmaxnreg: ptxas fits the 288-thread
//     block in 168 registers a thread (D = 128 spills 96 bytes).
//   * bf16 at other head dims (the mock's D = 16), fwd_bf16, the first
//     kernel of this file: 4 warps per 64-query tile, cp.async K/V tiles in shared
//     memory, mma.sync m16n8k16;
//   * f32 (the mock's FP32 policy), fwd_f32: 4 threads per query row split
//     D, with plain FMA loops over 32-key tiles in shared memory (no TF32).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // key rows per tile, bf16
constexpr int BK32 = 32;            // key rows per tile, f32
constexpr int THREADS_BF16 = 128;   // 4 warps x 16 query rows
constexpr int THREADS_F32 = 256;    // 64 query rows x 4 threads
constexpr float NEG_INF = -1e30f;
constexpr float LSE_DEAD = 1e30f;

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = valid ? 16 : 0;                        // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layout of mma m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A 16x16: a[0] rows g, cols 2t..2t+1; a[1] row g+8; a[2] row g, cols
//            2t+8..; a[3] row g+8, cols 2t+8..
//   B 16x8:  b0 rows (k) 2t..2t+1, col (n) g; b1 rows 2t+8.., col g
//   C 16x8:  c[0..1] row g, cols 2t..2t+1; c[2..3] row g+8
template <int D>
__global__ void __launch_bounds__(THREADS_BF16)
fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
         __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int S, int H,
         Strides qs, Strides ks, Strides vs, int causal, float scale) {
  constexpr int KS = D / 16;        // k-steps over D for q.k^T
  constexpr int NT = D / 8;         // n8 tiles over D for p @ v
  constexpr int LDS = D + 8;        // shared row stride in values (16-byte multiple)
  __shared__ __align__(16) __nv_bfloat16 k_tile[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_tile[BK * LDS];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int len = min(lengths[b], S);
  const int kend = causal ? min(len, q0 + BQ) : len;   // keys that can be valid
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;       // this thread's two rows

  uint32_t qa[KS][4];
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
#pragma unroll
  for (int kd = 0; kd < KS; ++kd) {
    const int c = kd * 16 + t4 * 2;
    qa[kd][0] = r0 < T ? *reinterpret_cast<const uint32_t*>(qb + r0 * qs.t + c) : 0u;
    qa[kd][1] = r1 < T ? *reinterpret_cast<const uint32_t*>(qb + r1 * qs.t + c) : 0u;
    qa[kd][2] = r0 < T ? *reinterpret_cast<const uint32_t*>(qb + r0 * qs.t + c + 8) : 0u;
    qa[kd][3] = r1 < T ? *reinterpret_cast<const uint32_t*>(qb + r1 * qs.t + c + 8) : 0u;
  }

  float acc[NT][4];
#pragma unroll
  for (int nd = 0; nd < NT; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;   // l: this thread's columns
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                                    // last tile consumed
    for (int i = tid; i < BK * (D / 8); i += THREADS_BF16) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = k0 + r < kend;
      const long long kr = k0 + r;
      cp_async16(&k_tile[r * LDS + c], ok ? kb + kr * ks.t + c : kb, ok);
      cp_async16(&v_tile[r * LDS + c], ok ? vb + kr * vs.t + c : vb, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nk = 0; nk < BK / 8; ++nk) {
      s[nk][0] = s[nk][1] = s[nk][2] = s[nk][3] = 0.0f;
      const __nv_bfloat16* kr = &k_tile[(nk * 8 + g) * LDS + t4 * 2];
#pragma unroll
      for (int kd = 0; kd < KS; ++kd) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kd * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kd * 16 + 8);
        mma_bf16(s[nk], qa[kd], b0, b1);
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nk = 0; nk < BK / 8; ++nk) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + nk * 8 + t4 * 2 + j;
        const bool ok0 = col < len && (!causal || col <= r0);
        const bool ok1 = col < len && (!causal || col <= r1);
        s[nk][j] = ok0 ? s[nk][j] * scale : NEG_INF;
        s[nk][2 + j] = ok1 ? s[nk][2 + j] * scale : NEG_INF;
        mx0 = fmaxf(mx0, s[nk][j]);
        mx1 = fmaxf(mx1, s[nk][2 + j]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nk = 0; nk < BK / 8; ++nk) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {        // a masked score adds nothing, never exp(0)
        s[nk][j] = s[nk][j] == NEG_INF ? 0.0f : expf(s[nk][j] - mn0);
        s[nk][2 + j] = s[nk][2 + j] == NEG_INF ? 0.0f : expf(s[nk][2 + j] - mn1);
        ps0 += s[nk][j];
        ps1 += s[nk][2 + j];
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nd = 0; nd < NT; ++nd) {
      acc[nd][0] *= al0;
      acc[nd][1] *= al0;
      acc[nd][2] *= al1;
      acc[nd][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // p's A fragment for keys 16kk..16kk+15 is the C fragments of n8
      // tiles 2kk and 2kk+1, rounded to bf16
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = &v_tile[(kk * 16 + t4 * 2) * LDS + g];
#pragma unroll
      for (int nd = 0; nd < NT; ++nd) {
        const __nv_bfloat16* c = vr + nd * 8;
        mma_bf16(acc[nd], pa, pack_raw(c[0], c[LDS]), pack_raw(c[8 * LDS], c[9 * LDS]));
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < NT; ++nd) {
    const int c = nd * 8 + t4 * 2;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(out + (((long long)b * T + r0) * H + h) * D + c) =
          l0 > 0.0f ? pack_bf16(acc[nd][0] / d0, acc[nd][1] / d0) : 0u;
    }
    if (r1 < T) {
      *reinterpret_cast<uint32_t*>(out + (((long long)b * T + r1) * H + h) * D + c) =
          l1 > 0.0f ? pack_bf16(acc[nd][2] / d1, acc[nd][3] / d1) : 0u;
    }
  }
  if (lse != nullptr && t4 == 0) {
    float* row = lse + ((long long)b * H + h) * T;
    if (r0 < T) row[r0] = l0 > 0.0f ? m0 + logf(d0) : LSE_DEAD;
    if (r1 < T) row[r1] = l1 > 0.0f ? m1 + logf(d1) : LSE_DEAD;
  }
}

// f32: thread (row, part) of the block owns query row q0 + tid / 4 and the
// dims d = 4 * i + part, so a quad's four threads read neighbouring words
template <int D>
__global__ void __launch_bounds__(THREADS_F32)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        const int* __restrict__ lengths, float* __restrict__ out, float* __restrict__ lse,
        int T, int S, int H, Strides qs, Strides ks, Strides vs, int causal, float scale) {
  constexpr int DP = D / 4;
  constexpr int LDS = D + 4;        // shared row stride in values (16-byte multiple)
  __shared__ __align__(16) float k_tile[BK32 * LDS];
  __shared__ __align__(16) float v_tile[BK32 * LDS];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = q0 + (tid >> 2);
  const int len = min(lengths[b], S);
  const int kend = causal ? min(len, q0 + BQ) : len;

  float qr[DP], acc[DP];
  const float* qrow = q + b * qs.b + h * qs.h + (long long)row * qs.t;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row < T ? qrow[4 * i + part] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  for (int k0 = 0; k0 < kend; k0 += BK32) {
    __syncthreads();
    for (int i = tid; i < BK32 * (D / 4); i += THREADS_F32) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool ok = k0 + r < kend;
      const long long kr = k0 + r;
      cp_async16(&k_tile[r * LDS + c], ok ? kb + kr * ks.t + c : kb, ok);
      cp_async16(&v_tile[r * LDS + c], ok ? vb + kr * vs.t + c : vb, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    float s[BK32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot = fmaf(qr[i], k_tile[j * LDS + 4 * i + part], dot);
      dot = quad_sum(dot);
      const int col = k0 + j;
      s[j] = col < len && (!causal || col <= row) ? dot * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
      s[j] = s[j] == NEG_INF ? 0.0f : expf(s[j] - mn);
      ps += s[j];
    }
    l = l * al + ps;
    m = mn;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= al;
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(s[j], v_tile[j * LDS + 4 * i + part], acc[i]);
    }
  }

  if (row < T) {
    const float dl = fmaxf(l, 1e-30f);
    float* orow = out + (((long long)b * T + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) orow[4 * i + part] = l > 0.0f ? acc[i] / dl : 0.0f;
    if (lse != nullptr && part == 0) {
      lse[((long long)b * H + h) * T + row] = l > 0.0f ? m + logf(dl) : LSE_DEAD;
    }
  }
}

// ------------------------------------------------- bf16, D in {64, 128}: TMA + wgmma
constexpr int TQ = 128;           // query rows per block: two consumer warpgroups of 64
constexpr int TK = 128;           // key rows per stage
constexpr int KV_STAGES = 2;
constexpr int THREADS_TMA = 2 * 128 + 32;   // two consumer warpgroups, one producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
constexpr int tma_smem_bytes() {
  return (TQ + KV_STAGES * 2 * TK) * D * 2 + (1 + 2 * KV_STAGES) * 8 + 1024;
}

// Shared memory, 1024-byte aligned: Q [D/64][TQ rows][128 B], then per
// stage K [D/64][TK][128 B] and V [D/64][TK][128 B]: every tile a 4-D TMA
// box {64 d, 1 head, rows, 1 lane} with the 128-byte swizzle, one per
// 64-column half. S = Q.K^T reads Q and K K-major; O += P.V takes P from
// registers and V MN-major (the transpose bit).
template <int D>
__global__ void __launch_bounds__(THREADS_TMA)
fwd_tma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ lengths,
        __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int S, int H,
        int causal, float scale_log2) {
  constexpr int HALVES = D / 64;
  constexpr int Q_BYTES = TQ * D * 2, KV_BYTES = TK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + Q_BYTES;           // stage s: K at 2s, V at 2s + 1
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kv_s + KV_STAGES * 2 * KV_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + KV_STAGES;

  // the last query tiles have the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ, h = blockIdx.y, b = blockIdx.z;
  const int len = min(lengths[b], S);
  const int kend = causal ? min(len, q0 + TQ) : len;     // keys that can be valid
  const int ntiles = kend > 0 ? (kend + TK - 1) / TK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {   // the producer warp: lane 0 issues every load
    if (lane == 0 && ntiles > 0) {
      hopper::mbar_expect_tx(qbar, Q_BYTES);
      for (int hf = 0; hf < HALVES; ++hf) {
        hopper::tma_load_4d(q_s + hf * TQ * 128, &tm_q, qbar, hf * 64, h, q0, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % KV_STAGES;
        if (j >= KV_STAGES) hopper::mbar_wait(&empty[s], ((j / KV_STAGES) - 1) & 1);
        uint8_t* ks = kv_s + (2 * s) * KV_BYTES;
        hopper::mbar_expect_tx(&full[s], 2 * KV_BYTES);   // whole boxes, zero fill included
        for (int hf = 0; hf < HALVES; ++hf) {
          hopper::tma_load_4d(ks + hf * TK * 128, &tm_k, &full[s], hf * 64, h, j * TK, b);
          hopper::tma_load_4d(ks + KV_BYTES + hf * TK * 128, &tm_v, &full[s], hf * 64, h,
                              j * TK, b);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns query rows q0 + 64 wg .. + 63; in it warp
  // w rows 16w + g and 16w + g + 8 (g = lane / 4), whose scores and outputs
  // sit at columns 8c + 2t + {0, 1} (t = lane % 4) of the accumulators
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int first = q0 + wg * 64, last = first + 63;
  const int r0 = first + (warp & 3) * 16 + g, r1 = r0 + 8;
  const uint32_t q_a = hopper::smem_u32(q_s) + wg * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;   // m in log2 units
  if (ntiles > 0) hopper::mbar_wait(qbar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % KV_STAGES;
    hopper::mbar_wait(&full[s], (j / KV_STAGES) & 1);
    const int k0 = j * TK;
    if (!causal || k0 <= last) {           // else every key of the tile is above our rows
      const uint32_t k_a = hopper::smem_u32(kv_s + (2 * s) * KV_BYTES);
      const uint32_t v_a = k_a + KV_BYTES;
      float sc[TK / 2];
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * TK * 128 + (kk % 4) * 32;
        hopper::wgmma_ss_bf16<TK>(sc, hopper::desc_sw128(q_a + (kk / 4) * TQ * 128 + (kk % 4) * 32,
                                                         16, 1024),
                                  hopper::desc_sw128(k_a + off, 16, 1024), kk > 0 ? 1 : 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // scores in log2 units; only a tile that crosses the length or the
      // diagonal of this warpgroup's rows is masked element by element
      const bool whole = k0 + TK <= len && (!causal || k0 + TK - 1 <= first);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int c = 0; c < TK / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * c + 2 * t4 + e;
          float x0 = sc[4 * c + e] * scale_log2, x1 = sc[4 * c + 2 + e] * scale_log2;
          if (!whole) {
            if (!(col < len && (!causal || col <= r0))) x0 = NEG_INF;
            if (!(col < len && (!causal || col <= r1))) x1 = NEG_INF;
          }
          sc[4 * c + e] = x0;
          sc[4 * c + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int c = 0; c < TK / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {     // a masked score adds nothing, never exp(0)
          float& x0 = sc[4 * c + e];
          float& x1 = sc[4 * c + 2 + e];
          x0 = (whole || x0 != NEG_INF) ? exp2f(x0 - mn0) : 0.0f;
          x1 = (whole || x1 != NEG_INF) ? exp2f(x1 - mn1) : 0.0f;
          ps0 += x0;
          ps1 += x1;
        }
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c] *= al0;
        o[4 * c + 1] *= al0;
        o[4 * c + 2] *= al1;
        o[4 * c + 3] *= al1;
      }
      // p rounded to bf16 in wgmma's A-register layout: keys 16kk..16kk+15
      // are the accumulator columns of n8 groups 2kk and 2kk + 1
      uint32_t pa[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        hopper::wgmma_rs_bf16_tb<D>(o, pa[kk],
                                    hopper::desc_sw128(v_a + kk * 16 * 128, TK * 128, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) hopper::fence_regs(pa[kk]);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = 8 * c + 2 * t4;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(out + (((long long)b * T + r0) * H + h) * D + col) =
          l0 > 0.0f ? pack_bf16(o[4 * c] / d0, o[4 * c + 1] / d0) : 0u;
    }
    if (r1 < T) {
      *reinterpret_cast<uint32_t*>(out + (((long long)b * T + r1) * H + h) * D + col) =
          l1 > 0.0f ? pack_bf16(o[4 * c + 2] / d1, o[4 * c + 3] / d1) : 0u;
    }
  }
  if (lse != nullptr && t4 == 0) {
    float* row = lse + ((long long)b * H + h) * T;
    if (r0 < T) row[r0] = l0 > 0.0f ? m0 * LN2 + logf(d0) : LSE_DEAD;
    if (r1 < T) row[r1] = l1 > 0.0f ? m1 * LN2 + logf(d1) : LSE_DEAD;
  }
}

// q (T rows) and k/v (S rows) as 4-D maps {D, H, rows, B} over their
// strides (in elements); boxes of 64 values x TQ or TK rows
template <int D>
int launch_tma(const void* q, const void* k, const void* v, const int* lengths, void* out,
               float* lse, int B, int T, int S, int H, Strides qs, Strides ks, Strides vs,
               int causal, float scale, cudaStream_t st) {
  constexpr int SMEM = tma_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(fwd_tma<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap maps[3];
  const void* base[3] = {q, k, v};
  const Strides* str[3] = {&qs, &ks, &vs};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(i == 0 ? T : S),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(str[i]->h) * 2,
                                   static_cast<cuuint64_t>(str[i]->t) * 2,
                                   static_cast<cuuint64_t>(str[i]->b) * 2};
    const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(i == 0 ? TQ : TK), 1};
    const int rc = hopper::encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base[i], dims,
                                  strides, box);
    if (rc != 0) return rc;
  }
  const dim3 grid((T + TQ - 1) / TQ, H, B);
  fwd_tma<D><<<grid, THREADS_TMA, SMEM, st>>>(maps[0], maps[1], maps[2], lengths,
                                              static_cast<__nv_bfloat16*>(out), lse, T, S, H,
                                              causal, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   float* lse, int B, int T, int S, int H, Strides qs, Strides ks, Strides vs,
                   int causal, float scale, bool bf16, cudaStream_t st) {
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  if (bf16) {
    fwd_bf16<D><<<grid, THREADS_BF16, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lengths, static_cast<__nv_bfloat16*>(out), lse, T,
        S, H, qs, ks, vs, causal, scale);
  } else {
    fwd_f32<D><<<grid, THREADS_F32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lengths, static_cast<float*>(out), lse, T, S, H, qs, ks,
        vs, causal, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Strides are in elements; lse may be
// null. bf16 with D in {64, 128} runs fwd_tma, other bf16 head dims
// fwd_bf16, f32 fwd_f32 (ops/flash_attention.py `_route` names the same
// choice). Returns 0, the cudaError_t of the launch, or a tensor-map code
// of hopper.cuh.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* lengths, void* out, void* lse,
    int B, int T, int S, int H, int D, long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh, long long vsb, long long vst, long long vsh,
    int causal, float scale, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0) return 0;
  const Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh};
  const int* lens = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool b16 = bf16 != 0;
  if (b16 && D == 64) {
    return launch_tma<64>(q, k, v, lens, out, l, B, T, S, H, qs, ks, vs, causal, scale, st);
  }
  if (b16 && D == 128) {
    return launch_tma<128>(q, k, v, lens, out, l, B, T, S, H, qs, ks, vs, causal, scale, st);
  }
  switch (D) {
    case 16: return launch<16>(q, k, v, lens, out, l, B, T, S, H, qs, ks, vs, causal, scale, b16, st);
    case 32: return launch<32>(q, k, v, lens, out, l, B, T, S, H, qs, ks, vs, causal, scale, b16, st);
    case 48: return launch<48>(q, k, v, lens, out, l, B, T, S, H, qs, ks, vs, causal, scale, b16, st);
    case 64: return launch<64>(q, k, v, lens, out, l, B, T, S, H, qs, ks, vs, causal, scale, b16, st);
    case 80: return launch<80>(q, k, v, lens, out, l, B, T, S, H, qs, ks, vs, causal, scale, b16, st);
    case 96: return launch<96>(q, k, v, lens, out, l, B, T, S, H, qs, ks, vs, causal, scale, b16, st);
    case 112: return launch<112>(q, k, v, lens, out, l, B, T, S, H, qs, ks, vs, causal, scale, b16, st);
    case 128: return launch<128>(q, k, v, lens, out, l, B, T, S, H, qs, ks, vs, causal, scale, b16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
