// Backward of the causal, length-masked flash attention (FlashAttention-2
// style, probabilities recomputed from the saved logsumexp), for Hopper
// (sm_90a).
//
// Replaces the two Pallas TPU kernels of radialog_tpu/ops/flash_attention.py:
// `_dq_kernel` (K5a) and `_dkv_kernel` (K5b), called from `_flash_bwd`. The
// math is the TPU kernels', not their blocking:
//   s  = (q . k summed in f32) * scale; key j of lane b is valid for query i
//        iff j < min(len[b], S) and, when causal, j <= i
//   p  = exp(s - lse[i]) where valid, exactly 0 elsewhere; a row whose
//        lse is 1e30 (no valid key) has p = 0
//   dp = do . v summed in f32
//   ds = (p * (dp - delta[i]) * scale) rounded to the input dtype
//   dq = sum_j ds . k            (K5a, f32 sums, input-dtype result)
//   dv = sum_i p^T . do with p rounded to the input dtype; dk = sum_i ds^T . q
//                                (K5b)
//   delta = rowsum(do * out) in f32, computed by K5a when it is handed out
// q, do (and out) are (B,T,H,D), k, v (B,S,H,D), read through their batch,
// token and head strides (last dim dense, rows 16-byte aligned); lse and
// delta are dense (B,H,T) f32; dq (B,T,H,D) and dk, dv (B,S,H,D) are dense.
// There is no lane-broadcast copy of lse/delta, no padding of T or S in
// memory and no transposed copy.
//
// What bounds them on an H100: at the training shape (B=2, T=S=600, H=32,
// D=128, bf16) each kernel does 6*H*D*pairs (K5a) or 8*H*D*pairs (K5b)
// operations over the ~180k valid (query, key) pairs of a lane on ~50 MB,
// about 150 operations per byte: below the 295 at which the tensor cores
// would be the limit, so the least time is the bytes'. At these sizes a
// kernel waits on the latency of its loads and of its chained products, so
// the design keeps both off the threads' instruction stream. Deterministic
// throughout: every output row has one owner, which walks the other axis in
// order, and there are no float atomics, so a run repeats itself bit for bit.
//   * bf16 with D in {64, 128} (dq_tma, dkv_tma; K3's fwd_tma in shape, but
//     one warpgroup a block): a block owns 64 rows of one (head, lane) and
//     streams 64-row tiles of the other axis through a 2-stage mbarrier
//     ring. It has no producer warp: thread 0 issues every TMA load (the
//     owned pair once, each stage again once the block is done with it), so
//     a block is 128 threads and two fit an SM (K5b needs 238 registers a
//     thread at D = 128; a lone producer warp would cost as many as a
//     consumer warp and keep it to one block an SM). The maps are 4-D {D, H,
//     rows, B} over the strided views (rows past T or S arrive as zeros),
//     every tile a 128-byte-swizzled box per 64 columns. Each tile's first
//     two products are committed apart, so p forms while the second runs.
//     The grid is (H, B, tiles), the tile index slowest: the heaviest tiles
//     of every head and lane start first.
//     - K5a (dq_tma): owned query rows, Q and dO loaded once; per 64-key
//       stage S = Q.K^T and dP = dO.V^T are two wgmma chains from shared
//       memory (all operands K-major); p and ds are formed in registers,
//       masked element by element only in tiles that cross the length or
//       the diagonal; ds, rounded to bf16, goes from the accumulator into
//       wgmma's A registers and dQ += dS.K reads the same K tile MN-major
//       (the transpose bit). Key tiles past min(len, last row + 1) are never
//       loaded; the last query tiles (the most keys) go first. With out
//       given, each quad first sums its rows' do * out (16-byte loads) and
//       writes delta for K5b, so the backward needs no separate pass for it.
//     - K5b (dkv_tma): owned key rows, K and V loaded once; Q, dO and the
//       rows' lse and delta stream by 64 queries, starting at the diagonal
//       when causal. S^T = K.Q^T and dP^T = V.dO^T come from shared memory;
//       P^T and dS^T, rounded to bf16, go from the accumulators into A
//       registers for dV += P^T.dO (issued before dS^T is formed) and dK +=
//       dS^T.Q, which read dO and Q MN-major from the same swizzled tiles
//       that the first two products read K-major. A key tile at or past
//       min(len, S) writes zeros and loads nothing. The first key tiles (the
//       most queries) go first.
//     Pitfalls, each handled here: TMA takes no stride that is not a
//     16-byte multiple, so the wrapper hands over `_strides` (a unit dim
//     gets its dense stride) and never raw strides; lse and delta rows are
//     T floats and 16-byte aligned only when T % 4 == 0 (T = 431, 413 are
//     not), so they are read with plain loads (K5b's threads 0..63 copy a
//     stage's 64 values into shared memory beside its TMA tiles) and never
//     through a map; one swizzled tile serves a K-major and an MN-major
//     descriptor (LBO = the distance between 64-column halves, SBO = 1024),
//     where a wrong offset gives wrong sums and not a fault; query and key
//     rows meet inside diagonal tiles in both kernels, which are masked
//     element by element. A protocol fault traps after 2^26 mbarrier polls.
//   * bf16 at other head dims (the mock's D = 16; dq_bf16, dkv_bf16, the
//     first kernels of this file): 4 warps per 64-row tile, cp.async tiles
//     in shared memory, mma.sync m16n8k16 with ds and p reused from the
//     accumulator layout as A fragments; K5b works on transposed tiles;
//   * f32 (the mock's FP32 policy; dq_f32, dkv_f32): 4 threads per owned row
//     split D, plain FMA loops over 32-row tiles in shared memory (no TF32).
// Tiles wholly past min(S, len) or wholly on the masked side of the causal
// diagonal are never read; tails (T, S no multiple of the tile) are masked.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;              // rows of the owned tile and of a streamed tile, bf16
constexpr int BT32 = 32;            // rows of a streamed tile, f32
constexpr int THREADS_BF16 = 128;   // 4 warps x 16 owned rows
constexpr int THREADS_F32 = 256;    // 64 owned rows x 4 threads
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

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [r0, r0 + rows) of a (.., token, head, D) bf16 tensor -> a shared tile
// of row stride LDS; rows at or past `limit` are filled with zeros
template <int D, int LDS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                               long long stride_t, int r0, int rows, int limit,
                                               int tid) {
  for (int i = tid; i < rows * (D / 8); i += THREADS_BF16) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(&tile[r * LDS + c], ok ? base + (long long)(r0 + r) * stride_t + c : base, ok);
  }
}

template <int D, int LDS>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* base, long long stride_t,
                                              int r0, int rows, int limit, int tid) {
  for (int i = tid; i < rows * (D / 4); i += THREADS_F32) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = r0 + r < limit;
    cp_async16(&tile[r * LDS + c], ok ? base + (long long)(r0 + r) * stride_t + c : base, ok);
  }
}

// Fragment layout of mma m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A 16x16: a[0] rows g, cols 2t..2t+1; a[1] row g+8; a[2] row g, cols
//            2t+8..; a[3] row g+8, cols 2t+8..
//   B 16x8:  b0 rows (k) 2t..2t+1, col (n) g; b1 rows 2t+8.., col g
//   C 16x8:  c[0..1] row g, cols 2t..2t+1; c[2..3] row g+8

// ------------------------------------------------------------------ K5a, bf16
template <int D>
__global__ void __launch_bounds__(THREADS_BF16)
dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const int* __restrict__ lengths, __nv_bfloat16* __restrict__ dq, int T, int S, int H,
        Strides qs, Strides ks, Strides vs, Strides os, int causal, float scale) {
  constexpr int KS = D / 16;        // k-steps over D
  constexpr int NT = D / 8;         // n8 tiles over D
  constexpr int LDS = D + 8;        // shared row stride in values (16-byte multiple)
  __shared__ __align__(16) __nv_bfloat16 k_tile[BQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_tile[BQ * LDS];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int len = min(lengths[b], S);
  const int kend = causal ? min(len, q0 + BQ) : len;   // keys that can be valid
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;       // this thread's two rows

  uint32_t qa[KS][4], da[KS][4];
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* ob = dout + b * os.b + h * os.h;
#pragma unroll
  for (int kd = 0; kd < KS; ++kd) {
    const int c = kd * 16 + t4 * 2;
    qa[kd][0] = r0 < T ? *reinterpret_cast<const uint32_t*>(qb + r0 * qs.t + c) : 0u;
    qa[kd][1] = r1 < T ? *reinterpret_cast<const uint32_t*>(qb + r1 * qs.t + c) : 0u;
    qa[kd][2] = r0 < T ? *reinterpret_cast<const uint32_t*>(qb + r0 * qs.t + c + 8) : 0u;
    qa[kd][3] = r1 < T ? *reinterpret_cast<const uint32_t*>(qb + r1 * qs.t + c + 8) : 0u;
    da[kd][0] = r0 < T ? *reinterpret_cast<const uint32_t*>(ob + r0 * os.t + c) : 0u;
    da[kd][1] = r1 < T ? *reinterpret_cast<const uint32_t*>(ob + r1 * os.t + c) : 0u;
    da[kd][2] = r0 < T ? *reinterpret_cast<const uint32_t*>(ob + r0 * os.t + c + 8) : 0u;
    da[kd][3] = r1 < T ? *reinterpret_cast<const uint32_t*>(ob + r1 * os.t + c + 8) : 0u;
  }
  const float* stat = lse + ((long long)b * H + h) * T;
  const float* dstat = delta + ((long long)b * H + h) * T;
  const float lse0 = r0 < T ? stat[r0] : LSE_DEAD, lse1 = r1 < T ? stat[r1] : LSE_DEAD;
  const float dl0 = r0 < T ? dstat[r0] : 0.0f, dl1 = r1 < T ? dstat[r1] : 0.0f;

  float acc[NT][4];
#pragma unroll
  for (int nd = 0; nd < NT; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const int last_row = q0 + warp * 16 + 15;             // the warp's last query row

  for (int k0 = 0; k0 < kend; k0 += BQ) {
    __syncthreads();                                    // last tile consumed
    load_tile_bf16<D, LDS>(k_tile, kb, ks.t, k0, BQ, kend, tid);
    load_tile_bf16<D, LDS>(v_tile, vb, vs.t, k0, BQ, kend, tid);
    cp_async_wait_all();
    __syncthreads();

#pragma unroll 1
    for (int kk = 0; kk < BQ / 16; ++kk) {              // 16 keys at a time
      const int c0 = k0 + kk * 16;
      if (c0 >= kend || (causal && c0 > last_row)) break;   // nothing valid from here on
      float s[2][4], dp[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        s[hf][0] = s[hf][1] = s[hf][2] = s[hf][3] = 0.0f;
        dp[hf][0] = dp[hf][1] = dp[hf][2] = dp[hf][3] = 0.0f;
        const __nv_bfloat16* kr = &k_tile[(kk * 16 + hf * 8 + g) * LDS + t4 * 2];
        const __nv_bfloat16* vr = &v_tile[(kk * 16 + hf * 8 + g) * LDS + t4 * 2];
#pragma unroll
        for (int kd = 0; kd < KS; ++kd) {
          mma_bf16(s[hf], qa[kd], *reinterpret_cast<const uint32_t*>(kr + kd * 16),
                   *reinterpret_cast<const uint32_t*>(kr + kd * 16 + 8));
          mma_bf16(dp[hf], da[kd], *reinterpret_cast<const uint32_t*>(vr + kd * 16),
                   *reinterpret_cast<const uint32_t*>(vr + kd * 16 + 8));
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + hf * 8 + t4 * 2 + j;
          const bool ok0 = col < len && (!causal || col <= r0);
          const bool ok1 = col < len && (!causal || col <= r1);
          const float p0 = ok0 ? expf(s[hf][j] * scale - lse0) : 0.0f;
          const float p1 = ok1 ? expf(s[hf][2 + j] * scale - lse1) : 0.0f;
          s[hf][j] = p0 * (dp[hf][j] - dl0) * scale;            // ds
          s[hf][2 + j] = p1 * (dp[hf][2 + j] - dl1) * scale;
        }
      }
      // ds's A fragment for these 16 keys is the two accumulator fragments,
      // rounded to bf16
      const uint32_t dsa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                               pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const __nv_bfloat16* kc = &k_tile[(kk * 16 + t4 * 2) * LDS + g];
#pragma unroll
      for (int nd = 0; nd < NT; ++nd) {
        const __nv_bfloat16* c = kc + nd * 8;
        mma_bf16(acc[nd], dsa, pack_raw(c[0], c[LDS]), pack_raw(c[8 * LDS], c[9 * LDS]));
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < NT; ++nd) {
    const int c = nd * 8 + t4 * 2;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(dq + (((long long)b * T + r0) * H + h) * D + c) =
          pack_bf16(acc[nd][0], acc[nd][1]);
    }
    if (r1 < T) {
      *reinterpret_cast<uint32_t*>(dq + (((long long)b * T + r1) * H + h) * D + c) =
          pack_bf16(acc[nd][2], acc[nd][3]);
    }
  }
}

// ------------------------------------------------------------------ K5b, bf16
template <int D>
__global__ void __launch_bounds__(THREADS_BF16)
dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         const int* __restrict__ lengths, __nv_bfloat16* __restrict__ dk,
         __nv_bfloat16* __restrict__ dv, int T, int S, int H, Strides qs, Strides ks,
         Strides vs, Strides os, int causal, float scale) {
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  constexpr int LDS = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_tile = k_tile + BQ * LDS;
  __nv_bfloat16* q_tile = v_tile + BQ * LDS;
  __nv_bfloat16* o_tile = q_tile + BQ * LDS;
  float* lse_s = reinterpret_cast<float*>(o_tile + BQ * LDS);
  float* delta_s = lse_s + BQ;

  const int k0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int len = min(lengths[b], S);
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;    // this thread's two key rows

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int nd = 0; nd < NT; ++nd) {
    dka[nd][0] = dka[nd][1] = dka[nd][2] = dka[nd][3] = 0.0f;
    dva[nd][0] = dva[nd][1] = dva[nd][2] = dva[nd][3] = 0.0f;
  }

  if (k0 < len) {                                       // else: no valid key, zeros
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* ob = dout + b * os.b + h * os.h;
    const float* stat = lse + ((long long)b * H + h) * T;
    const float* dstat = delta + ((long long)b * H + h) * T;
    load_tile_bf16<D, LDS>(k_tile, k + b * ks.b + h * ks.h, ks.t, k0, BQ, len, tid);
    load_tile_bf16<D, LDS>(v_tile, v + b * vs.b + h * vs.h, vs.t, k0, BQ, len, tid);
    cp_async_wait_all();        // also when no query tile follows (causal, k0 >= T)
    const int first_key = k0 + warp * 16;               // the warp's first key row
    const __nv_bfloat16* ka_row = &k_tile[(warp * 16 + g) * LDS + t4 * 2];
    const __nv_bfloat16* va_row = &v_tile[(warp * 16 + g) * LDS + t4 * 2];

    for (int q0 = causal ? k0 : 0; q0 < T; q0 += BQ) {  // k0 is a multiple of BQ
      __syncthreads();                                  // last tile consumed
      load_tile_bf16<D, LDS>(q_tile, qb, qs.t, q0, BQ, T, tid);
      load_tile_bf16<D, LDS>(o_tile, ob, os.t, q0, BQ, T, tid);
      if (tid < BQ) {
        lse_s[tid] = q0 + tid < T ? stat[q0 + tid] : LSE_DEAD;
        delta_s[tid] = q0 + tid < T ? dstat[q0 + tid] : 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();

#pragma unroll 1
      for (int kk = 0; kk < BQ / 16; ++kk) {            // 16 queries at a time
        const int i0 = q0 + kk * 16;
        if (i0 >= T) break;
        if (causal && i0 + 15 < first_key) continue;    // every pair masked
        // transposed tiles: rows are this warp's keys, columns the queries
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          st[hf][0] = st[hf][1] = st[hf][2] = st[hf][3] = 0.0f;
          dpt[hf][0] = dpt[hf][1] = dpt[hf][2] = dpt[hf][3] = 0.0f;
        }
#pragma unroll
        for (int kd = 0; kd < KS; ++kd) {
          const uint32_t ka[4] = {
              *reinterpret_cast<const uint32_t*>(ka_row + kd * 16),
              *reinterpret_cast<const uint32_t*>(ka_row + 8 * LDS + kd * 16),
              *reinterpret_cast<const uint32_t*>(ka_row + kd * 16 + 8),
              *reinterpret_cast<const uint32_t*>(ka_row + 8 * LDS + kd * 16 + 8)};
          const uint32_t va[4] = {
              *reinterpret_cast<const uint32_t*>(va_row + kd * 16),
              *reinterpret_cast<const uint32_t*>(va_row + 8 * LDS + kd * 16),
              *reinterpret_cast<const uint32_t*>(va_row + kd * 16 + 8),
              *reinterpret_cast<const uint32_t*>(va_row + 8 * LDS + kd * 16 + 8)};
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const __nv_bfloat16* qr = &q_tile[(kk * 16 + hf * 8 + g) * LDS + t4 * 2 + kd * 16];
            const __nv_bfloat16* orow = &o_tile[(kk * 16 + hf * 8 + g) * LDS + t4 * 2 + kd * 16];
            mma_bf16(st[hf], ka, *reinterpret_cast<const uint32_t*>(qr),
                     *reinterpret_cast<const uint32_t*>(qr + 8));
            mma_bf16(dpt[hf], va, *reinterpret_cast<const uint32_t*>(orow),
                     *reinterpret_cast<const uint32_t*>(orow + 8));
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int li = kk * 16 + hf * 8 + t4 * 2 + j;   // query row within the tile
            const int i = q0 + li;
            const float l = lse_s[li], dl = delta_s[li];
            const bool ok0 = kr0 < len && (!causal || kr0 <= i);
            const bool ok1 = kr1 < len && (!causal || kr1 <= i);
            const float p0 = ok0 ? expf(st[hf][j] * scale - l) : 0.0f;
            const float p1 = ok1 ? expf(st[hf][2 + j] * scale - l) : 0.0f;
            st[hf][j] = p0;
            st[hf][2 + j] = p1;
            dpt[hf][j] = p0 * (dpt[hf][j] - dl) * scale;        // ds
            dpt[hf][2 + j] = p1 * (dpt[hf][2 + j] - dl) * scale;
          }
        }
        // p^T and ds^T, rounded to bf16, are A fragments over these 16 queries
        const uint32_t pa[4] = {pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
                                pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
        const uint32_t dsa[4] = {pack_bf16(dpt[0][0], dpt[0][1]), pack_bf16(dpt[0][2], dpt[0][3]),
                                 pack_bf16(dpt[1][0], dpt[1][1]), pack_bf16(dpt[1][2], dpt[1][3])};
        const __nv_bfloat16* oc = &o_tile[(kk * 16 + t4 * 2) * LDS + g];
        const __nv_bfloat16* qc = &q_tile[(kk * 16 + t4 * 2) * LDS + g];
#pragma unroll
        for (int nd = 0; nd < NT; ++nd) {
          const __nv_bfloat16* c = oc + nd * 8;
          mma_bf16(dva[nd], pa, pack_raw(c[0], c[LDS]), pack_raw(c[8 * LDS], c[9 * LDS]));
          c = qc + nd * 8;
          mma_bf16(dka[nd], dsa, pack_raw(c[0], c[LDS]), pack_raw(c[8 * LDS], c[9 * LDS]));
        }
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < NT; ++nd) {
    const int c = nd * 8 + t4 * 2;
    if (kr0 < S) {
      const long long o = (((long long)b * S + kr0) * H + h) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[nd][0], dka[nd][1]);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[nd][0], dva[nd][1]);
    }
    if (kr1 < S) {
      const long long o = (((long long)b * S + kr1) * H + h) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[nd][2], dka[nd][3]);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[nd][2], dva[nd][3]);
    }
  }
}

// ------------------------------------------------------------------- K5a, f32
// thread (row, part) of the block owns query row q0 + tid / 4 and the dims
// d = 4 * i + part, so a quad's four threads read neighbouring words
template <int D>
__global__ void __launch_bounds__(THREADS_F32)
dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, const int* __restrict__ lengths, float* __restrict__ dq,
       int T, int S, int H, Strides qs, Strides ks, Strides vs, Strides os, int causal,
       float scale) {
  constexpr int DP = D / 4;
  constexpr int LDS = D + 4;        // shared row stride in values (16-byte multiple)
  __shared__ __align__(16) float k_tile[BT32 * LDS];
  __shared__ __align__(16) float v_tile[BT32 * LDS];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = q0 + (tid >> 2);
  const int len = min(lengths[b], S);
  const int kend = causal ? min(len, q0 + BQ) : len;

  float qr[DP], dor[DP], acc[DP];
  const float* qrow = q + b * qs.b + h * qs.h + (long long)row * qs.t;
  const float* orow = dout + b * os.b + h * os.h + (long long)row * os.t;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row < T ? qrow[4 * i + part] : 0.0f;
    dor[i] = row < T ? orow[4 * i + part] : 0.0f;
    acc[i] = 0.0f;
  }
  const long long srow = ((long long)b * H + h) * T + row;
  const float l = row < T ? lse[srow] : LSE_DEAD;
  const float dl = row < T ? delta[srow] : 0.0f;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  for (int k0 = 0; k0 < kend; k0 += BT32) {
    __syncthreads();
    load_tile_f32<D, LDS>(k_tile, kb, ks.t, k0, BT32, kend, tid);
    load_tile_f32<D, LDS>(v_tile, vb, vs.t, k0, BT32, kend, tid);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BT32; ++j) {
      float dot = 0.0f, dpv = 0.0f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        dot = fmaf(qr[i], k_tile[j * LDS + 4 * i + part], dot);
        dpv = fmaf(dor[i], v_tile[j * LDS + 4 * i + part], dpv);
      }
      dot = quad_sum(dot);
      dpv = quad_sum(dpv);
      const int col = k0 + j;
      const bool ok = col < len && (!causal || col <= row);
      const float p = ok ? expf(dot * scale - l) : 0.0f;
      const float ds = p * (dpv - dl) * scale;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(ds, k_tile[j * LDS + 4 * i + part], acc[i]);
    }
  }

  if (row < T) {
    float* out = dq + (((long long)b * T + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) out[4 * i + part] = acc[i];
  }
}

// ------------------------------------------------------------------- K5b, f32
template <int D>
__global__ void __launch_bounds__(THREADS_F32)
dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        const float* __restrict__ dout, const float* __restrict__ lse,
        const float* __restrict__ delta, const int* __restrict__ lengths,
        float* __restrict__ dk, float* __restrict__ dv, int T, int S, int H, Strides qs,
        Strides ks, Strides vs, Strides os, int causal, float scale) {
  constexpr int DP = D / 4;
  constexpr int LDS = D + 4;
  __shared__ __align__(16) float q_tile[BT32 * LDS];
  __shared__ __align__(16) float o_tile[BT32 * LDS];
  __shared__ float lse_s[BT32];
  __shared__ float delta_s[BT32];

  const int k0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid & 3;
  const int krow = k0 + (tid >> 2);
  const int len = min(lengths[b], S);

  float kr[DP], vr[DP], dka[DP], dva[DP];
  const float* krp = k + b * ks.b + h * ks.h + (long long)krow * ks.t;
  const float* vrp = v + b * vs.b + h * vs.h + (long long)krow * vs.t;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    kr[i] = krow < len ? krp[4 * i + part] : 0.0f;
    vr[i] = krow < len ? vrp[4 * i + part] : 0.0f;
    dka[i] = dva[i] = 0.0f;
  }

  if (k0 < len) {                                       // else: no valid key, zeros
    const float* qb = q + b * qs.b + h * qs.h;
    const float* ob = dout + b * os.b + h * os.h;
    const float* stat = lse + ((long long)b * H + h) * T;
    const float* dstat = delta + ((long long)b * H + h) * T;
    for (int q0 = causal ? k0 : 0; q0 < T; q0 += BT32) {  // k0 is a multiple of BT32
      __syncthreads();
      load_tile_f32<D, LDS>(q_tile, qb, qs.t, q0, BT32, T, tid);
      load_tile_f32<D, LDS>(o_tile, ob, os.t, q0, BT32, T, tid);
      if (tid < BT32) {
        lse_s[tid] = q0 + tid < T ? stat[q0 + tid] : LSE_DEAD;
        delta_s[tid] = q0 + tid < T ? dstat[q0 + tid] : 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < BT32; ++j) {
        float dot = 0.0f, dpv = 0.0f;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          dot = fmaf(kr[i], q_tile[j * LDS + 4 * i + part], dot);
          dpv = fmaf(vr[i], o_tile[j * LDS + 4 * i + part], dpv);
        }
        dot = quad_sum(dot);
        dpv = quad_sum(dpv);
        const bool ok = krow < len && (!causal || krow <= q0 + j);
        const float p = ok ? expf(dot * scale - lse_s[j]) : 0.0f;
        const float ds = p * (dpv - delta_s[j]) * scale;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          dva[i] = fmaf(p, o_tile[j * LDS + 4 * i + part], dva[i]);
          dka[i] = fmaf(ds, q_tile[j * LDS + 4 * i + part], dka[i]);
        }
      }
    }
  }

  if (krow < S) {
    const long long o = (((long long)b * S + krow) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      dk[o + 4 * i + part] = dka[i];
      dv[o + 4 * i + part] = dva[i];
    }
  }
}

// ------------------------------------------- bf16, D in {64, 128}: TMA + wgmma
constexpr int TS = 64;              // rows of a streamed stage: keys (K5a), queries (K5b)
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LSE_DEAD_LOG2 = LSE_DEAD * LOG2E;

// Shared memory, 1024-byte aligned: the owned pair (Q and dO, or K and V) of
// 64 rows, then per stage the streamed pair of TS rows, every tile
// [D/64][rows][128 B] (a 4-D TMA box {64 d, 1 head, rows, 1 lane} per
// 64-column half, 128-byte swizzle); then K5b's lse and delta per stage;
// then the mbarriers.
template <int D>
constexpr int tma_smem_bytes() {
  return (2 * 64 + STAGES * 2 * TS) * D * 2 + STAGES * 2 * TS * 4 + (1 + STAGES) * 8 + 1024;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// a (B, rows, H, D) bf16 tensor read with plain loads
struct Rows {
  const __nv_bfloat16* p;
  Strides s;
};

// rowsum(do * out) of row r in f32: quad member t4 takes the 16-byte chunks
// t4, t4 + 4, ... of both rows, then the quad adds its four sums; a row at or
// past T gives 0 (every member still joins the shuffles)
template <int D>
__device__ __forceinline__ float row_delta(const Rows& dout, const Rows& out, int b, int h, int r,
                                           int T, int t4) {
  float acc = 0.0f;
  if (r < T) {
    const __nv_bfloat16* a = dout.p + b * dout.s.b + r * dout.s.t + h * dout.s.h;
    const __nv_bfloat16* o = out.p + b * out.s.b + r * out.s.t + h * out.s.h;
#pragma unroll
    for (int c = t4; c < D / 8; c += 4) {
      const uint4 av = *reinterpret_cast<const uint4*>(a + 8 * c);
      const uint4 ov = *reinterpret_cast<const uint4*>(o + 8 * c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(o2[i]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
  return quad_sum(acc);
}

// Register layouts (PTX ISA, wgmma m64nNk16, f32 accumulators): warp w of a
// warpgroup holds rows 16w + g and 16w + g + 8 (g = lane / 4); acc[4c + e]
// is row 16w + g, column 8c + 2t + e (t = lane % 4), acc[4c + 2 + e] the row
// below. The A registers of a 16-column step kk are the accumulator values
// of columns 16kk..16kk+15 packed in pairs: {4(2kk)+0,1}, {4(2kk)+2,3},
// {4(2kk+1)+0,1}, {4(2kk+1)+2,3} (K3's P.V uses the same order).
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// acc (64 x TS) = A (64 rows of an owned tile of `rows` rows) . B (a
// streamed tile of TS rows)^T, both K-major over D
template <int D>
__device__ __forceinline__ void product_kt(float (&acc)[TS / 2], uint32_t a, int rows,
                                           uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    hopper::wgmma_ss_bf16<TS>(acc, hopper::desc_sw128(a + (kk / 4) * rows * 128 + step, 16, 1024),
                              hopper::desc_sw128(bt + (kk / 4) * TS * 128 + step, 16, 1024),
                              kk > 0 ? 1 : 0);
  }
}

// acc (64 x D) += A (64 x TS, registers) . B (a streamed tile of TS rows x D,
// read MN-major from the same swizzled tile: LBO = the distance between its
// 64-column halves, SBO = the next 8 rows)
template <int D>
__device__ __forceinline__ void product_mn(float (&acc)[D / 2], const uint32_t (&a)[TS / 16][4],
                                           uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < TS / 16; ++kk) {
    hopper::wgmma_rs_bf16_tb<D>(acc, a[kk], hopper::desc_sw128(bt + kk * 16 * 128, TS * 128, 1024),
                                1);
  }
}

// Both kernels: one warpgroup a block, 64 owned rows, and no producer warp:
// thread 0 issues every TMA load (the owned pair once, then each stage as
// soon as the block has finished with it), so a block is 128 threads and two
// blocks fit an SM's registers (up to 255 a thread) and shared memory.

// K5a. Grid (H, B, query tiles of 64 rows); the tile index is reversed.
// With out.p set, delta is computed here and written; else it is read.
template <int D>
__global__ void __launch_bounds__(128, 2)
dq_tma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
       const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
       const float* __restrict__ lse, float* __restrict__ delta, Rows dout, Rows out,
       const int* __restrict__ lengths, __nv_bfloat16* __restrict__ dq, int T, int S, int H,
       int causal, float scale) {
  constexpr int HALVES = D / 64;
  constexpr int Q_BYTES = 64 * D * 2, KV_BYTES = TS * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* do_s = q_s + Q_BYTES;
  uint8_t* kv_s = do_s + Q_BYTES;           // stage s: K at 2s, V at 2s + 1
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kv_s + STAGES * 2 * KV_BYTES);
  uint64_t* full = qbar + 1;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;
  const int len = min(lengths[b], S);
  const int kend = causal ? min(len, q0 + 64) : len;     // keys that can be valid
  const int ntiles = kend > 0 ? (kend + TS - 1) / TS : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the K and V tiles of key tile j into stage j % STAGES (thread 0)
  auto load_kv = [&](int j) {
    uint8_t* ks = kv_s + (2 * (j % STAGES)) * KV_BYTES;
    uint64_t* bar = &full[j % STAGES];
    hopper::mbar_expect_tx(bar, 2 * KV_BYTES);    // whole boxes, zero fill included
    for (int hf = 0; hf < HALVES; ++hf) {
      hopper::tma_load_4d(ks + hf * TS * 128, &tm_k, bar, hf * 64, h, j * TS, b);
      hopper::tma_load_4d(ks + KV_BYTES + hf * TS * 128, &tm_v, bar, hf * 64, h, j * TS, b);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
    if (ntiles > 0) {
      hopper::mbar_expect_tx(qbar, 2 * Q_BYTES);
      for (int hf = 0; hf < HALVES; ++hf) {
        hopper::tma_load_4d(q_s + hf * 64 * 128, &tm_q, qbar, hf * 64, h, q0, b);
        hopper::tma_load_4d(do_s + hf * 64 * 128, &tm_do, qbar, hf * 64, h, q0, b);
      }
      for (int j = 0; j < min(STAGES, ntiles); ++j) load_kv(j);
    }
  }
  __syncthreads();

  // warp w holds query rows q0 + 16w + g and + 8 (g = lane / 4)
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long long srow = ((long long)b * H + h) * T;
  float dl0, dl1;
  if (out.p != nullptr) {
    dl0 = row_delta<D>(dout, out, b, h, r0, T, t4);
    dl1 = row_delta<D>(dout, out, b, h, r1, T, t4);
    if (t4 == 0 && r0 < T) delta[srow + r0] = dl0;
    if (t4 == 0 && r1 < T) delta[srow + r1] = dl1;
  } else {
    dl0 = r0 < T ? delta[srow + r0] : 0.0f;
    dl1 = r1 < T ? delta[srow + r1] : 0.0f;
  }
  const float ls0 = r0 < T ? lse[srow + r0] * LOG2E : LSE_DEAD_LOG2;
  const float ls1 = r1 < T ? lse[srow + r1] * LOG2E : LSE_DEAD_LOG2;
  const float scale_log2 = scale * LOG2E;
  const uint32_t q_a = hopper::smem_u32(q_s), do_a = hopper::smem_u32(do_s);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  if (ntiles > 0) hopper::mbar_wait(qbar, 0);

  for (int j = 0; j < ntiles; ++j) {        // every key tile holds a key <= q0
    const int s = j % STAGES, k0 = j * TS;
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);
    const uint32_t k_a = hopper::smem_u32(kv_s + (2 * s) * KV_BYTES);
    const uint32_t v_a = k_a + KV_BYTES;
    float sc[TS / 2], dp[TS / 2];
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    product_kt<D>(sc, q_a, 64, k_a);       // S = Q.K^T
    hopper::wgmma_commit();
    product_kt<D>(dp, do_a, 64, v_a);      // dP = dO.V^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();               // S is in; dP may still run
    hopper::fence_regs(sc);

    // p in place of s while dP runs, then ds; only a tile that crosses the
    // length or the diagonal is masked element by element
    const bool whole = k0 + TS <= len && (!causal || k0 + TS - 1 <= q0);
#pragma unroll
    for (int c = 0; c < TS / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * c + 2 * t4 + e;
        float p0 = exp2f(sc[4 * c + e] * scale_log2 - ls0);
        float p1 = exp2f(sc[4 * c + 2 + e] * scale_log2 - ls1);
        if (!whole) {
          if (!(col < len && (!causal || col <= r0))) p0 = 0.0f;
          if (!(col < len && (!causal || col <= r1))) p1 = 0.0f;
        }
        sc[4 * c + e] = p0;
        sc[4 * c + 2 + e] = p1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < TS / 2; ++i) {     // acc[4c + 2 + e] is row r1
      sc[i] = sc[i] * (dp[i] - (i & 2 ? dl1 : dl0)) * scale;
    }
    uint32_t da[TS / 16][4];               // ds rounded to bf16, as A registers
    pack_a<TS>(da, sc);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    product_mn<D>(acc, da, k_a);           // dQ += dS.K
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < TS / 16; ++kk) hopper::fence_regs(da[kk]);
    if (j + STAGES < ntiles) {               // refill the stage once every warp is done
      __syncthreads();
      if (tid == 0) load_kv(j + STAGES);
    }
  }

#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = 8 * c + 2 * t4;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(dq + (((long long)b * T + r0) * H + h) * D + col) =
          pack_bf16(acc[4 * c], acc[4 * c + 1]);
    }
    if (r1 < T) {
      *reinterpret_cast<uint32_t*>(dq + (((long long)b * T + r1) * H + h) * D + col) =
          pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
}

// K5b. Grid (H, B, key tiles of 64 rows), the first key tiles first. A stage
// holds Q and dO tiles of TS queries and their lse (in log2 units) and delta,
// which threads 0..TS-1 copy into shared memory with plain loads: the full
// barrier counts the block's 128 arrivals (thread 0's with the TMA bytes).
template <int D>
__global__ void __launch_bounds__(128, 2)
dkv_tma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const int* __restrict__ lengths, __nv_bfloat16* __restrict__ dk,
        __nv_bfloat16* __restrict__ dv, int T, int S, int H, int causal, float scale) {
  constexpr int HALVES = D / 64;
  constexpr int KV_BYTES = 64 * D * 2, Q_BYTES = TS * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);
  uint8_t* v_s = k_s + KV_BYTES;
  uint8_t* qd_s = v_s + KV_BYTES;           // stage s: Q at 2s, dO at 2s + 1
  float* lse_s = reinterpret_cast<float*>(qd_s + STAGES * 2 * Q_BYTES);   // [STAGES][TS]
  float* dlt_s = lse_s + STAGES * TS;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(dlt_s + STAGES * TS);
  uint64_t* full = kvbar + 1;

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * 64;
  const int len = min(lengths[b], S);
  const int qfirst = causal ? k0 / TS : 0;          // k0 is a multiple of TS
  const int ntiles = k0 < len ? max(0, (T + TS - 1) / TS - qfirst) : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* stat = lse + ((long long)b * H + h) * T;
  const float* dstat = delta + ((long long)b * H + h) * T;

  // lse and delta of row tid of query tile j (threads 0..TS-1), loaded a
  // tile ahead of their store so that no warp waits for them
  auto stats = [&](int j, float& l, float& dl) {
    const int r = (qfirst + j) * TS + tid;
    l = r < T ? stat[r] : LSE_DEAD;
    dl = r < T ? dstat[r] : 0.0f;
  };
  // query tile j into stage j % STAGES, by every thread of the block
  auto fill = [&](int j, float l, float dl) {
    const int s = j % STAGES, q0 = (qfirst + j) * TS;
    if (tid < TS) {
      lse_s[s * TS + tid] = l * LOG2E;
      dlt_s[s * TS + tid] = dl;
    }
    if (tid == 0) {
      uint8_t* qs = qd_s + (2 * s) * Q_BYTES;
      hopper::mbar_expect_tx(&full[s], 2 * Q_BYTES);
      for (int hf = 0; hf < HALVES; ++hf) {
        hopper::tma_load_4d(qs + hf * TS * 128, &tm_q, &full[s], hf * 64, h, q0, b);
        hopper::tma_load_4d(qs + Q_BYTES + hf * TS * 128, &tm_do, &full[s], hf * 64, h, q0, b);
      }
    } else {
      hopper::mbar_arrive(&full[s]);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 128);
    hopper::fence_barrier_init();
    if (ntiles > 0) {
      hopper::mbar_expect_tx(kvbar, 2 * KV_BYTES);
      for (int hf = 0; hf < HALVES; ++hf) {
        hopper::tma_load_4d(k_s + hf * 64 * 128, &tm_k, kvbar, hf * 64, h, k0, b);
        hopper::tma_load_4d(v_s + hf * 64 * 128, &tm_v, kvbar, hf * 64, h, k0, b);
      }
    }
  }
  __syncthreads();
  for (int j = 0; j < min(STAGES, ntiles); ++j) {
    float l = 0.0f, dl = 0.0f;
    if (tid < TS) stats(j, l, dl);
    fill(j, l, dl);
  }

  // warp w holds key rows k0 + 16w + g and + 8
  const int g = lane >> 2, t4 = lane & 3;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8, kl = k0 + 63;
  const float scale_log2 = scale * LOG2E;
  const uint32_t k_a = hopper::smem_u32(k_s), v_a = hopper::smem_u32(v_s);

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.0f;
  if (ntiles > 0) hopper::mbar_wait(kvbar, 0);

  for (int j = 0; j < ntiles; ++j) {        // causal: the first tile holds the diagonal
    const int s = j % STAGES, q0 = (qfirst + j) * TS;
    float next_l = 0.0f, next_dl = 0.0f;      // the statistics of tile j + STAGES
    if (tid < TS && j + STAGES < ntiles) stats(j + STAGES, next_l, next_dl);
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);
    const uint32_t q_a = hopper::smem_u32(qd_s + (2 * s) * Q_BYTES);
    const uint32_t o_a = q_a + Q_BYTES;
    float st[TS / 2], dpt[TS / 2];
    hopper::fence_regs(dka);
    hopper::fence_regs(dva);
    hopper::wgmma_fence();
    product_kt<D>(st, k_a, 64, q_a);       // S^T = K.Q^T
    hopper::wgmma_commit();
    product_kt<D>(dpt, v_a, 64, o_a);      // dP^T = V.dO^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();               // S^T is in; dP^T may still run
    hopper::fence_regs(st);

    // rows are keys, columns queries: p^T in place of s^T, then dV += P^T.dO
    // runs while ds^T forms in place of dp^T, then dK += dS^T.Q
    const bool whole = kl < len && (!causal || q0 >= kl) && q0 + TS <= T;
    const float* ls = lse_s + s * TS;
    const float* dls = dlt_s + s * TS;
#pragma unroll
    for (int c = 0; c < TS / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * c + 2 * t4 + e, col = q0 + qi;
        const float l2 = ls[qi];
        float p0 = exp2f(st[4 * c + e] * scale_log2 - l2);
        float p1 = exp2f(st[4 * c + 2 + e] * scale_log2 - l2);
        if (!whole) {
          if (!(kr0 < len && (!causal || kr0 <= col) && col < T)) p0 = 0.0f;
          if (!(kr1 < len && (!causal || kr1 <= col) && col < T)) p1 = 0.0f;
        }
        st[4 * c + e] = p0;
        st[4 * c + 2 + e] = p1;
      }
    }
    uint32_t pa[TS / 16][4], da[TS / 16][4];   // p^T and ds^T rounded to bf16
    pack_a<TS>(pa, st);
    hopper::fence_regs(dva);
    hopper::wgmma_fence();
    product_mn<D>(dva, pa, o_a);           // dV += P^T.dO
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();               // dP^T is in; dV may still run
    hopper::fence_regs(dpt);
#pragma unroll
    for (int c = 0; c < TS / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = dls[8 * c + 2 * t4 + e];
        dpt[4 * c + e] = st[4 * c + e] * (dpt[4 * c + e] - dl) * scale;
        dpt[4 * c + 2 + e] = st[4 * c + 2 + e] * (dpt[4 * c + 2 + e] - dl) * scale;
      }
    }
    pack_a<TS>(da, dpt);
    hopper::fence_regs(dka);
    hopper::wgmma_fence();
    product_mn<D>(dka, da, q_a);           // dK += dS^T.Q
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dka);
    hopper::fence_regs(dva);
#pragma unroll
    for (int kk = 0; kk < TS / 16; ++kk) {
      hopper::fence_regs(pa[kk]);
      hopper::fence_regs(da[kk]);
    }
    if (j + STAGES < ntiles) {               // refill the stage once every warp is done
      __syncthreads();
      fill(j + STAGES, next_l, next_dl);
    }
  }

#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = 8 * c + 2 * t4;
    if (kr0 < S) {
      const long long o = (((long long)b * S + kr0) * H + h) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[4 * c], dka[4 * c + 1]);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[4 * c], dva[4 * c + 1]);
    }
    if (kr1 < S) {
      const long long o = (((long long)b * S + kr1) * H + h) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[4 * c + 2], dka[4 * c + 3]);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[4 * c + 2], dva[4 * c + 3]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *out;
  const float* lse;
  float* delta;
  const int* lengths;
  int B, T, S, H;
  Strides qs, ks, vs, os, outs;
  int causal;
  float scale;
  bool bf16;
  cudaStream_t st;
};

// a (B, rows, H, D) bf16 tensor as a 4-D map {D, H, rows, B} over its
// strides (in elements), boxes of 64 values x box_rows rows
int encode_rows(CUtensorMap* map, const void* base, int D, int H, int rows, int B,
                const Strides& s, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.t) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  return hopper::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

// the maps of q, k, v, do; q and do in boxes of q_rows rows, k and v of kv_rows
int encode_all(CUtensorMap (&maps)[4], const Args& a, int D, int q_rows, int kv_rows) {
  int rc = encode_rows(&maps[0], a.q, D, a.H, a.T, a.B, a.qs, q_rows);
  if (rc == 0) rc = encode_rows(&maps[1], a.k, D, a.H, a.S, a.B, a.ks, kv_rows);
  if (rc == 0) rc = encode_rows(&maps[2], a.v, D, a.H, a.S, a.B, a.vs, kv_rows);
  if (rc == 0) rc = encode_rows(&maps[3], a.dout, D, a.H, a.T, a.B, a.os, q_rows);
  return rc;
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = e == cudaSuccess;
  return static_cast<int>(e);
}

// blocks of a TMA-route kernel that an SM holds at once (the design's two)
template <typename Kernel>
int resident_blocks(Kernel kernel, int smem, bool& configured) {
  int rc = set_smem(kernel, smem, configured), n = 0;
  if (rc == 0) rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 128, smem);
  return rc == 0 ? n : -rc;
}

template <int D>
bool dq_configured = false;
template <int D>
bool dkv_configured = false;

template <int D>
int launch_dq_tma(const Args& a, void* dq) {
  constexpr int SMEM = tma_smem_bytes<D>();
  int rc = set_smem(dq_tma<D>, SMEM, dq_configured<D>);
  CUtensorMap maps[4];
  if (rc == 0) rc = encode_all(maps, a, D, 64, TS);
  if (rc != 0) return rc;
  const dim3 grid(a.H, a.B, (a.T + 63) / 64);
  const Rows dout{static_cast<const __nv_bfloat16*>(a.dout), a.os};
  const Rows out{static_cast<const __nv_bfloat16*>(a.out), a.outs};
  dq_tma<D><<<grid, 128, SMEM, a.st>>>(maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, dout,
                                       out, a.lengths, static_cast<__nv_bfloat16*>(dq), a.T, a.S,
                                       a.H, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_tma(const Args& a, void* dk, void* dv) {
  constexpr int SMEM = tma_smem_bytes<D>();
  int rc = set_smem(dkv_tma<D>, SMEM, dkv_configured<D>);
  CUtensorMap maps[4];
  if (rc == 0) rc = encode_all(maps, a, D, TS, 64);
  if (rc != 0) return rc;
  const dim3 grid(a.H, a.B, (a.S + 63) / 64);
  dkv_tma<D><<<grid, 128, SMEM, a.st>>>(maps[0], maps[1], maps[2], maps[3], a.lse, a.delta,
                                        a.lengths, static_cast<__nv_bfloat16*>(dk),
                                        static_cast<__nv_bfloat16*>(dv), a.T, a.S, a.H, a.causal,
                                        a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  const dim3 grid((a.T + BQ - 1) / BQ, a.H, a.B);
  if (a.bf16) {
    dq_bf16<D><<<grid, THREADS_BF16, 0, a.st>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
        a.delta, a.lengths, static_cast<__nv_bfloat16*>(dq), a.T, a.S, a.H, a.qs, a.ks, a.vs,
        a.os, a.causal, a.scale);
  } else {
    dq_f32<D><<<grid, THREADS_F32, 0, a.st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        a.lengths, static_cast<float*>(dq), a.T, a.S, a.H, a.qs, a.ks, a.vs, a.os, a.causal,
        a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  if (a.bf16) {
    constexpr int smem = 4 * BQ * (D + 8) * 2 + 2 * BQ * 4;   // k, v, q, do tiles; lse, delta
    cudaError_t err = cudaFuncSetAttribute(dkv_bf16<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dkv_bf16<D><<<grid, THREADS_BF16, smem, a.st>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
        a.delta, a.lengths, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        a.T, a.S, a.H, a.qs, a.ks, a.vs, a.os, a.causal, a.scale);
  } else {
    dkv_f32<D><<<grid, THREADS_F32, 0, a.st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        a.lengths, static_cast<float*>(dk), static_cast<float*>(dv), a.T, a.S, a.H, a.qs, a.ks,
        a.vs, a.os, a.causal, a.scale);
  }
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* out,
               const void* lse, void* delta, const void* lengths, int B, int T, int S, int H,
               const long long* strides, int causal, float scale, int bf16, void* stream) {
  return Args{q, k, v, dout, out, static_cast<const float*>(lse), static_cast<float*>(delta),
              static_cast<const int*>(lengths), B, T, S, H,
              Strides{strides[0], strides[1], strides[2]},
              Strides{strides[3], strides[4], strides[5]},
              Strides{strides[6], strides[7], strides[8]},
              Strides{strides[9], strides[10], strides[11]},
              Strides{strides[12], strides[13], strides[14]}, causal, scale, bf16 != 0,
              static_cast<cudaStream_t>(stream)};
}

bool tma_route(int bf16, int D) { return bf16 != 0 && (D == 64 || D == 128); }

}  // namespace

// C interface, loaded with ctypes. ``strides`` points to 15 element strides
// on the host: batch, token, head of q, k, v, do and out. bf16 with D in
// {64, 128} runs dq_tma / dkv_tma, other bf16 head dims (16, 32) dq_bf16 /
// dkv_bf16, f32 dq_f32 / dkv_f32 (ops/flash_attention.py `_bwd_route` names
// the same choice). With ``out`` set (the TMA route only), K5a computes
// delta = rowsum(do * out) and writes it to ``delta``. Each function returns
// 0, the cudaError_t of its launch, or a tensor-map code of hopper.cuh.
extern "C" int flash_attention_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    void* delta, const void* lengths, void* dq, int B, int T, int S, int H, int D,
    const long long* strides, int causal, float scale, int bf16, void* stream,
    const void* out) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0) return 0;
  const Args a = make_args(q, k, v, dout, out, lse, delta, lengths, B, T, S, H, strides, causal,
                           scale, bf16, stream);
  if (tma_route(bf16, D)) return D == 64 ? launch_dq_tma<64>(a, dq) : launch_dq_tma<128>(a, dq);
  if (out != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch_dq<16>(a, dq);
    case 32: return launch_dq<32>(a, dq);
    case 64: return launch_dq<64>(a, dq);
    case 128: return launch_dq<128>(a, dq);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* lengths, void* dk, void* dv, int B, int T, int S, int H,
    int D, const long long* strides, int causal, float scale, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0) return 0;
  const Args a = make_args(q, k, v, dout, nullptr, lse, const_cast<void*>(delta), lengths, B, T,
                           S, H, strides, causal, scale, bf16, stream);
  if (tma_route(bf16, D)) {
    return D == 64 ? launch_dkv_tma<64>(a, dk, dv) : launch_dkv_tma<128>(a, dk, dv);
  }
  switch (D) {
    case 16: return launch_dkv<16>(a, dk, dv);
    case 32: return launch_dkv<32>(a, dk, dv);
    case 64: return launch_dkv<64>(a, dk, dv);
    case 128: return launch_dkv<128>(a, dk, dv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of dq_tma (dkv = 0) or dkv_tma (dkv = 1) at head dim D (64 or 128)
// that one SM holds at once, from the occupancy calculator; a negative
// value is a cudaError_t.
extern "C" int flash_attention_bwd_blocks_per_sm(int D, int dkv) {
  if (D != 64 && D != 128) return -static_cast<int>(cudaErrorInvalidValue);
  if (dkv) {
    return D == 64 ? resident_blocks(dkv_tma<64>, tma_smem_bytes<64>(), dkv_configured<64>)
                   : resident_blocks(dkv_tma<128>, tma_smem_bytes<128>(), dkv_configured<128>);
  }
  return D == 64 ? resident_blocks(dq_tma<64>, tma_smem_bytes<64>(), dq_configured<64>)
                 : resident_blocks(dq_tma<128>, tma_smem_bytes<128>(), dq_configured<128>);
}
