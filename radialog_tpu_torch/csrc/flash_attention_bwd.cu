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
// q, do are (B,T,H,D), k, v (B,S,H,D), read through their batch, token and
// head strides (last dim dense, rows 16-byte aligned); lse and delta are
// dense (B,H,T) f32; dq (B,T,H,D) and dk, dv (B,S,H,D) are dense. There is
// no lane-broadcast copy of lse/delta, no padding of T or S in memory and no
// transposed copy.
//
// What bounds them on an H100: at the training shape (B=2, T=S=600, H=32,
// D=128, bf16) each kernel does 6*H*D*pairs operations (three products over
// the ~180k valid (query, key) pairs of a lane) on ~50 MB, about 150
// operations per byte: below the 295 at which the tensor cores would be the
// limit, so the least time is the bytes'. A simple kernel is held back by
// its shared-memory loads and instruction rate long before either.
// The design, simple first, and deterministic (no float atomics: every
// output row has one owner, which walks the other axis in order):
//   * K5a, bf16: one block of 4 warps per (64-query tile, head, lane); a
//     warp owns 16 query rows, keeps its q and do fragments in registers and
//     walks 64-key tiles of k and v that cp.async stages in shared memory;
//     q.k^T and do.v^T are mma.sync m16n8k16 bf16 -> f32, ds is rounded to
//     bf16 in the accumulator layout and reused as the A fragment of ds @ k;
//   * K5b, bf16: one block per (64-key tile, head, lane) holds its k and v
//     tile in shared memory and walks 64-query tiles of q and do (with their
//     lse and delta); a warp owns 16 key rows and computes the transposed
//     tiles s^T = k.q^T and dp^T = v.do^T, so that p^T and ds^T are already A
//     fragments of p^T @ do and ds^T @ q; 70 KB of dynamic shared memory;
//   * f32 (the mock's FP32 policy): 4 threads per owned row split D, plain
//     FMA loops over 32-row tiles in shared memory (no TF32);
//   * tiles wholly past min(S, len) or wholly on the masked side of the
//     causal diagonal are never read; a key tile past the length writes
//     zeros; tails (T, S no multiple of 64) are masked on load and store.
// wgmma, TMA, a pipelined ring of tiles and ldmatrix come in a later change.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* lengths;
  int B, T, S, H;
  Strides qs, ks, vs, os;
  int causal;
  float scale;
  bool bf16;
  cudaStream_t st;
};

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

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* lengths, int B, int T, int S, int H,
               const long long* strides, int causal, float scale, int bf16, void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
              static_cast<const int*>(lengths), B, T, S, H,
              Strides{strides[0], strides[1], strides[2]},
              Strides{strides[3], strides[4], strides[5]},
              Strides{strides[6], strides[7], strides[8]},
              Strides{strides[9], strides[10], strides[11]}, causal, scale, bf16 != 0,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// C interface, loaded with ctypes. ``strides`` points to 12 element strides
// on the host: batch, token, head of q, k, v and do. Each function returns
// the cudaError_t of its launch (0 on success). Head dims 16, 32, 64, 128.
extern "C" int flash_attention_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* lengths, void* dq, int B, int T, int S, int H, int D,
    const long long* strides, int causal, float scale, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0) return 0;
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, B, T, S, H, strides, causal,
                           scale, bf16, stream);
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
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, B, T, S, H, strides, causal,
                           scale, bf16, stream);
  switch (D) {
    case 16: return launch_dkv<16>(a, dk, dv);
    case 32: return launch_dkv<32>(a, dk, dv);
    case 64: return launch_dkv<64>(a, dk, dv);
    case 128: return launch_dkv<128>(a, dk, dv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
