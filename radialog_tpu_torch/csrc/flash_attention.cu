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
// the memory would be the limit; so the least time is the bytes', and a
// simple kernel is held back by its instruction issue long before either.
// The design, simple first:
//   * bf16: one block of 4 warps per (64-query tile, head, lane); each warp
//     owns 16 query rows, keeps its q fragments in registers and walks
//     64-key tiles that cp.async stages in shared memory (rows padded by 8
//     values, so fragment loads hit 32 banks); q.k^T and p @ v are
//     mma.sync m16n8k16 bf16 -> f32, and the score accumulator fragment is
//     reused as p's operand fragment (FlashAttention-2's register trick);
//   * f32 (the mock's FP32 policy): 4 threads per query row split D, with
//     plain FMA loops over 32-key tiles in shared memory (no TF32);
//   * key tiles past min(S, len) or above the causal diagonal of the block
//     are never read; tail rows of q (T not a multiple of 64) and of the
//     keys are masked on load and on store.
// wgmma, TMA and a pipelined ring of tiles come in a later change.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// null. Returns the cudaError_t of the launch (0 on success).
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
