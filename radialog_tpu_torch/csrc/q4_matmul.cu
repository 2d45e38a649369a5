// W4A8 GEMM for Hopper (sm_90a): int8 activations (M,K) x nibble-packed int4
// weights (N,K/2) with group-wise f32 scales and offsets -> f32 (M,N).
//
// Replaces the Pallas TPU kernel radialog_tpu/ops/q4_matmul.py `_make_kernel`
// (called through `_w4a8_tiled`). Like it, this kernel computes, for every
// scale group g of `group` consecutive K rows, in K order,
//   acc[m,n] += f32(sum_k x8[m,k] * q[k,n]) * gscale[g,n]
//               (+ f32(sum_k x8[m,k]) * goff[g,n]   on the asymmetric grid)
// into one f32 accumulator; the per-row activation scale and the bias are
// applied afterwards in PyTorch (radialog_tpu_torch/ops/q4_matmul.py
// `_matmul`). Each group's integer sums are exact. The f32 products and sums
// are single rounded operations in that order (`__fmul_rn`, `__fadd_rn`, no
// fused multiply-add), so the result is the plain version's bit for bit and
// the same from run to run: K is never split across blocks.
//
// Layout (the port's own): byte j of weight row n holds q[2j] in its low
// nibble and q[2j+1] in its high nibble, two's complement, codes in [-8, 7].
// gscale/goff are (G, N) f32 with G >= ceil(K / group).
//
// What bounds it on an H100: at decode (M = 16..56) a projection reads its
// int4 weight once, K*N/2 bytes, for 2*M*N*K operations: 64-224 operations
// per byte, below the ~590 at which the int8 tensor cores become the limit.
// So decode is bound by the weight bytes, prefill (M >= 256) by the tensor
// cores.
//
// Design (simple and exact first):
//   * a 128-thread block computes a 64 x 32 output tile, each warp 16 rows
//     x 32 columns as 4 mma.sync.m16n8k32 s8 instructions per 32 K values;
//     the narrow N tile gives N = 4096 128 blocks for 132 SMs without
//     splitting K;
//   * the K loop runs a 3-stage ring of 128-deep tiles in shared memory,
//     filled by 16-byte cp.async copies (A 64 x 128 bytes, B 32 x 64 bytes);
//     row strides of 160 and 80 bytes keep the fragment reads free of bank
//     conflicts;
//   * nibbles are unpacked in registers: one 32-bit word holds 8 codes; its
//     low nibbles (K values 0,2,4,6 of the word) become the first B register
//     and its high nibbles (1,3,5,7) the second. The A registers pick the
//     same K values out of 8 consecutive activation bytes with two byte
//     permutes, so the activations need no even/odd split in memory;
//   * the unpack needs no sign extension: nibble ^ 8 is the code plus 8, in
//     [0, 15]. The tensor cores sum x * (q + 8); a fifth mma against a
//     register of ones gives the group's activation row sums (needed anyway
//     for the offset term), and sum x*q = sum x*(q+8) - 8 * rowsum, exact;
//   * ragged M, N and K edges are masked by zero-filled copies (cp.async
//     with src-size 0) and masked stores. A zero activation contributes
//     nothing, whatever the weight byte beside it.
// K must be a multiple of 32 (16-byte weight rows) and `group` a multiple of
// 128 (a K tile never straddles two groups); the wrapper checks both.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 32;
constexpr int BK = 128;          // K values per stage
constexpr int LDA = BK + 32;     // A row stride in bytes
constexpr int LDB = BK / 2 + 16; // B row stride in bytes
constexpr int STAGES = 3;
constexpr int THREADS = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS)
q4_gemm_kernel(const int8_t* __restrict__ A, const uint8_t* __restrict__ W,
               const float* __restrict__ gscale, const float* __restrict__ goff,
               float* __restrict__ C, int M, int N, int K, int group) {
  __shared__ __align__(16) int8_t As[STAGES][BM * LDA];
  __shared__ __align__(16) uint8_t Bs[STAGES][BN * LDB];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int tiles_per_group = group / BK;
  const int K2 = K / 2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp * 16;
  const int g = lane >> 2;
  const int t = lane & 3;

  int acc[4][4];
  int rs[4];          // the group's activation row sums; rs[0] row g, rs[2] row g + 8
  float facc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    rs[j] = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[j][c] = 0;
      facc[j][c] = 0.0f;
    }
  }

  auto load_tile = [&](int stage, int kt) {
    const int kbase = kt * BK;
#pragma unroll
    for (int c = tid; c < BM * (BK / 16); c += THREADS) {
      const int r = c >> 3;
      const int col = (c & 7) * 16;
      const int gk = kbase + col;
      const int gm = m0 + r;
      const bool in = gk < K && gm < M;
      cp_async16(&As[stage][r * LDA + col], A + (size_t)(in ? gm : 0) * K + (in ? gk : 0),
                 in ? 16 : 0);
    }
    {
      const int r = tid >> 2;
      const int col = (tid & 3) * 16;          // bytes: 32 K values
      const int gb = kbase / 2 + col;
      const int gn = n0 + r;
      const bool in = gb < K2 && gn < N;
      cp_async16(&Bs[stage][r * LDB + col], W + (size_t)(in ? gn : 0) * K2 + (in ? gb : 0),
                 in ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }

  const uint32_t ones[2] = {0x01010101u, 0x01010101u};
  for (int i = 0; i < ktiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();            // tile i has landed; tile i - 1 is consumed by every warp
    if (i + STAGES - 1 < ktiles) load_tile((i + STAGES - 1) % STAGES, i + STAGES - 1);
    cp_async_commit();

    const int8_t* as = As[i % STAGES];
    const uint8_t* bs = Bs[i % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // 8 consecutive activations of rows g and g + 8, split into the even
      // and the odd K values of the weight word this thread unpacks
      const uint2 lo = *reinterpret_cast<const uint2*>(&as[(wm + g) * LDA + kk + t * 8]);
      const uint2 hi = *reinterpret_cast<const uint2*>(&as[(wm + g + 8) * LDA + kk + t * 8]);
      uint32_t af[4];
      af[0] = __byte_perm(lo.x, lo.y, 0x6420);
      af[1] = __byte_perm(hi.x, hi.y, 0x6420);
      af[2] = __byte_perm(lo.x, lo.y, 0x7531);
      af[3] = __byte_perm(hi.x, hi.y, 0x7531);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(&bs[(ni * 8 + g) * LDB + kk / 2 + t * 4]);
        uint32_t bf[2];
        bf[0] = (w & 0x0f0f0f0fu) ^ 0x08080808u;
        bf[1] = ((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u;
        mma_s8(acc[ni], af, bf);
      }
      mma_s8(rs, af, ones);
    }

    if ((i + 1) % tiles_per_group == 0 || i + 1 == ktiles) {
      // the group ends: rescale its integer sums into the f32 accumulator
      const int grp = i / tiles_per_group;
      const float* gs = gscale + (size_t)grp * N;
      const float* go = goff == nullptr ? nullptr : goff + (size_t)grp * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n0 + ni * 8 + t * 2 + (c & 1);
          const int rowsum = rs[c & 2];
          if (n < N) {
            float upd = __fmul_rn(static_cast<float>(acc[ni][c] - 8 * rowsum), gs[n]);
            if (go != nullptr) upd = __fadd_rn(upd, __fmul_rn(static_cast<float>(rowsum), go[n]));
            facc[ni][c] = __fadd_rn(facc[ni][c], upd);
          }
          acc[ni][c] = 0;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) rs[j] = 0;
    }
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = m0 + wm + g + (c >> 1) * 8;
      const int n = n0 + ni * 8 + t * 2 + (c & 1);
      if (row < M && n < N) C[(size_t)row * N + n] = facc[ni][c];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. a (M,K) int8; w (N,K/2) packed nibbles;
// gscale (G,N) f32; goff (G,N) f32 or nullptr (symmetric grid); c (M,N) f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int q4_gemm_s8s4f32(const void* a, const void* w, const void* gscale,
                               const void* goff, void* c, int m, int n, int k, int group,
                               void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  q4_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const uint8_t*>(w),
      static_cast<const float*>(gscale), static_cast<const float*>(goff),
      static_cast<float*>(c), m, n, k, group);
  return static_cast<int>(cudaGetLastError());
}
