// Exact int32 product of int8 activations with int4 weights (per-column
// scales applied outside), for Hopper (sm_90a): the two W4A8 prototypes of
// tools/microbench_w4.py.
//
// Replaces the Pallas TPU kernels
//   T2  tools/microbench_w4.py `_w4_kernel`  (called through `_w4a8_tiled`):
//       the activations split into their even and odd K values, xlo/xhi
//       (M, K/2) int8, against the nibble pairs;
//   T3  tools/microbench_w4.py `_w4p_kernel` (called through `_w4p_tiled`):
//       the whole activation row x (M, K) int8 against the int4 weight.
// Both compute acc[m, n] = sum_k x[m, k] * q[k, n] in int32, exactly, so
// both equal the plain version (radialog_tpu_torch/ops/w4_colscale.py) bit
// for bit. The per-column scale and the per-row activation scale are
// applied afterwards in PyTorch, as on the TPU.
//
// Layout (the port's own): w (N, K/2) bytes, byte j of row n holds q[2j, n]
// in its low nibble and q[2j+1, n] in its high nibble, two's complement;
// the codes are in [-7, 7].
//
// What bounds it on an H100: at decode (M = 32) a projection reads its int4
// weight once, K*N/2 bytes, for 2*M*N*K operations: 128 operations per
// byte, below the ~590 at which the int8 tensor cores become the limit; so
// it is bound by the weight bytes.
//
// Design (K4's, csrc/q4_matmul.cu, without the groups):
//   * a 128-thread block computes a 64 x 32 output tile, each warp 16 rows x
//     32 columns as 4 mma.sync.m16n8k32 s8 instructions per 32 K values;
//   * a 3-stage ring of 128-deep K tiles in shared memory, filled by 16-byte
//     cp.async copies with zero fill past the edges of M, N and K (a zero
//     activation adds nothing, whatever the weight byte beside it);
//   * one 32-bit weight word holds 8 codes: its low nibbles (the even K
//     values) become the first B register and its high nibbles (the odd
//     ones) the second, each sign-extended per byte as (v ^ 8) - 8;
//   * the A registers hold the same K values: T3 picks the even and the odd
//     bytes of 8 consecutive activations with two byte permutes; T2 reads
//     4 consecutive bytes of xlo and of xhi, which are those values already.
// K must be a multiple of 32 (16-byte weight rows); the wrapper checks it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 32;
constexpr int BK = 128;          // K values per stage
constexpr int LDA = BK + 32;     // whole-row A stride in bytes (T3)
constexpr int LDH = BK / 2 + 16; // half-row A stride in bytes (T2: xlo, xhi)
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

// four signed nibbles (one per byte, in [0, 15] as stored) -> four int8
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return __vsub4(v ^ 0x08080808u, 0x08080808u);
}

// SPLIT: T2 (A = xlo, xhi, each (M, K/2)); else T3 (A = x, (M, K)).
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS)
w4_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Ahi,
          const uint8_t* __restrict__ W, int* __restrict__ C, int M, int N, int K) {
  constexpr int A_BYTES = SPLIT ? 2 * BM * LDH : BM * LDA;
  __shared__ __align__(16) int8_t As[STAGES][A_BYTES];
  __shared__ __align__(16) uint8_t Bs[STAGES][BN * LDB];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int K2 = K / 2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp * 16;
  const int g = lane >> 2;
  const int t = lane & 3;

  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0;

  auto load_tile = [&](int stage, int kt) {
    const int kbase = kt * BK;
    if (SPLIT) {
      // xlo then xhi: 64 rows x 64 bytes each, 16 bytes a copy
#pragma unroll
      for (int c = tid; c < 2 * BM * (BK / 32); c += THREADS) {
        const int half = c / (BM * (BK / 32));
        const int r = (c >> 2) % BM;
        const int col = (c & 3) * 16;
        const int gb = kbase / 2 + col;
        const int gm = m0 + r;
        const bool in = gb < K2 && gm < M;
        const int8_t* src = half ? Ahi : A;
        cp_async16(&As[stage][half * BM * LDH + r * LDH + col],
                   src + (size_t)(in ? gm : 0) * K2 + (in ? gb : 0), in ? 16 : 0);
      }
    } else {
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

  for (int i = 0; i < ktiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();            // tile i has landed; tile i - 1 is consumed by every warp
    if (i + STAGES - 1 < ktiles) load_tile((i + STAGES - 1) % STAGES, i + STAGES - 1);
    cp_async_commit();

    const int8_t* as = As[i % STAGES];
    const uint8_t* bs = Bs[i % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4];
      if (SPLIT) {
        // the even K values kk + t*8 + {0,2,4,6} are xlo bytes kk/2 + t*4 + {0..3}
        const int8_t* lo = as;
        const int8_t* hi = as + BM * LDH;
        af[0] = *reinterpret_cast<const uint32_t*>(&lo[(wm + g) * LDH + kk / 2 + t * 4]);
        af[1] = *reinterpret_cast<const uint32_t*>(&lo[(wm + g + 8) * LDH + kk / 2 + t * 4]);
        af[2] = *reinterpret_cast<const uint32_t*>(&hi[(wm + g) * LDH + kk / 2 + t * 4]);
        af[3] = *reinterpret_cast<const uint32_t*>(&hi[(wm + g + 8) * LDH + kk / 2 + t * 4]);
      } else {
        // 8 consecutive activations of rows g and g + 8, split into the even
        // and the odd K values of the weight word this thread unpacks
        const uint2 r0 = *reinterpret_cast<const uint2*>(&as[(wm + g) * LDA + kk + t * 8]);
        const uint2 r8 = *reinterpret_cast<const uint2*>(&as[(wm + g + 8) * LDA + kk + t * 8]);
        af[0] = __byte_perm(r0.x, r0.y, 0x6420);
        af[1] = __byte_perm(r8.x, r8.y, 0x6420);
        af[2] = __byte_perm(r0.x, r0.y, 0x7531);
        af[3] = __byte_perm(r8.x, r8.y, 0x7531);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(&bs[(ni * 8 + g) * LDB + kk / 2 + t * 4]);
        uint32_t bf[2];
        bf[0] = sext_nibbles(w & 0x0f0f0f0fu);
        bf[1] = sext_nibbles((w >> 4) & 0x0f0f0f0fu);
        mma_s8(acc[ni], af, bf);
      }
    }
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = m0 + wm + g + (c >> 1) * 8;
      const int n = n0 + ni * 8 + t * 2 + (c & 1);
      if (row < M && n < N) C[(size_t)row * N + n] = acc[ni][c];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. T2: xlo, xhi (M, K/2) int8; T3: x (M, K)
// int8; w (N, K/2) packed nibbles; c (M, N) int32. Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int w4_int32_split_launch(const void* xlo, const void* xhi, const void* w, void* c,
                                     int m, int n, int k, void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  w4_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xlo), static_cast<const int8_t*>(xhi),
      static_cast<const uint8_t*>(w), static_cast<int*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int w4_int32_launch(const void* x, const void* w, void* c, int m, int n, int k,
                               void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  w4_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), nullptr, static_cast<const uint8_t*>(w),
      static_cast<int*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
