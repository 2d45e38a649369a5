// W8A8 GEMM for Hopper (sm_90a): int8 (M,K) x int8 (N,K)^T -> int32 (M,N).
//
// Replaces the Pallas TPU kernel radialog_tpu/ops/q8_matmul.py `_kernel`
// (called through `_w8a8_tiled`). Like it, this kernel computes only the
// exact int32 accumulator; the per-row activation scale, per-channel weight
// scale and bias are applied afterwards in PyTorch
// (radialog_tpu_torch/ops/q8_matmul.py `_finish`).
//
// What bounds it on an H100: at decode (M = batch = 56) every projection
// reads its whole int8 weight once for 2*M*N*K operations, ~112 operations
// per byte, far below the ~590 int8 operations per byte at which the tensor
// cores become the limit (1979 TOP/s over 3.35 TB/s). So decode is bound by
// the weight bytes; prefill (M = 56*80) is bound by the tensor cores.
//
// Design (simple and exact first):
//   * weights stay int8 (N, K) row-major, K contiguous: the "col" operand
//     of mma.sync m16n8k32 s8, loaded without any transpose;
//   * a 128-thread block computes a 64x64 output tile; each warp a 32x32
//     sub-tile as 2x4 mma.sync.m16n8k32 s8 -> s32 instructions;
//   * the K loop double-buffers 64-deep A and B tiles in shared memory with
//     16-byte cp.async copies; rows are padded to 80 bytes so the fragment
//     reads are free of bank conflicts;
//   * M is tiled by 64, never padded to a larger tile, so a decode step
//     reads each weight byte once per 64 rows of M (once at M = 56);
//   * ragged M, N (lm_head N = 32001 is odd) and K edges are masked by
//     zero-filled copies (cp.async with src-size 0) and masked stores;
//   * when the output has too few tiles to fill 132 SMs (N = 4096 at
//     decode: 64 tiles) the K range is split across blocks and the partial
//     sums are added with int32 atomics into a zeroed output. Integer
//     addition is associative, so the result is bit-identical in any order.
// K must be a multiple of 16 (16-byte rows); the wrapper checks it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = 80;  // padded shared-memory row stride in bytes

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

__global__ void __launch_bounds__(128)
q8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               int32_t* __restrict__ C, int M, int N, int K, int ktiles_per_split,
               int use_atomic) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * ktiles_per_split;
  const int kt1 = min(kt0 + ktiles_per_split, ktiles);
  const int nk = kt1 - kt0;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  auto load_tile = [&](int stage, int kt) {
    const int kbase = kt * BK;
#pragma unroll
    for (int c = tid; c < BM * (BK / 16); c += 128) {
      const int r = c >> 2;
      const int col = (c & 3) * 16;
      const int gk = kbase + col;
      const bool kin = gk < K;
      const int gks = kin ? gk : 0;
      const int gm = m0 + r;
      const bool min_ = kin && gm < M;
      cp_async16(&As[stage][r * LDS + col], A + (size_t)(min_ ? gm : 0) * K + gks, min_ ? 16 : 0);
      const int gn = n0 + r;
      const bool nin = kin && gn < N;
      cp_async16(&Bs[stage][r * LDS + col], B + (size_t)(nin ? gn : 0) * K + gks, nin ? 16 : 0);
    }
  };

  if (nk > 0) {
    load_tile(0, kt0);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    const int st = i & 1;
    if (i + 1 < nk) {
      load_tile(st ^ 1, kt0 + i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* as = As[st];
    const int8_t* bs = Bs[st];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&as[r * LDS + kk + t * 4]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&as[(r + 8) * LDS + kk + t * 4]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&as[r * LDS + kk + 16 + t * 4]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&as[(r + 8) * LDS + kk + 16 + t * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(&bs[n * LDS + kk + t * 4]);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(&bs[n * LDS + kk + 16 + t * 4]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm + mi * 16 + g;
      const int col = n0 + wn + ni * 8 + t * 2;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = row + (c >> 1) * 8;
        const int cc = col + (c & 1);
        if (rr < M && cc < N) {
          int32_t* dst = C + (size_t)rr * N + cc;
          if (use_atomic) {
            atomicAdd(dst, acc[mi][ni][c]);
          } else {
            *dst = acc[mi][ni][c];
          }
        }
      }
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. `splits` > 1 requires C zeroed beforehand.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int q8_gemm_s8s8s32(const void* a, const void* b, void* c, int m, int n, int k,
                               int splits, void* stream) {
  const int ktiles = (k + BK - 1) / BK;
  if (splits < 1) splits = 1;
  if (splits > ktiles) splits = ktiles;
  const int per = (ktiles + splits - 1) / splits;
  splits = (ktiles + per - 1) / per;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  q8_gemm_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int32_t*>(c), m,
      n, k, per, splits > 1 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
