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
// cores become the limit (1979 TOP/s over 3.35 TB/s): decode is bound by
// the weight bytes, and what counts is how many weight bytes are in flight.
// A prefill (M = 56*80 = 4480) does ~4500 operations per byte and is bound
// by the tensor cores; only wgmma reaches their rate, and only if TMA keeps
// its operands arriving.
//
// The design. Both routes run one kernel, q8_tma_kernel: one producer warp
// whose lane 0 keeps a ring of STAGES tiles of 128 bytes of K in flight
// with TMA (128-byte swizzle, zero fill past every edge, completion on an
// mbarrier per stage), and one or two consumer warpgroups that run
// wgmma.m64nNk32.s32.s8.s8 on the tiles in shared memory, then release the
// stage on a second mbarrier. Int8 wgmma takes only K-major operands, and
// both are: activations (M,K) and weights (N,K) are row-major with K
// contiguous. The epilogue stores the int32 accumulator with masked
// st.global, 8 bytes a store where N is even (the lm_head's odd N gives
// rows that a TMA store could not take, and 4-byte stores).
//   * prefill and admission rows (M > 64): a 128 x 256 output tile, two
//     consumer warpgroups of 64 rows x 256 columns (128 int32 accumulators
//     a thread), 4 stages of 48 KB; where those tiles would leave half the
//     card empty (256 rows at N = 4096), 128 x 128 tiles and 6 stages of 32
//     KB, which need fewer K splits. The grid walks M fastest, so the
//     blocks in flight share one weight tile and the activations stay in
//     the 50 MB L2. With one producer warp the 288-thread block fits the
//     consumers' 128 accumulators in 154 registers a thread, no spill: no
//     setmaxnreg is needed.
//   * decode rows (M <= 64): the operands swap, C^T = W . X^T. 64 weight
//     rows fill wgmma's M, and the activation rows become its N, padded to
//     8, 16, 32 or 64 by TMA's zero fill. One consumer warpgroup, a ring of
//     6-8 stages (~96 KB) so two blocks an SM keep ~190 KB of weights in
//     flight.
//   * when the output tiles cannot fill the card (N = 4096 at decode: 64
//     tiles) the K range is split across blocks and the partial sums are
//     added with int32 atomics into a zeroed output. Integer addition is
//     associative, so the result is bitwise the same in any order.
// The launch plan (route, tile, stages, splits) is chosen in Python
// (ops/q8_matmul.py `_plan`). It replaces an mma.sync m16n8k32 kernel
// on a double-buffered cp.async ring, which the swapped route beats at
// every decode row count and the wgmma route by ~5x at M = 4480 (NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md). K
// must be a multiple of 16 (16-byte rows, TMA's stride rule); the wrapper
// checks it.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------ TMA + wgmma
constexpr int KT = 128;   // bytes of K per stage: one 128-byte swizzle row

// NWG consumer warpgroups x 64 rows of the A operand; WN rows of the B
// operand. Without SWAP, A = activations (M rows) and B = weights (N rows);
// with SWAP, A = weights and B = activations, and C is written transposed.
template <int NWG, int WN, int STAGES, bool SWAP>
__global__ void __launch_bounds__(NWG * 128 + 32)
q8_tma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
              int32_t* __restrict__ C, int M, int N, int K, int ktiles_per_split,
              int use_atomic) {
  constexpr int BMA = 64 * NWG;
  constexpr int A_BYTES = BMA * KT, B_BYTES = WN * KT, STAGE = A_BYTES + B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int ktiles = (K + KT - 1) / KT;
  const int kt0 = blockIdx.z * ktiles_per_split;
  const int nk = min(kt0 + ktiles_per_split, ktiles) - kt0;
  const int a0 = blockIdx.x * BMA, b0 = blockIdx.y * WN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NWG * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {   // the producer warp: lane 0 issues every load
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) hopper::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        uint8_t* st = smem + s * STAGE;
        hopper::mbar_expect_tx(&full[s], STAGE);   // whole boxes, zero fill included
        const int kc = (kt0 + i) * KT;
        hopper::tma_load_2d(st, &tm_a, &full[s], kc, a0);
        hopper::tma_load_2d(st + A_BYTES, &tm_b, &full[s], kc, b0);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  int acc[WN / 2];
#pragma unroll
  for (int j = 0; j < WN / 2; ++j) acc[j] = 0;
  hopper::fence_regs(acc);
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t sa = hopper::smem_u32(smem + s * STAGE) + wg * 64 * KT;
    const uint32_t sb = hopper::smem_u32(smem + s * STAGE + A_BYTES);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 32; ++kk) {
      hopper::wgmma_s8<WN>(acc, hopper::desc_sw128(sa + kk * 32, 16, 1024),
                           hopper::desc_sw128(sb + kk * 32, 16, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();           // the previous stage's products are done
    if (i > 0) hopper::mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // accumulator layout of m64nN: warp w of the group owns rows 16w..16w+15;
  // acc[4c + e] is row g + 8 (e >> 1), column 8c + 2t + (e & 1)
  const int g = lane >> 2, t = lane & 3;
  const int ra = a0 + wg * 64 + (warp & 3) * 16 + g;
  if (!SWAP && !use_atomic && (N & 1) == 0) {
    // a thread's two neighbouring columns as one 8-byte store (even N keeps
    // every row 8-byte aligned)
#pragma unroll
    for (int c = 0; c < WN / 8; ++c) {
      const int n = b0 + 8 * c + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = ra + 8 * r;
        if (m < M && n < N) {
          *reinterpret_cast<int2*>(C + static_cast<size_t>(m) * N + n) =
              make_int2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < WN / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = ra + 8 * (e >> 1);
      const int j = b0 + 8 * c + 2 * t + (e & 1);
      const int m = SWAP ? j : i, n = SWAP ? i : j;
      if (m < M && n < N) {
        int32_t* dst = C + static_cast<size_t>(m) * N + n;
        if (use_atomic) {
          atomicAdd(dst, acc[4 * c + e]);
        } else {
          *dst = acc[4 * c + e];
        }
      }
    }
  }
}

template <int NWG, int WN, int STAGES, bool SWAP>
int launch_tma(const int8_t* x, const int8_t* w, int32_t* c, int m, int n, int k, int per,
               cudaStream_t stream) {
  constexpr int BMA = 64 * NWG;
  constexpr int SMEM = STAGES * (BMA + WN) * KT + 2 * STAGES * 8 + 1024;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(q8_tma_kernel<NWG, WN, STAGES, SWAP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  // activations (M,K) and weights (N,K): dims innermost first, row stride K bytes
  CUtensorMap tx, tw;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t xbox[2] = {KT, static_cast<cuuint32_t>(SWAP ? WN : BMA)};
  const cuuint32_t wbox[2] = {KT, static_cast<cuuint32_t>(SWAP ? BMA : WN)};
  int rc = hopper::encode(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xdims, stride, xbox);
  if (rc == 0) rc = hopper::encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, stride, wbox);
  if (rc != 0) return rc;
  const int ktiles = (k + KT - 1) / KT;
  const int splits = (ktiles + per - 1) / per;
  const int rows_a = SWAP ? n : m, rows_b = SWAP ? m : n;
  const dim3 grid((rows_a + BMA - 1) / BMA, (rows_b + WN - 1) / WN, splits);
  q8_tma_kernel<NWG, WN, STAGES, SWAP><<<grid, NWG * 128 + 32, SMEM, stream>>>(
      SWAP ? tw : tx, SWAP ? tx : tw, c, m, n, k, per, splits > 1 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. swap 0: prefill rows (wn 256 with 4
// stages, or 128 with 6); swap 1: decode rows, the operands swapped (wn in {8, 16, 32,
// 64}; 8 stages, 6 at wn 64). `per` K tiles of 128 bytes per split; more
// than one split requires C zeroed beforehand. Returns 0, a cudaError_t, or
// a tensor-map code of hopper.cuh.
extern "C" int q8_gemm_s8s8s32(const void* a, const void* b, void* c, int m, int n, int k,
                               int swap, int wn, int stages, int per, void* stream) {
  const auto* x = static_cast<const int8_t*>(a);
  const auto* w = static_cast<const int8_t*>(b);
  auto* out = static_cast<int32_t*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || per <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!swap && wn == 256 && stages == 4) {
    return launch_tma<2, 256, 4, false>(x, w, out, m, n, k, per, st);
  }
  if (!swap && wn == 128 && stages == 6) {
    return launch_tma<2, 128, 6, false>(x, w, out, m, n, k, per, st);
  }
  if (swap) {
    if (wn == 8 && stages == 8) return launch_tma<1, 8, 8, true>(x, w, out, m, n, k, per, st);
    if (wn == 16 && stages == 8) return launch_tma<1, 16, 8, true>(x, w, out, m, n, k, per, st);
    if (wn == 32 && stages == 8) return launch_tma<1, 32, 8, true>(x, w, out, m, n, k, per, st);
    if (wn == 64 && stages == 6) return launch_tma<1, 64, 6, true>(x, w, out, m, n, k, per, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
