// Exact int32 product of int8 activations with int4 weights (per-column
// scales applied outside), for Hopper (sm_90a): the two W4A8 prototypes of
// tools/microbench_w4.py.
//
// Replaces the Pallas TPU kernels
//   T2  tools/microbench_w4.py:93 `_w4_kernel` (called through `_w4a8_tiled`):
//       the activations split into their even and odd K values, xlo/xhi
//       (M, K/2) int8, against the nibble pairs;
//   T3  tools/microbench_w4.py:153 `_w4p_kernel` (called through `_w4p_tiled`):
//       the whole activation row x (M, K) int8 against the int4 weight.
// Both compute acc[m, n] = sum_k x[m, k] * q[k, n] in int32, exactly, so
// both equal the plain version (radialog_tpu_torch/ops/w4_colscale.py) bit
// for bit. The per-column scale and the per-row activation scale are
// applied afterwards in PyTorch, as on the TPU.
//
// Layout (the port's own): w (N, K/2) bytes, byte j of row n holds q[2j, n]
// in its low nibble and q[2j+1, n] in its high nibble, two's complement.
//
// What bounds it on an H100: at decode (M = 32) a projection reads its int4
// weight once, K*N/2 bytes, for 2*M*N*K operations: 128 operations per
// byte, below the ~590 at which the int8 tensor cores become the limit; so
// it is bound by the weight bytes, and what counts is how many of them are
// in flight. The activations are small and come from L2.
//
// The design, K1's swapped decode route (csrc/q8_matmul.cu) with the weight
// unpacked in registers: C^T = Q . X^T. The ring, its producer warp and the
// unpack are w4_tma.cuh's, shared with K4 (csrc/q4_matmul.cu).
//   * The weight's output columns are wgmma's 64-row M side, one consumer
//     warpgroup per 64 weight rows, one or two a block: 64 rows give the
//     most blocks; 128, where the 64-row tiles would not fit the card at
//     once, let one stage of activations serve 128 weight rows and halve
//     the tiles (the plan's choice). The activation rows are wgmma's
//     N, padded to 8, 16, 32 or 64 by TMA's zero fill; more than 64 rows
//     are tiled over the grid in 64s, the row tile walking fastest so that
//     blocks in flight share one weight tile in L2.
//   * One producer warp, whose lane 0 keeps a ring of stages in flight with
//     TMA (128-byte swizzle, zero fill past every edge, one full and one
//     empty mbarrier a stage). The ring holds 3 to 8 stages of 256 K values
//     (~100 KB), two blocks an SM: 64-190 KB of packed weight in flight an
//     SM.
//   * A stage's 8 products are issued after all its A registers are
//     written and pinned (wgmma reads them asynchronously), then waited
//     for before the stage is released and the registers reused.
//   * Where the output tiles cannot fill the card (N = 4096 at decode) the
//     K range is split across blocks and the partial sums are added with
//     int32 atomics into a zeroed output; integer addition is associative,
//     so the result is bitwise the same in any order. Otherwise the
//     transposed accumulator is stored with masked 8-byte stores (two
//     neighbouring output columns, swapped between lanes) where N is even.
// The launch plan (wn, weight rows a block, stages, K splits) is chosen in
// Python (ops/w4_colscale.py `_plan`). K must be a multiple of 32 (16-byte
// packed rows: TMA's stride rule); operands are contiguous and 16-byte
// aligned; the wrapper checks it.

#include <cstdint>
#include <cuda_runtime.h>

#include "w4_tma.cuh"

namespace {

using w4::KB;

// SPLIT: T2 (tm_x = xlo, tm_xhi = xhi, each (M, K/2)); else T3 (tm_x = x,
// (M, K)). NWG consumer warpgroups x 64 weight rows; WN activation rows.
template <bool SPLIT, int NWG, int WN, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 2)
w4_tma_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_xhi, int32_t* __restrict__ C, int M, int N,
              int K, int ktiles_per_split, int use_atomic) {
  using S = w4::Stage<NWG, WN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = w4::ring_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * S::BYTES);
  uint64_t* empty = full + STAGES;

  const int ktiles = (K + 2 * KB - 1) / (2 * KB);
  const int kt0 = blockIdx.z * ktiles_per_split;
  const int nk = min(kt0 + ktiles_per_split, ktiles) - kt0;
  const int b0 = blockIdx.x * WN;       // activation rows
  const int a0 = blockIdx.y * S::ROWS;  // weight rows: output columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  w4::init_ring(full, empty, STAGES, NWG * 128);

  if (warp == NWG * 4) {   // the producer warp: lane 0 issues every load
    if (lane == 0) {
      w4::produce<SPLIT, NWG, WN, STAGES>(smem, full, empty, &tm_w, &tm_x, &tm_xhi, kt0, nk, a0,
                                          b0, K);
    }
    return;
  }

  // a consumer: warpgroup wg, warp wq of it; its rows 16 wq + g and + 8 of
  // the warpgroup's 64 both sit at swizzle phase g
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  int acc[WN / 2];
#pragma unroll
  for (int j = 0; j < WN / 2; ++j) acc[j] = 0;
  hopper::fence_regs(acc);
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* st = smem + s * S::BYTES;
    const uint8_t* r0 = st + (wg * 64 + wq * 16 + g) * KB;
    uint32_t a[8][4];
    w4::unpack<SPLIT>(a, r0, r0 + 8 * KB, g, t);
    const uint32_t sb = hopper::smem_u32(st + S::W_BYTES);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hopper::wgmma_rs_s8<WN>(acc, a[j],
                              hopper::desc_sw128(sb + (j / 4) * S::X_BYTES + (j % 4) * 32, 16, 1024),
                              1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) hopper::fence_regs(a[j]);
    hopper::mbar_arrive(&empty[s]);
  }

  // acc[4c + e]: weight row (output column) n0 + 8 (e >> 1), activation row
  // b0 + 8c + 2t + (e & 1); the sums are 16 times the product
  const int n0 = a0 + wg * 64 + wq * 16 + g;
  if (!use_atomic && (N & 1) == 0) {
    // lanes g and g ^ 1 swap a value, so each stores two neighbouring
    // columns of one output row in 8 bytes: even g (n0, n0 + 1), odd g
    // (n0 + 7, n0 + 8)
    const bool odd = g & 1;
    const int n = odd ? n0 + 7 : n0;
#pragma unroll
    for (int c = 0; c < WN / 8; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v0 = acc[4 * c + h] >> 4, v1 = acc[4 * c + 2 + h] >> 4;
        const int other = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        const int m = b0 + 8 * c + 2 * t + h;
        if (m < M && n < N) {
          *reinterpret_cast<int2*>(C + static_cast<size_t>(m) * N + n) =
              odd ? make_int2(other, v1) : make_int2(v0, other);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < WN / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = b0 + 8 * c + 2 * t + (e & 1), n = n0 + 8 * (e >> 1);
      if (m < M && n < N) {
        int32_t* dst = C + static_cast<size_t>(m) * N + n;
        if (use_atomic) {
          atomicAdd(dst, acc[4 * c + e] >> 4);
        } else {
          *dst = acc[4 * c + e] >> 4;
        }
      }
    }
  }
}

template <bool SPLIT, int NWG, int WN>
int launch(const void* x, const void* xhi, const void* w, int32_t* c, int m, int n, int k,
           int per, cudaStream_t stream) {
  constexpr int STAGES = w4::stages_of(NWG, WN), SMEM = w4::Stage<NWG, WN>::SMEM;
  static bool configured = false;
  int rc = w4::allow_smem(w4_tma_kernel<SPLIT, NWG, WN, STAGES>, SMEM, configured);
  CUtensorMap tw, tx, th;
  if (rc == 0) rc = w4::encode_maps<SPLIT, 64 * NWG, WN>(&tw, &tx, &th, x, xhi, w, m, n, k);
  if (rc != 0) return rc;
  const int ktiles = (k + 2 * KB - 1) / (2 * KB);
  const int splits = (ktiles + per - 1) / per;
  const dim3 grid((m + WN - 1) / WN, (n + 64 * NWG - 1) / (64 * NWG), splits);
  w4_tma_kernel<SPLIT, NWG, WN, STAGES><<<grid, NWG * 128 + 32, SMEM, stream>>>(
      tw, tx, th, c, m, n, k, per, splits > 1 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <bool SPLIT>
int dispatch(const void* x, const void* xhi, const void* w, void* c, int m, int n, int k, int wn,
             int rows, int stages, int per, void* stream) {
  auto* out = static_cast<int32_t*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || per <= 0 || k % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nwg = rows / 64;
  if ((rows != 64 && rows != 128) || stages != w4::stages_of(nwg, wn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nwg == 2) {
    if (wn == 8) return launch<SPLIT, 2, 8>(x, xhi, w, out, m, n, k, per, st);
    if (wn == 16) return launch<SPLIT, 2, 16>(x, xhi, w, out, m, n, k, per, st);
    if (wn == 32) return launch<SPLIT, 2, 32>(x, xhi, w, out, m, n, k, per, st);
    if (wn == 64) return launch<SPLIT, 2, 64>(x, xhi, w, out, m, n, k, per, st);
  } else {
    if (wn == 8) return launch<SPLIT, 1, 8>(x, xhi, w, out, m, n, k, per, st);
    if (wn == 16) return launch<SPLIT, 1, 16>(x, xhi, w, out, m, n, k, per, st);
    if (wn == 32) return launch<SPLIT, 1, 32>(x, xhi, w, out, m, n, k, per, st);
    if (wn == 64) return launch<SPLIT, 1, 64>(x, xhi, w, out, m, n, k, per, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, loaded with ctypes. T2: xlo, xhi (M, K/2) int8; T3: x (M, K)
// int8; w (N, K/2) packed nibbles; c (M, N) int32. The plan: wn in {8, 16,
// 32, 64} activation rows a block, rows in {64, 128} weight rows a block,
// stages as stages_of gives them, `per` K tiles of 256 values per split
// (more than one split requires c zeroed beforehand). Each returns 0, a
// cudaError_t, or a tensor-map code of hopper.cuh.
extern "C" int w4_int32_split_launch(const void* xlo, const void* xhi, const void* w, void* c,
                                     int m, int n, int k, int wn, int rows, int stages, int per,
                                     void* stream) {
  return dispatch<true>(xlo, xhi, w, c, m, n, k, wn, rows, stages, per, stream);
}

extern "C" int w4_int32_launch(const void* x, const void* w, void* c, int m, int n, int k, int wn,
                               int rows, int stages, int per, void* stream) {
  return dispatch<false>(x, nullptr, w, c, m, n, k, wn, rows, stages, per, stream);
}
