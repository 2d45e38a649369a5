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
// unpacked in registers: C^T = Q . X^T.
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
//     empty mbarrier a stage). A stage holds 256 K values: 128 packed bytes
//     of each weight row, and two 128-byte boxes of each activation row
//     (T3: x[:, k0:k0+128] and x[:, k0+128:k0+256]; T2: xlo and xhi at
//     k0/2). A zero byte is two zero codes and a zero activation adds
//     nothing, so the zero fill is exact. The ring holds 3 to 8 stages
//     (~100 KB), two blocks an SM: 64-190 KB of packed weight in flight
//     an SM.
//   * The A operand comes from registers: wgmma.m64nNk32.s32.s8.s8 with A
//     in the fragment layout (rows 16 w + g and + 8, K 4t..4t+3 and
//     16+4t..16+4t+3 of the 32-value step; g = lane / 4, t = lane % 4). A
//     thread reads its packed bytes from the swizzled tile (16-byte chunk c
//     of row r sits at chunk c ^ (r % 8): no bank conflicts) and puts each
//     nibble in the HIGH half of its byte, which as an int8 is 16 q
//     exactly: (w << 4) & 0xf0f0f0f0 holds the low nibbles, w & 0xf0f0f0f0
//     the high ones, with no sign extension. The sums are then 16 times the
//     product, exactly divisible, and are shifted right by 4 before they
//     are stored (|16 x q| <= 2^14 a term, so K up to 131040 fits int32).
//     T2 pairs naturally: one word of packed bytes gives the xlo step's
//     register (low nibbles) and the xhi step's (high ones). T3 needs K in
//     order in each register: two packed bytes (four K values) become
//     [lo0, hi0, lo1, hi1] with one byte permute.
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

#include "hopper.cuh"

namespace {

constexpr int KB = 128;   // packed weight bytes of a row per stage: 256 K values
constexpr uint32_t HIGH = 0xf0f0f0f0u;

// the stages of the ring, by weight rows a block and wn: ~100 KB a block,
// two blocks an SM (mirrored by ops/w4_colscale.py STAGES)
constexpr int stages_of(int nwg, int wn) {
  return nwg == 2 ? (wn == 8 ? 6 : wn == 16 ? 5 : wn == 32 ? 4 : 3)
                  : (wn <= 16 ? 8 : wn == 32 ? 6 : 4);
}

// the 32-bit word `word` of logical 16-byte chunk `chunk` of a swizzled
// 128-byte row whose index is g modulo 8
__device__ __forceinline__ uint32_t ld_chunk(const uint8_t* row, int chunk, int word, int g) {
  return *reinterpret_cast<const uint32_t*>(row + ((chunk ^ g) << 4) + 4 * word);
}

// SPLIT: T2 (tm_x = xlo, tm_xhi = xhi, each (M, K/2)); else T3 (tm_x = x,
// (M, K)). NWG consumer warpgroups x 64 weight rows; WN activation rows.
template <bool SPLIT, int NWG, int WN, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 2)
w4_tma_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_xhi, int32_t* __restrict__ C, int M, int N,
              int K, int ktiles_per_split, int use_atomic) {
  constexpr int ROWS = 64 * NWG;
  constexpr int W_BYTES = ROWS * KB, X_BYTES = WN * 128, STAGE = W_BYTES + 2 * X_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int ktiles = (K + 2 * KB - 1) / (2 * KB);
  const int kt0 = blockIdx.z * ktiles_per_split;
  const int nk = min(kt0 + ktiles_per_split, ktiles) - kt0;
  const int b0 = blockIdx.x * WN;       // activation rows
  const int a0 = blockIdx.y * ROWS;     // weight rows: output columns
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
        const int kp = (kt0 + i) * KB;   // packed bytes: K / 2
        // T3's second box starts past K on a last, short tile: it is not
        // loaded, and the weight bytes facing it arrive as zeros
        const bool second = SPLIT || 2 * kp + 128 < K;
        hopper::mbar_expect_tx(&full[s], W_BYTES + (second ? 2 : 1) * X_BYTES);
        hopper::tma_load_2d(st, &tm_w, &full[s], kp, a0);
        if (SPLIT) {
          hopper::tma_load_2d(st + W_BYTES, &tm_x, &full[s], kp, b0);
          hopper::tma_load_2d(st + W_BYTES + X_BYTES, &tm_xhi, &full[s], kp, b0);
        } else {
          hopper::tma_load_2d(st + W_BYTES, &tm_x, &full[s], 2 * kp, b0);
          if (second) hopper::tma_load_2d(st + W_BYTES + X_BYTES, &tm_x, &full[s], 2 * kp + 128, b0);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg, warp wq of it; its rows 16 wq + g and + 8 of
  // the warpgroup's 64 both sit at swizzle phase g
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t pick = (t & 1) ? 0x7632u : 0x5410u;   // T3: bytes 2t, 2t+1 of two words
  int acc[WN / 2];
#pragma unroll
  for (int j = 0; j < WN / 2; ++j) acc[j] = 0;
  hopper::fence_regs(acc);
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* st = smem + s * STAGE;
    const uint8_t* r0 = st + (wg * 64 + wq * 16 + g) * KB;
    const uint8_t* r1 = r0 + 8 * KB;
    // a[j]: the A registers of the stage's product j, which reads the 32
    // activation bytes at 32 (j % 4) of box j / 4
    uint32_t a[8][4];
    if (SPLIT) {
      // xlo/xhi step q covers packed bytes 32q..32q+31: chunks 2q and 2q+1
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w00 = ld_chunk(r0, 2 * q, t, g), w01 = ld_chunk(r0, 2 * q + 1, t, g);
        const uint32_t w10 = ld_chunk(r1, 2 * q, t, g), w11 = ld_chunk(r1, 2 * q + 1, t, g);
        a[q][0] = (w00 << 4) & HIGH;
        a[q][1] = (w10 << 4) & HIGH;
        a[q][2] = (w01 << 4) & HIGH;
        a[q][3] = (w11 << 4) & HIGH;
        a[4 + q][0] = w00 & HIGH;
        a[4 + q][1] = w10 & HIGH;
        a[4 + q][2] = w01 & HIGH;
        a[4 + q][3] = w11 & HIGH;
      }
    } else {
      // K values 32j + 4t.. are packed bytes 16j + 2t, +1 (chunk j); 32j +
      // 16 + 4t.. are bytes 8 + 2t, 9 + 2t of the same chunk
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint8_t* row = r ? r1 : r0;
          const uint32_t v = __byte_perm(ld_chunk(row, j, t >> 1, g),
                                         ld_chunk(row, j, 2 + (t >> 1), g), pick);
          const uint32_t lo = (v << 4) & HIGH, hi = v & HIGH;
          a[j][r] = __byte_perm(lo, hi, 0x5140);       // K 4t..4t+3
          a[j][2 + r] = __byte_perm(lo, hi, 0x7362);   // K 16+4t..16+4t+3
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) hopper::fence_regs(a[j]);
    const uint32_t sb = hopper::smem_u32(st + W_BYTES);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hopper::wgmma_rs_s8<WN>(acc, a[j],
                              hopper::desc_sw128(sb + (j / 4) * X_BYTES + (j % 4) * 32, 16, 1024),
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
  constexpr int STAGES = stages_of(NWG, WN), ROWS = 64 * NWG;
  constexpr int SMEM = STAGES * (ROWS * KB + 2 * WN * 128) + 2 * STAGES * 8 + 1024;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(w4_tma_kernel<SPLIT, NWG, WN, STAGES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  // dims innermost first: the weight (N, K/2); the activations (M, K/2)
  // (T2) or (M, K) (T3); every box 128 bytes wide
  const cuuint64_t xk = static_cast<cuuint64_t>(SPLIT ? k / 2 : k);
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(k / 2), static_cast<cuuint64_t>(n)};
  const cuuint64_t xdims[2] = {xk, static_cast<cuuint64_t>(m)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(k / 2)};
  const cuuint64_t xstride[1] = {xk};
  const cuuint32_t wbox[2] = {KB, ROWS};
  const cuuint32_t xbox[2] = {128, WN};
  CUtensorMap tw, tx, th;
  int rc = hopper::encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, wstride, wbox);
  if (rc == 0) rc = hopper::encode(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xdims, xstride, xbox);
  if (rc == 0) {
    rc = hopper::encode(&th, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, SPLIT ? xhi : x, xdims, xstride,
                        xbox);
  }
  if (rc != 0) return rc;
  const int ktiles = (k + 2 * KB - 1) / (2 * KB);
  const int splits = (ktiles + per - 1) / per;
  const dim3 grid((m + WN - 1) / WN, (n + ROWS - 1) / ROWS, splits);
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
  if ((rows != 64 && rows != 128) || stages != stages_of(nwg, wn)) {
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
