// The W4A8 mainloop shared by T2/T3 (w4_colscale.cu) and K4 (q4_matmul.cu),
// for Hopper (sm_90a): a TMA ring of stages filled by one producer warp, and
// the unpack of a stage's packed weight bytes into the A registers of an
// int8 wgmma whose operands are swapped, C^T = Q . X^T.
//
// A stage holds 256 K values: 128 packed bytes of each of ROWS weight rows
// (byte j of row n holds q[2j, n] in its low nibble and q[2j+1, n] in its
// high nibble, two's complement), and two 128-byte boxes of each of WN
// activation rows (T3 and K4: x[:, k0:k0+128] and x[:, k0+128:k0+256]; T2:
// xlo and xhi at k0/2). Every box is written with the 128-byte swizzle and
// zero fill past every edge: a zero byte is two zero codes and a zero
// activation adds nothing, so the fill is exact.
//
// The A operand comes from registers: wgmma.m64nNk32.s32.s8.s8 with A in the
// fragment layout (rows 16 w + g and + 8, K 4t..4t+3 and 16+4t..16+4t+3 of
// the 32-value step; g = lane / 4, t = lane % 4). A thread reads its packed
// bytes from the swizzled tile (16-byte chunk c of row r sits at chunk
// c ^ (r % 8): no bank conflicts) and puts each nibble in the HIGH half of
// its byte, which as an int8 is 16 q exactly: (w << 4) & 0xf0f0f0f0 holds
// the low nibbles, w & 0xf0f0f0f0 the high ones, with no sign extension.
// The sums are then 16 times the product, exactly divisible, and are
// shifted right by 4 (|16 x q| <= 2^14 a term, so K up to 131040 fits
// int32). T2 pairs naturally: one word of packed bytes gives the xlo step's
// register (low nibbles) and the xhi step's (high ones). T3 and K4 need K in
// order in each register: two packed bytes (four K values) become [lo0,
// hi0, lo1, hi1] with one byte permute.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace w4 {

constexpr int KB = 128;   // packed weight bytes of a row per stage: 256 K values
constexpr uint32_t HIGH = 0xf0f0f0f0u;

// the stages of the ring, by consumer warpgroups (64 weight rows each) and
// wn: ~100 KB a block, two blocks an SM (mirrored by ops/q4_matmul.py STAGES)
constexpr int stages_of(int nwg, int wn) {
  return nwg == 2 ? (wn == 8 ? 6 : wn == 16 ? 5 : wn == 32 ? 4 : 3)
                  : (wn <= 16 ? 8 : wn == 32 ? 6 : 4);
}

// a stage's bytes: the weight tile, then the two activation boxes
template <int NWG, int WN>
struct Stage {
  static constexpr int ROWS = 64 * NWG, W_BYTES = ROWS * KB, X_BYTES = WN * 128,
                       BYTES = W_BYTES + 2 * X_BYTES;
  // the ring, its full and empty mbarriers, and the 1024-byte alignment
  static constexpr int SMEM = stages_of(NWG, WN) * BYTES + 2 * stages_of(NWG, WN) * 8 + 1024;
};

// the ring's base: dynamic shared memory aligned to 1024 bytes (the swizzle's atom)
__device__ __forceinline__ uint8_t* ring_base(uint8_t* smem_raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// one full barrier (the producer's arrival and the TMA bytes) and one empty
// barrier (every consumer thread) a stage
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages,
                                          int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], consumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// whether stage kt's second activation box holds any K below K (T3, K4): a
// box that starts past K is not loaded, and the weight bytes facing it
// arrive as zeros, but the box itself keeps an older stage's bytes
__device__ __forceinline__ bool second_box(int kt, int K) { return kt * 2 * KB + 128 < K; }

// The producer: lane 0 of the producer warp keeps the ring of STAGES full,
// stages kt0 .. kt0 + nk - 1, weight rows a0.., activation rows b0..
template <bool SPLIT, int NWG, int WN, int STAGES>
__device__ __forceinline__ void produce(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* tm_w, const CUtensorMap* tm_x,
                                        const CUtensorMap* tm_xhi, int kt0, int nk, int a0,
                                        int b0, int K) {
  using S = Stage<NWG, WN>;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    if (i >= STAGES) hopper::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
    uint8_t* st = smem + s * S::BYTES;
    const int kp = (kt0 + i) * KB;   // packed bytes: K / 2
    const bool second = SPLIT || second_box(kt0 + i, K);
    hopper::mbar_expect_tx(&full[s], S::W_BYTES + (second ? 2 : 1) * S::X_BYTES);
    hopper::tma_load_2d(st, tm_w, &full[s], kp, a0);
    if (SPLIT) {
      hopper::tma_load_2d(st + S::W_BYTES, tm_x, &full[s], kp, b0);
      hopper::tma_load_2d(st + S::W_BYTES + S::X_BYTES, tm_xhi, &full[s], kp, b0);
    } else {
      hopper::tma_load_2d(st + S::W_BYTES, tm_x, &full[s], 2 * kp, b0);
      if (second) hopper::tma_load_2d(st + S::W_BYTES + S::X_BYTES, tm_x, &full[s], 2 * kp + 128, b0);
    }
  }
}

// the 32-bit word `word` of logical 16-byte chunk `chunk` of a swizzled
// 128-byte row whose index is g modulo 8
__device__ __forceinline__ uint32_t ld_chunk(const uint8_t* row, int chunk, int word, int g) {
  return *reinterpret_cast<const uint32_t*>(row + ((chunk ^ g) << 4) + 4 * word);
}

// The A registers of a stage's 8 products for the thread's weight rows r0
// and r1 = r0 + 8 (16 w + g of its warpgroup's 64, both at swizzle phase g):
// a[j] is product j's, which reads the 32 activation bytes at 32 (j % 4) of
// box j / 4
template <bool SPLIT>
__device__ __forceinline__ void unpack(uint32_t (&a)[8][4], const uint8_t* r0, const uint8_t* r1,
                                       int g, int t) {
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
    const uint32_t pick = (t & 1) ? 0x7632u : 0x5410u;   // bytes 2t, 2t+1 of two words
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
}

// the tensor maps, dims innermost first: the weight (N, K/2); the
// activations (M, K/2) (T2: xlo, xhi) or (M, K) (T3, K4); every box 128
// bytes wide, ROWS weight rows and WN activation rows. th may be null (no
// third map: K4)
template <bool SPLIT, int ROWS, int WN>
int encode_maps(CUtensorMap* tw, CUtensorMap* tx, CUtensorMap* th, const void* x,
                const void* xhi, const void* w, int m, int n, int k) {
  const cuuint64_t xk = static_cast<cuuint64_t>(SPLIT ? k / 2 : k);
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(k / 2), static_cast<cuuint64_t>(n)};
  const cuuint64_t xdims[2] = {xk, static_cast<cuuint64_t>(m)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(k / 2)};
  const cuuint64_t xstride[1] = {xk};
  const cuuint32_t wbox[2] = {KB, ROWS};
  const cuuint32_t xbox[2] = {128, WN};
  int rc = hopper::encode(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, wstride, wbox);
  if (rc == 0) rc = hopper::encode(tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xdims, xstride, xbox);
  if (rc == 0 && th != nullptr) {
    rc = hopper::encode(th, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, SPLIT ? xhi : x, xdims, xstride,
                        xbox);
  }
  return rc;
}

// raise the kernel's dynamic shared memory limit to `bytes`, once per kernel
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  return 0;
}

}  // namespace w4
