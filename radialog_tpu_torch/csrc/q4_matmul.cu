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
// the same from run to run, K split or not.
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
// The design: T3's mainloop (csrc/w4_tma.cuh, shared with w4_colscale.cu),
// C^T = Q . X^T, with the group's rescale in the consumers' registers.
//   * The weight's output columns are wgmma's 64-row M side, one consumer
//     warpgroup per 64 weight rows, one or two a block; the activation rows
//     are its N, padded to 8, 16, 32 or 64 by TMA's zero fill, tiled over
//     the grid in 64s above 64 rows, the row tile walking fastest. One
//     producer warp keeps a ring of 256-value stages in flight with TMA
//     (~100 KB a block, two blocks an SM); the nibbles are unpacked into the
//     A registers as 16 q, so the integer sums are 16 times the product.
//   * A group of 128 K values is one activation box, four products; groups
//     end after product 3 or 7 of a stage (groups of 512 every second
//     stage, the mock's 128 mid-stage: a kernel of its own, MID). At a
//     group's end the consumer waits for its products, converts acc >> 4 to
//     f32 (exact: below 2^24 for any group pick_bk allows), multiplies by
//     gscale[g][n] of its two weight rows, on the asymmetric grid adds
//     f32(rowsum) * goff[g][n], and adds that into an f32 register
//     accumulator. The next group's first product overwrites the int32
//     accumulator (wgmma's scale-d of 0), so nothing is zeroed. The scales
//     and offsets of the block's rows reach shared memory by cp.async two
//     groups ahead of their use (three slots); read from device memory at
//     the group's end, their latency showed.
//   * The activation row sums (asymmetric grid only) come from the stage's
//     activation boxes already in shared memory: a row-sum warp beside the
//     producer sums each box row with __dp4a as the stage lands and
//     publishes the sums in shared memory (its own mbarrier a stage), and
//     each consumer adds the two neighbouring sums of its activation rows
//     per box. Measured slower on an H100 (PERF.md): __dp4a by every
//     consumer warp (each reads the whole box again), and a second wgmma
//     against a constant A of 0x10 bytes (twice the tensor work).
//   * K is split across blocks where the output tiles leave half the card's
//     slots empty (wo and down at decode), on group boundaries only. Split 0
//     writes its running sum and every other split each group's f32 term
//     to a workspace, a dense slot of the tile a group; the last block of a
//     tile to arrive (an int32 ticket taken with atomicAdd after a fence)
//     copies the slots into its free ring with 16-byte cp.async, all of a
//     chunk in flight at once, adds them in group order and resets the
//     ticket to 0. No block waits for another, nothing is added with float
//     atomics, and the workspace and tickets are allocated once per device
//     (ops/q4_matmul.py), so a call is one launch.
// The launch plan (wn, weight rows a block, stages, K splits) is chosen in
// Python (ops/q4_matmul.py `_plan`). K must be a multiple of 32 (16-byte
// packed rows: TMA's stride rule) and `group` of 128; the wrapper checks
// both.

#include <cstdint>
#include <cuda_runtime.h>

#include "w4_tma.cuh"

namespace {

using w4::KB;

// the consumer warpgroups' own barrier (the producer warp has returned)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// the four products of activation box J0 / 4 of a stage into acc; keep = 0
// starts a group
template <int WN, int J0>
__device__ __forceinline__ void box_products(int (&acc)[WN / 2], const uint32_t (&a)[8][4],
                                             uint32_t sb, int keep) {
#pragma unroll
  for (int j = J0; j < J0 + 4; ++j) {
    const uint64_t db = hopper::desc_sw128(sb + (j / 4) * WN * 128 + (j % 4) * 32, 16, 1024);
    hopper::wgmma_rs_s8<WN>(acc, a[j], db, j == J0 ? keep : 1);
  }
}

constexpr int SCALE_SLOTS = 3;   // groups whose scales are in shared memory at once

// a 4-byte asynchronous copy to shared memory; src_bytes 0 writes zero
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// a 16-byte asynchronous copy to shared memory, through L2 only
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the row-sum warp's sums of one stage: 2 WN ints, box b row j at b WN + j
template <int WN>
__device__ __forceinline__ void stage_rowsums(int* out, const uint8_t* boxes, bool second,
                                              int lane) {
  for (int r = lane; r < 2 * WN; r += 32) {   // box r / WN, row r % WN: 128 bytes at 128 r
    int sum = 0;
    if (r < WN || second) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {   // the chunks in a lane's own order: no bank conflicts
        const uint4 v =
            *reinterpret_cast<const uint4*>(boxes + 128 * r + 16 * ((c + r) & 7));
        sum = __dp4a(static_cast<int>(v.x), 0x01010101, sum);
        sum = __dp4a(static_cast<int>(v.y), 0x01010101, sum);
        sum = __dp4a(static_cast<int>(v.z), 0x01010101, sum);
        sum = __dp4a(static_cast<int>(v.w), 0x01010101, sum);
      }
    }
    out[r] = sum;
  }
}

// a consumer adds the published sums of its activation rows 8c + 2t + h
// of one box into rsp[2c + h]
template <int WN>
__device__ __forceinline__ void add_rowsums(int (&rsp)[WN / 4], const int* sums, int t) {
#pragma unroll
  for (int c = 0; c < WN / 8; ++c) {
    const int2 v = *reinterpret_cast<const int2*>(sums + 8 * c + 2 * t);
    rsp[2 * c] += v.x;
    rsp[2 * c + 1] += v.y;
  }
}

// the block's threads: the consumer warpgroups, the producer warp and, on
// the asymmetric grid, the row-sum warp
constexpr int threads_of(int nwg, bool asym) { return nwg * 128 + (asym ? 64 : 32); }

// the ring (w4::Stage); a full barrier a stage for the published row sums
// and, on the asymmetric grid, the sums themselves; the scale slots
template <int NWG, int WN, bool ASYM>
constexpr int smem_of() {
  return w4::Stage<NWG, WN>::SMEM + w4::stages_of(NWG, WN) * (8 + (ASYM ? 8 * WN : 0)) +
         SCALE_SLOTS * 2 * 64 * NWG * 4;
}

// NWG consumer warpgroups x 64 weight rows; WN activation rows; ASYM: the
// asymmetric grid (offsets and row sums), else goff is null; MID: groups
// may end after product 3 of a stage (group % 256 == 128: the mock's), whose
// wait between the two boxes' products, on a path that only some stages
// take, makes ptxas serialize every wgmma of the kernel. Grid: (activation
// row tiles, weight row tiles, K splits of `per` stages).
template <int NWG, int WN, int STAGES, bool ASYM, bool MID>
__global__ void __launch_bounds__(threads_of(NWG, ASYM), 2)
q4_tma_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
              const float* __restrict__ gscale, const float* __restrict__ goff,
              float* __restrict__ C, float* __restrict__ ws, int* __restrict__ tickets, int M,
              int N, int K, int group, int per) {
  using S = w4::Stage<NWG, WN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last_block;
  uint8_t* smem = w4::ring_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * S::BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* sums_full = empty + STAGES;                          // ASYM
  int* sums = reinterpret_cast<int*>(sums_full + STAGES);        // ASYM: [STAGES][2][WN]
  float* scales = reinterpret_cast<float*>(sums + (ASYM ? STAGES * 2 * WN : 0));
                                                                 // [SCALE_SLOTS][2][ROWS]

  const int ktiles = (K + 2 * KB - 1) / (2 * KB);
  const int splits = gridDim.z;
  const int kt0 = blockIdx.z * per;
  const int nk = min(kt0 + per, ktiles) - kt0;
  const int b0 = blockIdx.x * WN;       // activation rows
  const int a0 = blockIdx.y * S::ROWS;  // weight rows: output columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (ASYM && threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&sums_full[s], 1);
  }
  w4::init_ring(full, empty, STAGES, NWG * 128);

  if (warp == NWG * 4) {   // the producer warp: lane 0 issues every load
    if (lane == 0) {
      w4::produce<false, NWG, WN, STAGES>(smem, full, empty, &tm_w, &tm_x, &tm_x, kt0, nk, a0,
                                          b0, K);
    }
    return;
  }
  if (ASYM && warp == NWG * 4 + 1) {   // the row-sum warp
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      hopper::mbar_wait(&full[s], (i / STAGES) & 1);
      stage_rowsums<WN>(sums + s * 2 * WN, smem + s * S::BYTES + S::W_BYTES,
                        w4::second_box(kt0 + i, K), lane);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&sums_full[s]);
    }
    return;
  }

  // a consumer: warpgroup wg, warp wq of it, weight rows n0 and n0 + 8
  // (rows lr and lr + 8 of the block's). acc[4c + e] / facc[4c + e]:
  // weight row n0 + 8 (e >> 1), activation row b0 + 8c + 2t + (e & 1)
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int lr = wg * 64 + wq * 16 + g, n0 = a0 + lr;
  const int P = group / 32;                  // products a group
  const int groups = (K + group - 1) / group;
  const bool running = blockIdx.z == 0;      // later splits store each group's term
  int grp = kt0 * 8 / P;                     // the split starts on a group boundary
  int left = P;                              // products before the group ends
  // a split launch's workspace: for each output tile, a slot of WN x ROWS
  // f32 a group (activation row, then weight row of the tile)
  constexpr int TILE = WN * S::ROWS;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float* ws_tile = splits > 1 ? ws + static_cast<size_t>(tile) * groups * TILE : nullptr;

  // group gi's scales (and offsets) of the block's rows, in slot
  // gi % SCALE_SLOTS, fetched SCALE_SLOTS - 1 groups ahead with cp.async:
  // the four lanes of a row pair copy gscale[n0], gscale[n0 + 8], goff[n0]
  // and goff[n0 + 8], one each, every lane on the same path (a copy past N
  // or past the last group reads nothing and writes 0); one commit group a
  // group
  const int scale_at = (t >> 1) * S::ROWS + lr + 8 * (t & 1);
  const float* scale_src = (t >> 1) ? goff : gscale;
  auto fetch_scales = [&](int gi) {
    const int n = n0 + 8 * (t & 1);
    const bool in = gi < groups && n < N && (ASYM || t < 2);
    cp_async4(scales + (gi % SCALE_SLOTS) * 2 * S::ROWS + scale_at,
              (in ? scale_src : gscale) + (in ? static_cast<size_t>(gi) * N + n : 0), in ? 4 : 0);
    cp_async_commit();
  };
#pragma unroll
  for (int d = 0; d < SCALE_SLOTS; ++d) fetch_scales(grp + d);

  int acc[WN / 2], rsp[WN / 4];   // rsp: the group's row sums of rows 8c + 2t + h
  float facc[WN / 2];
#pragma unroll
  for (int j = 0; j < WN / 2; ++j) facc[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < WN / 4; ++j) rsp[j] = 0;

  // the group ends: its term, in the plain version's operations and order
  auto group_end = [&]() {
    cp_async_wait<SCALE_SLOTS - 1>();   // this group's scales have landed
    __syncwarp();
    const float* slot = scales + (grp % SCALE_SLOTS) * 2 * S::ROWS;
    const float gs[2] = {slot[lr], slot[lr + 8]};
    const float go[2] = {ASYM ? slot[S::ROWS + lr] : 0.0f, ASYM ? slot[S::ROWS + lr + 8] : 0.0f};
    __syncwarp();                       // read by every lane before the lanes refill it
    fetch_scales(grp + SCALE_SLOTS);
#pragma unroll
    for (int c = 0; c < WN / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float u = __fmul_rn(__int2float_rn(acc[4 * c + e] >> 4), gs[e >> 1]);
        if (ASYM) u = __fadd_rn(u, __fmul_rn(__int2float_rn(rsp[2 * c + (e & 1)]), go[e >> 1]));
        if (running) {
          facc[4 * c + e] = __fadd_rn(facc[4 * c + e], u);
        } else {
          ws_tile[grp * TILE + (8 * c + 2 * t + (e & 1)) * S::ROWS + lr + 8 * (e >> 1)] = u;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < WN / 4; ++j) rsp[j] = 0;
    ++grp;
  };

  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES, kt = kt0 + i;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* st = smem + s * S::BYTES;
    const uint8_t* r0 = st + lr * KB;
    uint32_t a[8][4];
    w4::unpack<false>(a, r0, r0 + 8 * KB, g, t);
    const uint32_t sb = hopper::smem_u32(st + S::W_BYTES);
    const int* stage_sums = sums + s * 2 * WN;
    // groups of P >= 4 products end after product 3 or 7 of a stage; the
    // last stage ends the last group, unless that group would start past K.
    // A second box that starts past K is not loaded: its products face zero
    // weights and add nothing, and its row sums are 0
    const bool first = left == P;                       // a group starts at product 0
    const bool mid = MID && left == 4;                  // a group ends after product 3
    const bool second = w4::second_box(kt, K);
    left = mid ? P - 4 : left - 8;
    const bool last = (!mid || second) && (left == 0 || kt == ktiles - 1);
    if (left == 0) left = P;

    hopper::wgmma_fence();
    box_products<WN, 0>(acc, a, sb, first ? 0 : 1);
    if (MID && mid) {   // the group ends mid-stage: its products and box 0's row sums first
      if (ASYM) {
        hopper::mbar_wait(&sums_full[s], (i / STAGES) & 1);
        add_rowsums<WN>(rsp, stage_sums, t);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      group_end();
      hopper::wgmma_fence();
    }
    box_products<WN, 4>(acc, a, sb, mid ? 0 : 1);
    hopper::wgmma_commit();
    if (ASYM) {   // the row sums, while the products run
      if (!mid) {
        hopper::mbar_wait(&sums_full[s], (i / STAGES) & 1);
        add_rowsums<WN>(rsp, stage_sums, t);
      }
      add_rowsums<WN>(rsp, stage_sums + WN, t);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) hopper::fence_regs(a[j]);
    hopper::mbar_arrive(&empty[s]);
    if (last) group_end();
  }
  cp_async_wait<0>();   // no copy outlives the block

  if (splits == 1) {
#pragma unroll
    for (int c = 0; c < WN / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = b0 + 8 * c + 2 * t + (e & 1), n = n0 + 8 * (e >> 1);
        if (m < M && n < N) C[static_cast<size_t>(m) * N + n] = facc[4 * c + e];
      }
    }
    return;
  }
  if (running) {   // split 0: its running sum, in slot 0
#pragma unroll
    for (int c = 0; c < WN / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ws_tile[(8 * c + 2 * t + (e & 1)) * S::ROWS + lr + 8 * (e >> 1)] = facc[4 * c + e];
      }
    }
  }

  // the last block of the tile to arrive adds the splits' terms in group order
  __threadfence();
  consumers_sync(NWG * 128);
  if (threadIdx.x == 0) last_block = atomicAdd(&tickets[tile], 1) == splits - 1;
  consumers_sync(NWG * 128);
  if (!last_block) return;
  __threadfence();
  // slot 0, then the later splits' groups g1.., copied by 16-byte cp.async
  // into the ring (free now) a chunk of slots at a time, all of a chunk in
  // flight at once; each thread sums the 4-float pieces it copied itself
  constexpr int PIECES = TILE / 4 / (NWG * 128);      // a thread's pieces a slot: WN / 8
  constexpr int CHUNK = STAGES * S::BYTES / (TILE * 4);
  const int g1 = per * 8 / P;                          // split 1's first group
  const int nslots = 1 + groups - g1;
  float* landing = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  float4 sum[PIECES];
  for (int j0 = 0; j0 < nslots; j0 += CHUNK) {
    const int nj = min(CHUNK, nslots - j0);
    for (int j = 0; j < nj; ++j) {
      const float* src = ws_tile + (j0 + j == 0 ? 0 : g1 + j0 + j - 1) * TILE;
#pragma unroll
      for (int q = 0; q < PIECES; ++q) {
        const int at = 4 * (tid + q * NWG * 128);
        cp_async16(landing + j * TILE + at, src + at);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    for (int j = 0; j < nj; ++j) {
#pragma unroll
      for (int q = 0; q < PIECES; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(landing + j * TILE +
                                                          4 * (tid + q * NWG * 128));
        if (j0 + j == 0) {
          sum[q] = v;
        } else {
          sum[q] = make_float4(__fadd_rn(sum[q].x, v.x), __fadd_rn(sum[q].y, v.y),
                               __fadd_rn(sum[q].z, v.z), __fadd_rn(sum[q].w, v.w));
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PIECES; ++q) {
    const int at = 4 * (tid + q * NWG * 128);          // activation row at / ROWS of the tile
    const int m = b0 + at / S::ROWS, n = a0 + at % S::ROWS;
    const float v[4] = {sum[q].x, sum[q].y, sum[q].z, sum[q].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m < M && n + i < N) C[static_cast<size_t>(m) * N + n + i] = v[i];
    }
  }
  if (threadIdx.x == 0) tickets[tile] = 0;   // for the next call
}

template <int NWG, int WN, bool ASYM, bool MID>
int launch(const void* x, const void* w, const float* gscale, const float* goff, float* c,
           float* ws, int* tickets, int m, int n, int k, int group, int per,
           cudaStream_t stream) {
  constexpr int STAGES = w4::stages_of(NWG, WN), SMEM = smem_of<NWG, WN, ASYM>();
  static bool configured = false;
  int rc = w4::allow_smem(q4_tma_kernel<NWG, WN, STAGES, ASYM, MID>, SMEM, configured);
  CUtensorMap tw, tx;
  if (rc == 0) rc = w4::encode_maps<false, 64 * NWG, WN>(&tw, &tx, nullptr, x, nullptr, w, m, n, k);
  if (rc != 0) return rc;
  const int ktiles = (k + 2 * KB - 1) / (2 * KB);
  const dim3 grid((m + WN - 1) / WN, (n + 64 * NWG - 1) / (64 * NWG), (ktiles + per - 1) / per);
  q4_tma_kernel<NWG, WN, STAGES, ASYM, MID><<<grid, threads_of(NWG, ASYM), SMEM, stream>>>(
      tw, tx, gscale, goff, c, ws, tickets, m, n, k, group, per);
  return static_cast<int>(cudaGetLastError());
}

template <bool ASYM, bool MID>
int by_shape(const void* x, const void* w, const float* gs, const float* go, float* c, float* ws,
             int* tickets, int m, int n, int k, int group, int wn, int nwg, int per,
             cudaStream_t st) {
#define Q4_LAUNCH(NWG, WN) \
  launch<NWG, WN, ASYM, MID>(x, w, gs, go, c, ws, tickets, m, n, k, group, per, st)
  if (nwg == 2) {   // two warpgroups at wn <= 32: the registers of two blocks an SM
    if (wn == 8) return Q4_LAUNCH(2, 8);
    if (wn == 16) return Q4_LAUNCH(2, 16);
    if (wn == 32) return Q4_LAUNCH(2, 32);
  } else {
    if (wn == 8) return Q4_LAUNCH(1, 8);
    if (wn == 16) return Q4_LAUNCH(1, 16);
    if (wn == 32) return Q4_LAUNCH(1, 32);
    if (wn == 64) return Q4_LAUNCH(1, 64);
  }
#undef Q4_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, loaded with ctypes. x (M,K) int8; w (N,K/2) packed nibbles;
// gscale (G,N) f32; goff (G,N) f32, or null on the symmetric grid; c (M,N)
// f32. The plan (ops/q4_matmul.py `_plan`): wn in {8, 16, 32, 64}
// activation rows a block; rows 64, or 128 at wn <= 32, weight rows a block;
// stages as w4::stages_of gives them; `per` stages of 256 K values a split,
// a multiple of the stages a group spans where K splits, which then needs
// ws (>= tiles * ceil(K/group) * wn * rows f32) and tickets (one int32 a
// tile, zero).
// Returns 0, a cudaError_t, or a tensor-map code of hopper.cuh.
extern "C" int q4_gemm_launch(const void* x, const void* w, const void* gscale, const void* goff,
                              void* c, void* ws, void* tickets, int m, int n, int k, int group,
                              int wn, int rows, int stages, int per, void* stream) {
  const int ktiles = (k + 2 * KB - 1) / (2 * KB);
  const int nwg = rows / 64;
  const bool split = per > 0 && per < ktiles;
  if (m <= 0 || n <= 0 || k <= 0 || per <= 0 || k % 32 || group <= 0 || group % 128 ||
      (rows != 64 && rows != 128) || (nwg == 2 && wn > 32) || stages != w4::stages_of(nwg, wn) ||
      (split && (ws == nullptr || tickets == nullptr || (per * 2 * KB) % group != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* gs = static_cast<const float*>(gscale);
  auto* go = static_cast<const float*>(goff);
  auto* out = static_cast<float*>(c);
  auto* wsp = static_cast<float*>(ws);
  auto* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mid = group % (2 * KB) != 0;
  auto* launch_of = go == nullptr ? (mid ? by_shape<false, true> : by_shape<false, false>)
                                  : (mid ? by_shape<true, true> : by_shape<true, false>);
  return launch_of(x, w, gs, go, out, wsp, tk, m, n, k, group, wn, nwg, per, st);
}
