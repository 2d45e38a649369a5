// Single-token attention over one layer of the int8 token-flat KV cache,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel radialog_tpu/ops/flash_decode.py `_kernel`
// + `_process_block` (called through `flash_decode_int8`), in its
// static-slot / interval mask mode with the leading shared-prefix block.
// The math is the TPU kernel's, without its TPU layout tricks (no
// block-diagonal q, no head-expansion matmul, no lane grouping, no 128-lane
// scale padding: scales are read at lanes [0, H)):
//   scores = float(q8 . k8 as an exact int32 dot) * ks * qs * D^-1/2
//   slot s of lane b is valid iff s < len[b] or a1[b] <= s <= b1[b]
//                                            or a2[b] <= s <= b2[b]
//   online softmax in f32, the shared prefix first (one block, one max),
//   then the lane's slots in blocks of bs; pv = bf16(p * vs), V int8 ->
//   bf16, f32 sums; out = acc * (1 / max(l, 1e-30)).
// The kernels cut the work into pieces that run in parallel, but take every
// p against the running max that the block-by-block walk of the plain
// version (ops/flash_decode.py) has at that block, so p and pv are its own
// bit for bit and only the order of the f32 sums differs; the pieces are
// merged in a fixed order, so a run repeats itself bit for bit.
//
// What bounds it on an H100: each live cache row is read once (H*D int8 of
// K and of V plus 2 bf16 scales per head) for ~4*H*D operations, about one
// operation per byte, so the kernel is bound by the bytes it reads; a
// decode-sized call (~100 MB at the report shape, ~4 MB over the binary-QA
// prefix) also by the latency of each block's chain of reads. The design:
//   * `lane_kernel`, one 128-thread block per (split, head, lane): a head
//     row of D bytes is read by D/16 threads with 16-byte loads (4-byte
//     loads where D % 16 != 0 or a row is not 16-byte aligned), so a warp
//     scores 32/(D/16) rows per load (4 at D = 128) with 4 dp4a and 3
//     shuffles a thread. Each warp takes CHUNK-row chunks of the block's
//     slots in turn and loads a whole chunk into registers before it uses
//     any. Phase A reads K and leaves every slot's score in shared memory;
//     the block takes each bs-block's max, the running max entering its
//     slots (the prefix's and the current row's, then the earlier splits'
//     maxima through the cluster) and the running max after each of its
//     bs-blocks. Phase C reads V and accumulates p @ V, each warp keeping
//     its own (m, l, acc) (a thread holds 16 output columns of its row
//     group); the warps' states are merged once, at the end, in warp order.
//     Registers are capped so that LANE_BLOCKS blocks fit an SM. (Measured
//     on an H100: a cp.async ring in shared memory, 8-row chunks, asking
//     for a warp's next chunk before using this one, and fewer blocks an
//     SM were slower; PERF.md.)
//   * Chunks with no valid slot are decided from (len, a1, b1, a2, b2)
//     before any read and skipped (exact: a fully masked chunk changes no
//     state), and nothing past the live bound max(len - 1, b1, b2) is
//     read: the dead gap of a wrapped ring window costs nothing.
//   * Where (B x H) blocks cannot fill the card, a (head, lane)'s slots are
//     split over a thread-block cluster of up to 8 blocks (the plan,
//     ops/flash_decode.py `_plan`, a function of the shapes only); the
//     ranks share their maxima through distributed shared memory, and
//     rank 0 reads the other ranks' states after a cluster barrier and
//     merges them in rank order. No scratch, no extra launch.
//   * `prefix_kernel`: the shared prefix (rows < p0, common to every lane)
//     is a small GEMM across lanes. One block per (tile of 64-row
//     sub-tiles, head, 16 lanes) stages the rows in shared memory, scores
//     them with mma.sync m16n8k32 s8 -> s32 (exact: bitwise the dp4a sum),
//     shares its lanes' maxima with the other tiles of its cluster (at most
//     8), and does p @ V against the prefix's max with mma.sync m16n8k16
//     bf16 -> f32 on pv and V widened to bf16 (every product exact in f32);
//     it writes each lane's partial (m, l, acc) to a scratch (tiles, B,
//     H[, D]). `lane_kernel` is launched behind it as a programmatic
//     dependent launch: phase A runs while prefix_kernel does, then waits
//     for it (griddepcontrol.wait) and adds the tiles in tile order ahead of
//     its own state. A call is two launches with a prefix and one without.
//
// K2'' (the `current` / `write_cache` mode of the same TPU kernel, its
// `_current` and `_wcapture` blocks): the step's own K/V row arrives as an
// operand (kc, kcs, vc, vcs: (B, H*D) int8 and (B, SLc) bf16) and is
// merged after the prefix state and before the lane's slots, the TPU
// kernel's order; the caller's mask ends one slot before it. With `write`
// the (head, lane)'s rank 0 then stores its own head's D bytes of k and v
// and its two scale entries at slot b1 + 1 of lane b in the cache, and
// nothing else, after the cluster barrier that follows every rank's reads:
// no two blocks write the same bytes, and every read of that slot (masked,
// p = 0) comes before the store. The TPU kernel rebuilds an 8-row slab and
// leaves the rows above the slot undefined; here every other byte of the
// cache stays as it was.
//
// T1 (tools/microbench_kvfused.py `fused_kernel`, K2 over one interleaved
// k|v buffer): `kv_stride` is the distance in bytes between two cache rows
// of k (and of v), SL the distance in elements between two scale rows. K2
// passes H*D and the scale width; T1 passes 2*H*D with v at k + H*D, and 2*H
// with the v scales at ks + H. The arithmetic is K2's, so T1 equals K2 bit
// for bit on the same data.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_D = 128;
constexpr int PTILE = 64;        // prefix rows of a prefix_kernel sub-tile
constexpr int LTILE = 16;        // lanes of a prefix_kernel block
constexpr int CHUNK = 16;        // rows a lane-kernel warp loads before it uses them
constexpr int LANE_BLOCKS = 8;   // lane-kernel blocks an SM must fit (a register cap)
constexpr float NEG_INF = -1e30f;

struct LaneArgs {
  const int8_t* q8;
  const float* qs;
  const int8_t* k8;
  const uint16_t* ks;
  const int8_t* v8;
  const uint16_t* vs;
  const int* lens;
  const int* a1;
  const int* b1;
  const int* a2;
  const int* b2;
  const float* pm;                 // prefix tiles' states, nullptr without a prefix
  const float* pl;
  const float* pacc;
  int ptiles;
  const int8_t* kc;                // K2'': the current row, nullptr without
  const uint16_t* kcs;
  const int8_t* vc;
  const uint16_t* vcs;
  int SLc;
  int8_t* kw;                      // K2'' write: the cache, nullptr without
  uint16_t* ksw;
  int8_t* vw;
  uint16_t* vsw;
  int layer, B, S, H, D, SL, kv_stride, split_rows, bs;
  float scale;
  float* out;
};

struct PrefixArgs {
  const int8_t* q8;
  const float* qs;
  const int8_t* k0;
  const uint16_t* ks0;
  const int8_t* v0;
  const uint16_t* vs0;
  int p0, p0p, sl0, B, H, D, vec16, sub;
  float scale;
  float* pm;
  float* pl;
  float* pacc;
};

__device__ __forceinline__ float bf16_bits_to_float(uint16_t u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// byte i of a word of int8 values as a float, exactly, without a
// conversion instruction: u holds the bytes biased by 128 (w ^ 0x80808080),
// 2^23 + u_i is a float's bit pattern, and 2^23 + 128 comes off again
__device__ __forceinline__ float byte_f(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.0f;
}

// two values as a bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// NW words of a row segment, streamed past L1 (each byte is read once)
template <int NW>
__device__ __forceinline__ void load_words(int (&w)[NW], const int8_t* p) {
  if constexpr (NW == 4) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
        : "l"(p));
  } else {
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = reinterpret_cast<const int*>(p)[j];
  }
}

// fold state (m2, l2, a2) into (m, l, a), both rescaled to the larger max
__device__ __forceinline__ void merge(float& m, float& l, float& a, float m2, float l2,
                                      float a2) {
  const float mn = fmaxf(m, m2);
  const float s1 = expf(m - mn);
  const float s2 = expf(m2 - mn);
  l = l * s1 + l2 * s2;
  a = a * s1 + a2 * s2;
  m = mn;
}

// a lane's mask: slot s is valid iff s < len or a1 <= s <= b1 or a2 <= s <= b2
struct Mask {
  int len, a1, b1, a2, b2;
  __device__ __forceinline__ bool valid(int s) const {
    return s < len || (s >= a1 && s <= b1) || (s >= a2 && s <= b2);
  }
  // any valid slot in [lo, up], decided without reading the slots
  __device__ __forceinline__ bool any(int lo, int up) const {
    return lo < len || max(a1, lo) <= min(b1, up) || max(a2, lo) <= min(b2, up);
  }
};

// The K (or V) words of a warp chunk's rows from row c that the thread
// reads (zeros past row `up` and past D), and their scales
template <int VEC, int TPR, int U>
__device__ __forceinline__ void chunk_load(const int8_t* base, const uint16_t* scales,
                                           const LaneArgs& a, size_t row0, size_t seg, int h,
                                           int c, int up, int grp, bool cols,
                                           int (&w)[U][VEC / 4], uint16_t (&sr)[U]) {
  constexpr int RPS = 32 / TPR;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = c + u * RPS + grp;
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) w[u][j] = 0;
    sr[u] = 0;
    if (r <= up) {
      const size_t row = row0 + r;
      if (cols) load_words<VEC / 4>(w[u], base + row * a.kv_stride + seg);
      sr[u] = scales[row * a.SL + h];
    }
  }
}

// VEC bytes of a row per thread (16, or 4 where D % 16 != 0 or a row
// segment is not 16-byte aligned), TPR threads per row (the power of two
// >= D / VEC). A warp takes CHUNK-row chunks of the split's slots in turn
// and loads a whole chunk before it uses any of it. Phase A: the scores of
// every slot, into shared memory; the maxima of the split's blocks of bs
// slots; the running max of the plain version (prefix, current row, the
// earlier splits' blocks through the cluster, then block by block). Phase
// C: p = exp(s - the running max of the slot's block), so p and pv =
// bf16(p * vs) are the plain version's own, and p @ V.
template <int VEC, int TPR>
__global__ void __launch_bounds__(THREADS, LANE_BLOCKS) lane_kernel(const LaneArgs a) {
  constexpr int NW = VEC / 4;                 // words a thread loads per row
  constexpr int RPS = 32 / TPR;               // rows a warp reads per load
  constexpr int U = RPS >= CHUNK ? 1 : CHUNK / RPS;  // loads per chunk
  constexpr int CR = RPS * U;                 // rows per warp chunk
  constexpr int STEP = WARPS * CR;            // from a warp's chunk to its next
  extern __shared__ float ssc[];              // the split's scores, then its blocks' maxima
  __shared__ float wacc[WARPS][MAX_D];
  __shared__ float wml[WARPS][2];
  __shared__ float bstate[MAX_D + 3];         // this block's (acc, m, l) for rank 0; its max
  __shared__ float cur_s;

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane / TPR;                 // the warp's row group
  const int col0 = (lane % TPR) * VEC;        // the thread's first column
  const bool cols = col0 < a.D;
  const int D = a.D;
  const int hd = a.H * D;
  const int r_lo = split * a.split_rows;
  const int r_end = min(r_lo + a.split_rows, a.S);
  const int nb = (r_end - r_lo + a.bs - 1) / a.bs;
  float* mblk = ssc + a.split_rows;
  const Mask mk = {a.lens[b], a.a1[b], a.b1[b], a.a2[b], a.b2[b]};
  const int r_hi = min(r_end, max(max(mk.len - 1, mk.b1), mk.b2) + 1);
  const size_t row0 = (static_cast<size_t>(a.layer) * a.B + b) * a.S;
  const size_t seg = static_cast<size_t>(h) * D + col0;  // the thread's bytes of a row
  const int8_t* qrow = a.q8 + static_cast<size_t>(b) * hd + h * D;
  const float qscale = a.qs[b * a.H + h];
  const int d = tid;                          // D <= THREADS (checked by the wrapper)

  // K2'': the current row's operands, loaded before the slots so that their
  // latency hides behind the stream; its score raises every rank's running
  // max, and rank 0 adds its p and pv
  const bool cur = a.kc != nullptr;
  int kcw = 0, qcw = 0;
  float kcs = 0.0f, vcs = 0.0f, vcd = 0.0f;
  if (cur) {
    if (warp == 0 && lane < D / 4) {
      kcw = reinterpret_cast<const int*>(a.kc + static_cast<size_t>(b) * hd + h * D)[lane];
      qcw = reinterpret_cast<const int*>(qrow)[lane];
    }
    kcs = bf16_bits_to_float(a.kcs[static_cast<size_t>(b) * a.SLc + h]);
    if (split == 0) {
      vcs = bf16_bits_to_float(a.vcs[static_cast<size_t>(b) * a.SLc + h]);
      if (d < D) vcd = static_cast<float>(a.vc[static_cast<size_t>(b) * hd + h * D + d]);
    }
  }

  int qw[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) qw[j] = 0;
  if (cols) load_words<NW>(qw, qrow + col0);

  // phase A: a score for every slot of the split, -1e30 where masked; a
  // chunk with no valid slot is not read
  auto live = [&](int c) { return c < r_hi && mk.any(c, min(c + CR, r_hi) - 1); };
  for (int c = r_lo + warp * CR; c < r_end; c += STEP) {
    const int up = min(c + CR, r_hi) - 1;    // the chunk's last live row
    const bool c_live = live(c);
    int kx[U][NW];
    uint16_t ksr[U];
    if (c_live) chunk_load<VEC, TPR, U>(a.k8, a.ks, a, row0, seg, h, c, up, grp, cols, kx, ksr);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = c + u * RPS + grp;
      float s = NEG_INF;
      if (c_live) {
        int dot = 0;
#pragma unroll
        for (int j = 0; j < NW; ++j) dot = __dp4a(kx[u][j], qw[j], dot);
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (r <= up && mk.valid(r)) {
          s = static_cast<float>(dot) * bf16_bits_to_float(ksr[u]) * qscale * a.scale;
        }
      }
      if (lane % TPR == 0 && r < r_end) ssc[r - r_lo] = s;
    }
  }
  // phase C's first chunk of V is asked for now, ahead of the barriers
  int vx[U][NW];
  uint16_t vsr[U];
  int c = r_lo + warp * CR;
  while (c < r_hi && !live(c)) c += STEP;
  if (c < r_hi) {
    chunk_load<VEC, TPR, U>(a.v8, a.vs, a, row0, seg, h, c, min(c + CR, r_hi) - 1, grp, cols, vx,
                            vsr);
  }
  if (cur && warp == 0) {
    int dot = __dp4a(kcw, qcw, 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) cur_s = static_cast<float>(dot) * kcs * qscale * a.scale;
  }
  __syncthreads();
  for (int j = warp; j < nb; j += WARPS) {    // the maxima of the split's blocks
    float mx = NEG_INF;
    for (int i = j * a.bs + lane; i < min((j + 1) * a.bs, r_end - r_lo); i += 32) {
      mx = fmaxf(mx, ssc[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) mblk[j] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    float mx = NEG_INF;
    for (int j = 0; j < nb; ++j) mx = fmaxf(mx, mblk[j]);
    bstate[MAX_D + 2] = mx;
  }

  // the running max before the slots (the prefix's, then the current
  // row's) and rank 0's starting state: the prefix tiles (one max, so their
  // sums add) merged in tile order, then the current row
  float m_run = NEG_INF;
  float fm = NEG_INF, fl = 0.0f, fa = 0.0f;
  if (a.ptiles > 0) {
    // prefix_kernel's tiles: this grid may start before that one ends
    asm volatile("griddepcontrol.wait;" ::: "memory");
    for (int t = 0; t < a.ptiles; ++t) {
      const size_t i = (static_cast<size_t>(t) * a.B + b) * a.H + h;
      m_run = fmaxf(m_run, a.pm[i]);
      if (split == 0) merge(fm, fl, fa, a.pm[i], a.pl[i], d < D ? a.pacc[i * D + d] : 0.0f);
    }
  }
  if (cur) {
    const float s = cur_s;
    m_run = fmaxf(m_run, s);
    if (split == 0) {
      const float m_new = fmaxf(fm, s);
      const float alpha = expf(fm - m_new);
      const float p = expf(s - m_new);
      fl = fl * alpha + p;
      fm = m_new;
      fa = fa * alpha + round_bf16(p * vcs) * vcd;
    }
  }
  if (gridDim.x > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                           // every rank's max is in its bstate
    if (tid == 0) {
      for (int r = 0; r < split; ++r) {
        m_run = fmaxf(m_run, cluster.map_shared_rank(bstate, r)[MAX_D + 2]);
      }
    }
  }
  if (tid == 0) {                             // the running max after each block
    for (int j = 0; j < nb; ++j) {
      m_run = fmaxf(m_run, mblk[j]);
      mblk[j] = m_run;
    }
  }
  __syncthreads();

  // phase C: each warp's chunks again, p against its block's running max;
  // the warp's (l, acc) are kept against the running max of its latest block
  float m = NEG_INF, l = 0.0f, acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  while (c < r_hi) {
    const int up = min(c + CR, r_hi) - 1;
    const float m_new = mblk[(up - r_lo) / a.bs];
    if (m_new != m) {
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] *= alpha;
      m = m_new;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = c + u * RPS + grp;
      float p = 0.0f, f = 1.0f;
      if (r <= up && mk.valid(r)) {
        const float mj = mblk[(r - r_lo) / a.bs];
        p = expf(ssc[r - r_lo] - mj);
        if (mj != m) f = expf(mj - m);        // a chunk across two blocks of slots
      }
      l += p * f;
      const float pv = round_bf16(p * bf16_bits_to_float(vsr[u])) * f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        acc[j] += pv * byte_f(static_cast<uint32_t>(vx[u][j / 4]) ^ 0x80808080u, j % 4);
      }
    }
    do {                                      // the warp's next live chunk
      c += STEP;
    } while (c < r_hi && !live(c));
    if (c < r_hi) {
      chunk_load<VEC, TPR, U>(a.v8, a.vs, a, row0, seg, h, c, min(c + CR, r_hi) - 1, grp, cols,
                              vx, vsr);
    }
  }

  // the warp's row groups share m: add their l and acc, then hand the
  // warp's state to the block
#pragma unroll
  for (int o = TPR; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (grp == 0 && cols) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) wacc[warp][col0 + j] = acc[j];
  }
  if (lane == 0) {
    wml[warp][0] = m;
    wml[warp][1] = l;
  }
  __syncthreads();                            // every warp's reads are done
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    merge(fm, fl, fa, wml[w][0], wml[w][1], d < D ? wacc[w][d] : 0.0f);
  }

  if (gridDim.x > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (d < D) bstate[d] = fa;
    if (tid == 0) {
      bstate[MAX_D] = fm;
      bstate[MAX_D + 1] = fl;
    }
    cluster.sync();                           // every rank's reads and state are done
    if (split == 0) {
      for (int r = 1; r < static_cast<int>(gridDim.x); ++r) {
        const float* rs = cluster.map_shared_rank(bstate, r);
        merge(fm, fl, fa, rs[MAX_D], rs[MAX_D + 1], d < D ? rs[d] : 0.0f);
      }
    }
    cluster.sync();                           // rank 0 is done with the others' memory
    if (split != 0) return;
  }
  if (d < D) {
    const float inv_l = 1.0f / fmaxf(fl, 1e-30f);
    a.out[(static_cast<size_t>(b) * a.H + h) * D + d] = fa * inv_l;
  }
  if (a.kw != nullptr) {
    // K2'' write: this head's bytes of the current row at slot b1 + 1, after
    // every read of every rank (the wrapper checks that the slot is < S)
    const size_t row = row0 + mk.b1 + 1;
    if (d < D) {
      a.kw[row * a.kv_stride + h * D + d] = a.kc[static_cast<size_t>(b) * hd + h * D + d];
      a.vw[row * a.kv_stride + h * D + d] = a.vc[static_cast<size_t>(b) * hd + h * D + d];
    }
    if (tid == 0) {
      a.ksw[row * a.SL + h] = a.kcs[static_cast<size_t>(b) * a.SLc + h];
      a.vsw[row * a.SL + h] = a.vcs[static_cast<size_t>(b) * a.SLc + h];
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// PTILE rows of one matrix of the prefix from row r0, head h, into a staged
// tile of RS-byte rows (zeros past p0p and past D), every load issued
// before the first store
template <int DP>
__device__ __forceinline__ void stage_rows(int8_t* dst, const int8_t* src, int r0,
                                           const PrefixArgs& a, int h, int tid) {
  constexpr int RS = DP + 16;
  const size_t hd = static_cast<size_t>(a.H) * a.D;
  if (a.vec16) {
    constexpr int CPR = DP / 16;             // 16-byte pieces of a staged row
    constexpr int PER = PTILE * CPR / THREADS;
    int4 x[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / CPR;
      const int c = (i % CPR) * 16;
      x[j] = make_int4(0, 0, 0, 0);
      if (r0 + r < a.p0p && c < a.D) {
        x[j] = *reinterpret_cast<const int4*>(src + (r0 + r) * hd + h * a.D + c);
      }
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      *reinterpret_cast<int4*>(dst + (i / CPR) * RS + (i % CPR) * 16) = x[j];
    }
  } else {
    constexpr int WPR = DP / 4;              // words of a staged row
    constexpr int PER = PTILE * WPR / THREADS;
    int x[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / WPR;
      const int c = (i % WPR) * 4;
      x[j] = 0;
      if (r0 + r < a.p0p && c < a.D) {
        x[j] = *reinterpret_cast<const int*>(src + (r0 + r) * hd + h * a.D + c);
      }
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      *reinterpret_cast<int*>(dst + (i / WPR) * RS + (i % WPR) * 4) = x[j];
    }
  }
}

__device__ __forceinline__ void stage_scales(float* dst, const uint16_t* src, int r0,
                                             const PrefixArgs& a, int h, int tid) {
  for (int r = tid; r < PTILE; r += THREADS) {
    dst[r] = r0 + r < a.p0p ? bf16_bits_to_float(src[static_cast<size_t>(r0 + r) * a.sl0 + h])
                            : 0.0f;
  }
}

// S = Q K^T over a staged 64-row tile: lanes g and g+8 (of the block's 16)
// at rows 8n + 2t, 8n + 2t + 1, exact int32
template <int DP>
__device__ __forceinline__ void qk(int (&sc)[PTILE / 8][4], const uint32_t (&qa)[DP / 32][4],
                                   const int8_t* kt, int g, int t) {
  constexpr int RS = DP + 16;
#pragma unroll
  for (int n = 0; n < PTILE / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[n][i] = 0;
    const int8_t* krow = kt + (8 * n + g) * RS + 4 * t;
#pragma unroll
    for (int k = 0; k < DP / 32; ++k) {
      mma_s8(sc[n], qa[k], *reinterpret_cast<const uint32_t*>(krow + 32 * k),
             *reinterpret_cast<const uint32_t*>(krow + 32 * k + 16));
    }
  }
}

// A tile of the shared prefix (`sub` sub-tiles of 64 rows) for 16 lanes of
// one head. The tiles of a (head, lane group) form one cluster: each finds
// its lanes' max score, the cluster shares them, and every tile computes p
// against the prefix's max, as the plain version's one prefix block does,
// so the tiles' (l, acc) add. DP = D rounded up to 32 (q's padding columns
// are zero, so the dot ignores K's). Every warp scores the whole sub-tile
// (the S fragment of m16n8k32 is laid out as the A fragment of m16n8k16, so
// p never leaves registers) and computes DP/4 of the output columns.
// Fragments (g = lane/4, t = lane%4): S and O hold lanes g and g+8 at
// columns 2t, 2t+1 of each 8-wide n-tile.
template <int DP>
__global__ void __launch_bounds__(THREADS) prefix_kernel(const PrefixArgs a) {
  constexpr int KSTEPS = DP / 32;            // QK steps along D
  constexpr int NT = PTILE / 8;              // QK n-tiles: prefix rows
  constexpr int ONT = DP / 8 / WARPS;        // PV n-tiles of a warp: output columns
  constexpr int RS = DP + 16;                // staged row stride (bytes): no bank conflicts
  __shared__ __align__(16) int8_t kt[PTILE * RS];
  __shared__ __align__(16) int8_t vt[PTILE * RS];
  __shared__ float ksc[PTILE];
  __shared__ float vsc[PTILE];
  __shared__ float cmax[LTILE];

  // the lane kernel may start now: it reads this grid's output only after
  // its scores, behind griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;");

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int lb0 = blockIdx.z * LTILE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int D = a.D;
  const int hd = a.H * D;

  // q of lanes lb0 + g and lb0 + g + 8 as A fragments (zeros past B and D)
  const int blo = lb0 + g, bhi = lb0 + g + 8;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int k = 0; k < KSTEPS; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int bb = (i & 1) ? bhi : blo;
      const int col = 32 * k + 4 * t + ((i & 2) ? 16 : 0);
      qa[k][i] = 0u;
      if (bb < a.B && col < D) {
        qa[k][i] = *reinterpret_cast<const uint32_t*>(a.q8 + static_cast<size_t>(bb) * hd + h * D +
                                                      col);
      }
    }
  }
  const float qs_lo = blo < a.B ? a.qs[blo * a.H + h] : 0.0f;
  const float qs_hi = bhi < a.B ? a.qs[bhi * a.H + h] : 0.0f;

  // pass 1: each lane's max score over the tile's valid rows (rows < p0)
  int sc[NT][4];
  float m_lo = NEG_INF, m_hi = NEG_INF;
  for (int st = 0; st < a.sub; ++st) {
    const int r0 = (tile * a.sub + st) * PTILE;
    if (st > 0) __syncthreads();             // the last sub-tile's K is consumed
    stage_rows<DP>(kt, a.k0, r0, a, h, tid);
    stage_scales(ksc, a.ks0, r0, a, h, tid);
    if (a.sub == 1) {                        // kept for pass 2
      stage_rows<DP>(vt, a.v0, r0, a, h, tid);
      stage_scales(vsc, a.vs0, r0, a, h, tid);
    }
    __syncthreads();
    qk<DP>(sc, qa, kt, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * n + 2 * t + (i & 1);
        if (r0 + r < a.p0) {
          const float s = static_cast<float>(sc[n][i]) * ksc[r] * (i < 2 ? qs_lo : qs_hi) * a.scale;
          if (i < 2) m_lo = fmaxf(m_lo, s);
          else m_hi = fmaxf(m_hi, s);
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
  }
  if (gridDim.x > 1) {                       // the max over the whole prefix
    cg::cluster_group cluster = cg::this_cluster();
    if (warp == 0 && t == 0) {
      cmax[g] = m_lo;
      cmax[g + 8] = m_hi;
    }
    cluster.sync();
    for (int r = 0; r < static_cast<int>(gridDim.x); ++r) {
      const float* rm = cluster.map_shared_rank(cmax, r);
      m_lo = fmaxf(m_lo, rm[g]);
      m_hi = fmaxf(m_hi, rm[g + 8]);
    }
  }

  // pass 2: p against the prefix's max, pv in bf16, O += pv @ V over the
  // warp's output columns (V's B fragment: rows 2t, 2t+1 and 8 more of one
  // column, widened to bf16, exact)
  float o[ONT][4];
#pragma unroll
  for (int j = 0; j < ONT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.0f;
  }
  float l_lo = 0.0f, l_hi = 0.0f;
  for (int st = 0; st < a.sub; ++st) {
    const int r0 = (tile * a.sub + st) * PTILE;
    if (a.sub > 1) {
      __syncthreads();                       // the last sub-tile is consumed
      stage_rows<DP>(kt, a.k0, r0, a, h, tid);
      stage_rows<DP>(vt, a.v0, r0, a, h, tid);
      stage_scales(ksc, a.ks0, r0, a, h, tid);
      stage_scales(vsc, a.vs0, r0, a, h, tid);
      __syncthreads();
      qk<DP>(sc, qa, kt, g, t);
    }
    float pv[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * n + 2 * t + (i & 1);
        float p = 0.0f;
        if (r0 + r < a.p0) {
          const float s = static_cast<float>(sc[n][i]) * ksc[r] * (i < 2 ? qs_lo : qs_hi) * a.scale;
          p = expf(s - (i < 2 ? m_lo : m_hi));
        }
        if (i < 2) l_lo += p;
        else l_hi += p;
        pv[n][i] = p * vsc[r];               // rounded to bf16 in the packing
      }
    }
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int k = 0; k < NT / 2; ++k) {
      pa[k][0] = pack_bf16(pv[2 * k][0], pv[2 * k][1]);
      pa[k][1] = pack_bf16(pv[2 * k][2], pv[2 * k][3]);
      pa[k][2] = pack_bf16(pv[2 * k + 1][0], pv[2 * k + 1][1]);
      pa[k][3] = pack_bf16(pv[2 * k + 1][2], pv[2 * k + 1][3]);
    }
#pragma unroll
    for (int j = 0; j < ONT; ++j) {
      const int col = (warp * ONT + j) * 8 + g;
#pragma unroll
      for (int k = 0; k < NT / 2; ++k) {
        const int8_t* vcol = vt + (16 * k + 2 * t) * RS + col;
        const uint32_t b0 = pack_bf16(vcol[0], vcol[RS]);
        const uint32_t b1 = pack_bf16(vcol[8 * RS], vcol[9 * RS]);
        mma_bf16(o[j], pa[k], b0, b1);
      }
    }
  }
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o2);
  }
  if (gridDim.x > 1) cg::this_cluster().sync();  // every rank has read cmax

  // the tile's partial states: pm/pl (tiles, B, H), pacc (tiles, B, H, D)
  const size_t ilo = (static_cast<size_t>(tile) * a.B + blo) * a.H + h;
  const size_t ihi = (static_cast<size_t>(tile) * a.B + bhi) * a.H + h;
  if (warp == 0 && t == 0) {
    if (blo < a.B) {
      a.pm[ilo] = m_lo;
      a.pl[ilo] = l_lo;
    }
    if (bhi < a.B) {
      a.pm[ihi] = m_hi;
      a.pl[ihi] = l_hi;
    }
  }
#pragma unroll
  for (int j = 0; j < ONT; ++j) {
    const int col = (warp * ONT + j) * 8 + 2 * t;
    if (col < D) {                           // D % 4 == 0: col + 1 < D too
      if (blo < a.B) {
        *reinterpret_cast<float2*>(a.pacc + ilo * D + col) = make_float2(o[j][0], o[j][1]);
      }
      if (bhi < a.B) {
        *reinterpret_cast<float2*>(a.pacc + ihi * D + col) = make_float2(o[j][2], o[j][3]);
      }
    }
  }
}

template <int VEC, int TPR>
cudaError_t launch_lane(const LaneArgs& a, int splits, cudaStream_t st) {
  // the split's scores and its blocks' maxima
  const int smem = (a.split_rows + a.split_rows / a.bs) * static_cast<int>(sizeof(float));
  static int sized = 48 * 1024;              // the largest dynamic size allowed so far
  if (smem > sized) {
    cudaError_t e = cudaFuncSetAttribute(lane_kernel<VEC, TPR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.H, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (splits > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = splits;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (a.ptiles > 0) {
    // start while prefix_kernel runs (programmatic dependent launch): the
    // scores do not depend on it, its tiles are read behind griddepcontrol.wait
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, lane_kernel<VEC, TPR>, a);
}

// the lane kernel for 16-byte (vec16) or 4-byte loads at head dim D
cudaError_t launch_lane_route(const LaneArgs& a, int splits, bool vec16, cudaStream_t st) {
  const int n = a.D / (vec16 ? 16 : 4);      // threads a row needs
  if (vec16) {
    if (n <= 1) return launch_lane<16, 1>(a, splits, st);
    if (n <= 2) return launch_lane<16, 2>(a, splits, st);
    if (n <= 4) return launch_lane<16, 4>(a, splits, st);
    return launch_lane<16, 8>(a, splits, st);
  }
  if (n <= 1) return launch_lane<4, 1>(a, splits, st);
  if (n <= 2) return launch_lane<4, 2>(a, splits, st);
  if (n <= 4) return launch_lane<4, 4>(a, splits, st);
  if (n <= 8) return launch_lane<4, 8>(a, splits, st);
  if (n <= 16) return launch_lane<4, 16>(a, splits, st);
  return launch_lane<4, 32>(a, splits, st);
}

template <int DP>
cudaError_t launch_prefix_dp(const PrefixArgs& a, int tiles, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, a.H, (a.B + LTILE - 1) / LTILE);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // the tiles of a (head, lane group)
  attr[0].val.clusterDim.x = tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = tiles > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, prefix_kernel<DP>, a);
}

cudaError_t launch_prefix(const PrefixArgs& a, int tiles, cudaStream_t st) {
  const int dp = (a.D + 31) / 32 * 32;
  if (dp == 32) return launch_prefix_dp<32>(a, tiles, st);
  if (dp == 64) return launch_prefix_dp<64>(a, tiles, st);
  if (dp == 96) return launch_prefix_dp<96>(a, tiles, st);
  return launch_prefix_dp<128>(a, tiles, st);
}

}  // namespace

// C interface, loaded with ctypes. ptiles == 0: no shared prefix (k0 and the
// scratch unused); else k0/v0 (P0p, H*D) int8, ks0/vs0 (P0p, sl0) bf16, p0
// live rows in ptiles tiles of psub sub-tiles of 64 rows (ptiles <= 8, one
// cluster), and pm/pl/pacc (ptiles, B, H[, D]) f32 scratch that
// prefix_kernel fills and lane_kernel reads. kc == nullptr: no current row
// (K2, K2', T1); else kc/vc (B, H*D) int8 and kcs/vcs (B, SLc) bf16, and
// with write != 0 the row is stored at slot b1 + 1 of k8/ks/v8/vs (K2'').
// kv_stride: bytes between two cache rows of k8 (and of v8); SL: elements
// between two scale rows. splits: blocks (one cluster, <= 8) per (head,
// lane), each over split_rows slots (a multiple of bs, the blocks of slots
// whose running max the plain version keeps); vec: 16 where D % 16 == 0 and every
// row segment is 16-byte aligned, else 4. out is (B,H,D) f32. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int flash_decode_int8_launch(
    const void* q8, const void* qs, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* lens, const void* a1, const void* b1, const void* a2,
    const void* b2, const void* k0, const void* ks0, const void* v0, const void* vs0, int p0,
    int p0p, int sl0, int ptiles, int psub, void* pm, void* pl, void* pacc, const void* kc,
    const void* kcs, const void* vc, const void* vcs, int SLc, int write, void* out, int layer,
    int B, int S, int H, int D, int SL, int kv_stride, int splits, int split_rows, int bs,
    int vec, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ptiles > 0) {
    PrefixArgs p = {static_cast<const int8_t*>(q8), static_cast<const float*>(qs),
                    static_cast<const int8_t*>(k0), static_cast<const uint16_t*>(ks0),
                    static_cast<const int8_t*>(v0), static_cast<const uint16_t*>(vs0),
                    p0, p0p, sl0, B, H, D, vec == 16, psub, scale,
                    static_cast<float*>(pm), static_cast<float*>(pl),
                    static_cast<float*>(pacc)};
    cudaError_t e = launch_prefix(p, ptiles, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  LaneArgs a = {};
  a.q8 = static_cast<const int8_t*>(q8);
  a.qs = static_cast<const float*>(qs);
  a.k8 = static_cast<const int8_t*>(k8);
  a.ks = static_cast<const uint16_t*>(ks);
  a.v8 = static_cast<const int8_t*>(v8);
  a.vs = static_cast<const uint16_t*>(vs);
  a.lens = static_cast<const int*>(lens);
  a.a1 = static_cast<const int*>(a1);
  a.b1 = static_cast<const int*>(b1);
  a.a2 = static_cast<const int*>(a2);
  a.b2 = static_cast<const int*>(b2);
  a.pm = ptiles > 0 ? static_cast<const float*>(pm) : nullptr;
  a.pl = ptiles > 0 ? static_cast<const float*>(pl) : nullptr;
  a.pacc = ptiles > 0 ? static_cast<const float*>(pacc) : nullptr;
  a.ptiles = ptiles;
  a.kc = static_cast<const int8_t*>(kc);
  a.kcs = static_cast<const uint16_t*>(kcs);
  a.vc = static_cast<const int8_t*>(vc);
  a.vcs = static_cast<const uint16_t*>(vcs);
  a.SLc = SLc;
  if (write) {
    a.kw = static_cast<int8_t*>(const_cast<void*>(k8));
    a.ksw = static_cast<uint16_t*>(const_cast<void*>(ks));
    a.vw = static_cast<int8_t*>(const_cast<void*>(v8));
    a.vsw = static_cast<uint16_t*>(const_cast<void*>(vs));
  }
  a.layer = layer;
  a.B = B;
  a.S = S;
  a.H = H;
  a.D = D;
  a.SL = SL;
  a.kv_stride = kv_stride;
  a.split_rows = split_rows;
  a.bs = bs;
  a.scale = scale;
  a.out = static_cast<float*>(out);
  cudaError_t e = launch_lane_route(a, splits, vec == 16, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

