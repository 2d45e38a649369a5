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
//   online softmax in f32 over blocks of `bs` slots, in slot order, after
//   the shared-prefix block; pv = bf16(p * vs), V int8 -> bf16, f32 sums;
//   out = acc * (1 / max(l, 1e-30)).
//
// What bounds it on an H100: each live cache row is read once (H*D int8 of
// K and of V plus 2 bf16 scales per head) for ~4*H*D operations, about one
// operation per byte, so the kernel is bound by the bytes it reads. The
// design reads only what it must:
//   * blocks past a lane's live bound max(len-1, b1, b2) are never read;
//   * the shared prefix (rows < p0, common to every lane) is read once per
//     launch per head by `prefix_kernel` (one warp per lane after that
//     read, in chunks of up to 512 rows so that a prefix of any length up
//     to max_position fits shared memory), which leaves each lane's online
//     softmax state (m, l, acc) after the prefix in a small scratch;
//     `lane_kernel` starts from that state, so the blocks are still walked
//     in the TPU kernel's order (prefix first, then slot blocks);
//   * one block per (head, lane) streams that head's 128-byte row segments
//     with 4-byte loads per thread (K, dp4a) and 1-byte loads (V), and the
//     1792 blocks of the decode shape (56 lanes x 32 heads) keep every SM
//     busy.
//
// K2'' (the `current` / `write_cache` mode of the same TPU kernel, its
// `_current` and `_wcapture` blocks): the step's own K/V row arrives as an
// operand (kc, kcs, vc, vcs: (B, H*D) int8 and (B, SLc) bf16) and is
// accumulated after the prefix state and before the lane's first block, the
// TPU kernel's order; the caller's mask ends one slot before it. With
// `write` the block then stores its own head's D bytes of k and v and its
// two scale entries at slot b1 + 1 of lane b in the cache, and nothing else:
// no two blocks write the same bytes, no block reads another's, and the
// block's own reads of that slot (masked, p = 0) all come before its store.
// The TPU kernel rebuilds an 8-row slab and leaves the rows above the slot
// undefined; here every other byte of the cache stays as it was.
//
// T1 (tools/microbench_kvfused.py `fused_kernel`, K2 over one interleaved
// k|v buffer): `kv_stride` is the distance in bytes between two cache rows
// of k (and of v), SL the distance in elements between two scale rows. K2
// passes H*D and the scale width; T1 passes 2*H*D with v at k + H*D, and 2*H
// with the v scales at ks + H. The arithmetic is K2's, so T1 equals K2 bit
// for bit on the same data.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int PREFIX_THREADS = 512;
constexpr int PREFIX_CHUNK = 512;     // prefix rows held in shared memory at once
constexpr int MAX_BS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_bits_to_float(uint16_t u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int dot_row(const int8_t* q, const int8_t* k, int d, int lane) {
  int acc = 0;
  for (int w = lane; w < d / 4; w += 32) {
    acc = __dp4a(reinterpret_cast<const int*>(k)[w], reinterpret_cast<const int*>(q)[w], acc);
  }
  return warp_sum(acc);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_fsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The shared-prefix block for every lane of head h (one block per head),
// starting from the empty softmax state. The head's prefix K/V rows are read
// from device memory once, in chunks of at most PREFIX_CHUNK rows, into
// shared memory; for each chunk every warp takes one lane at a time: a
// thread scores whole rows (K rows padded to D + 4 bytes so the 32 rows a
// warp reads at once sit in 32 banks), max and sum are warp shuffles, and
// the warp's threads split D for p @ V. A lane's online-softmax state
// (m, l, acc) lives in pm/pl/pacc between chunks; lane b is always served
// by warp b % WARPS, so no other warp touches it. A prefix of at most
// PREFIX_CHUNK rows is one chunk, the TPU kernel's single prefix block.
__global__ void __launch_bounds__(PREFIX_THREADS)
prefix_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs,
              const int8_t* __restrict__ k0, const uint16_t* __restrict__ ks0,
              const int8_t* __restrict__ v0, const uint16_t* __restrict__ vs0,
              int p0, int p0p, int sl0, int B, int H, int D, float scale,
              float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int ch = min(p0p, PREFIX_CHUNK);                        // rows per chunk
  const int kstr = D / 4 + 1;                                   // K row stride, words
  int* k_tile = reinterpret_cast<int*>(smem);                   // ch * kstr
  int8_t* v_tile = reinterpret_cast<int8_t*>(k_tile + ch * kstr);  // ch * D
  float* kscale = reinterpret_cast<float*>(v_tile + ch * D);    // ch
  float* vscale = kscale + ch;                                  // ch
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int WARPS = PREFIX_THREADS / 32;
  float* sbuf = vscale + ch + warp * ch;                        // per warp: ch
  int* qbuf = reinterpret_cast<int*>(vscale + ch + WARPS * ch) + warp * (D / 4);
  const int hd = H * D;

  // rows at or past p0 are masked: chunks that hold none of the first p0
  // rows change no state and are not read (the first chunk always runs, so
  // p0 = 0 still leaves the empty state m = -1e30, l = 0, acc = 0)
  for (int c0 = 0; c0 == 0 || c0 < min(p0, p0p); c0 += ch) {
    const int rows = min(ch, p0p - c0);
    __syncthreads();                                            // last chunk consumed
    for (int i = tid; i < rows * (D / 4); i += PREFIX_THREADS) {
      const int r = i / (D / 4);
      const int w = i % (D / 4);
      const size_t src = (size_t)(c0 + r) * hd + h * D;
      k_tile[r * kstr + w] = reinterpret_cast<const int*>(k0 + src)[w];
      reinterpret_cast<int*>(v_tile)[i] = reinterpret_cast<const int*>(v0 + src)[w];
    }
    for (int r = tid; r < rows; r += PREFIX_THREADS) {
      kscale[r] = bf16_bits_to_float(ks0[(size_t)(c0 + r) * sl0 + h]);
      vscale[r] = bf16_bits_to_float(vs0[(size_t)(c0 + r) * sl0 + h]);
    }
    __syncthreads();

    for (int b = warp; b < B; b += WARPS) {
      const int* qrow = reinterpret_cast<const int*>(q8 + (size_t)b * hd + h * D);
      for (int w = lane; w < D / 4; w += 32) qbuf[w] = qrow[w];
      __syncwarp();
      const float qscale = qs[b * H + h];
      const float m_prev = c0 == 0 ? NEG_INF : pm[b * H + h];
      float m_cur = NEG_INF;
      for (int r = lane; r < rows; r += 32) {
        int dot = 0;
        for (int w = 0; w < D / 4; ++w) dot = __dp4a(k_tile[r * kstr + w], qbuf[w], dot);
        const float s = c0 + r < p0 ? static_cast<float>(dot) * kscale[r] * qscale * scale
                                    : NEG_INF;
        sbuf[r] = s;
        m_cur = fmaxf(m_cur, s);
      }
      const float m_new = fmaxf(m_prev, warp_max(m_cur));
      const float alpha = expf(m_prev - m_new);
      float psum = 0.0f;
      for (int r = lane; r < rows; r += 32) {
        const float p = c0 + r < p0 ? expf(sbuf[r] - m_new) : 0.0f;
        psum += p;
        sbuf[r] = round_bf16(p * vscale[r]);                    // pv, in place
      }
      const float l_blk = warp_fsum(psum);
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float o = 0.0f;
        for (int r = 0; r < rows; ++r) o += sbuf[r] * static_cast<float>(v_tile[r * D + d]);
        float* a = pacc + ((size_t)b * H + h) * D + d;
        *a = c0 == 0 ? o : *a * alpha + o;
      }
      if (lane == 0) {
        pm[b * H + h] = m_new;
        pl[b * H + h] = c0 == 0 ? l_blk : pl[b * H + h] * alpha + l_blk;
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(THREADS)
lane_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs,
            const int8_t* __restrict__ k8, const uint16_t* __restrict__ ks,
            const int8_t* __restrict__ v8, const uint16_t* __restrict__ vs,
            const int* __restrict__ lens, const int* __restrict__ a1, const int* __restrict__ b1,
            const int* __restrict__ a2, const int* __restrict__ b2,
            const float* __restrict__ pm, const float* __restrict__ pl,
            const float* __restrict__ pacc, const int8_t* __restrict__ kc,
            const uint16_t* __restrict__ kcs, const int8_t* __restrict__ vc,
            const uint16_t* __restrict__ vcs, int SLc, int8_t* kw, uint16_t* ksw, int8_t* vw,
            uint16_t* vsw, int layer, int B, int S, int H, int D, int SL, int kv_stride,
            int bs, float scale, float* __restrict__ out) {
  __shared__ float sc[MAX_BS];
  __shared__ float pr[MAX_BS];
  __shared__ float pv[MAX_BS];
  __shared__ unsigned char ok[MAX_BS];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hd = H * D;

  const int len = lens[b], la1 = a1[b], lb1 = b1[b], la2 = a2[b], lb2 = b2[b];
  const int live = max(max(len - 1, lb1), lb2);
  const int nblk = live < 0 ? 0 : min(live / bs + 1, S / bs);

  float m = NEG_INF, l = 0.0f, acc = 0.0f;
  const int d = tid;  // D <= THREADS (checked by the wrapper)
  if (pm != nullptr) {
    m = pm[b * H + h];
    l = pl[b * H + h];
    if (d < D) acc = pacc[((size_t)b * H + h) * D + d];
  }
  const int8_t* qrow = q8 + (size_t)b * hd + h * D;
  const float qscale = qs[b * H + h];
  const size_t lane_row0 = ((size_t)layer * B + b) * S;

  if (kc != nullptr) {
    // K2'': the current row, always valid, after the prefix and before the
    // lane's blocks (the plain version's block of one row)
    if (warp == 0) {
      const int dot = dot_row(qrow, kc + (size_t)b * hd + h * D, D, lane);
      if (lane == 0) {
        sc[0] = static_cast<float>(dot) * bf16_bits_to_float(kcs[(size_t)b * SLc + h]) *
                qscale * scale;
      }
    }
    __syncthreads();
    const float s = sc[0];
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
    m = m_new;
    if (d < D) {
      const float pvc = round_bf16(p * bf16_bits_to_float(vcs[(size_t)b * SLc + h]));
      acc = acc * alpha + pvc * static_cast<float>(vc[(size_t)b * hd + h * D + d]);
    }
    __syncthreads();                                            // sc[0] is read
  }

  for (int blk = 0; blk < nblk; ++blk) {
    const int s0 = blk * bs;
    for (int r = warp; r < bs; r += THREADS / 32) {
      const int s = s0 + r;
      const int dot = dot_row(qrow, k8 + (lane_row0 + s) * kv_stride + h * D, D, lane);
      if (lane == 0) {
        const bool valid = s < len || (s >= la1 && s <= lb1) || (s >= la2 && s <= lb2);
        const float kscale = bf16_bits_to_float(ks[(lane_row0 + s) * SL + h]);
        const float v = static_cast<float>(dot) * kscale * qscale * scale;
        sc[r] = valid ? v : NEG_INF;
        ok[r] = valid ? 1 : 0;
      }
    }
    __syncthreads();
    float m_cur = NEG_INF;
    for (int r = 0; r < bs; ++r) m_cur = fmaxf(m_cur, sc[r]);
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    for (int r = tid; r < bs; r += THREADS) {
      const float p = ok[r] ? expf(sc[r] - m_new) : 0.0f;
      pr[r] = p;
      const float vscale = bf16_bits_to_float(vs[(lane_row0 + s0 + r) * SL + h]);
      pv[r] = round_bf16(p * vscale);
    }
    __syncthreads();
    float psum = 0.0f;
    for (int r = 0; r < bs; ++r) psum += pr[r];
    l = l * alpha + psum;
    m = m_new;
    if (d < D) {
      float o = 0.0f;
      const int8_t* vcol = v8 + (lane_row0 + s0) * kv_stride + h * D + d;
      for (int r = 0; r < bs; ++r) o += pv[r] * static_cast<float>(vcol[(size_t)r * kv_stride]);
      acc = acc * alpha + o;
    }
    __syncthreads();
  }
  if (d < D) {
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
    out[((size_t)b * H + h) * D + d] = acc * inv_l;
  }
  if (kw != nullptr) {
    // K2'' write: this head's bytes of the current row at slot b1 + 1, after
    // every read of this block (the wrapper checks that the slot is < S)
    const size_t row = lane_row0 + lb1 + 1;
    if (d < D) {
      kw[row * kv_stride + h * D + d] = kc[(size_t)b * hd + h * D + d];
      vw[row * kv_stride + h * D + d] = vc[(size_t)b * hd + h * D + d];
    }
    if (tid == 0) {
      ksw[row * SL + h] = kcs[(size_t)b * SLc + h];
      vsw[row * SL + h] = vcs[(size_t)b * SLc + h];
    }
  }
}

}  // namespace

// Dynamic shared memory of prefix_kernel for one chunk: the K tile (rows
// padded by one word), the V tile, two scale rows, and per warp a score row
// and a q row. At most 168 KB (512 rows, D = 128).
static size_t prefix_smem(int p0p, int d) {
  constexpr int warps = PREFIX_THREADS / 32;
  const size_t ch = static_cast<size_t>(p0p < PREFIX_CHUNK ? p0p : PREFIX_CHUNK);
  return ch * (d + 4) + ch * d + ch * (2 + warps) * sizeof(float) +
         static_cast<size_t>(warps) * d;
}

// C interface, loaded with ctypes. k0 == nullptr: no shared prefix. With a
// prefix, pm/pl/pacc are (B,H), (B,H), (B,H,D) f32 scratch. kc == nullptr:
// no current row (K2, K2', T1); else kc/vc (B, H*D) int8 and kcs/vcs (B, SLc)
// bf16, and with write != 0 the row is stored at slot b1 + 1 of k8/ks/v8/vs
// (K2''). kv_stride: bytes between two cache rows of k8 (and of v8); SL:
// elements between two scale rows. out is (B,H,D) f32. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int flash_decode_int8_launch(
    const void* q8, const void* qs, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* lens, const void* a1, const void* b1, const void* a2,
    const void* b2, const void* k0, const void* ks0, const void* v0, const void* vs0, int p0,
    int p0p, int sl0, void* pm, void* pl, void* pacc, const void* kc, const void* kcs,
    const void* vc, const void* vcs, int SLc, int write, void* out, int layer, int B, int S,
    int H, int D, int SL, int kv_stride, int bs, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool prefix = k0 != nullptr;
  if (prefix) {
    const size_t smem = prefix_smem(p0p, D);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    prefix_kernel<<<H, PREFIX_THREADS, smem, st>>>(
        static_cast<const int8_t*>(q8), static_cast<const float*>(qs),
        static_cast<const int8_t*>(k0), static_cast<const uint16_t*>(ks0),
        static_cast<const int8_t*>(v0), static_cast<const uint16_t*>(vs0), p0, p0p, sl0, B, H,
        D, scale, static_cast<float*>(pm), static_cast<float*>(pl), static_cast<float*>(pacc));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H, B);
  lane_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(qs),
      static_cast<const int8_t*>(k8), static_cast<const uint16_t*>(ks),
      static_cast<const int8_t*>(v8), static_cast<const uint16_t*>(vs),
      static_cast<const int*>(lens), static_cast<const int*>(a1), static_cast<const int*>(b1),
      static_cast<const int*>(a2), static_cast<const int*>(b2),
      prefix ? static_cast<const float*>(pm) : nullptr,
      prefix ? static_cast<const float*>(pl) : nullptr,
      prefix ? static_cast<const float*>(pacc) : nullptr, static_cast<const int8_t*>(kc),
      static_cast<const uint16_t*>(kcs), static_cast<const int8_t*>(vc),
      static_cast<const uint16_t*>(vcs), SLc,
      write ? static_cast<int8_t*>(const_cast<void*>(k8)) : nullptr,
      write ? static_cast<uint16_t*>(const_cast<void*>(ks)) : nullptr,
      write ? static_cast<int8_t*>(const_cast<void*>(v8)) : nullptr,
      write ? static_cast<uint16_t*>(const_cast<void*>(vs)) : nullptr, layer, B, S, H, D, SL,
      kv_stride, bs, scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
