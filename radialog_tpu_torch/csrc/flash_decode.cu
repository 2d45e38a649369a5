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
//     read), which leaves each lane's online softmax state (m, l, acc)
//     after the prefix block in a small scratch; `lane_kernel` starts from
//     that state, so the blocks are still walked in the TPU kernel's order
//     (prefix first, then slot blocks);
//   * one block per (head, lane) streams that head's 128-byte row segments
//     with 4-byte loads per thread (K, dp4a) and 1-byte loads (V), and the
//     1792 blocks of the decode shape (56 lanes x 32 heads) keep every SM
//     busy.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int PREFIX_THREADS = 512;
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
// from device memory once into shared memory; then each warp takes one lane
// at a time: a thread scores whole rows (K rows padded to D + 4 bytes so the
// 32 rows a warp reads at once sit in 32 banks), max and sum are warp
// shuffles, and the warp's threads split D for p @ V. No block barrier is
// needed after the load, so the lanes of a head proceed in parallel.
__global__ void __launch_bounds__(PREFIX_THREADS)
prefix_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs,
              const int8_t* __restrict__ k0, const uint16_t* __restrict__ ks0,
              const int8_t* __restrict__ v0, const uint16_t* __restrict__ vs0,
              int p0, int p0p, int sl0, int B, int H, int D, float scale,
              float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int kstr = D / 4 + 1;                                   // K row stride, words
  int* k_tile = reinterpret_cast<int*>(smem);                   // p0p * kstr
  int8_t* v_tile = reinterpret_cast<int8_t*>(k_tile + p0p * kstr);  // p0p * D
  float* kscale = reinterpret_cast<float*>(v_tile + p0p * D);   // p0p
  float* vscale = kscale + p0p;                                 // p0p
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int WARPS = PREFIX_THREADS / 32;
  float* sbuf = vscale + p0p + warp * p0p;                      // per warp: p0p
  int* qbuf = reinterpret_cast<int*>(vscale + p0p + WARPS * p0p) + warp * (D / 4);
  const int hd = H * D;

  for (int i = tid; i < p0p * (D / 4); i += PREFIX_THREADS) {
    const int r = i / (D / 4);
    const int w = i % (D / 4);
    k_tile[r * kstr + w] = reinterpret_cast<const int*>(k0 + (size_t)r * hd + h * D)[w];
    reinterpret_cast<int*>(v_tile)[i] = reinterpret_cast<const int*>(v0 + (size_t)r * hd + h * D)[w];
  }
  for (int r = tid; r < p0p; r += PREFIX_THREADS) {
    kscale[r] = bf16_bits_to_float(ks0[(size_t)r * sl0 + h]);
    vscale[r] = bf16_bits_to_float(vs0[(size_t)r * sl0 + h]);
  }
  __syncthreads();

  for (int b = warp; b < B; b += WARPS) {
    const int* qrow = reinterpret_cast<const int*>(q8 + (size_t)b * hd + h * D);
    for (int w = lane; w < D / 4; w += 32) qbuf[w] = qrow[w];
    __syncwarp();
    const float qscale = qs[b * H + h];
    float m_cur = NEG_INF;
    for (int r = lane; r < p0p; r += 32) {
      int dot = 0;
      for (int w = 0; w < D / 4; ++w) dot = __dp4a(k_tile[r * kstr + w], qbuf[w], dot);
      const float s = r < p0 ? static_cast<float>(dot) * kscale[r] * qscale * scale : NEG_INF;
      sbuf[r] = s;
      m_cur = fmaxf(m_cur, s);
    }
    const float m_new = fmaxf(NEG_INF, warp_max(m_cur));
    float psum = 0.0f;
    for (int r = lane; r < p0p; r += 32) {
      const float p = r < p0 ? expf(sbuf[r] - m_new) : 0.0f;
      psum += p;
      sbuf[r] = round_bf16(p * vscale[r]);                      // pv, in place
    }
    const float l = warp_fsum(psum);
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float o = 0.0f;
      for (int r = 0; r < p0p; ++r) o += sbuf[r] * static_cast<float>(v_tile[r * D + d]);
      pacc[((size_t)b * H + h) * D + d] = o;                    // 0 * alpha + block sum
    }
    if (lane == 0) {
      pm[b * H + h] = m_new;
      pl[b * H + h] = l;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS)
lane_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs,
            const int8_t* __restrict__ k8, const uint16_t* __restrict__ ks,
            const int8_t* __restrict__ v8, const uint16_t* __restrict__ vs,
            const int* __restrict__ lens, const int* __restrict__ a1, const int* __restrict__ b1,
            const int* __restrict__ a2, const int* __restrict__ b2,
            const float* __restrict__ pm, const float* __restrict__ pl,
            const float* __restrict__ pacc, int layer, int B, int S, int H, int D, int SL,
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

  for (int blk = 0; blk < nblk; ++blk) {
    const int s0 = blk * bs;
    for (int r = warp; r < bs; r += THREADS / 32) {
      const int s = s0 + r;
      const int dot = dot_row(qrow, k8 + (lane_row0 + s) * hd + h * D, D, lane);
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
      const int8_t* vcol = v8 + (lane_row0 + s0) * hd + h * D + d;
      for (int r = 0; r < bs; ++r) o += pv[r] * static_cast<float>(vcol[(size_t)r * hd]);
      acc = acc * alpha + o;
    }
    __syncthreads();
  }
  if (d < D) {
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
    out[((size_t)b * H + h) * D + d] = acc * inv_l;
  }
}

}  // namespace

// Dynamic shared memory of prefix_kernel: the K tile (rows padded by one
// word), the V tile, two scale rows, and per warp a score row and a q row.
static size_t prefix_smem(int p0p, int d) {
  constexpr int warps = PREFIX_THREADS / 32;
  return static_cast<size_t>(p0p) * (d + 4) + static_cast<size_t>(p0p) * d +
         static_cast<size_t>(p0p) * (2 + warps) * sizeof(float) +
         static_cast<size_t>(warps) * d;
}

// C interface, loaded with ctypes. k0 == nullptr: no shared prefix. With a
// prefix, pm/pl/pacc are (B,H), (B,H), (B,H,D) f32 scratch. out is (B,H,D)
// f32. Returns the cudaError_t of the launches (0 on success).
extern "C" int flash_decode_int8_launch(
    const void* q8, const void* qs, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* lens, const void* a1, const void* b1, const void* a2,
    const void* b2, const void* k0, const void* ks0, const void* v0, const void* vs0, int p0,
    int p0p, int sl0, void* pm, void* pl, void* pacc, void* out, int layer, int B, int S,
    int H, int D, int SL, int bs, float scale, void* stream) {
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
      prefix ? static_cast<const float*>(pacc) : nullptr, layer, B, S, H, D, SL, bs, scale,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
