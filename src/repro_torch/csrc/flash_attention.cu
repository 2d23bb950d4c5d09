// Forward GQA attention (causal and sliding window) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_kernel :29-85); its
// oracle is src/repro/kernels/flash_attention_ref.py::reference. For every
// query row i of head h (kv head h / G), with q pre-scaled:
//   s_ij = scale * q_i . k_j          for the keys j the mask lets through
//   out_i = sum_j softmax(s_i)_j v_j  (online softmax, max and sum in fp32)
// The mask is causal (j <= i) and/or a window (j > i - window). A row that no
// key reaches gives 0, not NaN: its sum stays 0 and is clamped at 1e-30, as
// in the TPU kernel (:85). q (B,S,H,hd), k/v (B,S,KV,hd), all contiguous, in
// float32 or bfloat16; o like q. Accumulation is fp32 throughout; the
// probabilities are not rounded to v's type (the TPU kernel's semantics).
//
// What bounds it: operations. At the zamba2-7b prefill shape, q/k/v
// (1, 2048, 32, 112) bf16 causal, the work is 4*hd*H*S(S+1)/2 = 30.1 GFLOP,
// 0.030 ms at the H100's 989 TFLOP/s bf16 tensor-core rate, against 58.7 MB
// of q, k, v and o (0.018 ms at 3.35 TB/s).
//
// Head dims up to 192, the Pallas kernel's domain on the paths that use it:
// deepseek-v2-lite's MLA prefill runs q and k 192 wide (128 decompressed +
// 64 rope) and v zero-padded from 128 to 192, since the TPU kernel, and so
// this one, takes one head dim for q, k and v. The padded columns cost a
// third of P V; a P V over v's own width is later work.
//
// Two kernels; the wrapper (kernels/flash_attention.py) picks one by a stated
// rule, and neither falls back to the other.
//
// flash_fwd_tc, bf16 with hd % 8 == 0 and hd <= 192: the tensor cores.
//   * A block takes 128 query rows of one query head: two consumer
//     warpgroups of 64 rows each and one producer warp. The producer loads Q
//     once and K/V tiles of 64 keys through a ring of 3 stages with TMA
//     (mbarriers: full when the bytes land, empty when both warpgroups are
//     done); tensor maps are made on the host with cuTensorMapEncodeTiled,
//     found through cudaGetDriverEntryPoint (no -lcuda), and passed as
//     __grid_constant__ parameters.
//   * S = Q K^T by wgmma, both operands K-major from shared memory (TMA's
//     128-byte swizzle); the online softmax in fp32 registers in base 2
//     (scale and log2(e) folded into one multiply).
//   * O += P V by wgmma with P from registers and V MN-major (its stored
//     [key][hd] layout, the transpose bit). P enters as a bf16 pair
//     P_hi = bf16(P), P_lo = bf16(P - P_hi): P rounded once to bf16 misses
//     the card bound of 1e-3 + 2^-7 |ref| near 0 (tests/torch_parity.py
//     emulates both), so the P V products cost twice the algorithm's.
//   * Within a warpgroup, S of the next tile and P V of this one are in
//     flight together, and the next softmax overlaps P V.
//   * Head dims: hd is zero-padded to 64, 128 or 192 columns in shared
//     memory by TMA's out-of-bounds fill (boxes of 64 columns); the products
//     run over hd rounded up to 64, 112, 120, 128 or 192 (a wgmma N); the
//     TMA store of O writes only hd columns and the rows < S. At 192 a
//     block holds Q (48 KB) and 3 stages of K and V (48 KB each): 193 KB of
//     the 227 KB it may opt into, and O takes 96 fp32 registers a thread:
//     there the producer is a whole warpgroup, which gives its registers to
//     the consumers with setmaxnreg (40 and 232 a thread).
//   * Causal and window: each warpgroup loops only over the tiles its rows
//     see, masks only the tiles that cross an edge, and waits for and
//     releases the rest unread; blocks are launched longest rows first.
//   * GQA: one block per (tile, query head, batch), so a kv head's K/V is
//     read by its G query heads' blocks, from L2 for the most part.
//   * Not done: ping-pong scheduling of the two warpgroups, 128-key tiles
//     with setmaxnreg, a persistent grid.
//
// flash_fwd, float32 (whose 3e-5 bound the tensor cores cannot hold) and
// bf16 with another hd: the fp32 CUDA cores, the first, simple port.
//   * one block per (batch, kv head, tile of 64 rows of the grouped query
//     matrix); a tile is 64/G query positions times the G query heads of the
//     kv head, so every K/V tile is read from HBM once for all G heads;
//   * hd up to 128 or, with 6 float4 of the output a row pair and thread in
//     place of 4, up to 192 (two instances of the kernel);
//   * the kv loop runs only over the key range the tile's rows can see
//     (causal upper end, window lower end): fully masked tiles are skipped,
//     not masked (the TPU kernel's :41-47);
//   * q, K and V tiles are staged through shared memory as fp32 and each
//     thread computes a 2x4 register tile of scores and a 2x16 tile of the
//     output, so shared-memory reads are float4 and conflict-free (odd row
//     stride in float4 units);
//   * a ragged last tile (S not a multiple of the tile) is masked here; the
//     TPU kernel asserted S % block == 0 (:101).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 64;      // rows of the grouped query matrix per block
constexpr int BK = 32;        // keys per K/V tile
constexpr int THREADS = 256;  // 32 row pairs x 8 lanes
constexpr int MAX_HD = 192;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 4 consecutive elements of a row of length hd, from column 4*c4, as fp32
// times mul; zero past hd.
template <typename T>
__device__ __forceinline__ float4 load4(const T* row, int c4, int hd,
                                        float mul) {
  float e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 4 * c4 + j;
    e[j] = c < hd ? load_f(row + c) * mul : 0.f;
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

size_t smem_bytes(int hd) {
  const int hd4 = (hd + 3) / 4;
  const int st4 = hd4 | 1;
  return sizeof(float4) * ((size_t)(ROWS + BK) * st4 + (size_t)BK * hd4) +
         sizeof(float) * ROWS * (BK + 1);
}

// grid (tiles, KV, B); row r of a tile is position p0 + r / G of query head
// kvh * G + r % G. A thread owns output columns 4 (tx + 8 j), j < NJ: hd up
// to 32 NJ.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int H,
              int KV, int hd, int pos_per_tile, float scale, int causal,
              int window) {
  extern __shared__ float4 smem4[];
  const int G = H / KV;
  const int hd4 = (hd + 3) / 4;
  const int st4 = hd4 | 1;
  float4* Qs = smem4;                      // [ROWS][st4]
  float4* Ks = Qs + ROWS * st4;            // [BK][st4]
  float4* Vs = Ks + BK * st4;              // [BK][hd4]
  float* Ps = reinterpret_cast<float*>(Vs + BK * hd4);  // [ROWS][BK + 1]

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int p0 = blockIdx.x * pos_per_tile;
  const int p_end = min(p0 + pos_per_tile, S);
  const int nrows = (p_end - p0) * G;
  const int t = threadIdx.x, ty = t >> 3, tx = t & 7;

  for (int i = t; i < ROWS * st4; i += THREADS) {
    const int r = i / st4, c4 = i - r * st4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows && c4 < hd4) {
      const int pos = p0 + r / G, h = kvh * G + r % G;
      val = load4(q + (((size_t)b * S + pos) * H + h) * hd, c4, hd, scale);
    }
    Qs[i] = val;
  }

  int lo = 0, hi = S;
  if (window > 0) lo = max(p0 - window + 1, 0);
  if (causal) hi = p_end;
  lo = lo / BK * BK;

  int row[2], pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = ty + 32 * i;
    pos[i] = p0 + row[i] / G;
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float4 acc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile's P.V is done with Ks, Vs, Ps
    for (int i = t; i < BK * hd4; i += THREADS) {
      const int kk = i / hd4, c4 = i - kk * hd4, key = k0 + kk;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (key < S) {
        const size_t off = (((size_t)b * S + key) * KV + kvh) * hd;
        kv4 = load4(k + off, c4, hd, 1.f);
        vv4 = load4(v + off, c4, hd, 1.f);
      }
      Ks[kk * st4 + c4] = kv4;
      Vs[kk * hd4 + c4] = vv4;
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c4 = 0; c4 < hd4; ++c4) {
      const float4 qa = Qs[row[0] * st4 + c4];
      const float4 qb = Qs[row[1] * st4 + c4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kk4 = Ks[(tx + 8 * j) * st4 + c4];
        s[0][j] = dot4(qa, kk4, s[0][j]);
        s[1][j] = dot4(qb, kk4, s[1][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 8 * j;
        ok[j] = row[i] < nrows && key < S && (!causal || key <= pos[i]) &&
                (window <= 0 || key > pos[i] - window);
        s[i][j] = ok[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[row[i] * (BK + 1) + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j].x *= alpha;
        acc[i][j].y *= alpha;
        acc[i][j].z *= alpha;
        acc[i][j].w *= alpha;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      const float pa = Ps[row[0] * (BK + 1) + kk];
      const float pb = Ps[row[1] * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c4 = tx + 8 * j;
        if (c4 < hd4) {
          const float4 vv4 = Vs[kk * hd4 + c4];
          axpy4(pa, vv4, acc[0][j]);
          axpy4(pb, vv4, acc[1][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= nrows) continue;
    const int h = kvh * G + row[i] % G;
    T* dst = o + (((size_t)b * S + pos[i]) * H + h) * hd;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c4 = tx + 8 * j;
      const float e[4] = {acc[i][j].x, acc[i][j].y, acc[i][j].z, acc[i][j].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * c4 + u;
        if (c4 < hd4 && c < hd) store_f(dst + c, e[u] * inv);
      }
    }
  }
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int hd, float scale, int causal,
              int window, void* stream) {
  const int pos_per_tile = ROWS / (H / KV);
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + pos_per_tile - 1) / pos_per_tile, KV, B);
  flash_fwd<T, NJ><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KV, hd,
      pos_per_tile, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int hd, float scale, int causal, int window,
           void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || H / KV > ROWS ||
      hd <= 0 || hd > MAX_HD || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  if (hd <= 128)
    return launch_nj<T, 4>(q, k, v, o, B, S, H, KV, hd, scale, causal,
                           window, stream);
  return launch_nj<T, 6>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                         stream);
}

// ---------------------------------------------------------------------------
// The bf16 kernel on wgmma + TMA. grid (H, B, ceil(S / BM)), 288 threads
// (384 at HDN 192): warpgroups 0 and 1 consume (64 query rows each), warp 8
// produces.
namespace tc {

constexpr int BM = 128;            // query rows a block
constexpr int BN = 64;             // keys a K/V tile
constexpr int STAGES = 3;          // K/V tiles in flight
// two consumer warpgroups and one producer warp; at HDN 192 a whole
// producer warpgroup, so that setmaxnreg (which acts on whole warpgroups)
// can move its registers to the consumers: O's 96 fp32 registers a thread
// do not fit the 168 that 9 warps leave each, where ptxas spills and
// serializes the wgmmas
template <int HDN>
constexpr int threads() {
  return HDN > 128 ? 3 * 128 : 2 * 128 + 32;
}
constexpr int PRODUCER_REGS = 40;    // 256 x 232 + 128 x 40 <= 384 x 168
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte boundary (the 128-byte swizzle repeats
// every 8 rows of 128 bytes): Q [NH][BM][64], then STAGES x (K [NH][BN][64],
// V [NH][BN][64]), bf16, each [rows][64] block as TMA's SWIZZLE_128B lays it
// out; NH = HDP / 64 column blocks of the head dim zero-padded to HDP. Then
// the mbarriers. HDN, the head dim the products run over, is hd rounded up
// to 64, 112, 120, 128 or 192 (a wgmma N; S = Q K^T takes ceil(HDN / 16)
// steps).
template <int HDN>
struct Plan {
  static constexpr int HDP = HDN <= 64 ? 64 : HDN <= 128 ? 128 : 192;
  static constexpr int NH = HDP / 64;
  static constexpr int Q_BYTES = NH * BM * 128;
  static constexpr int KV_BYTES = NH * BN * 128;  // one of K, V
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = K_OFF + STAGES * STAGE_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: a box of the 4-D map (hd, heads, S, B) into shared memory, and back
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start >> 4, leading
// byte offset >> 4 (bits 16-29), stride byte offset >> 4 (bits 32-45),
// layout type 1 (bits 62-63)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B on one warpgroup, m64 x n x k16, bf16 in, fp32 sums; ss: A and
// B from shared memory (K-major), rs: A from registers, B MN-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n120(float (&d)[60],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59"
      "}, {%60, %61, %62, %63}, %64, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// O += P V, N = the padded head dim, from registers P and MN-major V
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  if constexpr (N == 112) wgmma_rs_n112(d, a, db, 1);
  if constexpr (N == 120) wgmma_rs_n120(d, a, db, 1);
  if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  if constexpr (N == 192) wgmma_rs_n192(d, a, db, 1);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (u, v) as a bf16 pair hi + lo: hi = bf16(u), lo = bf16(u - hi)
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

// The scores of one key tile (accumulator layout: element i is row r0 for
// i & 2 == 0, else r1, key k0 + 8 (i / 4) + 2u + (i & 1)) -> probabilities
// in place, the online softmax in base 2 with the TPU kernel's semantics:
// masked entries -1e30 and exactly 0, the sum from the fp32 values. Returns
// the factors the earlier sums of rows r0 and r1 take.
__device__ __forceinline__ float2 softmax_tile(float (&s)[32], int k0, int r0,
                                               int r1, int u, int S,
                                               int causal, int window,
                                               bool edge, float scale_log2,
                                               float& m0, float& m1,
                                               float& l0, float& l1) {
  float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = k0 + 8 * (i / 4) + 2 * u + (i & 1);
    const int row = (i & 2) ? r1 : r0;
    float v = s[i] * scale_log2;
    if (edge && !(key < S && (!causal || key <= row) &&
                  (window <= 0 || key > row - window)))
      v = -1e30f;
    s[i] = v;
    if (i & 2)
      mx1 = fmaxf(mx1, v);
    else
      mx0 = fmaxf(mx0, v);
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
  const float2 alpha = make_float2(exp2f(m0 - n0), exp2f(m1 - n1));
  m0 = n0;
  m1 = n1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = s[i] == -1e30f ? 0.f : exp2f(s[i] - ((i & 2) ? n1 : n0));
    s[i] = p;
    if (i & 2)
      sum1 += p;
    else
      sum0 += p;
  }
  l0 = l0 * alpha.x + sum0;
  l1 = l1 * alpha.y + sum1;
  return alpha;
}

// P as the A fragments of the 4 k16 steps of P V, each a bf16 pair hi + lo
// (the accumulators of key blocks 2 kk and 2 kk + 1 are step kk's A)
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&ph)[4][4],
                                       uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
}

template <int HDN>
__global__ void __launch_bounds__(threads<HDN>(), 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, int S, int H,
                 int KV, float scale_log2, int causal, int window) {
  using PL = Plan<HDN>;
  constexpr int NH = PL::NH;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + PL::K_OFF;
  const uint32_t bar_full = base + PL::BAR_OFF;        // STAGES barriers
  const uint32_t bar_empty = bar_full + 8 * STAGES;    // STAGES barriers
  const uint32_t bar_q = bar_empty + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest rows first
  const int kvh = h / (H / KV);
  int lo = window > 0 ? max(q0 - window + 1, 0) : 0;
  lo = lo / BN * BN;
  const int hi = causal ? min(q0 + BM, S) : S;
  const int n_tiles = (hi - lo + BN - 1) / BN;
  // the warp index through a shuffle: the compiler then knows it is the
  // same in every lane, and so is each branch on it around a wgmma
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, 2 * 128);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: Q once, then K and V tiles through the ring
    if constexpr (HDN > 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          PRODUCER_REGS));
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(bar_q, PL::Q_BYTES);
      for (int c = 0; c < NH; ++c)
        tma_load(sQ + c * BM * 128, &tm_q, 64 * c, h, q0, b, bar_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES)
          mbar_wait(bar_empty + 8 * st, ((it / STAGES) & 1) ^ 1);
        const uint32_t k_dst = sK + st * PL::STAGE_BYTES;
        const uint32_t v_dst = k_dst + PL::KV_BYTES;
        mbar_expect_tx(bar_full + 8 * st, PL::STAGE_BYTES);
        const int k0 = lo + it * BN;
        for (int c = 0; c < NH; ++c) {
          tma_load(k_dst + c * BN * 128, &tm_k, 64 * c, kvh, k0, b,
                   bar_full + 8 * st);
          tma_load(v_dst + c * BN * 128, &tm_v, 64 * c, kvh, k0, b,
                   bar_full + 8 * st);
        }
      }
    }
    return;
  }

  if constexpr (HDN > 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread rows
  // r0 and r0 + 8 (g = lane / 4), and columns 8 j + 2u, + 1 of each n8
  // block j of the wgmma accumulators (u = lane % 4)
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, u = lane & 3;
  const int row_lo = q0 + 64 * wg, row_hi = row_lo + 63;
  const int r0 = row_lo + 16 * wq + g, r1 = r0 + 8;
  // the tiles some row of this warpgroup sees: [it_begin, it_end); it
  // waits for the others and releases them unread, without a wgmma on a
  // divergent path
  int it_end = causal ? min(n_tiles, (row_hi - lo) / BN + 1) : n_tiles;
  const int thr = row_lo - window - BN + 1 - lo;
  int it_begin = window > 0 && thr >= 0 ? thr / BN + 1 : 0;
  if (row_lo >= S) it_end = 0;
  it_begin = min(it_begin, it_end);
  const uint32_t q_tile = sQ + 64 * wg * 128;
  auto full = [&](int it) {
    mbar_wait(bar_full + 8 * (it % STAGES), (it / STAGES) & 1);
  };
  auto release = [&](int it) { mbar_arrive(bar_empty + 8 * (it % STAGES)); };
  auto k_tile = [&](int it) {
    return sK + (it % STAGES) * PL::STAGE_BYTES;
  };
  auto is_edge = [&](int k0) {
    return (causal && k0 + BN - 1 > row_lo) ||
           (window > 0 && k0 <= row_hi - window) || k0 + BN > S;
  };
  // S = Q K^T, both K-major; a k16 step is 32 bytes into a 128-byte row
  auto scores = [&](float (&s)[32], int it) {
    const uint32_t kt = k_tile(it);
#pragma unroll
    for (int kk = 0; kk < (HDN + 15) / 16; ++kk)
      wgmma_ss_n64(s, desc(q_tile + (kk / 4) * BM * 128 + (kk % 4) * 32, 16,
                           1024),
                   desc(kt + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024),
                   kk > 0);
  };

  float o[HDN / 2];
#pragma unroll
  for (int i = 0; i < HDN / 2; ++i) o[i] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  mbar_wait(bar_q, 0);
  for (int it = 0; it < it_begin; ++it) {
    full(it);
    release(it);
  }
  if (it_begin < it_end) {
    float s[32];
    uint32_t ph[4][4], pl[4][4];
    full(it_begin);
    wg_fence();
    scores(s, it_begin);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    softmax_tile(s, lo + it_begin * BN, r0, r1, u, S, causal, window,
                 is_edge(lo + it_begin * BN), scale_log2, m0, m1, l0, l1);
    pack_p(s, ph, pl);
    // V is [key][hd], MN-major: 16 keys are 2 x 1024 bytes, the 64-column
    // blocks of hd are BN x 128 bytes apart
    auto pv = [&](int it) {
      const uint32_t vt = k_tile(it) + PL::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = desc(vt + kk * 2048, BN * 128, 1024);
        wgmma_pv<HDN>(o, ph[kk], dv);
        wgmma_pv<HDN>(o, pl[kk], dv);
      }
      wg_commit();
    };
    // each step: S of the next tile and O += P V of this one in flight
    // together; the next softmax runs while P V does, and O takes its
    // factor once P V is done. P stays in registers until then.
    for (int it = it_begin; it + 1 < it_end; ++it) {
      full(it + 1);
      wg_fence();
      scores(s, it + 1);
      wg_commit();
      pv(it);
      wg_wait<1>();
      fence_regs(s);
      const int k0 = lo + (it + 1) * BN;
      const float2 alpha = softmax_tile(s, k0, r0, r1, u, S, causal, window,
                                        is_edge(k0), scale_log2, m0, m1, l0,
                                        l1);
      wg_wait<0>();
      fence_regs(o);
      release(it);
#pragma unroll
      for (int i = 0; i < HDN / 2; ++i) o[i] *= (i & 2) ? alpha.y : alpha.x;
      pack_p(s, ph, pl);
    }
    wg_fence();
    pv(it_end - 1);
    wg_wait<0>();
    fence_regs(o);
    release(it_end - 1);
  }
  for (int it = it_end; it < n_tiles; ++it) {
    full(it);
    release(it);
  }

  // O / l, bf16, into this warpgroup's own Q rows (swizzled as TMA lays
  // them out), then one TMA store a 64-column block; it writes only the
  // rows < S and the columns < hd
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int lr0 = 16 * wq + g;  // row within the warpgroup's 64
#pragma unroll
  for (int j = 0; j < HDN / 8; ++j) {
    unsigned char* blk = gbase + (j / 8) * BM * 128 + 64 * wg * 128;
    const int chunk = ((j % 8) ^ g) << 4;  // rows r and r + 8: same r % 8
    *reinterpret_cast<__nv_bfloat162*>(blk + lr0 * 128 + chunk + 4 * u) =
        __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(blk + (lr0 + 8) * 128 + chunk +
                                       4 * u) =
        __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if ((threadIdx.x & 127) == 0 && row_lo < S) {
    for (int c = 0; c < NH; ++c)
      tma_store(&tm_o, q_tile + c * BM * 128, 64 * c, h, row_lo, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

}  // namespace tc

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded: no
// -lcuda at link time
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 4-D map (hd, heads, S, B) of a contiguous (B, S, heads, hd) bf16
// tensor, boxes of 64 columns x `rows` positions of one head; columns past
// hd and rows past S read as 0 and are not written
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int hd, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDN>
int launch_tc_hd(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int KV, int hd, float scale, int causal,
                 int window, void* stream) {
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, B, S, H, hd, tc::BM) ||
      !make_map(&mk, k, B, S, KV, hd, tc::BN) ||
      !make_map(&mv, v, B, S, KV, hd, tc::BN) ||
      !make_map(&mo, o, B, S, H, hd, 64))
    return (int)cudaErrorInvalidValue;
  const int smem = tc::Plan<HDN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      tc::flash_fwd_tc<HDN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + tc::BM - 1) / tc::BM);
  tc::flash_fwd_tc<HDN><<<grid, tc::threads<HDN>(), smem,
                          (cudaStream_t)stream>>>(
      mq, mk, mv, mo, S, H, KV, scale * tc::LOG2E, causal, window);
  return (int)cudaGetLastError();
}

int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int hd, float scale, int causal,
              int window, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > MAX_HD ||
      hd % 8 != 0 || B > 65535 || (S + tc::BM - 1) / tc::BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  auto run = [&](auto hdn) {
    return launch_tc_hd<decltype(hdn)::value>(q, k, v, o, B, S, H, KV, hd,
                                               scale, causal, window, stream);
  };
  if (hd <= 64) return run(std::integral_constant<int, 64>());
  if (hd <= 112) return run(std::integral_constant<int, 112>());
  if (hd <= 120) return run(std::integral_constant<int, 120>());
  if (hd <= 128) return run(std::integral_constant<int, 128>());
  return run(std::integral_constant<int, 192>());
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, int hd, float scale,
                        int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                       stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KV, int hd, float scale,
                         int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, scale, causal,
                               window, stream);
}

int flash_attention_bf16_tc(const void* q, const void* k, const void* v,
                            void* o, int B, int S, int H, int KV, int hd,
                            float scale, int causal, int window,
                            void* stream) {
  return launch_tc(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                   stream);
}

// dynamic shared memory of a flash_fwd_tc block for head dim hd, in bytes
int flash_attention_tc_smem_bytes(int hd) {
  return hd <= 64    ? tc::Plan<64>::SMEM
         : hd <= 128 ? tc::Plan<128>::SMEM
                     : tc::Plan<192>::SMEM;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
