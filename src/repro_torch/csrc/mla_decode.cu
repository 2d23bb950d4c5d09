// Absorbed MLA decode attention (flash-decode) for Hopper, sm_90a.
//
// Replaces no Pallas TPU kernel: the JAX package's MLA decode
// (src/repro/models/attention.py::mla_decode) is plain jnp, and the port ran
// it as plain PyTorch (models/attention.py::_mla_absorbed), which upcast the
// whole latent capacity to float32 and scored every position of it in every
// layer on every step. Per slot b of the batch, with n = min(pos[b] + 1,
// cap) the positions cached and s = 1/sqrt(qk head dim):
//   score[h][t] = (q_abs[b,h] . ck[b,t] + q_rope[b,h] . cr[b,t]) s,  t < n
//   lat[b,h]    = sum_t softmax_t(score[h])[t] ck[b,t]
// q_abs (B,H,R) and q_rope (B,H,E) in the caches' type; ck (B,cap,R) and cr
// (B,cap,E) the latent and rope caches; pos (B,) int32, >= 0; lat (B,H,R)
// in the caches' type. Scores, the softmax and every sum are float32.
//
// What bounds it: bytes. Absorbed MLA's key and value are the same latent
// row: a position's R + E values (1,152 bytes in bf16 at R 512, E 64) serve
// both products, 2 H (2 R + E) operations: 30 FLOP a byte at H = 16, 60 at
// H = 32, far below the H100's 295. So the kernel reads each cached
// position once, in its stored type, and nothing past n:
//   * Split the positions. Slot b's n positions go to min(parts, ceil(n /
//     chunk)) parts, each a multiple of 32 positions, computed on the card
//     from pos: no host sync, no grid sized on the host from lengths. A part
//     that is its slot's only one writes lat; the others write their max,
//     sum and unnormalised latent sum in float32, and mla_decode_combine (a
//     second, small launch in the same library call) merges them. The
//     wrapper's chunk (1,024 positions at H <= 16, 1,536 above) was the
//     fastest of 384-1,536 at both serving cells' shapes on an H100: the
//     partials cost at most 5-7% of the bytes their part read there.
//   * mla_decode_tc, bf16 at R, E = 512, 64 or 32, 16: the tensor cores
//     (mma.sync m16n8k16, bf16 in, float32 sums; wgmma's 64-row tiles would
//     be mostly padding at 16-32 heads, and a kernel bound by bytes does not
//     need its rate). Grid (head groups, B, parts): a block takes 16 or 32
//     heads (MT = 1 or 2 row tiles of 16; heads past H are zero rows) with
//     4 MT warps, and the head groups of one part (H > 32) run side by side,
//     so all but the first read its tiles from L2. q_abs and q_rope are
//     copied to shared memory once; 64-position tiles of [ck | cr] (73.7 KB
//     at R 512, E 64) stream through a ring of two stages of cp.async (16
//     bytes a thread, rows past the part zero-filled), one block an SM: of
//     2-4 stages of 32 or 64 positions this kept the most bytes in flight
//     (63-64% of the byte bound at dsv2-lite.decode's shape, 48-51% for 32
//     positions). Warp (mt, cq) computes the scores of row tile mt at
//     positions 16 cq..16 cq + 15 over all R + E columns, and the latent sum
//     of row tile mt in columns cq R/4..(cq + 1) R/4 over the tile. The
//     softmax is online, in float32: 8 threads a head row take the tile's
//     max and sum. Rows are padded by 16 bytes (odd multiples of 16:
//     ldmatrix's 8 rows hit 8 distinct bank groups).
//   * Rounding. The plain version rounds the normalised probabilities to
//     bf16 before the product with the latent (probs.to(ck.dtype)). An
//     online softmax cannot normalise before it has seen every position, so
//     here the unnormalised exp(score - running max) is rounded to bf16
//     before the product, and the float32 sum of the unrounded values
//     divides at the end: the same bf16 rounding of each probability,
//     relative to another scale.
//   * mla_decode_cc, float32 (and bf16 at other widths): the CUDA cores.
//     Grid (B, parts, head groups of 16); 16-position tiles in shared
//     memory as float32, thread (r, j) scores head row r at position j and
//     the 16 threads of a row share its max and sum by shuffles; the
//     probabilities are rounded to the caches' type (a no-op in float32).
//     At dsv2-lite.decode's shape in float32 it takes about the plain
//     version's time (~2.9 ms on an H100): it exists so that float32 models
//     decode on the card, not for speed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BN = 32;  // a part's positions are a multiple of this
constexpr int COMBINE_THREADS = 128;
constexpr int MAX_PARTS = 32;  // a slot's parts: one warp weighs them

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Part p of slot b: positions [t0, t1); parts is the slot's part count.
struct Span {
  int parts, t0, t1;
};

__device__ __forceinline__ Span span(const int* pos, int b, int p, int cap,
                                     int max_parts, int chunk) {
  const int n = max(min(pos[b], cap - 1) + 1, 0);
  Span s;
  s.parts = min(max_parts, max(1, ceil_div(n, chunk)));
  const int per = ceil_div(ceil_div(n, s.parts), BN) * BN;
  s.t0 = min(p * per, n);
  s.t1 = min(s.t0 + per, n);
  return s;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Slot b, head h: lat = sum_p w_p o_p / sum_p w_p l_p with w_p = exp(m_p -
// max m), over the slot's parts that saw a position (m_p > -inf; the
// others wrote no o_p). One warp takes the weights; every thread then four
// latent columns a step. Grid (H, B).
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
    mla_decode_combine(const int* __restrict__ pos,
                       const float* __restrict__ m_part,
                       const float* __restrict__ l_part,
                       const float* __restrict__ o_part, T* __restrict__ out,
                       int H, int R, int cap, int max_parts, int chunk) {
  __shared__ float w_s[MAX_PARTS];
  __shared__ float inv_s;
  const int h = blockIdx.x, b = blockIdx.y;
  const int parts = span(pos, b, 0, cap, max_parts, chunk).parts;
  if (parts <= 1) return;  // the slot's one part wrote lat itself
  const size_t row = (size_t)b * H + h;
  if (threadIdx.x < 32) {
    const int p = threadIdx.x;
    const float m = p < parts ? m_part[row * max_parts + p] : -INFINITY;
    const float l = p < parts ? l_part[row * max_parts + p] : 0.f;
    float mx = m;
    for (int x = 16; x > 0; x >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
    const float w = m > -INFINITY ? expf(m - mx) : 0.f;
    float sum = w * l;
    for (int x = 16; x > 0; x >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, x);
    if (p < parts) w_s[p] = w;
    if (p == 0) inv_s = sum > 0.f ? 1.f / sum : 0.f;
  }
  __syncthreads();
  const float* o = o_part + row * max_parts * R;
  const float inv = inv_s;
  for (int c = threadIdx.x * 4; c < R; c += COMBINE_THREADS * 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < parts; ++p) {
      const float w = w_s[p];
      if (w == 0.f) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < R) acc[k] += w * o[(size_t)p * R + c + k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < R) out[row * R + c + k] = from_f<T>(acc[k] * inv);
  }
}

// ---------------------------------------------------------------------------
// mla_decode_cc: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int CC_THREADS = 256;
constexpr int CC_ROWS = 16;  // heads a block
constexpr int CC_BN = 16;    // positions a tile

// shared (float32): q [CC_ROWS][D + 1], kv [CC_BN][D + 1], p [CC_ROWS][CC_BN],
// alpha and l [CC_ROWS], o [CC_ROWS][R]
inline size_t cc_smem(int R, int E) {
  return sizeof(float) * ((size_t)(CC_ROWS + CC_BN) * (R + E + 1) +
                          CC_ROWS * CC_BN + 2 * CC_ROWS +
                          (size_t)CC_ROWS * R);
}

// grid (B, max_parts, head groups of CC_ROWS). Thread (r, j) = (tid / 16,
// tid % 16) scores head row r at the tile's position j; the 16 threads of
// a row share its running max and sum by shuffles. Rows are D + 1 floats
// apart, so the 16 rows a warp reads fall in distinct banks.
template <typename T>
__global__ void __launch_bounds__(CC_THREADS)
    mla_decode_cc(const T* __restrict__ q_abs, const T* __restrict__ q_rope,
                  const T* __restrict__ ck, const T* __restrict__ cr,
                  const int* __restrict__ pos, T* __restrict__ out,
                  float* __restrict__ m_part, float* __restrict__ l_part,
                  float* __restrict__ o_part, int H, int R, int E, int cap,
                  int max_parts, int chunk, float scale) {
  extern __shared__ float smem_cc[];
  const int D = R + E, D1 = D + 1;
  const int b = blockIdx.x, p = blockIdx.y, h0 = blockIdx.z * CC_ROWS;
  const Span sp = span(pos, b, p, cap, max_parts, chunk);
  if (p >= sp.parts) return;
  float* qs = smem_cc;                      // [CC_ROWS][D1]
  float* kv = qs + (size_t)CC_ROWS * D1;    // [CC_BN][D1]
  float* ps = kv + (size_t)CC_BN * D1;      // [CC_ROWS][CC_BN]
  float* as = ps + CC_ROWS * CC_BN;         // [CC_ROWS]
  float* ls = as + CC_ROWS;                 // [CC_ROWS]
  float* os = ls + CC_ROWS;                 // [CC_ROWS][R]
  const int tid = threadIdx.x, r = tid / CC_BN, j = tid % CC_BN;
  for (int i = tid; i < CC_ROWS * D; i += CC_THREADS) {
    const int rr = i / D, c = i % D, h = h0 + rr;
    const size_t at = (size_t)b * H + h;
    qs[rr * D1 + c] = h >= H ? 0.f
                      : c < R ? to_f(q_abs[at * R + c])
                              : to_f(q_rope[at * E + c - R]);
  }
  for (int i = tid; i < CC_ROWS * R; i += CC_THREADS) os[i] = 0.f;
  float m = -INFINITY, l = 0.f;  // row r's, the same in its 16 threads
  for (int ts = sp.t0; ts < sp.t1; ts += CC_BN) {
    const int nt = min(CC_BN, sp.t1 - ts);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < nt * D; i += CC_THREADS) {
      const int jj = i / D, c = i % D;
      const size_t t = (size_t)b * cap + ts + jj;
      kv[jj * D1 + c] = c < R ? to_f(ck[t * R + c]) : to_f(cr[t * E + c - R]);
    }
    __syncthreads();
    float s = -INFINITY;
    if (j < nt) {
      float acc = 0.f;
      for (int c = 0; c < D; ++c) acc += qs[r * D1 + c] * kv[j * D1 + c];
      s = acc * scale;
    }
    float mx = s;
#pragma unroll
    for (int x = 1; x < CC_BN; x <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
    mx = fmaxf(mx, m);  // finite: a tile's first position is in range
    const float e = expf(s - mx);
    float sum = e;
#pragma unroll
    for (int x = 1; x < CC_BN; x <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, x);
    const float alpha = expf(m - mx);
    l = l * alpha + sum;
    m = mx;
    ps[r * CC_BN + j] = to_f(from_f<T>(e));  // rounded to the caches' type
    if (j == 0) as[r] = alpha;
    __syncthreads();
    for (int i = tid; i < CC_ROWS * R; i += CC_THREADS) {
      const int rr = i / R, c = i % R;
      float acc = os[i] * as[rr];
      for (int jj = 0; jj < nt; ++jj)
        acc += ps[rr * CC_BN + jj] * kv[jj * D1 + c];
      os[i] = acc;
    }
  }
  if (j == 0) ls[r] = l;
  __syncthreads();
  if (sp.parts == 1) {
    for (int i = tid; i < CC_ROWS * R; i += CC_THREADS) {
      const int rr = i / R, c = i % R, h = h0 + rr;
      const float lr = ls[rr];
      if (h < H)
        out[((size_t)b * H + h) * R + c] =
            from_f<T>(lr > 0.f ? os[i] / lr : 0.f);
    }
    return;
  }
  if (j == 0 && h0 + r < H) {
    const size_t at = ((size_t)b * H + h0 + r) * max_parts + p;
    m_part[at] = m;
    l_part[at] = l;
  }
  for (int i = tid; i < CC_ROWS * R; i += CC_THREADS) {
    const int rr = i / R, c = i % R, h = h0 + rr;
    if (h < H) o_part[(((size_t)b * H + h) * max_parts + p) * R + c] = os[i];
  }
}

// ---------------------------------------------------------------------------
// mla_decode_tc: the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a b, m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

typedef __nv_bfloat16 bf16;

template <int R, int E, int MT>
struct Cfg {
  static constexpr int D = R + E;
  static constexpr int DS = D + 8;  // row stride: an odd number of 16 bytes
  static constexpr int ROWS = 16 * MT;
  static constexpr int THREADS = 128 * MT;
  static constexpr int TN = 64;     // positions a tile
  static constexpr int STAGES = 2;  // tiles in the ring
  static constexpr int NQ = TN / 32;  // n8 tiles of a warp's scores
  static constexpr int PT = TN / 8;   // positions a softmax thread
  static constexpr int PS = TN + 8;   // probability row stride
  static constexpr int SS = TN + 4;   // score row stride (float)
  static constexpr int NT = R / 32;   // n8 tiles of a warp's latent columns
  static_assert(R % 32 == 0 && E % 8 == 0 && D % 16 == 0, "widths");
  static_assert(TN % 32 == 0, "tiles");
  static_assert((DS * 2 / 16) % 2 == 1 && (PS * 2 / 16) % 2 == 1, "pads");
  // shared memory, bytes
  static constexpr size_t KV = (size_t)STAGES * TN * DS * 2;
  static constexpr size_t Q = (size_t)ROWS * DS * 2;
  static constexpr size_t S = (size_t)ROWS * SS * 4;
  static constexpr size_t P = (size_t)ROWS * PS * 2;
  static constexpr size_t STATS = (size_t)ROWS * 3 * 4;
  static constexpr size_t SMEM = KV + Q + S + P + STATS;
};

// grid (head groups of 16 MT, B, max_parts): the head groups of a part
// run side by side, so all but the first read its tiles from L2
template <int R, int E, int MT>
__global__ void __launch_bounds__(Cfg<R, E, MT>::THREADS)
    mla_decode_tc(const bf16* __restrict__ q_abs,
                  const bf16* __restrict__ q_rope,
                  const bf16* __restrict__ ck, const bf16* __restrict__ cr,
                  const int* __restrict__ pos, bf16* __restrict__ out,
                  float* __restrict__ m_part, float* __restrict__ l_part,
                  float* __restrict__ o_part, int H, int cap, int max_parts,
                  int chunk, float scale) {
  using C = Cfg<R, E, MT>;
  constexpr int D = C::D, DS = C::DS, STAGES = C::STAGES, TN = C::TN;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  unsigned char* sm = smem_tc;
  bf16* kv = reinterpret_cast<bf16*>(sm);                 // [STAGES][TN][DS]
  bf16* qs = reinterpret_cast<bf16*>(sm + C::KV);         // [ROWS][DS]
  float* ss = reinterpret_cast<float*>(sm + C::KV + C::Q);    // [ROWS][SS]
  bf16* ps = reinterpret_cast<bf16*>(sm + C::KV + C::Q + C::S);  // [ROWS][PS]
  float* m_s = reinterpret_cast<float*>(sm + C::KV + C::Q + C::S + C::P);
  float* l_s = m_s + C::ROWS;
  float* a_s = l_s + C::ROWS;

  const int h0 = blockIdx.x * C::ROWS, b = blockIdx.y, p = blockIdx.z;
  const Span sp = span(pos, b, p, cap, max_parts, chunk);
  if (p >= sp.parts) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int mt = warp / 4, cq = warp % 4;
  const int ntiles = ceil_div(sp.t1 - sp.t0, TN);

  if (ntiles > 0) {
    // q rows: [q_abs | q_rope] of heads h0.., zero past H
    for (int i = tid; i < C::ROWS * (D / 8); i += C::THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8, h = h0 + r;
      const bool ok = h < H;
      const size_t at = (size_t)b * H + (ok ? h : 0);
      const bf16* src = c < R ? q_abs + at * R + c : q_rope + at * E + c - R;
      cp_async16(qs + r * DS + c, src, ok);
    }
  }
  auto load = [&](int i) {
    bf16* dst = kv + (size_t)(i % STAGES) * TN * DS;
    const int ts = sp.t0 + i * TN;
    for (int k = tid; k < TN * (D / 8); k += C::THREADS) {
      const int j = k / (D / 8), c = (k % (D / 8)) * 8;
      const bool ok = ts + j < sp.t1;
      const size_t t = (size_t)b * cap + (ok ? ts + j : 0);
      const bf16* src = c < R ? ck + t * R + c : cr + t * E + c - R;
      cp_async16(dst + j * DS + c, src, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load(i);
    cp_commit();
  }
  if (tid < C::ROWS) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float o[C::NT][4];
#pragma unroll
  for (int n = 0; n < C::NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int r0 = mt * 16 + lane / 4;  // this thread's accumulator rows
  const int col0 = cq * (R / 4);      // this warp's latent columns

  for (int i = 0; i < ntiles; ++i) {
    if (i + STAGES - 1 < ntiles) load(i + STAGES - 1);
    cp_commit();
    cp_wait<STAGES - 1>();
    __syncthreads();
    const bf16* tile = kv + (size_t)(i % STAGES) * TN * DS;
    const int ts = sp.t0 + i * TN;

    // scores of row tile mt at positions cq TN/4 .. (cq + 1) TN/4
    {
      float acc[C::NQ][4];
#pragma unroll
      for (int q = 0; q < C::NQ; ++q)
        acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
      const bf16* qa = qs + (mt * 16 + lane % 16) * DS + (lane / 16) * 8;
      const bf16* kb =
          tile + (cq * (TN / 4) + lane % 8) * DS + ((lane / 8) % 2) * 8;
#pragma unroll 12
      for (int k = 0; k < D / 16; ++k) {
        uint32_t a[4];
        ldsm_x4(a, qa + k * 16);
#pragma unroll
        for (int q = 0; q < C::NQ; ++q) {
          uint32_t bb[2];
          ldsm_x2(bb, kb + q * 8 * DS + k * 16);
          mma(acc[q], a, bb[0], bb[1]);
        }
      }
#pragma unroll
      for (int q = 0; q < C::NQ; ++q) {
        const int j = cq * (TN / 4) + q * 8 + 2 * (lane % 4);
        float* s0 = ss + r0 * C::SS + j;
        float* s1 = s0 + 8 * C::SS;
        const bool v0 = ts + j < sp.t1, v1 = ts + j + 1 < sp.t1;
        s0[0] = v0 ? acc[q][0] * scale : -INFINITY;
        s0[1] = v1 ? acc[q][1] * scale : -INFINITY;
        s1[0] = v0 ? acc[q][2] * scale : -INFINITY;
        s1[1] = v1 ? acc[q][3] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: 8 threads a row, TN / 8 positions each
    {
      const int r = tid / 8, j = (tid % 8) * C::PT;
      const float* s = ss + r * C::SS + j;
      float v[C::PT];
      float mx = -INFINITY;
#pragma unroll
      for (int q = 0; q < C::PT; ++q) {
        v[q] = s[q];
        mx = fmaxf(mx, v[q]);
      }
#pragma unroll
      for (int x = 1; x < 8; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_old = m_s[r];
      mx = fmaxf(mx, m_old);  // finite: a tile's first position is in range
      float sum = 0.f;
      bf16* pr = ps + r * C::PS + j;
#pragma unroll
      for (int q = 0; q < C::PT; ++q) {
        const float e = expf(v[q] - mx);
        sum += e;
        pr[q] = __float2bfloat16(e);
      }
#pragma unroll
      for (int x = 1; x < 8; x <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, x);
      if (tid % 8 == 0) {
        const float alpha = expf(m_old - mx);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();

    // latent sums of row tile mt in columns col0..col0 + R/4
    {
      const float al0 = a_s[r0], al1 = a_s[r0 + 8];
#pragma unroll
      for (int n = 0; n < C::NT; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, ps + (mt * 16 + lane % 16) * C::PS + kk * 16 +
                       (lane / 16) * 8);
        const bf16* vb = tile + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                    DS + col0;
#pragma unroll
        for (int n = 0; n + 1 < C::NT; n += 2) {
          uint32_t bb[4];
          ldsm_x4_t(bb, vb + n * 8 + (lane / 16) * 8);
          mma(o[n], a, bb[0], bb[1]);
          mma(o[n + 1], a, bb[2], bb[3]);
        }
        if (C::NT % 2) {
          uint32_t bb[2];
          ldsm_x2_t(bb, vb + (C::NT - 1) * 8);
          mma(o[C::NT - 1], a, bb[0], bb[1]);
        }
      }
    }
    __syncthreads();  // the stage, scores and probabilities are free again
  }
  cp_wait<0>();
  __syncthreads();  // the row sums, also where the part saw no position

  const int hr0 = h0 + r0, hr1 = hr0 + 8;
  const int cc = col0 + 2 * (lane % 4);
  if (sp.parts == 1) {
    const float l0 = l_s[r0], l1 = l_s[r0 + 8];
    const float i0 = l0 > 0.f ? 1.f / l0 : 0.f, i1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      if (hr0 < H)
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * H + hr0) * R +
                                           cc + n * 8) =
            __floats2bfloat162_rn(o[n][0] * i0, o[n][1] * i0);
      if (hr1 < H)
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * H + hr1) * R +
                                           cc + n * 8) =
            __floats2bfloat162_rn(o[n][2] * i1, o[n][3] * i1);
    }
    return;
  }
  if (tid < C::ROWS && h0 + tid < H) {
    const size_t at = ((size_t)b * H + h0 + tid) * max_parts + p;
    m_part[at] = m_s[tid];
    l_part[at] = l_s[tid];
  }
  if (ntiles == 0) return;  // m -inf: the combine skips this part
#pragma unroll
  for (int n = 0; n < C::NT; ++n) {
    if (hr0 < H)
      *reinterpret_cast<float2*>(
          o_part + (((size_t)b * H + hr0) * max_parts + p) * R + cc + n * 8) =
          make_float2(o[n][0], o[n][1]);
    if (hr1 < H)
      *reinterpret_cast<float2*>(
          o_part + (((size_t)b * H + hr1) * max_parts + p) * R + cc + n * 8) =
          make_float2(o[n][2], o[n][3]);
  }
}

template <int R, int E, int MT>
int launch(const void* q_abs, const void* q_rope, const void* ck,
           const void* cr, const void* pos, void* out, void* m_part,
           void* l_part, void* o_part, int B, int H, int cap, int max_parts,
           int chunk, float scale, cudaStream_t stream) {
  using C = Cfg<R, E, MT>;
  const int smem = (int)C::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_tc<R, E, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  mla_decode_tc<R, E, MT>
      <<<dim3(ceil_div(H, C::ROWS), B, max_parts), C::THREADS, smem, stream>>>(
          (const bf16*)q_abs, (const bf16*)q_rope, (const bf16*)ck,
          (const bf16*)cr, (const int*)pos, (bf16*)out, (float*)m_part,
          (float*)l_part, (float*)o_part, H, cap, max_parts, chunk, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

bool valid(int B, int H, int R, int E, int cap, int max_parts, int chunk) {
  return B > 0 && B <= 65535 && H > 0 && H <= 65535 && R > 0 && E >= 0 &&
         cap > 0 && max_parts > 0 && max_parts <= MAX_PARTS && chunk > 0;
}

template <typename T>
int combine(const void* pos, const void* m_part, const void* l_part,
            const void* o_part, void* out, int B, int H, int R, int cap,
            int max_parts, int chunk, cudaStream_t stream) {
  if (max_parts <= 1) return (int)cudaSuccess;
  mla_decode_combine<T><<<dim3(H, B), COMBINE_THREADS, 0, stream>>>(
      (const int*)pos, (const float*)m_part, (const float*)l_part,
      (const float*)o_part, (T*)out, H, R, cap, max_parts, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cc(const void* q_abs, const void* q_rope, const void* ck,
              const void* cr, const void* pos, void* out, void* m_part,
              void* l_part, void* o_part, int B, int H, int R, int E, int cap,
              int max_parts, int chunk, float scale, void* stream) {
  if (!valid(B, H, R, E, cap, max_parts, chunk))
    return (int)cudaErrorInvalidValue;
  const size_t smem = cc_smem(R, E);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_cc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  mla_decode_cc<T><<<dim3(B, max_parts, ceil_div(H, CC_ROWS)), CC_THREADS,
                     smem, s>>>(
      (const T*)q_abs, (const T*)q_rope, (const T*)ck, (const T*)cr,
      (const int*)pos, (T*)out, (float*)m_part, (float*)l_part,
      (float*)o_part, H, R, E, cap, max_parts, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return combine<T>(pos, m_part, l_part, o_part, out, B, H, R, cap,
                    max_parts, chunk, s);
}

}  // namespace

extern "C" {

int mla_decode_f32(const void* q_abs, const void* q_rope, const void* ck,
                   const void* cr, const void* pos, void* out, void* m_part,
                   void* l_part, void* o_part, int B, int H, int R, int E,
                   int cap, int max_parts, int chunk, float scale,
                   void* stream) {
  return launch_cc<float>(q_abs, q_rope, ck, cr, pos, out, m_part, l_part,
                          o_part, B, H, R, E, cap, max_parts, chunk, scale,
                          stream);
}

int mla_decode_bf16(const void* q_abs, const void* q_rope, const void* ck,
                    const void* cr, const void* pos, void* out, void* m_part,
                    void* l_part, void* o_part, int B, int H, int R, int E,
                    int cap, int max_parts, int chunk, float scale,
                    void* stream) {
  return launch_cc<__nv_bfloat16>(q_abs, q_rope, ck, cr, pos, out, m_part,
                                  l_part, o_part, B, H, R, E, cap, max_parts,
                                  chunk, scale, stream);
}

// bf16 at (R, E) = (512, 64) or (32, 16), every pointer on a 16-byte
// boundary: mla_decode_tc, then the combine
int mla_decode_bf16_tc(const void* q_abs, const void* q_rope, const void* ck,
                       const void* cr, const void* pos, void* out,
                       void* m_part, void* l_part, void* o_part, int B, int H,
                       int R, int E, int cap, int max_parts, int chunk,
                       float scale, void* stream) {
  if (!valid(B, H, R, E, cap, max_parts, chunk))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q_abs | (uintptr_t)q_rope | (uintptr_t)ck |
       (uintptr_t)cr) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const int mt = H <= 16 ? 1 : 2;
  int err;
  if (R == 512 && E == 64)
    err = mt == 1 ? tc::launch<512, 64, 1>(q_abs, q_rope, ck, cr, pos, out,
                                           m_part, l_part, o_part, B, H, cap,
                                           max_parts, chunk, scale, s)
                  : tc::launch<512, 64, 2>(q_abs, q_rope, ck, cr, pos, out,
                                           m_part, l_part, o_part, B, H, cap,
                                           max_parts, chunk, scale, s);
  else if (R == 32 && E == 16)
    err = mt == 1 ? tc::launch<32, 16, 1>(q_abs, q_rope, ck, cr, pos, out,
                                          m_part, l_part, o_part, B, H, cap,
                                          max_parts, chunk, scale, s)
                  : tc::launch<32, 16, 2>(q_abs, q_rope, ck, cr, pos, out,
                                          m_part, l_part, o_part, B, H, cap,
                                          max_parts, chunk, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != (int)cudaSuccess) return err;
  return combine<__nv_bfloat16>(pos, m_part, l_part, o_part, out, B, H, R,
                                cap, max_parts, chunk, s);
}

const char* mla_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
