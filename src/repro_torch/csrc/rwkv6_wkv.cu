// Chunked RWKV6 WKV recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv.py::rwkv6_wkv
// (_kernel :22-67); its oracle is src/repro/kernels/rwkv6_wkv_ref.py::
// reference, the step-by-step recurrence of every head of every batch row
//   o_t[n]    = sum_i r_t[i] (S[i][n] + u[i] k_t[i] v_t[n])
//   S[i][n]   = w_t[i] S[i][n] + k_t[i] v_t[n]
// from a zero state. Per chunk of Q steps, with lw = log(max(w, 1e-20)),
// lcum its inclusive cumsum over the chunk and lprev[q] = lcum[q-1] (0 at
// q = 0; the TPU kernel computes lcum - lw, which rounds once more), the
// kernel computes, all in fp32:
//   scores    sc[q][j] = sum_i r[q][i] k[j][i] exp(lprev[q][i] - lcum[j][i])
//                        for j < q, and sc[q][q] = sum_i r[q][i] u[i] k[q][i]
//   output    o[q][n]  = sum_{j<=q} sc[q][j] v[j][n]
//                        + sum_i r[q][i] exp(lprev[q][i]) S[i][n]
//   state     S[i][n]  = exp(lcum[Q-1][i]) S[i][n]
//                        + sum_q k[q][i] exp(lcum[Q-1][i] - lcum[q][i]) v[q][n]
// r, k, v (B,L,H,N) in float32 or bfloat16, w (B,L,H,N) and u (H,N) float32;
// out (B,L,H,N) in r's type, s_final (B,H,N,N) float32. N <= 64, Q <= 64;
// L is any length (the last chunk may be short).
//
// What bounds it: bytes. At the rwkv6-3b prefill shape, r/k/v (1, 2048,
// 40, 64) bf16 and w float32, the function must read 52.4 MB and write
// 11.1 MB (out and s_final): 63.6 MB, 0.019 ms at 3.35 TB/s. Its work is
// about 24 thousand operations a token and head at Q = 32: the two (N,N)
// contractions (the carried term and the state update, 4 N^2) and sc v are
// tensor-core work (1.5 G, 0.0015 ms at 989 TFLOP/s with the fp32 operands
// as bf16 pairs, as K2 and K3 take theirs); the scores, their exps, the
// decays and the bonus are fp32 work (0.48 G, 0.0072 ms at 67 TFLOP/s).
// chip_smoke.py (wkv_ops) counts both.
//
// Two kernels; the wrapper (kernels/rwkv6_wkv.py) picks one by a stated rule
// (bf16 with N a multiple of 16 -> wkv6_tc, the rest -> wkv6), and neither
// falls back to the other. Both keep every exponent <= 0: splitting
// exp(lprev - lcum) into exp(lprev) exp(-lcum) would overflow fp32 within a
// few steps of strong decay (w = 1e-20 gives lw = -46 a step). A short last
// chunk is padded (k = v = r = 0, w = 1: nothing is added to the state and
// the decay is unchanged), so L needs no divisor; the TPU wrapper shrank its
// chunk to a divisor of L (:73-75), which is 1 for a prime L.
//
// wkv6 (the first design), float32 and other N: the fp32 CUDA cores. The
// TPU kept the (N,N) state in VMEM scratch across the sequential chunk axis
// of its grid (:26-28, :54, :62); here one block per (batch row, head)
// loops over the chunks and keeps the state in registers (16 values a
// thread) with a copy in shared memory for the carried term. The TPU kernel
// built the (Q,Q,N) pairwise decay tensor, 256 KB at Q = 32 and N = 64; here
// each score sums its N channels in a loop, computing
// exp(lprev[q][i] - lcum[j][i]) as it goes. It took 1.70 ms at the path
// shape on an H100 80GB HBM3 (700 W): 40 blocks for 132 SMs, each walking
// 64 chunks in series with 6 barriers a chunk, half of each warp idle in the
// scores, every product on the fp32 cores.
//
// wkv6_tc, bf16 r/k/v: the tensor cores (mma.sync m16n8k16, fp32 sums).
// Only the state update S <- exp(lcum_last) S + U is serial along the
// sequence; every chunk's output can be computed at once from the state at
// its start. So the state pass puts those states in a scratch buffer and
// the output pass computes all chunks in parallel:
//   * wkv6_tc_decay, grid (chunks, H, B): per chunk the decay exp(lcum_last)
//     and k exp(lcum_last - lcum) as a bf16 pair hi + lo, split once here.
//   * wkv6_tc_walk, grid (N / 16, H, B): 16 state rows a block (rows are
//     independent), one 16-column slice a warp, the state fp32 in registers.
//     Per chunk: U = (k exp(...))^T v on the tensor cores, the state at the
//     chunk's start to scratch, one multiply-add an element. Its copies,
//     worked out once, run 3 chunks ahead (cp.async); nothing else is on the
//     serial path (computed in the walk itself, the decays and their exps
//     made each chunk several times slower: with ~5 warps an SM, a chunk
//     costs the latency of its instructions in series).
//   * wkv6_tc_out, grid (chunks, H, B), 8 warps: exact fp32 scores over 4 x 4
//     tiles of (q, j) on every lane (the pairs of a 4-key group take
//     2^(lprev - lcum[j3]) 2^(lcum[j3] - lcum[j]), both exponents <= 0),
//     then o = sc v + (r exp(lprev)) S on the tensor cores, sc, r exp(lprev)
//     and S as bf16 pairs hi + lo (hi hi + hi lo + lo hi), r, k, v as they
//     are. A float32 operand rounded once to bf16 misses the card bounds
//     (tests/torch_parity.py::wkv_tc_emulation pins this).
// The wrapper allocates the scratch (kernels/rwkv6_wkv.py::scratch_bytes):
// 63.6 MB at the path shape, 41.9 MB of it the states. Its traffic (the
// states written once and read once, the split k written and read) is
// what bounds this design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int NMAX = 64;
constexpr int QMAX = 64;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Layout {
  int sN, sQ;  // odd row strides of the N- and Q-wide tiles
  size_t rs, ks, vs, la, lc, sc, st, us, de, total;  // offsets in floats
};

__host__ __device__ inline Layout layout(int Q, int N) {
  Layout s;
  s.sN = N | 1;
  s.sQ = Q | 1;
  const size_t tile = (size_t)Q * s.sN;
  s.rs = 0;             // r, then r exp(lprev)
  s.ks = s.rs + tile;   // k, then k exp(lcum_last - lcum)
  s.vs = s.ks + tile;   // v
  s.la = s.vs + tile;   // lw
  s.lc = s.la + tile;   // lcum
  s.sc = s.lc + tile;   // [Q][sQ] scores
  s.st = s.sc + (size_t)Q * s.sQ;  // [N][N] state at the chunk start
  s.us = s.st + (size_t)N * N;     // u of this head
  s.de = s.us + N;                 // exp(lcum_last)
  s.total = s.de + N;
  return s;
}

// grid (H, B). QM is the largest chunk the instance takes (32 or 64).
template <typename T, int QM>
__global__ void __launch_bounds__(THREADS)
    wkv6(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, T* __restrict__ out,
         float* __restrict__ s_final, int L, int H, int N, int Q) {
  extern __shared__ float smem[];
  const Layout s = layout(Q, N);
  float* rs = smem + s.rs;
  float* ks = smem + s.ks;
  float* vs = smem + s.vs;
  float* la = smem + s.la;
  float* lc = smem + s.lc;
  float* sc = smem + s.sc;
  float* st = smem + s.st;
  float* us = smem + s.us;
  float* de = smem + s.de;

  const int h = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // output and state columns: n = t & 63; rows rg + 4m
  const int n = t & 63, rg = t >> 6;

  // the state of this thread: S[rg + 4m][n]
  float sr[NMAX / 4];
#pragma unroll
  for (int m = 0; m < NMAX / 4; ++m) sr[m] = 0.f;
  for (int i = t; i < N * N; i += THREADS) st[i] = 0.f;
  for (int i = t; i < N; i += THREADS) us[i] = u[(size_t)h * N + i];

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int Qc = min(Q, L - c0);
    __syncthreads();  // the previous chunk is done with every tile
    for (int idx = t; idx < Q * N; idx += THREADS) {
      const int q = idx / N, i = idx - q * N;
      const int o = q * s.sN + i;
      if (q < Qc) {
        const size_t g = (((size_t)b * L + c0 + q) * H + h) * N + i;
        rs[o] = load_f(r + g);
        ks[o] = load_f(k + g);
        vs[o] = load_f(v + g);
        la[o] = logf(fmaxf(w[g], 1e-20f));
      } else {  // padding: adds nothing, decays nothing
        rs[o] = ks[o] = vs[o] = la[o] = 0.f;
      }
    }
    __syncthreads();

    // inclusive cumsum of lw over the chunk: 4 lanes a channel, Q/4 rows
    // each, joined by shuffles within the 4 lanes. lprev[q] is read as
    // lcum[q-1] itself (0 at q = 0), not as lcum - lw.
    if (t < 4 * NMAX) {
      const int i = t >> 2, part = t & 3;
      const int per = (Q + 3) / 4;
      const int q0 = part * per, q1 = min(Q, q0 + per);
      float run = 0.f;
      if (i < N)
        for (int q = q0; q < q1; ++q) run += la[q * s.sN + i];
      float incl = run;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float other = __shfl_up_sync(0xffffffffu, incl, off, 4);
        if (part >= off) incl += other;
      }
      float c = __shfl_up_sync(0xffffffffu, incl, 1, 4);
      if (part == 0) c = 0.f;
      if (i < N)
        for (int q = q0; q < q1; ++q) {
          c += la[q * s.sN + i];
          lc[q * s.sN + i] = c;
        }
    }
    __syncthreads();

    // scores: warp w takes rows q = w + 8m, lane j (and j + 32) the keys
    for (int q = warp; q < Qc; q += THREADS / 32) {
      const float* rq = rs + q * s.sN;
      const float* pq = lc + max(q - 1, 0) * s.sN;  // lprev[q], used if q > 0
#pragma unroll
      for (int jj = 0; jj < QM / 32; ++jj) {
        const int j = lane + 32 * jj;
        if (j > q) continue;
        const float* kj = ks + j * s.sN;
        float acc = 0.f;
        if (j == q) {
          for (int i = 0; i < N; ++i) acc = fmaf(rq[i] * us[i], kj[i], acc);
        } else {
          const float* cj = lc + j * s.sN;
          for (int i = 0; i < N; ++i)
            acc = fmaf(rq[i] * kj[i], expf(pq[i] - cj[i]), acc);
        }
        sc[q * s.sQ + j] = acc;
      }
    }
    __syncthreads();

    // r exp(lprev) and k exp(lcum_last - lcum) in place; exp(lcum_last)
    for (int idx = t; idx < Q * N; idx += THREADS) {
      const int q = idx / N, i = idx - q * N;
      const int o = q * s.sN + i;
      const float last = lc[(Q - 1) * s.sN + i];
      if (q > 0) rs[o] *= expf(lc[o - s.sN]);
      ks[o] *= expf(last - lc[o]);
      if (q == 0) de[i] = expf(last);
    }
    __syncthreads();

    // output: this thread computes o[rg + 4m][n]
    if (n < N) {
      float acc[QM / 4];
#pragma unroll
      for (int m = 0; m < QM / 4; ++m) acc[m] = 0.f;
      for (int j = 0; j < Qc; ++j) {
        const float vj = vs[j * s.sN + n];
#pragma unroll
        for (int m = 0; m < QM / 4; ++m) {
          const int q = rg + 4 * m;
          if (q < Qc && j <= q) acc[m] = fmaf(sc[q * s.sQ + j], vj, acc[m]);
        }
      }
      for (int i = 0; i < N; ++i) {
        const float si = st[i * N + n];
#pragma unroll
        for (int m = 0; m < QM / 4; ++m) {
          const int q = rg + 4 * m;
          if (q < Qc) acc[m] = fmaf(rs[q * s.sN + i], si, acc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < QM / 4; ++m) {
        const int q = rg + 4 * m;
        if (q < Qc)
          store_f(out + (((size_t)b * L + c0 + q) * H + h) * N + n, acc[m]);
      }
    }
    __syncthreads();  // every read of st for this chunk is done

    // state: S[i][n] = exp(lcum_last[i]) S[i][n] + sum_q kdec[q][i] v[q][n]
    if (n < N) {
      float upd[NMAX / 4];
#pragma unroll
      for (int m = 0; m < NMAX / 4; ++m) upd[m] = 0.f;
      for (int q = 0; q < Qc; ++q) {
        const float vq = vs[q * s.sN + n];
#pragma unroll
        for (int m = 0; m < NMAX / 4; ++m) {
          const int i = rg + 4 * m;
          if (i < N) upd[m] = fmaf(ks[q * s.sN + i], vq, upd[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < NMAX / 4; ++m) {
        const int i = rg + 4 * m;
        if (i < N) {
          sr[m] = fmaf(sr[m], de[i], upd[m]);
          st[i * N + n] = sr[m];
        }
      }
    }
  }

  if (n < N) {
    float* dst = s_final + ((size_t)b * H + h) * N * N;
#pragma unroll
    for (int m = 0; m < NMAX / 4; ++m) {
      const int i = rg + 4 * m;
      if (i < N) dst[(size_t)i * N + n] = sr[m];
    }
  }
}

template <typename T, int QM>
int launch_q(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* out, void* s_final, int B, int L, int H,
             int N, int Q, void* stream) {
  const size_t smem = layout(Q, N).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6<T, QM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6<T, QM><<<dim3(H, B), THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (T*)out, (float*)s_final, L, H, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, void* s_final, int B, int L, int H,
           int N, int chunk, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || N <= 0 || N > NMAX || chunk <= 0 ||
      chunk > QMAX || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int Q = min(chunk, L);
  if (Q <= 32)
    return launch_q<T, 32>(r, k, v, w, u, out, s_final, B, L, H, N, Q,
                           stream);
  return launch_q<T, 64>(r, k, v, w, u, out, s_final, B, L, H, N, Q, stream);
}

// ---------------------------------------------------------------------------
// wkv6_tc, the bf16 kernel on the tensor cores (see the note above), as three
// launches on one stream: wkv6_tc_decay and wkv6_tc_walk (the state pass),
// then wkv6_tc_out (the output pass). QP is the chunk rounded up to 16, 32
// or 64; rows past the chunk are padding.
namespace tc {

constexpr int THREADS = 128;      // 4 warps
constexpr int OUT_THREADS = 256;  // 8 warps in the output pass
constexpr int NM = 64;        // state width in shared memory
constexpr int KS = NM + 8;    // bf16 row strides: 16-byte multiples whose 8
constexpr int VS = 16 + 8;    // rows of an ldmatrix hit 8 distinct bank quads

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared (a shared-space address), zero-filled when
// !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
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

// d += a b, m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as a bf16 pair hi + lo: hi = bf16(x), lo = bf16(x - hi), which
// carries 16 of float32's 24 bits where hi alone carries 8
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ void split1(float x, __nv_bfloat16* hi,
                                       __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16(x);
  *hi = h;
  *lo = __float2bfloat16(x - __bfloat162float(h));
}

// 2^x on the special-function unit, as exp2f takes it, with results below
// 2^-126 flushed to 0: they vanish in any fp32 sum of terms of order 1
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Fragments (g = lane / 4, u = lane % 4): an A tile m16k16 holds rows g and
// g + 8, columns 2u, 2u + 1 and 2u + 8, 2u + 9; a B tile k16n8 holds column
// g, rows 2u, 2u + 1 (b0) and 2u + 8, 2u + 9 (b1); a C tile m16n8 holds rows
// g (d0, d1) and g + 8 (d2, d3), columns 2u, 2u + 1. ldmatrix x4 addresses:
// lane l gives row l & 7 of matrix l >> 3.

// The log-decays of one chunk for one channel, in base 2: P consecutive
// lanes a channel, lane `part` taking R consecutive rows (part R .. part R
// + R - 1), joined by a scan over the P lanes. The caller passes w = 1 for
// rows at or past the chunk's end: padding adds no decay.
template <int R>
struct Decays {
  float lc[R];   // inclusive running sum of this thread's rows
  float before;  // the sum of the rows before them
  float last;    // the chunk's total
};

template <int R, int P>
__device__ __forceinline__ void decays(const float (&wr)[R], int part,
                                       Decays<R>& d) {
  float run = 0.f;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    run += log2f(fmaxf(wr[m], 1e-20f));
    d.lc[m] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < P; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off, P);
    if (part >= off) incl += o;
  }
  const float ex = __shfl_up_sync(0xffffffffu, incl, 1, P);
  d.before = part ? ex : 0.f;
  d.last = __shfl_sync(0xffffffffu, incl, P - 1, P);
}

// The state pass, in two kernels. Only S <- exp(lcum_last) S + U is serial
// along the sequence; the decays and k exp(lcum_last - lcum) of every chunk
// are not. So wkv6_tc_decay computes those for all chunks at once, and
// wkv6_tc_walk walks the chunks with nothing on its serial path but copies,
// the products U and one multiply-add a state element.

// Where the scratch buffer keeps what the passes hand on, in floats from
// its start: the state at each chunk's start (B, H, nc, N, N), the chunks'
// decays exp(lcum_last) (B, H, nc, N), and k exp(lcum_last - lcum) as bf16
// hi and lo (B, H, nc, QP, N) each.
struct Scratch {
  float* starts;
  float* decay;
  __nv_bfloat16* kh;
  __nv_bfloat16* kl;
};

__host__ __device__ inline Scratch scratch(void* p, int BH, int nc, int QP,
                                           int N) {
  Scratch s;
  s.starts = (float*)p;
  s.decay = s.starts + (size_t)BH * nc * N * N;
  s.kh = (__nv_bfloat16*)(s.decay + (size_t)BH * nc * N);
  s.kl = s.kh + (size_t)BH * nc * QP * N;
  return s;
}

// grid (chunks, H, B): two threads a channel, as in wkv6_tc_out
template <int QP>
__global__ void __launch_bounds__(THREADS)
    wkv6_tc_decay(const __nv_bfloat16* __restrict__ k,
                  const float* __restrict__ w, Scratch sc, int L, int H,
                  int N, int Q) {
  constexpr int HALF = QP / 2;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int c0 = c * Q, qc = min(Q, L - c0);
  const size_t row = (size_t)H * N;
  const size_t base = ((size_t)b * L + c0) * row + (size_t)h * N;
  const size_t bhc = ((size_t)b * H + h) * gridDim.x + c;
  const int ci = t >> 1, part = t & 1;
  const bool chan = ci < N;
  float wr[HALF];
  __nv_bfloat16 kr[HALF];
#pragma unroll
  for (int m = 0; m < HALF; ++m) {
    const int q = part * HALF + m;
    const bool ok = chan && q < qc;
    const size_t off = base + (size_t)q * row + ci;
    wr[m] = ok ? w[off] : 1.f;
    kr[m] = ok ? k[off] : __float2bfloat16(0.f);
  }
  Decays<HALF> d;
  decays<HALF, 2>(wr, part, d);
  if (!chan) return;
  __nv_bfloat16* kh = sc.kh + bhc * QP * N + ci;
  __nv_bfloat16* kl = sc.kl + bhc * QP * N + ci;
#pragma unroll
  for (int m = 0; m < HALF; ++m) {
    const int q = part * HALF + m;
    split1(__bfloat162float(kr[m]) * exp2f(d.last - (d.before + d.lc[m])),
           kh + q * N, kl + q * N);
  }
  if (part == 0) sc.decay[bhc * N + ci] = exp2f(d.last);
}

// The walk. A block carries 16 rows i of a head's state, all N columns,
// one 16-column slice a warp (rows are independent: S[i][:] reads only
// k[:, i] and w[:, i]). Chunk c + STAGES - 1 is copied in while chunk c
// computes, one barrier a chunk.
template <int QP>
struct WalkSmem {
  static constexpr int STAGES = 4;  // chunks in flight (8 ran no faster)
  struct Stage {
    __nv_bfloat16 kh[QP * VS];  // k exp(lcum_last - lcum), hi + lo, [q][i]
    __nv_bfloat16 kl[QP * VS];
    __nv_bfloat16 v[QP * KS];   // [q][n]
    float dec[16];
  };
  Stage st[STAGES];
};

// grid (N / 16, H, B): block (it, h, b) carries S[16 it .. 16 it + 15][:]
// of head h; warp w its columns 16 w .. 16 w + 15 in fp32 registers.
template <int QP>
__global__ void __launch_bounds__(THREADS)
    wkv6_tc_walk(const __nv_bfloat16* __restrict__ v, Scratch sc,
                 float* __restrict__ s_final, int L, int H, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Smem = WalkSmem<QP>;
  constexpr int STAGES = Smem::STAGES;
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int it = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, u = lane & 3;
  const int nc = (L + Q - 1) / Q;
  const size_t row = (size_t)H * N;
  const size_t bh = (size_t)b * H + h;
  // This thread's share of a chunk's copies, worked out once: per row q,
  // 2 pieces of kh, 2 of kl and N / 8 of v (16 bytes each), then 4 of the
  // decays. Per chunk only the source moves (by `step` bytes).
  constexpr int KMAX = (QP * (4 + NM / 8) + 4 + THREADS - 1) / THREADS;
  const char* src0[KMAX];
  int step[KMAX], dsm[KMAX], vrow[KMAX];
  int n_pieces = 0;
  {
    const int per = 4 + N / 8;
    const size_t tile = bh * nc * QP * N + 16 * it;  // chunk 0's kh tile
#pragma unroll
    for (int k2 = 0; k2 < KMAX; ++k2) {
      const int i = t + k2 * THREADS;
      const int q = i / per, j = i - q * per;
      vrow[k2] = -1;
      if (i >= QP * per + 4) {
        src0[k2] = nullptr;
        step[k2] = dsm[k2] = 0;
        continue;
      }
      n_pieces = k2 + 1;
      if (q == QP) {  // the decays of the block's 16 channels
        src0[k2] = (const char*)(sc.decay + bh * nc * N + 16 * it + 4 * j);
        step[k2] = 4 * N;
        dsm[k2] = (int)offsetof(typename Smem::Stage, dec) + 16 * j;
      } else if (j < 4) {
        src0[k2] = (const char*)((j < 2 ? sc.kh : sc.kl) + tile +
                                 (size_t)q * N + 8 * (j & 1));
        step[k2] = 2 * QP * N;
        dsm[k2] = (int)(j < 2 ? offsetof(typename Smem::Stage, kh)
                              : offsetof(typename Smem::Stage, kl)) +
                  2 * (q * VS + 8 * (j & 1));
      } else {
        src0[k2] = (const char*)(v + (size_t)b * L * row + (size_t)q * row +
                                 (size_t)h * N + 8 * (j - 4));
        step[k2] = 2 * Q * (int)row;
        dsm[k2] = (int)offsetof(typename Smem::Stage, v) +
                  2 * (q * KS + 8 * (j - 4));
        vrow[k2] = q;
      }
    }
  }
  const uint32_t stage0 = smem_u32(&s.st[0]);
  auto load = [&](int c) {
    const uint32_t at = stage0 + (c % STAGES) * (uint32_t)sizeof(
                                                    typename Smem::Stage);
    const int qc = min(Q, L - c * Q);
#pragma unroll
    for (int k2 = 0; k2 < KMAX; ++k2) {
      if (k2 >= n_pieces) break;
      const bool ok = vrow[k2] < qc;  // rows of v past the sequence: zeros
      const char* src = ok ? src0[k2] + (size_t)c * step[k2] : src0[k2];
      cp_async16(at + dsm[k2], src, ok);
    }
  };

  // the state: rows i = 16 it + g (+ 8), columns 16 warp + 8 j + 2u (+ 1)
  float S[2][4] = {};
  const bool cols_in = 16 * warp < N;
  const int i0 = 16 * it + g;
  // U = (k exp(lcum_last - lcum))^T v over chunk c's steps, the hi and lo
  // products in separate sums so that no mma waits on another
  auto products = [&](int c, float (&U)[2][4]) {
    const typename Smem::Stage& d = s.st[c % STAGES];
    float Ul[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < QP / 16; ++kk) {
      uint32_t ah[4], al[4], bv[4];
      const int ao = (16 * kk + (lane & 7) + 8 * (lane >> 4)) * VS +
                     8 * ((lane >> 3) & 1);
      ldsm_x4_t(ah, d.kh + ao);
      ldsm_x4_t(al, d.kl + ao);
      ldsm_x4_t(bv, d.v + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) *
                              KS + 16 * warp + 8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma(U[j], ah, bv[2 * j], bv[2 * j + 1]);
        mma(Ul[j], al, bv[2 * j], bv[2 * j + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) U[j][e] += Ul[j][e];
  };
  // the state at chunk c's start to scratch, then S = exp(lcum_last) S + U
  auto advance = [&](int c, const float (&U)[2][4]) {
    const typename Smem::Stage& d = s.st[c % STAGES];
    float* dst = sc.starts + (bh * nc + c) * N * N;
    const float d0 = d.dec[g], d1 = d.dec[g + 8];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 16 * warp + 8 * j + 2 * u;
      *reinterpret_cast<float2*>(dst + (size_t)i0 * N + n) =
          make_float2(S[j][0], S[j][1]);
      *reinterpret_cast<float2*>(dst + (size_t)(i0 + 8) * N + n) =
          make_float2(S[j][2], S[j][3]);
      S[j][0] = fmaf(S[j][0], d0, U[j][0]);
      S[j][1] = fmaf(S[j][1], d0, U[j][1]);
      S[j][2] = fmaf(S[j][2], d1, U[j][2]);
      S[j][3] = fmaf(S[j][3], d1, U[j][3]);
    }
  };

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nc) load(c);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int c = 0; c < nc; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // chunk c has landed; every read of chunk c - 1 done
    if (c + STAGES - 1 < nc) load(c + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    if (!cols_in) continue;
    float U[2][4] = {};
    products(c, U);
    advance(c, U);
  }
  if (!cols_in) return;
  float* dst = s_final + bh * N * N;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = 16 * warp + 8 * j + 2 * u;
    *reinterpret_cast<float2*>(dst + (size_t)i0 * N + n) =
        make_float2(S[j][0], S[j][1]);
    *reinterpret_cast<float2*>(dst + (size_t)(i0 + 8) * N + n) =
        make_float2(S[j][2], S[j][3]);
  }
}

template <int QP>
struct OutPairs {
  float2 rl[QP][NM + 1];  // (r, lprev), [q][i]
  float2 kl[QP][NM + 1];  // (k, lcum), [j][i]
};
struct OutState {
  __nv_bfloat16 sh[NM * KS];   // the state at the chunk's start, hi + lo,
  __nv_bfloat16 slo[NM * KS];  // [i][n]
};

template <int QP>
struct OutSmem {
  static constexpr int SS = QP + 8;  // bf16 row stride of the scores
  union {                            // the pairs for the scores, then the
    OutPairs<QP> pr;                 // state for the products
    OutState st;
  };
  alignas(16) __nv_bfloat16 sch[QP * SS];  // scores, hi + lo, [q][j]
  alignas(16) __nv_bfloat16 scl[QP * SS];
  alignas(16) __nv_bfloat16 rh[QP * KS];  // r exp(lprev), hi + lo, [q][i]
  alignas(16) __nv_bfloat16 rlo[QP * KS];
  alignas(16) __nv_bfloat16 vs[QP * KS];  // v, [j][n]
  float us[NM];
};

// grid (chunks, H, B): one block per chunk of one head, all N columns.
template <int QP>
__global__ void __launch_bounds__(OUT_THREADS, QP == 64 ? 2 : 3)
    wkv6_tc_out(const __nv_bfloat16* __restrict__ r,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ starts,
                __nv_bfloat16* __restrict__ out, int L, int H, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Smem = OutSmem<QP>;
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  constexpr int R = QP / 4, SS = Smem::SS;
  // 16-byte pieces of v and float4 of the state a thread
  constexpr int NV = (QP * NM / 8 + OUT_THREADS - 1) / OUT_THREADS;
  constexpr int NS = NM * NM / 4 / OUT_THREADS;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int c0 = c * Q, qc = min(Q, L - c0);
  const size_t row = (size_t)H * N;
  const size_t base = ((size_t)b * L + c0) * row + (size_t)h * N;

  // 1. every load from device memory first, so the block waits once: this
  // thread's channel ci = t / 4 over rows part R .., its pieces of v and of
  // the state at the chunk's start
  const int ci = t >> 2, part = t & 3;
  const bool chan = ci < N;
  float wr[R];
  __nv_bfloat16 rr[R], kr[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int q = part * R + m;
    const bool ok = chan && q < qc;
    const size_t off = base + (size_t)q * row + ci;
    wr[m] = ok ? w[off] : 1.f;
    rr[m] = ok ? r[off] : __float2bfloat16(0.f);
    kr[m] = ok ? k[off] : __float2bfloat16(0.f);
  }
  uint4 vr[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * OUT_THREADS, q = i / (N / 8), n = 8 * (i % (N / 8));
    vr[j] = make_uint4(0u, 0u, 0u, 0u);
    if (q < qc)
      vr[j] = *reinterpret_cast<const uint4*>(v + base + (size_t)q * row + n);
  }
  float4 sr[NS];
  const float* st = starts + (((size_t)b * H + h) * gridDim.x + c) * N * N;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int i = t + j * OUT_THREADS;
    sr[j] = i < N * N / 4 ? *reinterpret_cast<const float4*>(st + 4 * i)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float uh = t < N ? u[(size_t)h * N + t] : 0.f;

  // lcum, lprev; (r, lprev), (k, lcum) and r exp(lprev) as hi + lo
  {
    Decays<R> d;
    decays<R, 4>(wr, part, d);
    if (chan) {
      float prev = d.before;  // lprev of this thread's first row
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int q = part * R + m;
        const float rv = __bfloat162float(rr[m]);
        const float cum = d.before + d.lc[m];
        s.pr.rl[q][ci] = make_float2(rv, prev);
        s.pr.kl[q][ci] = make_float2(__bfloat162float(kr[m]), cum);
        split1(rv * exp2f(prev), &s.rh[q * KS + ci], &s.rlo[q * KS + ci]);
        prev = cum;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * OUT_THREADS, q = i / (N / 8), n = 8 * (i % (N / 8));
    if (q < QP) *reinterpret_cast<uint4*>(s.vs + q * KS + n) = vr[j];
  }
  for (int i = t; i < QP * SS / 2; i += OUT_THREADS) {
    reinterpret_cast<uint32_t*>(s.sch)[i] = 0u;
    reinterpret_cast<uint32_t*>(s.scl)[i] = 0u;
  }
  if (t < N) s.us[t] = uh;
  __syncthreads();

  // 2. scores over 4 x 4 tiles of (q, j), every lane busy: the P4 (P4 - 1)
  // / 2 tiles below the diagonal (all pairs j < q), 8 lanes each (channels
  // i = p mod 8), then the P4 tiles on it (the 6 pairs j < q and the bonus
  // r u k at j = q), 4 lanes each. The lanes of a tile are adjacent and join
  // their sums by shuffles. Each exponent is <= 0.
  constexpr int P4 = QP / 4, N_BELOW = P4 * (P4 - 1) / 2;
  constexpr int UNITS = 8 * N_BELOW + 4 * P4;
  static_assert(UNITS % 32 == 0, "whole warps take the score units");
  for (int unit = t; unit < UNITS; unit += OUT_THREADS) {
    const bool below = unit < 8 * N_BELOW;
    int qa, jb, p;  // rows 4 qa .. 4 qa + 3, keys 4 jb .., first channel p
    if (below) {
      const int tile = unit >> 3;
      int a = (int)((1.f + sqrtf(1.f + 8.f * tile)) * 0.5f);
      while (a * (a - 1) / 2 > tile) --a;
      while ((a + 1) * a / 2 <= tile) ++a;
      qa = a;
      jb = tile - a * (a - 1) / 2;
      p = unit & 7;
    } else {
      qa = jb = (unit - 8 * N_BELOW) >> 2;
      p = unit & 3;
    }
    float acc[4][4] = {};
    if (4 * qa < qc) {
      const float2(*rl)[NM + 1] = s.pr.rl + 4 * qa;
      const float2(*kl)[NM + 1] = s.pr.kl + 4 * jb;
      if (below) {
#pragma unroll 2
        for (int i = p; i < N; i += 8) {
          float2 x[4], y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[e] = rl[e][i];
            y[e] = kl[e][i];
          }
          // 2^(lprev[q] - lcum[j]) = 2^(lprev[q] - lcum[j3]) 2^(lcum[j3] -
          // lcum[j]) with j3 the tile's last key: lcum falls along j and
          // q - 1 >= j3, so both exponents are <= 0; 7 exps for 16 pairs
          float a[4], kd[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = x[e].x * ex2(x[e].y - y[3].y);
#pragma unroll
          for (int f = 0; f < 3; ++f) kd[f] = y[f].x * ex2(y[3].y - y[f].y);
          kd[3] = y[3].x;
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int f = 0; f < 4; ++f)
              acc[e][f] = fmaf(a[e], kd[f], acc[e][f]);
        }
      } else {
#pragma unroll 2
        for (int i = p; i < N; i += 4) {
          float2 x[4], y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[e] = rl[e][i];
            y[e] = kl[e][i];
          }
          const float ui = s.us[i];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[e][e] = fmaf(x[e].x * ui, y[e].x, acc[e][e]);
#pragma unroll
            for (int f = 0; f < e; ++f)
              acc[e][f] = fmaf(x[e].x * y[f].x, ex2(x[e].y - y[f].y),
                               acc[e][f]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        acc[e][f] += __shfl_xor_sync(0xffffffffu, acc[e][f], 1);
        acc[e][f] += __shfl_xor_sync(0xffffffffu, acc[e][f], 2);
        const float o = __shfl_xor_sync(0xffffffffu, acc[e][f], 4);
        if (below) acc[e][f] += o;
      }
    // lane p < 4 of a tile writes its row p
    if (p < 4) {
      float v4[4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
        v4[f] = p == 0 ? acc[0][f] : p == 1 ? acc[1][f]
              : p == 2 ? acc[2][f] : acc[3][f];
      uint32_t h0, l0, h1, l1;
      split2(v4[0], v4[1], h0, l0);
      split2(v4[2], v4[3], h1, l1);
      const int off = (4 * qa + p) * SS + 4 * jb;
      *reinterpret_cast<uint2*>(s.sch + off) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(s.scl + off) = make_uint2(l0, l1);
    }
  }
  __syncthreads();  // the pairs are read; their space takes the state
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int i = t + j * OUT_THREADS, ii = 4 * i / N, n = 4 * i % N;
    if (i < N * N / 4) {
      uint32_t h0, l0, h1, l1;
      split2(sr[j].x, sr[j].y, h0, l0);
      split2(sr[j].z, sr[j].w, h1, l1);
      *reinterpret_cast<uint2*>(s.st.sh + ii * KS + n) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(s.st.slo + ii * KS + n) = make_uint2(l0, l1);
    }
  }
  __syncthreads();

  // 3. o = (r exp(lprev)) S + sc v on the tensor cores: units of 16 rows x
  // 16 columns, warp w takes w, w + 4, ...
  const int g = lane >> 2, uq = lane & 3;
  const int n16 = N / 16, units = (QP / 16) * n16;
  for (int unit = warp; unit < units; unit += OUT_THREADS / 32) {
    const int mt = unit / n16, np = unit % n16;
    if (16 * mt >= qc) continue;
    float acc[2][4] = {};
    const int arow = 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int acol = 8 * (lane >> 4);
    const int brow = 8 * ((lane >> 3) & 1) + (lane & 7);
    const int bcol = 16 * np + 8 * (lane >> 4);
    for (int ks = 0; ks < n16; ++ks) {  // hi hi + hi lo + lo hi
      uint32_t ah[4], al[4], bh[4], bl[4];
      ldsm_x4(ah, s.rh + arow * KS + 16 * ks + acol);
      ldsm_x4(al, s.rlo + arow * KS + 16 * ks + acol);
      ldsm_x4_t(bh, s.st.sh + (16 * ks + brow) * KS + bcol);
      ldsm_x4_t(bl, s.st.slo + (16 * ks + brow) * KS + bcol);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma(acc[j], ah, bh[2 * j], bh[2 * j + 1]);
        mma(acc[j], ah, bl[2 * j], bl[2 * j + 1]);
        mma(acc[j], al, bh[2 * j], bh[2 * j + 1]);
      }
    }
    for (int kk = 0; kk <= mt; ++kk) {  // key tiles at or below the diagonal
      uint32_t ah[4], al[4], bv[4];
      ldsm_x4(ah, s.sch + arow * SS + 16 * kk + acol);
      ldsm_x4(al, s.scl + arow * SS + 16 * kk + acol);
      ldsm_x4_t(bv, s.vs + (16 * kk + brow) * KS + bcol);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma(acc[j], ah, bv[2 * j], bv[2 * j + 1]);
        mma(acc[j], al, bv[2 * j], bv[2 * j + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int q = 16 * mt + g + 8 * rr;
        if (q < qc)
          *reinterpret_cast<__nv_bfloat162*>(
              out + base + (size_t)q * row + 16 * np + 8 * j + 2 * uq) =
              __floats2bfloat162_rn(acc[j][2 * rr], acc[j][2 * rr + 1]);
      }
  }
}

template <int QP>
size_t smem_bytes(int pass) {
  return pass == 0 ? sizeof(WalkSmem<QP>) : sizeof(OutSmem<QP>);
}

template <int QP>
int launch_qp(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* out, void* s_final, void* scratch_p,
              int B, int L, int H, int N, int Q, void* stream) {
  const int nc = (L + Q - 1) / Q;
  const int ws = (int)smem_bytes<QP>(0), os = (int)smem_bytes<QP>(1);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_tc_walk<QP>, cudaFuncAttributeMaxDynamicSharedMemorySize, ws);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      wkv6_tc_out<QP>, cudaFuncAttributeMaxDynamicSharedMemorySize, os);
  if (err != cudaSuccess) return (int)err;
  const auto* kb = (const __nv_bfloat16*)k;
  const auto* vb = (const __nv_bfloat16*)v;
  const Scratch sc = scratch(scratch_p, B * H, nc, QP, N);
  const cudaStream_t sm = (cudaStream_t)stream;
  wkv6_tc_decay<QP><<<dim3(nc, H, B), THREADS, 0, sm>>>(
      kb, (const float*)w, sc, L, H, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_tc_walk<QP><<<dim3(N / 16, H, B), THREADS, ws, sm>>>(
      vb, sc, (float*)s_final, L, H, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_tc_out<QP><<<dim3(nc, H, B), OUT_THREADS, os, sm>>>(
      (const __nv_bfloat16*)r, kb, vb, (const float*)w, (const float*)u,
      sc.starts, (__nv_bfloat16*)out, L, H, N, Q);
  return (int)cudaGetLastError();
}

inline int padded(int Q) { return Q <= 16 ? 16 : Q <= 32 ? 32 : 64; }

}  // namespace tc

int launch_tc(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* out, void* s_final, void* starts, int B,
              int L, int H, int N, int chunk, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || N <= 0 || N > tc::NM || N % 16 != 0 ||
      chunk <= 0 || chunk > QMAX || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k | (uintptr_t)v | (uintptr_t)w) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int Q = min(chunk, L);
  switch (tc::padded(Q)) {
    case 16:
      return tc::launch_qp<16>(r, k, v, w, u, out, s_final, starts, B, L, H,
                               N, Q, stream);
    case 32:
      return tc::launch_qp<32>(r, k, v, w, u, out, s_final, starts, B, L, H,
                               N, Q, stream);
    default:
      return tc::launch_qp<64>(r, k, v, w, u, out, s_final, starts, B, L, H,
                               N, Q, stream);
  }
}

}  // namespace

extern "C" {

int rwkv6_wkv_f32(const void* r, const void* k, const void* v, const void* w,
                  const void* u, void* out, void* s_final, int B, int L,
                  int H, int N, int chunk, void* stream) {
  return launch<float>(r, k, v, w, u, out, s_final, B, L, H, N, chunk,
                       stream);
}

int rwkv6_wkv_bf16(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* out, void* s_final,
                   int B, int L, int H, int N, int chunk, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, out, s_final, B, L, H, N,
                               chunk, stream);
}

// scratch: the buffer struct Scratch lays out, of
// kernels/rwkv6_wkv.py::scratch_bytes(B, L, H, N, chunk) bytes on a 16-byte
// boundary; N a multiple of 16, k, v and w on 16-byte boundaries
int rwkv6_wkv_bf16_tc(const void* r, const void* k, const void* v,
                      const void* w, const void* u, void* out, void* s_final,
                      void* starts, int B, int L, int H, int N, int chunk,
                      void* stream) {
  return launch_tc(r, k, v, w, u, out, s_final, starts, B, L, H, N, chunk,
                   stream);
}

// dynamic shared memory of a wkv6_tc block at this chunk, in bytes: the
// walk of the state pass (pass 0) or the output pass (pass 1)
int rwkv6_wkv_tc_smem_bytes(int pass, int chunk) {
  switch (tc::padded(chunk)) {
    case 16: return (int)tc::smem_bytes<16>(pass);
    case 32: return (int)tc::smem_bytes<32>(pass);
    default: return (int)tc::smem_bytes<64>(pass);
  }
}

const char* rwkv6_wkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
