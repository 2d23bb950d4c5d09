// Chunked Mamba2 SSD scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_scan.py::mamba2_scan
// (_kernel :25-66); its oracle is src/repro/kernels/mamba2_scan_ref.py::
// reference, the step-by-step recurrence
//   h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,
// for every head h of every batch row, with B/C shared by the H/G heads of a
// group. Per chunk of Q steps (a = dt*A) both kernels compute, in fp32:
//   intra-chunk  y[q]  = sum_{k<=q} (C[q].B[k]) exp(seg[q][k]) dt[k] x[k]
//   carried      y[q] += exp(cum[q]) C[q] h^T
//   state        h     = exp(cum[Q-1]) h + sum_q x[q]^T (B[q] dt[q]
//                                                exp(seg[Q-1][q]))
// with seg[q][k] = sum_{k<j<=q} a_j and cum[q] = sum_{j<=q} a_j. Every decay
// is a sum of a run of a, never a difference cum[q] - cum[k]: within a chunk
// cum reaches ~10^2 on heads that decay fast, where one float32 step is
// ~1e-5, and a difference of two such sums loses the small decays that
// matter. x (B,L,H,P), B/C (B,L,G,N) in float32 or bfloat16; dt (B,L,H) and
// A (H,) float32; y (B,L,H,P) in x's type; h_final (B,H,P,N) float32.
// P <= 64, N <= 64, chunk Q <= 128; L is any length (the last chunk may be
// short: it is padded with zeros, and dt = 0 adds and decays nothing; the
// reference model shrinks its chunk to a divisor of L instead,
// mamba2.py:119-124, which is 1 for a prime L).
//
// What bounds it: bytes. At the zamba2-7b prefill shape, x (1, 2048, 112,
// 64) bf16 with B/C (1, 2048, 1, 64) bf16, the kernel must read 30.9 MB and
// write 31.2 MB (y and h_final): 61.9 MB, 0.0185 ms at 3.35 TB/s. Its
// 11.3 GFLOP take 0.011 ms at the bf16 tensor-core rate.
//
// The TPU kept the (P,N) state in VMEM scratch across the sequential chunk
// axis of its grid (:28-31, :59-66). CUDA blocks run in no order, so a block
// loops over the chunks itself and carries the state. Two kernels; the
// wrapper (kernels/mamba2_scan.py) picks one by a stated rule, and neither
// falls back to the other.
//
// ssd_scan_tc, bf16 with P and N multiples of 8: the tensor cores.
//   * Split value channels: y[:, p] and h[p, :] depend on x[:, p] alone, so
//     the grid is (H, P / 32, B), 224 blocks at batch 1, and a block keeps
//     only its 32 x N slice of the state. Each block recomputes C B^T and
//     the decays of its chunk.
//   * mma.sync m16n8k16 (bf16 in, fp32 sums) with ldmatrix, not wgmma:
//     wgmma's 64-row tiles fit a 32-channel slice poorly, and a kernel bound
//     by bytes does not need its rate. C B^T takes the bf16 inputs as they
//     are; every float32 operand enters as a bf16 pair hi + lo (M, h, w B):
//     rounded once to bf16 they miss the card bound (tests/torch_parity.py
//     emulates both). The state itself stays fp32 in registers; a hi + lo
//     copy in shared memory feeds C h^T.
//   * The decays come from running sums by warp shuffles within 16-row
//     blocks and sums of whole blocks (struct Runs); M is built one 16 x 16
//     tile at a time at or below the diagonal, spread over the 16 warps, and
//     kept in shared memory as hi + lo for M x.
//   * The next chunk's x, B, C and dt are copied into a second buffer with
//     cp.async while this chunk computes. Rows, value channels and state
//     columns past L, P and N are zero in shared memory.
//
// ssd_scan, float32 (and bf16 with other P or N): the fp32 CUDA cores, the
// first, simple port. One block per (batch row, head), the state in
// registers (16 values a thread) with a copy in shared memory for the
// carried term; a chunk's x, B, C, dt and the (Q,Q) weights live in about
// 180 KB of shared memory; seg is a running sum down each column of the
// weight matrix, one thread a column; the three products use register tiles
// (8x8, 8x4 and 4x4 a thread). At batch 1 the grid has H = 112 blocks for
// the card's 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int QMAX = 128;
constexpr int PMAX = 64;
constexpr int NMAX = 64;

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
  size_t xs, Bs, Cs, Ms, hs, vec, total;  // offsets in floats
};

__host__ __device__ inline Layout layout(int Q, int P, int N) {
  Layout s;
  s.sN = N | 1;
  s.sQ = Q | 1;
  s.xs = 0;
  s.Bs = s.xs + (size_t)Q * P;
  s.Cs = s.Bs + (size_t)Q * s.sN;
  s.Ms = s.Cs + (size_t)Q * s.sN;
  s.hs = s.Ms + (size_t)Q * s.sQ;
  s.vec = s.hs + (size_t)P * s.sN;
  s.total = s.vec + 3 * (size_t)Q;  // dt, exp(cum), dt * decay to end
  return s;
}

// grid (H, B)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scan(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, T* __restrict__ y,
             float* __restrict__ h_final, int L, int H, int P, int G, int N,
             int Q) {
  extern __shared__ float smem[];
  const Layout s = layout(Q, P, N);
  float* xs = smem + s.xs;   // [Q][P]
  float* Bs = smem + s.Bs;   // [Q][sN]
  float* Cs = smem + s.Cs;   // [Q][sN]
  float* Ms = smem + s.Ms;   // [Q][sQ]  intra-chunk weights
  float* hs = smem + s.hs;   // [P][sN]  state at the chunk start
  float* dts = smem + s.vec;
  float* ecum = dts + Q;
  float* wq = ecum + Q;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a_h = A[h];
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;

  // the state of this thread: p = ty + 16i, n = tx + 16j
  float hr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) hr[i][j] = 0.f;
  for (int i = t; i < P * s.sN; i += THREADS) hs[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int Qc = min(Q, L - c0);
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = t; i < Q * P; i += THREADS) {
      const int r = i / P, p = i - r * P;
      xs[i] = r < Qc ? load_f(x + (((size_t)b * L + c0 + r) * H + h) * P + p)
                     : 0.f;
    }
    for (int i = t; i < Q * N; i += THREADS) {
      const int r = i / N, n = i - r * N;
      const size_t off = (((size_t)b * L + c0 + r) * G + g) * N + n;
      Bs[r * s.sN + n] = r < Qc ? load_f(Bm + off) : 0.f;
      Cs[r * s.sN + n] = r < Qc ? load_f(Cm + off) : 0.f;
    }
    for (int r = t; r < Q; r += THREADS)
      dts[r] = r < Qc ? dt[((size_t)b * L + c0 + r) * H + h] : 0.f;
    __syncthreads();

    // inclusive cumsum of a = dt*A over the chunk: one warp, 4 steps a lane
    if (t < 32) {
      float part[QMAX / 32];
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < QMAX / 32; ++u) {
        const int r = t * (QMAX / 32) + u;
        run += r < Q ? dts[r] * a_h : 0.f;
        part[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_up_sync(0xffffffffu, incl, off);
        if (t >= off) incl += other;
      }
      const float base = incl - run;
#pragma unroll
      for (int u = 0; u < QMAX / 32; ++u) {
        const int r = t * (QMAX / 32) + u;
        if (r < Q) {
          ecum[r] = expf(base + part[u]);
        }
      }
    }
    // segment sums seg[q][k] = sum_{k<j<=q} a_j into Ms, a running sum down
    // column k (one thread a column); its last value is the log-decay from
    // step k to the chunk's end. Never a difference of two prefix sums:
    // those reach ~10^2 within a chunk, where a float32 step is ~1e-5
    if (t < Q) {
      float run = 0.f;
      Ms[t * s.sQ + t] = 0.f;
      for (int q = t + 1; q < Q; ++q) {
        run += dts[q] * a_h;
        Ms[q * s.sQ + t] = run;
      }
      wq[t] = dts[t] * expf(run);  // dt * decay to the chunk's end
    }
    __syncthreads();

    // M[q][k] = (C[q].B[k]) exp(seg[q][k]) dt[k] for k <= q, else 0;
    // this thread: q = ty + 16i, k = tx + 16j
    {
      float gacc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) gacc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = min(ty + 16 * i, Q - 1);
          cv[i] = Cs[r * s.sN + n];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = min(tx + 16 * j, Q - 1);
          bv[j] = Bs[r * s.sN + n];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) gacc[i][j] = fmaf(cv[i], bv[j], gacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = ty + 16 * i;
        if (q >= Q) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = tx + 16 * j;
          if (k >= Q) continue;
          Ms[q * s.sQ + k] =
              k <= q ? gacc[i][j] * expf(Ms[q * s.sQ + k]) * dts[k] : 0.f;
        }
      }
    }
    __syncthreads();

    // y[q][p] = sum_k M[q][k] x[k][p] + exp(cum[q]) sum_n C[q][n] h[p][n];
    // this thread: q = ty + 16i, p = tx + 16j
    {
      float y1[8][4], y2[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) y1[i][j] = y2[i][j] = 0.f;
      for (int k = 0; k < Qc; ++k) {
        float mv[8], xv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = min(ty + 16 * i, Q - 1);
          mv[i] = Ms[r * s.sQ + k];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[k * P + min(tx + 16 * j, P - 1)];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) y1[i][j] = fmaf(mv[i], xv[j], y1[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[8], hv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = min(ty + 16 * i, Q - 1);
          cv[i] = Cs[r * s.sN + n];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hv[j] = hs[min(tx + 16 * j, P - 1) * s.sN + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) y2[i][j] = fmaf(cv[i], hv[j], y2[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = ty + 16 * i;
        if (q >= Qc) continue;
        T* dst = y + (((size_t)b * L + c0 + q) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) store_f(dst + p, fmaf(ecum[q], y2[i][j], y1[i][j]));
        }
      }
    }
    __syncthreads();  // every read of hs for this chunk is done

    // h[p][n] = exp(cum_last) h[p][n] + sum_q x[q][p] wq[q] B[q][n]
    {
      float upd[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) upd[i][j] = 0.f;
      for (int q = 0; q < Qc; ++q) {
        const float w = wq[q];
        float xv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xv[i] = xs[q * P + min(ty + 16 * i, P - 1)] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[q * s.sN + min(tx + 16 * j, N - 1)];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) upd[i][j] = fmaf(xv[i], bv[j], upd[i][j]);
      }
      const float decay = ecum[Q - 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = tx + 16 * j;
          hr[i][j] = fmaf(hr[i][j], decay, upd[i][j]);
          if (p < P && n < N) hs[p * s.sN + n] = hr[i][j];
        }
      }
    }
  }

  float* dst = h_final + ((size_t)b * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (p < P && n < N) dst[p * N + n] = hr[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* h_final, int B, int L, int H, int P,
           int G, int N, int chunk, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > PMAX || N <= 0 || N > NMAX || chunk <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int Q = min(min(chunk, QMAX), L);
  const size_t smem = layout(Q, P, N).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan<T><<<dim3(H, B), THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (T*)y, (float*)h_final, L, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 kernel on the tensor cores. grid (H, ceil(P / PS), B): one block
// per (head, slice of PS value channels, batch row), 16 warps.
namespace tc {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int Q = 128;       // chunk rows in shared memory, zero-padded
constexpr int PS = 32;       // value channels a block
constexpr int NP = 64;       // state width in shared memory, zero-padded
constexpr int XS = PS + 8;   // row strides in bf16: 16-byte multiples whose
constexpr int BS = NP + 8;   // 8 rows of an ldmatrix hit 8 distinct bank quads
constexpr int MS = 16 + 8;
// 16 x 16 tiles of a chunk at or below the diagonal
constexpr int NT = (Q / 16) * (Q / 16 + 1) / 2;

// The running sums of a chunk, in base 2 (a = dt A log2(e)), from which
// every decay is a sum of runs of a, never a difference of two prefix sums:
// with q in 16-row block qb and k in block kb,
//   seg[q][k] = sum_{k<j<=q} a_j = loc[q][k]                 (qb == kb)
//             = (col[k] + mid[kb][qb]) + pre[q]              (qb > kb)
//   cum[q]    = sum_{j<=q} a_j = before[qb] + pre[q]
// pre[q]: from q's block start to q; col[k]: after k to its block's end;
// mid[kb][qb]: the blocks strictly between; before[qb] = mid[-1][qb].
struct Runs {
  float pre[Q];
  float col[Q];
  float mid[9][9];          // mid[kb + 1][qb], kb = -1 .. 7, qb = 0 .. 8
  float tot[8];             // block totals
  float loc[Q][17];         // loc[q][k % 16] within q's block, k <= q
};

struct Smem {
  __nv_bfloat16 x[2][Q * XS];  // two buffers: chunk c and chunk c + 1
  __nv_bfloat16 b[2][Q * BS];
  __nv_bfloat16 c[2][Q * BS];
  __nv_bfloat16 h_hi[PS * BS];  // the state at the chunk start, hi + lo
  __nv_bfloat16 h_lo[PS * BS];
  float dt[2][Q];
  float wq[Q];                  // dt * decay to the chunk's end
  Runs run;
  // M = (C B^T) exp(seg) dt on the 36 row x key tiles of 16 x 16 at or
  // below the diagonal, tile (mi, ki) at mi (mi + 1) / 2 + ki, hi + lo
  alignas(16) __nv_bfloat16 m_hi[NT][16 * MS];  // ldmatrix rows: 16 bytes
  alignas(16) __nv_bfloat16 m_lo[NT][16 * MS];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (u, v) as a bf16 pair hi + lo: hi = bf16(u), lo = bf16(u - hi), which
// carries 16 of float32's 24 bits where hi alone carries 8
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

// a bf16 pair scaled by (wu, wv) in fp32, then split
__device__ __forceinline__ void scale_split(uint32_t pair, float wu, float wv,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
  split2(f.x * wu, f.y * wv, hi, lo);
}

// Fragments (g = lane / 4, u = lane % 4): an A tile m16k16 holds rows g and
// g + 8, columns 2u, 2u + 1 and 2u + 8, 2u + 9; a B tile k16n8 holds column
// g, rows 2u, 2u + 1 (b0) and 2u + 8, 2u + 9 (b1); a C tile m16n8 holds rows
// g (d0, d1) and g + 8 (d2, d3), columns 2u, 2u + 1.

// (mi, ki) of the tiles of M at or below the diagonal, tile mi (mi + 1) / 2
// + ki; tiles w, w + 16, w + 32 go to warp w
__constant__ unsigned char kTileMi[NT] = {
    0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4, 5, 5, 5,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7};
__constant__ unsigned char kTileKi[NT] = {
    0, 0, 1, 0, 1, 2, 0, 1, 2, 3, 0, 1, 2, 3, 4, 0, 1, 2,
    3, 4, 5, 0, 1, 2, 3, 4, 5, 6, 0, 1, 2, 3, 4, 5, 6, 7};

// NTW tiles of M, warp w's tiles w + 16 i: rows 16 mi.., keys 16 ki..
// (ki <= mi), G = C B^T on the tensor cores, then G exp(seg) dt for
// k <= q < qc (else 0), stored as hi + lo for the products with x. The
// tiles' products and epilogues are independent, so they overlap.
template <int NTW>
__device__ __forceinline__ void m_tiles(Smem& s, const __nv_bfloat16* bs,
                                        const __nv_bfloat16* cs,
                                        const float* dts, int qc, int first,
                                        int lane) {
  const int g = lane >> 2, u = lane & 3;
  const Runs& R = s.run;
  int mi[NTW], ki[NTW];
  float acc[NTW][2][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    mi[i] = kTileMi[first + WARPS * i];
    ki[i] = kTileKi[first + WARPS * i];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      uint32_t ca[4], bb[4];
      ldsm_x4(ca, cs + (16 * mi[i] + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                           BS + 16 * ks + 8 * (lane >> 4));
      ldsm_x4(bb, bs + (16 * ki[i] + 8 * (lane >> 4) + (lane & 7)) * BS +
                      16 * ks + 8 * ((lane >> 3) & 1));
      mma(acc[i][0], ca, bb[0], bb[1]);
      mma(acc[i][1], ca, bb[2], bb[3]);
    }
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int idx = first + WARPS * i;
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows g and g + 8
      const int q = 16 * mi[i] + g + 8 * r;
      const bool in = q < qc;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = 16 * ki[i] + 8 * j + 2 * u;
        // both forms, then a select: no branch between the tiles
        const float2 ck = *reinterpret_cast<const float2*>(R.col + k);
        const float base = R.mid[ki[i] + 1][mi[i]], pre = R.pre[q];
        const bool diag = ki[i] == mi[i];
        const float s0 = diag ? R.loc[q][k & 15] : (ck.x + base) + pre;
        const float s1 = diag ? R.loc[q][(k + 1) & 15] : (ck.y + base) + pre;
        const float m0 =
            k <= q && in ? acc[i][j][2 * r] * exp2f(s0) * dts[k] : 0.f;
        const float m1 = k + 1 <= q && in
                             ? acc[i][j][2 * r + 1] * exp2f(s1) * dts[k + 1]
                             : 0.f;
        uint32_t hi, lo;
        split2(m0, m1, hi, lo);
        const int off = (g + 8 * r) * MS + 8 * j + 2 * u;
        *reinterpret_cast<uint32_t*>(s.m_hi[idx] + off) = hi;
        *reinterpret_cast<uint32_t*>(s.m_lo[idx] + off) = lo;
      }
    }
  }
}

// y on the rows of tiles ma < mb and the value channels of n8 tile pj:
// exp(cum[q]) C h^T + M x, h and M as hi + lo
__device__ __forceinline__ void y_tiles(const Smem& s,
                                        const __nv_bfloat16* xs,
                                        const __nv_bfloat16* cs, int qc,
                                        int ma, int mb, int pj, int lane,
                                        __nv_bfloat16* yrow,
                                        size_t row_stride, int p_left) {
  const int g = lane >> 2, u = lane & 3;
  const Runs& R = s.run;
  const int mt[2] = {ma, mb};
  float yhi[2][4] = {}, ylo[2][4] = {};  // [row tile][.]
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int off = (8 * pj + (lane & 7)) * BS + 16 * ks +
                    8 * ((lane >> 3) & 1);
    uint32_t bh[2], bl[2];
    ldsm_x2(bh, s.h_hi + off);
    ldsm_x2(bl, s.h_lo + off);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint32_t ca[4];
      ldsm_x4(ca, cs + (16 * mt[m] + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                           BS + 16 * ks + 8 * (lane >> 4));
      mma(yhi[m], ca, bh[0], bh[1]);
      mma(ylo[m], ca, bl[0], bl[1]);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float e0 = exp2f(R.mid[0][mt[m]] + R.pre[16 * mt[m] + g]);
    const float e1 = exp2f(R.mid[0][mt[m]] + R.pre[16 * mt[m] + g + 8]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      yhi[m][e] = (yhi[m][e] + ylo[m][e]) * (e < 2 ? e0 : e1);
      ylo[m][e] = 0.f;
    }
  }
  // M x over the key tiles kk <= m; tile mb has the most
  for (int kk = 0; kk <= mb; ++kk) {
    uint32_t bx[2];
    ldsm_x2_t(bx, xs + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * XS +
                      8 * pj);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (kk > mt[m]) continue;
      const int idx = mt[m] * (mt[m] + 1) / 2 + kk;
      const int off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * MS +
                      8 * (lane >> 4);
      uint32_t ah[4], al[4];
      ldsm_x4(ah, s.m_hi[idx] + off);
      ldsm_x4(al, s.m_lo[idx] + off);
      mma(yhi[m], ah, bx[0], bx[1]);
      mma(ylo[m], al, bx[0], bx[1]);
    }
  }
  const int p = 8 * pj + 2 * u;
  if (p >= p_left) return;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = 16 * mt[m] + g + 8 * r;
      if (q < qc)
        *reinterpret_cast<__nv_bfloat162*>(yrow + q * row_stride + p) =
            __floats2bfloat162_rn(yhi[m][2 * r] + ylo[m][2 * r],
                                  yhi[m][2 * r + 1] + ylo[m][2 * r + 1]);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    ssd_scan_tc(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ A,
                const __nv_bfloat16* __restrict__ Bm,
                const __nv_bfloat16* __restrict__ Cm,
                __nv_bfloat16* __restrict__ y, float* __restrict__ h_final,
                int L, int H, int P, int G, int N, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  Runs& R = s.run;
  const int h = blockIdx.x, p0 = blockIdx.y * PS, b = blockIdx.z;
  const int grp = h / (H / G);
  const float a_h = A[h] * 1.4426950408889634f;  // exponents in base 2
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, u = lane & 3;
  const int n_chunks = (L + chunk - 1) / chunk;

  auto load_chunk = [&](int c, int buf) {
    const int c0 = c * chunk, qc = min(chunk, L - c0);
    for (int i = t; i < Q * (PS / 8); i += THREADS) {
      const int r = i / (PS / 8), p = 8 * (i % (PS / 8));
      const bool ok = r < qc && p0 + p < P;
      cp_async16(&s.x[buf][r * XS + p],
                 ok ? x + (((size_t)b * L + c0 + r) * H + h) * P + p0 + p : x,
                 ok);
    }
    for (int i = t; i < Q * (NP / 8); i += THREADS) {
      const int r = i / (NP / 8), n = 8 * (i % (NP / 8));
      const bool ok = r < qc && n < N;
      const size_t off = (((size_t)b * L + c0 + r) * G + grp) * N + n;
      cp_async16(&s.b[buf][r * BS + n], ok ? Bm + off : Bm, ok);
      cp_async16(&s.c[buf][r * BS + n], ok ? Cm + off : Cm, ok);
    }
    for (int r = t; r < Q; r += THREADS) {
      const bool ok = r < qc;
      cp_async4(&s.dt[buf][r],
                ok ? dt + ((size_t)b * L + c0 + r) * H + h : dt, ok);
    }
  };

  // the state: rows p = 16 mi_h + g (+8), columns n = 8 nj + 2u (+1)
  const int mi_h = warp & 1, nj = warp >> 1;
  float hacc[4] = {};
  for (int i = t; i < PS * BS; i += THREADS) {
    s.h_hi[i] = __float2bfloat16(0.f);
    s.h_lo[i] = __float2bfloat16(0.f);
  }

  load_chunk(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, c0 = c * chunk, qc = min(chunk, L - c0);
    if (c + 1 < n_chunks) load_chunk(c + 1, buf ^ 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // chunk c has landed; buffer buf ^ 1 is in flight
    const float* dts = s.dt[buf];
    const __nv_bfloat16* xs = s.x[buf];
    const __nv_bfloat16* bs = s.b[buf];
    const __nv_bfloat16* cs = s.c[buf];

    // the runs of a (see Runs), by warp shuffles within each 16-row block
    // (half a warp): scans for pre and col, a running sum down each column
    // for loc
    if (t < Q) {
      const float a = dts[t] * a_h;
      const int li = t & 15;
      float pre = a, rev = a;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, pre, off, 16);
        const float dn = __shfl_down_sync(0xffffffffu, rev, off, 16);
        if (li >= off) pre += up;
        if (li + off < 16) rev += dn;
      }
      const float col = __shfl_down_sync(0xffffffffu, rev, 1, 16);
      R.pre[t] = pre;
      R.col[t] = li < 15 ? col : 0.f;
      if (li == 15) R.tot[t >> 4] = pre;
      float run = 0.f;
      R.loc[t][li] = 0.f;
#pragma unroll
      for (int d = 1; d < 16; ++d) {
        const float v =
            __shfl_sync(0xffffffffu, a, (lane & 16) | ((li + d) & 15));
        run += v;
        if (li + d < 16) R.loc[t + d][li] = run;
      }
    }
    __syncthreads();
    if (t < 81) {  // mid[kb + 1][qb]: the blocks kb + 1 .. qb - 1
      const int kb = t / 9 - 1, qb = t % 9;
      float m = 0.f;
      for (int i = kb + 1; i < qb; ++i) m += R.tot[i];
      R.mid[kb + 1][qb] = m;
    }
    __syncthreads();
    if (t < Q)  // the decay from step t to the chunk's end, times dt
      s.wq[t] = dts[t] * exp2f(R.col[t] + R.mid[(t >> 4) + 1][8]);

    // M: 36 tiles, warp w takes w and w + 16, and warps 0..3 also w + 32
    static_assert(NT == 2 * WARPS + 4, "tiles of M over the warps");
    m_tiles<2>(s, bs, cs, dts, qc, warp, lane);
    if (warp < 4) m_tiles<1>(s, bs, cs, dts, qc, warp + 2 * WARPS, lane);
    __syncthreads();
    // y: warp w takes the row tiles w % 4 and 7 - w % 4 (1 + 8 key tiles
    // between them) and the n8 value tile w / 4
    {
      const int ma = warp & 3;
      y_tiles(s, xs, cs, qc, ma, 7 - ma, warp >> 2, lane,
              y + (((size_t)b * L + c0) * H + h) * P + p0, (size_t)H * P,
              P - p0);
    }
    __syncthreads();  // every read of h_hi / h_lo for this chunk is done

    // h = exp(cum[last]) h + x^T (w B), x^T from ldmatrix.trans, w B as
    // hi + lo; the state stays fp32 in the accumulators
    {
      const float decay = exp2f(R.mid[0][8]);
      float hlo[4] = {};
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[e] *= decay;
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        uint32_t ax[4], bb[2];
        ldsm_x4_t(ax, xs + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * XS +
                          16 * mi_h + 8 * ((lane >> 3) & 1));
        ldsm_x2_t(bb, bs + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) *
                               BS + 8 * nj);
        const float* w = s.wq + 16 * kk + 2 * u;
        uint32_t hi[2], lo[2];
        scale_split(bb[0], w[0], w[1], hi[0], lo[0]);
        scale_split(bb[1], w[8], w[9], hi[1], lo[1]);
        mma(hacc, ax, hi[0], hi[1]);
        mma(hlo, ax, lo[0], lo[1]);
      }
      const int p_lo = 16 * mi_h + g, n = 8 * nj + 2 * u;
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[e] += hlo[e];
      uint32_t hi, lo;
      split2(hacc[0], hacc[1], hi, lo);
      *reinterpret_cast<uint32_t*>(s.h_hi + p_lo * BS + n) = hi;
      *reinterpret_cast<uint32_t*>(s.h_lo + p_lo * BS + n) = lo;
      split2(hacc[2], hacc[3], hi, lo);
      *reinterpret_cast<uint32_t*>(s.h_hi + (p_lo + 8) * BS + n) = hi;
      *reinterpret_cast<uint32_t*>(s.h_lo + (p_lo + 8) * BS + n) = lo;
    }
    __syncthreads();  // the new state is in place; buffer buf is free
  }

  float* dst = h_final + (size_t)(b * H + h) * P * N;
  const int n = 8 * nj + 2 * u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + 16 * mi_h + g + 8 * r;
    if (p < P && n < N)
      *reinterpret_cast<float2*>(dst + (size_t)p * N + n) =
          make_float2(hacc[2 * r], hacc[2 * r + 1]);
  }
}

}  // namespace tc

int launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, void* y, void* h_final, int B, int L, int H,
              int P, int G, int N, int chunk, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > PMAX || P % 8 != 0 || N <= 0 || N > NMAX || N % 8 != 0 ||
      chunk <= 0 || chunk > QMAX || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int smem = (int)sizeof(tc::Smem);
  cudaError_t err = cudaFuncSetAttribute(
      tc::ssd_scan_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tc::ssd_scan_tc<<<dim3(H, (P + tc::PS - 1) / tc::PS, B), tc::THREADS, smem,
                    (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)dt, (const float*)A,
      (const __nv_bfloat16*)Bm, (const __nv_bfloat16*)Cm, (__nv_bfloat16*)y,
      (float*)h_final, L, H, P, G, N, min(chunk, L));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mamba2_scan_f32(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* h_final,
                    int B, int L, int H, int P, int G, int N, int chunk,
                    void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, y, h_final, B, L, H, P, G, N, chunk,
                       stream);
}

int mamba2_scan_bf16(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* h_final,
                     int B, int L, int H, int P, int G, int N, int chunk,
                     void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_final, B, L, H, P, G, N,
                               chunk, stream);
}

int mamba2_scan_bf16_tc(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y,
                        void* h_final, int B, int L, int H, int P, int G,
                        int N, int chunk, void* stream) {
  return launch_tc(x, dt, A, Bm, Cm, y, h_final, B, L, H, P, G, N, chunk,
                   stream);
}

// dynamic shared memory of a ssd_scan_tc block, in bytes
int mamba2_scan_tc_smem_bytes() { return (int)sizeof(tc::Smem); }

const char* mamba2_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
