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
// What bounds it: operations. At the rwkv6-3b prefill shape, r/k/v
// (1, 2048, 40, 64) bf16 and w float32, the kernel must read 52.4 MB and
// write 11.1 MB (out and s_final): 63.6 MB, 0.019 ms at 3.35 TB/s. Its
// fp32 work is about 24 thousand operations a token and head at Q = 32,
// two (N,N) contractions (the carried term and the state update, 4 N^2) and
// the pairwise scores with their exps and their product with v (about
// 7 N (Q-1)/2): 2.0 G operations, 0.030 ms at the card's 67 TFLOP/s of
// fp32 (chip_smoke.py, wkv_ops, counts them). The state is fp32 and the contractions read it as such, so the
// fp32 rate, not the bf16 tensor-core rate, is the one that applies.
//
// What the design does about it: the TPU kept the (N,N) state in VMEM
// scratch across the sequential chunk axis of its grid (:26-28, :54, :62).
// CUDA blocks run in no order, so one block per (batch row, head) loops over
// the chunks itself and keeps the state in registers (16 values a thread)
// with a copy in shared memory for the carried term. Each input byte is read
// from HBM once and each output byte written once. The TPU kernel built the
// (Q,Q,N) pairwise decay tensor, 256 KB at Q = 32 and N = 64, more than a
// block's shared memory; here each score sums its N channels in a loop,
// computing exp(lprev[q][i] - lcum[j][i]) as it goes. Every exponent taken
// is <= 0: splitting it into exp(lprev) exp(-lcum) would overflow fp32
// within a few steps of strong decay (w = 1e-20 gives lw = -46 a step). A
// chunk's tiles take about 63 KB of dynamic shared memory at Q = 32. All
// products run on the fp32 CUDA cores: this first kernel is the simple,
// exact one. A short last chunk is padded (k = v = r = 0, w = 1: nothing is
// added to the state and the decay is unchanged), so L needs no divisor;
// the TPU wrapper shrank its chunk to a divisor of L (:73-75), which is 1 for
// a prime L. At batch 1 the grid has H = 40 blocks for the card's 132 SMs;
// the recurrence is independent across value channels n, so a later kernel
// can split n over several blocks per head.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

const char* rwkv6_wkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
