// Chunked Mamba2 SSD scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_scan.py::mamba2_scan
// (_kernel :25-66); its oracle is src/repro/kernels/mamba2_scan_ref.py::
// reference, the step-by-step recurrence
//   h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,
// for every head h of every batch row, with B/C shared by the H/G heads of a
// group. Per chunk of Q steps (a = dt*A, cum = its inclusive cumsum in the
// chunk) the kernel computes, all in fp32:
//   intra-chunk  y[q]  = sum_{k<=q} (C[q].B[k]) exp(cum[q]-cum[k]) dt[k] x[k]
//   carried      y[q] += exp(cum[q]) C[q] h^T
//   state        h     = exp(cum[Q-1]) h + sum_q x[q]^T (B[q] dt[q]
//                                                exp(cum[Q-1]-cum[q]))
// x (B,L,H,P), B/C (B,L,G,N) in float32 or bfloat16; dt (B,L,H) and A (H,)
// float32; y (B,L,H,P) in x's type; h_final (B,H,P,N) float32. P <= 64,
// N <= 64, chunk Q <= 128; L is any length (the last chunk may be short).
//
// What bounds it: bytes. At the zamba2-7b prefill shape, x (1, 2048, 112,
// 64) bf16 with B/C (1, 2048, 1, 64) bf16, the kernel must read 30.9 MB and
// write 31.2 MB (y and h_final): 61.9 MB, 0.0185 ms at 3.35 TB/s. Its
// 11.3 GFLOP take 0.011 ms at the bf16 tensor-core rate.
//
// What the design does about it: the TPU kept the (P,N) state in VMEM
// scratch across the sequential chunk axis of its grid (:28-31, :59-66).
// CUDA blocks run in no order, so one block per (batch row, head) loops over
// the chunks itself and keeps the state in registers (16 values a thread)
// with a copy in shared memory for the carried term. Each input byte is read
// from HBM once and each output byte written once. A chunk's x, B, C, dt and
// the (Q,Q) weight matrix live in about 180 KB of dynamic shared memory; the
// weights exp(cum[q]-cum[k]) are computed only for k <= q, where they are at
// most 1 (the masked ones would overflow). The three products run on the
// fp32 CUDA cores with register tiles (8x8, 8x4 and 4x4 a thread), not the
// tensor cores: this first kernel is the simple, exact one. A short last
// chunk is padded with zeros (dt = 0 leaves cum flat and adds nothing), so
// L needs no divisor: the reference model shrinks its chunk to a divisor of
// L (mamba2.py:119-124), which is 1 for a prime L. At batch 1 the grid has
// H = 112 blocks for the card's 132 SMs.
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
  s.total = s.vec + 4 * (size_t)Q;  // dt, cum, exp(cum), dt * decay to end
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
  float* cum = dts + Q;
  float* ecum = cum + Q;
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
      const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int u = 0; u < QMAX / 32; ++u) {
        const int r = t * (QMAX / 32) + u;
        if (r < Q) {
          const float c = base + part[u];
          cum[r] = c;
          ecum[r] = expf(c);
          wq[r] = dts[r] * expf(last - c);  // dt * decay to the chunk's end
        }
      }
    }
    __syncthreads();

    // M[q][k] = (C[q].B[k]) exp(cum[q]-cum[k]) dt[k] for k <= q, else 0;
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
              k <= q ? gacc[i][j] * expf(cum[q] - cum[k]) * dts[k] : 0.f;
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

const char* mamba2_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
