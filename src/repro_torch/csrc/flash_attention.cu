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
// What the design does about it: this first kernel is the simple, exact one
// and runs on the fp32 CUDA cores, not the tensor cores (wgmma, TMA and warp
// specialisation are later work), so it sits far above that bound. It keeps
// the work and the bytes at their minimum:
//   * one block per (batch, kv head, tile of 64 rows of the grouped query
//     matrix); a tile is 64/G query positions times the G query heads of the
//     kv head, so every K/V tile is read from HBM once for all G heads;
//   * the kv loop runs only over the key range the tile's rows can see
//     (causal upper end, window lower end): fully masked tiles are skipped,
//     not masked (the TPU kernel's :41-47);
//   * q, K and V tiles are staged through shared memory as fp32 and each
//     thread computes a 2x4 register tile of scores and a 2x16 tile of the
//     output, so shared-memory reads are float4 and conflict-free (odd row
//     stride in float4 units);
//   * a ragged last tile (S not a multiple of the tile) is masked here; the
//     TPU kernel asserted S % block == 0 (:101).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;      // rows of the grouped query matrix per block
constexpr int BK = 32;        // keys per K/V tile
constexpr int THREADS = 256;  // 32 row pairs x 8 lanes
constexpr int MAX_HD = 128;
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
// kvh * G + r % G.
template <typename T>
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
  float4 acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

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
      for (int j = 0; j < 4; ++j) {
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
      for (int j = 0; j < 4; ++j) {
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
    for (int j = 0; j < 4; ++j) {
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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int hd, float scale, int causal, int window,
           void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || H / KV > ROWS ||
      hd <= 0 || hd > MAX_HD || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const int pos_per_tile = ROWS / (H / KV);
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + pos_per_tile - 1) / pos_per_tile, KV, B);
  flash_fwd<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KV, hd,
      pos_per_tile, scale, causal, window);
  return (int)cudaGetLastError();
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

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
