// NF-HEDM stage-1 reduction (paper §VI-A) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hedm_reduce.py::hedm_reduce
// (_kernel :65-102, _median9 :42-56); its oracle is
// src/repro/kernels/hedm_reduce_ref.py::reference, and this kernel matches it
// bit for bit. Per pixel of every frame:
//   img = max(frame - dark, 0)                          (dark subtraction)
//   med = 3x3 median of img, edge-replicated
//   lap = 8*med - (sum of the 8 neighbours of med)      (median edge-replicated)
//   mask = lap > threshold && med > threshold * 0.5
// plus the per-frame count of mask pixels.
//
// What bounds it: the bytes are 12.35 GB of frames read (and the 16.8 MB dark
// frame, from L2 for every frame) and 3.09 GB of mask written at (736, 2048,
// 2048) float32: 15.4 GB / 3.35 TB/s = 4.6 ms on an H100 SXM. The first port
// took 23.3 ms there (H100 80GB HBM3, 700 W), bound by instructions: 32x32
// tiles in three phases split by barriers, a division, a modulo and two
// clamps per halo element, the 19-exchange median network (38 min/max) with
// four clamps and nine shared loads per median on 1.13x the pixels, and
// one-byte stores: ~110-130 instructions a pixel, ~11-13 ms of issue on the
// card's ~30 T lane-instructions/s before any stall.
//
// What this design does about it: fewer instructions a pixel, no shared
// memory and no barrier but the count's.
// * Register strips. A thread owns SW = 8 adjacent columns (32 bytes of a
//   float32 frame, 16 of uint16) and walks down a band of TH = 128 rows. A
//   warp covers 32 SW columns; the two columns of halo on each side come
//   from the neighbouring lanes by shuffles (lanes 0 and 31 load theirs).
//   Rows roll through three-row rings in registers, unrolled by 3 so that
//   no value is moved: one frame row is read per output row, and each
//   median is computed once and used by the three Laplacian rows that need
//   it. A strip of 8 computes 10 medians from 12 sorted columns for 8 pixels,
//   where a strip of 4 computes 6 from 8 for 4. Strips of 8 in bands of
//   128 rows ran fastest on the card of strips 4 and 8 by bands of 32, 64
//   and 128; the shape is fixed here.
// * The median from sorted columns. Each 3-row column is sorted once (3
//   exchanges, 6 min/max) and shared by the three medians that use it; a
//   median is then med3(max of the lows, med3 of the mids, min of the highs),
//   12 min/max. The median of 9 is an order statistic, so this selects the
//   value the oracle's network selects; with no NaN in the input the only
//   freedom is the sign of a zero, which no compare and no count can see.
// * Wide access. Frames and dark come in by 16-byte loads where the strip's
//   rows are aligned to its width (W % SW == 0), the buffers start on
//   16-byte boundaries and the strip lies inside the frame; the mask goes
//   out in 8-byte stores. Strips that cross the right border, unaligned
//   widths and buffers that start off a 16-byte boundary (a view with a
//   storage offset) take a scalar path in the same kernel. Interior lanes
//   clamp nothing.
// * Overlap. The next frame row's loads are issued before this row is
//   computed; blocks of 4 warps (4 bands of one column strip) keep several
//   rows in flight on every SM.
//
// Bit-exactness: edge replication is a clamp of the global coordinate. img is
// read at clamped coordinates; the median at a coordinate outside the frame
// is the median at the clamped one (the oracle replicates the computed
// median, hedm_reduce_ref.py:20-23): the out-of-frame median rows and
// columns are copies of the border's. The Laplacian is summed left to right
// as the oracle writes it, with round-to-nearest intrinsics, and the build
// uses --fmad=false; 8*x is exact. The TPU kernel's halo rebuild
// (hedm_reduce.py:80-95) exists only because its wrapper pads the input
// first, and has no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SW = 8;      // columns a thread (32 B of float32, 16 of uint16)
constexpr int WARPS = 4;   // bands of one column strip a block
constexpr int TH = 128;    // output rows a warp
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

__device__ __forceinline__ float min3(float a, float b, float c) {
  return fminf(fminf(a, b), c);
}
__device__ __forceinline__ float max3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}
__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

__device__ __forceinline__ float img_of(float f, float d) {
  return fmaxf(__fsub_rn(f, d), 0.0f);
}

// SW frame values and SW dark values of one row, by 16-byte loads
__device__ __forceinline__ void load_vec(const float* f, const float* d,
                                         float (&fv)[SW], float (&dv)[SW]) {
#pragma unroll
  for (int i = 0; i < SW / 4; ++i) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(f) + i);
    const float4 b = __ldg(reinterpret_cast<const float4*>(d) + i);
    fv[4 * i] = a.x; fv[4 * i + 1] = a.y; fv[4 * i + 2] = a.z;
    fv[4 * i + 3] = a.w;
    dv[4 * i] = b.x; dv[4 * i + 1] = b.y; dv[4 * i + 2] = b.z;
    dv[4 * i + 3] = b.w;
  }
}
__device__ __forceinline__ void load_vec(const uint16_t* f, const float* d,
                                         float (&fv)[SW], float (&dv)[SW]) {
  static_assert(SW % 8 == 0, "uint16 strips come in 16-byte pieces");
#pragma unroll
  for (int i = 0; i < SW / 8; ++i) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(f) + i);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fv[8 * i + 2 * j] = static_cast<float>(w[j] & 0xffffu);
      fv[8 * i + 2 * j + 1] = static_cast<float>(w[j] >> 16);
    }
  }
#pragma unroll
  for (int i = 0; i < SW / 4; ++i) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(d) + i);
    dv[4 * i] = b.x; dv[4 * i + 1] = b.y; dv[4 * i + 2] = b.z;
    dv[4 * i + 3] = b.w;
  }
}

// One frame row as loaded (before the subtraction): this lane's SW columns
// and, for lanes 0 and 31, the two halo columns beyond the warp.
struct Raw {
  float f[SW], d[SW];
  float hf[2], hd[2];
};

template <typename T>
struct Band {
  const T* frame;
  const float* dark;
  int H, W, x0, hx, lane;  // hx: first halo column of lanes 0 and 31
  bool vec;                // this lane's strip: 16-byte loads

  __device__ __forceinline__ void load(int y, Raw& raw) const {
    const size_t rowoff = static_cast<size_t>(y) * W;
    if (vec) {
      load_vec(frame + rowoff + x0, dark + rowoff + x0, raw.f, raw.d);
    } else {
#pragma unroll
      for (int c = 0; c < SW; ++c) {
        const size_t off = rowoff + min(x0 + c, W - 1);
        raw.f[c] = static_cast<float>(__ldg(frame + off));
        raw.d[c] = __ldg(dark + off);
      }
    }
    if (lane == 0 || lane == 31) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t off = rowoff + clampi(hx + c, W - 1);
        raw.hf[c] = static_cast<float>(__ldg(frame + off));
        raw.hd[c] = __ldg(dark + off);
      }
    }
  }

  // img over columns x0 - 2 .. x0 + SW + 1
  __device__ __forceinline__ void img(const Raw& raw,
                                      float (&v)[SW + 4]) const {
#pragma unroll
    for (int c = 0; c < SW; ++c) v[c + 2] = img_of(raw.f[c], raw.d[c]);
    const float h0 = img_of(raw.hf[0], raw.hd[0]);
    const float h1 = img_of(raw.hf[1], raw.hd[1]);
    const float l0 = __shfl_up_sync(0xffffffffu, v[SW], 1);
    const float l1 = __shfl_up_sync(0xffffffffu, v[SW + 1], 1);
    const float r0 = __shfl_down_sync(0xffffffffu, v[2], 1);
    const float r1 = __shfl_down_sync(0xffffffffu, v[3], 1);
    v[0] = lane == 0 ? h0 : l0;
    v[1] = lane == 0 ? h1 : l1;
    v[SW + 2] = lane == 31 ? h0 : r0;
    v[SW + 3] = lane == 31 ? h1 : r1;
  }

  // the medians at columns x0 - 1 .. x0 + SW of the img rows a, b, c
  // (rows m - 1, m, m + 1); those at columns outside the frame are copies of
  // the border's
  __device__ __forceinline__ void medians(const float (&a)[SW + 4],
                                          const float (&b)[SW + 4],
                                          const float (&c)[SW + 4],
                                          float (&med)[SW + 2]) const {
    float lo[SW + 4], mi[SW + 4], hi[SW + 4];
#pragma unroll
    for (int x = 0; x < SW + 4; ++x) {
      const float p = fminf(a[x], b[x]), q = fmaxf(a[x], b[x]);
      lo[x] = fminf(p, c[x]);
      const float r = fmaxf(p, c[x]);
      mi[x] = fminf(q, r);
      hi[x] = fmaxf(q, r);
    }
#pragma unroll
    for (int p = 0; p < SW + 2; ++p)
      med[p] = med3(max3(lo[p], lo[p + 1], lo[p + 2]),
                    med3(mi[p], mi[p + 1], mi[p + 2]),
                    min3(hi[p], hi[p + 1], hi[p + 2]));
    if (x0 == 0) med[0] = med[1];
    if (x0 + SW >= W) {  // the column W - 1 is at position W - x0
      const int pw = W - x0;
      float e = med[0];
#pragma unroll
      for (int p = 0; p < SW + 2; ++p)
        if (p == pw) e = med[p];
#pragma unroll
      for (int p = 0; p < SW + 2; ++p)
        if (p > pw) med[p] = e;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
hedm_reduce_kernel(const T* __restrict__ frames,
                   const float* __restrict__ dark, uint8_t* __restrict__ mask,
                   int32_t* __restrict__ counts, int H, int W,
                   float threshold, bool aligned) {
  __shared__ int s_warp[WARPS];
  const int f = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t plane = static_cast<size_t>(H) * W;
  const int X0 = blockIdx.x * 32 * SW;  // the warp's first column
  Band<T> band;
  band.frame = frames + static_cast<size_t>(f) * plane;
  band.dark = dark;
  band.H = H;
  band.W = W;
  band.lane = lane;
  band.x0 = X0 + SW * lane;
  band.hx = lane == 0 ? X0 - 2 : X0 + 32 * SW;
  band.vec = aligned && W % SW == 0 && band.x0 + SW <= W;
  const int x0 = band.x0;
  const bool store_vec = band.vec;
  uint8_t* mrow = mask + static_cast<size_t>(f) * plane + x0;

  const float half = threshold * 0.5f;
  int local = 0;
  const int Y0 = (blockIdx.y * WARPS + warp) * TH;
  if (Y0 < H) {
    // virtual median rows m = Y0 - 1 .. m_end; row m reads img rows m - 1,
    // m, m + 1 at clamped coordinates; output row m - 1 once m > Y0
    const int m_end = min(Y0 + TH, H);
    float I0[SW + 4], I1[SW + 4], I2[SW + 4];  // img rows, a ring of three
    float M0[SW + 2], M1[SW + 2], M2[SW + 2];  // median rows, likewise
    Raw nxt;
    band.load(clampi(Y0 - 2, H - 1), nxt);
    band.img(nxt, I1);
    band.load(clampi(Y0 - 1, H - 1), nxt);
    band.img(nxt, I2);
    band.load(clampi(Y0, H - 1), nxt);

    // one virtual row m: the newest img row goes into `in`, the newest
    // median row into `mn`; (a, b, in) are img rows m - 1, m, m + 1 and
    // (up, mid, mn) median rows m - 2, m - 1, m
    auto step = [&](int m, float (&a)[SW + 4], float (&b)[SW + 4],
                    float (&in)[SW + 4], float (&up)[SW + 2],
                    float (&mid)[SW + 2], float (&mn)[SW + 2]) {
      band.img(nxt, in);
      band.load(clampi(m + 2, H - 1), nxt);  // in flight during this row
      band.medians(a, b, in, mn);
      // rows outside the frame: copies of the border's median row
      if (m == 0) {
#pragma unroll
        for (int p = 0; p < SW + 2; ++p) mid[p] = mn[p];
      }
      if (m == H) {
#pragma unroll
        for (int p = 0; p < SW + 2; ++p) mn[p] = mid[p];
      }
      if (m <= Y0) return;
      const int y = m - 1;
      uint32_t bits[SW / 4] = {};
#pragma unroll
      for (int c = 0; c < SW; ++c) {
        // the oracle's order: 8*n4 - (((((((n0+n1)+n2)+n3)+n5)+n6)+n7)+n8)
        float s = __fadd_rn(up[c], up[c + 1]);
        s = __fadd_rn(s, up[c + 2]);
        s = __fadd_rn(s, mid[c]);
        s = __fadd_rn(s, mid[c + 2]);
        s = __fadd_rn(s, mn[c]);
        s = __fadd_rn(s, mn[c + 1]);
        s = __fadd_rn(s, mn[c + 2]);
        const float n4 = mid[c + 1];
        const float lap = __fsub_rn(__fmul_rn(8.0f, n4), s);
        const uint32_t on = (lap > threshold) && (n4 > half);
        bits[c / 4] |= on << (8 * (c % 4));
      }
      uint8_t* out = mrow + static_cast<size_t>(y) * W;
      if (store_vec) {
        static_assert(SW == 8, "one 8-byte mask store a row");
        *reinterpret_cast<uint2*>(out) = make_uint2(bits[0], bits[1]);
#pragma unroll
        for (int i = 0; i < SW / 4; ++i) local += __popc(bits[i]);
      } else {
#pragma unroll
        for (int c = 0; c < SW; ++c) {
          if (x0 + c < W) {
            const uint32_t on = (bits[c / 4] >> (8 * (c % 4))) & 1u;
            out[c] = static_cast<uint8_t>(on);
            local += on;
          }
        }
      }
    };

    for (int m = Y0 - 1; m <= m_end; m += 3) {
      step(m, I1, I2, I0, M1, M2, M0);
      if (m + 1 > m_end) break;
      step(m + 1, I2, I0, I1, M2, M0, M1);
      if (m + 2 > m_end) break;
      step(m + 2, I0, I1, I2, M0, M1, M2);
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, o);
  if (lane == 0) s_warp[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += s_warp[w];
    if (total) atomicAdd(counts + f, total);
  }
}

template <typename T>
int launch(const void* frames, const void* dark, void* mask, void* counts,
           int F, int H, int W, float threshold, void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || F > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the 16-byte loads and 8-byte stores need the buffers on those boundaries
  const uintptr_t inputs = reinterpret_cast<uintptr_t>(frames) |
                           reinterpret_cast<uintptr_t>(dark);
  const bool aligned =
      inputs % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 8 == 0;
  constexpr int cols = 32 * SW;
  const dim3 grid((W + cols - 1) / cols, (H + WARPS * TH - 1) / (WARPS * TH),
                  F);
  hedm_reduce_kernel<T><<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(frames), static_cast<const float*>(dark),
      static_cast<uint8_t*>(mask), static_cast<int32_t*>(counts), H, W,
      threshold, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. frames (F,H,W), dark (H,W) float32, mask
// (F,H,W) uint8 and counts (F,) int32 are contiguous device buffers; counts
// must be zeroed by the caller. Launches on `stream` without synchronising
// and returns cudaGetLastError() (0 on success).
extern "C" int hedm_reduce_f32(const void* frames, const void* dark, void* mask,
                               void* counts, int F, int H, int W,
                               float threshold, void* stream) {
  return launch<float>(frames, dark, mask, counts, F, H, W, threshold, stream);
}

extern "C" int hedm_reduce_u16(const void* frames, const void* dark, void* mask,
                               void* counts, int F, int H, int W,
                               float threshold, void* stream) {
  return launch<uint16_t>(frames, dark, mask, counts, F, H, W, threshold,
                          stream);
}

extern "C" const char* hedm_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
