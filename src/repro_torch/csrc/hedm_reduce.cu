// NF-HEDM stage-1 reduction (paper §VI-A) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hedm_reduce.py::hedm_reduce
// (_kernel :65-102, _median9 :42-56); its oracle is
// src/repro/kernels/hedm_reduce_ref.py::reference, and this kernel matches it
// bit for bit. Per pixel of every frame:
//   img = max(frame - dark, 0)                          (dark subtraction)
//   med = 3x3 median of img, edge-replicated            (19-exchange network)
//   lap = 8*med - (sum of the 8 neighbours of med)      (median edge-replicated)
//   mask = lap > threshold && med > threshold * 0.5
// plus the per-frame count of mask pixels.
//
// What bounds it: HBM bytes. At (736, 2048, 2048) float32 the kernel reads
// 12.35 GB of frames (and the 16.8 MB dark frame) and writes 3.09 GB of mask:
// 15.4 GB / 3.35 TB/s = 4.6 ms on an H100 SXM. Its ~55 fp32 min/max/add
// operations per pixel take ~2.5 ms at 67 TFLOP/s, below that.
//
// What the design does about it: one block per 32x32 output tile of one
// frame. The block reads its (32+4)^2 input halo tile once into shared
// memory, so each pixel comes from HBM once; the 2-pixel halo rows and
// columns are re-read by the four neighbouring blocks and hit L2. The median
// ring (32+2)^2 and the Laplacian work from shared memory only, and the mask
// is written once. The per-frame count is a warp-shuffle reduction and one
// integer atomicAdd per block (exact in any order).
//
// Bit-exactness: edge replication is a clamp of the global coordinate — the
// input halo reads frame and dark at the clamped coordinate, and every entry
// of the median ring is the median AT its clamped coordinate, which is the
// oracle's replicated padding of the median (hedm_reduce_ref.py:20-23). The
// Laplacian is summed left to right as the oracle writes it, with
// round-to-nearest intrinsics, and the build uses --fmad=false; 8*x is exact.
// The TPU kernel's halo rebuild (hedm_reduce.py:80-95) exists only because
// its wrapper pads the input first, and has no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;            // output tile edge, pixels
constexpr int ROWS = 8;             // blockDim.y; a thread covers TILE/ROWS rows
constexpr int THREADS = TILE * ROWS;
constexpr int IN = TILE + 4;        // input halo tile: median + Laplacian support
constexpr int MED = TILE + 2;       // median ring: Laplacian support

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

__device__ __forceinline__ void sort2(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// Median of 9 by the 19-exchange network of the TPU kernel's _median9.
__device__ __forceinline__ float median9(float* v) {
  sort2(v[1], v[2]); sort2(v[4], v[5]); sort2(v[7], v[8]);
  sort2(v[0], v[1]); sort2(v[3], v[4]); sort2(v[6], v[7]);
  sort2(v[1], v[2]); sort2(v[4], v[5]); sort2(v[7], v[8]);
  sort2(v[0], v[3]); sort2(v[5], v[8]); sort2(v[4], v[7]);
  sort2(v[3], v[6]); sort2(v[1], v[4]); sort2(v[2], v[5]);
  sort2(v[4], v[7]); sort2(v[4], v[2]); sort2(v[6], v[4]);
  sort2(v[4], v[2]);
  return v[4];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
hedm_reduce_kernel(const T* __restrict__ frames, const float* __restrict__ dark,
                   uint8_t* __restrict__ mask, int32_t* __restrict__ counts,
                   int H, int W, float threshold) {
  __shared__ float s_in[IN][IN + 1];
  __shared__ float s_med[MED][MED + 1];
  __shared__ int s_warp[THREADS / 32];

  const int f = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;
  const T* frame = frames + static_cast<size_t>(f) * plane;

  // input halo tile: s_in[r][c] = img at the clamped (y0-2+r, x0-2+c)
  for (int i = tid; i < IN * IN; i += THREADS) {
    const int r = i / IN, c = i % IN;
    const size_t off = static_cast<size_t>(clampi(y0 - 2 + r, H - 1)) * W
                       + clampi(x0 - 2 + c, W - 1);
    s_in[r][c] = fmaxf(__fsub_rn(static_cast<float>(frame[off]), dark[off]),
                       0.0f);
  }
  __syncthreads();

  // median ring: s_med[r][c] = median at the clamped (y0-1+r, x0-1+c); its
  // neighbours are img at clamped coordinates, all inside the halo tile
  for (int i = tid; i < MED * MED; i += THREADS) {
    const int r = i / MED, c = i % MED;
    const int my = clampi(y0 - 1 + r, H - 1);
    const int mx = clampi(x0 - 1 + c, W - 1);
    float v[9];
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int ly = clampi(my + dy, H - 1) - (y0 - 2);
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        v[(dy + 1) * 3 + dx + 1] = s_in[ly][clampi(mx + dx, W - 1) - (x0 - 2)];
      }
    }
    s_med[r][c] = median9(v);
  }
  __syncthreads();

  const float half = threshold * 0.5f;
  const int tx = threadIdx.x;
  const int x = x0 + tx;
  int local = 0;
  for (int i = threadIdx.y; i < TILE; i += ROWS) {
    const int y = y0 + i;
    if (y < H && x < W) {
      const float n0 = s_med[i][tx], n1 = s_med[i][tx + 1], n2 = s_med[i][tx + 2];
      const float n3 = s_med[i + 1][tx], n4 = s_med[i + 1][tx + 1];
      const float n5 = s_med[i + 1][tx + 2];
      const float n6 = s_med[i + 2][tx], n7 = s_med[i + 2][tx + 1];
      const float n8 = s_med[i + 2][tx + 2];
      // the oracle's order: 8*n4 - (((((((n0+n1)+n2)+n3)+n5)+n6)+n7)+n8)
      float s = __fadd_rn(n0, n1);
      s = __fadd_rn(s, n2);
      s = __fadd_rn(s, n3);
      s = __fadd_rn(s, n5);
      s = __fadd_rn(s, n6);
      s = __fadd_rn(s, n7);
      s = __fadd_rn(s, n8);
      const float lap = __fsub_rn(__fmul_rn(8.0f, n4), s);
      const int m = (lap > threshold) && (n4 > half);
      mask[static_cast<size_t>(f) * plane + static_cast<size_t>(y) * W + x] =
          static_cast<uint8_t>(m);
      local += m;
    }
  }

  for (int o = 16; o > 0; o >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, o);
  }
  if ((tid & 31) == 0) s_warp[tid >> 5] = local;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += s_warp[w];
    if (total) atomicAdd(counts + f, total);
  }
}

template <typename T>
int launch(const void* frames, const void* dark, void* mask, void* counts,
           int F, int H, int W, float threshold, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, F);
  const dim3 block(TILE, ROWS);
  hedm_reduce_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(frames), static_cast<const float*>(dark),
      static_cast<uint8_t*>(mask), static_cast<int32_t*>(counts), H, W,
      threshold);
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
