// NF-HEDM stage-1 labeling and centroids (paper §VI-A) for Hopper, sm_90a.
//
// Replaces no TPU kernel: the reference labels and weighs its spots on the
// host (src/repro/hedm/pipeline.py, label_components and the np.bincount
// centroids of reduce_frames). This kernel takes hedm_reduce's uint8 mask
// and the frames as given, on the card, and leaves per frame the number of
// signal pixels, the number of 4-connected components ("spots") and each
// spot's peak (sum v*y / sum v, sum v*x / sum v, sum v) in float32, so only
// those cross back to the host instead of the whole mask. It matches the
// host bit for bit: components are numbered by their first pixel in
// row-major order within their frame (label_components' order), and each
// spot's float64 sums are taken over its pixels in ascending pixel order,
// as np.bincount takes them, with products and sums rounded one by one
// (--fmad=false, and the _rn intrinsics), or in any order where every sum
// is an integer that float64 holds exactly.
//
// What bounds it: at 2048x2048 a frame's mask is 4 MB, the labels 16 MB
// written and read a few times; ~0.1 ms of HBM traffic at 3.35 TB/s. The
// real work is small: ~12 spots of a few hundred pixels a frame. So the
// design aims at few launches and no host round trip inside a pass, and
// at staying correct, if slower, on any mask: a full frame, a checkerboard
// (2M components), a spiral through every tile.
//
// Pass 1, hedm_label_chunk, over a chunk of whole frames (the wrapper
// chunks the stack so the scratch stays bounded), seven launches:
// * label_local: 32x32 tiles, union-find in shared memory (atomicMin links
//   the larger root under the smaller, finds halve their path), so a
//   tile's local root is its least pixel; every signal pixel's global
//   parent is written. Background slots are never written nor read: every
//   kernel after reads the mask first, so a sparse frame's labels touch
//   little more than its signal pixels (a slot left by an earlier call is
//   never looked at).
// * label_merge: the pixels on each tile's top and left border unite with
//   their neighbour across it, by the same union-find on the global array.
//   Links only ever point to a smaller index, so a component's root is its
//   least flat index in the chunk, which is its first pixel in its frame.
// * label_compress: every pixel halves its path and points at its root.
// * row_count: a warp a row counts its roots and signal pixels; the counts
//   of a frame go to the head (n_signal, n_spots) by one atomic a row.
// * scan_rows: one block scans the rows' root counts: each row's first
//   component number in the chunk.
// * rank: a warp a row numbers its roots in order and stores -(k + 1) in
//   the root's parent slot, with the component's root and first bounding
//   box (xmin, xmax, ymax).
// * relabel: every pixel walks to its root's number and keeps it; the
//   ends of each run widen the box by atomics (a run of a component lies
//   inside one row, so only its two ends can move the box).
//
// Pass 2 weighs the components, one launch chain a chunk, after the host
// has learnt the number of spots from pass 1's head and sized the peaks:
// * hedm_label_weigh_u16_exact, for uint16 weights where every sum is an
//   integer of at most 2^53 (a 2048x2048 frame's are below 2^49), so any
//   order of summation gives the host's bits: weigh_exact, a thread a
//   signal pixel, adds its v, v*y and v*x to its component's float64 sums
//   by atomics, one set a warp when the warp's pixels are all of one
//   component; then weigh_finish writes the peaks. Its cost is the mask
//   read once and, for a frame-wide spot, three same-address atomics a
//   warp of it.
// * hedm_label_weigh_{f32,f64,u16}, for the other weights: a warp a
//   component scans its bounding box in raster order, 256 pixels a batch,
//   the next batch's loads in flight; the lanes compact the batch's
//   pixels that carry the component's number into shared memory, with
//   their products v*y and v*x, and lanes 0, 1 and 2 add one moment each in
//   that order, so each sum is the host's sequential one. The scan costs
//   the box's area over 256 loads (a ring's box is most of a frame), the
//   sums one dependent add a pixel of the spot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;            // tile of label_local and label_merge
constexpr int LOCAL_THREADS = 256;  // 8 rows of a tile at a time
constexpr int ROW_WARPS = 8;        // rows a block of the row kernels
constexpr int FLAT_THREADS = 256;   // pixels a block of the flat kernels
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int WEIGH_THREADS = 128;
constexpr int BATCH_STEPS = 8;      // 32-pixel steps a batch of weigh
constexpr int BATCH = 32 * BATCH_STEPS;
constexpr unsigned FULL = 0xffffffffu;

// Union-find over `parent`, where every link points to a smaller index.
// Mem picks the memory: shared (volatile reads) or global (reads and
// writes through L2, so other blocks' links are seen).
struct Shared {
  static __device__ __forceinline__ int ld(int* p) {
    return *static_cast<volatile int*>(p);
  }
  static __device__ __forceinline__ void st(int* p, int v) {
    *static_cast<volatile int*>(p) = v;
  }
};
struct Global {
  static __device__ __forceinline__ int ld(int* p) { return __ldcg(p); }
  static __device__ __forceinline__ void st(int* p, int v) { __stcg(p, v); }
};

// The root of x; each node passed on the way is pointed at its
// grandparent (path halving). Only non-roots are written, always with an
// ancestor, so a concurrent link is never undone on a root.
template <typename Mem>
__device__ __forceinline__ int find(int* parent, int x) {
  while (true) {
    const int p = Mem::ld(parent + x);
    if (p == x) return x;
    const int g = Mem::ld(parent + p);
    if (g == p) return p;
    Mem::st(parent + x, g);
    x = g;
  }
}

// Unite the sets of a and b: the larger root is linked under the smaller
// by atomicMin; when another thread moved that root first, retry from the
// value it found (Playne and Hawick's union).
template <typename Mem>
__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find<Mem>(parent, a);
    b = find<Mem>(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void __launch_bounds__(LOCAL_THREADS)
label_local(const uint8_t* __restrict__ mask, int* __restrict__ parent, int H,
            int W) {
  __shared__ int s[TILE * TILE];
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int fbase = blockIdx.z * H * W;
  const int lx = threadIdx.x % TILE, ly0 = threadIdx.x / TILE;
  const int x = x0 + lx;
  constexpr int STEP = LOCAL_THREADS / TILE;
#pragma unroll
  for (int ly = ly0; ly < TILE; ly += STEP) {
    const int y = y0 + ly;
    const bool on = x < W && y < H && mask[fbase + y * W + x];
    s[ly * TILE + lx] = on ? ly * TILE + lx : -1;
  }
  __syncthreads();
#pragma unroll
  for (int ly = ly0; ly < TILE; ly += STEP) {
    const int li = ly * TILE + lx;
    if (Shared::ld(s + li) < 0) continue;
    if (lx > 0 && Shared::ld(s + li - 1) >= 0) unite<Shared>(s, li, li - 1);
    if (ly > 0 && Shared::ld(s + li - TILE) >= 0)
      unite<Shared>(s, li, li - TILE);
  }
  __syncthreads();
#pragma unroll
  for (int ly = ly0; ly < TILE; ly += STEP) {
    const int li = ly * TILE + lx;
    if (s[li] < 0) continue;  // background, or outside the frame
    const int r = find<Shared>(s, li);
    parent[fbase + (y0 + ly) * W + x] =
        fbase + (y0 + r / TILE) * W + x0 + r % TILE;
  }
}

// threads 0..31: the tile's top border with the row above; 32..63: its left
// border with the column to the left
__global__ void __launch_bounds__(2 * TILE)
label_merge(const uint8_t* __restrict__ mask, int* __restrict__ parent, int H,
            int W) {
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int fbase = blockIdx.z * H * W;
  const int t = threadIdx.x % TILE;
  int p, q;
  if (threadIdx.x < TILE) {
    const int x = x0 + t;
    if (y0 == 0 || x >= W) return;
    p = fbase + y0 * W + x;
    q = p - W;
  } else {
    const int y = y0 + t;
    if (x0 == 0 || y >= H) return;
    p = fbase + y * W + x0;
    q = p - 1;
  }
  if (mask[p] && mask[q]) unite<Global>(parent, p, q);
}

__global__ void __launch_bounds__(FLAT_THREADS)
label_compress(const uint8_t* __restrict__ mask, int* __restrict__ parent,
               int N) {
  const int p = blockIdx.x * FLAT_THREADS + threadIdx.x;
  if (p >= N || !mask[p]) return;
  const int v = Global::ld(parent + p);
  if (v == p) return;
  const int r = find<Global>(parent, p);
  if (Global::ld(parent + p) != r) Global::st(parent + p, r);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * ROW_WARPS)
row_count(const uint8_t* __restrict__ mask, const int* __restrict__ parent,
          int H, int W, int R, int* __restrict__ row_roots,
          int* __restrict__ n_signal, int* __restrict__ n_spots) {
  const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (row >= R) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int base = row * W;
  int roots = 0, sig = 0;
  for (int x = lane; x < W; x += 32) {
    if (!mask[base + x]) continue;
    ++sig;
    roots += parent[base + x] == base + x;
  }
  roots = warp_sum(roots);
  sig = warp_sum(sig);
  if (lane == 0) {
    row_roots[row] = roots;
    const int f = row / H;
    if (n_signal && sig) atomicAdd(n_signal + f, sig);
    if (n_spots && roots) atomicAdd(n_spots + f, roots);
  }
}

// exclusive scan of a[0..R) in place, one block
__global__ void __launch_bounds__(SCAN_THREADS) scan_rows(int* a, int R) {
  __shared__ int warp_tot[SCAN_THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int carry = 0;
  for (int t0 = 0; t0 < R; t0 += SCAN_THREADS * SCAN_ITEMS) {
    const int i0 = t0 + threadIdx.x * SCAN_ITEMS;
    int v[SCAN_ITEMS], sum = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      v[j] = i0 + j < R ? a[i0 + j] : 0;
      sum += v[j];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += n;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += n;
      }
      warp_tot[lane] = w;
    }
    __syncthreads();
    int run = carry + (warp ? warp_tot[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (i0 + j < R) a[i0 + j] = run;
      run += v[j];
    }
    carry += warp_tot[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
}

struct Comps {
  int *root, *xmin, *xmax, *ymax;
};

__global__ void __launch_bounds__(32 * ROW_WARPS)
rank(const uint8_t* __restrict__ mask, int* __restrict__ parent,
     const int* __restrict__ row_first, int H, int W, int R, Comps c) {
  const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (row >= R) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int base = row * W, y = row % H;
  int k0 = row_first[row];
  for (int x0 = 0; x0 < W; x0 += 32) {
    const int x = x0 + lane;
    const bool root =
        x < W && mask[base + x] && parent[base + x] == base + x;
    const unsigned bits = __ballot_sync(FULL, root);
    if (root) {
      const int k = k0 + __popc(bits & ((1u << lane) - 1));
      parent[base + x] = -(k + 1);
      c.root[k] = base + x;
      c.xmin[k] = x;
      c.xmax[k] = x;
      c.ymax[k] = y;
    }
    k0 += __popc(bits);
  }
}

__global__ void __launch_bounds__(FLAT_THREADS)
relabel(const uint8_t* __restrict__ mask, int* __restrict__ parent, int H,
        int W, int N, Comps c) {
  const int p = blockIdx.x * FLAT_THREADS + threadIdx.x;
  if (p >= N || !mask[p]) return;
  int v = Global::ld(parent + p);
  if (v < 0) return;  // a root: numbered by rank
  while (v >= 0) v = Global::ld(parent + v);
  Global::st(parent + p, v);
  const int k = -v - 1;
  const int row = p / W, x = p - row * W;
  if (x == 0 || !mask[p - 1]) {  // a run starts here
    atomicMin(c.xmin + k, x);
    atomicMax(c.ymax + k, row % H);
  }
  if (x == W - 1 || !mask[p + 1]) atomicMax(c.xmax + k, x);  // a run ends
}

// The peak of a component from its float64 sums, as the host computes it.
__device__ __forceinline__ void put_peak(float* peaks, int k, double si,
                                         double sy, double sx) {
  const double d = si < 1e-9 ? 1e-9 : si;  // np.maximum(s_i, 1e-9), NaN kept
  peaks[3 * k] = __double2float_rn(__ddiv_rn(sy, d));
  peaks[3 * k + 1] = __double2float_rn(__ddiv_rn(sx, d));
  peaks[3 * k + 2] = __double2float_rn(si);
}

// A warp a component, its sums in ascending pixel order (the source note).
template <typename T>
__global__ void __launch_bounds__(WEIGH_THREADS)
weigh(const uint8_t* __restrict__ mask, const T* __restrict__ frames,
      const int* __restrict__ parent, Comps c, int H, int W, int K,
      float* __restrict__ peaks) {
  __shared__ double staged[WEIGH_THREADS / 32][3][BATCH + 1];  // +1: banks
  const int k = blockIdx.x * (WEIGH_THREADS / 32) + threadIdx.x / 32;
  if (k >= K) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int plane = H * W;
  const int root = c.root[k];
  const int f = root / plane;
  const int ya = (root - f * plane) / W, xa = c.xmin[k];
  const int bw = c.xmax[k] - xa + 1;
  const int area = (c.ymax[k] - ya + 1) * bw;
  const int tag = -(k + 1);
  const uint8_t* on_mask = mask + static_cast<size_t>(f) * plane;
  const int* lab = parent + f * plane;
  const T* val = frames + static_cast<size_t>(f) * plane;
  double(*buf)[BATCH + 1] = staged[threadIdx.x / 32];
  int lv[BATCH_STEPS];
  T vv[BATCH_STEPS];
  auto load = [&](int i0) {
#pragma unroll
    for (int j = 0; j < BATCH_STEPS; ++j) {
      const int i = i0 + 32 * j + lane;
      const int p = i < area ? (ya + i / bw) * W + xa + i % bw : 0;
      const bool in = i < area;  // three loads in flight at once
      const uint8_t m = in ? on_mask[p] : 0;
      const int l = in ? lab[p] : 0;
      vv[j] = in ? val[p] : T(0);
      lv[j] = m ? l : 0;  // 0: never a tag; a background slot is not used
    }
  };
  double acc = 0.0;  // lane m < 3: moment m (s_i, s_y, s_x)
  load(0);
  for (int i0 = 0; i0 < area; i0 += BATCH) {
    int n = 0;
#pragma unroll
    for (int j = 0; j < BATCH_STEPS; ++j) {
      const bool on = lv[j] == tag;
      const unsigned bits = __ballot_sync(FULL, on);
      if (on) {
        const int i = i0 + 32 * j + lane;
        const int at = n + __popc(bits & ((1u << lane) - 1));
        const double w = static_cast<double>(vv[j]);
        buf[0][at] = w;
        buf[1][at] = __dmul_rn(w, static_cast<double>(ya + i / bw));
        buf[2][at] = __dmul_rn(w, static_cast<double>(xa + i % bw));
      }
      n += __popc(bits);
    }
    __syncwarp();
    load(i0 + BATCH);  // in flight while the sums run
    if (lane < 3) {  // the loads of 8 terms, then their 8 dependent adds
      const double* b = buf[lane];
      int q = 0;
      for (; q + 8 <= n; q += 8) {
        double t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = b[q + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = __dadd_rn(acc, t[u]);
      }
      for (; q < n; ++q) acc = __dadd_rn(acc, b[q]);
    }
    __syncwarp();
  }
  const double si = __shfl_sync(FULL, acc, 0);
  const double sy = __shfl_sync(FULL, acc, 1);
  const double sx = __shfl_sync(FULL, acc, 2);
  if (lane == 0) put_peak(peaks, k, si, sy, sx);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// A thread a pixel of the chunk; sums (K, 3) zeroed before. Every value
// here is an integer below 2^53, so the atomics' order leaves the bits.
__global__ void __launch_bounds__(FLAT_THREADS)
weigh_exact(const uint8_t* __restrict__ mask,
            const uint16_t* __restrict__ frames,
            const int* __restrict__ parent, int H, int W, int N,
            double* __restrict__ sums) {
  const int p = blockIdx.x * FLAT_THREADS + threadIdx.x;
  const bool on = p < N && mask[p];
  const unsigned bits = __ballot_sync(FULL, on);
  if (!bits) return;  // the whole warp
  int k = -1;
  double w = 0.0, wy = 0.0, wx = 0.0;
  if (on) {
    k = -parent[p] - 1;
    const int pix = p % (H * W), y = pix / W;
    w = static_cast<double>(frames[p]);
    wy = w * static_cast<double>(y);
    wx = w * static_cast<double>(pix - y * W);
  }
  const int k0 = __shfl_sync(FULL, k, __ffs(bits) - 1);
  if (__all_sync(FULL, !on || k == k0)) {
    w = warp_sum(w);
    wy = warp_sum(wy);
    wx = warp_sum(wx);
    if (threadIdx.x % 32) return;
    k = k0;
  } else if (!on) {
    return;
  }
  atomicAdd(sums + 3 * k, w);
  atomicAdd(sums + 3 * k + 1, wy);
  atomicAdd(sums + 3 * k + 2, wx);
}

__global__ void __launch_bounds__(FLAT_THREADS)
weigh_finish(const double* __restrict__ sums, int K,
             float* __restrict__ peaks) {
  const int k = blockIdx.x * FLAT_THREADS + threadIdx.x;
  if (k < K) put_peak(peaks, k, sums[3 * k], sums[3 * k + 1], sums[3 * k + 2]);
}

// The chunk's scratch, int32: parent[N] | row_first[R] | root, xmin, xmax,
// ymax [cap each], cap = F * ceil(H * W / 2), the most 4-connected
// components F frames can hold.
struct Scratch {
  int* parent;
  int* rows;
  Comps c;
  Scratch(void* base, int F, int H, int W) {
    const size_t N = static_cast<size_t>(F) * H * W;
    const size_t cap = static_cast<size_t>(F) * ((static_cast<size_t>(H) * W
                                                   + 1) / 2);
    parent = static_cast<int*>(base);
    rows = parent + N;
    c.root = rows + static_cast<size_t>(F) * H;
    c.xmin = c.root + cap;
    c.xmax = c.xmin + cap;
    c.ymax = c.xmax + cap;
  }
};

bool bad_shape(int F, int H, int W) {
  return F <= 0 || H <= 0 || W <= 0 || F > 65535 ||
         static_cast<long long>(F) * H * W > (1LL << 30);
}

template <typename T>
int launch_weigh(const void* mask, const void* frames, int F, int H, int W,
                 void* scratch, int K, void* peaks, void* stream) {
  if (bad_shape(F, H, W) || K < 0) return cudaErrorInvalidValue;
  if (K == 0) return 0;
  Scratch s(scratch, F, H, W);
  constexpr int per_block = WEIGH_THREADS / 32;
  weigh<T><<<(K + per_block - 1) / per_block, WEIGH_THREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const T*>(frames),
      s.parent, s.c, H, W, K, static_cast<float*>(peaks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. All buffers are contiguous device buffers;
// every launch goes on `stream` without synchronising, and each function
// returns cudaGetLastError() (0 on success).
//
// Pass 1 over a chunk of F frames: mask (F,H,W) uint8 (0 or not), scratch of
// N + F*H + 4*cap int32 (struct Scratch); adds each frame's signal pixels and
// components to n_signal[f] and n_spots[f], which the caller zeroes (null:
// not counted).
extern "C" int hedm_label_chunk(const void* mask, int F, int H, int W,
                                void* scratch, void* n_signal, void* n_spots,
                                void* stream) {
  if (bad_shape(F, H, W)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  Scratch s(scratch, F, H, W);
  const int N = F * H * W, R = F * H;
  const dim3 tiles((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, F);
  const int flat = (N + FLAT_THREADS - 1) / FLAT_THREADS;
  const int rows = (R + ROW_WARPS - 1) / ROW_WARPS;
  label_local<<<tiles, LOCAL_THREADS, 0, st>>>(m, s.parent, H, W);
  label_merge<<<tiles, 2 * TILE, 0, st>>>(m, s.parent, H, W);
  label_compress<<<flat, FLAT_THREADS, 0, st>>>(m, s.parent, N);
  row_count<<<rows, 32 * ROW_WARPS, 0, st>>>(
      m, s.parent, H, W, R, s.rows, static_cast<int*>(n_signal),
      static_cast<int*>(n_spots));
  scan_rows<<<1, SCAN_THREADS, 0, st>>>(s.rows, R);
  rank<<<rows, 32 * ROW_WARPS, 0, st>>>(m, s.parent, s.rows, H, W, R, s.c);
  relabel<<<flat, FLAT_THREADS, 0, st>>>(m, s.parent, H, W, N, s.c);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 over the same chunk, its scratch as pass 1 left it: the chunk's
// mask, frames (F,H,W) as given, K the chunk's components (the sum of its
// n_spots); writes the
// (K, 3) float32 peaks at `peaks`, in component order, the sums in
// ascending pixel order.
extern "C" int hedm_label_weigh_f32(const void* mask, const void* frames,
                                    int F, int H, int W, void* scratch, int K,
                                    void* peaks, void* stream) {
  return launch_weigh<float>(mask, frames, F, H, W, scratch, K, peaks,
                           stream);
}

extern "C" int hedm_label_weigh_f64(const void* mask, const void* frames,
                                    int F, int H, int W, void* scratch, int K,
                                    void* peaks, void* stream) {
  return launch_weigh<double>(mask, frames, F, H, W, scratch, K, peaks,
                           stream);
}

extern "C" int hedm_label_weigh_u16(const void* mask, const void* frames,
                                    int F, int H, int W, void* scratch, int K,
                                    void* peaks, void* stream) {
  return launch_weigh<uint16_t>(mask, frames, F, H, W, scratch, K, peaks,
                           stream);
}

// Pass 2 for uint16 frames where every sum is exact (the caller checks:
// 65535 * max(H, W) * H * W <= 2^53): also sums, room for (K, 3) float64,
// which this zeroes on the stream.
extern "C" int hedm_label_weigh_u16_exact(const void* mask, const void* frames,
                                          int F, int H, int W, void* scratch,
                                          int K, void* sums, void* peaks,
                                          void* stream) {
  if (bad_shape(F, H, W) || K < 0) return cudaErrorInvalidValue;
  if (K == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch s(scratch, F, H, W);
  const int N = F * H * W;
  double* sum = static_cast<double*>(sums);
  const int err = static_cast<int>(
      cudaMemsetAsync(sum, 0, sizeof(double) * 3 * static_cast<size_t>(K),
                      st));
  if (err) return err;
  weigh_exact<<<(N + FLAT_THREADS - 1) / FLAT_THREADS, FLAT_THREADS, 0, st>>>(
      static_cast<const uint8_t*>(mask), static_cast<const uint16_t*>(frames),
      s.parent, H, W, N, sum);
  weigh_finish<<<(K + FLAT_THREADS - 1) / FLAT_THREADS, FLAT_THREADS, 0, st>>>(
      sum, K, static_cast<float*>(peaks));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hedm_label_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
