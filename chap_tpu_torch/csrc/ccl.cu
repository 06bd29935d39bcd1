// K2: batched largest-connected-component cleanup of label maps, for Hopper.
//
// Replaces chap_tpu/semi/nms.py::_label_mask_batch (:118-182) and
// _largest_id_sort (:221-243), driven by largest_cc_batch (:257-270). There
// the labelling is an XLA while_loop of window max-propagations, sweeps and
// pointer jumps that tests for convergence every round; run eagerly it would
// synchronise with the host every round in the middle of the train step.
//
// What it computes: for segmentation maps seg [B, H, W] and classes
// c = 1..C-1, the (C-1)*B masks seg == c (mask m = (c-1)*B + b). Each mask's
// 8-connected components are labelled by their largest linear index; the
// component with the most pixels is kept, ties going to the smallest label;
// out[b] = c on the kept pixels, 0 elsewhere. Exactly chap_tpu's result.
//
// What bounds it on the H100: at the main path's 24 maps of 256^2 the data
// is 6.3 MB of int32 labels in and 6.3 MB out (3.8 us at 3.35 TB/s); the
// union-find itself is a few passes over 4.7 M pixels of scratch. The
// design keeps every pass on the device with no host round trip:
//   1. init      parent[g] = g on foreground, -1 elsewhere; sizes and out 0
//   2. merge     union with the 4 backward neighbours (W, NW, N, NE); a root
//                is linked toward the LARGER index with atomicCAS, so parent
//                indices only grow and every root is its component's max
//   3. compress  parent[g] = root(g), then atomicAdd of 1 on the root's size
//   4. select    one block per mask: argmax of (size, -label) as a 64-bit key
//                in a warp shuffle and a shared-memory atomicMax, then write
//                the kept pixels into out
// Reads during merge bypass L1 (__ldcg): other SMs link roots concurrently.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int find_root(const int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  while (a != b) {
    const int lo = a < b ? a : b;
    const int hi = a < b ? b : a;
    const int old = atomicCAS(parent + lo, lo, hi);
    if (old == lo) return;  // lo now points at hi
    // lo was linked elsewhere meanwhile: join hi with lo's new tree
    a = find_root(parent, old);
    b = find_root(parent, hi);
  }
}

__global__ void ccl_init(const int* __restrict__ seg, int* __restrict__ parent,
                         int* __restrict__ size, int* __restrict__ out,
                         int batch, int hw, int total) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int m = g / hw;
  const int p = g - m * hw;
  const int cls = m / batch + 1;
  const int b = m - (cls - 1) * batch;
  parent[g] = seg[b * hw + p] == cls ? g : -1;
  size[g] = 0;
  if (m < batch) out[g] = 0;  // the class-1 masks cover out once
}

__global__ void ccl_merge(const int* __restrict__ seg, int* parent, int batch,
                          int h, int w, int total) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int hw = h * w;
  const int m = g / hw;
  const int p = g - m * hw;
  const int cls = m / batch + 1;
  const int b = m - (cls - 1) * batch;
  const int* row = seg + b * hw;
  if (row[p] != cls) return;
  const int y = p / w;
  const int x = p - y * w;
  if (x > 0 && row[p - 1] == cls) unite(parent, g, g - 1);
  if (y > 0) {
    if (x > 0 && row[p - w - 1] == cls) unite(parent, g, g - w - 1);
    if (row[p - w] == cls) unite(parent, g, g - w);
    if (x + 1 < w && row[p - w + 1] == cls) unite(parent, g, g - w + 1);
  }
}

__global__ void ccl_compress(int* parent, int* size, int total) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  if (__ldcg(parent + g) < 0) return;
  const int r = find_root(parent, g);
  parent[g] = r;
  atomicAdd(size + r, 1);
}

__global__ void ccl_select(const int* __restrict__ parent,
                           const int* __restrict__ size, int* __restrict__ out,
                           int batch, int hw) {
  const int m = blockIdx.x;
  const int base = m * hw;
  const int cls = m / batch + 1;
  const int b = m - (cls - 1) * batch;
  unsigned long long best = 0ull;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const int g = base + p;
    if (parent[g] == g) {
      const unsigned long long key =
          (static_cast<unsigned long long>(size[g]) << 32) |
          static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned>(p));
      best = key > best ? key : best;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xffffffffu, best, o);
    best = other > best ? other : best;
  }
  __shared__ unsigned long long block_best;
  if (threadIdx.x == 0) block_best = 0ull;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicMax(&block_best, best);
  __syncthreads();
  best = block_best;
  if (best == 0ull) return;  // no foreground in this mask
  const int root =
      base + static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull));
  int* out_row = out + b * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    if (parent[base + p] == root) out_row[p] = cls;
  }
}

}  // namespace

// seg, out: [batch, h, w] int32; parent, size: [(num_classes-1)*batch*h*w]
// int32 scratch. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError() after the launches.
extern "C" int chap_largest_cc(const int* seg, int* out, int* parent, int* size,
                               int batch, int h, int w, int num_classes,
                               void* stream) {
  const int hw = h * w;
  const int masks = (num_classes - 1) * batch;
  const int total = masks * hw;
  if (masks <= 0 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  ccl_init<<<blocks, threads, 0, s>>>(seg, parent, size, out, batch, hw, total);
  ccl_merge<<<blocks, threads, 0, s>>>(seg, parent, batch, h, w, total);
  ccl_compress<<<blocks, threads, 0, s>>>(parent, size, total);
  ccl_select<<<masks, 1024, 0, s>>>(parent, size, out, batch, hw);
  return static_cast<int>(cudaGetLastError());
}
