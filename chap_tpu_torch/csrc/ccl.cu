// K2: batched largest-connected-component cleanup of label maps, for Hopper.
//
// Replaces chap_tpu/semi/nms.py::_label_mask_batch (:118-182) and
// _largest_id_sort (:221-243), driven by largest_cc_batch (:257-270). There
// the labelling is an XLA while_loop of window max-propagations, sweeps and
// pointer jumps that tests for convergence every round; run eagerly it would
// synchronise with the host every round in the middle of the train step.
//
// What it computes: for segmentation maps seg [B, H, W] and each class
// c = 1..C-1, the 8-connected components of seg == c, each labelled by its
// largest linear index within its map; the component with the most pixels
// is kept, ties going to the smallest label; out[b] = c on the kept pixels,
// 0 elsewhere (values outside [1, C) are background). Exactly chap_tpu's
// result.
//
// What bounds it on the H100: at the main path's 24 maps of 256^2 the data
// is 6.3 MB of int32 labels in and 6.3 MB out, 12.6 MB or 3.76 us at
// 3.35 TB/s. What stands in the way is not the bytes but the union-find:
// long chains of dependent global-memory round trips, and atomics that
// serialise on one address. The design, one C entry point, five launches,
// no host sync:
//   1. local    one block per 32x32 tile: the tile's classes go to shared
//               memory once; same-class 8-neighbours inside the tile unite
//               with shared-memory atomicCAS and path compression, roots
//               linked toward the larger index (so every root is its
//               component's maximum), NW/NE left out where W or N already
//               joins them; each tile-local component's size is counted in
//               shared memory, one atomic per set of a warp's lanes that
//               share a root (__match_any_sync). Writes each pixel's global
//               parent (-1 on background) and, at tile-local roots only, the
//               size.
//               One labelling per map: the classes of a map are disjoint,
//               so pixels unite only if they share a foreground class.
//               Also zeroes the B*(C-1) winner slots.
//   2. border   only pixels on a tile's top row, left and right columns
//               unite across tiles, with a global atomicCAS link toward the
//               larger index and path halving in find. Every parent write
//               is an atomicMax, so parents only grow: a racy halving write
//               is still an ancestor and never undoes a later one.
//   3. flatten  every pixel's parent becomes its root; each tile-local root
//               adds its tile-local size to its global root with one
//               atomicAdd (not one per pixel).
//   4. select   per 256-pixel range of one map, every global root
//               atomicMax-es a 64-bit key (size, ~label) into a shared slot
//               per class; then one global atomicMax per (range, class) into
//               the (map, class) slot.
//   5. write    out = class where the pixel's root is its slot's winner,
//               0 elsewhere (no separate zero pass).
// Ragged maps (H or W not a multiple of 32) are masked in every phase.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, for those 24 maps:
// 0.063-0.110 ms of kernel time across clean, speckled and percolating
// label maps, where labelling each class's masks apart with global
// union-find alone took 0.49-1.61 ms.
//
// K2 in 3D (entry point chap_largest_cc_3d), for the 3D CHAP step's maps
// seg [B, X, Y, Z] (Z fastest), 26-connected: the same result as
// chap_tpu/semi/nms.py::largest_cc_batch on [B, X, Y, Z] (labels are max
// linear indices within a map, with Z fastest, as chap_tpu's flatten).
// At the LA step's 4 maps of 112x112x80 the bound is 16.1 MB of int32 in
// and 16.1 MB out, 9.6 us at 3.35 TB/s. Same five phases as in 2D:
//   1. local    one block per 4x8x16 tile (X x Y x Z, 512 voxels): each
//               voxel unites with those of its 13 backward 26-neighbours
//               (smaller linear index) of the same class inside the tile,
//               in shared memory; sizes per tile-local root as in 2D.
//   2. border   one thread per voxel of the batch; only a voxel on a tile
//               face where a backward neighbour crosses into another tile
//               (x at the tile's low face, y at its low or high face, z at
//               its low or high face) does work: it unites with every
//               same-class backward neighbour that lies in another tile.
//               So voxels that touch only across a tile's edge or corner
//               (up to 7 other tiles) merge too.
//   3. flatten  the 2D kernel's ccl_flatten.
//   4. select   the 2D kernel's ccl_select with n = X*Y*Z.
//   5. write    the 2D kernel's ccl_write with n = X*Y*Z.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                  // tile side, one thread per pixel
constexpr int kTilePixels = kTile * kTile;
constexpr int kSharedSlots = 32;           // classes reduced in shared memory
constexpr int kThreads = 256;              // phases 3, 4 and 5

typedef unsigned long long u64;

// ---- tile-local union-find in shared memory (local indices) --------------
// Halving writes here are plain stores: a stale one still names an ancestor,
// and ccl_local takes every pixel's root from find_shared, never from a
// parent it stored.

__device__ __forceinline__ int find_shared(int* par, int x) {
  volatile int* vp = par;
  int p = vp[x];
  while (p != x) {
    const int gp = vp[p];
    if (gp == p) return p;
    vp[x] = gp;                            // halving: x skips to grandparent
    x = gp;
    p = vp[x];
  }
  return x;
}

__device__ void unite_shared(int* par, int a, int b) {
  a = find_shared(par, a);
  b = find_shared(par, b);
  while (a != b) {
    const int lo = a < b ? a : b;
    const int hi = a < b ? b : a;
    const int old = atomicCAS(par + lo, lo, hi);
    if (old == lo) return;
    a = find_shared(par, old);
    b = find_shared(par, hi);
  }
}

// ---- global union-find (global indices, reads bypass L1) ------------------
// A parent only ever points to a larger index, and every write of one is an
// atomicMax: a thread that halves a path with a grandparent it read earlier
// can then never overwrite a later, larger ancestor (such as the root that
// ccl_flatten wrote), so a parent only grows toward its root.

__device__ __forceinline__ int find_global(int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    const int gp = __ldcg(parent + p);
    if (gp == p) return p;
    atomicMax(parent + x, gp);             // halving: x skips to grandparent
    x = gp;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite_global(int* parent, int a, int b) {
  a = find_global(parent, a);
  b = find_global(parent, b);
  while (a != b) {
    const int lo = a < b ? a : b;
    const int hi = a < b ? b : a;
    const int old = atomicCAS(parent + lo, lo, hi);
    if (old == lo) return;
    a = find_global(parent, old);
    b = find_global(parent, hi);
  }
}

__device__ __forceinline__ int fg_class(int v, int num_classes) {
  return (v >= 1 && v < num_classes) ? v : 0;
}

// Which backward neighbours a pixel unites with, from whether W, NW, N and
// NE share its class: W and N always; NW only if neither W nor N does (NW
// is N's west and W's north neighbour, so either joins it already); NE only
// if N does not (NE's west neighbour is N). Every pair left out is joined
// through pairs that are always united, so the components are the same
// with fewer unions.
enum { kW = 1, kNW = 2, kN = 4, kNE = 8 };

__device__ __forceinline__ int union_mask(bool w, bool nw, bool n, bool ne) {
  return (w ? kW : 0) | (n ? kN : 0) | (nw && !w && !n ? kNW : 0) |
         (ne && !n ? kNE : 0);
}

// grid (tiles_x, tiles_y, batch), block (32, 32)
__global__ void __launch_bounds__(kTilePixels)
ccl_local(const int* __restrict__ seg, int* __restrict__ parent,
          int* __restrict__ size, u64* __restrict__ slot, int h, int w,
          int num_classes, int n_slots) {
  __shared__ int s_cls[kTilePixels];
  __shared__ int s_par[kTilePixels];
  __shared__ int s_cnt[kTilePixels];
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int l = ly * kTile + lx;
  const int x = blockIdx.x * kTile + lx;
  const int y = blockIdx.y * kTile + ly;
  const bool in = x < w && y < h;
  const int map_base = blockIdx.z * h * w;
  const int g = map_base + y * w + x;
  const int c = in ? fg_class(seg[g], num_classes) : 0;
  s_cls[l] = c;
  s_par[l] = l;
  s_cnt[l] = 0;
  const int block = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int i = block * kTilePixels + l; i < n_slots;
       i += gridDim.x * gridDim.y * gridDim.z * kTilePixels) {
    slot[i] = 0ull;
  }
  __syncthreads();
  // within a tile a larger local index is a larger global index
  if (c) {
    const int m = union_mask(
        lx > 0 && s_cls[l - 1] == c,
        lx > 0 && ly > 0 && s_cls[l - kTile - 1] == c,
        ly > 0 && s_cls[l - kTile] == c,
        lx + 1 < kTile && ly > 0 && s_cls[l - kTile + 1] == c);
    if (m & kW) unite_shared(s_par, l, l - 1);
    if (m & kNW) unite_shared(s_par, l, l - kTile - 1);
    if (m & kN) unite_shared(s_par, l, l - kTile);
    if (m & kNE) unite_shared(s_par, l, l - kTile + 1);
  }
  __syncthreads();
  // sizes: the lanes of a warp (one tile row) that share a root add their
  // count with one shared atomic
  const int r = c ? find_shared(s_par, l) : -1 - lx;
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  if (c && lx == __ffs(peers) - 1) atomicAdd(s_cnt + r, __popc(peers));
  __syncthreads();
  if (!in) return;
  if (c) {
    const int ry = r / kTile, rx = r - ry * kTile;
    parent[g] = map_base + (blockIdx.y * kTile + ry) * w + blockIdx.x * kTile + rx;
  } else {
    parent[g] = -1;
  }
  size[g] = (c && r == l) ? s_cnt[l] : 0;
}

// grid (tiles_x, tiles_y, batch), block 3*32: top row, left and right column
__global__ void ccl_border(const int* __restrict__ seg, int* parent, int h,
                           int w, int num_classes) {
  const int t = threadIdx.x;
  int lx, ly;
  if (t < kTile) {
    ly = 0; lx = t;
  } else if (t < 2 * kTile) {
    ly = t - kTile; lx = 0;
  } else {
    ly = t - 2 * kTile; lx = kTile - 1;
  }
  if (t >= kTile && ly == 0) return;       // the top row covers row 0
  const int x = blockIdx.x * kTile + lx;
  const int y = blockIdx.y * kTile + ly;
  if (x >= w || y >= h) return;
  const int map_base = blockIdx.z * h * w;
  const int g = map_base + y * w + x;
  const int c = fg_class(seg[g], num_classes);
  if (!c) return;
  // the backward neighbours W, NW, N, NE, pruned as in phase 1; those that
  // lie in another tile are united here
  const int* row = seg + map_base + y * w;
  const int m = union_mask(x > 0 && row[x - 1] == c,
                           x > 0 && y > 0 && row[x - 1 - w] == c,
                           y > 0 && row[x - w] == c,
                           x + 1 < w && y > 0 && row[x + 1 - w] == c);
  const int dy[4] = {0, -1, -1, -1};
  const int dx[4] = {-1, -1, 0, 1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!(m & (1 << k))) continue;         // kW, kNW, kN, kNE in this order
    const int ny = y + dy[k], nx = x + dx[k];
    if (ny / kTile == static_cast<int>(blockIdx.y) &&
        nx / kTile == static_cast<int>(blockIdx.x))
      continue;                            // same tile: united in phase 1
    unite_global(parent, g, map_base + ny * w + nx);
  }
}

__global__ void ccl_flatten(int* parent, int* size, int total) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int p = __ldcg(parent + g);
  if (p < 0) return;
  const int r = find_global(parent, g);
  if (p != r) atomicMax(parent + g, r);
  const int s = size[g];                   // > 0 only at tile-local roots
  if (s > 0 && r != g) atomicAdd(size + r, s);
}

// grid (ceil(n / kThreads), batch), block kThreads; n pixels or voxels per map
__global__ void ccl_select(const int* __restrict__ seg,
                           const int* __restrict__ parent,
                           const int* __restrict__ size, u64* slot, int n,
                           int num_classes) {
  __shared__ u64 s_best[kSharedSlots];
  const int l = threadIdx.x;
  const int n_cls = num_classes - 1;
  const int n_shared = n_cls < kSharedSlots ? n_cls : kSharedSlots;
  if (l < n_shared) s_best[l] = 0ull;
  __syncthreads();
  const int p = blockIdx.x * kThreads + l;
  u64* map_slot = slot + blockIdx.y * n_cls;
  if (p < n) {
    const int g = blockIdx.y * n + p;
    if (parent[g] == g) {                  // a global root: foreground
      const int c = seg[g];
      const u64 key = (static_cast<u64>(size[g]) << 32) |
                      static_cast<u64>(0xFFFFFFFFu - static_cast<unsigned>(p));
      if (c - 1 < kSharedSlots) {
        atomicMax(s_best + c - 1, key);
      } else {
        atomicMax(map_slot + c - 1, key);
      }
    }
  }
  __syncthreads();
  if (l < n_shared && s_best[l] != 0ull) atomicMax(map_slot + l, s_best[l]);
}

__global__ void ccl_write(const int* __restrict__ seg,
                          const int* __restrict__ parent,
                          const u64* __restrict__ slot, int* __restrict__ out,
                          int hw, int num_classes, int total) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int c = fg_class(seg[g], num_classes);
  int v = 0;
  if (c) {
    const int b = g / hw;
    const u64 best = slot[b * (num_classes - 1) + c - 1];
    const int root = b * hw + static_cast<int>(
        0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull));
    v = parent[g] == root ? c : 0;
  }
  out[g] = v;
}

// ---- 3D ---------------------------------------------------------------------

constexpr int kTX = 4, kTY = 8, kTZ = 16;  // 3D tile, one thread per voxel
constexpr int kTileVoxels = kTX * kTY * kTZ;

// the 13 backward 26-neighbours (smaller linear index, Z fastest)
__constant__ signed char kBack[13][3] = {
    {-1, -1, -1}, {-1, -1, 0}, {-1, -1, 1}, {-1, 0, -1}, {-1, 0, 0},
    {-1, 0, 1},   {-1, 1, -1}, {-1, 1, 0},  {-1, 1, 1},  {0, -1, -1},
    {0, -1, 0},   {0, -1, 1},  {0, 0, -1}};

// grid (tiles_z, tiles_y, tiles_x * batch), block (kTZ, kTY, kTX)
__global__ void __launch_bounds__(kTileVoxels)
ccl3_local(const int* __restrict__ seg, int* __restrict__ parent,
           int* __restrict__ size, u64* __restrict__ slot, int nx, int ny,
           int nz, int tiles_x, int num_classes, int n_slots) {
  __shared__ int s_cls[kTileVoxels];
  __shared__ int s_par[kTileVoxels];
  __shared__ int s_cnt[kTileVoxels];
  const int lz = threadIdx.x, ly = threadIdx.y, lx = threadIdx.z;
  const int l = (lx * kTY + ly) * kTZ + lz;   // == the linear thread id
  const int map = blockIdx.z / tiles_x;
  const int tx = blockIdx.z - map * tiles_x;
  const int x0 = tx * kTX, y0 = blockIdx.y * kTY, z0 = blockIdx.x * kTZ;
  const int x = x0 + lx, y = y0 + ly, z = z0 + lz;
  const bool in = x < nx && y < ny && z < nz;
  const int map_base = map * nx * ny * nz;
  const int g = map_base + (x * ny + y) * nz + z;
  const int c = in ? fg_class(seg[g], num_classes) : 0;
  s_cls[l] = c;
  s_par[l] = l;
  s_cnt[l] = 0;
  const int block = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int i = block * kTileVoxels + l; i < n_slots;
       i += gridDim.x * gridDim.y * gridDim.z * kTileVoxels) {
    slot[i] = 0ull;
  }
  __syncthreads();
  // within a tile a larger local index is a larger global index (both are
  // lexicographic in (x, y, z))
  if (c) {
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      const int ax = lx + kBack[k][0], ay = ly + kBack[k][1], az = lz + kBack[k][2];
      if (ax < 0 || ay < 0 || ay >= kTY || az < 0 || az >= kTZ) continue;
      const int nl = (ax * kTY + ay) * kTZ + az;
      if (s_cls[nl] == c) unite_shared(s_par, l, nl);
    }
  }
  __syncthreads();
  const int r = c ? find_shared(s_par, l) : -1 - l;
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  if (c && (l & 31) == __ffs(peers) - 1) atomicAdd(s_cnt + r, __popc(peers));
  __syncthreads();
  if (!in) return;
  if (c) {
    const int rx = r / (kTY * kTZ), ry = (r / kTZ) % kTY, rz = r % kTZ;
    parent[g] = map_base + ((x0 + rx) * ny + y0 + ry) * nz + z0 + rz;
  } else {
    parent[g] = -1;
  }
  size[g] = (c && r == l) ? s_cnt[l] : 0;
}

// one thread per voxel of the batch
__global__ void ccl3_border(const int* __restrict__ seg, int* parent, int nx,
                            int ny, int nz, int num_classes, int total) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int n = nx * ny * nz;
  const int map_base = (g / n) * n;
  const int p = g - map_base;
  const int x = p / (ny * nz);
  const int y = (p / nz) % ny;
  const int z = p % nz;
  const int lx = x % kTX, ly = y % kTY, lz = z % kTZ;
  // an interior voxel's backward neighbours all lie in its own tile
  if (lx != 0 && ly != 0 && ly != kTY - 1 && lz != 0 && lz != kTZ - 1) return;
  const int c = fg_class(seg[g], num_classes);
  if (!c) return;
#pragma unroll
  for (int k = 0; k < 13; ++k) {
    const int ax = x + kBack[k][0], ay = y + kBack[k][1], az = z + kBack[k][2];
    if (ax < 0 || ay < 0 || ay >= ny || az < 0 || az >= nz) continue;
    if (ax / kTX == x / kTX && ay / kTY == y / kTY && az / kTZ == z / kTZ)
      continue;                            // same tile: united in phase 1
    const int ng = map_base + (ax * ny + ay) * nz + az;
    if (seg[ng] == c) unite_global(parent, g, ng);
  }
}

}  // namespace

// seg, out: [batch, nx, ny, nz] int32 (nz fastest); parent, size:
// [batch*nx*ny*nz] int32 scratch; slot: [batch*(num_classes-1)] uint64
// scratch. Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError() after the launches.
extern "C" int chap_largest_cc_3d(const int* seg, int* out, int* parent,
                                  int* size, void* slot, int batch, int nx,
                                  int ny, int nz, int num_classes,
                                  void* stream) {
  if (batch <= 0 || nx <= 0 || ny <= 0 || nz <= 0 || num_classes < 2 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total_ll = static_cast<long long>(batch) * nx * ny * nz;
  const int tiles_x = (nx + kTX - 1) / kTX;
  if (total_ll >= (1ll << 31) || static_cast<long long>(tiles_x) * batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = static_cast<int>(total_ll);
  const int n = nx * ny * nz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* slots = static_cast<u64*>(slot);
  const dim3 tiles((nz + kTZ - 1) / kTZ, (ny + kTY - 1) / kTY, tiles_x * batch);
  const dim3 tile_block(kTZ, kTY, kTX);
  const int blocks = (total + kThreads - 1) / kThreads;
  ccl3_local<<<tiles, tile_block, 0, s>>>(seg, parent, size, slots, nx, ny, nz,
                                          tiles_x, num_classes,
                                          batch * (num_classes - 1));
  ccl3_border<<<blocks, kThreads, 0, s>>>(seg, parent, nx, ny, nz,
                                          num_classes, total);
  ccl_flatten<<<blocks, kThreads, 0, s>>>(parent, size, total);
  ccl_select<<<dim3((n + kThreads - 1) / kThreads, batch), kThreads, 0,
                    s>>>(seg, parent, size, slots, n, num_classes);
  ccl_write<<<blocks, kThreads, 0, s>>>(seg, parent, slots, out, n,
                                        num_classes, total);
  return static_cast<int>(cudaGetLastError());
}

// seg, out: [batch, h, w] int32; parent, size: [batch*h*w] int32 scratch;
// slot: [batch*(num_classes-1)] uint64 scratch. Launches on `stream`,
// allocates nothing, does not synchronise. Returns cudaGetLastError() after
// the launches.
extern "C" int chap_largest_cc(const int* seg, int* out, int* parent, int* size,
                               void* slot, int batch, int h, int w,
                               int num_classes, void* stream) {
  const int total = batch * h * w;
  if (batch <= 0 || h <= 0 || w <= 0 || num_classes < 2 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* slots = static_cast<u64*>(slot);
  const dim3 tiles((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, batch);
  const dim3 tile_block(kTile, kTile);
  const int blocks = (total + kThreads - 1) / kThreads;
  ccl_local<<<tiles, tile_block, 0, s>>>(seg, parent, size, slots, h, w,
                                         num_classes, batch * (num_classes - 1));
  ccl_border<<<tiles, 3 * kTile, 0, s>>>(seg, parent, h, w, num_classes);
  ccl_flatten<<<blocks, kThreads, 0, s>>>(parent, size, total);
  const int n = h * w;
  ccl_select<<<dim3((n + kThreads - 1) / kThreads, batch), kThreads, 0, s>>>(
      seg, parent, size, slots, n, num_classes);
  ccl_write<<<blocks, kThreads, 0, s>>>(seg, parent, slots, out, n,
                                        num_classes, total);
  return static_cast<int>(cudaGetLastError());
}
