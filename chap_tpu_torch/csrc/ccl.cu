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
// and 16.1 MB out, 9.6 us at 3.35 TB/s. What stands in the way is the
// labelling's dependent steps. Its first version (4x8x16 tiles, a global
// union for every pair of touching voxels in two tiles) took 2.87 ms on
// percolating maps: one giant component's hundreds of thousands of unions
// contended on its root. Five kernels of its own, no host sync:
//   1. ccl3_local    one block per 8x16x16 tile (X x Y x Z, 2,048 voxels,
//                    4 a thread, their loads in flight together), labelled
//                    in shared memory in rounds: each round hooks the larger
//                    of two differing labels across every same-class pair
//                    of backward 26-neighbours to the smaller (atomicMin),
//                    then points every voxel at its root with path halving,
//                    until a round finds nothing to hook (a few). Each
//                    tile-local component is then represented by its
//                    largest voxel: writes each voxel's parent (that
//                    voxel), the representative's size, and the tile's list
//                    of representatives.
//   2. ccl3_border   one block per tile, one thread per voxel of its low x,
//                    y and z faces (23% of the voxels): each cross-tile
//                    contact is taken once, at the voxel in the higher tile
//                    along the first axis where the two tiles differ, so
//                    edge and corner contacts (up to 7 tiles) merge too.
//                    Each contact forms the pair (own representative,
//                    neighbour's); a block-wide hash set in shared memory
//                    lets only a pair's first offer unite globally: one
//                    global union per distinct pair of touching tile-local
//                    components, not per touching voxel pair.
//   3. ccl3_flatten  over the lists only: each representative links
//                    straight to its global root and adds its size there.
//   4. ccl3_select   over the lists: every global root atomicMax-es (size,
//                    ~label) per class, as in 2D.
//   5. ccl3_write    4 voxels a thread: a voxel's global root is its
//                    parent's parent; out = class where that is the winner.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W for those maps:
// 0.113 / 0.156 / 0.245 ms of kernel time on clean / speckled /
// percolating maps (ccl3_local 0.071 / 0.088 / 0.152, ccl3_border 0.029 /
// 0.042 / 0.073, the other three 0.013-0.022 together), where the first
// version took 0.225 / 0.342 / 2.873 ms. Concurrent union-find in shared
// memory in place of the hooking rounds took ccl3_local alone to 5.3 ms
// on percolating maps, and 4x8x16 tiles take 0.52 ms there
// (chip_smoke.py's k2_3d_variants).

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

constexpr int kTX = 8, kTY = 16, kTZ = 16;     // 3D tile, X x Y x Z
constexpr int kTileVoxels = kTX * kTY * kTZ;   // 2048
constexpr int kLocalThreads = 512;             // ccl3_local
// ccl3_local's blocks an SM: caps it at 32 registers, where it would take
// 57 and fit 2 blocks (10% faster, H100 80GB HBM3 at 700 W)
constexpr int kLocalBlocksPerSM = 4;
constexpr int kPerThread = kTileVoxels / kLocalThreads;
// a tile's voxels with lx = 0, or ly = 0, or lz = 0 (ccl3_border)
constexpr int kFaceVoxels = kTY * kTZ + (kTX - 1) * kTZ + (kTX - 1) * (kTY - 1);
constexpr int kBorderThreads = (kFaceVoxels + 31) / 32 * 32;
constexpr int kPairBits = 10;                  // ccl3_border's set of pairs
constexpr int kPairSlots = 1 << kPairBits;
constexpr int kPairProbes = 16;
constexpr u64 kNoPair = ~0ull;
constexpr int kListThreads = 128;              // ccl3_flatten, ccl3_select
constexpr int kWriteVoxels = 4;                // ccl3_write, voxels a thread

static_assert(kTileVoxels % kLocalThreads == 0, "whole voxels a thread");
static_assert(kLocalThreads % 32 == 0, "whole warps");

// Neighbour k of the 27 in a 3x3x3 block, k = (dx + 1) * 9 + (dy + 1) * 3 +
// dz + 1: k < 13 are the 13 backward 26-neighbours (smaller linear index,
// Z fastest), k = 13 the voxel itself.
__host__ __device__ constexpr int nb_dx(int k) { return k / 9 - 1; }
__host__ __device__ constexpr int nb_dy(int k) { return k / 3 % 3 - 1; }
__host__ __device__ constexpr int nb_dz(int k) { return k % 3 - 1; }

struct Geom3 {
  int nx, ny, nz;                    // one map
  int tiles_y, tiles_z, tiles_per_map, n_tiles;
};

struct Tile3 {
  int map_base, x0, y0, z0;
};

__device__ __forceinline__ Tile3 tile_of(int tile, const Geom3& q) {
  const int map = tile / q.tiles_per_map;
  const int r = tile - map * q.tiles_per_map;
  const int tz = r % q.tiles_z, ty = r / q.tiles_z % q.tiles_y;
  const int tx = r / (q.tiles_z * q.tiles_y);
  return {map * q.nx * q.ny * q.nz, tx * kTX, ty * kTY, tz * kTZ};
}

// grid n_tiles, block kLocalThreads. Thread t holds the tile's voxels
// l = t + j * kLocalThreads, l = (lx * kTY + ly) * kTZ + lz, so each of its
// kPerThread loads and stores is coalesced and all are in flight at once.
// A tile-local component is represented by its largest voxel (its label
// within the tile). Writes every voxel's parent: the global index of its
// representative (-1 on background); at each representative the
// component's size; and the tile's list of representatives: tiles[tile] of
// them at tiles[n_tiles + tile * kTileVoxels].
__global__ void __launch_bounds__(kLocalThreads, kLocalBlocksPerSM)
ccl3_local(const int* __restrict__ seg, int* __restrict__ parent,
           int* __restrict__ size, int* __restrict__ tiles,
           u64* __restrict__ slot, Geom3 q, int num_classes, int n_slots) {
  __shared__ int s_cls[kTileVoxels];
  __shared__ int s_par[kTileVoxels];
  __shared__ int s_cnt[kTileVoxels];
  __shared__ int s_top[kTileVoxels];       // a root's largest member
  __shared__ int s_roots;
  const Tile3 tl = tile_of(blockIdx.x, q);
  const int t = threadIdx.x, lane = t & 31;
  int g[kPerThread], c[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = t + j * kLocalThreads;
    const int x = tl.x0 + l / (kTY * kTZ), y = tl.y0 + l / kTZ % kTY;
    const int z = tl.z0 + l % kTZ;
    const bool in = x < q.nx && y < q.ny && z < q.nz;
    g[j] = in ? tl.map_base + (x * q.ny + y) * q.nz + z : -1;
    c[j] = in ? fg_class(seg[g[j]], num_classes) : 0;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = t + j * kLocalThreads;
    s_cls[l] = c[j];
    s_par[l] = l;
    s_cnt[l] = 0;
    s_top[l] = 0;
  }
  if (t == 0) s_roots = 0;
  for (int i = blockIdx.x * kLocalThreads + t; i < n_slots;
       i += gridDim.x * kLocalThreads) {
    slot[i] = 0ull;
  }
  __syncthreads();
  // Each voxel's same-class backward neighbours inside the tile (bit k).
  int same[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = t + j * kLocalThreads;
    const int lx = l / (kTY * kTZ), ly = l / kTZ % kTY, lz = l % kTZ;
    int m = 0;
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      const int ax = lx + nb_dx(k), ay = ly + nb_dy(k), az = lz + nb_dz(k);
      if (c[j] && ax >= 0 && ay >= 0 && ay < kTY && az >= 0 && az < kTZ &&
          s_cls[(ax * kTY + ay) * kTZ + az] == c[j])
        m |= 1 << k;
    }
    same[j] = m;
  }
  // Label the tile in rounds. s_par[l] is a label: a smaller voxel of l's
  // component, or l itself at a root. Each round hooks the larger of two
  // differing labels across each same-class pair to the smaller (shared
  // atomicMin), then points every voxel at its root, halving the paths it
  // walks, until a round finds no differing labels. Labels only decrease,
  // so a component's last root is its smallest voxel. Each round's work is
  // bounded; the first round already hangs each voxel under its smallest
  // neighbour, so the trees are shallow.
  volatile int* lab = s_par;
  while (true) {
    int changed = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (!same[j]) continue;
      const int l = t + j * kLocalThreads;
      const int a = lab[l];
#pragma unroll
      for (int k = 0; k < 13; ++k) {
        if (!(same[j] >> k & 1)) continue;
        const int b = lab[l + (nb_dx(k) * kTY + nb_dy(k)) * kTZ + nb_dz(k)];
        if (a != b) {
          atomicMin(s_par + (a > b ? a : b), a < b ? a : b);
          changed = 1;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (!c[j]) continue;
      const int l = t + j * kLocalThreads;
      int x = l, p = lab[l];
      for (int gp = lab[p]; gp != p; gp = lab[p]) {
        lab[x] = gp;                       // halving: x skips to grandparent
        x = gp;
        p = lab[x];
      }
      lab[l] = p;
    }
    if (!__syncthreads_or(changed)) break;
  }
  // sizes and largest members: the lanes of a warp that share a root (whose
  // l grow with the lane) add their count and offer their largest l with
  // one shared atomic each
  int r[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = t + j * kLocalThreads;
    r[j] = c[j] ? lab[l] : -1 - l;
    const unsigned peers = __match_any_sync(0xffffffffu, r[j]);
    if (c[j] && lane == __ffs(peers) - 1) {
      atomicAdd(s_cnt + r[j], __popc(peers));
      atomicMax(s_top + r[j], l - lane + 31 - __clz(peers));
    }
  }
  __syncthreads();
  int* list = tiles + q.n_tiles + blockIdx.x * kTileVoxels;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = t + j * kLocalThreads;
    const int top = c[j] ? s_top[r[j]] : -1;
    const bool rep = c[j] && top == l;
    const unsigned reps = __ballot_sync(0xffffffffu, rep);
    int base = 0;
    if (lane == 0 && reps) base = atomicAdd(&s_roots, __popc(reps));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (rep) {
      list[base + __popc(reps & ((1u << lane) - 1u))] = g[j];
      size[g[j]] = s_cnt[r[j]];
    }
    if (g[j] < 0) continue;
    if (c[j]) {
      const int tx = top / (kTY * kTZ), ty = top / kTZ % kTY, tz = top % kTZ;
      parent[g[j]] = tl.map_base + ((tl.x0 + tx) * q.ny + tl.y0 + ty) * q.nz +
                     tl.z0 + tz;
    } else {
      parent[g[j]] = -1;
    }
  }
  __syncthreads();
  if (t == 0) tiles[blockIdx.x] = s_roots;
}

// True the first time the block offers the pair (a, b) to its set, false
// after; true also when the slots around the pair's hash are all taken (a
// pair offered twice is only a wasted union).
__device__ __forceinline__ bool first_offer(u64* set, int a, int b) {
  const u64 key = (static_cast<u64>(static_cast<unsigned>(a)) << 32) |
                  static_cast<unsigned>(b);
  const unsigned h = static_cast<unsigned>((key * 0x9E3779B97F4A7C15ull) >>
                                           (64 - kPairBits));
  for (int i = 0; i < kPairProbes; ++i) {
    const u64 old = atomicCAS(set + ((h + i) & (kPairSlots - 1)), kNoPair, key);
    if (old == kNoPair) return true;
    if (old == key) return false;
  }
  return true;
}

// grid n_tiles, block kBorderThreads: thread t takes the t-th voxel of the
// tile's low faces (lx = 0, then ly = 0, then lz = 0). Every pair of
// 26-adjacent voxels in two tiles is taken at one of them: along the first
// axis (x, then y, then z) where their tiles differ, the one in the higher
// tile lies on that tile's low face, and the other across it. A voxel
// forms the pair (its tile-local root, the neighbour's) for each same-class
// neighbour so taken, and only a pair the block has not seen unites.
__global__ void __launch_bounds__(kBorderThreads)
ccl3_border(const int* __restrict__ seg, int* parent, Geom3 q, int num_classes) {
  __shared__ u64 s_pairs[kPairSlots];
  for (int i = threadIdx.x; i < kPairSlots; i += kBorderThreads) s_pairs[i] = kNoPair;
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= kFaceVoxels) return;
  int lx, ly, lz;
  if (t < kTY * kTZ) {
    lx = 0; ly = t / kTZ; lz = t % kTZ;
  } else if (t < kTY * kTZ + (kTX - 1) * kTZ) {
    const int u = t - kTY * kTZ;
    lx = 1 + u / kTZ; ly = 0; lz = u % kTZ;
  } else {
    const int u = t - kTY * kTZ - (kTX - 1) * kTZ;
    lx = 1 + u / (kTY - 1); ly = 1 + u % (kTY - 1); lz = 0;
  }
  const Tile3 tl = tile_of(blockIdx.x, q);
  const int x = tl.x0 + lx, y = tl.y0 + ly, z = tl.z0 + lz;
  if (x >= q.nx || y >= q.ny || z >= q.nz) return;
  const int g = tl.map_base + (x * q.ny + y) * q.nz + z;
  const int c = fg_class(seg[g], num_classes);
  if (!c) return;
  // the tile-local root, or (if another block linked it already) an
  // ancestor of it: the same set either way
  const int own = __ldcg(parent + g);
  int last = -1;
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const int dx = nb_dx(k), dy = nb_dy(k), dz = nb_dz(k);
    const bool same_x = dx == 0 || (dx < 0 ? lx > 0 : lx < kTX - 1);
    const bool same_y = dy == 0 || (dy < 0 ? ly > 0 : ly < kTY - 1);
    if (!((lx == 0 && dx < 0) || (ly == 0 && dy < 0 && same_x) ||
          (lz == 0 && dz < 0 && same_x && same_y)))
      continue;
    const int ax = x + dx, ay = y + dy, az = z + dz;
    if (ax < 0 || ay < 0 || az < 0 || ax >= q.nx || ay >= q.ny || az >= q.nz)
      continue;
    const int ng = tl.map_base + (ax * q.ny + ay) * q.nz + az;
    if (seg[ng] != c) continue;
    const int other = __ldcg(parent + ng);
    if (other == last) continue;
    last = other;
    if (first_offer(s_pairs, own, other)) unite_global(parent, own, other);
  }
}

// grid n_tiles, block kListThreads: each tile-local root links straight to
// its global root and adds its tile-local size there (one atomic per
// tile-local component, not per voxel).
__global__ void __launch_bounds__(kListThreads)
ccl3_flatten(int* parent, int* size, const int* __restrict__ tiles, int n_tiles) {
  const int n = tiles[blockIdx.x];
  const int* list = tiles + n_tiles + blockIdx.x * kTileVoxels;
  for (int i = threadIdx.x; i < n; i += kListThreads) {
    const int r = list[i];
    const int root = find_global(parent, r);
    if (root != r) {
      atomicMax(parent + r, root);
      atomicAdd(size + root, size[r]);
    }
  }
}

// grid n_tiles, block kListThreads: every global root (a tile-local root
// that is its own parent) atomicMax-es the key (size, ~label) into a shared
// slot per class, then one global atomicMax per (tile, class).
__global__ void __launch_bounds__(kListThreads)
ccl3_select(const int* __restrict__ seg, const int* __restrict__ parent,
            const int* __restrict__ size, const int* __restrict__ tiles,
            u64* slot, Geom3 q, int num_classes) {
  __shared__ u64 s_best[kSharedSlots];
  const int l = threadIdx.x;
  const int n_cls = num_classes - 1;
  const int n_shared = n_cls < kSharedSlots ? n_cls : kSharedSlots;
  if (l < n_shared) s_best[l] = 0ull;
  __syncthreads();
  const int map = blockIdx.x / q.tiles_per_map;
  const int map_base = map * q.nx * q.ny * q.nz;
  u64* map_slot = slot + map * n_cls;
  const int n = tiles[blockIdx.x];
  const int* list = tiles + q.n_tiles + blockIdx.x * kTileVoxels;
  for (int i = l; i < n; i += kListThreads) {
    const int r = list[i];
    if (parent[r] != r) continue;
    const int c = seg[r];
    const u64 key = (static_cast<u64>(size[r]) << 32) |
                    static_cast<u64>(0xFFFFFFFFu - static_cast<unsigned>(r - map_base));
    if (c - 1 < kSharedSlots) {
      atomicMax(s_best + c - 1, key);
    } else {
      atomicMax(map_slot + c - 1, key);
    }
  }
  __syncthreads();
  if (l < n_shared && s_best[l] != 0ull) atomicMax(map_slot + l, s_best[l]);
}

// grid ceil(total / (kThreads * kWriteVoxels)), block kThreads: a voxel's
// global root is its parent's parent (a tile-local root's parent is its
// global root after ccl3_flatten); out = class where that is its slot's
// winner, 0 elsewhere.
__global__ void __launch_bounds__(kThreads)
ccl3_write(const int* __restrict__ seg, const int* __restrict__ parent,
           const u64* __restrict__ slot, int* __restrict__ out, int n,
           int num_classes, int total) {
  const int base = blockIdx.x * kThreads * kWriteVoxels + threadIdx.x;
  int c[kWriteVoxels], p[kWriteVoxels];
#pragma unroll
  for (int j = 0; j < kWriteVoxels; ++j) {
    const int g = base + j * kThreads;
    c[j] = g < total ? fg_class(seg[g], num_classes) : 0;
  }
#pragma unroll
  for (int j = 0; j < kWriteVoxels; ++j) {
    p[j] = c[j] ? parent[base + j * kThreads] : 0;
  }
#pragma unroll
  for (int j = 0; j < kWriteVoxels; ++j) {
    const int g = base + j * kThreads;
    if (g >= total) continue;
    int v = 0;
    if (c[j]) {
      const int b = g / n;
      const u64 best = slot[b * (num_classes - 1) + c[j] - 1];
      const int root = b * n + static_cast<int>(
          0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull));
      v = parent[p[j]] == root ? c[j] : 0;
    }
    out[g] = v;
  }
}

bool geom3(int batch, int nx, int ny, int nz, Geom3* q) {
  if (batch <= 0 || nx <= 0 || ny <= 0 || nz <= 0) return false;
  const long long tiles_x = (nx + kTX - 1) / kTX;
  q->nx = nx; q->ny = ny; q->nz = nz;
  q->tiles_y = (ny + kTY - 1) / kTY;
  q->tiles_z = (nz + kTZ - 1) / kTZ;
  const long long per_map = tiles_x * q->tiles_y * q->tiles_z;
  const long long n_tiles = per_map * batch;
  const long long total = static_cast<long long>(batch) * nx * ny * nz;
  if (total + kThreads * kWriteVoxels >= (1ll << 31) ||
      n_tiles * (kTileVoxels + 1) >= (1ll << 31))
    return false;
  q->tiles_per_map = static_cast<int>(per_map);
  q->n_tiles = static_cast<int>(n_tiles);
  return true;
}

}  // namespace

// The int32 scratch chap_largest_cc_3d needs for its tile lists, or -1 when
// the maps are too large for it.
extern "C" int chap_largest_cc_3d_scratch(int batch, int nx, int ny, int nz) {
  Geom3 q;
  if (!geom3(batch, nx, ny, nz, &q)) return -1;
  return q.n_tiles * (kTileVoxels + 1);
}

// seg, out: [batch, nx, ny, nz] int32 (nz fastest); parent, size:
// [batch*nx*ny*nz] int32 scratch; slot: [batch*(num_classes-1)] uint64
// scratch; tiles: chap_largest_cc_3d_scratch(...) int32 scratch. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launches.
extern "C" int chap_largest_cc_3d(const int* seg, int* out, int* parent,
                                  int* size, void* slot, int* tiles, int batch,
                                  int nx, int ny, int nz, int num_classes,
                                  void* stream) {
  Geom3 q;
  if (!geom3(batch, nx, ny, nz, &q) || num_classes < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = batch * nx * ny * nz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* slots = static_cast<u64*>(slot);
  ccl3_local<<<q.n_tiles, kLocalThreads, 0, s>>>(
      seg, parent, size, tiles, slots, q, num_classes, batch * (num_classes - 1));
  ccl3_border<<<q.n_tiles, kBorderThreads, 0, s>>>(seg, parent, q, num_classes);
  ccl3_flatten<<<q.n_tiles, kListThreads, 0, s>>>(parent, size, tiles, q.n_tiles);
  ccl3_select<<<q.n_tiles, kListThreads, 0, s>>>(seg, parent, size, tiles, slots,
                                                 q, num_classes);
  const int per_block = kThreads * kWriteVoxels;
  ccl3_write<<<(total + per_block - 1) / per_block, kThreads, 0, s>>>(
      seg, parent, slots, out, nx * ny * nz, num_classes, total);
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
