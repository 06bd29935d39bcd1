// K3: the sliding-window accumulate of the 3D eval, for Hopper.
//
// Replaces chap_tpu/eval/sliding_window.py::SlidingWindowEngine ->
// accumulate -> scan_body (:98-164): there each batch of patches is
// scattered into the score and count maps with one-hot selection matmuls,
// a workaround for the TPU's tile alignment at strides like 18/4.
//
// What it computes, for one batch of P patches with starts s_p (P x 3, in
// order) and the two decoders' logits l1, l2 [P, C, px, py, pz]:
//   q_p = softmax over C of (l1_p + l2_p) / 2      (l1_p alone without l2)
//   score[c, s_p + i] += q_p[c, i],  cnt[s_p + i] += 1
// into the class-first score map [C, X, Y, Z] and the count map [X, Y, Z]
// (fp32). The patches of a batch overlap (stride 18 < 112), so a
// patch-per-block scatter would race.
//
// What bounds it on the H100: bytes. At the LA eval's batch of 16 patches
// of 112x112x80 with C = 2 it reads 2 x 16 x 2 x 1.0 M fp32 logits, 257 MB
// or 77 us at 3.35 TB/s, plus the read and write of the score and count
// maps over the batch's bounding box (41 MB): 0.089 ms in all; a few tens
// of flops a voxel. The design, one launch, output-stationary and
// deterministic:
//   * one thread per 4 consecutive z-voxels of the batch's bounding box
//     (computed on the host from the starts); it walks the batch's patches
//     in order, and for each patch that covers it reads those voxels' C
//     logits of both decoders, averages them, takes the softmax in
//     registers (no softmax tensor in device memory) and adds it to C
//     running sums a voxel; then one read-modify-write of score and cnt.
//     No atomics, and each voxel adds its patches in patch order: two calls
//     give bit-identical maps.
//   * where pz, the volume's Z, the box's z-origin and the pointers allow
//     (LA: 80, 96, 0), each class's logits of a patch whose z-start is a
//     multiple of 4 (LA's stride 4) come as one 16-byte load, and score
//     and cnt as 16-byte loads and stores: a warp reads whole 32-byte
//     sectors, and each thread keeps 4 x 2C loads in flight. Any other
//     patch, and any other geometry, takes scalar loads, voxel by voxel.
//   * the batch's starts sit in shared memory, read once a block.
// Voxels of the box that no patch covers write nothing.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, one LA batch:
// 0.096-0.116 ms of kernel time over four calls (77-93% of the bound),
// where the first version, one thread a voxel with scalar loads and the
// starts read from device memory, took 0.171-0.214 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 8;
constexpr int kZ = 4;                  // consecutive z-voxels a thread
constexpr int kStartsChunk = 256;      // patches whose starts are in shared memory

struct SwGeom {
  int n_patches, px, py, pz, nx, ny, nz, bx0, by0, bz0, bx, by, bz;
  bool vec;                            // 16-byte loads and stores allowed
};

// softmax over the C values of v (the mean logits of one voxel), added to
// acc: the arithmetic of K3's first version, kept so its sums are the same
template <int C>
__device__ __forceinline__ void add_softmax(float (&v)[C], float (&acc)[C]) {
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) m = fmaxf(m, v[c]);
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = expf(v[c] - m);
    s += v[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] += v[c] / s;
}

__device__ __forceinline__ float lane4(const float4& f, int j) {
  return j == 0 ? f.x : j == 1 ? f.y : j == 2 ? f.z : f.w;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
sw_accumulate(const float* __restrict__ logits1,
              const float* __restrict__ logits2, const int* __restrict__ starts,
              float* __restrict__ score, float* __restrict__ cnt, SwGeom q) {
  __shared__ int s_start[3 * kStartsChunk];
  const int quads = (q.bz + kZ - 1) / kZ;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = t < static_cast<long long>(q.bx) * q.by * quads;
  const int lq = static_cast<int>(t % quads);
  const long long r = t / quads;
  const int x = q.bx0 + static_cast<int>(r / q.by);
  const int y = q.by0 + static_cast<int>(r % q.by);
  const int z = q.bz0 + lq * kZ;              // this thread's first z
  const int z_end = q.bz0 + q.bz;             // the box's end
  const long long patch_vox = static_cast<long long>(q.px) * q.py * q.pz;
  float acc[kZ][C];
  float n[kZ];
#pragma unroll
  for (int j = 0; j < kZ; ++j) {
    n[j] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.0f;
  }
  for (int p0 = 0; p0 < q.n_patches; p0 += kStartsChunk) {
    const int chunk = min(kStartsChunk, q.n_patches - p0);
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * chunk; i += kThreads) s_start[i] = starts[3 * p0 + i];
    __syncthreads();
    if (!live) continue;
    for (int p = 0; p < chunk; ++p) {
      const int ix = x - s_start[3 * p], iy = y - s_start[3 * p + 1];
      const int sz = s_start[3 * p + 2], iz = z - sz;
      if (ix < 0 || ix >= q.px || iy < 0 || iy >= q.py || iz + kZ <= 0 || iz >= q.pz)
        continue;
      const long long base = static_cast<long long>(p0 + p) * C * patch_vox +
                             (static_cast<long long>(ix) * q.py + iy) * q.pz + iz;
      if (q.vec && (sz & (kZ - 1)) == 0) {
        // iz is a multiple of 4 and pz too: all four voxels lie in the patch
        float4 a[C], b[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          a[c] = __ldg(reinterpret_cast<const float4*>(logits1 + base + c * patch_vox));
          if (logits2 != nullptr)
            b[c] = __ldg(reinterpret_cast<const float4*>(logits2 + base + c * patch_vox));
        }
#pragma unroll
        for (int j = 0; j < kZ; ++j) {
          float v[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            v[c] = lane4(a[c], j);
            if (logits2 != nullptr) v[c] = (v[c] + lane4(b[c], j)) / 2.0f;
          }
          add_softmax<C>(v, acc[j]);
          n[j] += 1.0f;
        }
      } else {
        float v[kZ][C];
        bool in[kZ];
#pragma unroll
        for (int j = 0; j < kZ; ++j) {
          in[j] = iz + j >= 0 && iz + j < q.pz && z + j < z_end;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (!in[j]) continue;
            const long long k = base + j + c * patch_vox;
            v[j][c] = logits2 != nullptr ? (logits1[k] + logits2[k]) / 2.0f : logits1[k];
          }
        }
#pragma unroll
        for (int j = 0; j < kZ; ++j) {
          if (!in[j]) continue;
          add_softmax<C>(v[j], acc[j]);
          n[j] += 1.0f;
        }
      }
    }
  }
  if (!live) return;
  const long long vox = static_cast<long long>(q.nx) * q.ny * q.nz;
  const long long g = (static_cast<long long>(x) * q.ny + y) * q.nz + z;
  if (q.vec && n[0] > 0.0f && n[1] > 0.0f && n[2] > 0.0f && n[3] > 0.0f) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float4* s4 = reinterpret_cast<float4*>(score + c * vox + g);
      float4 s = *s4;
      s.x += acc[0][c]; s.y += acc[1][c]; s.z += acc[2][c]; s.w += acc[3][c];
      *s4 = s;
    }
    float4* c4 = reinterpret_cast<float4*>(cnt + g);
    float4 m = *c4;
    m.x += n[0]; m.y += n[1]; m.z += n[2]; m.w += n[3];
    *c4 = m;
    return;
  }
#pragma unroll
  for (int j = 0; j < kZ; ++j) {
    if (n[j] == 0.0f) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) score[c * vox + g + j] += acc[j][c];
    cnt[g + j] += n[j];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int C>
void launch(const float* l1, const float* l2, const int* starts, float* score,
            float* cnt, const SwGeom& q, unsigned blocks, cudaStream_t s) {
  sw_accumulate<C><<<blocks, kThreads, 0, s>>>(l1, l2, starts, score, cnt, q);
}

}  // namespace

// logits1, logits2: [n_patches, num_classes, px, py, pz] fp32 (logits2 may
// be null: one model output); starts: [n_patches, 3] int32 on the device;
// score: [num_classes, nx, ny, nz] fp32; cnt: [nx, ny, nz] fp32, both
// accumulated in place over the box [b*0, b*0 + b*). Launches on `stream`,
// allocates nothing, does not synchronise. Returns cudaGetLastError().
extern "C" int chap_sw_accumulate(const float* logits1, const float* logits2,
                                  const int* starts, float* score, float* cnt,
                                  int n_patches, int num_classes, int px,
                                  int py, int pz, int nx, int ny, int nz,
                                  int bx0, int by0, int bz0, int bx, int by,
                                  int bz, void* stream) {
  if (n_patches <= 0 || num_classes < 1 || num_classes > kMaxClasses ||
      bx <= 0 || by <= 0 || bz <= 0 || bx0 < 0 || by0 < 0 || bz0 < 0 ||
      bx0 + bx > nx || by0 + by > ny || bz0 + bz > nz)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads =
      static_cast<long long>(bx) * by * ((bz + kZ - 1) / kZ);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = pz % kZ == 0 && nz % kZ == 0 && bz0 % kZ == 0 &&
                   aligned16(logits1) && (logits2 == nullptr || aligned16(logits2)) &&
                   aligned16(score) && aligned16(cnt);
  const SwGeom q{n_patches, px, py, pz, nx, ny, nz, bx0, by0, bz0, bx, by, bz, vec};
  const unsigned nb = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_classes) {
    case 1: launch<1>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 2: launch<2>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 3: launch<3>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 4: launch<4>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 5: launch<5>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 6: launch<6>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 7: launch<7>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    default: launch<8>(logits1, logits2, starts, score, cnt, q, nb, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
