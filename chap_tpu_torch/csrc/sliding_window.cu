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
// maps over the batch's bounding box; a few tens of flops a voxel. The
// design, one launch, output-stationary and deterministic:
//   * one thread per voxel of the batch's bounding box (computed on the host
//     from the starts); it walks the batch's patches in order, and for each
//     patch that covers it reads that voxel's C logits of both decoders,
//     averages them, takes the softmax in registers (no softmax tensor in
//     device memory) and adds it to C running sums; then one read-modify-
//     write of score and cnt. No atomics: two calls give bit-identical maps.
//   * consecutive threads hold consecutive z, so each patch's logits and
//     the maps are read in coalesced runs.
// Voxels of the box that no patch covers write nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 8;

__global__ void __launch_bounds__(kThreads)
sw_accumulate(const float* __restrict__ logits1,
              const float* __restrict__ logits2, const int* __restrict__ starts,
              float* __restrict__ score, float* __restrict__ cnt,
              int n_patches, int num_classes, int px, int py, int pz, int nx,
              int ny, int nz, int bx0, int by0, int bz0, int bx, int by,
              int bz) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(bx) * by * bz) return;
  const int lz = static_cast<int>(t % bz);
  const long long r = t / bz;
  const int ly = static_cast<int>(r % by);
  const int lx = static_cast<int>(r / by);
  const int x = bx0 + lx, y = by0 + ly, z = bz0 + lz;
  const long long patch_vox = static_cast<long long>(px) * py * pz;
  float acc[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) acc[c] = 0.0f;
  float n = 0.0f;
  for (int p = 0; p < n_patches; ++p) {
    const int ix = x - starts[3 * p];
    const int iy = y - starts[3 * p + 1];
    const int iz = z - starts[3 * p + 2];
    if (ix < 0 || ix >= px || iy < 0 || iy >= py || iz < 0 || iz >= pz) continue;
    const long long base = static_cast<long long>(p) * num_classes * patch_vox +
                           (static_cast<long long>(ix) * py + iy) * pz + iz;
    float v[kMaxClasses];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < num_classes) {
        float a = logits1[base + c * patch_vox];
        if (logits2 != nullptr) a = (a + logits2[base + c * patch_vox]) / 2.0f;
        v[c] = a;
        m = fmaxf(m, a);
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < num_classes) {
        v[c] = expf(v[c] - m);
        s += v[c];
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < num_classes) acc[c] += v[c] / s;
    }
    n += 1.0f;
  }
  if (n == 0.0f) return;
  const long long vox = static_cast<long long>(nx) * ny * nz;
  const long long g = (static_cast<long long>(x) * ny + y) * nz + z;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) {
    if (c < num_classes) score[c * vox + g] += acc[c];
  }
  cnt[g] += n;
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
  const long long box = static_cast<long long>(bx) * by * bz;
  const long long blocks = (box + kThreads - 1) / kThreads;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  sw_accumulate<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      logits1, logits2, starts, score, cnt, n_patches, num_classes, px, py, pz,
      nx, ny, nz, bx0, by0, bz0, bx, by, bz);
  return static_cast<int>(cudaGetLastError());
}
