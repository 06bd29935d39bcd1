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
// patch-per-block scatter would race. The logits are fp32
// (chap_sw_accumulate) or bf16 (chap_sw_accumulate_bf16: a bf16 model's
// output, as chap_tpu's engine feeds it). In bf16 the mean is taken as
// chap_tpu's bf16 (out[0] + out[1]) / 2.0 is: the sum rounded to bf16
// (__float2bfloat16_rn), then halved (exact); the softmax and the sums are
// fp32 in both.
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
// In bf16 the same design reads half the logits' bytes: each class's 4
// z-voxels of a patch come as one 8-byte load (needs 8-byte aligned
// logits), so an LA batch's bound falls to 128.5 MB of logits plus the
// 41 MB of maps, about 0.051 ms, and a BraTS batch's (8 patches of 96^3,
// one output) to 28.3 + 78.6 MB, about 0.032 ms. Measured by chip_smoke.py
// on an H100 80GB HBM3 at 700 W: 0.0815 ms an LA batch (62% of that bound)
// and 0.0498 ms the BraTS batch (64%), against 90% and 77% for the fp32
// instantiation in the same call (its 8-byte loads keep half the bytes in
// flight a thread: a candidate cause, not measured).
// The fp32 instantiation, measured the same way, one LA batch:
// 0.096-0.116 ms of kernel time over four calls (77-93% of the bound),
// where the first version, one thread a voxel with scalar loads and the
// starts read from device memory, took 0.171-0.214 ms.

#include <cuda_bf16.h>
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
  bool vec;                            // vector loads and stores allowed
};

// How K3 reads one logits type: a scalar, 4 consecutive values (one 16-byte
// load of fp32, one 8-byte load of bf16), and the mean of two outputs.
template <typename T>
struct Logits;

template <>
struct Logits<float> {
  static constexpr int kAlign = 16;
  static __device__ __forceinline__ float one(const float* p, long long k) { return p[k]; }
  static __device__ __forceinline__ void four(const float* p, float (&v)[kZ]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  static __device__ __forceinline__ float mean(float a, float b) { return (a + b) / 2.0f; }
};

template <>
struct Logits<__nv_bfloat16> {
  static constexpr int kAlign = 8;
  static __device__ __forceinline__ float one(const __nv_bfloat16* p, long long k) {
    return __bfloat162float(p[k]);
  }
  static __device__ __forceinline__ void four(const __nv_bfloat16* p, float (&v)[kZ]) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
  }
  // chap_tpu's bf16 (a + b) / 2.0: the sum rounded to bf16, halved exactly
  static __device__ __forceinline__ float mean(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(a + b)) * 0.5f;
  }
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

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
sw_accumulate(const T* __restrict__ logits1, const T* __restrict__ logits2,
              const int* __restrict__ starts, float* __restrict__ score,
              float* __restrict__ cnt, SwGeom q) {
  using L = Logits<T>;
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
        float a[C][kZ], b[C][kZ];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          L::four(logits1 + base + c * patch_vox, a[c]);
          if (logits2 != nullptr) L::four(logits2 + base + c * patch_vox, b[c]);
        }
#pragma unroll
        for (int j = 0; j < kZ; ++j) {
          float v[C];
#pragma unroll
          for (int c = 0; c < C; ++c)
            v[c] = logits2 != nullptr ? L::mean(a[c][j], b[c][j]) : a[c][j];
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
            v[j][c] = logits2 != nullptr ? L::mean(L::one(logits1, k), L::one(logits2, k))
                                         : L::one(logits1, k);
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

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T, int C>
void launch(const T* l1, const T* l2, const int* starts, float* score,
            float* cnt, const SwGeom& q, unsigned blocks, cudaStream_t s) {
  sw_accumulate<T, C><<<blocks, kThreads, 0, s>>>(l1, l2, starts, score, cnt, q);
}

template <typename T>
int accumulate(const T* logits1, const T* logits2, const int* starts,
               float* score, float* cnt, int n_patches, int num_classes,
               int px, int py, int pz, int nx, int ny, int nz, int bx0,
               int by0, int bz0, int bx, int by, int bz, void* stream) {
  if (n_patches <= 0 || num_classes < 1 || num_classes > kMaxClasses ||
      bx <= 0 || by <= 0 || bz <= 0 || bx0 < 0 || by0 < 0 || bz0 < 0 ||
      bx0 + bx > nx || by0 + by > ny || bz0 + bz > nz)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads =
      static_cast<long long>(bx) * by * ((bz + kZ - 1) / kZ);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int la = Logits<T>::kAlign;
  const bool vec = pz % kZ == 0 && nz % kZ == 0 && bz0 % kZ == 0 &&
                   aligned(logits1, la) && (logits2 == nullptr || aligned(logits2, la)) &&
                   aligned(score, 16) && aligned(cnt, 16);
  const SwGeom q{n_patches, px, py, pz, nx, ny, nz, bx0, by0, bz0, bx, by, bz, vec};
  const unsigned nb = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_classes) {
    case 1: launch<T, 1>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 2: launch<T, 2>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 3: launch<T, 3>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 4: launch<T, 4>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 5: launch<T, 5>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 6: launch<T, 6>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    case 7: launch<T, 7>(logits1, logits2, starts, score, cnt, q, nb, s); break;
    default: launch<T, 8>(logits1, logits2, starts, score, cnt, q, nb, s); break;
  }
  return static_cast<int>(cudaGetLastError());
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
  return accumulate<float>(logits1, logits2, starts, score, cnt, n_patches,
                           num_classes, px, py, pz, nx, ny, nz, bx0, by0, bz0,
                           bx, by, bz, stream);
}

// The same with bf16 logits (score and cnt stay fp32).
extern "C" int chap_sw_accumulate_bf16(const void* logits1, const void* logits2,
                                       const int* starts, float* score,
                                       float* cnt, int n_patches,
                                       int num_classes, int px, int py, int pz,
                                       int nx, int ny, int nz, int bx0, int by0,
                                       int bz0, int bx, int by, int bz,
                                       void* stream) {
  return accumulate<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(logits1),
      static_cast<const __nv_bfloat16*>(logits2), starts, score, cnt,
      n_patches, num_classes, px, py, pz, nx, ny, nz, bx0, by0, bz0, bx, by,
      bz, stream);
}
