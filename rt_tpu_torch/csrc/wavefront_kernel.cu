// Bounce-major (wavefront) forward path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel rt_tpu/ops/pallas_wavefront.py::_make_wf_kernel
// (rng_impl="hash"): one launch advances every ray of a ray-state table by
// one bounce.  With bounce == 0 (the TPU kernel's gen=True) it makes the
// camera rays of a sample chunk in ray-id order and runs their bounce 0;
// with bounce b > 0 it runs bounce b of every live ray of the table, in
// place.  With a `words` buffer (record=True) it also writes each ray's
// winner word, which the wavefront gradient reads.  The caller
// (rt_tpu_torch/ops/wavefront.py) sorts the table between bounces
// (torch.sort: dead rays last, live rays by direction octant and origin
// cell), and assembles the frame from the final table by ray id.
//
// The per-ray bounce is trace.cuh's bounce_once, the function the render
// and blockwise kernels loop over: one source for rows 1, 5 and 8 of the
// port's kernel table, so the three trace the same paths and this
// kernel's frames equal the blockwise kernel's bit for bit.
//
// State, float32 (13, n) row-major (row k at k * n): origin 0-2, direction
// 3-5, throughput 6-8, radiance 9-11, live 12 (1 or 0).  ids, int32 (n):
// the ray id, sample * n_pix + pixel, chunk-local; a ray's draws come from
// its id, so a ray traces the same path wherever the sorts put it.  The
// TPU kernel's (14, N) state bitcast its ids into a float row with a bit-30
// tag against the TPU's flush of subnormals; here they are int32.
//
// What bounds it on this card.  FP32 issue in the closest-hit scan, ~20-30
// operations per primitive per live bounce (5000 spheres: ~150 K per live
// bounce, against ~100 for the rest of the bounce); device-memory traffic
// is 56 bytes read and written per live ray per launch plus the tables
// (read as warp-wide broadcasts from L1/L2, as blockwise_kernel.cu reads
// them).  The design is the simple one:
//   * one thread per ray; tables in device memory (16384 rows of 64 B do
//     not fit in shared memory);
//   * a dead ray costs one load: a thread whose ray is dead returns at
//     once, and a thread past the live prefix (`limit`, a count the caller
//     computes on the card after a compaction sort, read here from device
//     memory: no host sync per bounce) returns without reading its ray.
//     After a sort the live rays are one prefix and each warp's lanes are
//     all live or all dead, which is what the TPU's bucketed live-prefix
//     shrink buys on its grid; sorted warps also scan together to the end.

#include "trace.cuh"

namespace {

constexpr int kCols = 16;  // padded row length of the tables

struct Args {
  Tables T;
  const float* cam;       // (16,) camera vector (gen only)
  const int32_t* seed;    // (1,) the chunk's seed
  float* state;           // (13, n)
  int32_t* ids;           // (n,)
  int32_t* words;         // (n,) winner words, or null
  const int32_t* limit;   // (1,) live-prefix length, or null for all n
  int n, n_pix, width;
  float inv_w, inv_h;
  int bounce, max_bounces, center_sample, rng_sphere;
};

__device__ __forceinline__ void store(const Args& A, int j, const Ray& r, const float rad[3],
                                      bool alive) {
  float* s = A.state + j;
  const int n = A.n;
  s[0 * n] = r.ox; s[1 * n] = r.oy; s[2 * n] = r.oz;
  s[3 * n] = r.dx; s[4 * n] = r.dy; s[5 * n] = r.dz;
  s[6 * n] = r.tr; s[7 * n] = r.tg; s[8 * n] = r.tb;
  s[9 * n] = rad[0]; s[10 * n] = rad[1]; s[11 * n] = rad[2];
  s[12 * n] = alive ? 1.0f : 0.0f;
}

// raygen + bounce 0 of ray j (= its id): ids and the whole table are
// written.
__global__ void __launch_bounds__(kThreads) wf_gen_kernel(Args A) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= A.n) return;
  const uint32_t pix = static_cast<uint32_t>(j % A.n_pix);
  const uint32_t smp = static_cast<uint32_t>(j / A.n_pix);
  const uint32_t seed = static_cast<uint32_t>(A.seed[0]);
  const uint32_t base = smp * (2u + 4u * static_cast<uint32_t>(A.max_bounces));
  float jx = 0.5f, jy = 0.5f;  // sample 0 of the first chunk at the pixel centre
  if (smp != 0 || !A.center_sample) {
    jx = hash_u01(pix, seed, base + 1u);
    jy = hash_u01(pix, seed, base + 2u);
  }
  Ray r = camera_ray(A.cam, static_cast<float>(pix % A.width),
                     static_cast<float>(pix / A.width), jx, jy, A.inv_w, A.inv_h);
  float rad[3] = {0.0f, 0.0f, 0.0f};
  int32_t word;
  const bool alive = bounce_once<kCols, kCols>(A.T, pix, seed, base + 2u, A.rng_sphere, r, rad,
                                               word);
  store(A, j, r, rad, alive);
  A.ids[j] = j;
  if (A.words != nullptr) A.words[j] = word;
}

// bounce A.bounce of the ray at column j, in place; a dead ray is left as
// it is (its winner word: a miss).
__global__ void __launch_bounds__(kThreads) wf_bounce_kernel(Args A) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= A.n) return;
  const float* s = A.state + j;
  const int n = A.n;
  if ((A.limit != nullptr && j >= *A.limit) || !(s[12 * n] > 0.0f)) {
    if (A.words != nullptr) A.words[j] = kWordMiss;
    return;
  }
  const uint32_t id = static_cast<uint32_t>(A.ids[j]);
  const uint32_t pix = id % static_cast<uint32_t>(A.n_pix);
  const uint32_t smp = id / static_cast<uint32_t>(A.n_pix);
  const uint32_t c = smp * (2u + 4u * static_cast<uint32_t>(A.max_bounces)) + 2u +
                     4u * static_cast<uint32_t>(A.bounce);
  Ray r{s[0 * n], s[1 * n], s[2 * n], s[3 * n], s[4 * n], s[5 * n], s[6 * n], s[7 * n], s[8 * n]};
  float rad[3] = {s[9 * n], s[10 * n], s[11 * n]};
  int32_t word;
  const bool alive = bounce_once<kCols, kCols>(A.T, pix, static_cast<uint32_t>(A.seed[0]), c,
                                               A.rng_sphere, r, rad, word);
  store(A, j, r, rad, alive);
  if (A.words != nullptr) A.words[j] = word;
}

}  // namespace

// Launches one call on `stream`; returns cudaGetLastError() as an int.
// Tables are row-major float32 (rows, 16), of which the first n_* rows are
// used; cam (16,) float32 and seed (1,) int32; state (13, n) float32, ids
// (n,) int32, words (n,) int32 or null, limit (1,) int32 or null.  bounce
// 0 writes state and ids from nothing (n = n_pix * samples of the chunk).
extern "C" int rt_wf_bounce(const float* spheres, int n_spheres, const float* planes, int n_planes,
                            const float* boxes, int n_boxes, const float* cam, const int32_t* seed,
                            float* state, int32_t* ids, int32_t* words, const int32_t* limit, int n,
                            int n_pix, int width, float inv_w, float inv_h, int bounce,
                            int max_bounces, int center_sample, int rng_sphere, void* stream) {
  Args a;
  a.T = Tables{spheres, n_spheres, planes, n_planes, boxes, n_boxes};
  a.cam = cam; a.seed = seed;
  a.state = state; a.ids = ids; a.words = words; a.limit = limit;
  a.n = n; a.n_pix = n_pix; a.width = width; a.inv_w = inv_w; a.inv_h = inv_h;
  a.bounce = bounce; a.max_bounces = max_bounces; a.center_sample = center_sample;
  a.rng_sphere = rng_sphere;
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bounce == 0) {
    wf_gen_kernel<<<blocks, kThreads, 0, s>>>(a);
  } else {
    wf_bounce_kernel<<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
