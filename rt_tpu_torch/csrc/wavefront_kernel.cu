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
// The per-ray bounce is trace.cuh's: bounce 0 runs bounce_once, the
// function the render and blockwise kernels loop over, and the later
// bounces run its two halves, closest_hit and finish_bounce, with the scan
// split over lanes (below).  One source for rows 1, 5 and 8 of the port's
// kernel table, so the three trace the same paths and this kernel's
// frames equal the blockwise kernel's bit for bit.
//
// State, float32 (13, n) row-major (row k at k * n): origin 0-2, direction
// 3-5, throughput 6-8, radiance 9-11, live 12 (1 or 0).  ids, int32 (n):
// the ray id, sample * n_pix + pixel, chunk-local; a ray's draws come from
// its id, so a ray traces the same path wherever the sorts put it.  A
// bounce-0 launch makes the rays ray0 .. ray0 + n - 1 of a chunk of
// `total` rays (the whole chunk: ray0 = 0, n = total): a shard of the
// chunk (ops/wavefront.py render_forward_wavefront_sharded, the
// counterpart of the TPU kernel's ray_offset meta[5]) traces exactly the
// rays of the whole-chunk launch, and a column whose id is at or past
// `total` (the last shard's padding) is a dead ray of zeros.  The
// TPU kernel's (14, N) state bitcast its ids into a float row with a bit-30
// tag against the TPU's flush of subnormals; here they are int32.
//
// What bounds it on this card.  FP32 issue in the closest-hit scan, ~20-30
// operations per primitive per live bounce (5000 spheres: ~150 K per live
// bounce, against ~100 for the rest of the bounce); device-memory traffic
// is 56 bytes read and written per live ray per launch plus the tables
// (read from L1/L2, as blockwise_kernel.cu reads them).  But a scan is a
// serial chain: one thread takes ~5000 dependent rows, so a launch lasts
// at least one ray's chain, and the card hides that latency only with many
// rays in flight.  Bounce 0 has them (every camera ray of the chunk, ~1 M
// on the config-5 slice, ran at 60% of the spec FP32 peak); after it the
// live rays are few (tens of thousands in the late bounces), and with one
// thread per ray bounces 1-7 ran at 9-16% of the peak (PERF.md).
// The design:
//   * bounce 0 (wf_gen_kernel): one thread per ray, bounce_once;
//   * bounces b > 0 (wf_bounce_kernel): a persistent grid of the card's
//     resident blocks; each live ray's scan runs on a group of G lanes, G
//     a power of two up to 32 chosen per launch on the card from the live
//     count so that live rays x G fill the resident threads
//     (split_lanes); lane k of the group scans rows k, k + G, ... of each
//     table with the serial scan's own comparisons, a shuffle butterfly
//     merges the lanes' winners exactly (merge_hit), and the group's first
//     lane runs the rest of the bounce and stores the ray;
//   * the live count is counted on the card by the caller before each later
//     bounce (a reduction over the live row) and read here from device
//     memory: no host sync per bounce.  The live-prefix length (`limit`,
//     which the caller computes after a compaction sort) bounds the columns
//     the groups visit; after a sort the live rays are one prefix, and a
//     ray that died since costs one load.  (G from the prefix instead of
//     the count left bounces 3 and 4 of the config-5 chunk at 4 lanes for
//     ~10 K and ~5 K live rays, 0.85 ms each: PERF.md);
//   * tables in device memory (16384 rows of 64 B do not fit in shared
//     memory).

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
  const int32_t* live;    // (1,) live rays of the table (b > 0: picks G), or null
  int n, n_pix, width;
  int ray0, total;        // gen: the first ray id of the launch, the chunk's rays
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

// raygen + bounce 0 of column j, ray id ray0 + j: ids and the whole table
// are written.
__global__ void __launch_bounds__(kThreads) wf_gen_kernel(Args A) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= A.n) return;
  const int id = A.ray0 + j;
  A.ids[j] = id;
  if (id >= A.total) {  // padding past the chunk: a dead ray
    const Ray dead{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const float zero[3] = {0.0f, 0.0f, 0.0f};
    store(A, j, dead, zero, false);
    if (A.words != nullptr) A.words[j] = kWordMiss;
    return;
  }
  const uint32_t pix = static_cast<uint32_t>(id % A.n_pix);
  const uint32_t smp = static_cast<uint32_t>(id / A.n_pix);
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
  if (A.words != nullptr) A.words[j] = word;
}

// The lanes per ray of a later bounce: the smallest power of two G <= 32
// with live * G >= resident, the threads of the persistent grid (so that
// the live rays' groups fill the resident warps).  The host exports it as
// rt_wf_split_lanes for the tests.
__host__ __device__ __forceinline__ int split_lanes(int live, int resident) {
  int g = 1;
  while (g < 32 && static_cast<int64_t>(live) * g < resident) g <<= 1;
  return g;
}

// The scan's order of preference at one distance: a sphere, then a plane,
// then a box (kNone last).
__device__ __forceinline__ int hit_rank(int kind) {
  return kind == kSphere ? 0 : (kind == kPlane ? 1 : (kind == kBox ? 2 : 3));
}

// Merges the closest hits of the G lanes of a group (G a power of two, the
// group aligned within its warp; `mask` its lanes) by a shuffle butterfly
// on the key (t, rank, row), rank sphere < plane < box (hit_rank): the
// smallest t wins, at an equal t a sphere beats a plane and a plane a box
// (a box never wins a tie: the scan's strict '<'), and within a class the
// first row.  This is the serial scan's winner over all the group's rows
// (closest_hit's tie rules; lane k scanned rows k, k + G, ...), so every
// lane of the group ends with it.  tests/test_torch_wavefront_host.py
// holds a torch mirror of this merge against the serial rule.
__device__ __forceinline__ void merge_hit(unsigned mask, int G, float& best, int& kind,
                                          int& win) {
  for (int off = G >> 1; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(mask, best, off);
    const int ok = __shfl_xor_sync(mask, kind, off);
    const int ow = __shfl_xor_sync(mask, win, off);
    const int rank = hit_rank(kind), orank = hit_rank(ok);
    if (ob < best || (ob == best && (orank < rank || (orank == rank && ow < win)))) {
      best = ob; kind = ok; win = ow;
    }
  }
}

// Bounce A.bounce of every live ray of the table, in place, on a
// persistent grid (the launcher sizes it to the card's resident blocks).
// Each live ray's closest-hit scan runs on a group of G = split_lanes(L)
// lanes, L the live rays (`live`, counted on the card by the caller; read
// from device memory): lane k scans rows k, k + G, k + 2G, ... of each
// table (closest_hit with first k, step G), merge_hit gives every lane the
// winner, and the group's first lane runs the rest of the bounce
// (finish_bounce) and stores the ray and its winner word.  Groups take the
// columns below the live-prefix length P (`limit`, or n without one) in
// grid-stride order.  A dead ray is left as it is (its winner word: a
// miss), and so is every column past P.
__global__ void __launch_bounds__(kThreads) wf_bounce_kernel(Args A) {
  const int n = A.n;
  const int prefix = A.limit != nullptr ? min(*A.limit, n) : n;
  const int live = A.live != nullptr ? min(*A.live, prefix) : prefix;
  const int threads = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int G = split_lanes(live, threads);
  const int lane = threadIdx.x & 31;
  const int k = lane & (G - 1);
  const unsigned mask = G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int groups = threads / G;
  const uint32_t seed = static_cast<uint32_t>(A.seed[0]);
  for (int j = tid / G; j < prefix; j += groups) {  // uniform within a group
    const float* s = A.state + j;
    if (!(s[12 * n] > 0.0f)) {
      if (k == 0 && A.words != nullptr) A.words[j] = kWordMiss;
      continue;
    }
    Ray r{s[0 * n], s[1 * n], s[2 * n], s[3 * n], s[4 * n], s[5 * n], s[6 * n], s[7 * n],
          s[8 * n]};
    float best;
    int kind, win;
    bool root;
    closest_hit<kCols, kCols>(A.T, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, k, G, best, kind, win,
                              root);
    merge_hit(mask, G, best, kind, win);
    if (k != 0) continue;
    const uint32_t id = static_cast<uint32_t>(A.ids[j]);
    const uint32_t pix = id % static_cast<uint32_t>(A.n_pix);
    const uint32_t smp = id / static_cast<uint32_t>(A.n_pix);
    const uint32_t c = smp * (2u + 4u * static_cast<uint32_t>(A.max_bounces)) + 2u +
                       4u * static_cast<uint32_t>(A.bounce);
    float rad[3] = {s[9 * n], s[10 * n], s[11 * n]};
    int32_t word;
    const bool alive = finish_bounce<kCols, kCols>(A.T, pix, seed, c, A.rng_sphere, r, rad, word,
                                                   best, kind, win, root);
    store(A, j, r, rad, alive);
    if (A.words != nullptr) A.words[j] = word;
  }
  if (A.words != nullptr) {
    for (int j = prefix + tid; j < n; j += threads) A.words[j] = kWordMiss;
  }
}

// The persistent grid of wf_bounce_kernel: its resident blocks on this
// card (occupancy at kThreads threads), queried once per process.
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wf_bounce_kernel, kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

}  // namespace

// Launches one call on `stream`; returns cudaGetLastError() as an int.
// Tables are row-major float32 (rows, 16), of which the first n_* rows are
// used; cam (16,) float32 and seed (1,) int32; state (13, n) float32, ids
// (n,) int32, words (n,) int32 or null, limit (1,) int32 or null, live (1,)
// int32 or null: the count of live rays in the table (bounce > 0; it only
// picks the lanes per ray).  bounce 0 writes state and ids from nothing:
// the rays ray0 .. ray0 + n - 1 of a chunk of `total` rays (n_pix * the
// chunk's samples; ids at or past it are dead); later bounces ignore ray0
// and total.
extern "C" int rt_wf_bounce(const float* spheres, int n_spheres, const float* planes, int n_planes,
                            const float* boxes, int n_boxes, const float* cam, const int32_t* seed,
                            float* state, int32_t* ids, int32_t* words, const int32_t* limit,
                            const int32_t* live, int n, int ray0, int total,
                            int n_pix, int width, float inv_w, float inv_h, int bounce,
                            int max_bounces, int center_sample, int rng_sphere, void* stream) {
  Args a;
  a.T = Tables{spheres, n_spheres, planes, n_planes, boxes, n_boxes};
  a.cam = cam; a.seed = seed;
  a.state = state; a.ids = ids; a.words = words; a.limit = limit; a.live = live;
  a.n = n; a.n_pix = n_pix; a.width = width; a.inv_w = inv_w; a.inv_h = inv_h;
  a.ray0 = ray0; a.total = total;
  a.bounce = bounce; a.max_bounces = max_bounces; a.center_sample = center_sample;
  a.rng_sphere = rng_sphere;
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bounce == 0) {
    wf_gen_kernel<<<blocks, kThreads, 0, s>>>(a);
  } else {
    wf_bounce_kernel<<<resident_blocks(), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The lanes per ray that a later bounce's launch gives `live` live rays on
// this card (wf_bounce_kernel's G).
extern "C" int rt_wf_split_lanes(int live) {
  return split_lanes(live, resident_blocks() * kThreads);
}

// Marks a library whose rt_wf_bounce takes the launch's first ray id and the
// chunk's rays (the sharded routes' interface): tools that load libraries
// built from other trees check for it.
extern "C" int rt_wf_offsets() { return 1; }
