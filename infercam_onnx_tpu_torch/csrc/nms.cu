// Greedy hard-NMS suppression for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel infercam_onnx_tpu/ops/pallas/nms.py
// (_nms_kernel, launched by greedy_suppress). Same contract: per image,
// candidates in descending-confidence order, candidate i is kept iff it
// is valid (> 0.5) and no kept j < i has iou(j, i) > max_iou. The IoU is
// the reference's: EPS = 1e-7 in the denominator, zero area for
// ill-formed (negative-extent) overlap boxes, NaN propagated by max/min.
//
// What bounds it on this card. The data is tiny (B*K*6*4 bytes, ~98 KB at
// B=16, K=256) and the IoU work, at most K^2/2 pairs per image, takes
// about a microsecond at the card's float32 rate once it is spread over
// the SMs. What is left is latency: the greedy order is a dependent chain
// over the candidates, and one CTA per image would leave most SMs idle.
// The design cuts the work, spreads it, and shortens the chain:
//
// 1. Only the work these inputs need. n = last valid index + 1. IoUs are
//    computed only for pairs j < i < n with both candidates valid: a row
//    j is read only if j is kept, a kept j is valid, and an invalid i is
//    never kept, so the keep mask is unchanged. Valid need not be a
//    prefix (a NaN confidence sorts first and is invalid). Where the
//    intersection is +-0 (most pairs) the quotient's sign is decided
//    without the IEEE divide.
// 2. Phase 1, the upper-triangular suppression bitmask (bit i of row j
//    set iff iou(j, i) > max_iou), is spread over a thread block cluster
//    per image (route: thread block clusters, launched with
//    cudaLaunchKernelEx and cudaLaunchAttributeClusterDimension). The
//    triangle is cut into 64x64 tiles up to n, each tile into 8 units of
//    8 rows; row group g of every band belongs to CTA g % cluster, so
//    each CTA holds the same share of every band and the shares follow
//    the triangle's work, not row counts. A warp takes a unit: each lane
//    holds two column boxes in registers, the row box is a shared-memory
//    broadcast, and two ballots give each 64-bit word, which the warp
//    writes into the first CTA's shared memory through distributed shared
//    memory (map_shared_rank), once a split cluster barrier (arrive at
//    entry, wait after the prologue's loads) says that every CTA of the
//    cluster has started. The cluster size comes from B (B * cluster
//    fills the SMs, at most 8, the portable limit) and from K (no more
//    CTAs than give every warp a unit); 512 threads and two CTAs an SM
//    keep all B=16 clusters of 8 resident (cudaOccupancyMaxActiveClusters
//    says 30 at K=1024). One cluster.sync() publishes the bitmask; the
//    other CTAs then exit. (The scan reading each row from the CTA that
//    built it, with a final cluster.sync() to keep their shared memory
//    alive, was slower on the card at every input timed: its remote loads
//    and the last barrier sit on the scan's path.)
// 3. The scan is one warp of the first CTA, resolving the greedy order a
//    64-candidate word at a time. The diagonal 64x64 block is loaded
//    first, all 64 rows at once (these loads do not depend on the chain).
//    Then only the candidates still standing are visited, in order, a
//    32-candidate half at a time (c = valid & ~removed; t = ctz(c); keep
//    t; c &= ~diag[t]; drop bits <= t), so the chain costs a shuffle and
//    a few register operations per kept candidate, not a shared-memory
//    round trip and a shuffle per candidate. Then the word's kept rows
//    are pushed into the later words: lane l takes kept rows l and l + 32
//    and an OR reduction across the warp combines each word, whose
//    removed set lane w keeps.
//
// One launch per call; no allocation; no synchronisation with the host.
// Bit-exactness with the plain PyTorch version needs the same float
// formula in the same order and no contraction: build with -fmad=false,
// without --use_fast_math (IEEE division).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kMaxWords = kMaxK / 64;
constexpr int kRows = 8;  // rows of one phase-1 unit, a row group
constexpr int kGroups = 64 / kRows;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr float kEps = 1e-7f;
constexpr unsigned kFull = 0xffffffffu;

// A timing build defines NMS_STAMP(slot) before this file to record a
// time stamp at each numbered point; here the points compile to nothing.
#ifndef NMS_STAMP
#define NMS_STAMP(slot)
#endif

// The two halves of a cluster barrier. Distributed shared memory may be
// written only once every CTA of the cluster is known to have started:
// each CTA arrives at entry and waits just before its first remote store.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// NaN wins, as in torch.maximum and torch.minimum. The sign of a zero
// result may differ from theirs; no decision depends on it (a +-0 extent
// or intersection takes the same branch either way).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float area(float w, float h) {
  return (w < 0.f || h < 0.f) ? 0.f : w * h;
}

// iou(j, i) > max_iou, with j's box first as in the plain version. Most
// pairs do not overlap; for inter = +-0 the quotient is +-0 unless the
// denominator is 0 or NaN (then NaN), decided here without the divide.
__device__ __forceinline__ bool suppresses(
    float jx0, float jy0, float jx1, float jy1, float ja, float ix0,
    float iy0, float ix1, float iy1, float ia, float max_iou) {
  const float tlx = max_nan(jx0, ix0);
  const float tly = max_nan(jy0, iy0);
  const float brx = min_nan(jx1, ix1);
  const float bry = min_nan(jy1, iy1);
  const float inter = area(brx - tlx, bry - tly);
  const float den = ((ja + ia) - inter) + kEps;
  if (inter == 0.f) return den == den && den != 0.f && 0.f > max_iou;
  return inter / den > max_iou;
}

__host__ __device__ __forceinline__ int tiles(int words) {
  return words * (words + 1) / 2;
}

// Bitmask layout, in the shared memory of the cluster's first CTA: band
// jw (rows 64 jw .. 64 jw + 63) from word jw on, word-major (neighbouring
// rows on neighbouring words: no bank conflicts). Word iw of row j is at
// band_base(jw) + (iw - jw) * 64 + j % 64.
__device__ __forceinline__ int band_base(int jw, int kw) {
  return 64 * (jw * kw - jw * (jw - 1) / 2);
}

size_t shared_bytes(int k) {
  const int kw = (k + 63) / 64;
  return sizeof(uint64_t) * (kMaxWords + (size_t)64 * tiles(kw)) +
         5 * sizeof(float) * (size_t)k;
}

// two CTAs an SM, so that B=16 clusters of 8 are resident at once
__global__ void __launch_bounds__(kThreads, 2)
nms_kernel(const float* __restrict__ boxes_t,  // [B, 4, K]
           const float* __restrict__ valid,    // [B, 1, K]
           float* __restrict__ keep,           // [B, 1, K]
           int k, float max_iou) {
  cluster_arrive_relaxed();  // waited for before the first remote store
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();  // a power of two
  const int lg = __ffs(csize) - 1;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x >> lg;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kw = (k + 63) >> 6;
  NMS_STAMP(0);

  extern __shared__ uint64_t smem[];
  uint64_t* vbits = smem;              // [kMaxWords] valid candidates
  uint64_t* bits = vbits + kMaxWords;  // the bitmask (first CTA's is used)
  float* x0 = reinterpret_cast<float*>(bits + 64 * tiles(kw));
  float* y0 = x0 + k;
  float* x1 = y0 + k;
  float* y1 = x1 + k;
  float* ar = y1 + k;

  // valid bits, a warp per 64-candidate word
  const float* vrow = valid + (size_t)b * k;
  for (int w = warp; w < kw; w += kWarps) {
    const int i = w * 64 + lane;
    const unsigned lo = __ballot_sync(kFull, i < k && vrow[i] > 0.5f);
    const unsigned hi =
        __ballot_sync(kFull, i + 32 < k && vrow[i + 32] > 0.5f);
    if (lane == 0) vbits[w] = lo | (uint64_t)hi << 32;
  }
  __syncthreads();
  int wn = 0;  // words up to the last valid candidate
  for (int w = kw - 1; w >= 0; --w) {
    if (vbits[w]) {
      wn = w + 1;
      break;
    }
  }
  const int n = wn ? 64 * wn - __clzll(vbits[wn - 1]) : 0;

  const float* bx = boxes_t + (size_t)b * 4 * k;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float a0 = bx[t], b0 = bx[k + t], a1 = bx[2 * k + t],
                b1 = bx[3 * k + t];
    x0[t] = a0;
    y0[t] = b0;
    x1[t] = a1;
    y1[t] = b1;
    ar[t] = area(a1 - a0, b1 - b0);
  }
  __syncthreads();
  cluster_wait();  // every CTA of the cluster has started

  // phase 1: a unit is one of this CTA's row groups against one word of
  // columns, in a 64x64 tile jw <= iw < wn; one warp per unit
  const int glg = 3 - lg;  // this CTA has 8 >> lg row groups per band
  for (int v = warp; v < tiles(wn) << glg; v += kWarps) {
    int t = v >> glg;
    int jw = 0;
    while (t >= wn - jw) {
      t -= wn - jw;
      ++jw;
    }
    const int iw = jw + t;
    const int local = v & ((1 << glg) - 1);  // row group local*csize+rank
    const int j0 = jw * 64 + ((local << lg) + rank) * kRows;
    const uint64_t vi = vbits[iw];
    const unsigned rows_valid =
        (unsigned)(vbits[jw] >> (j0 & 63)) & ((1u << kRows) - 1);
    const int ia = iw * 64 + lane, ib = ia + 32;
    const bool va = (vi >> lane) & 1, vb = (vi >> (lane + 32)) & 1;
    float ax0 = 0.f, ay0 = 0.f, ax1 = 0.f, ay1 = 0.f, aa = 0.f;
    float bx0 = 0.f, by0 = 0.f, bx1 = 0.f, by1 = 0.f, ba = 0.f;
    if (va) {
      ax0 = x0[ia], ay0 = y0[ia], ax1 = x1[ia], ay1 = y1[ia], aa = ar[ia];
    }
    if (vb) {
      bx0 = x0[ib], by0 = y0[ib], bx1 = x1[ib], by1 = y1[ib], ba = ar[ib];
    }
    uint64_t mine = 0;  // lane r keeps row j0 + r
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      uint64_t word = 0;
      if ((rows_valid >> r) & 1) {
        const int j = j0 + r;
        const float jx0 = x0[j], jy0 = y0[j], jx1 = x1[j], jy1 = y1[j];
        const float ja = ar[j];
        bool sa = false, sb = false;
        if (va && ia > j) {
          sa = suppresses(jx0, jy0, jx1, jy1, ja, ax0, ay0, ax1, ay1, aa,
                          max_iou);
        }
        if (vb && ib > j) {
          sb = suppresses(jx0, jy0, jx1, jy1, ja, bx0, by0, bx1, by1, ba,
                          max_iou);
        }
        word = __ballot_sync(kFull, sa) |
               (uint64_t)__ballot_sync(kFull, sb) << 32;
      }
      if (lane == r) mine = word;
    }
    if (lane < kRows) {  // into the first CTA's shared memory
      *cluster.map_shared_rank(
          bits + band_base(jw, kw) + (iw - jw) * 64 + (j0 & 63) + lane, 0) =
          mine;
    }
  }
  NMS_STAMP(1);
  cluster.sync();  // the bitmask is complete; the other CTAs may exit
  NMS_STAMP(2);

  // phase 2: the greedy scan, one warp, a 64-candidate word at a time
  if (rank == 0 && warp == 0) {
    float* krow = keep + (size_t)b * k;
    uint64_t removed = 0;  // lane w: word w of the removed candidates
    for (int jw = 0; jw < wn; ++jw) {
      const uint64_t cand = vbits[jw] & ~__shfl_sync(kFull, removed, jw);
      const int ja = jw * 64 + lane, jb = ja + 32;
      const bool ca = (cand >> lane) & 1, cb = (cand >> (lane + 32)) & 1;
      // rows ja and jb from word jw on; word jw + d is 64 d further on
      const uint64_t* pa = bits + band_base(jw, kw) + lane;
      const uint64_t* pb = pa + 32;
      // the diagonal block before the chain: these loads do not depend
      // on it, so they are all in flight at once
      const uint64_t da = ca ? pa[0] : 0, db = cb ? pb[0] : 0;
      // the chain: only the candidates still standing, in order, a
      // 32-candidate half at a time
      unsigned clo = (unsigned)cand, chi = (unsigned)(cand >> 32);
      unsigned klo = 0, khi = 0;
      while (clo) {
        const int t = __ffs(clo) - 1;
        klo |= 1u << t;
        const uint64_t row = __shfl_sync(kFull, da, t);
        clo &= ~(unsigned)row & (~1u << t);
        chi &= ~(unsigned)(row >> 32);
      }
      while (chi) {
        const int t = __ffs(chi) - 1;
        khi |= 1u << t;
        chi &= ~__shfl_sync(kFull, (unsigned)(db >> 32), t) & (~1u << t);
      }
      const bool ka = (klo >> lane) & 1, kb = (khi >> lane) & 1;
      if (ja < k) krow[ja] = ka ? 1.f : 0.f;
      if (jb < k) krow[jb] = kb ? 1.f : 0.f;
      // push the kept rows into the later words: lane l takes kept rows
      // l and l + 32, and an OR across the warp combines each word
      if (klo | khi) {
        for (int iw = jw + 1; iw < wn; ++iw) {
          const int d = (iw - jw) * 64;
          const uint64_t x = (ka ? pa[d] : 0) | (kb ? pb[d] : 0);
          const uint64_t hit =
              __reduce_or_sync(kFull, (unsigned)x) |
              (uint64_t)__reduce_or_sync(kFull, (unsigned)(x >> 32)) << 32;
          if (lane == iw) removed |= hit;
        }
      }
    }
    NMS_STAMP(3);
  } else if (rank == 0) {  // candidates past the last valid word
    float* krow = keep + (size_t)b * k;
    for (int i = 64 * wn + threadIdx.x - 32; i < k; i += kThreads - 32) {
      krow[i] = 0.f;
    }
  }
  NMS_STAMP(4);
}

int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// B * cluster fills the SMs (at most the portable 8), and no more CTAs
// than give each warp of the cluster a unit of K's bitmask
int cluster_size(int batch, int k, int sms) {
  const int units = tiles((k + 63) / 64) * kGroups;
  const int by_work = (units + kWarps - 1) / kWarps;
  int need = 1;
  while (need < by_work && need < kMaxCluster) need *= 2;
  const int by_sms = pow2_floor(sms / batch > 1 ? sms / batch : 1);
  return need < by_sms ? need : by_sms;
}

// The launch configuration for (batch, k) on the current device, with its
// shared memory allowed; returns the CUDA error code.
cudaError_t plan(int batch, int k, void* stream, cudaLaunchConfig_t* cfg,
                 cudaLaunchAttribute* attr) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int cluster = cluster_size(batch, k, sms);
  const size_t smem = shared_bytes(k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(batch * cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" int nms_max_k() { return kMaxK; }

// Launches on `stream`, on the calling thread's current device (the
// caller makes the tensors' device current); returns the CUDA error code
// (0 = ok). Does not synchronize.
extern "C" int nms_greedy_suppress(const float* boxes_t, const float* valid,
                                   float* keep, int batch, int k,
                                   float max_iou, void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = plan(batch, k, stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, nms_kernel, boxes_t, valid, keep, k,
                           max_iou);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster size a launch for (batch, k) takes, its dynamic shared
// memory per CTA, and how many such clusters the device can hold at once
// (cudaOccupancyMaxActiveClusters); returns the CUDA error code.
extern "C" int nms_cluster_plan(int batch, int k, int* cluster,
                                int* smem_bytes, int* active_clusters) {
  if (batch <= 0 || k <= 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = plan(batch, k, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  *cluster = (int)attr.val.clusterDim.x;
  *smem_bytes = (int)cfg.dynamicSmemBytes;
  return (int)cudaOccupancyMaxActiveClusters(active_clusters, nms_kernel,
                                             &cfg);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
