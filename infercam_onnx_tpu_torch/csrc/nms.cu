// Greedy hard-NMS suppression for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel infercam_onnx_tpu/ops/pallas/nms.py
// (_nms_kernel, launched by greedy_suppress). Same contract: per image,
// candidates in descending-confidence order, candidate i is kept iff it
// is valid (> 0.5) and no kept j < i has iou(j, i) > max_iou. The IoU is
// the reference's: EPS = 1e-7 in the denominator, zero area for
// ill-formed (negative-extent) overlap boxes, NaN propagated by max/min.
//
// Bound on this card: the data is tiny (B*K*6*4 bytes, ~98 KB at B=16,
// K=256) and the IoU work is ~K^2/2 pairs per image, microseconds at
// the card's float32 rate. What bounds it is the latency of the K-step
// dependent greedy scan. The design keeps each step to one shared-memory
// word per lane:
//   phase 1: all threads of the CTA build the upper-triangular
//            suppression bitmask mask[j][w] (uint64 words) in shared
//            memory, 64 IoUs per thread-item;
//   phase 2: one warp scans i = 0..K-1. Lane w owns word w of the
//            "removed" set; the owner of bit i decides keep[i] and
//            broadcasts it with __shfl_sync; a kept i ORs mask[i][lane]
//            into every lane's word.
// One CTA per image (grid = B). K is padded inside the kernel to a
// multiple of 64; pad candidates are never visited.
//
// Bit-exactness with the plain PyTorch version needs the same float
// formula in the same order and no contraction: build with -fmad=false,
// without --use_fast_math (IEEE division).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;  // 16 words per row; 152 KB of shared memory
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;  // torch.maximum: NaN wins
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float area(float w, float h) {
  return (w < 0.f || h < 0.f) ? 0.f : w * h;
}

size_t shared_bytes(int words) {
  const size_t kp = (size_t)words * 64;
  return kp * words * sizeof(uint64_t) + 6 * kp * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes_t,  // [B, 4, K]
           const float* __restrict__ valid,    // [B, 1, K]
           float* __restrict__ keep,           // [B, 1, K]
           int k, int words, float max_iou) {
  extern __shared__ uint64_t smem[];
  const int kp = words * 64;
  uint64_t* mask = smem;  // [kp][words], row j = candidates j suppresses
  float* x0 = reinterpret_cast<float*>(mask + (size_t)kp * words);
  float* y0 = x0 + kp;
  float* x1 = y0 + kp;
  float* y1 = x1 + kp;
  float* ar = y1 + kp;
  float* flag = ar + kp;  // valid in, keep out

  const int b = blockIdx.x;
  const float* bx = boxes_t + (size_t)b * 4 * k;
  for (int t = threadIdx.x; t < kp; t += blockDim.x) {
    float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f, v = 0.f;
    if (t < k) {
      a0 = bx[t];
      b0 = bx[k + t];
      a1 = bx[2 * k + t];
      b1 = bx[3 * k + t];
      v = valid[(size_t)b * k + t];
    }
    x0[t] = a0;
    y0[t] = b0;
    x1[t] = a1;
    y1[t] = b1;
    ar[t] = area(a1 - a0, b1 - b0);
    flag[t] = v;
  }
  __syncthreads();

  // phase 1: mask[j][w] bit t set iff i = 64w + t > j, i < k and
  // iou(j, i) > max_iou
  for (int item = threadIdx.x; item < k * words; item += blockDim.x) {
    const int j = item / words;
    const int w = item - j * words;
    const int i0 = w * 64;
    uint64_t bits = 0;
    if (i0 + 63 > j) {
      const float jx0 = x0[j], jy0 = y0[j], jx1 = x1[j], jy1 = y1[j];
      const float ja = ar[j];
      for (int t = 0; t < 64; ++t) {
        const int i = i0 + t;
        if (i <= j || i >= k) continue;
        const float tlx = max_nan(jx0, x0[i]);
        const float tly = max_nan(jy0, y0[i]);
        const float brx = min_nan(jx1, x1[i]);
        const float bry = min_nan(jy1, y1[i]);
        const float inter = area(brx - tlx, bry - tly);
        const float uni = (ja + ar[i]) - inter;
        const float iou = inter / (uni + kEps);
        if (iou > max_iou) bits |= 1ull << t;
      }
    }
    mask[(size_t)j * words + w] = bits;
  }
  __syncthreads();

  // phase 2: the sequential greedy scan, one warp
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint64_t removed = 0;
    for (int i = 0; i < k; ++i) {
      const int owner = i >> 6;
      int kept = 0;
      if (lane == owner) {
        kept = flag[i] > 0.5f && !((removed >> (i & 63)) & 1ull);
        flag[i] = kept ? 1.f : 0.f;
      }
      kept = __shfl_sync(0xffffffffu, kept, owner);
      if (kept && lane < words) removed |= mask[(size_t)i * words + lane];
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    keep[(size_t)b * k + t] = flag[t];
  }
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
  const int words = (k + 63) / 64;
  const size_t smem = shared_bytes(words);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      boxes_t, valid, keep, k, words, max_iou);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
