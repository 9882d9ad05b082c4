// HBM streaming copy for Hopper (sm_90a).
//
// Replaces tpu_operator/validator/perf.py:measure_hbm_pallas_gbps, the
// Pallas kernel that streams an fp32 array HBM -> VMEM -> HBM in 2 MiB
// blocks: one read and one write per element, no arithmetic. The perf
// validator times it beside the elementwise scale-add probe, and the two
// must agree (HBM_STREAMING_BAND) for the probe's bandwidth to count as the
// card's streaming limit.
//
// Bound: device-memory bandwidth only. At the perf validator's default of
// 512 MiB the copy moves 2 x 536,870,912 B = 1,073,741,824 B, which takes at
// least 1,073,741,824 B / 3.35 TB/s = 0.32 ms on an H100 SXM5 (NVIDIA data
// sheet; a card under a lower power limit streams slower).
//
// Design: the whole copy is bytes in flight, so every thread moves 16 bytes
// per access (float4, 128-bit loads and stores, neighbouring threads on
// neighbouring addresses) in a grid-stride loop over the aligned body, with
// streaming cache hints (ld.global.cs / st.global.cs) since no element is
// read twice. A scalar head covers a source that is not 16-byte aligned and
// a scalar tail covers a count that is not a multiple of 4. When source and
// destination are misaligned relative to each other no float4 pairing
// exists and the whole range takes the scalar path. Indices are 64-bit, so
// arrays beyond 2^31 elements copy whole. The grid is a few blocks per SM:
// enough resident warps to keep the memory system saturated without
// launching one block per 4 KiB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
stream_copy_f32_kernel(const float* __restrict__ src, float* __restrict__ dst,
                       int64_t n, int64_t head, int64_t nvec) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  // scalar head: up to the first 16-byte boundary of src (the whole range
  // when src and dst cannot both be aligned)
  for (int64_t i = tid; i < head; i += stride) {
    dst[i] = src[i];
  }

  const float4* __restrict__ src4 = reinterpret_cast<const float4*>(src + head);
  float4* __restrict__ dst4 = reinterpret_cast<float4*>(dst + head);
  for (int64_t i = tid; i < nvec; i += stride) {
    __stcs(dst4 + i, __ldcs(src4 + i));
  }

  // scalar tail: fewer than 4 elements after the last whole float4
  const int64_t t = head + nvec * 4 + tid;
  if (t < n) {
    dst[t] = src[t];
  }
}

}  // namespace

extern "C" {

// Copies n fp32 elements src -> dst on `stream`. Returns the CUDA error of
// the launch (0 on success); the caller raises on anything else.
int tpuop_stream_copy_f32(const void* src, void* dst, int64_t n, void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  int64_t head = n;
  int64_t nvec = 0;
  if ((s & 15u) == (d & 15u) && (s & 3u) == 0) {
    head = static_cast<int64_t>(((16u - (s & 15u)) & 15u) / 4u);
    if (head > n) head = n;
    nvec = (n - head) / 4;
  }
  const int64_t work = nvec > head ? nvec : head;

  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t max_blocks = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;

  stream_copy_f32_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), n, head, nvec);
  return static_cast<int>(cudaGetLastError());
}

const char* tpuop_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
