// HBM streaming copy for Hopper (sm_90a).
//
// Replaces tpu_operator/validator/perf.py:measure_hbm_pallas_gbps, the
// Pallas kernel that streams an fp32 array HBM -> VMEM -> HBM in 2 MiB
// double-buffered blocks: one read and one write per element, no
// arithmetic. The perf validator times it beside the elementwise scale-add
// probe, and the two must agree (HBM_STREAMING_BAND) for the probe's
// bandwidth to count as the card's streaming limit.
//
// Bound: device-memory bandwidth only. At the perf validator's default of
// 512 MiB the copy moves 2 x 536,870,912 B = 1,073,741,824 B, which takes at
// least 1,073,741,824 B / 3.35 TB/s = 0.32 ms on an H100 SXM5 (NVIDIA data
// sheet; a card under a lower power limit streams slower).
//
// Design: a copy needs many bytes in flight and no instruction per byte, so
// the aligned body moves through the Tensor Memory Accelerator as 1-D bulk
// copies (cp.async.bulk, no tensor map) global -> shared -> global, as the
// TPU kernel streams through VMEM. CTA b copies chunks [b * kRun, b * kRun +
// kRun), one shared-memory buffer and one mbarrier per chunk, and one thread
// drives it: it issues every load (mbarrier.arrive.expect_tx, then the bulk
// load), waits for each chunk's barrier in turn, issues that chunk's bulk
// store, and ends with wait_group 0 so the buffers outlive the stores that
// read them. The buffers are written and read by the async proxy only (bulk
// load, bulk store), so no proxy fence is needed between a load and its
// store; the one generic-proxy write, mbarrier.init, is fenced before the
// first bulk load.
//
// What the card rewards is a compact window: the bytes in flight should be
// about what covers the memory latency (some 8 MiB on an H100) and lie
// close together. CTAs start in address order, so the window moves through
// the array as a plain copy's does, and the dynamic shared-memory request
// is raised to the SM's share for kCtasPerSm CTAs, which caps how many CTAs,
// and so how many bytes, are in flight per SM: 132 SMs x 2 CTAs x 2 chunks x
// 16 KiB = 8.25 MiB. A persistent grid (one CTA per SM, chunks blockIdx.x +
// k * gridDim.x, a refilled ring) lets the CTAs drift apart and measured
// about 4% slower; a window of three times the size about 1% slower
// (PERF.md).
//
// The launch plan (kernels/stream_copy.py:launch_plan) is computed by the
// caller and validated here: a scalar head of fewer than 4 elements up to
// the first 16-byte boundary (bulk copies need 16-byte-aligned global
// addresses on both ends and sizes that are multiples of 16 B), n_chunks
// bulk chunks of kChunkBytes with a last one of last_bytes, and a scalar
// tail of fewer than 4 elements. When source and destination are
// misaligned relative to each other no bulk pairing exists: the plan is
// then head = n, no chunks, and the whole range takes a grid-stride scalar
// loop. Byte offsets are 64-bit, so arrays beyond 4 GiB copy whole.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBulkThreads = 32;  // lane 0 drives the copies; lanes 0-3 copy head and tail
constexpr int64_t kChunkBytes = 16 * 1024;  // one bulk copy; kernels/stream_copy.py:CHUNK_BYTES
constexpr int kRun = 2;                     // chunks per CTA, a buffer and an mbarrier each
constexpr int kCtasPerSm = 2;               // resident CTAs per SM, capped by shared memory
constexpr int kScalarThreads = 256;
constexpr int kScalarBlocksPerSm = 8;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kBulkThreads)
stream_copy_f32_bulk_kernel(const float* __restrict__ src, float* __restrict__ dst,
                            int64_t n, int head, int tail, int64_t n_chunks,
                            uint32_t last_bytes) {
  extern __shared__ __align__(128) unsigned char bufs[];

  if (blockIdx.x == 0) {
    const int lane = static_cast<int>(threadIdx.x);
    if (lane < head) dst[lane] = src[lane];
    if (lane < tail) dst[n - tail + lane] = src[n - tail + lane];
  }
  if (threadIdx.x != 0) return;

  const char* body_src = reinterpret_cast<const char*>(src + head);
  char* body_dst = reinterpret_cast<char*>(dst + head);
  const uint32_t buf0 = shared_addr(bufs);
  const uint32_t bar0 = buf0 + kRun * static_cast<uint32_t>(kChunkBytes);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRun;
  const int count = n_chunks - first < kRun ? static_cast<int>(n_chunks - first) : kRun;
  auto bytes_of = [&](int64_t c) {
    return c == n_chunks - 1 ? last_bytes : static_cast<uint32_t>(kChunkBytes);
  };

  for (int i = 0; i < count; ++i) mbar_init(bar0 + 8u * i);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

  for (int i = 0; i < count; ++i) {
    const uint32_t bytes = bytes_of(first + i);
    mbar_expect_tx(bar0 + 8u * i, bytes);
    bulk_load(buf0 + i * static_cast<uint32_t>(kChunkBytes),
              body_src + (first + i) * kChunkBytes, bytes, bar0 + 8u * i);
  }
  for (int i = 0; i < count; ++i) {
    mbar_wait(bar0 + 8u * i, 0);
    bulk_store(body_dst + (first + i) * kChunkBytes,
               buf0 + i * static_cast<uint32_t>(kChunkBytes), bytes_of(first + i));
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(kScalarThreads)
stream_copy_f32_scalar_kernel(const float* __restrict__ src, float* __restrict__ dst,
                              int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    __stcs(dst + i, __ldcs(src + i));
  }
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" {

// Copies n fp32 elements src -> dst on `stream` by the launch plan (head,
// chunk_bytes, n_chunks, last_bytes, tail), kRun chunks per CTA.
// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a plan that does not cover [0, n) exactly with
// aligned bulk copies of kChunkBytes; the caller raises on anything but 0.
int tpuop_stream_copy_f32(const void* src, void* dst, int64_t n, int64_t head,
                          int64_t chunk_bytes, int64_t n_chunks, int64_t last_bytes,
                          int64_t tail, void* stream) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  if (n <= 0 || head < 0 || tail < 0 || n_chunks < 0 || ((s | d) & 3u) != 0) return kInvalid;

  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (n_chunks == 0) {  // no bulk body: the whole range is scalar
    if (head != n || tail != 0 || last_bytes != 0) return kInvalid;
    int64_t blocks = (n + kScalarThreads - 1) / kScalarThreads;
    const int64_t max_blocks = static_cast<int64_t>(sms) * kScalarBlocksPerSm;
    if (blocks > max_blocks) blocks = max_blocks;
    stream_copy_f32_scalar_kernel<<<static_cast<unsigned int>(blocks), kScalarThreads, 0, st>>>(
        static_cast<const float*>(src), static_cast<float*>(dst), n);
    return static_cast<int>(cudaGetLastError());
  }

  if (head >= 4 || tail >= 4 || chunk_bytes != kChunkBytes) return kInvalid;
  if (last_bytes <= 0 || last_bytes > kChunkBytes || last_bytes % 16 != 0) return kInvalid;
  if (n_chunks > (n * 4) / kChunkBytes + 1) return kInvalid;  // keeps the sum below from overflowing
  const int64_t body_bytes = (n_chunks - 1) * kChunkBytes + last_bytes;
  if (head + body_bytes / 4 + tail != n) return kInvalid;
  if (((s + 4 * head) & 15u) != 0 || ((d + 4 * head) & 15u) != 0) return kInvalid;
  const int64_t grid = (n_chunks + kRun - 1) / kRun;
  if (grid > 0x7fffffff) return kInvalid;

  int smem_optin = 0;
  int smem_sm = 0;
  int smem_reserved = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the buffers and barriers, raised to the SM's share for kCtasPerSm CTAs
  int64_t smem = kRun * (kChunkBytes + 8);
  const int64_t share = smem_sm / kCtasPerSm - smem_reserved;
  if (share > smem) smem = share < smem_optin ? share : smem_optin;
  if (smem > smem_optin) return kInvalid;

  err = cudaFuncSetAttribute(stream_copy_f32_bulk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_copy_f32_bulk_kernel<<<static_cast<unsigned int>(grid), kBulkThreads, static_cast<size_t>(smem), st>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), n, static_cast<int>(head),
      static_cast<int>(tail), n_chunks, static_cast<uint32_t>(last_bytes));
  return static_cast<int>(cudaGetLastError());
}

const char* tpuop_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
