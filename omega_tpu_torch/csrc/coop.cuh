// What the two cooperative subcycle kernels (barotropic.cu, bt_gather.cu)
// share on the host: how many blocks of a kernel the card holds at once.
//
// A cooperative launch runs only when every block of its grid can be
// resident at once, so a launcher sizes its grid from the blocks an SM
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the SMs. The
// queries cost several microseconds of host time, more than a subcycle
// takes on the card, so each answer is kept per device, kernel, block and
// dynamic shared memory; the kernel's opt-in to the device's largest
// dynamic shared memory is set with the first query.
#pragma once

#include <mutex>

#include <cuda_runtime.h>

namespace omega {

// blocks of kernel `k` an SM of the current device holds at `threads` and
// `smem` bytes of dynamic shared memory (0 where `smem` is more than a
// block may opt into) into *blocks, the device's SMs into *sms; returns a
// CUDA error code or 0
template <typename K>
int coop_blocks(K* k, int threads, size_t smem, int* blocks, int* sms) {
  struct Entry {
    const void* k;
    int dev, threads;
    size_t smem;
    int blocks, sms;
  };
  constexpr int kEntries = 32;
  static std::mutex mu;
  static Entry seen[kEntries];
  static int count = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* const key = reinterpret_cast<const void*>(k);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < (count < kEntries ? count : kEntries); ++i) {
    const Entry& e = seen[i];
    if (e.k == key && e.dev == dev && e.threads == threads &&
        e.smem == smem) {
      *blocks = e.blocks;
      *sms = e.sms;
      return 0;
    }
  }
  int optin = 0, n_sms = 0, b = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, threads,
                                                          smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  seen[count % kEntries] = Entry{key, dev, threads, smem, b, n_sms};
  ++count;
  *blocks = b;
  *sms = n_sms;
  return 0;
}

}  // namespace omega
