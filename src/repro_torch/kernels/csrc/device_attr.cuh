// Per-device caches of the CUDA attributes a launch needs.
//
// cudaFuncSetAttribute (the dynamic shared memory a kernel may take) and
// the occupancy-derived "room" (resident blocks on the whole card) are
// properties of a device, so each is asked once per (kernel, device) and
// kept under the device's ordinal: a launch on a second card sets its own
// attribute and reads its own room. The device is the calling thread's
// current device, which the Python wrappers make the tensors' device for
// every launch. The tables are guarded by one mutex, so concurrent first
// launches from several host threads (the sharded engine's pool) are safe;
// after the first launch a lookup costs a map search under the lock.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace device_attr {

// (kernel, device ordinal, threads, dynamic shared bytes); threads is -1
// for the shared-memory attribute
using Key = std::tuple<const void*, int, int, long long>;

inline std::mutex& table_mutex() {
  static std::mutex m;
  return m;
}

inline std::map<Key, long long>& table() {
  static std::map<Key, long long> t;
  return t;
}

// Lets `kernel` take up to `bytes` of dynamic shared memory on the current
// device, set once per (kernel, device): every caller asks one fixed size
// per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const Key key{(const void*)kernel, dev, -1, 0};
  std::lock_guard<std::mutex> lock(table_mutex());
  if (table().count(key)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) table()[key] = 1;
  return err;
}

// Resident blocks of `kernel` on the whole current device at `threads`
// threads and `smem` dynamic shared bytes a block.
template <typename K>
cudaError_t room(K kernel, int threads, size_t smem, long long* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const Key key{(const void*)kernel, dev, threads, (long long)smem};
  std::lock_guard<std::mutex> lock(table_mutex());
  auto it = table().find(key);
  if (it != table().end()) {
    *out = it->second;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  *out = (long long)per_sm * sms;
  table()[key] = *out;
  return cudaSuccess;
}

}  // namespace device_attr
