// Occupancy of a persistent-grid kernel, shared by the allocator's
// launchers (gnep_sweep.cu, gnep_iter.cu): how many blocks of Kernel at
// Threads threads fit on one SM of the current device, and that device's SM
// count, queried once for each device and kept.
#pragma once

#include <atomic>
#include <cuda_runtime.h>

struct Fit {
  int per_sm, sms;
  long long resident() const { return (long long)per_sm * sms; }
};

// One cache for each kernel instantiation: Kernel is the kernel's address.
template <auto Kernel, int Threads>
Fit device_fit() {
  constexpr int kMaxDevices = 64;
  static std::atomic<long long> cached[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  long long packed = dev < kMaxDevices ? cached[dev].load() : 0;
  if (packed == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, Threads,
                                                  0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    packed = ((long long)(per_sm > 0 ? per_sm : 1) << 32)
             | (unsigned)(sms > 0 ? sms : 1);
    if (dev < kMaxDevices) cached[dev].store(packed);
  }
  return Fit{(int)(packed >> 32), (int)(packed & 0xffffffff)};
}
