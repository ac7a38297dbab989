// Included by every kernel source here. An extern "C" entry launches on
// the device that its tensors live on (the `device` argument) and gives the
// calling thread back its current device when it returns: PyTorch
// allocates and launches on the current device, so an entry that left it
// changed would misplace the caller's next work where one host thread
// serves several cards.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err != cudaSuccess) prev = -1;
    else if (prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
