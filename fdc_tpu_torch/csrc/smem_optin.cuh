// Opt a kernel in to more than 48 KB of dynamic shared memory, once a
// device: cudaFuncSetAttribute costs host time on every launch otherwise.
// `done` is the kernel's own, a static of its launcher (every kernel of
// one signature has the same type K).

#pragma once

#include <cuda_runtime.h>

template <class K>
cudaError_t allow_smem(K* kern, int bytes, bool (&done)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}
