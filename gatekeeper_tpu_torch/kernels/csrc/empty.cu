// An empty kernel: its device time is the launch floor that every kernel of
// the port pays (`python3 chip_smoke.py --probe` times it beside K1-K4).
// Not on any path of the port.

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int gk_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
