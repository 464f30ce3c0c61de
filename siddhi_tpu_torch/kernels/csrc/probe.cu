// Build-and-launch check for the port's CUDA kernels: y = x + 1 on int32.
//
// Replaces the capability probe of the JAX package
// (siddhi_tpu/kernels/probe.py, kernels_available -> _k).  It proves that
// nvcc built a library for this card and that a kernel from it launches
// on PyTorch's stream.  Bound by bytes: one int32 read and one written
// per element.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void add_one_kernel(const int32_t* __restrict__ x,
                               int32_t* __restrict__ y, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = x[i] + 1;
}

extern "C" int probe_add_one(const void* x, void* y, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    add_one_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (int32_t*)y, n);
    return (int)cudaGetLastError();
}
