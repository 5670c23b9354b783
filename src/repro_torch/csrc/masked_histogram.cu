// Masked per-column histogram on Hopper (sm_90a).
//
//   out[m, b] = sum_n w[n] * [codes[n, m] == b]        codes (N, M) int32,
//                                                       w (N,) f32, out (M, B) f32
//
// Replaces the Pallas TPU kernel `masked_histogram_pallas`
// (src/repro/kernels/entropy/kernel.py:45, body `masked_histogram_kernel` :23),
// which built a (rows x cols x B) one-hot in VMEM and contracted it on the MXU.
// A one-hot contraction is the TPU's way around a missing scatter; Hopper has
// fast shared-memory atomics, so this kernel scatters directly:
//
//   * one block per tile of `tile_m` columns; its (tile_m, B) counts live in
//     shared memory (the whole (M, B) output of the main path, 2300 x 256 f32,
//     does not fit one block, so columns are tiled);
//   * the block's threads stride over the (row, column-in-tile) cells and add
//     the row weight with a shared-memory atomicAdd;
//   * the tile is then written out whole, so bins no code reaches stay exactly 0.
//
// Rows are not split across blocks, so there is no cross-block reduction.
// With 0/1 weights every partial sum is an integer below 2^24 and the result is
// bit-exact whatever order the atomics land in; fractional weights may sum in a
// different order than the plain version (see kernels/entropy/kernel.py).
// Codes outside [0, B) are ignored.
//
// Bound on an H100 at the main-path shape (N = 322, M = 2300, B = 256): it reads
// 3.0 MB of codes and writes 2.4 MB of counts, ~1.6 us at 3.35 TB/s; the adds are
// negligible, so at that size it is bound by launch latency.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void masked_histogram_kernel(const int32_t* __restrict__ codes,
                                        const float* __restrict__ weights,
                                        float* __restrict__ out,
                                        int N, int M, int B, int tile_m) {
    extern __shared__ float hist[];  // (tile_m, B)
    const int col0 = blockIdx.x * tile_m;
    const int tm = min(tile_m, M - col0);
    for (int i = threadIdx.x; i < tm * B; i += blockDim.x) hist[i] = 0.0f;
    __syncthreads();

    const long long cells = (long long)N * tm;
    for (long long i = threadIdx.x; i < cells; i += blockDim.x) {
        const long long r = i / tm;
        const int c = (int)(i - r * tm);
        const int code = codes[r * M + col0 + c];
        if (code >= 0 && code < B) atomicAdd(&hist[c * B + code], weights[r]);
    }
    __syncthreads();

    float* dst = out + (long long)col0 * B;
    for (int i = threadIdx.x; i < tm * B; i += blockDim.x) dst[i] = hist[i];
}

// Returns a cudaError_t as int: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int launch_masked_histogram(const void* codes, const void* weights,
                                       void* out, int N, int M, int B,
                                       int tile_m, void* stream) {
    if (N < 0 || M <= 0 || B <= 0 || tile_m <= 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)tile_m * B * sizeof(float);   // the wrapper keeps it <= 48 KB
    const int blocks = (M + tile_m - 1) / tile_m;
    masked_histogram_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
        (const int32_t*)codes, (const float*)weights, (float*)out, N, M, B, tile_m);
    return (int)cudaGetLastError();
}
