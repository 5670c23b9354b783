// Fused Gen-DST generation step on Hopper (sm_90a): one-row delta update of each
// candidate's (M, B) histogram, then its masked-entropy fitness.
//
//   counts[p, m, old[p, m]] -= applied[p];  counts[p, m, new[p, m]] += applied[p]
//   h[p, m]  = -sum_b q log2 q,  q = counts[p, m, b] / max(sum_b counts[p, m, b], 1e-12)
//   f_d[p]   = sum_m h[p, m] cm[p, m] / max(sum_m cm[p, m], 1)
//   fit[p]   = -|f_d[p] - f_ref|
//
// Replaces the Pallas TPU kernel `fused_delta_fitness_pallas`
// (src/repro/kernels/gen_dst/kernel.py:77, body `fused_delta_fitness_kernel` :39).
// The TPU kernel held a slab of candidates in VMEM and applied the delta as a
// one-hot compare against a bin iota. Here:
//
//   * one block per candidate; each warp takes whole columns, its lanes stride
//     over the B bins of the column;
//   * the delta is two conditional adds per column, done in place on the counts
//     tensor (the TPU kernel aliased its output onto its input for the same
//     effect); the adds are the plain version's `-w` then `+w`, so the counts
//     come out bit-equal to it; only the (at most two) bins that change are
//     stored, and none when `applied[p]` is 0;
//   * the column total and the sum of q log2 q are warp-shuffle reductions, the
//     per-column entropies go to shared memory, and thread 0 takes the
//     column-masked mean and writes the fitness;
//   * the entropy and the mean accumulate in float64 and round to float32 once,
//     as the plain version does: float32 sums of ~256 terms near 8 bits carry
//     errors of ~1e-6 that depend on the summation order, which would leave the
//     kernel and the plain version that far apart.
//
// `f_ref` is read from device memory so the caller needs no host sync.
//
// Bound on an H100 at the main-path shape (P = 100, M = 23, B = 256): the counts
// are read once, ~2.4 MB, plus two stored bins per column where the delta is
// applied, ~0.7 us at 3.35 TB/s; the arithmetic (one float64 log2 per nonzero
// bin, at most ~0.6 M of them) is far below the float64 rate, so at that size
// it is bound by launch latency.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__global__ void fused_delta_fitness_kernel(float* __restrict__ counts,
                                           const int32_t* __restrict__ old_codes,
                                           const int32_t* __restrict__ new_codes,
                                           const float* __restrict__ applied,
                                           const bool* __restrict__ col_mask,
                                           const float* __restrict__ f_ref,
                                           float* __restrict__ fit,
                                           int M, int B) {
    extern __shared__ double h[];  // (M,) per-column entropy
    const int p = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const float w = applied[p];

    for (int m = warp; m < M; m += nwarps) {
        float* row = counts + ((long long)p * M + m) * B;
        const int oc = old_codes[(long long)p * M + m];
        const int nc = new_codes[(long long)p * M + m];
        double total = 0.0;
        for (int b = lane; b < B; b += 32) {
            float c = row[b];
            if (w != 0.0f && (b == oc || b == nc)) {   // at most two bins change
                if (b == oc) c = c + (-w);
                if (b == nc) c = c + w;
                row[b] = c;
            }
            total += (double)c;
        }
        total = fmax(warp_sum(total), 1e-12);
        double acc = 0.0;
        for (int b = lane; b < B; b += 32) {
            const double q = (double)row[b] / total;
            if (q > 0.0) acc += q * log2(fmax(q, 1e-30));
        }
        acc = warp_sum(acc);
        if (lane == 0) h[m] = -acc;
    }
    __syncthreads();

    if (threadIdx.x == 0) {
        double num = 0.0, den = 0.0;
        for (int m = 0; m < M; ++m) {
            if (col_mask[(long long)p * M + m]) {
                num += h[m];
                den += 1.0;
            }
        }
        fit[p] = (float)(-fabs(num / fmax(den, 1.0) - (double)f_ref[0]));
    }
}

// Returns a cudaError_t as int: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing; `counts` is updated in place.
extern "C" int launch_fused_delta_fitness(void* counts, const void* old_codes,
                                          const void* new_codes, const void* applied,
                                          const void* col_mask, const void* f_ref,
                                          void* fit, int P, int M, int B,
                                          void* stream) {
    if (P < 0 || M <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (P == 0) return (int)cudaSuccess;
    const size_t smem = (size_t)M * sizeof(double);   // the wrapper keeps it <= 48 KB
    fused_delta_fitness_kernel<<<P, 256, smem, (cudaStream_t)stream>>>(
        (float*)counts, (const int32_t*)old_codes, (const int32_t*)new_codes,
        (const float*)applied, (const bool*)col_mask, (const float*)f_ref,
        (float*)fit, M, B);
    return (int)cudaGetLastError();
}
