// Fused Gen-DST generation step on Hopper (sm_90a): one-row delta update of each
// candidate's (M, B) histogram, then its masked-entropy fitness.
//
//   counts[p, m, old[p, m]] -= applied[p];  counts[p, m, new[p, m]] += applied[p]
//   h[p, m]  = -sum_b q log2 q,  q = counts[p, m, b] / max(sum_b counts[p, m, b], 1e-12)
//   f_d[p]   = sum_m h[p, m] cm[p, m] / max(sum_m cm[p, m], 1)
//   fit[p]   = -|f_d[p] - f_ref[p]|    (one f_ref for every p, or one per p)
//
// Replaces the Pallas TPU kernel `fused_delta_fitness_pallas`
// (src/repro/kernels/gen_dst/kernel.py:77, body `fused_delta_fitness_kernel` :39),
// which held a slab of candidates in VMEM and applied the delta as a one-hot
// compare against a bin iota.
//
// Bound on an H100 at the main-path shape (P = 100, M = 23, B = 256): the counts
// are read once, 2.36 MB, ~0.7 us at 3.35 TB/s; the float64 arithmetic is a few
// operations per nonzero bin (~0.6 M bins at most), far below the float64 rate.
// So the work is bound by bytes, and at this size in practice by latency: the
// launch, one round trip to device memory, and the reductions.  The design
// spends its effort there:
//
//   * One CTA per candidate, one warp per column (23 warps at D1; a CTA of 32
//     warps walks wider tables).  The warps read their columns straight from
//     device memory: each lane reads 16-byte vectors of its bins and keeps
//     three independent float64 sums (total, positive mass, c log2 c), so a
//     lane's loads and logs overlap; three shuffle reductions per column.
//   * Hopper's bulk asynchronous copy (TMA, `cp.async.bulk` completing on an
//     `mbarrier`, 1-D, so no tensor map is encoded on the host) stages an 8 KB
//     float64 table of log2(k), k < 1024, into each CTA's shared memory while
//     the warps load their first column's codes, mask bit and the delta.
//     Staging each candidate's whole counts slab the same way measured slower
//     than reading it from device memory at every shape tried: at D1 (23
//     columns) and at 100 columns, with a zero delta and with a delta on every
//     candidate (chip_ablation.py at commit b3bbcc9; PERF.md), so the slab is
//     not staged and every shape takes the same route.
//   * The delta is applied in place by one lane per column, as the plain
//     version's `-w` then `+w`, before the warp reads the column; nothing is
//     stored when `applied[p]` is 0.
//   * The entropy uses h = (C+ log2 T - sum_{c>0} c log2 c) / T with T the
//     column total and C+ its positive mass, the plain version's
//     -sum q log2 q with q = c / T rewritten; log2 of an integer count below
//     1024 comes from the table (a float64 log2 per bin cost ~2 us at D1), any
//     other value is computed.  Sums stay float64 and the fitness rounds to
//     float32 once, as in the plain version: float32 sums of ~256 terms near
//     8 bits carry order-dependent errors of ~1e-6.
//   * The column-masked mean is a shuffle reduction over the warps' partial
//     sums, then one thread writes the fitness.
//   * Filling the card at P = 100 on 132 SMs: splitting a candidate over a
//     thread-block cluster of 2 or 4 CTAs, whose partial sums met through
//     distributed shared memory, fills more SMs but measured slower at 23 and
//     at 100 columns (same script and commit), so a candidate is one CTA.
//
// Tensor cores have no role: the work is ~0.6 M independent bin reductions
// with a data-dependent log, no matrix product.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int MAX_WARPS = 32;
constexpr int LOG2_N = 1024;                            // table of log2(k), k < LOG2_N
constexpr int LOG2_BYTES = LOG2_N * 8;
constexpr int HEADER = 1024;                            // mbarrier and the warps' partial sums
constexpr int MAX_DEVICES = 64;

__device__ __align__(16) double g_log2_table[LOG2_N];
bool g_table_ready[MAX_DEVICES];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// returns once phase `parity` of `bar` has completed; a wait that never ends
// traps after ~2^26 polls, an error at the next synchronise, instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    for (uint32_t polls = 0; !done; ++polls) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (polls == (1u << 26)) __trap();
    }
}

// `bytes` (a multiple of 16) from 16-byte aligned device memory into shared
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ double log2_of(double c, const double* lg) {
    const int k = (int)c;
    if (k < LOG2_N && (double)k == c) return lg[k];
    return log2(c);
}

struct Sums { double total = 0.0, pos = 0.0, clogc = 0.0; };

__device__ __forceinline__ void add_bin(Sums& s, float c, const double* lg) {
    const double d = (double)c;
    s.total += d;
    if (c > 0.0f) {
        s.pos += d;
        s.clogc += d * log2_of(d, lg);
    }
}

// entropy of one column of B bins at `row`, by one warp
__device__ __forceinline__ double column_entropy(const float* row, int B, const double* lg,
                                                 int lane) {
    Sums s;
    if ((B & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
        const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll 2
        for (int i = lane; i < (B >> 2); i += 32) {
            const float4 v = r4[i];
            add_bin(s, v.x, lg);
            add_bin(s, v.y, lg);
            add_bin(s, v.z, lg);
            add_bin(s, v.w, lg);
        }
    } else {
        for (int b = lane; b < B; b += 32) add_bin(s, row[b], lg);
    }
    const double total = fmax(warp_sum(s.total), 1e-12);
    const double pos = warp_sum(s.pos);
    const double clogc = warp_sum(s.clogc);
    return (pos * log2_of(total, lg) - clogc) / total;
}

// one CTA per candidate, one warp per column
__global__ void __launch_bounds__(MAX_WARPS * 32)
fused_delta_fitness_kernel(float* __restrict__ counts, const int32_t* __restrict__ old_codes,
                           const int32_t* __restrict__ new_codes,
                           const float* __restrict__ applied, const bool* __restrict__ col_mask,
                           const float* __restrict__ f_ref, float* __restrict__ fit,
                           int M, int B, int f_ref_step) {
    // dynamic shared memory: the same layout in static arrays measured slower
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t& bar = *reinterpret_cast<uint64_t*>(smem);
    double* warp_num = reinterpret_cast<double*>(smem + 64);           // [MAX_WARPS]
    double* warp_den = warp_num + MAX_WARPS;                           // [MAX_WARPS]
    double* lg = reinterpret_cast<double*>(smem + HEADER);             // [LOG2_N]
    const int p = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;

    if (threadIdx.x == 0) mbar_init(&bar, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(&bar, LOG2_BYTES);
        bulk_load(lg, g_log2_table, LOG2_BYTES, &bar);
    }

    // while the table flies: the delta and this warp's first column's operands
    const float w = applied[p];
    int m = warp;
    int oc = 0, nc = 0;
    bool keep = false;
    if (m < M) {
        oc = old_codes[(size_t)p * M + m];
        nc = new_codes[(size_t)p * M + m];
        keep = col_mask[(size_t)p * M + m];
    }
    mbar_wait(&bar, 0);

    double num = 0.0, den = 0.0;
    for (; m < M; m += nwarps) {
        float* row = counts + ((size_t)p * M + m) * B;
        if (lane == 0 && w != 0.0f) {          // at most two bins change
            if ((unsigned)oc < (unsigned)B) row[oc] = row[oc] + (-w);
            if ((unsigned)nc < (unsigned)B) row[nc] = row[nc] + w;
        }
        __syncwarp();
        const double h = column_entropy(row, B, lg, lane);
        if (keep) {
            num += h;
            den += 1.0;
        }
        const int next = m + nwarps;
        if (next < M) {
            oc = old_codes[(size_t)p * M + next];
            nc = new_codes[(size_t)p * M + next];
            keep = col_mask[(size_t)p * M + next];
        }
    }

    // the masked mean: the warps' partial sums by shuffles
    if (lane == 0) {
        warp_num[warp] = num;
        warp_den[warp] = den;
    }
    __syncthreads();
    if (warp == 0) {
        num = warp_sum(lane < nwarps ? warp_num[lane] : 0.0);
        den = warp_sum(lane < nwarps ? warp_den[lane] : 0.0);
        if (lane == 0) {
            const double f = (double)f_ref[(size_t)p * f_ref_step];
            fit[p] = (float)(-fabs(num / fmax(den, 1.0) - f));
        }
    }
}

}  // namespace

// Returns a cudaError_t as int: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing; `counts` is updated in place.  Candidate p
// reads f_ref[p * f_ref_step]: one F(D) for all (step 0) or one per candidate
// (step 1), as when several datasets' searches share a launch.  The first
// call on a device also fills the device's log2 table, a synchronous 8 KB copy
// from the host (so not inside a CUDA graph capture).
extern "C" int launch_fused_delta_fitness(void* counts, const void* old_codes,
                                          const void* new_codes, const void* applied,
                                          const void* col_mask, const void* f_ref,
                                          void* fit, int P, int M, int B, int f_ref_step,
                                          void* stream) {
    if (P < 0 || M <= 0 || B <= 0 || (f_ref_step != 0 && f_ref_step != 1))
        return (int)cudaErrorInvalidValue;
    if (P == 0) return (int)cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!g_table_ready[dev]) {
        static double table[LOG2_N];
        for (int k = 1; k < LOG2_N; ++k) table[k] = std::log2((double)k);
        err = cudaMemcpyToSymbol(g_log2_table, table, sizeof(table));
        if (err != cudaSuccess) return (int)err;
        g_table_ready[dev] = true;
    }
    fused_delta_fitness_kernel<<<P, 32 * (M < MAX_WARPS ? M : MAX_WARPS), HEADER + LOG2_BYTES,
                                 (cudaStream_t)stream>>>(
        (float*)counts, (const int32_t*)old_codes, (const int32_t*)new_codes,
        (const float*)applied, (const bool*)col_mask, (const float*)f_ref, (float*)fit, M, B,
        f_ref_step);
    return (int)cudaGetLastError();
}
