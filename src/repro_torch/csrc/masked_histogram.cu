// Masked per-column histogram on Hopper (sm_90a), with an optional row gather.
//
//   out[c, b] = sum_r w[r] * [F[r, c] == b]          out (C, B) f32, w (R,) f32 or 1
//
//   F = codes                          (no row index: R = N rows, C = M columns)
//   F[r, p*M + j] = codes[rows[p, r], j]   (row index rows (P, R) int32: C = P*M)
//
// With no row index this is the Pallas TPU kernel `masked_histogram_pallas`
// (src/repro/kernels/entropy/kernel.py:45, body `masked_histogram_kernel` :23),
// which built a (rows x cols x B) one-hot in VMEM and contracted it on the MXU.
// With the index it is that kernel on the fold the JAX package's
// `population_histogram` (entropy/ops.py:83) builds from `codes[rows]`
// transposed to (R, P*M): the gather and the transpose happen in the kernel's
// loads, so the caller launches one kernel where it launched a cast, a gather,
// a copy, a fill and the histogram.
//
// Bound on an H100 at the main-path shape (P = 100, R = 322 rows, M = 23, B = 256):
// the gathered codes, 3.0 MB (from the 9.6 MB table, which sits in the 50 MB L2
// after the first generation), the row index, 0.13 MB, and 2.4 MB of counts
// written; ~1.6 us at 3.35 TB/s.  The adds are negligible.  At that size it is
// bound by latency: one round trip for the row index, one for the codes, the
// shared-memory atomics and the store.  What the design does about it:
//
//   * one block of 512 threads per tile of `tile` fold columns (a power of two
//     up to 32; by measurement 8, and 16 with weights), its (tile, B) counts
//     in shared memory: at D1 288 blocks of 8 KB, all resident at once, up to
//     four per SM;
//   * with uniform weights (the gathered entry) the shared counts are integers
//     and each cell is one integer shared-memory atomic add; a float32 add,
//     which weights need, is a compare-and-swap loop in shared memory
//     (ATOMS.CAST.SPIN in the SASS) and measured 2.5x slower for the uniform
//     path; integer counts below 2^24 convert to float32 exactly;
//   * a warp's lanes cover `tile` columns of 32 / tile rows, so no two lanes of
//     an instruction add into the same column unless they also hold different
//     rows (the compiler turns the constant +1 into a warp-aggregated
//     increment, which measured faster than aggregating equal codes with
//     __match_any_sync); padding the counts' rows to an odd stride, so that
//     equal codes of different columns fall in different banks, measured
//     slower with integer counts and faster with float adds, so only the
//     weighted path pads, and takes tiles of 16;
//   * each thread issues a batch of BATCH row-index loads, then BATCH code (and
//     weight) loads, and only then its BATCH atomics, so a thread waits for one
//     round trip per batch, not one per cell (measured faster than a load per
//     atomic); the index math is 32-bit, with one widening multiply per code
//     address;
//   * the tile is written out with 16-byte stores where the output is aligned.
//
// Rows are not split across blocks, so there is no cross-block reduction.
// With 0/1 weights every partial sum is an integer below 2^24 and the result is
// bit-exact whatever order the atomics land in; fractional weights may sum in a
// different order than the plain version (see kernels/entropy/kernel.py).
// Codes outside [0, B) are ignored.  A row index outside [0, N) traps: an
// error at the next synchronise that leaves the CUDA context unusable, as a
// device-side assert of PyTorch's own indexing does; the host does not check
// the indices, which would wait for the device.  No tensor-core or TMA path:
// the gathered rows are 92-byte pieces of the table, and the work is a
// scatter.  The measurements behind each choice (chip_ablation.py with the
// variants built by compile-time switches, at commit b3bbcc9) are in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int BATCH = 8;
constexpr int SMEM_LIMIT = 232448;     // a block's shared memory on Hopper

// row stride of the shared counts: odd (B | 1) for float adds, whose
// compare-and-swap loops then meet fewer bank conflicts; B for integer counts
template <bool WEIGHTED>
__host__ __device__ __forceinline__ int padded_stride(int B) {
    return WEIGHTED ? (B | 1) : B;
}

// bin value of the shared counts: float32 sums (weighted) or integer counts
template <bool WEIGHTED>
__device__ __forceinline__ float bin_value(uint32_t raw) {
    return WEIGHTED ? __uint_as_float(raw) : (float)raw;
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(THREADS)
masked_histogram_kernel(const int32_t* __restrict__ codes, const float* __restrict__ weights,
                        const int32_t* __restrict__ rows, float* __restrict__ out,
                        int N, int M, int B, int R, int C, int tile) {
    extern __shared__ uint32_t hist[];  // (tile, bs): float32 bits, or integer counts
    const int bs = padded_stride<WEIGHTED>(B);
    const int c0 = blockIdx.x * tile;
    const int tc = min(tile, C - c0);
    for (int i = threadIdx.x; i < tc * bs; i += THREADS) hist[i] = 0u;

    const int lane = threadIdx.x & 31;
    const int per_warp = 32 / tile;                       // rows a warp covers at once
    const int cc = lane & (tile - 1);                     // column in the tile
    const int step = (THREADS / 32) * per_warp;           // rows the block covers at once
    const int r0 = (threadIdx.x >> 5) * per_warp + lane / tile;
    const int c = c0 + cc;
    const int p = rows ? c / M : 0;                       // candidate of the fold column
    const int j = c - p * M;                              // its column of `codes`
    const int32_t* ridx = rows ? rows + (size_t)p * R : nullptr;
    const int32_t* col = codes + j;
    uint32_t* h = hist + cc * bs;
    __syncthreads();

    if (cc < tc) {
        for (int r = r0; r < R; r += BATCH * step) {
            int row[BATCH];
#pragma unroll
            for (int k = 0; k < BATCH; ++k) {
                const int rr = r + k * step;
                row[k] = rr < R ? (ridx ? ridx[rr] : rr) : -1;
            }
            int code[BATCH];
            float wt[BATCH];
#pragma unroll
            for (int k = 0; k < BATCH; ++k) {
                code[k] = -1;
                wt[k] = 1.0f;
                if (r + k * step < R) {
                    if ((unsigned)row[k] >= (unsigned)N) __trap();
                    code[k] = col[(size_t)row[k] * M];
                    if (WEIGHTED) wt[k] = weights[r + k * step];
                }
            }
#pragma unroll
            for (int k = 0; k < BATCH; ++k) {
                if ((unsigned)code[k] >= (unsigned)B) continue;
                if (WEIGHTED)
                    atomicAdd(reinterpret_cast<float*>(h + code[k]), wt[k]);
                else
                    atomicAdd(h + code[k], 1u);
            }
        }
    }
    __syncthreads();

    float* dst = out + (size_t)c0 * B;
    const int total = tc * B;
    const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (total & 3) == 0;
    if (vec) {
        for (int i = threadIdx.x * 4; i < total; i += THREADS * 4) {
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int e = i + k;
                const int col_e = e / B;
                v[k] = bin_value<WEIGHTED>(hist[col_e * bs + (e - col_e * B)]);
            }
            *reinterpret_cast<float4*>(dst + i) = make_float4(v[0], v[1], v[2], v[3]);
        }
    } else {
        for (int e = threadIdx.x; e < total; e += THREADS) {
            const int col_e = e / B;
            dst[e] = bin_value<WEIGHTED>(hist[col_e * bs + (e - col_e * B)]);
        }
    }
}

template <bool WEIGHTED>
cudaError_t launch(const int32_t* codes, const float* weights, const int32_t* rows, float* out,
                   int N, int M, int B, int R, int C, int tile, cudaStream_t stream) {
    const size_t smem = (size_t)tile * padded_stride<WEIGHTED>(B) * sizeof(uint32_t);
    if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            masked_histogram_kernel<WEIGHTED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int blocks = (C + tile - 1) / tile;
    masked_histogram_kernel<WEIGHTED><<<blocks, THREADS, smem, stream>>>(
        codes, weights, rows, out, N, M, B, R, C, tile);
    return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing.  `codes` is (N, M) int32; `weights` is
// (R,) float32, or null for weights of 1; `rows` is (P, R) int32, or null (then
// P is 1 and R is N); `out` is (P*M, B) float32.  `tile` is the fold columns per
// block, a power of two from 1 to 32; its counts, `tile` rows of B (B | 1 with
// weights) 32-bit words, must fit 227 KB.
extern "C" int launch_masked_histogram(const void* codes, const void* weights,
                                       const void* rows, void* out, int N, int M, int B,
                                       int P, int R, int tile, void* stream) {
    if (N < 0 || M <= 0 || B <= 0 || P <= 0 || R < 0 || tile <= 0 || tile > 32 ||
        (tile & (tile - 1)) != 0 || (!rows && (P != 1 || R != N)))
        return (int)cudaErrorInvalidValue;
    const long long C = (long long)P * M;
    if (C > 0x7fffffffLL - 32) return (int)cudaErrorInvalidValue;
    auto c = (const int32_t*)codes;
    auto w = (const float*)weights;
    auto r = (const int32_t*)rows;
    auto o = (float*)out;
    auto s = (cudaStream_t)stream;
    const cudaError_t err = w ? launch<true>(c, w, r, o, N, M, B, R, (int)C, tile, s)
                              : launch<false>(c, w, r, o, N, M, B, R, (int)C, tile, s);
    return (int)err;
}
