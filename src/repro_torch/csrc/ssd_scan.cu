// Mamba-2 SSD chunked scan on Hopper (sm_90a), returning the final state.
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,   h_0 = 0
//   x (B, S, H, P), dt (B, S, H) f32, a (H,) f32, Bm/Cm (B, S, G, N), all in the
//   model's layout; head h reads group g = h / (H / G).
//   -> y (B, S, H, P) in x's dtype, h_final (B, H, P, N) f32.
//
// Replaces the Pallas TPU kernel `ssd_scan_pallas`
// (src/repro/kernels/ssd_scan/kernel.py:62, body `_ssd_kernel` :24), which walks a
// sequential grid axis over chunks with the (P, N) state in VMEM scratch. Here one
// block owns one (batch, head) and walks the chunks in a loop. Per chunk of length
// Q (the math of kernel.py:34-57):
//
//   la  = cumsum(dt * a)                                         (Q,)
//   y   = tril(C B^T o exp(la_i - la_j)) (x dt) + exp(la) o (C h^T)
//   h'  = h exp(la_Q) + (x dt)^T (B o exp(la_Q - la))
//
//   * B, C, dt and u = x * dt of the chunk, and the (P, N) state, live in shared
//     memory as float32 (rows padded by one float against bank conflicts);
//   * the cumulative log-decay is a run per lane and a warp scan over the staged dt
//     (one thread walking strided dt loads in order cost more than the products);
//   * the (Q, Q) decay-weighted matrix is built 32 query rows at a time, and only
//     for j <= i: exp(la_i - la_j) is never taken where la_i - la_j > 0, so nothing
//     overflows and no inf * 0 can make a NaN;
//   * the wrapper walks chunks of at most 64 (kernels/ssd_scan/kernel.py): the
//     quadratic intra-chunk work halves from Q = 128, and a 76 KB block lets three
//     blocks share an SM;
//   * a partial last chunk (S not a multiple of Q) is handled by its length L;
//   * x, B and C are read in place through their batch and position strides (views
//     into the conv output in the model), with no transpose and no repeat per head;
//   * the final state is written out (the TPU kernel does not): prefill hands it to
//     decode.
//
// Bound on an H100 at the zamba2 prefill shape (B 4, S 1024, H 80, P = N = 64,
// Q 64, bf16): ~92 MB of x, y, dt, B, C and the final state, 0.027 ms at
// 3.35 TB/s; the chunk products, BH (S/Q) 2 (Q^2 N + Q^2 P + 2 Q P N) = 10.7 GFLOP,
// would take 0.011 ms at the bf16 tensor-core rate. This kernel does them on the
// CUDA cores in float32, one multiply-add per two shared-memory loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TI = 32;   // query rows of the decay-weighted matrix built at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

size_t smem_bytes(int Q, int P, int N) {
    return sizeof(float) * ((size_t)2 * Q * (N + 1) + (size_t)Q * (P + 1) +
                            (size_t)P * (N + 1) + (size_t)TI * (Q + 1) + 4 * (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ h_out,
                int S, int H, int G, int P, int N, int Q,
                long long x_sb, long long x_ss, long long bc_sb, long long bc_ss) {
    extern __shared__ float smem[];
    const int ldn = N + 1, ldp = P + 1, ldq = Q + 1;
    float* Bs = smem;                 // (Q, ldn)
    float* Cs = Bs + Q * ldn;         // (Q, ldn)
    float* Us = Cs + Q * ldn;         // (Q, ldp): x * dt
    float* Hs = Us + Q * ldp;         // (P, ldn): the state entering the chunk
    float* At = Hs + P * ldn;         // (TI, ldq): decay-weighted C B^T rows
    float* la = At + TI * ldq;        // (Q,): log-decay from the chunk start
    float* e_in = la + Q;             // (Q,): exp(la)
    float* w_end = e_in + Q;          // (Q,): exp(la_last - la)
    float* dts = w_end + Q;           // (Q,): dt of the chunk

    const int tid = threadIdx.x;
    const int b = blockIdx.x / H, h = blockIdx.x - b * H;
    const int g = h / (H / G);
    const float ah = a[h];
    const T* xb = x + b * x_sb + (long long)h * P;
    const float* dtb = dt + (long long)b * S * H + h;
    const T* bb = bm + b * bc_sb + (long long)g * N;
    const T* cb = cm + b * bc_sb + (long long)g * N;
    T* yb = y + ((long long)b * S * H + h) * P;

    for (int i = tid; i < P * N; i += THREADS) {
        const int p = i / N, n = i - p * N;
        Hs[p * ldn + n] = 0.0f;
    }

    for (int c0 = 0; c0 < S; c0 += Q) {
        const int L = min(Q, S - c0);
        __syncthreads();   // the previous chunk's tiles are no longer read
        for (int j = tid; j < L; j += THREADS) dts[j] = dtb[(long long)(c0 + j) * H];
#pragma unroll 4
        for (int i = tid; i < L * N; i += THREADS) {
            const int j = i / N, n = i - j * N;
            const long long off = (long long)(c0 + j) * bc_ss + n;
            Bs[j * ldn + n] = to_f32(bb[off]);
            Cs[j * ldn + n] = to_f32(cb[off]);
        }
        __syncthreads();   // dts is written
#pragma unroll 4
        for (int i = tid; i < L * P; i += THREADS) {
            const int j = i / P, p = i - j * P;
            Us[j * ldp + p] = to_f32(xb[(long long)(c0 + j) * x_ss + p]) * dts[j];
        }
        if (tid < 32) {   // the cumulative log-decay: a run per lane, then a warp scan
            const int per = (L + 31) / 32, j0 = tid * per;
            float run = 0.0f;
            for (int k = 0; k < per; ++k) {
                const int j = j0 + k;
                if (j < L) {
                    run += dts[j] * ah;
                    la[j] = run;
                }
            }
            float incl = run;
            for (int off = 1; off < 32; off <<= 1) {
                const float v = __shfl_up_sync(0xffffffffu, incl, off);
                if (tid >= off) incl += v;
            }
            const float excl = incl - run;
            for (int k = 0; k < per; ++k) {
                const int j = j0 + k;
                if (j < L) la[j] += excl;
            }
        }
        __syncthreads();
        const float la_last = la[L - 1];
        for (int j = tid; j < L; j += THREADS) {
            e_in[j] = expf(la[j]);
            w_end[j] = expf(la_last - la[j]);
        }

        for (int i0 = 0; i0 < L; i0 += TI) {
            const int rows = min(TI, L - i0), cols = i0 + rows;
            __syncthreads();   // At is free; e_in and w_end are written
            for (int e = tid; e < rows * cols; e += THREADS) {
                const int ii = e / cols, j = e - ii * cols, i = i0 + ii;
                float val = 0.0f;
                if (j <= i) {
                    float dot = 0.0f;
                    for (int n = 0; n < N; ++n) dot = fmaf(Cs[i * ldn + n], Bs[j * ldn + n], dot);
                    val = dot * expf(la[i] - la[j]);
                }
                At[ii * ldq + j] = val;
            }
            __syncthreads();
            for (int e = tid; e < rows * P; e += THREADS) {
                const int ii = e / P, p = e - ii * P, i = i0 + ii;
                float intra = 0.0f;
                for (int j = 0; j <= i; ++j) intra = fmaf(At[ii * ldq + j], Us[j * ldp + p], intra);
                float inter = 0.0f;
                for (int n = 0; n < N; ++n) inter = fmaf(Cs[i * ldn + n], Hs[p * ldn + n], inter);
                yb[(long long)(c0 + i) * H * P + p] = from_f32<T>(intra + e_in[i] * inter);
            }
        }
        __syncthreads();   // every y row has read the entering state

        const float decay = expf(la_last);
        for (int e = tid; e < P * N; e += THREADS) {
            const int p = e / N, n = e - p * N;
            float acc = Hs[p * ldn + n] * decay;
            for (int j = 0; j < L; ++j)
                acc = fmaf(Us[j * ldp + p], Bs[j * ldn + n] * w_end[j], acc);
            Hs[p * ldn + n] = acc;
        }
    }
    __syncthreads();

    float* hb = h_out + ((long long)b * H + h) * P * N;
    for (int i = tid; i < P * N; i += THREADS) {
        const int p = i / N, n = i - p * N;
        hb[i] = Hs[p * ldn + n];
    }
}

template <typename T>
int launch_typed(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                 void* y, void* h_out, int B, int S, int H, int G, int P, int N, int Q,
                 long long x_sb, long long x_ss, long long bc_sb, long long bc_ss,
                 cudaStream_t stream) {
    const size_t smem = smem_bytes(Q, P, N);
    auto kernel = ssd_scan_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B * H, THREADS, smem, stream>>>(
        (const T*)x, (const float*)dt, (const float*)a, (const T*)bm, (const T*)cm, (T*)y,
        (float*)h_out, S, H, G, P, N, Q, x_sb, x_ss, bc_sb, bc_ss);
    return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing; the wrapper (kernels/ssd_scan/kernel.py) has
// checked shapes, dtypes and strides and chosen Q so that the tiles fit shared
// memory. x_sb/x_ss and bc_sb/bc_ss are the batch and position strides (in
// elements) of x and of Bm/Cm; their inner dims are contiguous.
extern "C" int launch_ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                               const void* cm, void* y, void* h_out, int B, int S, int H,
                               int G, int P, int N, int Q, long long x_sb, long long x_ss,
                               long long bc_sb, long long bc_ss, int is_bf16, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || N <= 0 || Q <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        return launch_typed<__nv_bfloat16>(x, dt, a, bm, cm, y, h_out, B, S, H, G, P, N, Q,
                                           x_sb, x_ss, bc_sb, bc_ss, s);
    return launch_typed<float>(x, dt, a, bm, cm, y, h_out, B, S, H, G, P, N, Q,
                               x_sb, x_ss, bc_sb, bc_ss, s);
}
