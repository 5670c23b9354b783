// Causal GQA flash attention (forward) on Hopper (sm_90a).
//
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, kh, :] * scale) v[b, j, kh, :]
//   q (B, Sq, H, hd), k/v (B, Skv, Kh, hd), o (B, Sq, H, hd), all in the model's
//   layout; kh = h / (H / Kh); causal keeps j <= i (both counted from 0).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:78, body `_fa_kernel` :26). The TPU
// kernel walks a sequential grid axis over key tiles with its running max, sum and
// accumulator in VMEM scratch. Here one block owns one (batch * head, query tile)
// and walks the key tiles in a loop, so nothing carries between blocks:
//
//   * the block's 64 query rows (pre-scaled) and each 64-row K and V tile are held
//     in shared memory as float32, rows padded by one float so that the strided
//     reads of the score and PV loops fall in distinct banks;
//   * 256 threads as 16 x 16; each computes a 4 x 4 patch of the score tile and
//     owns 4 query rows x ceil(hd / 16) columns of the float32 accumulator in
//     registers (SLOTS columns per row, a compile-time bound on hd);
//   * the online softmax keeps the running max and sum per row in shared memory;
//     four threads share a row and reduce with warp shuffles;
//   * K/V rows of KV head h / (H / Kh) are read in place (no copy per query head);
//     key tiles wholly above the diagonal are never loaded;
//   * a masked score is -inf and never reaches exp: p = 0 for it, and a row whose
//     running max is still -inf (only a ragged tail row past Sq) rescales by 0.
//     The denominator is clamped at 1e-30 as kernel.py:70-72 does.
//
// Ragged Sq and Skv are masked in the kernel; no padding is needed.
//
// Bound on an H100: 4 * B * H * hd * S(S+1)/2 float operations for the causal
// product; at the zamba2 prefill shape (B 4, S 1024, H 32, hd 80) that is
// 21.5 GFLOP, 0.022 ms at the 989 TFLOP/s bf16 tensor-core rate, against 0.025 ms
// for its 84 MB of q, k, v and o at 3.35 TB/s. This first kernel does its
// products on the CUDA cores in float32 from shared memory (no wgmma, no TMA),
// so it is far from both; chip_smoke.py times it beside its bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;  // thread grid of the score and accumulator patches
constexpr int RQ = BQ / TY;     // query rows per thread
constexpr int RK = BK / TX;     // key columns per thread
constexpr int LDP = BK + 1;     // padded row of the probability tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

size_t smem_bytes(int hd) {
    const size_t ld = hd + 1;
    return sizeof(float) * (BQ * ld + 2 * BK * ld + BQ * LDP + 3 * BQ);
}

template <typename T, int SLOTS>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Sq, int Skv, int H, int Kh, int hd, float scale, int causal) {
    extern __shared__ float smem[];
    const int ld = hd + 1;
    float* Qs = smem;                 // (BQ, ld), scaled
    float* Ks = Qs + BQ * ld;         // (BK, ld)
    float* Vs = Ks + BK * ld;         // (BK, ld)
    float* Ps = Vs + BK * ld;         // (BQ, LDP): scores, then probabilities
    float* m_s = Ps + BQ * LDP;       // running max per row
    float* l_s = m_s + BQ;            // running sum per row
    float* a_s = l_s + BQ;            // this tile's rescale factor per row

    const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int kh = h / (H / Kh);
    const int q0 = blockIdx.x * BQ;
    const long long q_row = (long long)H * hd;     // stride between positions of q and o
    const long long kv_row = (long long)Kh * hd;   // ... of k and v
    const T* qb = q + ((long long)b * Sq * H + h) * hd;
    const T* kb = k + ((long long)b * Skv * Kh + kh) * hd;
    const T* vb = v + ((long long)b * Skv * Kh + kh) * hd;
    T* ob = o + ((long long)b * Sq * H + h) * hd;

    for (int i = tid; i < BQ * hd; i += THREADS) {
        const int r = i / hd, d = i - r * hd, s = q0 + r;
        Qs[r * ld + d] = s < Sq ? to_f32(qb[s * q_row + d]) * scale : 0.0f;
    }
    if (tid < BQ) {
        m_s[tid] = -INFINITY;
        l_s[tid] = 0.0f;
    }

    float acc[RQ][SLOTS];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) acc[i][j] = 0.0f;

    // causal: no key tile beyond the last real query row of this block
    const int q_last = min(q0 + BQ, Sq) - 1;
    int n_tiles = (Skv + BK - 1) / BK;
    if (causal) n_tiles = min(n_tiles, q_last / BK + 1);

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * BK;
        __syncthreads();   // the previous tile's Ks, Vs and Ps are no longer read
        for (int i = tid; i < BK * hd; i += THREADS) {
            const int r = i / hd, d = i - r * hd, s = k0 + r;
            const bool in = s < Skv;
            Ks[r * ld + d] = in ? to_f32(kb[s * kv_row + d]) : 0.0f;
            Vs[r * ld + d] = in ? to_f32(vb[s * kv_row + d]) : 0.0f;
        }
        __syncthreads();

        float sc[RQ][RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j) sc[i][j] = 0.0f;
        for (int d = 0; d < hd; ++d) {
            float qv[RQ], kv[RK];
#pragma unroll
            for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + TY * i) * ld + d];
#pragma unroll
            for (int j = 0; j < RK; ++j) kv[j] = Ks[(tx + TX * j) * ld + d];
#pragma unroll
            for (int i = 0; i < RQ; ++i)
#pragma unroll
                for (int j = 0; j < RK; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                const int r = ty + TY * i, c = tx + TX * j;
                const bool keep = k0 + c < Skv && (!causal || q0 + r >= k0 + c);
                Ps[r * LDP + c] = keep ? sc[i][j] : -INFINITY;
            }
        __syncthreads();

        {   // online softmax: four threads per row, 16 columns each
            const int r = tid >> 2, part = tid & 3;
            float* row = Ps + r * LDP + part * (BK / 4);
            const float m_old = m_s[r];
            float mx = -INFINITY;
            for (int c = 0; c < BK / 4; ++c) mx = fmaxf(mx, row[c]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.0f;
            for (int c = 0; c < BK / 4; ++c) {
                const float s = row[c];
                const float p = s == -INFINITY ? 0.0f : expf(s - m_new);
                row[c] = p;
                sum += p;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            const float alpha = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
            __syncwarp();   // every lane of the row has read m_s[r]
            if (part == 0) {
                m_s[r] = m_new;
                l_s[r] = alpha * l_s[r] + sum;
                a_s[r] = alpha;
            }
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const float al = a_s[ty + TY * i];
#pragma unroll
            for (int j = 0; j < SLOTS; ++j) acc[i][j] *= al;
        }
        for (int c = 0; c < BK; ++c) {
            float vv[SLOTS];
#pragma unroll
            for (int j = 0; j < SLOTS; ++j) {
                const int col = tx + TX * j;
                vv[j] = col < hd ? Vs[c * ld + col] : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
                const float p = Ps[(ty + TY * i) * LDP + c];
#pragma unroll
                for (int j = 0; j < SLOTS; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
            }
        }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int r = ty + TY * i, s = q0 + r;
        if (s >= Sq) continue;
        const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) {
            const int col = tx + TX * j;
            if (col < hd) ob[s * q_row + col] = from_f32<T>(acc[i][j] / l);
        }
    }
}

template <typename T, int SLOTS>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                 int Skv, int H, int Kh, int hd, int causal, float scale,
                 cudaStream_t stream) {
    const size_t smem = smem_bytes(hd);
    auto kernel = flash_attention_kernel<T, SLOTS>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, B * H);
    kernel<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                            Sq, Skv, H, Kh, hd, scale, causal);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
              int H, int Kh, int hd, int causal, float scale, cudaStream_t s) {
    // the accumulator holds ceil(hd / 16) columns per row: instantiate the head
    // dims of the ported configs (16, 32, 64, 80, 128, 256) and round others up
    if (hd <= 16) return launch_typed<T, 1>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    if (hd <= 32) return launch_typed<T, 2>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    if (hd <= 64) return launch_typed<T, 4>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    if (hd <= 80) return launch_typed<T, 5>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    if (hd <= 128) return launch_typed<T, 8>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    return launch_typed<T, 16>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
}

}  // namespace

// Returns a cudaError_t as int: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing; the wrapper (kernels/flash_attention/kernel.py)
// has checked shapes, dtypes and contiguity. is_bf16: 1 for bfloat16, 0 for float32.
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int H, int Kh, int hd,
                                      int causal, int is_bf16, float scale, void* stream) {
    if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || hd <= 0 ||
        hd > 256 || B * H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        return launch_hd<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    return launch_hd<float>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
}
