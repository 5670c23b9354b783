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
// and walks the key tiles in a loop, so nothing carries between blocks. The
// launcher picks one of two bodies by dtype:
//
// bfloat16 (namespace wg; what serving runs): the FlashAttention-3 shape.
//   * a block of 384 threads owns 128 query rows: two consumer warpgroups of 64
//     rows (the wgmma M) and a producer warpgroup, whose one thread keeps TMA
//     loads of K and V tiles in flight through a two-stage ring synchronised by
//     mbarriers (full per stage for K and for V, empty per stage); setmaxnreg
//     moves registers from the producer to the consumers;
//   * the tensor maps are 4-D (hd, heads, S, B): a 64-column box that runs past hd
//     is zero-filled by the hardware instead of reading the next head's values,
//     and so are rows past S. Tiles are 128-byte swizzled, 64 columns per atom;
//   * S = Q K^T is a wgmma with Q and K both K-major in shared memory, in k-steps
//     of 16 over hd rounded up to the wgmma width HDN;
//   * the online softmax runs on the accumulator fragments (row max and sum over
//     the four lanes of a quad, exp2f with log2(e) * scale folded in); P goes to
//     bf16 in registers (the cast the model's `_sdpa` applies to the weights
//     before PV) and is the A operand of O += P V, with V MN-major in shared
//     memory; O is a float32 m64 x HDN fragment, and columns past hd are dropped;
//   * key tiles wholly above the diagonal are never loaded, only tiles that cross
//     it (or pass Skv) are masked, and the last query tiles, the longest, launch
//     first; K/V of head h / (H / Kh) are read in place.
//
// float32 (the first kernel, kept for the float32 legs, which need full float32
// products):
//   * the block's 64 query rows (pre-scaled) and each 64-row K and V tile are held
//     in shared memory as float32, rows padded by one float so that the strided
//     reads of the score and PV loops fall in distinct banks;
//   * 256 threads as 16 x 16; each computes a 4 x 4 patch of the score tile and
//     owns 4 query rows x ceil(hd / 16) columns of the float32 accumulator in
//     registers (SLOTS columns per row, a compile-time bound on hd);
//   * the online softmax keeps the running max and sum per row in shared memory;
//     four threads share a row and reduce with warp shuffles.
//
// In both, a masked score is -inf and never reaches exp: p = 0 for it, and a row
// whose running max is still -inf rescales by 0. The denominator is clamped at
// 1e-30 as kernel.py:70-72 does. Ragged Sq and Skv are masked in the kernel (TMA's
// zero rows past Skv would otherwise score 0) and rows past Sq are not stored.
//
// Bound on an H100: 4 * B * H * hd * S(S+1)/2 float operations for the causal
// product; at the zamba2 prefill shape (B 4, S 1024, H 32, hd 80) that is
// 21.5 GFLOP, 0.022 ms at the 989 TFLOP/s bf16 tensor-core rate, against 0.025 ms
// for its 84 MB of q, k, v and o at 3.35 TB/s. chip_smoke.py times both bodies
// beside that bound.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;  // thread grid of the score and accumulator patches
constexpr int RQ = BQ / TY;     // query rows per thread
constexpr int RK = BK / TX;     // key columns per thread
constexpr int LDP = BK + 1;     // padded row of the probability tile

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

namespace wg {

// ---- the bfloat16 body: TMA-fed, warp-specialised, products on wgmma ------------------

constexpr int BQ = 128;           // query rows per block: two consumer warpgroups of 64
constexpr int THREADS = 384;      // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int ATOM = 64;          // bf16 columns of one 128-byte swizzle atom
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// returns once the phase of `bar` with parity `parity` has completed; a wait that
// never ends (a pipeline fault) traps after ~2^26 polls, an error at the next
// synchronise, instead of holding the card
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

// one 4-D box of the tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
                 :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
                    "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
                 : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving reads or writes of accumulator registers across
// the asynchronous wgmma and its wait
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// 2^x on the special-function unit (what exp2f lowers to, without its range fix-up)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// named barrier `id` over both consumer warpgroups: one waits, the other arrives
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

template <int N> struct Wgmma;
template <> struct Wgmma<16> {
    static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n16(d, a, b, 1); }
};
template <> struct Wgmma<32> {
    static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n32(d, a, b, 1); }
};
template <> struct Wgmma<64> {
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n64(d, a, b, 1); }
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) { wgmma_ss_n64(d, a, b, acc); }
};
template <> struct Wgmma<80> {
    static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n80(d, a, b, 1); }
};
template <> struct Wgmma<128> {
    static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n128(d, a, b, 1); }
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) { wgmma_ss_n128(d, a, b, acc); }
};
template <> struct Wgmma<256> {
    static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n256(d, a, b, 1); }
};

// HDN: the head dim rounded up to a wgmma width (16, 32, 64, 80, 128, 256); the
// tensor map zero-fills the columns from hd to HDN. BK: keys per tile.
template <int HDN, int BK>
struct Tiles {
    // the ring of K/V tiles: three stages where they fit in 227 KB, two at hd 256
    static constexpr int STAGES = HDN <= 128 ? 3 : 2;
    static constexpr int ATOMS = (HDN + ATOM - 1) / ATOM;        // swizzle atoms across hd
    static constexpr int Q_BYTES = ATOMS * BQ * ATOM * 2;
    static constexpr int KV_BYTES = ATOMS * BK * ATOM * 2;      // one K or V tile
    static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 3 * STAGES);
    static_assert(SMEM <= 232448, "tiles exceed the shared memory of a block");
};

template <int HDN, int BK>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                             int Sq, int Skv, int H, int Kh, int hd, float scale_log2,
                             int causal) {
    using T = Tiles<HDN, BK>;
    extern __shared__ uint8_t smem_raw[];
    // the swizzled tiles start on a 1024-byte boundary (one swizzle period)
    uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* Qs = base;                                   // [ATOMS][BQ][64]
    uint8_t* Ks = Qs + T::Q_BYTES;                        // [STAGES][ATOMS][BK][64]
    uint8_t* Vs = Ks + T::STAGES * T::KV_BYTES;           // [STAGES][ATOMS][BK][64]
    uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + T::STAGES * T::KV_BYTES);
    uint64_t* q_full = bars;
    uint64_t* k_full = bars + 1;
    uint64_t* v_full = bars + 1 + T::STAGES;
    uint64_t* empty = bars + 1 + 2 * T::STAGES;

    const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
    const int kh = h / (H / Kh);
    // causal: the longest query tiles (the last ones) are launched first
    const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    const int q0 = qt * BQ;
    const int q_last = min(q0 + BQ, Sq) - 1;
    int n_tiles = (Skv + BK - 1) / BK;
    if (causal) n_tiles = min(n_tiles, q_last / BK + 1);   // tiles above the diagonal skipped

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < T::STAGES; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&v_full[s], 1);
            mbar_init(&empty[s], 2 * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= 256) {
        // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (threadIdx.x == 256) {
            mbar_expect_tx(q_full, T::Q_BYTES);
            for (int a = 0; a < T::ATOMS; ++a)
                tma_load_4d(Qs + a * BQ * ATOM * 2, &tq, q_full, a * ATOM, h, q0, b);
            for (int t = 0; t < n_tiles; ++t) {
                const int s = t % T::STAGES;
                mbar_wait(&empty[s], ((t / T::STAGES) & 1) ^ 1);
                uint8_t* kd = Ks + s * T::KV_BYTES;
                uint8_t* vd = Vs + s * T::KV_BYTES;
                mbar_expect_tx(&k_full[s], T::KV_BYTES);
                for (int a = 0; a < T::ATOMS; ++a)
                    tma_load_4d(kd + a * BK * ATOM * 2, &tk, &k_full[s], a * ATOM, kh, t * BK, b);
                mbar_expect_tx(&v_full[s], T::KV_BYTES);
                for (int a = 0; a < T::ATOMS; ++a)
                    tma_load_4d(vd + a * BK * ATOM * 2, &tv, &v_full[s], a * ATOM, kh, t * BK, b);
            }
        }
    } else {
        // ---- two consumer warpgroups, 64 query rows each ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
        const int warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
        const int wg_row0 = q0 + wg * 64;
        const int row0 = wg_row0 + warp * 16 + g, row1 = row0 + 8;

        float acc[HDN / 2];
#pragma unroll
        for (int i = 0; i < HDN / 2; ++i) acc[i] = 0.0f;
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;   // l: this thread's part

        const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128;
        float sc[BK / 2];
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;

        // S = Q K_t^T: both K-major; a k-step of 16 is 32 bytes into the swizzle atom
        auto issue_s = [&](int t) {
            const uint32_t k_addr = smem_u32(Ks + (t % T::STAGES) * T::KV_BYTES);
#pragma unroll
            for (int kk = 0; kk < HDN / 16; ++kk) {
                const uint64_t da = desc_sw128(q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024);
                const uint64_t db = desc_sw128(k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024);
                Wgmma<BK>::ss(sc, da, db, kk > 0);
            }
        };
        // O += P V_t: V is MN-major; 16 keys are two 8-row groups (2048 bytes), and
        // the hd atoms lie BK rows apart
        auto issue_pv = [&](int t) {
            const uint32_t v_addr = smem_u32(Vs + (t % T::STAGES) * T::KV_BYTES);
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                Wgmma<HDN>::rs(acc, pa[kk], desc_sw128(v_addr + kk * 2048, BK * 128, 1024));
        };
        // the online softmax of tile t in the log2 domain: a masked score is -inf
        // and never reaches exp2, and a row whose running max is -inf rescales by 0;
        // O is rescaled and P goes to bf16 in registers, the A operand of P V
        auto softmax = [&](int t) {
            const int k0 = t * BK;
            const bool mask = k0 + BK > Skv || (causal && k0 + BK - 1 > wg_row0);
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                const int col = k0 + (i / 4) * 8 + qd * 2 + (i & 1);
                const int row = (i & 2) ? row1 : row0;
                if (mask && (col >= Skv || (causal && col > row))) sc[i] = -INFINITY;
                if (i & 2) mx1 = fmaxf(mx1, sc[i]); else mx0 = fmaxf(mx0, sc[i]);
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            // running maxima of the raw scores; scale > 0, so they order alike
            const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
            const float al0 = m0 == -INFINITY ? 0.0f : ex2((m0 - n0) * scale_log2);
            const float al1 = m1 == -INFINITY ? 0.0f : ex2((m1 - n1) * scale_log2);
            m0 = n0;
            m1 = n1;
            const float b0 = -n0 * scale_log2, b1 = -n1 * scale_log2;
            float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                const float v = sc[i];
                const float p = v == -INFINITY ? 0.0f : ex2(fmaf(v, scale_log2, (i & 2) ? b1 : b0));
                sc[i] = p;
                if (i & 2) s1 += p; else s0 += p;
            }
            l0 = al0 * l0 + s0;
            l1 = al1 * l1 + s1;
#pragma unroll
            for (int i = 0; i < HDN / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
                pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
                pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
                pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
            }
        };

        // The two warpgroups take turns at the tensor cores (named barriers 1 and
        // 2): one issues its GEMMs, P_t V_t then Q K_{t+1}^T back to back, while the
        // other runs its softmax. Warpgroup 0 goes first; each phase ends by
        // handing the turn over, except warpgroup 1's last, which nobody awaits.
        const int my_turn = 1 + wg, other_turn = 2 - wg;
        int phase = 0;
        auto gemm_begin = [&]() { named_sync(my_turn); };
        auto gemm_end = [&]() {
            ++phase;
            if (!(wg == 1 && phase == n_tiles + 1)) named_arrive(other_turn);
        };
        if (wg == 1) named_arrive(other_turn);

        mbar_wait(q_full, 0);
        mbar_wait(&k_full[0], 0);
        gemm_begin();
        wgmma_fence();
        issue_s(0);
        wgmma_commit();
        gemm_end();
        wgmma_wait0();
        fence_regs(sc);
        softmax(0);

        for (int t = 0; t < n_tiles; ++t) {
            const bool next = t + 1 < n_tiles;
            mbar_wait(&v_full[t % T::STAGES], (t / T::STAGES) & 1);
            if (next) mbar_wait(&k_full[(t + 1) % T::STAGES], ((t + 1) / T::STAGES) & 1);
            gemm_begin();
            wgmma_fence();
            fence_regs(acc);
            issue_pv(t);
            if (next) issue_s(t + 1);
            wgmma_commit();
            gemm_end();
            wgmma_wait0();
            fence_regs(acc);
            fence_regs(sc);
            mbar_arrive(&empty[t % T::STAGES]);
            if (next) softmax(t + 1);
        }

        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float r0 = 1.0f / fmaxf(l0, 1e-30f), r1 = 1.0f / fmaxf(l1, 1e-30f);
        const long long q_row = (long long)H * hd;
        bf16* ob = o + ((long long)b * Sq * H + h) * hd;
#pragma unroll
        for (int i = 0; i < HDN / 2; i += 2) {
            const int row = (i & 2) ? row1 : row0;
            const int col = (i / 4) * 8 + qd * 2;
            const float r = (i & 2) ? r1 : r0;
            if (row < Sq && col < hd)
                *reinterpret_cast<uint32_t*>(ob + row * q_row + col) =
                    pack_bf16(acc[i] * r, acc[i + 1] * r);
        }
    }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is fetched
// through the runtime's entry-point query, so the library links nothing beyond
// cudart
EncodeTiledFn encode_fn() {
    static EncodeTiledFn fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
        if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
        fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// (B, S, heads, hd) bf16 as a 4-D map (hd, heads, S, B): hd is its own dimension,
// so a 64-wide box past hd is zero-filled instead of reading the next head; so are
// rows past S. Boxes are 64 x 1 x rows x 1, 128-byte swizzled.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd, int rows) {
    EncodeTiledFn fn = encode_fn();
    if (!fn) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                   (cuuint64_t)S * heads * hd * 2};
    const cuuint32_t box[4] = {ATOM, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                    strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HDN, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
           int Kh, int hd, int causal, float scale, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    int err = make_map(&tq, q, B, Sq, H, hd, BQ);
    if (!err) err = make_map(&tk, k, B, Skv, Kh, hd, BK);
    if (!err) err = make_map(&tv, v, B, Skv, Kh, hd, BK);
    if (err) return err;
    auto kernel = flash_attention_wgmma_kernel<HDN, BK>;
    const int smem = Tiles<HDN, BK>::SMEM;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
    kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv, (bf16*)o, Sq, Skv, H, Kh, hd,
                                            scale * LOG2E, causal);
    return (int)cudaGetLastError();
}

// hd is a multiple of 8 (the wrapper pads other widths): the TMA strides are
// multiples of 16 bytes. 64-key tiles at hd 256 keep Q and two stages of K and V
// under the 227 KB a block may use.
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
              int H, int Kh, int hd, int causal, float scale, cudaStream_t s) {
    if (hd % 8 != 0) return (int)cudaErrorInvalidValue;
    if (hd <= 16) return launch<16, 128>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    if (hd <= 32) return launch<32, 128>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    if (hd <= 64) return launch<64, 128>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    if (hd <= 80) return launch<80, 128>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    if (hd <= 128) return launch<128, 128>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    return launch<256, 64>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
}

}  // namespace wg

// Returns a cudaError_t as int: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing; the wrapper (kernels/flash_attention/kernel.py)
// has checked shapes, dtypes and contiguity. is_bf16: 1 for bfloat16 (the wgmma
// body; hd a multiple of 8, pointers 16-byte aligned), 0 for float32.
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int H, int Kh, int hd,
                                      int causal, int is_bf16, float scale, void* stream) {
    if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || hd <= 0 ||
        hd > 256 || B * H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16) return wg::launch_hd(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
    return launch_hd<float>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, scale, s);
}
