// Mamba-2 SSD chunked scan on Hopper (sm_90a), returning the final state.
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,   h_0 = 0
//   x (B, S, H, P), dt (B, S, H) f32, a (H,) f32, Bm/Cm (B, S, G, N), all in the
//   model's layout; head h reads group g = h / (H / G).
//   -> y (B, S, H, P) in x's dtype, h_final (B, H, P, N) f32.
//
// Replaces the Pallas TPU kernel `ssd_scan_pallas`
// (src/repro/kernels/ssd_scan/kernel.py:62, body `_ssd_kernel` :24), which walks a
// sequential grid axis over chunks with the (P, N) state in VMEM scratch. Per
// chunk of length Q (the math of kernel.py:34-57):
//
//   la  = cumsum(dt * a)                                         (Q,)
//   y   = tril(C B^T o exp(la_i - la_j)) (x dt) + exp(la) o (C h^T)
//   h'  = h exp(la_Q) + (x dt)^T (B o exp(la_Q - la))
//
// The launcher picks one of two bodies by dtype. Both read x, B and C in place
// through their batch and position strides (views into the conv output in the
// model), with no transpose and no repeat per head; both take a partial last
// chunk (S not a multiple of Q) by its length L; both write the final state (the
// TPU kernel does not), which prefill hands to decode; and neither takes the exp of
// a positive number (exp(la_i - la_j) is wanted only for j <= i, where la_i <= la_j),
// so nothing overflows and no inf * 0 makes a NaN.
//
// bfloat16 (namespace chunked; what serving runs): the chunked state-passing form,
// three kernels back to back on the stream, every chunk in parallel.
//   1. chunk state, grid (chunks, batch x group x head blocks): each chunk's own
//      state s_c = (x o dt o exp(la_last - la))^T B and its decay exp(la_last),
//      into float32 scratch the wrapper allocates;
//   2. state passing, grid (P N tiles, batch x head): H_{c+1} = exp(la_last_c) H_c
//      + s_c, elementwise, each H_c written as bf16 hi/lo planes; the last state
//      is the final state;
//   3. chunk scan, same grid as 1: the y above, with H_c the entering state.
//   * The products are mma.sync m16n8k16 (bf16 in, float32 out). x, B and C go in
//     as they are; an operand the kernel computes in float32 (dt w B, the decay-
//     weighted C B^T, the state H) goes in as a bf16 hi + lo pair in two MMAs, so
//     it keeps ~16 bits of mantissa rather than the 8 of one bf16 rounding.
//   * All heads of a group share C B^T: a block takes up to 4 heads of one group,
//     computes C B^T once and keeps it in shared memory; each head only applies its
//     own decay, in registers, while it builds the MMA's A operand. Below the
//     diagonal the decay factors through a per-head table (no exp per element).
//   * One warp per head scans the staged dt for the log-decay.
//
// float32 (the first kernel, kept for the float32 legs, which need full float32
// products): one block owns one (batch, head) and walks the chunks in a loop.
//   * B, C, dt and u = x * dt of the chunk, and the (P, N) state, live in shared
//     memory as float32 (rows padded by one float against bank conflicts);
//   * the cumulative log-decay is a run per lane and a warp scan over the staged dt;
//   * the (Q, Q) decay-weighted matrix is built 32 query rows at a time;
//   * the wrapper walks chunks of at most 64 (kernels/ssd_scan/kernel.py): the
//     quadratic intra-chunk work halves from Q = 128, and a 76 KB block lets three
//     blocks share an SM.
//
// Bound on an H100 at the zamba2 prefill shape (B 4, S 1024, H 80, P = N = 64,
// bf16): ~92 MB of x, y, dt, B, C and the final state, 0.027 ms at 3.35 TB/s; the
// chunk products, BH (S/Q) 2 (Q^2 N + Q^2 P + 2 Q P N) = 10.7 GFLOP at Q = 64,
// would take 0.011 ms at the bf16 tensor-core rate. The bf16 body also moves the
// chunk states through the L2 (42 MB at Q = 128: written, read, written as hi/lo,
// read).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TI = 32;   // query rows of the decay-weighted matrix built at a time

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

namespace chunked {

// ---- the bfloat16 body: chunks in parallel, products on the tensor cores ----------

typedef __nv_bfloat16 bf16;
constexpr int THREADS = 256;       // pass 1 and 2: 8 warps
constexpr int THREADS3 = 512;      // pass 3: 16 warps, one 16 x 32 output tile each
constexpr int CB_LD = 24;          // row stride of a 16 x 16 float tile of C B^T
// heads of one group per block, one warp scanning each head's dt; 4 gave the
// shortest passes 1 and 3 at zamba2's shape
constexpr int HB = 4;

__host__ __device__ constexpr int round32(int v) { return (v + 31) / 32 * 32; }

// Shared-memory layouts. Tiles keep the model's layout (rows of positions, the
// head or state width contiguous), rows padded by 8 elements so that the eight
// 16-byte rows an ldmatrix reads fall in distinct banks. Per-head tiles are
// double-buffered: the next head's are copied in (cp.async) while this head's
// products run.
struct StateSmem {   // pass 1: B[t][n], x[2][t][p], dt[hh][t], dt w[hh][t]
    int ldb, ldx;
    size_t b, x, xsz, dts, cw, bytes;
    __host__ __device__ StateSmem(int Q, int P, int N) : ldb(round32(N) + 8), ldx(round32(P) + 8) {
        b = 0;
        x = b + (size_t)Q * ldb * 2;
        xsz = (size_t)Q * ldx * 2;
        dts = x + 2 * xsz;
        cw = dts + (size_t)HB * Q * 4;
        bytes = cw + (size_t)HB * Q * 4;
    }
};
struct ScanSmem {    // pass 3: C[t][n], B[t][n], C B^T (lower 16 x 16 tiles, f32),
                     // x[2][t][p], H[2] hi/lo [p][n], la, dt, row and column decays[2]
    int ldc, ldx, ntri;
    size_t c, b, cb, x, xsz, h, hsz, la, dts, rowf, colf, bytes;
    __host__ __device__ ScanSmem(int Q, int P, int N)
        : ldc(round32(N) + 8), ldx(round32(P) + 8), ntri((Q / 16) * (Q / 16 + 1) / 2) {
        c = 0;
        b = c + (size_t)Q * ldc * 2;
        cb = b + (size_t)Q * ldc * 2;
        x = cb + (size_t)ntri * 16 * CB_LD * 4;
        xsz = (size_t)Q * ldx * 2;
        h = x + 2 * xsz;
        hsz = (size_t)2 * round32(P) * ldc * 2;
        la = h + 2 * hsz;
        dts = la + (size_t)HB * Q * 4;
        rowf = dts + (size_t)HB * Q * 4;
        colf = rowf + (size_t)2 * Q * (Q / 16) * 4;
        bytes = colf + (size_t)2 * Q * 4;
    }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// x0, x1 = hi + lo with hi, lo bf16: the pair carries ~16 bits of mantissa
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi = as_u32(h);
    lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(const bf16* p, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(const bf16* p, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c += a b, m16n8k16, bf16 in, float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Block {       // the (chunk, batch, group, heads) a block of pass 1 or 3 owns
    int c, b, g, h0, nh, c0, L;
    __device__ Block(int S, int H, int G, int Q) {
        const int rep = H / G, nhb = (rep + HB - 1) / HB;
        int r = blockIdx.y;
        const int hb = r % nhb;
        r /= nhb;
        g = r % G;
        b = r / G;
        c = blockIdx.x;
        h0 = g * rep + hb * HB;
        nh = min(HB, rep - hb * HB);
        c0 = c * Q;
        L = min(Q, S - c0);
    }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// dst[r][c] = src[r * rs + c] for r < rows, c < cols; zero up to (rows_pad,
// round32(cols)). Where the source allows 16-byte copies (the model's widths and
// strides do) they are issued with cp.async and land by the next
// cp_async_wait_all; otherwise the copy is done here, element by element.
template <int NT, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long rs, int rows,
                                          int rows_pad, int cols) {
    constexpr int E = 16 / sizeof(T);
    const int pad = round32(cols);
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && rs % E == 0 && cols % E == 0) {
        const int units = pad / E;
        for (int i = threadIdx.x; i < rows_pad * units; i += NT) {
            const int r = i / units, c = (i - r * units) * E;
            if (r < rows && c < cols)
                cp_async16(dst + r * ld + c, src + r * rs + c);
            else
                *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0, 0, 0, 0);
        }
    } else {
        for (int i = threadIdx.x; i < rows_pad * pad; i += NT) {
            const int r = i / pad, c = i - r * pad;
            dst[r * ld + c] = (r < rows && c < cols) ? src[r * rs + c] : T(0.0f);
        }
    }
}

// dt of the block's heads, dts[hh][t], zero past the chunk's end and past nh
template <int Q, int NT>
__device__ __forceinline__ void stage_dt(float* dts, const float* dt, const Block& k, int S, int H) {
    for (int i = threadIdx.x; i < Q * HB; i += NT) {
        const int t = i / HB, hh = i - t * HB;
        dts[hh * Q + t] = (hh < k.nh && t < k.L) ? dt[((long long)k.b * S + k.c0 + t) * H + k.h0 + hh]
                                                 : 0.0f;
    }
}

// la[t] = cumsum(dt * a) of one head over the chunk, by one warp: a run of Q/32
// per lane, then a warp scan. Past L, dt is 0, so la[Q-1] = la[L-1].
template <int Q>
__device__ __forceinline__ void log_decay(const float* dts, float ah, float (&la)[Q / 32]) {
    const int lane = threadIdx.x % 32;
    float run = 0.0f;
#pragma unroll
    for (int k = 0; k < Q / 32; ++k) {
        run += dts[lane * (Q / 32) + k] * ah;
        la[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < Q / 32; ++k) la[k] += excl;
}

// Pass 1: each chunk's own state s_c[p, n] = sum_t x[t, p] (dt_t w_t B[t, n]),
// w_t = exp(la_last - la_t) <= 1, and its decay exp(la_last). x goes into the MMA
// as it is (x^T through ldmatrix.trans); the float32 dt w B goes in as a bf16
// hi + lo pair.
template <int Q>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a, const bf16* __restrict__ bm,
                       float* __restrict__ states, float* __restrict__ decay, int S, int H,
                       int G, int P, int N, int nc, long long x_sb, long long x_ss,
                       long long bc_sb, long long bc_ss) {
    extern __shared__ __align__(16) uint8_t smem[];
    const StateSmem lay(Q, P, N);
    bf16* Bs = reinterpret_cast<bf16*>(smem + lay.b);
    float* dts = reinterpret_cast<float*>(smem + lay.dts);
    float* cw = reinterpret_cast<float*>(smem + lay.cw);
    const int ldb = lay.ldb, ldx = lay.ldx;
    const Block k(S, H, G, Q);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q = lane % 4;
    const int lr = lane % 8, lm = lane / 8;   // ldmatrix: row and matrix this lane addresses
    auto xbuf = [&](int hh) { return reinterpret_cast<bf16*>(smem + lay.x + (hh & 1) * lay.xsz); };
    auto load_x = [&](int hh) {
        load_tile<THREADS>(xbuf(hh), ldx,
                           x + k.b * x_sb + (long long)k.c0 * x_ss + (long long)(k.h0 + hh) * P,
                           x_ss, k.L, Q, P);
    };

    load_tile<THREADS>(Bs, ldb, bm + k.b * bc_sb + (long long)k.c0 * bc_ss + (long long)k.g * N, bc_ss,
              k.L, Q, N);
    load_x(0);
    stage_dt<Q, THREADS>(dts, dt, k, S, H);
    __syncthreads();
    if (warp < k.nh) {
        float la[Q / 32];
        log_decay<Q>(dts + warp * Q, a[k.h0 + warp], la);
        const float la_last = __shfl_sync(0xffffffffu, la[Q / 32 - 1], 31);
#pragma unroll
        for (int j = 0; j < Q / 32; ++j) {
            const int t = lane * (Q / 32) + j;
            cw[warp * Q + t] = dts[warp * Q + t] * __expf(la_last - la[j]);
        }
        if (lane == 0) decay[((long long)k.b * H + k.h0 + warp) * nc + k.c] = __expf(la_last);
    }

    const int ntn = round32(N) / 32, tiles = (round32(P) / 16) * ntn;
    for (int hh = 0; hh < k.nh; ++hh) {
        const int h = k.h0 + hh;
        cp_async_wait_all();
        __syncthreads();   // this head's x and cw are in; the other buffer is free
        if (hh + 1 < k.nh) load_x(hh + 1);
        const bf16* xs = xbuf(hh);
        const float* w = cw + hh * Q;
        float* out = states + (((long long)k.b * H + h) * nc + k.c) * P * N;
        for (int tile = warp; tile < tiles; tile += THREADS / 32) {
            const int p0 = (tile / ntn) * 16, n0 = (tile % ntn) * 32;
            float acc[4][4] = {};
#pragma unroll 2
            for (int t0 = 0; t0 < Q; t0 += 16) {
                uint32_t af[4];   // x^T rows p0.., columns t0..
                ldsm_x4_t(xs + (t0 + lr + (lm >> 1) * 8) * ldx + p0 + (lm & 1) * 8, af);
                const float2 w0 = *reinterpret_cast<const float2*>(w + t0 + 2 * q);
                const float2 w1 = *reinterpret_cast<const float2*>(w + t0 + 8 + 2 * q);
#pragma unroll
                for (int jp = 0; jp < 2; ++jp) {
                    uint32_t bf[4];   // B rows t0.., columns n0 + 16 jp ..: two n8 tiles
                    ldsm_x4_t(Bs + (t0 + lr + (lm & 1) * 8) * ldb + n0 + 16 * jp + (lm >> 1) * 8, bf);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float2 v0 = bf16x2_to_float2(bf[2 * e]);
                        const float2 v1 = bf16x2_to_float2(bf[2 * e + 1]);
                        uint32_t h0, l0, h1, l1;
                        split(v0.x * w0.x, v0.y * w0.y, h0, l0);
                        split(v1.x * w1.x, v1.y * w1.y, h1, l1);
                        mma(acc[2 * jp + e], af, h0, h1);
                        mma(acc[2 * jp + e], af, l0, l1);
                    }
                }
            }
            const int g = lane / 4;
            const bool pairs = N % 2 == 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int p = p0 + g + r * 8, n = n0 + j * 8 + 2 * q;
                    if (p >= P || n >= N) continue;
                    if (pairs)
                        *reinterpret_cast<float2*>(out + p * N + n) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
                    else {
                        out[p * N + n] = acc[j][2 * r];
                        if (n + 1 < N) out[p * N + n + 1] = acc[j][2 * r + 1];
                    }
                }
            }
        }
    }
}

// Pass 2: the state entering each chunk, H_0 = 0, H_{c+1} = exp(la_last_c) H_c
// + s_c, written as a bf16 hi + lo pair (two planes of (P, N) per chunk), the
// operand pass 3 feeds its MMAs; the last state is the final state, in float32.
// Elementwise and memory-bound: a thread owns V consecutive (p, n) of one (b, h)
// and keeps up to 8 chunks' loads in flight.
__device__ __forceinline__ void load_v(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_v(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void store_v(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_v(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, const float (&v)[4]) {
    uint32_t h0, l0, h1, l1;
    split(v[0], v[1], h0, l0);
    split(v[2], v[3], h1, l1);
    *reinterpret_cast<uint2*>(hi) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(lo) = make_uint2(l0, l1);
}
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, const float (&v)[1]) {
    const bf16 h = __float2bfloat16(v[0]);
    *hi = h;
    *lo = __float2bfloat16(v[0] - __bfloat162float(h));
}

template <int V>
__global__ void __launch_bounds__(THREADS)
ssd_state_pass_kernel(const float* __restrict__ states, const float* __restrict__ decay,
                      bf16* __restrict__ hs, float* __restrict__ h_out, int PN, int nc) {
    constexpr int D = 8;
    const int i = (blockIdx.x * THREADS + threadIdx.x) * V;
    if (i >= PN) return;
    const long long bh = blockIdx.y;
    const float* st = states + bh * nc * PN + i;
    bf16* hb = hs + bh * nc * 2 * PN + i;
    const float* dc = decay + bh * nc;
    float h[V];
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = 0.0f;
    for (int c0 = 0; c0 < nc; c0 += D) {
        float s[D][V];
#pragma unroll
        for (int j = 0; j < D; ++j)
            if (c0 + j < nc) load_v(st + (long long)(c0 + j) * PN, s[j]);
#pragma unroll
        for (int j = 0; j < D; ++j)
            if (c0 + j < nc) {
                bf16* out = hb + (long long)(c0 + j) * 2 * PN;
                store_split(out, out + PN, h);
                const float d = dc[c0 + j];
#pragma unroll
                for (int v = 0; v < V; ++v) h[v] = d * h[v] + s[j][v];
            }
    }
    store_v(h_out + bh * PN + i, h);
}

// Pass 3: y = tril(C B^T o exp(la_i - la_j)) (x dt) + exp(la) o (C H_c^T).
//   * C B^T is the same for every head of a group: the block computes its lower
//     16 x 16 tiles once (exact bf16 inputs, float32) and keeps them in shared
//     memory for its heads.
//   * Per head, the A operand M[i, j] = CB[i, j] exp(la_i - la_j) dt_j is built in
//     registers. Below the diagonal tile, the decay factors through the tile's
//     last column r: exp(la_i - la_r) exp(la_r - la_j), both exponents <= 0 (la
//     only falls), from per-head tables. On the diagonal tile the exponent is
//     clamped at 0 and entries j > i are zeroed by a select: no exp of a positive
//     number, no inf * 0. M goes in as a hi + lo pair against x as it is; C goes
//     in as it is against H_c's hi + lo planes.
//   * 16 warps, each a 16-row x 32-column tile of y, the longest (last) rows
//     first; the next head's x, H_c and decay tables are loaded while this
//     head's products run.
template <int Q>
__global__ void __launch_bounds__(THREADS3)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const bf16* __restrict__ bm,
                      const bf16* __restrict__ cm, const bf16* __restrict__ hs,
                      bf16* __restrict__ y, int S, int H, int G, int P, int N, int nc,
                      long long x_sb, long long x_ss, long long bc_sb, long long bc_ss) {
    constexpr int NB = Q / 16;           // 16-row blocks of the chunk
    extern __shared__ __align__(16) uint8_t smem[];
    const ScanSmem lay(Q, P, N);
    bf16* Cs = reinterpret_cast<bf16*>(smem + lay.c);
    bf16* Bs = reinterpret_cast<bf16*>(smem + lay.b);
    float* CB = reinterpret_cast<float*>(smem + lay.cb);
    float* las = reinterpret_cast<float*>(smem + lay.la);
    float* dts = reinterpret_cast<float*>(smem + lay.dts);
    const int ldc = lay.ldc, ldx = lay.ldx, PP = round32(P), NP = round32(N);
    const Block k(S, H, G, Q);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
    const int lr = lane % 8, lm = lane / 8;
    auto xbuf = [&](int hh) { return reinterpret_cast<bf16*>(smem + lay.x + (hh & 1) * lay.xsz); };
    auto hbuf = [&](int hh) { return reinterpret_cast<bf16*>(smem + lay.h + (hh & 1) * lay.hsz); };
    auto rowf = [&](int hh) { return reinterpret_cast<float*>(smem + lay.rowf) + (hh & 1) * Q * NB; };
    auto colf = [&](int hh) { return reinterpret_cast<float*>(smem + lay.colf) + (hh & 1) * Q; };
    auto load_head = [&](int hh) {   // x and the entering state's hi/lo planes
        const int h = k.h0 + hh;
        load_tile<THREADS3>(xbuf(hh), ldx,
                            x + k.b * x_sb + (long long)k.c0 * x_ss + (long long)h * P,
                            x_ss, k.L, Q, P);
        const bf16* hin = hs + (((long long)k.b * H + h) * nc + k.c) * 2 * P * N;
        load_tile<THREADS3>(hbuf(hh), ldc, hin, (long long)N, P, PP, N);
        load_tile<THREADS3>(hbuf(hh) + PP * ldc, ldc, hin + P * N, (long long)N, P, PP, N);
    };
    // rowf[i][jb] = exp(la_i - la_r), r = 16 jb + 15 < i; colf[j] = exp(la_r - la_j) dt_j,
    // r the last row of j's block: both exponents <= 0
    auto decay_tables = [&](int hh) {
        const float* la = las + hh * Q;
        float* rf = rowf(hh);
        float* cf = colf(hh);
        for (int e = threadIdx.x; e < Q * NB; e += THREADS3) {
            const int i = e / NB, r = (e - i * NB) * 16 + 15;
            rf[e] = r < i ? __expf(la[i] - la[r]) : 0.0f;
        }
        for (int j = threadIdx.x; j < Q; j += THREADS3)
            cf[j] = __expf(la[j | 15] - la[j]) * dts[hh * Q + j];
    };

    const long long goff = k.b * bc_sb + (long long)k.c0 * bc_ss + (long long)k.g * N;
    load_tile<THREADS3>(Cs, ldc, cm + goff, bc_ss, k.L, Q, N);
    load_tile<THREADS3>(Bs, ldc, bm + goff, bc_ss, k.L, Q, N);
    load_head(0);
    stage_dt<Q, THREADS3>(dts, dt, k, S, H);
    cp_async_wait_all();
    __syncthreads();
    if (warp < k.nh) {
        float la[Q / 32];
        log_decay<Q>(dts + warp * Q, a[k.h0 + warp], la);
#pragma unroll
        for (int j = 0; j < Q / 32; ++j) las[warp * Q + lane * (Q / 32) + j] = la[j];
    }
    for (int t = warp; t < lay.ntri; t += THREADS3 / 32) {   // C B^T, lower tiles
        int ib = 0;
        while ((ib + 1) * (ib + 2) / 2 <= t) ++ib;
        const int i0 = ib * 16, j0 = (t - ib * (ib + 1) / 2) * 16;
        float cb[2][4] = {};
        for (int n0 = 0; n0 < NP; n0 += 16) {
            uint32_t af[4], bf[4];
            ldsm_x4(Cs + (i0 + lr + (lm & 1) * 8) * ldc + n0 + (lm >> 1) * 8, af);
            ldsm_x4(Bs + (j0 + lr + (lm >> 1) * 8) * ldc + n0 + (lm & 1) * 8, bf);
            mma(cb[0], af, bf[0], bf[1]);
            mma(cb[1], af, bf[2], bf[3]);
        }
        float* tile = CB + t * 16 * CB_LD;
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
            *reinterpret_cast<float2*>(tile + g * CB_LD + jt * 8 + 2 * q) = make_float2(cb[jt][0], cb[jt][1]);
            *reinterpret_cast<float2*>(tile + (g + 8) * CB_LD + jt * 8 + 2 * q) = make_float2(cb[jt][2], cb[jt][3]);
        }
    }
    __syncthreads();
    decay_tables(0);

    const int npb = PP / 32, tiles = NB * npb;
    for (int hh = 0; hh < k.nh; ++hh) {
        const int h = k.h0 + hh;
        cp_async_wait_all();
        __syncthreads();   // this head's tiles and tables are in; the other buffers are free
        if (hh + 1 < k.nh) {
            load_head(hh + 1);
            decay_tables(hh + 1);
        }
        const bf16* xs = xbuf(hh);
        const bf16* Hh = hbuf(hh);
        const bf16* Hl = Hh + PP * ldc;
        const float* la = las + hh * Q;
        const float* dtv = dts + hh * Q;
        const float* rf = rowf(hh);
        const float* cf = colf(hh);
        for (int tile = warp; tile < tiles; tile += THREADS3 / 32) {
            const int rb = NB - 1 - tile / npb, p0 = (tile % npb) * 32;
            const int i0 = rb * 16, ia = i0 + g, ib = ia + 8;
            const float la_a = la[ia], la_b = la[ib];
            float acc[4][4] = {}, inter[4][4] = {};
            for (int jb = 0; jb <= rb; ++jb) {
                const int j0 = jb * 16;
                const float* ct = CB + (rb * (rb + 1) / 2 + jb) * 16 * CB_LD;
                uint32_t ah[4], al[4];
                if (jb < rb) {
                    const float ra = rf[ia * NB + jb], rbv = rf[ib * NB + jb];
                    const float2 c0 = *reinterpret_cast<const float2*>(cf + j0 + 2 * q);
                    const float2 c1 = *reinterpret_cast<const float2*>(cf + j0 + 8 + 2 * q);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {   // A fragment e: rows ia / ib, columns +0 / +8
                        const float2 v = *reinterpret_cast<const float2*>(
                            ct + (g + (e & 1) * 8) * CB_LD + (e >> 1) * 8 + 2 * q);
                        const float r = (e & 1) ? rbv : ra;
                        const float2 cc = (e >> 1) ? c1 : c0;
                        split(v.x * r * cc.x, v.y * r * cc.y, ah[e], al[e]);
                    }
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = (e & 1) ? ib : ia, j = j0 + 2 * q + (e >> 1) * 8;
                        const float lai = (e & 1) ? la_b : la_a;
                        const float2 v = *reinterpret_cast<const float2*>(
                            ct + (g + (e & 1) * 8) * CB_LD + (e >> 1) * 8 + 2 * q);
                        const float d0 = __expf(fminf(lai - la[j], 0.0f)) * dtv[j];
                        const float d1 = __expf(fminf(lai - la[j + 1], 0.0f)) * dtv[j + 1];
                        split(j <= i ? v.x * d0 : 0.0f, j + 1 <= i ? v.y * d1 : 0.0f, ah[e], al[e]);
                    }
                }
#pragma unroll
                for (int jp = 0; jp < 2; ++jp) {
                    uint32_t bf[4];   // x rows j0.., columns p0 + 16 jp ..: two n8 tiles
                    ldsm_x4_t(xs + (j0 + lr + (lm & 1) * 8) * ldx + p0 + 16 * jp + (lm >> 1) * 8, bf);
                    mma(acc[2 * jp], ah, bf[0], bf[1]);
                    mma(acc[2 * jp], al, bf[0], bf[1]);
                    mma(acc[2 * jp + 1], ah, bf[2], bf[3]);
                    mma(acc[2 * jp + 1], al, bf[2], bf[3]);
                }
            }
            for (int n0 = 0; n0 < NP; n0 += 16) {
                uint32_t af[4];
                ldsm_x4(Cs + (i0 + lr + (lm & 1) * 8) * ldc + n0 + (lm >> 1) * 8, af);
#pragma unroll
                for (int jp = 0; jp < 2; ++jp) {
                    uint32_t bh[4], bl[4];   // H rows p0 + 16 jp .., columns n0..
                    const int off = (p0 + 16 * jp + lr + (lm >> 1) * 8) * ldc + n0 + (lm & 1) * 8;
                    ldsm_x4(Hh + off, bh);
                    ldsm_x4(Hl + off, bl);
                    mma(inter[2 * jp], af, bh[0], bh[1]);
                    mma(inter[2 * jp], af, bl[0], bl[1]);
                    mma(inter[2 * jp + 1], af, bh[2], bh[3]);
                    mma(inter[2 * jp + 1], af, bl[2], bl[3]);
                }
            }
            const float ea = __expf(la_a), eb = __expf(la_b);
            bf16* yb = y + (((long long)k.b * S + k.c0) * H + h) * P;
            const long long y_ss = (long long)H * P;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const int p = p0 + jj * 8 + 2 * q;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int i = r ? ib : ia;
                    const float e = r ? eb : ea;
                    if (i >= k.L) continue;
                    const float v0 = acc[jj][2 * r] + e * inter[jj][2 * r];
                    const float v1 = acc[jj][2 * r + 1] + e * inter[jj][2 * r + 1];
                    if (p + 1 < P) {
                        *reinterpret_cast<__nv_bfloat162*>(yb + i * y_ss + p) =
                            __floats2bfloat162_rn(v0, v1);
                    } else if (p < P) {
                        yb[i * y_ss + p] = __float2bfloat16(v0);
                    }
                }
            }
        }
    }
}

template <int Q>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm, void* y,
           void* h_out, void* scratch, int B, int S, int H, int G, int P, int N,
           long long x_sb, long long x_ss, long long bc_sb, long long bc_ss, cudaStream_t s) {
    const int nc = (S + Q - 1) / Q, rep = H / G, PN = P * N;
    const long long n_states = (long long)B * H * nc * PN;
    float* states = (float*)scratch;                    // (B, H, nc, P, N) f32
    bf16* hs = (bf16*)(states + n_states);              // (B, H, nc, 2, P, N) bf16 hi, lo
    float* decay = states + 2 * n_states;               // (B, H, nc)
    const size_t sm1 = StateSmem(Q, P, N).bytes, sm3 = ScanSmem(Q, P, N).bytes;
    auto k1 = ssd_chunk_state_kernel<Q>;
    auto k3 = ssd_chunk_scan_kernel<Q>;
    cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm1);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm3);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(nc, B * G * ((rep + HB - 1) / HB));
    k1<<<grid, THREADS, sm1, s>>>((const bf16*)x, (const float*)dt, (const float*)a,
                                  (const bf16*)bm, states, decay, S, H, G, P, N, nc, x_sb, x_ss,
                                  bc_sb, bc_ss);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (PN % 4 == 0)
        ssd_state_pass_kernel<4><<<dim3((PN / 4 + THREADS - 1) / THREADS, B * H), THREADS, 0, s>>>(
            states, decay, hs, (float*)h_out, PN, nc);
    else
        ssd_state_pass_kernel<1><<<dim3((PN + THREADS - 1) / THREADS, B * H), THREADS, 0, s>>>(
            states, decay, hs, (float*)h_out, PN, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k3<<<grid, THREADS3, sm3, s>>>((const bf16*)x, (const float*)dt, (const float*)a,
                                   (const bf16*)bm, (const bf16*)cm, hs, (bf16*)y, S, H, G, P, N,
                                   nc, x_sb, x_ss, bc_sb, bc_ss);
    return (int)cudaGetLastError();
}

}  // namespace chunked

// Returns a cudaError_t as int: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing; the wrapper (kernels/ssd_scan/kernel.py) has
// checked shapes, dtypes and strides and chosen Q so that the tiles fit shared
// memory. x_sb/x_ss and bc_sb/bc_ss are the batch and position strides (in
// elements) of x and of Bm/Cm; their inner dims are contiguous. is_bf16: 1 for
// bfloat16 (the chunked body; Q 64 or 128; scratch holds B H ceil(S/Q) (2 P N + 1)
// floats), 0 for float32 (scratch unused).
extern "C" int launch_ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                               const void* cm, void* y, void* h_out, int B, int S, int H,
                               int G, int P, int N, int Q, long long x_sb, long long x_ss,
                               long long bc_sb, long long bc_ss, void* scratch, int is_bf16,
                               void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || N <= 0 || Q <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16) {
        if (Q == 64)
            return chunked::launch<64>(x, dt, a, bm, cm, y, h_out, scratch, B, S, H, G, P, N,
                                       x_sb, x_ss, bc_sb, bc_ss, s);
        if (Q == 128)
            return chunked::launch<128>(x, dt, a, bm, cm, y, h_out, scratch, B, S, H, G, P, N,
                                        x_sb, x_ss, bc_sb, bc_ss, s);
        return (int)cudaErrorInvalidValue;
    }
    return launch_typed<float>(x, dt, a, bm, cm, y, h_out, B, S, H, G, P, N, Q,
                               x_sb, x_ss, bc_sb, bc_ss, s);
}
