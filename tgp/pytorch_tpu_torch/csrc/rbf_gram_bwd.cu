// VJP of the fused ARD-RBF Gram for Hopper (sm_90a), plain C interface.
//
// For K[d, i, j] = ks[d] * e_dij, e = exp(-0.5 * max(|x_i|^2 + |z_j|^2 - 2 x_i.z_j, 0))
// and a cotangent g of K's shape, with gK = g * K:
//   dX[d, i] = sum_j gK_dij (z_dj - x_di)
//   dZ[d, j] = sum_i gK_dij (x_di - z_dj)
//   dks[d]   = sum_ij g_dij e_dij
// For the pair (rbf_gram.cu with K_zz), the row set is [X rows; Z rows]: rows
// of X take g_xz, rows of Z take g_zz, and dZ sums the Z rows' own
// gradients and the column gradients of both Grams.
//
// Replaces: tgp/pytorch_tpu/ops/pallas/rbf_gram.py `_bwd` (:114-131), the
// custom VJP of the Pallas kernel `_forward` (pallas_call at :85), which the
// JAX package leaves to XLA as jnp.  Its eager transcription,
// `ops/rbf_gram.py::rbf_gram_bwd`, is this kernel's plain version: about
// twenty launches and half a dozen (N, M) temporaries.
//
// Bound on the card: bytes.  It must read g, X, Z and ks and write dX, dZ
// and dks; K is recomputed, not read.  At the training shape (8611 x 100,
// Dx = 4, fp32) that is 3.72 MB, 1.11 us at 3.35 TB/s, against about 36
// operations per output, 0.47 us at the fp32 rate.
//
// Design for that bound:
//   * g is read once.  A block owns TN whole rows.  It copies its rows of X,
//     Z (transposed) and its g rows into shared memory with cp.async, all
//     copies in flight at once (16 bytes each for g), so it waits for device
//     memory once.  It then recomputes e in registers (the forward's sums in
//     the forward's order) and turns the g tile into gK = ks * e * g in
//     place (13.6 KB in fp32 at M = 100).  From that tile it forms the rows'
//     dX (a sum over j per (row, feature)), its partial column sums for dZ
//     (a sum over its rows per (column, feature)), and its partial of dks.
//     Each long sum runs as independent partial sums added in a fixed order,
//     not as one chain of dependent adds.  Only where the tile exceeds 48 KB
//     is Z taken in column chunks (and TN halved for very wide Dx).
//   * TN from the SM count: at least 32 rows, and as many more (up to 64) as
//     give the busiest SM the fewest rows.  At 8611 + 100 rows that is 257
//     blocks of 34 (every SM runs at most 2), not 274 of 32 (10 SMs ran 3).
//   * Deterministic, no floating-point atomics.  Each block writes its
//     partials, M * Dx + 1 values, to a scratch row of its own; a second,
//     small launch sums the rows in a fixed order (32 warps take fixed,
//     strided subsets of the blocks; their sums are added in warp order).
//     That launch was chosen over "the last block to finish reduces" because
//     the latter needs a counter zeroed before every call (itself a launch
//     or memset on the stream) and a fence protocol; the second launch needs
//     neither.  Two runs give the same bits.  The partials are 412 KB in
//     fp32 at the training shape, an eighth of g.
//
// Launches on the caller's stream, does not synchronise, allocates nothing
// (the wrapper gives it the scratch), and returns cudaGetLastError().

#include <cuda_pipeline.h>

#include "rbf_gram_common.cuh"

namespace {

using rbf::Pack;

constexpr int TN_MIN = 32;          // rows per block, at least ...
constexpr int TN_MAX = 64;          // ... and at most
constexpr int BLOCKS_PER_SM = 2;    // blocks of the pass resident on an SM at once
constexpr int RED_WARPS = 32;       // warps of a reduction block

struct Plan {
    int TN, MC;                     // rows per block, columns of Z per chunk
    int64_t tiles_x, tiles;         // row tiles of X, of X and Z, per slice
};

// Rows per block and columns per chunk.  The chunk of Z, the gK tile, the
// tile's rows and their gradients and the dks tree must fit the
// shared-memory budget; MC is a multiple of V and, where it can be, all of
// Z.  Between TN_MIN and the largest TN that fits, TN gives the busiest SM
// the fewest rows: the blocks run in waves of BLOCKS_PER_SM per SM, so 274
// blocks of 32 rows (8611 + 100 rows) would give some SMs 96 rows and 257
// blocks of 34 give every SM at most 68.  False for a shape it does not
// take (not even one row and V columns fit).
template <typename T>
bool plan(int Dy, int N, int M, int Dx, bool pair, Plan& p) {
    constexpr int V = Pack<T>::V;
    int dev = 0, sms = 0;
    if (Dy <= 0 || N < 0 || M <= 0 || Dx < 0 || cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
        return false;
    const int budget = rbf::SMEM_BYTES / (int)sizeof(T) - rbf::THREADS / 32;
    const auto mc_for = [&](int tn) {   // zt: Dx * MC; gK: TN * MC; xs, racc: TN * Dx
        const int room = budget - 2 * tn * Dx;
        return room > 0 ? room / (Dx + tn) / V * V : 0;
    };
    const auto tiles_for = [&](int tn) {
        return ((int64_t)N + tn - 1) / tn + (pair ? ((int64_t)M + tn - 1) / tn : 0);
    };
    int hi = TN_MAX;
    while (hi > TN_MIN && mc_for(hi) < rbf::round_up(M, V)) --hi;
    while (hi > 1 && mc_for(hi) < V) hi /= 2;
    if (mc_for(hi) < V) return false;
    const int64_t slots = (int64_t)BLOCKS_PER_SM * sms;
    int64_t best = INT64_MAX;
    for (int tn = std::min(TN_MIN, hi); tn <= hi; ++tn) {
        const int64_t rows = ((int64_t)Dy * tiles_for(tn) + slots - 1) / slots * tn;
        if (rows < best) {
            best = rows;
            p.TN = tn;
        }
    }
    p.MC = std::min(mc_for(p.TN), rbf::round_up(M, V));
    p.tiles_x = ((int64_t)N + p.TN - 1) / p.TN;
    p.tiles = tiles_for(p.TN);
    return true;
}

size_t smem_bytes(int TN, int MC, int Dx, size_t item) {
    return item * ((size_t)(Dx + TN) * MC + 2 * (size_t)TN * Dx + rbf::THREADS / 32);
}

// Start copying rows [c0, c0 + mc) of z (each Dx values) transposed into
// zt[k * ld + j], one value per cp.async copy, consecutive threads on
// consecutive values of z; columns [mc, mcp) are set to zero, so that
// 16-byte groups can run past mc.  The copies hold no register and are all
// in flight at once; wait_staged() waits for them.
template <typename T>
__device__ __forceinline__ void stage_z(const T* __restrict__ z, int c0, int mc,
                                        int mcp, int Dx, int ld, T* zt) {
    const T* src = z + (int64_t)c0 * Dx;
    for (int e = threadIdx.x; e < mcp * Dx; e += blockDim.x) {
        const int j = e / Dx, k = e - j * Dx;
        if (j < mc)
            __pipeline_memcpy_async(zt + k * ld + j, src + e, sizeof(T));
        else
            zt[k * ld + j] = T(0);
    }
}

__device__ __forceinline__ void wait_staged() {
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
}

// a[0] + a[1] + ... in index order: independent partial sums, which keep a
// long sum from being one chain of dependent adds, combined in a fixed order
template <typename T, int K>
__device__ __forceinline__ T sum_in_order(const T (&a)[K]) {
    T s = a[0];
#pragma unroll
    for (int r = 1; r < K; ++r) s += a[r];
    return s;
}

template <typename T>
__global__ void __launch_bounds__(rbf::THREADS)
rbf_gram_bwd_kernel(const T* __restrict__ X, const T* __restrict__ Z,
                    const T* __restrict__ ks, const T* __restrict__ gxz,
                    const T* __restrict__ gzz, T* __restrict__ dX,
                    T* __restrict__ dZ, T* __restrict__ part, int N, int M,
                    int Dx, int TN, int tiles_x, int tiles, int MC) {
    constexpr int V = Pack<T>::V;
    extern __shared__ __align__(16) unsigned char smem[];
    T* zt = reinterpret_cast<T*>(smem);          // [Dx][MC] a chunk of Z, transposed
    T* gk = zt + (size_t)Dx * MC;                // [TN][MC] g, then ks * e * g
    T* xs = gk + (size_t)TN * MC;                // [TN][Dx] the tile's rows
    T* racc = xs + (size_t)TN * Dx;              // [TN][Dx] their gradients
    T* red = racc + (size_t)TN * Dx;             // [THREADS / 32] the warps' dks

    const rbf::Tile tl = rbf::tile_of(N, M, TN, tiles_x, tiles);
    const int tid = threadIdx.x;
    const T* z = Z + (int64_t)tl.d * M * Dx;
    const int64_t first = (int64_t)tl.d * tl.rows + tl.row0;   // first row, flat
    const T* x = (tl.zpart ? Z : X) + first * Dx;
    const T* g = (tl.zpart ? gzz : gxz) + first * M;
    T* dx = (tl.zpart ? dZ : dX) + first * Dx;
    T* pp = part + (int64_t)blockIdx.x * ((int64_t)M * Dx + 1);   // own partials
    const T s = ks[tl.d];
    const int nx = tl.nrows * Dx;

    for (int p = tid; p < nx; p += blockDim.x) {
        __pipeline_memcpy_async(xs + p, x + p, sizeof(T));
        racc[p] = T(0);
    }
    T dks = T(0);

    for (int c0 = 0; c0 < M; c0 += MC) {
        const int mc = min(MC, M - c0);
        const int G = (mc + V - 1) / V;
        const int mcp = G * V;
        // the chunk of Z and the tile's g, all copies in flight at once
        stage_z(z, c0, mc, mcp, Dx, MC, zt);
        for (int gi = tid; gi < tl.nrows * G; gi += blockDim.x) {
            const int i = gi / G;
            const int j0 = (gi - i * G) * V;
            const T* src = g + (int64_t)i * M + c0 + j0;
            T* dst = gk + i * MC + j0;
            if (j0 + V <= mc && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
                __pipeline_memcpy_async(dst, src, 16);
            } else {
#pragma unroll
                for (int v = 0; v < V; ++v) dst[v] = j0 + v < mc ? src[v] : T(0);
            }
        }
        wait_staged();

        // gK = ks * e * g in place, e recomputed: the forward's sums in the
        // forward's order
        for (int gi = tid; gi < tl.nrows * G; gi += blockDim.x) {
            const int i = gi / G;
            const int j0 = (gi - i * G) * V;
            T xn = T(0), zn[V], cross[V];
#pragma unroll
            for (int v = 0; v < V; ++v) zn[v] = cross[v] = T(0);
            for (int k = 0; k < Dx; ++k) {
                const T xv = xs[i * Dx + k];
                const Pack<T> zv = *reinterpret_cast<const Pack<T>*>(zt + k * MC + j0);
                xn += xv * xv;
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    zn[v] += zv.v[v] * zv.v[v];
                    cross[v] += xv * zv.v[v];
                }
            }
            Pack<T>* gp = reinterpret_cast<Pack<T>*>(gk + i * MC + j0);
            Pack<T> o = *gp;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const T e = rbf::rbf_e(xn, zn[v], cross[v]);
                dks += o.v[v] * e;
                o.v[v] = s * e * o.v[v];
            }
            *gp = o;
        }
        __syncthreads();

        // rows: racc[i, k] += sum_j gK_ij (z_jk - x_ik), per (row, feature)
        for (int p = tid; p < nx; p += blockDim.x) {
            const int i = p / Dx, k = p - (p / Dx) * Dx;
            const T xik = xs[p];
            T acc[V];                       // V independent sums, added in order
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = T(0);
            for (int j0 = 0; j0 < mcp; j0 += V) {
                const Pack<T> gp = *reinterpret_cast<const Pack<T>*>(gk + i * MC + j0);
                const Pack<T> zp = *reinterpret_cast<const Pack<T>*>(zt + k * MC + j0);
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] += gp.v[v] * (zp.v[v] - xik);
            }
            racc[p] += sum_in_order(acc);
        }
        // columns: this block's part of sum_i gK_ij (x_ik - z_jk)
        for (int q = tid; q < mc * Dx; q += blockDim.x) {
            const int j = q / Dx, k = q - (q / Dx) * Dx;
            const T zjk = zt[k * MC + j];
            T acc[4] = {T(0), T(0), T(0), T(0)};   // rows i = r (mod 4)
            int i = 0;
            for (; i + 4 <= tl.nrows; i += 4) {
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    acc[r] += gk[(i + r) * MC + j] * (xs[(i + r) * Dx + k] - zjk);
            }
            for (int r = 0; i < tl.nrows; ++i, ++r)
                acc[r] += gk[i * MC + j] * (xs[i * Dx + k] - zjk);
            pp[(int64_t)c0 * Dx + q] = sum_in_order(acc);
        }
        __syncthreads();
    }

    for (int p = tid; p < nx; p += blockDim.x) dx[p] = racc[p];
    // dks: a fixed shuffle tree in each warp, then the warps' sums in order
    for (int o = 16; o > 0; o >>= 1) dks += __shfl_down_sync(0xffffffffu, dks, o);
    if ((tid & 31) == 0) red[tid >> 5] = dks;
    __syncthreads();
    if (tid == 0) {
        T tot = T(0);
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += red[w];
        pp[(int64_t)M * Dx] = tot;
    }
}

// Sums the blocks' partials in a fixed order.  Block b serves slice
// d = b / chunks and 32 consecutive entries e of the M * Dx + 1 per slice;
// warp w sums the partial rows w, w + 32, ..., and warp 0 adds the 32 sums in
// warp order.  Entry e < M * Dx is dZ's (added to the Z rows' own gradients
// already in dZ when add_rows), the last is dks.
template <typename T>
__global__ void __launch_bounds__(RED_WARPS * 32)
rbf_gram_bwd_reduce(const T* __restrict__ part, T* __restrict__ dZ,
                    T* __restrict__ dks, int M, int Dx, int tiles, int chunks,
                    int add_rows) {
    __shared__ T acc[RED_WARPS][33];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int d = blockIdx.x / chunks;
    const int64_t E = (int64_t)M * Dx + 1;
    const int64_t e = (int64_t)(blockIdx.x - d * chunks) * 32 + lane;
    T sum = T(0);
    if (e < E)
        for (int b = w; b < tiles; b += RED_WARPS)
            sum += part[((int64_t)d * tiles + b) * E + e];
    acc[w][lane] = sum;
    __syncthreads();
    if (w != 0 || e >= E) return;
    T tot = T(0);
    for (int q = 0; q < RED_WARPS; ++q) tot += acc[q][lane];
    if (e == E - 1) {
        dks[d] = tot;
    } else {
        T* o = dZ + (int64_t)d * (E - 1) + e;
        *o = add_rows ? *o + tot : tot;
    }
}

template <typename T>
int64_t scratch(int Dy, int N, int M, int Dx, int pair) {
    Plan p;
    if (!plan<T>(Dy, N, M, Dx, pair != 0, p)) return -1;
    return (int64_t)Dy * p.tiles * ((int64_t)M * Dx + 1);
}

template <typename T>
int launch(const T* X, const T* Z, const T* ks, const T* gxz, const T* gzz,
           T* dX, T* dZ, T* dks, T* part, int Dy, int N, int M, int Dx,
           void* stream) {
    Plan p;
    if (!plan<T>(Dy, N, M, Dx, gzz != nullptr, p)) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (int64_t)Dy * p.tiles;
    const int64_t chunks = ((int64_t)M * Dx + 1 + 31) / 32;
    if (blocks <= 0 || blocks > INT32_MAX || (int64_t)Dy * chunks > INT32_MAX)
        return (int)cudaErrorInvalidConfiguration;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    rbf_gram_bwd_kernel<T><<<(unsigned)blocks, rbf::THREADS,
                             smem_bytes(p.TN, p.MC, Dx, sizeof(T)), st>>>(
        X, Z, ks, gxz, gzz, dX, dZ, part, N, M, Dx, p.TN, (int)p.tiles_x,
        (int)p.tiles, p.MC);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    rbf_gram_bwd_reduce<T><<<(unsigned)(Dy * chunks), RED_WARPS * 32, 0, st>>>(
        part, dZ, dks, M, Dx, (int)p.tiles, (int)chunks, gzz != nullptr);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Values of scratch `part` that rbf_gram_bwd_* needs, or -1 for a shape it
// does not take (Dx too wide for one row and V columns in the budget).
// Call with the device of the tensors current, as for rbf_gram_bwd_*.
int64_t rbf_gram_bwd_scratch_f32(int Dy, int N, int M, int Dx, int pair) {
    return scratch<float>(Dy, N, M, Dx, pair);
}

int64_t rbf_gram_bwd_scratch_f64(int Dy, int N, int M, int Dx, int pair) {
    return scratch<double>(Dy, N, M, Dx, pair);
}

// dX, dZ and dks from g_xz (Dy, N, M) and, unless gzz is null, g_zz
// (Dy, M, M).  Two launches on the stream: the block pass and its reduction.
// Run with the device of the tensors current (the plan reads its SM count).
int rbf_gram_bwd_f32(const float* X, const float* Z, const float* ks,
                     const float* gxz, const float* gzz, float* dX, float* dZ,
                     float* dks, float* part, int Dy, int N, int M, int Dx,
                     void* stream) {
    return launch<float>(X, Z, ks, gxz, gzz, dX, dZ, dks, part, Dy, N, M, Dx,
                         stream);
}

int rbf_gram_bwd_f64(const double* X, const double* Z, const double* ks,
                     const double* gxz, const double* gzz, double* dX,
                     double* dZ, double* dks, double* part, int Dy, int N,
                     int M, int Dx, void* stream) {
    return launch<double>(X, Z, ks, gxz, gzz, dX, dZ, dks, part, Dy, N, M, Dx,
                          stream);
}

}  // extern "C"
