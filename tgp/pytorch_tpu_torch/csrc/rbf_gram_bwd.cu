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
// Two designs of one pass and one fixed-order reduction; the wrapper's
// `bwd_design` chooses by shape (ops/rbf_gram.py).  Both read g once,
// recompute e (never read K) and are deterministic: no floating-point
// atomics; each block writes its dZ and dks partials, M * Dx + 1 values, to
// a scratch row of its own, and a second, small launch (rbf_gram_bwd_reduce)
// sums the rows in a fixed order (32 warps take fixed, strided subsets of
// the rows; their sums are added in warp order).  That launch was chosen over
// "the last block to finish reduces", which needs a counter zeroed before
// every call and a fence protocol.  Two runs give the same bits.
//
// Bound on the card: bytes, except at wide Dx.  It must read g, X, Z and ks
// and write dX, dZ and dks; K is recomputed, not read.  At the training shape
// (8611 x 100, Dx = 4, fp32) that is 3.72 MB, 1.11 us at 3.35 TB/s, against
// about 36 operations per output, 0.47 us at the fp32 rate; at YearMSD's
// Dx = 90 the three products (6 Dx operations an output) set it: 8.4 us.
//
// The block pass (rbf_gram_bwd_kernel), for one wave of small tiles: the
// flagship's pair and the single-wave fp32 shapes.
//   * A block owns TN whole rows.  It copies its rows of X, Z (transposed)
//     and its g rows into shared memory with cp.async, all copies in flight
//     at once (16 bytes each for g), so it waits for device memory once.  It
//     then recomputes e in registers (the forward's sums in the forward's
//     order) and turns the g tile into gK = ks * e * g in place (13.6 KB in
//     fp32 at M = 100).  From that tile it forms the rows' dX (a sum over j
//     per (row, feature)), its partial column sums for dZ (a sum over its
//     rows per (column, feature)), and its partial of dks.  Each long sum
//     runs as independent partial sums added in a fixed order.  Only where
//     the tile exceeds 48 KB is Z taken in column chunks (and TN halved for
//     very wide Dx).
//   * TN from the SM count: at least 32 rows, and as many more (up to 64) as
//     give the busiest SM the fewest rows.  At 8611 + 100 rows that is 257
//     blocks of 34 (every SM runs at most 2), not 274 of 32 (10 SMs ran 3).
//     The partials are 412 KB in fp32 at the training shape, an eighth of g.
//   * What holds it back elsewhere: copies, then arithmetic, never both; 48
//     KB of shared memory (at YearMSD fp64 Z in chunks of 2 columns, 50
//     rounds of stage, wait, compute); a partial row a block (22.8 MB at
//     YearMSD fp64, 2.8x g); fp64 products on the CUDA cores.
//
// The tile pass (rbf_gram_bwd_tile_kernel, rbf_gram_bwd_quad_kernel), for
// the rest: fp64 at Dx >= 8 and the multi-wave shapes.
//   * A block owns a run of row tiles of one slice.  It opts in to up to
//     227 KB of shared memory (rbf_gram_bwd_tile_setup, once a device), so
//     Z, its norms (computed once a block) and its dZ sums stay whole on chip
//     at every shape of chip_smoke.py's KERNEL_SHAPES, YearMSD's Dx = 90 and
//     airline's M = 500 included.
//   * The next tile's g and X rows load (cp.async) while this tile is
//     computed: two buffers, one commit group a tile.
//   * The dZ and dks sums stay in shared memory or registers across the
//     block's tiles: one partial row a block, as many blocks as fill the
//     card's resident slots once.  At YearMSD fp64 that is 132 rows, 9.5 MB,
//     against the block pass's 317 rows, 22.8 MB.
//   * fp64 (the fragment kernel): the three products, X Z^T over Dx,
//     gK [Z 1] over the columns and gK^T [X 1] over the tile's rows, run on
//     the tensor cores as mma.sync m16n8k8 (DMMA) on 16 x 8 fragments; the
//     column of ones gives each product's row or column sum of gK with it.
//     (On an NVIDIA H100 80GB HBM3 the kernel took 78 us at YearMSD fp64 on
//     m8n8k4, 65 us on m16n8k8.)
//   * fp32 stays fp32 on the CUDA cores (TF32 moved mu by 21-72% in the
//     solves): at Dx <= 16 the quad kernel, four threads a row, the row's
//     sums in registers and shuffles, a thread a column for dZ; at wider Dx
//     the fragment kernel with the products in the same lane layout.
//   * It costs more than the block pass at one wave of small tiles: a block
//     waits for Z and its first tile before it computes.
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
bool plan(int Dy, int N, int M, int Dx, bool pair, int sms, Plan& p) {
    constexpr int V = Pack<T>::V;
    if (Dy <= 0 || N < 0 || M <= 0 || Dx < 0 || sms <= 0) return false;
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

// ---------------------------------------------------------------------------
// The tile pass.  A block owns a run of row tiles of one slice and keeps Z,
// its norms and its dZ sums on chip across them; the g tile of the next row
// tile loads (cp.async, double-buffered) while this one is computed.
// ---------------------------------------------------------------------------

constexpr int WARPS = rbf::THREADS / 32;  // warps of a tile-pass block
constexpr int SMEM_MAX = 232448;          // dynamic shared memory a block may opt in to
constexpr int SMEM_SM = 233472;           // shared memory of an SM ...
constexpr int SMEM_RESERVED = 1024;       // ... of which the runtime keeps this a block
constexpr int QUAD_TN = rbf::THREADS / 4; // rows of a quad-kernel tile: 4 threads a row

__host__ __device__ __forceinline__ int up(int a, int b) { return (a + b - 1) / b * b; }

// Registers per thread of the tile kernels (fragment fp32, fragment fp64,
// quad DX = 4, 8 and 16), read once by rbf_gram_bwd_tile_setup; the plan
// derives the blocks resident on an SM from them.
int g_regs[5] = {0, 0, 0, 0, 0};

// Shared memory of the fragment kernel, in values of T, and where each array
// starts.  The g buffers come first, so their rows (ldg a multiple of 16
// bytes) take 16-byte copies.
struct FragLayout {
    int Mp, Dxp, Kp, ldz, ldg, ldx;
    int gs, xs, zs, acc, ps, zn, xn, red, total;
};

__host__ __device__ __forceinline__ FragLayout frag_layout(int TN, int M, int Dx) {
    // Z and the dZ sums keep M rows: the fragments' rows past M read zeros
    // from their accessors, so that Z stays whole at YearMSD's Dx = 90
    FragLayout L;
    L.Mp = up(M, 16);           // columns, padded to whole fragments
    L.Dxp = up(Dx + 1, 8);      // features and the column of ones
    L.Kp = up(Dx, 8);           // depth of X Z^T, a multiple of the mma's k
    L.ldg = L.Mp + 4;
    L.ldz = L.Dxp + 2;
    L.ldx = L.Dxp + 2;
    L.gs = 0;                                   // [2][TN][ldg] g, then gK in place
    L.xs = L.gs + 2 * TN * L.ldg;               // [2][TN][ldx] [X 1] rows
    L.zs = L.xs + 2 * TN * L.ldx;               // [M][ldz]     [Z 1]
    L.acc = L.zs + M * L.ldz;                   // [M][Dxp]     gK^T [X 1], summed
    L.ps = L.acc + M * L.Dxp;                   // [TN][ldx]    gK [Z 1] of a tile
    L.zn = L.ps + TN * L.ldx;                   // [Mp]         |z|^2
    L.xn = L.zn + L.Mp;                         // [TN]         |x|^2
    L.red = L.xn + TN;                          // [WARPS]      the warps' dks
    L.total = L.red + WARPS;
    return L;
}

// Shared memory of the quad kernel (fp32, Dx <= DX), in floats.  Row pitch
// of g: ldg = 4 (mod 32), so the 8 rows x 4 columns a warp reads at once
// fall in 32 banks.  After the last tile the g buffers hold the column sums
// of the H row groups (H = THREADS / M, 1 for M > THREADS).
struct QuadLayout {
    int ldg, H, gs, xs, zs, zn, red, total;
};

__host__ __device__ __forceinline__ QuadLayout quad_layout(int M, int Dx, int DX) {
    QuadLayout L;
    L.ldg = up(M, 4);
    while (L.ldg % 32 != 4) L.ldg += 4;
    L.H = M <= rbf::THREADS ? rbf::THREADS / M : 1;
    const int comb = (M <= rbf::THREADS ? L.H * M : M) * (Dx + 1);
    L.gs = 0;
    L.xs = up(2 * QUAD_TN * L.ldg > comb ? 2 * QUAD_TN * L.ldg : comb, 4);
    L.zs = L.xs + 2 * QUAD_TN * DX;             // [M][DX]
    L.zn = L.zs + M * DX;
    L.red = L.zn + M;
    L.total = L.red + WARPS;
    return L;
}

// Tile t of slice d: its rows (of X, or of Z for the pair's K_zz rows), their
// cotangent rows and their gradient rows.
template <typename T>
struct Rows {
    const T* x;
    const T* g;
    T* dx;
    int nrows;
};

template <typename T>
__device__ __forceinline__ Rows<T> rows_of(int t, int d, int N, int M, int Dx,
                                           int TN, int tiles_x, const T* X,
                                           const T* Z, const T* gxz,
                                           const T* gzz, T* dX, T* dZ) {
    const bool zpart = t >= tiles_x;
    const int row0 = (zpart ? t - tiles_x : t) * TN;
    const int rows = zpart ? M : N;
    const int64_t first = (int64_t)d * rows + row0;
    Rows<T> r;
    r.x = (zpart ? Z : X) + first * Dx;
    r.g = (zpart ? gzz : gxz) + first * M;
    r.dx = (zpart ? dZ : dX) + first * Dx;
    r.nrows = min(TN, rows - row0);
    return r;
}

// (i, j) = divmod(e, W) for e = threadIdx.x, threadIdx.x + blockDim.x, ...:
// a block-strided walk over a row-major (rows, W) range without a division
// a step.
struct Walk {
    int i, j, di, dj, W;
    __device__ __forceinline__ explicit Walk(int w) : W(w) {
        i = threadIdx.x / W;
        j = threadIdx.x - i * W;
        di = blockDim.x / W;
        dj = blockDim.x - di * W;
    }
    __device__ __forceinline__ void next() {
        i += di;
        j += dj;
        if (j >= W) {
            j -= W;
            ++i;
        }
    }
};

// Start copying TN rows of g (nrows real, each M values) into dst[i * ld + j]
// for j < cols (a multiple of V): 16-byte copies where a group is whole and
// aligned, value by value at the ragged end, zeros past it.
template <typename T>
__device__ __forceinline__ void stage_g(const T* g, int nrows, int TN, int M,
                                        int cols, int ld, T* dst) {
    constexpr int V = Pack<T>::V;
    for (Walk w(cols / V); w.i < TN; w.next()) {
        const int i = w.i, j0 = w.j * V;
        T* o = dst + i * ld + j0;
        const T* src = g + (int64_t)i * M + j0;
        if (i < nrows && j0 + V <= M && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            __pipeline_memcpy_async(o, src, 16);
        } else {
#pragma unroll
            for (int v = 0; v < V; ++v) {
                if (i < nrows && j0 + v < M)
                    __pipeline_memcpy_async(o + v, src + v, sizeof(T));
                else
                    o[v] = T(0);
            }
        }
    }
}

// Start copying `rows` rows (nrows real, each Dx values) into dst[i * ld + f]
// for f < W: column `ones` of a real row is 1 (none if negative), the rest
// past Dx, and every row past nrows, 0.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* x, int nrows, int rows, int Dx,
                                           int W, int ld, int ones, T* dst) {
    for (Walk w(W); w.i < rows; w.next()) {
        const int i = w.i, f = w.j;
        T* o = dst + i * ld + f;
        if (i < nrows && f < Dx)
            __pipeline_memcpy_async(o, x + (int64_t)i * Dx + f, sizeof(T));
        else
            *o = i < nrows && f == ones ? T(1) : T(0);
    }
}

// mma.sync m16n8k8 in fp64 (DMMA): D = A B + D for one warp, where lane
// l = 4 g + t holds A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4),
// B(t, g), B(t + 4, g) and D(g + 8 h, 2 t + v) as d[h][v].
__device__ __forceinline__ void mma_f64(double (&d)[2][2], double a0, double a1,
                                        double a2, double a3, double b0, double b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d[0][0]), "+d"(d[0][1]), "+d"(d[1][0]), "+d"(d[1][1])
        : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// One 16 x 8 fragment of a product over k < K, added to c: in lane
// l = 4 g + t, c[h][v] += sum_k a(m0 + g + 8 h, k) b(k, n0 + 2 t + v).
// fp64 on the tensor cores (K a multiple of 8): the even and the odd
// k-steps go to two independent sums, added at the end, so that two mma
// chains are in flight.  fp32 on the CUDA cores, in the same lane layout,
// with no TF32.
template <typename FA, typename FB>
__device__ __forceinline__ void frag_dot(double (&c)[2][2], int K, const FA& a,
                                         const FB& b, int m0, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = m0 + g, r1 = m0 + g + 8, n = n0 + g;
    double p[2][2] = {{0., 0.}, {0., 0.}};
    for (int k0 = 0; k0 < K; k0 += 16) {
        mma_f64(c, a(r0, k0 + t), a(r1, k0 + t), a(r0, k0 + t + 4), a(r1, k0 + t + 4),
                b(k0 + t, n), b(k0 + t + 4, n));
        const int k1 = k0 + 8;
        if (k1 < K)
            mma_f64(p, a(r0, k1 + t), a(r1, k1 + t), a(r0, k1 + t + 4),
                    a(r1, k1 + t + 4), b(k1 + t, n), b(k1 + t + 4, n));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 2; ++v) c[h][v] += p[h][v];
}

template <typename FA, typename FB>
__device__ __forceinline__ void frag_dot(float (&c)[2][2], int K, const FA& a,
                                         const FB& b, int m0, int n0) {
    const int lane = threadIdx.x & 31, r0 = m0 + (lane >> 2), n = n0 + 2 * (lane & 3);
    for (int k = 0; k < K; ++k) {
        const float a0 = a(r0, k), a1 = a(r0 + 8, k), b0 = b(k, n), b1 = b(k, n + 1);
        c[0][0] += a0 * b0;
        c[0][1] += a0 * b1;
        c[1][0] += a1 * b0;
        c[1][1] += a1 * b1;
    }
}

// The block's dks, a fixed shuffle tree in each warp and the warps' sums in
// order, into *out.
template <typename T>
__device__ __forceinline__ void block_dks(T dks, T* red, T* out) {
    for (int o = 16; o > 0; o >>= 1) dks += __shfl_down_sync(0xffffffffu, dks, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = dks;
    __syncthreads();
    if (threadIdx.x == 0) {
        T tot = T(0);
        for (int w = 0; w < WARPS; ++w) tot += red[w];
        *out = tot;
    }
}

// The fragment kernel: the three products on 16 x 8 fragments, fp64 on the
// tensor cores.  Per row tile: cross = X Z^T (then e and gK = ks e g in
// place of g), P = gK [Z 1] (dX = P[:, :Dx] - P[:, Dx] x) and
// acc += gK^T [X 1] (kept across the block's tiles; its column Dx is the
// column sum of gK).  Block b of slice d writes partial row d * bps + b:
// acc[:, :Dx] - acc[:, Dx] z, then dks.
template <typename T>
__global__ void __launch_bounds__(rbf::THREADS)
rbf_gram_bwd_tile_kernel(const T* __restrict__ X, const T* __restrict__ Z,
                         const T* __restrict__ ks, const T* __restrict__ gxz,
                         const T* __restrict__ gzz, T* __restrict__ dX,
                         T* __restrict__ dZ, T* __restrict__ part, int N, int M,
                         int Dx, int TN, int tiles_x, int tiles, int bps) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* sm = reinterpret_cast<T*>(smem);
    const FragLayout L = frag_layout(TN, M, Dx);
    T* zs = sm + L.zs;
    T* acc = sm + L.acc;
    T* ps = sm + L.ps;
    T* zn = sm + L.zn;
    T* xn = sm + L.xn;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int d = blockIdx.x / bps, b = blockIdx.x - d * bps;
    const int t0 = (int)((int64_t)tiles * b / bps);
    const int t1 = (int)((int64_t)tiles * (b + 1) / bps);
    const T s = ks[d];
    T* pp = part + (int64_t)blockIdx.x * ((int64_t)M * Dx + 1);

    stage_rows(Z + (int64_t)d * M * Dx, M, M, Dx, L.Dxp, L.ldz, Dx, zs);
    if (t0 < t1) {
        const Rows<T> r = rows_of(t0, d, N, M, Dx, TN, tiles_x, X, Z, gxz, gzz, dX, dZ);
        stage_g(r.g, r.nrows, TN, M, L.Mp, L.ldg, sm + L.gs);
        stage_rows(r.x, r.nrows, TN, Dx, L.Dxp, L.ldx, Dx, sm + L.xs);
    }
    __pipeline_commit();
    for (int e = tid; e < M * L.Dxp; e += blockDim.x) acc[e] = T(0);
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int j = tid; j < L.Mp; j += blockDim.x) {   // once a block, in index order
        T n = T(0);
        for (int f = 0; f < Dx && j < M; ++f) n += zs[j * L.ldz + f] * zs[j * L.ldz + f];
        zn[j] = n;
    }

    const int nbn = L.Mp / 8, nbf = L.Dxp / 8;        // 8-column blocks
    const int nfa = TN / 16 * nbn, nfb = TN / 16 * nbf, nfc = L.Mp / 16 * nbf;
    const int fr = lane >> 2, fc = 2 * (lane & 3);    // this lane's place in a fragment
    T dks = T(0);
    for (int t = t0; t < t1; ++t) {
        const int cur = (t - t0) & 1;
        T* g = sm + L.gs + cur * TN * L.ldg;
        T* x = sm + L.xs + cur * TN * L.ldx;
        const Rows<T> rw = rows_of(t, d, N, M, Dx, TN, tiles_x, X, Z, gxz, gzz, dX, dZ);
        if (t + 1 < t1) {       // the next tile loads while this one is computed
            const Rows<T> nx = rows_of(t + 1, d, N, M, Dx, TN, tiles_x, X, Z, gxz, gzz,
                                       dX, dZ);
            stage_g(nx.g, nx.nrows, TN, M, L.Mp, L.ldg, sm + L.gs + (cur ^ 1) * TN * L.ldg);
            stage_rows(nx.x, nx.nrows, TN, Dx, L.Dxp, L.ldx, Dx,
                       sm + L.xs + (cur ^ 1) * TN * L.ldx);
        }
        __pipeline_commit();
        for (int i = tid; i < TN; i += blockDim.x) {
            T n = T(0);
            for (int f = 0; f < Dx; ++f) n += x[i * L.ldx + f] * x[i * L.ldx + f];
            xn[i] = n;
        }
        __syncthreads();

        // cross = X Z^T, then e and gK = ks e g in place of g
        const auto xa = [&](int m, int k) { return k < Dx ? x[m * L.ldx + k] : T(0); };
        const auto zb = [&](int k, int n) { return n < M ? zs[n * L.ldz + k] : T(0); };
        for (int f = warp; f < nfa; f += WARPS) {
            const int m0 = f / nbn * 16, n0 = f % nbn * 8;
            T c[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
            frag_dot(c, L.Kp, xa, zb, m0, n0);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = m0 + fr + 8 * h;
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    const int j = n0 + fc + v;
                    const T e = rbf::rbf_e(xn[i], zn[j], c[h][v]);
                    T& gv = g[i * L.ldg + j];
                    dks += gv * e;
                    gv = s * e * gv;
                }
            }
        }
        __syncthreads();

        // P = gK [Z 1] (rows), acc += gK^T [X 1] (columns)
        const auto ga = [&](int m, int k) { return g[m * L.ldg + k]; };
        const auto zr = [&](int k, int n) { return k < M ? zs[k * L.ldz + n] : T(0); };
        for (int f = warp; f < nfb; f += WARPS) {
            const int m0 = f / nbf * 16, n0 = f % nbf * 8;
            T c[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
            frag_dot(c, L.Mp, ga, zr, m0, n0);
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int v = 0; v < 2; ++v) ps[(m0 + fr + 8 * h) * L.ldx + n0 + fc + v] = c[h][v];
        }
        const auto gt = [&](int m, int k) { return g[k * L.ldg + m]; };
        const auto xb = [&](int k, int n) { return x[k * L.ldx + n]; };
        for (int f = warp; f < nfc; f += WARPS) {
            const int m0 = f / nbf * 16, n0 = f % nbf * 8;
            T c[2][2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    const int j = m0 + fr + 8 * h;
                    c[h][v] = j < M ? acc[j * L.Dxp + n0 + fc + v] : T(0);
                }
            frag_dot(c, TN, gt, xb, m0, n0);
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    const int j = m0 + fr + 8 * h;
                    if (j < M) acc[j * L.Dxp + n0 + fc + v] = c[h][v];
                }
        }
        __syncthreads();

        for (Walk w(Dx); w.i < rw.nrows; w.next())
            rw.dx[w.i * Dx + w.j] = ps[w.i * L.ldx + w.j]
                                    - ps[w.i * L.ldx + Dx] * x[w.i * L.ldx + w.j];
        __pipeline_wait_prior(0);
        __syncthreads();
    }

    for (Walk w(Dx); w.i < M; w.next())
        pp[w.i * Dx + w.j] = acc[w.i * L.Dxp + w.j]
                             - acc[w.i * L.Dxp + Dx] * zs[w.i * L.ldz + w.j];
    block_dks(dks, sm + L.red, pp + (int64_t)M * Dx);
}

// The quad kernel, fp32 at Dx <= DX and M <= 2 * THREADS, on the CUDA cores
// with the sums in registers.  A tile is QUAD_TN rows; thread (r, q) = (tid / 4,
// tid % 4) takes row r against columns q, q + 4, ...: cross, e, gK (written
// back in place of g for the column pass), dks, and its share of the row's
// gK [Z 1], which the four threads of the row add by shuffles.  Then thread
// (h, j) adds gK[i, j] [x_i 1] over the tile's rows i = h (mod H) into
// registers kept across the block's tiles (columns j and j + THREADS where
// M > THREADS).  At the end the H row groups' sums are added in order.
template <int DX>
__global__ void __launch_bounds__(rbf::THREADS)
rbf_gram_bwd_quad_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                         const float* __restrict__ ks, const float* __restrict__ gxz,
                         const float* __restrict__ gzz, float* __restrict__ dX,
                         float* __restrict__ dZ, float* __restrict__ part, int N,
                         int M, int Dx, int tiles_x, int tiles, int bps) {
    constexpr int TN = QUAD_TN, V4 = DX / 4;
    extern __shared__ __align__(16) unsigned char smem[];
    float* sm = reinterpret_cast<float*>(smem);
    const QuadLayout L = quad_layout(M, Dx, DX);
    float* zs = sm + L.zs;
    float* zn = sm + L.zn;
    const int tid = threadIdx.x;
    const int d = blockIdx.x / bps, b = blockIdx.x - d * bps;
    const int t0 = (int)((int64_t)tiles * b / bps);
    const int t1 = (int)((int64_t)tiles * (b + 1) / bps);
    const float s = ks[d];
    float* pp = part + (int64_t)blockIdx.x * ((int64_t)M * Dx + 1);
    const int Mc = M < rbf::THREADS ? M : rbf::THREADS;
    const int h = tid / Mc, jc = tid - h * Mc;    // the column pass's row group, column
    const bool active = h < L.H;
    const int r = tid >> 2, q = tid & 3;          // the row pass's row and column phase
    const int gcols = up(M, 4);

    stage_rows(Z + (int64_t)d * M * Dx, M, M, Dx, DX, DX, -1, zs);
    if (t0 < t1) {
        const Rows<float> rw = rows_of(t0, d, N, M, Dx, TN, tiles_x, X, Z, gxz, gzz, dX, dZ);
        stage_g(rw.g, rw.nrows, TN, M, gcols, L.ldg, sm + L.gs);
        stage_rows(rw.x, rw.nrows, TN, Dx, DX, DX, -1, sm + L.xs);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int j = tid; j < M; j += blockDim.x) {   // once a block, in index order
        float n = 0.f;
        for (int f = 0; f < Dx; ++f) n += zs[j * DX + f] * zs[j * DX + f];
        zn[j] = n;
    }

    float acc[2][DX + 1];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int f = 0; f <= DX; ++f) acc[u][f] = 0.f;
    float dks = 0.f;
    for (int t = t0; t < t1; ++t) {
        const int cur = (t - t0) & 1;
        float* g = sm + L.gs + cur * TN * L.ldg;
        const float* x = sm + L.xs + cur * TN * DX;
        const Rows<float> rw = rows_of(t, d, N, M, Dx, TN, tiles_x, X, Z, gxz, gzz, dX, dZ);
        if (t + 1 < t1) {       // the next tile loads while this one is computed
            const Rows<float> nx = rows_of(t + 1, d, N, M, Dx, TN, tiles_x, X, Z, gxz,
                                           gzz, dX, dZ);
            stage_g(nx.g, nx.nrows, TN, M, gcols, L.ldg, sm + L.gs + (cur ^ 1) * TN * L.ldg);
            stage_rows(nx.x, nx.nrows, TN, Dx, DX, DX, -1, sm + L.xs + (cur ^ 1) * TN * DX);
        }
        __pipeline_commit();
        __syncthreads();

        // row pass: row r against columns q, q + 4, ...
        float xr[DX], P[DX], rs = 0.f, xn = 0.f;
#pragma unroll
        for (int k = 0; k < V4; ++k) {
            const float4 v = *reinterpret_cast<const float4*>(x + r * DX + 4 * k);
            xr[4 * k] = v.x;
            xr[4 * k + 1] = v.y;
            xr[4 * k + 2] = v.z;
            xr[4 * k + 3] = v.w;
        }
#pragma unroll
        for (int f = 0; f < DX; ++f) {
            xn += xr[f] * xr[f];
            P[f] = 0.f;
        }
        for (int j = q; j < M; j += 4) {
            float zv[DX], cross = 0.f;
#pragma unroll
            for (int k = 0; k < V4; ++k) {
                const float4 v = *reinterpret_cast<const float4*>(zs + j * DX + 4 * k);
                zv[4 * k] = v.x;
                zv[4 * k + 1] = v.y;
                zv[4 * k + 2] = v.z;
                zv[4 * k + 3] = v.w;
            }
#pragma unroll
            for (int f = 0; f < DX; ++f) cross += xr[f] * zv[f];
            const float e = rbf::rbf_e(xn, zn[j], cross);
            const float gv = g[r * L.ldg + j];
            dks += gv * e;
            const float gk = s * e * gv;
            g[r * L.ldg + j] = gk;
            rs += gk;
#pragma unroll
            for (int f = 0; f < DX; ++f) P[f] += gk * zv[f];
        }
#pragma unroll
        for (int f = 0; f < DX; ++f) {
            P[f] += __shfl_xor_sync(0xffffffffu, P[f], 1);
            P[f] += __shfl_xor_sync(0xffffffffu, P[f], 2);
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        if (r < rw.nrows) {
#pragma unroll
            for (int f = 0; f < DX; ++f)
                if (f < Dx && (f & 3) == q) rw.dx[r * Dx + f] = P[f] - rs * xr[f];
        }
        __syncthreads();

        // column pass: rows h, h + H, ... into the column sums
        if (active) {
            for (int i = h; i < rw.nrows; i += L.H) {
                float xv[DX];
#pragma unroll
                for (int k = 0; k < V4; ++k) {
                    const float4 v = *reinterpret_cast<const float4*>(x + i * DX + 4 * k);
                    xv[4 * k] = v.x;
                    xv[4 * k + 1] = v.y;
                    xv[4 * k + 2] = v.z;
                    xv[4 * k + 3] = v.w;
                }
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int j = jc + u * rbf::THREADS;
                    if (u == 1 && j >= M) break;
                    const float gk = g[i * L.ldg + j];
#pragma unroll
                    for (int f = 0; f < DX; ++f) acc[u][f] += gk * xv[f];
                    acc[u][DX] += gk;
                }
            }
        }
        __pipeline_wait_prior(0);
        __syncthreads();
    }

    float* comb = sm + L.gs;    // [H][M][Dx + 1]: the g buffers are free now
    if (active) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int j = jc + u * rbf::THREADS;
            if (u == 1 && j >= M) break;
            float* o = comb + (int64_t)(h * M + j) * (Dx + 1);
#pragma unroll
            for (int f = 0; f < DX; ++f)
                if (f < Dx) o[f] = acc[u][f];
            o[Dx] = acc[u][DX];
        }
    }
    __syncthreads();
    for (Walk w(Dx); w.i < M; w.next()) {
        const int j = w.i, f = w.j;
        float a = 0.f, c = 0.f;
        for (int hh = 0; hh < L.H; ++hh) {
            a += comb[(hh * M + j) * (Dx + 1) + f];
            c += comb[(hh * M + j) * (Dx + 1) + Dx];
        }
        pp[j * Dx + f] = a - c * zs[j * DX + f];
    }
    block_dks(dks, sm + L.red, pp + (int64_t)M * Dx);
}

struct TilePlan {
    int quad;                   // 0: the fragment kernel; 4, 8 or 16: the quad kernel's DX
    int TN;                     // rows per tile
    int tiles_x, tiles;         // row tiles of X, of X and Z, per slice
    int bps;                    // blocks per slice
    int smem;                   // dynamic shared memory, bytes
};

// Blocks of a kernel resident on an SM, from its shared memory and registers.
int resident(int smem, int regs) {
    const int by_smem = SMEM_SM / (smem + SMEM_RESERVED);
    const int by_regs = 65536 / (up(regs, 8) * rbf::THREADS);
    return std::max(1, std::min(std::min(by_smem, by_regs), 2048 / rbf::THREADS));
}

// The quad kernel's DX for Gram columns M and features Dx, or 0 where the
// fragment kernel runs: fp32 with Dx <= 16 and M <= 2 * THREADS takes the
// quad kernel where its g tiles of 64 rows fit (M up to about 420).
template <typename T>
int quad_dx(int M, int Dx) {
    const int DX = sizeof(T) == 4 && Dx <= 16 && M <= 2 * rbf::THREADS
                       ? (Dx <= 4 ? 4 : Dx <= 8 ? 8 : 16) : 0;
    return DX && quad_layout(M, Dx, DX).total * (int64_t)sizeof(T) <= SMEM_MAX ? DX : 0;
}

// Which kernel of the tile pass takes Gram columns M and features Dx: 0 none
// (Z, its dZ sums and one 16-row tile do not fit 227 KB), 1 the quad kernel,
// 2 the fragment kernel.  The wrapper's rule reads it.
template <typename T>
int tile_kind(int M, int Dx) {
    if (M <= 0 || Dx <= 0) return 0;
    if (quad_dx<T>(M, Dx)) return 1;
    return (int64_t)frag_layout(16, M, Dx).total * (int64_t)sizeof(T) <= SMEM_MAX ? 2 : 0;
}

// The tile pass's plan.  The quad kernel where quad_dx takes the shape; every
// other shape the fragment kernel, with the largest TN (64, 32 or 16 rows)
// that lets two blocks share an SM, else the largest that fits one.  Blocks
// per slice: as many as fill the card's resident slots once (`sms`, the
// caller's cached SM count), at most one per tile.  False for a shape it does
// not take (tile_kind 0) or before rbf_gram_bwd_tile_setup has run.
template <typename T>
bool tile_plan(int Dy, int N, int M, int Dx, bool pair, int sms, TilePlan& p) {
    if (Dy <= 0 || N < 0 || M <= 0 || Dx <= 0 || sms <= 0) return false;
    int regs = 0;
    p.quad = quad_dx<T>(M, Dx);
    if (p.quad) {
        p.TN = QUAD_TN;
        p.smem = quad_layout(M, Dx, p.quad).total * (int)sizeof(T);
        regs = g_regs[p.quad == 4 ? 2 : p.quad == 8 ? 3 : 4];
    } else {
        p.TN = 0;
        for (int pass = 0; pass < 2 && !p.TN; ++pass) {
            const int cap = pass == 0 ? SMEM_SM / 2 - SMEM_RESERVED : SMEM_MAX;
            for (int tn = 64; tn >= 16 && !p.TN; tn /= 2)
                if ((int64_t)frag_layout(tn, M, Dx).total * (int64_t)sizeof(T) <= cap)
                    p.TN = tn;
        }
        if (!p.TN) return false;
        p.smem = frag_layout(p.TN, M, Dx).total * (int)sizeof(T);
        regs = g_regs[sizeof(T) == 8 ? 1 : 0];
    }
    if (p.smem > SMEM_MAX || regs <= 0) return false;
    p.tiles_x = (N + p.TN - 1) / p.TN;
    p.tiles = p.tiles_x + (pair ? (M + p.TN - 1) / p.TN : 0);
    if (p.tiles <= 0) return false;
    const int64_t slots = (int64_t)resident(p.smem, regs) * sms;
    p.bps = (int)std::max<int64_t>(1, std::min<int64_t>(p.tiles, slots / Dy));
    return true;
}

template <typename T>
int64_t tile_scratch(int Dy, int N, int M, int Dx, int pair, int sms) {
    TilePlan p;
    if (!tile_plan<T>(Dy, N, M, Dx, pair != 0, sms, p)) return -1;
    return (int64_t)Dy * p.bps * ((int64_t)M * Dx + 1);
}

template <typename T>
int tile_launch(const T* X, const T* Z, const T* ks, const T* gxz, const T* gzz,
                T* dX, T* dZ, T* dks, T* part, int Dy, int N, int M, int Dx,
                int sms, void* stream) {
    TilePlan p;
    if (!tile_plan<T>(Dy, N, M, Dx, gzz != nullptr, sms, p))
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = (int64_t)Dy * p.bps;
    const int64_t chunks = ((int64_t)M * Dx + 1 + 31) / 32;
    if (blocks > INT32_MAX || (int64_t)Dy * chunks > INT32_MAX)
        return (int)cudaErrorInvalidConfiguration;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (sizeof(T) == 4) {
        if (p.quad == 4)
            rbf_gram_bwd_quad_kernel<4><<<(unsigned)blocks, rbf::THREADS, p.smem, st>>>(
                X, Z, ks, gxz, gzz, dX, dZ, part, N, M, Dx, p.tiles_x, p.tiles, p.bps);
        else if (p.quad == 8)
            rbf_gram_bwd_quad_kernel<8><<<(unsigned)blocks, rbf::THREADS, p.smem, st>>>(
                X, Z, ks, gxz, gzz, dX, dZ, part, N, M, Dx, p.tiles_x, p.tiles, p.bps);
        else if (p.quad == 16)
            rbf_gram_bwd_quad_kernel<16><<<(unsigned)blocks, rbf::THREADS, p.smem, st>>>(
                X, Z, ks, gxz, gzz, dX, dZ, part, N, M, Dx, p.tiles_x, p.tiles, p.bps);
    }
    if (p.quad == 0)
        rbf_gram_bwd_tile_kernel<T><<<(unsigned)blocks, rbf::THREADS, p.smem, st>>>(
            X, Z, ks, gxz, gzz, dX, dZ, part, N, M, Dx, p.TN, p.tiles_x, p.tiles, p.bps);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    rbf_gram_bwd_reduce<T><<<(unsigned)(Dy * chunks), RED_WARPS * 32, 0, st>>>(
        part, dZ, dks, M, Dx, p.bps, (int)chunks, gzz != nullptr);
    return (int)cudaGetLastError();
}

template <typename T>
int64_t scratch(int Dy, int N, int M, int Dx, int pair, int sms) {
    Plan p;
    if (!plan<T>(Dy, N, M, Dx, pair != 0, sms, p)) return -1;
    return (int64_t)Dy * p.tiles * ((int64_t)M * Dx + 1);
}

template <typename T>
int launch(const T* X, const T* Z, const T* ks, const T* gxz, const T* gzz,
           T* dX, T* dZ, T* dks, T* part, int Dy, int N, int M, int Dx,
           int sms, void* stream) {
    Plan p;
    if (!plan<T>(Dy, N, M, Dx, gzz != nullptr, sms, p))
        return (int)cudaErrorInvalidValue;
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

// Opts the tile kernels in to SMEM_MAX bytes of dynamic shared memory on the
// current device and reads their registers for the plan.
int tile_setup() {
    const void* fns[5] = {(const void*)rbf_gram_bwd_tile_kernel<float>,
                          (const void*)rbf_gram_bwd_tile_kernel<double>,
                          (const void*)rbf_gram_bwd_quad_kernel<4>,
                          (const void*)rbf_gram_bwd_quad_kernel<8>,
                          (const void*)rbf_gram_bwd_quad_kernel<16>};
    for (int i = 0; i < 5; ++i) {
        cudaError_t err = cudaFuncSetAttribute(
            fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        cudaFuncAttributes a;
        err = cudaFuncGetAttributes(&a, fns[i]);
        if (err != cudaSuccess) return (int)err;
        g_regs[i] = a.numRegs;
    }
    return 0;
}

}  // namespace

extern "C" {

// The block pass.
// Values of scratch `part` that rbf_gram_bwd_* needs, or -1 for a shape it
// does not take (Dx too wide for one row and V columns in the budget).
// `sms` is the device's SM count (the caller caches it).
int64_t rbf_gram_bwd_scratch_f32(int Dy, int N, int M, int Dx, int pair, int sms) {
    return scratch<float>(Dy, N, M, Dx, pair, sms);
}

int64_t rbf_gram_bwd_scratch_f64(int Dy, int N, int M, int Dx, int pair, int sms) {
    return scratch<double>(Dy, N, M, Dx, pair, sms);
}

// dX, dZ and dks from g_xz (Dy, N, M) and, unless gzz is null, g_zz
// (Dy, M, M).  Two launches on the stream: the block pass and its reduction.
int rbf_gram_bwd_f32(const float* X, const float* Z, const float* ks,
                     const float* gxz, const float* gzz, float* dX, float* dZ,
                     float* dks, float* part, int Dy, int N, int M, int Dx,
                     int sms, void* stream) {
    return launch<float>(X, Z, ks, gxz, gzz, dX, dZ, dks, part, Dy, N, M, Dx,
                         sms, stream);
}

int rbf_gram_bwd_f64(const double* X, const double* Z, const double* ks,
                     const double* gxz, const double* gzz, double* dX,
                     double* dZ, double* dks, double* part, int Dy, int N,
                     int M, int Dx, int sms, void* stream) {
    return launch<double>(X, Z, ks, gxz, gzz, dX, dZ, dks, part, Dy, N, M, Dx,
                          sms, stream);
}

// The tile pass.  Run once per device, with it current, before the others.
int rbf_gram_bwd_tile_setup(void) { return tile_setup(); }

// Which of its kernels takes Gram columns M and features Dx: 0 none, 1 the
// quad kernel, 2 the fragment kernel (no device query; before the setup too).
int rbf_gram_bwd_tile_kind_f32(int M, int Dx) { return tile_kind<float>(M, Dx); }

int rbf_gram_bwd_tile_kind_f64(int M, int Dx) { return tile_kind<double>(M, Dx); }

// As rbf_gram_bwd_scratch_*, for the tile pass (-1: Z and one 16-row tile do
// not fit 227 KB of shared memory, or the setup has not run).
int64_t rbf_gram_bwd_tile_scratch_f32(int Dy, int N, int M, int Dx, int pair, int sms) {
    return tile_scratch<float>(Dy, N, M, Dx, pair, sms);
}

int64_t rbf_gram_bwd_tile_scratch_f64(int Dy, int N, int M, int Dx, int pair, int sms) {
    return tile_scratch<double>(Dy, N, M, Dx, pair, sms);
}

// As rbf_gram_bwd_*: the tile pass and the same reduction, two launches.
int rbf_gram_bwd_tile_f32(const float* X, const float* Z, const float* ks,
                          const float* gxz, const float* gzz, float* dX, float* dZ,
                          float* dks, float* part, int Dy, int N, int M, int Dx,
                          int sms, void* stream) {
    return tile_launch<float>(X, Z, ks, gxz, gzz, dX, dZ, dks, part, Dy, N, M, Dx,
                              sms, stream);
}

int rbf_gram_bwd_tile_f64(const double* X, const double* Z, const double* ks,
                          const double* gxz, const double* gzz, double* dX,
                          double* dZ, double* dks, double* part, int Dy, int N,
                          int M, int Dx, int sms, void* stream) {
    return tile_launch<double>(X, Z, ks, gxz, gzz, dX, dZ, dks, part, Dy, N, M, Dx,
                               sms, stream);
}

}  // extern "C"
