// Fused ARD-RBF Gram kernel for Hopper (sm_90a), plain C interface.
//
//   K[d, i, j] = ks[d] * exp(-0.5 * max(|x_di|^2 + |z_dj|^2 - 2 x_di . z_dj, 0))
//
// on inputs already divided by the ARD lengthscale: X (Dy, N, Dx),
// Z (Dy, M, Dx), ks (Dy,), all contiguous row-major.  One launch writes
// K_xz = K(X, Z) (Dy, N, M) and, when Kzz is given, K_zz = K(Z, Z) (Dy, M, M):
// the row set is [X rows; Z rows], each row against Z.  Without Kzz it is the
// single Gram K(X1, X2).
//
// Replaces: tgp/pytorch_tpu/ops/pallas/rbf_gram.py `_forward` (pallas_call
// at :85, body `_gram_kernel` at :50-63), which `marginal_qf` reached twice,
// for K_zz and K_xz.  Same arithmetic: the |x|^2 + |z|^2 - 2 x.z expansion
// clamped at 0, with each sum over Dx taken in index order, and ks applied
// last.  No tensor cores: Dx = 4 is below wgmma's depth, and TF32 would cost
// three digits of a Gram that feeds an ill-conditioned Cholesky (fp32 is
// already 8e-3 off fp64 on the flagship's predictive variance).
//
// Bound on the card: bytes, and the launch.  The flagship pair at bucket 4096
// (Dx = 4, M = 100) moves 1.75 MB in fp32, 0.52 us at 3.35 TB/s, almost all
// of it the outputs; at the training shape (8611 rows) 3.62 MB, 1.08 us.  Its
// operations (about 30 per output) are a tenth of that at the fp32 rate.
// The launch costs about 2 us, so the pair takes one launch, not two.
//
// Design for that bound:
//   * A block owns TN whole output rows, all M columns, so its output is one
//     contiguous span of TN * M values.  Each thread computes a group of V
//     consecutive outputs (V = 4 floats or 2 doubles) and writes it with one
//     16-byte store; consecutive threads own consecutive groups, so a warp
//     writes 512 contiguous bytes.  A group that is unaligned or runs past M
//     is written value by value.
//   * Z, transposed, and its squared norms are staged once per block in
//     shared memory ((Dx + 1) * M values, 2 KB at the flagship), and read back
//     16 bytes at a time without bank conflicts.  Only where (Dx + 1) * M
//     values exceed 48 KB is Z staged in column chunks of MC.
//   * TN = 256 / (groups per row), so each of the 256 threads owns one group:
//     TN = 10 at M = 100 in fp32, which gives 36 blocks at bucket 256, 420 at
//     bucket 4096 and 872 at 8611 rows for the 132 SMs, every output in
//     flight at once.
//   * The grid is flat: Dy x row tiles in gridDim.x (up to 2^31 - 1 blocks),
//     so neither N nor Dy meets a grid dimension's 65535 cap.
//
// Launches on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include "rbf_gram_common.cuh"

namespace {

using rbf::Pack;

// Stage rows [c0, c0 + mc) of z (each Dx values) transposed into
// zt[k * ld + j] and their squared norms into zn[j], summed over k in index
// order; columns [mc, mcp) are zero so that 16-byte groups can run past mc.
// One thread per column.  The caller syncs before reading zt and zn.
template <typename T>
__device__ __forceinline__ void stage_z(const T* __restrict__ z, int c0, int mc,
                                        int mcp, int Dx, int ld, T* zt, T* zn) {
    for (int j = threadIdx.x; j < mcp; j += blockDim.x) {
        const T* zr = z + (int64_t)(c0 + j) * Dx;
        T acc = T(0);
        for (int k = 0; k < Dx; ++k) {
            const T v = j < mc ? zr[k] : T(0);
            zt[k * ld + j] = v;
            acc += v * v;
        }
        zn[j] = acc;
    }
}

template <typename T>
__global__ void __launch_bounds__(rbf::THREADS)
rbf_gram_kernel(const T* __restrict__ X, const T* __restrict__ Z,
                const T* __restrict__ ks, T* __restrict__ Kxz,
                T* __restrict__ Kzz, int N, int M, int Dx, int TN,
                int tiles_x, int tiles, int MC) {
    constexpr int V = Pack<T>::V;
    extern __shared__ __align__(16) unsigned char smem[];
    T* zt = reinterpret_cast<T*>(smem);          // [Dx][MC] a chunk of Z, transposed
    T* zn = zt + (size_t)Dx * MC;                // [MC]     its squared norms

    const rbf::Tile tl = rbf::tile_of(N, M, TN, tiles_x, tiles);
    const T* z = Z + (int64_t)tl.d * M * Dx;
    const T* x = (tl.zpart ? z : X + (int64_t)tl.d * N * Dx)
        + (int64_t)tl.row0 * Dx;
    T* out = (tl.zpart ? Kzz : Kxz) + ((int64_t)tl.d * tl.rows + tl.row0) * M;
    const T s = ks[tl.d];

    for (int c0 = 0; c0 < M; c0 += MC) {
        const int mc = min(MC, M - c0);
        const int G = (mc + V - 1) / V;          // groups per row in this chunk
        stage_z(z, c0, mc, G * V, Dx, MC, zt, zn);
        __syncthreads();
        for (int gi = threadIdx.x; gi < tl.nrows * G; gi += blockDim.x) {
            const int i = gi / G;
            const int j0 = (gi - i * G) * V;
            const T* xr = x + (int64_t)i * Dx;
            T xn = T(0), cross[V];
#pragma unroll
            for (int v = 0; v < V; ++v) cross[v] = T(0);
            for (int k = 0; k < Dx; ++k) {
                const T xv = __ldg(xr + k);          // one row per ~G threads: broadcast
                const Pack<T> zv = *reinterpret_cast<const Pack<T>*>(zt + k * MC + j0);
                xn += xv * xv;
#pragma unroll
                for (int v = 0; v < V; ++v) cross[v] += xv * zv.v[v];
            }
            const Pack<T> znv = *reinterpret_cast<const Pack<T>*>(zn + j0);
            Pack<T> r;
#pragma unroll
            for (int v = 0; v < V; ++v) r.v[v] = s * rbf::rbf_e(xn, znv.v[v], cross[v]);
            T* dst = out + (int64_t)i * M + c0 + j0;
            if (j0 + V <= mc && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
                *reinterpret_cast<Pack<T>*>(dst) = r;
            } else {
#pragma unroll
                for (int v = 0; v < V; ++v)
                    if (j0 + v < mc) dst[v] = r.v[v];
            }
        }
        __syncthreads();
    }
}

template <typename T>
int launch(const T* X, const T* Z, const T* ks, T* Kxz, T* Kzz, int Dy, int N,
           int M, int Dx, void* stream) {
    constexpr int V = Pack<T>::V;
    if (Dy <= 0 || N < 0 || M <= 0 || Dx < 0) return (int)cudaErrorInvalidValue;
    // the widest chunk of Z (a multiple of V columns) whose values and norms
    // fit the budget, and no wider than Z
    int MC = rbf::SMEM_BYTES / ((Dx + 1) * (int)sizeof(T)) / V * V;
    if (MC < V) return (int)cudaErrorInvalidValue;
    MC = std::min(MC, rbf::round_up(M, V));
    const int TN = std::max(1, rbf::THREADS / (MC / V));
    const int64_t tiles_x = ((int64_t)N + TN - 1) / TN;
    const int64_t tiles = tiles_x + (Kzz ? ((int64_t)M + TN - 1) / TN : 0);
    const int64_t blocks = (int64_t)Dy * tiles;
    if (blocks <= 0 || blocks > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = (size_t)(Dx + 1) * MC * sizeof(T);
    rbf_gram_kernel<T><<<(unsigned)blocks, rbf::THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        X, Z, ks, Kxz, Kzz, N, M, Dx, TN, (int)tiles_x, (int)tiles, MC);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K_xz into Kxz and, unless Kzz is null, K_zz into Kzz.  A grid of more than
// 2^31 - 1 blocks (Dy x row tiles), or a Dx too wide for V columns of Z in
// the shared-memory budget (Dx > 3071), is refused through the return value.
int rbf_gram_f32(const float* X, const float* Z, const float* ks, float* Kxz,
                 float* Kzz, int Dy, int N, int M, int Dx, void* stream) {
    return launch<float>(X, Z, ks, Kxz, Kzz, Dy, N, M, Dx, stream);
}

int rbf_gram_f64(const double* X, const double* Z, const double* ks,
                 double* Kxz, double* Kzz, int Dy, int N, int M, int Dx,
                 void* stream) {
    return launch<double>(X, Z, ks, Kxz, Kzz, Dy, N, M, Dx, stream);
}

}  // extern "C"
