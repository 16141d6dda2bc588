// Pieces shared by the ARD-RBF Gram forward (rbf_gram.cu) and its VJP
// (rbf_gram_bwd.cu): the 16-byte pack, the reference's arithmetic and the
// flat grid's tile indexing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace rbf {

constexpr int THREADS = 256;               // threads per block, both kernels
constexpr int SMEM_BYTES = 48 * 1024;      // shared-memory budget per block: the
                                           // limit of a launch without opt-in

// V values of T in one 16-byte access: 4 floats or 2 doubles.
template <typename T>
struct alignas(16) Pack {
    static constexpr int V = 16 / static_cast<int>(sizeof(T));
    T v[V];
};

inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }

// exp(-0.5 * max(|x|^2 + |z|^2 - 2 x.z, 0)): the expansion of the reference
// (`_gram_kernel`, `rbf_gram_reference`), not the direct difference.
template <typename T>
__device__ __forceinline__ T rbf_e(T xn, T zn, T cross) {
    T d2 = xn + zn - T(2) * cross;
    d2 = d2 > T(0) ? d2 : T(0);
    return dev_exp(T(-0.5) * d2);
}

// The rows a block owns.  The grid is flat: block b serves output slice
// d = b / tiles and row tile t = b % tiles of the row set [X rows; Z rows],
// whose first tiles_x tiles are rows of X (K_xz) and the rest rows of Z
// (K_zz).  So neither N nor Dy meets a grid dimension's 65535 cap.
struct Tile {
    int d;          // output slice
    bool zpart;     // rows of Z (K_zz) rather than of X (K_xz)
    int row0;       // first row within its part
    int nrows;      // rows in this tile (TN, or fewer at the ragged end)
    int rows;       // rows of its part: N or M
};

__device__ __forceinline__ Tile tile_of(int N, int M, int TN, int tiles_x,
                                        int tiles) {
    Tile t;
    t.d = blockIdx.x / tiles;
    const int i = blockIdx.x - t.d * tiles;
    t.zpart = i >= tiles_x;
    t.row0 = (t.zpart ? i - tiles_x : i) * TN;
    t.rows = t.zpart ? M : N;
    t.nrows = min(TN, t.rows - t.row0);
    return t;
}

}  // namespace rbf
