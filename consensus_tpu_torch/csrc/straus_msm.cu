// Shared-doubling Straus multi-scalar multiplication for the randomized
// Ed25519 batch verifier, for Hopper (sm_90a).
//
// Replaces the TPU kernel consensus_tpu/ops/pallas_scan.py::straus_msm (body
// _msm_kernel): the one point
//
//     sum_i [zk_i](-A_i) + sum_i [z_i](-R_i)
//
// over every lane, with one doubling chain per block of lanes instead of one
// per signature.  Per lane it builds the 9-entry tables j*(-A) and j*(-R) by
// 7 sequential adds from the base point (as _msm_kernel does), then walks the
// 64 signed 4-bit windows MSB first: the first 64 - n_low windows look up only
// the A table, the last n_low add the R table's entry too (z < 2^128, so its
// high windows are all zero).  A lane whose digits are all 8 (d = 0)
// contributes the identity whatever its coordinates hold: that is how the
// engine masks padded and undecodable lanes.
//
// The result is the same group element as the plain torch version
// (consensus_tpu_torch/ops/scan_kernels.py::straus_msm_reference) but another
// projective representative: the tables are built by adds rather than by
// doublings, and the lanes are summed in this kernel's block tree rather than
// in one tree over the whole batch.  Compare it in affine coordinates.
//
// What bounds it on this card: integer multiplies.  Per lane it does about
// 111 point adds (14 for the tables, n_low = 33 combining A and R, one tree
// add per window), about 1,000 field multiplications of 25 64x64->128
// products each; per block 64 x 4 doubles and 64 adds on the accumulator.  Its
// bytes (eight (32, batch) f32 coordinates and 97 digit rows) are a tenth of
// that time at the card's memory rate.
//
// What the design does about it, first version: one thread per lane and one
// block of THREADS = 128 lanes per tile.  Each window,
// every thread writes its contribution to shared memory, the block sums them
// by a halving tree (thread t adds slot t + s into slot t), and thread 0
// doubles the block's accumulator 4 times and adds the block sum.  Thread 0's
// doublings come before its own lookup, so they overlap the other warps'
// lookups.  A second kernel joins the blocks' partial sums (radix-2^51 limbs
// in a scratch buffer the wrapper allocates) by the same tree in one block and
// writes the point as canonical 8-bit limbs.  At 8,192 lanes that is 64 blocks
// on 132 SMs, and the tree leaves half the threads idle at each level:
// Pippenger buckets, warp-shuffle reductions and more lanes per SM are later
// work.
//
// Layout at the C boundary (batch trailing, limbs leading, as in the JAX
// package): eight (32, batch) float32 coordinates -A (X, Y, Z, T) then -R,
// weakly reduced; (64, batch) int32 zk digits and (n_low, batch) int32 z
// digits, stored as d + 8, MSB window first; a (20, ceil(batch / THREADS))
// int64 scratch; four (32, 1) float32 outputs.

#include "ed25519_field.cuh"

namespace {

struct msm_inputs {
  const float* a[4];   // -A: X, Y, Z, T, each (32, batch)
  const float* r[4];   // -R
  const int32_t* zk;   // (64, batch)
  const int32_t* z;    // (n_low, batch)
  long long batch;
  int n_low;
};

// A point's 20 limbs to and from column `col` of a (20, stride) u64 array:
// the block's shared-memory slots and the partial sums both use it, so
// neighbouring threads touch neighbouring words.
HD void fe_put(u64* base, long long stride, long long col, int k, const fe& f) {
  for (int i = 0; i < 5; ++i) base[(5 * k + i) * stride + col] = f.v[i];
}

HD fe fe_get(const u64* base, long long stride, long long col, int k) {
  fe f;
  for (int i = 0; i < 5; ++i) f.v[i] = base[(5 * k + i) * stride + col];
  return f;
}

HD void ge_put(u64* base, long long stride, long long col, const ge& p) {
  fe_put(base, stride, col, 0, p.X);
  fe_put(base, stride, col, 1, p.Y);
  fe_put(base, stride, col, 2, p.Z);
  fe_put(base, stride, col, 3, p.T);
}

HD ge ge_get(const u64* base, long long stride, long long col) {
  return ge{fe_get(base, stride, col, 0), fe_get(base, stride, col, 1),
            fe_get(base, stride, col, 2), fe_get(base, stride, col, 3)};
}

// j*p for j = 0..8: the identity, p, then 7 sequential adds of p.
HD void table9(const ge& p, ge* tab) {
  tab[0] = ge_identity();
  tab[1] = p;
  for (int j = 2; j < TABLE; ++j) tab[j] = ge_add(tab[j - 1], p);
}

// Both tables of lane `lane`.
HD void msm_tables(const msm_inputs& in, long long lane, ge* a_tab, ge* r_tab) {
  const long long n = in.batch;
  table9(ge{fe_load(in.a[0] + lane, n), fe_load(in.a[1] + lane, n),
            fe_load(in.a[2] + lane, n), fe_load(in.a[3] + lane, n)}, a_tab);
  table9(ge{fe_load(in.r[0] + lane, n), fe_load(in.r[1] + lane, n),
            fe_load(in.r[2] + lane, n), fe_load(in.r[3] + lane, n)}, r_tab);
}

// table[|d|] with the sign of d, for a digit stored as d + 8.  A code outside
// [0, 16] is not a valid input; the clamp only keeps such a lane from reading
// outside the table.
HD ge lookup(const ge* tab, int code) {
  const int d = code - 8;
  int idx = d < 0 ? -d : d;
  idx = idx > TABLE - 1 ? TABLE - 1 : idx;
  ge q = tab[idx];
  if (d < 0) {
    q.X = fe_neg(q.X);
    q.T = fe_neg(q.T);
  }
  return q;
}

// Lane `lane`'s contribution to window w: its A entry, plus its R entry in
// the last n_low windows.
HD ge msm_contribution(const msm_inputs& in, const ge* a_tab, const ge* r_tab,
                       int w, long long lane) {
  ge c = lookup(a_tab, in.zk[w * in.batch + lane]);
  const int n_high = WINDOWS - in.n_low;
  if (w >= n_high) c = ge_add(c, lookup(r_tab, in.z[(w - n_high) * in.batch + lane]));
  return c;
}

// 16 * acc: 3 doubles without T, then 1 that materializes T for the add.
HD ge ge_quad_double(ge acc) {
  acc = ge_dbl(acc, false);
  acc = ge_dbl(acc, false);
  acc = ge_dbl(acc, false);
  return ge_dbl(acc, true);
}

}  // namespace

#ifdef __CUDACC__

constexpr int THREADS = 128;  // lanes per block; a power of two

// Halving tree over the block's THREADS slots of `sh`; slot 0 ends with the
// sum.  Every thread of the block must call it.
__device__ __forceinline__ void block_tree(u64* sh, int t) {
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) ge_put(sh, THREADS, t, ge_add(ge_get(sh, THREADS, t), ge_get(sh, THREADS, t + s)));
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
straus_msm_partials_kernel(msm_inputs in, u64* __restrict__ partials) {
  __shared__ u64 sh[20 * THREADS];  // (20, THREADS)
  const int t = threadIdx.x;
  const long long lane = (long long)blockIdx.x * THREADS + t;
  const bool live = lane < in.batch;  // the ragged edge contributes the identity
  ge a_tab[TABLE], r_tab[TABLE];
  if (live) msm_tables(in, lane, a_tab, r_tab);
  ge acc = ge_identity();  // thread 0's
  for (int w = 0; w < WINDOWS; ++w) {
    if (t == 0) acc = ge_quad_double(acc);
    ge_put(sh, THREADS, t, live ? msm_contribution(in, a_tab, r_tab, w, lane) : ge_identity());
    __syncthreads();
    block_tree(sh, t);
    if (t == 0) acc = ge_add(acc, ge_get(sh, THREADS, 0));
    __syncthreads();  // slot 0 is read before the next window overwrites it
  }
  if (t == 0) ge_put(partials, gridDim.x, blockIdx.x, acc);
}

__global__ void __launch_bounds__(THREADS)
straus_msm_join_kernel(const u64* __restrict__ partials, int nblocks, float* __restrict__ ox,
                       float* __restrict__ oy, float* __restrict__ oz, float* __restrict__ ot) {
  __shared__ u64 sh[20 * THREADS];  // (20, THREADS)
  const int t = threadIdx.x;
  ge s = ge_identity();
  for (int b = t; b < nblocks; b += THREADS) s = ge_add(s, ge_get(partials, nblocks, b));
  ge_put(sh, THREADS, t, s);
  __syncthreads();
  block_tree(sh, t);
  if (t == 0) {
    const ge r = ge_get(sh, THREADS, 0);
    fe_store(ox, 1, r.X);
    fe_store(oy, 1, r.Y);
    fe_store(oz, 1, r.Z);
    fe_store(ot, 1, r.T);
  }
}

// Launches both kernels on `stream` of CUDA device `device` and returns the
// first nonzero cudaGetLastError() (0 on success).  `partials` holds
// 20 * ceil(batch / THREADS) int64.
extern "C" int straus_msm_launch(const void* ax, const void* ay, const void* az,
                                 const void* at, const void* rx, const void* ry,
                                 const void* rz, const void* rt, const void* zk,
                                 const void* z, void* partials, void* ox, void* oy,
                                 void* oz, void* ot, int batch, int n_low, int device,
                                 void* stream) {
  if (batch < 0 || n_low < 0 || n_low > WINDOWS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const msm_inputs in = {
      {(const float*)ax, (const float*)ay, (const float*)az, (const float*)at},
      {(const float*)rx, (const float*)ry, (const float*)rz, (const float*)rt},
      (const int32_t*)zk, (const int32_t*)z, batch, n_low};
  const int nblocks = (batch + THREADS - 1) / THREADS;
  if (nblocks > 0) {
    straus_msm_partials_kernel<<<nblocks, THREADS, 0, (cudaStream_t)stream>>>(
        in, (u64*)partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  straus_msm_join_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const u64*)partials, nblocks, (float*)ox, (float*)oy, (float*)oz, (float*)ot);
  return (int)cudaGetLastError();
}

extern "C" const char* straus_msm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
