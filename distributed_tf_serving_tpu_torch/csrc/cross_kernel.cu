// Hand-written Hopper (sm_90a) kernels for the DCN-v2 serving step.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * dts_fused_serve   <- distributed_tf_serving_tpu/ops/cross_kernel.py
//                          build_fused_serve (inner `kernel`): embedding
//                          gather + L cross layers + ReLU MLP + f32 head +
//                          sigmoid, per candidate row. Float weights
//                          (fused_serve_{bf16,f32}_kernel) and the int8
//                          {qw, qscale} weights of ops/quantize.py
//                          (fused_serve_int8_{bf16,f32}_kernel).
//   * dts_cross_stack   <- distributed_tf_serving_tpu/ops/cross_kernel.py
//                          fused_cross_apply / _cross_kernel: the DCN-v2
//                          cross stack x = x0 * (x @ W_l + b_l) + x alone.
//
// What bounds them on an H100 SXM (data-sheet peaks: 3.35 TB/s HBM, 989
// TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 without them). At the serving
// width (43 fields x 16 = 688, L = 3, MLP 256/128/64) the fused serve step
// does ~3.3 MFLOP per row. At 2048 rows that is ~6.7 GFLOP against ~9 MB
// (gathered table rows ~5.6 MB, bf16 weights ~3.3 MB): operation-bound. At
// 256 rows it is ~0.84 GFLOP against ~4 MB, so the weight bytes set it.
// The int8 variant streams 1 byte per weight plus f32 scales (~1.64 MB at
// that width against ~3.3 MB of bf16), the same arithmetic otherwise.
//
// What bounds the bf16 fused serve kernel in practice is neither peak.
// A 16-row tile re-reads every weight from L2: 3.4 MB per tile, 435 MB at
// 2048 rows, which in the ~0.075 ms it takes is ~5.8 TB/s of L2 reads, so
// there the L2 stream is the likely limit and more rows per block (each
// weight fragment feeding several mmas) the lever. At the small buckets
// few tiles exist,
// and a tile's time is the serial work of one warp: per 32-deep k chunk
// two B loads from L2 and dependent mma.sync, in groups of 4 chunks whose
// loads are issued together (one L2 round trip per group). The cluster
// split below divides that work over up to 8 SMs per tile.
//
// Design (what the TPU kernel did, and what changes here):
//   * A tile of ROWS rows goes through ALL layers in one launch: a layer
//     needs the whole previous row. The tile's x0 (f32) and the carried
//     activation x (compute dtype, double buffered) live in shared memory.
//   * The TPU kernel kept every weight matrix resident in VMEM; a 688x688
//     bf16 matrix alone is 0.95 MB against 227 KB of shared memory per
//     block, so here weights stream from L2 (the 3.3 MB of bf16 weights fit
//     the 50 MB L2 many times over).
//   * Thread-block cluster (bf16 fused serve): a tile is served by a
//     cluster of C in {1, 2, 4, 8} blocks on neighbouring SMs. Rank r owns
//     the 8-column output tiles [r*nt/C, (r+1)*nt/C) of every layer (nt =
//     pad_n(N)/8), so it streams 1/C of the weights and its warps' chains
//     shrink by about C. C is the largest with all tiles' clusters resident
//     at once (the host's rule, ops/cross_kernel.py serve_cluster, from
//     cudaOccupancyMaxActiveClusters; one 512-thread block per SM). A cluster must
//     fit one GPC, so an H100 SXM holds 15 clusters of 8, 30 of 4 and 66 of
//     2 (not 132 / C): 256 rows (16 tiles) take C = 4, 512 and 1024 take
//     C = 2 and 2048 keeps the one-block kernel; a second wave would cost
//     more than the smaller C. Every block gathers the whole x0 tile itself
//     (~44 KB of table rows, cheap next to the weights), so layer 0 of the
//     cross stack and of the MLP need no exchange.
//   * Exchange, one cluster barrier per layer: each rank writes its own
//     columns of `nxt` locally, cluster.sync(), then copies every peer's
//     columns of `nxt` from that peer's shared memory into its own (16-byte
//     DSMEM loads; an 8-column tile of one row is exactly 16 bytes), then
//     __syncthreads(). One barrier suffices because of the double buffers
//     and because a rank pulls from a peer only the columns that peer owns:
//     a peer writes its owned columns of buffer X again two layers later
//     (X is `nxt` at layers l and l+2), after the barrier of layer l+1,
//     which no rank passes before every rank has finished the pull of
//     layer l; and the columns a rank writes into its own X while pulling
//     are ones no peer ever reads from it. The last layer of the MLP and of
//     the cross stack is not exchanged: the head needs only own columns.
//   * Partial head: each rank sums wo over its own columns of the last
//     cross output and of the last MLP output; after a cluster barrier rank
//     0 adds the C partials (rank order), adds bo and writes the scores; a
//     last barrier keeps every block resident until rank 0 has read its
//     shared memory. C = 1 takes none of the cluster steps.
//   * bf16 (the serving dtype) runs on the tensor cores: mma.sync m16n8k16
//     with f32 accumulation. The 16 rows are the mma's M; activations sit
//     row-major in shared memory (row stride padded so the fragment loads
//     are bank-conflict free) and weights are pre-laid out by the host as
//     W^T [N8][K32] (N padded to 8, K to 32, zero-filled), so each lane
//     reads 16 contiguous bytes of A and of B per 32-deep k chunk. Within a
//     chunk the k order is permuted identically in A and B, which leaves
//     the sum unchanged. Each warp owns two 8-column output tiles at a time
//     and issues the B loads of four chunks before their mmas. A rank's
//     ~22 cross-layer tiles at C = 4 are 11 pairs for 16 warps; splitting
//     each pair's k chunks over the idle warps (f32 partials added in
//     shared memory) measured no faster at any C the rule picks, so it is
//     not done.
//   * bf16 cross stack (cross_stack_bf16_kernel<R>): the same cluster
//     split, and R = 16 or 32 rows per tile. At R = 32 each warp keeps two
//     m16 A fragments and feeds every B fragment it loads from L2 to both,
//     which halves the L2 weight stream per row (at 2048 rows and R = 16,
//     128 tiles each re-read 2.9 MB of W^T: ~372 MB). Every rank loads the
//     whole x0 tile and stores only its own columns of x_L; with no head,
//     a closing cluster barrier keeps each block resident until its peers'
//     last DSMEM pull is done (see the kernel). R and C come from the host
//     (ops/cross_kernel.py cross_plan, fed by
//     dts_cross_max_active_clusters); R = 32 is planned only where its
//     shared memory fits. Each element's k order is the same at every
//     (R, C), so every plan gives the same bits. The fused serve kernels
//     keep R = 16.
//   * f32 runs on plain FFMA (tensor cores have no f32, and TF32 would
//     break the 1e-5 parity). Its activations are stored transposed
//     ([column][row], ROWS contiguous): one k step reads the ROWS values of
//     column k as shared-memory broadcasts, and each thread owns two
//     adjacent output columns for all rows.
//   * The update x0 * (x @ W + b) + x is f32 with explicit _rn operations
//     (no FMA contraction), rounded to the compute dtype once per layer,
//     matching the JAX kernel's rounding points.
//   * The gather reads each 64-byte table row as four float4 loads (the TPU
//     issued one DMA per (row, field) pair). Ids arrive host-folded into
//     [0, V), so they are not range-checked here. Rows past n are zero-
//     filled (0 * finite weights stays 0) and never stored.
//   * int8 weights (per-output-channel scale s): the bf16 path reads 8
//     int8 values per lane and 32-deep chunk (one 8-byte load in place of
//     16 bytes of bf16), widens them to bf16 in registers (exact, |q| <=
//     127) in the same k order as A, and runs the same mma. The widening
//     uses byte permutes and one f32 subtract per value, not the
//     conversion unit (I2F/F2F cost ~15 % of the kernel's time on an
//     H100), and a warp keeps 8 chunks of B loads in flight (the registers
//     4 chunks of bf16 take). The f32 path widens each int8 to f32. The
//     scale folds into the f32 result in the JAX kernel's order: xw =
//     acc * s, then + b (cross and MLP alike).
//     The head arrives dequantized to f32 by the host. Padded output
//     columns are never stored (the j < N guard), so their scale is
//     irrelevant.
//   * Padded shared-memory columns are zeroed before use: stale values
//     there would meet the zero-padded weights as garbage * 0 (NaN * 0 is
//     NaN), the same reason the TPU kernel zeroes its scratch.
//
// Plain C interface (loaded with ctypes): pointers and the stream are raw
// addresses; every entry returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int ROWS = 16;             // candidate rows per block (= mma M)
constexpr int MAX_MLP = 4;           // MLP layers the fused serve kernel takes
constexpr int F32_MAX_THREADS = 512;
constexpr int BF16_THREADS = 512;    // 16 warps
constexpr int KCHUNK = 32;           // k depth per pair of m16n8k16 mmas
constexpr int KGROUP = 4;            // k chunks of bf16 B loads issued together

__host__ __device__ inline int pad_k(int k) { return (k + KCHUNK - 1) / KCHUNK * KCHUNK; }
__host__ __device__ inline int pad_n(int n) { return (n + 7) / 8 * 8; }
// Rank r of a cluster of c owns the 8-column tiles [tile_begin(nt, c, r),
// tile_begin(nt, c, r + 1)) of a layer with nt tiles; tile_owner inverts it
// (the largest r whose range starts at or before t).
__host__ __device__ inline int tile_begin(int nt, int c, int r) { return r * nt / c; }
__host__ __device__ inline int tile_owner(int t, int nt, int c) { return ((t + 1) * c - 1) / nt; }
// Row stride (elements) of a row-major bf16 activation tile read as mma A:
// a stride of 64 mod 128 bytes keeps each 8-lane phase of the 16-byte
// fragment loads on distinct banks.
__host__ __device__ inline int lda_of(int k) {
  const int kp = pad_k(k);
  return kp % 64 == 0 ? kp + 32 : kp;
}

__device__ __forceinline__ float f32_of(float v) { return v; }
__device__ __forceinline__ float f32_of(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float f32_of(int8_t v) { return static_cast<float>(v); }

// The f32 matmul result of a weight column j: scaled by s[j] for int8
// weights (per-output-channel scale), as it is for float weights.
template <typename T>
__device__ __forceinline__ float scaled(float acc, const float* s, int j) {
  if constexpr (std::is_same<T, int8_t>::value) {
    return __fmul_rn(acc, s[j]);
  } else {
    return acc;
  }
}

// out[r] = sum_{j0 <= j < K} v[r][j] * w[j] in f32, one warp per row;
// element (r, j) of the tile lives at v[r * rs + j * cs].
template <typename T>
__device__ void rowdot(const T* v, int rs, int cs, int K, const float* __restrict__ w,
                       float* out, int j0 = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = warp; r < ROWS; r += nw) {
    float s = 0.f;
    for (int j = j0 + lane; j < K; j += 32) s = fmaf(f32_of(v[r * rs + j * cs]), w[j], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[r] = s;
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// x0[r, f*D + e] = table[ids[r, f], e] * wts[r, f] (f32) for the block's
// rows; emit(r, j, value) stores one element. Four float4 loads per 64-byte
// table row when D % 4 == 0.
template <typename Emit>
__device__ void gather(const int* ids, const void* wts, int wts_bf16, const float* table,
                       int n, int F, int D, int row0, Emit emit) {
  const int q4 = (D & 3) == 0 ? D >> 2 : 0;  // float4 chunks per table row
  const int per = q4 ? q4 : D;
  const int items = ROWS * F * per;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int q = i % per;
    const int rf = i / per;
    const int f = rf % F;
    const int r = rf / F;
    const int row = row0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    float w = 0.f;
    if (row < n) {
      const size_t e = (size_t)row * F + f;
      const int id = ids[e];
      w = wts_bf16 ? __bfloat162float(static_cast<const bf16*>(wts)[e])
                   : static_cast<const float*>(wts)[e];
      const float* src = table + (size_t)id * D;
      if (q4) {
        const float4 t = reinterpret_cast<const float4*>(src)[q];
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
      } else {
        v[0] = src[q];
      }
    }
    const int j = f * D + (q4 ? 4 * q : q);
    const int cnt = q4 ? 4 : 1;
    for (int c = 0; c < cnt; ++c) emit(r, j + c, __fmul_rn(v[c], w));
  }
}

// ========================================================= f32: FFMA path

// acc[r] = sum_k in[r][k] * W[k][j] for every output column j of an
// [ROWS, K] x [K, M] product; epi(j, acc) consumes each finished column.
// `inT` is the transposed tile [K][ROWS] in shared memory; W is [K, M]
// row-major in global memory (read through L2), f32 or int8 (widened to
// f32 exactly; the caller's epilogue applies the scale).
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const int8_t* p, float& a, float& b) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  a = static_cast<float>(static_cast<int8_t>(v.x));
  b = static_cast<float>(static_cast<int8_t>(v.y));
}

template <typename T, typename Epi>
__device__ __forceinline__ void ffma_layer(const float* inT, int K, const T* __restrict__ W,
                                           int M, Epi epi) {
  const int pairs = (M + 1) >> 1;
  const bool vec = (M & 1) == 0;
  for (int cg = threadIdx.x; cg < pairs; cg += blockDim.x) {
    const int j0 = 2 * cg;
    const bool has1 = j0 + 1 < M;
    float a0[ROWS], a1[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      a0[r] = 0.f;
      a1[r] = 0.f;
    }
    const T* wp = W + j0;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      float w0, w1;
      if (vec) {
        load_pair(wp + (size_t)k * M, w0, w1);
      } else {
        w0 = f32_of(wp[(size_t)k * M]);
        w1 = has1 ? f32_of(wp[(size_t)k * M + 1]) : 0.f;
      }
      const float4* col = reinterpret_cast<const float4*>(inT + (size_t)k * ROWS);
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 x = col[q];
        a0[4 * q] = fmaf(x.x, w0, a0[4 * q]);
        a0[4 * q + 1] = fmaf(x.y, w0, a0[4 * q + 1]);
        a0[4 * q + 2] = fmaf(x.z, w0, a0[4 * q + 2]);
        a0[4 * q + 3] = fmaf(x.w, w0, a0[4 * q + 3]);
        a1[4 * q] = fmaf(x.x, w1, a1[4 * q]);
        a1[4 * q + 1] = fmaf(x.y, w1, a1[4 * q + 1]);
        a1[4 * q + 2] = fmaf(x.z, w1, a1[4 * q + 2]);
        a1[4 * q + 3] = fmaf(x.w, w1, a1[4 * q + 3]);
      }
    }
    epi(j0, a0);
    if (has1) epi(j0 + 1, a1);
  }
}

// L cross layers over transposed f32 tiles; returns the buffer holding x_L.
// sc: [L, d] per-channel scales of int8 weights (unused for float).
template <typename T>
__device__ const float* ffma_cross(const float* x0T, float* xb0, float* xb1, int d,
                                   const T* __restrict__ Wc, const float* __restrict__ bc,
                                   const float* __restrict__ sc, int L) {
  float* cur = xb0;
  float* nxt = xb1;
  for (int l = 0; l < L; ++l) {
    const float* b = bc + (size_t)l * d;
    const float* s = sc ? sc + (size_t)l * d : nullptr;
    ffma_layer(cur, d, Wc + (size_t)l * d * d, d, [&](int j, const float(&acc)[ROWS]) {
      const float bj = b[j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int o = j * ROWS + r;
        const float xw = __fadd_rn(scaled<T>(acc[r], s, j), bj);
        nxt[o] = __fadd_rn(__fmul_rn(x0T[o], xw), cur[o]);
      }
    });
    __syncthreads();  // every thread read all of `cur`; the next layer overwrites it
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// ====================================================== bf16: mma.sync path

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four int8 values (the bytes of v, lowest first) as two packed bf16x2
// registers. Each byte b becomes the f32 with bits 0x4B0000(b ^ 0x80), which
// is 2^23 + 128 + b; subtracting 2^23 + 128 leaves b exactly. |b| <= 127 is
// exact in bf16, so its bf16 bits are the f32's high half.
__device__ __forceinline__ float i8_byte_to_f32(uint32_t u, uint32_t sel) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, sel)), 8388736.f);
}
__device__ __forceinline__ uint32_t bf16x2_of(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  lo = bf16x2_of(i8_byte_to_f32(u, 0x7650), i8_byte_to_f32(u, 0x7651));
  hi = bf16x2_of(i8_byte_to_f32(u, 0x7652), i8_byte_to_f32(u, 0x7653));
}

// One lane's B fragment of a 32-deep chunk: the 8 consecutive k values
// k0 .. k0 + 7 of one output column, loaded raw, then expanded to four
// packed bf16x2 registers (k pairs 0-1, 2-3, 4-5, 6-7) in the same k
// order as A's fragment.
template <typename T>
struct BFrag;
template <>
struct BFrag<bf16> {
  typedef uint4 Raw;  // 16 bytes
  static constexpr int kGroup = KGROUP;
  static __device__ __forceinline__ Raw load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ uint4 expand(Raw r) { return r; }
};
template <>
struct BFrag<int8_t> {
  typedef uint2 Raw;  // 8 bytes: rows of pad_k(K) bytes keep it aligned
  static constexpr int kGroup = 2 * KGROUP;  // half the bytes: twice the chunks in flight
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ uint4 expand(Raw r) {
    uint4 o;
    i8x4_to_bf16x4(r.x, o.x, o.y);
    i8x4_to_bf16x4(r.y, o.z, o.w);
    return o;
  }
};

// C[R, N] = A[R, K] @ W[K, N] on the tensor cores, for the 8-column output
// tiles [t0, t1) only; R = 16 or 32 rows, H = R / 16 m16 row halves. A is
// row-major in shared memory (stride lda, columns [K, pad_k(K)) zero); WT
// is W^T laid out [pad_n(N)][pad_k(K)] in global memory, zero-padded, bf16
// or int8. epi(r, j, value) gets every element of those tiles with j < N,
// in f32 (unscaled). Every B fragment loaded from L2 feeds the mmas of all
// H halves, so at R = 32 a row costs half the weight stream it costs at 16.
// Each element's k order is the same at every R and every tile range.
template <int R, typename T, typename Epi>
__device__ __forceinline__ void mma_layer(const bf16* A, int lda, int K,
                                          const T* __restrict__ WT, int N, int t0, int t1,
                                          Epi epi) {
  constexpr int H = R / 16;
  static_assert(R == 16 * H && (H == 1 || H == 2), "R is 16 or 32 rows");
  const int kp = pad_k(K);
  const int nch = kp / KCHUNK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* a_lo = A + g * lda + 8 * t;
  const bf16* a_hi = A + (g + 8) * lda + 8 * t;
  typedef typename BFrag<T>::Raw Raw;
  const Raw zero = {};
  for (int tile = t0 + 2 * warp; tile < t1; tile += 2 * nw) {
    const bool two = tile + 1 < t1;
    float c[2][H][4] = {};
    const T* b0p = WT + (size_t)(tile * 8 + g) * kp + 8 * t;
    const T* b1p = b0p + (size_t)8 * kp;
    constexpr int G = BFrag<T>::kGroup;
    for (int c0 = 0; c0 < nch; c0 += G) {
      Raw bq[G][2];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const bool ok = c0 + u < nch;
        const int off = (c0 + u) * KCHUNK;
        bq[u][0] = ok ? BFrag<T>::load(b0p + off) : zero;
        bq[u][1] = ok && two ? BFrag<T>::load(b1p + off) : zero;
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (c0 + u < nch) {
          const int off = (c0 + u) * KCHUNK;
          // Lane (g, t) holds k = off + 8t .. off + 8t + 7 of rows g and
          // g + 8 of each half: pairs 0-1 feed the first mma, 2-3 the second.
          uint4 lo[H], hi[H];
#pragma unroll
          for (int h = 0; h < H; ++h) {
            lo[h] = *reinterpret_cast<const uint4*>(a_lo + 16 * h * lda + off);
            hi[h] = *reinterpret_cast<const uint4*>(a_hi + 16 * h * lda + off);
          }
          const uint4 b0 = BFrag<T>::expand(bq[u][0]);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            mma_bf16(c[0][h], lo[h].x, hi[h].x, lo[h].y, hi[h].y, b0.x, b0.y);
            mma_bf16(c[0][h], lo[h].z, hi[h].z, lo[h].w, hi[h].w, b0.z, b0.w);
          }
          if (two) {
            const uint4 b1 = BFrag<T>::expand(bq[u][1]);
#pragma unroll
            for (int h = 0; h < H; ++h) {
              mma_bf16(c[1][h], lo[h].x, hi[h].x, lo[h].y, hi[h].y, b1.x, b1.y);
              mma_bf16(c[1][h], lo[h].z, hi[h].z, lo[h].w, hi[h].w, b1.z, b1.w);
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s == 0 || two) {
        const int j = (tile + s) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int r = 16 * h + g;
          if (j < N) {
            epi(r, j, c[s][h][0]);
            epi(r + 8, j, c[s][h][2]);
          }
          if (j + 1 < N) {
            epi(r, j + 1, c[s][h][1]);
            epi(r + 8, j + 1, c[s][h][3]);
          }
        }
      }
    }
  }
}

// Zero a bf16 region of `count` elements (count * 2 a multiple of 16).
__device__ void zero_bf16(bf16* p, int count) {
  uint4* q = reinterpret_cast<uint4*>(p);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < count / 8; i += blockDim.x) q[i] = z;
}

// After cluster.sync(): copy every peer's columns of the row-major R-row
// tile `buf` (stride ld, nt 8-column tiles) from the peer that owns them
// into this block's copy, one 16-byte DSMEM load per row and tile. Only the
// owner's columns are read from a peer (the one-barrier argument in the
// header depends on it).
template <int R>
__device__ void pull_peers(bf16* buf, int ld, int nt, int c, int me) {
  cg::cluster_group cluster = cg::this_cluster();
  const int t0 = tile_begin(nt, c, me), own = tile_begin(nt, c, me + 1) - t0;
  const int other = nt - own;
  for (int i = threadIdx.x; i < R * other; i += blockDim.x) {
    int t = i % other;
    if (t >= t0) t += own;  // skip this block's own tiles
    bf16* p = buf + (i / other) * ld + 8 * t;
    *reinterpret_cast<uint4*>(p) =
        *reinterpret_cast<const uint4*>(cluster.map_shared_rank(p, tile_owner(t, nt, c)));
  }
}

// L cross layers over row-major bf16 R-row tiles (x0 f32 row-major, stride
// d); returns the buffer holding x_L. sc: [L, d] scales of int8 weights.
// Rank `me` of a cluster of c blocks computes its own columns of every
// layer and pulls the others' after each layer but the last (whose own
// columns are all the caller reads). No barrier follows the last pull: a
// caller with c > 1 and L >= 2 must cluster.sync() before its block exits.
template <int R, typename T>
__device__ const bf16* mma_cross(const float* x0, bf16* xb0, bf16* xb1, int d, int ldx,
                                 const T* __restrict__ WcT, const float* __restrict__ bc,
                                 const float* __restrict__ sc, int L, int c, int me) {
  bf16* cur = xb0;
  bf16* nxt = xb1;
  const size_t wstride = (size_t)pad_n(d) * pad_k(d);
  const int nt = pad_n(d) / 8;
  const int t0 = tile_begin(nt, c, me), t1 = tile_begin(nt, c, me + 1);
  for (int l = 0; l < L; ++l) {
    const float* b = bc + (size_t)l * d;
    const float* s = sc ? sc + (size_t)l * d : nullptr;
    mma_layer<R>(cur, ldx, d, WcT + l * wstride, d, t0, t1, [&](int r, int j, float acc) {
      const int o = r * ldx + j;
      const float xw = __fadd_rn(scaled<T>(acc, s, j), b[j]);
      nxt[o] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(x0[r * d + j], xw), __bfloat162float(cur[o])));
    });
    if (c > 1 && l + 1 < L) {
      cg::this_cluster().sync();
      pull_peers<R>(nxt, ldx, nt, c, me);
    }
    __syncthreads();  // every warp read all of `cur`; the next layer overwrites it
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

struct ServeArgs {
  const int* ids;       // [n, F] int32, host-folded into [0, V)
  const void* wts;      // [n, F] bf16 or f32
  int wts_bf16;
  const float* table;   // [V, D] f32
  // Weights: f32 or int8 [K, N] for the f32 kernels; bf16 or int8 W^T
  // [pad_n(N), pad_k(K)] for the bf16 kernels.
  const void* wc;       // cross [L] x [d, d]
  const float* bc;      // [L, d] f32
  const float* sc;      // [L, d] f32 scales (int8 weights only)
  int L;
  const void* wm[MAX_MLP];   // MLP layer m: [K_m, M_m]
  const float* bm[MAX_MLP];  // [M_m] f32
  const float* sm[MAX_MLP];  // [M_m] f32 scales (int8 weights only)
  int mdims[MAX_MLP];
  int n_mlp;
  int mmax;
  const float* wo;      // [d + M_last] f32 head
  const float* bo;      // [1] f32
  float* pred;          // [n] f32
  float* logit;         // [n] f32
  int n, F, D;
};

__device__ void write_scores(const ServeArgs& a, const float* lc, const float* lh, int row0) {
  if (threadIdx.x < ROWS) {
    const int row = row0 + threadIdx.x;
    if (row < a.n) {
      const float lo = __fadd_rn(__fadd_rn(lc[threadIdx.x], lh[threadIdx.x]), a.bo[0]);
      a.logit[row] = lo;
      a.pred[row] = sigmoid(lo);
    }
  }
}

// T: the weights' element type (float, or int8_t with scales).
template <typename T>
__device__ __forceinline__ void serve_f32(const ServeArgs& a, unsigned char* smem) {
  const int d = a.F * a.D;
  float* x0T = reinterpret_cast<float*>(smem);
  float* xb0 = x0T + (size_t)d * ROWS;
  float* xb1 = xb0 + (size_t)d * ROWS;
  float* hb0 = xb1 + (size_t)d * ROWS;
  float* hb1 = hb0 + (size_t)a.mmax * ROWS;
  float* lh = hb1 + (size_t)a.mmax * ROWS;
  float* lc = lh + ROWS;
  const int row0 = blockIdx.x * ROWS;

  gather(a.ids, a.wts, a.wts_bf16, a.table, a.n, a.F, a.D, row0, [&](int r, int j, float x) {
    x0T[j * ROWS + r] = x;
    xb0[j * ROWS + r] = x;
  });
  __syncthreads();

  const float* in = xb0;
  int K = d;
  for (int m = 0; m < a.n_mlp; ++m) {
    float* out = (m & 1) ? hb1 : hb0;
    const float* b = a.bm[m];
    const float* s = a.sm[m];
    ffma_layer(in, K, static_cast<const T*>(a.wm[m]), a.mdims[m],
               [&](int j, const float(&acc)[ROWS]) {
                 const float bj = b[j];
#pragma unroll
                 for (int r = 0; r < ROWS; ++r) {
                   const float y = __fadd_rn(scaled<T>(acc[r], s, j), bj);
                   out[j * ROWS + r] = y > 0.f ? y : 0.f;
                 }
               });
    __syncthreads();
    in = out;
    K = a.mdims[m];
  }
  rowdot(in, 1, ROWS, K, a.wo + d, lh);

  const float* xc =
      ffma_cross(x0T, xb0, xb1, d, static_cast<const T*>(a.wc), a.bc, a.sc, a.L);
  rowdot(xc, 1, ROWS, d, a.wo, lc);
  __syncthreads();
  write_scores(a, lc, lh, row0);
}

// The columns [j0, j1) of a width-N layer that rank me of c owns.
__device__ __forceinline__ void own_columns(int N, int c, int me, int& j0, int& j1) {
  const int nt = pad_n(N) / 8;
  j0 = 8 * tile_begin(nt, c, me);
  j1 = min(8 * tile_begin(nt, c, me + 1), N);
}

// T: the weights' element type (bf16, or int8_t with scales). The block
// is rank `me` of a cluster of c serving tile blockIdx.x / c (header).
template <typename T>
__device__ __forceinline__ void serve_bf16(const ServeArgs& a, unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), me = (int)cluster.block_rank();
  const int d = a.F * a.D;
  const int ldx = lda_of(d), ldh = lda_of(a.mmax);
  float* x0 = reinterpret_cast<float*>(smem);
  bf16* xb0 = reinterpret_cast<bf16*>(x0 + (size_t)ROWS * d);
  bf16* xb1 = xb0 + ROWS * ldx;
  bf16* hb0 = xb1 + ROWS * ldx;
  bf16* hb1 = hb0 + ROWS * ldh;
  float* lh = reinterpret_cast<float*>(hb1 + ROWS * ldh);
  float* lc = lh + ROWS;
  const int row0 = (int)(blockIdx.x / c) * ROWS;

  zero_bf16(xb0, 2 * ROWS * ldx + 2 * ROWS * ldh);
  __syncthreads();
  gather(a.ids, a.wts, a.wts_bf16, a.table, a.n, a.F, a.D, row0, [&](int r, int j, float x) {
    x0[r * d + j] = x;
    xb0[r * ldx + j] = __float2bfloat16_rn(x);
  });
  __syncthreads();

  const bf16* in = xb0;
  int lda = ldx, K = d;
  for (int m = 0; m < a.n_mlp; ++m) {
    bf16* out = (m & 1) ? hb1 : hb0;
    const int M = a.mdims[m];
    const float* b = a.bm[m];
    const float* s = a.sm[m];
    const int nt = pad_n(M) / 8;
    mma_layer<ROWS>(in, lda, K, static_cast<const T*>(a.wm[m]), M, tile_begin(nt, c, me),
              tile_begin(nt, c, me + 1), [&](int r, int j, float acc) {
                const float y = __fadd_rn(scaled<T>(acc, s, j), b[j]);
                out[r * ldh + j] = __float2bfloat16_rn(y > 0.f ? y : 0.f);
              });
    // Columns [M, pad_k(M)) feed the next layer's padded k: clear what an
    // earlier, wider layer left there.
    const int gap = pad_k(M) - M;
    for (int i = threadIdx.x; i < ROWS * gap; i += blockDim.x)
      out[(i / gap) * ldh + M + i % gap] = __float2bfloat16_rn(0.f);
    if (c > 1 && m + 1 < a.n_mlp) {
      cluster.sync();
      pull_peers<ROWS>(out, ldh, nt, c, me);
    }
    __syncthreads();
    in = out;
    lda = ldh;
    K = M;
  }
  int j0, j1;
  own_columns(K, c, me, j0, j1);
  rowdot(in, lda, 1, j1, a.wo + d, lh, j0);

  const bf16* xc = mma_cross<ROWS>(x0, xb0, xb1, d, ldx, static_cast<const T*>(a.wc), a.bc,
                                   a.sc, a.L, c, me);
  own_columns(d, c, me, j0, j1);
  rowdot(xc, ldx, 1, j1, a.wo, lc, j0);
  if (c == 1) {
    __syncthreads();
    write_scores(a, lc, lh, row0);
    return;
  }
  cluster.sync();  // every rank's partial head sums are in its lc / lh
  if (me == 0 && threadIdx.x < ROWS) {
    const int r = threadIdx.x, row = row0 + r;
    float pc = lc[r], ph = lh[r];
    for (int q = 1; q < c; ++q) {
      pc = __fadd_rn(pc, *cluster.map_shared_rank(lc + r, q));
      ph = __fadd_rn(ph, *cluster.map_shared_rank(lh + r, q));
    }
    if (row < a.n) {
      const float lo = __fadd_rn(__fadd_rn(pc, ph), a.bo[0]);
      a.logit[row] = lo;
      a.pred[row] = sigmoid(lo);
    }
  }
  cluster.sync();  // no block exits while rank 0 may still read its partials
}

__global__ void __launch_bounds__(F32_MAX_THREADS) fused_serve_f32_kernel(ServeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  serve_f32<float>(a, smem);
}

__global__ void __launch_bounds__(F32_MAX_THREADS) fused_serve_int8_f32_kernel(ServeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  serve_f32<int8_t>(a, smem);
}

__global__ void __launch_bounds__(BF16_THREADS) fused_serve_bf16_kernel(ServeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  serve_bf16<bf16>(a, smem);
}

__global__ void __launch_bounds__(BF16_THREADS) fused_serve_int8_bf16_kernel(ServeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  serve_bf16<int8_t>(a, smem);
}

__global__ void __launch_bounds__(F32_MAX_THREADS)
    cross_stack_f32_kernel(const float* __restrict__ x0g, const float* __restrict__ w,
                           const float* __restrict__ b, float* __restrict__ out, int n, int d,
                           int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* x0T = reinterpret_cast<float*>(smem);
  float* xb0 = x0T + (size_t)d * ROWS;
  float* xb1 = xb0 + (size_t)d * ROWS;
  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < ROWS * d; i += blockDim.x) {
    const int r = i / d, j = i % d, row = row0 + r;
    const float v = row < n ? x0g[(size_t)row * d + j] : 0.f;
    x0T[j * ROWS + r] = v;
    xb0[j * ROWS + r] = v;
  }
  __syncthreads();
  const float* xc = ffma_cross(x0T, xb0, xb1, d, w, b, nullptr, L);
  for (int i = threadIdx.x; i < ROWS * d; i += blockDim.x) {
    const int r = i / d, j = i % d, row = row0 + r;
    if (row < n) out[(size_t)row * d + j] = xc[j * ROWS + r];
  }
}

// The bf16 cross stack: a tile of R rows (16 or 32) served by a cluster of
// c blocks (the launch's cluster size, 1 included). Every rank loads the
// whole x0 tile, computes its own columns of every layer through
// mma_cross (pulling the peers' after each layer but the last) and stores
// its own columns of x_L.
template <int R>
__global__ void __launch_bounds__(BF16_THREADS)
    cross_stack_bf16_kernel(const bf16* __restrict__ x0g, const bf16* __restrict__ wT,
                            const float* __restrict__ b, bf16* __restrict__ out, int n, int d,
                            int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), me = (int)cluster.block_rank();
  const int ldx = lda_of(d);
  float* x0 = reinterpret_cast<float*>(smem);
  bf16* xb0 = reinterpret_cast<bf16*>(x0 + (size_t)R * d);
  bf16* xb1 = xb0 + R * ldx;
  const int row0 = (int)(blockIdx.x / c) * R;
  zero_bf16(xb0, 2 * R * ldx);
  __syncthreads();
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, j = i % d, row = row0 + r;
    const bf16 v = row < n ? x0g[(size_t)row * d + j] : __float2bfloat16_rn(0.f);
    x0[r * d + j] = __bfloat162float(v);
    xb0[r * ldx + j] = v;
  }
  __syncthreads();
  const bf16* xc = mma_cross<R>(x0, xb0, xb1, d, ldx, wT, b, nullptr, L, c, me);
  int j0, j1;
  own_columns(d, c, me, j0, j1);
  const int w = j1 - j0;
  for (int i = threadIdx.x; i < R * w; i += blockDim.x) {
    const int r = i / w, j = j0 + i % w, row = row0 + r;
    if (row < n) out[(size_t)row * d + j] = xc[r * ldx + j];
  }
  // Block lifetime: mma_cross's last pull (after layer L - 2) reads the
  // peers' shared memory with no barrier after it, so a rank that got here
  // first could exit while a slower peer still reads its shared memory
  // through DSMEM, which is undefined. The fused serve kernel is covered
  // by its head's closing barrier; this kernel has no head, so it waits
  // for the whole cluster here.
  if (c > 1 && L >= 2) cluster.sync();
}

int f32_threads(int widest) {
  int t = ((widest + 1) / 2 + 31) / 32 * 32;  // one thread per column pair
  if (t < 64) t = 64;
  if (t > F32_MAX_THREADS) t = F32_MAX_THREADS;
  return t;
}

}  // namespace

extern "C" {

int dts_rows_per_block() { return ROWS; }

int dts_max_mlp_layers() { return MAX_MLP; }

// Warps of a bf16 block (the host's cross_plan counts their rounds).
int dts_bf16_warps() { return BF16_THREADS / 32; }

// Row stride (elements) of the bf16 activation tiles, and the padding the
// host applies to bf16 weights: W^T as [pad_n(N)][pad_k(K)].
int dts_bf16_pad_k(int k) { return pad_k(k); }
int dts_bf16_pad_n(int n) { return pad_n(n); }

// Bytes of one [K, N] weight operand of elem_bytes-wide elements as the
// fused serve kernels read it: [K][N] for the f32 kernels, W^T
// [pad_n(N)][pad_k(K)] for the bf16 kernels (bf16 or int8 elements).
size_t dts_weight_operand_bytes(int k, int n, int elem_bytes, int cd_bf16) {
  if (cd_bf16) return (size_t)pad_n(n) * pad_k(k) * elem_bytes;
  return (size_t)k * n * elem_bytes;
}

// The column partition of the bf16 fused serve cluster (the host mirrors it).
int dts_tile_begin(int nt, int c, int r) { return tile_begin(nt, c, r); }
int dts_tile_owner(int t, int nt, int c) { return tile_owner(t, nt, c); }

// x0, two x and two h buffers, two head partials.
size_t dts_serve_smem_bytes(int d, int mmax, int cd_bf16) {
  if (cd_bf16)
    return (size_t)ROWS * d * 4 + 2 * (size_t)ROWS * lda_of(d) * 2 +
           2 * (size_t)ROWS * lda_of(mmax) * 2 + 2 * ROWS * sizeof(float);
  return (size_t)ROWS * (4 * (size_t)d + 8 * (size_t)d + 8 * (size_t)mmax) +
         2 * ROWS * sizeof(float);
}

// x0 (f32) and two x buffers of a `rows`-row cross-stack tile.
size_t dts_cross_smem_bytes(int d, int cd_bf16, int rows) {
  if (cd_bf16) return (size_t)rows * d * 4 + 2 * (size_t)rows * lda_of(d) * 2;
  return (size_t)rows * d * 12;
}

const char* dts_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The bf16 fused serve kernel for float or int8 weights, its dynamic shared
// memory raised to `smem`.
static cudaError_t bf16_serve_kernel(int w_int8, size_t smem, void (**kernel)(ServeArgs)) {
  *kernel = w_int8 ? fused_serve_int8_bf16_kernel : fused_serve_bf16_kernel;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A launch of `blocks` bf16 blocks in clusters of c along x.
static void cluster_launch(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks,
                           size_t smem, cudaStream_t s, int c) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(BF16_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// How many clusters of c bf16 fused-serve blocks (width d, widest MLP
// layer mmax) the current device holds at once, into *out.
int dts_serve_max_active_clusters(int c, int d, int mmax, int w_int8, int* out) {
  const size_t smem = dts_serve_smem_bytes(d, mmax, 1);
  void (*kernel)(ServeArgs);
  cudaError_t e = bf16_serve_kernel(w_int8, smem, &kernel);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch(&cfg, &attr, c, smem, nullptr, c);
  e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  cudaGetLastError();  // a refusal is returned here, not left for the next launch
  return (int)e;
}

// w_int8: the weights are int8 with f32 per-output-channel scales sc
// ([L, d]) and sm[m] ([M_m]); otherwise float in the compute dtype and the
// scale pointers are ignored. cluster: the bf16 kernels' blocks per 16-row
// tile (>= 1; the host picks it), 0 for the f32
// kernels; a size the launch refuses is returned as its error.
int dts_fused_serve(const int* ids, const void* wts, int wts_bf16, const float* table,
                    const void* wc, const float* bc, int L, const void* const* wm,
                    const float* const* bm, const int* mdims, int n_mlp, const float* wo,
                    const float* bo, float* pred, float* logit, int n, int F, int D,
                    int cd_bf16, int w_int8, const float* sc, const float* const* sm,
                    int cluster, void* stream) {
  if (n_mlp < 1 || n_mlp > MAX_MLP || n < 0) return (int)cudaErrorInvalidValue;
  if (cd_bf16 ? cluster < 1 : cluster != 0) return (int)cudaErrorInvalidValue;
  if (w_int8 && (sc == nullptr || sm == nullptr)) return (int)cudaErrorInvalidValue;
  for (int m = 0; w_int8 && m < n_mlp; ++m)
    if (sm[m] == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ServeArgs a;
  a.ids = ids;
  a.wts = wts;
  a.wts_bf16 = wts_bf16;
  a.table = table;
  a.wc = wc;
  a.bc = bc;
  a.sc = w_int8 ? sc : nullptr;
  a.L = L;
  a.n_mlp = n_mlp;
  a.mmax = 0;
  for (int m = 0; m < MAX_MLP; ++m) {
    a.wm[m] = m < n_mlp ? wm[m] : nullptr;
    a.bm[m] = m < n_mlp ? bm[m] : nullptr;
    a.sm[m] = w_int8 && m < n_mlp ? sm[m] : nullptr;
    a.mdims[m] = m < n_mlp ? mdims[m] : 0;
    if (a.mdims[m] > a.mmax) a.mmax = a.mdims[m];
  }
  a.wo = wo;
  a.bo = bo;
  a.pred = pred;
  a.logit = logit;
  a.n = n;
  a.F = F;
  a.D = D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = F * D;
  const int grid = (n + ROWS - 1) / ROWS;
  const size_t smem = dts_serve_smem_bytes(d, a.mmax, cd_bf16);
  void (*kernel)(ServeArgs);
  cudaError_t e;
  if (cd_bf16) {
    e = bf16_serve_kernel(w_int8, smem, &kernel);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_launch(&cfg, &attr, grid * cluster, smem, s, cluster);
    e = cudaLaunchKernelEx(&cfg, kernel, a);
    const cudaError_t last = cudaGetLastError();  // clears a refusal as well
    return (int)(e != cudaSuccess ? e : last);
  }
  kernel = w_int8 ? fused_serve_int8_f32_kernel : fused_serve_f32_kernel;
  const int threads = f32_threads(d > a.mmax ? d : a.mmax);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

typedef void (*CrossBf16Kernel)(const bf16*, const bf16*, const float*, bf16*, int, int, int);

// The bf16 cross-stack kernel of `rows` rows per block (16 or 32), its
// dynamic shared memory raised to its size at width d.
static cudaError_t bf16_cross_kernel(int rows, int d, CrossBf16Kernel* kernel, size_t* smem) {
  if (rows != 16 && rows != 32) return cudaErrorInvalidValue;
  *kernel = rows == 32 ? cross_stack_bf16_kernel<32> : cross_stack_bf16_kernel<16>;
  *smem = dts_cross_smem_bytes(d, 1, rows);
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// How many clusters of c bf16 cross-stack blocks of `rows` rows at width d
// the current device holds at once, into *out.
int dts_cross_max_active_clusters(int c, int d, int rows, int* out) {
  CrossBf16Kernel kernel;
  size_t smem;
  cudaError_t e = bf16_cross_kernel(rows, d, &kernel, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch(&cfg, &attr, c, smem, nullptr, c);
  e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  cudaGetLastError();  // a refusal is returned here, not left for the next launch
  return (int)e;
}

// rows, cluster: the bf16 kernel's rows per block (16 or 32) and blocks
// per tile (>= 1; the host picks both); the f32 kernel takes rows = 16 and
// cluster = 0. A plan the launch refuses is returned as its error.
int dts_cross_stack(const void* x0, const void* w, const float* b, void* out, int n, int d,
                    int L, int cd_bf16, int rows, int cluster, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (cd_bf16 ? cluster < 1 : rows != ROWS || cluster != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (cd_bf16) {
    CrossBf16Kernel kernel;
    size_t smem;
    e = bf16_cross_kernel(rows, d, &kernel, &smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_launch(&cfg, &attr, (n + rows - 1) / rows * cluster, smem, s, cluster);
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x0),
                           static_cast<const bf16*>(w), b, static_cast<bf16*>(out), n, d, L);
    const cudaError_t last = cudaGetLastError();  // clears a refusal as well
    return (int)(e != cudaSuccess ? e : last);
  }
  const size_t smem = dts_cross_smem_bytes(d, 0, ROWS);
  e = cudaFuncSetAttribute(cross_stack_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  cross_stack_f32_kernel<<<(n + ROWS - 1) / ROWS, f32_threads(d), smem, s>>>(
      static_cast<const float*>(x0), static_cast<const float*>(w), b, static_cast<float*>(out),
      n, d, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
