// Building blocks shared by siren_fwd.cu and siren_bwd.cu: the SIREN
// chain's layer products as warp-level 3xTF32 tensor-core tiles on Hopper
// (sm_90a), the fragment permutation that keeps activations in registers
// from one layer to the next, the staged weight layout, and asynchronous
// tile copies.
//
// Which TPU kernels this serves: recombiner_tpu/ops/fused_inr.py::_fwd_kernel,
// ::_bwd_kernel and recombiner_tpu/ops/pallas_inr.py::_kernel, through the
// two kernels that include it.
//
// 3xTF32. mma.sync.m16n8k8 multiplies TF32 operands (10 explicit mantissa
// bits) into an f32 accumulator. Each f32 operand v is split as
//   hi = rna(v),  lo = rna(v - hi)
// (rna: to TF32, nearest, ties away from zero, as cvt.rna.tf32.f32 rounds;
// v - hi is exact in f32), and a product is accumulated as
//   hi_a hi_b  into one accumulator,  lo_a hi_b + hi_a lo_b  into another,
// added once at the end. lo is within 2^-11 of v; its rounding and the
// dropped lo_a lo_b are within about 2^-22 of the product. Kept apart, the
// small terms add no rounding to the large sum. So the result comes close
// to f32 accuracy, which the chain needs: w0 = 30 multiplies each layer's
// error through sin. On the card at CIFAR widths the kernels' gaps to an
// f64 evaluation are 1.1 to 1.4 times the f32 plain versions' (chip_smoke.py
// prints both; PERF.md §6). One TF32 pass (2^-11) misses the kernels' f32
// tolerances; tests/test_torch_tf32_split.py emulates both in numpy and
// shows it. The
// rounding is done with integer operations (tf32_round), which on the card
// is faster than cvt.rna.tf32.f32 (scripts/torch_siren_variants.py, variant
// cvt_rna; PERF.md §6).
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32; lane = 4 g + t):
//   A (16 x 8, row): a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B (8 x 8, col):  b0 (t, g)   b1 (t+4, g)
//   C (16 x 8):      c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// The permutation. A layer's output in C layout holds units 2t, 2t+1 of
// each 8-unit block. The next layer reads it as its A operand with k = t
// standing for unit 2t and k = t + 4 for unit 2t + 1, that is
//   a0 = c0, a1 = c2, a2 = c1, a3 = c3,
// inside each thread: no shuffle and no shared-memory round trip between
// layers. The B fragment follows the same order: b0 is weight row 8 kt + 2t,
// b1 row 8 kt + 2t + 1 (forward), or, for da = dz W^T, columns 8 kt + 2t and
// 8 kt + 2t + 1 of row 8 nt + g. Activation tiles loaded from memory (x, dy)
// are read straight into C layout, so every layer uses the one convention.
//
// Weights are staged in shared memory once per sample. siren_fwd's fixed-width
// instances stage them pre-split, hi and lo of each B fragment in fragment
// order, so a B fragment is one conflict-free 16-byte load
// (layer_forward_presplit). siren_bwd reads each layer both ways (W for the
// recompute, W^T for da), and hi/lo planes in fragment order for both would
// take four copies of the weights, about 50 KB at CIFAR widths, which would
// cost it its second block per SM; so it stages them as f32, per layer a
// bias row of round8(out) and round8(in) rows of round8(out) + 4 floats, all
// pads zero, and splits when a B fragment is loaded (four ALU operations per
// value). With that row stride of 4 (mod 8) floats the forward's B loads are
// free of bank conflicts; the backward's have two-way conflicts.
// Widths are padded to multiples of 8 with zeros (34 -> 40, 3 -> 8).
//
// Instances. Each kernel is compiled once per width set that a modality
// config runs (SIREN_FIXED_INSTANCES: CIFAR's 32-32-32-32-3, audio's
// 32-32-32-32-1, video's 34-32-32-32-3), with every width a template
// constant, so that every guard, tile count and stride folds; and once for
// widths read at run time, up to 64 in up to 8 layers (instance 0), which
// every other width set takes (the TINY configs). A fragment array holds
// the 8-unit blocks of the instance's widest layer (5 at video's 34-wide
// input, 4 at 32), but each layer's loops run over the blocks of its own
// padded width (round8 for units, round16 for dW's row blocks), so a
// 32-wide layer of video's instance does what CIFAR's does and only layer
// 0's operands have a fifth block. The run-time instance's arrays are 64
// wide and 8 deep: it spills (255 registers in siren_bwd) and is several
// times slower than a fixed one at the same widths (PERF.md §6).
//
// Bounds on this card at CIFAR widths and f32 accuracy: siren_fwd is bound
// by bytes (0.0233 ms at B = 500), siren_bwd by operations as 3xTF32
// (0.2919 ms at B = 2,500). Both run several times above them, held by
// instruction issue and latency: the splits, the sines and, in siren_bwd,
// its dW phase (PERF.md §6).
//
// Fixed-order dW sums (siren_bwd.cu): each warp owns whole 8-column blocks
// of every dW_l, sums them over a pixel tile in registers in pixel order,
// and adds the sums tile after tile to its own shared accumulator; db_l
// likewise per lane, combined in a fixed order. No atomics, so two launches
// on the same inputs are bitwise equal.
//
// A host stand-in can compile the kernels with a C++ compiler by defining
// SIREN_HOST_STANDIN and providing the functions in the #ifndef block below
// (an m16n8k8 emulated over one warp's lanes) and CUDA's builtins.

#pragma once

#include <stdint.h>

#ifndef SIREN_HOST_STANDIN
#include <cuda_runtime.h>
#endif

#define SIREN_MAX_LAYERS 8
#define SIREN_MAX_WIDTH 64
#define SMEM_LIMIT (227 * 1024)

struct SirenDims {
  int n_layers;
  int d[SIREN_MAX_LAYERS + 1];
};

// Read and check n_layers + 1 widths from a host array; false if refused.
static inline bool read_dims(int n_layers, const void* dims_host, SirenDims& dims) {
  if (n_layers < 1 || n_layers > SIREN_MAX_LAYERS) return false;
  const int* d = static_cast<const int*>(dims_host);
  dims.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (d[l] < 1 || d[l] > SIREN_MAX_WIDTH) return false;
    dims.d[l] = d[l];
  }
  return true;
}

static inline int theta_floats(const SirenDims& dims) {
  int n = 0;
  for (int l = 0; l < dims.n_layers; ++l) n += (dims.d[l] + 1) * dims.d[l + 1];
  return n;
}

static __host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }
static __host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }
static __host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// Row stride (floats) of a pixel-major activation tile read as C/A
// fragments: 8 or 24 (mod 32), so the 8-byte loads and stores of a C
// fragment and the 4-byte column reads of siren_bwd's dW operands are free
// of bank conflicts. A tile holds round8(d) columns: dW's 16-unit row
// blocks skip the upper half of a block that lies wholly past d.
static __host__ __device__ __forceinline__ int frag_stride(int d) {
  const int r = round8(d);
  return (r & 8) ? r : r + 8;
}
// Staged weights of one layer: bias row, then round8(in) rows of this stride.
static __host__ __device__ __forceinline__ int weight_stride(int out) { return round8(out) + 4; }
static __host__ __device__ __forceinline__ int layer_floats(int in, int out) {
  return round8(out) + round8(in) * weight_stride(out);
}
// The same layer staged pre-split for the forward: bias row, then per
// (kt, nt, lane) the 16 bytes {b0 hi, b1 hi, b0 lo, b1 lo}.
static __host__ __device__ __forceinline__ int split_layer_floats(int in, int out) {
  return round8(out) + 2 * round8(in) * round8(out);
}

#ifndef SIREN_HOST_STANDIN
// d += a b on one warp's m16n8k8 tile, TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous global -> shared copies; with valid false the destination is
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
#endif

// v rounded to TF32 to nearest, ties away from zero: cvt.rna.tf32.f32's
// rounding of a finite value, as two integer operations.
__device__ __forceinline__ uint32_t tf32_round(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// hi = rna(v), lo = rna(v - hi); v - hi is exact in f32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(v);
  lo = tf32_round(v - __uint_as_float(hi));
}

// a b in 3xTF32: the large term into big, the two small ones into small.
// Summed apart, the small terms (about 2^-11 of the large) add no rounding
// to the large sum, which then rounds as often as an f32 FMA chain; the
// caller adds big + small once at the end.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2], const uint32_t (&blo)[2]) {
  mma_tf32(small, alo, bhi);
  mma_tf32(small, ahi, blo);
  mma_tf32(big, ahi, bhi);
}

template <int NT>
__device__ __forceinline__ void add_small(float (&big)[NT][4], const float (&small)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) big[nt][i] += small[nt][i];
  }
}

// sin and cos of x for |x| <= SINCOS_FAST_MAX, branch-free: x = j pi/2 + r
// with j = rint(2x/pi) and r reduced in three FMA steps (pi/2 as three f32
// parts; exact enough for |j| < 2^16), then the minimax polynomials of
// Cephes' sinf/cosf on [-pi/4, pi/4] and a quadrant swap. Within 7e-8 of
// sin/cos over the range, as the library's f32 sinf (tests/
// test_torch_tf32_split.py emulates it against numpy).
#define SINCOS_FAST_MAX 1.0e5f
__device__ __forceinline__ void sincos_fast(float x, float& s, float& c) {
  const float j = rintf(x * 0.636619772f);
  float r = fmaf(j, -1.57079637e+00f, x);
  r = fmaf(j, 4.37113883e-08f, r);
  r = fmaf(j, 1.77635684e-15f, r);
  const float z = r * r;
  float ps = fmaf(z, -1.9515295891e-4f, 8.3321608736e-3f);
  ps = fmaf(z, ps, -1.6666654611e-1f);
  const float sr = fmaf(r, ps * z, r);
  float pc = fmaf(z, 2.443315711809948e-5f, -1.388731625493765e-3f);
  pc = fmaf(z, pc, 4.166664568298827e-2f);
  pc = fmaf(z, pc, -0.5f);
  const float cr = fmaf(z, pc, 1.0f);
  const int q = (int)j;
  const float sv = (q & 1) ? cr : sr, cv = (q & 1) ? sr : cr;
  s = (q & 2) ? -sv : sv;
  c = ((q + 1) & 2) ? -cv : cv;
}

// s = sin(w0 z) and c = w0 cos(w0 z) for the units of a C-layout tile (the
// first nts 8-unit blocks; the rest 0): one sincos per unit on the
// branch-free path, whose independent chains the compiler interleaves, and
// the library's precise sincosf for the whole tile in the rare case that
// an argument is out of that path's range or not finite (one branch per
// tile, not one per unit).
template <int NT>
__device__ __forceinline__ void sin_cos_tile(const float (&z)[NT][4], int nts, float w0,
                                             float (&s)[NT][4], float (&c)[NT][4]) {
  bool wide = false;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sv = 0.f, cv = 0.f;
      if (nt < nts) {
        const float arg = w0 * z[nt][i];
        wide |= !(fabsf(arg) <= SINCOS_FAST_MAX);
        sincos_fast(arg, sv, cv);
        cv *= w0;
      }
      s[nt][i] = sv;
      c[nt][i] = cv;
    }
  }
  if (wide) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (nt < nts) {
          float sv, cv;
          sincosf(w0 * z[nt][i], &sv, &cv);
          s[nt][i] = sv;
          c[nt][i] = w0 * cv;
        }
      }
    }
  }
}

// The fixed-width instances, X(id, layers, in, hidden, out): widths
// in-hidden-...-hidden-out. Instance 0 is the run-time one. The port's
// recombiner_tpu_torch/ops/fused_inr.py::FIXED_WIDTHS lists the same table;
// the C entry points refuse a launch whose instance is not this table's.
#define SIREN_FIXED_INSTANCES(X) \
  X(1, 4, 32, 32, 3) /* CIFAR, Kodak, kodak_mini, protein */ \
  X(2, 4, 32, 32, 1) /* audio, audio_mini */ \
  X(3, 4, 34, 32, 3) /* video */

// One instance's widths: template constants when IN0 > 0, else read from
// SirenDims (L, IN0, HID, OUT = SIREN_MAX_LAYERS, 0, 0, 0). NT and MT: the
// 8- and 16-unit blocks of its widest layer, the fragment arrays' sizes.
template <int L, int IN0, int HID, int OUT>
struct Instance {
  static constexpr bool fixed = IN0 > 0;
  static constexpr int layers = L;
  static constexpr int max_width =
      !fixed ? SIREN_MAX_WIDTH
             : (IN0 > HID ? (IN0 > OUT ? IN0 : OUT) : (HID > OUT ? HID : OUT));
  static constexpr int NT = round8(max_width) / 8;
  static constexpr int MT = round16(max_width) / 16;
  SirenDims rt;
  __device__ __forceinline__ int n_layers() const { return fixed ? L : rt.n_layers; }
  __device__ __forceinline__ int operator[](int l) const {
    return fixed ? (l == 0 ? IN0 : l == L ? OUT : HID) : rt.d[l];
  }
};
using RuntimeInstance = Instance<SIREN_MAX_LAYERS, 0, 0, 0>;

static inline bool widths_are(const SirenDims& dims, int L, int in, int hid, int out) {
  bool same = dims.n_layers == L && dims.d[0] == in && dims.d[L] == out;
  for (int l = 1; same && l < L; ++l) same = dims.d[l] == hid;
  return same;
}

// The instance these widths take: a fixed one's id, else 0.
static inline int siren_instance(const SirenDims& dims) {
#define SIREN_MATCH(id, L, IN0, HID, OUT) \
  if (widths_are(dims, L, IN0, HID, OUT)) return id;
  SIREN_FIXED_INSTANCES(SIREN_MATCH)
#undef SIREN_MATCH
  return 0;
}

// f(Instance<...>{}) for instance id `inst`.
template <class F>
static auto with_instance(int inst, F&& f) {
  switch (inst) {
#define SIREN_CASE(id, L, IN0, HID, OUT) \
  case id:                              \
    return f(Instance<L, IN0, HID, OUT>{});
    SIREN_FIXED_INSTANCES(SIREN_CASE)
#undef SIREN_CASE
    default:
      return f(RuntimeInstance{});
  }
}

// Floats per copy for rows of width d at these addresses: 4 (16 bytes), 2
// (8 bytes, video's 34-wide rows) or 1.
static inline int row_vec(int d, const void* a, const void* b) {
  const uintptr_t p = (uintptr_t)a | (uintptr_t)b;
  return (d % 4 == 0 && p % 16 == 0) ? 4 : (d % 2 == 0 && p % 8 == 0) ? 2 : 1;
}

// A fragment (split) from an 8-unit block held in C layout: the permutation.
__device__ __forceinline__ void a_from_c(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// A 16-pixel x (8 NT)-unit tile in C layout: c[nt] holds units 8 nt + 2t,
// 8 nt + 2t + 1 of pixels g and g + 8.
template <int NT>
__device__ __forceinline__ void load_c(float (&c)[NT][4], const float* rows, int stride, int d,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3, nts = round8(d) >> 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < nts) {
      const float2 u = *reinterpret_cast<const float2*>(rows + g * stride + 8 * nt + 2 * t);
      const float2 v =
          *reinterpret_cast<const float2*>(rows + (g + 8) * stride + 8 * nt + 2 * t);
      c[nt][0] = u.x;
      c[nt][1] = u.y;
      c[nt][2] = v.x;
      c[nt][3] = v.y;
    } else {
      c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    }
  }
}

template <int NT>
__device__ __forceinline__ void store_c(const float (&c)[NT][4], float* rows, int stride, int d,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3, nts = round8(d) >> 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < nts) {
      *reinterpret_cast<float2*>(rows + g * stride + 8 * nt + 2 * t) =
          make_float2(c[nt][0], c[nt][1]);
      *reinterpret_cast<float2*>(rows + (g + 8) * stride + 8 * nt + 2 * t) =
          make_float2(c[nt][2], c[nt][3]);
    }
  }
}

// z = a W + b for 16 pixels: a (C layout over `in` units), W staged at w.
template <int NT>
__device__ __forceinline__ void layer_forward(const float (&a)[NT][4], float (&z)[NT][4],
                                              const float* w, int in, int out, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int kts = round8(in) >> 3, nts = round8(out) >> 3, ws = weight_stride(out);
  const float* rows = w + round8(out);
  float small[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float b0 = nt < nts ? w[8 * nt + 2 * t] : 0.f;
    const float b1 = nt < nts ? w[8 * nt + 2 * t + 1] : 0.f;
    z[nt][0] = b0;
    z[nt][1] = b1;
    z[nt][2] = b0;
    z[nt][3] = b1;
    small[nt][0] = small[nt][1] = small[nt][2] = small[nt][3] = 0.f;
  }
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt < kts) {
      uint32_t ahi[4], alo[4];
      a_from_c(a[kt], ahi, alo);
      const float* r = rows + (8 * kt + 2 * t) * ws + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nts) {
          uint32_t bhi[2], blo[2];
          split_tf32(r[8 * nt], bhi[0], blo[0]);
          split_tf32(r[ws + 8 * nt], bhi[1], blo[1]);
          mma_3xtf32(z[nt], small[nt], ahi, alo, bhi, blo);
        }
      }
    }
  }
  add_small(z, small);
}

// da = dz W^T for 16 pixels: dz (C layout over `out` units) -> da (C layout
// over `in` units), W staged at w.
template <int NT>
__device__ __forceinline__ void layer_backward(const float (&dz)[NT][4], float (&da)[NT][4],
                                               const float* w, int in, int out, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int kts = round8(out) >> 3, nts = round8(in) >> 3, ws = weight_stride(out);
  const float* rows = w + round8(out);
  float small[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    da[nt][0] = da[nt][1] = da[nt][2] = da[nt][3] = 0.f;
    small[nt][0] = small[nt][1] = small[nt][2] = small[nt][3] = 0.f;
  }
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt < kts) {
      uint32_t ahi[4], alo[4];
      a_from_c(dz[kt], ahi, alo);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nts) {
          const float2 v =
              *reinterpret_cast<const float2*>(rows + (8 * nt + g) * ws + 8 * kt + 2 * t);
          uint32_t bhi[2], blo[2];
          split_tf32(v.x, bhi[0], blo[0]);
          split_tf32(v.y, bhi[1], blo[1]);
          mma_3xtf32(da[nt], small[nt], ahi, alo, bhi, blo);
        }
      }
    }
  }
  add_small(da, small);
}

// The same as layer_forward, with the layer staged by stage_split_weights:
// one conflict-free 16-byte load per B fragment and no split.
template <int NT>
__device__ __forceinline__ void layer_forward_presplit(const float (&a)[NT][4], float (&z)[NT][4],
                                                       const float* w, int in, int out,
                                                       int lane) {
  const int t = lane & 3;
  const int kts = round8(in) >> 3, nts = round8(out) >> 3;
  const uint4* frag = reinterpret_cast<const uint4*>(w + round8(out));
  float small[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float b0 = nt < nts ? w[8 * nt + 2 * t] : 0.f;
    const float b1 = nt < nts ? w[8 * nt + 2 * t + 1] : 0.f;
    z[nt][0] = b0;
    z[nt][1] = b1;
    z[nt][2] = b0;
    z[nt][3] = b1;
    small[nt][0] = small[nt][1] = small[nt][2] = small[nt][3] = 0.f;
  }
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt < kts) {
      uint32_t ahi[4], alo[4];
      a_from_c(a[kt], ahi, alo);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nts) {
          const uint4 b = frag[(kt * nts + nt) * 32 + lane];
          const uint32_t bhi[2] = {b.x, b.y}, blo[2] = {b.z, b.w};
          mma_3xtf32(z[nt], small[nt], ahi, alo, bhi, blo);
        }
      }
    }
  }
  add_small(z, small);
}

// Stage one sample's packed theta for layer_forward_presplit at w_off[l]:
// the bias row, then every B fragment split once (the forward reads each
// one once per 16-pixel tile).
__device__ __forceinline__ void stage_split_weights(float* smem, const int* w_off,
                                                    const float* th, const SirenDims& dims,
                                                    int tid, int nthreads) {
  int src = 0;
  for (int l = 0; l < dims.n_layers; ++l) {
    const int in = dims.d[l], out = dims.d[l + 1];
    const int o8 = round8(out), nts = o8 >> 3, n = (round8(in) >> 3) * nts * 32;
    float* dst = smem + w_off[l];
    for (int k = tid; k < o8; k += nthreads) dst[k] = k < out ? th[src + k] : 0.f;
    uint4* frag = reinterpret_cast<uint4*>(dst + o8);
    for (int q = tid; q < n; q += nthreads) {
      const int lane = q & 31, f = q >> 5, kt = f / nts, nt = f - kt * nts;
      const int r = 8 * kt + 2 * (lane & 3), c = 8 * nt + (lane >> 2);
      const float* w = th + src + out;
      const float b0 = (r < in && c < out) ? w[r * out + c] : 0.f;
      const float b1 = (r + 1 < in && c < out) ? w[(r + 1) * out + c] : 0.f;
      uint4 v;
      split_tf32(b0, v.x, v.z);
      split_tf32(b1, v.y, v.w);
      frag[q] = v;
    }
    src += (in + 1) * out;
  }
}

// Stage one sample's packed theta (per layer [b (out), W (in x out)]) into
// the layout above at w_off[l]; every float of each layer's region is
// written, pads with zero.
__device__ __forceinline__ void stage_weights(float* smem, const int* w_off, const float* th,
                                              const SirenDims& dims, int tid, int nthreads) {
  int src = 0;
  for (int l = 0; l < dims.n_layers; ++l) {
    const int in = dims.d[l], out = dims.d[l + 1];
    const int o8 = round8(out), ws = weight_stride(out), n = layer_floats(in, out);
    float* dst = smem + w_off[l];
    for (int k = tid; k < n; k += nthreads) {
      float v = 0.f;
      if (k < o8) {
        if (k < out) v = th[src + k];
      } else {
        const int r = (k - o8) / ws, c = (k - o8) - r * ws;
        if (r < in && c < out) v = th[src + out + r * out + c];
      }
      dst[k] = v;
    }
    src += (in + 1) * out;
  }
}

// Copy `rows` pixel rows of width d (contiguous in global memory from src)
// into shared rows of `stride`, asynchronously, by threads tid, tid +
// nthreads, ...; rows at or past `valid_rows` are zero-filled. vec: floats
// per copy (row_vec), dividing d and stride, src aligned to it.
template <int V>
__device__ __forceinline__ void copy_rows_vec(float* dst, int stride, const float* src, int d,
                                              int rows, int valid_rows, int tid, int nthreads) {
  const int q = d / V;
  for (int c = tid; c < rows * q; c += nthreads) {
    const int r = c / q, k = c - r * q;
    const bool ok = r < valid_rows;
    const float* from = ok ? src + (size_t)r * d + V * k : src;
    if constexpr (V == 4)
      cp_async16(dst + r * stride + 4 * k, from, ok);
    else if constexpr (V == 2)
      cp_async8(dst + r * stride + 2 * k, from, ok);
    else
      cp_async4(dst + r * stride + k, from, ok);
  }
}
__device__ __forceinline__ void copy_rows_async(float* dst, int stride, const float* src, int d,
                                                int rows, int valid_rows, int vec, int tid,
                                                int nthreads) {
  if (vec == 4)
    copy_rows_vec<4>(dst, stride, src, d, rows, valid_rows, tid, nthreads);
  else if (vec == 2)
    copy_rows_vec<2>(dst, stride, src, d, rows, valid_rows, tid, nthreads);
  else
    copy_rows_vec<1>(dst, stride, src, d, rows, valid_rows, tid, nthreads);
}

// Store `rows` shared rows of `stride` (first d floats each) to contiguous
// global memory at dst, coalesced; vec as above for dst.
__device__ __forceinline__ void store_rows(float* dst, const float* src, int stride, int d,
                                           int rows, int vec, int tid, int nthreads) {
  if (vec == 4) {
    const int q = d >> 2;
    for (int c = tid; c < rows * q; c += nthreads) {
      const int r = c / q, k = c - r * q;
      reinterpret_cast<float4*>(dst)[c] =
          *reinterpret_cast<const float4*>(src + r * stride + 4 * k);
    }
  } else if (vec == 2) {
    const int q = d >> 1;
    for (int c = tid; c < rows * q; c += nthreads) {
      const int r = c / q, k = c - r * q;
      reinterpret_cast<float2*>(dst)[c] =
          *reinterpret_cast<const float2*>(src + r * stride + 2 * k);
    }
  } else {
    for (int c = tid; c < rows * d; c += nthreads) {
      const int r = c / d, k = c - r * d;
      dst[c] = src[r * stride + k];
    }
  }
}
