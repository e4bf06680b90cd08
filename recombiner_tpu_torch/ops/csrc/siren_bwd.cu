// Per-sample SIREN backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel recombiner_tpu/ops/fused_inr.py::_bwd_kernel (the
// backward of the custom_vjp in _make_fused). For every sample s, with the
// forward of siren_fwd.cu
//   a_0 = x[s, p, :],  z_l = a_l @ W_l + b_l,  a_{l+1} = sin(w0 z_l),
// and dz_{L-1} = dy[s, p, :], it computes
//   dW_l = sum_p a_l^T dz_l,   db_l = sum_p dz_l,   da_l = dz_l W_l^T,
//   dz_{l-1} = da_l * w0 cos(w0 z_{l-1}),            dx[s, p, :] = da_0,
// and writes dx and dtheta, dtheta in theta's packed layout (per layer
// [db_l (out), dW_l (in x out, row-major)]). Nothing but x, theta, dy, dx
// and dtheta touches device memory: the forward is recomputed on chip.
//
// Design (the 3xTF32 tile product, the fragment permutation, the staged
// weight layout and the sincos are in siren_mma.cuh):
// - One block of up to four warps per sample. Its weights are staged in
//   shared memory once; it walks the sample's pixels in tiles of 16 per
//   warp (64 at CIFAR), each warp owning 16 pixels of a tile.
// - x and dy tiles arrive by cp.async, double-buffered: the next tile's
//   copy is issued before this tile's first barrier and lands while it
//   computes.
// - Forward recompute, per warp in registers: each layer is a 3xTF32
//   tensor-core product, and each hidden unit takes one sincos (the
//   branch-free path, as accurate as the library's sincosf), keeping sin as
//   the next layer's input (and in a shared tile for dW) and w0 cos in
//   registers for the backward, which recomputes neither.
// - Backward, per warp in registers, layer by layer: da_l = dz_l W_l^T is a
//   tensor-core product whose A operand is dz_l's C fragment (the
//   permutation); dz_{l-1} = da_l * w0 cos goes to a shared tile for dW and
//   stays in registers as the next A operand; da_0 leaves as dx through a
//   shared staging tile as coalesced 16-byte stores.
// - dW_l = a_l^T dz_l needs both operands transposed (k = pixels), so it
//   reads them from the shared tiles, whose row strides (8 or 24 mod 32
//   floats) make those column reads free of bank conflicts. Its 16 x 8
//   output tiles are dealt to the warps in a fixed way: warp w owns the
//   8-column blocks nt = w, w + warps, ... with all their 16-row blocks, so
//   a dz fragment is loaded and split once for the row blocks beside it.
//   Each warp sums its tiles over the tile's pixels in registers, in order,
//   and adds the sums to its own accumulator in shared memory (fragment
//   order, 16-byte accesses) tile after tile; db_l rides on the same loads
//   as per-lane f32 sums of the dz values, combined in a fixed order at the
//   end. No atomics: two launches on the same inputs give bitwise-equal
//   outputs. dtheta is written once, at the end of the sample. (Where the
//   accumulator does not fit in shared memory, at the largest widths and
//   depths, the owning lane adds each tile's sums to dtheta in device memory
//   instead, in the same fixed order.)
// - Barriers per tile: one after the copy, one after the forward, one per
//   layer of the backward (its dW reads the tiles the other warps wrote):
//   six at CIFAR's four layers.
// - Instances (siren_mma.cuh): one per width set a modality config runs,
//   every width a compile-time constant (CIFAR's 32-32-32-32-3, audio's
//   32-32-32-32-1, video's 34-32-32-32-3), and one for widths read at run
//   time, up to 64 in up to 8 layers, which spills and serves only the
//   TINY configs and arbitrary widths.
//
// Shared memory at CIFAR widths (32-32-32-32-3), 64-pixel tiles: 106,528
// bytes (weights 15.8 KB, accumulator 15.0 KB, two x, two dy and two dz
// tiles, three activation tiles), so two blocks (eight warps) per SM. Four
// blocks would need under 56 KB each: the activation and dz tiles that the
// transposed dW operands are read from take 700 bytes per pixel, and eight
// warps per block would double them. Registers: 121 (ptxas), of which the
// w0 cos terms of three hidden layers take 48. At video's widths the
// 34-wide input grows the weights (layer 0 has 40 padded rows) and dW_0's
// accumulator (three 16-row blocks: 12 tiles, not 8), but its x tiles keep
// a 40-float stride, because dW_0's third row block reads only its lower 8
// rows (34 <= 40), so the block needs 109,728 bytes: still two per SM.
// x and dx rows of 34 floats move as 8-byte copies.
//
// Precision: 3xTF32 products and f32 sums (see siren_mma.cuh: at CIFAR its
// gaps to an f64 evaluation are 1.3 to 1.4 times the f32 plain version's),
// and sines as accurate as the library's (w0 = 30 puts the arguments far
// outside __sinf's accurate range); never --use_fast_math.
//
// Bound (CIFAR encode, B = 2,500 samples, P = 1,024): per pixel the forward
// recompute's 3,072 multiply-adds (it stops before the last layer) and 3,168
// each for dW and da, 9,408 in all: 48.17 GFLOP, 0.7189 ms at the 67
// TFLOP/s FP32 FMA peak, 0.2919 ms as 3xTF32 on the tensor cores (3 x 48.17
// GFLOP at 495 TFLOP/s); 751 MB of x, theta, dy, dx and dtheta, 0.2243 ms at
// 3.35 TB/s. At f32 accuracy it is bound by operations (3xTF32). The 96
// sincos per pixel are not counted. What holds it above that bound is
// instruction issue and latency, not the tensor cores: dW's operand loads
// and splits (about 50 instructions per 6 tile products) and the chains of
// dependent mma.sync that eight warps per SM hide poorly.
// scripts/torch_siren_variants.py times it with each phase cut out in turn
// (PERF.md §6).

#include "siren_mma.cuh"

#define BWD_MAX_WARPS 4

// Shared-memory layout (floats) and strides, computed on the host.
struct BwdLayout {
  int w_off[SIREN_MAX_LAYERS];     // staged weights of layer l
  int tile0[SIREN_MAX_LAYERS];     // first dW output tile of layer l in acc
  int g_off[SIREN_MAX_LAYERS];     // layer l's offset in packed theta
  int act[SIREN_MAX_LAYERS];       // a_l tile, l = 1 .. L-1
  int sa[SIREN_MAX_LAYERS];        // its row stride
  int dbp[SIREN_MAX_LAYERS];       // per-lane db partial sums of layer l: round8(out) x 4
  int zero_from;                   // everything from here on is zeroed at the start
  int acc;                         // dW accumulator, 128 floats per tile; -1: in dtheta
  int xb[2], dyb[2], dzb[2];       // double-buffered x, dy and dz tiles
  int sx, sdy, sz;                 // their row strides
  int total;
};

static BwdLayout bwd_layout(const SirenDims& dims, int warps, bool acc_in_smem) {
  BwdLayout lay = {};
  const int L = dims.n_layers, T = 16 * warps;
  int off = 0, tiles = 0, goff = 0, sz = frag_stride(dims.d[0]);
  for (int l = 0; l < L; ++l) {
    const int in = dims.d[l], out = dims.d[l + 1];
    lay.w_off[l] = off;
    off += layer_floats(in, out);
    lay.tile0[l] = tiles;
    tiles += (round16(in) / 16) * (round8(out) / 8);
    lay.g_off[l] = goff;
    goff += (in + 1) * out;
    if (l > 0) sz = frag_stride(in) > sz ? frag_stride(in) : sz;
  }
  off = round4(off);
  lay.zero_from = off;
  lay.acc = acc_in_smem ? off : -1;
  if (acc_in_smem) off += tiles * 128;
  for (int l = 0; l < L; ++l) {
    lay.dbp[l] = off;
    off += round8(dims.d[l + 1]) * 4;
  }
  lay.sx = frag_stride(dims.d[0]);
  lay.sdy = frag_stride(dims.d[L]);
  lay.sz = sz;
  for (int b = 0; b < 2; ++b) {
    lay.xb[b] = off;
    off += T * lay.sx;
    lay.dyb[b] = off;
    off += T * lay.sdy;
    lay.dzb[b] = off;
    off += T * lay.sz;
  }
  for (int l = 1; l < L; ++l) {
    lay.sa[l] = frag_stride(dims.d[l]);
    lay.act[l] = off;
    off += T * lay.sa[l];
  }
  lay.total = off;
  return lay;
}

// dW_l and db_l over one tile's T pixels for the output tiles this warp
// owns: A rows a_l (stride sA), Z rows dz_l (stride sZ). Warp w owns the
// 8-column blocks nt = w, w + warps, ... of dW_l with all their 16-row
// blocks, so each dz fragment is loaded and split once for all of them and
// their MT products run side by side, each into its two accumulators. A
// row block whose upper 8 rows lie wholly past `in` reads only its lower 8
// (the tiles hold round8(in) columns; the upper rows are zero and dropped).
template <int MT>
__device__ __forceinline__ void dw_tile(const float* A, int sA, const float* Z, int sZ, int in,
                                        int out, int T, int warp, int warps, int lane,
                                        float* acc, float* dbp, float* dth, bool first) {
  const int g = lane >> 2, t = lane & 3;
  const int nts = round8(out) >> 3, mts = round16(in) >> 4;
  for (int nt = warp; nt < nts; nt += warps) {
    float big[MT][4], small[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) big[mt][i] = small[mt][i] = 0.f;
    }
    float db = 0.f;
    for (int kk = 0; kk < T; kk += 8) {
      const float* zr = Z + (kk + t) * sZ + 8 * nt + g;
      const float z0 = zr[0], z1 = zr[4 * sZ];
      db += z0;
      db += z1;
      uint32_t bhi[2], blo[2];
      split_tf32(z0, bhi[0], blo[0]);
      split_tf32(z1, bhi[1], blo[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mts) {
          const float* ar = A + (kk + t) * sA + 16 * mt + g;
          uint32_t ahi[4], alo[4];
          split_tf32(ar[0], ahi[0], alo[0]);
          split_tf32(ar[4 * sA], ahi[2], alo[2]);
          if (16 * mt + 8 < in) {
            split_tf32(ar[8], ahi[1], alo[1]);
            split_tf32(ar[4 * sA + 8], ahi[3], alo[3]);
          } else {
            ahi[1] = alo[1] = ahi[3] = alo[3] = 0u;
          }
          mma_3xtf32(big[mt], small[mt], ahi, alo, bhi, blo);
        }
      }
    }
    dbp[(8 * nt + g) * 4 + t] += db;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt < mts) {
        const float d[4] = {big[mt][0] + small[mt][0], big[mt][1] + small[mt][1],
                            big[mt][2] + small[mt][2], big[mt][3] + small[mt][3]};
        if (acc) {
          float4* p = reinterpret_cast<float4*>(acc) + (mt * nts + nt) * 32 + lane;
          float4 v = *p;
          v.x += d[0];
          v.y += d[1];
          v.z += d[2];
          v.w += d[3];
          *p = v;
        } else {
          // rows 16 mt + g (+ 8), columns 8 nt + 2t (+ 1) of dW_l in packed dtheta
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 16 * mt + g + 8 * (i >> 1), c = 8 * nt + 2 * t + (i & 1);
            if (r < in && c < out) {
              float* q = dth + out + r * out + c;
              *q = first ? d[i] : *q + d[i];
            }
          }
        }
      }
    }
  }
}

template <class I>
__global__ void __launch_bounds__(BWD_MAX_WARPS * 32)
siren_bwd_kernel(const float* __restrict__ x, const float* __restrict__ theta,
                 const float* __restrict__ dy, float* __restrict__ dx,
                 float* __restrict__ dtheta, int P, int theta_stride, SirenDims dims,
                 BwdLayout lay, float w0, int x_vec, int dy_vec) {
  constexpr int NT = I::NT, MAXL = I::layers;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, warps = nthreads >> 5, lane = tid & 31;
  const int T = 16 * warps;
  const int s = blockIdx.x;
  const I W{dims};
  const int L = W.n_layers(), in0 = W[0], outL = W[L];

  // pads, accumulators and tiles start at zero; staging writes every weight
  for (int i = lay.zero_from + tid; i < lay.total; i += nthreads) smem[i] = 0.f;
  stage_weights(smem, lay.w_off, theta + (size_t)s * theta_stride, dims, tid, nthreads);
  __syncthreads();

  const float* xs = x + (size_t)s * P * in0;
  const float* dys = dy + (size_t)s * P * outL;
  float* dxs = dx + (size_t)s * P * in0;
  float* dth = dtheta + (size_t)s * theta_stride;
  const int n_tiles = (P + T - 1) / T;

  copy_rows_async(smem + lay.xb[0], lay.sx, xs, in0, T, P, x_vec, tid, nthreads);
  copy_rows_async(smem + lay.dyb[0], lay.sdy, dys, outL, T, P, dy_vec, tid, nthreads);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, p0 = it * T;
    if (it + 1 < n_tiles) {
      const int p1 = p0 + T;
      copy_rows_async(smem + lay.xb[cur ^ 1], lay.sx, xs + (size_t)p1 * in0, in0, T, P - p1,
                      x_vec, tid, nthreads);
      copy_rows_async(smem + lay.dyb[cur ^ 1], lay.sdy, dys + (size_t)p1 * outL, outL, T,
                      P - p1, dy_vec, tid, nthreads);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's x and dy are in

    // ---- forward recompute for pixels p0 + 16 warp + [0, 16)
    float cs[MAXL - 1][NT][4];  // w0 cos(w0 z_l) of hidden layer l
    {
      float a[NT][4];
      load_c(a, smem + lay.xb[cur] + 16 * warp * lay.sx, lay.sx, in0, lane);
#pragma unroll
      for (int l = 0; l < MAXL - 1; ++l) {
        if (l < L - 1) {
          const int out = W[l + 1];
          float z[NT][4];
          layer_forward(a, z, smem + lay.w_off[l], W[l], out, lane);
          sin_cos_tile(z, round8(out) >> 3, w0, a, cs[l]);
          store_c(a, smem + lay.act[l + 1] + 16 * warp * lay.sa[l + 1], lay.sa[l + 1], out,
                  lane);
        }
      }
    }
    __syncthreads();  // every warp's activation rows are in

    // ---- backward, layer L-1 down to 0; dz_l lives in dzb[l & 1] for l < L-1
    float dz[NT][4];
    load_c(dz, smem + lay.dyb[cur] + 16 * warp * lay.sdy, lay.sdy, outL, lane);
#pragma unroll
    for (int l = MAXL - 1; l >= 0; --l) {
      if (l < L) {
        const int in = W[l], out = W[l + 1];
        float da[NT][4];
        layer_backward(dz, da, smem + lay.w_off[l], in, out, lane);
        // dz_{l-1} (or dx) into the other dz tile: its last readers, dW_{l+1}, are
        // behind the previous barrier
        float* zt = smem + lay.dzb[(l + 1) & 1] + 16 * warp * lay.sz;
        if (l > 0) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) dz[nt][i] = da[nt][i] * cs[l > 0 ? l - 1 : 0][nt][i];
          }
          store_c(dz, zt, lay.sz, in, lane);
        } else {
          store_c(da, zt, lay.sz, in0, lane);
          __syncwarp();
          const int pw = p0 + 16 * warp, rows = min(16, P - pw);
          if (rows > 0)
            store_rows(dxs + (size_t)pw * in0, zt, lay.sz, in0, rows, x_vec, lane, 32);
        }
        // dW_l, db_l over the tile, reading the shared a_l and dz_l tiles
        const float* A = smem + (l == 0 ? lay.xb[cur] : lay.act[l]);
        const int sA = l == 0 ? lay.sx : lay.sa[l];
        const float* Z = smem + (l == L - 1 ? lay.dyb[cur] : lay.dzb[l & 1]);
        const int sZ = l == L - 1 ? lay.sdy : lay.sz;
        dw_tile<I::MT>(A, sA, Z, sZ, in, out, T, warp, warps, lane,
                           lay.acc >= 0 ? smem + lay.acc + 128 * lay.tile0[l] : nullptr,
                           smem + lay.dbp[l], dth + lay.g_off[l], it == 0);
        __syncthreads();  // dz_l and a_l are free; dz_{l-1} is in
      }
    }
  }
  cp_async_wait<0>();

  // ---- dtheta: db from the per-lane partials, dW from the owners' accumulators
  for (int l = 0; l < L; ++l) {
    const int in = W[l], out = W[l + 1];
    const float* p = smem + lay.dbp[l];
    for (int j = tid; j < out; j += nthreads)
      dth[lay.g_off[l] + j] = ((p[4 * j] + p[4 * j + 1]) + p[4 * j + 2]) + p[4 * j + 3];
    if (lay.acc >= 0) {
      const int g = lane >> 2, t = lane & 3, nts = round8(out) >> 3;
      const int n_t = (round16(in) >> 4) * nts;
      for (int j = warp; j < n_t; j += warps) {
        const int mt = j / nts, nt = j - mt * nts;
        const float4 v =
            reinterpret_cast<const float4*>(smem + lay.acc + 128 * lay.tile0[l])[j * 32 + lane];
        const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * mt + g + 8 * (i >> 1), c = 8 * nt + 2 * t + (i & 1);
          if (r < in && c < out) dth[lay.g_off[l] + out + r * out + c] = vals[i];
        }
      }
    }
  }
}

template <class I>
static cudaError_t allow_smem(size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(siren_bwd_kernel<I>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
             : cudaSuccess;
}

// The most warps (64-, 32- or 16-pixel tiles) whose buffers fit, with the
// dW accumulator in shared memory if any does, else in dtheta; 0 if none.
static int plan(const SirenDims& dims, BwdLayout& lay) {
  for (int acc_in_smem = 1; acc_in_smem >= 0; --acc_in_smem) {
    for (int w = BWD_MAX_WARPS; w >= 1; w /= 2) {
      lay = bwd_layout(dims, w, acc_in_smem);
      if (sizeof(float) * (size_t)lay.total <= SMEM_LIMIT) return w;
    }
  }
  return 0;
}

// x (B, P, dims[0]), theta (B, theta_stride), dy (B, P, dims[n_layers]) in;
// dx (B, P, dims[0]) and dtheta (B, theta_stride) out; all f32 and contiguous
// on the device; dims is a host array of n_layers + 1 widths; instance is the
// one these widths take (siren_mma.cuh's table; a launch that names another
// is refused). Launches on `stream` and returns cudaGetLastError() (0 =
// launched). With B or P zero nothing is launched and nothing is written.
extern "C" int siren_bwd(const void* x, const void* theta, const void* dy, void* dx,
                         void* dtheta, int B, int P, int n_layers, const void* dims_host,
                         int theta_stride, float w0, int instance, void* stream) {
  SirenDims dims;
  if (!read_dims(n_layers, dims_host, dims) || B < 0 || P < 0 ||
      theta_stride < theta_floats(dims) || instance != siren_instance(dims))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || P == 0) return (int)cudaSuccess;
  BwdLayout lay;
  const int warps = plan(dims, lay);
  if (!warps) return (int)cudaErrorInvalidValue;
  const int x_vec = row_vec(dims.d[0], x, dx), dy_vec = row_vec(dims.d[n_layers], dy, dy);
  const size_t smem = sizeof(float) * (size_t)lay.total;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_instance(instance, [&](auto inst) {
    using I = decltype(inst);
    cudaError_t e = allow_smem<I>(smem);
    if (e != cudaSuccess) return e;
    siren_bwd_kernel<I><<<B, 32 * warps, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(theta),
        static_cast<const float*>(dy), static_cast<float*>(dx), static_cast<float*>(dtheta), P,
        theta_stride, dims, lay, w0, x_vec, dy_vec);
    return cudaGetLastError();
  });
}

// The launch plan for these widths, for reports: out[0] warps per block,
// out[1] dynamic shared memory per block in bytes, out[2] blocks resident
// per SM, out[3] 1 if the dW accumulator is in shared memory, out[4] the
// instance. Returns a cudaError_t.
extern "C" int siren_bwd_plan(int n_layers, const void* dims_host, int* out) {
  SirenDims dims;
  if (!read_dims(n_layers, dims_host, dims)) return (int)cudaErrorInvalidValue;
  BwdLayout lay;
  const int warps = plan(dims, lay);
  if (!warps) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)lay.total;
  const int instance = siren_instance(dims);
  out[0] = warps;
  out[1] = (int)smem;
  out[3] = lay.acc >= 0;
  out[4] = instance;
  return (int)with_instance(instance, [&](auto inst) {
    using I = decltype(inst);
    cudaError_t e = allow_smem<I>(smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], siren_bwd_kernel<I>,
                                                        32 * warps, smem);
    return e;
  });
}
