// Per-sample SIREN forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels recombiner_tpu/ops/fused_inr.py::_fwd_kernel
// (groups of samples: samples_per_block > 1) and
// recombiner_tpu/ops/pallas_inr.py::_kernel (one sample per program:
// samples_per_block = 1, the main path). For every sample s and pixel p:
//   a_0 = x[s, p, :],  z_l = a_l @ W_l[s] + b_l[s],
//   a_{l+1} = sin(w0 z_l)  (all layers but the last, which writes z_l),
// and only y[s, p, :] is written to device memory. theta[s] holds, layer
// after layer, [b_l (out), W_l (in x out, row-major)]: the layout of
// recombiner_tpu/models/inr.py::latent_to_weights.
//
// Design (the building blocks, and how the 3xTF32 split and the fragment
// permutation work, are in siren_mma.cuh's note; the forward has no sums
// across pixels):
// - A block of four warps owns a sample (or a group of samples) and a chunk
//   of up to 1,024 / samples_per_block pixels. It stages each sample's
//   weights in shared memory once (in the fixed-width instances split into
//   TF32 hi and lo parts in fragment order), and its warps walk the chunk's
//   16-pixel tiles, tile w, w + 4, ... for warp w: at CIFAR one block
//   covers a whole sample, so its weights are staged once per sample (four
//   times before).
// - Where those blocks would leave the card's resident slots (SMs x blocks
//   per SM) idle, as audio's decode does (B = 60 samples of 800 pixels: 60
//   blocks on 132 SMs), the chunk shrinks in whole 64-pixel steps (one
//   16-pixel tile per warp) until the grid fills one wave of slots, if
//   that lowers the busiest SM's count of 64-pixel block rounds
//   (fwd_chunk). The forward has no sums across pixels, so the chunk
//   changes no number.
// - Each warp runs the chain on its tile in registers: every layer product
//   is an m16n8k8 3xTF32 tensor-core tile product, the output's C fragment
//   becomes the next layer's A fragment by the fragment permutation, and
//   sin(w0 z) is taken once per unit in between, on siren_mma.cuh's
//   branch-free path (as accurate as the library's sinf, which w0 = 30
//   needs: the arguments lie far outside __sinf's accurate range; no
//   --use_fast_math), so the compiler interleaves a tile's 16 sines.
// - Instances (siren_mma.cuh): one per width set a modality config runs
//   (CIFAR's, audio's and video's, every guard and stride a constant,
//   weights staged pre-split: 29 KB at video's widths), and one for widths
//   read at run time, up to 64 in up to 8 layers (weights staged as f32:
//   pre-split planes at those widths would not fit in shared memory).
// - x tiles arrive by cp.async, double-buffered per warp: the next tile's
//   copy (16 rows, one contiguous 2 KB run at CIFAR, 16-byte copies; 8-byte
//   copies of video's 34-wide rows) is in flight while this one computes.
//   y leaves through a shared staging tile as coalesced stores of the
//   contiguous 16 x out run.
// - No block barrier inside the pixel loop: a warp only reads what it copied.
//
// Bound on the H100 (CIFAR decode, B = 500, P = 1,024, 32-32-32-32-3): 3,168
// multiply-adds per pixel, 3.24 GFLOP: 0.0484 ms at the 67 TFLOP/s FP32 FMA
// peak, 0.0197 ms as 3xTF32 (3 x 3.24 GFLOP at 495 TFLOP/s TF32); 78.2 MB of
// x, theta and y: 0.0233 ms at 3.35 TB/s. So at f32 accuracy it is bound by
// bytes. The sines (96 per pixel, about 20 instructions each) are not
// counted in either bound. What holds it above that bound is instruction
// issue: the sines take about a third of its time, the second and third
// TF32 passes about a quarter (scripts/torch_siren_variants.py; PERF.md
// §6). Staging the weights pre-split takes the B operands' splits off
// the loop, at 49.6 KB per block: four blocks (sixteen warps) per SM.

#include "siren_mma.cuh"

#define FWD_WARPS 4
#define FWD_PIXELS_PER_SAMPLE_BLOCK 1024

// Shared-memory layout (floats), computed on the host.
struct FwdLayout {
  int w_off[SIREN_MAX_LAYERS];  // staged weights of layer l
  int bufs;                     // first per-warp buffer; everything below is weights
  int sx, sy;                   // row strides of the x and y tiles
  int warp_floats;              // per warp: two x tiles, then one y tile
  int total;
};

// presplit: the weights staged by stage_split_weights (the fixed-width
// instances), else by stage_weights.
static FwdLayout fwd_layout(const SirenDims& dims, bool presplit) {
  FwdLayout lay = {};
  int off = 0;
  for (int l = 0; l < dims.n_layers; ++l) {
    lay.w_off[l] = off;
    off += presplit ? split_layer_floats(dims.d[l], dims.d[l + 1])
                    : layer_floats(dims.d[l], dims.d[l + 1]);
  }
  lay.bufs = round4(off);
  lay.sx = frag_stride(dims.d[0]);
  lay.sy = frag_stride(dims.d[dims.n_layers]);
  lay.warp_floats = 2 * 16 * lay.sx + 16 * lay.sy;
  lay.total = lay.bufs + FWD_WARPS * lay.warp_floats;
  return lay;
}

template <class I>
__global__ void __launch_bounds__(FWD_WARPS * 32, 4)
siren_fwd_kernel(const float* __restrict__ x, const float* __restrict__ theta,
                 float* __restrict__ y, int B, int P, int theta_stride, SirenDims dims,
                 FwdLayout lay, float w0, int samples_per_block, int chunk, int x_vec,
                 int y_vec) {
  constexpr int NT = I::NT, MAXL = I::layers;
  constexpr bool PRESPLIT = I::fixed;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const I W{dims};
  const int L = W.n_layers(), in0 = W[0], outL = W[L];

  float* xbuf = smem + lay.bufs + warp * lay.warp_floats;  // two tiles of 16 x sx
  float* ybuf = xbuf + 2 * 16 * lay.sx;
  // pad columns of the x tiles are read as zeros and never copied into
  for (int i = lane; i < 2 * 16 * lay.sx; i += 32) xbuf[i] = 0.f;
  __syncwarp();

  const int p_begin = blockIdx.y * chunk;
  const int n_pix = min(P - p_begin, chunk);
  const int n_tiles = (n_pix + 15) >> 4;

  for (int si = 0; si < samples_per_block; ++si) {
    const int s = blockIdx.x * samples_per_block + si;
    if (s >= B) break;  // the same for every thread of the block
    __syncthreads();    // the previous sample's readers of the weights are done
    if constexpr (PRESPLIT)
      stage_split_weights(smem, lay.w_off, theta + (size_t)s * theta_stride, dims, tid,
                          FWD_WARPS * 32);
    else
      stage_weights(smem, lay.w_off, theta + (size_t)s * theta_stride, dims, tid,
                    FWD_WARPS * 32);
    __syncthreads();

    const float* xs = x + ((size_t)s * P + p_begin) * in0;
    float* ys = y + ((size_t)s * P + p_begin) * outL;
    if (warp < n_tiles)
      copy_rows_async(xbuf, lay.sx, xs + (size_t)warp * 16 * in0, in0, 16,
                      n_pix - warp * 16, x_vec, lane, 32);
    cp_async_commit();
    for (int it = warp, k = 0; it < n_tiles; it += FWD_WARPS, ++k) {
      const int next = it + FWD_WARPS;
      if (next < n_tiles)
        copy_rows_async(xbuf + ((k + 1) & 1) * 16 * lay.sx, lay.sx,
                        xs + (size_t)next * 16 * in0, in0, 16, n_pix - next * 16, x_vec,
                        lane, 32);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();

      float a[NT][4];
      load_c(a, xbuf + (k & 1) * 16 * lay.sx, lay.sx, in0, lane);
#pragma unroll
      for (int l = 0; l < MAXL; ++l) {
        if (l < L) {
          float z[NT][4];
          if constexpr (PRESPLIT)
            layer_forward_presplit(a, z, smem + lay.w_off[l], W[l], W[l + 1], lane);
          else
            layer_forward(a, z, smem + lay.w_off[l], W[l], W[l + 1], lane);
          if (l < L - 1) {
            float unused[NT][4];
            sin_cos_tile(z, round8(W[l + 1]) >> 3, w0, a, unused);
          } else {
            store_c(z, ybuf, lay.sy, outL, lane);
          }
        }
      }
      __syncwarp();
      const int rows = min(16, n_pix - it * 16);
      store_rows(ys + (size_t)it * 16 * outL, ybuf, lay.sy, outL, rows, y_vec, lane, 32);
      __syncwarp();  // this x tile and the y tile are free for the next copies
    }
    cp_async_wait<0>();
    __syncwarp();
  }
}

template <class I>
static cudaError_t allow_smem(size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(siren_fwd_kernel<I>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
             : cudaSuccess;
}

// Pixels per block for `groups` sample groups of P pixels on `sms` SMs of
// `per_sm` resident blocks each: 1,024 / samples_per_block (at least 64),
// or, where that grid would leave slots idle, the fewest whole 64-pixel
// steps whose grid fits one wave of slots, if that lowers the busiest SM's
// 64-pixel block rounds (ceil(blocks / sms) x ceil(min(chunk, P) / 64)).
static int fwd_chunk(int groups, int P, int samples_per_block, int sms, int per_sm) {
  int chunk = (FWD_PIXELS_PER_SAMPLE_BLOCK / samples_per_block) & ~15;
  if (chunk < 64) chunk = 64;
  const long slots = (long)sms * per_sm;
  auto blocks = [&](int c) { return (long)groups * ((P + c - 1) / c); };
  auto rounds = [&](int c) {
    return (blocks(c) + sms - 1) / sms * (((c < P ? c : P) + 63) / 64);
  };
  if (sms < 1 || per_sm < 1 || blocks(chunk) >= slots) return chunk;
  int c = 64;
  while (c < chunk && blocks(c) > slots) c += 64;
  return c < chunk && rounds(c) < rounds(chunk) ? c : chunk;
}

// The card's SM count and this instance's resident blocks per SM.
template <class I>
static cudaError_t residency(size_t smem, int& sms, int& per_sm) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, siren_fwd_kernel<I>,
                                                      FWD_WARPS * 32, smem);
  return e;
}

// x (B, P, dims[0]), theta (B, theta_stride), y (B, P, dims[n_layers]), all
// f32 and contiguous on the device; dims is a host array of n_layers + 1
// widths; instance is the one these widths take (siren_mma.cuh's table; a
// launch that names another is refused). Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int siren_fwd(const void* x, const void* theta, void* y, int B, int P,
                         int n_layers, const void* dims_host, int theta_stride, float w0,
                         int samples_per_block, int instance, void* stream) {
  SirenDims dims;
  if (!read_dims(n_layers, dims_host, dims) || samples_per_block < 1 || B < 0 || P < 0 ||
      theta_stride < theta_floats(dims) || instance != siren_instance(dims))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || P == 0) return (int)cudaSuccess;
  const FwdLayout lay = fwd_layout(dims, instance != 0);
  const size_t smem = sizeof(float) * (size_t)lay.total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int x_vec = row_vec(dims.d[0], x, x), y_vec = row_vec(dims.d[n_layers], y, y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_instance(instance, [&](auto inst) {
    using I = decltype(inst);
    int sms = 0, per_sm = 0;
    cudaError_t e = allow_smem<I>(smem);
    if (e == cudaSuccess) e = residency<I>(smem, sms, per_sm);
    if (e != cudaSuccess) return e;
    const int groups = (B + samples_per_block - 1) / samples_per_block;
    const int chunk = fwd_chunk(groups, P, samples_per_block, sms, per_sm);
    const dim3 grid(groups, (P + chunk - 1) / chunk);
    siren_fwd_kernel<I><<<grid, FWD_WARPS * 32, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(theta), static_cast<float*>(y),
        B, P, theta_stride, dims, lay, w0, samples_per_block, chunk, x_vec, y_vec);
    return cudaGetLastError();
  });
}

// The launch plan for these widths, for reports: out[0] warps per block,
// out[1] dynamic shared memory per block in bytes, out[2] blocks resident
// per SM, out[3] the instance, and for B samples of P pixels at
// samples_per_block, out[4] pixels per block and out[5] blocks. Returns a
// cudaError_t.
extern "C" int siren_fwd_plan(int n_layers, const void* dims_host, int B, int P,
                              int samples_per_block, int* out) {
  SirenDims dims;
  if (!read_dims(n_layers, dims_host, dims) || B < 1 || P < 1 || samples_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const int instance = siren_instance(dims);
  const size_t smem = sizeof(float) * (size_t)fwd_layout(dims, instance != 0).total;
  out[0] = FWD_WARPS;
  out[1] = (int)smem;
  out[3] = instance;
  return (int)with_instance(instance, [&](auto inst) {
    using I = decltype(inst);
    int sms = 0;
    cudaError_t e = allow_smem<I>(smem);
    if (e == cudaSuccess) e = residency<I>(smem, sms, out[2]);
    if (e != cudaSuccess) return e;
    const int groups = (B + samples_per_block - 1) / samples_per_block;
    out[4] = fwd_chunk(groups, P, samples_per_block, sms, out[2]);
    out[5] = groups * ((P + out[4] - 1) / out[4]);
    return e;
  });
}
