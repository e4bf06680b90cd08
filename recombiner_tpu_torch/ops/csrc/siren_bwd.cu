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
// Design: one block per sample; its threads walk the sample's pixels in
// tiles of blockDim.x (128 when shared memory allows), one pixel per
// thread, tile after tile in order. Per tile:
//   1. x and dy tiles are copied in, coalesced, to shared memory;
//   2. forward recompute, one pixel per thread, weights staged in shared
//      memory once per block as in siren_fwd.cu (broadcast 16-byte loads);
//      each pre-activation z_l is kept in shared memory (row per pixel);
//   3. backward, layer by layer: each thread turns its z_{l-1} row into
//      a_l = sin(w0 z) in place and keeps w0 cos(w0 z) in registers, and
//      computes da_l for its pixel; then the block reduces dW_l, db_l over
//      the tile's pixels, each thread owning fixed (row, 4 columns) cells
//      of dtheta; then each thread writes dz_{l-1} = da_l * cos term for
//      its pixel; at layer 0 da_0 goes out as dx through shared memory.
// The dW/db sums over a tile run over pixels in order, and a tile's sum
// is added to dtheta (which the same thread owns for the whole sample)
// tile after tile in order: no atomics, so two launches on the same inputs
// give bitwise-equal outputs.
//
// Shared memory rows are padded to a multiple of 4 floats plus 4, so
// per-pixel float4 row accesses are free of bank conflicts. At CIFAR widths
// (32-32-32-32-3) a 128-pixel tile takes 105,360 bytes: two blocks per SM.
//
// Precision: FP32 FMA and the precise sinf / sincosf (w0 = 30 puts the
// arguments far outside __sinf's accurate range); never --use_fast_math.
//
// Bound (CIFAR encode, B = 2,500 samples, P = 1,024, 32-32-32-32-3): per
// pixel the forward recompute's 3,072 multiply-adds (it stops before the
// last layer) and 3,168 each for dW and da, 9,408 in all: 48.2 GFLOP,
// about 0.72 ms at the H100's 67 TFLOP/s FP32; 751 MB of x,
// theta, dy, dx and dtheta, about 0.22 ms at 3.35 TB/s. Bound by operations.

#include <cuda_runtime.h>
#include <stdint.h>

#define SIREN_MAX_LAYERS 8
#define SIREN_MAX_WIDTH 64
#define BWD_MAX_THREADS 128
#define SMEM_LIMIT (227 * 1024)

struct SirenDims {
  int n_layers;
  int d[SIREN_MAX_LAYERS + 1];
};

static __host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }
// shared-memory row stride of a width-d activation row
static __host__ __device__ __forceinline__ int srow(int d) { return round4(d) + 4; }

// staged weights, in floats: per layer (in + 1) rows of round4(out)
static __host__ __device__ int weight_floats(const SirenDims& dims) {
  int n = 0;
  for (int l = 0; l < dims.n_layers; ++l) n += (dims.d[l] + 1) * round4(dims.d[l + 1]);
  return n;
}

// per tile, in floats: one row per pixel for a_0 .. a_{L-1} and for dz
static __host__ __device__ int tile_floats(const SirenDims& dims, int tile) {
  int n = 0, maxout = 0;
  for (int l = 0; l < dims.n_layers; ++l) {
    n += tile * srow(dims.d[l]);
    maxout = dims.d[l + 1] > maxout ? dims.d[l + 1] : maxout;
  }
  return n + tile * srow(maxout);
}

template <int MAXW>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
siren_bwd_kernel(const float* __restrict__ x, const float* __restrict__ theta,
                 const float* __restrict__ dy, float* __restrict__ dx,
                 float* __restrict__ dtheta, int P, int theta_stride, SirenDims dims,
                 float w0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = blockDim.x;  // pixels per tile
  const int t = threadIdx.x;
  const int s = blockIdx.x;
  const int L = dims.n_layers;
  const int in0 = dims.d[0], outL = dims.d[L];

  const int w_floats = weight_floats(dims);
  float* act0 = smem + w_floats;  // a_0 rows; then one buffer per layer
  const int t_floats = tile_floats(dims, T);
  int maxout = 0;
  for (int l = 0; l < L; ++l) maxout = dims.d[l + 1] > maxout ? dims.d[l + 1] : maxout;
  float* dzb = act0 + t_floats - T * srow(maxout);  // dz rows of the current layer

  // stage theta[s] (bias row, then weight rows, each padded to round4(out))
  const float* th = theta + (size_t)s * theta_stride;
  {
    int src = 0, dst = 0;
    for (int l = 0; l < L; ++l) {
      const int out = dims.d[l + 1], out4 = round4(out);
      const int n = (dims.d[l] + 1) * out4;
      for (int k = t; k < n; k += T) {
        const int r = k / out4, c = k - r * out4;
        smem[dst + k] = c < out ? th[src + r * out + c] : 0.f;
      }
      src += (dims.d[l] + 1) * out;
      dst += n;
    }
  }

  float* dth = dtheta + (size_t)s * theta_stride;
  const float* xs = x + (size_t)s * P * in0;
  const float* dys = dy + (size_t)s * P * outL;
  float* dxs = dx + (size_t)s * P * in0;
  const int sr0 = srow(in0), srL = srow(outL), in04 = round4(in0), outL4 = round4(outL);

  for (int p0 = 0; p0 < P; p0 += T) {
    const int nv = min(T, P - p0);
    __syncthreads();  // the previous tile's readers of act0 / dzb are done
    // x and dy tiles, zero past the last pixel and in the pad lanes
    for (int k = t; k < T * in04; k += T) {
      const int r = k / in04, c = k - r * in04;
      act0[r * sr0 + c] = r < nv && c < in0 ? xs[(size_t)(p0 + r) * in0 + c] : 0.f;
    }
    for (int k = t; k < T * outL4; k += T) {
      const int r = k / outL4, c = k - r * outL4;
      dzb[r * srL + c] = r < nv && c < outL ? dys[(size_t)(p0 + r) * outL + c] : 0.f;
    }
    __syncthreads();

    // ---- forward recompute for pixel p0 + t: z_l -> the next layer's rows
    {
      float a[MAXW], z[MAXW];
      const float4* x4 = reinterpret_cast<const float4*>(act0 + t * sr0);
#pragma unroll
      for (int i4 = 0; i4 < MAXW / 4; ++i4) {
        if (4 * i4 < in0) {
          const float4 v = x4[i4];
          a[4 * i4] = v.x;
          a[4 * i4 + 1] = v.y;
          a[4 * i4 + 2] = v.z;
          a[4 * i4 + 3] = v.w;
        }
      }
      const float* layer = smem;
      float* next = act0 + T * sr0;
      for (int l = 0; l < L - 1; ++l) {
        const int in = dims.d[l], out = dims.d[l + 1], out4 = round4(out);
        const float4* b4 = reinterpret_cast<const float4*>(layer);
#pragma unroll
        for (int j4 = 0; j4 < MAXW / 4; ++j4) {
          if (4 * j4 < out) {
            const float4 b = b4[j4];
            z[4 * j4] = b.x;
            z[4 * j4 + 1] = b.y;
            z[4 * j4 + 2] = b.z;
            z[4 * j4 + 3] = b.w;
          }
        }
#pragma unroll
        for (int i = 0; i < MAXW; ++i) {
          if (i < in) {
            const float ai = a[i];
            const float4* w4 = reinterpret_cast<const float4*>(layer + (i + 1) * out4);
#pragma unroll
            for (int j4 = 0; j4 < MAXW / 4; ++j4) {
              if (4 * j4 < out) {
                const float4 w = w4[j4];
                z[4 * j4] = fmaf(ai, w.x, z[4 * j4]);
                z[4 * j4 + 1] = fmaf(ai, w.y, z[4 * j4 + 1]);
                z[4 * j4 + 2] = fmaf(ai, w.z, z[4 * j4 + 2]);
                z[4 * j4 + 3] = fmaf(ai, w.w, z[4 * j4 + 3]);
              }
            }
          }
        }
        // pad lanes of z are 0: zero bias and weight pads
        float4* zrow = reinterpret_cast<float4*>(next + t * srow(out));
#pragma unroll
        for (int j4 = 0; j4 < MAXW / 4; ++j4) {
          if (4 * j4 < out)
            zrow[j4] = make_float4(z[4 * j4], z[4 * j4 + 1], z[4 * j4 + 2], z[4 * j4 + 3]);
        }
#pragma unroll
        for (int j = 0; j < MAXW; ++j) {
          if (j < out) a[j] = sinf(w0 * z[j]);
        }
        layer += (in + 1) * out4;
        next += T * srow(out);
      }
    }

    // ---- backward, layer L-1 down to 0
    const float* layer = smem + w_floats;  // one past the last layer's weights
    float* act_end = dzb;                  // one past the last activation buffer
    int goff = 0;
    for (int l = 0; l < L; ++l) goff += (dims.d[l] + 1) * dims.d[l + 1];
    for (int l = L - 1; l >= 0; --l) {
      const int in = dims.d[l], out = dims.d[l + 1];
      const int out4 = round4(out), sri = srow(in), sro = srow(out);
      layer -= (in + 1) * out4;
      float* act = act_end - T * sri;
      act_end = act;
      goff -= (in + 1) * out;

      // own row: z_{l-1} -> a_l in place, keeping w0 cos(w0 z_{l-1})
      float c[MAXW];
      if (l > 0) {
        float4* arow = reinterpret_cast<float4*>(act + t * sri);
#pragma unroll
        for (int i4 = 0; i4 < MAXW / 4; ++i4) {
          if (4 * i4 < in) {
            float4 v = arow[i4];
            float sv, cv;
            sincosf(w0 * v.x, &sv, &cv);
            v.x = sv;
            c[4 * i4] = w0 * cv;
            sincosf(w0 * v.y, &sv, &cv);
            v.y = sv;
            c[4 * i4 + 1] = w0 * cv;
            sincosf(w0 * v.z, &sv, &cv);
            v.z = sv;
            c[4 * i4 + 2] = w0 * cv;
            sincosf(w0 * v.w, &sv, &cv);
            v.w = sv;
            c[4 * i4 + 3] = w0 * cv;
            arow[i4] = v;
          }
        }
      }
      // own row of dz_l, and da_l = dz_l W_l^T for this pixel
      float dz[MAXW], da[MAXW];
      const float4* dzrow = reinterpret_cast<const float4*>(dzb + t * sro);
#pragma unroll
      for (int j4 = 0; j4 < MAXW / 4; ++j4) {
        if (4 * j4 < out) {
          const float4 v = dzrow[j4];
          dz[4 * j4] = v.x;
          dz[4 * j4 + 1] = v.y;
          dz[4 * j4 + 2] = v.z;
          dz[4 * j4 + 3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < MAXW; ++i) {
        da[i] = 0.f;
        if (i < in) {
          const float4* w4 = reinterpret_cast<const float4*>(layer + (i + 1) * out4);
          float acc = 0.f;
#pragma unroll
          for (int j4 = 0; j4 < MAXW / 4; ++j4) {
            if (4 * j4 < out) {
              const float4 w = w4[j4];
              acc = fmaf(dz[4 * j4], w.x, acc);
              acc = fmaf(dz[4 * j4 + 1], w.y, acc);
              acc = fmaf(dz[4 * j4 + 2], w.z, acc);
              acc = fmaf(dz[4 * j4 + 3], w.w, acc);
            }
          }
          da[i] = acc;
        }
      }
      __syncthreads();  // every a_l row and dz_l row is in place

      // dW_l (rows 1..in) and db_l (row 0) over this tile's pixels, in order
      const int q4 = out4 / 4, nq = (in + 1) * q4;
      const float4* dz4 = reinterpret_cast<const float4*>(dzb);
      for (int q = t; q < nq; q += T) {
        const int r = q / q4, j4 = q - r * q4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r == 0) {
          for (int p = 0; p < nv; ++p) {
            const float4 d = dz4[p * (sro / 4) + j4];
            acc.x += d.x;
            acc.y += d.y;
            acc.z += d.z;
            acc.w += d.w;
          }
        } else {
          for (int p = 0; p < nv; ++p) {
            const float av = act[p * sri + r - 1];
            const float4 d = dz4[p * (sro / 4) + j4];
            acc.x = fmaf(av, d.x, acc.x);
            acc.y = fmaf(av, d.y, acc.y);
            acc.z = fmaf(av, d.z, acc.z);
            acc.w = fmaf(av, d.w, acc.w);
          }
        }
        float* g = dth + goff + r * out + 4 * j4;
        const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * j4 + k < out) g[k] = p0 == 0 ? v[k] : g[k] + v[k];
        }
      }
      __syncthreads();  // done reading dz_l and a_l

      // own row: dz_{l-1} = da_l * w0 cos(w0 z_{l-1}); at layer 0, dx
      float4* orow = reinterpret_cast<float4*>(l > 0 ? dzb + t * sri : act0 + t * sr0);
#pragma unroll
      for (int i4 = 0; i4 < MAXW / 4; ++i4) {
        if (4 * i4 < in) {
          if (l > 0)
            orow[i4] = make_float4(da[4 * i4] * c[4 * i4], da[4 * i4 + 1] * c[4 * i4 + 1],
                                   da[4 * i4 + 2] * c[4 * i4 + 2],
                                   da[4 * i4 + 3] * c[4 * i4 + 3]);
          else
            orow[i4] = make_float4(da[4 * i4], da[4 * i4 + 1], da[4 * i4 + 2], da[4 * i4 + 3]);
        }
      }
    }
    __syncthreads();  // the dx tile is in act0
    for (int k = t; k < nv * in0; k += T) {
      const int r = k / in0, c = k - r * in0;
      dxs[(size_t)p0 * in0 + k] = act0[r * sr0 + c];
    }
  }
}

template <int MAXW>
static cudaError_t launch(const float* x, const float* theta, const float* dy, float* dx,
                          float* dtheta, int B, int P, int theta_stride, const SirenDims& dims,
                          float w0, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(siren_bwd_kernel<MAXW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  siren_bwd_kernel<MAXW><<<B, threads, smem, stream>>>(x, theta, dy, dx, dtheta, P,
                                                       theta_stride, dims, w0);
  return cudaGetLastError();
}

// x (B, P, dims[0]), theta (B, theta_stride), dy (B, P, dims[n_layers]) in;
// dx (B, P, dims[0]) and dtheta (B, theta_stride) out; all f32 and contiguous
// on the device; dims is a host array of n_layers + 1 widths. Launches on
// `stream` and returns cudaGetLastError() (0 = launched). With B or P zero
// nothing is launched and nothing is written.
extern "C" int siren_bwd(const void* x, const void* theta, const void* dy, void* dx,
                         void* dtheta, int B, int P, int n_layers, const void* dims_host,
                         int theta_stride, float w0, void* stream) {
  if (n_layers < 1 || n_layers > SIREN_MAX_LAYERS || B < 0 || P < 0)
    return (int)cudaErrorInvalidValue;
  SirenDims dims;
  dims.n_layers = n_layers;
  const int* d = static_cast<const int*>(dims_host);
  int maxw = 0, need = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (d[l] < 1 || d[l] > SIREN_MAX_WIDTH) return (int)cudaErrorInvalidValue;
    dims.d[l] = d[l];
    maxw = d[l] > maxw ? d[l] : maxw;
  }
  for (int l = 0; l < n_layers; ++l) need += (d[l] + 1) * d[l + 1];
  if (theta_stride < need) return (int)cudaErrorInvalidValue;
  if (B == 0 || P == 0) return (int)cudaSuccess;
  // the largest tile (128, 64 or 32 pixels) whose buffers fit in shared memory
  int threads = BWD_MAX_THREADS;
  size_t smem = 0;
  for (; threads >= 32; threads /= 2) {
    smem = sizeof(float) * (size_t)(weight_floats(dims) + tile_floats(dims, threads));
    if (smem <= SMEM_LIMIT) break;
  }
  if (threads < 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(theta);
  const float* dyf = static_cast<const float*>(dy);
  float* dxf = static_cast<float*>(dx);
  float* dtf = static_cast<float*>(dtheta);
  cudaError_t e =
      maxw <= 32 ? launch<32>(xf, tf, dyf, dxf, dtf, B, P, theta_stride, dims, w0, threads,
                              smem, st)
                 : launch<64>(xf, tf, dyf, dxf, dtf, B, P, theta_stride, dims, w0, threads,
                              smem, st);
  return (int)e;
}
