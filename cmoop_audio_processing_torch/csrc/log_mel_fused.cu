// Fused log-mel chain for Hopper (sm_90a): frames -> windowed real DFT ->
// power -> mel -> log, one kernel, in two routes.
//
// Replaces cmoop_audio_processing_tpu/frontend/pallas_kernels.py::log_mel_fused
// (the Pallas body _kernel -> _logmel_tile). Same function, without the
// TPU's tiling: no 128-lane padding of the bins or the mel columns, and only
// the n_mels real columns are written. The log is either natural,
// ln(mel + 1e-6), or raw dB, 10*log10(max(mel, 1e-10)).
//
// * FFT route (the n_fft of mel_fft::with_plan: the powers of two from 64
//   to 2048 and the even sizes whose half is 2^a 3^b 5^c, up to 32 points a
//   lane): log_mel_fft_kernel<P> (radix 2) or log_mel_mixed_kernel<P>, on
//   mel_fft.cuh's stages (span load, a
//   warp or a lane group per frame for the packed real FFT, one lane per
//   frame for the sparse mel product and the log), the
//   block's rows written coalesced. A block handles frames of one clip, so
//   it also records the clip's dB maximum with an order-free atomic max on
//   the float's ordered-int encoding (exact, so deterministic); the
//   per-sample top_db step is then one in-place pass, top_db_kernel: out =
//   max(out - clip max, -top_db), one read and one write of the output.
//   Bound: device memory (mel_fft.cuh says what holds it back).
// * Dense route (any other n_fft): log_mel_fused_kernel on mel_tile.cuh's
//   stages, a dense-GEMM DFT on f32 CUDA cores, which limits it; its
//   top_db step stays in the wrapper, as the TPU version ran it in XLA.

#include <cuda_runtime.h>

#include "mel_fft.cuh"
#include "mel_tile.cuh"

namespace {

using mel_tile::TF;

__device__ __forceinline__ float to_db(float mel) {
  return 10.f * log10f(fmaxf(mel, 1e-10f));
}

__global__ void __launch_bounds__(mel_tile::THREADS)
log_mel_fused_kernel(const float* __restrict__ y, const float* __restrict__ w,
                     const float* __restrict__ mel_w, float* __restrict__ out,
                     int n_samples, int n_frames, long long total_frames,
                     int n_fft, int n_bins, int hop, int pad, int n_mels,
                     int natural_log) {
  extern __shared__ __align__(16) float smem[];
  const long long frame0 = (long long)blockIdx.x * TF;
  const float* acc = mel_tile::mel_power_tile(
      y, w, mel_w, smem, frame0, n_samples, n_frames, total_frames, n_fft,
      n_bins, hop, pad, n_mels);
  // each thread reads only the accumulator entries it wrote: no barrier.
  // Entry e is row frame0 + e / n_mels of the (total_frames, n_mels)
  // output, so a block's rows are one contiguous run of out
  const long long n_valid =
      (total_frames - frame0 < TF ? total_frames - frame0 : TF) * n_mels;
  float* dst = out + frame0 * n_mels;
  for (int e = threadIdx.x; e < n_valid; e += mel_tile::THREADS) {
    const float mel = acc[e];
    dst[e] = natural_log ? logf(mel + 1e-6f) : to_db(mel);
  }
}

// ordered-int encoding of a float: signed-int order equals float order
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// mode: 0 = natural log, 1 = raw dB, 2 = dB and the clip maximum into
// clip_max[clip] (ordered-int encoding)
template <int P>
__device__ __forceinline__ void log_mel_fft(
    const float* __restrict__ y, const float* __restrict__ tables,
    const int* __restrict__ csr, const float* __restrict__ mel_w,
    float* __restrict__ out, int* __restrict__ clip_max, int n_samples,
    int n_frames, int hop, int pad, int frames_per_block, int blocks_per_clip,
    int n_mels, int nnz, int mode, int n_fft) {
  n_fft = mel_fft::plan_n_fft<P>(n_fft);
  extern __shared__ __align__(16) float smem[];
  const int clip = blockIdx.x / blocks_per_clip;
  const int t0 = (blockIdx.x % blocks_per_clip) * frames_per_block;
  const int rb = min(frames_per_block, n_frames - t0);
  const int span_len = (rb - 1) * hop + n_fft;
  const mel_fft::Layout lay(n_fft, n_mels, nnz, 0, rb, span_len);
  mel_fft::mel_rows<P>(
      smem, lay, n_fft, tables, csr, mel_w, n_mels, nnz, nullptr, 0,
      y + (long long)clip * n_samples, n_samples, (long long)t0 * hop - pad,
      span_len, hop, rb, [mode](float mel) {
        return mode == 0 ? logf(mel + 1e-6f) : to_db(mel);
      });
  // the block's rows are one contiguous run of out: coalesced
  const float* rows = smem + lay.span;
  float* dst = out + ((long long)clip * n_frames + t0) * n_mels;
  float vmax = -3.402823466e38f;
  for (int i = threadIdx.x; i < rb * n_mels; i += mel_fft::THREADS) {
    const float v = rows[(i / n_mels) * lay.mel_stride + i % n_mels];
    dst[i] = v;
    vmax = fmaxf(vmax, v);
  }
  if (mode != 2) return;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int d = 16; d >= 1; d /= 2)
    vmax = fmaxf(vmax, __shfl_xor_sync(mel_fft::FULL, vmax, d));
  float* bmax = smem + lay.bmax;
  if (lane == 0) bmax[warp] = vmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < mel_fft::WARPS; ++i) vmax = fmaxf(vmax, bmax[i]);
    atomicMax(clip_max + clip, ordered(vmax));
  }
}

#define LOG_MEL_FFT_PARAMS                                                   \
  const float *__restrict__ y, const float *__restrict__ tables,             \
      const int *__restrict__ csr, const float *__restrict__ mel_w,          \
      float *__restrict__ out, int *__restrict__ clip_max, int n_samples,    \
      int n_frames, int hop, int pad, int frames_per_block,                  \
      int blocks_per_clip, int n_mels, int nnz, int mode, int n_fft
#define LOG_MEL_FFT_ARGS                                                \
  y, tables, csr, mel_w, out, clip_max, n_samples, n_frames, hop, pad,  \
      frames_per_block, blocks_per_clip, n_mels, nnz, mode, n_fft

// the radix-2 plan (P a power of two); the mixed plan, compiled for
// mel_fft::min_blocks(P) blocks an SM
template <int P>
__global__ void __launch_bounds__(mel_fft::THREADS)
log_mel_fft_kernel(LOG_MEL_FFT_PARAMS) { log_mel_fft<P>(LOG_MEL_FFT_ARGS); }

template <int P>
__global__ void __launch_bounds__(mel_fft::THREADS, mel_fft::min_blocks(P))
log_mel_mixed_kernel(LOG_MEL_FFT_PARAMS) { log_mel_fft<P>(LOG_MEL_FFT_ARGS); }

// out[i] = max(out[i] - clip max, floor_db), in place: the wrapper's
// _top_db rule, bit for bit. per_clip = n_frames * n_mels.
template <bool VEC4>
__global__ void top_db_kernel(float* __restrict__ out,
                              const int* __restrict__ clip_max,
                              long long per_clip, long long total,
                              float floor_db) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC4) {  // per_clip % 4 == 0: a float4 never straddles two clips
    float4* o4 = reinterpret_cast<float4*>(out);
    for (; i < total / 4; i += stride) {
      const float ref = unordered(clip_max[4 * i / per_clip]);
      float4 v = o4[i];
      v.x = fmaxf(v.x - ref, floor_db);
      v.y = fmaxf(v.y - ref, floor_db);
      v.z = fmaxf(v.z - ref, floor_db);
      v.w = fmaxf(v.w - ref, floor_db);
      o4[i] = v;
    }
  } else {
    for (; i < total; i += stride)
      out[i] = fmaxf(out[i] - unordered(clip_max[i / per_clip]), floor_db);
  }
}

template <int P>
cudaError_t launch_fft(const float* y, const float* tables, const int* csr,
                       const float* mel_w, float* out, int* clip_max,
                       int batch, int n_samples, int n_frames, int hop, int pad,
                       int n_mels, int nnz, int mode, int n_fft,
                       cudaStream_t stream) {
  int frames, blocks;
  mel_fft::block_geometry(n_frames, n_fft, hop, n_mels, nnz, 0, &frames,
                          &blocks);
  const mel_fft::Layout lay(n_fft, n_mels, nnz, 0, frames,
                            (frames - 1) * hop + n_fft);
  const size_t smem = sizeof(float) * lay.total;
  const auto kernel = [] {
    if constexpr (mel_fft::pow2(P)) return log_mel_fft_kernel<P>;
    else return log_mel_mixed_kernel<P>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks * batch, mel_fft::THREADS, smem, stream>>>(
          y, tables, csr, mel_w, out, clip_max, n_samples, n_frames, hop, pad,
          frames, blocks, n_mels, nnz, mode, n_fft);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one dense-route block needs for n_mels
// mel bands.
size_t log_mel_fused_smem_bytes(int n_mels) {
  return sizeof(float) * mel_tile::smem_floats(n_mels);
}

// Dense route. y (batch, n_samples); w (n_fft, 2*n_bins) = [cos | -sin]
// with the window folded in; mel_w (n_bins, n_mels) = M^T; out (batch *
// n_frames, n_mels). All float32, contiguous, on the device. natural_log:
// 1 = ln(mel + 1e-6), 0 = 10*log10(max(mel, 1e-10)). Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
int log_mel_fused_launch(const void* y, const void* w, const void* mel_w,
                         void* out, int batch, int n_samples, int n_frames,
                         int n_fft, int n_bins, int hop, int center,
                         int n_mels, int natural_log, void* stream) {
  const size_t smem = log_mel_fused_smem_bytes(n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)batch * n_frames;
  const unsigned blocks = (unsigned)((total + TF - 1) / TF);
  log_mel_fused_kernel<<<blocks, mel_tile::THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const float*)y, (const float*)w, (const float*)mel_w, (float*)out,
      n_samples, n_frames, total, n_fft, n_bins, hop, center ? n_fft / 2 : 0,
      n_mels, natural_log);
  return (int)cudaGetLastError();
}

// FFT route, n_fft one of mel_fft::with_plan's. tables: the plan's table
// (mel_fft::table_floats; frontend/cuda_kernels.py fft_tables), float32;
// csr (4, n_mels) int32: each band's first bin, bin count and offset into
// mel_w (nnz float32 weights), then the bands longest first; out (batch * n_frames, n_mels); clip_max
// (batch) int32 scratch. mode: 0 = ln(mel + 1e-6), 1 = raw dB, 2 = dB and
// then the per-clip top_db step in place, out = max(out - clip max,
// floor_db) with floor_db = -top_db. Returns 0 once launched, else a
// cudaError_t.
int log_mel_fft_launch(const void* y, const void* tables, const void* csr,
                       const void* mel_w, void* out, void* clip_max, int batch,
                       int n_samples, int n_frames, int n_fft, int hop,
                       int center, int n_mels, int nnz, int mode,
                       float floor_db, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 2) {
    // 0x80808080 decodes to -3.4e38, below any dB value
    cudaError_t err = cudaMemsetAsync(clip_max, 0x80, sizeof(int) * batch, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int pad = center ? n_fft / 2 : 0;
  cudaError_t err = mel_fft::with_plan(n_fft, [&](auto p) {
    return launch_fft<decltype(p)::value>(
        (const float*)y, (const float*)tables, (const int*)csr,
        (const float*)mel_w, (float*)out, (int*)clip_max, batch, n_samples,
        n_frames, hop, pad, n_mels, nnz, mode, n_fft, s);
  });
  if (err != cudaSuccess || mode != 2) return (int)err;
  const long long per_clip = (long long)n_frames * n_mels;
  const long long total = per_clip * batch;
  const bool vec4 = per_clip % 4 == 0;
  const long long blocks = ((vec4 ? total / 4 : total) + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 4096 ? blocks : 4096);
  if (vec4)
    top_db_kernel<true><<<grid, 256, 0, s>>>(
        (float*)out, (const int*)clip_max, per_clip, total, floor_db);
  else
    top_db_kernel<false><<<grid, 256, 0, s>>>(
        (float*)out, (const int*)clip_max, per_clip, total, floor_db);
  return (int)cudaGetLastError();
}

}  // extern "C"
