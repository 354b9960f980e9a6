// Fused MFCC chain for Hopper (sm_90a): frames -> windowed real DFT ->
// power -> mel -> 10*log10 -> orthonormal DCT-II, one kernel, in two routes.
//
// Replaces cmoop_audio_processing_tpu/frontend/pallas_kernels.py::mfcc_fused
// (the Pallas body _mfcc_kernel -> _logmel_tile). Same function, without the
// TPU's tiling: no 128-lane padding (only the n_mels real mel columns enter
// the DCT, so no padded column can add a log10(amin) term).
//
// * FFT route (the n_fft of mel_fft::with_plan: the powers of two from 64
//   to 2048 and the even sizes whose half is 2^a 3^b 5^c, up to 32 points a
//   lane): mfcc_fft_kernel<P> (radix 2) or mfcc_mixed_kernel<P>, on
//   mel_fft.cuh's stages (span load, a warp
//   or a lane group per frame for the packed real FFT, one lane per frame
//   for the sparse mel product and the dB), then
//   the n_mels x n_mfcc DCT, one lane per frame against D^T in shared
//   memory, and the block's n_mfcc-float rows written coalesced. Bound:
//   device memory (mel_fft.cuh says what holds it back).
// * Dense route (any other n_fft): mfcc_fused_kernel on mel_tile.cuh's
//   stages, a dense-GEMM DFT on f32 CUDA cores, which limits it.
// The DCT adds 2*n_mels*n_mfcc FLOPs per frame.

#include <cuda_runtime.h>

#include "mel_fft.cuh"
#include "mel_tile.cuh"

namespace {

using mel_tile::TF;

__global__ void __launch_bounds__(mel_tile::THREADS)
mfcc_fused_kernel(const float* __restrict__ y, const float* __restrict__ w,
                  const float* __restrict__ mel_w, const float* __restrict__ dct,
                  float* __restrict__ out, int n_samples, int n_frames,
                  long long total_frames, int n_fft, int n_bins, int hop,
                  int pad, int n_mels, int n_mfcc) {
  extern __shared__ __align__(16) float smem[];
  const long long frame0 = (long long)blockIdx.x * TF;
  float* acc = mel_tile::mel_power_tile(y, w, mel_w, smem, frame0, n_samples,
                                        n_frames, total_frames, n_fft, n_bins,
                                        hop, pad, n_mels);
  const int tid = threadIdx.x;
  const int n_acc = TF * n_mels;

  // each thread owns the same accumulator entries throughout: the dB step
  // needs no barrier, the DCT (which reads whole rows) does
  for (int e = tid; e < n_acc; e += mel_tile::THREADS)
    acc[e] = 10.f * log10f(fmaxf(acc[e], 1e-10f));
  __syncthreads();
  for (int e = tid; e < TF * n_mfcc; e += mel_tile::THREADS) {
    const int f = e / n_mfcc, c = e % n_mfcc;
    const long long r = frame0 + f;
    if (r >= total_frames) continue;
    float v = 0.f;
    for (int m = 0; m < n_mels; ++m)
      v = fmaf(acc[f * n_mels + m], dct[m * n_mfcc + c], v);
    out[r * n_mfcc + c] = v;
  }
}

// The FFT route's kernel body for P points a lane (mel_fft::with_plan).
template <int P>
__device__ __forceinline__ void mfcc_fft(
    const float* __restrict__ y, const float* __restrict__ tables,
    const int* __restrict__ csr, const float* __restrict__ mel_w,
    const float* __restrict__ dct, float* __restrict__ out, int n_samples,
    int n_frames, int hop, int pad, int frames_per_block, int blocks_per_clip,
    int n_mels, int nnz, int n_mfcc, int n_fft) {
  n_fft = mel_fft::plan_n_fft<P>(n_fft);
  extern __shared__ __align__(16) float smem[];
  const int clip = blockIdx.x / blocks_per_clip;
  const int t0 = (blockIdx.x % blocks_per_clip) * frames_per_block;
  const int rb = min(frames_per_block, n_frames - t0);
  const int span_len = (rb - 1) * hop + n_fft;
  const mel_fft::Layout lay(n_fft, n_mels, nnz, n_mfcc, rb, span_len);
  mel_fft::mel_rows<P>(
      smem, lay, n_fft, tables, csr, mel_w, n_mels, nnz, dct, n_mels * n_mfcc,
      y + (long long)clip * n_samples, n_samples, (long long)t0 * hop - pad,
      span_len, hop, rb,
      [](float mel) { return 10.f * log10f(fmaxf(mel, 1e-10f)); });
  // the DCT: each warp takes whole coefficients, one lane per frame, its
  // frame's dB row (conflict-free) against the column of D^T (broadcast)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* rows = smem + lay.span;
  const float* dct_s = smem + lay.dct;
  float* coef = smem + lay.scratch;
  if (lane < rb) {
    for (int c = warp; c < n_mfcc; c += mel_fft::WARPS) {
      float v = 0.f;
      for (int m = 0; m < n_mels; ++m)
        v = fmaf(rows[lane * lay.mel_stride + m], dct_s[m * n_mfcc + c], v);
      coef[lane * lay.out_stride + c] = v;
    }
  }
  __syncthreads();
  // the block's rows are one contiguous run of out: coalesced
  float* dst = out + ((long long)clip * n_frames + t0) * n_mfcc;
  for (int i = threadIdx.x; i < rb * n_mfcc; i += mel_fft::THREADS)
    dst[i] = coef[(i / n_mfcc) * lay.out_stride + i % n_mfcc];
}

#define MFCC_FFT_PARAMS                                                     \
  const float *__restrict__ y, const float *__restrict__ tables,            \
      const int *__restrict__ csr, const float *__restrict__ mel_w,         \
      const float *__restrict__ dct, float *__restrict__ out, int n_samples, \
      int n_frames, int hop, int pad, int frames_per_block,                 \
      int blocks_per_clip, int n_mels, int nnz, int n_mfcc, int n_fft
#define MFCC_FFT_ARGS                                                   \
  y, tables, csr, mel_w, dct, out, n_samples, n_frames, hop, pad,       \
      frames_per_block, blocks_per_clip, n_mels, nnz, n_mfcc, n_fft

// the radix-2 plan (P a power of two); the mixed plan, compiled for
// mel_fft::min_blocks(P) blocks an SM
template <int P>
__global__ void __launch_bounds__(mel_fft::THREADS)
mfcc_fft_kernel(MFCC_FFT_PARAMS) { mfcc_fft<P>(MFCC_FFT_ARGS); }

template <int P>
__global__ void __launch_bounds__(mel_fft::THREADS, mel_fft::min_blocks(P))
mfcc_mixed_kernel(MFCC_FFT_PARAMS) { mfcc_fft<P>(MFCC_FFT_ARGS); }

template <int P>
cudaError_t launch_fft(const float* y, const float* tables, const int* csr,
                       const float* mel_w, const float* dct, float* out,
                       int batch, int n_samples, int n_frames, int hop, int pad,
                       int n_mels, int nnz, int n_mfcc, int n_fft,
                       cudaStream_t stream) {
  int frames, blocks;
  mel_fft::block_geometry(n_frames, n_fft, hop, n_mels, nnz, n_mfcc, &frames,
                          &blocks);
  const mel_fft::Layout lay(n_fft, n_mels, nnz, n_mfcc, frames,
                            (frames - 1) * hop + n_fft);
  const size_t smem = sizeof(float) * lay.total;
  const auto kernel = [] {
    if constexpr (mel_fft::pow2(P)) return mfcc_fft_kernel<P>;
    else return mfcc_mixed_kernel<P>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks * batch, mel_fft::THREADS, smem, stream>>>(
          y, tables, csr, mel_w, dct, out, n_samples, n_frames, hop, pad,
          frames, blocks, n_mels, nnz, n_mfcc, n_fft);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one dense-route block needs for n_mels
// mel bands.
size_t mfcc_fused_smem_bytes(int n_mels) {
  return sizeof(float) * mel_tile::smem_floats(n_mels);
}

// Dense route. y (batch, n_samples); w (n_fft, 2*n_bins) = [cos | -sin]
// with the window folded in; mel_w (n_bins, n_mels) = M^T; dct (n_mels,
// n_mfcc) = D^T; out (batch * n_frames, n_mfcc). All float32, contiguous,
// on the device. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
int mfcc_fused_launch(const void* y, const void* w, const void* mel_w,
                      const void* dct, void* out, int batch, int n_samples,
                      int n_frames, int n_fft, int n_bins, int hop, int center,
                      int n_mels, int n_mfcc, void* stream) {
  const size_t smem = mfcc_fused_smem_bytes(n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)batch * n_frames;
  const unsigned blocks = (unsigned)((total + TF - 1) / TF);
  mfcc_fused_kernel<<<blocks, mel_tile::THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)w, (const float*)mel_w,
      (const float*)dct, (float*)out, n_samples, n_frames, total, n_fft,
      n_bins, hop, center ? n_fft / 2 : 0, n_mels, n_mfcc);
  return (int)cudaGetLastError();
}

// FFT route, n_fft one of mel_fft::with_plan's. tables, csr and mel_w as
// for log_mel_fft_launch (log_mel_fused.cu); dct (n_mels, n_mfcc) = D^T;
// out (batch * n_frames, n_mfcc). Returns 0 once launched, else a
// cudaError_t.
int mfcc_fft_launch(const void* y, const void* tables, const void* csr,
                    const void* mel_w, const void* dct, void* out, int batch,
                    int n_samples, int n_frames, int n_fft, int hop, int center,
                    int n_mels, int nnz, int n_mfcc, void* stream) {
  const int pad = center ? n_fft / 2 : 0;
  return (int)mel_fft::with_plan(n_fft, [&](auto p) {
    return launch_fft<decltype(p)::value>(
        (const float*)y, (const float*)tables, (const int*)csr,
        (const float*)mel_w, (const float*)dct, (float*)out, batch, n_samples,
        n_frames, hop, pad, n_mels, nnz, n_mfcc, n_fft, (cudaStream_t)stream);
  });
}

}  // extern "C"
