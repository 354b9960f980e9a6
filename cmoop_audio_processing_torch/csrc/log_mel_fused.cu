// Fused log-mel chain for Hopper (sm_90a): frames -> windowed real DFT ->
// power -> mel -> log, one kernel.
//
// Replaces cmoop_audio_processing_tpu/frontend/pallas_kernels.py::log_mel_fused
// (the Pallas body _kernel -> _logmel_tile). Same function, without the
// TPU's tiling: no 128-lane padding of the bins or the mel columns, and only
// the n_mels real columns are written. The log is either natural,
// ln(mel + 1e-6), or raw dB, 10*log10(max(mel, 1e-10)). The per-sample
// top_db step (max over a whole clip, then clamp) spans blocks, so it runs
// after the kernel, in the wrapper, as the TPU version ran it in XLA.
//
// The frame gather, DFT, power and mel stages are mel_tile.cuh's, shared
// with mfcc_fused.cu; its header states what bounds the function on an
// H100 (memory traffic), what limits this design (its dense-GEMM DFT on
// f32 CUDA cores) and what the design does about it.

#include <cuda_runtime.h>

#include "mel_tile.cuh"

namespace {

using mel_tile::TF;
using mel_tile::THREADS;

__global__ void __launch_bounds__(THREADS)
log_mel_fused_kernel(const float* __restrict__ y, const float* __restrict__ w,
                     const float* __restrict__ mel_w, float* __restrict__ out,
                     int n_samples, int n_frames, long long total_frames,
                     int n_fft, int n_bins, int hop, int pad, int n_mels,
                     int natural_log) {
  extern __shared__ float smem[];
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
  for (int e = threadIdx.x; e < n_valid; e += THREADS) {
    const float mel = acc[e];
    dst[e] = natural_log ? logf(mel + 1e-6f)
                         : 10.f * log10f(fmaxf(mel, 1e-10f));
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for n_mels mel bands.
size_t log_mel_fused_smem_bytes(int n_mels) {
  return sizeof(float) * mel_tile::smem_floats(n_mels);
}

// y (batch, n_samples); w (n_fft, 2*n_bins) = [cos | -sin] with the window
// folded in; mel_w (n_bins, n_mels) = M^T; out (batch * n_frames, n_mels).
// All float32, contiguous, on the device. natural_log: 1 = ln(mel + 1e-6),
// 0 = 10*log10(max(mel, 1e-10)). Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
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
  log_mel_fused_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)w, (const float*)mel_w, (float*)out,
      n_samples, n_frames, total, n_fft, n_bins, hop, center ? n_fft / 2 : 0,
      n_mels, natural_log);
  return (int)cudaGetLastError();
}

}  // extern "C"
