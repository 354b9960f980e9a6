// Fused MFCC chain for Hopper (sm_90a): frames -> windowed real DFT ->
// power -> mel -> 10*log10 -> orthonormal DCT-II, one kernel.
//
// Replaces cmoop_audio_processing_tpu/frontend/pallas_kernels.py::mfcc_fused
// (the Pallas body _mfcc_kernel -> _logmel_tile). Same function, without the
// TPU's tiling: no 128-lane padding (only the n_mels real mel columns enter
// the DCT, so no padded column can add a log10(amin) term).
//
// The frame gather, DFT, power and mel stages are mel_tile.cuh's, shared
// with log_mel_fused.cu; its header states what bounds the function on an
// H100 (memory traffic), what limits this design (its dense-GEMM DFT on
// f32 CUDA cores) and what the design does about it. The DCT adds
// 2*n_mels*n_mfcc FLOPs per frame and writes n_mfcc floats.

#include <cuda_runtime.h>

#include "mel_tile.cuh"

namespace {

using mel_tile::TF;
using mel_tile::THREADS;

__global__ void __launch_bounds__(THREADS)
mfcc_fused_kernel(const float* __restrict__ y, const float* __restrict__ w,
                  const float* __restrict__ mel_w, const float* __restrict__ dct,
                  float* __restrict__ out, int n_samples, int n_frames,
                  long long total_frames, int n_fft, int n_bins, int hop,
                  int pad, int n_mels, int n_mfcc) {
  extern __shared__ float smem[];
  const long long frame0 = (long long)blockIdx.x * TF;
  float* acc = mel_tile::mel_power_tile(y, w, mel_w, smem, frame0, n_samples,
                                        n_frames, total_frames, n_fft, n_bins,
                                        hop, pad, n_mels);
  const int tid = threadIdx.x;
  const int n_acc = TF * n_mels;

  // each thread owns the same accumulator entries throughout: the dB step
  // needs no barrier, the DCT (which reads whole rows) does
  for (int e = tid; e < n_acc; e += THREADS)
    acc[e] = 10.f * log10f(fmaxf(acc[e], 1e-10f));
  __syncthreads();
  for (int e = tid; e < TF * n_mfcc; e += THREADS) {
    const int f = e / n_mfcc, c = e % n_mfcc;
    const long long r = frame0 + f;
    if (r >= total_frames) continue;
    float v = 0.f;
    for (int m = 0; m < n_mels; ++m)
      v = fmaf(acc[f * n_mels + m], dct[m * n_mfcc + c], v);
    out[r * n_mfcc + c] = v;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for n_mels mel bands.
size_t mfcc_fused_smem_bytes(int n_mels) {
  return sizeof(float) * mel_tile::smem_floats(n_mels);
}

// y (batch, n_samples); w (n_fft, 2*n_bins) = [cos | -sin] with the window
// folded in; mel_w (n_bins, n_mels) = M^T; dct (n_mels, n_mfcc) = D^T;
// out (batch * n_frames, n_mfcc). All float32, contiguous, on the device.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
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
  mfcc_fused_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)w, (const float*)mel_w,
      (const float*)dct, (float*)out, n_samples, n_frames, total, n_fft,
      n_bins, hop, center ? n_fft / 2 : 0, n_mels, n_mfcc);
  return (int)cudaGetLastError();
}

}  // extern "C"
