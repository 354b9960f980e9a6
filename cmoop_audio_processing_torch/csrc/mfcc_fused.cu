// Fused MFCC chain for Hopper (sm_90a): frames -> windowed real DFT ->
// power -> mel -> 10*log10 -> orthonormal DCT-II, one kernel.
//
// Replaces cmoop_audio_processing_tpu/frontend/pallas_kernels.py::mfcc_fused
// (the Pallas body _mfcc_kernel -> _logmel_tile). Same function, without the
// TPU's tiling: no 128-lane padding (only the n_mels real mel columns enter
// the DCT, so no padded column can add a log10(amin) term), and the kernel
// gathers its own frames from the waveform, reflecting at the edges, where
// the TPU version had to frame in XLA because Mosaic forbids unaligned
// VMEM slices.
//
// What bounds it: per frame the DFT GEMM costs 2*n_fft*2*n_bins FLOPs
// (2*512*514 at the KWS shape), the mel and DCT GEMMs 2*257*40 + 2*40*13;
// about 548 kFLOP against ~1.5 KB of traffic (hop new samples of the
// waveform plus n_mfcc outputs, the constant matrices staying in L2). That
// is ~370 FLOP/byte, so on an H100 the kernel is bound by f32 CUDA-core
// arithmetic, never by memory. The design therefore:
//   * keeps the (T, 2K) projection and the (T, K) power in registers and
//     shared memory only: they never reach device memory, which is what
//     the TPU kernel's fusion bought;
//   * runs the DFT as a register-tiled f32 GEMM (each thread 4 frames x 4
//     bins x {re, im} = 32 accumulators), full FFMA with no TF32, because
//     the librosa match needs full f32 (the TPU kernel used
//     Precision.HIGHEST for the same reason);
//   * accumulates mel += power @ M[chunk] per bin chunk, so the power
//     spectrogram of a chunk is consumed right after it is made.
// tensor-core paths (wgmma with 3xTF32 split operands) are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int TF = 64;       // frames per block
constexpr int KC = 64;       // DFT bins per chunk
constexpr int NC = 32;       // DFT depth (samples) per shared-memory stage
constexpr int THREADS = 256; // 16 x 16 thread grid, 4 x 4 register tile each
constexpr int LOADS_F = TF * NC / THREADS;  // frame samples each thread loads

__global__ void __launch_bounds__(THREADS)
mfcc_fused_kernel(const float* __restrict__ y, const float* __restrict__ w,
                  const float* __restrict__ mel_w, const float* __restrict__ dct,
                  float* __restrict__ out, int n_samples, int n_frames,
                  long long total_frames, int n_fft, int n_bins, int hop,
                  int pad, int n_mels, int n_mfcc) {
  extern __shared__ float smem[];
  float* fs = smem;                    // [NC][TF + 1] frame samples, transposed
  float* wc = fs + NC * (TF + 1);      // [NC][KC] cos rows of this stage
  float* ws = wc + NC * KC;            // [NC][KC] -sin rows of this stage
  float* ps = ws + NC * KC;            // [TF][KC + 1] power of this bin chunk
  float* ms = ps + TF * (KC + 1);      // [KC][n_mels] mel rows of this chunk
  float* acc = ms + KC * n_mels;       // [TF][n_mels] mel accumulator

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // bin lane: bins tx + 16 * j
  const int ty = tid / 16;  // frame lane: frames ty + 16 * i
  const long long frame0 = (long long)blockIdx.x * TF;
  const int two_k = 2 * n_bins;

  // the frames this thread gathers: always the same LOADS_F frames, at
  // sample offset tid % NC within each stage
  const int nl = tid % NC;
  long long ybase[LOADS_F];
  int tstart[LOADS_F];
  bool fvalid[LOADS_F];
#pragma unroll
  for (int i = 0; i < LOADS_F; ++i) {
    const int f = (tid + i * THREADS) / NC;
    const long long r = frame0 + f;
    fvalid[i] = r < total_frames;
    const long long b = fvalid[i] ? r / n_frames : 0;
    const int t = fvalid[i] ? (int)(r - b * n_frames) : 0;
    ybase[i] = b * (long long)n_samples;
    tstart[i] = t * hop - pad;
  }

  const int n_acc = TF * n_mels;
  for (int e = tid; e < n_acc; e += THREADS) acc[e] = 0.f;

  for (int k0 = 0; k0 < n_bins; k0 += KC) {
    float are[4][4], aim[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) are[i][j] = aim[i][j] = 0.f;

    for (int n0 = 0; n0 < n_fft; n0 += NC) {
      __syncthreads();  // previous stage (or previous chunk's mel) consumed
#pragma unroll
      for (int i = 0; i < LOADS_F; ++i) {
        const int f = (tid + i * THREADS) / NC;
        float v = 0.f;
        if (fvalid[i]) {
          int j = tstart[i] + n0 + nl;
          if (pad) {  // centred framing: numpy "reflect" (edge not repeated)
            if (j < 0) j = -j;
            if (j >= n_samples) j = 2 * (n_samples - 1) - j;
          }
          v = y[ybase[i] + j];
        }
        fs[nl * (TF + 1) + f] = v;
      }
      for (int e = tid; e < NC * KC; e += THREADS) {
        const int n = e / KC, k = e % KC;
        const bool ok = k0 + k < n_bins;
        const float* row = w + (long long)(n0 + n) * two_k;
        wc[e] = ok ? row[k0 + k] : 0.f;
        ws[e] = ok ? row[n_bins + k0 + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < NC; ++n) {
        float a[4], c[4], s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = fs[n * (TF + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = wc[n * KC + tx + 16 * j];
          s[j] = ws[n * KC + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            are[i][j] = fmaf(a[i], c[j], are[i][j]);
            aim[i][j] = fmaf(a[i], s[j], aim[i][j]);
          }
      }
    }

    // power of this chunk -> shared memory; padded bins carry exact zeros
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * (KC + 1) + tx + 16 * j] =
            are[i][j] * are[i][j] + aim[i][j] * aim[i][j];
    for (int e = tid; e < KC * n_mels; e += THREADS) {
      const int k = e / n_mels;
      ms[e] = k0 + k < n_bins ? mel_w[(long long)(k0 + k) * n_mels + e % n_mels]
                              : 0.f;
    }
    __syncthreads();
    const int kmax = min(KC, n_bins - k0);
    for (int e = tid; e < n_acc; e += THREADS) {
      const int f = e / n_mels, m = e % n_mels;
      float v = acc[e];
      for (int k = 0; k < kmax; ++k)
        v = fmaf(ps[f * (KC + 1) + k], ms[k * n_mels + m], v);
      acc[e] = v;
    }
  }

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
  return sizeof(float) * ((size_t)NC * (TF + 1) + 2 * NC * KC +
                          TF * (KC + 1) + (size_t)KC * n_mels +
                          (size_t)TF * n_mels);
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
