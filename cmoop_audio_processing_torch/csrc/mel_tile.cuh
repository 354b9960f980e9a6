// The dense route's stages, shared by the two fused frontend kernels
// (mfcc_fused.cu, log_mel_fused.cu) for every n_fft that mel_fft.cuh's FFT
// route does not take (not in its with_plan list: odd, a prime factor
// above 5, or more than 32 points a lane, such as 401, 402, 1200): one
// block's 64
// frames -> windowed real DFT -> power -> mel, accumulated in shared
// memory. Each kernel adds its own epilogue (dB + DCT-II, or the log) on
// the accumulator this leaves behind.
//
// What bounds it: the function is bound by device-memory traffic on an
// H100 (mel_fft.cuh), but this route runs the DFT as a dense GEMM,
// 2*n_fft*2*n_bins FLOP per frame (~38x an FFT's count at 512), and that
// f32 CUDA-core arithmetic is what limits it. It is the general route, kept
// simple:
//   * the (T, 2K) projection and the (T, K) power stay in registers and
//     shared memory only: they never reach device memory, which is what
//     the TPU kernels' fusion bought;
//   * the DFT is a register-tiled f32 GEMM (each thread 4 frames x 4 bins x
//     {re, im} = 32 accumulators), full FFMA with no TF32, because the
//     librosa match needs full f32 (the TPU kernels used Precision.HIGHEST
//     for the same reason). Its depth runs in stages of NC samples, padded
//     past n_fft: rows of w past n_fft load as zeros and frame samples
//     n >= n_fft as zeros, so any n_fft is taken and no frame is read past
//     its end;
//   * mel += power @ M[chunk] per bin chunk, so the power spectrogram of a
//     chunk is consumed right after it is made;
//   * frames are gathered from the waveform, reflecting at the edges (numpy
//     "reflect", edge not repeated), where the TPU versions had to frame in
//     XLA because Mosaic forbids unaligned VMEM slices. Frames are numbered
//     across the whole batch, so frames of different clips share a block.

#pragma once

#include <cuda_runtime.h>

namespace mel_tile {

constexpr int TF = 64;       // frames per block
constexpr int KC = 64;       // DFT bins per chunk
constexpr int NC = 32;       // DFT depth (samples) per shared-memory stage
constexpr int THREADS = 256; // 16 x 16 thread grid, 4 x 4 register tile each
constexpr int LOADS_F = TF * NC / THREADS;  // frame samples each thread loads

// Floats of dynamic shared memory the stages need for n_mels mel bands;
// the mel accumulator [TF][n_mels] comes last.
inline size_t smem_floats(int n_mels) {
  return (size_t)NC * (TF + 1) + 2 * NC * KC + TF * (KC + 1) +
         (size_t)KC * n_mels + (size_t)TF * n_mels;
}

// Fills acc[TF][n_mels] (the last region of smem) with this block's mel
// power: acc[f][m] = sum_k |DFT(frame frame0 + f)[k]|^2 * M^T[k][m], for
// frames below total_frames (rows past it hold zeros). On return each
// thread owns entries tid, tid + THREADS, ... of acc: an epilogue that
// touches only those needs no barrier. Returns acc.
__device__ __forceinline__ float* mel_power_tile(
    const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ mel_w, float* smem, long long frame0,
    int n_samples, int n_frames, long long total_frames, int n_fft,
    int n_bins, int hop, int pad, int n_mels) {
  float* fs = smem;                    // [NC][TF + 1] frame samples, transposed
  float* wc = fs + NC * (TF + 1);      // [NC][KC] cos rows of this stage
  float* ws = wc + NC * KC;            // [NC][KC] -sin rows of this stage
  float* ps = ws + NC * KC;            // [TF][KC + 1] power of this bin chunk
  float* ms = ps + TF * (KC + 1);      // [KC][n_mels] mel rows of this chunk
  float* acc = ms + KC * n_mels;       // [TF][n_mels] mel accumulator

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // bin lane: bins tx + 16 * j
  const int ty = tid / 16;  // frame lane: frames ty + 16 * i
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
        if (fvalid[i] && n0 + nl < n_fft) {
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
        float c = 0.f, s = 0.f;
        if (k0 + k < n_bins && n0 + n < n_fft) {
          const float* row = w + (long long)(n0 + n) * two_k;
          c = row[k0 + k];
          s = row[n_bins + k0 + k];
        }
        wc[e] = c;
        ws[e] = s;
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
  return acc;
}

}  // namespace mel_tile
